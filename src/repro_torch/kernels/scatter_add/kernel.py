"""The ordered scatter-add kernel, ``csrc/ordered_scatter_add.cu``.

It replaces no TPU kernel.  It is the port's deterministic form of
``residue.at[nbr].add(contrib)`` (``repro/algorithms/pagerank.py:122``):
``torch.index_add_`` on CUDA tensors adds with atomics, in an order that
changes from run to run, and PageRank's ranks must not.  The wrapper sorts
the updates stably by index (``torch.sort(stable=True)``, the port's own
helper, not a TPU kernel); the kernel then gives each run of equal indices
to one thread, which adds the run's values left to right, that is in
update order, onto the base value.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = load("ordered_scatter_add").ordered_scatter_add_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ordered_scatter_add_cuda(base: torch.Tensor, index: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """A new f32 tensor: ``base`` with ``values[u]`` added at ``index[u]``
    in update order, bit-equal to the CPU's sequential sum.  Indices must
    lie in ``[0, len(base))``.  Launches on the current stream and does
    not synchronize."""
    for name, t in (("base", base), ("index", index), ("values", values)):
        if not (t.is_cuda and t.device == base.device):
            raise ValueError(f"ordered_scatter_add_cuda needs {name} on the "
                             f"CUDA device of base, got {t.device}")
    if base.dtype != torch.float32 or values.dtype != torch.float32:
        raise ValueError(f"base and values must be float32, got "
                         f"{base.dtype} and {values.dtype}")
    if base.dim() != 1 or index.dim() != 1 or index.shape != values.shape:
        raise ValueError(f"base must be 1-D and index, values 1-D of one "
                         f"length; got {tuple(base.shape)}, "
                         f"{tuple(index.shape)}, {tuple(values.shape)}")
    if index.shape[0] >= 2 ** 31 or base.shape[0] >= 2 ** 31:
        raise ValueError("more updates or slots than the kernel indexes")
    out = base.contiguous().clone()
    k = index.shape[0]
    if k == 0:
        return out
    keys, order = torch.sort(index.to(torch.int32), stable=True)
    order = order.to(torch.int32)
    values = values.contiguous()
    with torch.cuda.device(base.device):
        err = _launch_fn()(out.data_ptr(), out.shape[0], keys.data_ptr(),
                           order.data_ptr(), values.data_ptr(), k,
                           torch.cuda.current_stream().cuda_stream)
    check_launch(err, "ordered_scatter_add")
    ordered_scatter_add_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
ordered_scatter_add_cuda.launches = 0
