"""The ordered scatter-add kernel, ``csrc/ordered_scatter_add.cu``.

It replaces no TPU kernel.  It is the port's deterministic form of
``residue.at[nbr].add(contrib)`` (``repro/algorithms/pagerank.py:122``):
``torch.index_add_`` on CUDA tensors adds with atomics, in an order that
changes from run to run, and PageRank's ranks must not.  The kernel groups
the updates into one segment per index by atomics, sorts each segment by
update id and adds it left to right onto the base value, in four launches
(the source's header has the passes); no library sort runs, and the copy
of ``base`` rides in the first launch.

Its scratch (a count per slot, the segment arrays) stays on the card
between calls, one set per device and stream, and grows when ``n`` or
``k`` does.  The per-slot counts are zero on entry: the kernel sets each
back to 0 as it closes the segment, so no call clears them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load

#: (device index, stream handle) -> (counts int32, zero between calls; work
#: uint8)
_SCRATCH: dict = {}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("ordered_scatter_add")
    for fn in (lib.ordered_scatter_add_launch,
               lib.ordered_scatter_add_f64_launch):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.ordered_scatter_add_counts.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ordered_scatter_add_counts.restype = ctypes.c_longlong
    lib.ordered_scatter_add_work_bytes.argtypes = [ctypes.c_int, ctypes.c_int,
                                                   ctypes.c_int]
    lib.ordered_scatter_add_work_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=64)
def _sizes(n: int, k: int, elem: int) -> tuple:
    """``(ints of counts, bytes of work)`` for ``n`` slots and ``k`` updates
    of ``elem`` bytes; read once a shape, as PageRank calls this every
    round."""
    lib = _lib()
    return (lib.ordered_scatter_add_counts(n, k),
            lib.ordered_scatter_add_work_bytes(n, k, elem))


def _scratch(device: torch.device, stream: int, n: int, k: int,
             elem: int) -> tuple:
    """The counts and work buffers of ``stream`` on ``device``, grown to
    ``n`` slots and ``k`` updates of ``elem`` bytes.  A grown counts buffer
    is new zeros (every call leaves it zero); the work buffer needs no
    clearing."""
    counts, work = _SCRATCH.get((device.index, stream), (None, None))
    need_counts, need_work = _sizes(n, k, elem)
    if counts is None or counts.numel() < need_counts:
        counts = torch.zeros(need_counts, dtype=torch.int32, device=device)
    if work is None or work.numel() < need_work:
        work = torch.empty(need_work, dtype=torch.uint8, device=device)
    _SCRATCH[(device.index, stream)] = (counts, work)
    return counts, work


def ordered_scatter_add_cuda(base: torch.Tensor, index: torch.Tensor,
                             values: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``base`` with ``values[u]`` added at ``index[u]`` in
    update order, bit-equal to the CPU's sequential sum; float32 (PageRank's
    residues) or float64 (the streaming rule's sums).  Indices must lie in
    ``[0, len(base))``.  Launches on the current stream and does not
    synchronize."""
    for name, t in (("base", base), ("index", index), ("values", values)):
        if not (t.is_cuda and t.device == base.device):
            raise ValueError(f"ordered_scatter_add_cuda needs {name} on the "
                             f"CUDA device of base, got {t.device}")
    if base.dtype not in (torch.float32, torch.float64) \
            or values.dtype != base.dtype:
        raise ValueError(f"base and values must be both float32 or both "
                         f"float64, got {base.dtype} and {values.dtype}")
    if base.dim() != 1 or index.dim() != 1 or index.shape != values.shape:
        raise ValueError(f"base must be 1-D and index, values 1-D of one "
                         f"length; got {tuple(base.shape)}, "
                         f"{tuple(index.shape)}, {tuple(values.shape)}")
    if index.shape[0] >= 2 ** 31 or base.shape[0] >= 2 ** 31:
        raise ValueError("more updates or slots than the kernel indexes")
    n, k = base.shape[0], index.shape[0]
    if k == 0 or n == 0:
        return base.clone()
    base = base.contiguous()
    index = index.to(torch.int32).contiguous()
    values = values.contiguous()
    out = torch.empty_like(base)
    lib = _lib()
    launch = (lib.ordered_scatter_add_launch if base.dtype == torch.float32
              else lib.ordered_scatter_add_f64_launch)
    with torch.cuda.device(base.device):
        stream = torch.cuda.current_stream().cuda_stream
        counts, work = _scratch(base.device, stream, n, k,
                                base.element_size())
        err = launch(out.data_ptr(), base.data_ptr(), n, index.data_ptr(),
                     values.data_ptr(), k, counts.data_ptr(),
                     work.data_ptr(), stream)
    check_launch(err, "ordered_scatter_add")
    ordered_scatter_add_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
ordered_scatter_add_cuda.launches = 0
