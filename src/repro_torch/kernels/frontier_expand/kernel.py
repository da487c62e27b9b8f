"""Kernel B1 wrapper: the load-balancing search, ``csrc/lbs.cu``.

Replaces the TPU kernel ``lbs_pallas`` of
``repro/kernels/frontier_expand/kernel.py``.  The kernel is a merge-path
load-balancing search: each block takes a fixed share of the merge of the
units with the scan entries, stages only its own window of the scan and
walks it in order, and a block wholly past the scan's total writes its
units without a search.  See the note in the source for what bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = load("lbs").lbs_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lbs_cuda(scan: torch.Tensor, budget: int):
    """``(owner[budget], rank[budget])`` int32 for an int32 ``scan`` [W] on
    a CUDA device; bit-equal to ``lbs_ref``.  Launches on the current
    stream and does not synchronize."""
    if not scan.is_cuda:
        raise ValueError(f"lbs_cuda needs a CUDA tensor, got {scan.device}")
    if scan.dtype != torch.int32 or scan.dim() != 1:
        raise ValueError(f"scan must be 1-D int32, got {scan.dtype} "
                         f"{tuple(scan.shape)}")
    if not scan.is_contiguous():
        raise ValueError("scan must be contiguous")
    if not 0 <= budget < 2 ** 31 - 2 ** 24:
        raise ValueError(f"budget {budget} is out of range")
    owner = torch.empty(budget, dtype=torch.int32, device=scan.device)
    rank = torch.empty(budget, dtype=torch.int32, device=scan.device)
    if budget == 0:
        return owner, rank
    with torch.cuda.device(scan.device):
        err = _launch_fn()(scan.data_ptr(), scan.shape[0], owner.data_ptr(),
                           rank.data_ptr(), budget,
                           torch.cuda.current_stream().cuda_stream)
    check_launch(err, "lbs")
    lbs_cuda.launches += 1
    return owner, rank


#: launches of the kernel since the count was last set to 0
lbs_cuda.launches = 0
