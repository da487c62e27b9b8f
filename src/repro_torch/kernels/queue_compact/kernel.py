"""Kernel B2 wrapper: stable stream compaction, ``csrc/compact.cu``.

Replaces the TPU kernel ``compact_tiles_pallas`` of
``repro/kernels/queue_compact/kernel.py`` and its phase-2 stitch in
``repro/kernels/queue_compact/ops.py``: count, scan and scatter, three
launches on the current stream.  The count stays on the device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load


@functools.lru_cache(maxsize=None)
def _lib():
    """``(compact_launch, items per block)``; the kernel's tile is read
    once, as the push calls this every round."""
    lib = load("compact")
    lib.compact_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.compact_launch.restype = ctypes.c_int
    lib.compact_tile.argtypes = []
    lib.compact_tile.restype = ctypes.c_int
    return lib.compact_launch, lib.compact_tile()


def compact_cuda(items: torch.Tensor, mask: torch.Tensor):
    """``([N] compacted then zeros, 0-dim int32 count)`` for int32 ``items``
    and bool ``mask`` on one CUDA device; bit-equal to ``compact_ref``.
    Launches on the current stream and does not synchronize."""
    if not (items.is_cuda and mask.is_cuda and items.device == mask.device):
        raise ValueError(f"compact_cuda needs both tensors on one CUDA "
                         f"device, got {items.device} and {mask.device}")
    if items.dtype != torch.int32 or mask.dtype != torch.bool:
        raise ValueError(f"items must be int32 and mask bool, got "
                         f"{items.dtype} and {mask.dtype}")
    if items.dim() != 1 or mask.shape != items.shape:
        raise ValueError(f"items and mask must be 1-D of one length, got "
                         f"{tuple(items.shape)} and {tuple(mask.shape)}")
    if not (items.is_contiguous() and mask.is_contiguous()):
        raise ValueError("items and mask must be contiguous")
    n = items.shape[0]
    if n >= 2 ** 31 - 2 ** 16:
        raise ValueError(f"{n} items are more than the kernel indexes")
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=items.device),
                torch.zeros((), dtype=torch.int32, device=items.device))
    launch, tile = _lib()
    # one allocation: the output, then the count, then the tile offsets
    buf = torch.empty(n + 1 + -(-n // tile), dtype=torch.int32,
                      device=items.device)
    out, count, scratch = buf[:n], buf[n], buf[n + 1:]
    with torch.cuda.device(items.device):
        err = launch(items.data_ptr(), mask.data_ptr(), n, out.data_ptr(),
                     count.data_ptr(), scratch.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    check_launch(err, "compact")
    compact_cuda.launches += 1
    return out, count


#: launches of the kernel since the count was last set to 0
compact_cuda.launches = 0
