"""Kernel B4, the double-buffered CSR row-slice stream, and the merge-path
expansion over it.

The counterpart of ``repro/kernels/drain_loop/csr_stream.py``.

  * :func:`stream_row_slices_ref` -- the plain version:
    ``out[i, :] = padded[clamp(starts[i], 0, m) : ... + budget]``, with
    ``padded`` = ``col_idx`` followed by ``budget`` zeros;
  * :func:`stream_row_slices_cuda` -- the kernel, ``csrc/csr_stream.cu``,
    whose staging (``csrc/csr_stream.cuh``) the BFS drain kernel B3 runs
    too;
  * :func:`stream_row_slices` -- the kernel for CUDA tensors, the plain
    version for CPU tensors;
  * :func:`expand_stream` -- the merge-path expansion whose neighbor gather
    reads the streamed slices, ``nbr = slices[owner, rank]``.  The
    merge-path layout makes it equal to the flat gather: every in-range
    unit's rank is below its owner's degree, which is at most the budget.
    On a slotted graph each chunk streams its slab span instead,
    ``SLAB_SLACK * (budget + G)`` words from ``slab_ptr[head]``, and a unit
    past its row's slab prefix reads the overlay tail from its own flat
    array (the reference's overlay arm).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ...core.backend import resolve_backend
from ...core.frontier import (Expansion, chunk_degrees, chunk_row_of,
                              inclusive_scan, searchsorted_right)
from ...graph.slotted import SLAB_SLACK
from ..build import check_launch, load

_I32 = torch.int32


def stream_row_slices_ref(col_idx: torch.Tensor, starts: torch.Tensor,
                          budget: int) -> torch.Tensor:
    """``[n_items, budget]`` int32: ``col_idx[starts[i] : starts[i]+budget]``
    per item, zero past the end of ``col_idx``; starts are clamped into
    ``[0, m]``.  No items give ``[0, budget]``."""
    n_items = starts.shape[0]
    if n_items == 0:
        return torch.zeros((0, budget), dtype=col_idx.dtype,
                           device=col_idx.device)
    m = col_idx.shape[0]
    padded = torch.cat([col_idx, col_idx.new_zeros(budget)])
    # row r of the window view is padded[r : r + budget], for r in [0, m]
    windows = padded.unfold(0, budget, 1)
    return windows[torch.clamp(starts.to(_I32), 0, m).long()]


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = load("csr_stream").csr_stream_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def stream_row_slices_cuda(col_idx: torch.Tensor, starts: torch.Tensor,
                           budget: int) -> torch.Tensor:
    """The B4 kernel: bit-equal to :func:`stream_row_slices_ref` for int32
    ``col_idx`` and ``starts`` on one CUDA device.  Launches on the current
    stream and does not synchronize."""
    if not (col_idx.is_cuda and starts.is_cuda
            and col_idx.device == starts.device):
        raise ValueError(f"stream_row_slices_cuda needs both tensors on one "
                         f"CUDA device, got {col_idx.device} and "
                         f"{starts.device}")
    if col_idx.dtype != _I32 or starts.dtype != _I32:
        raise ValueError(f"col_idx and starts must be int32, got "
                         f"{col_idx.dtype} and {starts.dtype}")
    if col_idx.dim() != 1 or starts.dim() != 1:
        raise ValueError("col_idx and starts must be 1-D")
    if not (col_idx.is_contiguous() and starts.is_contiguous()):
        raise ValueError("col_idx and starts must be contiguous")
    m = col_idx.shape[0]
    if budget < 0 or m + budget >= 2 ** 31:
        raise ValueError(f"budget {budget} with {m} columns is out of the "
                         f"kernel's int32 range")
    out = torch.empty((starts.shape[0], budget), dtype=_I32,
                      device=col_idx.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(col_idx.device):
        err = _launch_fn()(starts.data_ptr(), starts.shape[0],
                           col_idx.data_ptr(), m, budget, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    check_launch(err, "csr_stream")
    stream_row_slices_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
stream_row_slices_cuda.launches = 0


def stream_row_slices(col_idx: torch.Tensor, starts: torch.Tensor,
                      budget: int) -> torch.Tensor:
    """The row-slice stream: the kernel for CUDA tensors, its plain version
    for CPU tensors."""
    if col_idx.is_cuda:
        return stream_row_slices_cuda(col_idx, starts, budget)
    return stream_row_slices_ref(col_idx, starts, budget)


def expand_stream(items: torch.Tensor, valid: torch.Tensor,
                  row_ptr: torch.Tensor, col_idx: torch.Tensor,
                  work_budget: int, widths: torch.Tensor | None = None,
                  max_width: int = 1, overlay=None,
                  backend: str = "auto") -> Expansion:
    """Merge-path expansion over streamed row slices; bit-identical to
    ``core.frontier.expand_merge_path`` on the flat gather.

    ``backend`` picks the stream: ``"torch"`` its plain version, otherwise
    :func:`stream_row_slices` (the kernel for CUDA tensors).  Every popped
    item streams a full ``work_budget``-long slice, ``n_items x
    work_budget`` words in all, as in the reference.

    With an ``overlay`` (a slotted graph; ``col_idx`` is its slab array), a
    chunk's slab span is at most ``SLAB_SLACK * (degree_sum + width) <=
    SLAB_SLACK * (work_budget + max_width)`` words by the slab-slack
    invariant, so one slice of that length from ``slab_ptr[head]`` holds
    every member row's slab; the overlay tail is read from its own flat
    array.
    """
    stream = (stream_row_slices_ref
              if resolve_backend(backend, row_ptr) == "torch"
              else stream_row_slices)
    safe = torch.where(valid, items, 0)
    deg = chunk_degrees(items, widths, valid, row_ptr)
    scan, total = inclusive_scan(deg)
    k = torch.arange(work_budget, dtype=_I32, device=items.device)
    owner = searchsorted_right(scan, k)
    owner = torch.clamp(owner, 0, items.shape[0] - 1)
    excl = scan - deg
    rank = k - excl[owner]
    head = safe[owner]
    src = (head if widths is None else
           chunk_row_of(row_ptr, head, rank, widths[owner], max_width))
    in_range = k < total
    if overlay is None:
        slices = stream(col_idx, row_ptr[safe].contiguous(), work_budget)
        nbr = slices[owner.long(),
                     torch.clamp(rank, 0, work_budget - 1).long()]
    else:
        slab_budget = SLAB_SLACK * (work_budget + max_width)
        slices = stream(col_idx, overlay.slab_ptr[safe].contiguous(),
                        slab_budget)
        off = row_ptr[head] + rank - row_ptr[src]
        s_idx = overlay.slab_ptr[src] + off - overlay.slab_ptr[head]
        s_val = slices[owner.long(),
                       torch.clamp(s_idx, 0, slab_budget - 1).long()]
        o_idx = overlay.ovl_ptr[src] + off - overlay.slab_len[src]
        o_val = overlay.ovl_col[
            torch.clamp(o_idx, 0, overlay.ovl_col.shape[0] - 1).long()]
        nbr = torch.where(off < overlay.slab_len[src], s_val, o_val)
    return Expansion(
        src=torch.where(in_range, src, 0),
        nbr=torch.where(in_range, nbr, 0),
        owner=torch.where(in_range, owner, 0),
        valid=in_range,
        total=total,
    )
