"""Kernel B3-pr wrapper: asynchronous PageRank's whole drain in one
cooperative launch, ``csrc/pagerank_drain.cu``.

Replaces the TPU kernel ``make_fused_drain`` / ``fused_drain_pallas`` of
``repro/kernels/drain_loop/kernel.py`` for the PageRank program at every
granularity 1 <= G <= 64.  The drain computes exactly what
``fused_drain_ref`` over the port's PageRank step computes: the queue,
``rank``, ``residue``, ``in_queue``, the rescan cursor, the WorkCounter
(splits included), rounds and processed items, bit for bit; each target's
contributions are added in unit order, as ``kernels/scatter_add`` adds
them on the persistent path.  The carry picks the mode: a packed lane of
the fused topology is the fused mode (B3-fused), a trace ring as the fifth
leaf the traced mode (B3-traced), an ``overlay`` (a streaming graph's
slotted view, ``col_idx`` its slab array) the slotted mode (B3-slotted).
See the note in the source for its structure and what bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load
from .launch import (check_operand, check_packed, chunk_operands, lane_of,
                     launch_plan, pack_cursors, ring_args, ring_of,
                     slotted_operands, unpack_carry, window_words)

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("pagerank_drain")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.pagerank_drain_grid.argtypes = [i, i, i, i, i, ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
    lib.pagerank_drain_grid.restype = i
    lib.pagerank_drain_launch.argtypes = (
        [p, i, p, p, p, i, p, p, i] + [p] * 5
        + [i, i, i, f, f, i, i, i, i] + [p] * 21 + [i, p, i, p, i, p])
    lib.pagerank_drain_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, wavefront: int, granularity: int, packed: bool,
          traced: bool, slotted: bool):
    """``(blocks, wavefront in shared memory)`` of the launch, read once per
    device, wavefront, granularity and mode."""
    return launch_plan(_lib().pagerank_drain_grid, "pagerank_drain",
                       device_index, wavefront, granularity, int(packed),
                       int(traced), int(slotted))


def pagerank_drain_cuda(carry, row_ptr: torch.Tensor, col_idx: torch.Tensor,
                        *, wavefront: int, budget: int, n_check: int,
                        damping: float, eps: float, max_rounds: int,
                        limit=None, granularity: int = 1,
                        split_threshold=None, overlay=None):
    """Drain ``carry = (queue, PRState, rounds, processed[, ring])`` in one
    launch, ``while rounds < min(max_rounds, limit) and max(residue) >
    eps``.  ``queue`` is a TaskQueue or a one-lane MultiQueue of packed
    tasks (the fused mode); a TraceRing as the fifth leaf gets one row a
    round (the traced mode) and comes back as a fresh copy.  With an
    ``overlay`` (``graph.slotted.Overlay``) the graph is a slotted view:
    ``col_idx`` is its slab array and the kernel reads each unit's word
    through the slab and the overlay (the slotted mode).

    Returns the new carry; its queue buffer, ``rank``, ``residue`` and
    ``in_queue`` are fresh copies that the kernel updated in place, its
    scalars views of one int32 tensor.  ``limit`` (an int or a 0-dim
    tensor) cuts the drain at an absolute round.  ``granularity`` and
    ``split_threshold`` are the program's chunking
    (``algorithms.common.chunking_for``).  Launches on the current stream,
    allocates its scratch with PyTorch and makes no host sync.
    """
    state = carry[1]
    lane_buf, _, _, _, packed = lane_of(carry[0])
    device = row_ptr.device
    for name, t, dtype in (("row_ptr", row_ptr, _I32),
                           ("col_idx", col_idx, _I32),
                           ("queue.buf", lane_buf, _I32),
                           ("rank", state.rank, torch.float32),
                           ("residue", state.residue, torch.float32),
                           ("in_queue", state.in_queue, torch.bool)):
        check_operand("pagerank_drain_cuda", name, t, device, dtype)
    n, m, cap = state.rank.shape[0], col_idx.shape[0], lane_buf.shape[0]
    if row_ptr.shape[0] != n + 1 or n < 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"{n} vertices")
    if wavefront < 1 or budget < 1 or cap < 1 or max_rounds < 0 \
            or not 1 <= n_check <= n:
        raise ValueError(f"wavefront {wavefront}, budget {budget}, capacity "
                         f"{cap}, max_rounds {max_rounds} and n_check "
                         f"{n_check} (at most n = {n}) must be positive")
    if m + budget >= 2 ** 31 or n_check + wavefront >= 2 ** 31:
        raise ValueError("the graph and budget exceed the kernel's int32 "
                         "range")
    codec = chunk_operands("pagerank_drain_cuda", n, granularity,
                           split_threshold)
    if packed:
        check_packed("pagerank_drain_cuda", n, granularity)
    slotted = slotted_operands("pagerank_drain_cuda", overlay, n, device)
    ring = ring_of("pagerank_drain_cuda", carry, device)
    grid, wave_in_shared = _grid(device.index, wavefront, granularity,
                                 packed, ring is not None, overlay is not None)

    cursors = pack_cursors(carry, limit, max_rounds, device,
                           state.check_cursor)
    buf = lane_buf.clone()
    rank = state.rank.clone()
    residue = state.residue.clone()
    in_queue = state.in_queue.clone()
    # scratch: the unit arrays, the per-target segment words (counts and
    # starts zeroed), the rows' truncation rounds (zeroed), the dedup words
    # (all ones), the windows, then the small arrays
    i32 = functools.partial(torch.empty, dtype=_I32, device=device)
    units5 = i32(5 * budget)
    unit_contrib = units5[budget:2 * budget].view(torch.float32)
    seg_contrib = units5[4 * budget:].view(torch.float32)
    seg_words = torch.zeros(3 * n, dtype=_I32, device=device)
    first_lane = torch.full((n,), -1, dtype=torch.int64, device=device)
    lane_res = torch.empty(wavefront * granularity, dtype=torch.float32,
                           device=device)
    windows = window_words(n, granularity, device)
    small = torch.zeros(2 * grid + 4, dtype=_I32, device=device)
    long_segs = i32(budget)
    scan_keep = i32(n_check)
    wave = (None if wave_in_shared else i32(grid * 2 * wavefront))
    units = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().pagerank_drain_launch(
            buf.data_ptr(), cap, rank.data_ptr(), residue.data_ptr(),
            in_queue.data_ptr(), n, row_ptr.data_ptr(), col_idx.data_ptr(),
            m, *slotted, cursors.data_ptr(), wavefront, budget, n_check,
            float(damping), float(eps), max_rounds, *codec,
            first_lane.data_ptr(), lane_res.data_ptr(), units5.data_ptr(),
            unit_contrib.data_ptr(), units5[2 * budget:].data_ptr(),
            units5[3 * budget:].data_ptr(), seg_contrib.data_ptr(),
            seg_words.data_ptr(), seg_words[n:].data_ptr(),
            small[2 * grid + 1:].data_ptr(), long_segs.data_ptr(),
            small[2 * grid + 3:].data_ptr(), scan_keep.data_ptr(),
            seg_words[2 * n:].data_ptr(),
            windows.data_ptr(), small[2 * grid + 2:].data_ptr(),
            small.data_ptr(), small[grid:2 * grid].data_ptr(),
            small[2 * grid:2 * grid + 1].data_ptr(),
            None if wave is None else wave.data_ptr(), units.data_ptr(),
            int(packed), *ring_args(ring), grid,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "pagerank_drain")
    pagerank_drain_cuda.launches += 1
    pagerank_drain_cuda.units_expanded = units
    return unpack_carry(carry, buf, cursors, extra=("check_cursor",),
                        ring=ring, rank=rank, residue=residue,
                        in_queue=in_queue)


#: launches of the kernel since the count was last set to 0
pagerank_drain_cuda.launches = 0
#: 0-dim int64 device tensor: the work units the last launch expanded
pagerank_drain_cuda.units_expanded = None
