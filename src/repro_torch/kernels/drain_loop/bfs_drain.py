"""Kernel B3 wrapper: speculative BFS's whole drain in one cooperative
launch, ``csrc/bfs_drain.cu``.

Replaces the TPU kernel ``make_fused_drain`` / ``fused_drain_pallas`` of
``repro/kernels/drain_loop/kernel.py`` for the BFS program at every
granularity 1 <= G <= 64, with merge-path or per_item expansion.  The
drain computes exactly what ``fused_drain_ref`` over the port's BFS step
computes: the queue, ``dist``, the WorkCounter (splits included), rounds
and processed items, bit for bit.  The carry picks the mode: a packed lane
of the fused topology is the fused mode (B3-fused), a trace ring as the
fifth leaf the traced mode (B3-traced), whose rows equal what
``runtime.api.instrument_step`` records; an ``overlay`` (a streaming
graph's slotted view, ``col_idx`` its slab array) is the slotted mode
(B3-slotted).  See the note in the source for its structure and what
bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load
from .launch import (INT_MAX, check_operand, check_packed, chunk_operands,
                     lane_of, launch_plan, pack_cursors, ring_args, ring_of,
                     slotted_operands, unpack_carry, window_words)

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("bfs_drain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bfs_drain_grid.argtypes = [i, i, i, i, i, ctypes.POINTER(i),
                                   ctypes.POINTER(i)]
    lib.bfs_drain_grid.restype = i
    lib.bfs_drain_launch.argtypes = ([p, i, p, i, p, p, i] + [p] * 5
                                     + [i] * 7 + [p] * 9 + [i] + [p] * 3
                                     + [i, p, i, p, i, p])
    lib.bfs_drain_launch.restype = i
    lib.bfs_drain_tile_positions.argtypes = []
    lib.bfs_drain_tile_positions.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, wavefront: int, granularity: int, packed: bool,
          traced: bool, slotted: bool):
    """``(blocks, wavefront in shared memory)`` of the launch, read once per
    device, wavefront, granularity and mode."""
    return launch_plan(_lib().bfs_drain_grid, "bfs_drain", device_index,
                       wavefront, granularity, int(packed), int(traced),
                       int(slotted))


def bfs_drain_cuda(carry, row_ptr: torch.Tensor, col_idx: torch.Tensor, *,
                   wavefront: int, budget: int, max_rounds: int, limit=None,
                   granularity: int = 1, split_threshold=None,
                   per_item: bool = False, max_chunk_degree=None,
                   overlay=None):
    """Drain ``carry = (queue, BFSState, rounds, processed[, ring])`` in
    one launch, ``while rounds < min(max_rounds, limit) and queue.size >
    0``.  ``queue`` is a TaskQueue or a one-lane MultiQueue of packed tasks
    (the fused mode); a TraceRing as the fifth leaf gets one row a round
    (the traced mode) and comes back as a fresh copy.  With an ``overlay``
    (``graph.slotted.Overlay``) the graph is a slotted view: ``col_idx`` is
    its slab array and the kernel reads each unit's word through the slab
    and the overlay (the slotted mode).

    ``granularity`` and ``split_threshold`` are the program's chunking
    (``algorithms.common.chunking_for``).  Merge path expands at most
    ``budget`` units a round and re-queues a chunk past it whole;
    ``per_item`` expands every unit, and ``max_chunk_degree`` (the largest
    degree sum of G consecutive rows) bounds its wavefront's units for the
    int32 range check.  Returns the new carry; its queue buffer and
    ``dist`` are fresh copies that the kernel updated in place, its scalars
    views of one int32 tensor.  ``limit`` (an int or a 0-dim tensor) cuts
    the drain at an absolute round.  Launches on the current stream,
    allocates its scratch with PyTorch and makes no host sync.
    """
    state = carry[1]
    lane_buf, _, _, _, packed = lane_of(carry[0])
    device = row_ptr.device
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx),
                    ("queue.buf", lane_buf), ("dist", state.dist)):
        check_operand("bfs_drain_cuda", name, t, device)
    n, m, cap = state.dist.shape[0], col_idx.shape[0], lane_buf.shape[0]
    if row_ptr.shape[0] != n + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"{n} vertices")
    if wavefront < 1 or budget < 1 or cap < 1 or max_rounds < 0:
        raise ValueError(f"wavefront {wavefront}, budget {budget}, capacity "
                         f"{cap} and max_rounds {max_rounds} must be "
                         f"positive")
    codec = chunk_operands("bfs_drain_cuda", n, granularity,
                           split_threshold)
    if packed:
        check_packed("bfs_drain_cuda", n, granularity)
    if per_item:
        # no truncation: a round's units are bounded by W chunks of the
        # largest degree sum.  The rows of a round need not be distinct (a
        # carry may hold a vertex twice), so the sum of the W G largest
        # degrees would not bound them.
        if max_chunk_degree is None:
            raise ValueError("per_item needs max_chunk_degree")
        units_bound = wavefront * max(int(max_chunk_degree), 1)
        budget, stored = INT_MAX, 0
    else:
        units_bound, stored = budget, budget
    if m + units_bound >= 2 ** 31 or units_bound + wavefront >= 2 ** 31:
        raise ValueError("the graph and the round's units exceed the "
                         "kernel's int32 range")
    slotted = slotted_operands("bfs_drain_cuda", overlay, n, device)
    ring = ring_of("bfs_drain_cuda", carry, device)
    grid, wave_in_shared = _grid(device.index, wavefront, granularity,
                                 packed, ring is not None, overlay is not None)
    cursors = pack_cursors(carry, limit, max_rounds, device)
    buf = lane_buf.clone()
    dist = state.dist.clone()
    # scratch: the units' nbr (merge path), the dedup and least-cand words
    # (all ones), the windows, the next wavefront's lane data, the tiles'
    # status words, then the barrier's word and the split count (zeroed),
    # then the wavefront copies when they do not fit in shared memory
    unit_nbr = torch.empty(max(stored, 1), dtype=_I32, device=device)
    words = torch.full((2 * n,), -1, dtype=torch.int64, device=device)
    windows = window_words(n, granularity, device)
    lanes = torch.empty(3 * wavefront, dtype=_I32, device=device)
    tiles_cap = max(grid, -(-(units_bound + wavefront)
                            // _lib().bfs_drain_tile_positions()))
    status = torch.zeros(tiles_cap + 1, dtype=torch.int64, device=device)
    small = status[tiles_cap:].view(_I32)
    wave = (None if wave_in_shared else
            torch.empty(grid * 4 * wavefront, dtype=_I32, device=device))
    units_expanded = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().bfs_drain_launch(
            buf.data_ptr(), cap, dist.data_ptr(), n, row_ptr.data_ptr(),
            col_idx.data_ptr(), m, *slotted, cursors.data_ptr(), wavefront,
            budget,
            stored, max_rounds, *codec, unit_nbr.data_ptr(),
            words.data_ptr(), words[n:].data_ptr(), windows.data_ptr(),
            small[1:].data_ptr(), lanes.data_ptr(),
            lanes[wavefront:].data_ptr(), lanes[2 * wavefront:].data_ptr(),
            status.data_ptr(), tiles_cap,
            small.data_ptr(), None if wave is None else wave.data_ptr(),
            units_expanded.data_ptr(), int(packed), *ring_args(ring), grid,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bfs_drain")
    bfs_drain_cuda.launches += 1
    bfs_drain_cuda.units_expanded = units_expanded
    return unpack_carry(carry, buf, cursors, ring=ring, dist=dist)


#: launches of the kernel since the count was last set to 0
bfs_drain_cuda.launches = 0
#: 0-dim int64 device tensor: the work units the last launch expanded,
#: summed over rounds
bfs_drain_cuda.units_expanded = None
