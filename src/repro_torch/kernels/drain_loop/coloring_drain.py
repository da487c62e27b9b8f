"""Kernel B3-col wrapper: speculative greedy coloring's whole drain in one
cooperative launch, ``csrc/coloring_drain.cu``.

Replaces the TPU kernel ``make_fused_drain`` / ``fused_drain_pallas`` of
``repro/kernels/drain_loop/kernel.py`` for the coloring program at every
granularity 1 <= G <= 64.  The drain computes exactly what
``fused_drain_ref`` over the port's fused assign/detect step computes: the
queue, ``colors``, the WorkCounter (splits included), rounds and processed
items, bit for bit.  The carry picks the mode: a packed lane of the fused
topology is the fused mode (B3-fused), a trace ring as the fifth leaf the
traced mode (B3-traced), an ``overlay`` (a streaming graph's slotted view,
``col_idx`` its slab array) the slotted mode (B3-slotted).  See the note in
the source for its structure and what bounds it.

Its per-lane marks and forbidden-color bitsets stay on the card between
launches, one set per device and stream, grown when a launch needs more:
every launch leaves them zero, so no launch clears them.
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

#: (device index, stream handle) -> (bad int32, bits int32), both zero
#: between launches
_SCRATCH: dict = {}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("coloring_drain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coloring_drain_grid.argtypes = [i, i, i, i, i, ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
    lib.coloring_drain_grid.restype = i
    lib.coloring_drain_launch.argtypes = ([p, i, p, i, p, p] + [p] * 5
                                          + [i, i, i, i, i, p, p, i]
                                          + [p] * 7 + [i, p, i, p, i, p])
    lib.coloring_drain_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, wavefront: int, granularity: int,
          packed: bool, traced: bool, slotted: bool):
    """``(blocks, wavefront in shared memory)`` of the launch."""
    return launch_plan(_lib().coloring_drain_grid, "coloring_drain",
                       device_index, wavefront, granularity, int(packed),
                       int(traced), int(slotted))


def _scratch(device: torch.device, stream: int, lanes: int,
             words: int) -> tuple:
    """The marks (``lanes`` ints) and bitsets (``words`` words) of
    ``stream`` on ``device``; a grown buffer is new zeros."""
    bad, bits = _SCRATCH.get((device.index, stream), (None, None))
    if bad is None or bad.numel() < lanes:
        bad = torch.zeros(lanes, dtype=_I32, device=device)
    if bits is None or bits.numel() < words:
        bits = torch.zeros(words, dtype=_I32, device=device)
    _SCRATCH[(device.index, stream)] = (bad, bits)
    return bad, bits


def coloring_drain_cuda(carry, row_ptr: torch.Tensor, col_idx: torch.Tensor,
                        *, wavefront: int, degree_budget: int,
                        max_rounds: int, limit=None, granularity: int = 1,
                        split_threshold=None, overlay=None):
    """Drain ``carry = (queue, ColorState, rounds, processed[, ring])`` in
    one launch, ``while rounds < min(max_rounds, limit) and queue.size >
    0``.  ``queue`` is a TaskQueue or a one-lane MultiQueue of packed tasks
    (the fused mode); a TraceRing as the fifth leaf gets one row a round
    (the traced mode) and comes back as a fresh copy.  With an ``overlay``
    (``graph.slotted.Overlay``) the graph is a slotted view: ``col_idx`` is
    its slab array and a row's neighbors are its slab prefix and overlay
    tail (the slotted mode).

    ``degree_budget`` is at least the degree sum of any ``wavefront *
    granularity`` distinct vertices (the program's flat budget, read once
    when it is built); it sizes the forbidden-color bitsets, and a round
    past it traps.  ``granularity`` and ``split_threshold`` are the
    program's chunking
    (``algorithms.common.chunking_for``).  Returns the new carry; its
    queue buffer and ``colors`` are fresh copies that the kernel updated in
    place, its scalars views of one int32 tensor.  Launches on the current
    stream, allocates its scratch with PyTorch and makes no host sync.
    """
    state = carry[1]
    lane_buf, _, _, _, packed = lane_of(carry[0])
    device = row_ptr.device
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx),
                    ("queue.buf", lane_buf), ("colors", state.colors)):
        check_operand("coloring_drain_cuda", name, t, device)
    n, cap = state.colors.shape[0], lane_buf.shape[0]
    if row_ptr.shape[0] != n + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"{n} vertices")
    if wavefront < 1 or cap < 1 or max_rounds < 0 or degree_budget < 0:
        raise ValueError(f"wavefront {wavefront}, capacity {cap}, max_rounds "
                         f"{max_rounds} and degree_budget {degree_budget} "
                         f"must be positive")
    codec = chunk_operands("coloring_drain_cuda", n, granularity,
                           split_threshold)
    if packed:
        check_packed("coloring_drain_cuda", n, granularity)
    flat = wavefront * granularity
    words = flat + degree_budget // 32 + 1
    if wavefront * (1 + granularity) >= 2 ** 31 or words >= 2 ** 31 \
            or col_idx.shape[0] >= 2 ** 31:
        raise ValueError("the graph or wavefront exceeds the kernel's int32 "
                         "range")
    slotted = slotted_operands("coloring_drain_cuda", overlay, n, device)
    ring = ring_of("coloring_drain_cuda", carry, device)
    grid, wave_in_shared = _grid(device.index, wavefront, granularity,
                                 packed, ring is not None,
                                 overlay is not None)

    cursors = pack_cursors(carry, limit, max_rounds, device)
    buf = lane_buf.clone()
    colors = state.colors.clone()
    # scratch: the next wavefront's lane degrees, the windows, then the
    # block counts, the barrier's word and the split count (zeroed), then
    # the wavefront copies when they do not fit in shared memory; the marks
    # and bitsets are the stream's
    lane_deg = torch.empty(flat, dtype=_I32, device=device)
    windows = window_words(n, granularity, device)
    small = torch.zeros(grid + 2, dtype=_I32, device=device)
    wave = (None if wave_in_shared else
            torch.empty(grid * (wavefront + flat), dtype=_I32,
                        device=device))
    visits = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        bad, bits = _scratch(device, stream, flat, words)
        err = _lib().coloring_drain_launch(
            buf.data_ptr(), cap, colors.data_ptr(), n, row_ptr.data_ptr(),
            col_idx.data_ptr(), *slotted, cursors.data_ptr(), wavefront,
            max_rounds, *codec, bad.data_ptr(), bits.data_ptr(), words,
            lane_deg.data_ptr(), windows.data_ptr(),
            small[grid + 1:].data_ptr(), small.data_ptr(),
            small[grid:grid + 1].data_ptr(),
            None if wave is None else wave.data_ptr(), visits.data_ptr(),
            int(packed), *ring_args(ring), grid, stream)
    check_launch(err, "coloring_drain")
    coloring_drain_cuda.launches += 1
    coloring_drain_cuda.visits = visits
    return unpack_carry(carry, buf, cursors, ring=ring, colors=colors)


#: launches of the kernel since the count was last set to 0
coloring_drain_cuda.launches = 0
#: 0-dim int64 device tensor: the neighbors the last launch's picks and
#: detects visited
coloring_drain_cuda.visits = None
