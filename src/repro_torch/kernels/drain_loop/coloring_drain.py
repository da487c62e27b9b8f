"""Kernel B3-col wrapper: speculative greedy coloring's whole drain in one
cooperative launch, ``csrc/coloring_drain.cu``.

Replaces the TPU kernel ``make_fused_drain`` / ``fused_drain_pallas`` of
``repro/kernels/drain_loop/kernel.py`` for the coloring program at every
granularity 1 <= G <= 64.  The drain computes exactly what
``fused_drain_ref`` over the port's fused assign/detect step computes: the
queue, ``colors``, the WorkCounter (splits included), rounds and processed
items, bit for bit.  The carry picks the mode: a packed lane of the fused
topology is the fused mode (B3-fused), a trace ring as the fifth leaf the
traced mode (B3-traced).  See the note in the source for its structure and
what bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load
from .launch import (check_operand, check_packed, chunk_operands, lane_of,
                     launch_plan, pack_cursors, ring_args, ring_of,
                     unpack_carry, window_words)

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("coloring_drain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.coloring_drain_grid.argtypes = [i, i, i, i, i, ctypes.POINTER(i),
                                        ctypes.POINTER(i)]
    lib.coloring_drain_grid.restype = i
    lib.coloring_drain_launch.argtypes = ([p, i, p, i, p, p, p, i, i, i, i,
                                           i, i] + [p] * 8
                                          + [i, p, i, p, i, p])
    lib.coloring_drain_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, wavefront: int, granularity: int,
          max_degree: int, packed: bool, traced: bool):
    """``(blocks, wavefront in shared memory)`` of the launch."""
    return launch_plan(_lib().coloring_drain_grid, "coloring_drain",
                       device_index, wavefront, granularity, max_degree,
                       int(packed), int(traced))


def coloring_drain_cuda(carry, row_ptr: torch.Tensor, col_idx: torch.Tensor,
                        *, wavefront: int, max_degree: int, max_rounds: int,
                        limit=None, granularity: int = 1,
                        split_threshold=None):
    """Drain ``carry = (queue, ColorState, rounds, processed[, ring])`` in
    one launch, ``while rounds < min(max_rounds, limit) and queue.size >
    0``.  ``queue`` is a TaskQueue or a one-lane MultiQueue of packed tasks
    (the fused mode); a TraceRing as the fifth leaf gets one row a round
    (the traced mode) and comes back as a fresh copy.

    ``max_degree`` (the graph's, read once when the program is built)
    sizes the block bitset in shared memory; ``granularity`` and
    ``split_threshold`` are the program's chunking
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
    if wavefront < 1 or cap < 1 or max_rounds < 0 or max_degree < 0:
        raise ValueError(f"wavefront {wavefront}, capacity {cap}, max_rounds "
                         f"{max_rounds} and max_degree {max_degree} must be "
                         f"positive")
    codec = chunk_operands("coloring_drain_cuda", n, granularity,
                           split_threshold)
    if packed:
        check_packed("coloring_drain_cuda", n, granularity)
    if wavefront * (1 + granularity) >= 2 ** 31 \
            or col_idx.shape[0] >= 2 ** 31:
        raise ValueError("the graph or wavefront exceeds the kernel's int32 "
                         "range")
    ring = ring_of("coloring_drain_cuda", carry, device)
    grid, wave_in_shared = _grid(device.index, wavefront, granularity,
                                 max_degree, packed, ring is not None)

    cursors = pack_cursors(carry, limit, max_rounds, device)
    buf = lane_buf.clone()
    colors = state.colors.clone()
    # scratch: pick and bad per vertex lane, the windows, then the block
    # counts, the two barrier words and the split count (zeroed), then the
    # wavefront copies when they do not fit in shared memory
    flat = wavefront * granularity
    lanes = torch.empty(2 * flat, dtype=_I32, device=device)
    windows = window_words(n, granularity, device)
    small = torch.zeros(grid + 3, dtype=_I32, device=device)
    wave = (None if wave_in_shared else
            torch.empty(grid * (wavefront + flat), dtype=_I32,
                        device=device))
    visits = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().coloring_drain_launch(
            buf.data_ptr(), cap, colors.data_ptr(), n, row_ptr.data_ptr(),
            col_idx.data_ptr(), cursors.data_ptr(), wavefront, max_rounds,
            max_degree, *codec, lanes.data_ptr(), lanes[flat:].data_ptr(),
            windows.data_ptr(), small[grid + 2:].data_ptr(),
            small.data_ptr(), small[grid:grid + 2].data_ptr(),
            None if wave is None else wave.data_ptr(), visits.data_ptr(),
            int(packed), *ring_args(ring), grid,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "coloring_drain")
    coloring_drain_cuda.launches += 1
    coloring_drain_cuda.visits = visits
    return unpack_carry(carry, buf, cursors, ring=ring, colors=colors)


#: launches of the kernel since the count was last set to 0
coloring_drain_cuda.launches = 0
#: 0-dim int64 device tensor: the neighbors the last launch's picks and
#: detects visited
coloring_drain_cuda.visits = None
