"""Kernel B3 wrapper: speculative BFS's whole drain in one cooperative
launch, ``csrc/bfs_drain.cu``.

Replaces the TPU kernel ``make_fused_drain`` / ``fused_drain_pallas`` of
``repro/kernels/drain_loop/kernel.py`` for the BFS program at every
granularity 1 <= G <= 64, with merge-path or per_item expansion.  The
drain computes exactly what ``fused_drain_ref`` over the port's BFS step
computes: the queue, ``dist``, the WorkCounter (splits included), rounds
and processed items, bit for bit.  See the note in the source for its
structure and what bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load
from .launch import (INT_MAX, check_operand, chunk_operands, launch_plan,
                     pack_cursors, unpack_carry, window_words)

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("bfs_drain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bfs_drain_grid.argtypes = [i, i, ctypes.POINTER(i),
                                   ctypes.POINTER(i)]
    lib.bfs_drain_grid.restype = i
    lib.bfs_drain_launch.argtypes = ([p, i, p, i, p, p, i, p, i, i, i, i, i,
                                      i, i] + [p] * 9 + [i, p])
    lib.bfs_drain_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, wavefront: int, granularity: int):
    """``(blocks, wavefront in shared memory)`` of the launch, read once per
    device, wavefront and granularity."""
    return launch_plan(_lib().bfs_drain_grid, "bfs_drain", device_index,
                       wavefront, granularity)


def bfs_drain_cuda(carry, row_ptr: torch.Tensor, col_idx: torch.Tensor, *,
                   wavefront: int, budget: int, max_rounds: int, limit=None,
                   granularity: int = 1, split_threshold=None,
                   per_item: bool = False, max_chunk_degree=None):
    """Drain ``carry = (queue, BFSState, rounds, processed)`` in one launch,
    ``while rounds < min(max_rounds, limit) and queue.size > 0``.

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
    queue, state, _, _ = carry
    device = row_ptr.device
    for name, t in (("row_ptr", row_ptr), ("col_idx", col_idx),
                    ("queue.buf", queue.buf), ("dist", state.dist)):
        check_operand("bfs_drain_cuda", name, t, device)
    n, m, cap = state.dist.shape[0], col_idx.shape[0], queue.buf.shape[0]
    if row_ptr.shape[0] != n + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"{n} vertices")
    if wavefront < 1 or budget < 1 or cap < 1 or max_rounds < 0:
        raise ValueError(f"wavefront {wavefront}, budget {budget}, capacity "
                         f"{cap} and max_rounds {max_rounds} must be "
                         f"positive")
    codec = chunk_operands("bfs_drain_cuda", n, granularity,
                           split_threshold)
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
    grid, wave_in_shared = _grid(device.index, wavefront, granularity)
    cursors = pack_cursors(carry, limit, max_rounds, device)
    buf = queue.buf.clone()
    dist = state.dist.clone()
    # scratch: the units' nbr (merge path), the dedup and least-cand words
    # (all ones), the windows, then the split count, the block counts and
    # the two barrier words (zeroed), then the wavefront copies when they do
    # not fit in shared memory
    unit_nbr = torch.empty(max(stored, 1), dtype=_I32, device=device)
    words = torch.full((2 * n,), -1, dtype=torch.int64, device=device)
    windows = window_words(n, granularity, device)
    small = torch.zeros(grid + 3, dtype=_I32, device=device)
    wave = (None if wave_in_shared else
            torch.empty(grid * 2 * wavefront, dtype=_I32, device=device))
    units_expanded = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().bfs_drain_launch(
            buf.data_ptr(), cap, dist.data_ptr(), n, row_ptr.data_ptr(),
            col_idx.data_ptr(), m, cursors.data_ptr(), wavefront, budget,
            stored, max_rounds, *codec, unit_nbr.data_ptr(),
            words.data_ptr(), words[n:].data_ptr(), windows.data_ptr(),
            small[grid + 2:].data_ptr(), small.data_ptr(),
            small[grid:grid + 2].data_ptr(),
            None if wave is None else wave.data_ptr(),
            units_expanded.data_ptr(), grid,
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "bfs_drain")
    bfs_drain_cuda.launches += 1
    bfs_drain_cuda.units_expanded = units_expanded
    return unpack_carry(carry, buf, cursors, dist=dist)


#: launches of the kernel since the count was last set to 0
bfs_drain_cuda.launches = 0
#: 0-dim int64 device tensor: the work units the last launch expanded
#: through the row-slice stream (csrc/csr_stream.cuh), summed over rounds
bfs_drain_cuda.units_expanded = None
