"""Kernel B3 wrapper: speculative BFS's whole drain in one cooperative
launch, ``csrc/bfs_drain.cu``.

Replaces the TPU kernel ``make_fused_drain`` / ``fused_drain_pallas`` of
``repro/kernels/drain_loop/kernel.py`` for the BFS program at granularity
1 with merge-path expansion.  The drain computes exactly what
``fused_drain_ref`` over the port's BFS step computes: the queue, ``dist``,
the WorkCounter, rounds and processed items, bit for bit.  See the note in
the source for its structure and what bounds it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load
from .launch import check_operand, launch_plan, pack_cursors, unpack_carry

_I32 = torch.int32


@functools.lru_cache(maxsize=None)
def _lib():
    lib = load("bfs_drain")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bfs_drain_grid.argtypes = [i, ctypes.POINTER(i), ctypes.POINTER(i)]
    lib.bfs_drain_grid.restype = i
    lib.bfs_drain_launch.argtypes = [p, i, p, i, p, p, i, p, i, i, i, p, p,
                                     p, p, p, p, p, i, p]
    lib.bfs_drain_launch.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _grid(device_index: int, wavefront: int):
    """``(blocks, wavefront in shared memory)`` of the launch, read once per
    device and wavefront."""
    return launch_plan(_lib().bfs_drain_grid, "bfs_drain", device_index,
                       wavefront)


def bfs_drain_cuda(carry, row_ptr: torch.Tensor, col_idx: torch.Tensor, *,
                   wavefront: int, budget: int, max_rounds: int, limit=None):
    """Drain ``carry = (queue, BFSState, rounds, processed)`` in one launch,
    ``while rounds < min(max_rounds, limit) and queue.size > 0``.

    Returns the new carry; its queue buffer and ``dist`` are fresh copies
    that the kernel updated in place, its scalars views of one int32
    tensor.  ``limit`` (an int or a 0-dim tensor) cuts the drain at an
    absolute round.  Launches on the current stream, allocates its scratch
    with PyTorch and makes no host sync.
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
    if m + budget >= 2 ** 31 or budget + wavefront >= 2 ** 31:
        raise ValueError("the graph and budget exceed the kernel's int32 "
                         "range")
    grid, wave_in_shared = _grid(device.index, wavefront)
    cursors = pack_cursors(carry, limit, max_rounds, device)
    buf = queue.buf.clone()
    dist = state.dist.clone()
    # scratch: unit nbr and candidate, then the block counts and the two
    # barrier words (zeroed), then the wavefront copies when they do not
    # fit in shared memory
    units = torch.empty(2 * budget, dtype=_I32, device=device)
    small = torch.zeros(grid + 2, dtype=_I32, device=device)
    wave = (None if wave_in_shared else
            torch.empty(grid * 2 * wavefront, dtype=_I32, device=device))
    first_unit = torch.full((n,), -1, dtype=torch.int64, device=device)
    units_expanded = torch.zeros((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = _lib().bfs_drain_launch(
            buf.data_ptr(), cap, dist.data_ptr(), n, row_ptr.data_ptr(),
            col_idx.data_ptr(), m, cursors.data_ptr(), wavefront, budget,
            max_rounds, units.data_ptr(), units[budget:].data_ptr(),
            first_unit.data_ptr(), small.data_ptr(),
            small[grid:].data_ptr(),
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
