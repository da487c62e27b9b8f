"""What the drain kernels' wrappers share: operand checks, the launch
plan, the chunk codec's operands and the coalescing windows, and the
carry's scalars packed into one int32 tensor for the kernel and unpacked
from it after (``bfs_drain``, ``pagerank_drain``, ``coloring_drain``)."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...core.counters import WorkCounter
from ...core.task import MAX_GRANULARITY
from ..build import check_launch

_I32 = torch.int32
INT_MAX = 2 ** 31 - 1

#: the carry's scalars in the order the kernels read them (csrc
#: drain_common.cuh, enum Cursor); a program's own scalars follow
CURSORS = ("head", "tail", "dropped", "rounds", "processed", "work",
           "splits", "counter_rounds", "limit")


def check_operand(who: str, name: str, t: torch.Tensor, device,
                  dtype=_I32) -> None:
    """Raise unless ``t`` is contiguous, of ``dtype``, on ``device`` (the
    CUDA device of the graph)."""
    if not (t.is_cuda and t.device == device):
        raise ValueError(f"{who} needs {name} on the CUDA device of row_ptr, "
                         f"got {t.device} and {device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}")


def chunk_operands(who: str, n: int, granularity: int,
                   split_threshold) -> tuple:
    """``(granularity, width_bits, threshold)`` for a kernel's chunk codec
    and windows (``csrc/drain_common.cuh``), the threshold ``INT_MAX`` where
    there is none.  Raises where a chunk code of a vertex would leave the
    int32 range."""
    if not 1 <= granularity <= MAX_GRANULARITY:
        raise ValueError(f"{who}: granularity must be in [1, "
                         f"{MAX_GRANULARITY}], got {granularity}")
    bits = (granularity - 1).bit_length()
    if n << bits >= 2 ** 31:
        raise ValueError(f"{who}: {n} vertices at granularity {granularity} "
                         f"exceed the int32 chunk codes")
    threshold = INT_MAX if split_threshold is None else int(split_threshold)
    return granularity, bits, min(threshold, INT_MAX)


def window_words(n: int, granularity: int, device) -> torch.Tensor:
    """The coalescing windows' zeroed 64-bit words: count, least and
    largest id of each of the ``n // G + 2`` G-aligned windows."""
    return torch.zeros(3 * (n // granularity + 2), dtype=torch.int64,
                       device=device)


def launch_plan(plan_fn, label: str, device_index: int, *args):
    """``(blocks, wavefront in shared memory)`` from a kernel's C plan
    function ``plan_fn(*args, int* grid, int* wave_in_shared)``."""
    grid, shared = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = plan_fn(*args, ctypes.byref(grid), ctypes.byref(shared))
    check_launch(err, f"{label} (launch plan)")
    return grid.value, bool(shared.value)


def pack_cursors(carry, limit, max_rounds: int, device, *extra):
    """One int32 tensor: the carry's scalars in CURSORS order, the round
    ``limit`` (an int, a 0-dim tensor, or None for ``max_rounds``), then
    ``extra`` 0-dim tensors of the program's own."""
    queue, state, rounds, processed = carry
    if limit is None:
        limit = max_rounds
    if not isinstance(limit, torch.Tensor):
        limit = torch.full((), min(int(limit), 2 ** 31 - 1), dtype=_I32,
                           device=device)
    counter = state.counter
    return torch.stack([
        t.to(device=device, dtype=_I32).reshape(())
        for t in (queue.head, queue.tail, queue.dropped, rounds, processed,
                  counter.work, counter.splits, counter.rounds, limit,
                  *extra)])


def unpack_carry(carry, buf: torch.Tensor, cursors: torch.Tensor,
                 extra=(), **state_fields):
    """The carry after a launch: the queue with ``buf`` and the kernel's
    cursors, the state with ``state_fields``, the ``extra`` scalars named
    as the state's fields, and a WorkCounter of views of ``cursors``."""
    queue, state, _, _ = carry
    c = dict(zip(CURSORS + tuple(extra), cursors.unbind()))
    queue = dataclasses.replace(queue, buf=buf, head=c["head"],
                                tail=c["tail"], dropped=c["dropped"])
    state = dataclasses.replace(
        state, **state_fields, **{name: c[name] for name in extra},
        counter=WorkCounter(work=c["work"], splits=c["splits"],
                            rounds=c["counter_rounds"]))
    return queue, state, c["rounds"], c["processed"]
