"""What the drain kernels' wrappers share: operand checks, the launch
plan, the chunk codec's operands and the coalescing windows, the task ring
and mode a carry gives (a TaskQueue, or the fused topology's packed lane;
a trace ring or none), the slotted mode's operands (a streaming graph's
slab and overlay arrays, or none), and the carry's scalars packed into one
int32 tensor for the kernel and unpacked from it after (``bfs_drain``,
``pagerank_drain``, ``coloring_drain``)."""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...core.counters import WorkCounter
from ...core.queue import MultiQueue
from ...core.task import MAX_GRANULARITY
from ...obs.ring import TraceRing
from ...obs.schema import NUM_FIELDS
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


def slotted_operands(who: str, overlay, n: int, device) -> tuple:
    """The slotted mode's four pointers (``slab_ptr``, ``slab_len``,
    ``ovl_ptr``, ``ovl_col`` of a ``graph.slotted.Overlay``), or four
    Nones -- the canonical mode -- without an overlay."""
    if overlay is None:
        return (None,) * 4
    for name, t in zip(overlay._fields, overlay):
        check_operand(who, f"overlay.{name}", t, device)
    if (overlay.slab_ptr.shape[0] != n + 1 or overlay.slab_len.shape[0] != n
            or overlay.ovl_ptr.shape[0] != n + 1
            or overlay.ovl_col.shape[0] < 1):
        raise ValueError(f"{who}: the overlay's arrays do not fit a graph "
                         f"of {n} vertices")
    return tuple(t.data_ptr() for t in overlay)


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


def lane_of(queue) -> tuple:
    """``(buf, head, tail, dropped, packed)`` of the task ring a drain
    kernel drains: a TaskQueue's (``packed`` False), or lane 0 of the fused
    topology's one-lane MultiQueue, whose packed words the kernel's fused
    mode reads and writes (``packed`` True)."""
    if isinstance(queue, MultiQueue):
        if queue.num_lanes != 1:
            raise ValueError(f"a drain kernel drains one lane; the "
                             f"MultiQueue has {queue.num_lanes}")
        lanes = queue.lanes
        return (lanes.buf[0], lanes.head[0], lanes.tail[0],
                lanes.dropped[0], True)
    return queue.buf, queue.head, queue.tail, queue.dropped, False


def check_packed(who: str, n: int, granularity: int) -> None:
    """The fused mode's admission: every task of a graph of ``n`` vertices
    at this granularity must survive the lane's 24-bit payload."""
    from ...server.encoding import check_job_fits  # lazy: server->core

    try:
        check_job_fits(0, n, granularity=granularity)
    except ValueError as e:
        raise ValueError(f"{who}: {e}") from None


def ring_of(who: str, carry, device):
    """A copy of the carry's TraceRing (its fifth leaf) for the traced mode
    to update in place, or None for an untraced carry."""
    if len(carry) == 4:
        return None
    ring = carry[4]
    check_operand(who, "ring.buf", ring.buf, device)
    if ring.buf.dim() != 2 or ring.buf.shape[1] != NUM_FIELDS:
        raise ValueError(f"{who}: a trace ring is [capacity, {NUM_FIELDS}], "
                         f"got {tuple(ring.buf.shape)}")
    return TraceRing(buf=ring.buf.clone(),
                     cursor=ring.cursor.to(device=device, dtype=_I32)
                     .reshape(()).clone())


def ring_args(ring) -> tuple:
    """The launch's trace operands: rows, capacity, cursor (or none)."""
    if ring is None:
        return None, 0, None
    return ring.buf.data_ptr(), ring.capacity, ring.cursor.data_ptr()


def pack_cursors(carry, limit, max_rounds: int, device, *extra):
    """One int32 tensor: the carry's scalars in CURSORS order, the round
    ``limit`` (an int, a 0-dim tensor, or None for ``max_rounds``), then
    ``extra`` 0-dim tensors of the program's own."""
    queue, state, rounds, processed = carry[:4]
    _, head, tail, dropped, _ = lane_of(queue)
    if limit is None:
        limit = max_rounds
    if not isinstance(limit, torch.Tensor):
        limit = torch.full((), min(int(limit), 2 ** 31 - 1), dtype=_I32,
                           device=device)
    counter = state.counter
    return torch.stack([
        t.to(device=device, dtype=_I32).reshape(())
        for t in (head, tail, dropped, rounds, processed,
                  counter.work, counter.splits, counter.rounds, limit,
                  *extra)])


def unpack_carry(carry, buf: torch.Tensor, cursors: torch.Tensor,
                 extra=(), ring=None, **state_fields):
    """The carry after a launch: the queue with ``buf`` and the kernel's
    cursors (a packed lane's as lane 0 of its MultiQueue; the round-robin
    pointer stays, as the fused pop never moves it), the state with
    ``state_fields``, the ``extra`` scalars named as the state's fields, a
    WorkCounter of views of ``cursors``, and ``ring`` as the fifth leaf of
    a traced carry."""
    queue, state = carry[0], carry[1]
    c = dict(zip(CURSORS + tuple(extra), cursors.unbind()))
    if isinstance(queue, MultiQueue):
        queue = dataclasses.replace(queue, lanes=dataclasses.replace(
            queue.lanes, buf=buf.unsqueeze(0), head=c["head"].reshape(1),
            tail=c["tail"].reshape(1), dropped=c["dropped"].reshape(1)))
    else:
        queue = dataclasses.replace(queue, buf=buf, head=c["head"],
                                    tail=c["tail"], dropped=c["dropped"])
    state = dataclasses.replace(
        state, **state_fields, **{name: c[name] for name in extra},
        counter=WorkCounter(work=c["work"], splits=c["splits"],
                            rounds=c["counter_rounds"]))
    out = (queue, state, c["rounds"], c["processed"])
    return out if ring is None else out + (ring,)
