"""Persistent and discrete schedulers: Atos's kernel-strategy axis.

The counterpart of ``repro/core/scheduler.py``.  Both drivers run the same
wavefront step: pop ``num_workers x fetch_size`` tasks, apply the
application function ``f``, push the produced tasks.

  * :func:`persistent_drive` -- the drain stays on the device.  PyTorch has
    no device-side while-loop, so each round is *predicated*: it computes
    the continuation flag on the device and, once the flag is false,
    changes nothing (queue, state, round and item counts alike).  The host
    enqueues ``POLL_EVERY`` such rounds between two reads of the flag, and
    those rounds make no host sync at all -- the CUDA sync-debug mode is
    set to raise inside them, so a sync that crept in fails loudly.
  * :func:`discrete_drive` -- a host loop that reads the flag once per
    round, as the reference's discrete kernels do;
  * :func:`megakernel_drive` -- the whole drain in one launch of the
    program's CUDA drain kernel (``kernels/drain_loop``).

The step is generic over a :class:`QueueOps` triple, as in the reference.
The raw-``WavefrontFn`` entry points of the reference (:func:`run`,
:func:`persistent_run`, :func:`discrete_run`, :func:`megakernel_run`,
:func:`partial_step`) drive one plain ``TaskQueue`` through the same
drivers; new code builds an ``AtosProgram`` and calls
``runtime.execute``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from .counters import WorkCounter
from .queue import TaskQueue
from .tree import tree_map, tree_where

# f(items, valid, state) -> (new_items, new_mask, new_state)
WavefrontFn = Callable[[torch.Tensor, torch.Tensor, Any],
                       Tuple[torch.Tensor, torch.Tensor, Any]]

#: predicated rounds the persistent driver enqueues per host poll
POLL_EVERY = 32


class RunStats(NamedTuple):
    rounds: torch.Tensor           # wavefronts executed
    items_processed: torch.Tensor  # total valid items popped
    dropped: torch.Tensor          # queue overflow drops (must be 0 in tests)


class QueueOps(NamedTuple):
    """The three queue operations the wavefront step is generic over."""

    pop: Callable[[Any], Tuple[torch.Tensor, torch.Tensor, Any]]
    push: Callable[[Any, torch.Tensor, torch.Tensor], Any]
    size: Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Atos launch configuration (Listing 3 of the paper).

    The fields and their meaning are the reference's; see
    ``repro/core/scheduler.SchedulerConfig``.  ``backend`` is the port's
    axis (``"torch" | "cuda" | "auto"``, core/backend.py) and defaults to
    ``"auto"``.  The port executes every cell of the policy matrix.

    The sharded topology's fields (``repro_torch/shard``):
    ``steal_threshold`` turns ring work stealing on (a shard donates up to
    ``steal_chunk`` owned tasks to its ring successor when the occupancy
    gap passes ``steal_threshold x mean``; 0 is off); ``mesh_shape``
    folds the ``num_shards`` into a ``(rows, cols)`` mesh whose exchange
    takes a column hop, then a row hop (None: the 1-D ring);
    ``defer_rounds`` 1 stages each round's exchanged tasks and delivers
    them at the start of the next round (0: strict); ``compress`` runs
    each hop's buffer through the delta codec (``shard/codec.py``) and
    meters its words.
    """

    num_workers: int = 64        # numBlock: parallel workers per wavefront
    fetch_size: int = 1          # FETCH_SIZE: items each worker pops
    persistent: bool = True      # ifPersist: kernel strategy
    max_rounds: int = 1 << 16    # safety bound on the drain
    backend: str = "auto"        # kernel backend: torch | cuda | auto
    topology: str = "auto"       # execution topology: single|fused|sharded|auto
    num_shards: int = 1          # device-mesh axis
    granularity: int = 1         # max chunk width G (core/task.py); 1 = fine
    split_threshold: int = 0     # chunk degree-sum cap; 0 = work-budget only
    kernel: str = "auto"         # persistent | discrete | megakernel | auto
    steal_threshold: float = 0.0  # occupancy-skew trigger; 0 = stealing off
    steal_chunk: int = 64        # max tasks donated per shard per round
    mesh_shape: Optional[Tuple[int, int]] = None  # (rows, cols) 2-D mesh
    defer_rounds: int = 0        # exchange delivery relaxation (0 = strict)
    compress: bool = False       # delta-compress exchange payloads (codec)

    @property
    def wavefront(self) -> int:
        return self.num_workers * self.fetch_size


def taskqueue_ops(cfg: SchedulerConfig) -> QueueOps:
    """The single-device engine's ops: one plain TaskQueue."""
    w = cfg.wavefront
    return QueueOps(
        pop=lambda q: q.pop(w),
        push=lambda q, items, mask: q.push(items, mask, backend=cfg.backend),
        size=lambda q: q.size,
    )


def _bump_rounds(state):
    return tree_map(
        lambda x: x.bump_round() if isinstance(x, WorkCounter) else x,
        state, is_leaf=lambda x: isinstance(x, WorkCounter))


def wavefront_step(f: WavefrontFn, on_empty, ops: QueueOps, carry,
                   *, always_run_body: bool = False):
    """One scheduling round, generic over the queue implementation.

    ``carry = (queue, state, rounds, processed)``.  When the pop yields no
    valid item the body's result is discarded and ``on_empty`` (if any)
    runs instead.  The reference branches with ``jax.lax.cond``; here both
    branches run and the device flag selects, so the round never waits
    for the host.  ``always_run_body`` keeps the body's state and push
    even on a zero-valid wavefront, and ``on_empty`` is not consulted (the
    task server's lane step: PageRank's in-body rescan must tick on an
    empty pop).
    """
    queue, state, rounds, processed = carry
    items, valid, queue = ops.pop(queue)
    n_valid = valid.sum(dtype=torch.int32)

    out, mask, s_body = f(items, valid, state)
    q_body = ops.push(queue, out, mask)
    if always_run_body:
        return (q_body, _bump_rounds(s_body), rounds + 1,
                processed + n_valid)
    if on_empty is None:
        q_empty, s_empty = queue, state
    else:
        out_e, mask_e, s_empty = on_empty(state)
        q_empty = ops.push(queue, out_e, mask_e)
    queue, state = tree_where(n_valid > 0, (q_body, s_body),
                              (q_empty, s_empty))
    # every WorkCounter ticks exactly once per step (empty rounds
    # included), matching the driver-level ``rounds`` carry element.
    return queue, _bump_rounds(state), rounds + 1, processed + n_valid


def continuation(ops: QueueOps, cfg: SchedulerConfig, stop,
                 empty_means_done: bool):
    """The shared while-condition: bounded rounds, optional drain/stop
    terms.  Returns a 0-dim bool tensor on the carry's device."""

    def cond(carry):
        queue, state, rounds, _ = carry
        more = rounds < cfg.max_rounds
        if empty_means_done:
            more = more & (ops.size(queue) > 0)
        if stop is not None:
            more = more & ~stop(state)
        return more

    return cond


@contextlib.contextmanager
def no_host_sync(device):
    """Raise on any device->host synchronization inside the block.

    On a CUDA device this sets PyTorch's sync-debug mode to ``"error"`` and
    restores the previous mode after; elsewhere it does nothing.
    """
    if torch.device(device).type != "cuda":
        yield
        return
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


def persistent_drive(step, cond, carry0):
    """Device-resident drain: ``POLL_EVERY`` predicated rounds per host poll.

    A predicated round applies ``step`` only while ``cond`` holds on the
    device, so the result -- rounds included -- is exactly the reference's
    ``lax.while_loop(cond, step, carry0)``.
    """
    device = carry0[2].device

    def predicated(carry):
        return tree_where(cond(carry), step(carry), carry)

    carry = carry0
    while bool(cond(carry)):  # the one host sync per poll
        with no_host_sync(device):
            for _ in range(POLL_EVERY):
                carry = predicated(carry)
    return carry


def megakernel_drive(step, cond, carry0, *, limit=None, kernel=None):
    """Whole drain in ONE launch of the program's CUDA drain kernel
    (``kernel``, a runner ``kernel(carry, limit)``), or as the plain fused
    drain when ``kernel`` is None; ``limit`` cuts it at an absolute round.
    Imported lazily: kernels/ imports this package's types."""
    from ..kernels.drain_loop.ops import megakernel_drive as _drive

    return _drive(step, cond, carry0, limit=limit, kernel=kernel)


def megakernel_segment(step, cond, example_carry, *, kernel=None):
    """``seg(carry, limit)`` for drains cut into segments: each call drains
    to round ``limit`` (absolute) in one launch of ``kernel``, or through
    the plain fused drain.  Imported lazily, as :func:`megakernel_drive`."""
    from ..kernels.drain_loop.ops import make_megakernel_segment

    return make_megakernel_segment(step, cond, example_carry, kernel=kernel)


def discrete_drive(step, cond, carry0, *, ops: QueueOps | None = None,
                   trace=None):
    """Host loop, one round per iteration (discrete kernels).

    The continuation flag is computed with the round, so each round costs
    one scalar device->host read, as in the reference.  ``trace``, if
    given (with the drain's ``ops``), collects per-round
    ``(queue_size_before_pop, items_processed)`` pairs -- the reference's
    legacy list, at the price of two more host reads a round.
    """
    if trace is not None and ops is None:
        raise ValueError("a discrete trace list needs the drain's ops")
    carry = carry0
    prev_processed = 0
    while bool(cond(carry)):  # the one per-round device->host sync
        size_before = int(ops.size(carry[0])) if trace is not None else 0
        carry = step(carry)
        if trace is not None:
            trace.append((size_before, int(carry[3]) - prev_processed))
            prev_processed = int(carry[3])
    return carry


# ---------------------------------------------------- TaskQueue entry points
def resolve_empty_means_done(on_empty,
                             empty_means_done: Optional[bool]) -> bool:
    """The raw entry points' default: without an explicit declaration a
    drain with ``on_empty`` ignores the queue size (the reference's legacy
    inference); ``AtosProgram.empty_means_done`` declares it instead."""
    return on_empty is None if empty_means_done is None else empty_means_done


def _raw_drain(f, queue: TaskQueue, state, cfg: SchedulerConfig, stop,
               on_empty, empty_means_done, queue_cfg=None):
    """``(step, cond, ops, carry0)`` of a raw-``WavefrontFn`` drain."""
    ops = taskqueue_ops(queue_cfg or cfg)
    cond = continuation(ops, cfg, stop,
                        resolve_empty_means_done(on_empty, empty_means_done))
    step = lambda carry: wavefront_step(f, on_empty, ops, carry)
    zero = torch.zeros((), dtype=torch.int32, device=queue.buf.device)
    return step, cond, ops, (queue, state, zero, zero)


def _finish(carry):
    q, s, rounds, processed = carry
    return q, s, RunStats(rounds, processed, q.dropped)


def persistent_run(f: WavefrontFn, queue: TaskQueue, state: Any,
                   cfg: SchedulerConfig, stop=None, on_empty=None,
                   empty_means_done: Optional[bool] = None):
    """Run until the queue drains (or ``stop(state)``) on the device:
    ``(queue, state, RunStats)``."""
    step, cond, _, carry0 = _raw_drain(f, queue, state, cfg, stop, on_empty,
                                       empty_means_done)
    return _finish(persistent_drive(step, cond, carry0))


def discrete_run(f: WavefrontFn, queue: TaskQueue, state: Any,
                 cfg: SchedulerConfig, stop=None, on_empty=None,
                 empty_means_done: Optional[bool] = None, trace=None):
    """Host-driven loop, one round per iteration (discrete kernels);
    ``trace`` is :func:`discrete_drive`'s legacy list."""
    step, cond, ops, carry0 = _raw_drain(f, queue, state, cfg, stop,
                                         on_empty, empty_means_done)
    return _finish(discrete_drive(step, cond, carry0, ops=ops, trace=trace))


def megakernel_run(f: WavefrontFn, queue: TaskQueue, state: Any,
                   cfg: SchedulerConfig, stop=None, on_empty=None,
                   empty_means_done: Optional[bool] = None):
    """The raw-``WavefrontFn`` megakernel strategy: the plain fused drain,
    its queue ops on the plain backend as the reference sets them up.  The
    drain kernels are per program (``AtosProgram.make_drain_kernel``), so
    a raw ``f`` has none: on CUDA tensors this raises, and
    ``runtime.execute`` on a program runs the kernel."""
    if queue.buf.is_cuda:
        raise NotImplementedError(
            "megakernel_run drains a raw WavefrontFn, which has no CUDA "
            "drain kernel; build an AtosProgram and call runtime.execute "
            "under a megakernel policy")
    step, cond, _, carry0 = _raw_drain(
        f, queue, state, cfg, stop, on_empty, empty_means_done,
        queue_cfg=dataclasses.replace(cfg, backend="torch"))
    return _finish(megakernel_drive(step, cond, carry0))


def run(f, queue, state, cfg: SchedulerConfig, stop=None, on_empty=None,
        empty_means_done: Optional[bool] = None, trace=None):
    """Dispatch on the kernel strategy: ``cfg.kernel="megakernel"`` routes
    to :func:`megakernel_run` (the ``persistent`` bool alone never selects
    it), else ``cfg.persistent`` picks :func:`persistent_run` or
    :func:`discrete_run`."""
    if cfg.kernel == "megakernel":
        return megakernel_run(f, queue, state, cfg, stop=stop,
                              on_empty=on_empty,
                              empty_means_done=empty_means_done)
    if cfg.persistent:
        return persistent_run(f, queue, state, cfg, stop=stop,
                              on_empty=on_empty,
                              empty_means_done=empty_means_done)
    return discrete_run(f, queue, state, cfg, stop=stop, on_empty=on_empty,
                        empty_means_done=empty_means_done, trace=trace)


def partial_step(f, on_empty, cfg: SchedulerConfig):
    """The round ``step(carry)`` of a raw ``f`` over one TaskQueue."""
    ops = taskqueue_ops(cfg)
    return lambda carry: wavefront_step(f, on_empty, ops, carry)
