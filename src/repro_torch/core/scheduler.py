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
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Tuple

import torch

from .counters import WorkCounter
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
    ``"auto"``.  The port executes the ``single`` and ``fused``
    topologies under the ``persistent``, ``discrete`` and ``megakernel``
    strategies; the topology and kernel fields take every value of the
    policy matrix, and ``runtime.execute`` names the ROADMAP item of each
    cell it cannot run yet.  The sharded topology's exchange and stealing
    fields come with its slice.
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
