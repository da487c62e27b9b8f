"""``execute``: one front door for (program, policy) combinations.

The counterpart of ``repro/runtime/api.py``.  The port runs the ``single``
and ``fused`` topologies under the ``persistent``, ``discrete`` and
``megakernel`` kernel strategies at every granularity; the ``sharded``
topology raises ``NotImplementedError`` naming ROADMAP A12.  The outcome
is normalized to ``(state, RunStats, info)`` as in the reference.

The two topologies share the step and differ in their :class:`QueueOps`:
``single`` drains one ``TaskQueue``; ``fused`` drains lane 0 of a one-lane
``MultiQueue`` whose tasks are packed ``(job, zigzag(task))`` words
(``server/encoding``), the task server's engine with one tenant.  Its
admission is checked at the config's granularity, and a graph whose chunk
codes would not fit the payload raises before any drain.

A megakernel cell runs, as in the reference, a body that expands through
the row-slice stream (``core/backend.STREAM``) and queue ops on the plain
backend.  On CUDA tensors with backend ``auto`` or ``cuda`` the whole drain
is one launch of the program's CUDA drain kernel, at every granularity and
in both topologies (a packed lane is the kernel's fused mode); a program
without one raises, and never falls back.  On CPU tensors, or with backend
``torch``, it is the plain fused drain over the same step.

``trace=`` takes an :class:`~repro_torch.obs.Trace`: a ring rides the
carry as a fifth leaf under every single/fused policy and records one row
per round (:func:`instrument_step`); a megakernel cell's drain kernel
writes the rows itself (its traced mode).  A plain ``list`` is the
discrete driver's legacy ``(size_before, items)`` trace.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.backend import STREAM, STREAM_TORCH, resolve_backend
from ..core.queue import make_multiqueue, make_queue
from ..core.scheduler import (QueueOps, RunStats, SchedulerConfig,
                              continuation, discrete_drive, megakernel_drive,
                              no_host_sync, persistent_drive, taskqueue_ops,
                              wavefront_step)
from ..obs import Trace
from .policy import ExecutionPolicy, policy_of
from .program import AtosProgram, ProgramContext

_LATER_SLICES = {
    "sharded": "the sharded topology comes with ROADMAP A12",
}


class ExecutionResult(NamedTuple):
    state: Any
    stats: RunStats
    info: dict


def _context(cfg: SchedulerConfig) -> ProgramContext:
    return ProgramContext(wavefront=cfg.wavefront,
                          num_workers=cfg.num_workers,
                          backend=cfg.backend,
                          granularity=cfg.granularity)


def fused_lane_ops(wavefront: int, backend: str, lane_id, job_id,
                   quota=None, aux: Optional[dict] = None,
                   task_width=None) -> QueueOps:
    """QueueOps over one packed MultiQueue lane, the task server's engine.

    Tasks on the wire are ``(job_id, zigzag(payload))`` int32s; the pop
    unpacks naturals for the body (0 in invalid slots), the push re-packs.
    ``lane_id``, ``job_id`` and ``quota`` may be tensors.  ``aux``, if
    given, receives the pop's routing-mismatch count (``aux["mismatch"]``)
    and the vertices it advanced (``aux["vertices"]``).  ``task_width`` (a
    natural-task -> chunk-width function) switches the quota to vertex
    units: the pop takes the longest slot prefix whose widths fit.
    """
    from ..server.encoding import (pack, packed_width, unpack_job,
                                   unpack_natural)  # lazy: server->core

    width_of = None if task_width is None else packed_width(task_width)

    def pop(mq):
        packed, valid, mq2 = mq.pop_lane(lane_id, wavefront, quota,
                                         width_of=width_of)
        natural = torch.where(valid, unpack_natural(packed), 0)
        if aux is not None:
            aux["mismatch"] = (valid & (unpack_job(packed) != job_id)).sum(
                dtype=torch.int32)
            if width_of is None:
                aux["vertices"] = valid.sum(dtype=torch.int32)
            else:
                aux["vertices"] = torch.where(
                    valid, width_of(packed), 0).sum(dtype=torch.int32)
        return natural, valid, mq2

    def push(mq, items, mask):
        return mq.push(lane_id, pack(job_id, items), mask, backend=backend)

    return QueueOps(pop=pop, push=push, size=lambda mq: mq.size)


def shared_queue_capacity(program: AtosProgram,
                          queue_capacity: Optional[int]) -> int:
    """The single/fused capacity rule."""
    return queue_capacity or program.default_queue_capacity


def _shared_setup(program: AtosProgram, graph, cfg: SchedulerConfig,
                  policy: ExecutionPolicy, queue_capacity: Optional[int]):
    """Build the drain bundle of the single and fused topologies:
    ``(queue, state, ops, step, cond, dropped_of)``.  Under the megakernel strategy the body streams its
    row slices and the queue ops (the seed push included) run on the plain
    backend, as the reference sets them up."""
    if policy.topology == "fused":
        # admission first, before any seed or body is built
        from ..server.encoding import check_job_fits
        check_job_fits(0, graph.num_vertices, granularity=cfg.granularity)
    state, seeds = program.init()
    capacity = shared_queue_capacity(program, queue_capacity)
    ctx = _context(cfg)
    if policy.kernel == "megakernel":
        ctx = ctx._replace(
            backend=STREAM_TORCH if cfg.backend == "torch" else STREAM)
        cfg = dataclasses.replace(cfg, backend="torch")
    seeds = torch.as_tensor(seeds, dtype=torch.int32, device=graph.device)
    if policy.topology == "single":
        queue = make_queue(capacity, device=graph.device).push_dense(
            seeds, backend=cfg.backend)
        ops = taskqueue_ops(cfg)
        dropped_of = lambda q: q.dropped
    else:  # fused: the one-lane, one-tenant server drain
        from ..server.encoding import pack
        queue = make_multiqueue(capacity, 1, device=graph.device).push(
            0, pack(0, seeds), torch.ones(seeds.shape, dtype=torch.bool,
                                          device=graph.device),
            backend=cfg.backend)
        ops = fused_lane_ops(cfg.wavefront, cfg.backend, lane_id=0, job_id=0)
        dropped_of = lambda mq: mq.lanes.dropped.sum(dtype=torch.int32)
    f = program.body(graph, ctx)
    on_empty = program.on_empty(graph, ctx)
    cond = continuation(ops, cfg, program.stop, program.empty_means_done)
    step = lambda carry: wavefront_step(f, on_empty, ops, carry)
    return queue, state, ops, step, cond, dropped_of


def instrument_step(step, cond, ops: QueueOps,
                    program: Optional[AtosProgram], *, lane: int = 0):
    """Wrap a 4-tuple drain ``(step, cond)`` to thread a TraceRing.

    The traced carry is ``(*inner, ring)``: the ring rides last, so
    ``carry[2]`` and ``carry[3]`` keep their meaning.  Each round records
    one row: the round, the lane, the queue size before the pop, pops (the
    processed delta), pushes (size after - size before + pops), and the
    WorkCounter's work and splits deltas where the program declares them
    (else 0).  The wrapped ``cond`` strips the ring.
    """
    work_of = program.work if program is not None else None
    splits_of = program.splits if program is not None else None

    def traced_step(carry):
        *inner, ring = carry
        q0, s0, r0, p0 = inner
        size_before = ops.size(q0)
        q1, s1, r1, p1 = step((q0, s0, r0, p0))
        pops = p1 - p0
        ring = ring.record(
            round=r0, lane=lane, queue_size=size_before, pops=pops,
            pushes=ops.size(q1) - size_before + pops,
            work=(work_of(s1) - work_of(s0)) if work_of is not None else 0,
            splits=(splits_of(s1) - splits_of(s0))
            if splits_of is not None else 0,
            donated=0, exchanged=0)
        return q1, s1, r1, p1, ring

    def traced_cond(carry):
        return cond(tuple(carry[:4]))

    return traced_step, traced_cond


def drain_kernel_for(program: AtosProgram, graph,
                     cfg: SchedulerConfig) -> Optional[Callable]:
    """The runner ``kernel(carry, limit)`` of a megakernel cell: the
    program's CUDA drain kernel when the backend resolves to ``"cuda"``,
    None (the plain fused drain) when it resolves to ``"torch"``.  Raises
    ``NotImplementedError`` where the program has no drain kernel.  The
    runner reads from the carry whether the queue is a packed lane (the
    fused mode) and whether a ring rides it (the traced mode)."""
    if resolve_backend(cfg.backend, graph.row_ptr) == "torch":
        return None
    kernel = program.drain_kernel(graph, _context(cfg), cfg.max_rounds)
    if kernel is None:
        raise NotImplementedError(
            f"{program.name} under {policy_of(cfg)} has no CUDA drain kernel: "
            f"each program needs a drain kernel of its own")
    return kernel


class DrainSetup(NamedTuple):
    """Everything a driver needs: the carry ``(queue, state, rounds,
    processed[, ring])``, the round ``step``, the loop ``cond``, for a
    megakernel cell the drain kernel's runner (None on the plain path),
    the queue ops, and ``dropped(queue)``, the drops summed over lanes."""
    carry: tuple
    step: Callable
    cond: Callable
    kernel: Optional[Callable]
    ops: QueueOps
    dropped: Callable


def drain_setup(program: AtosProgram, graph, cfg: SchedulerConfig, *,
                queue_capacity: Optional[int] = None,
                trace: Optional[Trace] = None) -> DrainSetup:
    """The drain of ``program`` on ``graph`` under ``cfg``, set up but not
    run -- for callers that drive it themselves, such as a drain cut into
    segments with ``core.scheduler.megakernel_segment``.  With a ``trace``
    the step is instrumented and a fresh ring of the trace's capacity is
    the carry's fifth leaf."""
    policy = policy_of(cfg)
    for axis in (policy.topology, policy.kernel):
        if axis in _LATER_SLICES:
            raise NotImplementedError(
                f"policy {policy} is not ported yet: {_LATER_SLICES[axis]}")
    kernel = (drain_kernel_for(program, graph, cfg)
              if policy.kernel == "megakernel" else None)
    queue, state, ops, step, cond, dropped_of = _shared_setup(
        program, graph, cfg, policy, queue_capacity)
    zero = torch.zeros((), dtype=torch.int32, device=graph.device)
    carry = (queue, state, zero, zero)
    if trace is not None:
        step, cond = instrument_step(step, cond, ops, program)
        carry = carry + (trace.ring(graph.device),)
    return DrainSetup(carry, step, cond, kernel, ops, dropped_of)


def execute(program: AtosProgram, graph, cfg: SchedulerConfig, *,
            queue_capacity: Optional[int] = None,
            trace: Optional[Any] = None) -> ExecutionResult:
    """Drain ``program`` on ``graph`` under the config's resolved policy.

    The drain runs where the graph lives.  Returns ``(final_state,
    RunStats, info)``; ``info["launches"]`` counts kernel-entry events per
    drain, as in the reference: one per round for the persistent and
    discrete strategies, one for the megakernel.  ``trace`` is a
    :class:`~repro_torch.obs.Trace` (every single/fused policy: the rows,
    an ``execute {policy}`` span and a ``run`` doc), a ``list`` (the
    discrete driver's per-round ``(size_before, items)``; ignored by the
    other strategies, as in the reference) or None: exactly the untraced
    drain.
    """
    policy = policy_of(cfg)
    obs = trace if isinstance(trace, Trace) else None
    legacy = trace if isinstance(trace, list) else None
    setup = drain_setup(program, graph, cfg, queue_capacity=queue_capacity,
                        trace=obs)
    step, cond, carry0 = setup.step, setup.cond, setup.carry
    span = (obs.span(f"execute {policy}") if obs is not None
            else contextlib.nullcontext())
    with span:
        if policy.kernel == "megakernel":
            if setup.kernel is None:
                carry = megakernel_drive(step, cond, carry0)
            else:
                with no_host_sync(graph.device):
                    carry = megakernel_drive(step, cond, carry0,
                                             kernel=setup.kernel)
        elif policy.persistent:
            carry = persistent_drive(step, cond, carry0)
        else:
            carry = discrete_drive(step, cond, carry0, ops=setup.ops,
                                   trace=legacy)
    queue, state, rounds, processed = carry[:4]
    stats = RunStats(rounds, processed, setup.dropped(queue))
    info = {
        "rounds": int(stats.rounds),
        "work": program.work_of(state),
        "dropped": int(stats.dropped),
        "splits": program.splits_of(state),
        "launches": 1 if policy.kernel == "megakernel" else int(rounds),
    }
    if obs is not None:
        obs.drain(carry[4], engine=str(policy))
        obs.add_metric(run_doc(policy, stats, info))
    return ExecutionResult(state, stats, info)


def run_doc(policy, stats: RunStats, info: dict) -> dict:
    """A single/fused run summary as the canonical ``run`` doc."""
    from ..obs.schema import metric_doc

    return metric_doc(
        "run", policy=str(policy), rounds=int(stats.rounds),
        items_processed=int(stats.items_processed),
        dropped=int(stats.dropped), work=int(info.get("work", 0)),
        splits=int(info.get("splits", 0)),
        launches=int(info.get("launches", 0)))
