"""``execute``: one front door for (program, policy) combinations.

The counterpart of ``repro/runtime/api.py``.  This slice runs the
``single`` topology under the ``persistent``, ``discrete`` and
``megakernel`` kernel strategies; every other cell raises
``NotImplementedError`` naming its ROADMAP item.  The outcome is
normalized to ``(state, RunStats, info)`` as in the reference.

A megakernel cell runs, as in the reference, a body that expands through
the row-slice stream (``core/backend.STREAM``) and queue ops on the plain
backend.  On CUDA tensors with backend ``auto`` or ``cuda`` the whole drain
is one launch of the program's CUDA drain kernel; a program or
configuration without one raises, and never falls back.  On CPU tensors,
or with backend ``torch``, it is the plain fused drain over the same step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from ..core.backend import STREAM, STREAM_TORCH, resolve_backend
from ..core.queue import make_queue
from ..core.scheduler import (RunStats, SchedulerConfig, continuation,
                              discrete_drive, megakernel_drive, no_host_sync,
                              persistent_drive, taskqueue_ops, wavefront_step)
from .policy import ExecutionPolicy, policy_of
from .program import AtosProgram, ProgramContext

_LATER_SLICES = {
    "fused": "the fused topology comes with ROADMAP A7",
    "sharded": "the sharded topology comes with ROADMAP A12",
}

#: the ROADMAP item that brings a CUDA drain kernel where the program (or
#: its configuration) has none yet
_DRAIN_KERNEL_ITEMS = {
    "bfs": "BFS at granularity > 1 or with per_item expansion comes with "
           "ROADMAP A8b",
    "pagerank": "PageRank at granularity > 1 comes with ROADMAP A8b",
    "coloring": "coloring at granularity > 1 comes with ROADMAP A8b",
}
_OTHER_DRAIN_KERNELS = "each program needs a drain kernel of its own"


class ExecutionResult(NamedTuple):
    state: Any
    stats: RunStats
    info: dict


def _context(cfg: SchedulerConfig) -> ProgramContext:
    return ProgramContext(wavefront=cfg.wavefront,
                          num_workers=cfg.num_workers,
                          backend=cfg.backend,
                          granularity=cfg.granularity)


def _shared_setup(program: AtosProgram, graph, cfg: SchedulerConfig,
                  queue_capacity: Optional[int]):
    """Build the drain bundle: ``(queue, state, step, cond)``.  Under the
    megakernel strategy the body streams its row slices and the queue ops
    (the seed push included) run on the plain backend, as the reference
    sets them up."""
    state, seeds = program.init()
    capacity = queue_capacity or program.default_queue_capacity
    ctx = _context(cfg)
    if policy_of(cfg).kernel == "megakernel":
        ctx = ctx._replace(
            backend=STREAM_TORCH if cfg.backend == "torch" else STREAM)
        cfg = dataclasses.replace(cfg, backend="torch")
    queue = make_queue(capacity, device=graph.device).push_dense(
        torch.as_tensor(seeds, dtype=torch.int32, device=graph.device),
        backend=cfg.backend)
    f = program.body(graph, ctx)
    on_empty = program.on_empty(graph, ctx)
    ops = taskqueue_ops(cfg)
    cond = continuation(ops, cfg, program.stop, program.empty_means_done)
    return queue, state, (lambda carry: wavefront_step(f, on_empty, ops,
                                                       carry)), cond


def drain_kernel_for(program: AtosProgram, graph,
                     cfg: SchedulerConfig) -> Optional[Callable]:
    """The runner ``kernel(carry, limit)`` of a megakernel cell: the
    program's CUDA drain kernel when the backend resolves to ``"cuda"``,
    None (the plain fused drain) when it resolves to ``"torch"``.  Raises
    ``NotImplementedError`` naming the ROADMAP item where the program has
    no kernel for this configuration."""
    if resolve_backend(cfg.backend, graph.row_ptr) == "torch":
        return None
    kernel = program.drain_kernel(graph, _context(cfg), cfg.max_rounds)
    if kernel is None:
        item = _DRAIN_KERNEL_ITEMS.get(program.name, _OTHER_DRAIN_KERNELS)
        raise NotImplementedError(
            f"{program.name} under {policy_of(cfg)} has no CUDA drain kernel "
            f"yet: {item}")
    return kernel


class DrainSetup(NamedTuple):
    """Everything a driver needs: the carry ``(queue, state, rounds,
    processed)``, the round ``step``, the loop ``cond``, and, for a
    megakernel cell, the drain kernel's runner (None on the plain path)."""
    carry: tuple
    step: Callable
    cond: Callable
    kernel: Optional[Callable]


def drain_setup(program: AtosProgram, graph, cfg: SchedulerConfig, *,
                queue_capacity: Optional[int] = None) -> DrainSetup:
    """The drain of ``program`` on ``graph`` under ``cfg``, set up but not
    run -- for callers that drive it themselves, such as a drain cut into
    segments with ``core.scheduler.megakernel_segment``."""
    policy = policy_of(cfg)
    kernel = (drain_kernel_for(program, graph, cfg)
              if policy.kernel == "megakernel" else None)
    queue, state, step, cond = _shared_setup(program, graph, cfg,
                                             queue_capacity)
    zero = torch.zeros((), dtype=torch.int32, device=graph.device)
    return DrainSetup((queue, state, zero, zero), step, cond, kernel)


def _check_supported(policy: ExecutionPolicy, trace) -> None:
    for axis in (policy.topology, policy.kernel):
        if axis in _LATER_SLICES:
            raise NotImplementedError(
                f"policy {policy} is not ported yet: {_LATER_SLICES[axis]}")
    if trace is not None:
        raise NotImplementedError(
            "tracing comes with the observability slice, ROADMAP A10")


def execute(program: AtosProgram, graph, cfg: SchedulerConfig, *,
            queue_capacity: Optional[int] = None,
            trace: Optional[Any] = None) -> ExecutionResult:
    """Drain ``program`` on ``graph`` under the config's resolved policy.

    The drain runs where the graph lives.  Returns ``(final_state,
    RunStats, info)``; ``info["launches"]`` counts kernel-entry events per
    drain, as in the reference: one per round for the persistent and
    discrete strategies, one for the megakernel.
    """
    policy = policy_of(cfg)
    _check_supported(policy, trace)
    carry0, step, cond, kernel = drain_setup(program, graph, cfg,
                                             queue_capacity=queue_capacity)
    if policy.kernel == "megakernel":
        if kernel is None:
            carry = megakernel_drive(step, cond, carry0)
        else:
            with no_host_sync(graph.device):
                carry = megakernel_drive(step, cond, carry0, kernel=kernel)
    elif policy.persistent:
        carry = persistent_drive(step, cond, carry0)
    else:
        carry = discrete_drive(step, cond, carry0)
    queue, state, rounds, processed = carry
    stats = RunStats(rounds, processed, queue.dropped)
    info = {
        "rounds": int(stats.rounds),
        "work": program.work_of(state),
        "dropped": int(stats.dropped),
        "splits": program.splits_of(state),
        "launches": 1 if policy.kernel == "megakernel" else int(rounds),
    }
    return ExecutionResult(state, stats, info)
