"""``execute``: one front door for (program, policy) combinations.

The counterpart of ``repro/runtime/api.py``.  This slice runs the
``single`` topology under the ``persistent`` and ``discrete`` kernel
strategies, at any granularity; every other cell raises
``NotImplementedError`` naming its ROADMAP item.  The outcome is
normalized to ``(state, RunStats, info)`` as in the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.queue import make_queue
from ..core.scheduler import (RunStats, SchedulerConfig, continuation,
                              discrete_drive, persistent_drive, taskqueue_ops,
                              wavefront_step)
from .policy import ExecutionPolicy, policy_of
from .program import AtosProgram, ProgramContext

_LATER_SLICES = {
    "fused": "the fused topology comes with ROADMAP A7",
    "sharded": "the sharded topology comes with ROADMAP A12",
    "megakernel": "the megakernel strategy comes with ROADMAP A8",
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


def _shared_setup(program: AtosProgram, graph, cfg: SchedulerConfig,
                  queue_capacity: Optional[int]):
    """Build the drain bundle: ``(queue, state, step, cond)``."""
    state, seeds = program.init()
    capacity = queue_capacity or program.default_queue_capacity
    queue = make_queue(capacity, device=graph.device).push_dense(
        torch.as_tensor(seeds, dtype=torch.int32, device=graph.device),
        backend=cfg.backend)
    ctx = _context(cfg)
    f = program.body(graph, ctx)
    on_empty = program.on_empty(graph, ctx)
    ops = taskqueue_ops(cfg)
    cond = continuation(ops, cfg, program.stop, program.empty_means_done)
    return queue, state, (lambda carry: wavefront_step(f, on_empty, ops,
                                                       carry)), cond


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
    drain, one per round for both strategies, as in the reference.
    """
    policy = policy_of(cfg)
    _check_supported(policy, trace)
    queue, state, step, cond = _shared_setup(program, graph, cfg,
                                             queue_capacity)
    zero = torch.zeros((), dtype=torch.int32, device=graph.device)
    carry0 = (queue, state, zero, zero)
    if policy.persistent:
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
        "launches": int(rounds),
    }
    return ExecutionResult(state, stats, info)
