"""The :class:`AtosProgram` protocol: declare a drain once, run it anywhere.

The counterpart of ``repro/runtime/program.py``.  An ``AtosProgram``
packages one application's drain:

    init()                    -> (state, seed tasks)
    make_body(graph, ctx)     -> WavefrontFn        (the expansion kernel)
    make_on_empty(graph, ctx) -> optional refill
    stop(state)               -> optional convergence predicate
    empty_means_done          -> does a drained queue end the run?
    result(state), work(state), splits(state), ideal_work
    dirty_seeds(delta, state) -> optional incremental re-seed (stream/)
    make_drain_kernel(graph, ctx, max_rounds)
                              -> optional CUDA drain kernel for the
                                 megakernel strategy (the port's own field)

    task_width(task)          -> chunk width (the task server's
                                 vertex-denominated quotas and loads)

The reference's replica-merge spec and ``task_vertex`` come with the
sharded slice.  The fused topology needs neither: its lane packs whatever
the body consumes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


def unit_task_width(items: torch.Tensor) -> torch.Tensor:
    """Default ``task_width``: every task is one vertex wide (G = 1)."""
    return torch.ones_like(items, dtype=torch.int32)


class ProgramContext(NamedTuple):
    """Where a wavefront body is about to run."""

    wavefront: int
    num_workers: int
    backend: str = "auto"
    granularity: int = 1         # max chunk width G (core/task.py)


@dataclasses.dataclass(frozen=True)
class AtosProgram:
    """One drain, declared once, runnable under every execution policy."""

    name: str
    init: Callable[[], Tuple[Any, Any]]
    make_body: Callable[..., Callable]       # (graph, ProgramContext) -> f
    result: Callable[[Any], Any]
    make_on_empty: Optional[Callable] = None  # (graph, ctx) -> on_empty fn
    stop: Optional[Callable[[Any], torch.Tensor]] = None
    #: does a globally empty queue end the drain?
    empty_means_done: bool = True
    work: Optional[Callable[[Any], torch.Tensor]] = None
    splits: Optional[Callable[[Any], torch.Tensor]] = None
    ideal_work: int = 0
    #: capacity hint when the caller does not size the queue explicitly
    default_queue_capacity: int = 1024
    #: ``(graph, ctx, max_rounds) -> runner(carry, limit)``: the program's
    #: hand-written drain kernel for ``kernel="megakernel"`` on CUDA
    #: tensors, or None where this program has none.  The
    #: runner drains while ``rounds < min(max_rounds, limit)`` and the
    #: body's ``cond`` holds, bit-identical to the plain fused drain.
    make_drain_kernel: Optional[Callable] = None
    #: the streaming hook: ``dirty_seeds(applied, state) -> (state',
    #: seeds)`` re-seeds only the frontier a committed delta batch
    #: invalidated (``applied`` a ``stream.ingest.AppliedDelta`` whose
    #: ``new_graph`` this program was built on, ``state`` the previous
    #: drain's final state).  None: the stream driver re-seeds in full
    #: through ``init()``.
    dirty_seeds: Optional[Callable[[Any, Any], Tuple[Any, Any]]] = None
    #: natural task -> chunk width: feeds the task server's
    #: vertex-denominated lane loads and pop quotas at granularity > 1
    task_width: Callable[[torch.Tensor], torch.Tensor] = unit_task_width

    def body(self, graph, ctx: ProgramContext):
        return self.make_body(graph, ctx)

    def on_empty(self, graph, ctx: ProgramContext):
        if self.make_on_empty is None:
            return None
        return self.make_on_empty(graph, ctx)

    def drain_kernel(self, graph, ctx: ProgramContext, max_rounds: int):
        if self.make_drain_kernel is None:
            return None
        return self.make_drain_kernel(graph, ctx, max_rounds)

    def work_of(self, state) -> int:
        return 0 if self.work is None else int(self.work(state))

    def splits_of(self, state) -> int:
        return 0 if self.splits is None else int(self.splits(state))
