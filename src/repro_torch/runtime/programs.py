"""Program registry: compile (algorithm name, graph, config) -> AtosProgram.

The counterpart of ``repro/runtime/programs.py``.  BFS is ported;
PageRank and coloring follow on the same queue, frontier and scheduler
(ROADMAP A6) and raise until then.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.scheduler import SchedulerConfig
from ..graph.csr import CSRGraph
from .program import AtosProgram

_NOT_PORTED = ("coloring", "pagerank")


def _factories():
    # lazy: the algorithm modules import repro_torch.runtime.program
    from ..algorithms import bfs

    return {"bfs": bfs.make_program}


def algorithms() -> tuple:
    """Registered algorithm names (stable order), ported or not."""
    return tuple(sorted((*_factories(), *_NOT_PORTED)))


def build_program(algorithm: str, graph: CSRGraph, cfg: SchedulerConfig,
                  params: Optional[Dict[str, Any]] = None,
                  queue_capacity: Optional[int] = None) -> AtosProgram:
    """Compile one drain.  ``params`` are the algorithm's keyword arguments
    (BFS ``source``/``strategy``/``work_budget``); unknown keys raise
    ``ValueError`` at build time."""
    if algorithm in _NOT_PORTED:
        raise NotImplementedError(
            f"{algorithm} is not ported yet (ROADMAP A6); this slice ports "
            f"bfs")
    factories = _factories()
    if algorithm not in factories:
        raise ValueError(f"unknown algorithm {algorithm!r}; "
                         f"expected one of {algorithms()}")
    return factories[algorithm](graph, cfg, queue_capacity=queue_capacity,
                                **dict(params or {}))


def reject_unknown_params(algorithm: str, params: Dict[str, Any]) -> None:
    """Shared tail-check for the factories' explicit ``pop`` parsing."""
    if params:
        raise ValueError(f"unknown {algorithm} params: {sorted(params)}")
