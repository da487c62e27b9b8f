"""Program registry: compile (algorithm name, graph, config) -> AtosProgram.

The counterpart of ``repro/runtime/programs.py``: BFS, PageRank and
coloring on the same queue, frontier and scheduler.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from ..core.scheduler import SchedulerConfig
from ..graph.csr import CSRGraph
from .program import AtosProgram

def _factories():
    # lazy: the algorithm modules import repro_torch.runtime.program
    from ..algorithms import bfs, coloring, pagerank

    return {"bfs": bfs.make_program, "coloring": coloring.make_program,
            "pagerank": pagerank.make_program}


def algorithms() -> tuple:
    """Registered algorithm names (stable order)."""
    return tuple(sorted(_factories()))


def build_program(algorithm: str, graph: CSRGraph, cfg: SchedulerConfig,
                  params: Optional[Dict[str, Any]] = None,
                  queue_capacity: Optional[int] = None) -> AtosProgram:
    """Compile one drain.  ``params`` are the algorithm's keyword arguments
    (BFS ``source``/``strategy``/``work_budget``; PageRank ``damping``/
    ``eps``/``check_size``/``work_budget``/``seed_count``; coloring takes
    none); unknown keys raise ``ValueError`` at build time."""
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
