"""Job abstraction: what a tenant submits and how it runs on the server.

The counterpart of ``repro/server/jobs.py``.  A **JobSpec** is the request
("run PageRank on graph 'web' with eps 1e-5, weight 2.0").  The
**JobRegistry** owns the named graphs and compiles a spec into a
**Program**, the job-parameterized bundle the server's lane step drives:

    init()                -> (state, seed natural tasks)
    wavefront_fn(i, v, s) -> (out, mask, s')     # the algorithm's body
    on_empty(s)           -> optional refill step (PageRank's rescan)
    stop(s)               -> optional convergence predicate
    result(s)             -> the job's answer (dist / rank / colors)

The registry adds no algorithmic knowledge of its own: it compiles the
spec through ``runtime.build_program`` and builds the program's body for
the server's context (wavefront, workers, backend, granularity).
``backend`` threads the kernel axis into each body: on CUDA graphs with
``"auto"`` or ``"cuda"`` every BFS and PageRank tenant expands through B1
and PageRank sums through the ordered scatter-add; every push runs B2 in
the engine's step.

Each job's program is built once, from its own params, at admission.
The reference's kernel-bundle and compiled-step caches save jit
compilations; the port compiles nothing per job (its lane step is a plain
function, ``engine.TaskServer``), so it keeps neither.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from ..core.scheduler import SchedulerConfig
from ..graph.csr import CSRGraph
from ..runtime.program import ProgramContext
from ..runtime.programs import build_program as _build_runtime_program
from .encoding import check_job_fits

ALGORITHMS = ("bfs", "pagerank", "coloring")


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """A tenant's request.  ``weight`` feeds the weighted fairness policy.

    ``shards > 1`` asks for a sharded single-tenant drain: the job owns a
    ``shards``-shard mesh for the duration of its drain (``repro_torch/
    shard``) and the server runs it as a phase of its own before the fused
    rounds.  ``stream`` takes a :class:`~repro_torch.stream.StreamSpec`:
    the job is a streaming job (a delta log committed batch by batch with
    incremental recompute), also served as a phase of its own; with
    ``shards > 1`` each batch drain is a sharded one.
    """

    algorithm: str                 # one of ALGORITHMS
    graph: str                     # name registered with the JobRegistry
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    weight: float = 1.0
    shards: int = 1                # >1 = sharded single-tenant job
    stream: Optional[Any] = None

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown algorithm {self.algorithm!r}; "
                             f"expected one of {ALGORITHMS}")
        if self.weight <= 0:
            raise ValueError("job weight must be positive")
        if self.shards < 1:
            raise ValueError("job shards must be >= 1")
        if self.stream is not None and not hasattr(self.stream, "deltas"):
            raise ValueError(
                "JobSpec.stream must be a repro_torch.stream.StreamSpec")


@dataclasses.dataclass(frozen=True)
class Program:
    """Compiled form of a JobSpec: the callables the lane step drives."""

    algorithm: str
    graph_name: str
    graph: Optional[CSRGraph]
    init: Callable[[], Tuple[Any, Any]]
    wavefront_fn: Callable
    result: Callable[[Any], Any]
    work: Callable[[Any], Any]
    ideal_work: int
    on_empty: Optional[Callable] = None
    stop: Optional[Callable] = None
    #: when False (and stop is None) a drained lane does NOT finish the
    #: job: the engine keeps serving its on_empty refills
    empty_means_done: bool = True
    #: natural task -> chunk width: the engine's vertex-denominated lane
    #: loads and pop quotas at granularity > 1
    task_width: Optional[Callable] = None


class JobRegistry:
    """Named graphs + spec -> Program compilation."""

    def __init__(self) -> None:
        self._graphs: Dict[str, CSRGraph] = {}

    def register_graph(self, name: str, graph: CSRGraph) -> None:
        if name in self._graphs:
            raise ValueError(f"graph {name!r} already registered")
        self._graphs[name] = graph

    def graph(self, name: str) -> CSRGraph:
        if name not in self._graphs:
            raise KeyError(
                f"graph {name!r} not registered "
                f"(have: {sorted(self._graphs)})")
        return self._graphs[name]

    @property
    def graph_names(self):
        return sorted(self._graphs)

    def build(self, spec: JobSpec, job_id: int, wavefront: int,
              num_workers: int, lane_capacity: int,
              backend: str = "auto", granularity: int = 1,
              split_threshold: int = 0) -> Program:
        graph = self.graph(spec.graph)
        # admission at the job's granularity: chunk codes must fit the
        # packed payload
        check_job_fits(job_id, graph.num_vertices, granularity=granularity)
        if num_workers <= 0 or wavefront % num_workers:
            raise ValueError(
                f"wavefront {wavefront} is not num_workers "
                f"({num_workers}) x fetch_size")
        cfg = SchedulerConfig(num_workers=num_workers,
                              fetch_size=wavefront // num_workers,
                              backend=backend, granularity=granularity,
                              split_threshold=split_threshold)
        prog = _build_runtime_program(
            spec.algorithm, graph, cfg, params=dict(spec.params),
            queue_capacity=lane_capacity)
        ctx = ProgramContext(wavefront=wavefront, num_workers=num_workers,
                             backend=backend, granularity=granularity)
        return Program(
            algorithm=spec.algorithm, graph_name=spec.graph, graph=graph,
            init=prog.init,
            wavefront_fn=prog.body(graph, ctx),
            on_empty=prog.on_empty(graph, ctx), stop=prog.stop,
            result=prog.result,
            work=lambda s: s.counter.work,
            ideal_work=prog.ideal_work,
            empty_means_done=prog.empty_means_done,
            task_width=prog.task_width,
        )
