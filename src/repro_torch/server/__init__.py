"""The multi-tenant graph task server: the counterpart of ``repro/server``.

One resident scheduler over a shared ``MultiQueue`` on the card, per-job
lanes of packed ``(job_id, payload)`` tasks, pluggable fairness policies,
backpressure and admission control, and a ``SchedulerConfig`` autotuner.
"""
from .autotune import (AUTOTUNE_SCHEMA, Autotuner, BACKEND_GRID,
                       DEFAULT_CANDIDATES, GRANULARITY_GRID, GraphStats,
                       TOPOLOGY_GRID, graph_class, graph_stats,
                       predict_cost, structural_cost,
                       structural_cost_runner)
from .encoding import (MAX_JOBS, MAX_NATURAL, PAYLOAD_BITS, PAYLOAD_MASK,
                       check_job_fits, pack, packed_width, unpack_job,
                       unpack_natural, unzigzag, zigzag)
from .engine import (Job, ServerResult, ServerStats, TaskServer,
                     serve_sequential)
from .jobs import ALGORITHMS, JobRegistry, JobSpec, Program
from .policies import (FairnessPolicy, LongestQueueFirst, RoundRobin,
                       WeightedShare, make_policy)

__all__ = [
    "AUTOTUNE_SCHEMA", "Autotuner", "BACKEND_GRID", "DEFAULT_CANDIDATES",
    "GRANULARITY_GRID", "GraphStats", "TOPOLOGY_GRID", "graph_class",
    "graph_stats", "predict_cost", "structural_cost",
    "structural_cost_runner",
    "MAX_JOBS", "MAX_NATURAL", "PAYLOAD_BITS", "PAYLOAD_MASK",
    "check_job_fits", "pack", "packed_width", "unpack_job",
    "unpack_natural", "unzigzag", "zigzag",
    "Job", "ServerResult", "ServerStats", "TaskServer", "serve_sequential",
    "ALGORITHMS", "JobRegistry", "JobSpec", "Program",
    "FairnessPolicy", "LongestQueueFirst", "RoundRobin", "WeightedShare",
    "make_policy",
]
