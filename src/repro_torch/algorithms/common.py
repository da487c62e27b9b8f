"""Budget helpers shared by the queue-driven algorithm drivers.

The counterpart of ``repro/algorithms/common.py`` (single-shard branch; the
shard-ownership block comes with the sharded slice).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core.task import ChunkCodec
from ..graph.csr import CSRGraph


def max_degree_of(graph: CSRGraph) -> int:
    """Max degree (one host read)."""
    return int(graph.degrees().max())


def mean_degree_f32(graph: CSRGraph) -> float:
    """The reference's ``float(jnp.mean(degrees))``: a float32 mean.

    The degree sum is exactly ``m``.  JAX sums the int32 degrees in float32,
    which is exact while the sum stays below 2**24, and then divides in
    float32; one float32 divide of the exact sum gives the same value.
    """
    return float(np.float32(graph.num_edges)
                 / np.float32(graph.num_vertices))


def default_work_budget(graph: CSRGraph, wavefront: int,
                        work_budget: int | None = None,
                        max_degree: int | None = None) -> int:
    """LBS (merge-path) work budget per wavefront.

    Truncated rows are re-queued, so this is a throughput knob, except that
    the first popped item must always expand fully, hence the
    ``max_degree`` floor.
    """
    if max_degree is None:
        max_degree = max_degree_of(graph)
    if work_budget is None:
        work_budget = wavefront * max(8, int(mean_degree_f32(graph) * 4))
    return max(work_budget, max_degree)


def chunking_for(cfg, work_budget: int | None = None
                 ) -> Tuple[ChunkCodec, Optional[int]]:
    """``(codec, split_threshold)`` for a chunk-aware body on one device.

    The threshold is the tighter of ``cfg.split_threshold`` (0 = unset) and
    the merge-path ``work_budget`` -- a liveness bound: a chunk whose degree
    sum exceeded the budget would be re-queued whole forever.  The
    reference's shard-ownership block comes with the sharded slice.
    """
    if cfg.num_shards > 1:
        raise NotImplementedError(
            "sharded chunking comes with the sharded slice, ROADMAP A12")
    bounds = [b for b in (cfg.split_threshold, work_budget) if b]
    return ChunkCodec(cfg.granularity), (min(bounds) if bounds else None)
