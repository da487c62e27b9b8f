"""Helpers shared by the queue-driven algorithm drivers: budgets, chunking
and a dense scatter-set.

The counterpart of ``repro/algorithms/common.py`` (single-shard branch; the
shard-ownership block comes with the sharded slice).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

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


def scatter_set(base: torch.Tensor, index: torch.Tensor, mask: torch.Tensor,
                values) -> torch.Tensor:
    """``base.at[where(mask, index, n)].set(where(mask, values, 0),
    mode="drop")`` as a new tensor, for masked targets that are unique or
    that get one value.  Unmasked lanes write a spare slot each
    (``n + lane``), so that on the card they do not all store to one
    address."""
    n, k = base.shape[0], index.shape[0]
    lane = torch.arange(k, dtype=torch.int32, device=base.device)
    ext = torch.cat([base, base.new_zeros(k)])
    ext[torch.where(mask, index, n + lane).long()] = torch.where(
        mask, values, 0).to(base.dtype)
    return ext[:n]


def mark(n: int, index: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``zeros(n, bool).at[where(mask, index, n)].set(True, mode="drop")``."""
    return scatter_set(torch.zeros(n, dtype=torch.bool, device=index.device),
                       index, mask, mask)


def edge_sources(graph: CSRGraph, dtype=torch.int64) -> torch.Tensor:
    """[m] source vertex of every CSR edge."""
    return torch.repeat_interleave(
        torch.arange(graph.num_vertices, dtype=dtype, device=graph.device),
        graph.degrees().long(), output_size=graph.num_edges)
