"""Helpers shared by the queue-driven algorithm drivers: budgets, chunking
and a dense scatter-set.

The counterpart of ``repro/algorithms/common.py``.
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


def max_chunk_degree_of(graph: CSRGraph, granularity: int) -> int:
    """The largest degree sum of ``granularity`` consecutive rows (a chunk's
    most units; one host read)."""
    rp = graph.row_ptr
    n = graph.num_vertices
    if n == 0:
        return 0
    ends = torch.clamp(torch.arange(n, device=rp.device) + granularity,
                       max=n)
    return int((rp[ends] - rp[:-1]).max())


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


def chunking_for(graph: CSRGraph, cfg, work_budget: int | None = None
                 ) -> Tuple[ChunkCodec, Optional[int], Optional[int]]:
    """``(codec, split_threshold, owner_block)`` for a chunk-aware body.

    The threshold is the tighter of ``cfg.split_threshold`` (0 = unset) and
    the merge-path ``work_budget`` -- a liveness bound: a chunk whose degree
    sum exceeded the budget would be re-queued whole forever.
    ``owner_block`` is the shard-ownership block when the config names a
    mesh (``cfg.num_shards > 1``): chunks never cross it, since routing
    keys off the chunk head and a shard's CSR slice covers its own block
    only.  None on one shard.
    """
    from ..shard.partition import block_size  # lazy: shard -> runtime

    bounds = [b for b in (cfg.split_threshold, work_budget) if b]
    owner_block = (block_size(graph.num_vertices, cfg.num_shards)
                   if cfg.num_shards > 1 else None)
    return (ChunkCodec(cfg.granularity), (min(bounds) if bounds else None),
            owner_block)


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


def edge_targets(graph) -> torch.Tensor:
    """[m] int32 neighbor of every edge in CSR order: a canonical graph's
    ``col_idx``, or a slotted view's two-level gather of every edge."""
    if getattr(graph, "overlay", None) is None:
        return graph.col_idx
    return graph.edge_targets()


def edge_sources(graph: CSRGraph, dtype=torch.int64) -> torch.Tensor:
    """[m] source vertex of every CSR edge."""
    return torch.repeat_interleave(
        torch.arange(graph.num_vertices, dtype=dtype, device=graph.device),
        graph.degrees().long(), output_size=graph.num_edges)
