"""BFS case study: BSP (Alg 1) vs speculative relaxed-barrier BFS (Alg 2).

The counterpart of ``repro/algorithms/bfs.py``.  Speculative BFS pops a
wavefront of vertices from the Atos queue; because the queue mixes depths,
a vertex may first be reached on a longer path and later re-relaxed.  Both
variants give exact shortest hop distances.

``atomicMin(&dist[nbr], ...)`` is a ``scatter_reduce(..., "amin")`` over
the wavefront's expanded edges: min is order-free, so the result is the
same on every device and every run.  "Was my relaxation the winner?" is
answered against the pre-scatter distance, as on the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import (ChunkCodec, SchedulerConfig, WorkCounter, adjacency_of,
                    chunk_degrees, chunk_seeds, coalesce_chunks,
                    expand_merge_path, expand_per_item, flatten_chunks)
from ..graph.csr import CSRGraph
from ..runtime.program import AtosProgram, ProgramContext
from ..runtime.programs import reject_unknown_params
from .common import (chunking_for, default_work_budget,
                     max_chunk_degree_of, max_degree_of)

INF = 0x7FFFFFFF

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class BFSState:
    dist: torch.Tensor      # [n] int32 hop distance, INF = unreached
    counter: WorkCounter


def _scatter_min(base: torch.Tensor, index: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """``base.at[index].min(values)`` (a new tensor)."""
    return base.scatter_reduce(0, index.reshape(-1).long(),
                               values.reshape(-1), "amin", include_self=True)


# --------------------------------------------------------------------- BSP
def _bsp_level(graph: CSRGraph, carry, max_degree: int):
    """One level-synchronous step over a dense frontier mask."""
    dist, frontier, level, work = carry
    rp, cols = graph.row_ptr, graph.col_idx
    deg = graph.degrees()
    j = torch.arange(max_degree, dtype=_I32, device=rp.device)
    edge = rp[:-1][:, None] + j[None, :]
    active = (j[None, :] < deg[:, None]) & frontier[:, None]
    nbr = cols[torch.clamp(edge, 0, graph.num_edges - 1)]
    cand = torch.where(active, level + 1, INF)
    new_dist = _scatter_min(dist, torch.where(active, nbr, 0), cand)
    new_frontier = new_dist < dist  # improved this level
    return new_dist, new_frontier, level + 1, work + active.sum(dtype=_I32)


def bfs_bsp(graph: CSRGraph, source: int, max_levels: int | None = None):
    """Level-synchronous BFS; host loop per level = discrete BSP kernels."""
    n = graph.num_vertices
    device = graph.device
    max_degree = max_degree_of(graph)
    dist = torch.full((n,), INF, dtype=_I32, device=device)
    dist[source] = 0
    frontier = torch.zeros((n,), dtype=torch.bool, device=device)
    frontier[source] = True
    level = torch.zeros((), dtype=_I32, device=device)
    work = torch.zeros((), dtype=_I32, device=device)
    max_levels = max_levels or n
    levels = 0
    frontier_sizes = []
    while bool(frontier.any()) and levels < max_levels:
        frontier_sizes.append(int(frontier.sum()))
        dist, frontier, level, work = _bsp_level(
            graph, (dist, frontier, level, work), max_degree)
        levels += 1
    return dist, {"levels": levels, "work": int(work),
                  "frontier_sizes": frontier_sizes}


# ------------------------------------------------------------- speculative
def init_state(graph: CSRGraph, source: int) -> BFSState:
    """dist = INF except the source."""
    dist = torch.full((graph.num_vertices,), INF, dtype=_I32,
                      device=graph.device)
    dist[source] = 0
    return BFSState(dist=dist, counter=WorkCounter.zero(graph.device))


def make_wavefront_fn(graph: CSRGraph, strategy: str, work_budget: int,
                      max_degree: int, backend: str = "auto",
                      codec: ChunkCodec | None = None,
                      split_threshold: int | None = None,
                      owner_block: int | None = None,
                      formation_row_ptr=None):
    """Speculative-BFS wavefront body ``f(items, valid, state)``.

    ``strategy`` is ``"merge_path"`` (CTA worker, load-balancing search,
    whose backend ``backend`` selects) or ``"per_item"`` (warp worker).
    ``codec`` makes the body chunk-aware: popped tasks decode to
    ``(head, width)`` row runs and improved neighbors are re-coalesced into
    chunks at push time, bounded by ``split_threshold`` and the shard
    ``owner_block``.  ``formation_row_ptr`` is the global row_ptr a shard's
    body forms chunks with (pushed vertices may be remote, so their degree
    sums cannot come from the shard's slice).  The identity codec (G = 1)
    is the single-vertex body.
    """
    codec = codec or ChunkCodec(1)
    g = codec.granularity
    rp, cols, overlay = adjacency_of(graph)
    form_rp = rp if formation_row_ptr is None else formation_row_ptr

    def f(items, valid, state: BFSState):
        safe = torch.where(valid, items, 0)
        heads, widths = codec.decode(safe)
        if strategy == "merge_path":      # CTA worker: task+data-parallel LB
            ex = expand_merge_path(heads, valid, rp, cols, work_budget,
                                   backend=backend, widths=widths,
                                   max_width=g, overlay=overlay)
            # chunks whose rows spill past the work budget are re-queued
            # whole; the first popped task always expands fully.
            deg = chunk_degrees(heads, widths, valid, rp)
            excl = torch.cumsum(deg, 0, dtype=_I32) - deg
            truncated = valid & (excl + deg > work_budget)
            live = ex.valid & ~truncated[ex.owner]
        else:                             # warp worker: task-parallel only
            flat_v, flat_valid, _ = flatten_chunks(heads, widths, valid, g)
            ex = expand_per_item(flat_v, flat_valid, rp, cols, max_degree,
                                 overlay=overlay)
            truncated = torch.zeros_like(valid)
            live = ex.valid
        dist = state.dist
        n = dist.shape[0]
        lanes_n = ex.nbr.shape[0]
        lanes = torch.arange(lanes_n, dtype=_I32, device=dist.device)
        # lanes that take no part scatter the identity of min (INF, or the
        # lane count) to a slot of their own, ``lane % n``: the result is
        # the reference's, and on the card they do not all contend for the
        # one address (slot 0 or a spare slot) that the reference uses.
        idle_slot = lanes % n
        cand = torch.where(live, dist[ex.src] + 1, INF)
        before = dist[ex.nbr]
        new_dist = _scatter_min(dist, torch.where(live, ex.nbr, idle_slot),
                                cand)
        improved = live & (cand < before)
        # within-wavefront dedup: of the lanes that improve one neighbor,
        # only the lowest lane requeues it (scatter-min over lane ids).
        first_lane = _scatter_min(
            torch.full((n,), lanes_n, dtype=_I32, device=dist.device),
            torch.where(improved, ex.nbr, idle_slot),
            torch.where(improved, lanes, lanes_n))
        improved = improved & (first_lane[ex.nbr] == lanes)
        counter = state.counter.add(
            torch.where(valid & ~truncated, widths, 0).sum(dtype=_I32))
        # push: improved neighbors re-coalesce into chunks; truncated
        # chunks are re-queued whole, unchanged.
        out_new, new_mask, n_splits = coalesce_chunks(
            ex.nbr, improved, codec, form_rp, split_threshold=split_threshold,
            owner_block=owner_block)
        counter = counter.add_splits(n_splits)
        out_items = torch.cat([out_new, torch.where(truncated, items, 0)])
        out_mask = torch.cat([new_mask, truncated])
        return out_items, out_mask, BFSState(dist=new_dist, counter=counter)

    return f


def make_program(graph: CSRGraph, cfg: SchedulerConfig, *,
                 queue_capacity: int | None = None,
                 **params) -> AtosProgram:
    """Speculative BFS as one :class:`AtosProgram`.

    ``params``: ``source``, ``strategy`` (merge_path | per_item),
    ``work_budget``.  ``cfg.granularity`` sets the chunk width G; the seed
    is a width-1 chunk.  Under the sharded topology ``dist`` merges by
    ``pmin`` (the union of every shard's relaxations), the work counter by
    delta-psum, and tasks are routed and stolen by their head vertex.
    """
    source = int(params.pop("source", 0))
    strategy = params.pop("strategy", "merge_path")
    work_budget = params.pop("work_budget", None)
    reject_unknown_params("bfs", params)
    n = graph.num_vertices
    max_degree = max_degree_of(graph)
    budget = default_work_budget(graph, cfg.wavefront, work_budget,
                                 max_degree=max_degree)
    codec, threshold, owner_block = chunking_for(
        graph, cfg, budget if strategy == "merge_path" else None)
    per_item = strategy == "per_item"
    # per_item's most units of one chunk, for the drain kernel's int32
    # check: read once, here (at G = 1 it is the max degree)
    chunk_units = None
    if per_item:
        chunk_units = (max_degree if codec.granularity == 1
                       else max_chunk_degree_of(graph, codec.granularity))

    def make_body(body_graph: CSRGraph, ctx: ProgramContext):
        return make_wavefront_fn(
            body_graph, strategy, budget, max_degree, backend=ctx.backend,
            codec=codec, split_threshold=threshold, owner_block=owner_block,
            formation_row_ptr=graph.row_ptr.to(body_graph.device))

    def make_drain_kernel(body_graph: CSRGraph, ctx: ProgramContext,
                          max_rounds: int):
        from ..kernels.drain_loop.bfs_drain import bfs_drain_cuda  # lazy

        rp, cols, overlay = adjacency_of(body_graph)

        def run(carry, limit=None):
            return bfs_drain_cuda(carry, rp, cols, overlay=overlay,
                                  wavefront=ctx.wavefront, budget=budget,
                                  max_rounds=max_rounds, limit=limit,
                                  granularity=codec.granularity,
                                  split_threshold=threshold,
                                  per_item=per_item,
                                  max_chunk_degree=chunk_units)

        return run

    def dirty_seeds(applied, state):
        from ..stream.incremental import bfs_dirty_seeds  # lazy

        return bfs_dirty_seeds(applied, state, codec=codec,
                               split_threshold=threshold)

    return AtosProgram(
        name="bfs",
        init=lambda: (init_state(graph, source),
                      chunk_seeds([source], codec, graph.row_ptr)),
        make_body=make_body,
        result=lambda s: s.dist,
        merge={"dist": "pmin", "counter": "work_counter"},
        task_vertex=codec.head,
        work=lambda s: s.counter.work,
        splits=lambda s: s.counter.splits,
        ideal_work=n,
        default_queue_capacity=queue_capacity or max(4 * n, 1024),
        make_drain_kernel=make_drain_kernel,
        dirty_seeds=dirty_seeds,
        task_width=codec.width,
    )


def bfs_speculative(graph: CSRGraph, source: int, cfg: SchedulerConfig,
                    strategy: str = "merge_path",
                    work_budget: int | None = None,
                    queue_capacity: int | None = None,
                    trace=None, mesh=None) -> Tuple[torch.Tensor, dict]:
    """Relaxed-barrier BFS on the Atos scheduler: a thin driver over
    :func:`repro_torch.runtime.execute`, which takes ``trace`` and, under
    the sharded topology, ``mesh``."""
    from ..runtime.api import execute  # lazy: runtime.api -> this module

    program = make_program(graph, cfg, queue_capacity=queue_capacity,
                           source=source, strategy=strategy,
                           work_budget=work_budget)
    state, _, info = execute(program, graph, cfg,
                             queue_capacity=queue_capacity, trace=trace,
                             mesh=mesh)
    return state.dist, info
