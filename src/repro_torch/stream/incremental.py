"""Incremental recompute rules: which seeds does a delta batch dirty?

The counterpart of ``repro/stream/incremental.py``.  Each rule is a host
function ``(applied, state, ...) -> (state', seeds)``; the algorithm
factories close it over their chunking and install it as
``AtosProgram.dirty_seeds``, so the stream driver never branches on the
algorithm.  The BFS and coloring rules are the reference's numpy code over
the state read from the graph's device; the BFS rule reads graph rows on
the device, a level of candidates at a time.  They hand the new state and
the chunk-coded seed tasks back to the device.  PageRank's float64 sums
run on the graph's device.

* **BFS** -- inserts seed the finite-distance sources of inserted edges.
  Deletes: the region-pruned rule walks only the vertices that lost every
  parent at the level below, resets them to INF and seeds their finite
  fringe; on an asymmetric graph the conservative level-cut rule resets
  every level at or past the lowest deleted tree edge.  Re-relaxation then
  gives the from-scratch hop distances bit for bit.
* **PageRank** -- the push invariant ``residue = (1-d) + d * A^T D^-1 rank
  - rank`` is restored densely on the new graph from the carried rank;
  negative residues (deleted in-edges) are decayed by the harvest/push
  sweep of the BSP kernel.  The reference runs these float64 sums on the
  host with ``np.bincount``, which adds each vertex's in-edge terms left to
  right; the port runs them on the graph's device through the ordered
  scatter-add (``kernels/scatter_add``: its float64 instance on the card,
  ``index_add_`` on the CPU), which adds them in the same order, so every
  bit is the reference's.  The sweep count goes to
  ``applied.meters["sweeps"]``.
* **Coloring** -- ``"conflicts"`` keeps the carried colors and seeds one
  assign task per losing endpoint of every inserted same-colored edge (the
  ``(hash, id)`` tie-break of the conflict detector).  The result is a
  valid coloring, not the one a cold drain gives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..core.task import ChunkCodec, chunk_seeds
from ..graph.slotted import row_neighbors
from ..kernels.scatter_add.ops import ordered_scatter_add
from .ingest import AppliedDelta

BFS_INF = 0x7FFFFFFF


def reseed(program, applied: AppliedDelta, state,
           incremental: bool = True) -> Tuple[Any, Any]:
    """The stream driver's dispatch: the program's incremental rule when it
    has one (and the caller wants it), else the full reseed via
    ``init()``: always correct, never cheaper."""
    if incremental and program.dirty_seeds is not None:
        return program.dirty_seeds(applied, state)
    return program.init()


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _csr_host(graph):
    return (_host(graph.row_ptr).astype(np.int64),
            _host(graph.col_idx).astype(np.int64))


def _chunked(verts, codec: ChunkCodec, row_ptr, split_threshold,
             device) -> torch.Tensor:
    """Sorted unique dirty vertices -> chunk-coded seed tasks on
    ``device``."""
    verts = np.unique(np.asarray(verts, dtype=np.int64)).astype(np.int32)
    seeds = chunk_seeds(verts, codec, row_ptr, split_threshold=split_threshold)
    return torch.as_tensor(np.asarray(seeds, dtype=np.int32), device=device)


# ---------------------------------------------------------------------- BFS
def _symmetric(applied: AppliedDelta) -> bool:
    """Is the committed graph symmetric?  A slotted commit tracks it; a
    canonical CSR gets an O(m log m) check."""
    if applied.slotted is not None:
        return applied.slotted.symmetric
    g = applied.new_graph
    n = g.num_vertices
    rp = _host(g.row_ptr).astype(np.int64)
    ci = _host(g.col_idx).astype(np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
    return bool(np.array_equal(src * n + ci, np.sort(ci * n + src)))


def _neighbors(graph, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(owner, nbr)`` on the host for the sorted unique ``rows``, read on
    the graph's device (:func:`~repro_torch.graph.slotted.row_neighbors`)."""
    owner, nbr = row_neighbors(graph, torch.from_numpy(
        np.asarray(rows, dtype=np.int64)).to(graph.device))
    return _host(owner), _host(nbr)


def bfs_dirty_seeds(applied: AppliedDelta, state, *, codec: ChunkCodec,
                    split_threshold):
    """Region-pruned delete invalidation (Ramalingam/Reps deletion phase).

    Candidates are the deleted tree edges' targets, taken in ascending old
    level; a candidate at level L keeps its distance iff it still has an
    unaffected neighbor at L - 1, else it is affected and its old tree
    children become candidates.  Affected vertices reset to INF and the
    region's finite fringe reseeds.  The scans read out-neighbors as
    in-neighbors, sound only on symmetric graphs: otherwise the
    conservative rule runs.

    The reference pops candidates one at a time from a heap keyed by
    level.  A candidate's level is its old distance, and its verdict reads
    only the level below, which is final before the first candidate of
    its level is popped, so the port takes a whole level at once and
    reads its candidates' rows from the device in one gather: the same
    affected set, with one device read a level instead of one a vertex.
    """
    if not _symmetric(applied):
        return bfs_dirty_seeds_conservative(
            applied, state, codec=codec, split_threshold=split_threshold)
    graph = applied.new_graph
    n = graph.num_vertices
    dist = _host(state.dist).astype(np.int64)

    affected = np.zeros(n, dtype=bool)
    seed_mask = np.zeros(n, dtype=bool)
    if applied.del_src.size:
        du = dist[applied.del_src]
        dv = dist[applied.del_dst]
        on_tree = (du < BFS_INF) & (dv == du + 1)
        pending = {}  # level -> candidate arrays
        for lv in np.unique(dv[on_tree]).tolist():
            pending[lv] = [applied.del_dst[on_tree & (dv == lv)]]
        while pending:
            L = min(pending)
            cand = np.unique(np.concatenate(pending.pop(L)))
            owner, nb = _neighbors(graph, cand)
            dn = dist[nb]
            supported = np.unique(owner[(dn == L - 1) & ~affected[nb]])
            lost = cand[~np.isin(cand, supported)]
            affected[lost] = True
            child = nb[np.isin(owner, lost) & (dn == L + 1) & ~affected[nb]]
            if child.size:
                pending.setdefault(L + 1, []).append(child)
    if affected.any():
        _, nb = _neighbors(graph, np.flatnonzero(affected))
        seed_mask[nb[(dist[nb] < BFS_INF) & ~affected[nb]]] = True
        dist[affected] = BFS_INF
    if applied.ins_src.size:
        iu = applied.ins_src[dist[applied.ins_src] < BFS_INF]
        seed_mask[iu] = True

    device = state.dist.device
    seeds = _chunked(np.flatnonzero(seed_mask), codec, graph.row_ptr,
                     split_threshold, device)
    new_state = dataclasses.replace(state, dist=torch.as_tensor(
        dist.astype(np.int32), device=device))
    return new_state, seeds


def bfs_dirty_seeds_conservative(applied: AppliedDelta, state, *,
                                 codec: ChunkCodec, split_threshold):
    """Monotone re-relaxation with level-cut invalidation: resets every
    level at or past the lowest deleted tree edge's target (always a
    superset of the region-pruned reset) and seeds the finite vertices with
    an INF out-neighbor on the new graph."""
    g = applied.csr()
    n = g.num_vertices
    rp, ci = _csr_host(g)
    dist = _host(state.dist).astype(np.int64)

    invalidated = False
    if applied.del_src.size:
        du = dist[applied.del_src]
        dv = dist[applied.del_dst]
        on_tree = (du < BFS_INF) & (dv == du + 1)
        if on_tree.any():
            L = int(dv[on_tree].min())
            dist = np.where(dist >= L, BFS_INF, dist)
            invalidated = True

    seed_mask = np.zeros(n, dtype=bool)
    if invalidated:
        src = np.repeat(np.arange(n, dtype=np.int64), np.diff(rp))
        to_inf = dist[ci] == BFS_INF
        has_inf_nbr = np.bincount(src[to_inf], minlength=n) > 0
        seed_mask |= (dist < BFS_INF) & has_inf_nbr
    if applied.ins_src.size:
        iu = applied.ins_src[dist[applied.ins_src] < BFS_INF]
        seed_mask[iu] = True

    device = state.dist.device
    seeds = _chunked(np.flatnonzero(seed_mask), codec, rp, split_threshold,
                     device)
    new_state = dataclasses.replace(state, dist=torch.as_tensor(
        dist.astype(np.int32), device=device))
    return new_state, seeds


# ----------------------------------------------------------------- PageRank
def pagerank_dirty_seeds(applied: AppliedDelta, state, *, damping: float,
                         eps: float, codec: ChunkCodec, split_threshold,
                         max_sweeps: int = 400):
    """Invariant restoration and negative-residue decay (module doc), in
    float64 on the graph's device."""
    g = applied.csr()
    n, m = g.num_vertices, g.num_edges
    rp = g.row_ptr.to(torch.int64)
    deg_i = rp[1:] - rp[:-1]
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=rp.device), deg_i,
        output_size=m)
    zeros = torch.zeros(n, dtype=torch.float64, device=rp.device)

    def in_sums(w):
        # np.bincount(col_idx, weights=w[src], minlength=n): each vertex's
        # in-edge terms added left to right from 0.0, in CSR order
        return ordered_scatter_add(zeros, g.col_idx, w[src])

    rank = state.rank.to(torch.float64)
    deg = torch.clamp(deg_i, min=1).to(torch.float64)
    # residue := (1-d)*1 + d * sum_{u->v} rank[u]/deg(u) - rank[v] on the
    # NEW graph: the exact error of the carried rank as a solution here
    contrib = damping * rank / deg
    residue = (1.0 - damping) + in_sums(contrib) - rank

    # decay negative mass (deleted in-edges): harvest into rank, push the
    # damped share along out-edges; the negative mass shrinks x damping a
    # sweep
    sweeps = 0
    for _ in range(max_sweeps):
        neg = residue < -eps
        if not bool(neg.any()):
            break
        sweeps += 1
        res_neg = torch.where(neg, residue, 0.0)
        rank = rank + res_neg
        residue = torch.where(neg, 0.0, residue)
        residue = residue + in_sums(damping * res_neg / deg)
    applied.meters["sweeps"] = sweeps

    rank32 = rank.to(torch.float32)
    residue32 = residue.to(torch.float32)
    over = residue32 > eps
    seeds = _chunked(np.flatnonzero(_host(over)), codec,
                     _host(g.row_ptr).astype(np.int64), split_threshold,
                     state.rank.device)
    new_state = dataclasses.replace(state, rank=rank32, residue=residue32,
                                    in_queue=over)
    return new_state, seeds


# ----------------------------------------------------------------- coloring
def _priority_host(v: np.ndarray) -> np.ndarray:
    """numpy mirror of ``algorithms.coloring._priority`` (uint32 wraps)."""
    v = v.astype(np.uint32)
    h = (v * np.uint32(2654435761)) ^ np.uint32(0x9E3779B9)
    h = (h ^ (h >> np.uint32(13))) * np.uint32(0x85EBCA6B)
    return h ^ (h >> np.uint32(16))


def coloring_dirty_seeds(applied: AppliedDelta, state, *, codec: ChunkCodec,
                         split_threshold):
    """Conflict-endpoint recoloring (``"conflicts"`` mode)."""
    rp = _host(applied.new_graph.row_ptr).astype(np.int64)
    colors = _host(state.colors)

    dirty = []
    u, v = applied.ins_src, applied.ins_dst
    if u.size:
        conflict = (colors[u] >= 0) & (colors[u] == colors[v])
        if conflict.any():
            cu, cv = u[conflict], v[conflict]
            pu, pv = _priority_host(cu), _priority_host(cv)
            # the endpoint with the HIGHER (hash, id) priority recolors
            u_loses = (pv < pu) | ((pv == pu) & (cv < cu))
            dirty.append(np.where(u_loses, cu, cv))
    uncolored = np.flatnonzero(colors < 0)  # defensive: partial prior state
    if uncolored.size:
        dirty.append(uncolored)

    device = state.colors.device
    if not dirty:
        return state, torch.zeros(0, dtype=torch.int32, device=device)
    # assign tasks: +(chunk code + 1), the coloring sign convention
    seeds = _chunked(np.concatenate(dirty), codec, rp, split_threshold,
                     device) + 1
    return state, seeds
