"""Delta ingestion: commit an :class:`EdgeDelta` batch against the graph.

The counterpart of ``repro/stream/ingest.py``.  Two commit paths produce
the canonical edge set (sorted unique directed pairs, self-loops dropped):

* **reference** (:func:`apply_delta` on a :class:`~repro_torch.graph.csr.
  CSRGraph`): set algebra on the int64 pair keys and a full ``from_edges``
  rebuild, O(m) per batch, kept as the oracle.  It runs in PyTorch on the
  graph's device (integer sorts and set operations give the reference's
  arrays exactly);
* **slotted** (:func:`apply_delta` on a :class:`~repro_torch.graph.slotted.
  SlottedCSR`, or :func:`commit`, which adds the compaction schedule):
  in-place slab inserts and deletes plus the overlay, O(touched rows).

Inserting a present edge or deleting an absent one is a no-op on both.
:func:`reshard` patches a sharded partition per owner after a commit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import CSRGraph, from_edges
from ..graph.slotted import SlottedCSR
from .deltas import EdgeDelta


@dataclasses.dataclass(frozen=True, eq=False)
class AppliedDelta:
    """A committed batch: the graphs on both sides and the *effective* ops
    (no-ops filtered out), which the dirty-seed rules key off.

    On the slotted path ``new_graph`` is a device :class:`~repro_torch.
    graph.slotted.SlottedView`; a host rule that needs a flat ``col_idx``
    calls :meth:`csr` (materialized once, valid until the next commit).
    ``touched_rows`` / ``compacted`` meter the commit.  ``meters`` takes
    what a dirty-seed rule reports about its own work (PageRank's decay
    sweeps).
    """

    old_graph: object     # CSRGraph | SlottedView before the batch
    new_graph: object     # CSRGraph | SlottedView after the batch
    ins_src: np.ndarray   # int32 [ki] effective inserts
    ins_dst: np.ndarray
    del_src: np.ndarray   # int32 [kd] effective deletes
    del_dst: np.ndarray
    slotted: SlottedCSR | None = None
    touched_rows: int = 0        # rows rewritten in place (0 = full rebuild)
    compacted: bool = False
    meters: dict = dataclasses.field(default_factory=dict)
    _csr_cache: list = dataclasses.field(default_factory=list, repr=False)

    @property
    def num_effective(self) -> int:
        return int(self.ins_src.size + self.del_src.size)

    def csr(self) -> CSRGraph:
        """Canonical materialization of ``new_graph``."""
        if self.slotted is None:
            return self.new_graph
        if not self._csr_cache:
            self._csr_cache.append(self.slotted.to_csr())
        return self._csr_cache[0]


def _check_n(graph, delta: EdgeDelta) -> int:
    n = graph.num_vertices
    if delta.num_vertices != n:
        raise ValueError(
            f"delta is for {delta.num_vertices} vertices, graph has {n}")
    return n


def _edge_keys(graph: CSRGraph) -> torch.Tensor:
    """Sorted int64 ``src * n + dst`` keys of the CSR's directed edges, on
    the graph's device (CSR order is sorted by ``(src, dst)`` already)."""
    n = graph.num_vertices
    rp = graph.row_ptr.to(torch.int64)
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=rp.device),
        rp[1:] - rp[:-1], output_size=graph.num_edges)
    return src * n + graph.col_idx.to(torch.int64)


def apply_delta(graph, delta: EdgeDelta) -> AppliedDelta:
    """Commit one canonical batch; returns the :class:`AppliedDelta`.

    A :class:`CSRGraph` takes the O(m) reference rebuild on its device, a
    :class:`SlottedCSR` the O(touched rows) in-place path (mutating it; no
    compaction here -- see :func:`commit`).
    """
    n = _check_n(graph, delta)
    if isinstance(graph, SlottedCSR):
        old_view = graph.view()
        ins_s, ins_d, del_s, del_d = graph.apply(
            delta.src, delta.dst, delta.insert)
        return AppliedDelta(
            old_graph=old_view, new_graph=graph.view(),
            ins_src=ins_s, ins_dst=ins_d, del_src=del_s, del_dst=del_d,
            slotted=graph, touched_rows=graph.last_touched)
    old = _edge_keys(graph)
    dkeys = torch.from_numpy(delta.src.astype(np.int64) * n
                             + delta.dst.astype(np.int64)).to(old.device)
    insert = torch.from_numpy(np.asarray(delta.insert, bool)).to(old.device)
    ins_keys, del_keys = dkeys[insert], dkeys[~insert]
    eff_ins = ins_keys[~torch.isin(ins_keys, old)]
    eff_del = del_keys[torch.isin(del_keys, old)]
    new = torch.unique(torch.cat([old[~torch.isin(old, eff_del)], eff_ins]))
    eff_ins, eff_del = eff_ins.cpu().numpy(), eff_del.cpu().numpy()
    return AppliedDelta(
        old_graph=graph,
        new_graph=from_edges(n, new // n, new % n, device=old.device),
        ins_src=(eff_ins // n).astype(np.int32),
        ins_dst=(eff_ins % n).astype(np.int32),
        del_src=(eff_del // n).astype(np.int32),
        del_dst=(eff_del % n).astype(np.int32),
    )


def commit(slotted: SlottedCSR, delta: EdgeDelta, batch_index: int,
           compact_every: int = 0,
           overlay_slack: float = 0.25) -> AppliedDelta:
    """One full slotted commit: in-place apply plus the compaction schedule,
    a pure function of the delta-log prefix and the two knobs, so a resumed
    run that replays ``deltas[:b]`` lands on the same slab layout."""
    applied = apply_delta(slotted, delta)
    slotted.last_compacted = False
    if slotted.should_compact(batch_index, compact_every, overlay_slack):
        slotted.compact()
        slotted.last_compacted = True
        applied = dataclasses.replace(applied, new_graph=slotted.view(),
                                      compacted=True)
    return applied


def replay(graph: CSRGraph, deltas) -> CSRGraph:
    """Fold a delta-log prefix into the graph (the reference path)."""
    for d in deltas:
        graph = apply_delta(graph, d).new_graph
    return graph


def replay_commits(slotted: SlottedCSR, deltas, compact_every: int = 0,
                   overlay_slack: float = 0.25,
                   first_batch: int = 1) -> SlottedCSR:
    """Fold a delta-log prefix through the slotted commit path (resume):
    the same :func:`commit` calls and batch indices, so the same
    compaction schedule and slab layout as the original run."""
    for i, d in enumerate(deltas):
        commit(slotted, d, first_batch + i, compact_every, overlay_slack)
    return slotted


def reshard(graph, num_shards: int, halo: bool = True, *,
            parts=None, touched_rows=None, devices=None):
    """Owner-aware sharded (re)build of a committed graph.

    Without ``parts`` this is the full ``partition_graph`` build of the
    canonical CSR (``to_csr()`` of a :class:`SlottedCSR`), its slices on
    ``devices`` (default: the graph's device).  Ownership blocks are a
    function of ``(n, num_shards)`` only, so re-partitioning the post-delta
    graph keeps every row's owner and steal halo.

    With ``parts`` (the previous :class:`~repro_torch.shard.partition.
    ShardedCSR`), ``touched_rows`` (the rows the commit rewrote) and a
    :class:`SlottedCSR` source, only the **dirty** shards -- owners of
    touched rows, plus their ring successors when ``parts`` carries halos
    (the successor replicates the owner's block) -- are re-extracted
    (``SlottedCSR.range_cols``) and rebuilt on their own devices; clean
    shards keep the very same tensors.  The port's slices are unpadded, so
    a dirty shard that grew needs no restack: the reference's overflow
    fallback to a full build with grown padding has no counterpart here.
    """
    from ..shard.partition import (block_bounds, build_slice, owner_of,
                                   partition_graph)  # lazy: shard -> runtime

    if parts is None or touched_rows is None or \
            not isinstance(graph, SlottedCSR):
        source = graph.to_csr() if isinstance(graph, SlottedCSR) else graph
        return partition_graph(source, num_shards, halo=halo,
                               devices=devices)

    touched = np.unique(np.asarray(touched_rows, dtype=np.int64))
    if touched.size == 0:
        return parts
    n = graph.num_vertices
    owners = np.unique(owner_of(torch.from_numpy(touched), n,
                                num_shards).numpy()).tolist()
    dirty = set(owners)
    if parts.halo:
        dirty |= {(d + 1) % num_shards for d in owners}

    rp_dev = graph.row_ptr64()
    # the edge offsets at every block boundary: one small host read
    at = sorted({v for d in range(num_shards)
                 for v in block_bounds(d, n, num_shards)})
    rp_at = dict(zip(at, rp_dev[torch.as_tensor(
        at, dtype=torch.int64, device=rp_dev.device)].tolist()))

    row_ptr, col_idx = list(parts.row_ptr), list(parts.col_idx)
    owned = list(parts.edges_per_shard)
    for d in sorted(dirty):
        lrp, lcol, owned[d] = build_slice(d, n, num_shards, parts.halo,
                                          rp_dev, rp_at, graph.range_cols)
        row_ptr[d] = lrp.to(parts.row_ptr[d].device)
        col_idx[d] = lcol.contiguous().to(parts.col_idx[d].device)
    return dataclasses.replace(parts, row_ptr=tuple(row_ptr),
                               col_idx=tuple(col_idx),
                               edges_per_shard=tuple(owned))
