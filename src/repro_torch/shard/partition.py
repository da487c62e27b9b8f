"""Vertex-block graph partitioner for the sharded task scheduler.

The counterpart of ``repro/shard/partition.py`` (its own copy of the host
math).  Shard ``d`` of ``S`` owns vertices ``[d*B, min(n, (d+1)*B))`` with
``B = ceil(n / S)``; :func:`owner_of` routes every produced task to the
shard that owns its head vertex.

The CSR adjacency is resharded: each shard holds only the edges of its own
block and, when stealing is on, a **steal halo**: a replica of its ring
predecessor's block, so donated tasks expand on the thief (twice the edge
storage).  Each shard's ``row_ptr`` keeps the global ``[n + 1]`` vertex
index space with local edge offsets, so the wavefront bodies run
unchanged on a shard-local :class:`~repro_torch.graph.csr.CSRGraph`;
entries of rows a shard neither owns nor haloes are zero and never read.

The reference stacks the slices into ``[S, ...]`` arrays padded to the
widest shard, because ``shard_map`` splits uniform shapes.  The port keeps
each shard's ``row_ptr`` and ``col_idx`` unpadded (``col_idx`` at least one
entry long) on that shard's own device: a shard on its own card pays for
its own edges only.  The slices are cut on the graph's device and moved
once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..graph.csr import CSRGraph

_I32 = torch.int32


def block_size(n: int, num_shards: int) -> int:
    """Vertices per shard (ceil split; trailing shards may be short or
    empty)."""
    return -(-n // num_shards)


def owner_of(vids, n: int, num_shards: int):
    """Owning shard of each vertex id (a tensor in, an int32 tensor out;
    callers mask invalid lanes to a safe id first)."""
    b = max(block_size(n, num_shards), 1)
    return torch.clamp(torch.as_tensor(vids).to(_I32) // b, 0,
                       num_shards - 1)


def block_bounds(shard: int, n: int, num_shards: int) -> Tuple[int, int]:
    """``[start, end)`` vertex range owned by ``shard``."""
    b = block_size(n, num_shards)
    return min(n, shard * b), min(n, (shard + 1) * b)


def owner_coords(vids, n: int, rows: int, cols: int):
    """2-D mesh coordinates ``(row, col)`` of each vertex's owner: the
    linear owner ``d`` of the 1-D split over ``rows * cols`` shards sits
    at ``(d // cols, d % cols)``."""
    d = owner_of(vids, n, rows * cols)
    return d // cols, d % cols


@dataclasses.dataclass(frozen=True)
class ShardedCSR:
    """Per-shard CSR slices, shard ``d``'s on ``devices[d]``.

    ``row_ptr[d]`` is an ``[n + 1]`` int32 tensor of local edge offsets
    for shard ``d``'s own (and halo) rows and zeros elsewhere;
    ``col_idx[d]`` holds shard ``d``'s edges (global neighbor ids).
    """

    row_ptr: Tuple[torch.Tensor, ...]
    col_idx: Tuple[torch.Tensor, ...]
    num_shards: int
    num_vertices: int
    halo: bool                # ring-predecessor block replicated (stealing)
    edges_per_shard: Tuple[int, ...]   # owned edges only (diagnostic)

    def local(self, shard: int) -> CSRGraph:
        """Shard ``shard``'s graph view."""
        return CSRGraph(row_ptr=self.row_ptr[shard],
                        col_idx=self.col_idx[shard])


def build_slice(d: int, n: int, num_shards: int, halo: bool, rp_dev,
                rp_at, cols_of) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Shard ``d``'s ``(row_ptr, col_idx, owned edges)``, cut on
    ``rp_dev``'s device: the slice format :func:`partition_graph` builds
    and ``stream/ingest.reshard`` patches per owner.

    ``rp_dev`` is the graph's ``[n + 1]`` row_ptr on its device,
    ``rp_at[v]`` the same offset on the host (read at block bounds only),
    ``cols_of(lo, hi)`` the concatenated neighbor lists of rows
    ``[lo, hi)`` (a ``col_idx`` slice of a CSR, ``SlottedCSR.range_cols``
    of a slotted graph); ``halo`` is whether the halo is in use.
    """
    own_lo, own_hi = block_bounds(d, n, num_shards)
    e_lo, e_hi = int(rp_at[own_lo]), int(rp_at[own_hi])

    def cut(lo_v: int, hi_v: int, base: int):
        """row_ptr entries of rows [lo_v, hi_v], shifted to start at
        ``base``."""
        return (rp_dev[lo_v:hi_v + 1].to(torch.int64)
                - int(rp_at[lo_v]) + base).to(_I32)

    lrp = torch.zeros(n + 1, dtype=_I32, device=rp_dev.device)
    if halo and d > 0:
        # the predecessor block immediately precedes the own block in
        # vertex (and so edge) space: one contiguous slice
        pre_lo, _ = block_bounds(d - 1, n, num_shards)
        lcol = cols_of(pre_lo, own_hi)
        lrp[pre_lo:own_hi + 1] = cut(pre_lo, own_hi, 0)
    elif halo:
        # shard 0's predecessor is the last block: [own | halo] edges
        pre_lo, pre_hi = block_bounds(num_shards - 1, n, num_shards)
        lcol = torch.cat([cols_of(own_lo, own_hi), cols_of(pre_lo, pre_hi)])
        lrp[own_lo:own_hi + 1] = cut(own_lo, own_hi, 0)
        lrp[pre_lo:pre_hi + 1] = cut(pre_lo, pre_hi, e_hi - e_lo)
    else:
        lcol = cols_of(own_lo, own_hi)
        lrp[own_lo:own_hi + 1] = cut(own_lo, own_hi, 0)
    if lcol.shape[0] == 0:
        # an edgeless shard keeps one unread entry: gathers clamp
        lcol = torch.zeros(1, dtype=_I32, device=rp_dev.device)
    return lrp, lcol, e_hi - e_lo


def partition_graph(graph: CSRGraph, num_shards: int, halo: bool = True,
                    devices: Optional[Sequence] = None) -> ShardedCSR:
    """Reshard ``graph`` by vertex block onto ``devices`` (default: every
    shard on the graph's device).

    With ``halo=True`` (and more than one shard) shard ``d`` also carries
    shard ``(d - 1) % S``'s rows: the only foreign tasks a shard ever pops
    are donations from its ring predecessor (``shard/steal.py``).
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    devices = ([graph.device] * num_shards if devices is None
               else [torch.device(d) for d in devices])
    n = graph.num_vertices
    rp = graph.row_ptr.cpu().numpy().astype(np.int64)
    col = graph.col_idx
    use_halo = halo and num_shards > 1

    def cols_of(lo_v: int, hi_v: int):
        return col[int(rp[lo_v]):int(rp[hi_v])]

    row_ptrs, cols, owned = [], [], []
    for d in range(num_shards):
        lrp, lcol, e = build_slice(d, n, num_shards, use_halo,
                                   graph.row_ptr, rp, cols_of)
        owned.append(e)
        row_ptrs.append(lrp.to(devices[d]))
        cols.append(lcol.contiguous().to(devices[d]))
    return ShardedCSR(row_ptr=tuple(row_ptrs), col_idx=tuple(cols),
                      num_shards=num_shards, num_vertices=n, halo=use_halo,
                      edges_per_shard=tuple(owned))


def split_seeds(seeds, n: int, num_shards: int, task_vertex=None):
    """Host-side owner split of the initial tasks: ``[S, max_per_shard]``
    int32 items and the per-shard counts (numpy), what seeds each shard's
    queue replica.  ``task_vertex`` maps a task to its vertex (identity by
    default; a tensor function, applied on the host)."""
    seeds = np.asarray(torch.as_tensor(seeds).cpu(), dtype=np.int32)
    verts = seeds if task_vertex is None else np.asarray(
        task_vertex(torch.as_tensor(seeds)), dtype=np.int32)
    owners = np.clip(verts // max(block_size(n, num_shards), 1), 0,
                     num_shards - 1)
    per = [seeds[owners == d] for d in range(num_shards)]
    width = max(1, max(len(p) for p in per))
    out = np.zeros((num_shards, width), dtype=np.int32)
    counts = np.zeros((num_shards,), dtype=np.int32)
    for d, p in enumerate(per):
        out[d, :len(p)] = p
        counts[d] = len(p)
    return out, counts
