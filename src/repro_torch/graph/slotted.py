"""Slotted CSR: the O(delta) commit representation for streaming graphs.

The counterpart of ``repro/graph/slotted.py``.  A canonical CSR (sorted
unique ``(src, dst)`` pairs, self-loops dropped) is kept mutable in place:

  * every row owns a **slab**, a power-of-two slot run inside one flat
    ``slab_col`` array, sized ``next_pow2(max(1, degree))`` at build and
    compaction time; its live prefix (``slab_len[r]`` entries) holds the
    row's smallest neighbors in sorted order;
  * a row that outgrows its slab spills its sorted tail into the
    **overlay** (``ovl_row`` / ``ovl_col``, lexsorted by ``(row, col)``);
  * a **compaction** re-packs everything into right-sized slabs with an
    empty overlay.

A row reads as ``slab prefix ++ overlay tail``, so the materialized CSR
(:meth:`SlottedCSR.to_csr`) is bit-identical to ``from_edges`` on the same
edge set, and the device :class:`SlottedView` carries the canonical
``row_ptr``: every consumer of degree sums runs unchanged, and only the
neighbor gather is two-level (``core/frontier.gather_neighbors``).

Slab-slack invariant: after every commit ``cap(r) <= SLAB_SLACK * max(1,
deg(r))`` for every row, or the next compaction is forced.  It bounds a
chunk's slab span, which the megakernel's row-slice stream reads.

The whole slotted graph lives on one device, the stream's: the per-row
arrays, the slab array and the overlay are tensors there, and every row
read goes through the two-level gather (:func:`row_neighbors`).
:meth:`SlottedCSR.apply` takes a batch as int64 pair keys at once (the
reference loops over the batch's rows and selects each row's ops with a
mask over the whole batch) and rebuilds only the touched rows.  Every
array, flag and effective op equals the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.frontier import adjacency_of, gather_neighbors
from .csr import CSRGraph

#: slab-slack bound: a row's slab capacity never exceeds this multiple of
#: its live degree (a violating commit forces the next compaction)
SLAB_SLACK = 4

_I32 = torch.int32
_I64 = torch.int64


def _next_pow2(x: torch.Tensor) -> torch.Tensor:
    """Elementwise next power of two of ``max(1, x)`` (int64)."""
    x = torch.clamp(x.to(_I64), min=1)
    p = torch.exp2(torch.ceil(torch.log2(x.to(torch.float64)))).to(_I64)
    p = torch.where(p < x, p * 2, p)  # exact, whatever log2 rounds to
    return torch.where(p // 2 >= x, p // 2, p)


def _seg_indices(starts: torch.Tensor, lens: torch.Tensor,
                 total: int) -> torch.Tensor:
    """Concatenated ``[starts[i], starts[i] + lens[i])`` ranges (int64, on
    the operands' device); ``total`` is ``lens.sum()``."""
    lens = lens.to(_I64)
    intra = (torch.arange(total, dtype=_I64, device=lens.device)
             - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens,
                                       output_size=total))
    return torch.repeat_interleave(starts.to(_I64), lens,
                                   output_size=total) + intra


def _is_symmetric(n: int, src: torch.Tensor, col: torch.Tensor) -> bool:
    """Does the directed edge set (in CSR order) equal its transpose?"""
    keys = src * n + col
    return bool(torch.equal(keys, torch.sort(col * n + src).values))


def _member(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``isin(keys, sorted_keys)`` for a sorted unique ``sorted_keys``."""
    if sorted_keys.numel() == 0:
        return torch.zeros(keys.shape, dtype=torch.bool, device=keys.device)
    pos = torch.clamp(torch.searchsorted(sorted_keys, keys),
                      max=sorted_keys.numel() - 1)
    return sorted_keys[pos] == keys


def row_neighbors(graph, rows: torch.Tensor) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
    """``(owner, nbr)``, int64 on the graph's device: the neighbors of the
    sorted unique ``rows`` of a canonical or slotted graph, row after row
    and each row's in sorted order, each beside its row.  O(their
    degrees): a slotted graph reads them through the two-level gather."""
    row_ptr, cols, overlay = adjacency_of(graph)
    rows = rows.to(_I64)
    rp = row_ptr.to(_I64)
    counts = rp[rows + 1] - rp[rows]
    total = int(counts.sum())
    owner = torch.repeat_interleave(rows, counts, output_size=total)
    edge = _seg_indices(rp[rows], counts, total)
    return owner, gather_neighbors(row_ptr, cols, owner, edge,
                                   overlay=overlay).to(_I64)


class Overlay(NamedTuple):
    """The two-level gather's companion (``core/frontier``).

    The gather for in-row offset ``off`` of row ``r`` reads the slab
    (``slab_col[slab_ptr[r] + off]``) while ``off < slab_len[r]`` and the
    overlay tail (``ovl_col[ovl_ptr[r] + off - slab_len[r]]``) past it.
    """

    slab_ptr: torch.Tensor   # [n+1] int32 slab slot offsets
    slab_len: torch.Tensor   # [n]   int32 live prefix length per row
    ovl_ptr: torch.Tensor    # [n+1] int32 overlay segment offsets
    ovl_col: torch.Tensor    # [>=1] int32 overlay neighbor ids (row-major)


@dataclasses.dataclass(frozen=True)
class SlottedView:
    """Immutable device snapshot of a :class:`SlottedCSR`.

    Reads like a :class:`~repro_torch.graph.csr.CSRGraph` (``row_ptr`` is
    the canonical degree prefix sum; ``num_vertices``, ``num_edges``,
    ``device`` and ``degrees()`` behave alike) but deliberately has **no**
    ``col_idx``: a consumer that would flat-gather neighbors must go
    through ``core.frontier.adjacency_of`` and the two-level gather.
    """

    row_ptr: torch.Tensor    # [n+1] int32, canonical (== from_edges row_ptr)
    slab_ptr: torch.Tensor   # [n+1] int32
    slab_len: torch.Tensor   # [n]   int32
    slab_col: torch.Tensor   # [S]   int32 slab slots (live prefixes + padding)
    ovl_ptr: torch.Tensor    # [n+1] int32
    ovl_col: torch.Tensor    # [>=1] int32
    m: int                   # edge count

    @property
    def num_vertices(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.m

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    @property
    def overlay(self) -> Overlay:
        return Overlay(slab_ptr=self.slab_ptr, slab_len=self.slab_len,
                       ovl_ptr=self.ovl_ptr, ovl_col=self.ovl_col)

    def to(self, device) -> "SlottedView":
        device = resolve_device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "m"})

    def edge_targets(self) -> torch.Tensor:
        """[m] int32: every edge's neighbor in canonical CSR order, read
        through the two-level gather (the canonical ``col_idx``)."""
        src = torch.repeat_interleave(
            torch.arange(self.num_vertices, dtype=_I32, device=self.device),
            self.degrees(), output_size=self.m)
        edge = torch.arange(self.m, dtype=_I32, device=self.device)
        return gather_neighbors(self.row_ptr, self.slab_col, src, edge,
                                overlay=self.overlay)


class SlottedCSR:
    """Mutable slotted CSR; one instance per stream.

    All mutation happens through :meth:`apply` (one canonical
    :class:`~repro_torch.stream.deltas.EdgeDelta`) and :meth:`compact` (a
    full re-pack, amortized by its triggers).  ``commits`` /
    ``compactions`` / ``touched_rows`` meter the commit cost.

    Every array is a tensor on the graph's device, with the reference's
    dtypes.  A mutation writes new tensors and never into old ones, so a
    :meth:`view` taken before it stays as it was.
    """

    def __init__(self, n: int, slab_ptr: torch.Tensor,
                 slab_col: torch.Tensor, slab_len: torch.Tensor,
                 deg: torch.Tensor, ovl_row: torch.Tensor,
                 ovl_col: torch.Tensor, symmetric: bool = False):
        self.n = int(n)
        self.slab_ptr = slab_ptr          # int64 [n+1]
        self.slab_col = slab_col          # int32 [slab_ptr[-1]]
        self.slab_len = slab_len          # int32 [n]
        self.deg = deg                    # int32 [n]
        self.ovl_row = ovl_row            # int32 [O] sorted by (row, col)
        self.ovl_col = ovl_col            # int32 [O]
        #: the symmetric-workload contract, tracked per commit so the
        #: tight BFS rule can prove its regional search exhaustive
        self.symmetric = bool(symmetric)
        self.commits = 0
        self.compactions = 0
        self.touched_rows = 0             # cumulative, across commits
        self.last_touched = 0             # rows rewritten by the last apply
        self.last_compacted = False       # did the last commit() compact?
        self._slack_violated = False
        self._view: Optional[SlottedView] = None

    # ------------------------------------------------------------ build
    @classmethod
    def from_csr(cls, graph: CSRGraph) -> "SlottedCSR":
        """O(m) one-time build from a canonical CSR (stream start), on the
        graph's device."""
        n, m = graph.num_vertices, graph.num_edges
        rp = graph.row_ptr.to(_I64)
        deg = rp[1:] - rp[:-1]
        slab_ptr = torch.zeros(n + 1, dtype=_I64, device=rp.device)
        slab_ptr[1:] = torch.cumsum(_next_pow2(deg), 0)
        slab = torch.zeros(int(slab_ptr[-1]), dtype=_I32, device=rp.device)
        slab[_seg_indices(slab_ptr[:-1], deg, m)] = graph.col_idx.to(_I32)
        src = torch.repeat_interleave(
            torch.arange(n, dtype=_I64, device=rp.device), deg,
            output_size=m)
        symmetric = _is_symmetric(n, src, graph.col_idx.to(_I64))
        deg = deg.to(_I32)
        empty = torch.empty(0, dtype=_I32, device=rp.device)
        return cls(n, slab_ptr, slab, deg, deg.clone(), empty, empty.clone(),
                   symmetric=symmetric)

    # ------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.slab_col.device

    @property
    def num_vertices(self) -> int:
        return self.n

    @property
    def num_edges(self) -> int:
        return int(self.deg.sum())

    @property
    def overlay_size(self) -> int:
        return int(self.ovl_row.numel())

    # ------------------------------------------------------------ reads
    def row_ptr64(self) -> torch.Tensor:
        """Canonical int64 ``[n+1]`` degree prefix sums, on the graph's
        device."""
        rp = torch.zeros(self.n + 1, dtype=_I64, device=self.device)
        rp[1:] = torch.cumsum(self.deg.to(_I64), 0)
        return rp

    def range_cols(self, lo: int, hi: int) -> torch.Tensor:
        """Concatenated canonical neighbor lists of rows ``[lo, hi)`` (int32
        on the graph's device, O(edges in range)): the sharded per-owner
        patch's row extraction (``stream/ingest.reshard``).  One two-level
        gather over the range, no loop over rows."""
        rows = torch.arange(lo, max(lo, hi), dtype=_I64, device=self.device)
        return row_neighbors(self.view(), rows)[1].to(_I32)

    def to_csr(self) -> CSRGraph:
        """Canonical materialization -- bit-identical to ``from_edges`` on
        the same edge set."""
        v = self.view()
        return CSRGraph(row_ptr=v.row_ptr, col_idx=v.edge_targets())

    def view(self) -> SlottedView:
        """Device snapshot (cached until the next mutation)."""
        if self._view is None:
            n, dev = self.n, self.device
            rp = self.row_ptr64()
            ovl_ptr = torch.zeros(n + 1, dtype=_I64, device=dev)
            ovl_ptr[1:] = torch.cumsum(
                torch.bincount(self.ovl_row.to(_I64), minlength=n), 0)
            ovl = self.ovl_col if self.ovl_col.numel() else \
                torch.zeros(1, dtype=_I32, device=dev)
            self._view = SlottedView(
                row_ptr=rp.to(_I32), slab_ptr=self.slab_ptr.to(_I32),
                slab_len=self.slab_len, slab_col=self.slab_col,
                ovl_ptr=ovl_ptr.to(_I32), ovl_col=ovl, m=int(rp[-1]))
        return self._view

    # ----------------------------------------------------------- commit
    def apply(self, src: np.ndarray, dst: np.ndarray,
              insert: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Commit one canonical op batch.

        ``(src, dst, insert)`` is an :class:`~repro_torch.stream.deltas.
        EdgeDelta`'s payload: unique ``(src, dst)`` pairs with a net verdict
        each, self-loops rejected.  Inserting a present edge or deleting an
        absent one is a no-op.  Returns the *effective* ops ``(ins_src,
        ins_dst, del_src, del_dst)`` as numpy, rows ascending and each row's
        ops in batch order, as the reference's per-row loop emits them.

        The batch's rows are read and the touched rows rebuilt in O(their
        degrees): a row's keys less the deletes, merged with the inserts,
        the first ``slab_cap`` of them into its slab and the rest into the
        overlay.  The slab array is written as a new copy (O(slab) on the
        device) so that earlier views keep theirs.
        """
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        insert = np.asarray(insert, dtype=bool)
        if src.size and np.any(src[1:] < src[:-1]):
            # a stable sort keeps the batch order inside a row (a canonical
            # batch is sorted already)
            order = np.argsort(src, kind="stable")
            src, dst, insert = src[order], dst[order], insert[order]
        n, dev = self.n, self.device

        def put(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(dev)

        key = src.astype(np.int64) * n + dst
        owner, nbr = row_neighbors(self.view(), put(np.unique(src)))
        cur = owner * n + nbr
        present = _member(cur, put(key)).cpu().numpy()
        eff_ins = insert & ~present
        eff_del = ~insert & present
        touched = np.unique(src[eff_ins | eff_del])
        slack_hit = False
        if touched.size:
            rows = put(touched)
            old = cur[torch.isin(owner, rows)]
            old = old[~torch.isin(old, put(key[eff_del]))]
            new = torch.sort(torch.cat([old, put(np.unique(key[eff_ins]))]))\
                .values
            new_row = new // n
            lo = torch.searchsorted(new_row, rows)
            cnt = torch.searchsorted(new_row, rows, right=True) - lo
            start = self.slab_ptr[rows]
            caps = self.slab_ptr[rows + 1] - start
            k = torch.minimum(cnt, caps)
            total = new.numel()
            intra = (torch.arange(total, dtype=_I64, device=dev)
                     - torch.repeat_interleave(lo, cnt, output_size=total))
            in_slab = intra < torch.repeat_interleave(k, cnt,
                                                      output_size=total)
            slot = torch.repeat_interleave(start, cnt,
                                           output_size=total) + intra
            slab = self.slab_col.clone()
            slab[slot[in_slab]] = (new[in_slab] % n).to(_I32)
            self.slab_col = slab
            self.slab_len = self.slab_len.index_put((rows,), k.to(_I32))
            self.deg = self.deg.index_put((rows,), cnt.to(_I32))
            slack_hit = bool(torch.any(
                caps > SLAB_SLACK * torch.clamp(cnt, min=1)))
            # the flat overlay: untouched rows' entries as they were, the
            # touched rows' fresh tails, sorted by (row, col) as one key
            okey = self.ovl_row.to(_I64) * n + self.ovl_col.to(_I64)
            okey = torch.sort(torch.cat([
                okey[~torch.isin(self.ovl_row.to(_I64), rows)],
                new[~in_slab]])).values
            self.ovl_row = (okey // n).to(_I32)
            self.ovl_col = (okey % n).to(_I32)
            self._view = None
        self.commits += 1
        self.last_touched = int(touched.size)
        self.touched_rows += int(touched.size)
        self._slack_violated = self._slack_violated or slack_hit
        ins_s, ins_d = src[eff_ins], dst[eff_ins]
        del_s, del_d = src[eff_del], dst[eff_del]
        # the graph stays symmetric iff every effective op's mirror holds
        # too (an insert needs (c, r) present, a delete needs it absent); a
        # batch cannot restore a broken flag -- compact() re-detects it
        if self.symmetric and (ins_s.size or del_s.size):
            mo, mn = row_neighbors(self.view(), put(np.unique(
                np.concatenate([ins_d, del_d]))))
            mirrors = mo * n + mn
            self.symmetric = bool(
                _member(mirrors, put(ins_d.astype(np.int64) * n
                                     + ins_s)).all()) and not bool(
                _member(mirrors, put(del_d.astype(np.int64) * n
                                     + del_s)).any())
        return ins_s, ins_d, del_s, del_d

    # ------------------------------------------------------- compaction
    def should_compact(self, batch_index: int, compact_every: int,
                       overlay_slack: float) -> bool:
        """Deterministic compaction trigger (a pure function of the delta
        log and the knobs): a violated slab-slack bound, every
        ``compact_every`` batches, or an overlay above ``overlay_slack *
        m``."""
        if self._slack_violated:
            return True
        if compact_every > 0 and batch_index % compact_every == 0:
            return True
        return self.overlay_size > overlay_slack * max(1, self.num_edges)

    def compact(self) -> None:
        """Re-pack into fresh right-sized slabs; the overlay empties and the
        materialized edge set is untouched."""
        v = self.view()
        col = v.edge_targets()
        deg = self.deg.to(_I64)
        slab_ptr = torch.zeros(self.n + 1, dtype=_I64, device=v.device)
        slab_ptr[1:] = torch.cumsum(_next_pow2(deg), 0)
        slab = torch.zeros(int(slab_ptr[-1]), dtype=_I32, device=v.device)
        slab[_seg_indices(slab_ptr[:-1], deg, v.m)] = col
        self.slab_ptr, self.slab_col = slab_ptr, slab
        self.slab_len = self.deg.clone()
        self.ovl_row = torch.empty(0, dtype=_I32, device=v.device)
        self.ovl_col = torch.empty(0, dtype=_I32, device=v.device)
        self.compactions += 1
        self._slack_violated = False
        self._view = None
        if not self.symmetric:
            # later mirrored ops may have restored symmetry; the per-commit
            # rule can only lower the flag, so re-detect exactly here
            src = torch.repeat_interleave(
                torch.arange(self.n, dtype=_I64, device=v.device), deg,
                output_size=v.m)
            self.symmetric = _is_symmetric(self.n, src, col.to(_I64))
