"""Worker-granularity expansion strategies: Atos's task/data-parallel blend.

The counterpart of ``repro/core/frontier.py``.

  * ``expand_per_item``   -- warp-sized worker: one neighbor loop per popped
    task, padded to ``max_degree``;
  * ``expand_merge_path`` -- CTA-sized worker: a load-balancing search
    spreads the wavefront's total neighbor work evenly over the lanes.

``expand_merge_path``'s ``backend`` runs the load-balancing search either
as its plain version or, for CUDA tensors, as the hand-written LBS kernel
(``kernels/frontier_expand``); the glue around the search is shared, and
both give identical outputs.

JAX clamps out-of-range gathers silently; PyTorch raises on the CPU and is
undefined on CUDA.  Every gather below whose index the reference lets run
out of range is clamped explicitly.  The slotted-graph overlay arm of
:func:`gather_neighbors` comes with the streaming slice.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.frontier_expand.kernel import lbs_cuda
from ..kernels.frontier_expand.ref import lbs_ref
from .backend import STREAMS, resolve_backend

_I32 = torch.int32


def _no_overlay(overlay) -> None:
    if overlay is not None:
        raise NotImplementedError(
            "slotted graphs (an edge-log overlay) come with the streaming "
            "slice, ROADMAP A9")


def searchsorted_right(sorted_arr: torch.Tensor,
                       values: torch.Tensor) -> torch.Tensor:
    """Vectorized upper_bound: int32 index of the first element > value."""
    return torch.searchsorted(sorted_arr, values, right=True, out_int32=True)


def adjacency_of(graph):
    """``(row_ptr, cols, overlay)`` of a canonical CSR graph."""
    overlay = getattr(graph, "overlay", None)
    _no_overlay(overlay)
    return graph.row_ptr, graph.col_idx, None


def gather_neighbors(row_ptr: torch.Tensor, cols: torch.Tensor,
                     src: torch.Tensor, edge: torch.Tensor,
                     overlay=None) -> torch.Tensor:
    """Neighbor id at flat canonical edge index ``edge`` (clamped into
    ``[0, m)`` as JAX's gather clamps it)."""
    _no_overlay(overlay)
    return cols[torch.clamp(edge, 0, cols.shape[0] - 1)]


class Expansion(NamedTuple):
    """Flattened (source, neighbor) work units for one wavefront."""

    src: torch.Tensor     # [W] source row per work unit (chunk member)
    nbr: torch.Tensor     # [W] neighbor / column id
    owner: torch.Tensor   # [W] index into the popped wavefront of the source
    valid: torch.Tensor   # [W] bool
    total: torch.Tensor   # 0-dim int32: true number of work units


def chunk_degrees(heads: torch.Tensor, widths, valid: torch.Tensor,
                  row_ptr: torch.Tensor) -> torch.Tensor:
    """Degree sum of each ``[head, head + width)`` chunk (0 where invalid);
    ``widths=None`` is the single-row case."""
    n = row_ptr.shape[0] - 1
    safe = torch.clamp(torch.where(valid, heads, 0), 0, n)
    end = safe + (1 if widths is None else widths.to(_I32))
    end = torch.clamp(end, 0, n)
    return torch.where(valid, row_ptr[end] - row_ptr[safe], 0)


def chunk_row_of(row_ptr: torch.Tensor, head: torch.Tensor, rank: torch.Tensor,
                 widths, max_width: int) -> torch.Tensor:
    """Source row of within-chunk edge offset ``rank`` in ``[head, head+w)``,
    by a ``max_width``-round compare-count against the chunk's local row
    offsets.  ``max_width <= 1`` is the identity."""
    if max_width <= 1:
        return head
    n = row_ptr.shape[0] - 1
    widths = widths.to(_I32)
    base = row_ptr[head]
    local = torch.zeros(head.shape, dtype=_I32, device=head.device)
    for j in range(1, max_width):
        before = row_ptr[torch.clamp(head + j, 0, n)] - base
        local = local + ((j < widths) & (before <= rank)).to(_I32)
    return torch.clamp(head + local, 0, max(n - 1, 0))


def search_for(backend: str, tensor: torch.Tensor):
    """The load-balancing search for operands beside ``tensor``: the LBS
    kernel when ``backend`` resolves to ``"cuda"``, else ``lbs_ref``."""
    return lbs_cuda if resolve_backend(backend, tensor) == "cuda" else lbs_ref


def inclusive_scan(deg: torch.Tensor):
    """``(scan, total)`` of the chunk degrees, in int32 as JAX keeps them."""
    scan = torch.cumsum(deg, 0, dtype=_I32)
    total = (scan[-1] if scan.shape[0] > 0
             else torch.zeros((), dtype=_I32, device=deg.device))
    return scan, total


def lbs_expansion(search, items, valid, row_ptr, col_idx, budget: int,
                  widths=None, max_width: int = 1) -> Expansion:
    """The merge-path expansion around a load-balancing ``search``
    (``scan, budget -> (owner, rank)``, the contract of ``lbs_ref``): the
    chunk degrees and their scan before it, and after it each unit's source
    row and neighbor, masked to the first ``total`` units.  ``rank`` is
    garbage past ``total``; the gathers it feeds are clamped and their
    results masked."""
    safe = torch.where(valid, items, 0)
    deg = chunk_degrees(items, widths, valid, row_ptr)
    scan, total = inclusive_scan(deg)
    owner, rank = search(scan, budget)
    owner = torch.clamp(owner, 0, safe.shape[0] - 1)
    head = safe[owner]
    src = (head if widths is None else
           chunk_row_of(row_ptr, head, rank, widths[owner], max_width))
    k = torch.arange(budget, dtype=_I32, device=safe.device)
    in_range = k < total
    edge = row_ptr[head] + rank
    nbr = gather_neighbors(row_ptr, col_idx, src, edge)
    return Expansion(
        src=torch.where(in_range, src, 0),
        nbr=torch.where(in_range, nbr, 0),
        owner=torch.where(in_range, owner, 0),
        valid=in_range,
        total=total,
    )


def expand_merge_path(items: torch.Tensor, valid: torch.Tensor,
                      row_ptr: torch.Tensor, col_idx: torch.Tensor,
                      work_budget: int, backend: str = "auto",
                      widths: torch.Tensor | None = None, max_width: int = 1,
                      overlay=None) -> Expansion:
    """CTA-style expansion: load-balancing search over the wavefront.

    ``items[i]`` is a vertex id (or EMPTY), or with ``widths`` the head of
    a chunk of ``widths[i]`` rows.  ``work_budget`` is the static number of
    work units per wavefront; units past it are masked out.  ``backend``
    selects the search: the LBS kernel (``kernels/frontier_expand``) when it
    resolves to ``"cuda"``, else its plain version ``lbs_ref``.  The
    internal values ``STREAM`` and ``STREAM_TORCH`` (core/backend.py) of a
    megakernel body expand over streamed row slices instead
    (``kernels/drain_loop/csr_stream``), with an identical result.
    """
    if backend in STREAMS:
        # lazy: kernels/drain_loop imports Expansion and the schedule
        # helpers from this module
        from ..kernels.drain_loop.csr_stream import expand_stream

        return expand_stream(items, valid, row_ptr, col_idx, work_budget,
                             widths=widths, max_width=max_width,
                             overlay=overlay, backend=STREAMS[backend])
    _no_overlay(overlay)
    return lbs_expansion(search_for(backend, row_ptr), items, valid, row_ptr,
                         col_idx, work_budget, widths, max_width)


def expand_per_item(items: torch.Tensor, valid: torch.Tensor,
                    row_ptr: torch.Tensor, col_idx: torch.Tensor,
                    max_degree: int, overlay=None) -> Expansion:
    """Warp-style expansion: one padded neighbor loop per popped item,
    giving a ``[n_items * max_degree]`` work list."""
    _no_overlay(overlay)
    safe = torch.where(valid, items, 0)
    deg = chunk_degrees(items, None, valid, row_ptr)
    j = torch.arange(max_degree, dtype=_I32, device=items.device)
    edge = row_ptr[safe][:, None] + j[None, :]          # [n, max_degree]
    in_range = j[None, :] < deg[:, None]
    src = safe[:, None].expand(edge.shape)
    nbr = gather_neighbors(row_ptr, col_idx, src, edge)
    owner = torch.arange(items.shape[0], dtype=_I32,
                         device=items.device)[:, None].expand(edge.shape)
    return Expansion(
        src=torch.where(in_range, src, 0).reshape(-1),
        nbr=torch.where(in_range, nbr, 0).reshape(-1),
        owner=torch.where(in_range, owner, 0).reshape(-1),
        valid=in_range.reshape(-1),
        total=deg.sum(dtype=_I32),
    )
