"""Graph-coloring case study: BSP speculative greedy (Alg 5) vs relaxed
(Alg 6).

The counterpart of ``repro/algorithms/coloring.py``.  Both variants give
each vertex the smallest color its neighbors do not use (reading possibly
stale neighbor colors), then detect conflicts and re-color.  The relaxed
variant fuses assign and detect in one body; a task's sign tells them
apart: ``+(task + 1)`` assigns, ``-(task + 1)`` detects.  A conflict is
lost by the endpoint with the lower ``(hash, id)`` priority.

**The same outputs, in a flat form.**  The reference pads every row to
the graph's largest degree (``[w, max_degree]``) and builds a one-hot
``[w, max_degree, max_colors]`` table, whose size follows the largest
degree and not the real ones; at ``rmat(15, 16)`` with 4,096 lanes it
asks for 147 GB.  The port gathers each row's neighbors through the
merge-path expansion (kernel B1 on CUDA tensors) with a static budget, the
sum of the largest degrees a wavefront can hold, and finds the smallest
free color in a flag table laid out like the expansion: row ``r`` holds
``deg(r) + 1`` flags at its scan offset, since the pick never exceeds
``deg(r)``, and the answer is the row's first clear flag.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..core import (ChunkCodec, Expansion, SchedulerConfig, WorkCounter,
                    adjacency_of, chunk_degrees, chunk_seeds,
                    coalesce_chunks, expand_merge_path, flatten_chunks)
from ..core.backend import unstreamed
from ..core.frontier import search_for
from ..graph.csr import CSRGraph
from ..runtime.program import AtosProgram, ProgramContext
from ..runtime.programs import reject_unknown_params
from .common import chunking_for, edge_sources, edge_targets, scatter_set

_I32 = torch.int32
_U32 = 0xFFFFFFFF
_BIG = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class ColorState:
    colors: torch.Tensor   # int32 [n], -1 = uncolored
    counter: WorkCounter   # assign tasks processed (Table 4: ratio vs n)


def flat_budget(graph: CSRGraph, lanes: int) -> int:
    """The expansion budget of ``lanes`` distinct rows: the sum of the
    ``lanes`` largest degrees (one host read, when the program is built)."""
    deg = graph.degrees()
    k = min(lanes, deg.shape[0])
    return int(deg.topk(k).values.sum()) if k else 0


def _gather_neighbor_colors(graph: CSRGraph, vids: torch.Tensor,
                            valid: torch.Tensor, budget: int,
                            backend: str = "auto") -> Expansion:
    """The neighbors of the rows ``vids[valid]`` as a flat expansion
    (``owner`` = lane, ``src`` = row, ``nbr`` = neighbor).  ``budget`` must
    be at least the rows' degree sum; no unit is dropped.  Coloring gathers
    flat on every cell, a megakernel body's too."""
    rp, cols, overlay = adjacency_of(graph)
    return expand_merge_path(vids, valid, rp, cols, budget,
                             backend=unstreamed(backend), overlay=overlay)


def _min_free_color(colors: torch.Tensor, ex: Expansion, deg: torch.Tensor,
                    backend: str = "auto") -> torch.Tensor:
    """Per lane: the smallest color in ``[0, deg]`` that no expanded
    neighbor of the lane holds (0 for a lane without rows).  ``deg`` is
    each lane's degree, 0 where the lane takes no part."""
    n_lanes = deg.shape[0]
    size = deg.to(_I32) + 1
    incl = torch.cumsum(size, 0, dtype=_I32)
    off = incl - size
    table = ex.nbr.shape[0] + n_lanes          # static: >= incl[-1]
    owner = ex.owner.long()
    c = colors[ex.nbr.long()]
    hit = ex.valid & (c >= 0) & (c <= deg[owner])
    units = torch.arange(ex.nbr.shape[0], dtype=_I32, device=deg.device)
    flag = torch.zeros(table + ex.nbr.shape[0], dtype=torch.bool,
                       device=deg.device)
    flag[torch.where(hit, off[owner] + c, table + units).long()] = hit
    slot_owner, slot_rank = search_for(backend, incl)(incl, table)
    p = torch.arange(table, dtype=_I32, device=deg.device)
    free = (p < incl[-1]) & ~flag[:table]
    # slots that are not free add the identity of min at a lane of their
    # own, so that on the card they do not contend for one address
    key = torch.where(free, slot_rank, _BIG)
    lane = torch.where(free, slot_owner, p % n_lanes).long()
    return torch.full((n_lanes,), _BIG, dtype=_I32, device=deg.device
                      ).scatter_reduce(0, lane, key, "amin", include_self=True)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``: the product
    in two halves of ``c``, each below 2**48, so nothing overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _priority(v: torch.Tensor) -> torch.Tensor:
    """The reference's uint32 hash priority, as int64 in ``[0, 2**32)``:
    multiplies wrap mod 2**32 and comparisons are unsigned, as on uint32."""
    h = _mul32(v.long() & _U32, 2654435761) ^ 0x9E3779B9
    h = _mul32(h ^ (h >> 13), 0x85EBCA6B)
    return h ^ (h >> 16)


def _conflicts(colors: torch.Tensor, vids: torch.Tensor,
               valid: torch.Tensor, ex: Expansion) -> torch.Tensor:
    """Does a lane's vertex share its color with a neighbor of higher
    ``(hash, id)`` priority? (It re-colors.)"""
    safe = torch.where(valid, vids, 0)
    owner = ex.owner.long()
    me = safe[owner]
    my = colors[me.long()]
    nbr = ex.nbr
    pv, pn = _priority(me), _priority(nbr)
    loses = (pn < pv) | ((pn == pv) & (nbr < me))
    clash = ex.valid & (colors[nbr.long()] == my) & loses & (my >= 0)
    n_lanes = vids.shape[0]
    units = torch.arange(nbr.shape[0], dtype=_I32, device=vids.device)
    hit = torch.zeros(n_lanes, dtype=_I32, device=vids.device).scatter_reduce(
        0, torch.where(clash, owner, units % max(n_lanes, 1)).long(),
        clash.to(_I32), "amax", include_self=True)
    return (hit > 0) & valid


def _edge_expansion(graph: CSRGraph, rows: torch.Tensor) -> Expansion:
    """Every CSR edge as a unit of its source row, valid where ``rows``
    holds at the source (a slotted view's edges through the two-level
    gather)."""
    src = edge_sources(graph, _I32)
    return Expansion(src=src, nbr=edge_targets(graph), owner=src,
                     valid=rows[src.long()],
                     total=torch.tensor(graph.num_edges, dtype=_I32,
                                        device=graph.device))


def coloring_bsp(graph: CSRGraph, max_iters: int = 10000,
                 backend: str = "auto", trace: list | None = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Alg 5: assign-all / barrier / detect-all, in the flat form over all
    m edges.  ``trace``, if given, receives each iteration's frontier
    size."""
    n = graph.num_vertices
    vids = torch.arange(n, dtype=_I32, device=graph.device)
    deg = graph.degrees()
    colors = torch.full((n,), -1, dtype=_I32, device=graph.device)
    frontier = torch.ones(n, dtype=torch.bool, device=graph.device)
    iters, work = 0, 0
    while iters < max_iters and bool(frontier.any()):
        fsize = int(frontier.sum())
        pick = _min_free_color(colors, _edge_expansion(graph, frontier),
                               torch.where(frontier, deg, 0), backend)
        colors = torch.where(frontier, pick, colors)
        frontier = _conflicts(colors, vids, frontier,
                              _edge_expansion(graph, frontier))
        work += fsize
        iters += 1
        if trace is not None:
            trace.append(fsize)
    return colors, {"iters": iters, "work": work}


def init_state(graph: CSRGraph, codec: ChunkCodec | None = None,
               split_threshold: int | None = None,
               owner_block: int | None = None
               ) -> Tuple[ColorState, torch.Tensor]:
    """Initial state and seed tasks, an assign per vertex; at ``G > 1``
    the every-vertex frontier packs into maximal chunks (inside one shard
    ``owner_block``), each encoded ``+(task + 1)``."""
    n = graph.num_vertices
    device = graph.device
    state = ColorState(colors=torch.full((n,), -1, dtype=_I32, device=device),
                       counter=WorkCounter.zero(device))
    if codec is None or codec.granularity == 1:
        return state, torch.arange(1, n + 1, dtype=_I32, device=device)
    chunks = chunk_seeds(np.arange(n), codec, graph.row_ptr,
                         split_threshold=split_threshold,
                         owner_block=owner_block)
    return state, torch.as_tensor(chunks + 1, device=device)


def make_wavefront_fn(graph: CSRGraph, budget: int, fused: bool = True,
                      codec: ChunkCodec | None = None,
                      split_threshold: int | None = None,
                      formation_row_ptr=None, backend: str = "auto",
                      owner_block: int | None = None):
    """The assign/detect body (Alg 6).

    An assign chunk colors its ``width`` vertices from the wavefront-start
    colors and queues one detect chunk for the same run; conflicted
    vertices re-coalesce into assign chunks (inside one shard
    ``owner_block``).  ``budget`` bounds the degree sum of one phase's
    lanes (:func:`flat_budget`); ``backend`` picks the expansion's search.
    The fused body's detects read the colors after this wavefront's
    assigns.  The unfused body (``fused=False``) serves the sharded
    topology: its detects read the wavefront-start colors, so a detect
    sees the same colors whichever shard ran a same-round assign, and a
    conflict is found one round later, never lost.
    """
    codec = codec or ChunkCodec(1)
    g = codec.granularity
    rp = graph.row_ptr
    form_rp = rp if formation_row_ptr is None else formation_row_ptr

    def f(items, valid, state: ColorState):
        is_assign = valid & (items > 0)
        is_detect = valid & (items < 0)
        codes = torch.where(is_assign, items - 1, -items - 1)
        codes = torch.where(valid, codes, 0)
        heads, widths = codec.decode(codes)
        vids, flat_valid, owner = flatten_chunks(heads, widths, valid, g)
        flat_assign = flat_valid & is_assign[owner]
        flat_detect = flat_valid & is_detect[owner]

        # phase A: assigns read the wavefront-start colors
        ex = _gather_neighbor_colors(graph, vids, flat_assign, budget,
                                     backend)
        pick = _min_free_color(
            state.colors, ex, chunk_degrees(vids, None, flat_assign, rp),
            unstreamed(backend))
        # one vertex has at most one task in the queue, so the targets of
        # this scatter are unique
        colors = scatter_set(state.colors, vids, flat_assign, pick)

        # phase B: detects read this wavefront's commits (fused) or the
        # wavefront-start colors (unfused)
        ex_d = _gather_neighbor_colors(graph, vids, flat_detect, budget,
                                       backend)
        bad = _conflicts(colors if fused else state.colors, vids,
                         flat_detect, ex_d)

        re_assign, re_mask, n_splits = coalesce_chunks(
            vids, bad, codec, form_rp, split_threshold=split_threshold,
            owner_block=owner_block)
        out = torch.cat([torch.where(is_assign, -(codes + 1), 0),
                         torch.where(re_mask, re_assign + 1, 0)])
        mask = torch.cat([is_assign, re_mask])
        counter = state.counter.add(flat_assign.sum(dtype=_I32))
        return out, mask, ColorState(colors=colors,
                                     counter=counter.add_splits(n_splits))

    return f


def make_program(graph: CSRGraph, cfg: SchedulerConfig, *,
                 queue_capacity: int | None = None,
                 **params) -> AtosProgram:
    """Speculative greedy coloring as one :class:`AtosProgram`.

    ``params``: ``dirty`` picks the streaming rule: ``"conflicts"`` (the
    default) keeps the carried colors and re-colors only the losing
    endpoints of inserted same-colored edges (a valid coloring for little
    work, but not the one a cold drain gives); ``"recolor"`` has no rule,
    so a delta batch re-seeds in full (bit-identical to a cold drain).  The
    megakernel cell runs the drain kernel B3-col
    (``kernels/drain_loop/coloring_drain``) at every granularity.  The
    sharded topology runs the unfused body; colors are single-writer per
    round, so both state fields merge by delta-psum, and a task's owner is
    its decoded chunk head.
    """
    dirty = params.pop("dirty", "conflicts")
    reject_unknown_params("coloring", params)
    if dirty not in ("conflicts", "recolor"):
        raise ValueError(f"coloring dirty mode must be 'conflicts' or "
                         f"'recolor', got {dirty!r}")
    n = graph.num_vertices
    codec, threshold, owner_block = chunking_for(graph, cfg)
    budget = flat_budget(graph, cfg.wavefront * cfg.granularity)

    def make_body(body_graph: CSRGraph, ctx: ProgramContext):
        return make_wavefront_fn(
            body_graph, budget, fused=not ctx.sharded, codec=codec,
            split_threshold=threshold,
            formation_row_ptr=graph.row_ptr.to(body_graph.device),
            backend=ctx.backend, owner_block=owner_block)

    def make_drain_kernel(body_graph: CSRGraph, ctx: ProgramContext,
                          max_rounds: int):
        from ..kernels.drain_loop.coloring_drain import (  # lazy
            coloring_drain_cuda)

        rp, cols, overlay = adjacency_of(body_graph)

        def run(carry, limit=None):
            return coloring_drain_cuda(carry, rp, cols, overlay=overlay,
                                       wavefront=ctx.wavefront,
                                       degree_budget=budget,
                                       max_rounds=max_rounds, limit=limit,
                                       granularity=codec.granularity,
                                       split_threshold=threshold)

        return run

    def conflict_seeds(applied, state):
        from ..stream.incremental import coloring_dirty_seeds  # lazy

        return coloring_dirty_seeds(applied, state, codec=codec,
                                    split_threshold=threshold)

    return AtosProgram(
        name="coloring",
        init=lambda: init_state(graph, codec, threshold, owner_block),
        make_body=make_body,
        result=lambda s: s.colors,
        merge={"colors": "sum_delta", "counter": "work_counter"},
        task_vertex=lambda t: codec.head(t.to(_I32).abs() - 1),
        work=lambda s: s.counter.work,
        splits=lambda s: s.counter.splits,
        ideal_work=n,
        default_queue_capacity=queue_capacity or max(4 * n, 1024),
        make_drain_kernel=make_drain_kernel,
        dirty_seeds=conflict_seeds if dirty == "conflicts" else None,
        # a task is a signed +-(code + 1)
        task_width=lambda t: codec.width(t.to(_I32).abs() - 1),
    )


def coloring_async(graph: CSRGraph, cfg: SchedulerConfig,
                   queue_capacity: int | None = None, trace=None, mesh=None
                   ) -> Tuple[torch.Tensor, dict]:
    """Alg 6: the assign/detect body on the Atos queue, a thin driver over
    :func:`repro_torch.runtime.execute`, which takes ``trace`` and
    ``mesh``."""
    from ..runtime.api import execute  # lazy: runtime.api -> this module

    program = make_program(graph, cfg, queue_capacity=queue_capacity)
    state, _, info = execute(program, graph, cfg,
                             queue_capacity=queue_capacity, trace=trace,
                             mesh=mesh)
    return state.colors, info


def validate_coloring(graph: CSRGraph, colors: torch.Tensor) -> bool:
    """Proper coloring: every vertex colored, no edge joins two vertices
    of one color.  Runs where the tensors live."""
    colors = torch.as_tensor(colors, device=graph.device)
    if bool((colors < 0).any()):
        return False
    src = edge_sources(graph)
    return bool((colors[src] != colors[edge_targets(graph).long()]).all())
