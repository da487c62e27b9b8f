"""PageRank case study: BSP push (Alg 3) vs asynchronous push (Alg 4).

The counterpart of ``repro/algorithms/pagerank.py``.  Residual ("push")
PageRank: every vertex holds ``(rank, residue)``.  Processing a vertex
harvests its residue into its rank and pushes ``damping * res / deg`` to
each out-neighbor's residue.  Converged when every residue is at most
``eps``.

Float sums do not associate, so the order of the pushes decides the low
bits.  The reference's ``residue.at[nbr].add(contrib)`` adds the updates
one by one in update order on XLA's CPU backend; the port adds them in
that order on every backend (``kernels/scatter_add``), so its ranks are
the reference's bit for bit and the same from run to run on the card.
Duplicate wavefront entries are de-duplicated by keeping the first
occurrence of each chunk head (the GPU's ``atomicExch`` semantics).

The single-device branch: the rescan block of the sharded topology, the
replica-merge spec and ``dirty_seeds`` come with ROADMAP A12 and A9.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..core import (ChunkCodec, SchedulerConfig, WorkCounter, adjacency_of,
                    chunk_degrees, chunk_seeds, coalesce_chunks,
                    expand_merge_path, flatten_chunks)
from ..core.backend import unstreamed
from ..graph.csr import CSRGraph
from ..kernels.scatter_add.ops import ordered_scatter_add
from ..runtime.program import AtosProgram, ProgramContext
from ..runtime.programs import reject_unknown_params
from .common import (chunking_for, default_work_budget, edge_sources, mark,
                     max_degree_of)

_I32 = torch.int32
_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class PRState:
    rank: torch.Tensor          # f32 [n]
    residue: torch.Tensor       # f32 [n]
    in_queue: torch.Tensor      # bool [n], presence bit
    check_cursor: torch.Tensor  # 0-dim int32, Alg 4's rotating rescan cursor
    counter: WorkCounter


def _push_wavefront(graph: CSRGraph, damping: float, work_budget: int,
                    backend: str = "auto", codec: ChunkCodec | None = None):
    """Shared core: harvest the residues of popped chunks, push to their
    neighbors.  Chunk-aware as the reference: a popped ``(head, width)``
    chunk is harvested or re-queued as a unit, and every expanded edge's
    contribution reads its own member row's residue and degree."""
    codec = codec or ChunkCodec(1)
    g = codec.granularity
    rp, cols, _ = adjacency_of(graph)

    def push(items, valid, state: PRState):
        n = state.rank.shape[0]
        k = items.shape[0]
        safe = torch.where(valid, items, 0)
        heads, widths = codec.decode(safe)
        # keep the first occurrence of each chunk head (atomicExch).  Lanes
        # that take no part add the identity k at a slot of their own.
        order = torch.arange(k, dtype=_I32, device=items.device)
        first_idx = torch.full((n,), k, dtype=_I32, device=items.device)
        first_idx = first_idx.scatter_reduce(
            0, torch.where(valid, heads, order % n).long(),
            torch.where(valid, order, k), "amin", include_self=True)
        is_first = valid & (first_idx[heads.long()] == order)

        # chunks spilling past the work budget are re-queued whole
        deg = chunk_degrees(heads, widths, is_first, rp)
        excl = torch.cumsum(deg, 0, dtype=_I32) - deg
        truncated = is_first & (excl + deg > work_budget)
        process = is_first & ~truncated

        flat_v, flat_valid, flat_owner = flatten_chunks(heads, widths, valid,
                                                        g)
        popped = mark(n, flat_v, flat_valid & process[flat_owner])
        rank = state.rank + torch.where(popped, state.residue, 0.0)
        residue = torch.where(popped, 0.0, state.residue)
        # popped vertices leave the queue; truncated ones stay (re-queued)
        trunc_mask = mark(n, flat_v, flat_valid & truncated[flat_owner])
        in_queue = torch.where(popped & ~trunc_mask, False, state.in_queue)

        ex = expand_merge_path(heads, process, rp, cols, work_budget,
                               backend=backend, widths=widths, max_width=g)
        # each edge's contribution from its own source row, read pre-harvest
        src = ex.src.long()
        row_deg = torch.clamp(rp[src + 1] - rp[src], min=1).to(_F32)
        res_src = torch.where(popped[src], state.residue[src], 0.0)
        contrib = torch.where(ex.valid, damping * res_src / row_deg, 0.0)
        # idle lanes add +0.0 to a slot of their own, which changes no bit
        lanes = torch.arange(ex.nbr.shape[0], dtype=_I32, device=rp.device)
        residue = ordered_scatter_add(
            residue, torch.where(ex.valid, ex.nbr, lanes % n), contrib,
            backend=unstreamed(backend))
        counter = state.counter.add(
            torch.where(process, widths, 0).sum(dtype=_I32))
        return residue, rank, in_queue, counter, truncated

    return push


# --------------------------------------------------------------------- BSP
def pagerank_bsp(graph: CSRGraph, damping: float = 0.85, eps: float = 1e-6,
                 max_iters: int = 1000, trace: list | None = None
                 ) -> Tuple[torch.Tensor, dict]:
    """Alg 3: process the whole frontier (all residues > eps) per sweep.
    ``trace``, if given, receives each sweep's active vertex count."""
    n = graph.num_vertices
    deg = torch.clamp(graph.degrees(), min=1).to(_F32)
    # the reference's sweep is jitted with the degrees as a constant, and
    # XLA folds ``x / deg`` into ``x * (1 / deg)``: so does the port here
    inv_deg = 1.0 / deg
    edge_src = edge_sources(graph)
    cols = graph.col_idx.long()
    rank = torch.zeros(n, dtype=_F32, device=graph.device)
    residue = torch.full((n,), 1.0 - damping, dtype=_F32, device=graph.device)
    iters, work = 0, 0
    while iters < max_iters and bool((residue > eps).any()):
        active = residue > eps
        res = torch.where(active, residue, 0.0)
        rank = rank + res
        residue = torch.where(active, 0.0, residue)
        contrib_per_v = damping * res * inv_deg
        residue = ordered_scatter_add(residue, cols, contrib_per_v[edge_src])
        nactive = int(active.sum())
        work += nactive
        iters += 1
        if trace is not None:
            trace.append(nactive)
    return rank, {"iters": iters, "work": work}


def pagerank_reference(graph: CSRGraph, damping: float = 0.85,
                       iters: int = 200) -> torch.Tensor:
    """Dense power iteration oracle: pr = (1-d)*1 + d*A^T D^{-1} pr."""
    n = graph.num_vertices
    deg = torch.clamp(graph.degrees(), min=1).to(_F32)
    edge_src = edge_sources(graph)
    cols = graph.col_idx.long()
    base = torch.full((n,), 1.0 - damping, dtype=_F32, device=graph.device)
    pr = base
    for _ in range(iters):
        contrib = damping * pr / deg
        pr = ordered_scatter_add(base, cols, contrib[edge_src])
    return pr


# ------------------------------------------------------------- asynchronous
def init_state(graph: CSRGraph, damping: float = 0.85,
               seed_count: int | None = None
               ) -> Tuple[PRState, torch.Tensor]:
    """Initial state and seed tasks: every residue ``1 - damping`` (the
    difference taken in double, then cast), the first ``seed_count``
    vertices (default all) queued."""
    n = graph.num_vertices
    n_seed = n if seed_count is None else min(n, seed_count)
    device = graph.device
    state = PRState(
        rank=torch.zeros(n, dtype=_F32, device=device),
        residue=torch.full((n,), 1.0 - damping, dtype=_F32, device=device),
        in_queue=torch.arange(n, dtype=_I32, device=device) < n_seed,
        check_cursor=torch.zeros((), dtype=_I32, device=device),
        counter=WorkCounter.zero(device),
    )
    return state, torch.arange(n_seed, dtype=_I32, device=device)


def make_wavefront_fns(graph: CSRGraph, wavefront: int, n_check: int,
                       damping: float = 0.85, eps: float = 1e-6,
                       work_budget: int | None = None, backend: str = "auto",
                       check_block=None, max_degree: int | None = None,
                       codec: ChunkCodec | None = None,
                       split_threshold: int | None = None,
                       formation_row_ptr=None):
    """The async-PageRank wavefront bodies ``(f, on_empty, stop)``.

    ``wavefront`` sizes ``on_empty``'s padding, ``n_check`` is the rotating
    rescan window, ``backend`` picks the merge-path search and the
    scatter-add.  ``check_block`` (the sharded rescan block) comes with
    ROADMAP A12.
    """
    if check_block is not None:
        raise NotImplementedError(
            "the sharded rescan block comes with the sharded slice, "
            "ROADMAP A12")
    n = graph.num_vertices
    work_budget = default_work_budget(graph, wavefront, work_budget,
                                      max_degree=max_degree)
    codec = codec or ChunkCodec(1)
    form_rp = graph.row_ptr if formation_row_ptr is None else formation_row_ptr
    push = _push_wavefront(graph, damping, work_budget, backend=backend,
                           codec=codec)
    n_check = min(n_check, n)
    j = torch.arange(n_check, dtype=_I32, device=graph.device)

    def scan_window(cursor):
        """Next ``n_check`` ids of the rotating scan (all valid: the block
        is the whole graph and ``n_check <= n``)."""
        return (cursor + j) % max(n, 1)

    def rescan(residue, in_queue, cursor):
        check_ids = scan_window(cursor)
        ids = check_ids.long()
        over = (residue[ids] > eps) & ~in_queue[ids]
        in_queue = in_queue | mark(n, check_ids, over)
        out_scan, scan_mask, n_splits = coalesce_chunks(
            check_ids, over, codec, form_rp, split_threshold=split_threshold)
        return in_queue, out_scan, scan_mask, n_splits

    def f(items, valid, state: PRState):
        residue, rank, in_queue, counter, truncated = push(items, valid, state)
        in_queue, out_scan, scan_mask, n_splits = rescan(
            residue, in_queue, state.check_cursor)
        new_state = PRState(rank=rank, residue=residue, in_queue=in_queue,
                            check_cursor=state.check_cursor + n_check,
                            counter=counter.add_splits(n_splits))
        out = torch.cat([out_scan, torch.where(truncated, items, 0)])
        mask = torch.cat([scan_mask, truncated])
        return out, mask, new_state

    def on_empty(state: PRState):
        in_queue, out_scan, scan_mask, n_splits = rescan(
            state.residue, state.in_queue, state.check_cursor)
        new_state = dataclasses.replace(
            state, in_queue=in_queue,
            check_cursor=state.check_cursor + n_check,
            counter=state.counter.add_splits(n_splits))
        pad = torch.zeros(wavefront, dtype=_I32, device=graph.device)
        return (torch.cat([out_scan, pad]),
                torch.cat([scan_mask, pad.to(torch.bool)]), new_state)

    def stop(state: PRState):
        # converged when nothing is above eps anywhere
        return state.residue.max() <= eps

    return f, on_empty, stop


def make_program(graph: CSRGraph, cfg: SchedulerConfig, *,
                 queue_capacity: int | None = None,
                 **params) -> AtosProgram:
    """Async push PageRank as one :class:`AtosProgram`.

    ``params``: ``damping``, ``eps``, ``check_size``, ``work_budget``,
    ``seed_count``.  ``empty_means_done=False``: the rotating rescan
    refills a drained queue, so only ``stop`` (max residue <= eps) ends the
    drain.  The megakernel cell runs the drain kernel B3-pr
    (``kernels/drain_loop/pagerank_drain``) at every granularity.
    """
    damping = float(params.pop("damping", 0.85))
    eps = float(params.pop("eps", 1e-6))
    check_size = int(params.pop("check_size", 64))
    work_budget = params.pop("work_budget", None)
    seed_count = params.pop("seed_count", None)
    reject_unknown_params("pagerank", params)
    n = graph.num_vertices
    max_degree = max_degree_of(graph)
    budget = default_work_budget(graph, cfg.wavefront, work_budget,
                                 max_degree=max_degree)
    codec, threshold = chunking_for(cfg, budget)
    n_check = min(cfg.num_workers * check_size, n)
    capacity = queue_capacity or max(8 * n, 1024)
    if seed_count is None:
        seed_count = min(n, max(1, capacity // 2))
    fns_cache: dict = {}

    def _fns(body_graph: CSRGraph, ctx: ProgramContext):
        key = (id(body_graph.row_ptr), ctx.wavefront, ctx.backend)
        if key not in fns_cache:
            fns_cache[key] = (body_graph, make_wavefront_fns(
                body_graph, ctx.wavefront, n_check=n_check, damping=damping,
                eps=eps, work_budget=budget, backend=ctx.backend,
                max_degree=max_degree, codec=codec,
                split_threshold=threshold, formation_row_ptr=graph.row_ptr))
        return fns_cache[key][1]

    # stop reads only the state: built once from the global graph
    _, _, stop = _fns(graph, ProgramContext(cfg.wavefront, cfg.num_workers,
                                            cfg.backend, cfg.granularity))

    def init():
        state, seeds = init_state(graph, damping, seed_count=seed_count)
        # the dense seed frontier packs into maximal chunks at G > 1
        return state, torch.as_tensor(chunk_seeds(
            seeds.cpu().numpy(), codec, graph.row_ptr,
            split_threshold=threshold), device=graph.device)

    def make_drain_kernel(body_graph: CSRGraph, ctx: ProgramContext,
                          max_rounds: int):
        from ..kernels.drain_loop.pagerank_drain import (  # lazy
            pagerank_drain_cuda)

        def run(carry, limit=None):
            return pagerank_drain_cuda(
                carry, body_graph.row_ptr, body_graph.col_idx,
                wavefront=ctx.wavefront, budget=budget, n_check=n_check,
                damping=damping, eps=eps, max_rounds=max_rounds, limit=limit,
                granularity=codec.granularity, split_threshold=threshold)

        return run

    return AtosProgram(
        name="pagerank",
        init=init,
        make_body=lambda g, ctx: _fns(g, ctx)[0],
        make_on_empty=lambda g, ctx: _fns(g, ctx)[1],
        result=lambda s: s.rank,
        stop=stop,
        empty_means_done=False,
        work=lambda s: s.counter.work,
        splits=lambda s: s.counter.splits,
        ideal_work=n,
        default_queue_capacity=capacity,
        make_drain_kernel=make_drain_kernel,
    )


def pagerank_async(graph: CSRGraph, cfg: SchedulerConfig,
                   damping: float = 0.85, eps: float = 1e-6,
                   check_size: int = 64, work_budget: int | None = None,
                   queue_capacity: int | None = None, trace=None
                   ) -> Tuple[torch.Tensor, dict]:
    """Alg 4: queue-driven asynchronous PageRank, a thin driver over
    :func:`repro_torch.runtime.execute`; ``info["max_residue"]`` is the
    largest residue left; ``trace`` goes to ``execute``."""
    from ..runtime.api import execute  # lazy: runtime.api -> this module

    program = make_program(graph, cfg, queue_capacity=queue_capacity,
                           damping=damping, eps=eps, check_size=check_size,
                           work_budget=work_budget)
    state, _, info = execute(program, graph, cfg,
                             queue_capacity=queue_capacity, trace=trace)
    info["max_residue"] = float(state.residue.max())
    return state.rank, info
