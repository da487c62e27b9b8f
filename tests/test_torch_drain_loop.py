"""The megakernel slice of the PyTorch port against the JAX package, on the
CPU, bit for bit, on numpy-made inputs: the row-slice stream's plain
version (B4) against numpy slicing; the streamed expansion against JAX's
``expand_merge_path(backend="jnp")``; the plain fused drain (B3's plain
version) on claim/push tapes against JAX's ``fused_drain_pallas``; and
``execute`` under ``single.megakernel`` against JAX's ``single.persistent``
cell, whole, cut at ``max_rounds`` and cut into segments; beyond
granularity 1 (G = 2, 3, 8; windows that split; chunks re-queued whole past
a tight budget; per_item) the drain's final queue too; and the BFS body at
G = 3 on a hand-made wavefront (a zero-degree member row, the partial
window of vertex n - 1, duplicate chunk heads); and the drain kernels'
chunk operands and their bound on a chunk's units.

JAX's own megakernel cells and its ``stream_row_slices`` do not run on the
installed JAX (ROADMAP C-ref1), so the port is held against the cells and
functions they are defined to equal.  The CUDA kernels themselves are held
against these plain versions on the card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.core import ChunkCodec as JCodec
from repro.core import EMPTY as J_EMPTY
from repro.core import SchedulerConfig as JConfig
from repro.core import make_queue as j_make_queue
from repro.core.scheduler import persistent_drive as j_persistent_drive
from repro.core.frontier import chunk_degrees as j_chunk_degrees
from repro.core.frontier import expand_merge_path as j_expand
from repro.kernels.drain_loop import fused_drain_pallas
from repro.runtime import build_program as j_build
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro.runtime.api import _shared_setup as j_setup
from repro.algorithms import bfs as jbfs
from repro_torch.algorithms import bfs as tbfs
from repro_torch.convert import bfs_state_from_numpy, graph_from_numpy
from repro_torch.core import (EMPTY, STREAM, STREAM_TORCH, ChunkCodec,
                              SchedulerConfig,
                              expand_merge_path, make_queue,
                              megakernel_drive, megakernel_segment,
                              resolve_backend)
from repro_torch.core.tree import tree_where
from repro_torch.kernels.drain_loop.csr_stream import (expand_stream,
                                                       stream_row_slices,
                                                       stream_row_slices_ref)
from repro_torch.kernels.drain_loop.kernel import (fused_drain_ref,
                                                   make_fused_drain)
from repro_torch.runtime import build_program, config_for, parse_policy
from repro_torch.runtime.api import drain_setup, execute

GRAPHS = {
    "rmat(8,8,1)": (lambda: jg.rmat(8, 8, seed=1),
                    lambda: tg.rmat(8, 8, seed=1, device="cpu")),
    "grid2d(16,16)": (lambda: jg.grid2d(16, 16),
                      lambda: tg.grid2d(16, 16, device="cpu")),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (mj(), mt()) for name, (mj, mt) in GRAPHS.items()}


def _eq(port, ref, err=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=err)


# ------------------------------------------------ B4's plain version
@pytest.mark.parametrize("n_items,budget,m", [
    (0, 8, 50), (1, 1, 50), (7, 13, 50), (64, 4, 1000), (33, 257, 300),
    (5, 64, 3)])
def test_stream_row_slices_ref_matches_numpy_slicing(n_items, budget, m):
    rng = np.random.default_rng(n_items * 31 + budget)
    col = rng.integers(0, 1 << 20, size=m).astype(np.int32)
    starts = rng.integers(-2 * budget, m + 2 * budget,
                          size=n_items).astype(np.int32)
    starts[: n_items // 3] = rng.integers(max(m - budget, 0), m + 1,
                                          size=n_items // 3)
    padded = np.concatenate([col, np.zeros(budget, np.int32)])
    want = np.zeros((n_items, budget), np.int32)
    for i, s in enumerate(np.clip(starts, 0, m)):
        want[i] = padded[s: s + budget]
    for fn in (stream_row_slices_ref, stream_row_slices):
        got = fn(torch.from_numpy(col), torch.from_numpy(starts), budget)
        assert got.dtype == torch.int32 and got.shape == (n_items, budget)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------- the streamed expansion over a wrapped ring
@pytest.fixture(scope="module")
def wrapped_wavefronts():
    """Chunk wavefronts popped across a wrapped ring head whose degree sum
    spills past one LBS tile, made by the JAX queue (the regime of
    test_kernels.py's multi-tile case)."""
    graph = jg.rmat(8, 8, seed=3)
    out = {}
    rings = {1: (256, 192, 160, 192), 4: (64, 48, 40, 48)}
    for g, (cap, first, popped, second) in rings.items():
        codec = JCodec(g)
        n = graph.num_vertices
        local = np.random.default_rng(7)

        def chunks(k, base):
            heads = local.integers(0, n - 4, size=k).astype(np.int32) + base
            widths = local.integers(1, g + 1, size=k).astype(np.int32)
            return codec.encode(jnp.asarray(heads % (n - 4)),
                                jnp.asarray(widths))

        q = j_make_queue(cap).push_dense(chunks(first, 0))
        _, _, q = q.pop(popped)
        q = q.push_dense(chunks(second, 100))
        head_before = int(q.head)
        items, valid, q = q.pop(cap)
        assert head_before + int(np.asarray(valid).sum()) > cap
        heads, widths = codec.decode(jnp.where(valid, items, 0))
        out[g] = (graph, heads, widths, valid)
    return out


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("budget", [1024, 4096])
def test_expand_stream_matches_jax_jnp_expansion(wrapped_wavefronts, g,
                                                 budget):
    graph, heads, widths, valid = wrapped_wavefronts[g]
    total = int(jnp.cumsum(j_chunk_degrees(heads, widths, valid,
                                           graph.row_ptr))[-1])
    assert total > 1024                     # multi-tile
    jw = widths if g > 1 else None
    ref = j_expand(heads, valid, graph.row_ptr, graph.col_idx, budget,
                   backend="jnp", widths=jw, max_width=g)
    pg = graph_from_numpy(np.asarray(graph.row_ptr),
                          np.asarray(graph.col_idx), device="cpu")
    th = torch.from_numpy(np.array(heads))
    tv = torch.from_numpy(np.array(valid))
    tw = torch.from_numpy(np.array(widths)) if g > 1 else None
    paths = {
        "expand_stream": expand_stream(th, tv, pg.row_ptr, pg.col_idx, budget,
                                       widths=tw, max_width=g),
        "STREAM": expand_merge_path(th, tv, pg.row_ptr, pg.col_idx, budget,
                                    backend=STREAM, widths=tw, max_width=g),
        "STREAM_TORCH": expand_merge_path(th, tv, pg.row_ptr, pg.col_idx,
                                          budget, backend=STREAM_TORCH,
                                          widths=tw, max_width=g),
    }
    for name, got in paths.items():
        for field, x, y in zip(ref._fields, got, ref):
            _eq(x, y, f"{name} {field}")


def test_stream_values_are_internal_and_overlays_wait_for_a9():
    g = tg.grid2d(4, 4, device="cpu")
    items = torch.tensor([0, 5], dtype=torch.int32)
    for value in (STREAM, STREAM_TORCH):
        with pytest.raises(ValueError, match="unknown backend"):
            resolve_backend(value, items)
        with pytest.raises(ValueError, match="unknown backend"):
            execute(build_program("bfs", g, SchedulerConfig(num_workers=2)),
                    g, SchedulerConfig(num_workers=2, backend=value))
    # a slotted view's overlay is served (the streaming slice): the stream
    # over its slab array equals the flat expansion of the canonical graph
    s = tg.SlottedCSR.from_csr(g)
    s.apply(np.array([0, 0]), np.array([2, 3]), np.array([True, True]))
    view, canonical = s.view(), s.to_csr()
    assert s.overlay_size > 0
    valid = torch.ones(2, dtype=torch.bool)
    got = expand_stream(items, valid, view.row_ptr, view.slab_col, 16,
                        overlay=view.overlay, backend="torch")
    want = expand_stream(items, valid, canonical.row_ptr, canonical.col_idx,
                         16, backend="torch")
    for field, x, y in zip(want._fields, got, want):
        _eq(x, y, f"slotted {field}")


# ------------------------- B3's plain version on claim/push tapes
_W = 4  # wavefront of every claim, as in tests/test_megakernel.py


def _jax_tape(cap, ops):
    """The tape inside ONE fused_drain_pallas launch (interpret mode)."""
    n_ops = len(ops)
    kinds = jnp.asarray([0 if k == "push" else 1 for k, _ in ops], jnp.int32)
    counts = jnp.asarray([n for _, n in ops], jnp.int32)
    carry0 = (j_make_queue(cap), jnp.int32(0), jnp.int32(0),
              jnp.full((n_ops, _W), J_EMPTY, jnp.int32),
              jnp.zeros((n_ops, _W), jnp.bool_),
              jnp.zeros((n_ops, 3), jnp.int32))

    def step(carry):
        q, i, counter, items_tr, valid_tr, cursor_tr = carry
        n = counts[i]

        def do_push(q):
            lane = jnp.arange(_W, dtype=jnp.int32)
            return (q.push(counter + lane, lane < n),
                    jnp.full((_W,), J_EMPTY, jnp.int32),
                    jnp.zeros((_W,), jnp.bool_), counter + n)

        def do_claim(q):
            items, valid, q2 = q.pop_upto(_W, n)
            return q2, items, valid, counter

        q, items, valid, counter = jax.lax.cond(kinds[i] == 0, do_push,
                                                do_claim, q)
        cursors = jnp.stack([q.head, q.tail, q.dropped])
        return (q, i + 1, counter, items_tr.at[i].set(items),
                valid_tr.at[i].set(valid), cursor_tr.at[i].set(cursors))

    q, i, _, items_tr, valid_tr, cursor_tr = fused_drain_pallas(
        step, lambda c: c[1] < n_ops, carry0)
    return q, i, items_tr, valid_tr, cursor_tr


def _port_tape(cap, ops):
    """The same tape through the port's plain fused drain; both branches
    run and a device flag selects, as the port's wavefront step does."""
    n_ops = len(ops)
    kinds = torch.tensor([0 if k == "push" else 1 for k, _ in ops],
                         dtype=torch.int32)
    counts = torch.tensor([n for _, n in ops], dtype=torch.int32)
    zero = torch.zeros((), dtype=torch.int32)
    carry0 = (make_queue(cap, device="cpu"), zero, zero,
              torch.full((n_ops, _W), EMPTY, dtype=torch.int32),
              torch.zeros((n_ops, _W), dtype=torch.bool),
              torch.zeros((n_ops, 3), dtype=torch.int32))

    def step(carry):
        q, i, counter, items_tr, valid_tr, cursor_tr = carry
        n = counts[i]
        is_push = kinds[i] == 0
        lane = torch.arange(_W, dtype=torch.int32)
        pushed = q.push(counter + lane, lane < n, backend="torch")
        items, valid, claimed = q.pop_upto(_W, n)
        q = tree_where(is_push, pushed, claimed)
        items = torch.where(is_push, EMPTY, items)
        valid = valid & ~is_push
        counter = torch.where(is_push, counter + n, counter)
        row = i.long()
        items_tr, valid_tr, cursor_tr = (items_tr.clone(), valid_tr.clone(),
                                         cursor_tr.clone())
        items_tr[row] = items
        valid_tr[row] = valid
        cursor_tr[row] = torch.stack([q.head, q.tail, q.dropped])
        return q, i + 1, counter, items_tr, valid_tr, cursor_tr

    q, i, _, items_tr, valid_tr, cursor_tr = fused_drain_ref(
        step, lambda c: c[1] < n_ops, carry0)
    return q, i, items_tr, valid_tr, cursor_tr


TAPES = {
    # capacity 8, five width-4 pushes: 12 dropped, then FIFO claims
    "saturating drops": (8, [("push", _W)] * 5 + [("claim", _W)] * 3),
    "claim on empty": (8, [("claim", _W), ("push", 2), ("claim", _W),
                           ("claim", _W)]),
    # a ring of 4 lapped several times
    "wraparound": (4, [op for n in (3, 4, 1, 2, 4, 3, 1, 4)
                       for op in (("push", n), ("claim", n))]),
}


@pytest.mark.parametrize("tape", list(TAPES))
def test_plain_fused_drain_matches_jax_on_claim_push_tapes(tape):
    cap, ops = TAPES[tape]
    jq, ji, jitems, jvalid, jcursors = _jax_tape(cap, ops)
    tq, ti, titems, tvalid, tcursors = _port_tape(cap, ops)
    assert int(ti) == int(ji) == len(ops)
    for field in ("buf", "head", "tail", "dropped"):
        _eq(getattr(tq, field), getattr(jq, field), field)
    _eq(titems, jitems, "claimed items")
    _eq(tvalid, jvalid, "claimed valid")
    _eq(tcursors, jcursors, "cursors")
    if tape == "saturating drops":
        assert int(tq.dropped) == 5 * _W - cap
        assert titems[5:][tvalid[5:]].tolist() == list(range(cap))
    if tape == "claim on empty":
        assert not tvalid[0].any() and not tvalid[3].any()
        assert (titems[0] == EMPTY).all()


def test_make_fused_drain_runs_any_like_shaped_carry():
    run = make_fused_drain(lambda c: (c[0] + 1, c[1] + c[0]),
                           lambda c: c[0] < 5,
                           (torch.tensor(0), torch.tensor(0)))
    for start in (0, 2, 7):
        a, b = run((torch.tensor(start), torch.tensor(0)))
        assert int(a) == max(start, 5)
        assert int(b) == sum(range(start, 5))


# ------------------- execute under single.megakernel vs JAX single.persistent
def _run_both(jgraph, tgraph, granularity, params, **cfg_kw):
    suffix = "" if granularity == 1 else f".g{granularity}"
    base = dict(num_workers=16, fetch_size=4, **cfg_kw)
    jcfg = j_config_for(JConfig(**base), j_parse("single.persistent" + suffix))
    tcfg = config_for(SchedulerConfig(**base),
                      parse_policy("single.megakernel" + suffix))
    js, jstats, jinfo = j_execute(j_build("bfs", jgraph, jcfg, params=params),
                                  jgraph, jcfg)
    ts, tstats, tinfo = execute(build_program("bfs", tgraph, tcfg,
                                              params=params), tgraph, tcfg)
    np.testing.assert_array_equal(ts.dist.numpy(), np.asarray(js.dist))
    for field in ("work", "splits", "rounds"):
        assert int(getattr(ts.counter, field)) == int(
            getattr(js.counter, field)), field
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert tinfo == {**jinfo, "launches": 1}
    return tinfo


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("strategy", ["merge_path", "per_item"])
def test_megakernel_bit_identical_to_jax_persistent(graphs, graph, g,
                                                    strategy):
    jgraph, tgraph = graphs[graph]
    info = _run_both(jgraph, tgraph, g, {"source": 3, "strategy": strategy})
    assert info["dropped"] == 0 and info["rounds"] > 1


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_megakernel_truncation_matches_jax(graphs, graph):
    """A work budget at the max degree re-queues truncated rows."""
    jgraph, tgraph = graphs[graph]
    max_degree = int(np.asarray(jgraph.degrees()).max())
    _run_both(jgraph, tgraph, 1, {"source": 0, "work_budget": max_degree})


@pytest.mark.parametrize("g", [1, 4])
def test_megakernel_max_rounds_cut_matches_jax(graphs, g):
    jgraph, tgraph = graphs["grid2d(16,16)"]
    info = _run_both(jgraph, tgraph, g, {"source": 0}, max_rounds=5)
    assert info["rounds"] == 5


@pytest.mark.parametrize("every", [1, 4, 64])
def test_segmented_megakernel_drain_equals_the_whole(graphs, every):
    """Segments with absolute round limits reproduce the uncut drain: the
    queue, the state and both round counters."""
    _, tgraph = graphs["rmat(8,8,1)"]
    cfg = config_for(SchedulerConfig(num_workers=4, fetch_size=2),
                     parse_policy("single.megakernel"))
    program = build_program("bfs", tgraph, cfg, params={"source": 3})
    whole = drain_setup(program, tgraph, cfg)
    assert whole.kernel is None             # CPU tensors: the plain drain
    want = megakernel_drive(whole.step, whole.cond, whole.carry)
    cut = drain_setup(program, tgraph, cfg)
    seg = megakernel_segment(cut.step, cut.cond, cut.carry)
    carry, limit, segments = cut.carry, 0, 0
    while bool(cut.cond(carry)):
        limit += every
        carry = seg(carry, limit)
        segments += 1
        assert int(carry[2]) == min(limit, int(want[2]))
    assert segments == -(-int(want[2]) // every)
    once = megakernel_drive(cut.step, cut.cond, cut.carry, limit=every)
    assert int(once[2]) == min(every, int(want[2]))
    for got, ref in ((carry[0].buf, want[0].buf), (carry[1].dist,
                                                   want[1].dist)):
        assert torch.equal(got, ref)
    assert [int(x) for x in (carry[0].head, carry[0].tail, carry[0].dropped,
                             carry[1].counter.work, carry[1].counter.rounds,
                             carry[2], carry[3])] == \
        [int(x) for x in (want[0].head, want[0].tail, want[0].dropped,
                          want[1].counter.work, want[1].counter.rounds,
                          want[2], want[3])]


# ------------- the megakernel beyond granularity 1, final queue included
def _final_carries(jgraph, tgraph, algo, g, params, **cfg_kw):
    """JAX's ``single.persistent.g<G>`` drain and the port's
    ``single.megakernel.g<G>`` plain fused drain, both set up by hand so
    that the final queue comes back; the queues, rounds and processed
    counts are held equal here, the states by the caller."""
    suffix = "" if g == 1 else f".g{g}"
    base = dict(num_workers=16, fetch_size=4, **cfg_kw)
    jpolicy = j_parse("single.persistent" + suffix)
    jcfg = j_config_for(JConfig(**base), jpolicy)
    jq, js, _, jstep, jcond, _ = j_setup(j_build(algo, jgraph, jcfg,
                                                 params=params),
                                         jgraph, jcfg, jpolicy, None)
    jcarry = j_persistent_drive(jstep, jcond,
                                (jq, js, jnp.int32(0), jnp.int32(0)))
    tcfg = config_for(SchedulerConfig(**base),
                      parse_policy("single.megakernel" + suffix))
    setup = drain_setup(build_program(algo, tgraph, tcfg, params=params),
                        tgraph, tcfg)
    assert setup.kernel is None             # CPU tensors: the plain drain
    tcarry = megakernel_drive(setup.step, setup.cond, setup.carry)
    for field in ("buf", "head", "tail", "dropped"):
        _eq(getattr(tcarry[0], field), getattr(jcarry[0], field),
            f"queue {field}")
    assert [int(x) for x in tcarry[2:]] == [int(x) for x in jcarry[2:]]
    return jcarry, tcarry


def _counters_equal(ts, js):
    for field in ("work", "splits", "rounds"):
        assert int(getattr(ts.counter, field)) == int(
            getattr(js.counter, field)), field


# (G, params, config fields): a non-power-of-two width code, a wide window,
# windows that split, a budget at the max degree that re-queues chunks
# whole, and per_item
WIDE_BFS = [(2, {}, {}), (3, {}, {}), (8, {}, {}),
            (3, {}, {"split_threshold": 6}),
            (3, {"work_budget": "max_degree"}, {}),
            (3, {"strategy": "per_item"}, {"split_threshold": 6}),
            (8, {"strategy": "per_item"}, {})]


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g,params,fields", WIDE_BFS)
def test_wide_megakernel_drain_matches_jax_with_its_queue(graphs, graph, g,
                                                          params, fields):
    jgraph, tgraph = graphs[graph]
    params = {"source": 3, **params}
    if params.get("work_budget") == "max_degree":
        params["work_budget"] = int(np.asarray(jgraph.degrees()).max())
    jcarry, tcarry = _final_carries(jgraph, tgraph, "bfs", g, params,
                                    **fields)
    _eq(tcarry[1].dist, jcarry[1].dist, "dist")
    _counters_equal(tcarry[1], jcarry[1])
    assert int(tcarry[0].dropped) == 0 and int(tcarry[2]) > 1
    if fields and graph == "rmat(8,8,1)":
        assert int(tcarry[1].counter.splits) > 0


@pytest.fixture(scope="module")
def tape_graph():
    """rmat(8,8,1) with its ids reversed, so that vertex n - 1 is a hub and
    its window is busy; rows of degree 0 stay."""
    jgraph = jg.rmat(8, 8, seed=1)
    n = jgraph.num_vertices
    jgraph = jg.permute_vertices(jgraph, np.arange(n)[::-1].copy())
    return jgraph, graph_from_numpy(np.asarray(jgraph.row_ptr),
                                    np.asarray(jgraph.col_idx), device="cpu")


def _tape_chunks(jgraph, g, seed):
    """Chunk heads and widths at granularity ``g`` over ``jgraph``: a chunk
    with a zero-degree member row, one that ends at n - 2, two with one
    head, random ones, and ``reach``, a row with n - 1 among its neighbors
    (the window of n - 1 is partial when G does not divide n)."""
    rp = np.asarray(jgraph.row_ptr)
    col = np.asarray(jgraph.col_idx)
    n = rp.shape[0] - 1
    deg = np.diff(rp)
    zero = int(np.flatnonzero(deg[1:n - 1] == 0)[0]) + 1
    reach = int(np.searchsorted(rp, np.flatnonzero(col == n - 1)[0],
                                side="right") - 1)
    rng = np.random.default_rng(seed)
    heads = [zero - 1, n - 1 - g, 7, 7, reach] + list(
        rng.integers(0, n - 1 - g, size=11))
    widths = [g, g, 2, g, 1] + list(rng.integers(1, g + 1, size=11))
    assert n % g != 0 and deg[zero] == 0
    return np.asarray(heads, np.int32), np.asarray(widths, np.int32), reach


@pytest.mark.parametrize("strategy", ["merge_path", "per_item"])
def test_bfs_body_matches_jax_on_a_g3_tape(tape_graph, strategy):
    """The BFS body at G = 3 on a hand-made wavefront; the distances make
    every neighbor of a popped row an improvement, n - 1 among them, so the
    push coalesces the partial window of n - 1 and others."""
    jgraph, tgraph = tape_graph
    g = 3
    n = jgraph.num_vertices
    heads, widths, reach = _tape_chunks(jgraph, g, seed=5)
    items = np.asarray(JCodec(g).encode(jnp.asarray(heads),
                                        jnp.asarray(widths)))
    valid = np.ones(items.shape[0], bool)
    valid[-2:] = False
    items = np.where(valid, items, np.int32(-2 ** 31)).astype(np.int32)
    dist = np.full(n, 0x7FFFFFFF, np.int32)
    for h, w in zip(heads[valid], widths[valid]):
        dist[h:h + w] = 1
    max_degree = int(np.asarray(jgraph.degrees()).max())
    budget = 4 * max_degree                 # truncates the tail chunks
    for threshold in (None, 6):
        jf = jbfs.make_wavefront_fn(jgraph, strategy, budget, max_degree,
                                    codec=JCodec(g), split_threshold=threshold)
        tf = tbfs.make_wavefront_fn(tgraph, strategy, budget, max_degree,
                                    backend="torch", codec=ChunkCodec(g),
                                    split_threshold=threshold)
        jstate = jbfs.BFSState(dist=jnp.asarray(dist),
                               counter=jbfs.WorkCounter.zero())
        tstate = bfs_state_from_numpy(dist, 0, 0, 0, device="cpu")
        jout = jf(jnp.asarray(items), jnp.asarray(valid), jstate)
        tout = tf(torch.from_numpy(items), torch.from_numpy(valid), tstate)
        for got, want in zip(tout[:2], jout[:2]):
            _eq(got, want)
        _eq(tout[2].dist, jout[2].dist, "dist")
        _counters_equal(tout[2], jout[2])
        assert int(tout[2].dist[n - 1]) == 2
        if threshold is not None:
            assert int(tout[2].counter.splits) > 0


@pytest.mark.parametrize("g", [1, 2, 3, 4, 8, 64])
def test_chunk_operands_and_chunk_degree_bound(graphs, g):
    """The drain kernels' chunk operands against the codec, and the bound
    on a chunk's units against numpy."""
    from repro_torch.algorithms.common import max_chunk_degree_of
    from repro_torch.kernels.drain_loop.launch import (INT_MAX,
                                                       chunk_operands)

    jgraph, tgraph = graphs["rmat(8,8,1)"]
    n = tgraph.num_vertices
    assert chunk_operands("k", n, g, None) == (g, JCodec(g).width_bits,
                                               INT_MAX)
    assert chunk_operands("k", n, g, 17)[2] == 17
    with pytest.raises(ValueError, match="int32 chunk codes"):
        chunk_operands("k", 2 ** 31 >> JCodec(g).width_bits, g, None)
    rp = np.asarray(jgraph.row_ptr).astype(np.int64)
    ends = np.minimum(np.arange(n) + g, n)
    assert max_chunk_degree_of(tgraph, g) == int((rp[ends] - rp[:-1]).max())


# ------- the cases B3-BFS's design bends on: the plain fused drain (the
# kernel's oracle on the card) against JAX's persistent cell, bit for bit.
# "backlog": 37 sources queued at launch, more than W = 8; "resumed": the
# same drain cut into segments of two rounds, tasks waiting at the cuts;
# "drop": a ring of 12 slots; "hub": a root, four hubs of 60 edges each
# (onto 24 targets, duplicates kept) under a budget past the hub round's
# 240 units; "hub_budget": the same at a budget of one hub's degree, which
# the first hub fills; "wide": W = 512, past the graph, at a budget of
# the max degree
BFS_BENDS = (
    [("backlog", mode, g) for g in (1, 2, 4, 64)
     for mode in ("single", "fused", "traced", "per_item")]
    + [(case, "single", g) for case in ("resumed", "drop", "hub",
                                        "hub_budget", "wide")
       for g in (1, 4)])


def _bend_graphs(case, graphs):
    if not case.startswith("hub"):
        return graphs["rmat(8,8,1)"]
    rng = np.random.default_rng(5)
    hubs, width, targets = 4, 60, 24
    n = 1 + hubs + targets
    rows = ([np.arange(1, hubs + 1)]
            + [np.sort(rng.integers(hubs + 1, n, size=width))
               for _ in range(hubs)]
            + [np.zeros(1, np.int64)] * targets)
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    col_idx = np.concatenate(rows)
    return (jg.CSRGraph(row_ptr=jnp.asarray(row_ptr, jnp.int32),
                        col_idx=jnp.asarray(col_idx, jnp.int32)),
            graph_from_numpy(row_ptr, col_idx, device="cpu"))


def _bend_leaves(carry, fused):
    """The carry's leaves as numpy arrays, the same order for both
    packages: the queue's, dist, the counters, rounds, processed, then the
    ring's."""
    queue, state = carry[0], carry[1]
    lanes = queue.lanes if fused else queue
    out = [lanes.buf, lanes.head, lanes.tail, lanes.dropped]
    if fused:
        out.append(queue.rr)
    out += [state.dist, state.counter.work, state.counter.splits,
            state.counter.rounds, carry[2], carry[3]]
    if len(carry) > 4:
        out += [carry[4].buf, carry[4].cursor]
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("case,mode,g", BFS_BENDS)
def test_bfs_drain_where_the_kernel_bends_matches_jax(graphs, case, mode, g):
    from repro.core import WorkCounter as JCounter
    from repro.core import chunk_seeds as j_chunk_seeds
    from repro.obs import TraceRing as JRing
    from repro.runtime.api import instrument_step as j_instrument
    from repro_torch.core import WorkCounter, chunk_seeds
    from repro_torch.obs import Trace

    jgraph, tgraph = _bend_graphs(case, graphs)
    n = tgraph.num_vertices
    topology = "fused" if mode == "fused" else "single"
    suffix = "" if g == 1 else f".g{g}"
    params = {"source": 0}
    if mode == "per_item":
        params["strategy"] = "per_item"
    if case == "hub":
        params["work_budget"] = 1024
    elif case == "hub_budget":
        params["work_budget"] = 60
    elif case == "wide":
        params["work_budget"] = int(np.asarray(jgraph.degrees()).max())
    base = (dict(num_workers=128, fetch_size=4) if case == "wide"
            else dict(num_workers=4, fetch_size=2))
    capacity = 12 if case == "drop" else None
    jinit = tinit = None
    if case in ("backlog", "resumed"):
        sources = np.arange(0, n, 7)
        jinit = (jbfs.BFSState(
            dist=jnp.full((n,), jbfs.INF, jnp.int32).at[sources].set(0),
            counter=JCounter.zero()),
            j_chunk_seeds(sources, JCodec(g), jgraph.row_ptr))
        dist = torch.full((n,), tbfs.INF, dtype=torch.int32)
        dist[torch.as_tensor(sources)] = 0
        tinit = (tbfs.BFSState(dist=dist, counter=WorkCounter.zero("cpu")),
                 chunk_seeds(sources, ChunkCodec(g), tgraph.row_ptr))

    jpolicy = j_parse(f"{topology}.persistent{suffix}")
    jcfg = j_config_for(JConfig(**base), jpolicy)
    jprogram = j_build("bfs", jgraph, jcfg, params=params)
    jq, js, jops, jstep, jcond, _ = j_setup(jprogram, jgraph, jcfg, jpolicy,
                                           capacity, init=jinit)
    jcarry = (jq, js, jnp.int32(0), jnp.int32(0))
    if mode == "traced":
        jstep, jcond = j_instrument(jstep, jcond, jops, jprogram)
        jcarry = jcarry + (JRing.make(64),)
    jcarry = j_persistent_drive(jstep, jcond, jcarry)

    tcfg = config_for(SchedulerConfig(**base),
                      parse_policy(f"{topology}.megakernel{suffix}"))
    setup = drain_setup(build_program("bfs", tgraph, tcfg, params=params),
                        tgraph, tcfg, queue_capacity=capacity,
                        trace=Trace(capacity=64) if mode == "traced" else None,
                        init=tinit)
    assert setup.kernel is None             # CPU tensors: the plain drain
    if case == "resumed":
        seg = megakernel_segment(setup.step, setup.cond, setup.carry)
        tcarry, limit, waited = setup.carry, 0, 0
        while bool(setup.cond(tcarry)):
            limit += 2
            tcarry = seg(tcarry, limit)
            waited += int(tcarry[0].size) > tcfg.wavefront
        assert waited > 0
    else:
        tcarry = megakernel_drive(setup.step, setup.cond, setup.carry)

    fused = topology == "fused"
    for got, want in zip(_bend_leaves(tcarry, fused),
                         _bend_leaves(jcarry, fused), strict=True):
        np.testing.assert_array_equal(got, want)
    assert (int(setup.dropped(tcarry[0])) > 0) == (case == "drop")
    assert int(tcarry[2]) > 2
