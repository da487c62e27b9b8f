"""The port's slotted CSR (``repro_torch.graph.slotted``) against JAX's.

The same canonical delta logs, made with numpy from a seed, go through
both packages' ``SlottedCSR``: after every commit and every compaction the
slab arrays, the overlay, the effective ops, the touched-row and
compaction meters and the symmetry flag are held bit for bit, and the
materialized CSR against ``from_edges``.  The read path -- the two-level
``gather_neighbors``, the merge-path expansion (plain search),
``expand_per_item`` and the plain slotted row-slice stream -- is held
against JAX's ``jnp`` expansion on the same slotted view with a non-empty
overlay, at granularities 1 and 4 (JAX's stream backend does not run on
its installed version).  Snapshot fingerprints are held against JAX's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graph as jg
import repro.graph.generators as jgen
import repro_torch.graph as tg
from repro.core.frontier import expand_merge_path as j_expand
from repro.core.frontier import expand_per_item as j_per_item
from repro.core.frontier import gather_neighbors as j_gather
from repro.stream import apply_delta as j_apply_delta
from repro.stream import commit as j_commit
from repro.stream import graph_fingerprint as j_fingerprint
from repro.stream import make_delta as j_make_delta
from repro_torch.convert import graph_from_numpy, slotted_view_from_numpy
from repro_torch.core import (adjacency_of, expand_merge_path,
                              expand_per_item, gather_neighbors)
from repro_torch.graph.slotted import SLAB_SLACK, SlottedCSR
from repro_torch.kernels.drain_loop.csr_stream import expand_stream
from repro_torch.stream import apply_delta, commit, graph_fingerprint
from repro_torch.stream import make_delta, replay_commits

TOPOLOGIES = {
    "rmat(6,6,1)": lambda: jgen.rmat(6, edge_factor=6, seed=1),
    "grid2d(10,10)": lambda: jgen.grid2d(10, 10),
    "erdos(40,160,2)": lambda: jgen.erdos(40, 160, seed=2),
}

ARRAYS = ("slab_ptr", "slab_len", "slab_col", "deg", "ovl_row", "ovl_col")


def _port_graph(jgraph):
    return graph_from_numpy(np.asarray(jgraph.row_ptr),
                            np.asarray(jgraph.col_idx), device="cpu")


def _assert_slotted_equal(t, j, msg=""):
    for name in ARRAYS:
        x, y = getattr(t, name).numpy(), getattr(j, name)
        assert x.dtype == y.dtype, f"{msg} {name} dtype"
        np.testing.assert_array_equal(x, y, err_msg=f"{msg} {name}")
    for name in ("symmetric", "commits", "compactions", "touched_rows",
                 "last_touched", "last_compacted", "overlay_size",
                 "num_edges"):
        assert getattr(t, name) == getattr(j, name), f"{msg} {name}"


def _assert_csr_equal(t, j, msg=""):
    np.testing.assert_array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr),
                                  err_msg=msg)
    np.testing.assert_array_equal(t.col_idx.numpy(), np.asarray(j.col_idx),
                                  err_msg=msg)


def _run_log(jbase, deltas, knobs, msg):
    """Commit ``deltas`` through both packages, holding every commit."""
    js = jg.SlottedCSR.from_csr(jbase)
    ts = SlottedCSR.from_csr(_port_graph(jbase))
    _assert_slotted_equal(ts, js, f"{msg} build")
    for b, (d, (every, slack)) in enumerate(zip(deltas, knobs), start=1):
        td = make_delta(d.num_vertices, d.src, d.dst, d.insert)
        ja = j_commit(js, d, b, every, slack)
        ta = commit(ts, td, b, every, slack)
        for f in ("ins_src", "ins_dst", "del_src", "del_dst"):
            got, want = getattr(ta, f), getattr(ja, f)
            assert got.dtype == want.dtype, f"{msg} b={b} {f}"
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{msg} b={b} {f}")
        assert (ta.touched_rows, ta.compacted) == \
            (ja.touched_rows, ja.compacted), f"{msg} b={b}"
        _assert_slotted_equal(ts, js, f"{msg} b={b}")
        _assert_csr_equal(ts.to_csr(), js.to_csr(), f"{msg} b={b}")
    return ts, js


# ------------------------------------------------------------- structure
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_from_csr_and_to_csr_match_jax(name):
    jbase = TOPOLOGIES[name]()
    js = jg.SlottedCSR.from_csr(jbase)
    ts = SlottedCSR.from_csr(_port_graph(jbase))
    _assert_slotted_equal(ts, js, name)
    _assert_csr_equal(ts.to_csr(), jbase, name)
    caps = np.diff(ts.slab_ptr.numpy())
    assert ((caps & (caps - 1)) == 0).all() and ts.overlay_size == 0


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("every", [0, 2])
def test_edge_delta_stream_commits_match_jax(name, every):
    """A generator log (mirrored ops, mixed inserts and deletes) through
    the commit schedule: every array after every commit and compaction."""
    jbase = TOPOLOGIES[name]()
    deltas = jgen.edge_delta_stream(jbase, 6, 24, seed=3)
    ts, js = _run_log(jbase, deltas, [(every, 0.25)] * len(deltas), name)
    assert ts.commits == len(deltas)


def _fuzz_case(rng, n):
    """tests/test_slotted.py's fuzz batch: random directed ops with
    repeats, canonicalized by ``make_delta`` (last wins)."""
    k = int(rng.integers(1, 40))
    src = rng.integers(0, n, k)
    dst = rng.integers(0, n, k)
    ins = rng.random(k) < 0.55
    keep = src != dst
    if not keep.any():
        return None
    return j_make_delta(n, src[keep], dst[keep], ins[keep])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_fuzz_delta_log_matches_jax_and_from_edges(seed):
    """tests/test_slotted.py's seeded fuzz logs (random knobs, directed
    ops) through both packages, and the port's ``to_csr`` against its own
    ``from_edges`` on the replayed edge set after every commit."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 48))
    m0 = int(rng.integers(0, 4 * n))
    jbase = jg.from_edges(n, rng.integers(0, n, m0), rng.integers(0, n, m0))
    deltas, knobs = [], []
    for _ in range(24):
        d = _fuzz_case(rng, n)
        if d is not None:
            deltas.append(d)
            knobs.append((int(rng.integers(0, 4)),
                          float(rng.choice([0.05, 0.25, 1.0]))))
    ts, _ = _run_log(jbase, deltas, knobs, f"seed={seed}")
    edges = {(int(a), int(b)) for a, b in zip(
        np.repeat(np.arange(n), np.diff(np.asarray(jbase.row_ptr))),
        np.asarray(jbase.col_idx))}
    for d in deltas:
        for a, b, i in zip(d.src.tolist(), d.dst.tolist(), d.insert.tolist()):
            (edges.add if i else edges.discard)((a, b))
    e = np.array(sorted(edges), dtype=np.int64).reshape(-1, 2)
    want = tg.from_edges(n, e[:, 0], e[:, 1], device="cpu")
    got = ts.to_csr()
    assert torch.equal(got.row_ptr, want.row_ptr)
    assert torch.equal(got.col_idx, want.col_idx)
    caps = np.diff(ts.slab_ptr.numpy())
    assert (caps <= SLAB_SLACK * np.maximum(ts.deg.numpy(), 1)).all() or \
        ts.should_compact(len(deltas) + 1, 0, 1e9)


def test_hypothesis_delta_log_matches_jax():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @st.composite
    def log(draw):
        n = draw(st.integers(min_value=2, max_value=14))
        pairs = st.tuples(st.integers(0, n - 1), st.integers(0, n - 1))
        edges = [e for e in draw(st.lists(pairs, max_size=40))
                 if e[0] != e[1]]
        batches = draw(st.lists(
            st.lists(st.tuples(st.integers(0, n - 1),
                               st.integers(0, n - 1), st.booleans()),
                     max_size=16),
            min_size=1, max_size=6))
        every = draw(st.integers(min_value=0, max_value=3))
        return n, edges, batches, every

    @settings(max_examples=40, deadline=None)
    @given(log())
    def check(case):
        n, edges, batches, every = case
        e = np.array(edges, dtype=np.int64).reshape(-1, 2)
        jbase = jg.from_edges(n, e[:, 0], e[:, 1])
        deltas = []
        for ops in batches:
            ops = [o for o in ops if o[0] != o[1]]
            if ops:
                deltas.append(j_make_delta(n, [o[0] for o in ops],
                                           [o[1] for o in ops],
                                           [o[2] for o in ops]))
        _run_log(jbase, deltas, [(every, 0.25)] * len(deltas), str(case))

    check()


def test_symmetry_flag_and_slack_compaction_match_jax():
    """tests/test_slotted.py's symmetry and slab-slack cases, step by step
    in both packages."""
    for jbase, steps in (
            (jgen.grid2d(4, 4), [([0, 5], [5, 0], [True, True]),
                                 ([0], [5], [False]), ([5], [0], [False])]),
            (jg.from_edges(34, np.zeros(32, np.int64), np.arange(1, 33)),
             [(np.zeros(31), np.arange(1, 32), np.zeros(31, bool))])):
        js = jg.SlottedCSR.from_csr(jbase)
        ts = SlottedCSR.from_csr(_port_graph(jbase))
        for src, dst, ins in steps:
            got = ts.apply(np.array(src), np.array(dst), np.array(ins))
            want = js.apply(np.array(src), np.array(dst), np.array(ins))
            for x, y in zip(got, want):
                np.testing.assert_array_equal(x, y)
            _assert_slotted_equal(ts, js)
            assert ts.should_compact(1, 0, 1e9) == js.should_compact(1, 0,
                                                                      1e9)
        ts.compact()
        js.compact()
        _assert_slotted_equal(ts, js)
        _assert_csr_equal(ts.to_csr(), js.to_csr())


def test_apply_delta_slotted_and_reference_paths_match_jax():
    jbase = jgen.erdos(30, 100, seed=3)
    tbase = _port_graph(jbase)
    d = jgen.edge_delta_stream(jbase, 1, 24, seed=4)[0]
    td = make_delta(d.num_vertices, d.src, d.dst, d.insert)
    ref = j_apply_delta(jbase, d)
    for got in (apply_delta(tbase, td),
                apply_delta(SlottedCSR.from_csr(tbase), td)):
        for f in ("ins_src", "ins_dst", "del_src", "del_dst"):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
        _assert_csr_equal(got.csr(), ref.new_graph)
    assert 0 < apply_delta(SlottedCSR.from_csr(tbase), td).touched_rows < 30


def test_replay_commits_matches_jax():
    from repro.stream import replay_commits as j_replay_commits

    jbase = jgen.rmat(5, edge_factor=6, seed=14)
    deltas = jgen.edge_delta_stream(jbase, 5, 16, seed=15)
    js = j_replay_commits(jg.SlottedCSR.from_csr(jbase), deltas,
                          compact_every=2)
    ts = replay_commits(SlottedCSR.from_csr(_port_graph(jbase)), deltas,
                        compact_every=2)
    _assert_slotted_equal(ts, js)


# ------------------------------------------------------------- read path
def _mutated(seed=7, scale=6):
    """A JAX slotted graph with a non-empty overlay (no compaction), its
    view carried across to the port, and both canonical graphs."""
    g = jgen.rmat(scale, edge_factor=6, seed=seed)
    s = jg.SlottedCSR.from_csr(g)
    for d in jgen.edge_delta_stream(g, 4, 24, seed=seed + 1):
        j_apply_delta(s, d)
    assert s.overlay_size > 0
    view = s.view()
    tview = slotted_view_from_numpy(
        *(np.asarray(getattr(view, f)) for f in (
            "row_ptr", "slab_ptr", "slab_len", "slab_col", "ovl_ptr",
            "ovl_col")), view.m, device="cpu")
    return view, tview, s.to_csr()


def _assert_expansion_equal(got, want, msg):
    for name, a, b in zip(want._fields, got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"{msg} {name}")


def test_view_has_no_flat_col_idx_and_reads_canonical():
    view, tview, canon = _mutated()
    with pytest.raises(AttributeError):
        _ = tview.col_idx
    assert tview.num_edges == canon.num_edges
    np.testing.assert_array_equal(tview.edge_targets().numpy(),
                                  np.asarray(canon.col_idx))
    rp, cols, overlay = adjacency_of(tview)
    assert cols is tview.slab_col and overlay is not None


def test_gather_neighbors_two_level_matches_jax():
    view, tview, canon = _mutated(seed=9)
    n, m = view.num_vertices, view.m
    src = np.repeat(np.arange(n, dtype=np.int32),
                    np.diff(np.asarray(view.row_ptr)))
    edge = np.arange(m, dtype=np.int32)
    want = j_gather(view.row_ptr, view.slab_col, jnp.asarray(src),
                    jnp.asarray(edge), overlay=view.overlay)
    got = gather_neighbors(tview.row_ptr, tview.slab_col,
                           torch.from_numpy(src), torch.from_numpy(edge),
                           overlay=tview.overlay)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(canon.col_idx))


@pytest.mark.parametrize("g", [1, 4])
def test_expansions_on_a_slotted_view_match_jax(g):
    """expand_merge_path (plain search), the plain slotted stream and
    expand_per_item against JAX's jnp expansion on the same view."""
    view, tview, canon = _mutated()
    n = view.num_vertices
    heads = np.arange(0, n - g, g, dtype=np.int32)[:24]
    widths = np.full(heads.shape, g, np.int32)
    valid = np.ones(heads.shape, bool)
    valid[5] = False
    budget = 1024
    jw = jnp.asarray(widths) if g > 1 else None
    tw = torch.from_numpy(widths) if g > 1 else None
    want = j_expand(jnp.asarray(heads), jnp.asarray(valid), view.row_ptr,
                    view.slab_col, budget, widths=jw, max_width=g,
                    overlay=view.overlay)
    canonical = j_expand(jnp.asarray(heads), jnp.asarray(valid),
                         canon.row_ptr, canon.col_idx, budget, widths=jw,
                         max_width=g)
    _assert_expansion_equal(
        expand_merge_path(torch.from_numpy(heads), torch.from_numpy(valid),
                          tview.row_ptr, tview.slab_col, budget,
                          backend="torch", widths=tw, max_width=g,
                          overlay=tview.overlay), want, f"merge_path g={g}")
    _assert_expansion_equal(
        expand_stream(torch.from_numpy(heads), torch.from_numpy(valid),
                      tview.row_ptr, tview.slab_col, budget, widths=tw,
                      max_width=g, overlay=tview.overlay, backend="torch"),
        want, f"stream g={g}")
    for name, a, b in zip(want._fields, want, canonical):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"jax slotted vs canonical "
                                              f"{name}")
    items = np.arange(0, n, 1 + g, dtype=np.int32)
    ivalid = np.ones(items.shape, bool)
    md = int(np.diff(np.asarray(view.row_ptr)).max())
    _assert_expansion_equal(
        expand_per_item(torch.from_numpy(items), torch.from_numpy(ivalid),
                        tview.row_ptr, tview.slab_col, md,
                        overlay=tview.overlay),
        j_per_item(jnp.asarray(items), jnp.asarray(ivalid), view.row_ptr,
                   view.slab_col, md, overlay=view.overlay), "per_item")


# ----------------------------------------------------------- fingerprint
def test_fingerprints_match_jax_on_slotted_and_canonical_graphs():
    view, tview, canon = _mutated(seed=13)
    want = {k: int(v) for k, v in j_fingerprint(view, 4).items()}
    assert {k: int(v) for k, v in graph_fingerprint(tview, 4).items()} == \
        want
    tcanon = _port_graph(canon)
    assert {k: int(v) for k, v in graph_fingerprint(tcanon, 4).items()} == \
        {k: int(v) for k, v in j_fingerprint(canon, 4).items()} == want
