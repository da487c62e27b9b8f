"""Speculative greedy coloring through the PyTorch port against the JAX
package, on the CPU, on numpy-made inputs, bit for bit: the flat forms of
the neighbor gather, the smallest free color and the conflict test against
JAX's padded one-hot functions; the uint32 priority hash; the state and
queue after ``init``; the fused body on hand-made wavefronts at granularity
1 and 4; ``execute`` under ``single.persistent``, ``single.discrete`` and
``single.megakernel`` (the plain fused drain on CPU tensors) against JAX's
``single.persistent`` and ``single.megakernel`` cells; a ``max_rounds``
cut, segmented drains and a JAX drain handed across mid-way; beyond
granularity 1 (G = 2, 3, 8; windows that split) the megakernel drain's
final queue against JAX's persistent cell and its state against JAX's
megakernel cell, and the body at G = 3 on a hand-made wavefront (a
zero-degree member row, the partial window of vertex n - 1, an assign and a
detect with one head); ``coloring_bsp``; and ``validate_coloring`` on every
result.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.algorithms import coloring as jcol
from repro.core import ChunkCodec as JCodec
from repro.core import SchedulerConfig as JConfig
from repro.core.scheduler import persistent_drive as j_persistent_drive
from repro.runtime import build_program as j_build
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro.runtime.api import _shared_setup as j_setup
from repro_torch.algorithms import coloring as tcol
from repro_torch.convert import (coloring_state_from_numpy, graph_from_numpy,
                                 queue_from_numpy)
from repro_torch.core import (ChunkCodec, SchedulerConfig, chunk_degrees,
                              megakernel_drive, megakernel_segment)
from repro_torch.runtime import (build_program, config_for, parse_policy,
                                 policy_of)
from repro_torch.runtime.api import _shared_setup, drain_setup, execute

GRAPHS = {
    "rmat(8,8,1)": (lambda: jg.rmat(8, 8, seed=1),
                    lambda: tg.rmat(8, 8, seed=1, device="cpu")),
    "grid2d(16,16)": (lambda: jg.grid2d(16, 16),
                      lambda: tg.grid2d(16, 16, device="cpu")),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (mj(), mt()) for name, (mj, mt) in GRAPHS.items()}


def _suffix(g):
    return "" if g == 1 else f".g{g}"


def _configs(policy, jpolicy=None, **kw):
    base = dict(num_workers=16, fetch_size=4, **kw)
    return (j_config_for(JConfig(**base), j_parse(jpolicy or policy)),
            config_for(SchedulerConfig(**base), parse_policy(policy)))


def _assert_state(ts, js):
    np.testing.assert_array_equal(ts.colors.numpy(), np.asarray(js.colors))
    for field in ("work", "splits", "rounds"):
        assert int(getattr(ts.counter, field)) == int(
            getattr(js.counter, field)), field


# ------------------------------------------------- the flat forms
def _lanes(n, k, seed):
    rng = np.random.default_rng(seed)
    vids = rng.permutation(n)[:k].astype(np.int32)   # distinct, as lanes are
    valid = rng.random(k) < 0.8
    colors = rng.integers(-1, 6, size=n).astype(np.int32)
    return vids, valid, colors


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flat_min_free_color_and_conflicts_match_jax_one_hot(graphs, graph,
                                                             seed):
    jgraph, tgraph = graphs[graph]
    n = jgraph.num_vertices
    max_degree = int(np.asarray(jgraph.degrees()).max())
    vids, valid, colors = _lanes(n, 64, seed)
    nbr, in_row = jcol._gather_neighbor_colors(
        jgraph, jnp.asarray(vids), jnp.asarray(valid), max_degree)
    want_pick = jcol._min_free_color(jnp.asarray(colors), nbr, in_row,
                                     max_degree + 1)
    want_bad = jcol._conflicts(jnp.asarray(colors), jnp.asarray(vids),
                               jnp.asarray(valid), nbr, in_row)
    tv, tval, tc = (torch.from_numpy(x) for x in (vids, valid, colors))
    budget = tcol.flat_budget(tgraph, 64)
    for backend in ("torch", "auto"):
        ex = tcol._gather_neighbor_colors(tgraph, tv, tval, budget, backend)
        assert int(ex.total) <= budget
        deg = chunk_degrees(tv, None, tval, tgraph.row_ptr)
        pick = tcol._min_free_color(tc, ex, deg, backend)
        np.testing.assert_array_equal(pick.numpy()[valid],
                                      np.asarray(want_pick)[valid])
        bad = tcol._conflicts(tc, tv, tval, ex)
        np.testing.assert_array_equal(bad.numpy(), np.asarray(want_bad))


def test_priority_matches_jax_uint32_hash_up_to_int32_max():
    rng = np.random.default_rng(5)
    v = np.concatenate([[0, 1, 2 ** 31 - 1, 2 ** 31 - 2, 2 ** 16, 65535],
                        rng.integers(0, 2 ** 31, size=5000)]).astype(np.int32)
    want = np.asarray(jcol._priority(jnp.asarray(v))).astype(np.int64)
    got = tcol._priority(torch.from_numpy(v))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() > 2 ** 31).any()     # the unsigned half is reached


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_coloring_bsp_matches_jax(graphs, graph):
    jgraph, tgraph = graphs[graph]
    jc, jinfo = jcol.coloring_bsp(jgraph)
    tc, tinfo = tcol.coloring_bsp(tgraph)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tinfo == jinfo
    assert tcol.validate_coloring(tgraph, tc)
    assert jcol.validate_coloring(jgraph, np.asarray(tc))


def test_validate_coloring_rejects_a_clash_and_an_uncolored_vertex(graphs):
    _, tgraph = graphs["grid2d(16,16)"]
    colors, _ = tcol.coloring_bsp(tgraph)
    assert tcol.validate_coloring(tgraph, colors)
    clash = colors.clone()
    clash[1] = clash[0]                           # 0 and 1 are neighbors
    assert not tcol.validate_coloring(tgraph, clash)
    uncolored = colors.clone()
    uncolored[7] = -1
    assert not tcol.validate_coloring(tgraph, uncolored)


# --------------------------------------------------------------- init
@pytest.mark.parametrize("g", [1, 4])
def test_init_state_and_queue_match_jax(graphs, g):
    jgraph, tgraph = graphs["rmat(8,8,1)"]
    policy = "single.persistent" + _suffix(g)
    jcfg, tcfg = _configs(policy)
    jq, js, *_ = j_setup(j_build("coloring", jgraph, jcfg), jgraph, jcfg,
                         j_parse(policy), None)
    tq, ts, *_ = _shared_setup(build_program("coloring", tgraph, tcfg),
                               tgraph, tcfg, policy_of(tcfg), None)
    _assert_state(ts, js)
    for field in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(getattr(tq, field).numpy(),
                                      np.asarray(getattr(jq, field)))


# ------------------------------------------------ hand-made wavefronts
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_fused_body_matches_jax_on_tapes(graphs, g, graph):
    """A wavefront of assign and detect chunks over disjoint vertex runs,
    with EMPTY lanes, on a half-colored state."""
    jgraph, tgraph = graphs[graph]
    n = jgraph.num_vertices
    rng = np.random.default_rng(g)
    k = 20
    heads = (rng.permutation(n // 4)[:k] * 4).astype(np.int32)
    widths = rng.integers(1, g + 1, size=k).astype(np.int32)
    codes = np.asarray(JCodec(g).encode(jnp.asarray(heads),
                                        jnp.asarray(widths)))
    sign = np.where(rng.random(k) < 0.5, 1, -1).astype(np.int32)
    items = (sign * (codes + 1)).astype(np.int32)
    valid = np.ones(k, bool)
    valid[-3:] = False
    items[~valid] = np.int32(-2 ** 31)
    colors = np.where(rng.random(n) < 0.5,
                      rng.integers(0, 5, size=n), -1).astype(np.int32)
    jf = jcol.make_wavefront_fn(jgraph, codec=JCodec(g))
    tf = tcol.make_wavefront_fn(tgraph, tcol.flat_budget(tgraph, k * g),
                                codec=ChunkCodec(g), backend="torch")
    jstate = jcol.ColorState(colors=jnp.asarray(colors),
                             counter=jcol.WorkCounter.zero())
    tstate = coloring_state_from_numpy(colors, 0, 0, 0, device="cpu")
    jout = jf(jnp.asarray(items), jnp.asarray(valid), jstate)
    tout = tf(torch.from_numpy(items), torch.from_numpy(valid), tstate)
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_state(tout[2], jout[2])
    assert (sign[valid] > 0).any() and (sign[valid] < 0).any()


# ------------------------------------------------------ execute vs JAX
_JAX_RUNS: dict = {}


def _jax_run(jgraph, name, jpolicy, **kw):
    key = (name, jpolicy, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jcfg, _ = _configs(jpolicy, **kw)
        _JAX_RUNS[key] = j_execute(j_build("coloring", jgraph, jcfg),
                                   jgraph, jcfg)
    return _JAX_RUNS[key]


def _run_both(graphs, name, policy, jpolicy, **kw):
    jgraph, tgraph = graphs[name]
    js, jstats, jinfo = _jax_run(jgraph, name, jpolicy, **kw)
    _, tcfg = _configs(policy, **kw)
    ts, tstats, tinfo = execute(build_program("coloring", tgraph, tcfg),
                                tgraph, tcfg)
    _assert_state(ts, js)
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    launches = 1 if "megakernel" in policy else tinfo["rounds"]
    assert tinfo == {**jinfo, "launches": launches}
    return tinfo, ts


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("kernel", ["persistent", "discrete", "megakernel"])
def test_execute_bit_identical_to_jax_persistent(graphs, graph, g, kernel):
    info, state = _run_both(graphs, graph, f"single.{kernel}" + _suffix(g),
                            "single.persistent" + _suffix(g))
    assert info["dropped"] == 0 and info["rounds"] > 2
    assert tcol.validate_coloring(graphs[graph][1], state.colors)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g", [1, 4])
def test_megakernel_bit_identical_to_jax_megakernel(graphs, graph, g):
    """JAX's coloring megakernel cell runs on the installed JAX (it never
    takes the streaming path), so the port's is held against it too."""
    info, state = _run_both(graphs, graph, "single.megakernel" + _suffix(g),
                            "single.megakernel" + _suffix(g))
    assert info["launches"] == 1
    assert tcol.validate_coloring(graphs[graph][1], state.colors)


# ------------- the megakernel beyond granularity 1, final queue included
WIDE = [(2, {}), (3, {}), (8, {}), (3, {"split_threshold": 6}),
        (8, {"split_threshold": 6})]


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g,fields", WIDE)
def test_wide_megakernel_drain_matches_jax_with_its_queue(graphs, graph, g,
                                                          fields):
    """The port's single.megakernel.g<G> plain fused drain against JAX's
    single.persistent.g<G> set up by hand (colors, counters with splits,
    rounds, processed and the final queue, bitwise), and through execute
    against JAX's single.megakernel.g<G>."""
    jgraph, tgraph = graphs[graph]
    policy = "single.megakernel" + _suffix(g)
    jpolicy = j_parse("single.persistent" + _suffix(g))
    jcfg, tcfg = _configs(policy, "single.persistent" + _suffix(g),
                          **fields)
    jq, js, _, jstep, jcond, _ = j_setup(j_build("coloring", jgraph, jcfg),
                                         jgraph, jcfg, jpolicy, None)
    jcarry = j_persistent_drive(jstep, jcond,
                                (jq, js, jnp.int32(0), jnp.int32(0)))
    setup = drain_setup(build_program("coloring", tgraph, tcfg), tgraph,
                        tcfg)
    assert setup.kernel is None             # CPU tensors: the plain drain
    tcarry = megakernel_drive(setup.step, setup.cond, setup.carry)
    for field in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(getattr(tcarry[0], field).numpy(),
                                      np.asarray(getattr(jcarry[0], field)),
                                      err_msg=field)
    _assert_state(tcarry[1], jcarry[1])
    assert [int(x) for x in tcarry[2:]] == [int(x) for x in jcarry[2:]]
    assert tcol.validate_coloring(tgraph, tcarry[1].colors)
    if fields and graph == "rmat(8,8,1)":
        assert int(tcarry[1].counter.splits) > 0
    info, _ = _run_both(graphs, graph, policy, policy, **fields)
    assert info["launches"] == 1


@pytest.fixture(scope="module")
def tape_graph():
    """rmat(8,8,1) with its ids reversed, so that vertex n - 1 is a hub and
    its window is busy; rows of degree 0 stay."""
    jgraph = jg.rmat(8, 8, seed=1)
    n = jgraph.num_vertices
    jgraph = jg.permute_vertices(jgraph, np.arange(n)[::-1].copy())
    return jgraph, graph_from_numpy(np.asarray(jgraph.row_ptr),
                                    np.asarray(jgraph.col_idx), device="cpu")


@pytest.mark.parametrize("threshold", [None, 6])
def test_fused_body_matches_jax_on_a_g3_tape(tape_graph, threshold):
    """The fused body at G = 3: an assign chunk with a zero-degree member
    row, an assign and a detect chunk with one head, and detect chunks
    over the partial window of n - 1 and others, on a state of mostly one
    color, where most detects clash."""
    jgraph, tgraph = tape_graph
    g = 3
    n = jgraph.num_vertices
    deg = np.asarray(jgraph.degrees())
    zero = int(np.flatnonzero(deg[1:n - 4] == 0)[0]) + 1
    rng = np.random.default_rng(4)
    # runs that share no vertex except the detect beside the assign at 100
    # (the high ids are the hubs, where detects clash most)
    starts = [s for s in range(n - 90, n - 8, 6) if abs(s - zero) > 8
              and abs(s - 100) > 8][:14]
    heads = [zero - 1, 100, 100, n - 2] + starts
    widths = [3, 3, 3, 2] + list(rng.integers(1, g + 1, size=len(starts)))
    sign = [1, 1, -1, -1] + list(np.where(rng.random(len(starts)) < 0.5,
                                          1, -1))
    codes = np.asarray(JCodec(g).encode(jnp.asarray(heads, jnp.int32),
                                        jnp.asarray(widths, jnp.int32)))
    items = (np.asarray(sign, np.int32) * (codes + 1)).astype(np.int32)
    valid = np.ones(items.shape[0], bool)
    valid[-2:] = False
    items[~valid] = np.int32(-2 ** 31)
    colors = np.where(rng.random(n) < 0.9, 0, 1).astype(np.int32)
    k = items.shape[0]
    jf = jcol.make_wavefront_fn(jgraph, codec=JCodec(g),
                                split_threshold=threshold)
    tf = tcol.make_wavefront_fn(tgraph, tcol.flat_budget(tgraph, k * g),
                                codec=ChunkCodec(g), backend="torch",
                                split_threshold=threshold)
    jstate = jcol.ColorState(colors=jnp.asarray(colors),
                             counter=jcol.WorkCounter.zero())
    tstate = coloring_state_from_numpy(colors, 0, 0, 0, device="cpu")
    jout = jf(jnp.asarray(items), jnp.asarray(valid), jstate)
    tout = tf(torch.from_numpy(items), torch.from_numpy(valid), tstate)
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_state(tout[2], jout[2])
    out, mask = tout[0].numpy(), tout[1].numpy()
    reassigned = out[k:][mask[k:]] - 1
    # the re-assign chunks include the window of n - 1, and a wide chunk
    # where no threshold splits it
    assert ((reassigned >> 2) + (reassigned & 3) >= n - 1).any()
    if threshold is None:
        assert ((reassigned & 3) > 0).any()
    else:                                   # the hubs' windows split
        assert int(tout[2].counter.splits) > 0


@pytest.mark.parametrize("kernel", ["persistent", "megakernel"])
def test_max_rounds_cut_matches_jax(graphs, kernel):
    info, state = _run_both(graphs, "rmat(8,8,1)", f"single.{kernel}",
                            "single.persistent", max_rounds=4)
    assert info["rounds"] == 4
    assert not tcol.validate_coloring(graphs["rmat(8,8,1)"][1], state.colors)


@pytest.mark.parametrize("every", [1, 5])
def test_segmented_megakernel_drain_equals_the_whole(graphs, every):
    _, tgraph = graphs["rmat(8,8,1)"]
    cfg = config_for(SchedulerConfig(num_workers=8, fetch_size=2),
                     parse_policy("single.megakernel"))
    program = build_program("coloring", tgraph, cfg)
    whole = drain_setup(program, tgraph, cfg)
    assert whole.kernel is None             # CPU tensors: the plain drain
    want = megakernel_drive(whole.step, whole.cond, whole.carry)
    cut = drain_setup(program, tgraph, cfg)
    seg = megakernel_segment(cut.step, cut.cond, cut.carry)
    carry, limit = cut.carry, 0
    while bool(cut.cond(carry)):
        limit += every
        carry = seg(carry, limit)
        assert int(carry[2]) == min(limit, int(want[2]))
    assert torch.equal(carry[0].buf, want[0].buf)
    assert torch.equal(carry[1].colors, want[1].colors)
    assert [int(x) for x in (carry[0].head, carry[0].tail, carry[2],
                             carry[3], carry[1].counter.work)] == \
        [int(x) for x in (want[0].head, want[0].tail, want[2], want[3],
                          want[1].counter.work)]


def test_assign_targets_are_unique_in_every_wavefront(graphs):
    """The assign scatter relies on unique targets: a vertex has at most
    one task in the queue, so no wavefront holds two tasks of one vertex."""
    _, tgraph = graphs["rmat(8,8,1)"]
    cfg = config_for(SchedulerConfig(num_workers=16, fetch_size=4),
                     parse_policy("single.discrete"))
    setup = drain_setup(build_program("coloring", tgraph, cfg), tgraph, cfg)
    carry, rounds = setup.carry, 0
    while bool(setup.cond(carry)):
        queue = carry[0]
        size = int(queue.size)
        live = queue.buf[(queue.head + torch.arange(size)) % queue.capacity]
        vertices = live.abs() - 1
        assert vertices.unique().numel() == size, f"round {rounds}"
        carry = setup.step(carry)
        rounds += 1
    assert rounds > 2


@pytest.mark.parametrize("g", [1, 4])
def test_drain_handed_across_mid_way(graphs, g):
    """Three JAX rounds, then the queue and colors cross to the port as
    numpy; the port's rounds continue exactly as JAX's would."""
    jgraph, tgraph = graphs["rmat(8,8,1)"]
    policy = "single.discrete" + _suffix(g)
    jcfg, tcfg = _configs(policy)
    jq, js, _, jstep, _, _ = j_setup(j_build("coloring", jgraph, jcfg),
                                     jgraph, jcfg, j_parse(policy), None)
    tstep = _shared_setup(build_program("coloring", tgraph, tcfg), tgraph,
                          tcfg, policy_of(tcfg), None)[3]
    zero = np.int32(0)
    carry = (jq, js, zero, zero)
    for _ in range(3):
        carry = jstep(carry)
    jq, js, jr, jp = carry
    tcarry = (queue_from_numpy(*(np.asarray(x) for x in (
                  jq.buf, jq.head, jq.tail, jq.dropped)), device="cpu"),
              coloring_state_from_numpy(
                  np.asarray(js.colors),
                  *(np.asarray(getattr(js.counter, f))
                    for f in ("work", "splits", "rounds")), device="cpu"),
              torch.tensor(int(jr), dtype=torch.int32),
              torch.tensor(int(jp), dtype=torch.int32))
    for _ in range(4):
        carry = jstep(carry)
        tcarry = tstep(tcarry)
        np.testing.assert_array_equal(tcarry[0].buf.numpy(),
                                      np.asarray(carry[0].buf))
        _assert_state(tcarry[1], carry[1])
        assert (int(tcarry[2]), int(tcarry[3])) == (int(carry[2]),
                                                    int(carry[3]))


def test_coloring_async_driver_matches_jax(graphs):
    jgraph, tgraph = graphs["grid2d(16,16)"]
    jc, jinfo = jcol.coloring_async(jgraph, JConfig(num_workers=8))
    tc, tinfo = tcol.coloring_async(tgraph, SchedulerConfig(num_workers=8))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert tinfo == jinfo


def test_params_and_unported_options(graphs):
    _, tgraph = graphs["grid2d(16,16)"]
    cfg = SchedulerConfig(num_workers=4)
    with pytest.raises(ValueError, match="unknown coloring params"):
        build_program("coloring", tgraph, cfg, params={"dirt": "recolor"})
    # the streaming rule comes with its streaming hook
    for dirty in ("conflicts", "recolor"):
        with pytest.raises(NotImplementedError, match="A9"):
            build_program("coloring", tgraph, cfg, params={"dirty": dirty})
    with pytest.raises(NotImplementedError, match="A12"):
        tcol.make_wavefront_fn(tgraph, 64, fused=False)
    # the flat budget: the largest degrees a wavefront can hold
    deg = np.sort(tgraph.degrees().numpy())[::-1]
    assert tcol.flat_budget(tgraph, 10) == int(deg[:10].sum())
    assert tcol.flat_budget(tgraph, 10 ** 6) == tgraph.num_edges
