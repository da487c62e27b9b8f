"""Asynchronous PageRank through the PyTorch port against the JAX package,
on the CPU, on numpy-made inputs, bit for bit: the state and queue after
``init``; the body, ``on_empty`` and ``stop`` on hand-made wavefronts at
granularity 1 and 4 (duplicate heads, truncation, a rescan window that
wraps); ``execute`` under ``single.persistent``, ``single.discrete`` and
``single.megakernel`` (the plain fused drain on CPU tensors) against JAX's
``single.persistent`` cell; a ``max_rounds`` cut, segmented drains and a
JAX drain handed across mid-way; beyond granularity 1 (G = 2, 3, 8;
windows that split; chunks re-queued whole past a tight budget) the
megakernel drain's final queue too, and the body at G = 3 on a hand-made
wavefront (a zero-degree member row, the partial window of vertex n - 1,
duplicate and overlapping chunks, one of them truncated); ``pagerank_bsp`` and
``pagerank_reference``; and the ordered scatter-add's plain version against
a left-to-right numpy loop.

The ranks are held bitwise because the port adds each wavefront's
contributions in update order, as XLA's CPU backend does.  JAX's own
megakernel cell does not run on the installed JAX (ROADMAP C-ref1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.algorithms import pagerank as jpr
from repro.core import ChunkCodec as JCodec
from repro.core import SchedulerConfig as JConfig
from repro.core.scheduler import persistent_drive as j_persistent_drive
from repro.runtime import build_program as j_build
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro.runtime.api import _shared_setup as j_setup
from repro_torch.algorithms import pagerank as tpr
from repro_torch.convert import (graph_from_numpy, pagerank_state_from_numpy,
                                 queue_from_numpy, to_numpy)
from repro_torch.core import (ChunkCodec, SchedulerConfig, WorkCounter,
                              megakernel_drive, megakernel_segment)
from repro_torch.kernels.scatter_add.ops import ordered_scatter_add
from repro_torch.kernels.scatter_add.ref import ordered_scatter_add_ref
from repro_torch.runtime import (build_program, config_for, parse_policy,
                                 policy_of)
from repro_torch.runtime.api import _shared_setup, drain_setup, execute

GRAPHS = {
    "rmat(8,8,1)": (lambda: jg.rmat(8, 8, seed=1),
                    lambda: tg.rmat(8, 8, seed=1, device="cpu")),
    "grid2d(16,16)": (lambda: jg.grid2d(16, 16),
                      lambda: tg.grid2d(16, 16, device="cpu")),
}
STATE_FIELDS = ("rank", "residue", "in_queue", "check_cursor")


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
    for field in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)),
                                      err_msg=field)
    for field in ("work", "splits", "rounds"):
        assert int(getattr(ts.counter, field)) == int(
            getattr(js.counter, field)), field


# --------------------------------------------------------------- init
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("params", [{}, {"seed_count": 37}])
def test_init_state_and_queue_match_jax(graphs, g, params):
    jgraph, tgraph = graphs["rmat(8,8,1)"]
    policy = "single.persistent" + _suffix(g)
    jcfg, tcfg = _configs(policy)
    jq, js, *_ = j_setup(j_build("pagerank", jgraph, jcfg, params), jgraph,
                         jcfg, j_parse(policy), None)
    tq, ts, *_ = _shared_setup(build_program("pagerank", tgraph, tcfg,
                                             params), tgraph, tcfg,
                               policy_of(tcfg), None)
    _assert_state(ts, js)
    for field in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(getattr(tq, field).numpy(),
                                      np.asarray(getattr(jq, field)))
    assert ts.residue.dtype == torch.float32
    assert float(ts.residue[0]) == float(np.float32(1.0 - 0.85))


# ------------------------------------------------ hand-made wavefronts
def _tape(n, g, seed):
    """A wavefront of chunk codes with a duplicate head, EMPTY lanes, and
    a state with residues around eps and scattered presence bits."""
    rng = np.random.default_rng(seed)
    k = 24
    heads = rng.integers(0, n - g, size=k).astype(np.int32)
    heads[5] = heads[2]                                  # duplicate head
    widths = rng.integers(1, g + 1, size=k).astype(np.int32)
    valid = np.ones(k, bool)
    valid[-4:] = False
    state = dict(
        rank=rng.random(n).astype(np.float32),
        residue=(rng.random(n) * 2e-6).astype(np.float32),
        in_queue=rng.random(n) < 0.3,
        check_cursor=np.int32(n - 7),                    # window wraps
    )
    return heads, widths, valid, state


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("budget", ["default", "max_degree"])
def test_body_on_empty_and_stop_match_jax_on_tapes(graphs, g, budget):
    jgraph, tgraph = graphs["rmat(8,8,1)"]
    n = jgraph.num_vertices
    max_degree = int(np.asarray(jgraph.degrees()).max())
    work_budget = None if budget == "default" else max_degree
    heads, widths, valid, st = _tape(n, g, seed=g)
    jcodec, tcodec = JCodec(g), ChunkCodec(g)
    items = np.asarray(jcodec.encode(jnp.asarray(heads), jnp.asarray(widths)))
    items = np.where(valid, items, np.int32(-2 ** 31)).astype(np.int32)
    kw = dict(wavefront=items.shape[0], n_check=40, damping=0.85, eps=1e-6,
              work_budget=work_budget)
    jf, jempty, jstop = jpr.make_wavefront_fns(jgraph, codec=jcodec,
                                               backend="jnp", **kw)
    tf, tempty, tstop = tpr.make_wavefront_fns(tgraph, codec=tcodec,
                                               backend="torch", **kw)
    jstate = jpr.PRState(**{k: jnp.asarray(v) for k, v in st.items()},
                         counter=jpr.WorkCounter.zero())
    tstate = pagerank_state_from_numpy(**st, work=0, splits=0, rounds=0,
                                       device="cpu")
    jout = jf(jnp.asarray(items), jnp.asarray(valid), jstate)
    tout = tf(torch.from_numpy(items), torch.from_numpy(valid), tstate)
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_state(tout[2], jout[2])
    if budget == "max_degree":
        assert int(np.asarray(jout[1])[-items.shape[0]:].sum()) > 0
    jout = jempty(jstate)
    tout = tempty(tstate)
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_state(tout[2], jout[2])
    assert bool(tstop(tstate)) == bool(jstop(jstate))
    done = pagerank_state_from_numpy(**{**st, "residue": st["residue"] * 0},
                                     work=0, splits=0, rounds=0,
                                     device="cpu")
    assert bool(tstop(done)) and not bool(tstop(tstate))


# ------------------------------------------------------ execute vs JAX
_JAX_RUNS: dict = {}


def _jax_run(jgraph, name, g, params, **kw):
    key = (name, g, tuple(sorted(params.items())), tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        jcfg, _ = _configs("single.persistent" + _suffix(g), **kw)
        _JAX_RUNS[key] = j_execute(j_build("pagerank", jgraph, jcfg,
                                           params=params), jgraph, jcfg)
    return _JAX_RUNS[key]


def _run_both(graphs, name, kernel, g, params=None, **kw):
    params = params or {}
    jgraph, tgraph = graphs[name]
    js, jstats, jinfo = _jax_run(jgraph, name, g, params, **kw)
    _, tcfg = _configs(f"single.{kernel}" + _suffix(g), **kw)
    ts, tstats, tinfo = execute(build_program("pagerank", tgraph, tcfg,
                                              params=params), tgraph, tcfg)
    _assert_state(ts, js)
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    launches = 1 if kernel == "megakernel" else jinfo["launches"]
    assert tinfo == {**jinfo, "launches": launches}
    return tinfo, ts


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("kernel", ["persistent", "discrete", "megakernel"])
def test_execute_bit_identical_to_jax_persistent(graphs, graph, g, kernel):
    info, state = _run_both(graphs, graph, kernel, g)
    assert info["dropped"] == 0 and info["rounds"] > 10
    assert float(state.residue.max()) <= 1e-6


@pytest.mark.parametrize("kernel", ["persistent", "megakernel"])
def test_truncation_and_seed_count_match_jax(graphs, kernel):
    """A work budget at the max degree re-queues truncated vertices; a
    small seed count leaves the rest to the rotating rescan."""
    jgraph, _ = graphs["rmat(8,8,1)"]
    max_degree = int(np.asarray(jgraph.degrees()).max())
    _run_both(graphs, "rmat(8,8,1)", kernel, 1,
              {"work_budget": max_degree, "seed_count": 20})


@pytest.mark.parametrize("kernel", ["persistent", "megakernel"])
def test_max_rounds_cut_matches_jax(graphs, kernel):
    info, state = _run_both(graphs, "grid2d(16,16)", kernel, 1,
                            max_rounds=7)
    assert info["rounds"] == 7 and float(state.residue.max()) > 1e-6


@pytest.mark.parametrize("every", [1, 16])
def test_segmented_megakernel_drain_equals_the_whole(graphs, every):
    _, tgraph = graphs["rmat(8,8,1)"]
    cfg = config_for(SchedulerConfig(num_workers=8, fetch_size=2),
                     parse_policy("single.megakernel"))
    program = build_program("pagerank", tgraph, cfg)
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
    for got, ref in zip(to_numpy(carry)[:2], to_numpy(want)[:2]):
        for field in ("buf", "head", "tail") if hasattr(got, "buf") else \
                STATE_FIELDS:
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(ref, field))
    assert int(carry[2]) == int(want[2]) and int(carry[3]) == int(want[3])


@pytest.mark.parametrize("g", [1, 4])
def test_drain_handed_across_mid_way(graphs, g):
    """Five JAX rounds, then the queue and PageRank state cross to the port
    as numpy; the port's rounds continue exactly as JAX's would."""
    jgraph, tgraph = graphs["rmat(8,8,1)"]
    policy = "single.discrete" + _suffix(g)
    jcfg, tcfg = _configs(policy)
    jq, js, _, jstep, _, _ = j_setup(j_build("pagerank", jgraph, jcfg),
                                     jgraph, jcfg, j_parse(policy), None)
    tstep = _shared_setup(build_program("pagerank", tgraph, tcfg), tgraph,
                          tcfg, policy_of(tcfg), None)[3]
    zero = np.int32(0)
    carry = (jq, js, zero, zero)
    for _ in range(5):
        carry = jstep(carry)
    jq, js, jr, jp = carry
    tcarry = (queue_from_numpy(*(np.asarray(x) for x in (
                  jq.buf, jq.head, jq.tail, jq.dropped)), device="cpu"),
              pagerank_state_from_numpy(
                  *(np.asarray(getattr(js, f)) for f in STATE_FIELDS),
                  *(np.asarray(getattr(js.counter, f))
                    for f in ("work", "splits", "rounds")), device="cpu"),
              torch.tensor(int(jr), dtype=torch.int32),
              torch.tensor(int(jp), dtype=torch.int32))
    for _ in range(6):
        carry = jstep(carry)
        tcarry = tstep(tcarry)
        np.testing.assert_array_equal(tcarry[0].buf.numpy(),
                                      np.asarray(carry[0].buf))
        _assert_state(tcarry[1], carry[1])
        assert (int(tcarry[2]), int(tcarry[3])) == (int(carry[2]),
                                                    int(carry[3]))


# ------------- the megakernel beyond granularity 1, final queue included
WIDE = [(2, {}, {}), (3, {}, {}), (8, {}, {}),
        (3, {}, {"split_threshold": 6}),
        (3, {"work_budget": "max_degree"}, {})]


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g,params,fields", WIDE)
def test_wide_megakernel_drain_matches_jax_with_its_queue(graphs, graph, g,
                                                          params, fields):
    """The port's single.megakernel.g<G> plain fused drain against JAX's
    single.persistent.g<G>, both set up by hand so that the final queue
    comes back: state, counters (splits included), rounds, processed and
    the queue, bitwise."""
    jgraph, tgraph = graphs[graph]
    if params.get("work_budget") == "max_degree":
        params = {"work_budget": int(np.asarray(jgraph.degrees()).max())}
    jpolicy = j_parse("single.persistent" + _suffix(g))
    jcfg, tcfg = _configs("single.megakernel" + _suffix(g),
                          "single.persistent" + _suffix(g), **fields)
    jq, js, _, jstep, jcond, _ = j_setup(j_build("pagerank", jgraph, jcfg,
                                                 params=params),
                                         jgraph, jcfg, jpolicy, None)
    jcarry = j_persistent_drive(jstep, jcond,
                                (jq, js, jnp.int32(0), jnp.int32(0)))
    setup = drain_setup(build_program("pagerank", tgraph, tcfg,
                                      params=params), tgraph, tcfg)
    assert setup.kernel is None             # CPU tensors: the plain drain
    tcarry = megakernel_drive(setup.step, setup.cond, setup.carry)
    for field in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(getattr(tcarry[0], field).numpy(),
                                      np.asarray(getattr(jcarry[0], field)),
                                      err_msg=field)
    _assert_state(tcarry[1], jcarry[1])
    assert [int(x) for x in tcarry[2:]] == [int(x) for x in jcarry[2:]]
    assert int(tcarry[0].dropped) == 0
    assert float(tcarry[1].residue.max()) <= 1e-6
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


@pytest.mark.parametrize("threshold", [None, 6])
def test_body_matches_jax_on_a_g3_tape(tape_graph, threshold):
    """The body and on_empty at G = 3: a chunk with a zero-degree member
    row, duplicate heads, chunks that share rows (one of each pair past
    the budget, so its rows stay queued), and a rescan window over the
    partial window of n - 1 with residues above eps."""
    jgraph, tgraph = tape_graph
    g = 3
    n = jgraph.num_vertices
    deg = np.asarray(jgraph.degrees())
    zero = int(np.flatnonzero(deg[1:n - 1] == 0)[0]) + 1
    rng = np.random.default_rng(9)
    heads = np.asarray([zero - 1, 40, 40, 41, 60] + list(
        rng.integers(0, n - g, size=14)) + [61, 0, 0], np.int32)
    widths = np.asarray([3, 2, 3, 3, 2] + list(
        rng.integers(1, g + 1, size=14)) + [3, 1, 1], np.int32)
    jcodec, tcodec = JCodec(g), ChunkCodec(g)
    items = np.asarray(jcodec.encode(jnp.asarray(heads), jnp.asarray(widths)))
    valid = np.ones(items.shape[0], bool)
    valid[-2:] = False
    items = np.where(valid, items, np.int32(-2 ** 31)).astype(np.int32)
    st = dict(rank=rng.random(n).astype(np.float32),
              residue=(rng.random(n) * 4e-6).astype(np.float32),
              in_queue=rng.random(n) < 0.2,
              check_cursor=np.int32(n - 9))      # over n - 1, wraps
    kw = dict(wavefront=items.shape[0], n_check=24, damping=0.85, eps=1e-6,
              work_budget=int(deg.max()) * 2, split_threshold=threshold)
    jf, jempty, _ = jpr.make_wavefront_fns(jgraph, codec=jcodec,
                                           backend="jnp", **kw)
    tf, tempty, _ = tpr.make_wavefront_fns(tgraph, codec=tcodec,
                                           backend="torch", **kw)
    jstate = jpr.PRState(**{k: jnp.asarray(v) for k, v in st.items()},
                         counter=jpr.WorkCounter.zero())
    tstate = pagerank_state_from_numpy(**st, work=0, splits=0, rounds=0,
                                       device="cpu")
    for jout, tout in ((jf(jnp.asarray(items), jnp.asarray(valid), jstate),
                        tf(torch.from_numpy(items), torch.from_numpy(valid),
                           tstate)),
                       (jempty(jstate), tempty(tstate))):
        for got, want in zip(tout[:2], jout[:2]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_state(tout[2], jout[2])
    # some chunks were truncated, and the window of n - 1 pushed
    assert int(np.asarray(jout[1]).sum()) > 0
    body = tf(torch.from_numpy(items), torch.from_numpy(valid), tstate)
    assert bool(body[1][-items.shape[0]:].any())
    if threshold is not None:
        assert int(body[2].counter.splits) > 0
    # row 61: harvested by the chunk (60, 2), still queued by the truncated
    # (61, 3)
    assert float(body[2].rank[61]) != float(st["rank"][61])
    assert bool(body[2].in_queue[61]) and not bool(body[2].in_queue[60])


def test_pagerank_async_driver_matches_jax(graphs):
    jgraph, tgraph = graphs["grid2d(16,16)"]
    jrank, jinfo = jpr.pagerank_async(jgraph, JConfig(num_workers=8),
                                      eps=1e-5)
    trank, tinfo = tpr.pagerank_async(tgraph, SchedulerConfig(num_workers=8),
                                      eps=1e-5)
    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    assert tinfo == jinfo and tinfo["max_residue"] <= 1e-5


# ------------------------------------------------- BSP and the oracle
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_pagerank_bsp_and_reference_match_jax(graphs, graph):
    jgraph, tgraph = graphs[graph]
    jrank, jinfo = jpr.pagerank_bsp(jgraph)
    trank, tinfo = tpr.pagerank_bsp(tgraph)
    np.testing.assert_array_equal(trank.numpy(), np.asarray(jrank))
    assert tinfo == jinfo
    jref = jpr.pagerank_reference(jgraph, iters=60)
    tref = tpr.pagerank_reference(tgraph, iters=60)
    np.testing.assert_array_equal(tref.numpy(), np.asarray(jref))
    # the async ranks lie within the eps contract of the oracle
    _, state = _run_both(graphs, graph, "persistent", 1)
    assert float((state.rank - tpr.pagerank_reference(tgraph)).abs().max()) \
        < 1e-3


# --------------------------------------------- the ordered scatter-add
def _numpy_sequential(base, index, values):
    out = base.copy()
    for i, v in zip(index, values):
        out[i] = np.float32(out[i] + v)
    return out


@pytest.mark.parametrize("case", ["one index 1e5 times", "random"])
def test_ordered_scatter_add_plain_matches_a_left_to_right_loop(case):
    rng = np.random.default_rng(11)
    if case == "one index 1e5 times":
        n, k = 64, 100_000
        index = np.full(k, 5, dtype=np.int32)
        index[::9] = rng.integers(0, n, size=len(index[::9]))
        values = (rng.standard_normal(k)
                  * 10.0 ** rng.integers(-8, 8, size=k)).astype(np.float32)
    else:
        n, k = 1000, 5000
        index = rng.integers(0, n, size=k).astype(np.int32)
        values = rng.random(k).astype(np.float32)
    base = rng.random(n).astype(np.float32)
    want = _numpy_sequential(base, index, values)
    for fn in (ordered_scatter_add_ref, ordered_scatter_add):
        got = fn(torch.from_numpy(base), torch.from_numpy(index),
                 torch.from_numpy(values))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    # the order decides the low bits: a pairwise sum differs here
    if case == "one index 1e5 times":
        pairwise = base[5] + values[index == 5].sum(dtype=np.float32)
        assert pairwise != want[5]


@pytest.mark.parametrize("length", [1, 8, 9, 64, 65, 2048, 2049, 100_000])
def test_ordered_scatter_add_plain_matches_jax_at_every_tier_edge(length):
    """A slot whose segment has ``length`` updates (the CUDA kernel's tier
    edges: thread 8, warp 64, block 2048, merge past it), interleaved with
    updates to other slots at mixed magnitudes, against JAX's
    ``x.at[idx].add(v)`` on the CPU, bit for bit."""
    rng = np.random.default_rng(length)
    n, k = 1000, 2 * length + 100
    index = rng.integers(0, n, size=k)
    index[index == 17] = 18
    index[rng.choice(k, size=length, replace=False)] = 17
    index = index.astype(np.int32)
    values = (rng.standard_normal(k)
              * 10.0 ** rng.integers(-8, 8, size=k)).astype(np.float32)
    base = rng.random(n).astype(np.float32)
    want = np.asarray(jnp.asarray(base).at[jnp.asarray(index)].add(
        jnp.asarray(values)))
    for fn in (ordered_scatter_add_ref, ordered_scatter_add):
        got = fn(torch.from_numpy(base), torch.from_numpy(index),
                 torch.from_numpy(values))
        np.testing.assert_array_equal(got.numpy(), want)


def test_ordered_scatter_add_refuses_cpu_tensors_on_the_cuda_backend():
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    base = torch.zeros(4)
    index = torch.tensor([1, 1], dtype=torch.int32)
    values = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA"):
        ordered_scatter_add_cuda(base, index, values)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ordered_scatter_add(base, index, values, backend="cuda")


def test_unknown_params_and_unported_options_raise(graphs):
    _, tgraph = graphs["grid2d(16,16)"]
    cfg = SchedulerConfig(num_workers=4)
    with pytest.raises(ValueError, match="unknown pagerank params"):
        build_program("pagerank", tgraph, cfg, params={"dampng": 0.8})
    with pytest.raises(NotImplementedError, match="A12"):
        tpr.make_wavefront_fns(tgraph, 4, 8, check_block=(0, 8))
    state, seeds = tpr.init_state(tgraph, seed_count=3)
    assert seeds.tolist() == [0, 1, 2] and int(state.in_queue.sum()) == 3
    assert isinstance(state.counter, WorkCounter)
