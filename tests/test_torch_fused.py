"""The fused topology (ROADMAP A7) on the CPU: every ``fused.{persistent,
discrete, megakernel}`` cell of BFS, PageRank and coloring at granularity
1, 2 and 4 equals the port's ``single`` cell -- state, counters, RunStats
and info -- and the final lane is the single queue packed; the port's
fused persistent and discrete cells equal JAX's, final MultiQueue
included, and coloring's fused megakernel equals JAX's (which runs on JAX
0.9, ROADMAP C-ref1).  Admission is checked at the config's granularity
and raises before any drain where the packed payload would not hold the
chunk codes (ROADMAP C-ref6)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.graph as jg
from repro.core import SchedulerConfig as JConfig
from repro.core.scheduler import persistent_drive as j_persistent_drive
from repro.runtime import build_program as j_build
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro.runtime.api import _shared_setup as j_setup
from repro_torch.convert import graph_from_numpy
from repro_torch.core import MultiQueue, SchedulerConfig, persistent_drive
from repro_torch.core.tree import to_numpy, tree_map
from repro_torch.graph import grid2d
from repro_torch.runtime import build_program, config_for, parse_policy
from repro_torch.runtime.api import drain_setup, execute
from repro_torch.server.encoding import unpack_natural

ALGOS = {"bfs": {"source": 3}, "pagerank": {"eps": 1e-5},
         "coloring": None}
KERNELS = ("persistent", "discrete", "megakernel")


@pytest.fixture(scope="module")
def graphs():
    jgraph = jg.rmat(7, 8, seed=3)
    return jgraph, graph_from_numpy(np.asarray(jgraph.row_ptr),
                                    np.asarray(jgraph.col_idx), device="cpu")


def _policy(topology, kernel, g):
    return f"{topology}.{kernel}" + ("" if g == 1 else f".g{g}")


def _config(policy, jax=False, **kw):
    base = dict(num_workers=8, fetch_size=2, **kw)
    if jax:
        return j_config_for(JConfig(**base), j_parse(policy))
    return config_for(SchedulerConfig(**base), parse_policy(policy))


def _leaves(tree):
    out = []
    tree_map(lambda t: out.append(t.numpy()), tree)
    return out


def _assert_tree(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("algo", list(ALGOS))
def test_fused_cell_equals_single_cell(graphs, algo, kernel, g):
    _, graph = graphs
    params = ALGOS[algo]
    results = {}
    for topology in ("single", "fused"):
        cfg = _config(_policy(topology, kernel, g))
        program = build_program(algo, graph, cfg, params=params)
        results[topology] = execute(program, graph, cfg)
    (ss, sst, sinfo), (fs, fst, finfo) = results["single"], results["fused"]
    _assert_tree(fs, ss)
    assert [int(x) for x in fst] == [int(x) for x in sst]
    assert finfo == sinfo and sinfo["rounds"] > 1 and sinfo["dropped"] == 0


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_fused_lane_is_the_single_queue_packed(graphs, algo, g):
    """Drains set up by hand: the fused carry's lane unpacks (live slots)
    to the single queue, with equal cursors, and the pointer stays 0."""
    _, graph = graphs
    params = ALGOS[algo]
    carries = {}
    for topology in ("single", "fused"):
        cfg = _config(_policy(topology, "persistent", g))
        setup = drain_setup(build_program(algo, graph, cfg, params=params),
                            graph, cfg)
        carries[topology] = persistent_drive(setup.step, setup.cond,
                                             setup.carry)
    sq, fq = carries["single"][0], carries["fused"][0]
    assert isinstance(fq, MultiQueue) and fq.num_lanes == 1
    lane = fq.lane(0)
    for name in ("head", "tail", "dropped"):
        assert int(getattr(lane, name)) == int(getattr(sq, name)), name
    cap = sq.capacity
    live = ((torch.arange(cap) - sq.head) % cap) < sq.size
    assert int(live.sum()) > 0 or int(sq.size) == 0
    assert torch.equal(unpack_natural(lane.buf)[live], sq.buf[live])
    assert int(fq.rr) == 0
    _assert_tree(carries["fused"][1:], carries["single"][1:])


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("algo", list(ALGOS))
def test_fused_cells_match_jax(graphs, algo, g):
    """The port's fused persistent and discrete cells against JAX's: state,
    RunStats and info; and the final MultiQueue of the persistent drain,
    set up by hand on both sides."""
    jgraph, graph = graphs
    params = ALGOS[algo]
    for kernel in ("persistent", "discrete"):
        policy = _policy("fused", kernel, g)
        jcfg, cfg = _config(policy, jax=True), _config(policy)
        js, jstats, jinfo = j_execute(j_build(algo, jgraph, jcfg, params),
                                      jgraph, jcfg)
        ts, tstats, tinfo = execute(build_program(algo, graph, cfg, params),
                                    graph, cfg)
        got, want = _leaves(ts), jax.tree.leaves(js)
        assert len(got) == len(want)
        for x, y in zip(got, want):
            np.testing.assert_array_equal(x, np.asarray(y))
        assert [int(x) for x in tstats] == [int(x) for x in jstats]
        assert tinfo == jinfo
    policy = _policy("fused", "persistent", g)
    jcfg, cfg = _config(policy, jax=True), _config(policy)
    jq, js, _, jstep, jcond, _ = j_setup(j_build(algo, jgraph, jcfg, params),
                                         jgraph, jcfg, j_parse(policy), None)
    jcarry = j_persistent_drive(jstep, jcond,
                                (jq, js, np.int32(0), np.int32(0)))
    setup = drain_setup(build_program(algo, graph, cfg, params), graph, cfg)
    tcarry = persistent_drive(setup.step, setup.cond, setup.carry)
    tq, jq = tcarry[0], jcarry[0]
    for name in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(getattr(tq.lanes, name).numpy(),
                                      np.asarray(getattr(jq.lanes, name)))
    assert int(tq.rr) == int(jq.rr)
    assert [int(x) for x in tcarry[2:]] == [int(x) for x in jcarry[2:]]


@pytest.mark.parametrize("g", [1, 4])
def test_coloring_fused_megakernel_matches_jax(graphs, g):
    jgraph, graph = graphs
    policy = _policy("fused", "megakernel", g)
    jcfg, cfg = _config(policy, jax=True), _config(policy)
    js, jstats, jinfo = j_execute(j_build("coloring", jgraph, jcfg), jgraph,
                                  jcfg)
    ts, tstats, tinfo = execute(build_program("coloring", graph, cfg),
                                graph, cfg)
    np.testing.assert_array_equal(ts.colors.numpy(), np.asarray(js.colors))
    for field in ("work", "splits", "rounds"):
        assert int(getattr(ts.counter, field)) == int(
            getattr(js.counter, field))
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert tinfo == jinfo == {**tinfo, "launches": 1}


@pytest.mark.parametrize("kernel", KERNELS)
def test_admission_raises_at_the_configs_granularity(kernel):
    """grid2d(375, 375), 140,625 vertices: its chunk codes fit at g32 and
    not at g64, where the reference's fused cell (checking at g1) would
    corrupt tasks silently.  The port raises before any body is built;
    the single cell at g64 is unaffected."""
    graph = grid2d(375, 375, device="cpu")
    built = []
    for g, fits in ((32, True), (64, False)):
        cfg = _config(_policy("fused", kernel, g), max_rounds=2)
        program = build_program("bfs", graph, cfg, params={"source": 0})
        make_body = program.make_body

        def spy(*args, _make=make_body):
            built.append(g)
            return _make(*args)

        program = dataclasses.replace(program, make_body=spy)
        if fits:
            _, _, info = execute(program, graph, cfg)
            assert info["rounds"] == 2
        else:
            with pytest.raises(ValueError, match="granularity 64"):
                execute(program, graph, cfg)
    assert built == [32]
    cfg = _config(_policy("single", kernel, 64), max_rounds=2)
    _, _, info = execute(build_program("bfs", graph, cfg,
                                       params={"source": 0}), graph, cfg)
    assert info["rounds"] == 2


def test_fused_carry_converts_to_numpy(graphs):
    """A fused carry is a plain tree: ``to_numpy`` hands it across."""
    _, graph = graphs
    cfg = _config("fused.discrete")
    setup = drain_setup(build_program("bfs", graph, cfg, {"source": 3}),
                        graph, cfg)
    lanes = to_numpy(setup.carry[0]).lanes
    assert lanes.buf.shape == (1, setup.carry[0].capacity)
    assert int(lanes.tail[0]) == 1 and int(setup.dropped(setup.carry[0])) == 0


@pytest.mark.parametrize("quota,vertex", [(None, False), (5, False),
                                          (9, True), (0, True)])
def test_fused_lane_ops_match_jax(quota, vertex):
    """``fused_lane_ops`` with its full signature, the task server's form:
    a slot or vertex quota (``task_width``), ``aux``'s mismatch and vertex
    counts over a lane that mixes two tenants, and the packed push."""
    import jax.numpy as jnp

    from repro.core.queue import make_multiqueue as j_make_multiqueue
    from repro.runtime.api import fused_lane_ops as j_fused_lane_ops
    from repro.server.encoding import pack as j_pack
    from repro_torch.core import make_multiqueue
    from repro_torch.runtime.api import fused_lane_ops
    from repro_torch.server.encoding import pack

    rng = np.random.default_rng(7)
    naturals = rng.integers(-(1 << 12), 1 << 12, size=24).astype(np.int32)
    jobs = np.where(rng.random(24) < 0.8, 1, 0).astype(np.int32)
    width = (lambda t: (t & 3) + 1) if vertex else None
    tq = make_multiqueue(32, 2, device="cpu").push(
        1, pack(torch.from_numpy(jobs), torch.from_numpy(naturals)),
        torch.ones(24, dtype=torch.bool))
    jq = j_make_multiqueue(32, 2).push(
        1, j_pack(jnp.asarray(jobs), jnp.asarray(naturals)),
        jnp.ones(24, bool))
    taux, jaux = {}, {}
    tops = fused_lane_ops(8, "torch", lane_id=1, job_id=1, quota=quota,
                          aux=taux, task_width=width)
    jops = j_fused_lane_ops(8, "jnp", lane_id=1, job_id=1, quota=quota,
                            aux=jaux, task_width=width)
    ti, tv, tq = tops.pop(tq)
    ji, jv, jq = jops.pop(jq)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert {k: int(v) for k, v in taux.items()} == \
        {k: int(v) for k, v in jaux.items()}
    mask = np.array([True, False] * 4)
    tq = tops.push(tq, ti, torch.from_numpy(mask))
    jq = jops.push(jq, ji, jnp.asarray(mask))
    for name in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(getattr(tq.lanes, name).numpy(),
                                      np.asarray(getattr(jq.lanes, name)))
    assert int(tops.size(tq)) == int(jops.size(jq))
