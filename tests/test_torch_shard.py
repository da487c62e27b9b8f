"""The port's sharded topology against the JAX package's.

Host math in process (block ownership, the partitioner with and without
the steal halo, the seed split, the donation plan, ``permute_vertices``,
chunk formation at a shard boundary), the legacy raw-``WavefrontFn``
runners, and the 1-shard mesh against JAX's 1-device mesh.  The S-shard
cells -- S in {2, 4, 8} and 2x2 / 2x4 meshes; BFS, PageRank and coloring;
persistent and discrete; strict and deferred; raw and compressed; stealing
on and off; g1 and g4 -- run the reference once, in one subprocess with
eight forced host devices (the ``reference`` fixture), and the port here on
``[cpu] * S`` meshes.

Every cell is held bitwise: the final state (PageRank's float32 rank and
residue included), ``RunStats``/``ShardRunStats`` and every
``ShardCounters`` total, and the discrete driver's legacy trace.  PageRank
is bitwise because the port's ``psum`` adds the shards' deltas in shard
order, the order JAX's CPU all-reduce uses on forced host devices.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.core import SchedulerConfig as JConfig
from repro.runtime import build_program as j_build
from repro_torch.core import SchedulerConfig
from repro_torch.launch.mesh import make_shard_mesh, make_shard_mesh2d
from repro_torch.runtime import build_program
from repro_torch.runtime.api import execute
from repro_torch.shard import run_sharded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# (id, algorithm, graph, S, mesh_shape, persistent, defer, compress,
#  steal_threshold, granularity, num_workers)
CASES = [
    ("bfs-s4", "bfs", "rmat7", 4, None, True, 0, False, 0.0, 1, 32),
    ("bfs-2x2-all", "bfs", "rmat7", 4, (2, 2), True, 1, True, 0.5, 1, 32),
    ("bfs-s2-star-codec-steal-g4", "bfs", "star", 2, None, True, 0, True,
     0.25, 4, 8),
    ("bfs-2x4-discrete-defer-steal", "bfs", "grid", 8, (2, 4), False, 1,
     False, 0.5, 1, 8),
    ("pagerank-s4", "pagerank", "rmat7", 4, None, True, 0, False, 0.0, 1,
     32),
    ("pagerank-2x2-all", "pagerank", "rmat7", 4, (2, 2), True, 1, True, 0.5,
     1, 32),
    ("pagerank-s8-discrete-steal-g4", "pagerank", "grid", 8, None, False, 0,
     False, 0.5, 4, 16),
    ("coloring-s4", "coloring", "rmat7", 4, None, True, 0, False, 0.0, 1,
     32),
    ("coloring-2x2-all", "coloring", "rmat7", 4, (2, 2), True, 1, True, 0.5,
     1, 32),
    ("coloring-s2-star-discrete-defer-g4", "coloring", "star", 2, None,
     False, 1, False, 0.0, 4, 8),
]

#: the reference's counters quoted for rmat(7, 8, seed 2), W = 32, S = 4
PINNED = {
    "bfs-s4": {"rounds": 4, "exchanged": 102},
    "bfs-2x2-all": {"exchanged": 108, "donated": 6},
    "pagerank-s4": {"rounds": 119},
    "pagerank-2x2-all": {"rounds": 114, "donated": 238},
    "coloring-s4": {"rounds": 26},
    "coloring-2x2-all": {"exchanged": 17, "donated": 20},
}

STAT_KEYS = ("rounds", "items_processed", "dropped", "route_dropped",
             "exchanged", "donated", "stolen_executed", "steal_rounds",
             "mis_routed", "exchanged_row", "exchanged_col", "payload_ints",
             "padding_ints", "wire_ints", "deferred_delivered",
             "overlap_rounds")
STAT_ARRAYS = ("per_device_items", "per_device_sent", "per_device_donated",
               "final_sizes")


def _star_edges():
    """A skewed star: hub 0 adjacent to all of 48 vertices, plus a sparse
    ring among the leaves."""
    n = 48
    src = np.concatenate([np.zeros(n - 1, np.int64), np.arange(1, n - 1)])
    dst = np.concatenate([np.arange(1, n), np.arange(2, n)])
    return n, src, dst


def _graphs(pkg):
    n, src, dst = _star_edges()
    if pkg is jg:
        return {"rmat7": jg.rmat(7, edge_factor=8, seed=2),
                "grid": jg.grid2d(8, 8, seed=0),
                "star": jg.from_edges(n, src, dst, symmetrize=True)}
    return {"rmat7": tg.rmat(7, edge_factor=8, seed=2, device="cpu"),
            "grid": tg.grid2d(8, 8, seed=0, device="cpu"),
            "star": tg.from_edges(n, src, dst, symmetrize=True,
                                  device="cpu")}


def _config(case, cls):
    _, _, _, s, shape, persistent, defer, compress, steal, g, w = case
    return cls(num_workers=w, num_shards=s, mesh_shape=shape,
               persistent=persistent, defer_rounds=defer, compress=compress,
               steal_threshold=steal, granularity=g)


def _params(algo):
    return {"source": 0} if algo == "bfs" else {}


def _leaves(state) -> dict:
    """Named numpy leaves of a state (dataclass of arrays / WorkCounter)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for g in dataclasses.fields(v):
                out[f"{f.name}.{g.name}"] = np.asarray(getattr(v, g.name))
        else:
            out[f.name] = np.asarray(v)
    return out


_REFERENCE = """
import dataclasses, json
import numpy as np
import repro.graph as jg
from repro.core import SchedulerConfig
from repro.runtime import build_program
from repro.shard import run_sharded

cases, (n, src, dst), stat_keys, stat_arrays = json.loads({spec!r})
graphs = {{"rmat7": jg.rmat(7, edge_factor=8, seed=2),
          "grid": jg.grid2d(8, 8, seed=0),
          "star": jg.from_edges(n, np.array(src), np.array(dst),
                                symmetrize=True)}}
out, arrays = {{}}, {{}}
for (cid, algo, gname, s, shape, persistent, defer, compress, steal, g,
     w) in cases:
    cfg = SchedulerConfig(num_workers=w, num_shards=s,
                          mesh_shape=tuple(shape) if shape else None,
                          persistent=persistent, defer_rounds=defer,
                          compress=compress, steal_threshold=steal,
                          granularity=g)
    trace = [] if not persistent else None
    params = {{"source": 0}} if algo == "bfs" else {{}}
    state, stats = run_sharded(build_program(algo, graphs[gname], cfg,
                                             params=params),
                               graphs[gname], cfg, trace=trace)
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for h in dataclasses.fields(v):
                arrays[cid + "/" + f.name + "." + h.name] = np.asarray(
                    getattr(v, h.name))
        else:
            arrays[cid + "/" + f.name] = np.asarray(v)
    d = {{k: int(getattr(stats, k)) for k in stat_keys}}
    d.update({{k: np.asarray(getattr(stats, k)).tolist()
              for k in stat_arrays}})
    d["trace"] = trace
    out[cid] = d
np.savez({npz!r}, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    """Start the reference's multi-shard cells in one subprocess with 8
    forced host devices as the module starts, so it runs beside the
    in-process tests; :func:`reference` waits for it."""
    out = tmp_path_factory.mktemp("shard")
    npz = str(out / "states.npz")
    n, src, dst = _star_edges()
    spec = json.dumps([CASES, (n, src.tolist(), dst.tolist()), STAT_KEYS,
                       STAT_ARRAYS])
    prog = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            + textwrap.dedent(_REFERENCE.format(spec=spec, npz=npz)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
        proc = subprocess.Popen([sys.executable, "-c", prog], stdout=so,
                                stderr=se, env=env)
    yield proc, out, npz
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_proc):
    """``(stats and traces by case, state arrays)`` of the reference."""
    proc, out, npz = _reference_proc
    assert proc.wait(timeout=600) == 0, (out / "stderr").read_text()[-3000:]
    stats = json.loads((out / "stdout").read_text().strip().splitlines()[-1])
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    return stats, arrays


def _mesh(cfg):
    devices = [CPU] * cfg.num_shards
    if cfg.mesh_shape is None:
        return make_shard_mesh(cfg.num_shards, devices=devices)
    return make_shard_mesh2d(*cfg.mesh_shape, devices=devices)


@pytest.fixture(scope="module")
def tgraphs():
    return _graphs(tg)


@pytest.mark.parametrize("kernel", ["persistent", "discrete"])
@pytest.mark.parametrize("algo", ["bfs", "coloring"])
def test_execute_sharded_info_matches_jax(algo, kernel):
    """``execute`` on a sharded cell: RunStats and every ``info`` key as
    the reference's 1-shard front door gives them (its 1-device mesh runs
    in this process), state bitwise."""
    from repro.runtime import execute as j_execute

    jgr = jg.rmat(6, edge_factor=8, seed=1)
    tgr = tg.rmat(6, edge_factor=8, seed=1, device="cpu")
    kw = dict(num_workers=16, topology="sharded",
              persistent=kernel == "persistent")
    jcfg, tcfg = JConfig(**kw), SchedulerConfig(**kw)
    jst, jstats, jinfo = j_execute(
        j_build(algo, jgr, jcfg, params=_params(algo)), jgr, jcfg)
    tst, tstats, tinfo = execute(
        build_program(algo, tgr, tcfg, params=_params(algo)), tgr, tcfg,
        mesh=make_shard_mesh(1, devices=[CPU]))
    for k, v in _leaves(tst).items():
        np.testing.assert_array_equal(v, _leaves(jst)[k])
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert tinfo == jinfo


def test_pagerank_one_shard_matches_jax():
    from repro.runtime import execute as j_execute

    jgr = jg.grid2d(6, 6, seed=0)
    tgr = tg.grid2d(6, 6, seed=0, device="cpu")
    kw = dict(num_workers=8, topology="sharded", granularity=2)
    jcfg, tcfg = JConfig(**kw), SchedulerConfig(**kw)
    jst, jstats, jinfo = j_execute(j_build("pagerank", jgr, jcfg), jgr, jcfg)
    tst, tstats, tinfo = execute(build_program("pagerank", tgr, tcfg), tgr,
                                 tcfg, mesh=make_shard_mesh(1, devices=[CPU]))
    for k, v in _leaves(tst).items():
        np.testing.assert_array_equal(v, _leaves(jst)[k])
    assert tinfo == jinfo


def test_sharded_bfs_equals_single_drain_and_bsp(tgraphs):
    """BFS distances are exact on any schedule: every mesh gives the
    single drain's ``dist``."""
    from repro_torch.algorithms.bfs import bfs_bsp

    g = tgraphs["rmat7"]
    want, _ = bfs_bsp(g, 0)
    for kw in (dict(num_shards=2),
               dict(num_shards=8, mesh_shape=(4, 2), defer_rounds=1,
                    steal_threshold=0.5)):
        cfg = SchedulerConfig(num_workers=32, **kw)
        state, stats = run_sharded(
            build_program("bfs", g, cfg, params={"source": 0}), g, cfg,
            mesh=_mesh(cfg))
        assert torch.equal(state.dist, want)
        assert stats.mis_routed == 0


# ------------------------------------------------------------ host math
@pytest.mark.parametrize("n,s", [(0, 1), (1, 4), (10, 3), (64, 8), (100, 7),
                                 (129, 4)])
def test_block_ownership_matches_jax(n, s):
    from repro.shard import partition as J
    from repro_torch.shard import partition as T

    assert T.block_size(n, s) == J.block_size(n, s)
    for d in range(s):
        assert T.block_bounds(d, n, s) == J.block_bounds(d, n, s)
    if n:
        vids = np.arange(n, dtype=np.int32)
        assert np.array_equal(T.owner_of(torch.as_tensor(vids), n, s).numpy(),
                              np.asarray(J.owner_of(vids, n, s)))
        for rows, cols in ((1, s), (s, 1)):
            got = T.owner_coords(torch.as_tensor(vids), n, rows, cols)
            want = J.owner_coords(vids, n, rows, cols)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("gname", ["rmat7", "star"])
def test_partition_matches_jax(gname, s, halo, tgraphs):
    from repro.shard.partition import partition_graph as j_partition
    from repro_torch.shard.partition import partition_graph

    jp = j_partition(_graphs(jg)[gname], s, halo=halo)
    tp = partition_graph(tgraphs[gname], s, halo=halo, devices=[CPU] * s)
    assert (tp.num_shards, tp.num_vertices, tp.halo, tp.edges_per_shard) == \
        (jp.num_shards, jp.num_vertices, jp.halo, jp.edges_per_shard)
    for d in range(s):
        assert np.array_equal(tp.row_ptr[d].numpy(), np.asarray(jp.row_ptr[d]))
        cols = tp.col_idx[d].numpy()
        jcols = np.asarray(jp.col_idx[d])
        stored = tp.col_idx[d].shape[0]
        assert np.array_equal(cols[:stored], jcols[:stored])
        local = tp.local(d)
        assert local.num_vertices == tp.num_vertices


def test_split_seeds_and_plan_donations_match_jax():
    from repro.shard import partition as JP
    from repro.shard.steal import plan_donations as j_plan
    from repro_torch.core.task import ChunkCodec
    from repro_torch.shard import partition as TP
    from repro_torch.shard.steal import plan_donations

    rng = np.random.default_rng(4)
    seeds = rng.integers(1, 200, 57).astype(np.int32)
    for s in (1, 3, 8):
        for tv in (None, "coloring"):
            jtv = ttv = None
            if tv:
                codec = ChunkCodec(4)
                ttv = lambda t: codec.head(t.abs() - 1)  # noqa: E731
                jtv = lambda t: (np.abs(np.asarray(t)) - 1) >> 2  # noqa: E731
            got = TP.split_seeds(seeds, 250, s, task_vertex=ttv)
            want = JP.split_seeds(seeds, 250, s, task_vertex=jtv)
            assert all(np.array_equal(a, np.asarray(b))
                       for a, b in zip(got, want))
    for trial in range(24):
        s = int(rng.integers(1, 9))
        sizes = rng.integers(0, 300, s).astype(np.int32)
        if trial % 3 == 0:
            sizes[:] = 7
        thr = float(rng.choice([0.0, 0.25, 0.5, 1.0, 3.0]))
        chunk = int(rng.choice([1, 8, 64]))
        assert np.array_equal(
            plan_donations(torch.as_tensor(sizes), thr, chunk).numpy(),
            np.asarray(j_plan(sizes, thr, chunk)))


def test_chunk_formation_at_owner_blocks_matches_jax():
    """``chunk_seeds`` and ``coalesce_chunks`` never form a chunk across a
    shard block, as the reference's."""
    import jax.numpy as jnp

    from repro.core import task as J
    from repro_torch.core import task as T

    g = tg.rmat(7, edge_factor=8, seed=2, device="cpu")
    rp = g.row_ptr.numpy()
    rng = np.random.default_rng(2)
    for gran, ob, thr in ((4, 13, None), (8, 32, 40), (16, 50, None)):
        vids = np.sort(rng.choice(128, 90, replace=False))
        got = T.chunk_seeds(vids, T.ChunkCodec(gran), rp, split_threshold=thr,
                            owner_block=ob)
        want = J.chunk_seeds(vids, J.ChunkCodec(gran), rp,
                             split_threshold=thr, owner_block=ob)
        assert np.array_equal(got, np.asarray(want))
        cand = rng.integers(0, 128, 200).astype(np.int32)
        mask = rng.random(200) < 0.6
        t = T.coalesce_chunks(torch.as_tensor(cand), torch.as_tensor(mask),
                              T.ChunkCodec(gran), g.row_ptr,
                              split_threshold=thr, owner_block=ob)
        j = J.coalesce_chunks(jnp.asarray(cand), jnp.asarray(mask),
                              J.ChunkCodec(gran), jnp.asarray(rp),
                              split_threshold=thr, owner_block=ob)
        for a, b in zip(t, j):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_permute_vertices_matches_jax():
    from repro.graph.csr import permute_vertices as j_permute
    from repro_torch.graph import permute_vertices

    perm = np.random.default_rng(3).permutation(128)
    got = permute_vertices(tg.rmat(7, edge_factor=8, seed=2, device="cpu"),
                           perm)
    want = j_permute(jg.rmat(7, edge_factor=8, seed=2), perm)
    assert np.array_equal(got.row_ptr.numpy(), np.asarray(want.row_ptr))
    assert np.array_equal(got.col_idx.numpy(), np.asarray(want.col_idx))
    assert got.device == CPU


# -------------------------------------------------------------- meshes
def test_make_shard_mesh_needs_gpus_or_explicit_devices():
    """Without ``devices=`` a mesh takes one card a shard and raises where
    fewer are visible, naming ``devices=``; it never stacks shards on one
    device by itself."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this host has four cards: make_shard_mesh(4) works")
    with pytest.raises(RuntimeError, match="devices="):
        make_shard_mesh(4)
    with pytest.raises(RuntimeError, match="devices="):
        make_shard_mesh2d(2, 2)
    g = tg.grid2d(3, 3, device="cpu")
    cfg = SchedulerConfig(num_workers=2, num_shards=4)
    with pytest.raises(RuntimeError, match="devices="):
        execute(build_program("bfs", g, cfg), g, cfg)
    mesh = make_shard_mesh2d(2, 2, devices=[CPU] * 4)
    assert mesh.dims == (2, 2) and mesh.size == 4
    with pytest.raises(ValueError, match="4 devices"):
        make_shard_mesh(4, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="mesh_shape"):
        run_sharded(build_program("bfs", g, cfg), g,
                    dataclasses.replace(cfg, mesh_shape=(2, 4)), mesh=mesh)


# ------------------------------------------------------- legacy runners
def _bfs_fns(g_j, g_t):
    from repro.algorithms import bfs as JB
    from repro_torch.algorithms import bfs as TB

    jf = JB.make_wavefront_fn(g_j, "merge_path", 256, 16)
    tf = TB.make_wavefront_fn(g_t, "merge_path", 256, 16)
    return (jf, JB.init_state(g_j, 0)), (tf, TB.init_state(g_t, 0))


@pytest.mark.parametrize("strategy", ["persistent", "discrete",
                                      "megakernel"])
def test_legacy_run_dispatches_like_jax(strategy):
    """``core.scheduler.run`` routes each strategy as the reference's does,
    bitwise on BFS; JAX's own megakernel fails on JAX 0.9 (ROADMAP
    C-ref1), so the megakernel is held against its persistent run, which
    it equals by construction."""
    from repro.core import scheduler as JS
    from repro.core.queue import make_queue as j_queue
    from repro_torch.core import scheduler as TS
    from repro_torch.core.queue import make_queue as t_queue

    g_j = jg.rmat(6, edge_factor=8, seed=1)
    g_t = tg.rmat(6, edge_factor=8, seed=1, device="cpu")
    (jf, js), (tf, ts) = _bfs_fns(g_j, g_t)
    kw = dict(num_workers=8, persistent=strategy != "discrete",
              kernel="megakernel" if strategy == "megakernel" else "auto")
    jcfg = JConfig(**dict(kw, kernel="auto"))
    tcfg = SchedulerConfig(**kw)
    jq, jst, jstats = JS.run(jf, j_queue(256, np.array([0])), js, jcfg)
    tq, tst, tstats = TS.run(tf, t_queue(256, [0], device="cpu"), ts, tcfg)
    assert np.array_equal(tst.dist.numpy(), np.asarray(jst.dist))
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert np.array_equal(tq.buf.numpy(), np.asarray(jq.buf))
    assert int(tst.counter.work) == int(jst.counter.work)


def test_legacy_runners_match_jax_bitwise():
    """``persistent_run``, ``discrete_run`` (with its trace), a ``stop``
    and an ``on_empty`` refill, and ``partial_step`` stepping by hand."""
    from repro.core import scheduler as JS
    from repro.core.queue import make_queue as j_queue
    from repro_torch.core import scheduler as TS
    from repro_torch.core.queue import make_queue as t_queue

    g_j = jg.grid2d(6, 6, seed=0)
    g_t = tg.grid2d(6, 6, seed=0, device="cpu")
    (jf, js), (tf, ts) = _bfs_fns(g_j, g_t)
    jcfg, tcfg = JConfig(num_workers=4), SchedulerConfig(num_workers=4)
    for kw in ({}, {"stop": "work"}):
        jstop = tstop = None
        if kw:
            jstop = lambda s: s.counter.work >= 9  # noqa: E731
            tstop = lambda s: s.counter.work >= 9  # noqa: E731
        jout = JS.persistent_run(jf, j_queue(128, np.array([0])), js, jcfg,
                                 stop=jstop)
        tout = TS.persistent_run(tf, t_queue(128, [0], device="cpu"), ts,
                                 tcfg, stop=tstop)
        assert np.array_equal(tout[1].dist.numpy(), np.asarray(jout[1].dist))
        assert [int(x) for x in tout[2]] == [int(x) for x in jout[2]]
    jtrace, ttrace = [], []
    jout = JS.discrete_run(jf, j_queue(128, np.array([0, 5])), js, jcfg,
                           trace=jtrace)
    tout = TS.discrete_run(tf, t_queue(128, [0, 5], device="cpu"), ts, tcfg,
                           trace=ttrace)
    assert np.array_equal(tout[1].dist.numpy(), np.asarray(jout[1].dist))
    assert [int(x) for x in tout[2]] == [int(x) for x in jout[2]]
    assert ttrace == jtrace
    # an on_empty refill without a declaration drops the queue-size term
    assert TS.resolve_empty_means_done(lambda s: s, None) is False
    assert TS.resolve_empty_means_done(None, None) is True
    # partial_step: three hand-driven rounds
    jstep = JS.partial_step(jf, None, jcfg)
    tstep = TS.partial_step(tf, None, tcfg)
    jc = (j_queue(128, np.array([0])), js, 0, 0)
    tc = (t_queue(128, [0], device="cpu"), ts,
          torch.zeros((), dtype=torch.int32),
          torch.zeros((), dtype=torch.int32))
    for _ in range(3):
        jc, tc = jstep(jc), tstep(tc)
        assert np.array_equal(tc[1].dist.numpy(), np.asarray(jc[1].dist))
        assert [int(tc[2]), int(tc[3])] == [int(jc[2]), int(jc[3])]


@pytest.mark.parametrize("strategy", ["megakernel", "persistent",
                                      "discrete"])
def test_legacy_run_on_coloring_matches_jax(strategy):
    """``run`` on coloring under each strategy (JAX's coloring megakernel
    runs on JAX 0.9): colors and RunStats bitwise."""
    from repro.algorithms import coloring as JC
    from repro.core import scheduler as JS
    from repro.core.queue import make_queue as j_queue
    from repro_torch.algorithms import coloring as TC
    from repro_torch.core import scheduler as TS
    from repro_torch.core.queue import make_queue as t_queue

    g_j = jg.rmat(5, edge_factor=4, seed=3)
    g_t = tg.rmat(5, edge_factor=4, seed=3, device="cpu")
    jf = JC.make_wavefront_fn(g_j)
    tf = TC.make_wavefront_fn(g_t, TC.flat_budget(g_t, 8))
    js, jseeds = JC.init_state(g_j)
    ts, tseeds = TC.init_state(g_t)
    kw = dict(num_workers=8, persistent=strategy != "discrete",
              kernel="megakernel" if strategy == "megakernel" else "auto")
    _, jst, jstats = JS.run(jf, j_queue(256, jseeds), js, JConfig(**kw))
    _, tst, tstats = TS.run(tf, t_queue(256, tseeds, device="cpu"), ts,
                            SchedulerConfig(**kw))
    assert np.array_equal(tst.colors.numpy(), np.asarray(jst.colors))
    assert [int(x) for x in tstats] == [int(x) for x in jstats]


# ------------------------------------- the multi-shard cells, last
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_cell_matches_jax_bitwise(case, reference, tgraphs):
    cid, algo, gname = case[:3]
    want_stats, want_arrays = reference
    want = want_stats[cid]
    g = tgraphs[gname]
    cfg = _config(case, SchedulerConfig)
    trace = [] if not cfg.persistent else None
    state, stats = run_sharded(
        build_program(algo, g, cfg, params=_params(algo)), g, cfg,
        mesh=_mesh(cfg), trace=trace)
    for k, v in _leaves(state).items():
        np.testing.assert_array_equal(v, want_arrays[f"{cid}/{k}"],
                                      err_msg=f"{cid}: state {k}")
    got = {k: int(getattr(stats, k)) for k in STAT_KEYS}
    got.update({k: np.asarray(getattr(stats, k)).tolist()
                for k in STAT_ARRAYS})
    assert got == {k: want[k] for k in got}, cid
    assert trace == want["trace"]
    for k, v in PINNED.get(cid, {}).items():
        assert got[k] == v, (cid, k)
    doc = stats.as_dict()          # the canonical shard_run doc validates
    assert doc["kind"] == "shard_run" and doc["rounds"] == got["rounds"]
    assert stats.mis_routed == 0 and stats.dropped == 0
    assert stats.route_dropped == 0
    if cfg.steal_threshold > 0 and algo != "bfs":
        assert stats.donated > 0
