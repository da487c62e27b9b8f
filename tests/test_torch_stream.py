"""The port's streaming subsystem (``repro_torch.stream``, ROADMAP A9)
against JAX's.

Inputs are made with numpy from a seed and handed to both packages:

  * the delta layer (``make_delta``, ``symmetrized``, the reference
    ``apply_delta`` and ``replay``, ``edge_delta_stream``) over several
    seeds and insert fractions;
  * each dirty-seed rule (BFS tight and conservative, PageRank's
    invariant restoration and decay, coloring's conflicts) on the same
    ``AppliedDelta`` and state: the same state (PageRank's float32 rank
    and residue included) and seeds;
  * ``stream_execute`` on single/fused x persistent/discrete x g1/g4: the
    result, the final state, the batch records (all but their host
    seconds) and ``info``; the port's megakernel cells (the plain fused
    drain on the CPU) against JAX's persistent cells (JAX's own megakernel
    stream does not run on its installed version); trace rows against
    JAX's;
  * incremental streams against cold drains within the port, snapshots
    resumed in-process (the sharded stream is held in
    ``test_torch_shard_stream.py``).

All bitwise, except PageRank against a cold drain (within 10 eps, the
reference's contract).
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import repro.graph.generators as jgen
import repro.obs as jobs
import repro_torch.graph as tg
from repro.core import ChunkCodec as JCodec
from repro.core import SchedulerConfig as JConfig
from repro.graph import SlottedCSR as JSlotted
from repro.runtime import build_program as j_build
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro.runtime import stream_execute as j_stream
from repro.stream import apply_delta as j_apply_delta
from repro.stream import commit as j_commit
from repro.stream import incremental as jinc
from repro.stream import make_delta as j_make_delta
from repro.stream import replay as j_replay
from repro.stream import symmetrized as j_symmetrized
from repro_torch.algorithms.coloring import validate_coloring
from repro_torch.convert import (bfs_state_from_numpy, coloring_state_from_numpy,
                                 graph_from_numpy, pagerank_state_from_numpy)
from repro_torch.core import ChunkCodec, SchedulerConfig
from repro_torch.core.counters import WorkCounter
from repro_torch.graph.slotted import SlottedCSR
from repro_torch.obs import Trace
from repro_torch.runtime import (build_program, config_for, execute,
                                 parse_policy, stream_execute)
from repro_torch.stream import (apply_delta, commit, incremental, make_delta,
                                replay, symmetrized)

SEEDS = [0, 1, 2]
FRACS = [0.0, 0.3, 0.5, 1.0]


def _port_graph(jgraph):
    return graph_from_numpy(np.asarray(jgraph.row_ptr),
                            np.asarray(jgraph.col_idx), device="cpu")


def _delta_equal(t, j):
    assert t.num_vertices == j.num_vertices
    for f in ("src", "dst", "insert"):
        got, want = getattr(t, f), getattr(j, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------- deltas
@pytest.mark.parametrize("seed", SEEDS)
def test_make_delta_and_symmetrized_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 30
    src, dst = rng.integers(0, n, 60), rng.integers(0, n, 60)
    keep = src != dst
    ins = rng.random(60) < 0.5
    t = make_delta(n, src[keep], dst[keep], ins[keep])
    j = j_make_delta(n, src[keep], dst[keep], ins[keep])
    _delta_equal(t, j)
    _delta_equal(symmetrized(t), j_symmetrized(j))
    for bad in ((n, [0], [0], [True]), (n, [0], [n], [True]),
                (n, [0, 1], [1], [True])):
        with pytest.raises(ValueError):
            make_delta(*bad)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("frac", FRACS)
def test_edge_delta_stream_and_replay_match_jax(seed, frac):
    """The generator's batches bit for bit, and the reference commit path
    (``apply_delta`` on a CSR, then ``replay``) on them."""
    jbase = jgen.rmat(7, edge_factor=4, seed=seed)
    tbase = _port_graph(jbase)
    jd = jgen.edge_delta_stream(jbase, 4, 40, seed=seed + 3,
                                insert_frac=frac)
    td = tg.edge_delta_stream(tbase, 4, 40, seed=seed + 3, insert_frac=frac)
    assert len(td) == len(jd)
    for t, j in zip(td, jd):
        _delta_equal(t, j)
    ja, ta = j_apply_delta(jbase, jd[0]), apply_delta(tbase, td[0])
    for f in ("ins_src", "ins_dst", "del_src", "del_dst"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    jr, tr = j_replay(jbase, jd), replay(tbase, td)
    np.testing.assert_array_equal(tr.row_ptr.numpy(), np.asarray(jr.row_ptr))
    np.testing.assert_array_equal(tr.col_idx.numpy(), np.asarray(jr.col_idx))
    with pytest.raises(ValueError, match="vertices"):
        apply_delta(tbase, make_delta(3, [0], [1], [True]))


# ----------------------------------------------------- dirty-seed rules
CODEC_CASES = [(1, None), (4, None), (4, 24)]


def _state_equal(t, j, msg=""):
    """A port state dataclass against JAX's, field by field."""
    for f in dataclasses.fields(t):
        got, want = getattr(t, f.name), getattr(j, f.name)
        if isinstance(got, WorkCounter):
            for g in ("work", "splits", "rounds"):
                assert int(getattr(got, g)) == int(getattr(want, g)), \
                    f"{msg} {f.name}.{g}"
            continue
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype, f"{msg} {f.name}"
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{msg} {f.name}")


def _commit_both(jbase, delta, every=0):
    """One slotted commit of ``delta`` in both packages."""
    js = JSlotted.from_csr(jbase)
    ts = SlottedCSR.from_csr(_port_graph(jbase))
    td = make_delta(delta.num_vertices, delta.src, delta.dst, delta.insert)
    return j_commit(js, delta, 1, every), commit(ts, td, 1, every)


def _jax_drain(algo, jgraph, params):
    jcfg = j_config_for(JConfig(num_workers=8), j_parse("single.persistent"))
    return j_execute(j_build(algo, jgraph, jcfg, params=params), jgraph,
                     jcfg).state


@pytest.mark.parametrize("g,threshold", CODEC_CASES)
@pytest.mark.parametrize("rule", ["tight", "conservative"])
def test_bfs_rules_match_jax(rule, g, threshold):
    jbase = jgen.rmat(7, edge_factor=6, seed=4)
    js0 = _jax_drain("bfs", jbase, {"source": 3})
    deltas = jgen.edge_delta_stream(jbase, 3, 48, seed=6, insert_frac=0.3)
    for d in deltas:
        ja, ta = _commit_both(jbase, d)
        jrule = getattr(jinc, "bfs_dirty_seeds" if rule == "tight"
                        else "bfs_dirty_seeds_conservative")
        trule = getattr(incremental, "bfs_dirty_seeds" if rule == "tight"
                        else "bfs_dirty_seeds_conservative")
        jstate, jseeds = jrule(ja, js0, codec=JCodec(g),
                               split_threshold=threshold, owner_block=None)
        tstate, tseeds = trule(ta, bfs_state_from_numpy(
            np.asarray(js0.dist), *(np.asarray(getattr(js0.counter, f))
                                    for f in ("work", "splits", "rounds")),
            device="cpu"), codec=ChunkCodec(g), split_threshold=threshold)
        _state_equal(tstate, jstate, rule)
        np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds))
        jbase = ja.csr()


def test_bfs_tight_rule_falls_back_on_an_asymmetric_graph():
    """A directed delete drops the symmetry flag: both packages take the
    conservative rule, with the same state and seeds."""
    jbase = jgen.grid2d(6, 6)
    js0 = _jax_drain("bfs", jbase, {"source": 0})
    d = j_make_delta(36, [0], [1], [False])
    ja, ta = _commit_both(jbase, d)
    assert not ta.slotted.symmetric and not ja.slotted.symmetric
    jstate, jseeds = jinc.bfs_dirty_seeds(ja, js0, codec=JCodec(1),
                                          split_threshold=None,
                                          owner_block=None)
    tstate, tseeds = incremental.bfs_dirty_seeds(
        ta, bfs_state_from_numpy(np.asarray(js0.dist), 0, 0, 0,
                                 device="cpu"),
        codec=ChunkCodec(1), split_threshold=None)
    np.testing.assert_array_equal(tstate.dist.numpy(),
                                  np.asarray(jstate.dist))
    np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds))


@pytest.mark.parametrize("g,threshold", CODEC_CASES)
def test_pagerank_rule_matches_jax(g, threshold):
    """Invariant restoration and the negative-residue decay over only the
    negative rows' out-edges: float32 rank and residue bit for bit."""
    jbase = jgen.rmat(7, edge_factor=6, seed=8)
    js0 = _jax_drain("pagerank", jbase, None)
    sweeps = []
    for frac in (0.0, 0.5):
        d = jgen.edge_delta_stream(jbase, 1, 64, seed=9,
                                   insert_frac=frac)[0]
        ja, ta = _commit_both(jbase, d)
        jstate, jseeds = jinc.pagerank_dirty_seeds(
            ja, js0, damping=0.85, eps=1e-6, codec=JCodec(g),
            split_threshold=threshold, owner_block=None)
        tstate, tseeds = incremental.pagerank_dirty_seeds(
            ta, pagerank_state_from_numpy(
                *(np.asarray(getattr(js0, f)) for f in (
                    "rank", "residue", "in_queue", "check_cursor")),
                *(np.asarray(getattr(js0.counter, f))
                  for f in ("work", "splits", "rounds")), device="cpu"),
            damping=0.85, eps=1e-6, codec=ChunkCodec(g),
            split_threshold=threshold)
        _state_equal(tstate, jstate, f"frac={frac}")
        np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds))
        sweeps.append(ta.meters["sweeps"])
    assert sweeps[0] > 0  # deletes only: negative residues were decayed


@pytest.mark.parametrize("g", [1, 4])
def test_coloring_conflict_rule_matches_jax(g):
    jbase = jgen.rmat(7, edge_factor=6, seed=10)
    js0 = _jax_drain("coloring", jbase, None)
    d = jgen.edge_delta_stream(jbase, 1, 96, seed=11, insert_frac=1.0)[0]
    ja, ta = _commit_both(jbase, d)
    jstate, jseeds = jinc.coloring_dirty_seeds(
        ja, js0, codec=JCodec(g), split_threshold=None, owner_block=None)
    tstate, tseeds = incremental.coloring_dirty_seeds(
        ta, coloring_state_from_numpy(
            np.asarray(js0.colors), *(np.asarray(getattr(js0.counter, f))
                                      for f in ("work", "splits", "rounds")),
            device="cpu"), codec=ChunkCodec(g), split_threshold=None)
    _state_equal(tstate, jstate)
    np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds))
    assert tseeds.numel() > 0


# ------------------------------------------------------- stream_execute
@pytest.fixture(scope="module")
def stream_inputs():
    jbase = jgen.rmat(6, edge_factor=6, seed=3)
    deltas = jgen.edge_delta_stream(jbase, 4, 24, seed=5)
    tdeltas = [make_delta(d.num_vertices, d.src, d.dst, d.insert)
               for d in deltas]
    return jbase, _port_graph(jbase), deltas, tdeltas


PARAMS = {"bfs": {"source": 3}, "pagerank": {},
          "coloring": {"dirty": "recolor"}}
HOST_SECONDS = ("commit_seconds", "reseed_seconds", "drain_seconds")


def _assert_stream_equal(t, j, msg=""):
    np.testing.assert_array_equal(t.result.numpy(), np.asarray(j.result),
                                  err_msg=msg)
    _state_equal(t.state, j.state, msg)
    assert len(t.batches) == len(j.batches)
    for a, b in zip(t.batches, j.batches):
        want = dataclasses.asdict(b)
        want.pop("commit_seconds")
        got = {k: v for k, v in dataclasses.asdict(a).items() if k in want}
        assert got == want, msg
    ti, ji = dict(t.info), dict(j.info)
    ti.pop("commit_seconds"), ji.pop("commit_seconds")
    assert ti == ji, msg


def _cfg(policy, jax=False):
    if jax:
        return j_config_for(JConfig(num_workers=16), j_parse(policy))
    return config_for(SchedulerConfig(num_workers=16), parse_policy(policy))


BFS_CELLS = [f"{top}.{kern}{g}" for top in ("single", "fused")
             for kern in ("persistent", "discrete") for g in ("", ".g4")]


@pytest.mark.parametrize("cell", BFS_CELLS)
def test_bfs_stream_matches_jax(stream_inputs, cell):
    jbase, tbase, jd, td = stream_inputs
    j = j_stream("bfs", jbase, jd, _cfg(cell, True), params=PARAMS["bfs"],
                 compact_every=2)
    t = stream_execute("bfs", tbase, td, _cfg(cell), params=PARAMS["bfs"],
                       compact_every=2)
    _assert_stream_equal(t, j, cell)
    assert t.info["compactions"] >= 1 and any(r.overlay for r in t.batches)


@pytest.mark.parametrize("algo", ["pagerank", "coloring"])
@pytest.mark.parametrize("cell", ["single.persistent", "fused.discrete.g4"])
def test_pagerank_and_coloring_streams_match_jax(stream_inputs, algo, cell):
    jbase, tbase, jd, td = stream_inputs
    j = j_stream(algo, jbase, jd, _cfg(cell, True), params=PARAMS[algo],
                 compact_every=2)
    t = stream_execute(algo, tbase, td, _cfg(cell), params=PARAMS[algo],
                       compact_every=2)
    _assert_stream_equal(t, j, f"{algo} {cell}")
    if algo == "pagerank":
        assert any(r.reseed_sweeps > 0 for r in t.batches)


@pytest.mark.parametrize("algo", ["bfs", "pagerank", "coloring"])
@pytest.mark.parametrize("cell", ["single.megakernel", "fused.megakernel.g4"])
def test_megakernel_streams_match_jax_persistent(stream_inputs, algo, cell):
    """The port's megakernel stream (the plain fused drain on CPU tensors,
    one segment a batch) against JAX's persistent cell."""
    jbase, tbase, jd, td = stream_inputs
    jcell = cell.replace("megakernel", "persistent")
    j = j_stream(algo, jbase, jd, _cfg(jcell, True), params=PARAMS[algo],
                 compact_every=2)
    t = stream_execute(algo, tbase, td, _cfg(cell), params=PARAMS[algo],
                       compact_every=2)
    _assert_stream_equal(t, j, f"{algo} {cell}")


@pytest.mark.parametrize("cell", ["single.persistent", "fused.discrete.g4"])
def test_stream_trace_rows_match_jax(stream_inputs, cell):
    """A traced stream: one row a round at absolute cross-batch rounds,
    the rows and the stream doc equal to JAX's."""
    jbase, tbase, jd, td = stream_inputs
    jt, tt = jobs.Trace(), Trace()
    j = j_stream("bfs", jbase, jd, _cfg(cell, True), params=PARAMS["bfs"],
                 compact_every=2, trace=jt)
    t = stream_execute("bfs", tbase, td, _cfg(cell), params=PARAMS["bfs"],
                       compact_every=2, trace=tt)
    _assert_stream_equal(t, j, cell)
    assert tt.records == jt.records
    assert [r["round"] for r in tt.records] == list(range(t.info["rounds"]))

    def docs(trace):
        return [{k: v for k, v in d.items() if k != "commit_seconds"}
                for d in trace.metrics]

    assert docs(tt) == docs(jt)


# --------------------------------------------------------- against cold
def _cold(algo, graph, cfg, params):
    program = build_program(algo, graph, cfg, params=params)
    return execute(program, graph, cfg).state


@pytest.mark.parametrize("cell", ["single.discrete", "single.megakernel.g4"])
def test_incremental_streams_equal_cold_drains(stream_inputs, cell):
    """BFS and coloring ``recolor`` bitwise against a cold drain on the
    replayed graph, PageRank within 10 eps; coloring ``conflicts`` gives a
    valid coloring for less work than ``recolor``."""
    _, tbase, _, td = stream_inputs
    cfg = _cfg(cell)
    final = replay(tbase, td)
    for algo in ("bfs", "coloring"):
        got = stream_execute(algo, tbase, td, cfg, params=PARAMS[algo],
                             compact_every=2)
        want = _cold(algo, final, cfg, PARAMS[algo])
        assert torch.equal(got.result, got.state.dist if algo == "bfs"
                           else got.state.colors)
        assert torch.equal(got.result, want.dist if algo == "bfs"
                           else want.colors), algo
    eps = 1e-6
    pr = stream_execute("pagerank", tbase, td, cfg, params={"eps": eps},
                        compact_every=2)
    cold = _cold("pagerank", final, cfg, {"eps": eps})
    assert float((pr.result - cold.rank).abs().max()) <= 10 * eps
    assert float(pr.state.residue.max()) <= eps
    conflicts = stream_execute("coloring", tbase, td, cfg, compact_every=2)
    recolor = stream_execute("coloring", tbase, td, cfg,
                             params={"dirty": "recolor"}, compact_every=2)
    assert validate_coloring(final, conflicts.result)
    assert conflicts.info["work"] < recolor.info["work"]
    assert all(r.incremental for r in conflicts.batches[1:])


def test_snapshot_resume_in_process_is_bit_identical(stream_inputs,
                                                     tmp_path):
    """A segmented megakernel stream equals the uncut one; a run resumed
    from an older snapshot equals both, records of the resumed batches
    included."""
    _, tbase, _, td = stream_inputs
    cfg = _cfg("single.megakernel")
    whole = stream_execute("bfs", tbase, td, cfg, params=PARAMS["bfs"],
                           compact_every=2)
    ticks = []
    cut = stream_execute("bfs", tbase, td, cfg, params=PARAMS["bfs"],
                         compact_every=2, snapshot_every=2,
                         checkpoint_dir=str(tmp_path), keep=100,
                         snapshot_hook=lambda t, b: ticks.append((t, b)))
    assert torch.equal(cut.result, whole.result) and len(ticks) > 4
    strip = [{k: v for k, v in dataclasses.asdict(r).items()
              if k not in HOST_SECONDS} for r in whole.batches]
    assert [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in HOST_SECONDS} for r in cut.batches] == strip
    # drop every snapshot past one in the middle of batch 2, then resume
    tick, batch = next((t, b) for t, b in ticks if b == 2)
    for t, _ in ticks:
        if t > tick + 1:
            shutil.rmtree(tmp_path / f"snap_{t}")
    resumed = stream_execute("bfs", tbase, td, cfg, params=PARAMS["bfs"],
                             compact_every=2, snapshot_every=2,
                             checkpoint_dir=str(tmp_path), keep=100,
                             resume=True)
    assert resumed.info["resumed_at"] == batch
    assert torch.equal(resumed.result, whole.result)
    assert [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in HOST_SECONDS} for r in resumed.batches] == \
        strip[batch:]

