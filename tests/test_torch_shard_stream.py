"""The port's sharded stream, per-owner reshard and sharded tracing
against the JAX package's.

In process: the slotted row extraction (``SlottedCSR.row_ptr64`` and
``range_cols``) on random row ranges after committed deltas, with an
overlay and a compaction; ``stream.reshard`` with and without ``parts``
and the steal halo, every shard's slice and ``edges_per_shard`` (the
reference pads its stack, the port's slices are unpadded), and the clean
shards' tensors left untouched.

The sharded cells -- streams over 2-3 delta batches on ``sharded.persistent``
and ``sharded.discrete``, BFS, PageRank (at G = 4) and coloring, a 2x2 mesh
with deferred delivery, the codec and stealing; traced ``execute`` on 1-D
and 2x2 meshes -- run the reference once, in one subprocess with eight
forced host devices (the ``reference`` fixture), and the port here on
``[cpu] * S`` meshes.  Every stream is traced on both sides.  (The
reference's ``unstack_ring`` indexes the shard-split ring on the device,
which the installed JAX refuses on a multi-device mesh: the subprocess
reads each ring to the host first, ROADMAP C-ref7.)

All bitwise: the result, the state's leaves (PageRank's float32 ones too),
every ``BatchRecord`` field but host seconds, ``info`` with its exchange
totals, the trace rows at their absolute rounds and the ``shard_run``
docs.  A sharded snapshot resumed in process equals the uninterrupted
stream bit for bit.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.graph as jg
import repro.graph.generators as jgen
import repro_torch.graph as tg
from repro.graph import SlottedCSR as JSlotted
from repro.stream import commit as j_commit
from repro.stream import reshard as j_reshard
from repro_torch.core import SchedulerConfig
from repro_torch.graph.slotted import SlottedCSR
from repro_torch.launch.mesh import make_shard_mesh, make_shard_mesh2d
from repro_torch.obs import Trace
from repro_torch.runtime import (build_program, config_for, execute,
                                 parse_policy, stream_execute)
from repro_torch.stream import commit, make_delta, reshard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

#: the host seconds a record carries; everything else is held bitwise
HOST_SECONDS = ("commit_seconds", "reseed_seconds", "drain_seconds",
                "reseed_sweeps")

# (id, algorithm, graph, policy, config fields, deltas, batch size,
#  delta seed, params, compact_every)
STREAMS = [
    ("bfs-s2-persistent", "bfs", "rmat6", "sharded.persistent",
     {"num_shards": 2}, 2, 12, 3, {"source": 0}, 2),
    ("bfs-2x2-persistent-defer-codec-steal", "bfs", "grid",
     "sharded.persistent", {"num_shards": 4, "mesh_shape": [2, 2],
                          "defer_rounds": 1, "compress": True,
                          "steal_threshold": 0.5}, 1, 16, 5,
     {"source": 0}, 0),
    ("pagerank-s2-persistent-g4", "pagerank", "rmat6",
     "sharded.persistent.g4", {"num_shards": 2}, 2, 12, 4, {}, 0),
    ("coloring-s4-discrete", "coloring", "erdos", "sharded.discrete",
     {"num_shards": 4}, 2, 10, 6, {}, 1),
]

# (id, policy, config fields): traced BFS drains on rmat6 from vertex 0
TRACED = [
    ("persistent-s2", "sharded.persistent", {"num_shards": 2}),
    ("discrete-s4", "sharded.discrete", {"num_shards": 4}),
    ("persistent-2x2-defer", "sharded.persistent",
     {"num_shards": 4, "mesh_shape": [2, 2], "defer_rounds": 1}),
    ("discrete-2x2-steal", "sharded.discrete",
     {"num_shards": 4, "mesh_shape": [2, 2], "steal_threshold": 0.5}),
]


def _graphs(pkg):
    if pkg is jg:
        return {"rmat6": jg.rmat(6, edge_factor=8, seed=1),
                "grid": jg.grid2d(8, 8, seed=0),
                "erdos": jg.erdos(32, 90, seed=2)}
    return {"rmat6": tg.rmat(6, edge_factor=8, seed=1, device="cpu"),
            "grid": tg.grid2d(8, 8, seed=0, device="cpu"),
            "erdos": tg.erdos(32, 90, seed=2, device="cpu")}


def _cfg(policy, fields, cls=SchedulerConfig, parse=parse_policy,
         cfor=config_for):
    kw = dict(fields)
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return cfor(cls(num_workers=16, **kw), parse(policy))


def _mesh(cfg):
    devices = [CPU] * cfg.num_shards
    if cfg.mesh_shape is None:
        return make_shard_mesh(cfg.num_shards, devices=devices)
    return make_shard_mesh2d(*cfg.mesh_shape, devices=devices)


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


def _records(res) -> list:
    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in HOST_SECONDS} for r in res.batches]


def _info(res) -> dict:
    return {k: v for k, v in res.info.items() if k != "commit_seconds"}


def _shard_docs(trace) -> list:
    return [d for d in trace.metrics if d["kind"] == "shard_run"]


_REFERENCE = """
import dataclasses, json
import numpy as np
import repro.graph as jg
from repro.core import SchedulerConfig
from repro.graph.generators import edge_delta_stream
from repro.obs import Trace
from repro.runtime import build_program, config_for, execute, parse_policy
from repro.runtime import stream_execute

import jax
import repro.shard.driver as sharded_driver

# the reference's unstack_ring indexes the shard-split ring on the device,
# which this JAX refuses on a multi-device mesh; read it to the host first
sharded_driver.unstack_ring = lambda ring, d: jax.tree.map(
    lambda x: np.asarray(x)[d], ring)

streams, traced, host = json.loads({spec!r})
graphs = {{"rmat6": jg.rmat(6, edge_factor=8, seed=1),
          "grid": jg.grid2d(8, 8, seed=0),
          "erdos": jg.erdos(32, 90, seed=2)}}

def cfg_of(policy, fields):
    kw = dict(fields)
    if kw.get("mesh_shape") is not None:
        kw["mesh_shape"] = tuple(kw["mesh_shape"])
    return config_for(SchedulerConfig(num_workers=16, **kw),
                      parse_policy(policy))

def leaves(cid, state, arrays):
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for h in dataclasses.fields(v):
                arrays[cid + "/" + f.name + "." + h.name] = np.asarray(
                    getattr(v, h.name))
        else:
            arrays[cid + "/" + f.name] = np.asarray(v)

def shard_docs(trace):
    return [d for d in trace.metrics if d["kind"] == "shard_run"]

out, arrays = {{"streams": {{}}, "traced": {{}}}}, {{}}
for (cid, algo, gname, policy, fields, nd, size, dseed, params,
     every) in streams:
    g = graphs[gname]
    deltas = edge_delta_stream(g, nd, size, seed=dseed)
    trace = Trace()
    res = stream_execute(algo, g, deltas, cfg_of(policy, fields),
                         params=params, compact_every=every, trace=trace)
    arrays[cid + "/result"] = np.asarray(res.result)
    leaves(cid, res.state, arrays)
    out["streams"][cid] = {{
        "records": [{{k: v for k, v in dataclasses.asdict(r).items()
                     if k not in host}} for r in res.batches],
        "info": {{k: v for k, v in res.info.items()
                 if k != "commit_seconds"}},
        "rows": trace.records, "shard_docs": shard_docs(trace)}}
for cid, policy, fields in traced:
    g = graphs["rmat6"]
    cfg = cfg_of(policy, fields)
    trace = Trace()
    state, stats, info = execute(build_program("bfs", g, cfg,
                                               params={{"source": 0}}),
                                 g, cfg, trace=trace)
    leaves(cid, state, arrays)
    out["traced"][cid] = {{"info": info, "rows": trace.records,
                          "shard_docs": shard_docs(trace)}}
np.savez({npz!r}, **arrays)
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    """Start the reference's sharded cells in one subprocess with 8 forced
    host devices as the module starts, so it runs beside the in-process
    tests; :func:`reference` waits for it."""
    out = tmp_path_factory.mktemp("shard_stream")
    npz = str(out / "arrays.npz")
    spec = json.dumps([STREAMS, TRACED, list(HOST_SECONDS)])
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
    """``(records, info and rows by cell, state arrays)`` of the
    reference."""
    proc, out, npz = _reference_proc
    assert proc.wait(timeout=600) == 0, (out / "stderr").read_text()[-3000:]
    docs = json.loads((out / "stdout").read_text().strip().splitlines()[-1])
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files}
    return docs, arrays


@pytest.fixture(scope="module")
def tgraphs():
    return _graphs(tg)


# ------------------------------------------------------- slotted rows
def _committed(seed: int, batches: int = 4, compact_every: int = 3):
    """The same delta log committed to a JAX and a port slotted CSR, the
    third commit compacting; yields both after every commit."""
    jgr = jg.rmat(7, edge_factor=8, seed=seed)
    tgr = tg.rmat(7, edge_factor=8, seed=seed, device="cpu")
    deltas = jgen.edge_delta_stream(jgr, batches, 24, seed=seed + 10)
    js, ts = JSlotted.from_csr(jgr), SlottedCSR.from_csr(tgr)
    for b, d in enumerate(deltas, start=1):
        ja = j_commit(js, d, b, compact_every)
        ta = commit(ts, make_delta(d.num_vertices, d.src, d.dst, d.insert),
                    b, compact_every)
        yield b, js, ts, ja, ta


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_slotted_row_ranges_match_jax(seed):
    """``row_ptr64`` and ``range_cols`` on random row ranges after every
    commit, an overlay present and a compaction passed, equal the
    reference's."""
    rng = np.random.default_rng(seed)
    saw_overlay = saw_compaction = False
    for _, js, ts, ja, ta in _committed(seed):
        saw_overlay |= js.overlay_size > 0
        saw_compaction |= ja.compacted
        assert ta.compacted == ja.compacted
        rp = ts.row_ptr64()
        assert rp.dtype == torch.int64
        np.testing.assert_array_equal(rp.numpy(), js.row_ptr64())
        n = js.num_vertices
        ranges = [(0, n), (0, 0), (n - 1, n)] + [
            tuple(sorted(rng.integers(0, n + 1, 2))) for _ in range(6)]
        for lo, hi in ranges:
            got = ts.range_cols(int(lo), int(hi))
            assert got.dtype == torch.int32 and got.device == CPU
            np.testing.assert_array_equal(got.numpy(),
                                          js.range_cols(int(lo), int(hi)))
    assert saw_overlay and saw_compaction


# ------------------------------------------------------------ reshard
def _same_parts(tp, jp):
    assert (tp.num_shards, tp.num_vertices, tp.halo) == \
        (jp.num_shards, jp.num_vertices, jp.halo)
    assert tuple(tp.edges_per_shard) == tuple(jp.edges_per_shard)
    jcol = np.asarray(jp.col_idx)
    for d in range(tp.num_shards):
        np.testing.assert_array_equal(tp.row_ptr[d].numpy(),
                                      np.asarray(jp.row_ptr[d]))
        stored = int(np.asarray(jp.row_ptr[d]).max())
        cols = tp.col_idx[d].numpy()
        assert cols.shape[0] == max(stored, 1)
        np.testing.assert_array_equal(cols[:stored], jcol[d, :stored])
        assert not jcol[d, stored:].any()


@pytest.mark.parametrize("patched", [False, True])
@pytest.mark.parametrize("halo", [False, True])
def test_reshard_matches_jax(halo, patched):
    """Every batch's reshard -- the full build, or the per-owner patch of
    the previous partition -- equals the reference's, shard by shard."""
    jparts = tparts = None
    for _, js, ts, ja, ta in _committed(4, batches=3):
        touched = np.concatenate([ja.ins_src, ja.del_src])
        np.testing.assert_array_equal(
            touched, np.concatenate([ta.ins_src, ta.del_src]))
        if patched and jparts is not None:
            jparts = j_reshard(js, 4, halo=halo, parts=jparts,
                               touched_rows=touched)
            tparts = reshard(ts, 4, halo=halo, parts=tparts,
                             touched_rows=touched)
        else:
            jparts = j_reshard(js, 4, halo=halo)
            tparts = reshard(ts, 4, halo=halo, devices=[CPU] * 4)
        _same_parts(tparts, jparts)


@pytest.mark.parametrize("halo", [False, True])
def test_reshard_keeps_clean_shards_tensors(halo):
    """A commit inside shard 0's block rebuilds shard 0 (and, with halos,
    its successor 1); every other shard keeps the very same tensors (the
    counterpart of the reference's untouched-shard tests)."""
    g = tg.grid2d(8, 8, device="cpu")
    s = SlottedCSR.from_csr(g)
    parts = reshard(s, 4, halo=halo, devices=[CPU] * 4)
    # delete the edge 0 - 8 in both directions: rows 0 and 8, shard 0
    applied = commit(s, make_delta(64, [0, 8], [8, 0], [False, False]), 1)
    touched = np.concatenate([applied.ins_src, applied.del_src])
    assert set(np.unique(touched).tolist()) == {0, 8}
    patched = reshard(s, 4, halo=halo, parts=parts, touched_rows=touched)
    dirty = {0, 1} if halo else {0}
    for d in range(4):
        same = (patched.row_ptr[d] is parts.row_ptr[d]
                and patched.col_idx[d] is parts.col_idx[d])
        assert same == (d not in dirty), d
        if d not in dirty:
            assert patched.col_idx[d].data_ptr() == parts.col_idx[d].data_ptr()
    assert patched.edges_per_shard[0] == parts.edges_per_shard[0] - 2
    full = reshard(s, 4, halo=halo, devices=[CPU] * 4)
    for d in range(4):
        assert torch.equal(patched.row_ptr[d], full.row_ptr[d])
        assert torch.equal(patched.col_idx[d], full.col_idx[d])
    assert patched.edges_per_shard == full.edges_per_shard
    # no touched rows: the partition itself comes back
    assert reshard(s, 4, halo=halo, parts=patched, touched_rows=[]) \
        is patched


# -------------------------------------------------- the sharded cells
def _stream(case, tgraphs, trace=None, **kw):
    _, algo, gname, policy, fields, nd, size, dseed, params, every = case
    g = tgraphs[gname]
    cfg = _cfg(policy, fields)
    deltas = tg.edge_delta_stream(g, nd, size, seed=dseed)
    return stream_execute(algo, g, deltas, cfg, params=dict(params),
                          compact_every=every, mesh=_mesh(cfg),
                          trace=trace, **kw)


@pytest.mark.parametrize("case", STREAMS, ids=[c[0] for c in STREAMS])
def test_sharded_stream_matches_jax_bitwise(case, reference, tgraphs):
    """``stream_execute`` on a sharded cell: the result, the state, every
    batch record, ``info`` (with the exchange totals) and the trace rows at
    their absolute rounds equal the reference's; the shard_run docs too."""
    cid = case[0]
    docs, arrays = reference
    want = docs["streams"][cid]
    trace = Trace()
    res = _stream(case, tgraphs, trace=trace)
    np.testing.assert_array_equal(res.result.numpy(), arrays[f"{cid}/result"])
    for k, v in _leaves(res.state).items():
        np.testing.assert_array_equal(v, arrays[f"{cid}/{k}"],
                                      err_msg=f"{cid}: state {k}")
    assert _records(res) == want["records"]
    assert _info(res) == want["info"]
    for k in ("exchanged", "donated", "steal_rounds", "mis_routed",
              "route_dropped"):
        assert k in res.info
    assert trace.records == want["rows"]
    assert _shard_docs(trace) == want["shard_docs"]
    shards = case[4]["num_shards"]
    assert len(trace.records) == res.info["rounds"] * shards
    assert sum(r["pops"] for r in trace.records) == res.info["processed"]
    assert res.info["mis_routed"] == 0 and res.info["dropped"] == 0
    if case[4].get("steal_threshold"):
        assert res.info["donated"] > 0


@pytest.mark.parametrize("case", TRACED, ids=[c[0] for c in TRACED])
def test_sharded_trace_matches_jax(case, reference, tgraphs):
    """``execute(..., trace=Trace())`` on a sharded cell: rows equal the
    reference's row for row (one a shard a round), the shard_run doc
    equal; the traced drain bitwise the untraced one."""
    cid, policy, fields = case
    docs, arrays = reference
    want = docs["traced"][cid]
    g = tgraphs["rmat6"]
    cfg = _cfg(policy, fields)
    program = build_program("bfs", g, cfg, params={"source": 0})
    trace = Trace()
    state, stats, info = execute(program, g, cfg, trace=trace,
                                 mesh=_mesh(cfg))
    for k, v in _leaves(state).items():
        np.testing.assert_array_equal(v, arrays[f"{cid}/{k}"])
    assert info == want["info"]
    assert trace.records == want["rows"]
    assert len(trace.records) == info["rounds"] * cfg.num_shards
    assert sum(r["pops"] for r in trace.records) == int(stats.items_processed)
    assert {r["engine"] for r in trace.records} == {policy}
    assert _shard_docs(trace) == want["shard_docs"]
    assert len(trace.metrics) == 1
    base_state, base_stats, base_info = execute(program, g, cfg,
                                                mesh=_mesh(cfg))
    for k, v in _leaves(base_state).items():
        np.testing.assert_array_equal(v, _leaves(state)[k])
    assert base_info == info
    assert [int(x) for x in base_stats] == [int(x) for x in stats]


def test_sharded_snapshot_resume_is_bit_identical(tmp_path, reference,
                                                  tgraphs):
    """Snapshots every two rounds of a sharded stream: the cut stream
    equals the whole one, and a resume from a mid-stream snapshot (the
    newer ones dropped) equals it too -- all equal to the reference's
    uninterrupted stream, which the traced stream equals too."""
    case = STREAMS[0]
    cid = case[0]
    docs, arrays = reference
    whole = _stream(case, tgraphs)
    ticks = []
    cut = _stream(case, tgraphs, snapshot_every=2,
                  checkpoint_dir=str(tmp_path), keep=100,
                  snapshot_hook=lambda t, b: ticks.append((t, b)))
    assert torch.equal(cut.result, whole.result)
    assert _records(cut) == _records(whole)
    np.testing.assert_array_equal(whole.result.numpy(),
                                  arrays[f"{cid}/result"])
    assert _records(whole) == docs["streams"][cid]["records"]
    # keep batch 1's newest snapshot, drop every later one
    tick = [t for t, b in ticks if b == 1][-1]
    assert any(b == 2 for _, b in ticks)
    for t, _ in ticks:
        if t > tick:
            shutil.rmtree(tmp_path / f"snap_{t}")
    resumed = _stream(case, tgraphs, snapshot_every=2,
                      checkpoint_dir=str(tmp_path), keep=100, resume=True)
    batch = 1
    assert resumed.info["resumed_at"] == batch
    assert torch.equal(resumed.result, whole.result)
    for k, v in _leaves(resumed.state).items():
        np.testing.assert_array_equal(v, _leaves(whole.state)[k])
    assert _records(resumed) == _records(whole)[batch:]
