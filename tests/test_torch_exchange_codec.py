"""The port's exchange codec and routed exchange against the JAX package's.

The codec in process, bit-exact: the words, their count, the capacity and
the mode, on the reference's own corpus (``tests/test_exchange_codec.py``'s
``_cases`` and ``SHAPES``) and its edge cases.  The routed exchange
(``route_tasks``: owner split, compaction, one hop or two, compression),
the stealing step (``rebalance``) and the pop (``pop_wavefront``) on S in
{2, 4, 8} and 2x2 / 2x4 meshes, against the reference run once in one
subprocess with eight forced host devices: every shard's queue replica,
its delivered buffer and every meter.
"""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.queue import MultiQueue as JMultiQueue
from repro.core.queue import TaskQueue as JTaskQueue
from repro.shard import codec as J
from repro.shard import exchange as JX
from repro_torch.core.queue import MultiQueue, TaskQueue
from repro_torch.core.task import ChunkCodec
from repro_torch.shard import codec as T
from repro_torch.shard import exchange as TX
from repro_torch.shard.steal import rebalance

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
E = -(2 ** 31)
I32_MIN, I32_MAX = -2 ** 31, 2 ** 31 - 1


def _reference_cases():
    spec = importlib.util.spec_from_file_location(
        "_reference_codec_tests",
        Path(__file__).with_name("test_exchange_codec.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = _reference_cases()


_J_ENCODE = jax.jit(J.encode_buffer)
_J_DECODE = jax.jit(J.decode_buffer, static_argnums=(1, 2))


def _same_encoding(buf: np.ndarray) -> None:
    """Words, word count, capacity, mode and decode all bit-exact (the
    reference's codec jitted: the same function, compiled once a shape)."""
    rows, width = buf.shape
    jw, jn = _J_ENCODE(jnp.asarray(buf, jnp.int32))
    tw, tn = T.encode_buffer(torch.as_tensor(buf, dtype=torch.int32))
    assert T.codec_capacity(rows, width) == J.codec_capacity(rows, width)
    assert tw.shape[0] == T.codec_capacity(rows, width)
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    assert int(tn) == int(jn)
    assert int(tw[0]) & 3 == int(jw[0]) & 3
    # decode from the stream alone, its dead tail zeroed
    live = torch.arange(tw.shape[0]) < int(tn)
    tw = torch.where(live, tw, 0)
    jd = np.asarray(_J_DECODE(jnp.asarray(tw.numpy()), rows, width))
    assert np.array_equal(T.decode_buffer(tw, rows, width).numpy(), jd)


# ----------------------------------------------------------------- codec
def test_codec_reference_corpus_bitexact():
    for buf in REF._cases(seed=1):
        _same_encoding(buf)


@pytest.mark.parametrize("width", [1, 2, 3, 4, 7, 8, 16, 33])
def test_codec_dense_rows_each_width(width):
    rng = np.random.default_rng(width)
    _same_encoding(rng.integers(0, 10_000, (4, width)).astype(np.int32))


def test_codec_edge_buffers_bitexact():
    """The reference's sentinel-adjacent, all-EMPTY, incompressible,
    compressible and degenerate buffers."""
    buf = np.full((4, 8), E, np.int32)
    buf[0, :3] = [I32_MIN + 1, I32_MIN + 2, I32_MAX]
    buf[2, 5] = I32_MIN + 1
    _same_encoding(buf)
    empty = np.full((4, 8), E, np.int32)
    _same_encoding(empty)
    assert int(T.encode_buffer(torch.as_tensor(empty))[1]) == 1
    rng = np.random.default_rng(9)
    for rows, width in REF.SHAPES:
        _same_encoding(rng.integers(I32_MIN + 1, I32_MAX,
                                    (rows, width)).astype(np.int32))
    sparse = np.full((4, 1024), E, np.int32)
    sparse[0, :7] = np.arange(7) * 3
    sparse[2, :5] = 64 + np.arange(5)
    _same_encoding(sparse)
    assert int(T.encode_buffer(torch.as_tensor(sparse))[1]) < 13
    for tiny in ([[5]], [[E]], [[E, 7]], [[7], [E]]):
        _same_encoding(np.asarray(tiny, np.int32))


def test_zigzag_matches_jax_on_boundaries():
    vals = np.array([0, -1, 1, -2, 2, I32_MAX, I32_MIN, I32_MIN + 1,
                     np.int32(np.int64(I32_MAX - I32_MIN) & 0xFFFFFFFF)],
                    np.int32)
    jz = np.asarray(J.zigzag(jnp.asarray(vals)))
    tz = T.zigzag(torch.as_tensor(vals))
    assert np.array_equal(tz.numpy(), jz.astype(np.int64))
    assert np.array_equal(T.unzigzag(tz).numpy(), vals)
    assert np.array_equal(
        T.unzigzag(tz).numpy(),
        np.asarray(J.unzigzag(jnp.asarray(jz))))


# --------------------------------------------------------------- exchange
# (id, S, mesh_shape, wavefront out width k, route_width, compress, G,
#  steal threshold, steal chunk)
CASES = [
    ("s2-raw", 2, None, 24, None, False, 1, 0.5, 8),
    ("s4-codec-g4", 4, None, 32, None, True, 4, 0.25, 16),
    ("s8-narrow-route", 8, None, 40, 3, False, 1, 1.0, 4),
    ("2x2-raw", 4, (2, 2), 32, None, False, 1, 0.5, 64),
    ("2x2-codec-narrow", 4, (2, 2), 32, 2, True, 2, 0.0, 8),
    ("2x4-codec-g4", 8, (2, 4), 24, 5, True, 4, 0.5, 16),
]
N_VERTS, CAP = 200, 64


def _inputs(case):
    """Seeded per-shard queues (both lanes part full, heads off zero),
    produced items and masks for one exchange case."""
    cid, s, _, k = case[:4]
    g = case[6]
    rng = np.random.default_rng(sum(map(ord, cid)))
    codec = ChunkCodec(g)
    buf = np.full((s, 2, CAP), E, np.int32)
    head = rng.integers(0, 20, (s, 2)).astype(np.int32)
    size = rng.integers(0, 30, (s, 2)).astype(np.int32)
    size[0] = [0, 0]
    size[-1, 0] = 29                            # skew for the steal plan
    for d in range(s):
        for lane in range(2):
            for i in range(size[d, lane]):
                v = int(rng.integers(0, N_VERTS))
                w = int(rng.integers(1, g + 1))
                buf[d, lane, (head[d, lane] + i) % CAP] = \
                    codec.encode(torch.tensor(v), torch.tensor(w)).item()
    tail = head + size
    heads = rng.integers(0, N_VERTS, (s, k))
    widths = rng.integers(1, g + 1, (s, k))
    items = codec.encode(torch.as_tensor(heads),
                         torch.as_tensor(widths)).numpy().astype(np.int32)
    mask = rng.random((s, k)) < 0.7
    return {"buf": buf, "head": head, "tail": tail.astype(np.int32),
            "items": items, "mask": mask}


_REFERENCE = """
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P
from repro.core.queue import MultiQueue, TaskQueue
from repro.core.task import ChunkCodec
from repro.launch.mesh import make_shard_mesh, make_shard_mesh2d
from repro.shard.exchange import pop_wavefront, route_tasks
from repro.shard.steal import rebalance

cases = json.loads({spec!r})
out = {{}}
for case in cases:
    cid, s, shape, k, rw, compress, g, thr, chunk = case["case"]
    inp = {{key: np.asarray(v) for key, v in case["inputs"].items()}}
    codec = ChunkCodec(g)
    if shape is None:
        mesh, axes, dims = make_shard_mesh(s), "shard", None
    else:
        mesh, axes, dims = make_shard_mesh2d(*shape), ("row", "col"), \\
            tuple(shape)
    z = jnp.zeros((s, 2), jnp.int32)
    mq0 = MultiQueue(lanes=TaskQueue(buf=jnp.asarray(inp["buf"]),
                                     head=jnp.asarray(inp["head"]),
                                     tail=jnp.asarray(inp["tail"]),
                                     dropped=z),
                     rr=jnp.zeros((s,), jnp.int32))
    width_of = codec.width if g > 1 else None

    def step(mq_st, items, mask):
        mq = jax.tree.map(lambda x: x[0], mq_st)
        mq, donated, trig = rebalance(mq, axis_name=axes, num_shards=s,
                                      threshold=thr, chunk=chunk,
                                      width_of=width_of)
        mq_s = mq
        mq, delivered, meters = route_tasks(
            mq, items[0], mask[0], axis_name=axes, num_shards=s,
            num_vertices={n}, task_vertex=codec.head, route_width=rw,
            mesh_dims=dims, compress=compress)
        pi, pv, pk, mq = pop_wavefront(mq, 12)
        st = lambda t: jax.tree.map(lambda x: x[None], t)
        return (st(mq_s), st(mq), delivered[None],
                {{key: v[None] for key, v in meters.items()}},
                donated[None], trig[None], pi[None], pk[None])

    spec_q = jax.tree.map(lambda _: P(axes), mq0)
    fn = jax.jit(shard_map(step, mesh=mesh,
                           in_specs=(spec_q, P(axes), P(axes)),
                           out_specs=(spec_q, spec_q, P(axes), P(axes),
                                      P(axes), P(axes), P(axes), P(axes)),
                           check_rep=False))
    res = fn(mq0, jnp.asarray(inp["items"]), jnp.asarray(inp["mask"]))
    mq_s, mq, delivered, meters, donated, trig, pi, pk = res
    lanes = lambda q: {{f: np.asarray(getattr(q.lanes, f)).tolist()
                       for f in ("buf", "head", "tail", "dropped")}}
    out[cid] = {{"stolen": lanes(mq_s), "final": lanes(mq),
                "delivered": np.asarray(delivered).tolist(),
                "meters": {{key: np.asarray(v).tolist()
                           for key, v in meters.items()}},
                "donated": np.asarray(donated).tolist(),
                "triggered": np.asarray(trig).tolist(),
                "pop": np.asarray(pi).tolist(),
                "pop_stolen": np.asarray(pk).tolist()}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    """The reference's exchange cases in one subprocess with 8 forced host
    devices, started as the module starts."""
    out = tmp_path_factory.mktemp("exchange")
    spec = json.dumps([
        {"case": case, "inputs": {k: v.tolist()
                                  for k, v in _inputs(case).items()}}
        for case in CASES])
    prog = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            + textwrap.dedent(_REFERENCE.format(spec=spec, n=N_VERTS)))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
        proc = subprocess.Popen([sys.executable, "-c", prog], stdout=so,
                                stderr=se, env=env)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_proc):
    proc, out = _reference_proc
    assert proc.wait(timeout=600) == 0, (out / "stderr").read_text()[-3000:]
    return json.loads((out / "stdout").read_text().strip().splitlines()[-1])


def _queues(inp, s):
    return [MultiQueue(lanes=TaskQueue(
        buf=torch.as_tensor(inp["buf"][d]),
        head=torch.as_tensor(inp["head"][d]),
        tail=torch.as_tensor(inp["tail"][d]),
        dropped=torch.zeros(2, dtype=torch.int32)),
        rr=torch.zeros((), dtype=torch.int32)) for d in range(s)]


def _lanes(mqs):
    return {f: [getattr(mq.lanes, f).tolist() for mq in mqs]
            for f in ("buf", "head", "tail", "dropped")}


def test_delivered_width_matches_jax():
    for args in ((7, 4, None), (3, 8, (2, 4)), (5, 4, (2, 2)),
                 (1, 1, None)):
        assert TX.delivered_width(*args) == JX.delivered_width(*args)


def test_pop_wavefront_matches_jax_in_process():
    """The stolen-first pop, both lanes wrapped around the ring."""
    rng = np.random.default_rng(5)
    for trial in range(6):
        buf = rng.integers(0, 500, (2, 16)).astype(np.int32)
        head = rng.integers(0, 16, 2).astype(np.int32)
        tail = head + rng.integers(0, 17, 2).astype(np.int32)
        z = np.zeros(2, np.int32)
        jmq = JMultiQueue(JTaskQueue(jnp.asarray(buf), jnp.asarray(head),
                                     jnp.asarray(tail), jnp.asarray(z)),
                          jnp.int32(0))
        tmq = MultiQueue(TaskQueue(torch.as_tensor(buf),
                                   torch.as_tensor(head),
                                   torch.as_tensor(tail), torch.as_tensor(z)),
                         torch.zeros((), dtype=torch.int32))
        w = int(rng.integers(1, 24))
        ji, jv, jk, jq = JX.pop_wavefront(jmq, w)
        ti, tv, tk, tq = TX.pop_wavefront(tmq, w)
        assert np.array_equal(ti.numpy(), np.asarray(ji))
        assert np.array_equal(tv.numpy(), np.asarray(jv))
        assert int(tk) == int(jk)
        assert np.array_equal(tq.lanes.head.numpy(), np.asarray(jq.lanes.head))


def test_collectives_on_one_device_mesh():
    """all_to_all, ppermute, all_gather and the shard-order psum over a
    4-shard CPU mesh (views, no copies, the reference's semantics)."""
    devices = [CPU] * 4
    sends = [torch.arange(12, dtype=torch.int32).reshape(4, 3) + 100 * d
             for d in range(4)]
    recv = TX.all_to_all(sends, [[0, 1, 2, 3]], devices)
    for d in range(4):
        for src in range(4):
            assert torch.equal(recv[d][src], sends[src][d])
    assert [int(x) for x in TX.ppermute(
        [torch.tensor(d) for d in range(4)], devices)] == [3, 0, 1, 2]
    assert TX.all_gather([torch.tensor(d) for d in range(4)],
                         devices)[2].tolist() == [0, 1, 2, 3]
    xs = [torch.tensor(v, dtype=torch.float32)
          for v in (1e8, 1.0, -1e8, 1.0)]
    assert float(TX.psum(xs, devices)[3]) == float(
        ((np.float32(1e8) + np.float32(1)) + np.float32(-1e8))
        + np.float32(1))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_exchange_step_matches_jax(case, reference):
    """rebalance -> route_tasks -> pop_wavefront on every shard: replicas,
    delivered buffers, meters, donations and the pop, bitwise."""
    cid, s, shape, k, rw, compress, g, thr, chunk = case
    want = reference[cid]
    inp = _inputs(case)
    codec = ChunkCodec(g)
    devices = [CPU] * s
    mqs, donated, trig = rebalance(
        _queues(inp, s), devices=devices, threshold=thr, chunk=chunk,
        width_of=codec.width if g > 1 else None)
    assert _lanes(mqs) == want["stolen"]
    assert [int(x) for x in donated] == want["donated"]
    assert [bool(trig)] * s == want["triggered"]
    mqs, delivered, meters = TX.route_tasks(
        mqs, [torch.as_tensor(x) for x in inp["items"]],
        [torch.as_tensor(x) for x in inp["mask"]], devices=devices,
        num_vertices=N_VERTS, task_vertex=codec.head, route_width=rw,
        mesh_dims=tuple(shape) if shape else None, compress=compress)
    assert [x.tolist() for x in delivered] == want["delivered"]
    assert {key: [int(m[key]) for m in meters] for key in meters[0]} == \
        want["meters"]
    pops = [TX.pop_wavefront(mq, 12) for mq in mqs]
    assert [p[0].tolist() for p in pops] == want["pop"]
    assert [int(p[2]) for p in pops] == want["pop_stolen"]
    assert _lanes([p[3] for p in pops]) == want["final"]
