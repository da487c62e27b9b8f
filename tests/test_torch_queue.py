"""The PyTorch port's TaskQueue against the JAX package's, bit for bit:
push/pop tapes with wraparound, overflow and the dropped counter, slot and
vertex quotas (0, negative, above occupancy), on both push paths -- the
prefix-sum push (``backend="torch"``) and the compaction-kernel push, whose
compaction runs its plain version on CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChunkCodec as JCodec
from repro.core import make_queue as j_make_queue
from repro_torch.convert import queue_from_numpy, to_numpy
from repro_torch.core import EMPTY, ChunkCodec, make_queue

PUSH_PATHS = {
    "prefix-sum": lambda q, items, mask: q.push(items, mask, backend="torch"),
    "compaction": lambda q, items, mask: q._push_compact(items, mask),
}


def _same(tq, jq, ctx=""):
    for field in ("buf", "head", "tail", "dropped"):
        np.testing.assert_array_equal(
            getattr(tq, field).numpy(), np.asarray(getattr(jq, field)),
            err_msg=f"{field} diverged {ctx}")


def _pair(capacity, init=None):
    jq = j_make_queue(capacity, None if init is None
                      else jnp.asarray(init, jnp.int32))
    tq = make_queue(capacity, None if init is None else np.asarray(init),
                    device="cpu")
    _same(tq, jq, "at construction")
    return tq, jq


def _push(path, tq, jq, items, mask):
    items = np.array(items, np.int32)
    mask = np.array(mask, bool)
    tq = PUSH_PATHS[path](tq, torch.from_numpy(items), torch.from_numpy(mask))
    jq = jq.push(jnp.asarray(items), jnp.asarray(mask))
    _same(tq, jq, f"after push of {mask.sum()} via {path}")
    return tq, jq


def _pop(tq, jq, n, quota=None, width_of=None, j_width_of=None):
    if quota is None:
        ti, tv, tq = tq.pop(n)
        ji, jv, jq = jq.pop(n)
    else:
        ti, tv, tq = tq.pop_upto(n, quota, width_of=width_of)
        ji, jv, jq = jq.pop_upto(n, quota, width_of=j_width_of)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _same(tq, jq, f"after pop({n}, quota={quota})")
    return ti, tv, tq, jq


# --------------------------------------------- scenarios of test_queue.py
@pytest.mark.parametrize("path", PUSH_PATHS)
def test_unit_scenarios(path):
    tq, jq = _pair(16, [1, 2, 3])
    ti, tv, tq, jq = _pop(tq, jq, 2)
    assert ti.tolist() == [1, 2] and int(tq.size) == 1

    tq, jq = _pair(8, [7])
    ti, tv, tq, jq = _pop(tq, jq, 4)
    assert tv.tolist() == [True, False, False, False]
    assert int(ti[1]) == EMPTY

    tq, jq = _pair(8)
    tq, jq = _push(path, tq, jq, [10, 11, 12, 13], [1, 0, 1, 0])
    ti, tv, tq, jq = _pop(tq, jq, 4)
    assert ti.tolist()[:2] == [10, 12]

    tq, jq = _pair(4, [1, 2, 3])
    tq, jq = _push(path, tq, jq, [4, 5, 6], [1, 1, 1])
    assert int(tq.size) == 4 and int(tq.dropped) == 2


@pytest.mark.parametrize("path", PUSH_PATHS)
def test_wraparound_sequence(path):
    tq, jq = _pair(4, [0, 1])
    for i in range(10):
        _, tv, tq, jq = _pop(tq, jq, 1)
        assert bool(tv[0])
        tq, jq = _push(path, tq, jq, [100 + i, 200 + i], [True, i % 2 == 0])


# ------------------------------------- scenarios of test_backend.py:58-130
@pytest.mark.parametrize("path", PUSH_PATHS)
@pytest.mark.parametrize("mask", [[1] * 6, [1, 0] * 3, [0] * 6])
def test_push_dense_holes_nothing(path, mask):
    tq, jq = _pair(16, [1, 2, 3])
    _push(path, tq, jq, np.arange(10, 16), mask)


@pytest.mark.parametrize("path", PUSH_PATHS)
def test_push_dropped_counter(path):
    tq, jq = _pair(8, [1, 2, 3, 4, 5])
    tq, jq = _push(path, tq, jq, np.arange(10, 16), [1, 0, 1, 1, 1, 1])
    assert int(tq.dropped) == 2
    ti, tv, _, _ = _pop(tq, jq, 8)
    assert ti[tv].tolist() == [1, 2, 3, 4, 5, 10, 12, 13]


@pytest.mark.parametrize("path", PUSH_PATHS)
def test_push_spans_multiple_tiles(path):
    n = 2 * 256 + 37
    rng = np.random.default_rng(3)
    tq, jq = _pair(2 * n)
    _push(path, tq, jq, rng.integers(0, 1 << 20, size=n), rng.random(n) < 0.4)


def test_push_dense_and_auto_backend_on_cpu():
    tq, jq = _pair(8)
    tq2 = tq.push_dense(torch.arange(5, dtype=torch.int32))   # auto -> torch
    _same(tq2, jq.push_dense(jnp.arange(5, dtype=jnp.int32)))


# -------------------------------------------------- seeded random tapes
@pytest.mark.parametrize("path", PUSH_PATHS)
@pytest.mark.parametrize("seed", range(6))
def test_random_tape_matches_jax(path, seed):
    """Random pushes (with holes, overflow) and pops (plain, and slot
    quotas that are 0, negative, partial or above the occupancy)."""
    rng = np.random.default_rng(seed)
    cap = int(rng.choice([4, 8, 13]))
    tq, jq = _pair(cap)
    counter = 0
    for _ in range(40):
        kind = rng.choice(["push", "pop", "quota"])
        if kind == "push":
            k = int(rng.integers(0, 2 * cap))
            items = np.arange(counter, counter + k)
            counter += k
            tq, jq = _push(path, tq, jq, items, rng.random(k) < 0.7)
        elif kind == "pop":
            _, _, tq, jq = _pop(tq, jq, int(rng.integers(1, cap + 2)))
        else:
            quota = int(rng.choice([-3, 0, 1, 2, 5, 99]))
            _, _, tq, jq = _pop(tq, jq, int(rng.integers(1, cap + 2)),
                                quota=quota)
        assert 0 <= int(tq.size) <= cap


@pytest.mark.parametrize("seed", range(4))
def test_vertex_quota_tape_matches_jax(seed):
    """Chunk tasks at G=4: vertex-denominated pops take the longest prefix
    of whole chunks fitting the quota; vertex_size agrees."""
    rng = np.random.default_rng(100 + seed)
    tc, jc = ChunkCodec(4), JCodec(4)
    tq, jq = _pair(16)
    for _ in range(30):
        if rng.random() < 0.5:
            k = int(rng.integers(1, 8))
            heads = rng.integers(0, 1000, size=k)
            widths = rng.integers(1, 5, size=k)
            items = np.asarray(jc.encode(jnp.asarray(heads, jnp.int32),
                                         jnp.asarray(widths, jnp.int32)))
            tq, jq = _push("prefix-sum", tq, jq, items, np.ones(k, bool))
        else:
            quota = int(rng.choice([-1, 0, 3, 4, 7, 40]))
            _, _, tq, jq = _pop(tq, jq, 6, quota=quota, width_of=tc.width,
                                j_width_of=jc.width)
        assert int(tq.vertex_size(tc.width)) == int(jq.vertex_size(jc.width))


def test_queue_handed_across_as_numpy():
    jq = j_make_queue(8, jnp.arange(6, dtype=jnp.int32))
    _, _, jq = jq.pop(5)
    jq = jq.push_dense(jnp.arange(20, 26, dtype=jnp.int32))
    tq = queue_from_numpy(np.asarray(jq.buf), np.asarray(jq.head),
                          np.asarray(jq.tail), np.asarray(jq.dropped),
                          device="cpu")
    _same(tq, jq)
    back = to_numpy(tq)
    np.testing.assert_array_equal(back.buf, np.asarray(jq.buf))
    for path in PUSH_PATHS:
        _push(path, tq, jq, [7, 8, 9], [1, 1, 0])
