"""The port's ``MultiQueue`` against the reference's, bit for bit, on seeded
op tapes: the round-robin ``pop``, ``pop_lane`` with slot and vertex
quotas (zero and negative quotas included), pushes past capacity,
``reset_lane``, and after every op the stacked buffers, cursors, drop
counts, the round-robin pointer, ``lane_sizes``, ``lane_loads`` (slot and
vertex weighted) and ``size``.  Lane ids go in as Python ints, 0-dim and
one-element tensors."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.queue import make_multiqueue as j_make_multiqueue
from repro_torch.core import EMPTY, make_multiqueue

W = 4


def _width(t):
    """A chunk-width function of G = 4 codes, the same in both packages."""
    return (t & 3) + 1


def _tape(seed: int, lanes: int, n_ops: int = 60):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n_ops):
        kind = rng.choice(["push", "push", "pop", "pop_lane", "pop_lane",
                           "reset"], p=[.3, .15, .2, .15, .15, .05])
        lane = int(rng.integers(0, lanes))
        if kind == "push":
            items = rng.integers(0, 1 << 12, size=W).astype(np.int32)
            mask = rng.random(W) < 0.7
            ops.append(("push", lane, items, mask))
        elif kind == "pop":
            ops.append(("pop", int(rng.integers(1, W + 1))))
        elif kind == "pop_lane":
            quota = [None, int(rng.integers(-1, 2 * W)), 0][
                int(rng.integers(0, 3))]
            vertex = bool(rng.random() < 0.5)
            ops.append(("pop_lane", lane, int(rng.integers(1, W + 1)), quota,
                        vertex))
        else:
            ops.append(("reset", lane))
    return ops


def _lane_arg(lane: int, how: str):
    if how == "int":
        return lane
    if how == "0-dim":
        return torch.tensor(lane, dtype=torch.int32)
    return torch.tensor([lane], dtype=torch.int32)


def _snapshot(q, to_np) -> list:
    """Everything observable of a MultiQueue, as numpy arrays."""
    return [to_np(x) for x in (
        q.lanes.buf, q.lanes.head, q.lanes.tail, q.lanes.dropped, q.rr,
        q.size, q.lane_sizes(), q.lane_dropped(), q.lane_loads(),
        q.lane_loads(_width))]


@functools.lru_cache(maxsize=None)
def _jax_run(lanes: int, cap: int, seed: int) -> list:
    """The tape through JAX's MultiQueue: after each op, the popped items
    and valid flags (or None) and the queue's snapshot."""
    q = j_make_multiqueue(cap, lanes)
    out = [(None, _snapshot(q, np.asarray))]
    for op in _tape(seed, lanes):
        popped = None
        if op[0] == "push":
            _, lane, items, mask = op
            q = q.push(lane, jnp.asarray(items), jnp.asarray(mask))
        elif op[0] == "reset":
            q = q.reset_lane(op[1])
        elif op[0] == "pop":
            items, valid, q = q.pop(op[1])
            popped = (np.asarray(items), np.asarray(valid))
        else:
            _, lane, n, quota, vertex = op
            items, valid, q = q.pop_lane(lane, n, quota,
                                         width_of=_width if vertex else None)
            popped = (np.asarray(items), np.asarray(valid))
        out.append((popped, _snapshot(q, np.asarray)))
    return out


@pytest.mark.parametrize("how", ["int", "0-dim", "one-element"])
@pytest.mark.parametrize("lanes,cap,seed", [(1, 8, 0), (1, 5, 1), (3, 4, 2),
                                            (3, 8, 3), (4, 6, 4)])
def test_multiqueue_tape_matches_jax(lanes, cap, seed, how):
    want = _jax_run(lanes, cap, seed)
    q = make_multiqueue(cap, lanes, device="cpu")
    got = [(None, _snapshot(q, torch.Tensor.numpy))]
    for op in _tape(seed, lanes):
        popped = None
        if op[0] == "push":
            _, lane, items, mask = op
            q = q.push(_lane_arg(lane, how), torch.from_numpy(items),
                       torch.from_numpy(mask), backend="torch")
        elif op[0] == "reset":
            q = q.reset_lane(_lane_arg(op[1], how))
        else:
            if op[0] == "pop":
                items, valid, q = q.pop(op[1])
            else:
                _, lane, n, quota, vertex = op
                items, valid, q = q.pop_lane(
                    _lane_arg(lane, how), n, quota,
                    width_of=_width if vertex else None)
            assert (items[~valid] == EMPTY).all()
            popped = (items.numpy(), valid.numpy())
        got.append((popped, _snapshot(q, torch.Tensor.numpy)))
    assert len(got) == len(want)
    for i, ((gp, gs), (wp, ws)) in enumerate(zip(got, want)):
        assert (gp is None) == (wp is None), i
        for a, b in zip(gp or (), wp or ()):
            np.testing.assert_array_equal(a, b, err_msg=f"op {i}")
        for a, b in zip(gs, ws):
            np.testing.assert_array_equal(a, b, err_msg=f"op {i}")


def test_pop_lane_leaves_the_round_robin_pointer():
    """The fused topology's pop names its lane; only ``pop`` rotates."""
    q = make_multiqueue(8, 3, device="cpu")
    q = q.push(1, torch.arange(4, dtype=torch.int32),
               torch.ones(4, dtype=torch.bool))
    _, valid, q2 = q.pop_lane(1, 2)
    assert int(valid.sum()) == 2 and int(q2.rr) == 0
    _, valid, q3 = q2.pop(4)
    assert int(valid.sum()) == 2 and int(q3.rr) == 2


def test_one_lane_stack_is_the_lane_itself():
    """A one-lane MultiQueue writes a lane back with no copy: its buffer
    is a view of the lane's, and the operands stay untouched."""
    q = make_multiqueue(8, 1, device="cpu")
    seeds = torch.arange(5, dtype=torch.int32)
    q1 = q.push(0, seeds, torch.ones(5, dtype=torch.bool), backend="torch")
    lane = q1.lane(0)
    q2 = q1.with_lane(0, lane)
    assert q2.lanes.buf.data_ptr() == lane.buf.data_ptr()
    assert (q.lanes.buf == EMPTY).all() and int(q.size) == 0
    assert int(q1.size) == 5
