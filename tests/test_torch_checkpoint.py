"""The port's checkpoints and stream snapshots (``repro_torch.checkpoint``,
``repro_torch.stream.snapshot``): the ``CheckpointManager`` round trip,
async save, retention, the atomic tmp-then-rename commit and prefixes, as
``tests/test_checkpoint_fault.py`` holds the reference's; snapshot cursors,
the fingerprint guard; and a streaming drain killed with SIGKILL inside its
snapshot hook, resumed in a new process bit for bit, on a persistent and a
megakernel cell.  The port's files are its own format.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import make_multiqueue, make_queue
from repro_torch.graph import rmat
from repro_torch.stream import SnapshotManager, graph_fingerprint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class _State:
    rank: torch.Tensor
    flags: torch.Tensor


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "state": _State(rank=torch.linspace(0, 1, 5),
                            flags=torch.tensor([True, False, True])),
            "queue": make_multiqueue(8, 2, device="cpu"),
            "host": (np.int32(3), np.arange(3, dtype=np.int64))}


def _leaves(tree):
    from repro_torch.checkpoint.manager import flatten_with_paths

    return flatten_with_paths(tree)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(1, tree)
    out = mgr.restore(1, tree)
    a, b = _leaves(tree), _leaves(out)
    assert list(a) == list(b)
    for path in a:
        x, y = a[path], b[path]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, path
            assert torch.equal(x, y), path
        else:
            assert np.asarray(x).dtype == np.asarray(y).dtype
            np.testing.assert_array_equal(x, y)
    assert isinstance(out["state"], _State)
    assert out["queue"].num_lanes == 2


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, _tree(), blocking=False)
    mgr.wait()
    assert mgr.latest_step() == 5


def test_retention_keeps_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]


def test_atomic_commit_ignores_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    os.makedirs(tmp_path / "step_2.tmp")  # a crash mid-save
    assert mgr.latest_step() == 1


def test_prefix_isolates_retention(tmp_path):
    steps = CheckpointManager(str(tmp_path), keep=2)
    snaps = CheckpointManager(str(tmp_path), keep=2, prefix="snap")
    for s in [1, 2, 3]:
        steps.save(s, _tree())
    for s in [10, 11, 12]:
        snaps.save(s, _tree())
    assert steps.all_steps() == [2, 3]
    assert snaps.all_steps() == [11, 12]
    out = snaps.restore(12, _tree())
    assert torch.equal(out["step"], _tree()["step"])


def test_prefix_validated(tmp_path):
    for bad in ("../evil", ""):
        with pytest.raises(ValueError):
            CheckpointManager(str(tmp_path), prefix=bad)


# ------------------------------------------------------------- snapshots
def test_snapshot_cursor_peek_and_fingerprint_guard(tmp_path):
    g = rmat(6, 6, seed=1, device="cpu")
    snap = SnapshotManager(str(tmp_path), keep=2)
    queue = make_queue(16, torch.arange(5), device="cpu")
    state = _State(rank=torch.zeros(3), flags=torch.ones(3, dtype=torch.bool))
    cursor = {"batch": 2, "rounds": 7, "processed": 30, "pre_work": 4,
              "pre_splits": 0, "seeds": 5, "eff": 12}
    snap.save(0, cursor=cursor, graph=g, num_deltas=2, queue=queue,
              state=state)
    peek = snap.peek(0)
    assert {k: peek[k] for k in cursor} == cursor
    assert peek["fingerprint"] == {k: int(v) for k, v in
                                   graph_fingerprint(g, 2).items()}
    tree = snap.restore(0, queue_template=make_queue(16, device="cpu"),
                        state_template=state, graph=g, num_deltas=2)
    assert torch.equal(tree["queue"].buf, queue.buf)
    assert int(tree["queue"].tail) == 5
    with pytest.raises(ValueError, match="fingerprint"):
        snap.restore(0, queue_template=make_queue(16, device="cpu"),
                     state_template=state, graph=g, num_deltas=3)
    with pytest.raises(ValueError, match="cursor"):
        snap.save(1, cursor={"batch": 0}, graph=g, num_deltas=0,
                  queue=queue, state=state)


# ------------------------------------------- SIGKILL a streaming drain
_STREAM_CHILD = """
    import json
    import os
    import signal
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import edge_delta_stream, rmat
    from repro_torch.runtime import config_for, parse_policy, stream_execute

    base = rmat(6, 6, seed=5, device="cpu")
    deltas = edge_delta_stream(base, 3, 12, seed=6)
    cfg = config_for(SchedulerConfig(num_workers=32),
                     parse_policy(os.environ["POLICY"]))
    kill_at = int(os.environ.get("KILL_AT_TICK", "-1"))

    def hook(tick, batch):
        if tick == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)

    res = stream_execute(
        "bfs", base, deltas, cfg, params={"source": 2},
        snapshot_every=2, checkpoint_dir=os.environ["SNAP_DIR"],
        keep=100, resume=os.environ.get("RESUME") == "1",
        snapshot_hook=hook, compact_every=2)
    print(json.dumps({
        "result": res.result.tolist(),
        "resumed_at": res.info["resumed_at"],
        "batches_run": res.info["batches_run"],
        "compactions": res.info["compactions"],
    }))
"""


def _stream_child(snap_dir, policy, kill_at=-1, resume=False):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               SNAP_DIR=str(snap_dir), KILL_AT_TICK=str(kill_at),
               RESUME="1" if resume else "0", POLICY=policy)
    return subprocess.run([sys.executable, "-c",
                           textwrap.dedent(_STREAM_CHILD)],
                          capture_output=True, text=True, env=env,
                          timeout=600)


@pytest.mark.parametrize("policy", ["single.persistent", "single.megakernel"])
def test_sigkill_mid_stream_resume_bit_exact(tmp_path, policy):
    """SIGKILL a streaming drain inside its snapshot hook; the resumed
    process reproduces the uninterrupted run's result and compaction count
    bit for bit."""
    out = _stream_child(tmp_path / "ref", policy)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    assert ref["resumed_at"] is None

    crash_dir = tmp_path / "crash"
    killed = _stream_child(crash_dir, policy, kill_at=3)
    assert killed.returncode == -signal.SIGKILL
    assert any(p.startswith("snap_") for p in os.listdir(crash_dir))

    resumed = _stream_child(crash_dir, policy, resume=True)
    assert resumed.returncode == 0, resumed.stderr[-3000:]
    got = json.loads(resumed.stdout.strip().splitlines()[-1])
    assert got["resumed_at"] is not None
    assert got["batches_run"] < ref["batches_run"]
    assert got["result"] == ref["result"]
    assert got["compactions"] == ref["compactions"]
