"""The port's sharded server jobs and the CLI's sharding flags against the
JAX package's.

A ``TaskServer`` with a sharded BFS job, a sharded streaming BFS job and
two fused tenants, traced: results, ``JobTelemetry``, ``ServerStats``
(``sharded_jobs``, ``sharded_rounds``), trace rows and summary docs; a
sharded job that overflows its replicas under ``strict_drops``, and one
whose drain reports a mis-routed task, raise as the reference's do (the
same message); the CLI's ``--shards``, ``--mesh``, ``--overlap`` and
``--compress`` print the reference's table, wall aside.  The reference
runs in one subprocess with eight forced host devices (the ``reference``
fixture; it reads each shard's ring to the host before the reference's
``unstack_ring``, ROADMAP C-ref7); the port's shards sit on the CPU, as a
server built with ``device="cpu"`` places them.  Also: a cache that
records a sharded config parses, as the reference's does.
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

import repro_torch.graph as tg
from repro_torch.core import SchedulerConfig
from repro_torch.graph import edge_delta_stream
from repro_torch.obs import Trace
from repro_torch.runtime import policy_of
from repro_torch.server import JobRegistry, JobSpec, TaskServer
from repro_torch.stream import StreamSpec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (algorithm, graph, params, shards, stream batches, weight)
JOBS = [
    ("bfs", "rmat", {"source": 3}, 2, 0, 1.0),
    ("pagerank", "grid", {"eps": 1e-4}, 1, 0, 2.0),
    ("bfs", "grid", {"source": 5}, 4, 2, 1.0),
    ("coloring", "rmat", {}, 1, 0, 3.0),
]
#: the CLI runs: the smallest registry and the sharding flags
CLI_BASE = ["--jobs", "3", "--scale", "6", "--grid-side", "8"]
CLI_FLAGS = [["--shards", "2"],
             ["--mesh", "2", "2", "--stream", "2"],
             ["--shards", "2", "--overlap"],
             ["--shards", "2", "--compress", "--stream", "2"]]
#: host clocks in the summary docs
HOST_KEYS = ("wall_seconds", "commit_seconds")


def _registry():
    reg = JobRegistry()
    reg.register_graph("rmat", tg.rmat(6, edge_factor=8, seed=0,
                                       device="cpu"))
    reg.register_graph("grid", tg.grid2d(8, 8, seed=0, device="cpu"))
    return reg


def _specs(Spec, StreamSpec_, deltas_of, reg):
    out = []
    for algo, gname, params, shards, batches, weight in JOBS:
        stream = None
        if batches:
            stream = StreamSpec_(
                deltas=tuple(deltas_of(reg.graph(gname), batches, 8, seed=1)),
                compact_every=2)
        out.append(Spec(algo, gname, dict(params), weight=weight,
                        shards=shards, stream=stream))
    return out


def _docs(trace) -> list:
    return [{k: v for k, v in d.items() if k not in HOST_KEYS}
            for d in trace.metrics]


_REFERENCE = """
import contextlib, dataclasses, io, json, sys
import jax
import numpy as np
import repro.graph as jg
import repro.shard as shard
import repro.shard.driver as sharded_driver
from repro.core import SchedulerConfig
from repro.graph.generators import edge_delta_stream
from repro.launch import taskserver
from repro.obs import Trace
from repro.server import JobRegistry, JobSpec, TaskServer
from repro.stream import StreamSpec

# the reference's unstack_ring indexes the shard-split ring on the device,
# which this JAX refuses on a multi-device mesh; read it to the host first
sharded_driver.unstack_ring = lambda ring, d: jax.tree.map(
    lambda x: np.asarray(x)[d], ring)

jobs, cli_base, cli_flags, host_keys = json.loads({spec!r})

def registry():
    reg = JobRegistry()
    reg.register_graph("rmat", jg.rmat(6, edge_factor=8, seed=0))
    reg.register_graph("grid", jg.grid2d(8, 8, seed=0))
    return reg

def specs(reg, only=None):
    out = []
    for algo, gname, params, shards, batches, weight in jobs:
        stream = None
        if batches:
            stream = StreamSpec(deltas=tuple(edge_delta_stream(
                reg.graph(gname), batches, 8, seed=1)), compact_every=2)
        out.append(JobSpec(algo, gname, dict(params), weight=weight,
                           shards=shards, stream=stream))
    return out if only is None else [out[i] for i in only]

out = {{}}
reg = registry()
trace = Trace()
server = TaskServer(reg, num_lanes=4, config=SchedulerConfig(num_workers=16),
                    trace=trace)
for s in specs(reg):
    server.submit(s)
res = server.run()
out["server"] = {{
    "results": {{str(k): np.asarray(v).tolist()
                for k, v in res.results.items()}},
    "telemetry": {{str(k): dataclasses.asdict(t)
                  for k, t in res.telemetry.items()}},
    "stats": {{k: v for k, v in dataclasses.asdict(res.stats).items()
              if k not in host_keys}},
    "rows": trace.records,
    "docs": [{{k: v for k, v in d.items() if k not in host_keys}}
             for d in trace.metrics],
}}

def raised(fn):
    try:
        fn()
    except RuntimeError as e:
        return str(e)
    return None

def overflow():
    s = TaskServer(registry(), num_lanes=2, lane_capacity=8,
                   config=SchedulerConfig(num_workers=16))
    s.submit(specs(s.registry, [0])[0])
    s.run()

real = shard.run_sharded
def misrouting(*a, **k):
    state, st = real(*a, **k)
    return state, dataclasses.replace(st, mis_routed=3)

def misrouted():
    shard.run_sharded = misrouting
    try:
        s = TaskServer(registry(), num_lanes=2,
                       config=SchedulerConfig(num_workers=16))
        s.submit(specs(s.registry, [0])[0])
        s.run()
    finally:
        shard.run_sharded = real

out["overflow"] = raised(overflow)
out["misrouted"] = raised(misrouted)
out["cli"] = []
for flags in cli_flags:
    sys.argv = ["taskserver", *cli_base, *flags]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        taskserver.main()
    out["cli"].append(buf.getvalue())
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_proc(tmp_path_factory):
    """Start the reference's server and CLI runs in one subprocess with 8
    forced host devices as the module starts; :func:`reference` waits."""
    out = tmp_path_factory.mktemp("shard_server")
    spec = json.dumps([JOBS, CLI_BASE, CLI_FLAGS, list(HOST_KEYS)])
    prog = ("import os\n"
            "os.environ['XLA_FLAGS'] = "
            "'--xla_force_host_platform_device_count=8'\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            + textwrap.dedent(_REFERENCE.format(spec=spec)))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
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


def _server(**kw):
    reg = _registry()
    server = TaskServer(reg, config=SchedulerConfig(num_workers=16),
                        device="cpu", **kw)
    return reg, server


# ----------------------------------------------------------- in process
def test_sharded_cache_entry_parses_like_jax(tmp_path):
    """``sharded`` stays out of the searched grid, and a cache that records
    a sharded config (written by hand, or by a reference tuner) parses:
    ``tune`` hands it back from the entry, ``recommend_for_mix`` from its
    key, as the reference's tuner does."""
    from repro.server import Autotuner as JTuner
    from repro.server import autotune as JA
    from repro_torch.server import Autotuner, autotune as TA

    assert "sharded" not in TA.TOPOLOGY_GRID
    assert all(policy_of(c).topology != "sharded"
               for c in TA.DEFAULT_CANDIDATES)
    key = "persistent|workers=64|fetch=1|backend=auto|topology=sharded" \
          "|granularity=4"
    import repro.graph as jg

    graph = _registry().graph("grid")
    entry = {"config": {"num_workers": 64, "fetch_size": 1,
                        "persistent": True, "backend": "auto",
                        "topology": "sharded", "granularity": 4,
                        "kernel": "auto"},
             "chosen": key, "trials": {key: 0.5}, "default_wall": 1.0}
    cache = tmp_path / "tune.json"
    cache.write_text(json.dumps({"bfs|mesh": entry}))
    tuned = Autotuner(cache_path=cache).tune("bfs", graph)
    mixed = Autotuner(cache_path=cache).recommend_for_mix([("bfs", graph)])
    jtuned = JTuner(cache_path=cache).tune("bfs", jg.grid2d(8, 8, seed=0))
    for cfg in (tuned, mixed):
        assert policy_of(cfg).topology == "sharded"
        assert (cfg.num_workers, cfg.fetch_size, cfg.granularity,
                cfg.backend) == (64, 1, 4, "auto")
        assert TA._config_key(cfg) == key
    assert JA._config_key(jtuned) == key
    assert dataclasses.asdict(TA._parse_config_key(key)) == \
        dataclasses.asdict(tuned)


def test_server_mesh_placement():
    """A CPU server puts a job's shards on the CPU; ``shard_devices`` names
    them (too few raise); a card server without them asks for one card a
    shard, and raises here naming ``devices=``."""
    _, server = _server()
    cfg = SchedulerConfig(num_workers=16, num_shards=4, mesh_shape=(2, 2))
    mesh = server._shard_mesh(cfg)
    assert mesh.devices == (torch.device("cpu"),) * 4 and mesh.dims == (2, 2)
    _, named = _server(shard_devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="given 2"):
        named._shard_mesh(cfg)
    if not torch.cuda.is_available():
        card = TaskServer(JobRegistry(), device="cpu")
        card.device = torch.device("cuda")
        with pytest.raises(RuntimeError, match="devices="):
            card._shard_mesh(cfg)


# ------------------------------------------------ against the reference
def test_sharded_server_matches_jax(reference):
    """Sharded BFS, sharded streaming BFS and two fused tenants, traced:
    every result, telemetry record, the server stats, the trace rows and
    the summary docs equal the reference's."""
    want = reference["server"]
    reg, server = _server(num_lanes=4, trace=(trace := Trace()))
    for spec in _specs(JobSpec, StreamSpec, edge_delta_stream, reg):
        server.submit(spec)
    res = server.run()
    for k, v in res.results.items():
        np.testing.assert_array_equal(v, np.asarray(want["results"][str(k)]))
    assert {str(k): dataclasses.asdict(t)
            for k, t in res.telemetry.items()} == want["telemetry"]
    stats = {k: v for k, v in dataclasses.asdict(res.stats).items()
             if k not in HOST_KEYS}
    assert stats == want["stats"]
    assert stats["sharded_jobs"] == 1 and stats["streaming_jobs"] == 1
    assert stats["sharded_rounds"] == res.telemetry[0].rounds_active > 0
    assert trace.records == want["rows"]
    assert _docs(trace) == want["docs"]
    engines = {r["engine"] for r in trace.records}
    assert {"server", "server.job0.sharded", "server.job2.stream"} <= engines
    assert res.telemetry[0].wavefront == 16 * 2
    assert res.telemetry[2].wavefront == 16 * 4


def test_sharded_job_raises_like_jax(reference, monkeypatch):
    """Replica overflow under ``strict_drops`` and a drain that reports
    mis-routed tasks both raise the reference's ``RuntimeError``."""
    import repro_torch.shard as shard

    reg = _registry()
    spec = _specs(JobSpec, StreamSpec, edge_delta_stream, reg)[0]
    server = TaskServer(reg, num_lanes=2, lane_capacity=8,
                        config=SchedulerConfig(num_workers=16), device="cpu")
    server.submit(spec)
    with pytest.raises(RuntimeError) as exc:
        server.run()
    assert reference["overflow"] and str(exc.value) == reference["overflow"]

    real = shard.run_sharded

    def misrouting(*a, **k):
        state, st = real(*a, **k)
        return state, dataclasses.replace(st, mis_routed=3)

    monkeypatch.setattr(shard, "run_sharded", misrouting)
    server = TaskServer(reg, num_lanes=2,
                        config=SchedulerConfig(num_workers=16), device="cpu")
    server.submit(spec)
    with pytest.raises(RuntimeError) as exc:
        server.run()
    assert reference["misrouted"] and \
        str(exc.value) == reference["misrouted"]


@pytest.mark.parametrize("case", range(len(CLI_FLAGS)),
                         ids=["-".join(f.strip("-") for f in flags)
                              for flags in CLI_FLAGS])
def test_cli_sharding_flags_print_the_jax_table(case, reference, capsys):
    """``--shards``, ``--mesh``, ``--overlap`` and ``--compress`` (with
    ``--stream`` where the reference runs it) on ``--device cpu``: every
    printed line equals the reference CLI's, wall aside."""
    from repro_torch.launch import taskserver

    taskserver.main([*CLI_BASE, *CLI_FLAGS[case], "--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    theirs = reference["cli"][case].splitlines()

    def strip(lines):
        return [line.split(" wall=")[0] for line in lines]

    assert strip(mine) == strip(theirs)
    assert any(line.startswith(("sharded phases:", "streaming phases:"))
               for line in mine)


def test_cli_sharding_flag_errors(capsys):
    """A contradicting ``--shards`` / ``--mesh``, the mesh flags under
    ``--autotune`` and a short ``--shard-devices`` exit with usage errors;
    ``--shards`` on the card without ``--shard-devices`` asks for one card
    a shard."""
    from repro_torch.launch import taskserver

    for flags, msg in ((["--shards", "3", "--mesh", "2", "2"], "contradicts"),
                       (["--mesh", "2", "2", "--autotune"], "--autotune"),
                       (["--shards", "4", "--shard-devices", "cpu,cpu"],
                        "--shard-devices")):
        with pytest.raises(SystemExit) as exc:
            taskserver.main([*CLI_BASE, "--device", "cpu", *flags])
        assert exc.value.code == 2
        assert msg in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            taskserver.main([*CLI_BASE, "--shards", "2"])
