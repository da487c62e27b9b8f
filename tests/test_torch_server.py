"""The multi-tenant task server (ROADMAP A11) on the CPU, against the JAX
package's: fairness policies on seeded sizes, weights and boost masks; the
fused server under ``weighted`` at g1 and g4 and ``round_robin`` (results,
every telemetry field, ``ServerStats`` but wall, and the traced rows);
``serve_sequential``; backpressure, deferred admission and FIFO order on a
flood program; a streaming tenant; the autotuner's cost model and picks;
the CLI.  Everything is bit for bit except ``GraphStats``, which the port
reduces in float32 in another order than XLA (held within 1e-5 relative),
and what follows from it.  The reference runs once per module."""
import dataclasses
import json
import logging
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
from repro.core import SchedulerConfig as JConfig
from repro.server import JobRegistry as JRegistry
from repro.server import JobSpec as JSpec
from repro.server import Program as JProgram
from repro.server import TaskServer as JServer
from repro.server import make_policy as j_make_policy
from repro.server import serve_sequential as j_serve_sequential
from repro_torch.convert import graph_from_numpy
from repro_torch.core import SchedulerConfig
from repro_torch.server import (JobRegistry, JobSpec, Program, TaskServer,
                                make_policy, serve_sequential)

W16 = dict(num_workers=16, fetch_size=1)
MIX = [
    ("bfs", "grid", {"source": 0}, 1.0),
    ("bfs", "rmat", {"source": 3}, 1.0),
    ("pagerank", "grid", {"eps": 1e-5}, 1.0),
    ("coloring", "rmat", {}, 1.0),
    ("bfs", "grid", {"source": 17}, 2.0),
    ("coloring", "grid", {}, 1.0),
    ("pagerank", "rmat", {"eps": 1e-5}, 1.0),
    ("bfs", "rmat", {"source": 9}, 1.0),
]
CELLS = {"weighted.g1": ("weighted", 1), "weighted.g4": ("weighted", 4),
         "round_robin.g1": ("round_robin", 1)}


@pytest.fixture(scope="module")
def registries():
    jgraphs = {"grid": jg.grid2d(8, 8), "rmat": jg.rmat(6, edge_factor=4,
                                                        seed=1)}
    jreg, treg = JRegistry(), JobRegistry()
    for name, g in jgraphs.items():
        jreg.register_graph(name, g)
        treg.register_graph(name, graph_from_numpy(
            np.asarray(g.row_ptr), np.asarray(g.col_idx), device="cpu"))
    return jreg, treg


def _specs(Spec, mix=MIX):
    return [Spec(a, g, dict(p), weight=w) for a, g, p, w in mix]


def _serve(registry, Spec, Server, Config, policy, g, trace=None,
           mix=MIX, **kw):
    server = Server(registry, num_lanes=8,
                    config=Config(**W16, granularity=g), policy=policy,
                    trace=trace, **kw)
    for spec in _specs(Spec, mix):
        server.submit(spec)
    return server.run()


@pytest.fixture(scope="module")
def jax_runs(registries):
    """The reference's fused runs, each traced (tracing does not change a
    run's results, which the reference's own tests hold)."""
    from repro.obs import Trace as JTrace

    jreg, _ = registries
    out = {}
    for cell, (policy, g) in CELLS.items():
        trace = JTrace()
        out[cell] = (_serve(jreg, JSpec, JServer, JConfig, policy, g,
                            trace=trace), trace)
    return out


def _stats(result):
    d = dataclasses.asdict(result.stats)
    d.pop("wall_seconds")
    return d


def _assert_same_result(want, got):
    assert sorted(want.results) == sorted(got.results)
    for i in want.results:
        np.testing.assert_array_equal(got.results[i],
                                      np.asarray(want.results[i]))
        assert got.telemetry[i].as_dict() == want.telemetry[i].as_dict(), i
    assert _stats(got) == _stats(want)


# ----------------------------------------------------------------- policies
@pytest.mark.parametrize("name", ["weighted", "round_robin",
                                  "longest_queue_first"])
def test_policies_allocate_like_jax(name):
    """40 seeded rounds through one policy object each (the rotation and
    cursor carry state): scarce and ample budgets, empty and boosted
    lanes, uneven weights."""
    rng = np.random.default_rng(7)
    jpol, tpol = j_make_policy(name), make_policy(name)
    for _ in range(40):
        lanes = int(rng.integers(1, 9))
        sizes = rng.integers(0, 40, lanes) * (rng.random(lanes) < 0.8)
        weights = rng.choice([1.0, 2.0, 3.0, 0.5], lanes)
        boosted = rng.random(lanes) < 0.25
        budget = int(rng.choice([1, 3, lanes, 16, 64, 1000]))
        want = jpol.allocate(sizes, weights, boosted, budget)
        got = tpol.allocate(sizes, weights, boosted, budget)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- fused server
@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
@pytest.mark.parametrize("cell", list(CELLS))
def test_server_matches_jax(registries, jax_runs, cell, traced):
    """Results, every JobTelemetry field (``as_dict``) and ServerStats but
    wall, bit for bit; traced, the ring's rows (lane, round, queue size,
    pops, pushes, work; engine ``server``) and the server/job docs too."""
    from repro_torch.obs import Trace

    _, treg = registries
    policy, g = CELLS[cell]
    want, jtrace = jax_runs[cell]
    trace = Trace() if traced else None
    got = _serve(treg, JobSpec, TaskServer, SchedulerConfig, policy, g,
                 trace=trace, device="cpu")
    _assert_same_result(want, got)
    if traced:
        assert trace.records == jtrace.records
        assert trace.truncated == jtrace.truncated == 0

        def docs(t):
            return [{k: v for k, v in d.items() if k != "wall_seconds"}
                    for d in t.metrics]
        assert docs(trace) == docs(jtrace)
        assert {k: h.to_doc() for k, h in trace.histograms.items()} == \
            {k: h.to_doc() for k, h in jtrace.histograms.items()}


def test_serve_sequential_matches_jax(registries):
    jreg, treg = registries
    cfg = dict(**W16)
    want = j_serve_sequential(jreg, _specs(JSpec), config=JConfig(**cfg))
    got = serve_sequential(treg, _specs(JobSpec),
                           config=SchedulerConfig(**cfg), device="cpu")
    _assert_same_result(want, got)


def test_round_robin_equals_sequential_and_fused_beats_it(registries,
                                                          jax_runs):
    """Whole-wavefront rotation never changes a job's own wavefronts: the
    round_robin server equals the tenant-at-a-time run bitwise, in rounds
    too; the weighted server takes fewer rounds."""
    _, treg = registries
    rr = _serve(treg, JobSpec, TaskServer, SchedulerConfig, "round_robin",
                1, device="cpu")
    seq = serve_sequential(treg, _specs(JobSpec),
                           config=SchedulerConfig(**W16), device="cpu")
    for i in seq.results:
        np.testing.assert_array_equal(rr.results[i], seq.results[i])
    assert rr.stats.rounds == seq.stats.rounds
    assert jax_runs["weighted.g1"][0].stats.rounds < seq.stats.rounds


# --------------------------------------- backpressure, admission, id space
def _flood(limit, fanout, kind):
    """Every popped task v < limit emits ``fanout`` copies of v + 1: floods
    a small lane."""
    if kind == "jax":
        def f(items, valid, state):
            emit = valid & (items < limit)
            out = jnp.concatenate([jnp.where(emit, items + 1, 0)] * fanout)
            mask = jnp.concatenate([emit] * fanout)
            return out, mask, state + jnp.sum(valid.astype(jnp.int32))

        return JProgram(
            algorithm="flood", graph_name="synthetic", graph=None,
            init=lambda: (jnp.int32(0), jnp.array([1], jnp.int32)),
            wavefront_fn=f, result=lambda s: np.asarray([int(s)]),
            work=lambda s: s, ideal_work=limit)

    def f(items, valid, state):
        emit = valid & (items < limit)
        out = torch.cat([torch.where(emit, items + 1, 0)] * fanout)
        mask = torch.cat([emit] * fanout)
        return out, mask, state + valid.sum(dtype=torch.int32)

    return Program(
        algorithm="flood", graph_name="synthetic", graph=None,
        init=lambda: (torch.zeros((), dtype=torch.int32),
                      torch.tensor([1], dtype=torch.int32)),
        wavefront_fn=f, result=lambda s: np.asarray([int(s)]),
        work=lambda s: s, ideal_work=limit)


@pytest.mark.parametrize("lanes,jobs,capacity,limit,fanout", [
    (1, 1, 8, 16, 3),      # backpressure detected and drained
    (2, 3, 8, 16, 3),      # the third tenant waits; admission deferred
    (1, 3, 64, 4, 1),      # FIFO admission, no drops
])
def test_flood_backpressure_and_admission_match_jax(lanes, jobs, capacity,
                                                    limit, fanout):
    out = {}
    for kind, Server, Config, kw in (
            ("jax", JServer, JConfig, {}),
            ("torch", TaskServer, SchedulerConfig, {"device": "cpu"})):
        server = Server(JRegistry() if kind == "jax" else JobRegistry(),
                        num_lanes=lanes,
                        config=Config(num_workers=4, fetch_size=1),
                        lane_capacity=capacity, strict_drops=False, **kw)
        for _ in range(jobs):
            server.submit_program(_flood(limit, fanout, kind))
        out[kind] = server.run()
    _assert_same_result(out["jax"], out["torch"])
    tel = out["torch"].telemetry
    admitted = [tel[i].admitted_round for i in range(jobs)]
    assert admitted == sorted(admitted)
    if capacity == 8:
        assert tel[0].dropped > 0 and tel[0].backpressure_events > 0
    if jobs > lanes and capacity == 8:
        assert out["torch"].stats.deferred_admissions > 0


def test_strict_drops_fail_loudly_by_default():
    server = TaskServer(JobRegistry(), num_lanes=1,
                        config=SchedulerConfig(num_workers=4),
                        lane_capacity=8, device="cpu")
    server.submit_program(_flood(16, 3, "torch"))
    with pytest.raises(RuntimeError, match="dropped .* lane overflow"):
        server.run()


def test_job_id_space_bounded_at_submit_time():
    server = TaskServer(JobRegistry(), num_lanes=1, device="cpu")
    prog = _flood(2, 1, "torch")
    for _ in range(128):
        server.submit_program(prog)
    with pytest.raises(ValueError, match="job id space exhausted"):
        server.submit_program(prog)


def test_registry_rejects_unknowns(registries):
    _, treg = registries
    with pytest.raises(KeyError):
        treg.graph("nope")
    with pytest.raises(ValueError):
        JobSpec("dijkstra", "grid")
    with pytest.raises(ValueError):
        JobSpec("bfs", "grid", weight=0.0)
    with pytest.raises(ValueError):
        treg.build(JobSpec("bfs", "grid", {"bogus": 1}), 0, 16, 16, 512)
    with pytest.raises(ValueError, match="register_graph|already"):
        treg.register_graph("grid", treg.graph("grid"))


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("spec", [
    ("bfs", "grid", {"source": 1}), ("bfs", "grid", {"source": 2}),
    ("pagerank", "rmat", {"eps": 1e-5}), ("coloring", "rmat", {})],
    ids=["bfs.source1", "bfs.source2", "pagerank", "coloring"])
def test_registry_builds_each_job_from_its_params(registries, spec):
    """Each job's program comes from its own params: its initial result,
    seed tasks and ideal work equal the reference registry's."""
    jreg, treg = registries
    algo, graph, params = spec
    jp = jreg.build(JSpec(algo, graph, dict(params)), 3, 16, 16, 512)
    tp = treg.build(JobSpec(algo, graph, dict(params)), 3, 16, 16, 512,
                    backend="torch")
    (js, jseeds), (ts, tseeds) = jp.init(), tp.init()
    assert np.array_equal(_np(tp.result(ts)), _np(jp.result(js)))
    assert np.array_equal(_np(tseeds), _np(jseeds))
    assert tp.ideal_work == jp.ideal_work


def test_graph_on_another_device_than_the_server_raises(registries,
                                                        monkeypatch):
    """The server refuses a registered graph that lives elsewhere (here a
    server said to run on the card, over the CPU registry)."""
    import repro_torch.server.engine as engine

    _, treg = registries
    monkeypatch.setattr(engine, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    server = TaskServer(treg, device="cuda")
    server.submit(JobSpec("bfs", "grid", {"source": 0}))
    with pytest.raises(ValueError, match="lives on cpu"):
        server.run()


# ------------------------------------------------- streaming and megakernel
STREAM_MIX = [("bfs", "grid", {"source": 0}, 1.0),
              ("coloring", "rmat", {}, 1.0),
              ("bfs", "rmat", {"source": 5}, 2.0)]


def _stream_server(kind, registry, kernel):
    if kind == "jax":
        from repro.graph.generators import edge_delta_stream
        from repro.stream import StreamSpec
        Spec, Server, Config, kw = JSpec, JServer, JConfig, {}
    else:
        from repro_torch.graph import edge_delta_stream
        from repro_torch.stream import StreamSpec
        Spec, Server, Config, kw = (JobSpec, TaskServer, SchedulerConfig,
                                    {"device": "cpu"})
    deltas = edge_delta_stream(registry.graph("rmat"), 2, 12, seed=3)
    server = Server(registry, num_lanes=2,
                    config=Config(**W16, kernel=kernel), **kw)
    server.submit(Spec("bfs", "rmat", {"source": 1},
                       stream=StreamSpec(deltas=tuple(deltas),
                                         compact_every=2)))
    for spec in _specs(Spec, STREAM_MIX):
        server.submit(spec)
    return server, server.run()


def _batch_records(job):
    keep = ("batch", "incremental", "seeds", "effective_ops", "rounds",
            "processed", "work", "splits", "dropped", "touched_rows",
            "overlay", "compacted")
    return [{k: getattr(b, k) for k in keep}
            for b in job.stream_result.batches]


def test_streaming_tenant_matches_jax(registries):
    """A streaming BFS tenant (2 delta batches, served as a phase before
    the fused rounds) beside three batch tenants: results, telemetry,
    stats and the stream's batch records equal JAX's."""
    jreg, treg = registries
    jserver, want = _stream_server("jax", jreg, "auto")
    tserver, got = _stream_server("torch", treg, "auto")
    _assert_same_result(want, got)
    assert got.stats.streaming_jobs == 1 and got.stats.stream_batches == 3
    assert _batch_records(tserver.jobs[0]) == \
        _batch_records(jserver._jobs[0])


def test_megakernel_request_logs_and_runs_per_round(registries, caplog):
    """``kernel="megakernel"`` logs the reference's warning and runs the
    per-round steps: the batch tenants equal the persistent server's bit
    for bit, the stream (plain fused drains on the CPU) its result."""
    _, treg = registries
    with caplog.at_level(logging.WARNING, logger="repro_torch.server"):
        mserver, mega = _stream_server("torch", treg, "megakernel")
    assert any("megakernel" in r.message and "per-round" in r.message
               for r in caplog.records)
    _, base = _stream_server("torch", treg, "auto")
    _assert_same_result(base, mega)


# -------------------------------------------------------------- autotuner
def _port_cfg(jcfg):
    """A JAX candidate under the backend-name map jnp -> torch, pallas ->
    cuda; a megakernel candidate keeps the port's ``auto`` (its drain
    kernel on the card, the plain fused drain on the host)."""
    backend = ("auto" if jcfg.kernel == "megakernel"
               else {"jnp": "torch", "pallas": "cuda"}[jcfg.backend])
    return SchedulerConfig(
        num_workers=jcfg.num_workers, fetch_size=jcfg.fetch_size,
        persistent=jcfg.persistent, backend=backend,
        topology=jcfg.topology, granularity=jcfg.granularity,
        kernel=jcfg.kernel)


def _graph_pairs(registries):
    jreg, treg = registries
    extra = jg.rmat(8, edge_factor=8, seed=2)
    pairs = [(jreg.graph(n), treg.graph(n)) for n in ("grid", "rmat")]
    pairs.append((extra, graph_from_numpy(np.asarray(extra.row_ptr),
                                          np.asarray(extra.col_idx),
                                          device="cpu")))
    return pairs


def test_graph_stats_class_and_cost_model_match_jax(registries,
                                                    monkeypatch):
    """``GraphStats`` within 1e-5 relative (float32 reductions in another
    order); ``graph_class`` equal; ``predict_cost`` and the untied
    structural cost bit for bit when fed the reference's features, and
    within 1e-5 from the port's own; the default grid is the reference's
    under the name map."""
    import repro.server.autotune as jat
    import repro_torch.server.autotune as tat

    assert [tat._config_key(_port_cfg(c)) for c in jat.DEFAULT_CANDIDATES] \
        == [tat._config_key(c) for c in tat.DEFAULT_CANDIDATES]
    assert tat.BACKEND_GRID == ("torch", "cuda")
    for jgraph, tgraph in _graph_pairs(registries):
        js, ts = jat.graph_stats(jgraph), tat.graph_stats(tgraph)
        jd, td = dataclasses.asdict(js), dataclasses.asdict(ts)
        assert jd.keys() == td.keys()
        for k in jd:
            assert td[k] == pytest.approx(jd[k], rel=1e-5), k
        assert tat.graph_class(tgraph) == jat.graph_class(jgraph)
        same = tat.GraphStats(**jd)
        for jc, tc in zip(jat.DEFAULT_CANDIDATES, tat.DEFAULT_CANDIDATES):
            assert tat.predict_cost(tc, same) == jat.predict_cost(jc, js)
            assert tat.predict_cost(tc, ts) == pytest.approx(
                jat.predict_cost(jc, js), rel=1e-5)
            for algo in ("bfs", "coloring", "pagerank"):
                jcost = jat.structural_cost_runner(algo, jgraph, jc)
                jtie = 1.0 + (zlib.crc32(jat._config_key(jc).encode())
                              % 997) * 1e-9
                assert tat.structural_cost(algo, tgraph, tc) * jtie == \
                    pytest.approx(jcost, rel=1e-5)
                with monkeypatch.context() as m:
                    m.setattr(tat, "graph_stats", lambda g: same)
                    assert tat.structural_cost(algo, tgraph, tc) * jtie \
                        == jcost


#: candidates with no exact structural ties (distinct strategy and lane
#: counts): JAX's CRC tiebreak hashes its backend names, the port's its
#: own, so only untied costs can pick alike
UNTIED = [JConfig(), JConfig(num_workers=16), JConfig(fetch_size=4),
          JConfig(num_workers=16, persistent=False),
          JConfig(persistent=False),
          JConfig(num_workers=256, granularity=4),
          JConfig(num_workers=16, kernel="megakernel"),
          JConfig(kernel="megakernel", granularity=4)]


@pytest.mark.parametrize("search", ["grid", "sh"])
def test_autotuner_picks_match_jax_under_the_name_map(registries, tmp_path,
                                                      search):
    from repro.server import Autotuner as JTuner
    from repro.server import structural_cost_runner as j_runner
    from repro_torch.server import Autotuner, structural_cost_runner

    jreg, treg = registries
    for name in ("grid", "rmat"):
        for algo in ("bfs", "coloring"):
            costs = sorted(j_runner(algo, jreg.graph(name), c)
                           for c in UNTIED)
            assert all(b > a * (1 + 1e-6) for a, b in zip(costs, costs[1:]))
            jt = JTuner(cache_path=tmp_path / f"j_{name}_{algo}.json",
                        candidates=UNTIED, warmup=0, iters=1,
                        runner=j_runner, search=search)
            tt = Autotuner(cache_path=tmp_path / f"t_{name}_{algo}.json",
                           candidates=[_port_cfg(c) for c in UNTIED],
                           warmup=0, iters=1,
                           runner=structural_cost_runner, search=search)
            assert tt.tune(algo, treg.graph(name)) == \
                _port_cfg(jt.tune(algo, jreg.graph(name)))
            jentry = json.loads((tmp_path / f"j_{name}_{algo}.json")
                                .read_text())
            tentry = json.loads((tmp_path / f"t_{name}_{algo}.json")
                                .read_text())
            (jk, je), = jentry.items()
            (tk, te), = tentry.items()
            assert jk == tk
            for field in ("schema", "search", "cells_total",
                          "cells_measured", "calibration_graph"):
                assert te[field] == je[field], field


def test_autotuner_skips_cuda_on_the_host_and_reloads_its_cache(
        registries, tmp_path, caplog):
    """On a CPU graph the ``cuda`` half of the default grid is skipped and
    logged; the cache is written, a second tune and a fresh tuner hit it
    without measuring, and the mix recommendation reads it."""
    from repro_torch.server import (Autotuner, DEFAULT_CANDIDATES,
                                    structural_cost_runner)

    _, treg = registries
    calls = []

    def runner(algorithm, graph, cfg):
        calls.append(cfg)
        return structural_cost_runner(algorithm, graph, cfg)

    cache = tmp_path / "tune.json"
    tuner = Autotuner(cache_path=cache, warmup=0, iters=1, runner=runner)
    with caplog.at_level(logging.INFO,
                         logger="repro_torch.server.autotune"):
        chosen = tuner.tune("bfs", treg.graph("grid"))
    assert any("skipped 24 candidates" in r.message for r in caplog.records)
    assert calls and all(c.backend != "cuda" for c in calls)
    entry = json.loads(cache.read_text())["bfs|mesh"]
    assert entry["cells_total"] == len(DEFAULT_CANDIDATES) - 24
    assert entry["cells_measured"] <= entry["cells_total"] // 4
    assert len(entry["cells_skipped"]) == 24
    assert "persistent|workers=64|fetch=1|backend=torch" in entry["trials"]
    n_calls = len(calls)

    def exploding(*a):
        raise AssertionError("a cache hit must not measure")

    assert tuner.tune("bfs", treg.graph("grid")) == chosen
    fresh = Autotuner(cache_path=cache, warmup=0, iters=1, runner=exploding)
    assert fresh.tune("bfs", treg.graph("grid")) == chosen
    assert len(calls) == n_calls
    assert fresh.recommend_for_mix([("bfs", treg.graph("grid"))]) == chosen


def test_autotuner_real_calibration_smoke(registries, tmp_path):
    """The default runner on the host: two candidates, the winner's
    measured wall no worse than the default's."""
    from repro_torch.server import Autotuner

    _, treg = registries
    tuner = Autotuner(cache_path=tmp_path / "tune.json",
                      candidates=[SchedulerConfig(backend="torch"),
                                  SchedulerConfig(num_workers=16,
                                                  backend="torch")],
                      warmup=1, iters=1)
    tuner.tune("bfs", treg.graph("grid"))
    entry = json.loads((tmp_path / "tune.json").read_text())["bfs|mesh"]
    assert entry["trials"][entry["chosen"]] <= entry["default_wall"]


# -------------------------------------------------------------------- CLI
def test_cli_runs_on_the_host_and_prints_the_reference_format(capsys):
    """``main()`` at ``--device cpu``: the telemetry table and the
    ``server:`` / ``sequential:`` lines come out in the reference's format
    (its own printer on the port's result gives the same text), and the
    fused rounds are below the sequential rounds."""
    from repro.launch.taskserver import print_telemetry as j_print
    from repro_torch.launch import taskserver

    taskserver.main(["--jobs", "8", "--scale", "6", "--grid-side", "8",
                     "--device", "cpu", "--compare-sequential"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    server_line = next(l for l in lines if l.startswith("server: "))
    seq_line = next(l for l in lines if l.startswith("sequential: "))
    fused = int(server_line.split("rounds=")[1].split()[0])
    seq = int(seq_line.split("rounds=")[1].split()[0])
    assert fused < seq
    reg = taskserver.build_registry(6, 8, 0, device="cpu")
    server = TaskServer(reg, num_lanes=8,
                        config=SchedulerConfig(num_workers=64),
                        device="cpu")
    for spec in taskserver.mixed_specs(8, reg, 1e-4, 0):
        server.submit(spec)
    result = server.run()
    taskserver.print_telemetry(result)
    mine = capsys.readouterr().out
    j_print(result)
    theirs = capsys.readouterr().out
    assert mine == theirs
    assert mine.splitlines()[:10] == lines[1:11]  # the table, wall aside

