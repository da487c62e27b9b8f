"""The port's observability layer (ROADMAP A10) against the reference's.

  * the ring: ``repro_torch.obs.TraceRing`` against a ``deque(maxlen=cap)``
    model (the cases of ``tests/test_obs.py`` and its seeded sweep), and
    ``record`` returning a new buffer, so a predicated round that did not
    run leaves no row;
  * schema, histograms and exporters: the same constants, validators that
    decide alike, and the port's JSONL and Chrome trace accepted by BOTH
    packages' validators;
  * tracing identity over the port's single/fused x persistent/discrete/
    megakernel cells at g1 and g4: results, RunStats and info equal the
    untraced run, one row per round, and the rows equal JAX's on every
    non-megakernel cell; the empty run, capacity truncation, the ``run``
    doc, the discrete driver's legacy list and the BSP drivers' per-sweep
    lists against JAX's.
"""
import json
import random
from collections import deque

import numpy as np
import pytest
import torch

import repro.graph as jg
import repro.obs as jobs
from repro.algorithms import coloring as jcol
from repro.algorithms import pagerank as jpr
from repro.core import SchedulerConfig as JConfig
from repro.runtime import build_program as j_build
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro_torch import obs
from repro_torch.algorithms import coloring as tcol
from repro_torch.algorithms import pagerank as tpr
from repro_torch.convert import graph_from_numpy
from repro_torch.core import SchedulerConfig
from repro_torch.core.tree import tree_map, tree_where
from repro_torch.obs import (LatencyHistogram, Trace, TraceRing, ring_rows,
                             stacked_rings, unstack_ring)
from repro_torch.obs.schema import NUM_FIELDS, TRACE_FIELDS
from repro_torch.runtime import build_program, config_for, parse_policy
from repro_torch.runtime.api import drain_setup, execute


@pytest.fixture(scope="module")
def graphs():
    jgraph = jg.rmat(6, edge_factor=4, seed=1)
    return jgraph, graph_from_numpy(np.asarray(jgraph.row_ptr),
                                    np.asarray(jgraph.col_idx), device="cpu")


# ------------------------------------------------------------- ring model
def _check_against_model(capacity, values):
    ring = TraceRing.make(capacity, device="cpu")
    model = deque(maxlen=capacity)
    for i, v in enumerate(values):
        ring = ring.record(round=i, work=v)
        model.append((i, v))
    rows, truncated = ring_rows(ring)
    assert truncated == max(0, len(values) - capacity)
    assert [(r["round"], r["work"]) for r in rows] == list(model)
    for r in rows:
        assert all(r[f] == 0 for f in TRACE_FIELDS
                   if f not in ("round", "work"))


def test_ring_empty():
    assert ring_rows(TraceRing.make(4, device="cpu")) == ([], 0)


def test_ring_partial_fill_keeps_order():
    _check_against_model(8, [10, 20, 30])


def test_ring_exact_fill_boundary():
    _check_against_model(4, [1, 2, 3, 4])


def test_ring_wraparound_keeps_newest():
    ring = TraceRing.make(3, device="cpu")
    for i in range(7):
        ring = ring.record(round=i, pops=torch.tensor(i * 10))
    rows, truncated = ring_rows(ring)
    assert truncated == 4
    assert [r["round"] for r in rows] == [4, 5, 6]
    assert [r["pops"] for r in rows] == [40, 50, 60]


@pytest.mark.parametrize("seed", [0, 1])
def test_ring_seeded_model_sweep(seed):
    rng = random.Random(seed)
    for capacity in (1, 2, 3, 5, 8):
        for n in (0, 1, capacity - 1, capacity, capacity + 1,
                  3 * capacity + 2):
            _check_against_model(
                capacity, [rng.randrange(-2**31, 2**31) for _ in range(n)])


def test_ring_rejects_unknown_field_and_bad_capacity():
    with pytest.raises(ValueError, match="unknown trace fields"):
        TraceRing.make(2, device="cpu").record(bogus=1)
    with pytest.raises(ValueError, match="capacity"):
        TraceRing.make(0, device="cpu")


def test_record_returns_a_new_buffer_so_skipped_rounds_leave_no_row():
    """A predicated round that does not run must not write: ``record``
    leaves its operand untouched, and ``tree_where`` on a false flag keeps
    the old ring even after the ring has wrapped."""
    ring = TraceRing.make(2, device="cpu")
    for i in range(3):
        ring = ring.record(round=i, work=i)
    before = ring.buf.clone()
    stepped = ring.record(round=99, work=99)
    assert torch.equal(ring.buf, before) and int(ring.cursor) == 3
    kept = tree_where(torch.tensor(False), stepped, ring)
    assert ring_rows(kept) == ring_rows(ring)
    taken = tree_where(torch.tensor(True), stepped, ring)
    assert [r["round"] for r in ring_rows(taken)[0]] == [2, 99]


def test_stacked_ring_round_trip():
    ring = TraceRing.make(4, device="cpu").record(round=0, work=7)
    stacked = stacked_rings(ring, 3)
    assert stacked.buf.shape == (3, 4, NUM_FIELDS)
    for d in range(3):
        rows, _ = ring_rows(unstack_ring(stacked, d))
        assert [(r["round"], r["work"]) for r in rows] == [(0, 7)]


# ------------------------------------------- schema, histogram, exporters
def test_schema_constants_are_the_references():
    assert obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert obs.TRACE_FIELDS == jobs.TRACE_FIELDS and NUM_FIELDS == 13
    assert obs.KINDS == jobs.KINDS
    assert obs.BENCH_META_KEYS == jobs.BENCH_META_KEYS
    assert obs.DEFAULT_CAPACITY == jobs.DEFAULT_CAPACITY


def _docs():
    """Valid and invalid metric documents, the bool-is-not-int trap
    included."""
    span = {"schema": 1, "kind": "span", "name": "x", "ts_us": 0.0,
            "dur_us": 1.5}
    row = dict({f: 0 for f in TRACE_FIELDS}, schema=1, kind="round",
               engine="e")
    return [span, dict(span, extra="ok"), {"schema": 1, "kind": "nope"},
            dict(span, schema=999), {k: v for k, v in span.items()
                                     if k != "dur_us"},
            row, dict(row, pops=True), dict(row, pops=1.5),
            dict(obs.default_meta(), schema=1, kind="meta"),
            dict(jobs.default_meta(), schema=1, kind="meta")]


def _verdict(fn, doc):
    try:
        fn(doc)
    except ValueError as e:
        return str(e)
    return None


def test_validators_decide_alike():
    for doc in _docs():
        assert _verdict(obs.validate_metric, doc) == _verdict(
            jobs.validate_metric, doc)
    lines = [json.dumps(d) for d in _docs()[:2]] + ["", "{not json"]
    assert _verdict(obs.validate_metrics_jsonl, lines) == _verdict(
        jobs.validate_metrics_jsonl, lines)
    for doc in ({}, {"traceEvents": [{"name": "x", "ph": "M"}]},
                {"traceEvents": [{"name": "x", "ph": "X", "pid": 1,
                                  "tid": 0, "ts": 0}]}):
        assert _verdict(obs.validate_chrome_trace, doc) == _verdict(
            jobs.validate_chrome_trace, doc) is not None
    meta = {"git_sha": "a", "jax_version": "b", "device_kind": "c",
            "python": "d", "schema": 1}
    for doc in ({"meta": meta}, {}, {"meta": dict(meta, schema=0)}):
        assert _verdict(obs.validate_bench, doc) == _verdict(
            jobs.validate_bench, doc)


def test_histogram_matches_the_references():
    rng = np.random.default_rng(3)
    for samples in ([], [7], list(range(1, 101)),
                    list(rng.integers(0, 1000, size=257))):
        t, j = LatencyHistogram("h"), jobs.LatencyHistogram("h")
        t.extend(samples)
        j.extend(samples)
        assert t.to_doc() == j.to_doc()
        for q in (1, 50, 95, 99, 100):
            assert t.percentile(q) == j.percentile(q)


def test_chrome_trace_and_jsonl_match_the_references(tmp_path):
    recs = []
    for engine in ("alpha", "beta"):
        for rnd in range(3):
            recs.append(dict({f: rnd for f in TRACE_FIELDS}, lane=1,
                             engine=engine))
    spans = [obs.metric_doc("span", name="compile", ts_us=3.0, dur_us=9.0)]
    assert obs.chrome_trace(recs, spans, meta={"git_sha": "x"}) == \
        jobs.chrome_trace(recs, spans, meta={"git_sha": "x"})
    path = obs.write_jsonl(tmp_path / "m.jsonl", spans)
    assert obs.read_jsonl(path) == jobs.read_jsonl(path) == spans
    obs.atomic_write_text(tmp_path / "m.jsonl", "two")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.jsonl"]


def test_default_meta_stamps_torch_and_says_jax_is_absent():
    meta = obs.default_meta()
    assert "jax" in meta["jax_version"] and "not" in meta["jax_version"]
    assert meta["torch_version"] == torch.__version__
    assert meta["device_kind"] == ("cpu" if not torch.cuda.is_available()
                                   else torch.cuda.get_device_name())
    jobs.validate_metric(dict(meta, schema=1, kind="meta"))


def test_port_files_pass_both_validators(graphs, tmp_path):
    """A traced fused drain written by the port: the JSONL and the Chrome
    trace pass the port's and the reference's validators."""
    _, graph = graphs
    cfg = config_for(SchedulerConfig(num_workers=16),
                     parse_policy("fused.persistent.g4"))
    trace = Trace(meta={"git_sha": "abc"})
    execute(build_program("bfs", graph, cfg, params={"source": 0}), graph,
            cfg, trace=trace)
    trace.histogram("latency").extend([3, 1, 2])
    trace.write(tmp_path / "t.json", tmp_path / "m.jsonl")
    lines = (tmp_path / "m.jsonl").read_text().splitlines()
    n = len(trace.records) + len(trace.spans) + len(trace.metrics) + 2
    assert obs.validate_metrics_jsonl(lines) == n
    assert jobs.validate_metrics_jsonl(lines) == n
    doc = json.loads((tmp_path / "t.json").read_text())
    assert obs.validate_chrome_trace(doc) == jobs.validate_chrome_trace(doc)
    assert doc["otherData"]["git_sha"] == "abc"
    kinds = [json.loads(line)["kind"] for line in lines]
    assert kinds[:3] == ["meta", "run", "histogram"]


# ------------------------------------------------------ tracing identity
CELLS = [f"{t}.{k}" for t in ("single", "fused")
         for k in ("persistent", "discrete", "megakernel")]


def _cfg(cell, jax=False, **kw):
    if jax:
        return j_config_for(JConfig(num_workers=16, fetch_size=1, **kw),
                            j_parse(cell))
    return config_for(SchedulerConfig(num_workers=16, fetch_size=1, **kw),
                      parse_policy(cell))


def _leaves(tree):
    out = []
    tree_map(lambda t: out.append(t.numpy()), tree)
    return out


@pytest.mark.parametrize("granularity", [1, 4])
@pytest.mark.parametrize("cell", CELLS)
def test_tracing_is_identity_and_rows_match_jax(graphs, cell, granularity):
    jgraph, graph = graphs
    if granularity > 1:
        cell = f"{cell}.g{granularity}"
    cfg = _cfg(cell)
    program = build_program("bfs", graph, cfg, params={"source": 0})
    base_state, base_stats, base_info = execute(program, graph, cfg)
    trace = Trace()
    state, stats, info = execute(program, graph, cfg, trace=trace)
    for a, b in zip(_leaves(state), _leaves(base_state)):
        np.testing.assert_array_equal(a, b)
    assert [int(x) for x in stats] == [int(x) for x in base_stats]
    assert info == base_info
    assert len(trace.records) == info["rounds"] > 1
    assert [r["round"] for r in trace.records] == list(range(info["rounds"]))
    assert all(r["engine"] == str(parse_policy(cell)) for r in trace.records)
    assert sum(r["pops"] for r in trace.records) == int(stats.items_processed)
    assert sum(r["work"] for r in trace.records) == info["work"]
    assert [s["name"] for s in trace.spans] == [f"execute {cell}"]
    if "megakernel" in cell:
        return  # JAX's BFS megakernel cells do not run (ROADMAP C-ref1)
    jtrace = jobs.Trace()
    jcfg = _cfg(cell, jax=True)
    j_execute(j_build("bfs", jgraph, jcfg, params={"source": 0}), jgraph,
              jcfg, trace=jtrace)
    assert trace.records == jtrace.records
    assert trace.metrics == jtrace.metrics


def test_megakernel_rows_equal_the_persistent_rows(graphs):
    """Where JAX cannot run the megakernel, its rows are held against the
    persistent cell's, for PageRank and coloring at g4 too."""
    _, graph = graphs
    for algo, params in (("bfs", {"source": 0}), ("pagerank", None),
                         ("coloring", None)):
        for suffix in ("", ".g4"):
            rows = {}
            for cell in ("single.persistent", "fused.megakernel"):
                cfg = _cfg(cell + suffix)
                trace = Trace()
                execute(build_program(algo, graph, cfg, params=params),
                        graph, cfg, trace=trace)
                rows[cell] = [{k: v for k, v in r.items() if k != "engine"}
                              for r in trace.records]
            assert rows["fused.megakernel"] == rows["single.persistent"]


def test_empty_run_edge(graphs):
    _, graph = graphs
    cfg = _cfg("single.persistent", max_rounds=0)
    program = build_program("bfs", graph, cfg, params={"source": 0})
    _, _, base_info = execute(program, graph, cfg)
    trace = Trace()
    _, _, info = execute(program, graph, cfg, trace=trace)
    assert base_info["rounds"] == 0 and info == base_info
    assert trace.records == [] and trace.truncated == 0


def test_capacity_truncation_edge(graphs):
    """The ring's newest rows survive a drain longer than its capacity,
    through the persistent driver's predicated rounds (which run past the
    drain's end inside each poll window)."""
    _, graph = graphs
    cfg = _cfg("single.persistent")
    program = build_program("bfs", graph, cfg, params={"source": 0})
    _, _, info = execute(program, graph, cfg)
    rounds = info["rounds"]
    assert rounds > 2
    trace = Trace(capacity=2)
    execute(program, graph, cfg, trace=trace)
    assert len(trace.records) == 2 and trace.truncated == rounds - 2
    assert [r["round"] for r in trace.records] == [rounds - 2, rounds - 1]


def test_run_doc_and_segments_carry_the_ring(graphs):
    """The ``run`` doc is registered once; a traced megakernel drain cut
    into segments carries its ring across them and equals the whole."""
    from repro_torch.core import megakernel_drive, megakernel_segment

    _, graph = graphs
    cfg = _cfg("single.megakernel")
    program = build_program("bfs", graph, cfg, params={"source": 0})
    trace = Trace()
    execute(program, graph, cfg, trace=trace)
    runs = [d for d in trace.metrics if d["kind"] == "run"]
    assert len(runs) == 1 and runs[0]["policy"] == "single.megakernel"
    whole = drain_setup(program, graph, cfg, trace=Trace())
    want = megakernel_drive(whole.step, whole.cond, whole.carry)
    cut = drain_setup(program, graph, cfg, trace=Trace())
    seg = megakernel_segment(cut.step, cut.cond, cut.carry)
    carry, limit = cut.carry, 0
    while bool(cut.cond(carry)):
        limit += 3
        carry = seg(carry, limit)
    assert ring_rows(carry[4]) == ring_rows(want[4])
    assert ring_rows(want[4])[0] == [
        {k: v for k, v in r.items() if k != "engine"}
        for r in trace.records]


@pytest.mark.parametrize("cell", ["single.discrete", "fused.discrete.g4"])
def test_legacy_list_matches_jax(graphs, cell):
    jgraph, graph = graphs
    got, want = [], []
    cfg, jcfg = _cfg(cell), _cfg(cell, jax=True)
    execute(build_program("bfs", graph, cfg, params={"source": 0}), graph,
            cfg, trace=got)
    j_execute(j_build("bfs", jgraph, jcfg, params={"source": 0}), jgraph,
              jcfg, trace=want)
    assert got == want and len(got) > 1
    # the list is the discrete driver's: other strategies ignore it
    ignored = []
    execute(build_program("bfs", graph, _cfg("single.persistent"),
                          params={"source": 0}), graph,
            _cfg("single.persistent"), trace=ignored)
    assert ignored == []


def test_bsp_trace_lists_match_jax(graphs):
    jgraph, graph = graphs
    got, want = [], []
    tpr.pagerank_bsp(graph, eps=1e-5, trace=got)
    jpr.pagerank_bsp(jgraph, eps=1e-5, trace=want)
    assert got == want and len(got) > 1
    got, want = [], []
    tcol.coloring_bsp(graph, trace=got)
    jcol.coloring_bsp(jgraph, trace=want)
    assert got == want and len(got) > 1


def test_drivers_pass_the_trace_through(graphs):
    from repro_torch.algorithms.bfs import bfs_speculative

    _, graph = graphs
    cfg = SchedulerConfig(num_workers=16)
    for run in (lambda t: bfs_speculative(graph, 0, cfg, trace=t),
                lambda t: tpr.pagerank_async(graph, cfg, eps=1e-5, trace=t),
                lambda t: tcol.coloring_async(graph, cfg, trace=t)):
        trace = Trace()
        _, info = run(trace)
        assert len(trace.records) == info["rounds"] > 0
