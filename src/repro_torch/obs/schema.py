"""The canonical observability schema (DESIGN.md §15).

A copy of ``repro/obs/schema.py`` -- the same ``SCHEMA_VERSION``,
``TRACE_FIELDS``, ``KINDS`` and validators, so that either package's
validators accept what the other writes.  The ``meta`` kind requires a
``jax_version`` string; the port stamps it saying that JAX is absent
(``obs/trace.default_meta``).

One schema for every metric the repo emits.  Before this layer the repo's
telemetry was five incompatible ad-hoc shapes (``WorkCounter``,
``JobTelemetry``, ``RunStats``, ``ShardRunStats``, per-bench JSON); now
every serialized metric document is a flat JSON object tagged with

    {"schema": SCHEMA_VERSION, "kind": <kind>, ...fields...}

and every kind's required fields (with their types) are declared in one
place — :data:`KINDS` — so exporters, the bench-smoke CI guard, and the
tests all validate against the same registry instead of each growing its
own notion of "what a run record looks like".

Two layers of records share the registry:

  * **device trace records** (kind ``round``): one row per scheduling
    round, recorded *inside* the drain loop by the
    :class:`~repro_torch.obs.ring.TraceRing` — the column layout is
    :data:`TRACE_FIELDS` and is identical across every engine (single,
    fused, sharded, server, stream, megakernel), with engine-specific
    columns (donations, exchange volume) simply zero where the engine has
    no such concept;
  * **host summary docs** (kinds ``run`` / ``shard_run`` / ``server`` /
    ``stream`` / ``job`` / ``span`` / ``histogram`` / ``meta``): the
    end-of-run shapes the engines' ``as_dict`` methods now serialize into.

Validation is hand-rolled (``jsonschema`` is not a dependency of this
repo): a kind declares required fields and a coarse type class per field;
:func:`validate_metric` checks presence and type and rejects unknown
kinds.  Extra fields are allowed — kinds are *floors*, so an engine can
attach topology-specific extras without a schema bump — but a missing or
mistyped required field fails loudly, which is exactly the field-drift
guard the bench-smoke CI job runs over every emitted document.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Mapping, Tuple

#: bump when a kind's required fields change incompatibly
SCHEMA_VERSION = 1

#: column layout of one device-side trace-ring record (all int32).  The
#: same row shape serves every engine; columns an engine has no meter for
#: are zero.  ``round`` is the 0-based round index *within the traced
#: drain* (stream segments add their absolute offset at drain time);
#: ``lane`` is the shard index (sharded), the MultiQueue lane (server), or
#: 0 (single/fused single-tenant).
TRACE_FIELDS: Tuple[str, ...] = (
    "round",       # 0-based scheduling-round index
    "lane",        # shard / MultiQueue lane / 0
    "queue_size",  # live items visible to this engine before the pop
    "pops",        # valid tasks popped this round
    "pushes",      # tasks pushed this round (size delta + pops)
    "work",        # WorkCounter.work delta (vertices advanced)
    "splits",      # WorkCounter.splits delta (chunk-formation splits)
    "donated",     # steal donations shipped this round (sharded only)
    "exchanged",   # distinct tasks routed off-device this round (sharded)
    "exchanged_row",  # cross-device payload ints, row-axis hop (2-D mesh)
    "exchanged_col",  # cross-device payload ints, column-axis hop (or 1-D)
    "wire",        # metered wire ints (compressed words when codec is on)
    "deferred",    # staged overlap arrivals delivered this round
)

NUM_FIELDS = len(TRACE_FIELDS)

#: coarse type classes for validation: "int" | "num" | "str" | "bool" |
#: "list" | "dict" — presence + type, not value ranges.
_TYPES = {
    "int": (int,),
    "num": (int, float),
    "str": (str,),
    "bool": (bool,),
    "list": (list,),
    "dict": (dict,),
}

#: required fields per metric kind (beyond the implicit schema/kind tag).
#: Kinds are floors: extra fields are welcome, missing ones are drift.
KINDS: Dict[str, Dict[str, str]] = {
    # provenance stamp shared by metrics files and BENCH_*.json documents
    "meta": {
        "git_sha": "str",
        "jax_version": "str",
        "device_kind": "str",
        "python": "str",
    },
    # single/fused drain summary (core RunStats + runtime info)
    "run": {
        "policy": "str",
        "rounds": "int",
        "items_processed": "int",
        "dropped": "int",
        "work": "int",
        "splits": "int",
        "launches": "int",
    },
    # sharded drain summary (shard/driver.ShardRunStats)
    "shard_run": {
        "rounds": "int",
        "items_processed": "int",
        "dropped": "int",
        "route_dropped": "int",
        "exchanged": "int",
        "donated": "int",
        "stolen_executed": "int",
        "steal_rounds": "int",
        "mis_routed": "int",
        "per_device_items": "list",
        "occupancy_balance": "num",
        # wire accounting (DESIGN.md §16): per-axis cross-device payload,
        # true payload vs EMPTY padding, metered wire ints, and the overlap
        # pipeline's delivery counters
        "exchanged_row": "int",
        "exchanged_col": "int",
        "payload_ints": "int",
        "padding_ints": "int",
        "wire_ints": "int",
        "deferred_delivered": "int",
        "overlap_rounds": "int",
        "overlap_occupancy": "num",
    },
    # multi-tenant server summary (server/engine.ServerStats)
    "server": {
        "rounds": "int",
        "wall_seconds": "num",
        "items_processed": "int",
        "backpressure_events": "int",
        "deferred_admissions": "int",
        "wavefront": "int",
        "occupancy": "num",
    },
    # streaming-job summary (stream/driver.StreamResult)
    "stream": {
        "batches": "int",
        "batches_run": "int",
        "rounds": "int",
        "processed": "int",
        "work": "int",
        "dropped": "int",
        "incremental": "bool",
        "topology": "str",
        "touched_rows": "int",    # slab rows rewritten across all commits
        "compactions": "int",     # slotted-CSR re-packs across the run
    },
    # per-tenant telemetry (core/counters.JobTelemetry)
    "job": {
        "job_id": "int",
        "algorithm": "str",
        "wavefront": "int",
        "granularity": "int",
        "rounds_active": "int",
        "items_processed": "int",
        "vertices_processed": "int",
        "work": "int",
        "latency_rounds": "int",
        "queue_delay_rounds": "int",
        "occupancy": "num",
        "overwork": "num",
    },
    # one device-trace row, drained to host (TRACE_FIELDS + engine tag)
    "round": dict({f: "int" for f in TRACE_FIELDS}, engine="str"),
    # host wall-clock span (trace/compile/execute/exchange phases)
    "span": {
        "name": "str",
        "ts_us": "num",
        "dur_us": "num",
    },
    # exact-percentile latency histogram (server jobs, ROADMAP item 3)
    "histogram": {
        "name": "str",
        "count": "int",
        "min": "num",
        "max": "num",
        "mean": "num",
        "p50": "num",
        "p95": "num",
        "p99": "num",
    },
}

#: required keys of the ``meta`` block every BENCH_*.json carries
#: (benchmarks/harness.bench_meta)
BENCH_META_KEYS: Tuple[str, ...] = ("git_sha", "jax_version", "device_kind",
                                    "python", "schema")


def metric_doc(kind: str, **fields: Any) -> dict:
    """Build (and validate) one canonical metric document."""
    doc = {"schema": SCHEMA_VERSION, "kind": kind}
    doc.update(fields)
    validate_metric(doc)
    return doc


def validate_metric(doc: Mapping[str, Any]) -> None:
    """Raise ``ValueError`` listing every schema violation in ``doc``."""
    errors = []
    if not isinstance(doc, Mapping):
        raise ValueError(f"metric doc must be a mapping, got {type(doc)}")
    kind = doc.get("kind")
    if kind not in KINDS:
        raise ValueError(
            f"unknown metric kind {kind!r}; expected one of {sorted(KINDS)}")
    if doc.get("schema") != SCHEMA_VERSION:
        errors.append(f"schema={doc.get('schema')!r} != {SCHEMA_VERSION}")
    for field, tclass in KINDS[kind].items():
        if field not in doc:
            errors.append(f"missing required field {field!r}")
            continue
        want = _TYPES[tclass]
        value = doc[field]
        # bool is an int subclass; an int-typed field must not accept it
        if isinstance(value, bool) and tclass != "bool":
            errors.append(f"field {field!r} is bool, expected {tclass}")
        elif not isinstance(value, want):
            errors.append(
                f"field {field!r} is {type(value).__name__}, "
                f"expected {tclass}")
    if errors:
        raise ValueError(
            f"invalid {kind!r} metric doc: " + "; ".join(errors))


def validate_metrics_jsonl(lines: Iterable[str]) -> int:
    """Validate a metrics JSONL stream; returns the number of docs."""
    import json

    n = 0
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            doc = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"metrics line {i}: invalid JSON: {e}") from e
        try:
            validate_metric(doc)
        except ValueError as e:
            raise ValueError(f"metrics line {i}: {e}") from e
        n += 1
    return n


def validate_chrome_trace(doc: Mapping[str, Any]) -> int:
    """Validate a Chrome trace-event document (the JSON-object form that
    chrome://tracing and Perfetto load); returns the event count."""
    if not isinstance(doc, Mapping) or "traceEvents" not in doc:
        raise ValueError(
            "chrome trace must be an object with a 'traceEvents' array")
    events = doc["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be an array")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        missing = [k for k in ("name", "ph", "pid", "tid") if k not in ev]
        if missing:
            raise ValueError(f"traceEvents[{i}] missing {missing}")
        if ev["ph"] in ("X", "B", "E") and "ts" not in ev:
            raise ValueError(f"traceEvents[{i}] ({ev['ph']!r}) missing ts")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"traceEvents[{i}] ('X') missing dur")
    return len(events)


def validate_bench(doc: Mapping[str, Any], *, name: str = "BENCH") -> None:
    """Validate one ``BENCH_*.json`` document's canonical envelope: a
    ``meta`` provenance block (harness.bench_meta) with every required
    key present and string/int-typed.  Benchmark payloads keep their
    section-specific shapes; the envelope is what CI guards for drift."""
    if not isinstance(doc, Mapping):
        raise ValueError(f"{name}: document must be a JSON object")
    meta = doc.get("meta")
    if not isinstance(meta, Mapping):
        raise ValueError(f"{name}: missing 'meta' provenance block "
                         f"(benchmarks/harness.bench_meta)")
    errors = []
    for key in BENCH_META_KEYS:
        if key not in meta:
            errors.append(f"meta.{key} missing")
        elif key == "schema":
            if meta[key] != SCHEMA_VERSION:
                errors.append(f"meta.schema={meta[key]!r} != {SCHEMA_VERSION}")
        elif not isinstance(meta[key], str):
            errors.append(f"meta.{key} is {type(meta[key]).__name__}, "
                          f"expected str")
    if errors:
        raise ValueError(f"{name}: " + "; ".join(errors))
