"""Exporters: JSONL metrics and Chrome trace-event JSON (DESIGN.md §15).

A copy of ``repro/obs/export.py``.

Both writers are **atomic** — temp-then-rename in the target directory,
the same crash-consistency discipline as the autotune cache and the
snapshot layer — so a reader (or a CI validator) never observes a
partially written file, even if the process dies mid-export.

The Chrome trace is the JSON-object form (``{"traceEvents": [...]}``)
that ``chrome://tracing`` and Perfetto load directly.  Two timebases
share one trace:

  * **device rounds** have no wall-clock timestamps by design (recording
    them would cost the host syncs the ring buffer exists to avoid), so
    round records are laid out on a *logical* timebase — round index ->
    microseconds, one round = :data:`ROUND_DUR_US` — as ``"X"`` complete
    events, one ``pid`` per engine and one ``tid`` per lane/shard, with
    the full record in ``args`` for Perfetto's inspector;
  * **host spans** (trace/compile/execute/exchange phases) carry real
    ``perf_counter`` microseconds relative to the Trace epoch, under a
    dedicated ``host`` process.

Perfetto renders both; the DESIGN.md §15 how-to documents that the round
lanes are schedule time, not wall time.
"""
from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Iterable, List, Mapping, Optional

from .schema import TRACE_FIELDS

#: logical duration of one scheduling round on the device timebase (µs)
ROUND_DUR_US = 10

#: pid of the host-span process lane in the Chrome trace
HOST_PID = 0


def atomic_write_text(path: str | Path, text: str) -> Path:
    """Write ``text`` to ``path`` via temp-then-rename (crash-consistent)."""
    path = Path(path)
    fd, tmp = tempfile.mkstemp(dir=path.parent or Path("."),
                               prefix=path.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


def write_jsonl(path: str | Path, docs: Iterable[Mapping]) -> Path:
    """Write metric documents as JSONL, atomically."""
    text = "".join(json.dumps(doc, sort_keys=True) + "\n" for doc in docs)
    return atomic_write_text(path, text)


def read_jsonl(path: str | Path) -> List[dict]:
    return [json.loads(line)
            for line in Path(path).read_text().splitlines() if line.strip()]


def chrome_trace(round_records: List[dict], spans: List[dict],
                 meta: Optional[dict] = None) -> dict:
    """Build a Chrome trace-event document from drained round records
    (each a TRACE_FIELDS dict + ``engine`` tag) and host span docs."""
    events: List[dict] = []
    # stable pid per engine: host is pid 0, engines 1..N in first-seen order
    pids = {}

    def pid_of(engine: str) -> int:
        if engine not in pids:
            pids[engine] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[engine], "tid": 0,
                           "args": {"name": engine}})
        return pids[engine]

    events.append({"name": "process_name", "ph": "M", "pid": HOST_PID,
                   "tid": 0, "args": {"name": "host"}})
    for span in spans:
        events.append({
            "name": span["name"], "cat": "host", "ph": "X",
            "pid": HOST_PID, "tid": 0,
            "ts": span["ts_us"], "dur": max(span["dur_us"], 1),
        })
    named_tids = set()
    for rec in round_records:
        engine = rec.get("engine", "run")
        pid = pid_of(engine)
        tid = int(rec.get("lane", 0))
        if (pid, tid) not in named_tids:
            named_tids.add((pid, tid))
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": f"lane {tid}"}})
        events.append({
            "name": f"round {rec['round']}", "cat": "round", "ph": "X",
            "pid": pid, "tid": tid,
            # logical timebase: 1 round = ROUND_DUR_US µs of schedule time
            "ts": int(rec["round"]) * ROUND_DUR_US, "dur": ROUND_DUR_US,
            "args": {k: rec[k] for k in TRACE_FIELDS},
        })
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta:
        doc["otherData"] = dict(meta)
    return doc


def write_chrome_trace(path: str | Path, doc: Mapping) -> Path:
    """Write a Chrome trace document, atomically."""
    return atomic_write_text(path, json.dumps(doc) + "\n")
