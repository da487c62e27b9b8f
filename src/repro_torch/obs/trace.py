"""The :class:`Trace` front door: one object per observed run.

The counterpart of ``repro/obs/trace.py``.  A ``Trace`` hands fresh device
rings to the drivers (:meth:`Trace.ring`, on the graph's device) and
collects their rows (:meth:`Trace.drain`) tagged with the engine name;
records host wall-clock spans (:meth:`Trace.span`); keeps validated
summary documents (:meth:`Trace.add_metric`) and exact-percentile
histograms; and writes a JSONL metrics file and a Perfetto-loadable
Chrome trace (:meth:`Trace.write`), both atomically.

Passing a ``Trace`` to ``runtime.execute`` turns tracing on; passing
``None`` (the default) builds no ring and wraps no step.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import torch

from .export import chrome_trace, write_chrome_trace, write_jsonl
from .hist import LatencyHistogram
from .ring import DEFAULT_CAPACITY, TraceRing, ring_rows
from .schema import SCHEMA_VERSION, metric_doc, validate_metric

#: what the port writes into the schema's required ``jax_version`` field
NO_JAX = "none: repro_torch runs on PyTorch and does not import jax"


def default_meta() -> dict:
    """Provenance stamp: torch and CUDA versions, the device kind, python.
    The schema's ``jax_version`` field says that JAX is absent."""
    import platform

    if torch.cuda.is_available():
        device_kind = torch.cuda.get_device_name()
    else:
        device_kind = "cpu"
    return {
        "git_sha": "unknown",  # entry points may stamp the real sha
        "jax_version": NO_JAX,
        "torch_version": torch.__version__,
        "cuda_version": str(torch.version.cuda),
        "device_kind": device_kind,
        "python": platform.python_version(),
    }


class Trace:
    """Collector for one observed run: rings, spans, metrics, histograms."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 meta: Optional[dict] = None) -> None:
        self.capacity = capacity
        self.records: List[dict] = []     # drained round rows (+engine tag)
        self.spans: List[dict] = []       # host wall-clock span docs
        self.metrics: List[dict] = []     # validated summary docs
        self.histograms: Dict[str, LatencyHistogram] = {}
        self.truncated = 0                # ring rows lost to wraparound
        self.meta = default_meta()
        if meta:
            self.meta.update(meta)
        self._epoch = time.perf_counter()

    # ------------------------------------------------------------- device
    def ring(self, device="cuda") -> TraceRing:
        """A fresh ring of this trace's capacity on ``device``."""
        return TraceRing.make(self.capacity, device=device)

    def drain(self, ring: TraceRing, engine: str,
              round_offset: int = 0) -> int:
        """Read a finished drain's ring to the host (the one tracing sync).

        ``engine`` tags every record (the Chrome trace's process lane);
        ``round_offset`` shifts in-ring round indices to absolute rounds
        for segmented drains.  Returns the number of records appended.
        """
        rows, truncated = ring_rows(ring)
        self.truncated += truncated
        for row in rows:
            rec = dict(row)
            rec["round"] += round_offset
            rec["engine"] = engine
            self.records.append(rec)
        return len(rows)

    # --------------------------------------------------------------- host
    @contextmanager
    def span(self, name: str):
        """Record one host wall-clock span on the trace's shared epoch."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            self.spans.append(metric_doc(
                "span", name=name,
                ts_us=(t0 - self._epoch) * 1e6,
                dur_us=(t1 - t0) * 1e6))

    def histogram(self, name: str) -> LatencyHistogram:
        """Get-or-create a named latency histogram."""
        if name not in self.histograms:
            self.histograms[name] = LatencyHistogram(name)
        return self.histograms[name]

    def add_metric(self, doc: dict) -> dict:
        """Register one canonical summary doc (validated on insertion)."""
        validate_metric(doc)
        self.metrics.append(doc)
        return doc

    # ------------------------------------------------------------- export
    def metric_docs(self) -> List[dict]:
        """Every document this trace exports, in canonical order: meta,
        summaries, histograms, spans, then the per-round records."""
        docs = [metric_doc("meta", **self.meta)]
        docs.extend(self.metrics)
        docs.extend(h.to_doc() for h in self.histograms.values())
        docs.extend(self.spans)
        for rec in self.records:
            docs.append(metric_doc("round", **rec))
        return docs

    def chrome(self) -> dict:
        """The Perfetto-loadable Chrome trace-event document."""
        meta = dict(self.meta, schema=SCHEMA_VERSION,
                    truncated_rounds=self.truncated)
        return chrome_trace(self.records, self.spans, meta=meta)

    def write(self, trace_path: Optional[str] = None,
              metrics_path: Optional[str] = None) -> None:
        """Atomically write the Chrome trace and/or the metrics JSONL."""
        if trace_path:
            write_chrome_trace(trace_path, self.chrome())
        if metrics_path:
            write_jsonl(metrics_path, self.metric_docs())
