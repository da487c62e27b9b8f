"""Observability (DESIGN.md §15): the counterpart of ``repro/obs``.

  * :mod:`~repro_torch.obs.ring`   -- the per-round trace ring carried
    through every drain (device ops only while tracing; read once at run
    end); the megakernel cells' drain kernels write it themselves;
  * :mod:`~repro_torch.obs.schema`, :mod:`~repro_torch.obs.hist`,
    :mod:`~repro_torch.obs.export` -- copies of the reference's schema,
    validators, histograms and exporters;
  * :mod:`~repro_torch.obs.trace`  -- the :class:`Trace` front door taken
    by ``runtime.execute(..., trace=...)``.

Tracing is opt-in: ``trace=None`` builds exactly the untraced drain.
"""
from .export import (atomic_write_text, chrome_trace, read_jsonl,
                     write_chrome_trace, write_jsonl)
from .hist import LatencyHistogram
from .ring import (DEFAULT_CAPACITY, TraceRing, ring_rows, stacked_rings,
                   unstack_ring)
from .schema import (BENCH_META_KEYS, KINDS, NUM_FIELDS, SCHEMA_VERSION,
                     TRACE_FIELDS, metric_doc, validate_bench,
                     validate_chrome_trace, validate_metric,
                     validate_metrics_jsonl)
from .trace import Trace, default_meta

__all__ = [
    "atomic_write_text", "chrome_trace", "read_jsonl", "write_chrome_trace",
    "write_jsonl", "LatencyHistogram", "DEFAULT_CAPACITY", "TraceRing",
    "ring_rows", "stacked_rings", "unstack_ring", "BENCH_META_KEYS",
    "KINDS", "NUM_FIELDS", "SCHEMA_VERSION", "TRACE_FIELDS", "metric_doc",
    "validate_bench", "validate_chrome_trace", "validate_metric",
    "validate_metrics_jsonl", "Trace", "default_meta",
]
