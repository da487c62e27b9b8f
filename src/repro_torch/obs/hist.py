"""Exact-percentile latency histograms (ROADMAP item 3, DESIGN.md §15).

A copy of ``repro/obs/hist.py``.

The serving-scale roadmap asks for p50/p99 *latency-round* histograms for
server jobs.  Round counts are small integers (a job's latency is tens to
thousands of scheduling rounds), so there is no reason to approximate:
:class:`LatencyHistogram` stores the samples and computes **exact**
nearest-rank percentiles — ``p(q)`` is the smallest sample with at least
``q%`` of the distribution at or below it, the textbook definition, so
``p50`` of ``[1..100]`` is exactly 50 and ``p99`` is exactly 99.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

from .schema import metric_doc


@dataclasses.dataclass
class LatencyHistogram:
    """Store-everything histogram with exact nearest-rank percentiles."""

    name: str
    samples: List[float] = dataclasses.field(default_factory=list)

    def add(self, value) -> None:
        self.samples.append(float(value))

    def extend(self, values) -> None:
        for v in values:
            self.add(v)

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        """Exact nearest-rank percentile: the ``ceil(q/100 * n)``-th
        smallest sample (0.0 for an empty histogram)."""
        if not self.samples:
            return 0.0
        if not 0 < q <= 100:
            raise ValueError(f"percentile q must be in (0, 100], got {q}")
        ordered = sorted(self.samples)
        rank = max(1, math.ceil(q / 100.0 * len(ordered)))
        return ordered[rank - 1]

    def to_doc(self) -> dict:
        """Serialize into the canonical ``histogram`` metric kind."""
        s = self.samples
        return metric_doc(
            "histogram",
            name=self.name,
            count=len(s),
            min=min(s) if s else 0.0,
            max=max(s) if s else 0.0,
            mean=(sum(s) / len(s)) if s else 0.0,
            p50=self.percentile(50),
            p95=self.percentile(95),
            p99=self.percentile(99),
        )
