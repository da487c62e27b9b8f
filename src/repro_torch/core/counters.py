"""Work counters for the paper's overwork metric (Table 4).

The counterpart of ``repro/core/counters.py``.  ``WorkCounter`` threads
through algorithm state; every processed item bumps ``work``, and
``overwork = work / ideal`` with the algorithm's fixed ideal workload.
``JobTelemetry`` comes with the task-server slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class WorkCounter:
    work: torch.Tensor    # vertices processed (0-dim int32)
    #: chunks the push-side coalescer declined to form (core/task.py); the
    #: task-granularity dial's engagement meter.  Always 0 at granularity 1.
    splits: torch.Tensor
    #: scheduling rounds this counter's state has been driven through --
    #: bumped exactly once per ``wavefront_step`` (empty rounds included)
    rounds: torch.Tensor

    @staticmethod
    def zero(device) -> "WorkCounter":
        def z():
            return torch.zeros((), dtype=torch.int32, device=device)
        return WorkCounter(work=z(), splits=z(), rounds=z())

    def add(self, n: torch.Tensor) -> "WorkCounter":
        return dataclasses.replace(self, work=self.work + n.to(torch.int32))

    def add_splits(self, n: torch.Tensor) -> "WorkCounter":
        return dataclasses.replace(self, splits=self.splits + n.to(torch.int32))

    def bump_round(self) -> "WorkCounter":
        return dataclasses.replace(self, rounds=self.rounds + 1)


def overwork_ratio(counter: WorkCounter, ideal: int) -> float:
    return float(counter.work) / float(max(ideal, 1))
