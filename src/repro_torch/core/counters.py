"""Work counters for the paper's overwork metric (Table 4).

The counterpart of ``repro/core/counters.py``.  ``WorkCounter`` threads
through algorithm state; every processed item bumps ``work``, and
``overwork = work / ideal`` with the algorithm's fixed ideal workload.
``JobTelemetry`` is the task server's per-tenant meter (host-side).
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


@dataclasses.dataclass
class JobTelemetry:
    """Per-tenant metering for the multi-job task server (host-side).

    The reference's fields and meaning: ``work`` is the job's WorkCounter
    at completion and ``ideal_work`` the algorithm's minimum, so
    ``overwork`` is the Table 4 metric per tenant.  Rounds are *server*
    scheduling rounds, so ``latency_rounds`` is queueing delay plus
    service time.
    """

    job_id: int
    algorithm: str
    graph: str
    wavefront: int                 # server W -- denominator for occupancy
    ideal_work: int
    submitted_round: int = 0
    admitted_round: int = -1       # -1 while waiting for a lane
    completed_round: int = -1
    rounds_active: int = 0         # rounds with quota > 0 or an on_empty step
    items_processed: int = 0       # valid tasks popped for this job
    #: vertices those pops advanced (sum of chunk widths); equals
    #: ``items_processed`` at granularity 1.  0 means "not metered" and
    #: occupancy falls back to the item count.
    vertices_processed: int = 0
    #: the server's chunk-width cap G -- the occupancy denominator is the
    #: round budget ``rounds_active x wavefront x G`` (vertex units)
    granularity: int = 1
    work: int = 0                  # WorkCounter at completion
    dropped: int = 0               # lane overflow drops attributed to the job
    backpressure_events: int = 0   # rounds the lane was drain-boosted
    routing_mismatches: int = 0    # packed job_id != lane owner (must be 0)

    @property
    def latency_rounds(self) -> int:
        if self.completed_round < 0:
            return -1
        return self.completed_round - self.submitted_round

    @property
    def queue_delay_rounds(self) -> int:
        if self.admitted_round < 0:
            return -1
        return self.admitted_round - self.submitted_round

    @property
    def occupancy(self) -> float:
        """Mean fraction of the round budget (vertex units) this job
        filled while active."""
        denom = self.rounds_active * self.wavefront * max(self.granularity, 1)
        if not denom:
            return 0.0
        filled = self.vertices_processed or self.items_processed
        return filled / denom

    @property
    def overwork(self) -> float:
        return self.work / max(self.ideal_work, 1)

    def as_dict(self) -> dict:
        """Serialize into the canonical ``job`` metric doc (obs/schema)."""
        from ..obs.schema import metric_doc  # lazy: obs is a leaf layer

        d = dataclasses.asdict(self)
        d.update(latency_rounds=self.latency_rounds,
                 queue_delay_rounds=self.queue_delay_rounds,
                 occupancy=self.occupancy, overwork=self.overwork)
        return metric_doc("job", **d)
