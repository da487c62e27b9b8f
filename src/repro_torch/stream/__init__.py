"""Streaming graphs: delta ingestion, incremental recompute, and
crash-consistent mid-drain snapshots.

The counterpart of ``repro/stream``.  Front door:
:func:`repro_torch.runtime.stream_execute`.  The pieces:

  * :mod:`deltas`      -- canonical edge-delta batches (validate + dedup)
  * :mod:`ingest`      -- commit a batch against the CSR / slotted CSR
  * :mod:`incremental` -- per-algorithm dirty-seed rules
  * :mod:`snapshot`    -- crash-consistent mid-drain snapshots
  * :mod:`driver`      -- the batch-by-batch streaming drain loop
"""
from .deltas import EdgeDelta, make_delta, symmetrized
from .driver import BatchRecord, StreamResult, StreamSpec, run_stream
from .incremental import reseed
from .ingest import (AppliedDelta, apply_delta, commit, replay,
                     replay_commits, reshard)
from .snapshot import SnapshotManager, graph_fingerprint

__all__ = [
    "EdgeDelta", "make_delta", "symmetrized",
    "AppliedDelta", "apply_delta", "commit", "replay", "replay_commits",
    "reshard",
    "reseed",
    "SnapshotManager", "graph_fingerprint",
    "BatchRecord", "StreamResult", "StreamSpec", "run_stream",
]
