"""Crash-consistent mid-drain snapshots for streaming jobs.

The counterpart of ``repro/stream/snapshot.py``.  A snapshot is one tree
written through the checkpoint layer's atomic tmp-then-rename commit
(``checkpoint/manager.py``, ``prefix="snap"``):

    cursor      -- batch index, rounds and processed items so far, and the
                   batch record's baselines (pre-drain work and splits,
                   seed and effective-op counts)
    fingerprint -- (n, m, row-sum, col-sum, delta-log position) of the
                   graph the drain ran on; a resume re-derives that graph by
                   replaying the delta log, and the check catches a caller
                   handing back another base graph or log
    queue       -- the live queue (TaskQueue or MultiQueue; a sharded
                   stream's is the tuple of its shards' MultiQueues, each
                   restored onto its shard's device)
    state       -- the program state

The driver snapshots only between rounds, so the carry on disk is the
carry the uninterrupted run had at that round, and a resumed run is
bit-identical to it.  The files are the port's own format.
"""
from __future__ import annotations

import re
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager

#: host-side scalars carried per snapshot (all int32 in the tree)
CURSOR_FIELDS = ("batch", "rounds", "processed", "pre_work", "pre_splits",
                 "seeds", "eff")


def graph_fingerprint(graph, num_deltas: int) -> dict:
    """Cheap int64 digest of (graph, delta-log position), the reference's.

    Representation independent: a slotted view digests its live slab
    prefixes plus its overlay tail, the multiset the canonical ``col_idx``
    holds, so a snapshot taken on a ``SlottedView`` restores against its
    canonical materialization too.  The sums run in int64 on the graph's
    device; only the five scalars reach the host.
    """
    rp = graph.row_ptr.to(torch.int64)
    if getattr(graph, "overlay", None) is not None:
        slab_ptr = graph.slab_ptr.to(torch.int64)
        cs = torch.cat([rp.new_zeros(1),
                        torch.cumsum(graph.slab_col.to(torch.int64), 0)])
        # sum of each row's live slab prefix, via cumsum differences
        col_sum = (cs[slab_ptr[:-1] + graph.slab_len.to(torch.int64)]
                   - cs[slab_ptr[:-1]]).sum()
        col_sum = col_sum + graph.ovl_col[:int(graph.ovl_ptr[-1])].to(
            torch.int64).sum()
        m = int(rp[-1])
    else:
        col_sum = graph.col_idx.to(torch.int64).sum()
        m = int(graph.col_idx.shape[0])
    return {
        "n": np.int64(graph.num_vertices),
        "m": np.int64(m),
        "row_sum": np.int64(int(rp.sum())),
        "col_sum": np.int64(int(col_sum)),
        "deltas": np.int64(num_deltas),
    }


class SnapshotManager:
    """Thin streaming-flavored wrapper over :class:`CheckpointManager`."""

    def __init__(self, directory: str, keep: int = 3):
        self.mgr = CheckpointManager(directory, keep=keep, prefix="snap")

    @property
    def dir(self) -> str:
        return self.mgr.dir

    # --------------------------------------------------------------- save
    def save(self, tick: int, *, cursor: dict, graph, num_deltas: int,
             queue: Any, state: Any, blocking: bool = True,
             fingerprint: Optional[dict] = None):
        """Write one snapshot.  ``fingerprint`` is ``graph_fingerprint(graph,
        num_deltas)`` when the caller holds it already (the graph is fixed
        within a batch, so the driver digests it once a batch)."""
        missing = set(CURSOR_FIELDS) - set(cursor)
        if missing:
            raise ValueError(f"snapshot cursor missing {sorted(missing)}")
        tree = {
            "cursor": {k: np.int32(cursor[k]) for k in CURSOR_FIELDS},
            "fingerprint": (fingerprint if fingerprint is not None
                            else graph_fingerprint(graph, num_deltas)),
            "queue": queue,
            "state": state,
        }
        self.mgr.save(tick, tree, blocking=blocking)

    def wait(self):
        self.mgr.wait()

    # ------------------------------------------------------------ inspect
    def latest(self) -> Optional[int]:
        return self.mgr.latest_step()

    def peek(self, tick: int) -> dict:
        """Read only the cursor and fingerprint of a snapshot: the resume
        path must learn which batch (hence which graph to replay) before it
        can build the restore template."""
        out: dict = {"fingerprint": {}}
        for key, meta in self.mgr.manifest(tick).items():
            names = re.findall(r"\['([^']+)'\]", key)
            if len(names) == 2 and names[0] == "cursor":
                out[names[1]] = int(self.mgr.load_leaf(tick, meta))
            elif len(names) == 2 and names[0] == "fingerprint":
                out["fingerprint"][names[1]] = int(
                    self.mgr.load_leaf(tick, meta))
        return out

    # ------------------------------------------------------------ restore
    def restore(self, tick: int, *, queue_template: Any, state_template: Any,
                graph, num_deltas: int) -> dict:
        """Load a snapshot into deterministically rebuilt templates.

        ``graph`` must be the replayed batch graph; a fingerprint mismatch
        means another base graph or delta log, and resuming would silently
        corrupt the run, so it raises.
        """
        want = {k: int(v) for k, v in
                graph_fingerprint(graph, num_deltas).items()}
        got = self.peek(tick)["fingerprint"]
        if got != want:
            raise ValueError(
                f"snapshot {tick} fingerprint {got} does not match the "
                f"replayed graph {want}: different base graph or delta log")
        like = {
            "cursor": {k: np.int32(0) for k in CURSOR_FIELDS},
            "queue": queue_template,
            "state": state_template,
        }
        return self.mgr.restore(tick, like)
