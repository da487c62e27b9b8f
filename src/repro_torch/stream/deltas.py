"""Edge deltas: the streaming subsystem's wire format.

A copy of ``repro/stream/deltas.py`` (pure numpy), so the port imports
nothing of the reference package.

A delta batch is a set of directed edge operations against a CSR graph:
``(src, dst, insert)`` triples where ``insert=True`` adds the edge and
``False`` removes it.  :func:`make_delta` is the validating front door: it
rejects out-of-range endpoints and self-loops (the CSR builder drops
self-loops, so accepting one here would silently do nothing) and
canonicalizes the batch — **last-wins de-duplication** per directed pair,
then a sort by ``(src, dst)`` — so a batch is a *function* from edge to
final operation.  Canonical batches make delta application idempotent
(applying a batch twice equals once) and order-insensitive within the
batch, the two properties the hypothesis suite pins down.

The repo's generators emit symmetric graphs; symmetric *deltas* are the
caller's contract (``graph/generators.edge_delta_stream`` emits both
directions of every pair).  Nothing here requires symmetry — directed
streams are legal — but the per-algorithm dirty-seed rules inherit the
base algorithms' assumptions about the graphs they run on.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeDelta:
    """One canonical batch of directed edge inserts/deletes.

    Arrays are host numpy (deltas are ingested host-side, like CSR
    construction); ``insert[i]`` tells whether ``(src[i], dst[i])`` is added
    or removed.  Construct via :func:`make_delta` — the constructor itself
    performs no validation.
    """

    num_vertices: int
    src: np.ndarray      # int32 [k]
    dst: np.ndarray      # int32 [k]
    insert: np.ndarray   # bool  [k]

    @property
    def num_ops(self) -> int:
        return int(self.src.shape[0])

    @property
    def num_inserts(self) -> int:
        return int(np.count_nonzero(self.insert))

    @property
    def num_deletes(self) -> int:
        return self.num_ops - self.num_inserts


def make_delta(num_vertices: int, src, dst, insert) -> EdgeDelta:
    """Validate + canonicalize a raw op list into an :class:`EdgeDelta`.

    Canonical form: at most one op per directed ``(src, dst)`` pair — the
    *last* occurrence in the input wins (a stream that inserts then deletes
    the same edge within a batch nets to a delete) — sorted by ``(src,
    dst)``.  Raises ``ValueError`` on shape mismatch, out-of-range
    endpoints, or self-loops.
    """
    n = int(num_vertices)
    if n <= 0:
        raise ValueError(f"num_vertices must be positive, got {n}")
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    ins = np.asarray(insert, dtype=bool).ravel()
    if not (src.shape == dst.shape == ins.shape):
        raise ValueError(
            f"delta arrays disagree: src {src.shape}, dst {dst.shape}, "
            f"insert {ins.shape}")
    if src.size:
        if src.min() < 0 or src.max() >= n or dst.min() < 0 or dst.max() >= n:
            raise ValueError(
                f"delta endpoint out of range for {n} vertices")
        loops = src == dst
        if loops.any():
            v = int(src[loops][0])
            raise ValueError(
                f"delta contains self-loop ({v}, {v}); the CSR builder "
                f"drops self-loops, so the op would be a silent no-op")
    # last-wins dedup: unique over the reversed key stream keeps, for each
    # directed pair, the index of its last occurrence in the original order;
    # np.unique aligns those indices to ascending key order, which IS the
    # canonical (src, dst) sort.
    key = src * n + dst
    _, rev_idx = np.unique(key[::-1], return_index=True)
    idx = src.size - 1 - rev_idx
    return EdgeDelta(
        num_vertices=n,
        src=src[idx].astype(np.int32),
        dst=dst[idx].astype(np.int32),
        insert=ins[idx],
    )


def symmetrized(delta: EdgeDelta) -> EdgeDelta:
    """Mirror every op: the undirected-stream helper (both directions get
    the same operation; re-canonicalized, so duplicates collapse)."""
    return make_delta(
        delta.num_vertices,
        np.concatenate([delta.src, delta.dst]),
        np.concatenate([delta.dst, delta.src]),
        np.concatenate([delta.insert, delta.insert]),
    )
