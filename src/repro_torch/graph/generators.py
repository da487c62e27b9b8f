"""Synthetic graph generators for the paper's two dataset classes.

The counterpart of ``repro/graph/generators.py``.  The random draws are
the reference's (numpy ``default_rng(seed)`` on the host, in the same
order); the arithmetic on them runs in PyTorch on the target device, so
one seed gives byte-identical CSR in both packages:

  * ``rmat``   -- R-MAT scale-free graph (Graph500 a=0.57, b=c=0.19);
  * ``grid2d`` -- 2D lattice, the road-network stand-in;
  * ``erdos``  -- uniform random.

Graphs are built on ``device`` (default ``"cuda"``).  ``edge_delta_stream``
walks a graph's undirected edge set into a seeded stream of delta batches,
the same batches as the reference's for the same arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.backend import resolve_device
from .csr import CSRGraph, from_edges


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19,
         device="cuda") -> CSRGraph:
    """R-MAT scale-free graph with 2**scale vertices."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for _ in range(scale):
        r = torch.from_numpy(rng.random(m)).to(device)
        # quadrant probabilities a, b, c, d (float64 compares, as numpy's)
        src_bit = (r >= a + b).long()
        dst_bit = (((r >= a) & (r < a + b)) | (r >= a + b + c)).long()
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return from_edges(n, src, dst, symmetrize=True, device=device)


def grid2d(rows: int, cols: int, seed: int = 0, extra_frac: float = 0.0,
           device="cuda") -> CSRGraph:
    """2D lattice (road-like).  ``extra_frac`` adds random shortcut edges."""
    device = resolve_device(device)
    n = rows * cols
    ids = np.arange(n, dtype=np.int64).reshape(rows, cols)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()])
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()])
    edges = np.concatenate([right, down], axis=1)
    if extra_frac > 0:
        rng = np.random.default_rng(seed)
        k = int(extra_frac * edges.shape[1])
        extra = rng.integers(0, n, size=(2, k))
        edges = np.concatenate([edges, extra], axis=1)
    return from_edges(n, edges[0], edges[1], symmetrize=True, device=device)


def erdos(n: int, m: int, seed: int = 0, device="cuda") -> CSRGraph:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return from_edges(n, src, dst, symmetrize=True, device=device)


def _sorted_member(sorted_keys: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Which ``keys`` lie in the sorted unique array ``sorted_keys``."""
    if sorted_keys.size == 0:
        return np.zeros(keys.shape, dtype=bool)
    pos = np.minimum(np.searchsorted(sorted_keys, keys), sorted_keys.size - 1)
    return sorted_keys[pos] == keys


def edge_delta_stream(graph: CSRGraph, num_batches: int, batch_size: int,
                      seed: int = 0, insert_frac: float = 0.5) -> list:
    """Deterministic seeded stream of mixed insert/delete delta batches.

    Walks the evolving *undirected* edge set from ``graph``: each batch
    deletes ``~(1 - insert_frac) * batch_size`` present pairs (sampled
    without replacement) and inserts ``~insert_frac * batch_size`` absent
    pairs (rejection-sampled, no self-loops), then emits both directions of
    every pair as one canonical :class:`~repro_torch.stream.deltas.
    EdgeDelta`, so replaying the stream keeps the graph symmetric.

    The same ``(graph, num_batches, batch_size, seed, insert_frac)`` give
    the reference's batches bit for bit: the same draws from the same
    ``default_rng(seed)``.  The present pairs are a sorted int64 key array
    (the reference keeps a Python set and sorts it once a batch), built on
    the graph's device; a candidate's membership is a binary search, and
    the accepted candidates are those the reference's sequential scan
    accepts: new, first of their value in the draw, up to the batch's need.
    """
    from ..stream.deltas import make_delta  # lazy: stream imports graph

    if not 0.0 <= insert_frac <= 1.0:
        raise ValueError(f"insert_frac must be in [0, 1], got {insert_frac}")
    n = graph.num_vertices
    rng = np.random.default_rng(seed)
    rp = graph.row_ptr.to(torch.int64)
    src = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=rp.device),
        rp[1:] - rp[:-1], output_size=graph.num_edges)
    ci = graph.col_idx.to(torch.int64)
    # undirected pair keys u*n+v with u < v (self-loops never in the CSR)
    present = torch.unique(torch.minimum(src, ci) * n
                           + torch.maximum(src, ci)).cpu().numpy()
    del src, ci

    n_ins = int(round(batch_size * insert_frac))
    n_del = batch_size - n_ins
    batches = []
    for _ in range(num_batches):
        dels = np.empty(0, dtype=np.int64)
        if n_del and present.size:
            dels = rng.choice(present, size=min(n_del, present.size),
                              replace=False)
            present = np.delete(present, np.searchsorted(present, dels))
        ins: list = []
        taken = 0
        attempts = 0
        while taken < n_ins and attempts < 64:
            a = rng.integers(0, n, size=2 * (n_ins - taken))
            b = rng.integers(0, n, size=a.size)
            lo, hi = np.minimum(a, b), np.maximum(a, b)
            cand = (lo * n + hi)[lo != hi]
            first = np.zeros(cand.size, dtype=bool)
            first[np.unique(cand, return_index=True)[1]] = True
            acc = cand[first & ~_sorted_member(present, cand)]
            acc = acc[:n_ins - taken]
            ins.append(acc)
            taken += acc.size
            srt = np.sort(acc)
            present = np.insert(present, np.searchsorted(present, srt), srt)
            attempts += 1
        keys = np.concatenate([dels] + ins).astype(np.int64)
        flags = np.concatenate([np.zeros(dels.size, bool),
                                np.ones(taken, bool)])
        lo, hi = keys // n, keys % n
        batches.append(make_delta(
            n,
            np.concatenate([lo, hi]),
            np.concatenate([hi, lo]),
            np.concatenate([flags, flags]),
        ))
    return batches
