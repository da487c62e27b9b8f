"""Synthetic graph generators for the paper's two dataset classes.

The counterpart of ``repro/graph/generators.py``.  The random draws are
the reference's (numpy ``default_rng(seed)`` on the host, in the same
order); the arithmetic on them runs in PyTorch on the target device, so
one seed gives byte-identical CSR in both packages:

  * ``rmat``   -- R-MAT scale-free graph (Graph500 a=0.57, b=c=0.19);
  * ``grid2d`` -- 2D lattice, the road-network stand-in;
  * ``erdos``  -- uniform random.

Graphs are built on ``device`` (default ``"cuda"``).
``edge_delta_stream`` comes with the streaming slice.
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
