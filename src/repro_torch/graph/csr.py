"""CSR graph container + degree statistics.

The counterpart of ``repro/graph/csr.py``: int32 ``row_ptr`` [n+1] and
``col_idx`` [m] tensors.  :func:`from_edges` runs the reference's
dedupe-and-sort step by step, in PyTorch on the target device (a sorted
unique over ``src * n + dst``, a bincount, a cumsum), so one edge list
gives byte-identical CSR in both packages, and a graph of tens of millions
of edges is built on the card instead of on the host.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    row_ptr: torch.Tensor  # [n+1] int32
    col_idx: torch.Tensor  # [m] int32

    @property
    def num_vertices(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.col_idx.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_ptr.device

    def degrees(self) -> torch.Tensor:
        return self.row_ptr[1:] - self.row_ptr[:-1]

    def to(self, device) -> "CSRGraph":
        device = resolve_device(device)
        return CSRGraph(self.row_ptr.to(device), self.col_idx.to(device))


def from_edges(n: int, src, dst, symmetrize: bool = False,
               device="cuda") -> CSRGraph:
    """Build CSR from an edge list (numpy arrays or tensors; dedupes +
    sorts on ``device``)."""
    device = resolve_device(device)
    src = torch.as_tensor(src, dtype=torch.int64, device=device)
    dst = torch.as_tensor(dst, dtype=torch.int64, device=device)
    if symmetrize:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    keep = src != dst  # drop self-loops
    key = torch.unique(src[keep] * n + dst[keep])   # sorted, like np.unique
    del src, dst, keep
    counts = torch.bincount(key // n, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int32, device=device)
    row_ptr[1:] = torch.cumsum(counts, 0)
    return CSRGraph(row_ptr=row_ptr, col_idx=(key % n).to(torch.int32))


def permute_vertices(g: CSRGraph, perm) -> CSRGraph:
    """Relabel vertices by ``perm`` (old id -> new id), on the graph's
    device: the paper's section 6.4 experiment, where a random permutation
    of the ids breaks the "consecutive queue entries are neighbors" pattern
    in graph coloring."""
    perm = torch.as_tensor(perm, dtype=torch.int64, device=g.device)
    src = torch.repeat_interleave(
        torch.arange(g.num_vertices, device=g.device),
        g.degrees().long(), output_size=g.num_edges)
    return from_edges(g.num_vertices, perm[src], perm[g.col_idx.long()],
                      device=g.device)


def degree_stats(g: CSRGraph) -> dict:
    deg = g.degrees().cpu().numpy()
    return {
        "n": g.num_vertices,
        "m": g.num_edges,
        "max_degree": int(deg.max(initial=0)),
        "avg_degree": float(deg.mean()) if len(deg) else 0.0,
        "degree_std": float(deg.std()) if len(deg) else 0.0,
    }
