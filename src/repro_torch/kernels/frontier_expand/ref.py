"""Plain PyTorch version of the load-balancing search (kernel B1).

The counterpart of ``repro/kernels/frontier_expand/ref.py``.  ``scan`` may
be the inclusive scan of per-row degrees or of per-chunk degree sums; the
search does not care.
"""
from __future__ import annotations

import torch


def lbs_ref(scan: torch.Tensor, budget: int):
    """owner(k) = first j with scan[j] > k; rank(k) = k - scan[owner-1]."""
    k = torch.arange(budget, dtype=torch.int32, device=scan.device)
    owner = torch.searchsorted(scan, k, right=True, out_int32=True)
    if scan.shape[0] == 0:
        return owner, k
    excl = torch.where(owner > 0, scan[torch.clamp(owner - 1, min=0)], 0)
    return owner, k - excl
