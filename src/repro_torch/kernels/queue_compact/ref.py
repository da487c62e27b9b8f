"""Plain PyTorch version of stream compaction (kernel B2).

The counterpart of ``repro/kernels/queue_compact/ref.py``.
"""
from __future__ import annotations

import torch


def compact_ref(items: torch.Tensor, mask: torch.Tensor):
    """Stable compaction: ([N], [N]bool) -> ([N] compacted then zeros,
    0-dim int32 count)."""
    n = items.shape[0]
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, 0, dtype=torch.int32) - m
    # masked-off lanes write into a spare slot n, which is sliced off
    out = torch.zeros(n + 1, dtype=torch.int32, device=items.device)
    out[torch.where(mask, pos, n).long()] = torch.where(mask, items, 0).to(
        torch.int32)
    return out[:n], m.sum(dtype=torch.int32)
