"""Public wrapper: global stream compaction.

The counterpart of ``repro/kernels/queue_compact/ops.py``.
``core/queue.TaskQueue.push`` uses :func:`compact` as its slot-reservation
engine when its backend resolves to ``"cuda"``, which makes the kernel the
push hot path of the scheduler.
"""
from __future__ import annotations

import torch

from .kernel import compact_cuda
from .ref import compact_ref


def compact(items: torch.Tensor, mask: torch.Tensor):
    """([N], [N]bool) -> ([N] compacted then zeros, count): the kernel for
    CUDA tensors, its plain version for CPU tensors.  Stable."""
    if items.is_cuda:
        return compact_cuda(items, mask)
    return compact_ref(items, mask)
