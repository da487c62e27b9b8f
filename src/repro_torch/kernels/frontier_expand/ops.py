"""Public wrapper: full CSR wavefront expansion through the LBS kernel.

The counterpart of ``repro/kernels/frontier_expand/ops.py``.  Only the
search runs in the kernel.  The glue around it -- chunk degrees, the scan,
the clip, ``chunk_row_of`` and ``gather_neighbors`` -- is
``core/frontier.lbs_expansion``, plain PyTorch shared with the plain
backend, as the reference keeps it outside its kernel too.
"""
from __future__ import annotations

import torch

from ...core.frontier import Expansion, lbs_expansion
from .kernel import lbs_cuda
from .ref import lbs_ref


def lbs(scan: torch.Tensor, budget: int):
    """The search: the kernel for a CUDA tensor, its plain version for a
    CPU tensor."""
    return lbs_cuda(scan, budget) if scan.is_cuda else lbs_ref(scan, budget)


def frontier_expand(items, valid, row_ptr, col_idx, budget: int,
                    widths=None, max_width: int = 1) -> Expansion:
    """Drop-in replacement for ``core.frontier.expand_merge_path`` that runs
    the merge-path search through :func:`lbs`; identical outputs."""
    return lbs_expansion(lbs, items, valid, row_ptr, col_idx, budget, widths,
                         max_width)
