"""Public wrapper: the ordered scatter-add on a backend.

``algorithms/pagerank`` adds every wavefront's contributions through
:func:`ordered_scatter_add`, so the residues come out bit for bit the same
on every backend and in every run.
"""
from __future__ import annotations

import torch

from ...core.backend import resolve_backend
from .kernel import ordered_scatter_add_cuda
from .ref import ordered_scatter_add_ref


def ordered_scatter_add(base: torch.Tensor, index: torch.Tensor,
                        values: torch.Tensor,
                        backend: str = "auto") -> torch.Tensor:
    """``base`` with ``values`` added at ``index`` in update order: the
    kernel when ``backend`` resolves to ``"cuda"``, else the plain
    version."""
    if resolve_backend(backend, base) == "cuda":
        return ordered_scatter_add_cuda(base, index, values)
    return ordered_scatter_add_ref(base, index, values)
