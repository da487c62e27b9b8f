"""Plain PyTorch version of the ordered scatter-add.

``out = base.clone(); out[index[u]] += values[u]`` for ``u = 0, 1, ...`` in
turn, so that each slot gets ``((base + v1) + v2) + ...`` in update order:
what ``residue.at[nbr].add(contrib)`` gives on XLA's CPU backend, which
applies the updates one by one.
"""
from __future__ import annotations

import torch


def ordered_scatter_add_ref(base: torch.Tensor, index: torch.Tensor,
                            values: torch.Tensor) -> torch.Tensor:
    """A new tensor: ``base`` with ``values`` added at ``index`` in update
    order.  On CPU tensors ``index_add_`` adds in that order.  On CUDA
    tensors ``index_put_(accumulate=True)`` under deterministic algorithms
    gives the same sum on every run, but not in update order: on the H100
    it differs from the CPU's sequential sum in the low bits, so a plain
    PageRank run on the card is held to the eps contract, not bitwise."""
    out = base.clone()
    index = index.reshape(-1).long()
    values = values.reshape(-1).to(base.dtype)
    if not out.is_cuda:
        return out.index_add_(0, index, values)
    previous = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out.index_put_((index,), values, accumulate=True)
    finally:
        torch.use_deterministic_algorithms(previous, warn_only=warn_only)
    return out
