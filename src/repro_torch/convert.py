"""Carry state across from the reference package as numpy arrays.

The reference keeps its graphs, queues and algorithm states as pytrees of
arrays; ``np.asarray`` of each leaf hands them to these constructors, and
:func:`to_numpy` hands the port's objects back.  The tests use this to
give both packages the same graph, the same mid-drain queue and state, and
the same model weights (``params_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from .algorithms.bfs import BFSState
from .algorithms.coloring import ColorState
from .algorithms.pagerank import PRState
from .core.backend import resolve_device
from .core.counters import WorkCounter
from .core.queue import TaskQueue
from .core.tree import to_numpy
from .graph.csr import CSRGraph
from .graph.slotted import SlottedView

__all__ = ["graph_from_numpy", "slotted_view_from_numpy", "queue_from_numpy",
           "bfs_state_from_numpy", "pagerank_state_from_numpy",
           "coloring_state_from_numpy", "params_from_numpy", "to_numpy"]


def _int32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.int32), device=device)


def graph_from_numpy(row_ptr, col_idx, device="cuda") -> CSRGraph:
    device = resolve_device(device)
    return CSRGraph(row_ptr=_int32(row_ptr, device),
                    col_idx=_int32(col_idx, device))


def slotted_view_from_numpy(row_ptr, slab_ptr, slab_len, slab_col, ovl_ptr,
                            ovl_col, m, device="cuda") -> SlottedView:
    """A slotted view (``graph.slotted.SlottedView``) from the reference's
    ``SlottedView`` arrays, so both packages drain the same slotted
    graph."""
    device = resolve_device(device)
    return SlottedView(row_ptr=_int32(row_ptr, device),
                       slab_ptr=_int32(slab_ptr, device),
                       slab_len=_int32(slab_len, device),
                       slab_col=_int32(slab_col, device),
                       ovl_ptr=_int32(ovl_ptr, device),
                       ovl_col=_int32(ovl_col, device), m=int(m))


def queue_from_numpy(buf, head, tail, dropped, device="cuda") -> TaskQueue:
    device = resolve_device(device)
    return TaskQueue(buf=_int32(buf, device), head=_int32(head, device),
                     tail=_int32(tail, device),
                     dropped=_int32(dropped, device))


def bfs_state_from_numpy(dist, work, splits, rounds,
                         device="cuda") -> BFSState:
    device = resolve_device(device)
    return BFSState(dist=_int32(dist, device),
                    counter=WorkCounter(work=_int32(work, device),
                                        splits=_int32(splits, device),
                                        rounds=_int32(rounds, device)))


def _counter(work, splits, rounds, device) -> WorkCounter:
    return WorkCounter(work=_int32(work, device),
                       splits=_int32(splits, device),
                       rounds=_int32(rounds, device))


def pagerank_state_from_numpy(rank, residue, in_queue, check_cursor, work,
                              splits, rounds, device="cuda") -> PRState:
    """A PageRank state (``PRState``) from the reference's leaves."""
    device = resolve_device(device)
    return PRState(
        rank=torch.tensor(np.asarray(rank, dtype=np.float32), device=device),
        residue=torch.tensor(np.asarray(residue, dtype=np.float32),
                             device=device),
        in_queue=torch.tensor(np.asarray(in_queue, dtype=bool),
                              device=device),
        check_cursor=_int32(check_cursor, device),
        counter=_counter(work, splits, rounds, device))


def coloring_state_from_numpy(colors, work, splits, rounds,
                              device="cuda") -> ColorState:
    """A coloring state (``ColorState``) from the reference's leaves."""
    device = resolve_device(device)
    return ColorState(colors=_int32(colors, device),
                      counter=_counter(work, splits, rounds, device))


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
        return torch.from_numpy(x.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(x)).to(device)  # a writable copy


def params_from_numpy(tree, device="cuda"):
    """The reference's parameter pytree, leaves as numpy arrays (for
    example ``jax.tree.map(np.asarray, params)``), as the port's nested dict
    of tensors on ``device``, each leaf in its own type."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(tree[k], device) for k in sorted(tree)}
    return _tensor(tree, device)
