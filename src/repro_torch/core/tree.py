"""Minimal pytree helpers over tensors, frozen dataclasses and tuples.

JAX threads its drain state as pytrees; the port keeps the same shapes
(frozen dataclasses, NamedTuples, tuples) and needs three whole-tree
operations on them: a leafwise map, a leafwise device-side select (the
stand-in for ``jax.lax.cond`` and for a predicated while-loop step), and a
conversion to numpy for handing state to the reference package.
"""
from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest, is_leaf=None):
    """Apply ``fn`` to every tensor leaf (or ``is_leaf`` node) of ``tree``,
    zipping the same positions of the trees in ``rest``.  Leaves that are
    neither tensors nor containers are returned unchanged."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest),
                             is_leaf=is_leaf)
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        return type(tree)(*(tree_map(fn, *xs, is_leaf=is_leaf)
                            for xs in zip(tree, *rest)))
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, *xs, is_leaf=is_leaf)
                     for xs in zip(tree, *rest))
    return tree


def tree_where(flag: torch.Tensor, on_true, on_false):
    """Leafwise ``torch.where(flag, on_true, on_false)`` with a 0-dim device
    flag: a branch taken on the device, with no host sync.  Leaves that are
    the same tensor in both trees are passed through uncopied."""
    return tree_map(lambda a, b: a if a is b else torch.where(flag, a, b),
                    on_true, on_false)


def to_numpy(tree):
    """Copy every tensor leaf to a numpy array (same tree structure)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
