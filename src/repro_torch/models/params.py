"""Spec-first parameters: shapes and logical sharding axes declared up front.

The counterpart of ``repro/models/params.py``.  Every module describes its
parameters as a tree of ``P(shape, axes, init)`` (nested dicts with ``P``
leaves); ``init_params`` materialises real weights from it and
``count_params`` counts them.  ``abstract_params`` and ``param_shardings``
wait for the dry-run and sharding slice.

A parameter tree is a nested dict of tensors with the reference's keys, so
``convert.params_from_numpy`` can carry the reference's weights across.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from ..core.backend import resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    """Parameter spec: shape + logical axes (one per dim) + init kind."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"       # normal | zeros | ones | small_normal
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts with the same keys, visited in
    sorted-key order as ``jax.tree.map`` visits them."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def _initializer(spec: P, generator: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    # the reference's rule: f32 normal scaled by 1/sqrt(fan_in), then cast;
    # fan_in is shape[-2], which is d for a stacked [L, d, ff] leaf
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def init_params(spec_tree, seed: int, dtype, device="cuda") -> Any:
    """Random weights for ``spec_tree`` on ``device``, drawn leaf by leaf
    (sorted-key order) from one ``torch.Generator`` seeded with ``seed``.

    The bits differ from ``jax.random``'s for the same seed; tests carry
    the reference's weights across with ``convert.params_from_numpy``.
    """
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    return tree_map(lambda s: _initializer(s, generator, dtype, device),
                    spec_tree)


def stack_layers(spec_tree, n: int):
    """Prepend a stacked 'layers' axis of size n to every spec."""
    return tree_map(lambda s: P((n,) + s.shape, ("layers",) + s.axes,
                                s.init, s.scale), spec_tree)


def count_params(spec_tree) -> int:
    return sum(int(math.prod(s.shape)) for s in tree_leaves(spec_tree))
