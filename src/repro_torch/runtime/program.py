"""The :class:`AtosProgram` protocol: declare a drain once, run it anywhere.

The counterpart of ``repro/runtime/program.py``.  An ``AtosProgram``
packages one application's drain:

    init()                    -> (state, seed tasks)
    make_body(graph, ctx)     -> WavefrontFn        (the expansion kernel)
    make_on_empty(graph, ctx) -> optional refill
    stop(state)               -> optional convergence predicate
    empty_means_done          -> does a drained queue end the run?
    result(state), work(state), splits(state), ideal_work
    dirty_seeds(delta, state) -> optional incremental re-seed (stream/)
    make_drain_kernel(graph, ctx, max_rounds)
                              -> optional CUDA drain kernel for the
                                 megakernel strategy (the port's own field)

    task_width(task)          -> chunk width (the task server's
                                 vertex-denominated quotas and loads)
    task_vertex(task)         -> head vertex id (sharded ownership,
                                 routing and stealing)
    merge                     -> per-field replica-merge spec (sharded)

The **merge spec** says how the sharded topology reconciles the state
replicas after each round (``shard/driver.py``).  Each state field names
its rule:

  * ``"pmin"`` / ``"pmax"``   -- monotone lattices (BFS ``dist``);
  * ``"sum_delta"``           -- ``prev + psum(new - prev)``, exact for
    single-writer or additive fields (PageRank's residue and rank,
    coloring's colors); the sum runs in shard order, as the reference's;
  * ``"or_delta"``            -- boolean single-writer fields;
  * ``"replicated"``          -- identical on every shard: no collective;
  * ``"work_counter"``        -- a whole WorkCounter: ``work`` and
    ``splits`` by ``sum_delta``, ``rounds`` (ticked in lockstep) as is.

A spec is a dict over the state's dataclass fields, one rule name for the
whole state, or a callable ``(prevs, news, devices) -> merged``.  The port
is single-controller: a rule takes the list of per-shard replicas before
and after the round and returns the list of merged replicas.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, \
    Union

import torch

from ..core.counters import WorkCounter
from ..core.tree import tree_map


def unit_task_width(items: torch.Tensor) -> torch.Tensor:
    """Default ``task_width``: every task is one vertex wide (G = 1)."""
    return torch.ones_like(items, dtype=torch.int32)


def identity_task_vertex(items: torch.Tensor) -> torch.Tensor:
    """Default ``task_vertex``: the task is its vertex id."""
    return items


class ProgramContext(NamedTuple):
    """Where a wavefront body is about to run.

    Under the sharded topology ``shard`` is the shard's index, ``axis_name``
    the mesh (a ``launch.mesh.ShardMesh``) and the graph handed to the
    builders is the shard's CSR slice: static bounds (budgets, max degree)
    come from the program's view of the global graph, so every shard runs
    the same computation.  Outside it both are None.
    """

    wavefront: int
    num_workers: int
    backend: str = "auto"
    granularity: int = 1         # max chunk width G (core/task.py)
    shard: Optional[int] = None
    num_shards: int = 1
    axis_name: Any = None

    @property
    def sharded(self) -> bool:
        return self.axis_name is not None


# ------------------------------------------------------------- merge rules
def _leaves(tree, is_leaf=None) -> list:
    out: list = []
    tree_map(lambda x: out.append(x) or x, tree, is_leaf=is_leaf)
    return out


def _rebuild(tree, leaves, is_leaf=None):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)


def delta_psum(prevs: List[torch.Tensor], news: List[torch.Tensor],
               devices) -> List[torch.Tensor]:
    """``prev + psum(new - prev)`` on every shard: the deltas summed in
    shard order on shard 0's device (``shard/exchange.reduce_sum``)."""
    from ..shard.exchange import broadcast, reduce_sum  # lazy: shard->here

    # the replicas of ``prev`` are equal, so the sum is added once
    total = reduce_sum([n - p for p, n in zip(prevs, news)], devices[0])
    return broadcast(prevs[0].to(devices[0]) + total, devices)


def _or_delta(prevs, news, devices):
    merged = delta_psum([p.to(torch.int32) for p in prevs],
                        [n.to(torch.int32) for n in news], devices)
    return [m > 0 for m in merged]


def _pmin(prevs, news, devices):
    from ..shard.exchange import pmin

    return pmin(news, devices)


def _pmax(prevs, news, devices):
    from ..shard.exchange import pmax

    return pmax(news, devices)


def _merge_work_counter(prevs, news, devices):
    """A whole WorkCounter: ``work`` and ``splits`` by delta-psum,
    ``rounds`` as is (every replica ticks it once a round)."""
    work = delta_psum([p.work for p in prevs], [n.work for n in news],
                      devices)
    splits = delta_psum([p.splits for p in prevs], [n.splits for n in news],
                        devices)
    return [dataclasses.replace(n, work=w, splits=s)
            for n, w, s in zip(news, work, splits)]


def _is_work_counter(x) -> bool:
    return isinstance(x, WorkCounter)


#: rules that take a whole sub-tree instead of its tensor leaves
_merge_work_counter.whole = _is_work_counter  # type: ignore[attr-defined]

MERGE_RULES: Dict[str, Callable] = {
    "pmin": _pmin,
    "pmax": _pmax,
    "sum_delta": delta_psum,
    "or_delta": _or_delta,
    "replicated": lambda prevs, news, devices: list(news),
    "work_counter": _merge_work_counter,
}

MergeSpec = Union[str, Callable, Dict[str, Union[str, Callable]]]


def _leafwise(rule: Callable, prevs: list, news: list, devices) -> list:
    """Apply ``rule`` to each leaf position across the shards' trees."""
    is_leaf = getattr(rule, "whole", None)
    per_shard_leaves = [_leaves(t, is_leaf) for t in news]
    prev_leaves = [_leaves(t, is_leaf) for t in prevs]
    merged = [rule([pl[i] for pl in prev_leaves],
                   [nl[i] for nl in per_shard_leaves], devices)
              for i in range(len(per_shard_leaves[0]))]
    return [_rebuild(news[d], [m[d] for m in merged], is_leaf)
            for d in range(len(news))]


def build_merge(spec: MergeSpec) -> Callable[[list, list, Any], list]:
    """Compile a merge spec into ``merge(prevs, news, devices) -> list``."""
    if callable(spec):
        return spec
    if isinstance(spec, str):
        rule = MERGE_RULES[spec]
        return lambda prevs, news, devices: _leafwise(rule, prevs, news,
                                                      devices)
    if isinstance(spec, dict):
        rules = {name: (MERGE_RULES[r] if isinstance(r, str) else r)
                 for name, r in spec.items()}

        def merge(prevs, news, devices):
            fields = {f.name for f in dataclasses.fields(prevs[0])}
            unknown = set(rules) - fields
            if unknown:
                raise ValueError(
                    f"merge spec names unknown state fields {sorted(unknown)}")
            # a spec must be total: keeping ``prev`` for an omitted field
            # would drop that field's per-shard updates every round
            missing = fields - set(rules)
            if missing:
                raise ValueError(
                    f"merge spec missing rules for state fields "
                    f"{sorted(missing)} (declare 'replicated' for fields "
                    f"that are identical on every shard)")
            merged = {name: _leafwise(rule, [getattr(p, name) for p in prevs],
                                      [getattr(n, name) for n in news],
                                      devices)
                      for name, rule in rules.items()}
            return [dataclasses.replace(
                prevs[d], **{name: merged[name][d] for name in rules})
                for d in range(len(news))]

        return merge
    raise TypeError(f"bad merge spec: {spec!r}")


@dataclasses.dataclass(frozen=True)
class AtosProgram:
    """One drain, declared once, runnable under every execution policy."""

    name: str
    init: Callable[[], Tuple[Any, Any]]
    make_body: Callable[..., Callable]       # (graph, ProgramContext) -> f
    result: Callable[[Any], Any]
    make_on_empty: Optional[Callable] = None  # (graph, ctx) -> on_empty fn
    stop: Optional[Callable[[Any], torch.Tensor]] = None
    #: does a globally empty queue end the drain?
    empty_means_done: bool = True
    work: Optional[Callable[[Any], torch.Tensor]] = None
    splits: Optional[Callable[[Any], torch.Tensor]] = None
    ideal_work: int = 0
    #: capacity hint when the caller does not size the queue explicitly
    default_queue_capacity: int = 1024
    #: ``(graph, ctx, max_rounds) -> runner(carry, limit)``: the program's
    #: hand-written drain kernel for ``kernel="megakernel"`` on CUDA
    #: tensors, or None where this program has none.  The
    #: runner drains while ``rounds < min(max_rounds, limit)`` and the
    #: body's ``cond`` holds, bit-identical to the plain fused drain.
    make_drain_kernel: Optional[Callable] = None
    #: the streaming hook: ``dirty_seeds(applied, state) -> (state',
    #: seeds)`` re-seeds only the frontier a committed delta batch
    #: invalidated (``applied`` a ``stream.ingest.AppliedDelta`` whose
    #: ``new_graph`` this program was built on, ``state`` the previous
    #: drain's final state).  None: the stream driver re-seeds in full
    #: through ``init()``.
    dirty_seeds: Optional[Callable[[Any, Any], Tuple[Any, Any]]] = None
    #: natural task -> chunk width: feeds the task server's
    #: vertex-denominated lane loads and pop quotas at granularity > 1
    task_width: Callable[[torch.Tensor], torch.Tensor] = unit_task_width
    #: how the sharded topology reconciles the state replicas each round
    merge: MergeSpec = "sum_delta"
    #: task -> head vertex id: ownership, routing and stealing key off it
    task_vertex: Callable[[torch.Tensor], torch.Tensor] = identity_task_vertex

    def body(self, graph, ctx: ProgramContext):
        return self.make_body(graph, ctx)

    def on_empty(self, graph, ctx: ProgramContext):
        if self.make_on_empty is None:
            return None
        return self.make_on_empty(graph, ctx)

    def drain_kernel(self, graph, ctx: ProgramContext, max_rounds: int):
        if self.make_drain_kernel is None:
            return None
        return self.make_drain_kernel(graph, ctx, max_rounds)

    def merge_fn(self) -> Callable[[list, list, Any], list]:
        return build_merge(self.merge)

    def work_of(self, state) -> int:
        return 0 if self.work is None else int(self.work(state))

    def splits_of(self, state) -> int:
        return 0 if self.splits is None else int(self.splits(state))
