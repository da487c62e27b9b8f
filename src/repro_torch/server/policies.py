"""Fairness policies: how one wavefront's budget is split across job lanes.

The counterpart of ``repro/server/policies.py``, a plain copy: policies
are host-side numpy, scheduling control flow between device dispatches.
Each round the server has a budget of ``W = num_workers x fetch_size``
pop slots (vertex slots ``W x G`` at granularity G > 1); a policy turns
the observed per-lane queue sizes into per-lane quotas summing to at most
the budget:

  * ``round_robin``         -- the whole wavefront to the next non-empty
    lane in rotation (Atos's ``num_queues``, one tenant per round);
  * ``weighted``            -- weighted max-min fair water-filling: budget a
    small-frontier lane cannot use spills to hungrier lanes, which fuses
    tenants into one wavefront;
  * ``longest_queue_first`` -- the whole wavefront to the fullest lane.

Lanes flagged ``boosted`` (their drop counter grew last round) are served
first, up to their demand: draining relieves a full ring buffer.
"""
from __future__ import annotations

import numpy as np


class FairnessPolicy:
    """Base: pre-serves backpressured lanes, then delegates to ``_allocate``."""

    name = "base"

    def allocate(self, sizes, weights, boosted, wavefront: int) -> np.ndarray:
        sizes = np.asarray(sizes, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.float64)
        boosted = np.asarray(boosted, dtype=bool)
        quotas = np.zeros_like(sizes)
        budget = int(wavefront)
        # drain-boost: backpressured lanes are served first, up to demand
        for lane in np.flatnonzero(boosted & (sizes > 0)):
            give = min(int(sizes[lane]), budget)
            quotas[lane] = give
            budget -= give
            if budget == 0:
                return quotas
        rest = self._allocate(sizes - quotas, weights, budget)
        return quotas + rest

    def _allocate(self, sizes, weights, budget: int) -> np.ndarray:
        raise NotImplementedError


class RoundRobin(FairnessPolicy):
    """Whole budget to the next non-empty lane in rotation (Atos classic)."""

    name = "round_robin"

    def __init__(self) -> None:
        self.cursor = 0

    def _allocate(self, sizes, weights, budget):
        quotas = np.zeros_like(sizes)
        num_lanes = len(sizes)
        if budget <= 0 or num_lanes == 0:
            return quotas
        for off in range(num_lanes):
            lane = (self.cursor + off) % num_lanes
            if sizes[lane] > 0:
                quotas[lane] = min(int(sizes[lane]), budget)
                self.cursor = (lane + 1) % num_lanes
                break
        return quotas


class WeightedShare(FairnessPolicy):
    """Weighted max-min fairness via integer water-filling.

    The in-order distribution is rotated by one lane per round: when the
    budget is smaller than the number of hungry lanes, truncation otherwise
    always hits the same high-index lanes (unbounded starvation).
    """

    name = "weighted"

    def __init__(self) -> None:
        self.rotation = 0

    def _allocate(self, sizes, weights, budget):
        quotas = np.zeros_like(sizes)
        demand = sizes.copy()
        rotation, self.rotation = self.rotation, self.rotation + 1
        while budget > 0:
            hungry = np.flatnonzero(demand > 0)
            if len(hungry) == 0:
                break
            hungry = np.roll(hungry, -(rotation % len(hungry)))
            w = weights[hungry]
            w = w / w.sum() if w.sum() > 0 else np.full(len(hungry),
                                                        1.0 / len(hungry))
            # proportional shares, at least 1 slot each while budget lasts
            shares = np.maximum(1, np.floor(budget * w)).astype(np.int64)
            gave = 0
            for lane, share in zip(hungry, shares):
                give = min(int(share), int(demand[lane]), budget - gave)
                quotas[lane] += give
                demand[lane] -= give
                gave += give
                if gave == budget:
                    break
            if gave == 0:
                break
            budget -= gave
        return quotas


class LongestQueueFirst(FairnessPolicy):
    """Whole budget to the fullest lane (throughput-greedy)."""

    name = "longest_queue_first"

    def _allocate(self, sizes, weights, budget):
        quotas = np.zeros_like(sizes)
        if budget <= 0 or len(sizes) == 0 or sizes.max(initial=0) <= 0:
            return quotas
        lane = int(np.argmax(sizes))
        quotas[lane] = min(int(sizes[lane]), budget)
        return quotas


_POLICIES = {
    "round_robin": RoundRobin,
    "weighted": WeightedShare,
    "longest_queue_first": LongestQueueFirst,
}


def make_policy(name: str) -> FairnessPolicy:
    if name not in _POLICIES:
        raise ValueError(f"unknown policy {name!r}; "
                         f"expected one of {sorted(_POLICIES)}")
    return _POLICIES[name]()
