"""Work-stealing rebalance over the shard ring.

The counterpart of ``repro/shard/steal.py``.  Every shard takes the same
rounds whatever its occupancy, so skew inflates the number of rounds: the
drain ends when the richest shard finishes.  When the gap between the
richest and poorest replica passes ``steal_threshold x mean``, each shard
donates up to ``steal_chunk`` of its surplus to its ring successor, which
can expand them because it carries the donor's block as a steal halo
(``shard/partition.py``).

The plan is a pure function of the gathered occupancy vector, so it is
computed once for all shards.  Donations come only from the LOCAL lane
(owned tasks) and land in the receiver's STOLEN lane, which is never
donated again: a task strays at most one ring hop from home.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..core.queue import EMPTY, MultiQueue
from .exchange import LANE_LOCAL, LANE_STOLEN, all_gather, ppermute

_I32 = torch.int32
_F32 = torch.float32


def plan_donations(sizes: torch.Tensor, threshold: float,
                   chunk: int) -> torch.Tensor:
    """Per-shard donation counts toward the ring successor.

    Donation ``d -> d + 1`` moves surplus above the (ceil) mean into the
    successor's deficit below it, capped at ``chunk``; nothing moves
    unless the max-min gap exceeds ``threshold x mean`` (compared in
    float32, as the reference does).
    """
    sizes = torch.as_tensor(sizes).to(_I32)
    s = sizes.shape[0]
    total = sizes.sum(dtype=_I32)
    mean = total // s + (total % s > 0).to(_I32)
    gap = sizes.max() - sizes.min()
    trigger = gap.to(_F32) > threshold * torch.clamp(mean, min=1).to(_F32)
    surplus = torch.clamp(sizes - mean, min=0)
    deficit = torch.clamp(mean - torch.roll(sizes, -1), min=0)
    give = torch.clamp(torch.minimum(surplus, deficit), max=chunk)
    return torch.where(trigger, give, 0).to(_I32)


def rebalance(mqs: Sequence[MultiQueue], *, devices, threshold: float,
              chunk: int, backend: str = "auto", width_of=None
              ) -> Tuple[List[MultiQueue], List[torch.Tensor], torch.Tensor]:
    """One stealing step over every shard: donate surplus owned tasks to
    the ring successor.

    Returns ``(mqs', n_donated, triggered)``: each shard's replica and its
    donation (in vertices), and the plan's trigger on shard 0's device.
    Runs every round (the round schedule is uniform); an all-zero plan
    ships only sentinels.  ``width_of`` (task -> chunk width) counts
    occupancy and donations in vertices, and the quota'd pop donates
    whole chunks only.
    """
    loads = [mq.lane_loads(width_of) for mq in mqs]
    sizes = all_gather([ld[LANE_LOCAL] + ld[LANE_STOLEN] for ld in loads],
                       devices[:1])[0]
    give = plan_donations(sizes, threshold, chunk)
    bufs, donated, popped = [], [], []
    for d, mq in enumerate(mqs):
        k = give[d:d + 1].to(devices[d], non_blocking=True)
        items, valid, mq = mq.pop_lane(LANE_LOCAL, chunk, quota=k,
                                       width_of=width_of)
        popped.append(mq)
        bufs.append(torch.where(valid, items, EMPTY))
        donated.append(valid.sum(dtype=_I32) if width_of is None else
                       torch.where(valid, width_of(items), 0).sum(dtype=_I32))
    recv = ppermute(bufs, devices)
    out = [mq.push(LANE_STOLEN, r, r != EMPTY, backend=backend)
           for mq, r in zip(popped, recv)]
    return out, donated, (give > 0).any()
