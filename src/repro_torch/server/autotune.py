"""Scheduler configuration autotuner: the paper's selection guidelines, live.

The counterpart of ``repro/server/autotune.py``.  Atos section 7 says when
each launch configuration wins: persistent kernels when frontiers are
small, discrete when rounds are few and fat, wide wavefronts for
heavy-tailed frontiers, narrow ones for meshes.  The autotuner *measures*
a candidate grid over ``SchedulerConfig = (strategy, num_workers,
fetch_size, backend, topology, granularity)`` on a calibration workload
and caches the winner per ``(algorithm, graph_class)``.

The axes are the reference's, with the port's backend names:
``BACKEND_GRID = ("torch", "cuda")`` (the plain PyTorch versions and the
hand-written kernels; results are bit-identical, so the tuner picks on
wall time alone).  ``cuda`` candidates need CUDA tensors: on a CPU graph
:meth:`Autotuner.tune` measures only the candidates that can run there and
logs the ones it skipped; on the card every candidate runs, the megakernel
block's drain kernels included.  The default candidate is
``SchedulerConfig()`` with its ``auto`` backend resolved for the
calibration graph (``cuda`` on the card, ``torch`` on the host); it is
always measured.

The default search is successive halving seeded by a graph-statistics cost
model (:func:`graph_stats`, :func:`predict_cost`): only the
predicted-cheapest ``max(2, N // 4)`` cells are measured, halving the
survivors between rounds; ``search="grid"`` measures every candidate.
:func:`structural_cost_runner` is a deterministic stand-in for the wall
clock.  Its CRC tiebreak hashes the configuration key, which spells the
backend, so its tiebreaks differ from the reference's; the untied cost is
:func:`structural_cost`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
import statistics
import tempfile
import time
import zlib
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

from ..core.scheduler import SchedulerConfig
from ..graph.csr import CSRGraph
from ..runtime.policy import policy_of

log = logging.getLogger("repro_torch.server.autotune")

#: curated launch shapes: both kernel strategies, narrow->wide wavefronts;
#: the plain ``SchedulerConfig()`` launch shape first.
_BASE_GRID: Tuple[SchedulerConfig, ...] = (
    SchedulerConfig(),                                       # the default
    SchedulerConfig(num_workers=16, fetch_size=1),
    SchedulerConfig(num_workers=64, fetch_size=4),
    SchedulerConfig(num_workers=256, fetch_size=1),
    SchedulerConfig(num_workers=16, fetch_size=1, persistent=False),
    SchedulerConfig(num_workers=64, fetch_size=1, persistent=False),
)

#: the searched backends -- the resolved axis values only ("auto" would
#: alias one of them and waste calibration runs).
BACKEND_GRID: Tuple[str, ...] = ("torch", "cuda")

#: the searched execution topologies.  ``sharded`` stays out, as in the
#: reference: it needs a mesh the calibration host may not have, and it
#: wins on capacity, not on calibration wall time; a cache that records a
#: sharded config parses all the same.
TOPOLOGY_GRID: Tuple[str, ...] = ("single", "fused")

#: the searched task granularities.
GRANULARITY_GRID: Tuple[int, ...] = (1, 4)

#: the megakernel strategy as a small block of its own: its bodies expand
#: through the row-slice stream and its queue ops run on the plain
#: backend, so crossing it with ``backend`` would only duplicate cells.
MEGAKERNEL_GRID: Tuple[SchedulerConfig, ...] = tuple(
    SchedulerConfig(num_workers=w, kernel="megakernel",
                    topology="auto" if t == "single" else t, granularity=g)
    for g in GRANULARITY_GRID
    for t in TOPOLOGY_GRID
    for w in (16, 64)
)

#: full candidate grid: every launch shape crossed with every backend,
#: topology and granularity, then the megakernel block.
DEFAULT_CANDIDATES: Tuple[SchedulerConfig, ...] = tuple(
    dataclasses.replace(c, backend=b,
                        topology="auto" if t == "single" else t,
                        granularity=g)
    for g in GRANULARITY_GRID
    for t in TOPOLOGY_GRID
    for b in BACKEND_GRID
    for c in _BASE_GRID
) + MEGAKERNEL_GRID


def default_config(graph: CSRGraph) -> SchedulerConfig:
    """``SchedulerConfig()`` with its ``auto`` backend resolved for
    ``graph``: what an untuned server runs, and the candidate every tune
    measures."""
    return dataclasses.replace(
        SchedulerConfig(), backend="cuda" if graph.row_ptr.is_cuda
        else "torch")


def _can_run(cfg: SchedulerConfig, graph: CSRGraph) -> bool:
    """Whether ``cfg`` can drain ``graph`` where it lives: the ``cuda``
    backend needs CUDA tensors."""
    return cfg.backend != "cuda" or graph.row_ptr.is_cuda


def graph_class(graph: CSRGraph) -> str:
    """Two-regime split from degree statistics (paper's dataset taxonomy)."""
    deg = graph.degrees()
    max_deg = float(deg.max())
    avg_deg = float(deg.to(torch.float32).mean())
    return "scale_free" if max_deg >= 4.0 * avg_deg + 8.0 else "mesh"


#: cache schema: 1 = grid entries without a "schema" field (still parse),
#: 2 = adds search/cells_total/cells_measured/cost_model.
AUTOTUNE_SCHEMA = 2


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Degree-derived features the cost model sees.

    ``frontier_growth`` is the mean degree after clipping at the 90th
    percentile (a hub's edges fan out once); ``diameter_proxy`` the
    expected number of drain rounds: ``log(n)/log(growth)`` when the
    degree CV is at least 1, ``sqrt(n)`` for bounded-degree meshes.
    """

    num_vertices: int
    num_edges: int
    avg_degree: float
    degree_cv: float
    frontier_growth: float
    diameter_proxy: float


def _quantile(sorted_x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile of a sorted 1-D float32 tensor (numpy's
    default method), without ``torch.quantile``'s input-size limit."""
    n = sorted_x.shape[0]
    pos = q * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return sorted_x[lo] + (sorted_x[hi] - sorted_x[lo]) * frac


def graph_stats(graph: CSRGraph) -> GraphStats:
    """Distill one calibration graph into the cost model's features.

    float32 reductions on the graph's device, as the reference reduces in
    float32; the population standard deviation (``correction=0``, as
    ``jnp.std``).  The reduction order differs from XLA's, so the features
    agree with the reference's to float32 rounding, not bit for bit.
    """
    deg = graph.degrees().to(torch.float32)
    n = int(graph.num_vertices)
    avg = float(deg.mean())
    cv = float(deg.std(correction=0)) / max(avg, 1e-9)
    ordered = deg.sort().values
    clip = _quantile(ordered, 0.9)
    growth = float(torch.minimum(deg, clip).mean())
    if cv >= 1.0:
        diam = math.log(max(n, 2)) / math.log(max(growth, 2.0))
    else:
        diam = math.sqrt(max(n, 1))
    return GraphStats(num_vertices=n, num_edges=int(graph.num_edges),
                      avg_degree=avg, degree_cv=cv,
                      frontier_growth=max(growth, 1.0),
                      diameter_proxy=max(diam, 1.0))


#: per-round fixed costs, arbitrary units: a discrete drain re-enters a
#: kernel every round, a persistent drain pays only the in-loop poll, the
#: megakernel amortizes even that into one launch.
_ROUND_COST = {"discrete": 8.0, "persistent": 1.0, "megakernel": 0.25}

#: per-round latency charge per launched lane.
_WIDTH_COST = 0.01


def predict_cost(cfg: SchedulerConfig, stats: GraphStats) -> float:
    """Relative drain-cost score for one candidate (arbitrary units): the
    paper's section-7 guidelines as arithmetic, used only to *rank*
    candidates when seeding successive halving.  Rounds are a frontier
    ramp (the diameter proxy) plus a drain phase retiring at most
    ``lanes`` tasks a round out of a rescan-inflated vertex budget; a
    round costs its strategy's fixed entry, one expansion (~avg degree)
    and a width penalty."""
    lanes = float(cfg.num_workers * cfg.fetch_size * max(cfg.granularity, 1))
    rescan = 1.0 + 0.5 * stats.degree_cv
    budget = stats.num_vertices * rescan
    rounds = stats.diameter_proxy + budget / lanes
    per_round = (_ROUND_COST[policy_of(cfg).kernel]
                 + max(stats.avg_degree, 1.0) + _WIDTH_COST * lanes)
    return rounds * per_round


def structural_cost(algorithm: str, graph: CSRGraph,
                    cfg: SchedulerConfig) -> float:
    """The untied structural cost: the drain simulated round by round with
    :func:`predict_cost`'s per-round wall model -- the frontier starts at
    one task, each round retires at most ``lanes`` of it and the rest grows
    by the hub-clipped branching factor until the rescan-inflated vertex
    budget is spent -- times an algorithm multiplier for rescan breadth."""
    stats = graph_stats(graph)
    lanes = float(cfg.num_workers * cfg.fetch_size * max(cfg.granularity, 1))
    rescan = 1.0 + 0.5 * stats.degree_cv
    budget = stats.num_vertices * rescan
    per_round = (_ROUND_COST[policy_of(cfg).kernel]
                 + max(stats.avg_degree, 1.0) + _WIDTH_COST * lanes)
    frontier, cost = 1.0, 0.0
    for _ in range(100_000):
        if budget <= 0.0 or frontier <= 0.0:
            break
        take = min(frontier, lanes, budget)
        cost += per_round
        budget -= take
        frontier = min(frontier - take + take * stats.frontier_growth,
                       budget)
    mult = {"bfs": 1.0, "coloring": 1.5, "pagerank": 2.5}.get(algorithm, 1.0)
    return cost * mult


def structural_cost_runner(algorithm: str, graph: CSRGraph,
                           cfg: SchedulerConfig) -> float:
    """Deterministic drop-in for the calibration runner: the
    :func:`structural_cost` of ``cfg``, with a CRC-derived epsilon of its
    configuration key that breaks exact ties, so grid and successive
    halving agree on tie-heavy candidate sets."""
    tiebreak = 1.0 + (zlib.crc32(_config_key(cfg).encode()) % 997) * 1e-9
    return structural_cost(algorithm, graph, cfg) * tiebreak


def _config_key(cfg: SchedulerConfig) -> str:
    # the leading segment is the resolved kernel-strategy name; the
    # default single topology and granularity 1 are omitted
    kind = policy_of(cfg).kernel
    key = (f"{kind}|workers={cfg.num_workers}|fetch={cfg.fetch_size}"
           f"|backend={cfg.backend}")
    topology = policy_of(cfg).topology
    if topology != "single":
        key += f"|topology={topology}"
    if cfg.granularity != 1:
        key += f"|granularity={cfg.granularity}"
    return key


def _config_dict(cfg: SchedulerConfig) -> dict:
    return {"num_workers": cfg.num_workers, "fetch_size": cfg.fetch_size,
            "persistent": cfg.persistent, "backend": cfg.backend,
            "topology": policy_of(cfg).topology,
            "granularity": cfg.granularity,
            "kernel": cfg.kernel}


def _load_topology(stored: Optional[str]) -> str:
    # "single" and "auto" resolve identically off-mesh; loads normalize to
    # "auto" so reloaded configs compare equal to the default candidates
    return "auto" if stored in (None, "single") else str(stored)


def _config_from_dict(d: dict) -> SchedulerConfig:
    # entries without the later axes were measured on the plain backend's
    # single topology at granularity 1
    return SchedulerConfig(num_workers=int(d["num_workers"]),
                           fetch_size=int(d["fetch_size"]),
                           persistent=bool(d["persistent"]),
                           backend=str(d.get("backend", "torch")),
                           topology=_load_topology(d.get("topology")),
                           granularity=int(d.get("granularity", 1)),
                           kernel=str(d.get("kernel", "auto")))


def _default_runner(algorithm: str, graph: CSRGraph,
                    cfg: SchedulerConfig) -> None:
    """One complete calibration run (result discarded; wall time is the
    signal), synchronized with the card when it ran there."""
    from ..algorithms import bfs, coloring, pagerank

    if algorithm == "bfs":
        out, _ = bfs.bfs_speculative(graph, 0, cfg)
    elif algorithm == "pagerank":
        out, _ = pagerank.pagerank_async(graph, cfg, eps=1e-4)
    elif algorithm == "coloring":
        out, _ = coloring.coloring_async(graph, cfg)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if out.is_cuda:
        torch.cuda.synchronize(out.device)


class Autotuner:
    """Measure-once, reuse-everywhere config selection.

    ``tune`` returns the winning :class:`SchedulerConfig` for one
    ``(algorithm, graph_class)``; ``recommend_for_mix`` aggregates the
    cached trials across a job mix and picks the config minimizing total
    calibration wall time.  ``search`` is ``"sh"`` (cost-model-seeded
    successive halving, the default) or ``"grid"`` (every candidate).
    ``runner`` may return a float to be used as the measurement instead of
    its wall time (see :func:`structural_cost_runner`).
    """

    def __init__(
        self,
        cache_path: Optional[str | Path] = None,
        candidates: Sequence[SchedulerConfig] = DEFAULT_CANDIDATES,
        warmup: int = 1,
        iters: int = 2,
        runner=_default_runner,
        search: str = "sh",
    ) -> None:
        if search not in ("sh", "grid"):
            raise ValueError(f"unknown search {search!r}; want 'sh'|'grid'")
        self.search = search
        self.cache_path = Path(cache_path) if cache_path else None
        self.candidates = list(candidates)
        self.warmup = warmup
        self.iters = iters
        self.runner = runner
        self._cache: Dict[str, dict] = {}
        if self.cache_path and self.cache_path.exists():
            self._cache = json.loads(self.cache_path.read_text())
            log.info("autotune cache loaded: %d entries from %s",
                     len(self._cache), self.cache_path)

    # ------------------------------------------------------------- plumbing
    def _save(self) -> None:
        # write-temp-then-rename: a torn JSON would poison every later load
        if self.cache_path:
            self.cache_path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=self.cache_path.parent,
                prefix=self.cache_path.name + ".", suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(json.dumps(self._cache, indent=2,
                                       sort_keys=True))
                os.replace(tmp, self.cache_path)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise

    def _measure(self, algorithm: str, graph: CSRGraph,
                 cfg: SchedulerConfig) -> float:
        for _ in range(self.warmup):
            self.runner(algorithm, graph, cfg)
        walls = []
        for _ in range(self.iters):
            t0 = time.perf_counter()
            returned = self.runner(algorithm, graph, cfg)
            wall = time.perf_counter() - t0
            walls.append(float(returned) if returned is not None else wall)
        return statistics.median(walls)

    @staticmethod
    def cache_key(algorithm: str, graph: CSRGraph) -> str:
        return f"{algorithm}|{graph_class(graph)}"

    # ------------------------------------------------------------------ api
    def tune(self, algorithm: str, graph: CSRGraph) -> SchedulerConfig:
        """Winning config for (algorithm, class-of-graph); cached."""
        key = self.cache_key(algorithm, graph)
        if key in self._cache:
            entry = self._cache[key]
            log.info("autotune cache hit %s -> %s", key, entry["chosen"])
            return _config_from_dict(entry["config"])

        # the candidates that can run where the graph lives, the default
        # first when the list lacks it
        default = default_config(graph)
        candidates = [c for c in self.candidates if _can_run(c, graph)]
        if default not in candidates:
            candidates.insert(0, default)
        skipped = [_config_key(c) for c in self.candidates
                   if not _can_run(c, graph)]
        if skipped:
            log.info("autotune %s: skipped %d candidates that cannot run on "
                     "%s: %s", key, len(skipped), graph.device,
                     ", ".join(skipped))
        stats = graph_stats(graph)
        predicted = {_config_key(c): predict_cost(c, stats)
                     for c in candidates}
        if self.search == "grid":
            measured = list(candidates)
        else:
            # measure only the predicted-cheapest quarter (floor 2), the
            # default force-included
            budget = max(2, len(candidates) // 4)
            ranked = sorted(candidates,
                            key=lambda c: predicted[_config_key(c)])
            measured = []
            for cfg in [default, *ranked]:
                if cfg not in measured:
                    measured.append(cfg)
                if len(measured) >= budget:
                    break

        samples: Dict[str, List[float]] = {_config_key(c): []
                                           for c in measured}
        trials: Dict[str, float] = {}

        def _round(survivors: List[SchedulerConfig]) -> None:
            for cfg in survivors:
                wall = self._measure(algorithm, graph, cfg)
                samples[_config_key(cfg)].append(wall)
                log.info("autotune %s: %s -> %.4fs", key, _config_key(cfg),
                         wall)
            trials.update({ck: statistics.median(v)
                           for ck, v in samples.items() if v})

        if self.search == "grid":
            _round(measured)
            best = min(measured, key=lambda c: trials[_config_key(c)])
        else:
            survivors = list(measured)
            if len(survivors) == 1:
                _round(survivors)
            while len(survivors) > 1:
                _round(survivors)
                survivors = sorted(
                    survivors,
                    key=lambda c: trials[_config_key(c)])[:(len(survivors)
                                                            + 1) // 2]
            best = survivors[0]

        entry = {
            "schema": AUTOTUNE_SCHEMA,
            "chosen": _config_key(best),
            "config": _config_dict(best),
            "trials": trials,
            "default_wall": trials[_config_key(default)],
            "calibration_graph": {"n": graph.num_vertices,
                                  "m": graph.num_edges},
            "search": self.search,
            "cells_total": len(candidates),
            "cells_measured": len(measured),
            "cells_skipped": skipped,
            "cost_model": {"stats": dataclasses.asdict(stats),
                           "predicted": {ck: predicted[ck]
                                         for ck in samples}},
        }
        self._cache[key] = entry
        self._save()
        log.info(
            "autotune decision %s: chose %s (%.4fs) vs default %s (%.4fs)",
            key, entry["chosen"], trials[entry["chosen"]],
            _config_key(default), entry["default_wall"])
        return best

    def recommend_for_mix(
        self, pairs: Iterable[Tuple[str, CSRGraph]]
    ) -> SchedulerConfig:
        """One shared config for a mixed job batch: tune each distinct
        (algorithm, graph-class), then pick the candidate whose *summed*
        calibration wall across the mix is smallest."""
        distinct: Dict[str, CSRGraph] = {}
        for algorithm, graph in pairs:
            distinct.setdefault(self.cache_key(algorithm, graph), graph)
        entries: List[dict] = []
        for key, graph in distinct.items():
            algorithm = key.split("|", 1)[0]
            self.tune(algorithm, graph)  # fills the cache
            entries.append(self._cache[key])
        if not entries:
            return SchedulerConfig()
        # only candidates measured for every workload are comparable
        shared = set(entries[0]["trials"])
        for e in entries[1:]:
            shared &= set(e["trials"])
        if not shared:
            chosen = [e["chosen"] for e in entries]
            best_key = max(chosen, key=chosen.count)
            log.warning(
                "autotune mix: cached trials share no candidates; falling "
                "back to majority per-workload winner %s", best_key)
            return _parse_config_key(best_key)
        totals = {ck: sum(e["trials"][ck] for e in entries) for ck in shared}
        best_key = min(totals, key=totals.get)
        log.info("autotune mix recommendation: %s (total %.4fs)",
                 best_key, totals[best_key])
        return _parse_config_key(best_key)


def _parse_config_key(key: str) -> SchedulerConfig:
    # keys without the later segments were measured on the plain
    # backend's single topology at granularity 1
    kind, workers, fetch, *rest = key.split("|")
    extras = dict(part.split("=", 1) for part in rest)
    return SchedulerConfig(
        num_workers=int(workers.split("=")[1]),
        fetch_size=int(fetch.split("=")[1]),
        persistent=(kind != "discrete"),
        kernel=("megakernel" if kind == "megakernel" else "auto"),
        backend=extras.get("backend", "torch"),
        topology=_load_topology(extras.get("topology")),
        granularity=int(extras.get("granularity", 1)),
    )
