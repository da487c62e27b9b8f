"""Persistent and discrete sharded drivers: one Atos drain, many shards.

The counterpart of ``repro/shard/driver.py``, single-controller as the
reference's ``shard_map`` is: one Python process drives every shard of a
:class:`~repro_torch.launch.mesh.ShardMesh`, shard ``d`` on
``mesh.devices[d]``.  Each shard carries a queue replica (a 2-lane
:class:`~repro_torch.core.queue.MultiQueue`: owned tasks and freshly
stolen ones) and a full-size state replica, authoritative for its vertex
block and reconciled every round by the program's merge spec
(``runtime/program.build_merge``).  One **round** runs each phase for
every shard before the next phase starts, so no shard reads a replica
another shard has not merged yet:

  1. *deliver*  -- (deferred mode) push the previous round's staged
                   arrivals into the LOCAL lane;
  2. *steal*    -- occupancy-skew-triggered ring donation (shard/steal.py);
  3. *pop*      -- one ``num_workers x fetch_size`` wavefront, stolen
                   first, with the ownership meter;
  4. *body*     -- the program's wavefront body on the shard's CSR slice
                   (on an empty pop too: a no-op for BFS and coloring, the
                   rescan for PageRank);
  5. *exchange* -- owner split and the per-axis all-to-all
                   (shard/exchange.py), optionally compressed; arrivals are
                   pushed now (strict, ``defer_rounds=0``) or staged for
                   the next round's step 1 (``defer_rounds=1``);
  6. *merge*    -- replica reconciliation (pmin, delta-psum, ...);
  7. *stop*     -- the psum of replica sizes plus staged arrivals, and the
                   program's stop predicate: no shard stops while any shard
                   has live or staged work.

:func:`persistent_run_sharded` runs predicated rounds as the port's
``persistent_drive`` does: ``POLL_EVERY`` rounds between two host reads of
the global flag, none of them synchronizing with the host (CUDA's
sync-debug mode raises inside a window), a round after the flag fell
changing nothing.  :func:`discrete_run_sharded` reads the flag every round
and can record the reference's per-round ``trace`` dicts.  Under both, a
traced drain carries one ring a shard on its device and writes a row a
shard a round inside the round.  A ``max_rounds`` exit flushes staged
arrivals back into the queues.

The reference sizes its staging buffer before the loop by tracing the
body abstractly (``_body_out_width``); here the first round, which runs
unpredicated (its flag was just read), produces the first staged buffer
and so its width: no probe call of the body.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.queue import EMPTY, MultiQueue, TaskQueue
from ..core.scheduler import (POLL_EVERY, SchedulerConfig, _bump_rounds,
                              no_host_sync)
from ..core.tree import tree_map
from ..graph.csr import CSRGraph
from ..launch.mesh import ShardMesh, make_shard_mesh, make_shard_mesh2d
from ..runtime.program import AtosProgram, ProgramContext, build_merge
from .exchange import (LANE_LOCAL, NUM_LANES, broadcast, pop_wavefront,
                       psum, route_tasks)
from .partition import ShardedCSR, owner_of, partition_graph, split_seeds
from .steal import rebalance

_I32 = torch.int32


def _shard_context(cfg: SchedulerConfig, shard: int,
                   mesh: ShardMesh) -> ProgramContext:
    """The context a shard's body is built in."""
    return ProgramContext(wavefront=cfg.wavefront,
                          num_workers=cfg.num_workers, backend=cfg.backend,
                          granularity=cfg.granularity, shard=shard,
                          num_shards=cfg.num_shards, axis_name=mesh)


class ShardCounters(NamedTuple):
    """One shard's round accounting (0-dim int32 tensors on its device).
    Inside a drain the driver keeps it packed, one int32 tensor of these
    fields in this order a shard, so that a round adds and predicates it
    in one device op each."""

    rounds: torch.Tensor         # uniform by construction
    items: torch.Tensor          # valid tasks this shard popped
    sent: torch.Tensor           # distinct tasks shipped to other owners
    route_dropped: torch.Tensor  # remote tasks lost to a narrow route row
    donated: torch.Tensor        # tasks this shard donated to its successor
    stolen_run: torch.Tensor     # stolen tasks this shard executed
    steal_rounds: torch.Tensor   # rounds the (uniform) steal trigger fired
    mis_routed: torch.Tensor     # popped tasks that violated ownership
    sent_row: torch.Tensor       # cross-shard payload ints, row-axis hop
    sent_col: torch.Tensor       # cross-shard payload ints, column-axis hop
    payload: torch.Tensor        # valid ints across all hop buffers
    padding: torch.Tensor        # EMPTY slots across all hop buffers
    wire: torch.Tensor           # metered wire ints (codec words if on)
    deferred: torch.Tensor       # staged tasks delivered a round late
    overlap_rounds: torch.Tensor  # rounds that computed over a delivery


def _packed_zero(devices) -> List[torch.Tensor]:
    return [torch.zeros(len(ShardCounters._fields), dtype=_I32, device=dev)
            for dev in devices]


def _unpacked(cs) -> List[ShardCounters]:
    return [ShardCounters(*c.unbind()) for c in cs]


@dataclasses.dataclass
class ShardRunStats:
    """Host-side run summary (per-device vectors have one entry a shard)."""

    rounds: int
    items_processed: int
    dropped: int              # queue-replica overflow drops (sum)
    route_dropped: int
    exchanged: int            # distinct tasks delivered across shards (sum)
    donated: int              # tasks moved by stealing (sum)
    stolen_executed: int
    steal_rounds: int
    mis_routed: int           # must be 0: every task ran on its owner/thief
    per_device_items: np.ndarray
    per_device_sent: np.ndarray
    per_device_donated: np.ndarray
    final_sizes: np.ndarray
    # wire accounting: a task relayed through both hops of a 2-D mesh is
    # carried twice, so payload_ints >= exchanged; a 1-D run puts all its
    # cross-shard ints on the (single) column hop
    exchanged_row: int = 0    # cross-shard payload ints, row-axis hop
    exchanged_col: int = 0    # cross-shard payload ints, column-axis hop
    payload_ints: int = 0     # valid ints carried by all hop buffers
    padding_ints: int = 0     # EMPTY slots those buffers carried
    wire_ints: int = 0        # metered wire: raw slots, or codec words
    deferred_delivered: int = 0  # tasks that landed one round late
    overlap_rounds: int = 0   # rounds overlapping compute with a delivery

    @property
    def occupancy_balance(self) -> float:
        """min/max of per-shard processed items (1.0 = perfectly even)."""
        if self.per_device_items.size == 0:
            return 1.0
        hi = int(self.per_device_items.max())
        return float(self.per_device_items.min()) / hi if hi else 1.0

    @property
    def overlap_occupancy(self) -> float:
        """Share of rounds (busiest shard) where staged arrivals were
        delivered while the wavefront also had work."""
        return self.overlap_rounds / self.rounds if self.rounds else 0.0

    def as_dict(self) -> dict:
        """The canonical ``shard_run`` doc (obs/schema)."""
        from ..obs.schema import metric_doc  # lazy: obs is a leaf layer

        d = dataclasses.asdict(self)
        for k, v in d.items():
            if isinstance(v, np.ndarray):
                d[k] = v.tolist()
        d["occupancy_balance"] = self.occupancy_balance
        d["overlap_occupancy"] = self.overlap_occupancy
        return metric_doc("shard_run", **d)


# --------------------------------------------------------------- plumbing
def seed_queues(program: AtosProgram, seeds, num_vertices: int,
                capacity: int, devices) -> List[MultiQueue]:
    """Owner-split ``seeds`` into one 2-lane queue replica a shard, on
    ``devices``: each shard's seeds placed in its LOCAL lane (no push, so
    no kernel launch)."""
    seed_buf, seed_counts = split_seeds(seeds, num_vertices, len(devices),
                                        task_vertex=program.task_vertex)
    queues = []
    for d, dev in enumerate(devices):
        k = int(seed_counts[d])
        if k > capacity:
            raise ValueError(
                f"shard {d} got {k} seed tasks > queue capacity {capacity}")
        buf = np.full((NUM_LANES, capacity), EMPTY, dtype=np.int32)
        buf[LANE_LOCAL, :k] = seed_buf[d, :k]
        tail = np.zeros(NUM_LANES, dtype=np.int32)
        tail[LANE_LOCAL] = k

        def zeros():
            return torch.zeros(NUM_LANES, dtype=_I32, device=dev)

        lanes = TaskQueue(buf=torch.as_tensor(buf, device=dev), head=zeros(),
                          tail=torch.as_tensor(tail, device=dev),
                          dropped=zeros())
        queues.append(MultiQueue(lanes=lanes, rr=torch.zeros(
            (), dtype=_I32, device=dev)))
    return queues


def _mesh_dims(cfg: SchedulerConfig) -> Optional[Tuple[int, int]]:
    """``(rows, cols)`` of the config's 2-D mesh, None for the 1-D ring."""
    if cfg.mesh_shape is None:
        return None
    rows, cols = cfg.mesh_shape
    if rows * cols != cfg.num_shards:
        raise ValueError(
            f"mesh_shape {cfg.mesh_shape} covers {rows * cols} devices but "
            f"num_shards is {cfg.num_shards}")
    return rows, cols


def _where_per_shard(flags, new: list, old: list) -> list:
    """``tree_where(flags[d], new[d], old[d])`` for every shard; a
    selection already made for the same (flag, new, old) objects is
    reused, so shards sharing merged tensors on one device share the
    result too."""
    memo: dict = {}

    def select(flag, a, b):
        if a is b:
            return a
        key = (id(flag), id(a), id(b))
        if key not in memo:
            memo[key] = (torch.where(flag, a, b), a, b, flag)
        return memo[key][0]

    return [tree_map(lambda a, b, f=flags[d]: select(f, a, b), new[d], old[d])
            for d in range(len(new))]


def _make_round(program: AtosProgram, cfg: SchedulerConfig, n: int,
                route_width: Optional[int], mesh: ShardMesh,
                mesh_dims: Optional[Tuple[int, int]] = None):
    """The round: deliver -> steal -> pop -> body -> exchange -> merge.

    ``round_step(fs, mqs, states, cs, pending, rings)`` returns ``(mqs,
    states, cs, pending', rings')``, each a list over shards (``cs`` the
    packed counters); ``pending`` is the staged arrivals in deferred mode
    (None before the first round and in strict mode); ``rings``, the
    shards' trace rings or None, get one row a shard.  ``keep_going(mqs,
    states, cs, pending)`` is the global continuation flag, one copy a
    shard.
    """
    s = cfg.num_shards
    w = cfg.wavefront
    devices = mesh.devices
    steal_on = cfg.steal_threshold > 0
    defer = cfg.defer_rounds > 0
    merge = build_merge(program.merge)
    # chunked tasks: occupancy, donation plans and the processed meter
    # count vertices; None keeps the slot-denominated accounting
    width_of = program.task_width if cfg.granularity > 1 else None
    lanes = [torch.arange(w, dtype=_I32, device=dev) for dev in devices]
    ones = [torch.ones((), dtype=_I32, device=dev) for dev in devices]

    def round_step(fs, mqs, states, cs, pending=None, rings=None):
        mqs = list(mqs)
        deferred_n = [torch.zeros((), dtype=_I32, device=dev)
                      for dev in devices]
        if pending is not None:
            # deferred delivery: last round's arrivals enter the queue now
            for d in range(s):
                pv = pending[d] != EMPTY
                deferred_n[d] = pv.sum(dtype=_I32)
                mqs[d] = mqs[d].push(LANE_LOCAL, pending[d], pv,
                                     backend=cfg.backend)
        if rings is not None:
            # pre-steal, pre-pop occupancy and the counters' baselines
            size_before = [mq.size for mq in mqs]
            work0 = [program.work(st) if program.work is not None else 0
                     for st in states]
            splits0 = [program.splits(st) if program.splits is not None
                       else 0 for st in states]
        donated = triggered = [torch.zeros((), dtype=_I32, device=dev)
                               for dev in devices]
        if steal_on:
            mqs, donated, triggered = rebalance(
                mqs, devices=devices, threshold=cfg.steal_threshold,
                chunk=cfg.steal_chunk, backend=cfg.backend,
                width_of=width_of)
            triggered = broadcast(triggered.to(_I32), devices)

        outs, masks, news, n_valid, mis, stolen = [], [], [], [], [], []
        for d in range(s):
            items, valid, n_stolen, mqs[d] = pop_wavefront(mqs[d], w)
            # ownership meter: lanes [0, n_stolen) came off the stolen lane
            # and belong to the ring predecessor; the rest must be ours
            verts = torch.where(valid, program.task_vertex(
                torch.where(valid, items, 0)), 0)
            expected = torch.where(lanes[d] < n_stolen, (d - 1) % s, d)
            mis.append((valid & (owner_of(verts, n, s) != expected))
                       .sum(dtype=_I32))
            stolen.append(n_stolen)
            n_valid.append(valid.sum(dtype=_I32))
            out, mask, new_state = fs[d](items, valid, states[d])
            outs.append(out)
            masks.append(mask)
            news.append(_bump_rounds(new_state))

        mqs, delivered, meters = route_tasks(
            mqs, outs, masks, devices=devices, num_vertices=n,
            task_vertex=program.task_vertex, route_width=route_width,
            backend=cfg.backend, mesh_dims=mesh_dims, compress=cfg.compress)
        if not defer:
            for d in range(s):
                mqs[d] = mqs[d].push(LANE_LOCAL, delivered[d],
                                     delivered[d] != EMPTY,
                                     backend=cfg.backend)
        if rings is not None:
            # one row a shard a round, by device ops: work and splits are
            # the shard's own pre-merge deltas, so a round's rows summed
            # over shards give the global round
            rings = list(rings)
            for d in range(s):
                m = meters[d]
                work1 = (program.work(news[d]) if program.work is not None
                         else 0)
                splits1 = (program.splits(news[d])
                           if program.splits is not None else 0)
                rings[d] = rings[d].record(
                    round=cs[d][0], lane=d, queue_size=size_before[d],
                    pops=n_valid[d],
                    pushes=mqs[d].size - size_before[d] + n_valid[d],
                    work=work1 - work0[d], splits=splits1 - splits0[d],
                    donated=donated[d], exchanged=m["sent"],
                    exchanged_row=m["sent_row"],
                    exchanged_col=m["sent_col"], wire=m["wire"],
                    deferred=deferred_n[d])
        # round-synchronous reconciliation: every shard then holds the
        # same merged state, so the next round's pops read fresh values
        states = merge(states, news, devices)

        cs_next = []
        for d in range(s):
            m = meters[d]
            # the round's increments, in ShardCounters' field order
            cs_next.append(cs[d] + torch.stack([
                ones[d], n_valid[d], m["sent"], m["rdrop"], donated[d],
                stolen[d], triggered[d], mis[d], m["sent_row"],
                m["sent_col"], m["payload"], m["padding"], m["wire"],
                deferred_n[d],
                ((deferred_n[d] > 0) & (n_valid[d] > 0)).to(_I32)]))
        return (mqs, states, cs_next, (delivered if defer else None),
                rings)

    def keep_going(mqs, states, cs, pending=None):
        """The global continuation, one copy a shard: rounds in bounds, and
        the psum'd live tasks (staged arrivals included) unless the
        program's empty queue is not the end (PageRank's rescan), and not
        the stop predicate (on the merged, replicated state)."""
        more = cs[0][0] < cfg.max_rounds          # rounds
        if program.empty_means_done:
            live = [mq.size for mq in mqs]
            if pending is not None:
                live = [sz + (p != EMPTY).sum(dtype=_I32)
                        for sz, p in zip(live, pending)]
            more = more & (psum(live, devices[:1])[0] > 0)
        if program.stop is not None:
            more = more & ~program.stop(states[0])
        return broadcast(more, devices)

    return round_step, keep_going


def _queue_sizes(mqs) -> np.ndarray:
    """Per-shard total replica occupancy (one host read)."""
    return np.array([int(mq.size) for mq in mqs], dtype=np.int32)


def _flush_pending(mqs, pending, backend):
    """Push still-staged arrivals into the LOCAL lanes (a ``max_rounds``
    or ``stop`` exit leaves one round staged)."""
    if pending is None:
        return list(mqs)
    return [mq.push(LANE_LOCAL, p, p != EMPTY, backend=backend)
            for mq, p in zip(mqs, pending)]


# ----------------------------------------------------------------- drivers
def _bodies(program, parts: ShardedCSR, cfg, mesh):
    return [program.body(parts.local(d), _shard_context(cfg, d, mesh))
            for d in range(cfg.num_shards)]


def persistent_run_sharded(program: AtosProgram, parts: ShardedCSR, mqs0,
                           states0, cfg: SchedulerConfig, mesh: ShardMesh,
                           route_width=None, mesh_dims=None, rings0=None):
    """The drain as predicated rounds, ``POLL_EVERY`` between host polls
    of the global flag, with no host sync inside a window.  ``rings0``,
    one :class:`~repro_torch.obs.TraceRing` a shard on its device, rides
    the carry as its other parts do, so a round after the flag fell writes
    no row.  Returns the per-shard ``(mqs, states, counters, rings)``."""
    round_step, keep_going = _make_round(program, cfg, parts.num_vertices,
                                         route_width, mesh, mesh_dims)
    fs = _bodies(program, parts, cfg, mesh)
    devices = mesh.devices
    mqs, states, pending = list(mqs0), list(states0), None
    rings = None if rings0 is None else list(rings0)
    cs = _packed_zero(devices)
    more = keep_going(mqs, states, cs)
    while bool(more[0]):  # the one host sync per poll
        with no_host_sync(devices[0]):
            for _ in range(POLL_EVERY):
                new = round_step(fs, mqs, states, cs, pending, rings)
                more_new = keep_going(*new[:4])
                if pending is None and cfg.defer_rounds > 0:
                    # the first round: its flag was just read on the host,
                    # and it makes the staging buffer the later rounds keep
                    mqs, states, cs, pending, rings = new
                    more = more_new
                    continue
                old = (mqs, states, cs, pending, rings)
                picked = [_where_per_shard(more, list(a), list(b))
                          if a is not None else None
                          for a, b in zip(new, old)]
                mqs, states, cs, pending, rings = picked
                more = [f & g for f, g in zip(more, more_new)]
    return (_flush_pending(mqs, pending, cfg.backend), states, _unpacked(cs),
            rings)


def discrete_run_sharded(program: AtosProgram, parts: ShardedCSR, mqs0,
                         states0, cfg: SchedulerConfig, mesh: ShardMesh,
                         route_width=None, trace: Optional[list] = None,
                         mesh_dims=None, rings0=None):
    """Host loop, one round per iteration (discrete kernels).

    ``trace`` collects the reference's per-round host dicts: ``round``,
    the shards' queue ``sizes`` after it, and the round's ``exchanged``,
    ``donated``, ``wire``, ``exchanged_row`` and ``exchanged_col``.
    ``rings0`` are the shards' trace rings, as in
    :func:`persistent_run_sharded`.
    """
    round_step, keep_going = _make_round(program, cfg, parts.num_vertices,
                                         route_width, mesh, mesh_dims)
    fs = _bodies(program, parts, cfg, mesh)
    devices = mesh.devices
    mqs, states, pending = list(mqs0), list(states0), None
    rings = None if rings0 is None else list(rings0)
    cs = _packed_zero(devices)
    rounds = 0
    keys = ("sent", "donated", "wire", "sent_row", "sent_col")
    prev = dict.fromkeys(keys, 0)
    while rounds < cfg.max_rounds:
        # the pre-round check, as the reference's host-synced predicate
        if program.empty_means_done:
            live = int(_queue_sizes(mqs).sum())
            if pending is not None:
                live += sum(int((p != EMPTY).sum()) for p in pending)
            if live == 0:
                break
        if program.stop is not None and bool(program.stop(states[0])):
            break
        mqs, states, cs, pending, rings = round_step(fs, mqs, states, cs,
                                                     pending, rings)
        more = keep_going(mqs, states, cs, pending)
        rounds += 1
        if trace is not None:
            host = torch.stack([c.cpu() for c in cs]).sum(0).tolist()
            totals = {k: host[ShardCounters._fields.index(k)] for k in keys}
            trace.append({
                "round": rounds,
                "sizes": _queue_sizes(mqs).tolist(),
                "exchanged": totals["sent"] - prev["sent"],
                "donated": totals["donated"] - prev["donated"],
                "wire": totals["wire"] - prev["wire"],
                "exchanged_row": totals["sent_row"] - prev["sent_row"],
                "exchanged_col": totals["sent_col"] - prev["sent_col"],
            })
            prev = totals
        if not bool(more[0]):
            break
    return (_flush_pending(mqs, pending, cfg.backend), states, _unpacked(cs),
            rings)


# --------------------------------------------------------------- front door
def _mesh_for(cfg: SchedulerConfig, mesh: Optional[ShardMesh],
              mesh_dims) -> ShardMesh:
    s = cfg.num_shards
    if mesh is None:
        return (make_shard_mesh(s) if mesh_dims is None
                else make_shard_mesh2d(*mesh_dims))
    if mesh.size != s:
        raise ValueError(f"the mesh has {mesh.size} shards but num_shards "
                         f"is {s}")
    if mesh.dims is not None and mesh.dims != mesh_dims:
        raise ValueError(f"a {mesh.dims} mesh under mesh_shape "
                         f"{cfg.mesh_shape}")
    return mesh


def run_sharded(program: AtosProgram, graph: CSRGraph, cfg: SchedulerConfig,
                *, queue_capacity: Optional[int] = None,
                route_width: Optional[int] = None,
                mesh: Optional[ShardMesh] = None, trace=None,
                trace_engine: Optional[str] = None,
                trace_round_offset: int = 0,
                initial_queues: Optional[List[MultiQueue]] = None,
                initial_state: Any = None,
                final_queues: Optional[list] = None,
                parts: Optional[ShardedCSR] = None
                ) -> Tuple[Any, ShardRunStats]:
    """Drain ``program`` over a ``cfg.num_shards``-shard mesh.

    Returns ``(final_state, ShardRunStats)``: the merged state (shard 0's
    replica, on ``mesh.devices[0]``; ``program.result(state)`` is the
    answer).  ``mesh`` defaults to ``cuda:0 .. cuda:S-1`` (1-D, or
    ``cfg.mesh_shape``), which raises where fewer cards are visible; pass
    ``launch.mesh.make_shard_mesh(S, devices=...)`` to stack shards on one
    device.  ``cfg.mesh_shape`` picks the two-hop exchange,
    ``cfg.defer_rounds`` the deferred delivery, ``cfg.compress`` the codec.

    ``trace`` takes an :class:`~repro_torch.obs.Trace` (each shard writes
    one row a round into a ring on its own device, with no host sync; the
    rings are drained at run end under ``trace_engine``, default
    ``sharded.persistent`` or ``sharded.discrete``, at rounds shifted by
    ``trace_round_offset``, and the ``shard_run`` doc is added) or the
    discrete driver's legacy ``list``.

    ``initial_state`` / ``initial_queues`` resume a drain from an explicit
    carry instead of ``program.init()`` (the stream driver's reseeds and
    snapshot restores; ``initial_queues`` is a list of per-shard
    :class:`MultiQueue` from :func:`seed_queues`, the state goes to every
    shard's device).  ``final_queues``, if a list, receives the list of
    per-shard end-of-drain queues.  ``parts``, a live
    :class:`~repro_torch.shard.partition.ShardedCSR` on the mesh's devices
    (``stream/ingest.reshard``), skips ``partition_graph``.
    """
    from ..obs import Trace  # lazy: obs is a leaf layer

    s = cfg.num_shards
    mesh_dims = _mesh_dims(cfg)
    mesh = _mesh_for(cfg, mesh, mesh_dims)
    devices = mesh.devices
    n = graph.num_vertices
    if parts is None:
        parts = partition_graph(graph, s, halo=cfg.steal_threshold > 0,
                                devices=devices)
    capacity = queue_capacity or max(4 * n, 1024)
    if initial_state is None or initial_queues is None:
        init_state, seeds = program.init()
        if initial_state is None:
            initial_state = init_state
        if initial_queues is None:
            initial_queues = seed_queues(program, seeds, n, capacity,
                                         devices)
    mqs0 = list(initial_queues)
    states0 = [tree_map(lambda x, dev=dev: x.to(dev), initial_state)
               for dev in devices]
    obs = trace if isinstance(trace, Trace) else None
    rings0 = ([obs.ring(dev) for dev in devices] if obs is not None
              else None)
    if cfg.persistent:
        mqs, states, cs, rings = persistent_run_sharded(
            program, parts, mqs0, states0, cfg, mesh,
            route_width=route_width, mesh_dims=mesh_dims, rings0=rings0)
    else:
        mqs, states, cs, rings = discrete_run_sharded(
            program, parts, mqs0, states0, cfg, mesh,
            route_width=route_width,
            trace=trace if isinstance(trace, list) else None,
            mesh_dims=mesh_dims, rings0=rings0)

    c = {k: np.array([int(getattr(cd, k)) for cd in cs], dtype=np.int32)
         for k in ShardCounters._fields}
    stats = ShardRunStats(
        rounds=int(c["rounds"].max()),
        items_processed=int(c["items"].sum()),
        dropped=sum(int(mq.lanes.dropped.sum()) for mq in mqs),
        route_dropped=int(c["route_dropped"].sum()),
        exchanged=int(c["sent"].sum()),
        donated=int(c["donated"].sum()),
        stolen_executed=int(c["stolen_run"].sum()),
        steal_rounds=int(c["steal_rounds"].max()),
        mis_routed=int(c["mis_routed"].sum()),
        per_device_items=c["items"],
        per_device_sent=c["sent"],
        per_device_donated=c["donated"],
        final_sizes=_queue_sizes(mqs),
        exchanged_row=int(c["sent_row"].sum()),
        exchanged_col=int(c["sent_col"].sum()),
        payload_ints=int(c["payload"].sum()),
        padding_ints=int(c["padding"].sum()),
        wire_ints=int(c["wire"].sum()),
        deferred_delivered=int(c["deferred"].sum()),
        overlap_rounds=int(c["overlap_rounds"].max()),
    )
    if obs is not None:
        engine = trace_engine or (
            "sharded.persistent" if cfg.persistent else "sharded.discrete")
        for ring in rings:
            obs.drain(ring, engine=engine, round_offset=trace_round_offset)
        obs.add_metric(stats.as_dict())
    if final_queues is not None:
        final_queues.append(mqs)
    return states[0], stats
