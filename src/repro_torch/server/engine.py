"""The multi-tenant task server: one resident scheduler, many graph jobs.

The counterpart of ``repro/server/engine.py``; the schedule -- quotas,
admission, backpressure, rounds -- is the reference's, bit for bit:

  * every admitted job owns one **lane** of a shared :class:`MultiQueue`
    on the server's device; its tasks are packed ``(job_id, payload)``
    int32s (``server/encoding``);
  * each round a **fairness policy** splits the wavefront budget ``W =
    num_workers x fetch_size`` into per-lane quotas, and every granted
    lane advances one step of its job's body: a *fused wavefront*, where
    one round advances many tenants and the small-frontier rounds of one
    fill with the others' work;
  * **backpressure**: a lane whose drop counter grew last round is served
    first, and new admissions wait until the overflow clears;
  * **admission control**: one job per lane; excess jobs wait in a FIFO.

A lane step is a plain function over ``runtime.api.fused_lane_ops`` and
``core.scheduler.wavefront_step(..., always_run_body=True)``: on CUDA
graphs with backend ``auto`` or ``cuda`` it pops the lane, expands
through B1 (``csrc/lbs.cu``), sums PageRank's residues through the ordered
scatter-add and pushes through B2 (``csrc/compact.cu``); nothing is
compiled or cached per step.  The loop is host-driven, one dispatch per
lane per round.  Host reads: one transfer a round for the lane sizes and
drops (and, at granularity > 1, the occupied lanes' vertex loads), one at
the round's end for the stop flags of the lanes that ran (they are read
only next round, so the schedule is the reference's), one vertex-load read
when a job is admitted at granularity > 1, and the job's counters when it
finishes.

``kernel="megakernel"`` cannot fuse a tenant's drain into one launch here
(tenants are admitted and finalized between rounds): the server logs a
warning and runs the per-round steps, and batch tenants launch no drain
kernel; streaming tenants' batch drains do run the drain kernels.
A ``JobSpec(shards > 1)`` owns a mesh for its whole drain, so it runs as a
phase of its own before the fused rounds (``shard.run_sharded``), as a
streaming job does; a streaming job with ``shards > 1`` drains each batch
on the mesh.  A server built on the CPU puts a job's shards on the CPU; on
the card a job of S shards takes ``cuda:0 .. cuda:S-1`` (and raises on
fewer cards) unless ``shard_devices=`` names the devices, for example
``[torch.device("cuda:0")] * 4``.  The server never stacks shards by
itself.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.backend import resolve_device
from ..core.counters import JobTelemetry
from ..core.queue import MultiQueue, make_multiqueue
from ..core.scheduler import SchedulerConfig, wavefront_step
from ..runtime.api import fused_lane_ops
from .encoding import MAX_JOBS, pack
from .encoding import packed_width as encoding_packed_width
from .jobs import JobRegistry, JobSpec, Program
from .policies import FairnessPolicy, make_policy

log = logging.getLogger("repro_torch.server")

_I32 = torch.int32


@dataclasses.dataclass
class Job:
    """Runtime record of one submitted job."""

    job_id: int
    program: Optional[Program]     # built at admission (config-specialized)
    weight: float
    spec: Optional[JobSpec] = None
    status: str = "pending"        # pending -> active -> done
    lane: int = -1
    state: Any = None
    counters: Any = None           # device int32[3]: (items, verts, mism)
    #: packed-wire chunk-width fn, built at admission; None when the
    #: program is width-1 or width-agnostic
    width_of: Any = None
    stopped: bool = False
    telemetry: Optional[JobTelemetry] = None
    result: Optional[np.ndarray] = None
    #: streaming jobs only: the full per-batch StreamResult
    stream_result: Any = None
    #: lane steps (pop, body, push) and on_empty steps this job ran: what
    #: its kernel launches follow from
    lane_steps: int = 0
    empty_steps: int = 0


@dataclasses.dataclass
class ServerStats:
    rounds: int = 0
    wall_seconds: float = 0.0
    items_processed: int = 0
    backpressure_events: int = 0
    deferred_admissions: int = 0
    wavefront: int = 0
    sharded_jobs: int = 0          # jobs served as sharded phases
    sharded_rounds: int = 0        # device rounds spent in those phases
    streaming_jobs: int = 0        # jobs served as streaming phases
    stream_batches: int = 0        # delta batches drained in those phases

    @property
    def occupancy(self) -> float:
        denom = self.rounds * self.wavefront
        return self.items_processed / denom if denom else 0.0

    def as_dict(self) -> dict:
        """Serialize into the canonical ``server`` doc (obs/schema)."""
        from ..obs.schema import metric_doc  # lazy: obs is a leaf layer

        d = dataclasses.asdict(self)
        d["occupancy"] = self.occupancy
        return metric_doc("server", **d)


@dataclasses.dataclass
class ServerResult:
    results: Dict[int, np.ndarray]
    telemetry: Dict[int, JobTelemetry]
    stats: ServerStats


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_device(a: torch.device, b: torch.device) -> bool:
    def norm(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return norm(a) == norm(b)


class TaskServer:
    """Multi-tenant graph-analytics server over one shared MultiQueue on
    ``device`` (default ``"cuda"``; a host without a card raises unless
    ``device="cpu"``)."""

    def __init__(
        self,
        registry: JobRegistry,
        num_lanes: int = 8,
        config: Optional[SchedulerConfig] = None,
        policy: str | FairnessPolicy = "weighted",
        lane_capacity: Optional[int] = None,
        autotuner=None,
        max_rounds: int = 1 << 17,
        strict_drops: bool = True,
        trace=None,
        device="cuda",
        shard_devices=None,
    ) -> None:
        self.device = resolve_device(device)
        #: the devices a sharded job's shards take, shard d on
        #: ``shard_devices[d]``; None: the CPU for a CPU server, else one
        #: card a shard (``launch.mesh.make_shard_mesh``)
        self.shard_devices = (None if shard_devices is None else
                              [torch.device(d) for d in shard_devices])
        self.registry = registry
        self.num_lanes = num_lanes
        self._config = config
        self.policy = (policy if isinstance(policy, FairnessPolicy)
                       else make_policy(policy))
        self._lane_capacity = lane_capacity
        self.autotuner = autotuner
        self.max_rounds = max_rounds
        #: optional :class:`~repro_torch.obs.Trace`: one ring on the
        #: server's device records a row per granted lane per round; it is
        #: read once when ``run()`` returns, beside the server and job
        #: summary docs and the latency histograms
        self.trace = trace
        # a dropped task is work lost forever (an unreached BFS vertex
        # stays INF), so by default any overflow fails the run loudly
        self.strict_drops = strict_drops
        self._jobs: List[Job] = []

    @property
    def jobs(self) -> tuple:
        """The submitted jobs' runtime records, in submission order."""
        return tuple(self._jobs)

    # ------------------------------------------------------------ submission
    def _next_job_id(self) -> int:
        # job ids live in the packed-task bitfield and are never recycled
        job_id = len(self._jobs)
        if job_id >= MAX_JOBS:
            raise ValueError(
                f"job id space exhausted: one TaskServer serves at most "
                f"{MAX_JOBS} jobs over its lifetime (encoding.PAYLOAD_BITS "
                f"bitfield); create a new server for the next batch")
        return job_id

    def submit(self, spec: JobSpec) -> int:
        """Queue a job for admission; returns its job_id."""
        job_id = self._next_job_id()
        self._jobs.append(Job(job_id=job_id, program=None,
                              weight=spec.weight, spec=spec))
        return job_id

    def submit_program(self, program: Program, weight: float = 1.0) -> int:
        """Escape hatch for synthetic/custom programs (tests, experiments).

        The program must already match the server's wavefront width.
        """
        job_id = self._next_job_id()
        self._jobs.append(Job(job_id=job_id, program=program, weight=weight))
        return job_id

    # ------------------------------------------------------------- plumbing
    def _resolve_config(self) -> SchedulerConfig:
        if self._config is not None:
            return self._config
        if self.autotuner is not None:
            pairs = [(j.spec.algorithm, self.registry.graph(j.spec.graph))
                     for j in self._jobs if j.spec is not None]
            if pairs:
                cfg = self.autotuner.recommend_for_mix(pairs)
                log.info("autotuned server config: %s", cfg)
                return cfg
        return SchedulerConfig()

    def _resolve_lane_capacity(self) -> int:
        if self._lane_capacity is not None:
            return self._lane_capacity
        biggest = 1024
        for j in self._jobs:
            if j.spec is not None:
                n = self.registry.graph(j.spec.graph).num_vertices
                biggest = max(biggest, 8 * n)
        return biggest

    def _check_devices(self) -> None:
        for j in self._jobs:
            if j.spec is None:
                continue
            graph = self.registry.graph(j.spec.graph)
            if not _same_device(graph.device, self.device):
                raise ValueError(
                    f"graph {j.spec.graph!r} lives on {graph.device}, but "
                    f"this server runs on {self.device}; register graphs "
                    f"on the server's device")

    def _zero(self) -> torch.Tensor:
        return torch.zeros((), dtype=_I32, device=self.device)

    def _lane_step(self, job: Job, mq: MultiQueue, lane: int, quota: int,
                   cfg: SchedulerConfig, ring, round_ix: int):
        """One granted lane's round: pop up to ``quota`` (vertex units at
        G > 1), run the body even on a zero-valid pop (PageRank's in-body
        rescan must tick), push.  Returns ``(mq, stopped, ring)``."""
        prog = job.program
        granular = cfg.granularity > 1
        aux: dict = {}
        ops = fused_lane_ops(cfg.wavefront, cfg.backend, lane, job.job_id,
                             quota=quota, aux=aux,
                             task_width=prog.task_width if granular
                             else None)
        if ring is not None:
            size_before = mq.lane(lane).size
            work0 = prog.work(job.state)
        mq, job.state, _, n_valid = wavefront_step(
            prog.wavefront_fn, None, ops, (mq, job.state, 0, 0),
            always_run_body=True)
        job.counters = job.counters + torch.stack(
            [n_valid, aux["vertices"], aux["mismatch"]]).to(_I32)
        if ring is not None:
            size_after = mq.lane(lane).size
            ring = ring.record(
                round=round_ix, lane=lane, queue_size=size_before,
                pops=n_valid, pushes=size_after - size_before + n_valid,
                work=prog.work(job.state) - work0)
        job.lane_steps += 1
        stopped = None if prog.stop is None else prog.stop(job.state)
        return mq, stopped, ring

    def _empty_step(self, job: Job, mq: MultiQueue, lane: int,
                    cfg: SchedulerConfig, ring, round_ix: int):
        """A drained lane's on_empty refill (PageRank's rescan)."""
        prog = job.program
        if ring is not None:
            size_before = mq.lane(lane).size
        out, mask, job.state = prog.on_empty(job.state)
        mq = mq.push(lane, pack(job.job_id, out), mask, backend=cfg.backend)
        if ring is not None:
            ring = ring.record(
                round=round_ix, lane=lane, queue_size=size_before, pops=0,
                pushes=mq.lane(lane).size - size_before)
        job.empty_steps += 1
        stopped = None if prog.stop is None else prog.stop(job.state)
        return mq, stopped, ring

    def _admit(self, job: Job, mq: MultiQueue, lane: int, cfg: SchedulerConfig,
               lane_capacity: int, rounds: int):
        """Seed ``lane`` with the job's initial tasks; returns the queue
        and the lane's size after the seed push (read on the host: the
        lane was empty, so it holds ``min(seeds, capacity)`` items)."""
        if job.program is None:
            job.program = self.registry.build(
                job.spec, job.job_id, cfg.wavefront, cfg.num_workers,
                lane_capacity, backend=cfg.backend,
                granularity=cfg.granularity,
                split_threshold=cfg.split_threshold)
        prog = job.program
        job.state, seeds = prog.init()
        job.counters = torch.zeros((3,), dtype=_I32, device=self.device)
        job.width_of = (encoding_packed_width(prog.task_width)
                        if cfg.granularity > 1 and prog.task_width is not None
                        else None)
        job.stopped = False
        job.lane = lane
        job.status = "active"
        if job.telemetry is None:  # submit-time round was 0 for batch mode
            job.telemetry = JobTelemetry(
                job_id=job.job_id, algorithm=prog.algorithm,
                graph=prog.graph_name, wavefront=cfg.wavefront,
                ideal_work=prog.ideal_work, granularity=cfg.granularity)
        job.telemetry.admitted_round = rounds
        mq = mq.reset_lane(lane)
        seeds = torch.as_tensor(seeds, dtype=_I32, device=self.device)
        # the seed push takes the server's backend (B2 on the card), with
        # the same result as the plain push
        mq = mq.push(lane, pack(job.job_id, seeds),
                     torch.ones(seeds.shape, dtype=torch.bool,
                                device=self.device), backend=cfg.backend)
        log.info("admit job %d (%s on %s) -> lane %d at round %d",
                 job.job_id, prog.algorithm, prog.graph_name, lane, rounds)
        return mq, min(int(seeds.shape[0]), mq.capacity)

    def _finalize(self, job: Job, mq: MultiQueue, rounds: int) -> MultiQueue:
        prog = job.program
        job.result = _to_numpy(prog.result(job.state))
        work = torch.as_tensor(prog.work(job.state), device=self.device)
        items, vertices, mismatches, work, dropped = torch.cat([
            job.counters.long(), work.long().reshape(1),
            mq.lane(job.lane).dropped.long().reshape(1)]).tolist()
        job.telemetry.items_processed = items
        job.telemetry.vertices_processed = vertices
        job.telemetry.routing_mismatches = mismatches
        job.telemetry.work = work
        job.telemetry.completed_round = rounds
        job.telemetry.dropped += dropped
        if self.strict_drops and job.telemetry.dropped > 0:
            raise RuntimeError(
                f"job {job.job_id} ({prog.algorithm} on {prog.graph_name}) "
                f"dropped {job.telemetry.dropped} tasks to lane overflow — "
                f"its result would be silently wrong.  Raise lane_capacity "
                f"(or pass strict_drops=False for loss-tolerant workloads).")
        job.status = "done"
        mq = mq.reset_lane(job.lane)
        log.info("job %d done at round %d (work=%d, occupancy=%.3f)",
                 job.job_id, rounds, job.telemetry.work,
                 job.telemetry.occupancy)
        job.lane = -1
        return mq

    # -------------------------------------------------------- sharded jobs
    def _shard_mesh(self, cfg: SchedulerConfig):
        """The mesh a ``cfg.num_shards``-shard job runs on (see the module
        docstring): ``shard_devices[:S]``, the CPU for a CPU server, or
        ``cuda:0 .. cuda:S-1``."""
        from ..launch.mesh import make_shard_mesh, make_shard_mesh2d

        s = cfg.num_shards
        devices = self.shard_devices
        if devices is not None:
            if len(devices) < s:
                raise ValueError(
                    f"a {s}-shard job needs {s} shard devices, but the "
                    f"server was given {len(devices)}")
            devices = devices[:s]
        elif self.device.type == "cpu":
            devices = [self.device] * s
        if cfg.mesh_shape is None:
            return make_shard_mesh(s, devices=devices)
        return make_shard_mesh2d(*cfg.mesh_shape, devices=devices)

    def _run_sharded(self, job: Job, cfg: SchedulerConfig,
                     stats: ServerStats) -> None:
        """Serve one ``shards > 1`` job as a sharded drain over its own
        mesh: a phase before the fused rounds, not a lane inside them."""
        from ..runtime.programs import build_program
        from ..shard import run_sharded

        spec = job.spec
        graph = self.registry.graph(spec.graph)
        scfg = dataclasses.replace(cfg, num_shards=spec.shards,
                                   topology="sharded")
        program = build_program(spec.algorithm, graph, scfg,
                                params=dict(spec.params),
                                queue_capacity=self._lane_capacity)
        log.info("sharded job %d (%s on %s) over %d shards",
                 job.job_id, spec.algorithm, spec.graph, spec.shards)
        state, sstats = run_sharded(
            program, graph, scfg, queue_capacity=self._lane_capacity,
            mesh=self._shard_mesh(scfg), trace=self.trace,
            trace_engine=f"server.job{job.job_id}.sharded")
        job.result = _to_numpy(program.result(state))
        tel = JobTelemetry(
            job_id=job.job_id, algorithm=spec.algorithm, graph=spec.graph,
            wavefront=scfg.wavefront * spec.shards,  # mesh-wide pop budget
            ideal_work=program.ideal_work)
        tel.admitted_round = tel.completed_round = 0
        tel.rounds_active = sstats.rounds
        tel.items_processed = sstats.items_processed
        tel.work = program.work_of(state)
        tel.dropped = sstats.dropped + sstats.route_dropped
        job.telemetry = tel
        if self.strict_drops and tel.dropped > 0:
            raise RuntimeError(
                f"sharded job {job.job_id} ({spec.algorithm} on "
                f"{spec.graph}) dropped {tel.dropped} tasks to replica "
                f"overflow — its result would be silently wrong.  Raise "
                f"lane_capacity (or pass strict_drops=False).")
        if sstats.mis_routed:
            raise RuntimeError(
                f"sharded job {job.job_id}: {sstats.mis_routed} tasks ran "
                f"off their owner shard (routing invariant violated)")
        job.status = "done"
        stats.sharded_jobs += 1
        stats.sharded_rounds += sstats.rounds
        log.info("sharded job %d done in %d device rounds "
                 "(exchanged=%d donated=%d balance=%.3f)",
                 job.job_id, sstats.rounds, sstats.exchanged,
                 sstats.donated, sstats.occupancy_balance)

    # ------------------------------------------------------ streaming jobs
    def _run_streaming(self, job: Job, cfg: SchedulerConfig,
                       stats: ServerStats) -> None:
        """Serve one streaming job (``spec.stream``) as a dedicated phase:
        ``run_stream`` over the spec's delta log under the config's kernel
        strategy (a megakernel batch drain is one launch of the program's
        drain kernel), on the single topology, or on the job's mesh when
        ``shards > 1``."""
        from ..stream.driver import run_stream

        spec = job.spec
        stream = spec.stream
        graph = self.registry.graph(spec.graph)
        sharded = spec.shards > 1
        scfg = (dataclasses.replace(cfg, num_shards=spec.shards,
                                    topology="sharded")
                if sharded else dataclasses.replace(cfg, topology="single"))
        log.info("streaming job %d (%s on %s): %d delta batches",
                 job.job_id, spec.algorithm, spec.graph, len(stream.deltas))
        res = run_stream(
            spec.algorithm, graph, stream.deltas, scfg,
            params=dict(spec.params), queue_capacity=self._lane_capacity,
            incremental=stream.incremental,
            snapshot_every=stream.snapshot_every,
            checkpoint_dir=stream.checkpoint_dir, resume=stream.resume,
            compact_every=stream.compact_every,
            overlay_slack=stream.overlay_slack,
            mesh=self._shard_mesh(scfg) if sharded else None,
            trace=self.trace,
            trace_engine=f"server.job{job.job_id}.stream")
        job.result = _to_numpy(res.result)
        job.stream_result = res
        tel = JobTelemetry(
            job_id=job.job_id, algorithm=spec.algorithm, graph=spec.graph,
            wavefront=scfg.wavefront * spec.shards, ideal_work=0)
        tel.admitted_round = tel.completed_round = 0
        tel.rounds_active = res.info["rounds"]
        tel.items_processed = res.info["processed"]
        tel.work = res.info["work"]
        tel.dropped = res.info["dropped"]
        job.telemetry = tel
        if self.strict_drops and tel.dropped > 0:
            raise RuntimeError(
                f"streaming job {job.job_id} ({spec.algorithm} on "
                f"{spec.graph}) dropped {tel.dropped} tasks to queue "
                f"overflow — its result would be silently wrong.  Raise "
                f"lane_capacity (or pass strict_drops=False).")
        job.status = "done"
        stats.streaming_jobs += 1
        stats.stream_batches += len(res.batches)
        log.info("streaming job %d done: %d batches, %d rounds, work=%d",
                 job.job_id, len(res.batches), res.info["rounds"],
                 res.info["work"])

    def _snapshot(self, mq: MultiQueue, lane_owner: Dict[int, Job],
                  granular: bool):
        """The round's one transfer: lane sizes, drops and, at G > 1, the
        vertex loads of the lanes whose jobs declare chunk widths."""
        sizes = mq.lane_sizes()
        rows = [sizes, mq.lane_dropped()]
        if granular:
            loads = sizes.clone()
            for lane, job in lane_owner.items():
                if job.width_of is not None:
                    loads[lane] = mq.lane(lane).vertex_size(job.width_of)
            rows.append(loads)
        host = torch.stack(rows).cpu().numpy().astype(np.int64)
        return host[0], host[1], (host[2] if granular else None)

    # ------------------------------------------------------------------ run
    def run(self) -> ServerResult:
        """Drain every submitted job; returns per-job results + telemetry.

        Streaming jobs and sharded jobs are served first, in submission
        order, as dedicated phases; everything else shares the fused
        multi-tenant rounds that follow.
        """
        cfg = self._resolve_config()
        if getattr(cfg, "kernel", "auto") == "megakernel":
            log.warning(
                "kernel='megakernel' requested, but the multi-tenant "
                "server loop is host-driven (one dispatch per scheduling "
                "round) and cannot fuse a tenant's drain into one launch; "
                "batch jobs run the per-round wavefront instead (streaming "
                "jobs still drain via the megakernel).  Use "
                "runtime.execute() for a fused single-tenant drain.")
        self._check_devices()
        W = cfg.wavefront
        lane_capacity = self._resolve_lane_capacity()
        stats = ServerStats(wavefront=W)
        trace = self.trace
        ring = trace.ring(self.device) if trace is not None else None
        t0 = time.perf_counter()
        for job in self._jobs:
            if job.status != "pending" or job.spec is None:
                continue
            if job.spec.stream is not None:
                self._run_streaming(job, cfg, stats)
            elif job.spec.shards > 1:
                self._run_sharded(job, cfg, stats)
        mq = make_multiqueue(lane_capacity, self.num_lanes,
                             device=self.device)
        pending = deque(j for j in self._jobs if j.status == "pending")
        lane_owner: Dict[int, Job] = {}
        free_lanes = deque(range(self.num_lanes))
        prev_dropped = np.zeros(self.num_lanes, dtype=np.int64)
        backpressured = False
        granular = cfg.granularity > 1
        rounds = 0

        while (pending or lane_owner) and rounds < self.max_rounds:
            # -- one snapshot per round drives completion, backpressure
            # detection and quota allocation
            sizes, dropped_now, loads = self._snapshot(mq, lane_owner,
                                                       granular)

            # -- completion: the convergence flag (computed with last
            # round's step) wins; otherwise a drained lane finishes the
            # job iff the program declares empty-means-done
            for lane, job in list(lane_owner.items()):
                done = (job.stopped if job.program.stop is not None
                        else (sizes[lane] == 0
                              and job.program.empty_means_done))
                if done:
                    mq = self._finalize(job, mq, rounds)
                    del lane_owner[lane]
                    free_lanes.append(lane)
                    prev_dropped[lane] = dropped_now[lane] = 0
                    sizes[lane] = 0
                    if granular:
                        loads[lane] = 0

            # -- admission control: drops observed last round defer new
            # tenants, unless the server is idle and would deadlock
            if pending and (not backpressured or not lane_owner):
                while pending and free_lanes:
                    lane = free_lanes.popleft()
                    job = pending.popleft()
                    mq, sizes[lane] = self._admit(job, mq, lane, cfg,
                                                  lane_capacity, rounds)
                    lane_owner[lane] = job
                    if granular:
                        loads[lane] = (
                            int(mq.lane(lane).vertex_size(job.width_of))
                            if job.width_of is not None else sizes[lane])
            elif pending and backpressured:
                stats.deferred_admissions += 1
            if not lane_owner:
                break  # everything drained and nothing left to admit

            boosted = np.zeros(self.num_lanes, dtype=bool)
            weights = np.zeros(self.num_lanes)
            for lane, job in lane_owner.items():
                weights[lane] = job.weight
                if dropped_now[lane] > prev_dropped[lane]:
                    boosted[lane] = True
                    job.telemetry.backpressure_events += 1
                    stats.backpressure_events += 1
            backpressured = bool(boosted.any())
            prev_dropped = dropped_now

            # -- quotas: slot-denominated at granularity 1, vertex-
            # denominated beyond (the budget is the wavefront's vertex
            # capacity W x G)
            if granular:
                quotas = self.policy.allocate(loads, weights, boosted,
                                              W * cfg.granularity)
            else:
                quotas = self.policy.allocate(sizes, weights, boosted, W)

            # -- fused wavefront: every granted lane advances this round
            flags = []
            for lane, job in lane_owner.items():
                prog = job.program
                quota = int(quotas[lane])
                if quota > 0:
                    mq, stopped, ring = self._lane_step(
                        job, mq, lane, quota, cfg, ring, rounds)
                elif sizes[lane] == 0 and prog.on_empty is not None \
                        and not job.stopped:
                    mq, stopped, ring = self._empty_step(
                        job, mq, lane, cfg, ring, rounds)
                else:
                    continue
                job.telemetry.rounds_active += 1
                if stopped is not None:
                    flags.append((job, stopped))
            if flags:  # read next round, so one transfer at the round's end
                values = torch.stack([f.reshape(()) for _, f in flags]).cpu()
                for (job, _), flag in zip(flags, values.tolist()):
                    job.stopped = bool(flag)

            rounds += 1

        if pending or lane_owner:
            unfinished = [j.job_id for j in self._jobs if j.status != "done"]
            raise RuntimeError(
                f"server hit max_rounds={self.max_rounds} with unfinished "
                f"jobs {unfinished}")

        stats.rounds = rounds
        stats.wall_seconds = time.perf_counter() - t0
        stats.items_processed = sum(
            j.telemetry.items_processed for j in self._jobs)
        if trace is not None:
            trace.drain(ring, engine="server")
            trace.add_metric(stats.as_dict())
            latency = trace.histogram("job_latency_rounds")
            delay = trace.histogram("job_queue_delay_rounds")
            for j in self._jobs:
                tel = j.telemetry
                if tel is None:
                    continue
                trace.add_metric(tel.as_dict())
                if tel.latency_rounds >= 0:
                    latency.add(tel.latency_rounds)
                if tel.queue_delay_rounds >= 0:
                    delay.add(tel.queue_delay_rounds)
                # one sample per drain the job ran: each delta batch of a
                # streaming job, the whole drain of a batch job
                per_job = trace.histogram(f"job{j.job_id}_latency_rounds")
                if j.stream_result is not None:
                    per_job.extend(b.rounds
                                   for b in j.stream_result.batches)
                elif tel.latency_rounds >= 0:
                    per_job.add(tel.latency_rounds)
        return ServerResult(
            results={j.job_id: j.result for j in self._jobs},
            telemetry={j.job_id: j.telemetry for j in self._jobs},
            stats=stats,
        )


def serve_sequential(
    registry: JobRegistry,
    specs: List[JobSpec],
    config: Optional[SchedulerConfig] = None,
    lane_capacity: Optional[int] = None,
    max_rounds: int = 1 << 17,
    device="cuda",
    shard_devices=None,
) -> ServerResult:
    """Baseline: each job runs alone (single lane, full wavefront; a
    sharded job on its mesh, ``shard_devices`` as :class:`TaskServer`'s).

    Total rounds are the sum over jobs -- what a tenant-at-a-time
    deployment pays.  Job ids match submission order, so results compare
    1:1 with a fused :class:`TaskServer` run over the same specs.
    """
    results: Dict[int, np.ndarray] = {}
    telemetry: Dict[int, JobTelemetry] = {}
    stats = ServerStats()
    t0 = time.perf_counter()
    for i, spec in enumerate(specs):
        server = TaskServer(registry, num_lanes=1, config=config,
                            policy="weighted", lane_capacity=lane_capacity,
                            max_rounds=max_rounds, device=device,
                            shard_devices=shard_devices)
        server.submit(spec)
        out = server.run()
        results[i] = out.results[0]
        tel = out.telemetry[0]
        tel.job_id = i
        telemetry[i] = tel
        stats.rounds += out.stats.rounds
        stats.items_processed += out.stats.items_processed
        stats.backpressure_events += out.stats.backpressure_events
        stats.wavefront = out.stats.wavefront
    stats.wall_seconds = time.perf_counter() - t0
    return ServerResult(results=results, telemetry=telemetry, stats=stats)
