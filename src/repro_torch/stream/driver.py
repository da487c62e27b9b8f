"""The streaming drain driver: delta batches x incremental recompute x
crash-consistent snapshots.

The counterpart of ``repro/stream/driver.py``.  ``run_stream`` turns any
registered :class:`~repro_torch.runtime.program.AtosProgram` into a
long-running job over a mutating graph.  Batch 0 drains the base graph
from ``program.init()``; each batch ``b >= 1`` commits ``deltas[b-1]``
against one long-lived slotted CSR (``stream/ingest``), re-seeds through
the program's ``dirty_seeds`` rule (``stream/incremental``) or the full
reseed, rebuilds the program on the new view -- its body closes over the
graph -- and drains again under the policy the config resolves to, through
``runtime.api.drain_setup``.  A megakernel batch drain is one launch of
the program's drain kernel on the slotted view (its slotted mode), or one
launch a segment.

Snapshots cut a drain at round boundaries.  Rounds and processed items live
in the carry, so a segmented drain takes exactly the steps of an uncut one,
and a resumed run -- replay the delta log, rebuild the program, restore
the carry, keep the segment schedule -- is bit-identical to the
uninterrupted one.

Under the sharded topology each batch drain is a sequence of
``shard.run_sharded`` segments over one long-lived partition, patched per
owner after each commit (``stream/ingest.reshard``); a sharded snapshot's
queue is the tuple of the shards' queues, each restored on its shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..core.queue import make_multiqueue, make_queue
from ..core.scheduler import (SchedulerConfig, megakernel_drive,
                              megakernel_segment, no_host_sync,
                              persistent_drive)
from ..graph.slotted import SlottedCSR
from ..obs import Trace
from ..runtime.api import drain_setup, shared_queue_capacity
from ..runtime.policy import policy_of
from ..runtime.programs import build_program
from .deltas import EdgeDelta
from .incremental import reseed
from .ingest import commit, replay_commits, reshard
from .snapshot import SnapshotManager, graph_fingerprint


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """Streaming attachment for a task-server job
    (``server/jobs.JobSpec(stream=...)``)."""

    deltas: Tuple[EdgeDelta, ...]
    incremental: bool = True
    snapshot_every: int = 0
    checkpoint_dir: Optional[str] = None
    resume: bool = False
    compact_every: int = 0        # 0 = occupancy/slack triggers only
    overlay_slack: float = 0.25   # compact when overlay > slack * m

    def __post_init__(self):
        object.__setattr__(self, "deltas", tuple(self.deltas))
        if self.snapshot_every < 0:
            raise ValueError("snapshot_every must be >= 0")
        if ((self.snapshot_every > 0 or self.resume)
                and not self.checkpoint_dir):
            raise ValueError(
                "snapshot_every/resume require a checkpoint_dir")
        if self.compact_every < 0:
            raise ValueError("compact_every must be >= 0")
        if not self.overlay_slack > 0:
            raise ValueError("overlay_slack must be > 0")


@dataclasses.dataclass
class BatchRecord:
    """Per-batch outcome.  The fields up to ``commit_seconds`` are the
    reference's (work and rounds are schedule-deterministic); the port adds
    the reseed's and the drain's host seconds and the reseed rule's sweeps
    (PageRank's negative-residue decay; 0 for the other rules)."""

    batch: int
    incremental: bool     # did a dirty-seed rule produce the seeds?
    seeds: int            # seed tasks enqueued for this batch's drain
    effective_ops: int    # delta ops that actually changed the edge set
    rounds: int
    processed: int
    work: int             # program work-counter delta over this batch
    splits: int
    dropped: int
    touched_rows: int = 0     # slab rows rewritten by this batch's commit
    overlay: int = 0          # overlay occupancy after the commit
    compacted: bool = False   # did this commit trigger a compaction?
    commit_seconds: float = 0.0   # apply(+compaction) wall time
    reseed_seconds: float = 0.0   # the dirty-seed rule's wall time
    drain_seconds: float = 0.0    # the batch drain's wall time
    reseed_sweeps: int = 0


@dataclasses.dataclass
class StreamResult:
    state: Any            # final program state (last batch's graph)
    result: Any           # program.result(state)
    batches: List[BatchRecord]
    info: dict

    def as_dict(self) -> dict:
        """Serialize into the canonical ``stream`` doc (obs/schema)."""
        from ..obs.schema import metric_doc

        return metric_doc(
            "stream",
            **{k: v for k, v in self.info.items() if v is not None})


def _drive_shared(setup, kernel: str, every: int, cb, device):
    """Drive a single/fused drain (``runtime.api.DrainSetup``) to its fixed
    point, calling ``cb(carry)`` at every ``every``-th round (0 = never).
    Rounds live in ``carry[2]``, so the boundaries are absolute round
    numbers and a resumed drain lands on the ones the uninterrupted drain
    did.  A segmented megakernel drain is one launch a segment, cut at the
    same boundaries; its launches run with host syncs set to raise."""
    step, cond, carry = setup.step, setup.cond, setup.carry
    if kernel == "megakernel":
        runner = setup.kernel
        guard = (lambda: no_host_sync(device)) if runner is not None \
            else contextlib.nullcontext
        if every <= 0:
            with guard():
                return megakernel_drive(step, cond, carry, kernel=runner)
        seg = megakernel_segment(step, cond, carry, kernel=runner)
        while bool(cond(carry)):
            limit = int(carry[2]) + every
            with guard():
                carry = seg(carry, limit)
            cb(carry)
        return carry
    if kernel == "persistent":
        if every <= 0:
            return persistent_drive(step, cond, carry)
        while bool(cond(carry)):
            limit = int(carry[2]) + every
            carry = persistent_drive(
                step, lambda c: cond(c) & (c[2] < limit), carry)
            cb(carry)
        return carry
    while bool(cond(carry)):
        carry = step(carry)
        if every > 0 and int(carry[2]) % every == 0:
            cb(carry)
    return carry


def _drive_sharded(program, graph, cfg: SchedulerConfig, capacity: int,
                   mqs, state, rounds: int, processed: int, every: int, cb,
                   route_width, mesh, trace=None, trace_engine=None,
                   trace_round_offset: int = 0, parts=None):
    """Segmented sharded drain: each segment is one ``run_sharded`` call
    with its round budget clamped to the next snapshot boundary.  The
    host-side continuation between segments is the in-loop one (the queue
    mass for ``empty_means_done`` programs, then ``stop``), and a segment
    that made no progress ends the drain.  Returns ``(queues, state,
    rounds, processed, dropped, extra)``."""
    from ..shard import run_sharded
    from ..shard.driver import _queue_sizes

    extra = {"exchanged": 0, "donated": 0, "steal_rounds": 0,
             "mis_routed": 0, "route_dropped": 0}

    def more() -> bool:
        if rounds >= cfg.max_rounds:
            return False
        if program.empty_means_done and int(_queue_sizes(mqs).sum()) == 0:
            return False
        if program.stop is not None and bool(program.stop(state)):
            return False
        return True

    while more():
        budget = cfg.max_rounds - rounds
        if every > 0:
            at_boundary = rounds % every
            budget = min(budget, every - at_boundary if at_boundary else every)
        final: list = []
        state, st = run_sharded(
            program, graph, dataclasses.replace(cfg, max_rounds=budget),
            queue_capacity=capacity, route_width=route_width, mesh=mesh,
            trace=trace, trace_engine=trace_engine,
            trace_round_offset=trace_round_offset + rounds,
            initial_queues=mqs, initial_state=state, final_queues=final,
            parts=parts)
        mqs = final[0]
        rounds += st.rounds
        processed += st.items_processed
        for k in extra:
            extra[k] += getattr(st, k)
        if every > 0:
            cb(mqs, state, rounds, processed)
        if st.rounds == 0:  # never spin on a segment that made no progress
            break
    dropped = sum(int(mq.lanes.dropped.sum()) for mq in mqs) \
        + extra["route_dropped"]
    return mqs, state, rounds, processed, dropped, extra


def run_stream(
    algorithm: str,
    graph,
    deltas,
    cfg: SchedulerConfig,
    *,
    params: Optional[dict] = None,
    queue_capacity: Optional[int] = None,
    incremental: bool = True,
    snapshot_every: int = 0,
    checkpoint_dir: Optional[str] = None,
    keep: int = 3,
    resume: bool = False,
    route_width: Optional[int] = None,
    mesh=None,
    snapshot_hook=None,
    trace: Optional[Trace] = None,
    compact_every: int = 0,
    overlay_slack: float = 0.25,
    trace_engine: Optional[str] = None,
) -> StreamResult:
    """Run ``algorithm`` over ``graph`` and a delta log, batch by batch, on
    the graph's device.

    See :func:`repro_torch.runtime.api.stream_execute` for the argument
    contract.  ``snapshot_hook(tick, batch)``, if given, fires after every
    committed snapshot.  On resume, records of batches that completed
    before the restored snapshot are not re-synthesized; the final state
    and result are bit-identical to an uninterrupted run.  ``trace``
    threads a fresh ring through every batch's drain (snapshots never see
    it), drains each under the engine ``trace_engine`` (default
    ``stream.<algorithm>``; the task server names its job) at absolute,
    cross-batch round numbers, and registers the ``stream`` summary doc at
    the end.  Under the sharded topology the drains run on ``mesh``
    (``shard.run_sharded``'s default when None) and the stream's ``info``
    adds the exchange totals (``exchanged``, ``donated``, ``steal_rounds``,
    ``mis_routed``, ``route_dropped``).
    """
    policy = policy_of(cfg)
    sharded = policy.topology == "sharded"
    if sharded:
        from ..shard.driver import _mesh_dims, _mesh_for, seed_queues
        mesh = _mesh_for(cfg, mesh, _mesh_dims(cfg))
    deltas = list(deltas)
    params = dict(params or {})
    total = len(deltas) + 1
    snap = SnapshotManager(checkpoint_dir, keep=keep) if checkpoint_dir \
        else None
    if (snapshot_every > 0 or resume) and snap is None:
        raise ValueError("snapshot_every/resume require a checkpoint_dir")
    device = graph.device

    tick = 0
    start_batch = 0
    resume_tick = None
    if resume:
        resume_tick = snap.latest()
        if resume_tick is not None:
            start_batch = snap.peek(resume_tick)["batch"]
            tick = resume_tick + 1
    resumed = resume_tick is not None

    # ONE slotted CSR lives across the whole stream: batch commits mutate it
    # in place.  Resume replays the committed prefix through the same commit
    # path, so the compaction schedule and the slab layout are the same.
    slotted = SlottedCSR.from_csr(graph)
    if start_batch:
        replay_commits(slotted, deltas[:start_batch], compact_every,
                       overlay_slack)
    cur_graph = slotted.view()
    parts = None  # sharded: the long-lived partition, patched per owner
    state = None
    records: List[BatchRecord] = []
    totals = {"rounds": 0, "processed": 0, "work": 0, "dropped": 0}
    program = None

    for b in range(start_batch, total):
        restoring = resumed and b == start_batch
        applied = None
        commit_s = reseed_s = 0.0
        if b > 0 and not restoring:
            t_commit = time.perf_counter()
            applied = commit(slotted, deltas[b - 1], b, compact_every,
                             overlay_slack)
            commit_s = time.perf_counter() - t_commit
            cur_graph = applied.new_graph
        # the body closes over the view, so the program is rebuilt per batch
        program = build_program(algorithm, cur_graph, cfg,
                                params=dict(params),
                                queue_capacity=queue_capacity)
        was_incremental = bool(b > 0 and incremental
                               and program.dirty_seeds is not None)
        n = cur_graph.num_vertices
        if sharded:
            # the owner-aware patch: only shards owning an effectively
            # changed row (and their halo successors) are rebuilt; batch 0,
            # or a fresh resume, pays the one full build
            t_commit = time.perf_counter()
            halo = cfg.steal_threshold > 0
            if parts is None:
                parts = reshard(slotted, cfg.num_shards, halo=halo,
                                devices=mesh.devices)
            elif applied is not None:
                parts = reshard(
                    slotted, cfg.num_shards, halo=halo, parts=parts,
                    touched_rows=np.concatenate([applied.ins_src,
                                                 applied.del_src]))
            commit_s += time.perf_counter() - t_commit
            capacity = queue_capacity or max(4 * n, 1024)
        else:
            capacity = shared_queue_capacity(program, queue_capacity)
        fingerprint = None

        restored = None
        if restoring:
            state_template, _ = program.init()
            if sharded:
                q_template = tuple(seed_queues(
                    program, torch.zeros((0,), dtype=torch.int32), n,
                    capacity, mesh.devices))
            elif policy.topology == "single":
                q_template = make_queue(capacity, device=device)
            else:
                q_template = make_multiqueue(capacity, 1, device=device)
            tree = snap.restore(resume_tick, queue_template=q_template,
                                state_template=state_template,
                                graph=cur_graph, num_deltas=b)
            cur = {k: int(v) for k, v in tree["cursor"].items()}
            queue = tree["queue"]
            restored = (list(queue) if sharded else queue, cur["rounds"],
                        cur["processed"])
            state = tree["state"]
            seeds = torch.zeros((0,), dtype=torch.int32, device=device)
            seeds_count, eff = cur["seeds"], cur["eff"]
            pre_work, pre_splits = cur["pre_work"], cur["pre_splits"]
        else:
            t_reseed = time.perf_counter()
            if b == 0:
                state, seeds = program.init()
                eff = 0
            else:
                state, seeds = reseed(program, applied, state,
                                      incremental=incremental)
                eff = applied.num_effective
            seeds = torch.as_tensor(seeds, dtype=torch.int32, device=device)
            seeds_count = int(seeds.shape[0])
            pre_work = program.work_of(state)
            pre_splits = program.splits_of(state)
            reseed_s = time.perf_counter() - t_reseed

        def save_snapshot(queue_tree, st, r, p):
            nonlocal tick, fingerprint
            if fingerprint is None:  # the graph is fixed within a batch
                fingerprint = graph_fingerprint(cur_graph, b)
            if isinstance(queue_tree, list):  # the shards' queues
                queue_tree = tuple(queue_tree)
            snap.save(tick, cursor={
                "batch": b, "rounds": r, "processed": p,
                "pre_work": pre_work, "pre_splits": pre_splits,
                "seeds": seeds_count, "eff": eff,
            }, graph=cur_graph, num_deltas=b, queue=queue_tree, state=st,
                fingerprint=fingerprint)
            t, tick = tick, tick + 1
            if snapshot_hook is not None:
                snapshot_hook(t, b)

        every = snapshot_every if snap is not None else 0
        engine = trace_engine or f"stream.{algorithm}"
        # cross-batch round offset: batches tile one absolute timeline
        batch_offset = totals["rounds"]
        r0 = restored[1] if restored is not None else 0
        t_drain = time.perf_counter()
        extra = {}
        if sharded:
            if restored is None:
                mqs = seed_queues(program, seeds, n, capacity, mesh.devices)
                p0 = 0
            else:
                mqs, _, p0 = restored
            if snap is not None and restored is None:
                save_snapshot(mqs, state, 0, 0)
            _, state, rounds, processed, dropped, extra = _drive_sharded(
                program, cur_graph, cfg, capacity, mqs, state, r0, p0, every,
                save_snapshot, route_width, mesh, trace=trace,
                trace_engine=engine, trace_round_offset=batch_offset - r0,
                parts=parts)
            drain_s = time.perf_counter() - t_drain
        else:
            setup = drain_setup(
                program, cur_graph, cfg, queue_capacity=queue_capacity,
                trace=trace, init=(state, seeds),
                queue=restored[0] if restored is not None else None,
                rounds=r0,
                processed=restored[2] if restored is not None else 0)
            if snap is not None and restored is None:
                save_snapshot(setup.carry[0], setup.carry[1], 0, 0)
            carry = _drive_shared(
                setup, policy.kernel, every,
                lambda c: save_snapshot(c[0], c[1], int(c[2]), int(c[3])),
                device)
            queue, state, rounds_a, processed_a = carry[:4]
            rounds, processed = int(rounds_a), int(processed_a)
            drain_s = time.perf_counter() - t_drain
            if trace is not None:
                trace.drain(carry[4], engine=engine,
                            round_offset=batch_offset - r0)
            dropped = int(setup.dropped(queue))

        records.append(BatchRecord(
            batch=b, incremental=was_incremental, seeds=seeds_count,
            effective_ops=eff, rounds=rounds, processed=processed,
            work=program.work_of(state) - pre_work,
            splits=program.splits_of(state) - pre_splits,
            dropped=dropped,
            # a restoring batch's commit happened inside replay_commits --
            # the slotted counters still hold exactly that batch's numbers
            touched_rows=(applied.touched_rows if applied is not None
                          else (slotted.last_touched if b > 0 else 0)),
            overlay=slotted.overlay_size,
            compacted=(applied.compacted if applied is not None
                       else (slotted.last_compacted if b > 0 else False)),
            commit_seconds=commit_s, reseed_seconds=reseed_s,
            drain_seconds=drain_s,
            reseed_sweeps=(applied.meters.get("sweeps", 0)
                           if applied is not None else 0),
        ))
        totals["rounds"] += rounds
        totals["processed"] += processed
        totals["work"] += records[-1].work
        totals["dropped"] += dropped
        for k, v in extra.items():
            totals[k] = totals.get(k, 0) + v

    if snap is not None:
        snap.wait()
    info = dict(totals)
    info.update({
        "batches": total,
        "batches_run": total - start_batch,
        "resumed_at": start_batch if resumed else None,
        "incremental": incremental,
        "topology": policy.topology,
        # commit-cost meters over the whole delta log, a resume-replayed
        # prefix included
        "touched_rows": slotted.touched_rows,
        "compactions": slotted.compactions,
        "commit_seconds": round(sum(r.commit_seconds for r in records), 6),
    })
    out = StreamResult(state=state, result=program.result(state),
                       batches=records, info=info)
    if trace is not None:
        trace.add_metric(out.as_dict())
    return out
