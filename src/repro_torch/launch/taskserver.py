"""Multi-tenant task-server driver: N concurrent graph jobs, one scheduler.

The counterpart of ``repro/launch/taskserver.py``, with ``--device``
(default ``cuda``; pass ``cpu`` to run on the host):

  PYTHONPATH=src python -m repro_torch.launch.taskserver --jobs 8 \\
      --policy weighted
  PYTHONPATH=src python -m repro_torch.launch.taskserver --jobs 9 \\
      --lanes 4 --scale 14 --grid-side 128 --workers 256 --fetch 4 \\
      --compare-sequential
  PYTHONPATH=src python -m repro_torch.launch.taskserver --jobs 8 \\
      --scale 6 --grid-side 8 --device cpu

Builds one scale-free (R-MAT) and one mesh (2-D grid) graph on the device,
submits a mixed batch of BFS / PageRank / coloring jobs against them and
drains everything through one TaskServer, printing per-job telemetry
(latency, rounds, occupancy, overwork) and the server totals.
``--compare-sequential`` also runs the tenant-at-a-time baseline.
``--shards S`` (or ``--mesh R C``) makes the BFS jobs sharded jobs over S
shards, with ``--overlap`` (deferred delivery) and ``--compress`` (the
wire codec); on ``--device cuda`` they take one card a shard unless
``--shard-devices`` names the devices:

  PYTHONPATH=src python -m repro_torch.launch.taskserver --jobs 3 \\
      --scale 6 --grid-side 8 --shards 4 --mesh 2 2 --overlap --compress \\
      --shard-devices cuda:0,cuda:0,cuda:0,cuda:0 --stream 2
"""
from __future__ import annotations

import argparse
import logging
import subprocess

from ..core.scheduler import SchedulerConfig
from ..graph.generators import grid2d, rmat
from ..runtime.policy import POLICY_GRID, parse_policy
from ..server import (Autotuner, JobRegistry, JobSpec, TaskServer,
                      serve_sequential)

ALGO_CYCLE = ("bfs", "pagerank", "coloring")


def git_sha() -> str:
    """Best-effort provenance stamp for the trace meta block."""
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, check=True).stdout.strip()
    except Exception:
        return "unknown"


def build_registry(scale: int, grid_side: int, seed: int,
                   device="cuda") -> JobRegistry:
    reg = JobRegistry()
    reg.register_graph("rmat", rmat(scale, edge_factor=8, seed=seed,
                                    device=device))
    reg.register_graph("grid", grid2d(grid_side, grid_side, seed=seed,
                                      device=device))
    return reg


def mixed_specs(n_jobs: int, registry: JobRegistry, eps: float,
                seed: int, shards: int = 1,
                stream: int = 0, stream_batch: int = 32,
                snapshot_every: int = 0, checkpoint_dir: str | None = None,
                resume: bool = False, compact_every: int = 0,
                overlay_slack: float = 0.25) -> list[JobSpec]:
    """Round-robin over algorithms x graphs, sources spread over vertices.

    With ``shards > 1`` the BFS jobs become sharded single-tenant jobs while
    PageRank and coloring stay in the fused rounds.  With ``stream > 0``
    the BFS jobs become streaming jobs (sharded ones with ``shards > 1``),
    each over a seeded delta log (``graph.edge_delta_stream``, ``stream``
    batches of ``stream_batch`` edge ops) with the given snapshot/resume
    posture (per-job subdirectories under ``checkpoint_dir``).
    """
    from ..graph.generators import edge_delta_stream
    from ..stream import StreamSpec

    specs = []
    graphs = registry.graph_names
    for i in range(n_jobs):
        algorithm = ALGO_CYCLE[i % len(ALGO_CYCLE)]
        gname = graphs[(i // len(ALGO_CYCLE)) % len(graphs)]
        n = registry.graph(gname).num_vertices
        params = {}
        if algorithm == "bfs":
            params["source"] = (seed + 7919 * i) % n
        elif algorithm == "pagerank":
            params["eps"] = eps
        stream_spec = None
        if stream > 0 and algorithm == "bfs":
            deltas = edge_delta_stream(registry.graph(gname), stream,
                                       stream_batch, seed=seed + i)
            job_dir = (f"{checkpoint_dir}/job_{i}"
                       if checkpoint_dir else None)
            stream_spec = StreamSpec(
                deltas=tuple(deltas),
                snapshot_every=snapshot_every if job_dir else 0,
                checkpoint_dir=job_dir, resume=resume and job_dir is not None,
                compact_every=compact_every, overlay_slack=overlay_slack)
        specs.append(JobSpec(algorithm, gname, params,
                             weight=1.0 + (i % 3),
                             shards=shards if algorithm == "bfs" else 1,
                             stream=stream_spec))
    return specs


def print_telemetry(result) -> None:
    hdr = (f"{'job':>3} {'algorithm':<9} {'graph':<5} {'lat(rounds)':>11} "
           f"{'active':>6} {'items':>7} {'occ':>6} {'overwork':>8} "
           f"{'drops':>5} {'bp':>3}")
    print(hdr)
    print("-" * len(hdr))
    for job_id in sorted(result.telemetry):
        t = result.telemetry[job_id]
        print(f"{job_id:>3} {t.algorithm:<9} {t.graph:<5} "
              f"{t.latency_rounds:>11} {t.rounds_active:>6} "
              f"{t.items_processed:>7} {t.occupancy:>6.3f} "
              f"{t.overwork:>8.2f} {t.dropped:>5} "
              f"{t.backpressure_events:>3}")
    s = result.stats
    print(f"server: rounds={s.rounds} occupancy={s.occupancy:.3f} "
          f"wall={s.wall_seconds:.2f}s "
          f"backpressure={s.backpressure_events} "
          f"deferred_admissions={s.deferred_admissions}")
    if s.sharded_jobs:
        print(f"sharded phases: {s.sharded_jobs} jobs, "
              f"{s.sharded_rounds} device rounds")
    if s.streaming_jobs:
        print(f"streaming phases: {s.streaming_jobs} jobs, "
              f"{s.stream_batches} delta batches")


def print_stream_records(server) -> None:
    """Per-batch breakdown of every streaming job's drains."""
    for job in server.jobs:
        if job.stream_result is None:
            continue
        res = job.stream_result
        print(f"streaming job {job.job_id}: {res.info['batches_run']} "
              f"batches (incremental={res.info['incremental']})")
        for r in res.batches:
            mode = "incr" if r.incremental else "full"
            print(f"  batch {r.batch:>3} [{mode}] ops={r.effective_ops:>4} "
                  f"seeds={r.seeds:>5} rounds={r.rounds:>5} "
                  f"work={r.work:>7} touched={r.touched_rows:>4} "
                  f"ovl={r.overlay:>4}{' compact' if r.compacted else ''}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--policy", default="weighted",
                    choices=["weighted", "round_robin",
                             "longest_queue_first"])
    ap.add_argument("--workers", type=int, default=64)
    ap.add_argument("--fetch", type=int, default=1)
    ap.add_argument("--exec-policy", default="auto",
                    help="execution policy '<topology>.<kernel>[.g<width>]'"
                         ": the server's rounds stay host-driven whatever "
                         "the kernel (a megakernel request logs a warning "
                         "and runs the per-round steps; streaming jobs' "
                         "batch drains honor it).  auto keeps the config "
                         "defaults.  Known cells: "
                         + ", ".join(str(p) for p in POLICY_GRID))
    ap.add_argument("--granularity", type=int, default=1,
                    help="max task chunk width G (core/task.py); a "
                         ".g<width> suffix on --exec-policy overrides it")
    ap.add_argument("--split-threshold", type=int, default=0,
                    help="chunk degree-sum cap at formation time (0 = "
                         "bounded by the merge-path work budget only)")
    ap.add_argument("--backend", default="auto",
                    choices=["torch", "cuda", "auto"],
                    help="kernel backend: the plain PyTorch versions, the "
                         "hand-written CUDA kernels, or auto (the kernels "
                         "on the card); ignored under --autotune")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the graphs and the server's "
                         "queue (default cuda)")
    ap.add_argument("--shards", type=int, default=1,
                    help="run the BFS jobs as sharded single-tenant drains "
                         "over N shards; on --device cuda they take "
                         "cuda:0..N-1 unless --shard-devices names them")
    ap.add_argument("--mesh", type=int, nargs=2, default=None,
                    metavar=("R", "C"),
                    help="shard the BFS jobs over a 2-D R x C mesh (two "
                         "per-axis exchange hops); implies --shards R*C")
    ap.add_argument("--overlap", action="store_true",
                    help="deferred exchange delivery: routed tasks are "
                         "staged one round (defer_rounds=1)")
    ap.add_argument("--compress", action="store_true",
                    help="delta-compress the exchange payloads "
                         "(shard/codec.py); lossless")
    ap.add_argument("--shard-devices", default=None, metavar="DEVS",
                    help="comma-separated devices of the shards, shard d on "
                         "the d-th, e.g. cuda:0,cuda:0,cuda:0,cuda:0 to "
                         "stack four shards on one card")
    ap.add_argument("--stream", type=int, default=0, metavar="N",
                    help="turn the BFS jobs into streaming jobs over N "
                         "delta batches")
    ap.add_argument("--stream-batch", type=int, default=32, metavar="K",
                    help="edge operations per delta batch")
    ap.add_argument("--compact-every", type=int, default=0, metavar="B",
                    help="re-pack the slotted CSR's slabs every B batches "
                         "(0 = on occupancy / slab-slack triggers only)")
    ap.add_argument("--overlay-slack", type=float, default=0.25,
                    metavar="F",
                    help="compact when the overlay exceeds F * m edges")
    ap.add_argument("--snapshot-every", type=int, default=0, metavar="R",
                    help="snapshot a streaming drain every R rounds "
                         "(needs --checkpoint-dir)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="directory for streaming snapshots (per-job "
                         "subdirectories); enables --resume")
    ap.add_argument("--resume", action="store_true",
                    help="resume each streaming job from its newest "
                         "snapshot under --checkpoint-dir")
    ap.add_argument("--scale", type=int, default=8,
                    help="R-MAT scale (2**scale vertices)")
    ap.add_argument("--grid-side", type=int, default=16)
    ap.add_argument("--eps", type=float, default=1e-4,
                    help="PageRank convergence threshold")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Perfetto-loadable Chrome trace of every "
                         "round to PATH")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the canonical metrics JSONL to PATH")
    ap.add_argument("--trace-capacity", type=int, default=0, metavar="N",
                    help="trace ring capacity in rounds (0 = default)")
    ap.add_argument("--autotune", action="store_true",
                    help="pick the SchedulerConfig via the autotuner")
    ap.add_argument("--autotune-cache", default=".atos_autotune.json")
    ap.add_argument("--compare-sequential", action="store_true")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(name)s: %(message)s")

    mesh_shape = tuple(args.mesh) if args.mesh else None
    if mesh_shape:
        rows, cols = mesh_shape
        if args.shards > 1 and args.shards != rows * cols:
            ap.error(f"--shards {args.shards} contradicts "
                     f"--mesh {rows} {cols} (= {rows * cols} shards)")
        args.shards = rows * cols
    shard_devices = None
    if args.shard_devices:
        from .mesh import parse_devices

        shard_devices = parse_devices(args.shard_devices)
        if len(shard_devices) < args.shards:
            ap.error(f"--shard-devices names {len(shard_devices)} devices "
                     f"for --shards {args.shards}")
    elif args.shards > 1 and args.device != "cpu":
        from .mesh import require_devices

        require_devices(args.shards, purpose=f"--shards {args.shards}")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    if args.snapshot_every and not args.checkpoint_dir:
        ap.error("--snapshot-every requires --checkpoint-dir")
    registry = build_registry(args.scale, args.grid_side, args.seed,
                              device=args.device)
    specs = mixed_specs(args.jobs, registry, args.eps, args.seed,
                        shards=args.shards, stream=args.stream,
                        stream_batch=args.stream_batch,
                        snapshot_every=args.snapshot_every,
                        checkpoint_dir=args.checkpoint_dir,
                        resume=args.resume,
                        compact_every=args.compact_every,
                        overlay_slack=args.overlay_slack)

    granularity = args.granularity
    if args.exec_policy == "auto":
        topology, kernel, persistent = "auto", "auto", True
    else:
        policy = parse_policy(args.exec_policy)
        topology, kernel = policy.topology, policy.kernel
        persistent = policy.persistent
        # an explicit granularity segment -- .g1 included -- wins
        if len(args.exec_policy.split(".")) == 3:
            granularity = policy.granularity
    if args.autotune and (mesh_shape or args.overlap or args.compress):
        # the tuner searches launch shapes, not the exchange's posture
        ap.error("--mesh/--overlap/--compress need an explicit config; "
                 "drop --autotune")
    config = None if args.autotune else SchedulerConfig(
        num_workers=args.workers, fetch_size=args.fetch,
        backend=args.backend, topology=topology, persistent=persistent,
        kernel=kernel, granularity=granularity,
        split_threshold=args.split_threshold,
        mesh_shape=mesh_shape, defer_rounds=1 if args.overlap else 0,
        compress=args.compress)
    autotuner = (Autotuner(cache_path=args.autotune_cache)
                 if args.autotune else None)

    trace = None
    if args.trace_out or args.metrics_out:
        from ..obs import DEFAULT_CAPACITY, Trace

        trace = Trace(capacity=args.trace_capacity or DEFAULT_CAPACITY,
                      meta={"git_sha": git_sha()})

    server = TaskServer(registry, num_lanes=args.lanes, config=config,
                        policy=args.policy, autotuner=autotuner,
                        trace=trace, device=args.device,
                        shard_devices=shard_devices)
    for spec in specs:
        server.submit(spec)
    print(f"submitted {len(specs)} jobs to {args.lanes} lanes "
          f"(policy={args.policy})")
    result = server.run()
    print_telemetry(result)
    if args.stream > 0:
        print_stream_records(server)
    if trace is not None:
        trace.write(args.trace_out, args.metrics_out)
        lat = trace.histograms.get("job_latency_rounds")
        if lat is not None and lat.count:
            print(f"job latency (rounds): p50={lat.percentile(50)} "
                  f"p95={lat.percentile(95)} p99={lat.percentile(99)} "
                  f"over {lat.count} jobs")
        for path, what in ((args.trace_out, "chrome trace"),
                           (args.metrics_out, "metrics jsonl")):
            if path:
                print(f"wrote {what}: {path} "
                      f"({len(trace.records)} round records, "
                      f"{trace.truncated} truncated)")

    if args.compare_sequential:
        seq_config = config
        if seq_config is None and autotuner is not None:
            seq_config = autotuner.recommend_for_mix(
                [(s.algorithm, registry.graph(s.graph)) for s in specs])
        seq = serve_sequential(registry, specs, config=seq_config,
                               device=args.device,
                               shard_devices=shard_devices)
        print(f"sequential: rounds={seq.stats.rounds} "
              f"occupancy={seq.stats.occupancy:.3f} "
              f"wall={seq.stats.wall_seconds:.2f}s")
        print(f"fused/sequential rounds: {result.stats.rounds}"
              f"/{seq.stats.rounds} "
              f"({result.stats.rounds / max(seq.stats.rounds, 1):.2f}x)")


if __name__ == "__main__":
    main()
