"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # full size: rmat scale 21, grid 1024^2
    python3 chip_smoke.py --scale 14 --grid-side 128   # a quick rehearsal

Phases, in order; any failure exits non-zero and prints no result:

  1. require a CUDA device; print the card's name and power limit;
  2. build the kernels from ``src/repro_torch/csrc`` with nvcc (one process
     per source, all at once) and print ptxas's register / shared-memory /
     spill report;
  3. hold each kernel bit-equal to its plain PyTorch version on the card, at
     the main path's shapes and at edge sizes;
  4. the main path: speculative BFS on ``rmat(scale, 16)`` under
     ``single.persistent`` at granularity 1, merge-path expansion, backend
     ``auto`` (the kernels), from the highest-degree vertex.  Distances
     must equal a host BFS (scipy), a second run on the plain ``torch``
     backend must give the same distances and RunStats, no item may be
     dropped, and both kernels must have launched.  The persistent driver
     runs its rounds between host polls with CUDA's sync-debug mode set to
     raise, so a host sync there fails the run.  Then ``grid2d`` at
     ``single.persistent.g4`` against scipy the same way;
  4b. the megakernel path: the same BFS under ``single.megakernel`` g1,
     one launch of the BFS drain kernel (B3) and none of B1 or B2.
     Distances equal scipy's; distances, RunStats, counters and the final
     queue equal the persistent drain's; the drain cut into segments of 64
     rounds equals the whole; ``grid2d`` at g1 equals scipy; and at a scale
     where the plain stream's [W, budget] slices stay under 1 GB the kernel
     drain equals the plain fused drain (``backend="torch"``);
  5. time each kernel, its plain version and one library call for the same
     function -- device time per call from torch.profiler, and time per
     call of a back-to-back run between CUDA events -- and the main drain
     on each backend with the host clock (auto, torch, torch, auto), then
     once more each under the profiler for device time, busy share and
     device ops per predicated step; then the megakernel drain beside the
     persistent one (persistent, megakernel, megakernel, persistent), B3's
     device time and the plain fused drain's at full size;
  6. print a ``{"kernels": [...]}`` line, the card's name and power limit,
     and, last, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the reference package.  Big outputs
go to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
INF = 0x7FFFFFFF


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Time per call between CUDA events over ``reps`` back-to-back calls
    (launch gaps included)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps: int = 1):
    """``(device ms per call, [(device op, total ms, calls), ...])`` from
    torch.profiler's CUDA activity over ``reps`` calls, or ``(None, [])``
    when the profiler reports no device time.  A device op is a kernel, a
    copy or a fill."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(ms for _, ms, _ in rows)
    return (total / reps if total > 0 else None), rows


def max_abs_err(got, want) -> int:
    return max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
               for a, b in zip(got, want))


def host_bfs(graph, source: int) -> np.ndarray:
    """Hop distances by scipy's BFS, unreached mapped to INF."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import shortest_path

    rp = graph.row_ptr.cpu().numpy()
    ci = graph.col_idx.cpu().numpy()
    n = graph.num_vertices
    adj = sp.csr_matrix((np.ones(ci.shape[0], np.float32), ci, rp),
                        shape=(n, n))
    d = shortest_path(adj, unweighted=True, indices=source)
    out = np.full(n, INF, dtype=np.int64)
    reached = np.isfinite(d)
    out[reached] = d[reached].astype(np.int64)
    return out.astype(np.int32)


# ------------------------------------------------------------ phase 3
def check_lbs(graph, budget: int, dev, rng) -> tuple:
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.frontier_expand.ref import lbs_ref

    deg = graph.degrees()
    picks = torch.as_tensor(rng.integers(0, graph.num_vertices, size=4096),
                            device=dev)
    main_scan = torch.cumsum(deg[picks], 0, dtype=torch.int32)
    cases = [("main W=4096", main_scan, budget)]
    for w in (1, 7, 257):
        d = torch.as_tensor(rng.integers(0, 9, size=w), dtype=torch.int32,
                            device=dev)
        cases.append((f"W={w}", torch.cumsum(d, 0, dtype=torch.int32), 4096))
    zeros = torch.tensor([0, 0, 5, 0, 3, 0], dtype=torch.int32, device=dev)
    cases.append(("zero degrees", torch.cumsum(zeros, 0, dtype=torch.int32),
                  64))
    cases.append(("budget past total", main_scan[:64].contiguous(), budget))
    cases.append(("all-zero scan", torch.zeros(300, dtype=torch.int32,
                                               device=dev), 1000))
    err = 0
    for label, scan, b in cases:
        got = lbs_cuda(scan, b)
        want = lbs_ref(scan, b)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        log(f"  B1 lbs {label}: budget={b} total={int(scan[-1])} "
            f"max_abs_err={e}")
        if e:
            raise AssertionError(f"lbs kernel disagrees with lbs_ref: {label}")
        err = max(err, e)
    return main_scan, err


def check_compact(n_main: int, dev, rng) -> tuple:
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.queue_compact.ref import compact_ref

    cases = [(n_main, p) for p in (0.0, 0.3, 1.0)]
    cases += [(n, 0.3) for n in (1, 255, 256, 257, 1023, 1024, 1025, 70001)]
    err = 0
    main_inputs = None
    for n, p in cases:
        items = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, size=n),
                                dtype=torch.int32, device=dev)
        mask = torch.as_tensor(rng.random(n) < p, device=dev)
        got = compact_cuda(items, mask)
        want = compact_ref(items, mask)
        torch.cuda.synchronize()
        e = max_abs_err(got, want)
        log(f"  B2 compact N={n} p={p}: count={int(got[1])} max_abs_err={e}")
        if e:
            raise AssertionError(f"compact kernel disagrees with compact_ref "
                                 f"at N={n} p={p}")
        err = max(err, e)
        if n == n_main and p == 0.3:
            main_inputs = (items, mask)
    return main_inputs, err


def check_stream(graph, dev, rng) -> tuple:
    """B4 against its plain version: 4096 starts drawn from the graph's
    row_ptr at budget 4096 (64 MB out; the reference's megakernel streams
    4096 x 495,616 words a round, 8.1 GB, which the plain version would
    have to hold as well), and edge sizes."""
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda, stream_row_slices_ref)

    m = graph.num_edges
    rows = torch.as_tensor(rng.integers(0, graph.num_vertices, size=4096),
                           device=dev)
    main_starts = graph.row_ptr[rows].contiguous()

    def starts(values):
        return torch.as_tensor(np.asarray(values, dtype=np.int32),
                               device=dev)

    cases = [
        ("main W=4096 from row_ptr", main_starts, 4096),
        ("0 items", starts([]), 4096),
        ("1 item", main_starts[:1].contiguous(), 4096),
        ("starts within budget of m",
         starts(rng.integers(max(m - 4096, 0), m + 1, size=300)), 4096),
        ("budget not a multiple of 4", main_starts[:257].contiguous(), 4099),
        ("budget 13, starts out of range",
         starts(rng.integers(-50, m + 50, size=1000)), 13),
    ]
    err = 0
    for label, st, b in cases:
        got = stream_row_slices_cuda(graph.col_idx, st, b)
        want = stream_row_slices_ref(graph.col_idx, st, b)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"stream kernel shape {tuple(got.shape)} "
                                 f"!= {tuple(want.shape)}: {label}")
        e = max_abs_err((got,), (want,))
        log(f"  B4 csr_stream {label}: items={st.shape[0]} budget={b} "
            f"max_abs_err={e}")
        if e:
            raise AssertionError(f"stream kernel disagrees with "
                                 f"stream_row_slices_ref: {label}")
        err = max(err, e)
    return main_starts, err


# ------------------------------------------------------------ phase 4
def _wrappers() -> dict:
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda)
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    return {"lbs": lbs_cuda, "compact": compact_cuda,
            "csr_stream": stream_row_slices_cuda, "bfs_drain": bfs_drain_cuda}


def reset_counts() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def drain(graph, cfg, source: int) -> tuple:
    """One BFS drain through the public entry points; host-clock seconds
    ending in a device synchronize."""
    from repro_torch.runtime import build_program, execute

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program = build_program("bfs", graph, cfg,
                            params={"source": source,
                                    "strategy": "merge_path"})
    state, stats, info = execute(program, graph, cfg)
    torch.cuda.synchronize()
    return state, stats, info, time.perf_counter() - t0


def carry_parts(carry) -> tuple:
    """``([buf, dist], [head, tail, dropped, rounds, processed, work,
    splits, counter rounds])`` of a drain carry, on the host."""
    queue, state, rounds, processed = carry
    return ([queue.buf.cpu(), state.dist.cpu()],
            [int(x) for x in (queue.head, queue.tail, queue.dropped, rounds,
                              processed, state.counter.work,
                              state.counter.splits, state.counter.rounds)])


def same_carry(a, b) -> bool:
    (ta, sa), (tb, sb) = carry_parts(a), carry_parts(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(ta, tb))


def kernel_drain(graph, cfg, source: int):
    """``(carry0, final carry)`` of one drain through the megakernel cell's
    drain kernel, set up with ``drain_setup`` so the final queue can be
    compared; the launch runs with host syncs set to raise."""
    from repro_torch.core import megakernel_drive, no_host_sync
    from repro_torch.runtime import build_program
    from repro_torch.runtime.api import drain_setup

    setup = drain_setup(build_program("bfs", graph, cfg,
                                      params={"source": source}), graph, cfg)
    with no_host_sync(graph.device):
        carry = megakernel_drive(setup.step, setup.cond, setup.carry,
                                 kernel=setup.kernel)
    torch.cuda.synchronize()
    return setup, carry


def check_megakernel(graph, grid, source: int, persistent: tuple,
                     want: np.ndarray, want_grid: np.ndarray,
                     small_scale: int) -> dict:
    """Phase 4b: the megakernel path against scipy, the persistent drain,
    itself cut into segments, and the plain fused drain."""
    from repro_torch.algorithms.common import default_work_budget
    from repro_torch.core import (SchedulerConfig, megakernel_drive,
                                  megakernel_segment, no_host_sync,
                                  persistent_drive)
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.runtime import build_program, config_for, parse_policy
    from repro_torch.runtime.api import drain_setup

    def config(policy, **kw):
        return config_for(SchedulerConfig(num_workers=1024, fetch_size=4,
                                          **kw), parse_policy(policy))

    cfg_m = config("single.megakernel")
    state_p, stats_p, info_p = persistent
    reset_counts()
    state, stats, info, secs = drain(graph, cfg_m, source)
    counts = read_counts()
    units = int(bfs_drain_cuda.units_expanded)
    log(f"    counts={counts} info={info} units expanded={units} drain "
        f"{secs:.3f} s")
    if counts != {"lbs": 0, "compact": 0, "csr_stream": 0, "bfs_drain": 1}:
        raise AssertionError(f"expected exactly one BFS drain launch and no "
                             f"other, got {counts}")
    if units <= 0:
        raise AssertionError("the drain expanded no unit through the stream")
    if info["dropped"] != 0 or info["launches"] != 1:
        raise AssertionError(f"megakernel drain: {info}")
    if not np.array_equal(state.dist.cpu().numpy(), want):
        raise AssertionError("megakernel distances differ from scipy")
    if not torch.equal(state.dist, state_p.dist) \
            or [int(x) for x in stats] != [int(x) for x in stats_p] \
            or {**info_p, "launches": 1} != info \
            or [int(x) for x in (state.counter.work, state.counter.splits,
                                 state.counter.rounds)] \
            != [int(x) for x in (state_p.counter.work, state_p.counter.splits,
                                 state_p.counter.rounds)]:
        raise AssertionError(f"megakernel drain differs from the persistent "
                             f"one: {stats} {info} vs {stats_p} {info_p}")
    log("    dist equals scipy's BFS; dist, RunStats, counter and info equal "
        "the persistent drain's")

    # the final queue: both drains set up by hand so the carry comes back
    cfg_p = config("single.persistent")
    setup_p = drain_setup(build_program("bfs", graph, cfg_p,
                                        params={"source": source}),
                          graph, cfg_p)
    carry_p = persistent_drive(setup_p.step, setup_p.cond, setup_p.carry)
    setup_m, carry_m = kernel_drain(graph, cfg_m, source)
    if not same_carry(carry_m, carry_p):
        raise AssertionError(f"megakernel carry differs from the persistent "
                             f"one: {carry_parts(carry_m)[1]} vs "
                             f"{carry_parts(carry_p)[1]}")
    log(f"    final queue, dist and counters equal the persistent drain's: "
        f"(head, tail, dropped, rounds, processed, work, splits, counter "
        f"rounds) = {carry_parts(carry_m)[1]}")

    seg = megakernel_segment(setup_m.step, setup_m.cond, setup_m.carry,
                             kernel=setup_m.kernel)
    carry, limit, segments = setup_m.carry, 0, 0
    while bool(setup_m.cond(carry)):
        limit += 64
        with no_host_sync(graph.device):
            carry = seg(carry, limit)
        segments += 1
    if not same_carry(carry, carry_m):
        raise AssertionError("the drain cut into 64-round segments differs "
                             "from the whole drain")
    log(f"    {segments} segments of 64 rounds equal the whole drain")

    side = grid.num_vertices
    reset_counts()
    state_g, _, info_g, secs_g = drain(grid, cfg_m, 0)
    counts_g = read_counts()
    if counts_g["bfs_drain"] != 1 or info_g["dropped"] != 0 \
            or not np.array_equal(state_g.dist.cpu().numpy(), want_grid):
        raise AssertionError(f"grid2d megakernel drain: {info_g} {counts_g}")
    log(f"    grid2d ({side} vertices) single.megakernel g1: dist equals "
        f"scipy's BFS; info={info_g} drain {secs_g:.3f} s")

    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    small_source = int(torch.argmax(small.degrees()))
    cfg_k = config_for(SchedulerConfig(num_workers=256, fetch_size=4),
                       parse_policy("single.megakernel"))
    cfg_t = config_for(SchedulerConfig(num_workers=256, fetch_size=4,
                                       backend="torch"),
                       parse_policy("single.megakernel"))
    small_budget = default_work_budget(small, cfg_k.wavefront)
    slice_bytes = 4 * cfg_k.wavefront * small_budget
    if slice_bytes >= 2 ** 30:
        raise AssertionError(f"the plain stream would hold {slice_bytes} B")
    _, carry_k = kernel_drain(small, cfg_k, small_source)
    setup_t = drain_setup(build_program("bfs", small, cfg_t,
                                        params={"source": small_source}),
                          small, cfg_t)
    if setup_t.kernel is not None:
        raise AssertionError("backend='torch' picked the drain kernel")
    reset_counts()
    carry_t = megakernel_drive(setup_t.step, setup_t.cond, setup_t.carry)
    if any(read_counts().values()):
        raise AssertionError(f"the plain fused drain launched a kernel: "
                             f"{read_counts()}")
    if not same_carry(carry_k, carry_t) or not np.array_equal(
            carry_k[1].dist.cpu().numpy(), host_bfs(small, small_source)):
        raise AssertionError("at the small scale the drain kernel differs "
                             "from the plain fused drain or from scipy")
    log(f"    rmat({small_scale}) W={cfg_k.wavefront} budget={small_budget} "
        f"(plain slices {slice_bytes / 2 ** 20:.0f} MiB): the drain kernel "
        f"equals the plain fused drain (backend=torch) and scipy; "
        f"{carry_parts(carry_k)[1]}")
    return {"state": state, "stats": stats, "info": info, "seconds": secs,
            "counts": counts, "units": units, "carry": carry_m,
            "segments": segments, "grid_info": info_g,
            "grid_seconds": secs_g, "grid_counts": counts_g,
            "small": {"scale": small_scale, "budget": small_budget,
                      "wavefront": cfg_k.wavefront,
                      "carry": carry_parts(carry_k)[1]}}


def check_guard(dev) -> None:
    """The persistent driver's no-sync guard must really raise on a sync."""
    from repro_torch.core import no_host_sync

    x = torch.ones(1, device=dev)
    try:
        with no_host_sync(dev):
            x.item()
    except RuntimeError:
        pass
    else:
        raise AssertionError("no_host_sync let a device->host sync through")
    if torch.cuda.get_sync_debug_mode() != 0:
        raise AssertionError("no_host_sync did not restore the sync mode")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=21,
                    help="R-MAT scale of the main graph (default 21)")
    ap.add_argument("--grid-side", type=int, default=1024,
                    help="side of the grid2d graph (default 1024)")
    args = ap.parse_args()
    started = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs "
              "only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.algorithms.common import default_work_budget
    from repro_torch.core import SchedulerConfig
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.graph import grid2d, rmat
    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.frontier_expand.ref import lbs_ref
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.queue_compact.ref import compact_ref
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda, stream_row_slices_ref)
    from repro_torch.runtime import config_for, parse_policy

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    reports = build.build()
    log(f"[2] built {', '.join(build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        log(f"  ptxas report for csrc/{name}.cu:")
        for line in report.strip().splitlines():
            log(f"    {line}")

    t0 = time.perf_counter()
    graph = rmat(args.scale, edge_factor=16, seed=1, device="cuda")
    deg = graph.degrees()
    source = int(torch.argmax(deg))
    cfg = config_for(SchedulerConfig(num_workers=1024, fetch_size=4),
                     parse_policy("single.persistent"))
    budget = default_work_budget(graph, cfg.wavefront)
    log(f"    main graph rmat({args.scale}, 16, seed=1): n={graph.num_vertices} "
        f"m={graph.num_edges} max_degree={int(deg.max())} source={source} "
        f"wavefront={cfg.wavefront} budget={budget} (generated in "
        f"{time.perf_counter() - t0:.1f} s)")

    log("[3] kernels vs their plain versions on the card")
    rng = np.random.default_rng(0)
    main_scan, lbs_err = check_lbs(graph, budget, dev, rng)
    n_push = budget + cfg.wavefront
    (items, mask), compact_err = check_compact(n_push, dev, rng)
    main_starts, stream_err = check_stream(graph, dev, rng)

    log(f"[4] main path: BFS rmat({args.scale}) single.persistent g1 "
        f"merge_path backend=auto")
    check_guard(dev)
    reset_counts()
    state, stats, info, secs = drain(graph, cfg, source)
    counts = read_counts()
    steps = -(-info["rounds"] // POLL_EVERY) * POLL_EVERY
    log(f"    counts={counts} info={info} drain {secs:.3f} s")
    if counts != {"lbs": steps, "compact": steps + 1, "csr_stream": 0,
                  "bfs_drain": 0}:
        raise AssertionError(f"expected one LBS and one compaction launch "
                             f"per predicated step ({steps}) plus the seed "
                             f"push's compaction, and no other, got {counts}")
    if info["dropped"] != 0:
        raise AssertionError(f"the main path dropped {info['dropped']} items")
    dist = state.dist.cpu().numpy()
    want = host_bfs(graph, source)
    if not np.array_equal(dist, want):
        bad = int((dist != want).sum())
        raise AssertionError(f"BFS distances differ from scipy at {bad} "
                             f"vertices")
    log(f"    dist equals scipy's BFS: reached {int((want != INF).sum())} "
        f"vertices, depth {int(want[want != INF].max())}")

    cfg_plain = config_for(SchedulerConfig(num_workers=1024, fetch_size=4,
                                           backend="torch"),
                           parse_policy("single.persistent"))
    reset_counts()
    state_p, stats_p, info_p, secs_p = drain(graph, cfg_plain, source)
    if any(read_counts().values()):
        raise AssertionError("backend='torch' launched a kernel")
    if not torch.equal(state_p.dist, state.dist):
        raise AssertionError("backend='torch' distances differ")
    if [int(x) for x in stats_p] != [int(x) for x in stats] \
            or info_p != info:
        raise AssertionError(f"backend='torch' stats differ: {stats_p} "
                             f"{info_p} vs {stats} {info}")
    log(f"    backend=torch on the card: identical dist, RunStats {info_p}; "
        f"drain {secs_p:.3f} s")

    side = args.grid_side
    grid = grid2d(side, side, device="cuda")
    cfg_g4 = config_for(SchedulerConfig(num_workers=1024, fetch_size=4),
                        parse_policy("single.persistent.g4"))
    reset_counts()
    state_g, _, info_g, secs_g = drain(grid, cfg_g4, 0)
    counts_g = read_counts()
    if info_g["dropped"] != 0 or min(counts_g["lbs"],
                                     counts_g["compact"]) <= 0:
        raise AssertionError(f"grid g4 run: {info_g} {counts_g}")
    want_grid = host_bfs(grid, 0)
    if not np.array_equal(state_g.dist.cpu().numpy(), want_grid):
        raise AssertionError("grid2d g4 distances differ from scipy")
    log(f"    grid2d({side},{side}) single.persistent.g4: dist equals "
        f"scipy's BFS; counts={counts_g} info={info_g} drain {secs_g:.3f} s")

    log(f"[4b] megakernel path: BFS rmat({args.scale}) single.megakernel g1 "
        f"merge_path backend=auto, one launch of the BFS drain kernel")
    mega = check_megakernel(graph, grid, source, (state, stats, info), want,
                            want_grid, min(args.scale, 14))

    log(f"[5] timing on {card}")
    k = torch.arange(budget, dtype=torch.int32, device=dev)
    zeros = torch.zeros(n_push, dtype=torch.int32, device=dev)

    def library_compact():
        kept = items[mask]
        out = zeros.clone()
        out[:kept.shape[0]] = kept
        return out

    # each version: device time per call (profiler) and time per call of a
    # back-to-back run between CUDA events, which includes launch gaps.  If
    # the profiler saw no device time for one of a kernel's three versions,
    # all three are reported by their event times, so that they compare.
    padded_main = torch.cat([graph.col_idx, graph.col_idx.new_zeros(4096)])
    window = torch.arange(4096, device=dev)
    versions = {
        "lbs": (lambda: lbs_cuda(main_scan, budget),
                lambda: lbs_ref(main_scan, budget),
                lambda: torch.searchsorted(main_scan, k, right=True,
                                           out_int32=True)),
        "compact": (lambda: compact_cuda(items, mask),
                    lambda: compact_ref(items, mask), library_compact),
        "csr_stream": (
            lambda: stream_row_slices_cuda(graph.col_idx, main_starts, 4096),
            lambda: stream_row_slices_ref(graph.col_idx, main_starts, 4096),
            lambda: padded_main[main_starts[:, None].long() + window]),
    }
    times = {}
    for name, fns in versions.items():
        by_profiler = [device_profile(fn, reps=20)[0] for fn in fns]
        by_events = [cuda_ms(fn) for fn in fns]
        if None in by_profiler:
            times[name] = (by_events, "cuda events", by_events)
        else:
            times[name] = (by_profiler, "profiler device time", by_events)
    # least time: each input read once, each output written once
    bound_bytes = {"lbs": 4 * main_scan.shape[0] + 8 * budget,
                   "compact": 5 * n_push + 4 * n_push + 4,
                   "csr_stream": 4 * 4096 + 2 * 4 * 4096 * 4096}

    # the main drain again on each backend, warm, in the order auto,
    # torch, torch, auto so that neither is always first; then one drain of
    # each under the profiler: its device time over its own host time is
    # the busy share, and its device ops per predicated step are the
    # launches a round costs the host
    backends = {"auto": cfg, "torch": cfg_plain}
    walls = {"auto": [], "torch": []}
    for name in ("auto", "torch", "torch", "auto"):
        walls[name].append(drain(graph, backends[name], source)[3])
    rounds = info["rounds"]
    profiled = {}
    for name, c in backends.items():
        held = {}
        dev_ms, rows = device_profile(
            lambda: held.update(secs=drain(graph, c, source)[3]))
        n_ops = sum(calls for _, _, calls in rows)
        profiled[name] = {
            "seconds": held["secs"], "device_ms": dev_ms,
            "busy_share": None if dev_ms is None
            else dev_ms / (1e3 * held["secs"]),
            "device_ops": n_ops, "device_ops_per_step": n_ops / steps,
            "device_ops_ms_calls": rows}
    for name, first in (("auto", secs), ("torch", secs_p)):
        mean = sum(walls[name]) / len(walls[name])
        prof = profiled[name]
        log(f"    drain rmat({args.scale}) backend={name}: first {first} s, "
            f"warm {walls[name]} s; {rounds} rounds ({steps} predicated "
            f"steps), warm {1e3 * mean / rounds:.3f} ms/round, "
            f"{graph.num_edges / mean:.4g} input edges/s  [{card}]")
        log(f"      under the profiler: {prof['seconds']} s wall, device "
            f"time {prof['device_ms']} ms, busy share {prof['busy_share']}; "
            f"{prof['device_ops_per_step']} device ops per predicated step "
            f"({prof['device_ops']} in {steps}); top device ops by time "
            f"(ms, calls):")
        for key, ms, calls in prof["device_ops_ms_calls"][:10]:
            log(f"      {ms:10.3f} {calls:7d}  {key[:90]}")
    log(f"    drain grid2d({side},{side}) g4: {secs_g:.3f} s, "
        f"{info_g['rounds']} rounds, {1e3 * secs_g / info_g['rounds']:.3f} "
        f"ms/round  [{card}]")

    # the megakernel drain beside the persistent one, warm, alternated;
    # then one of each kind under the profiler: the B3 launch, and the
    # plain fused drain (backend torch, the plain stream) at full size
    cfg_mega = config_for(SchedulerConfig(num_workers=1024, fetch_size=4),
                          parse_policy("single.megakernel"))
    cfg_mega_plain = config_for(
        SchedulerConfig(num_workers=1024, fetch_size=4, backend="torch"),
        parse_policy("single.megakernel"))
    mega_walls = {"persistent": [], "megakernel": []}
    for name in ("persistent", "megakernel", "megakernel", "persistent"):
        c = cfg if name == "persistent" else cfg_mega
        mega_walls[name].append(drain(graph, c, source)[3])
    held = {}
    mega_dev_ms, mega_rows = device_profile(
        lambda: held.update(secs=drain(graph, cfg_mega, source)[3]))
    b3_ms = sum(ms for key, ms, _ in mega_rows if "bfs_drain" in key)
    b3_event_ms = cuda_ms(lambda: kernel_drain(graph, cfg_mega, source),
                          reps=3, warmup=1)
    b3_timed_by = "profiler device time"
    if b3_ms <= 0:
        b3_ms, b3_timed_by = b3_event_ms, "cuda events"
    held_t = {}
    plain_dev_ms, plain_rows = device_profile(
        lambda: held_t.update(out=drain(graph, cfg_mega_plain, source)))
    state_t, stats_t, info_t, secs_t = held_t["out"]
    b3_err = max_abs_err((mega["state"].dist,), (state_t.dist,))
    if b3_err or not torch.equal(state_t.dist, mega["state"].dist) \
            or [int(x) for x in stats_t] != [int(x) for x in mega["stats"]] \
            or info_t != mega["info"]:
        raise AssertionError(f"the plain fused drain at full size differs "
                             f"from the drain kernel: {info_t} vs "
                             f"{mega['info']}")
    plain_ms = plain_dev_ms if plain_dev_ms is not None else 1e3 * secs_t
    pushed = carry_parts(mega["carry"])[1][1]
    processed_m = int(mega["stats"].items_processed)
    bound_bytes["bfs_drain"] = (8 * mega["units"] + 12 * processed_m
                                + 4 * pushed)
    mean_m = sum(mega_walls["megakernel"]) / 2
    mean_p = sum(mega_walls["persistent"]) / 2
    log(f"    drain rmat({args.scale}) warm, alternated: persistent "
        f"{mega_walls['persistent']} s, megakernel "
        f"{mega_walls['megakernel']} s; {rounds} rounds: "
        f"{1e3 * mean_p / rounds:.3f} vs {1e3 * mean_m / rounds:.3f} "
        f"ms/round  [{card}]")
    log(f"    B3 bfs_drain: {b3_ms:.3f} ms by {b3_timed_by} for {rounds} "
        f"rounds, {1e3 * b3_ms / rounds:.2f} us/round (drain under the "
        f"profiler: {held['secs']} s wall, {mega_dev_ms} ms device, busy "
        f"share {None if mega_dev_ms is None else mega_dev_ms / (1e3 * held['secs'])}"
        f"; between events around the kernel drain {b3_event_ms:.3f} ms); "
        f"{mega['units']} units expanded, {processed_m} popped, {pushed} "
        f"pushed: bound {1e3 * bound_bytes['bfs_drain'] / HBM_BYTES_PER_S:.3f}"
        f" ms  [{card}]")
    log(f"    plain fused drain (backend torch, plain stream) at full size: "
        f"equal result; {secs_t:.3f} s wall, {plain_dev_ms} ms device; top "
        f"device ops (ms, calls):")
    for key, ms, calls in plain_rows[:5]:
        log(f"      {ms:10.3f} {calls:7d}  {key[:90]}")
    log(f"    drain grid2d({side},{side}) megakernel g1: "
        f"{mega['grid_seconds']:.3f} s, {mega['grid_info']['rounds']} "
        f"rounds  [{card}]")

    sources = {"lbs": ("src/repro_torch/csrc/lbs.cu",
                       "src/repro/kernels/frontier_expand/kernel.py:59",
                       lbs_err,
                       f"scan int32[{main_scan.shape[0]}], budget {budget}"),
               "compact": ("src/repro_torch/csrc/compact.cu",
                           "src/repro/kernels/queue_compact/kernel.py:44",
                           compact_err,
                           f"items int32[{n_push}], mask bool[{n_push}], "
                           f"p=0.3"),
               "csr_stream": ("src/repro_torch/csrc/csr_stream.cu",
                              "src/repro/kernels/drain_loop/csr_stream.py:72",
                              stream_err,
                              "starts int32[4096] from row_ptr, budget 4096")}
    kernels = []
    for name, (source_file, replaces, err, shape) in sources.items():
        (kd, pd, ld), timed_by, (ke, pe, le) = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source_file,
            "replaces": replaces, "launches": counts[name],
            "bit_equal": err == 0, "max_abs_err": err,
            "ms": kd, "plain_ms": pd,
            "bound_ms": 1e3 * bound_bytes[name] / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": ld, "timed_by": timed_by,
            "event_ms": ke, "plain_event_ms": pe, "library_event_ms": le,
            "shape": shape})
    # B4's staging (csrc/csr_stream.cuh) runs inside the B3 launch on the
    # megakernel path; its standalone wrapper is not launched there
    kernels[-1]["launches"] = (mega["counts"]["bfs_drain"]
                               if mega["units"] > 0 else 0)
    kernels[-1]["launched_in"] = (f"bfs_drain: {mega['units']} units "
                                  f"staged through csr_stream.cuh")
    kernels[-1]["wrapper_launches"] = mega["counts"]["csr_stream"]
    kernels.append({
        "name": "bfs_drain", "route": "cuda",
        "source": "src/repro_torch/csrc/bfs_drain.cu",
        "replaces": "src/repro/kernels/drain_loop/kernel.py:82",
        "launches": mega["counts"]["bfs_drain"], "bit_equal": b3_err == 0,
        "max_abs_err": b3_err, "ms": b3_ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * bound_bytes["bfs_drain"] / HBM_BYTES_PER_S,
        "bound_by": "bytes", "library_ms": None, "timed_by": b3_timed_by,
        "event_ms": b3_event_ms, "plain_wall_ms": 1e3 * secs_t,
        "rounds": rounds, "units_expanded": mega["units"],
        "shape": f"rmat({args.scale}) drain, W={cfg.wavefront}, budget "
                 f"{budget}, queue int32[{4 * graph.num_vertices}]"})
    for kern in kernels[:-1]:
        log(f"    {kern['name']}: {kern['ms']:.4f} ms (plain "
            f"{kern['plain_ms']:.4f}, library {kern['library_ms']:.4f}, "
            f"bound {kern['bound_ms']:.4f}; between events {kern['event_ms']:.4f}, "
            f"plain {kern['plain_event_ms']:.4f}, library "
            f"{kern['library_event_ms']:.4f})  [{card}]")
    summary = {
        "card": card, "scale": args.scale, "grid_side": side,
        "main": {"n": graph.num_vertices, "m": graph.num_edges,
                 "source": source, "budget": budget, "info": info,
                 "predicated_steps": steps,
                 "first_seconds": {"auto": secs, "torch": secs_p},
                 "warm_seconds": walls, "profiled": profiled},
        "grid_g4": {"info": info_g, "seconds": secs_g,
                    "launches": counts_g},
        "megakernel": {"info": mega["info"], "counts": mega["counts"],
                       "units_expanded": mega["units"],
                       "segments_of_64": mega["segments"],
                       "first_seconds": mega["seconds"],
                       "warm_seconds": mega_walls,
                       "profiled": {"seconds": held["secs"],
                                    "device_ms": mega_dev_ms,
                                    "rows": mega_rows},
                       "plain_full_size": {"seconds": secs_t,
                                           "device_ms": plain_dev_ms,
                                           "rows": plain_rows[:20]},
                       "grid_info": mega["grid_info"],
                       "grid_seconds": mega["grid_seconds"],
                       "small": mega["small"]},
        "kernels": kernels,
    }
    summary["script_seconds"] = time.perf_counter() - started
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    log(f"[6] chip_smoke.py took {summary['script_seconds']:.1f} s  [{card}]")

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
