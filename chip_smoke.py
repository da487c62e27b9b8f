"""Drive the PyTorch/CUDA port end to end on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # full size: rmat scale 21, grid 1024^2
    python3 chip_smoke.py --scale 14 --grid-side 128   # a quick rehearsal

Phases, in order; any failure exits non-zero and prints no result:

  1. require a CUDA device; print the card's name and power limit;
  2. build the kernels from ``src/repro_torch/csrc`` with nvcc (one process
     per source, all at once) and print ptxas's register / shared-memory /
     spill report, and how often B5's library holds the wgmma (``HGMMA``)
     and TMA (``UTMALDG``) instructions in its SASS (``cuobjdump -sass``;
     none of either fails);
  3. hold each kernel bit-equal to its plain PyTorch version on the card, at
     the main path's shapes and at edge sizes (B1 on budgets at and one
     off the scan's total, zero-degree runs longer than its tiles, scan
     entries on a tile's first and last item, a budget of 2^24 and
     coloring's flat budget; B2 three calls in a row and off the 16-byte
     grid, up to N = 2^24); the ordered scatter-add
     bit-equal to the sequential sum at a PageRank round's shape, on one
     index repeated 1e5 times, at each edge of its tiers (segments of 1 to
     1e5 updates, float32 and float64) and on 3,000 segments past 2048 in
     one call, and its float64 instance at k = m (the streaming reseed's
     sum over col_idx) equal to numpy's bincount; B4 also over the slab
     array of the graph's slotted build, at the slotted span SLAB_SLACK
     (budget + 1);
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
  4c. PageRank (damping 0.85, eps 1e-6, check_size 64) on the same graph
     under ``single.megakernel`` as one launch of B3-pr and no other:
     converged (max residue <= eps, no drop), the push invariant within
     its float32 bound, within 1e-3 of a float64 power iteration; under
     ``single.persistent`` through B1, B2 and the ordered scatter-add over
     its first 512 rounds, bitwise equal (state, counters, queue) to the
     megakernel drain cut alike; 64-round segments equal the whole; at
     rmat(14) the kernel drain equals the plain drain run on the CPU and
     a whole persistent drain on the card bit for bit; two megakernel
     drains, B3-pr's device time, busy shares, and the first 64 rounds
     against the plain fused drain on the card (timed) and the first 16
     against the plain drain on the CPU (bitwise); the persistent drain's
     device ops a round over its first 256 rounds;
  4d. coloring on the same graph likewise: persistent (valid, checked on
     the card; backends auto and torch bitwise equal over the first 256
     rounds), megakernel as one launch of B3-col equal to it, queue and
     counters included; segments; at rmat(14) the kernel drain equals the
     plain fused drain;
  4e. the megakernel beyond G = 1, one launch of each program's drain
     kernel and none of B1, B2 or the ordered scatter-add: BFS merge path at
     ``single.megakernel.g4`` on rmat and grid2d against scipy, the
     persistent g4 cell (queue and counters included) and its own 64-round
     segments; BFS per_item at g1 and g4 on grid2d against scipy and the
     persistent per_item cell, at g1 on rmat against scipy and, over its
     first 64 rounds, against the persistent per_item cell and the plain
     fused drain cut alike (their padded rounds at full size); PageRank g4 on
     rmat and grid2d converged within its bounds, equal to the persistent
     g4 cell over its first 512 rounds, segments equal to the whole;
     coloring g4 valid and equal to the persistent g4 cell over its first
     128 rounds; at rmat(14) each configuration's whole drain equal to the
     plain fused drain (PageRank's run on the CPU); one warm drain of each
     cell timed (host clock, device time, busy share) and the kernel
     against its plain version;
  4f. the fused topology and the traced drains (ROADMAP A7, A10): BFS
     ``fused.persistent`` g1 through B1 and B2 on packed items (launch
     counts as in 4, dist equal to scipy, state, RunStats, info equal to
     single.persistent, the final lane its queue packed, no host sync in
     a window); each program's ``fused.megakernel`` g1 as one launch of its
     drain kernel's fused mode, bitwise equal to the single.megakernel
     carries of 4b-4d; BFS and coloring at ``fused.megakernel.g2`` and BFS
     ``.g4`` on grid2d against their single cells; ``fused.*.g4`` on
     rmat(21) refused by admission before any launch; PageRank
     ``fused.persistent`` cut at 512 rounds against single alike; traced
     drains (``Trace()``): BFS persistent (one row a round, rows reconcile
     with the counters), each program's traced single and fused
     megakernel as one launch of the traced mode, equal to the untraced
     drain, BFS's rows equal to the persistent rows and PageRank's first
     512 and coloring's first 128 to the traced persistent drains cut
     alike; the JSONL and Chrome traces written under
     ``chiprun_out/chip_smoke/`` and validated; one warm drain of each
     mode beside the untraced single drain; each mode's first 64 rounds
     against its plain fused drain (PageRank's on the CPU over the first
     16 rounds), and the fused
     traced modes whole at rmat(14) against the plain fused drain;
  4g. streaming graphs (ROADMAP A9, B3-slotted): ``stream_execute`` over
     ``edge_delta_stream(graph, 4, 16384, seed 7)`` with a compaction
     every 2 batches (batches 1 and 3 drain with an overlay), each
     megakernel batch drain one launch of its drain kernel's slotted mode
     and none of B1, B2 or the scatter-add: BFS single.megakernel g1 and
     g4, fused.megakernel g1 and single.persistent g1 against scipy and a
     cold drain on the replayed graph and one another (batch records
     included), cut into 64-round snapshot segments, resumed in-process
     from an older snapshot, and traced (one row a round at absolute
     rounds); PageRank converged, each rank within 2 eps rank / (1 - d)
     + 8 u rank and within 10 eps max(rank, 1) of a cold drain, the push
     invariant within its bound; coloring ``recolor`` equal to a cold
     drain, ``conflicts`` valid for less work; per batch the commit,
     reseed and drain seconds, PageRank's decay sweeps and the commit
     meters, and PageRank's reseed seconds a batch; on batch 1's slotted
     view each drain kernel's slotted mode over the first 64 rounds
     against the discrete cell's plain flat gather (PageRank's over the
     first 16 rounds on the
     CPU), timed beside the canonical mode on the canonical CSR (BFS and
     coloring also whole); at rmat(14) each slotted
     drain whole against the plain fused drain on the CPU; a child process
     killed with SIGKILL in its snapshot hook, resumed here bit for bit;
  4h. the multi-tenant task server (ROADMAP A11): four lanes under the
     ``weighted`` policy at W = 4096 -- BFS on rmat from 4's source and
     from a seeded second source, coloring on rmat, BFS on grid2d from
     vertex 0 -- each granted lane a step through B1 and B2 (and the
     ordered scatter-add for PageRank): BFS dist equal to scipy's, the
     coloring valid, no drop, no misrouted task, the jobs' items summing
     to the server's, the B1/B2 launches those the lane steps imply and no
     drain kernel; rounds, occupancy, wall time, and device ops a round
     and busy share over the first 256 rounds under the profiler.  At
     rmat(14) and grid2d(128) the reference's 8-job mix (PageRank at eps
     1e-6) under ``weighted`` g1 and g4 and ``round_robin`` g1, traced,
     bitwise equal to the same server run on the CPU (a child process a
     cell, one thread each, started after 2; 4h waits for them before it
     measures) -- results, telemetry, stats and trace rows --,
     ``round_robin`` equal to ``serve_sequential``, the fused rounds
     below it; a streaming BFS tenant under ``kernel="megakernel"``: the
     warning, one B3-slotted launch a batch and none for the batch
     tenants, dist equal to a cold drain's; ``Autotuner.tune`` with the
     real runner, then a cache hit that measures nothing; the CLI
     ``python -m repro_torch.launch.taskserver`` as a child process on the
     card, exit 0, fused rounds below sequential;
  4i. the sharded topology (ROADMAP A12), four shards on one card
     (``devices=[cuda:0] * 4``) through ``execute(..., mesh=...)``: BFS
     from 4's source under ``sharded.persistent`` on a 2x2 mesh with
     deferred delivery, the codec and stealing, dist equal to 4's single
     drain, nothing mis-routed or dropped, something donated, the B1 and
     B2 launches those the predicated steps imply (the 1-D strict mesh's
     drain runs in 4j);
     PageRank and coloring on the 1-D mesh over their first 32 rounds
     (launches as implied), PageRank's first 16 rounds bitwise equal to
     the same cell run on the CPU (a child process started after 2),
     coloring's first 16 to the same cell on the plain backend on the
     card; at
     rmat(14) BFS (2x2 with deferred delivery and stealing, under
     ``sharded.discrete``), PageRank and coloring (1-D, persistent)
     drained whole, bitwise equal to the CPU child's runs (state,
     RunStats, info);
  4j. the sharded stream, sharded server jobs, the CLI's sharding flags
     and sharded tracing (ROADMAP A12), four shards on one card: BFS on
     the 1-D mesh over 4g's delta log (``stream_execute``, the partition
     patched per owner after each commit), each batch's dist equal to
     4g's stream's at that batch and batch 0's (the whole drain) to 4's;
     the same BFS as a traced ``JobSpec(shards=4)`` in a ``TaskServer``
     beside a fused tenant, dist equal to 4's, telemetry to batch 0's
     ``ShardRunStats``, one row a shard a round, B1 and B2 as the steps
     imply, its first 32 steps under the profiler; at rmat(14) a traced
     2x2 discrete drain with the codec and stealing and a sharded
     PageRank stream bitwise equal to the CPU child's, a sharded BFS
     stream snapshotted and resumed bit-identical; the sharding CLI
     (``--shards 4 --mesh 2 2 --overlap --compress --stream 2`` with
     ``--shard-devices``) on the card printing the CPU's table;
  5. time each kernel, its plain version and one library call for the same
     function -- device time per call from torch.profiler, and time per
     call of a back-to-back run between CUDA events; B1 also at coloring's
     flat budget, the ordered scatter-add also in float64 at k = m -- and
     the main drain
     on each backend with the host clock (auto, torch, torch, auto), then
     once more each under the profiler for device time, busy share and
     device ops per predicated step; then the megakernel drain beside the
     persistent one (persistent, megakernel, megakernel, persistent), B3's
     device time and the plain fused drain's at full size;
  6. time the flash-attention kernel (B5) at the LM path's per-layer shape,
     its plain version and ``F.scaled_dot_product_attention`` (the library
     call, timed here only; the port never calls it); the bf16 shape runs
     the tensor-core instance (wgmma + TMA, p in three bf16 terms), whose
     SASS counts are printed again, and the CUDA-core instance is timed at
     the same shape in f32;
  7. the LM serving path: minitron-4b at full width and depth in bf16 with
     seeded random weights.  Prefill of 2 x 4096 tokens through
     ``attn_impl="auto"`` must launch B5 exactly once per layer (32), all
     of them its tensor-core instance (the f32 prefill below all of them
     its CUDA-core instance); its
     logits at 64 seeded positions, the last positions and the first 32 of
     sequence 0 are held, with the plain bf16 path's, against an f32
     reference (the same weights upcast, plain path); an f32 prefill through
     B5 must equal the f32 reference far more closely than a path with bf16
     probabilities does.  32 decode steps through the cache replay sequence
     0 against the same reference; the continuous-batching engine answers 8
     requests in ``continuous`` and ``bsp`` mode with the schedule the same
     request lengths give on the CPU at the smoke config; prefill, decode
     and engine times;
  7b. the other model families at full width in bf16 with seeded random
     weights, each freed before the next: olmoe-1b-7b (MoE) whole, prefill
     2 x 4096; falcon-mamba-7b (SSM) whole, 1 x 128; zamba2-1.2b (hybrid)
     whole, 1 x 512; seamless-m4t-medium (encoder-decoder) whole, 2 x 256
     text tokens over 2 x 1536 frames; llava-next-34b (VLM) 8 of its 60
     layers, 2,880 patches + 320 text tokens.  Each prefill through
     ``attn_impl="auto"`` launches B5 as ``B5_PER_PREFILL`` says, all of it
     the tensor-core instance; its logits at seeded positions are held,
     with the plain bf16 path's, against an f32 reference (phase 7's
     bound); decode steps through the bf16 cache (the recurrence for the
     SSM and the hybrid) replay sequence 0 against the same reference.
     For the MoE: the routing flips between the kernel path and the
     reference are counted and bounded, the logits are held where no flip
     came before and, at every position, against a reference routed as the
     kernel path was; the dropped count is printed; the engine in both
     modes keeps the CPU smoke schedule; one decode step under the
     profiler.  Meanwhile ``repro_torch.examples.quickstart`` runs as a
     child on the card and one on the CPU, and every line they print but
     PageRank's error must agree.  kimi-k2-1t (1.04 T parameters) is not
     run: olmoe-1b-7b covers its family;
  8. print each phase's wall, a ``{"kernels": [...]}`` line, the card's
     name and power limit, and, last, ``{"ok": true, "device": {...}}``.

Imports nothing of JAX and nothing of the reference package.  Big outputs
go to ``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
INF = 0x7FFFFFFF


STARTED = time.perf_counter()


#: (phase label, seconds since the start) of each phase's first line
PHASE_STARTS = []


def log(*parts) -> None:
    """Print a line stamped with the seconds since the script started; a
    line that starts with a phase label ("[4c] ...") starts that phase."""
    now = time.perf_counter() - STARTED
    if parts and str(parts[0]).startswith("["):
        PHASE_STARTS.append((str(parts[0]).split("]")[0] + "]", now))
    print(f"{now:7.1f}s", *parts, flush=True)


def phase_walls() -> dict:
    """Seconds from each phase's start to the next one's (the last phase's
    to now)."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter() - STARTED]
    return {label: end - start
            for (label, start), end in zip(PHASE_STARTS, ends)}


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


def device_rows(prof) -> list:
    """``[(device op, total ms, calls), ...]`` of a finished profile: its
    device events summed by name, read straight from the profiler's Kineto
    results.  ``key_averages()`` gives the same sums but first builds a
    Python event tree over every record (about 0.3 ms a record on the card
    host: a minute for 220,000 records)."""
    device = torch.autograd.DeviceType.CUDA
    totals = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != device:
            continue
        ms, calls = totals.get(e.name(), (0.0, 0))
        totals[e.name()] = (ms + e.duration_ns() / 1e6, calls + 1)
    return [(name, ms, calls) for name, (ms, calls) in totals.items()
            if ms > 0]


def device_profile(fn, reps: int = 1):
    """``(device ms per call, [(device op, total ms, calls), ...])`` from
    torch.profiler's CUDA activity over ``reps`` calls, or ``(None, [])``
    when the profiler reports no device time.  A device op is a kernel, a
    copy or a fill.

    The profiler may drop some of the records (on the H100 it kept 15 of
    20 back-to-back launches of one kernel), so a call's time is each
    op's mean recorded time times its launches per call (its recorded
    count over ``reps``, rounded, at least 1), not the total over
    ``reps``.  With ``reps == 1`` that is the total."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = device_rows(prof)
    rows.sort(key=lambda r: -r[1])
    per_call = sum(ms / calls * max(1, round(calls / reps))
                   for _, ms, calls in rows)
    return (per_call if per_call > 0 else None), rows


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
    """B1 against ``lbs_ref`` on the main shape and the edge cases; returns
    the main scan, coloring's (scan, flat budget) and the largest error."""
    from repro_torch.algorithms.coloring import flat_budget
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
    # the ties and the kernel's tiles of 2048 merge items: budgets at and
    # one off the total, zero-degree runs longer than a tile, entries on a
    # tile's first and last item, a budget of 2^24 (tiles past the total)
    ties = np.random.default_rng(3)
    for w in (1, 7, 4096, 2 ** 16):
        d = ties.integers(0, 9, size=w)
        d[::3] = 0
        d[-1] = 5
        scan = torch.as_tensor(np.cumsum(d), dtype=torch.int32, device=dev)
        for delta in (-1, 0, 1):
            cases.append((f"W={w} total{delta:+d}", scan,
                          int(d.sum()) + delta))
    runs = np.zeros(70000, dtype=np.int64)
    runs[::2500] = 3
    runs[4100] = 20000
    for label, d, extra in (
            ("zero-degree runs across tiles", runs, 9000),
            ("entries on each tile's last item", np.full(300, 2047), 5000),
            ("entries on each tile's first item",
             np.r_[2048, np.full(299, 2047)], 100)):
        scan = torch.as_tensor(np.cumsum(d), dtype=torch.int32, device=dev)
        cases.append((label, scan, int(d.sum()) + extra))
    cases.append(("budget 2^24", main_scan, 2 ** 24))
    # coloring's flat gather: the scan of its first round's assign lanes
    # (vertices 0 .. W - 1) at the flat budget, the sum of the W largest
    # degrees
    col_budget = flat_budget(graph, 4096)
    col_scan = torch.cumsum(deg[:4096], 0, dtype=torch.int32)
    cases.append(("coloring g1 flat budget", col_scan, col_budget))
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
    return main_scan, (col_scan, col_budget), err


def check_compact(n_main: int, dev, rng) -> tuple:
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.queue_compact.ref import compact_ref

    cases = [(n_main, p) for p in (0.0, 0.3, 0.99, 1.0)]
    cases += [(n, 0.3) for n in (1, 255, 256, 257, 1023, 1024, 1025, 4095,
                                 4096, 4097, 70001)]
    cases += [(2 ** 24, p) for p in (0.0, 0.3, 1.0)]
    err = 0
    main_inputs = None
    for n, p in cases:
        items = torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31 - 1, size=n),
                                dtype=torch.int32, device=dev)
        mask = torch.as_tensor(rng.random(n) < p, device=dev)
        want = compact_ref(items, mask)
        # three calls in a row (each on fresh zeroed words), then the same
        # items one off the 16-byte grid (the kernel's scalar loads)
        got = [compact_cuda(items, mask) for _ in range(3)]
        odd = compact_cuda(items[1:], mask[1:])
        torch.cuda.synchronize()
        e = max(max(max_abs_err(g, want) for g in got),
                max_abs_err(odd, compact_ref(items[1:], mask[1:])))
        log(f"  B2 compact N={n} p={p}: count={int(got[0][1])} max_abs_err="
            f"{e} (three calls, and the items off the 16-byte grid)")
        if e:
            raise AssertionError(f"compact kernel disagrees with compact_ref "
                                 f"at N={n} p={p}")
        err = max(err, e)
        if n == n_main and p == 0.3:
            main_inputs = (items, mask)
    return main_inputs, err


def check_stream_slotted(graph, budget: int, dev, rng) -> tuple:
    """B4 at its slotted shape (the megakernel streams a chunk's slab span,
    SLAB_SLACK (budget + 1) words from slab_ptr[head] of a slotted view's
    slab array): 48 heads of the graph's slotted build, 1.98 M words each
    at rmat(21), against its plain version; the kernel's int32 guard holds
    against the slab array's length."""
    from repro_torch.graph import SlottedCSR
    from repro_torch.graph.slotted import SLAB_SLACK
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda, stream_row_slices_ref)

    view = SlottedCSR.from_csr(graph).view()
    heads = torch.as_tensor(rng.integers(0, graph.num_vertices, size=48),
                            device=dev)
    starts = view.slab_ptr[heads].contiguous()
    width = SLAB_SLACK * (budget + 1)
    if view.slab_col.shape[0] + width >= 2 ** 31:
        raise AssertionError("the slab array and span exceed B4's int32 "
                             "range")
    got = stream_row_slices_cuda(view.slab_col, starts, width)
    want = stream_row_slices_ref(view.slab_col, starts, width)
    err = max_abs_err((got,), (want,))
    log(f"  B4 csr_stream slotted span: items=48 width={width} from "
        f"slab_ptr, slab array {view.slab_col.shape[0]} words: "
        f"max_abs_err={err}")
    if err or got.shape != want.shape:
        raise AssertionError("the stream kernel over the slab array "
                             "disagrees with stream_row_slices_ref")
    return (view.slab_col, starts, width), err


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
    from repro_torch.kernels.drain_loop.coloring_drain import (
        coloring_drain_cuda)
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda)
    from repro_torch.kernels.drain_loop.pagerank_drain import (
        pagerank_drain_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    return {"lbs": lbs_cuda, "compact": compact_cuda,
            "csr_stream": stream_row_slices_cuda, "bfs_drain": bfs_drain_cuda,
            "flash_attention": flash_attention_cuda,
            "ordered_scatter_add": ordered_scatter_add_cuda,
            "pagerank_drain": pagerank_drain_cuda,
            "coloring_drain": coloring_drain_cuda}


def reset_counts() -> None:
    for wrapper in _wrappers().values():
        wrapper.launches = 0
    flash = _wrappers()["flash_attention"]
    flash.instance_launches = dict.fromkeys(flash.instance_launches, 0)


def flash_instances() -> dict:
    """B5's launches by instance since the counts were last set to 0."""
    return dict(_wrappers()["flash_attention"].instance_launches)


def read_counts() -> dict:
    return {name: w.launches for name, w in _wrappers().items()}


def only(**launches) -> dict:
    """The counts of a run that launched these kernels and no other."""
    return {name: launches.get(name, 0) for name in _wrappers()}


def drain(graph, cfg, source: int) -> tuple:
    """One BFS drain (merge-path, from ``source``) through the public entry
    points: ``run_algo``'s state, RunStats, info and seconds."""
    return run_algo("bfs", graph, cfg, {"source": source,
                                        "strategy": "merge_path"})


def check_megakernel(graph, grid, source: int, persistent: tuple,
                     want: np.ndarray, want_grid: np.ndarray,
                     small_scale: int) -> dict:
    """Phase 4b: the megakernel path against scipy, the persistent drain,
    itself cut into segments, and the plain fused drain."""
    from repro_torch.algorithms.common import default_work_budget
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.runtime import config_for, parse_policy

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
    if counts != only(bfs_drain=1):
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
    params = {"source": source}
    carry_p, _ = drive("bfs", graph, config("single.persistent"), params)
    carry_m, _ = drive("bfs", graph, cfg_m, params)
    if not same_leaves(carry_m, carry_p):
        raise AssertionError(f"megakernel carry differs from the persistent "
                             f"one: {scalars(carry_m)} vs "
                             f"{scalars(carry_p)}")
    log(f"    final queue, dist and counters equal the persistent drain's: "
        f"(head, tail, dropped, rounds, processed, work, splits, counter "
        f"rounds) = {scalars(carry_m)}")

    carry, segments = segmented("bfs", graph, cfg_m, 64, params)
    if not same_leaves(carry, carry_m):
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
    small_params = {"source": small_source}
    carry_k, _ = drive("bfs", small, cfg_k, small_params)
    reset_counts()
    carry_t, _ = drive("bfs", small, cfg_t, small_params)
    if any(read_counts().values()):
        raise AssertionError(f"the plain fused drain launched a kernel: "
                             f"{read_counts()}")
    if not same_leaves(carry_k, carry_t) or not np.array_equal(
            carry_k[1].dist.cpu().numpy(), host_bfs(small, small_source)):
        raise AssertionError("at the small scale the drain kernel differs "
                             "from the plain fused drain or from scipy")
    log(f"    rmat({small_scale}) W={cfg_k.wavefront} budget={small_budget} "
        f"(plain slices {slice_bytes / 2 ** 20:.0f} MiB): the drain kernel "
        f"equals the plain fused drain (backend=torch) and scipy; "
        f"{scalars(carry_k)}")
    return {"state": state, "stats": stats, "info": info, "seconds": secs,
            "counts": counts, "units": units, "carry": carry_m,
            "segments": segments, "grid_info": info_g,
            "grid_seconds": secs_g, "grid_counts": counts_g,
            "small": {"scale": small_scale, "budget": small_budget,
                      "wavefront": cfg_k.wavefront,
                      "carry": scalars(carry_k)}}


# --------------------------------------- phases 3, 4c and 4d: PageRank and
# coloring (the ordered scatter-add, B3-pr and B3-col)
U32 = 2.0 ** -24                   # float32 unit roundoff
PR_PARAMS = {"damping": 0.85, "eps": 1e-6, "check_size": 64}
FIRST_ROUNDS = 64                  # rounds of the kernel-vs-plain timing
# rounds of a full-size PageRank drain kernel held against the plain drain
# on the CPU (the plain scatter-add on the card sums in another order)
HOST_ROUNDS = 16
HOST_PLAIN = f"the plain drain on the CPU, first {HOST_ROUNDS} rounds"


def sequential_sum(base, index, values) -> torch.Tensor:
    """``base`` with each update added in turn, in base's precision: numpy's
    unbuffered ``add.at`` on the host.  (The CPU's ``index_add_`` is in
    order only up to a size: at millions of updates it splits the work
    over threads.)"""
    out = base.cpu().numpy().copy()
    np.add.at(out, index.cpu().numpy(), values.cpu().numpy())
    return torch.from_numpy(out)


SCATTER_TIERS = (1, 2, 8, 9, 64, 65, 2048, 2049, 100_000)


def scatter_cases(graph, budget: int, rng) -> list:
    """``(label, (base, index, values))`` on the card: a PageRank round's
    shape (``budget`` updates, the edges of consecutive rows, into n slots;
    the last tenth idle lanes adding +0.0 at ``lane % n``); one index
    repeated 1e5 times at mixed magnitudes; a slot whose segment has each
    tier edge's length, among updates to 999 others, in float32 and
    float64; 3,000 segments of 2,049 to 2,400 updates, shuffled."""
    n, m = graph.num_vertices, graph.num_edges
    start = int(rng.integers(0, max(m - budget, 1)))
    index = graph.col_idx[start:start + budget].clone()
    k = index.shape[0]
    idle = k // 10
    lanes = torch.arange(k, dtype=torch.int32, device="cuda")
    index[k - idle:] = lanes[k - idle:] % n
    values = torch.as_tensor(rng.random(k).astype(np.float32) * 1e-3,
                             device="cuda")
    values[k - idle:] = 0.0
    base = torch.as_tensor(rng.random(n).astype(np.float32) * 1e-6,
                           device="cuda")
    dup = np.full(100_000, 17)
    dup[::7] = rng.integers(0, 1000, size=len(dup[::7]))
    mixed = rng.standard_normal(dup.size) * 10.0 ** rng.integers(
        -8, 8, size=dup.size)
    cases = [("PageRank round", (base, index, values)),
             ("one index 1e5 times", tuple(torch.as_tensor(x, device="cuda")
                                          for x in (
                 rng.random(1000).astype(np.float32), dup.astype(np.int32),
                 mixed.astype(np.float32))))]
    for dtype in (np.float32, np.float64):
        for length in SCATTER_TIERS:
            size = 2 * length + 100
            tier = rng.integers(0, 1000, size=size)
            tier[tier == 17] = 18
            tier[rng.choice(size, size=length, replace=False)] = 17
            v = rng.standard_normal(size) * 10.0 ** rng.integers(
                -8, 8, size=size)
            cases.append((f"segment of {length} {np.dtype(dtype).name}",
                          tuple(torch.as_tensor(x, device="cuda") for x in (
                              rng.random(1000).astype(dtype),
                              tier.astype(np.int32), v.astype(dtype)))))
    lengths = rng.integers(2049, 2401, size=3000)
    many = rng.permutation(np.repeat(np.arange(3000) * 7, lengths))
    cases.append(("3000 segments past 2048", tuple(
        torch.as_tensor(x, device="cuda") for x in (
            rng.random(21_000).astype(np.float32), many.astype(np.int32),
            (rng.standard_normal(many.size) * 10.0 ** rng.integers(
                -6, 6, size=many.size)).astype(np.float32)))))
    return cases


def check_scatter(graph, budget: int, rng) -> tuple:
    """The ordered scatter-add against the sequential sum, bitwise, on
    ``scatter_cases``, and its float64 instance at k = m (the streaming
    reseed's sum: ``col_idx`` as the index, from zeros) against numpy's
    ``bincount``.  The plain version on CUDA tensors (deterministic
    ``index_put_``) is reported beside the first two cases.  Returns the
    main inputs, the float64 inputs, the kernel's largest error over the
    cases, and the plain version's report."""
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)
    from repro_torch.kernels.scatter_add.ref import ordered_scatter_add_ref

    cases = scatter_cases(graph, budget, rng)
    plain_report, errs = {}, []
    for label, (b, i, v) in cases:
        want = sequential_sum(b, i, v)
        got = ordered_scatter_add_cuda(b, i, v).cpu()
        err = float((got - want).abs().max())
        errs.append(err)
        note = ""
        if len(plain_report) < 2:
            plain = ordered_scatter_add_ref(b, i, v).cpu()
            plain_err = float((plain - want).abs().max())
            plain_report[label] = {"bitwise": bool(torch.equal(plain, want)),
                                   "max_abs_err": plain_err}
            note = (f"; plain on CUDA (deterministic index_put_) bitwise "
                    f"{plain_report[label]['bitwise']}, max_abs_err "
                    f"{plain_err:.3g}")
        log(f"  ordered_scatter_add {label}: {v.shape[0]} updates into "
            f"{b.shape[0]} slots: bitwise {torch.equal(got, want)} "
            f"(max_abs_err {err}){note}")
        if not torch.equal(got, want):
            raise AssertionError(f"ordered_scatter_add differs from the "
                                 f"sequential sum: {label}")
    n, m = graph.num_vertices, graph.num_edges
    f64 = (torch.zeros(n, dtype=torch.float64, device="cuda"), graph.col_idx,
           torch.as_tensor(rng.random(m) * 1e-3, device="cuda"))
    want = np.bincount(f64[1].cpu().numpy(), weights=f64[2].cpu().numpy(),
                       minlength=n)
    got = ordered_scatter_add_cuda(*f64).cpu().numpy()
    err = float(np.abs(got - want).max())
    errs.append(err)
    log(f"  ordered_scatter_add float64 at k = m: {m} updates (col_idx) "
        f"into {n} zeros: bitwise against numpy's bincount "
        f"{np.array_equal(got, want)} (max_abs_err {err})")
    if not np.array_equal(got, want):
        raise AssertionError("the float64 ordered_scatter_add at k = m "
                             "differs from numpy's bincount")
    return cases[0][1], f64, max(errs), plain_report


def algo_config(policy: str, workers: int = 1024, **kw):
    from repro_torch.core import SchedulerConfig
    from repro_torch.runtime import config_for, parse_policy

    return config_for(SchedulerConfig(num_workers=workers, fetch_size=4,
                                      **kw), parse_policy(policy))


def run_algo(algo: str, graph, cfg, params=None) -> tuple:
    """One drain through the public entry points; host-clock seconds
    ending in a device synchronize."""
    from repro_torch.runtime import build_program, execute

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats, info = execute(build_program(algo, graph, cfg,
                                               params=params), graph, cfg)
    torch.cuda.synchronize()
    return state, stats, info, time.perf_counter() - t0


def drive(algo: str, graph, cfg, params=None, limit=None,
          trace=None) -> tuple:
    """``(carry, seconds)`` of one drain set up with ``drain_setup``, so
    that the final queue comes back: the persistent driver, or the
    megakernel cell's kernel (or plain fused drain) with host syncs set to
    raise around a kernel launch.  With a ``trace`` (a ``Trace``) the carry
    has the ring as its fifth leaf."""
    from repro_torch.core import (megakernel_drive, no_host_sync,
                                  persistent_drive)
    from repro_torch.runtime import build_program, policy_of
    from repro_torch.runtime.api import drain_setup

    setup = drain_setup(build_program(algo, graph, cfg, params=params),
                        graph, cfg, trace=trace)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    if policy_of(cfg).kernel != "megakernel":
        carry = persistent_drive(setup.step, setup.cond, setup.carry)
    elif setup.kernel is None:
        carry = megakernel_drive(setup.step, setup.cond, setup.carry,
                                 limit=limit)
    else:
        with no_host_sync(graph.device):
            carry = megakernel_drive(setup.step, setup.cond, setup.carry,
                                     limit=limit, kernel=setup.kernel)
    end.record()
    torch.cuda.synchronize()
    drive.event_ms = start.elapsed_time(end)
    return carry, time.perf_counter() - t0


def leaves(tree) -> list:
    """Every tensor of a state or carry, on the host, in tree order."""
    from repro_torch.core.tree import tree_map

    out = []
    tree_map(lambda t: out.append(t.cpu()), tree)
    return out


def same_leaves(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def lane_queue(queue):
    """The TaskQueue a drain drains: the queue, or a fused carry's lane 0."""
    from repro_torch.core import MultiQueue

    return queue.lane(0) if isinstance(queue, MultiQueue) else queue


def scalars(carry) -> list:
    """The carry's integer scalars: queue (or lane 0) head, tail, dropped,
    rounds, processed, then the state's 0-dim leaves."""
    queue, state, rounds, processed = carry[:4]
    queue = lane_queue(queue)
    return [int(x) for x in (queue.head, queue.tail, queue.dropped, rounds,
                             processed)] + [int(x) for x in leaves(state)
                                            if x.dim() == 0]


def outcome(carry, megakernel: bool) -> tuple:
    """``(state, RunStats, info)`` of a drain's final carry, as ``execute``
    reports them."""
    from repro_torch.core import RunStats

    queue, state, rounds, processed = carry[:4]
    dropped = lane_queue(queue).dropped
    info = {"rounds": int(rounds), "work": int(state.counter.work),
            "dropped": int(dropped), "splits": int(state.counter.splits),
            "launches": 1 if megakernel else int(rounds)}
    return state, RunStats(rounds, processed, dropped), info


def segmented(algo: str, graph, cfg, every: int, params=None) -> tuple:
    """``(carry, segments)`` of the drain cut into launches of ``every``
    rounds through ``megakernel_segment``."""
    from repro_torch.core import megakernel_segment, no_host_sync
    from repro_torch.runtime import build_program
    from repro_torch.runtime.api import drain_setup

    setup = drain_setup(build_program(algo, graph, cfg, params=params),
                        graph, cfg)
    seg = megakernel_segment(setup.step, setup.cond, setup.carry,
                             kernel=setup.kernel)
    carry, limit, segments = setup.carry, 0, 0
    while bool(setup.cond(carry)):
        limit += every
        with no_host_sync(graph.device):
            carry = seg(carry, limit)
        segments += 1
    torch.cuda.synchronize()
    return carry, segments


def pagerank_invariant(graph, state, units: int, work: int) -> dict:
    """The push invariant ``rank + residue = (1-d) + d A^T D^-1 rank`` in
    float64 on the card, with d and 1-d the float32 values the drain used.

    The bound: every value that reaches x_v = rank_v + residue_v only grows
    (mass moves from residue to rank or arrives from neighbors), so each of
    the N_v float32 additions into residue_v, the H_v into rank_v, and the
    multiply and divide of each arriving contribution err by at most
    u * x_v (u = 2**-24), to first order.  Summed over the vertices,
    sum_v |err_v| / x_v <= u * (sum N_v + sum H_v + 2 n) = u * (units +
    work + 2 n): the units the drain expanded and the vertices it
    harvested."""
    n = graph.num_vertices
    d = float(np.float32(PR_PARAMS["damping"]))
    base = float(np.float32(1.0 - PR_PARAMS["damping"]))
    src = torch.repeat_interleave(torch.arange(n, device="cuda"),
                                  graph.degrees().long(),
                                  output_size=graph.num_edges)
    cols = graph.col_idx.long()
    deg = graph.degrees().clamp(min=1).double()
    rank = state.rank.double()
    x = rank + state.residue.double()
    rhs = torch.full((n,), base, dtype=torch.float64,
                     device="cuda").index_add_(0, cols, (d * rank / deg)[src])
    rel = (x - rhs).abs() / x
    bound = U32 * (units + work + 2 * n)
    ref = torch.full((n,), base, dtype=torch.float64, device="cuda")
    for _ in range(300):
        ref = torch.full_like(ref, base).index_add_(0, cols,
                                                    (d * ref / deg)[src])
    ref_err = float(((rank - ref).abs() / ref.clamp(min=1.0)).max())
    return {"sum_rel_err": float(rel.sum()), "max_rel_err": float(rel.max()),
            "bound": bound, "ref_max_rel_err": float(ref_err),
            "ref_limit": 1e-3, "min_x": float(x.min())}


def pagerank_bytes(units, work, processed, rounds, n_check, pushed) -> int:
    """Bytes a PageRank drain must move: per unit its col_idx word and the
    target's residue read and written (12); per harvest two row_ptr words,
    rank and residue read and written, the presence bit (25); per pop its
    ring word (4); per rescan id its residue and presence bit (5); per push
    its ring word (4)."""
    return (12 * units + 25 * work + 4 * processed + 5 * n_check * rounds
            + 4 * pushed)


def coloring_bytes(visits, processed, work, pushed) -> int:
    """Bytes a coloring drain must move: per neighbor visited its col_idx
    word and its color (8); per pop its ring word and two row_ptr words
    (12); per assign its color write (4); per push its ring word (4)."""
    return 8 * visits + 12 * processed + 4 * work + 4 * pushed


def carry_err(a, b) -> float:
    """Largest |a - b| over two carries' leaves, in float64 (inf where
    their shapes or types differ)."""
    la, lb = leaves(a), leaves(b)
    if len(la) != len(lb) or any(x.shape != y.shape or x.dtype != y.dtype
                                 for x, y in zip(la, lb)):
        return float("inf")
    return max((float((x.double() - y.double()).abs().max())
                for x, y in zip(la, lb) if x.numel()), default=0.0)


def first_rounds_times(algo: str, graph, kernel_name: str,
                       suffix: str = "") -> dict:
    """The kernel and the plain fused drain (backend torch) on the same
    inputs, the first FIRST_ROUNDS rounds of the main drain at the policy
    suffix ``suffix`` (``""`` for g1, ``".g4"``): device time by the
    profiler (CUDA events around the whole drive, setup included, beside
    it), and what those rounds moved.  The kernel's carry is held bitwise
    against a plain version at this shape: for coloring the plain drain on
    the card; for PageRank, whose plain scatter-add on CUDA tensors sums in
    another order (kernels/scatter_add/ref.py), the plain drain on the CPU
    over the graph copied there, which sums in update order, both cut at
    HOST_ROUNDS."""
    wrapper = _wrappers()[kernel_name]
    params = PR_PARAMS if algo == "pagerank" else None
    cfg_k = algo_config("single.megakernel" + suffix)
    cfg_t = algo_config("single.megakernel" + suffix, backend="torch")
    carry, _ = drive(algo, graph, cfg_k, params, limit=FIRST_ROUNDS)
    counted = (int(wrapper.units_expanded) if algo == "pagerank"
               else int(wrapper.visits))
    _, k_rows = device_profile(
        lambda: drive(algo, graph, cfg_k, params, limit=FIRST_ROUNDS))
    k_ms, k_timed_by = kernel_device_ms(k_rows, kernel_name, drive.event_ms)
    ev_ms = cuda_ms(lambda: drive(algo, graph, cfg_k, params,
                                  limit=FIRST_ROUNDS), reps=1, warmup=0)
    held = {}
    p_ms, _ = device_profile(lambda: held.update(out=drive(
        algo, graph, cfg_t, params, limit=FIRST_ROUNDS)))
    plain_carry, plain_secs = held["out"]
    if p_ms is None:
        raise AssertionError(f"{algo}: the profiler saw no device time of "
                             f"the plain fused drain")
    timed_by = k_timed_by
    if int(plain_carry[2]) != int(carry[2]):
        raise AssertionError(f"{algo}: the plain fused drain ran "
                             f"{int(plain_carry[2])} rounds, not "
                             f"{int(carry[2])}")
    out = {"carry": carry, "counted": counted, "ms": k_ms,
           "event_ms": ev_ms, "plain_ms": p_ms,
           "plain_wall_ms": 1e3 * plain_secs, "timed_by": timed_by}
    held = carry
    if algo == "coloring":
        plain = plain_carry
        held_against = "the plain fused drain on the card"
    else:
        t0 = time.perf_counter()
        held, _ = drive(algo, graph, cfg_k, params, limit=HOST_ROUNDS)
        plain = host_plain_drain(
            algo, graph.to("cpu"),
            algo_config("single.discrete" + suffix, max_rounds=HOST_ROUNDS),
            params)
        out["cpu_plain_seconds"] = time.perf_counter() - t0
        out["plain_on_cuda_max_abs_err"] = carry_err(carry, plain_carry)
        held_against = HOST_PLAIN
    bitwise, err = same_leaves(held, plain), carry_err(held, plain)
    if not bitwise:
        raise AssertionError(f"{algo}: the drain kernel differs from "
                             f"{held_against}: max |diff| {err}")
    return {**out, "held_against": held_against, "bit_equal": bitwise,
            "max_abs_err": err}


def pagerank_path(graph, card: str, small_scale: int) -> dict:
    """Phase 4c: PageRank on ``graph`` through B3-pr (``single.megakernel``)
    whole, and through B1, B2 and the ordered scatter-add
    (``single.persistent``) over its first PR_CUT rounds: the two cut
    alike held against each other bitwise (queue included), the whole
    kernel drain against the push invariant and a float64 power
    iteration, and against its 64-round segments; at ``small_scale`` the
    kernel drain against the plain drain on the CPU and against a whole
    persistent drain on the card.  The full-size persistent drain is cut:
    whole, it is about a minute of host-bound rounds on an H100."""
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.pagerank_drain import (
        pagerank_drain_cuda)

    cfg_m = algo_config("single.megakernel")
    walls = {"persistent": [], "megakernel": []}
    reset_counts()
    state, stats, info, secs_m = run_algo("pagerank", graph, cfg_m,
                                          PR_PARAMS)
    counts_m = read_counts()
    units = int(pagerank_drain_cuda.units_expanded)
    walls["megakernel"].append(secs_m)
    rounds = info["rounds"]
    max_res = float(state.residue.max())
    log(f"    single.megakernel: counts={counts_m} info={info} units "
        f"expanded {units} max_residue {max_res:.4g}; drain {secs_m:.3f} s"
        f"  [{card}]")
    if counts_m != only(pagerank_drain=1):
        raise AssertionError(f"expected exactly one PageRank drain launch "
                             f"and no other: {counts_m}")
    if not (rounds < cfg_m.max_rounds and max_res <= PR_PARAMS["eps"]
            and info["dropped"] == 0):
        raise AssertionError(f"PageRank did not converge: {info}, "
                             f"max_residue {max_res}")

    # the persistent drain cut at PR_CUT rounds (whole where the drain is
    # shorter), set up by hand as execute sets it up, so that its final
    # queue comes back
    cut = min(PR_CUT, rounds)
    reset_counts()
    carry_p, secs = drive("pagerank", graph, algo_config(
        "single.persistent", max_rounds=cut), PR_PARAMS)
    counts = read_counts()
    walls["persistent"].append(secs)
    steps = -(-int(carry_p[2]) // POLL_EVERY) * POLL_EVERY
    log(f"    single.persistent, first {int(carry_p[2])} rounds: "
        f"counts={counts}; {secs:.3f} s, "
        f"{1e3 * secs / int(carry_p[2]):.3f} ms/round  [{card}]")
    if int(carry_p[2]) != cut or counts != only(
            lbs=steps, compact=2 * steps + 1, ordered_scatter_add=steps):
        raise AssertionError(f"expected {cut} rounds and per predicated "
                             f"step ({steps}) one LBS, one ordered "
                             f"scatter-add and two compactions (the body's "
                             f"push and on_empty's), plus the seed push's "
                             f"compaction, and no other: {counts}")

    # the kernel drain cut alike against the persistent one; then the whole
    # drain again, set up by hand, against the run above
    carry_mc, _ = drive("pagerank", graph, algo_config(
        "single.megakernel", max_rounds=cut), PR_PARAMS)
    same_or_raise(f"PageRank megakernel vs persistent, first {cut} "
                  f"rounds", carry_mc, carry_p)
    log(f"    first {cut} rounds: rank, residue, presence bits, cursor, "
        f"WorkCounter, queue and counters equal the persistent drain's, bit "
        f"for bit: {scalars(carry_mc)}")
    carry_m, secs = drive("pagerank", graph, cfg_m, PR_PARAMS)
    walls["megakernel"].append(secs)
    if not same_leaves(carry_m[1], state) or [
            int(x) for x in (carry_m[2], carry_m[3], carry_m[0].dropped)] \
            != [int(x) for x in stats]:
        raise AssertionError(f"two whole megakernel drains differ: "
                             f"{scalars(carry_m)} vs {info}")

    inv = pagerank_invariant(graph, state, units, int(state.counter.work))
    log(f"    push invariant in float64: sum_v |err_v|/x_v = "
        f"{inv['sum_rel_err']:.4g} <= u (units + work + 2n) = "
        f"{inv['bound']:.4g} (max |err_v|/x_v {inv['max_rel_err']:.3g}); "
        f"max_v |rank - ref| / max(ref, 1) = {inv['ref_max_rel_err']:.3g} "
        f"against 300 float64 power iterations (limit 1e-3)")
    if not (inv["sum_rel_err"] <= inv["bound"]
            and inv["ref_max_rel_err"] <= inv["ref_limit"]):
        raise AssertionError(f"PageRank outside its bounds: {inv}")

    seg_carry, segments = segmented("pagerank", graph, cfg_m, 64, PR_PARAMS)
    if not same_leaves(seg_carry, carry_m):
        raise AssertionError("the PageRank drain cut into 64-round "
                             "segments differs from the whole drain")
    log(f"    {segments} segments of 64 rounds equal the whole drain")

    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    cfg_small = algo_config("single.megakernel", workers=256)
    small_k, _ = drive("pagerank", small, cfg_small, PR_PARAMS)
    host = small.to("cpu")
    cfg_host = algo_config("single.discrete", workers=256)
    t0 = time.perf_counter()
    small_h = host_plain_drain("pagerank", host, cfg_host, PR_PARAMS)
    host_secs = time.perf_counter() - t0
    if not same_leaves(small_k, small_h):
        raise AssertionError(f"at rmat({small_scale}) the PageRank drain "
                             f"kernel differs from the plain drain on the "
                             f"CPU: {scalars(small_k)} vs {scalars(small_h)}")
    small_p, small_secs = drive("pagerank", small, algo_config(
        "single.persistent", workers=256), PR_PARAMS)
    same_or_raise(f"rmat({small_scale}) PageRank persistent vs the drain "
                  f"kernel, whole", small_p, small_k)
    log(f"    rmat({small_scale}) W={cfg_small.wavefront}: the drain kernel "
        f"equals the plain fused drain run on the CPU bit for bit "
        f"({host_secs:.1f} s there) and the whole single.persistent drain "
        f"on the card ({small_secs:.2f} s); {scalars(small_k)}")

    # busy share: the megakernel drain, and the first 256 persistent rounds
    held = {}
    mega_dev_ms, mega_rows = device_profile(
        lambda: held.update(secs=drive("pagerank", graph, cfg_m,
                                       PR_PARAMS)[1]))
    b3_ms = sum(ms for key, ms, _ in mega_rows if "pagerank_drain" in key)
    cut_cfg = algo_config("single.persistent", max_rounds=256)
    held_p = {}
    pers_dev_ms, pers_rows = device_profile(
        lambda: held_p.update(secs=run_algo("pagerank", graph, cut_cfg,
                                            PR_PARAMS)[3]))
    first = first_rounds_times("pagerank", graph, "pagerank_drain")
    fc = first["carry"]
    n_check = min(1024 * PR_PARAMS["check_size"], graph.num_vertices)
    pushed = int(carry_m[0].tail) - int(graph.num_vertices)
    drain_bytes = pagerank_bytes(units, int(state.counter.work),
                                 int(stats.items_processed), rounds, n_check,
                                 pushed)
    first_bytes = pagerank_bytes(
        first["counted"], int(fc[1].counter.work), int(fc[3]), int(fc[2]),
        n_check, int(fc[0].tail) - int(graph.num_vertices))
    out = {"info": info, "counts": counts, "counts_megakernel": counts_m,
           "max_residue": max_res, "units_expanded": units,
           "work_per_n": int(state.counter.work) / graph.num_vertices,
           "walls": walls, "invariant": inv, "segments_of_64": segments,
           "small": {"scale": small_scale, "carry": scalars(small_k),
                     "cpu_seconds": host_secs,
                     "persistent_seconds": small_secs},
           "persistent_cut_rounds": int(carry_p[2]),
           "megakernel_profiled": {"seconds": held["secs"],
                                   "device_ms": mega_dev_ms,
                                   "b3_ms": b3_ms,
                                   "rows": mega_rows[:10]},
           "persistent_first_256": {"seconds": held_p["secs"],
                                    "device_ms": pers_dev_ms,
                                    "device_ops": sum(c for _, _, c in
                                                      pers_rows),
                                    "rows": pers_rows[:10]},
           "drain_bound_ms": 1e3 * drain_bytes / HBM_BYTES_PER_S,
           "first_rounds": {k: v for k, v in first.items() if k != "carry"},
           "first_bound_ms": 1e3 * first_bytes / HBM_BYTES_PER_S,
           "first_rounds_n": int(fc[2])}
    mean_p = sum(walls["persistent"]) / len(walls["persistent"])
    mean_m = sum(walls["megakernel"]) / len(walls["megakernel"])
    log(f"    drains (megakernel twice, whole; persistent once, its first "
        f"{cut} rounds): persistent {walls['persistent']} s, megakernel "
        f"{walls['megakernel']} s; {rounds} rounds, work/n "
        f"{out['work_per_n']:.3f}: {1e3 * mean_p / cut:.3f} vs "
        f"{1e3 * mean_m / rounds:.4f} ms/round  [{card}]")
    log(f"    B3-pr pagerank_drain: {b3_ms:.3f} ms of device time for the "
        f"drain ({1e3 * b3_ms / rounds:.2f} us/round), busy share "
        f"{None if mega_dev_ms is None else mega_dev_ms / (1e3 * held['secs'])}"
        f"; bound {out['drain_bound_ms']:.3f} ms (bytes)  [{card}]")
    log(f"    persistent, first 256 rounds under the profiler: "
        f"{held_p['secs']:.3f} s wall, {pers_dev_ms} ms device, busy share "
        f"{None if pers_dev_ms is None else pers_dev_ms / (1e3 * held_p['secs'])}"
        f", {out['persistent_first_256']['device_ops'] / 256} device ops a "
        f"round  [{card}]")
    log(f"    first {out['first_rounds_n']} rounds: kernel {first['ms']} ms "
        f"(events {first['event_ms']:.3f}), plain fused drain "
        f"{first['plain_ms']} ms device ({first['plain_wall_ms']:.1f} ms "
        f"wall), bound {out['first_bound_ms']:.4f} ms  [{card}]")
    log(f"    first {out['first_rounds_n']} rounds: the kernel's carry "
        f"equals {first['held_against']} bit for bit "
        f"({first['cpu_plain_seconds']:.1f} s there; max |diff| "
        f"{first['max_abs_err']}); the plain drain on the card (another "
        f"summation order) differs by at most "
        f"{first['plain_on_cuda_max_abs_err']:.3g}")
    out["carry"] = carry_m             # for phase 4f; not in the summary
    return out


def host_plain_drain(algo: str, host_graph, cfg, params=None, trace=None):
    """The plain drain on CPU tensors: ``fused_drain_ref`` (kernel B3's
    plain version) over the step of ``cfg``'s cell, whose expansion is the
    flat gather through B1's plain version (equal to the streamed one);
    traced with a ``trace``."""
    from repro_torch.kernels.drain_loop.kernel import fused_drain_ref
    from repro_torch.runtime import build_program
    from repro_torch.runtime.api import drain_setup

    setup = drain_setup(build_program(algo, host_graph, cfg, params=params),
                        host_graph, cfg, trace=trace)
    return fused_drain_ref(setup.step, setup.cond, setup.carry)


def coloring_path(graph, card: str, small_scale: int) -> dict:
    """Phase 4d: coloring on ``graph`` through B1 and B2
    (``single.persistent``, backends auto and torch) and through B3-col
    (``single.megakernel``), valid and held against each other bitwise;
    64-round segments against the whole; the kernel drain at
    ``small_scale`` against the plain fused drain."""
    from repro_torch.algorithms.coloring import validate_coloring
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.coloring_drain import (
        coloring_drain_cuda)

    cfg_p = algo_config("single.persistent")
    cfg_m = algo_config("single.megakernel")
    walls = {"persistent": [], "megakernel": []}
    # one persistent drain gives the state, RunStats, info and final queue,
    # set up by hand as execute sets it up
    reset_counts()
    carry_p, secs = drive("coloring", graph, cfg_p)
    counts = read_counts()
    state, stats, info = outcome(carry_p, megakernel=False)
    walls["persistent"].append(secs)
    rounds = info["rounds"]
    steps = -(-rounds // POLL_EVERY) * POLL_EVERY
    n_colors = int(state.colors.max()) + 1
    log(f"    single.persistent: counts={counts} info={info} colors "
        f"{n_colors}; drain {secs:.3f} s, {1e3 * secs / rounds:.3f} ms/round"
        f"  [{card}]")
    if counts != only(lbs=3 * steps, compact=steps + 1):
        raise AssertionError(f"expected three LBS launches (the two gathers "
                             f"and the free-color search) and one "
                             f"compaction per predicated step ({steps}), "
                             f"plus the seed push's compaction: {counts}")
    if info["dropped"] != 0 or not validate_coloring(graph, state.colors):
        raise AssertionError(f"the coloring is not valid: {info}")
    log("    valid (checked on the card: every vertex colored, no edge "
        "joins one color)")

    reset_counts()
    state_m, stats_m, info_m, secs_m = run_algo("coloring", graph, cfg_m)
    counts_m = read_counts()
    visits = int(coloring_drain_cuda.visits)
    walls["megakernel"].append(secs_m)
    if counts_m != only(coloring_drain=1):
        raise AssertionError(f"expected exactly one coloring drain launch "
                             f"and no other: {counts_m}")
    if not same_leaves(state_m, state) \
            or [int(x) for x in stats_m] != [int(x) for x in stats] \
            or info_m != {**info, "launches": 1}:
        raise AssertionError(f"the megakernel coloring differs from the "
                             f"persistent one: {info_m} vs {info}")
    log(f"    single.megakernel: counts={counts_m}, {visits} neighbor "
        f"visits; colors, WorkCounter, RunStats and info equal the "
        f"persistent drain's; drain {secs_m:.4f} s  [{card}]")
    carry_m, secs = drive("coloring", graph, cfg_m)
    walls["megakernel"].append(secs)
    if not same_leaves(carry_m, carry_p):
        raise AssertionError(f"megakernel carry differs from the persistent "
                             f"one: {scalars(carry_m)} vs {scalars(carry_p)}")
    log(f"    final queue and counters equal the persistent drain's: "
        f"(head, tail, dropped, rounds, processed, work, splits, counter "
        f"rounds) = {scalars(carry_m)}")
    seg_carry, segments = segmented("coloring", graph, cfg_m, 64)
    if not same_leaves(seg_carry, carry_m):
        raise AssertionError("the coloring drain cut into 64-round "
                             "segments differs from the whole drain")
    log(f"    {segments} segments of 64 rounds equal the whole drain")

    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    small_k, _ = drive("coloring", small,
                       algo_config("single.megakernel", workers=256))
    reset_counts()
    small_t, _ = drive("coloring", small,
                       algo_config("single.megakernel", workers=256,
                                   backend="torch"))
    if any(read_counts().values()) or not same_leaves(small_k, small_t):
        raise AssertionError(f"at rmat({small_scale}) the coloring drain "
                             f"kernel differs from the plain fused drain")
    log(f"    rmat({small_scale}) W=1024: the drain kernel equals the plain "
        f"fused drain (backend=torch) bit for bit; {scalars(small_k)}")

    held = {}
    mega_dev_ms, mega_rows = device_profile(
        lambda: held.update(secs=drive("coloring", graph, cfg_m)[1]))
    b3_ms = sum(ms for key, ms, _ in mega_rows if "coloring_drain" in key)
    cut_cfg = algo_config("single.persistent", max_rounds=COL_TORCH_CUT)
    held_p = {}
    pers_dev_ms, pers_rows = device_profile(
        lambda: held_p.update(out=run_algo("coloring", graph, cut_cfg)))
    held_p["secs"] = held_p["out"][3]
    # the plain backend over the same first rounds, bitwise (the whole
    # persistent drain is held against the megakernel drain above)
    reset_counts()
    state_t, stats_t, info_t, secs_t = run_algo(
        "coloring", graph, algo_config("single.persistent", backend="torch",
                                       max_rounds=COL_TORCH_CUT))
    state_c, stats_c, info_c, _ = held_p["out"]
    if any(read_counts().values()) or not same_leaves(state_t, state_c) \
            or info_t != info_c \
            or [int(x) for x in stats_t] != [int(x) for x in stats_c]:
        raise AssertionError("backend='torch' coloring differs or launched "
                             "a kernel")
    log(f"    backend=torch, first {COL_TORCH_CUT} rounds: identical colors, "
        f"counters and RunStats to backend=auto's; {secs_t:.3f} s  [{card}]")
    first = first_rounds_times("coloring", graph, "coloring_drain")
    fc = first["carry"]
    n = graph.num_vertices
    drain_bytes = coloring_bytes(visits, int(stats.items_processed),
                                 int(state.counter.work),
                                 int(carry_m[0].tail) - n)
    first_bytes = coloring_bytes(first["counted"], int(fc[3]),
                                 int(fc[1].counter.work),
                                 int(fc[0].tail) - n)
    out = {"info": info, "counts": counts, "counts_megakernel": counts_m,
           "colors": n_colors, "visits": visits,
           "work_per_n": int(state.counter.work) / n, "walls": walls,
           "torch_first_rounds_seconds": secs_t,
           "segments_of_64": segments,
           "small": {"scale": small_scale, "carry": scalars(small_k)},
           "megakernel_profiled": {"seconds": held["secs"],
                                   "device_ms": mega_dev_ms, "b3_ms": b3_ms,
                                   "rows": mega_rows[:10]},
           "persistent_first_256": {"seconds": held_p["secs"],
                                    "device_ms": pers_dev_ms,
                                    "device_ops": sum(c for _, _, c in
                                                      pers_rows),
                                    "rows": pers_rows[:10]},
           "drain_bound_ms": 1e3 * drain_bytes / HBM_BYTES_PER_S,
           "first_rounds": {k: v for k, v in first.items() if k != "carry"},
           "first_bound_ms": 1e3 * first_bytes / HBM_BYTES_PER_S,
           "first_rounds_n": int(fc[2])}
    mean_p = sum(walls["persistent"]) / len(walls["persistent"])
    mean_m = sum(walls["megakernel"]) / len(walls["megakernel"])
    log(f"    drains (persistent once, the first; megakernel twice, after "
        f"it): persistent {walls['persistent']} s, megakernel "
        f"{walls['megakernel']} s; {rounds} rounds, work/n "
        f"{out['work_per_n']:.3f}, {n_colors} colors: "
        f"{1e3 * mean_p / rounds:.3f} vs {1e3 * mean_m / rounds:.4f} "
        f"ms/round  [{card}]")
    log(f"    B3-col coloring_drain: {b3_ms:.3f} ms of device time for the "
        f"drain ({1e3 * b3_ms / rounds:.2f} us/round), busy share "
        f"{None if mega_dev_ms is None else mega_dev_ms / (1e3 * held['secs'])}"
        f"; bound {out['drain_bound_ms']:.3f} ms (bytes)  [{card}]")
    log(f"    persistent, first 256 rounds under the profiler: "
        f"{held_p['secs']:.3f} s wall, {pers_dev_ms} ms device, busy share "
        f"{None if pers_dev_ms is None else pers_dev_ms / (1e3 * held_p['secs'])}"
        f", {out['persistent_first_256']['device_ops'] / 256} device ops a "
        f"round  [{card}]")
    log(f"    first {out['first_rounds_n']} rounds: kernel {first['ms']} ms "
        f"(events {first['event_ms']:.3f}), plain fused drain "
        f"{first['plain_ms']} ms device ({first['plain_wall_ms']:.1f} ms "
        f"wall), bound {out['first_bound_ms']:.4f} ms  [{card}]")
    log(f"    first {out['first_rounds_n']} rounds: the kernel's carry "
        f"equals {first['held_against']} bit for bit (max |diff| "
        f"{first['max_abs_err']})")
    out["carry"] = carry_m             # for phase 4f; not in the summary
    return out


# rounds of the persistent coloring drain held bitwise between backends
COL_TORCH_CUT = 256


# -------------------------------- phase 4e: the megakernel beyond G = 1
WIDE = ".g4"                       # the policy suffix of the wide cells
PR_CUT = 512                       # rounds of the PageRank cells held bitwise
COL_CUT = 128                      # rounds of the coloring cells held bitwise
PI_CUT = 64                        # rounds of the per_item cells held bitwise
PROFILE_TRIES = 3                  # profiled calls before giving up


def same_or_raise(label: str, got, want) -> None:
    if not same_leaves(got, want):
        raise AssertionError(f"{label}: {scalars(got)} vs {scalars(want)} "
                             f"(max |diff| {carry_err(got, want)})")


def kernel_device_ms(rows, kernel_name: str, events_ms: float,
                     events: str = "CUDA events around the driver call"
                     ) -> tuple:
    """``(ms, timed_by)``: the profiler's device ms of ``kernel_name``'s
    rows, or, where the profiler dropped the launch's record (it drops
    some, see ``device_profile``), ``events_ms``, the same run timed
    between CUDA events, named so that no other time stands in unnamed."""
    ms = sum(t for key, t, _ in rows if kernel_name in key)
    if ms > 0:
        return ms, "profiler device time"
    return events_ms, f"{events} (the profiler dropped the kernel's record)"


def profiled_drive(algo: str, graph, cfg, kernel_name: str | None,
                   params=None, limit=None, trace=None) -> dict:
    """One warm drain under the profiler: host seconds, device ms, the
    kernel's device ms (``kernel_name`` None: the plain drain's whole device
    time), the busy share and the same drain's time between CUDA events.
    The profiler drops records now and then (see ``device_profile``): a
    call it saw no device time of is made again, PROFILE_TRIES times in
    all, and then raises.  The launches of a call made again are taken
    off the counts, so a caller's count window sees the one call kept."""
    for _ in range(PROFILE_TRIES):
        before = read_counts()
        held = {}
        dev_ms, rows = device_profile(lambda: held.update(
            out=drive(algo, graph, cfg, params, limit=limit, trace=trace)))
        if dev_ms is not None:
            break
        log(f"    {algo}: the profiler saw no device time of the call; "
            f"calling again")
        for name, wrapper in _wrappers().items():
            wrapper.launches = before[name]
    else:
        raise AssertionError(f"{algo}: the profiler saw no device time in "
                             f"{PROFILE_TRIES} tries")
    carry, secs = held["out"]
    timed_by = "profiler device time"
    k_ms, busy = dev_ms, dev_ms / (1e3 * secs)
    if kernel_name is not None:
        k_ms, timed_by = kernel_device_ms(rows, kernel_name, drive.event_ms)
        if timed_by != "profiler device time":
            busy = None                # the device total lacks the kernel
    return {"carry": carry, "seconds": secs, "device_ms": dev_ms,
            "kernel_ms": k_ms, "timed_by": timed_by, "busy_share": busy,
            "event_ms": drive.event_ms, "rows": rows[:8]}


def paired_ms(a: dict, b: dict) -> tuple:
    """``(a_ms, b_ms, timed_by)`` of two ``profiled_drive`` results on one
    clock: both kernels' profiler device times where the profiler kept
    both records, else both drains' times between CUDA events."""
    if a["timed_by"] == b["timed_by"] == "profiler device time":
        return a["kernel_ms"], b["kernel_ms"], "profiler device time"
    return (a["event_ms"], b["event_ms"],
            "CUDA events around both driver calls (the profiler dropped a "
            "kernel's record)")


def bfs_bytes(units: int, carry) -> int:
    """Bytes a BFS drain must move: per unit its col_idx word and dist[nbr]
    (8); per pop its ring word and two row_ptr words (12); per push its
    ring word (4)."""
    return (8 * units + 12 * int(carry[3])
            + 4 * int(lane_queue(carry[0]).tail))


def per_item_cut(graph, params, card: str) -> dict:
    """BFS per_item g1 at the main path's size, cut at PI_CUT rounds: the
    drain kernel, the persistent per_item cell and the plain fused drain
    (backend torch), bit for bit (dist, RunStats, counters with splits,
    final queue); the kernel and the plain drain timed over those rounds.
    Both plain forms pad each round to [W, max_degree] lanes."""
    from repro_torch.algorithms.common import max_degree_of
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda

    cfg_k = algo_config("single.megakernel", max_rounds=PI_CUT)
    reset_counts()
    kern = profiled_drive("bfs", graph, cfg_k, "bfs_drain", params)
    counts = read_counts()
    units = int(bfs_drain_cuda.units_expanded)
    if counts != only(bfs_drain=1):
        raise AssertionError(f"per_item g1 cut: expected one BFS drain "
                             f"launch and no other, got {counts}")
    torch.cuda.reset_peak_memory_stats()
    carry_p, secs_p = drive("bfs", graph, algo_config(
        "single.persistent", max_rounds=PI_CUT), params)
    peak = torch.cuda.max_memory_allocated()
    same_or_raise(f"per_item g1 rmat, {PI_CUT} rounds, megakernel vs "
                  f"persistent", kern["carry"], carry_p)
    plain = profiled_drive("bfs", graph, algo_config(
        "single.megakernel", max_rounds=PI_CUT, backend="torch"), None,
        params)
    same_or_raise(f"per_item g1 rmat, {PI_CUT} rounds, kernel vs the plain "
                  f"fused drain", kern["carry"], plain["carry"])
    torch.cuda.empty_cache()           # the padded rounds' cached blocks
    carry = kern["carry"]
    out = {"carry": scalars(carry), "rounds": int(carry[2]), "units": units,
           "counts": counts, "kernel_ms": kern["kernel_ms"],
           "timed_by": kern["timed_by"], "kernel_seconds": kern["seconds"],
           "plain_ms": plain["device_ms"], "plain_seconds": plain["seconds"],
           "persistent_seconds": secs_p, "persistent_peak_bytes": peak,
           "padded_tensor_bytes": 4 * cfg_k.wavefront * max_degree_of(graph),
           "max_abs_err": carry_err(carry, plain["carry"]),
           "bound_bytes": bfs_bytes(units, carry)}
    log(f"    BFS per_item g1 rmat, the first {out['rounds']} rounds "
        f"(max_rounds {PI_CUT}): the drain kernel equals single.persistent "
        f"per_item and the plain fused drain bit for bit, queue and counters "
        f"included (splits {out['carry'][6]}); kernel {out['kernel_ms']:.3f}"
        f" ms, plain fused drain {out['plain_ms']:.3f} ms device "
        f"({out['plain_seconds']:.3f} s host), bound "
        f"{1e3 * out['bound_bytes'] / HBM_BYTES_PER_S:.4f} ms; persistent "
        f"{secs_p:.3f} s, peak {peak / 2 ** 30:.2f} GiB allocated (padded "
        f"int32 round {out['padded_tensor_bytes'] / 2 ** 30:.2f} GiB)  "
        f"[{card}]")
    return out


def wide_bfs(graph, grid, source: int, want, want_grid, card: str,
             small_scale: int, grid_persistent: tuple) -> dict:
    """Phase 4e, BFS: merge path at g4 and per_item at g1 and g4 through
    the BFS drain kernel, against scipy, the persistent cells (on grid2d
    [4]'s ``single.persistent.g4`` drain, ``grid_persistent``), segments
    and the plain fused drain."""
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda

    out = {}
    for label, g, src, want_d in (("rmat", graph, source, want),
                                  ("grid2d", grid, 0, want_grid)):
        params = {"source": src}
        if label == "grid2d":
            carry_p, secs_p = grid_persistent
        else:
            carry_p, secs_p = drive("bfs", g, algo_config(
                "single.persistent" + WIDE), params)
        reset_counts()
        carry_m, secs_m = drive("bfs", g,
                                algo_config("single.megakernel" + WIDE),
                                params)
        counts = read_counts()
        units = int(bfs_drain_cuda.units_expanded)
        if counts != only(bfs_drain=1):
            raise AssertionError(f"BFS g4 {label}: expected one BFS drain "
                                 f"launch and no other, got {counts}")
        if int(carry_m[0].dropped) or not np.array_equal(
                carry_m[1].dist.cpu().numpy(), want_d):
            raise AssertionError(f"BFS g4 {label}: dist differs from scipy "
                                 f"or items were dropped")
        same_or_raise(f"BFS g4 {label} megakernel vs persistent", carry_m,
                      carry_p)
        seg, segments = segmented("bfs", g, algo_config("single.megakernel"
                                                        + WIDE), 64, params)
        same_or_raise(f"BFS g4 {label} segments vs whole", seg, carry_m)
        out[label] = {"carry": scalars(carry_m), "units": units,
                      "counts": counts, "persistent_seconds": secs_p,
                      "megakernel_seconds": secs_m, "segments_of_64":
                      segments}
        if label == "grid2d":               # rmat's warm drain is below
            warm = profiled_drive("bfs", g, algo_config(
                "single.megakernel" + WIDE), "bfs_drain", params)
            same_or_raise("BFS g4 grid2d: two drains", warm["carry"],
                          carry_m)
            out[label]["timing"] = {k: v for k, v in warm.items()
                                    if k != "carry"}
            log(f"    BFS g4 grid2d warm: {warm['seconds']:.4f} s host, "
                f"bfs_drain {warm['kernel_ms']:.3f} ms device, busy share "
                f"{warm['busy_share']}  [{card}]")
        log(f"    BFS merge_path single.megakernel.g4 {label}: one "
            f"bfs_drain launch, dist equals scipy; dist, RunStats, counters "
            f"(splits {scalars(carry_m)[6]}) and final queue equal "
            f"single.persistent.g4; {segments} segments of 64 rounds equal "
            f"the whole; {int(carry_m[2])} rounds, {units} units; "
            f"persistent {secs_p:.3f} s, megakernel {secs_m:.4f} s  [{card}]")

    # the g4 drain timed: warm, under the profiler, and the plain fused
    # drain (backend torch, the plain stream) at full size beside it
    params = {"source": source}
    cfg_k = algo_config("single.megakernel" + WIDE)
    warm = profiled_drive("bfs", graph, cfg_k, "bfs_drain", params)
    plain = profiled_drive("bfs", graph, algo_config("single.megakernel"
                                                     + WIDE, backend="torch"),
                           None, params)
    same_or_raise("BFS g4 kernel vs the plain fused drain", warm["carry"],
                  plain["carry"])
    carry_m = warm["carry"]
    out["timing"] = {k: v for k, v in warm.items() if k != "carry"}
    out["plain"] = {"seconds": plain["seconds"],
                    "device_ms": plain["device_ms"], "rows": plain["rows"],
                    "max_abs_err": carry_err(carry_m, plain["carry"])}
    out["bound_bytes"] = bfs_bytes(out["rmat"]["units"], carry_m)
    log(f"    BFS g4 rmat warm: {warm['seconds']:.4f} s host, bfs_drain "
        f"{warm['kernel_ms']:.3f} ms device ({warm['timed_by']}), busy "
        f"share {warm['busy_share']}; plain fused drain {plain['seconds']:.3f}"
        f" s host, {plain['device_ms']} ms device, equal bit for bit  "
        f"[{card}]")

    # per_item: grid2d whole at g1 and g4 against the persistent per_item
    # cell and scipy; rmat whole at g1 against scipy, timed
    for G in (1, 4):
        suffix = "" if G == 1 else WIDE
        params = {"source": 0, "strategy": "per_item"}
        carry_p, _ = drive("bfs", grid, algo_config("single.persistent"
                                                    + suffix), params)
        reset_counts()
        carry_m, secs = drive("bfs", grid, algo_config("single.megakernel"
                                                       + suffix), params)
        counts = read_counts()
        if counts != only(bfs_drain=1) or not np.array_equal(
                carry_m[1].dist.cpu().numpy(), want_grid):
            raise AssertionError(f"per_item g{G} grid2d: {counts} or dist "
                                 f"differs from scipy")
        same_or_raise(f"per_item g{G} grid2d megakernel vs persistent",
                      carry_m, carry_p)
        warm = profiled_drive("bfs", grid, algo_config(
            "single.megakernel" + suffix), "bfs_drain", params)
        same_or_raise(f"per_item g{G} grid2d: two drains", warm["carry"],
                      carry_m)
        out[f"per_item_grid_g{G}"] = {
            "carry": scalars(carry_m), "seconds": secs,
            "timing": {k: v for k, v in warm.items() if k != "carry"}}
        log(f"    BFS per_item single.megakernel g{G} grid2d: one launch, "
            f"equals scipy and single.persistent per_item g{G} (queue "
            f"included); {int(carry_m[2])} rounds, {secs:.4f} s; warm "
            f"{warm['seconds']:.4f} s host, bfs_drain "
            f"{warm['kernel_ms']:.3f} ms device, busy share "
            f"{warm['busy_share']}  [{card}]")
    params = {"source": source, "strategy": "per_item"}
    reset_counts()
    carry_m, secs = drive("bfs", graph, algo_config("single.megakernel"),
                          params)
    counts = read_counts()
    units = int(bfs_drain_cuda.units_expanded)
    if counts != only(bfs_drain=1) or int(carry_m[0].dropped) \
            or not np.array_equal(carry_m[1].dist.cpu().numpy(), want):
        raise AssertionError(f"per_item g1 rmat: {counts} or dist differs "
                             f"from scipy")
    warm = profiled_drive("bfs", graph, algo_config("single.megakernel"),
                          "bfs_drain", params)
    same_or_raise("per_item g1 rmat: two drains", warm["carry"], carry_m)
    out["per_item_rmat_g1"] = {
        "carry": scalars(carry_m), "units": units, "first_seconds": secs,
        "counts": counts,
        "timing": {k: v for k, v in warm.items() if k != "carry"},
        "bound_bytes": bfs_bytes(units, carry_m)}
    log(f"    BFS per_item single.megakernel g1 rmat: one launch, dist "
        f"equals scipy; {int(carry_m[2])} rounds, {units} units; warm "
        f"{warm['seconds']:.4f} s host, bfs_drain {warm['kernel_ms']:.3f} ms "
        f"device, busy share {warm['busy_share']}  [{card}]")
    out["per_item_rmat_g1"]["cut"] = per_item_cut(graph, params, card)

    # rmat(small): each configuration whole against the plain fused drain,
    # and per_item against its persistent cell too
    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    small_source = int(torch.argmax(small.degrees()))
    want_small = host_bfs(small, small_source)
    for name, suffix, strategy in (("merge_path g4", WIDE, "merge_path"),
                                   ("per_item g1", "", "per_item"),
                                   ("per_item g4", WIDE, "per_item")):
        params = {"source": small_source, "strategy": strategy}
        cfg_k = algo_config("single.megakernel" + suffix, workers=256)
        warm = profiled_drive("bfs", small, cfg_k, "bfs_drain", params)
        reset_counts()
        plain = profiled_drive("bfs", small, algo_config(
            "single.megakernel" + suffix, workers=256, backend="torch"), None,
            params)
        if any(read_counts().values()):
            raise AssertionError("the plain fused drain launched a kernel")
        same_or_raise(f"rmat({small_scale}) BFS {name} kernel vs plain",
                      warm["carry"], plain["carry"])
        if not np.array_equal(warm["carry"][1].dist.cpu().numpy(),
                              want_small):
            raise AssertionError(f"rmat({small_scale}) BFS {name}: dist "
                                 f"differs from scipy")
        if strategy == "per_item":
            carry_p, _ = drive("bfs", small, algo_config(
                "single.persistent" + suffix, workers=256), params)
            same_or_raise(f"rmat({small_scale}) BFS {name} vs persistent",
                          warm["carry"], carry_p)
        carry = warm["carry"]
        out[f"small {name}"] = {
            "carry": scalars(carry), "kernel_ms": warm["kernel_ms"],
            "timed_by": warm["timed_by"], "plain_ms": plain["device_ms"],
            "plain_seconds": plain["seconds"],
            "units": int(bfs_drain_cuda.units_expanded),
            "max_abs_err": carry_err(carry, plain["carry"])}
        also = (" and the persistent per_item cell"
                if strategy == "per_item" else "")
        log(f"    rmat({small_scale}) W=1024 BFS {name}: the drain kernel "
            f"equals the plain fused drain bit for bit{also} and scipy; kernel {warm['kernel_ms']:.3f} ms, plain "
            f"{plain['device_ms']} ms device; {scalars(carry)}  [{card}]")
    return out


def wide_pagerank(graph, grid, card: str, small_scale: int) -> dict:
    """Phase 4e, PageRank at g4 through B3-pr: converged within its bounds,
    bitwise equal to the persistent g4 cell cut at PR_CUT rounds, segments
    equal to the whole; at rmat(small) equal to the plain drain on the
    CPU; the first rounds timed against the plain fused drain."""
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.pagerank_drain import (
        pagerank_drain_cuda)

    out = {}
    cfg_m = algo_config("single.megakernel" + WIDE)
    for label, g in (("rmat", graph), ("grid2d", grid)):
        reset_counts()
        state, stats, info, secs = run_algo("pagerank", g, cfg_m, PR_PARAMS)
        counts = read_counts()
        units = int(pagerank_drain_cuda.units_expanded)
        max_res = float(state.residue.max())
        if counts != only(pagerank_drain=1) or info["launches"] != 1:
            raise AssertionError(f"PageRank g4 {label}: expected one "
                                 f"PageRank drain launch, got {counts}")
        if not (info["rounds"] < cfg_m.max_rounds
                and max_res <= PR_PARAMS["eps"] and info["dropped"] == 0):
            raise AssertionError(f"PageRank g4 {label} did not converge: "
                                 f"{info}, max_residue {max_res}")
        inv = pagerank_invariant(g, state, units, int(state.counter.work))
        if not (inv["sum_rel_err"] <= inv["bound"]
                and inv["ref_max_rel_err"] <= inv["ref_limit"]):
            raise AssertionError(f"PageRank g4 {label} outside its bounds: "
                                 f"{inv}")
        cut_m, _ = drive("pagerank", g, algo_config(
            "single.megakernel" + WIDE, max_rounds=PR_CUT), PR_PARAMS)
        cut_p, secs_p = drive("pagerank", g, algo_config(
            "single.persistent" + WIDE, max_rounds=PR_CUT), PR_PARAMS)
        same_or_raise(f"PageRank g4 {label} megakernel vs persistent, "
                      f"{PR_CUT} rounds", cut_m, cut_p)
        whole = profiled_drive("pagerank", g, cfg_m, "pagerank_drain",
                               PR_PARAMS)
        if not same_leaves(whole["carry"][1], state):
            raise AssertionError(f"PageRank g4 {label}: two drains differ")
        seg, segments = segmented("pagerank", g, cfg_m, 64, PR_PARAMS)
        same_or_raise(f"PageRank g4 {label} segments vs whole", seg,
                      whole["carry"])
        carry = whole["carry"]
        n_check = min(1024 * PR_PARAMS["check_size"], g.num_vertices)
        out[label] = {
            "info": info, "counts": counts, "units": units,
            "max_residue": max_res, "invariant": inv,
            "work_per_n": int(state.counter.work) / g.num_vertices,
            "first_seconds": secs, "segments_of_64": segments,
            "persistent_cut_seconds": secs_p,
            "timing": {k: v for k, v in whole.items() if k != "carry"},
            "bound_bytes": pagerank_bytes(
                units, int(state.counter.work), int(stats.items_processed),
                info["rounds"], n_check,
                int(carry[0].tail) - g.num_vertices)}
        log(f"    PageRank single.megakernel.g4 {label}: one pagerank_drain "
            f"launch, {info['rounds']} rounds, splits {info['splits']}, "
            f"converged (max residue {max_res:.3g}); invariant "
            f"{inv['sum_rel_err']:.4g} <= {inv['bound']:.4g}, "
            f"{inv['ref_max_rel_err']:.3g} from float64 (limit 1e-3); the "
            f"first {PR_CUT} rounds equal single.persistent.g4's bit for bit "
            f"(persistent {secs_p:.2f} s); {segments} segments of 64 rounds "
            f"equal the whole; warm {whole['seconds']:.3f} s host, "
            f"pagerank_drain {whole['kernel_ms']:.3f} ms device, busy share "
            f"{whole['busy_share']}  [{card}]")

    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    small_k, _ = drive("pagerank", small, algo_config(
        "single.megakernel" + WIDE, workers=256), PR_PARAMS)
    t0 = time.perf_counter()
    small_h = host_plain_drain("pagerank", small.to("cpu"), algo_config(
        "single.discrete" + WIDE, workers=256), PR_PARAMS)
    host_secs = time.perf_counter() - t0
    same_or_raise(f"rmat({small_scale}) PageRank g4 kernel vs the plain "
                  f"drain on the CPU", small_k, small_h)
    log(f"    rmat({small_scale}) W=1024 PageRank g4: the drain kernel "
        f"equals the plain fused drain run on the CPU bit for bit "
        f"({host_secs:.1f} s there); {scalars(small_k)}  [{card}]")
    out["small"] = {"carry": scalars(small_k), "cpu_seconds": host_secs}
    first = first_rounds_times("pagerank", graph, "pagerank_drain", WIDE)
    fc = first["carry"]
    n_check = min(1024 * PR_PARAMS["check_size"], graph.num_vertices)
    out["first_rounds"] = {k: v for k, v in first.items() if k != "carry"}
    out["first_bound_ms"] = 1e3 * pagerank_bytes(
        first["counted"], int(fc[1].counter.work), int(fc[3]), int(fc[2]),
        n_check, int(fc[0].tail) - graph.num_vertices) / HBM_BYTES_PER_S
    log(f"    PageRank g4 first {FIRST_ROUNDS} rounds: kernel "
        f"{first['ms']} ms, plain fused drain {first['plain_ms']} ms "
        f"device, bound {out['first_bound_ms']:.4f} ms; the kernel's carry "
        f"equals {first['held_against']} bit for bit  [{card}]")
    return out


def wide_coloring(graph, card: str, small_scale: int) -> dict:
    """Phase 4e, coloring at g4 through B3-col: valid, equal to the
    persistent g4 cell cut at COL_CUT rounds; at rmat(small) equal to the
    plain fused drain; the first rounds timed against it."""
    from repro_torch.algorithms.coloring import validate_coloring
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.coloring_drain import (
        coloring_drain_cuda)

    cfg_m = algo_config("single.megakernel" + WIDE)
    reset_counts()
    state, stats, info, secs = run_algo("coloring", graph, cfg_m)
    counts = read_counts()
    visits = int(coloring_drain_cuda.visits)
    if counts != only(coloring_drain=1) or info["launches"] != 1:
        raise AssertionError(f"coloring g4: expected one coloring drain "
                             f"launch, got {counts}")
    if info["dropped"] or not validate_coloring(graph, state.colors):
        raise AssertionError(f"coloring g4 is not valid: {info}")
    cut_m, _ = drive("coloring", graph, algo_config(
        "single.megakernel" + WIDE, max_rounds=COL_CUT))
    cut_p, secs_p = drive("coloring", graph, algo_config(
        "single.persistent" + WIDE, max_rounds=COL_CUT))
    same_or_raise(f"coloring g4 megakernel vs persistent, {COL_CUT} rounds",
                  cut_m, cut_p)
    whole = profiled_drive("coloring", graph, cfg_m, "coloring_drain")
    if not same_leaves(whole["carry"][1], state):
        raise AssertionError("coloring g4: two drains differ")
    carry = whole["carry"]
    n = graph.num_vertices
    out = {"info": info, "counts": counts, "visits": visits,
           "colors": int(state.colors.max()) + 1,
           "work_per_n": int(state.counter.work) / n, "first_seconds": secs,
           "persistent_cut_seconds": secs_p,
           "timing": {k: v for k, v in whole.items() if k != "carry"},
           "bound_bytes": coloring_bytes(visits, int(stats.items_processed),
                                         int(state.counter.work),
                                         int(carry[0].tail) - n)}
    log(f"    coloring single.megakernel.g4 rmat: one coloring_drain launch, "
        f"valid, {out['colors']} colors, {info['rounds']} rounds, splits "
        f"{info['splits']}; the first {COL_CUT} rounds equal "
        f"single.persistent.g4's, queue and counters included (persistent "
        f"{secs_p:.2f} s); warm {whole['seconds']:.4f} s host, "
        f"coloring_drain {whole['kernel_ms']:.3f} ms device, busy share "
        f"{whole['busy_share']}  [{card}]")

    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    small_k, _ = drive("coloring", small, algo_config(
        "single.megakernel" + WIDE, workers=256))
    reset_counts()
    small_t, _ = drive("coloring", small, algo_config(
        "single.megakernel" + WIDE, workers=256, backend="torch"))
    if any(read_counts().values()):
        raise AssertionError("the plain fused drain launched a kernel")
    same_or_raise(f"rmat({small_scale}) coloring g4 kernel vs plain",
                  small_k, small_t)
    log(f"    rmat({small_scale}) W=1024 coloring g4: the drain kernel equals "
        f"the plain fused drain bit for bit; {scalars(small_k)}  [{card}]")
    out["small"] = {"carry": scalars(small_k)}
    first = first_rounds_times("coloring", graph, "coloring_drain", WIDE)
    fc = first["carry"]
    out["first_rounds"] = {k: v for k, v in first.items() if k != "carry"}
    out["first_bound_ms"] = 1e3 * coloring_bytes(
        first["counted"], int(fc[3]), int(fc[1].counter.work),
        int(fc[0].tail) - n) / HBM_BYTES_PER_S
    log(f"    coloring g4 first {FIRST_ROUNDS} rounds: kernel {first['ms']} "
        f"ms, plain fused drain {first['plain_ms']} ms device, bound "
        f"{out['first_bound_ms']:.4f} ms; equal bit for bit  [{card}]")
    return out


# ------------- phase 4f: the fused topology and the traced drains (A7, A10)
TRACE_CAPACITY = 16384             # rows: at least PageRank's g1 rounds
ROW_BYTES = 4 * 13                 # one trace row (obs/schema.TRACE_FIELDS)
DRAINS = {"bfs": "bfs_drain", "pagerank": "pagerank_drain",
          "coloring": "coloring_drain"}


def fused_equals_single(fused, single) -> bool:
    """A fused carry against a single one: state, rounds and processed
    equal, the lane's cursors the queue's, and every slot of the lane the
    queue's task packed with job 0 (EMPTY where the queue was never
    written)."""
    from repro_torch.core import EMPTY
    from repro_torch.server.encoding import pack

    lane, queue = lane_queue(fused[0]), single[0]
    want = torch.where(queue.buf == EMPTY, EMPTY, pack(0, queue.buf))
    return (torch.equal(lane.buf, want)
            and [int(x) for x in (lane.head, lane.tail, lane.dropped)]
            == [int(x) for x in (queue.head, queue.tail, queue.dropped)]
            and same_leaves(tuple(fused[1:4]), tuple(single[1:4])))


def rows_of(ring) -> list:
    from repro_torch.obs import ring_rows

    rows, truncated = ring_rows(ring)
    if truncated:
        raise AssertionError(f"the trace ring dropped {truncated} rows")
    return rows


def traced_rows(algo: str, graph, cfg, params=None) -> tuple:
    """``(carry, rows)`` of a traced drain (``drive`` with a Trace)."""
    from repro_torch.obs import Trace

    carry, _ = drive(algo, graph, cfg, params,
                     trace=Trace(capacity=TRACE_CAPACITY))
    return carry, rows_of(carry[4])


def mode_first_rounds(algo: str, graph, policy: str, params,
                      traced: bool) -> dict:
    """A drain kernel's mode over the first FIRST_ROUNDS rounds of the
    main drain: the kernel (device time by the profiler) and the plain
    fused drain over the same (fused or traced) step, backend torch, on
    the card, held bitwise -- for PageRank, whose plain scatter-add on the
    card sums in another order, against the plain drain on the CPU, both
    cut at HOST_ROUNDS."""
    from repro_torch.obs import Trace

    def trace():
        return Trace(capacity=TRACE_CAPACITY) if traced else None

    name = DRAINS[algo]
    wrapper = _wrappers()[name]
    reset_counts()
    kern = profiled_drive(algo, graph, algo_config(policy), name, params,
                          limit=FIRST_ROUNDS, trace=trace())
    counts = read_counts()
    if counts != only(**{name: 1}):
        raise AssertionError(f"{algo} {policy}: expected one {name} launch "
                             f"and no other, got {counts}")
    counted = (int(wrapper.visits) if algo == "coloring"
               else int(wrapper.units_expanded))
    plain = profiled_drive(algo, graph, algo_config(policy, backend="torch"),
                           None, params, limit=FIRST_ROUNDS, trace=trace())
    carry = kern["carry"]
    if algo == "pagerank":
        # the discrete cell's step, whose flat gather is far cheaper on the
        # CPU than the plain stream (host_plain_drain)
        t0 = time.perf_counter()
        held, _ = drive(algo, graph, algo_config(policy), params,
                        limit=HOST_ROUNDS, trace=trace())
        want = host_plain_drain(algo, graph.to("cpu"), algo_config(
            policy.replace("megakernel", "discrete"),
            max_rounds=HOST_ROUNDS), params, trace=trace())
        cpu_secs = time.perf_counter() - t0
        held_against = HOST_PLAIN
    else:
        held, want, cpu_secs = carry, plain["carry"], None
        held_against = "the plain fused drain on the card"
    same_or_raise(f"{algo} {policy}{' traced' if traced else ''}, kernel vs "
                  f"{held_against}", held, want)
    n = graph.num_vertices
    rounds = int(carry[2])
    pushed = int(lane_queue(carry[0]).tail) - (
        0 if algo == "bfs" else n)
    if algo == "bfs":
        moved = bfs_bytes(counted, carry)
    elif algo == "pagerank":
        n_check = min(1024 * PR_PARAMS["check_size"], n)
        moved = pagerank_bytes(counted, int(carry[1].counter.work),
                               int(carry[3]), rounds, n_check, pushed)
    else:
        moved = coloring_bytes(counted, int(carry[3]),
                               int(carry[1].counter.work), pushed)
    moved += ROW_BYTES * rounds if traced else 0
    return {"carry": carry, "counts": counts, "rounds": rounds,
            "kernel_ms": kern["kernel_ms"], "timed_by": kern["timed_by"],
            "plain_ms": plain["device_ms"], "plain_seconds": plain["seconds"],
            "cpu_plain_seconds": cpu_secs, "held_against": held_against,
            "max_abs_err": carry_err(held, want),
            "bound_bytes": moved}


def fused_and_traced(graph, grid, source: int, want, want_grid, mega: dict,
                     pr: dict, col: dict, single: tuple, card: str,
                     small_scale: int) -> dict:
    """Phase 4f: the fused topology (BFS persistent through B1 and B2 on
    packed items; each program's megakernel as one launch of its drain
    kernel's fused mode, g1 and g2, and BFS g4 on grid2d; g4 refused at
    rmat(21) by the admission check) and the traced drains (persistent,
    and each megakernel as one launch of the kernel's traced mode), held
    against the single cells of phases 4-4d, scipy, the traced persistent
    rows and the plain fused drains; their files written and validated;
    each mode's drain timed beside the untraced single drain."""
    from repro_torch.algorithms.coloring import validate_coloring
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.obs import (Trace, validate_chrome_trace,
                                 validate_metrics_jsonl)
    from repro_torch.runtime import build_program, execute

    out = {}
    bfs_params = {"source": source}
    params_of = {"bfs": bfs_params, "pagerank": PR_PARAMS, "coloring": None}
    singles = {"bfs": mega["carry"], "pagerank": pr["carry"],
               "coloring": col["carry"]}

    # BFS fused.persistent g1: B1 and B2 on packed items
    state_s, stats_s, info_s = single
    reset_counts()
    carry_f, secs_f = drive("bfs", graph, algo_config("fused.persistent"),
                            bfs_params)
    counts = read_counts()
    state, stats, info = outcome(carry_f, megakernel=False)
    steps = -(-info["rounds"] // POLL_EVERY) * POLL_EVERY
    if counts != only(lbs=steps, compact=steps + 1):
        raise AssertionError(f"BFS fused.persistent: expected one LBS and "
                             f"one compaction per predicated step ({steps})"
                             f" plus the seed push's, got {counts}")
    if not np.array_equal(state.dist.cpu().numpy(), want) \
            or not same_leaves(state, state_s) or info != info_s \
            or [int(x) for x in stats] != [int(x) for x in stats_s] \
            or not fused_equals_single(carry_f, mega["carry"]):
        raise AssertionError(f"BFS fused.persistent differs from scipy or "
                             f"single.persistent: {info} vs {info_s}")
    out["bfs_fused_persistent"] = {"info": info, "counts": counts,
                                   "seconds": secs_f}
    log(f"    BFS fused.persistent g1: counts={counts}; dist equals scipy; "
        f"dist, counters, RunStats and info equal single.persistent's, the "
        f"final lane its queue packed (cursors equal); {secs_f:.3f} s, no "
        f"host sync inside a window  [{card}]")

    # each program's fused.megakernel g1: one launch of the fused mode,
    # against the single.megakernel carries of 4b-4d; then each mode timed
    timing = {}
    for algo, name in DRAINS.items():
        params = params_of[algo]
        reset_counts()
        fused = profiled_drive(algo, graph, algo_config("fused.megakernel"),
                               name, params)
        counts = read_counts()
        if counts != only(**{name: 1}):
            raise AssertionError(f"{algo} fused.megakernel: expected one "
                                 f"{name} launch and no other: {counts}")
        if not fused_equals_single(fused["carry"], singles[algo]):
            raise AssertionError(f"{algo} fused.megakernel differs from "
                                 f"single.megakernel: "
                                 f"{scalars(fused['carry'])} vs "
                                 f"{scalars(singles[algo])}")
        untraced = profiled_drive(algo, graph,
                                  algo_config("single.megakernel"), name,
                                  params)
        same_or_raise(f"{algo} single.megakernel, two drains",
                      untraced["carry"], singles[algo])
        traced = {}
        for topology in ("single", "fused"):
            reset_counts()
            run = profiled_drive(
                algo, graph, algo_config(f"{topology}.megakernel"), name,
                params, trace=Trace(capacity=TRACE_CAPACITY))
            counts_t = read_counts()
            if counts_t != only(**{name: 1}):
                raise AssertionError(f"{algo} traced {topology}.megakernel:"
                                     f" expected one {name} launch, got "
                                     f"{counts_t}")
            held = run["carry"][:4]
            if not (same_leaves(held, singles[algo]) if topology == "single"
                    else fused_equals_single(held, singles[algo])):
                raise AssertionError(f"{algo} traced {topology}.megakernel "
                                     f"differs from the untraced drain")
            rows = rows_of(run["carry"][4])
            if len(rows) != int(run["carry"][2]) \
                    or sum(r["pops"] for r in rows) != int(run["carry"][3]) \
                    or sum(r["work"] for r in rows) \
                    != int(run["carry"][1].counter.work):
                raise AssertionError(f"{algo} traced {topology}: rows do "
                                     f"not reconcile with the carry")
            traced[topology] = {"rows": rows, "counts": counts_t,
                                **{k: v for k, v in run.items()
                                   if k not in ("carry", "rows")}}
        if traced["single"]["rows"] != traced["fused"]["rows"]:
            raise AssertionError(f"{algo}: the fused traced rows differ "
                                 f"from the single traced rows")
        timing[algo] = {
            "single": {k: untraced[k] for k in ("seconds", "kernel_ms",
                                                "busy_share")},
            "fused": {"launches": counts[name],
                      **{k: fused[k] for k in ("seconds", "kernel_ms",
                                               "busy_share")}},
            "single_traced": {"launches": traced["single"]["counts"][name],
                              **{k: traced["single"][k] for k in (
                                  "seconds", "kernel_ms", "busy_share")}},
            "fused_traced": {k: traced["fused"][k] for k in (
                "seconds", "kernel_ms", "busy_share")},
            "rounds": int(singles[algo][2])}
        out[f"{algo}_rows"] = traced["single"]["rows"]
        t = timing[algo]
        log(f"    {algo} g1 megakernel drains, one each, warm ({name} "
            f"device ms / host s): single {t['single']['kernel_ms']:.3f} / "
            f"{t['single']['seconds']:.4f}, fused "
            f"{t['fused']['kernel_ms']:.3f} / {t['fused']['seconds']:.4f}, "
            f"single traced {t['single_traced']['kernel_ms']:.3f} / "
            f"{t['single_traced']['seconds']:.4f}, fused traced "
            f"{t['fused_traced']['kernel_ms']:.3f} / "
            f"{t['fused_traced']['seconds']:.4f}; {t['rounds']} rounds; "
            f"each one launch, equal to single.megakernel bit for bit, the "
            f"rows reconcile with the carry  [{card}]")
    out["timing"] = timing

    # the traced rows against the traced persistent drains
    carry_t, rows_p = traced_rows("bfs", graph,
                                  algo_config("single.persistent"),
                                  bfs_params)
    if not same_leaves(tuple(carry_t[:4]), singles["bfs"]) \
            or len(rows_p) != info_s["rounds"] \
            or sum(r["pops"] for r in rows_p) != int(stats_s.items_processed) \
            or sum(r["work"] for r in rows_p) != info_s["work"]:
        raise AssertionError("the traced BFS persistent drain differs from "
                             "the untraced one or its rows do not reconcile")
    if out["bfs_rows"] != rows_p:
        raise AssertionError("BFS: the megakernel's trace rows differ from "
                             "the persistent drain's")
    log(f"    traced single.persistent BFS g1: {len(rows_p)} rows, sum of "
        f"pops = processed, sum of work = work, result equal to untraced, "
        f"no host sync inside a window; the traced megakernels' rows equal "
        f"its rows")
    for algo, cut in (("pagerank", PR_CUT), ("coloring", COL_CUT)):
        _, rows_c = traced_rows(algo, graph, algo_config(
            "single.persistent", max_rounds=cut), params_of[algo])
        rows_m = out[f"{algo}_rows"]
        if rows_m[:cut] != rows_c or len(rows_c) != min(cut, len(rows_m)):
            bad = next((i for i, (x, y) in enumerate(zip(rows_m, rows_c))
                        if x != y), None)
            raise AssertionError(f"{algo}: the megakernel's first {cut} "
                                 f"trace rows differ from the traced "
                                 f"persistent drain cut alike ({len(rows_c)}"
                                 f" rows; first difference at {bad}: "
                                 f"{None if bad is None else rows_m[bad]} vs "
                                 f"{None if bad is None else rows_c[bad]})")
        log(f"    {algo}: the traced megakernel's first {cut} rows equal "
            f"the traced single.persistent drain's cut at {cut} rounds")

    # the files: each program's traced megakernel drain through execute
    written = {}
    for algo in DRAINS:
        trace = Trace(capacity=TRACE_CAPACITY, meta={"program": algo})
        cfg = algo_config("fused.megakernel")
        execute(build_program(algo, graph, cfg, params=params_of[algo]),
                graph, cfg, trace=trace)
        if [{k: v for k, v in r.items() if k != "engine"}
                for r in trace.records] != out[f"{algo}_rows"]:
            raise AssertionError(f"{algo}: execute's trace rows differ")
        base = ROOT / "chiprun_out" / "chip_smoke" / f"trace_{algo}"
        trace.write(f"{base}.json", f"{base}.jsonl")
        n_docs = validate_metrics_jsonl(
            Path(f"{base}.jsonl").read_text().splitlines())
        n_events = validate_chrome_trace(
            json.loads(Path(f"{base}.json").read_text()))
        written[algo] = {"jsonl_docs": n_docs, "chrome_events": n_events}
    out["files"] = written
    log(f"    traces written to chiprun_out/chip_smoke/trace_*.json(l) and "
        f"valid: {written}")
    for algo in DRAINS:
        out.pop(f"{algo}_rows")

    # fused.megakernel.g2 (BFS, coloring) and BFS g4 on grid2d, against
    # their single cells and scipy; g4 refused at rmat(21)
    for algo, g, suffix, want_d in (("bfs", graph, ".g2", want),
                                    ("coloring", graph, ".g2", None),
                                    ("bfs", grid, ".g4", want_grid)):
        params = ({"source": source if g is graph else 0}
                  if algo == "bfs" else None)
        label = f"{algo} fused.megakernel{suffix} " + (
            "rmat" if g is graph else "grid2d")
        carry_s, _ = drive(algo, g, algo_config("single.megakernel"
                                                + suffix), params)
        reset_counts()
        carry_f, secs = drive(algo, g, algo_config("fused.megakernel"
                                                   + suffix), params)
        counts = read_counts()
        if counts != only(**{DRAINS[algo]: 1}):
            raise AssertionError(f"{label}: expected one launch, {counts}")
        if not fused_equals_single(carry_f, carry_s):
            raise AssertionError(f"{label} differs from single: "
                                 f"{scalars(carry_f)} vs {scalars(carry_s)}")
        ok = (np.array_equal(carry_f[1].dist.cpu().numpy(), want_d)
              if algo == "bfs" else validate_coloring(g, carry_f[1].colors))
        if not ok or int(lane_queue(carry_f[0]).dropped):
            raise AssertionError(f"{label}: wrong result or drops")
        out[label] = {"carry": scalars(carry_f), "seconds": secs}
        held = "equals scipy" if algo == "bfs" else "is valid"
        log(f"    {label}: one launch; equals single.megakernel{suffix} "
            f"(lane = queue packed) and {held}; {int(carry_f[2])} rounds, "
            f"{secs:.4f} s  [{card}]")
    from repro_torch.server.encoding import check_job_fits

    n = graph.num_vertices
    try:
        check_job_fits(0, n, granularity=4)
        reason = None
    except ValueError as e:
        reason = str(e)
    refused = []
    for kernel in ("persistent", "discrete", "megakernel"):
        if reason is None:         # a rehearsal's graph fits at g4
            break
        cfg = algo_config(f"fused.{kernel}.g4")
        reset_counts()
        try:
            execute(build_program("bfs", graph, cfg, params=bfs_params),
                    graph, cfg)
        except ValueError as e:
            if any(read_counts().values()) or str(e) != reason:
                raise AssertionError(f"fused.{kernel}.g4: {e}; "
                                     f"{read_counts()}") from e
            refused.append(kernel)
        else:
            raise AssertionError(f"fused.{kernel}.g4 with n = {n} was not "
                                 f"refused")
    out["refused_g4"] = {"refused": refused, "reason": reason}
    if reason is None:
        log(f"    n = {n} fits at g4: the admission refusal is checked at "
            f"full size")
    else:
        log(f"    fused.{{{', '.join(refused)}}}.g4 with n = {n}: admission "
            f"refuses before any launch: {reason}")

    # PageRank fused.persistent cut at PR_CUT rounds against single alike
    cut_s, _ = drive("pagerank", graph, algo_config(
        "single.persistent", max_rounds=PR_CUT), PR_PARAMS)
    cut_f, secs = drive("pagerank", graph, algo_config(
        "fused.persistent", max_rounds=PR_CUT), PR_PARAMS)
    if not fused_equals_single(cut_f, cut_s) or int(cut_f[2]) != min(
            PR_CUT, timing["pagerank"]["rounds"]):
        raise AssertionError("PageRank fused.persistent cut differs from "
                             "single.persistent cut alike")
    log(f"    PageRank fused.persistent cut at {PR_CUT} rounds equals "
        f"single.persistent cut alike bit for bit ({secs:.2f} s)  [{card}]")

    # each mode over the first rounds at rmat(21) against its plain version,
    # and the fused traced modes whole at rmat(small) on the card (PageRank
    # on the CPU, cut at HOST_ROUNDS)
    first = {}
    for algo in DRAINS:
        for mode, policy, traced in (("fused", "fused.megakernel", False),
                                     ("traced", "single.megakernel", True)):
            first[f"{algo}.{mode}"] = mode_first_rounds(
                algo, graph, policy, params_of[algo], traced)
            r = first[f"{algo}.{mode}"]
            log(f"    {DRAINS[algo]} {mode} mode, first {r['rounds']} "
                f"rounds: kernel {r['kernel_ms']:.3f} ms device, plain "
                f"fused drain {r['plain_ms']:.1f} ms device, equal to "
                f"{r['held_against']} bit for bit; bound "
                f"{1e3 * r['bound_bytes'] / HBM_BYTES_PER_S:.4f} ms  "
                f"[{card}]")
    from repro_torch.graph import rmat
    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    for algo in ("bfs", "coloring"):
        params = ({"source": int(torch.argmax(small.degrees()))}
                  if algo == "bfs" else None)
        cfg_k = algo_config("fused.megakernel", workers=256)
        carry_k, rows_k = traced_rows(algo, small, cfg_k, params)
        carry_t, rows_t = traced_rows(algo, small, algo_config(
            "fused.megakernel", workers=256, backend="torch"), params)
        same_or_raise(f"rmat({small_scale}) {algo} fused traced kernel vs "
                      f"plain", carry_k, carry_t)
        log(f"    rmat({small_scale}) {algo} fused.megakernel traced: the "
            f"kernel equals the plain fused drain bit for bit, "
            f"{len(rows_k)} rows included")
    out["first_rounds"] = {k: {kk: vv for kk, vv in v.items()
                               if kk != "carry"} for k, v in first.items()}
    return out


# ------------------------- phase 4g: streaming graphs (A9, B3-slotted)
STREAM = {"num_batches": 4, "batch_size": 16384, "seed": 7,
          "insert_frac": 0.5}
STREAM_KNOBS = {"compact_every": 2, "overlay_slack": 0.25}
SNAPSHOT_EVERY = 64
HOST_SECONDS = ("commit_seconds", "reseed_seconds", "drain_seconds")
SLOT_BYTES = 12                    # a row's slab_ptr, slab_len and ovl_ptr


def stream_run(algo: str, graph, deltas, policy: str, params=None,
               **kw) -> tuple:
    """``(StreamResult, counts, seconds)`` of one ``stream_execute`` on
    ``graph`` with phase 4g's compaction knobs; ``counts`` are the kernel
    launches of the whole stream."""
    from repro_torch.runtime import stream_execute

    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = stream_execute(algo, graph, deltas, algo_config(policy),
                         params=params, **STREAM_KNOBS, **kw)
    torch.cuda.synchronize()
    return res, read_counts(), time.perf_counter() - t0


def records_of(res) -> list:
    """The stream's batch records without their host seconds."""
    import dataclasses

    return [{k: v for k, v in dataclasses.asdict(r).items()
             if k not in HOST_SECONDS} for r in res.batches]


def log_batches(label: str, res, card: str) -> list:
    """One line per batch: commit, reseed and drain seconds, PageRank's
    decay sweeps, the commit meters; returns the rows."""
    rows = []
    for r in res.batches:
        rows.append({"batch": r.batch, "commit_s": r.commit_seconds,
                     "reseed_s": r.reseed_seconds,
                     "drain_s": r.drain_seconds, "sweeps": r.reseed_sweeps,
                     "touched_rows": r.touched_rows, "overlay": r.overlay,
                     "compacted": r.compacted, "seeds": r.seeds,
                     "rounds": r.rounds, "work": r.work,
                     "effective_ops": r.effective_ops})
        log(f"      {label} batch {r.batch}: commit {r.commit_seconds:.4f} s,"
            f" reseed {r.reseed_seconds:.4f} s, drain {r.drain_seconds:.4f}"
            f" s; sweeps {r.reseed_sweeps}; touched_rows {r.touched_rows}, "
            f"overlay {r.overlay}, compacted {r.compacted}; seeds {r.seeds},"
            f" rounds {r.rounds}, work {r.work}  [{card}]")
    return rows


def launches_only(label: str, counts: dict, name: str, want: int) -> None:
    if counts != only(**{name: want}):
        raise AssertionError(f"{label}: expected {want} {name} launches "
                             f"(one a batch drain or segment) and no other "
                             f"kernel, got {counts}")


def bfs_streams(graph, deltas, source: int, final, card: str) -> dict:
    """BFS over the delta log: single.megakernel g1 and g4,
    fused.megakernel g1 and single.persistent g1, against scipy on the
    final graph, a cold drain on it and one another; single.megakernel g1
    cut into 64-round snapshot segments, resumed in-process from an older
    snapshot, and traced."""
    import shutil

    from repro_torch.obs import Trace

    params = {"source": source}
    want = host_bfs(final, source)
    cold, _, cold_info, _ = run_algo("bfs", final,
                                     algo_config("single.megakernel"),
                                     params)
    if not np.array_equal(cold.dist.cpu().numpy(), want):
        raise AssertionError("the cold BFS drain on the final graph "
                             "differs from scipy")
    out = {"cells": {}}
    base = None
    batches = STREAM["num_batches"] + 1
    batch_dists = []
    for policy in ("single.megakernel", "single.megakernel.g4",
                   "fused.megakernel", "single.persistent"):
        # the first stream's dist at each batch end, for [4j]'s sharded one
        with batch_ends(lambda st: batch_dists.append(st.dist.clone())
                        if policy == "single.megakernel" else None):
            res, counts, secs = stream_run("bfs", graph, deltas, policy,
                                           params)
        if "megakernel" in policy:
            launches_only(f"BFS stream {policy}", counts, "bfs_drain",
                          batches)
        elif counts["bfs_drain"] or not (counts["lbs"] and
                                         counts["compact"]):
            raise AssertionError(f"BFS stream {policy}: {counts}")
        dist = res.result.cpu().numpy()
        if not np.array_equal(dist, want):
            raise AssertionError(f"BFS stream {policy}: dist differs from "
                                 f"scipy on the final graph at "
                                 f"{int((dist != want).sum())} vertices")
        if res.info["dropped"] or not any(r.overlay for r in res.batches):
            raise AssertionError(f"BFS stream {policy}: {res.info}")
        rec = records_of(res)
        if policy == "single.megakernel":
            base = (res, rec)
        elif ".g4" not in policy and (
                rec != base[1] or not same_leaves(res.state, base[0].state)
                or {k: v for k, v in res.info.items()
                    if k not in ("topology", "commit_seconds")}
                != {k: v for k, v in base[0].info.items()
                    if k not in ("topology", "commit_seconds")}):
            raise AssertionError(f"BFS stream {policy} differs from "
                                 f"single.megakernel: {rec} vs {base[1]}")
        elif [{k: r[k] for k in ("touched_rows", "overlay", "compacted",
                                 "effective_ops")} for r in rec] != \
                [{k: r[k] for k in ("touched_rows", "overlay", "compacted",
                                    "effective_ops")} for r in base[1]]:
            raise AssertionError(f"BFS stream {policy}: commit meters differ")
        out["cells"][policy] = {"seconds": secs, "counts": counts,
                                "info": res.info,
                                "batches": log_batches(f"BFS {policy}", res,
                                                       card)}
        log(f"    BFS stream {policy}: dist equals scipy and the cold drain "
            f"on the final graph; {counts['bfs_drain']} drain launches for "
            f"{batches} batches; info {res.info}; {secs:.3f} s  [{card}]")
    res, rec = base

    # snapshots every 64 rounds: the same stream, one launch a segment
    snap_dir = ROOT / "build" / "chip_smoke_snapshots"
    shutil.rmtree(snap_dir, ignore_errors=True)
    ticks = []
    cut, counts, secs = stream_run(
        "bfs", graph, deltas, "single.megakernel", params,
        snapshot_every=SNAPSHOT_EVERY, checkpoint_dir=str(snap_dir),
        keep=1000, snapshot_hook=lambda t, b: ticks.append((t, b)))
    launches_only("BFS snapshot stream", counts, "bfs_drain",
                  len(ticks) - batches)
    if records_of(cut) != rec or not same_leaves(cut.state, res.state):
        raise AssertionError("the BFS stream cut into 64-round segments "
                             "differs from the whole")
    # resume from batch 2's last snapshot (after a compaction): drop every
    # later one; the resume replays the commits of batches 1 and 2
    tick, batch = [t for t in ticks if t[1] == 2][-1]
    for t, _ in ticks:
        if t > tick:
            shutil.rmtree(snap_dir / f"snap_{t}")
    resumed, _, resume_secs = stream_run(
        "bfs", graph, deltas, "single.megakernel", params,
        snapshot_every=SNAPSHOT_EVERY, checkpoint_dir=str(snap_dir),
        keep=1000, resume=True)
    if resumed.info["resumed_at"] != batch \
            or not same_leaves(resumed.state, res.state) \
            or records_of(resumed) != rec[batch:]:
        raise AssertionError(f"the BFS stream resumed from snapshot {tick} "
                             f"differs: {resumed.info}")
    shutil.rmtree(snap_dir, ignore_errors=True)
    log(f"    BFS stream single.megakernel, snapshots every "
        f"{SNAPSHOT_EVERY} rounds: {len(ticks)} snapshots, "
        f"{counts['bfs_drain']} segment launches, equal to the whole "
        f"stream ({secs:.3f} s); resumed in-process from snapshot {tick} "
        f"(batch {batch}), bit-identical ({resume_secs:.3f} s)  [{card}]")

    trace = Trace(capacity=TRACE_CAPACITY)
    traced, counts, tsecs = stream_run("bfs", graph, deltas,
                                       "single.megakernel", params,
                                       trace=trace)
    launches_only("BFS traced stream", counts, "bfs_drain", batches)
    total = traced.info["rounds"]
    if not same_leaves(traced.state, res.state) or trace.truncated \
            or [r["round"] for r in trace.records] != list(range(total)) \
            or sum(r["pops"] for r in trace.records) != \
            traced.info["processed"]:
        raise AssertionError(f"the traced BFS stream: {len(trace.records)} "
                             f"rows for {total} rounds, {trace.truncated} "
                             f"truncated")
    log(f"    BFS stream traced: one row a round at absolute rounds "
        f"(0..{total - 1}), pops reconcile, equal to the untraced stream "
        f"({tsecs:.3f} s)  [{card}]")
    out.update({"cold_info": cold_info, "snapshots": len(ticks),
                "segment_launches": counts["bfs_drain"],
                "resumed_at": batch, "traced_rounds": total,
                "batch_dists": batch_dists})
    return out


def pagerank_stream(graph, deltas, final, card: str) -> dict:
    """PageRank single.megakernel g1 over the delta log: converged; each
    vertex's rank within 2 eps rank / (1 - d) + 8 u rank of a cold drain
    on the final graph, and within 10 eps max(rank, 1) (the reference's
    10 eps, scaled to ranks above 1); the push invariant within its
    float32 bound."""
    from repro_torch.kernels.drain_loop.pagerank_drain import (
        pagerank_drain_cuda)

    res, counts, secs = stream_run("pagerank", graph, deltas,
                                   "single.megakernel", PR_PARAMS)
    # the reseed's float64 sums launch the ordered scatter-add once, and
    # once a decay sweep; the drains launch nothing but B3-pr
    reseed_sums = sum(1 + r.reseed_sweeps for r in res.batches[1:])
    if counts != only(pagerank_drain=STREAM["num_batches"] + 1,
                      ordered_scatter_add=reseed_sums):
        raise AssertionError(f"PageRank stream: expected one pagerank_drain "
                             f"launch a batch drain and {reseed_sums} "
                             f"ordered scatter-adds in the reseeds, and no "
                             f"other kernel: {counts}")
    units_last = int(pagerank_drain_cuda.units_expanded)
    max_res = float(res.state.residue.max())
    cold, _, cold_info, cold_secs = run_algo(
        "pagerank", final, algo_config("single.megakernel"), PR_PARAMS)
    eps, d = PR_PARAMS["eps"], PR_PARAMS["damping"]
    # two drains that stop with every residue in [-eps, eps] each lie within
    # eps (I - d P)^-1 1 = eps rank / (1 - d) of the fixed point, vertex by
    # vertex (rank = (1 - d) (I - d P)^-1 1): they agree within 2 eps rank /
    # (1 - d), plus float32 rounding.  The reference's 10 eps (its test at
    # rmat(6), ranks near 1) is this bound where rank is about 1; a hub's
    # rank is far above 1, and the slack grows with it.
    diff_t = (res.result.double() - cold.rank.double()).abs()
    top = torch.maximum(res.result, cold.rank).double()
    slack = 2 * eps / (1 - d) * top + 8 * U32 * top
    diff = float(diff_t.max())
    ratio = float((diff_t / slack).max())
    within_10_eps = float((diff_t / (10 * eps * top.clamp(min=1.0))).max())
    # the reseed restores the invariant in float64 and casts rank and
    # residue to float32 (two roundings a vertex, and rank's rounding in the
    # right-hand side): 4 n on top of the last drain's units and work
    last = res.batches[-1]
    inv = pagerank_invariant(final, res.state, units_last,
                             last.work + 4 * final.num_vertices)
    if not (max_res <= eps and res.info["dropped"] == 0 and ratio <= 1.0
            and within_10_eps <= 1.0 and inv["sum_rel_err"] <= inv["bound"]
            and inv["ref_max_rel_err"] <= inv["ref_limit"]):
        raise AssertionError(f"PageRank stream: max residue {max_res}, "
                             f"|stream - cold| {diff} ({ratio} of the "
                             f"bound, {within_10_eps} of 10 eps max(rank, "
                             f"1)), invariant {inv}, {res.info}")
    log(f"    PageRank stream single.megakernel: converged (max residue "
        f"{max_res:.3g}); max |rank - cold| = {diff:.3g}, {ratio:.3g} of "
        f"2 eps rank / (1 - d) + 8 u rank, {within_10_eps:.3g} of 10 eps "
        f"max(rank, 1); push "
        f"invariant {inv['sum_rel_err']:.4g} <= {inv['bound']:.4g}, "
        f"{inv['ref_max_rel_err']:.3g} from a float64 power iteration; "
        f"{counts['pagerank_drain']} drain launches, {reseed_sums} float64 "
        f"scatter-adds in the reseeds; {secs:.3f} s (cold drain "
        f"{cold_secs:.3f} s, {cold_info['rounds']} rounds)  [{card}]")
    reseeds = [r.reseed_seconds for r in res.batches[1:]]
    log(f"    PageRank reseed: {min(reseeds):.4f}-{max(reseeds):.4f} s a "
        f"batch over {len(reseeds)} batches, {reseed_sums} float64 ordered "
        f"scatter-adds at k = m  [{card}]")
    return {"info": res.info, "seconds": secs, "counts": counts,
            "reseed_seconds": reseeds,
            "max_residue": max_res, "max_diff_vs_cold": diff,
            "diff_over_bound": ratio, "diff_over_10_eps_rank": within_10_eps,
            "invariant": inv, "cold_info": cold_info,
            "cold_seconds": cold_secs,
            "batches": log_batches("PageRank", res, card)}


def coloring_streams(graph, deltas, final, card: str) -> dict:
    """Coloring single.megakernel g1: ``recolor`` bitwise equal to a cold
    drain on the final graph; ``conflicts`` valid, for less work."""
    from repro_torch.algorithms.coloring import validate_coloring

    out = {}
    cold, _, cold_info, _ = run_algo("coloring", final,
                                     algo_config("single.megakernel"))
    for dirty in ("recolor", "conflicts"):
        res, counts, secs = stream_run("coloring", graph, deltas,
                                       "single.megakernel", {"dirty": dirty})
        launches_only(f"coloring stream {dirty}", counts, "coloring_drain",
                      STREAM["num_batches"] + 1)
        if not validate_coloring(final, res.result):
            raise AssertionError(f"coloring stream {dirty}: not a valid "
                                 f"coloring of the final graph")
        if dirty == "recolor" and not torch.equal(res.result, cold.colors):
            raise AssertionError("coloring stream recolor differs from the "
                                 "cold drain on the final graph")
        out[dirty] = {"info": res.info, "seconds": secs, "counts": counts,
                      "batches": log_batches(f"coloring {dirty}", res,
                                             card)}
        log(f"    coloring stream {dirty}: valid on the final graph"
            f"{', equal to the cold drain' if dirty == 'recolor' else ''};"
            f" work {res.info['work']}; {secs:.3f} s  [{card}]")
    if not out["conflicts"]["info"]["work"] < out["recolor"]["info"]["work"]:
        raise AssertionError("coloring conflicts did no less work than "
                             "recolor")
    out["cold_info"] = cold_info
    return out


def slotted_view_after(graph, delta):
    """Batch 1's slotted view: ``delta`` committed with phase 4g's knobs
    (no compaction at batch 1), its overlay non-empty."""
    from repro_torch.graph import SlottedCSR
    from repro_torch.stream import commit

    s = SlottedCSR.from_csr(graph)
    applied = commit(s, delta, 1, **STREAM_KNOBS)
    if applied.compacted or s.overlay_size == 0:
        raise AssertionError(f"batch 1's view: compacted {applied.compacted},"
                             f" overlay {s.overlay_size}")
    return s.view(), s


def slotted_first_rounds(algo: str, view, canonical, source: int,
                         card: str) -> dict:
    """A drain kernel's slotted mode over the first FIRST_ROUNDS rounds of
    a cold drain on batch 1's view: one launch, bitwise equal to the
    discrete cell's plain flat gather on the same view (on the card;
    PageRank's, whose plain scatter-add on the card sums in another order,
    on the CPU, both cut at HOST_ROUNDS, as in 4c); the plain slotted
    stream's [W, 4 (budget + 1)]
    slices would not fit.  Timed beside the plain drain on the card and the
    canonical mode on the same graph's canonical CSR."""
    params = PR_PARAMS if algo == "pagerank" else (
        {"source": source} if algo == "bfs" else None)
    name = DRAINS[algo]
    wrapper = _wrappers()[name]
    reset_counts()
    kern = profiled_drive(algo, view, algo_config("single.megakernel"), name,
                          params, limit=FIRST_ROUNDS)
    counts = read_counts()
    launches_only(f"{algo} slotted, first rounds", counts, name, 1)
    counted = (int(wrapper.visits) if algo == "coloring"
               else int(wrapper.units_expanded))
    carry = kern["carry"]
    plain_cfg = algo_config("single.discrete", backend="torch",
                            max_rounds=FIRST_ROUNDS)
    plain = profiled_drive(algo, view, plain_cfg, None, params)
    if algo == "pagerank":
        t0 = time.perf_counter()
        held, _ = drive(algo, view, algo_config("single.megakernel"), params,
                        limit=HOST_ROUNDS)
        want = host_plain_drain(algo, view.to("cpu"), algo_config(
            "single.discrete", backend="torch", max_rounds=HOST_ROUNDS),
            params)
        cpu_secs = time.perf_counter() - t0
        held_against = ("the discrete cell's plain flat gather on the CPU "
                        f"over the first {HOST_ROUNDS} rounds")
    else:
        held, want, cpu_secs = carry, plain["carry"], None
        held_against = "the discrete cell's plain flat gather on the card"
    same_or_raise(f"{algo} slotted, kernel vs {held_against}", held, want)
    canon = profiled_drive(algo, canonical, algo_config("single.megakernel"),
                           name, params, limit=FIRST_ROUNDS)
    slot_ms, canon_ms, pair_by = paired_ms(kern, canon)
    n = view.num_vertices
    rounds = int(carry[2])
    pushed = int(lane_queue(carry[0]).tail) - (0 if algo == "bfs" else n)
    if algo == "bfs":
        moved = bfs_bytes(counted, carry)
    elif algo == "pagerank":
        moved = pagerank_bytes(counted, int(carry[1].counter.work),
                               int(carry[3]), rounds,
                               min(1024 * PR_PARAMS["check_size"], n),
                               pushed)
    else:
        moved = coloring_bytes(counted, int(carry[3]),
                               int(carry[1].counter.work), pushed)
    moved += SLOT_BYTES * int(carry[3])
    log(f"    {name} slotted, first {rounds} rounds on batch 1's view: one "
        f"launch, equal to {held_against}"
        f"{'' if cpu_secs is None else f' ({cpu_secs:.1f} s there)'}; "
        f"kernel {kern['kernel_ms']:.3f} ms ({kern['timed_by']}), plain "
        f"{plain['device_ms']:.3f} ms device on the card; slotted "
        f"{slot_ms:.3f} ms vs canonical mode {canon_ms:.3f} ms on the "
        f"canonical CSR ({pair_by}); bound "
        f"{1e3 * moved / HBM_BYTES_PER_S:.4f} ms (bytes)  [{card}]")
    return {"rounds": rounds, "kernel_ms": kern["kernel_ms"],
            "timed_by": kern["timed_by"], "plain_ms": plain["device_ms"],
            "paired_ms": slot_ms, "canonical_ms": canon_ms,
            "paired_timed_by": pair_by,
            "cpu_plain_seconds": cpu_secs, "held_against": held_against,
            "max_abs_err": carry_err(held, want), "bound_bytes": moved,
            "counts": counts}


def slotted_whole_drains(view, canonical, card: str) -> dict:
    """BFS's and coloring's whole cold drains on batch 1's view through the
    slotted mode beside the canonical mode on the canonical CSR (device
    time), with equal results."""
    out = {}
    for algo, params in (("bfs", {"source": 0}), ("coloring", None)):
        name = DRAINS[algo]
        cfg = algo_config("single.megakernel")
        slot = profiled_drive(algo, view, cfg, name, params)
        canon = profiled_drive(algo, canonical, cfg, name, params)
        if not same_leaves(slot["carry"], canon["carry"]):
            raise AssertionError(f"{algo}: the slotted drain differs from "
                                 f"the canonical drain on the same graph")
        slot_ms, canon_ms, pair_by = paired_ms(slot, canon)
        out[algo] = {"slotted_ms": slot_ms, "canonical_ms": canon_ms,
                     "timed_by": pair_by, "rounds": int(slot["carry"][2])}
        log(f"    {name} whole drain on batch 1's graph: slotted "
            f"{slot_ms:.3f} ms, canonical {canon_ms:.3f} ms ({pair_by}), "
            f"{int(slot['carry'][2])} rounds, equal carries  [{card}]")
    return out


def slotted_small(small_scale: int, card: str) -> dict:
    """At rmat(small_scale): each program's whole slotted drain (a view
    with an overlay) against the plain fused drain on the CPU."""
    from repro_torch.graph import edge_delta_stream, rmat

    small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    delta = edge_delta_stream(small, 1, 1024, seed=STREAM["seed"])[0]
    view, _ = slotted_view_after(small, delta)
    host = view.to("cpu")
    out = {}
    for algo in ("bfs", "pagerank", "coloring"):
        params = PR_PARAMS if algo == "pagerank" else (
            {"source": 0} if algo == "bfs" else None)
        reset_counts()
        carry, _ = drive(algo, view, algo_config("single.megakernel",
                                                 workers=256), params)
        launches_only(f"{algo} slotted at rmat({small_scale})", read_counts(),
                      DRAINS[algo], 1)
        t0 = time.perf_counter()
        want = host_plain_drain(algo, host, algo_config(
            "single.discrete", workers=256), params)
        same_or_raise(f"{algo} slotted whole drain at rmat({small_scale}) vs "
                      f"the plain fused drain on the CPU", carry, want)
        out[algo] = {"rounds": int(carry[2]),
                     "cpu_seconds": time.perf_counter() - t0}
    log(f"    rmat({small_scale}) with an overlay of {int(view.ovl_ptr[-1])}:"
        f" each slotted drain kernel equals the plain fused drain on the CPU "
        f"bit for bit, whole drains {out}  [{card}]")
    return out


_KILLED_CHILD = """
import os, signal, sys
sys.path.insert(0, os.path.join(os.environ["REPO"], "src"))
from repro_torch.core import SchedulerConfig
from repro_torch.graph import edge_delta_stream, rmat
from repro_torch.runtime import config_for, parse_policy, stream_execute

base = rmat(int(os.environ["SCALE"]), edge_factor=16, seed=1, device="cuda")
deltas = edge_delta_stream(base, 4, 1024, seed=7)
cfg = config_for(SchedulerConfig(num_workers=256, fetch_size=4),
                 parse_policy("single.megakernel"))

def hook(tick, batch):
    if tick == int(os.environ["KILL_AT"]):
        os.kill(os.getpid(), signal.SIGKILL)

stream_execute("bfs", base, deltas, cfg, params={"source": 0},
               snapshot_every=8, checkpoint_dir=os.environ["SNAP_DIR"],
               keep=1000, snapshot_hook=hook, compact_every=2,
               overlay_slack=0.25)
"""


def sigkill_resume(small_scale: int, card: str) -> dict:
    """A child process runs a segmented megakernel stream at
    rmat(small_scale) and kills itself with SIGKILL in its snapshot hook;
    this process resumes from the snapshots it left, and the result equals
    the uninterrupted stream bit for bit."""
    import os
    import shutil
    import signal

    from repro_torch.graph import edge_delta_stream, rmat
    from repro_torch.runtime import stream_execute

    snap_dir = ROOT / "build" / "chip_smoke_sigkill"
    shutil.rmtree(snap_dir, ignore_errors=True)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", _KILLED_CHILD],
        env=dict(os.environ, REPO=str(ROOT), SCALE=str(small_scale),
                 KILL_AT="5", SNAP_DIR=str(snap_dir)),
        capture_output=True, text=True, timeout=300)
    child_secs = time.perf_counter() - t0
    if child.returncode != -signal.SIGKILL:
        raise AssertionError(f"the child was not killed: rc "
                             f"{child.returncode}\n{child.stderr[-2000:]}")
    base = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    deltas = edge_delta_stream(base, 4, 1024, seed=7)
    cfg = algo_config("single.megakernel", workers=256)
    kw = dict(params={"source": 0}, compact_every=2, overlay_slack=0.25)
    whole = stream_execute("bfs", base, deltas, cfg, **kw)
    resumed = stream_execute("bfs", base, deltas, cfg, snapshot_every=8,
                             checkpoint_dir=str(snap_dir), keep=1000,
                             resume=True, **kw)
    shutil.rmtree(snap_dir, ignore_errors=True)
    at = resumed.info["resumed_at"]
    if at is None or not same_leaves(resumed.state, whole.state) \
            or records_of(resumed) != records_of(whole)[at:] \
            or resumed.info["compactions"] != whole.info["compactions"]:
        raise AssertionError(f"the stream resumed after SIGKILL differs: "
                             f"{resumed.info} vs {whole.info}")
    log(f"    SIGKILL at rmat({small_scale}): the child died in its snapshot "
        f"hook ({child_secs:.1f} s); resumed here at batch {at}, result, "
        f"state, records and compactions bit-identical to the "
        f"uninterrupted stream  [{card}]")
    return {"resumed_at": at, "child_seconds": child_secs}


def streaming_path(graph, source: int, card: str, small_scale: int) -> dict:
    """Phase 4g: ``stream_execute`` over a delta log of rmat's graph on the
    card -- BFS, PageRank and coloring, each megakernel batch drain one
    launch of its drain kernel's slotted mode -- and B3-slotted against
    its plain version."""
    from repro_torch.graph import edge_delta_stream
    from repro_torch.stream import replay

    t0 = time.perf_counter()
    deltas = edge_delta_stream(graph, **STREAM)
    gen_secs = time.perf_counter() - t0
    final = replay(graph, deltas)
    log(f"    edge_delta_stream {STREAM}: {[d.num_ops for d in deltas]} "
        f"directed ops ({gen_secs:.2f} s); replayed final graph m="
        f"{final.num_edges}; knobs {STREAM_KNOBS}")
    out = {"deltas": [d.num_ops for d in deltas], "gen_seconds": gen_secs}
    out["bfs"] = bfs_streams(graph, deltas, source, final, card)
    # for [4j], taken out of the summary there
    out["log"], out["batch_dists"] = deltas, out["bfs"].pop("batch_dists")
    out["pagerank"] = pagerank_stream(graph, deltas, final, card)
    out["coloring"] = coloring_streams(graph, deltas, final, card)
    view, slotted = slotted_view_after(graph, deltas[0])
    canonical = slotted.to_csr()
    log(f"    batch 1's slotted view: overlay {slotted.overlay_size}, slab "
        f"array {view.slab_col.shape[0]} words for m={view.num_edges}")
    out["first_rounds"] = {algo: slotted_first_rounds(algo, view, canonical,
                                                      source, card)
                           for algo in ("bfs", "pagerank", "coloring")}
    out["whole"] = slotted_whole_drains(view, canonical, card)
    out["overlay"] = slotted.overlay_size
    del view, slotted, canonical
    out["small"] = slotted_small(small_scale, card)
    out["sigkill"] = sigkill_resume(small_scale, card)
    return out


# ------------------------------------------- phase 4h: the task server (A11)
#: the reference's 8-job mix (tests/test_server.py), PageRank at eps 1e-6
SERVER_MIX = [("bfs", "grid", {"source": 0}, 1.0),
              ("bfs", "rmat", {"source": 3}, 1.0),
              ("pagerank", "grid", {"eps": 1e-6}, 1.0),
              ("coloring", "rmat", {}, 1.0),
              ("bfs", "grid", {"source": 17}, 2.0),
              ("coloring", "grid", {}, 1.0),
              ("pagerank", "rmat", {"eps": 1e-6}, 1.0),
              ("bfs", "rmat", {"source": 9}, 1.0)]
#: (policy, granularity) of the small server runs, each traced
SERVER_CELLS = {"weighted.g1": ("weighted", 1), "weighted.g4": ("weighted", 4),
                "round_robin.g1": ("round_robin", 1)}
SERVER_SMALL = {"workers": 256, "fetch": 4, "grid_side": 128}
#: B1 launches of one lane step of each program's body (coloring: the
#: assign and detect gathers and the first-free search)
B1_PER_STEP = {"bfs": 1, "pagerank": 1, "coloring": 3}
#: rounds of the full-width server run under the profiler
PROFILED_ROUNDS = 256
#: ring rows of a small traced run: one a lane step, ~4,100 at most
SERVER_TRACE_CAPACITY = 16384

#: child processes started by this script, stopped when it ends
CHILDREN = []

#: a child process that runs small server cells (``server_child``)
_SERVER_CHILD = """
import os, sys
sys.path.insert(0, os.environ["REPO"])
import chip_smoke
chip_smoke.server_child()
"""


def small_registry(small_scale: int, device):
    """``(registry, graphs)``: rmat(small_scale, 16, seed 1) and
    grid2d(128) on ``device``."""
    from repro_torch.graph import grid2d, rmat
    from repro_torch.server import JobRegistry

    side = SERVER_SMALL["grid_side"]
    graphs = {"rmat": rmat(small_scale, edge_factor=16, seed=1,
                           device=device),
              "grid": grid2d(side, side, device=device)}
    reg = JobRegistry()
    for name, g in graphs.items():
        reg.register_graph(name, g)
    return reg, graphs


def small_specs() -> list:
    from repro_torch.server import JobSpec

    return [JobSpec(a, g, dict(p), weight=w) for a, g, p, w in SERVER_MIX]


def small_config(granularity: int):
    from repro_torch.core import SchedulerConfig

    return SchedulerConfig(num_workers=SERVER_SMALL["workers"],
                           fetch_size=SERVER_SMALL["fetch"],
                           granularity=granularity)


def server_child() -> None:
    """The body of a child process: run the small server cells that the
    JSON in ``SERVER_CHILD`` names (``sequential`` is ``serve_sequential``)
    on its device and pickle what the parent compares: results, telemetry
    docs, stats but wall, trace rows and, on the card, the kernel launches
    beside those the lane steps imply, and the seconds it ran."""
    import os
    import pickle

    started = time.perf_counter()
    spec = json.loads(os.environ["SERVER_CHILD"])
    sys.path.insert(0, str(ROOT / "src"))
    device = spec["device"]
    # a CPU child runs beside the script's host-bound phases: one thread
    torch.set_num_threads(1 if device == "cpu" else 2)
    from repro_torch.obs import Trace
    from repro_torch.server import serve_sequential

    on_card = device == "cuda"
    reg, graphs = small_registry(spec["scale"], device)
    out = {"graphs": {k: (g.row_ptr.cpu().numpy(), g.col_idx.cpu().numpy())
                      for k, g in graphs.items()}, "cells": {}}
    for cell in spec["cells"]:
        if on_card:
            reset_counts()
        t0 = time.perf_counter()
        if cell == "sequential":
            res = serve_sequential(reg, small_specs(),
                                   config=small_config(1), device=device)
            if on_card:
                torch.cuda.synchronize()
            server = trace = None
        else:
            policy, g = SERVER_CELLS[cell]
            trace = Trace(capacity=SERVER_TRACE_CAPACITY)
            server, res, _ = serve(reg, small_specs(), small_config(g),
                                   policy=policy, trace=trace, device=device)
        stats = dataclasses.asdict(res.stats)
        stats.pop("wall_seconds")
        out["cells"][cell] = {
            "results": res.results,
            "telemetry": {i: t.as_dict() for i, t in res.telemetry.items()},
            "stats": stats, "occupancy": res.stats.occupancy,
            "records": None if trace is None else trace.records,
            "truncated": None if trace is None else trace.truncated,
            "counts": read_counts() if on_card else None,
            "implied": (server_launches(server)
                        if on_card and server is not None else None),
            "seconds": time.perf_counter() - t0}
    out["ran"] = time.perf_counter() - started
    with open(spec["out"] + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(spec["out"] + ".tmp", spec["out"])


def start_server_child(small_scale: int, device: str, cells, tag: str):
    """Start ``server_child`` on ``device`` (the CPU child sees no card)."""
    import os

    path = ROOT / "build" / f"chip_smoke_server_{tag}.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    env = dict(os.environ, REPO=str(ROOT), SERVER_CHILD=json.dumps(
        {"scale": small_scale, "device": device, "cells": list(cells),
         "out": str(path)}))
    if device == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    logfile = open(path.with_suffix(".log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", _SERVER_CHILD], env=env,
                            stdout=logfile, stderr=subprocess.STDOUT)
    logfile.close()
    CHILDREN.append(proc)
    return {"proc": proc, "path": path, "tag": tag,
            "started": time.perf_counter()}


def wait_server_child(child: dict) -> dict:
    import pickle

    t0 = time.perf_counter()
    rc = child["proc"].wait(timeout=900)
    log_text = child["path"].with_suffix(".log").read_text()
    if rc != 0:
        raise AssertionError(f"the server child {child['tag']} failed: rc "
                             f"{rc}\n{log_text[-3000:]}")
    with open(child["path"], "rb") as f:
        out = pickle.load(f)
    child["path"].unlink()
    out["waited"] = time.perf_counter() - t0
    out["lifetime"] = time.perf_counter() - child["started"]
    return out


def server_launches(server, drains=None) -> dict:
    """The kernel launches a server run's lane steps imply: B1 per body
    step (``B1_PER_STEP``), B2 for each lane step, on_empty step and seed
    push, the ordered scatter-add for each PageRank step, and no drain
    kernel but ``drains`` (the streaming tenants')."""
    batch = [j for j in server.jobs
             if j.spec is None or j.spec.stream is None]
    return only(
        lbs=sum(B1_PER_STEP[j.program.algorithm] * j.lane_steps
                for j in batch),
        compact=sum(j.lane_steps + j.empty_steps + 1 for j in batch),
        ordered_scatter_add=sum(j.lane_steps for j in batch
                                if j.program.algorithm == "pagerank"),
        **(drains or {}))


def check_server(label: str, server, res, counts: dict, drains=None):
    """No drop and no misrouted task in any job, the jobs' items summing to
    the server's, the launch counts the lane steps imply."""
    for i, tel in res.telemetry.items():
        if tel.dropped or tel.routing_mismatches:
            raise AssertionError(f"{label}: job {i} dropped {tel.dropped}, "
                                 f"{tel.routing_mismatches} misrouted")
    items = sum(t.items_processed for t in res.telemetry.values())
    if items != res.stats.items_processed:
        raise AssertionError(f"{label}: jobs' items {items} != the "
                             f"server's {res.stats.items_processed}")
    want = server_launches(server, drains)
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, the lane steps "
                             f"imply {want}")


def serve(registry, specs, cfg, policy="weighted", lanes=None,
          device="cuda", **kw):
    """``(server, result, seconds)`` of one TaskServer run on ``device``;
    on the card the seconds end in a synchronize."""
    from repro_torch.server import TaskServer

    server = TaskServer(registry, num_lanes=lanes or len(specs), config=cfg,
                        policy=policy, device=device, **kw)
    for spec in specs:
        server.submit(spec)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    res = server.run()
    sync()
    return server, res, time.perf_counter() - t0


def server_full_width(graph, grid, source: int, want, want_grid,
                      card: str) -> dict:
    """The served path at full width: BFS from [4]'s source and from a
    seeded second source, coloring on rmat, BFS on grid2d from vertex 0,
    four lanes under ``weighted``; then its first rounds under the
    profiler."""
    from repro_torch.algorithms.coloring import validate_coloring
    from repro_torch.core import SchedulerConfig
    from repro_torch.server import JobRegistry, JobSpec

    reg = JobRegistry()
    reg.register_graph("rmat", graph)
    reg.register_graph("grid", grid)
    cfg = SchedulerConfig(num_workers=1024, fetch_size=4)
    reached = torch.nonzero(graph.degrees() > 0).flatten().cpu().numpy()
    second = int(reached[np.random.default_rng(22).integers(len(reached))])
    specs = [JobSpec("bfs", "rmat", {"source": source}),
             JobSpec("bfs", "rmat", {"source": second}),
             JobSpec("coloring", "rmat"),
             JobSpec("bfs", "grid", {"source": 0})]
    reset_counts()
    server, res, secs = serve(reg, specs, cfg)
    counts = read_counts()
    check_server("full-width server", server, res, counts)
    for i, expect in ((0, want), (3, want_grid)):
        if not np.array_equal(res.results[i], expect):
            raise AssertionError(f"full-width server: job {i}'s BFS "
                                 f"differs from scipy's")
    if not validate_coloring(graph, torch.as_tensor(res.results[2],
                                                    device=graph.device)):
        raise AssertionError("full-width server: the coloring is invalid")
    s = res.stats
    jobs = {i: {"algorithm": t.algorithm, "graph": t.graph,
                "latency_rounds": t.latency_rounds,
                "rounds_active": t.rounds_active,
                "items": t.items_processed, "occupancy": t.occupancy,
                "work": t.work, "lane_steps": server.jobs[i].lane_steps}
            for i, t in res.telemetry.items()}
    levels = int(want_grid[want_grid != INF].max()) + 1
    log(f"    full width, 4 lanes, weighted, W={cfg.wavefront}: BFS rmat "
        f"from {source} and {second}, coloring rmat, BFS grid2d from 0; "
        f"{s.rounds} rounds (the grid BFS alone {levels}), occupancy "
        f"{s.occupancy:.4f}, {secs:.3f} s wall, {1e3 * secs / s.rounds:.3f} "
        f"ms a round; BFS dist from {source} and on grid2d equal scipy's "
        f"(the second source's below), coloring valid, no drop, no "
        f"misrouted task; launches {counts} as the lane steps imply  "
        f"[{card}]")
    for i, j in jobs.items():
        log(f"      job {i} {j['algorithm']} on {j['graph']}: latency "
            f"{j['latency_rounds']} rounds, {j['lane_steps']} lane steps, "
            f"{j['items']} items, occupancy {j['occupancy']:.4f}")

    held = {}

    def first_rounds():
        t1 = time.perf_counter()
        try:
            serve(reg, specs, cfg, max_rounds=PROFILED_ROUNDS)
        except RuntimeError as exc:
            if f"max_rounds={PROFILED_ROUNDS}" not in str(exc):
                raise
        else:
            raise AssertionError("the server finished within "
                                 f"{PROFILED_ROUNDS} rounds")
        held["secs"] = time.perf_counter() - t1

    dev_ms, rows = device_profile(first_rounds)
    n_ops = sum(calls for _, _, calls in rows)
    busy = None if dev_ms is None else dev_ms / (1e3 * held["secs"])
    log(f"    its first {PROFILED_ROUNDS} rounds under the profiler: "
        f"{held['secs']:.3f} s wall, {dev_ms} ms device, busy share {busy}; "
        f"{n_ops / PROFILED_ROUNDS:.1f} device ops a round; top device ops "
        f"(ms, calls):  [{card}]")
    for key, ms, calls in rows[:8]:
        log(f"      {ms:10.3f} {calls:7d}  {key[:90]}")
    return {"rounds": s.rounds, "occupancy": s.occupancy, "seconds": secs,
            "ms_a_round": 1e3 * secs / s.rounds, "counts": counts,
            "jobs": jobs, "second_source": second,
            "second_dist": res.results[1],
            "profiled": {"rounds": PROFILED_ROUNDS, "seconds": held["secs"],
                         "device_ms": dev_ms, "busy_share": busy,
                         "device_ops": n_ops,
                         "device_ops_a_round": n_ops / PROFILED_ROUNDS,
                         "rows": rows[:20]}}


def server_small(cpu: dict, children: dict, card: str) -> dict:
    """The reference's 8-job mix at rmat(14) and grid2d(128) under
    ``weighted`` g1 and g4 and ``round_robin`` g1, traced, each in a child
    process of its own on the card, bitwise against the same server run on
    the CPU (``cpu``: the CPU children's runs by cell; results, every
    telemetry doc, stats but wall, trace rows);
    each run's launches those its lane steps imply; ``round_robin`` equal
    to ``serve_sequential``, the weighted rounds below it."""
    runs = {tag: wait_server_child(child) for tag, child in children.items()}
    lifetimes = ", ".join(f"{tag} {run['lifetime']:.1f} s"
                          for tag, run in runs.items())
    log(f"    the card children: {lifetimes}")
    graphs = next(iter(cpu.values()))["graphs"]
    for tag, run in (*runs.items(), *cpu.items()):
        for name, (rp, ci) in run["graphs"].items():
            if not (np.array_equal(rp, graphs[name][0])
                    and np.array_equal(ci, graphs[name][1])):
                raise AssertionError(f"{tag}: the card's {name} differs "
                                     f"from the CPU's")
    out = {}
    for cell in (*SERVER_CELLS, "sequential"):
        got = runs[cell]["cells"][cell]
        for i, tel in got["telemetry"].items():
            if tel["dropped"] or tel["routing_mismatches"]:
                raise AssertionError(f"small {cell}: job {i} dropped or "
                                     f"misrouted: {tel}")
        items = sum(t["items_processed"] for t in got["telemetry"].values())
        if items != got["stats"]["items_processed"]:
            raise AssertionError(f"small {cell}: jobs' items {items} != "
                                 f"the server's")
        out[cell] = {"rounds": got["stats"]["rounds"],
                     "occupancy": got["occupancy"],
                     "seconds": got["seconds"], "counts": got["counts"]}
        if cell == "sequential":
            continue
        if got["counts"] != got["implied"]:
            raise AssertionError(f"small {cell}: launches {got['counts']}, "
                                 f"the lane steps imply {got['implied']}")
        ref = cpu[cell]["cells"][cell]
        if got["truncated"] or ref["truncated"]:
            raise AssertionError(f"small {cell}: the trace ring wrapped")
        same = (all(np.array_equal(got["results"][i], ref["results"][i])
                    for i in ref["results"])
                and got["telemetry"] == ref["telemetry"]
                and got["stats"] == ref["stats"]
                and got["records"] == ref["records"])
        if not same:
            raise AssertionError(f"small {cell}: the server on the card "
                                 f"differs from the CPU's")
        out[cell]["cpu_seconds"] = ref["seconds"]
        out[cell]["trace_rows"] = len(got["records"])
        log(f"    small {cell}: {got['stats']['rounds']} rounds, occupancy "
            f"{got['occupancy']:.4f}, {got['seconds']:.3f} s on the card "
            f"(CPU {ref['seconds']:.1f} s); results, telemetry, stats and "
            f"{len(got['records'])} trace rows bitwise equal the CPU's; "
            f"launches {got['counts']}  [{card}]")
    seq = runs["sequential"]["cells"]["sequential"]
    rr = runs["round_robin.g1"]["cells"]["round_robin.g1"]
    fused = out["weighted.g1"]["rounds"]
    if not all(np.array_equal(rr["results"][i], seq["results"][i])
               for i in seq["results"]) \
            or rr["stats"]["rounds"] != seq["stats"]["rounds"]:
        raise AssertionError("round_robin differs from serve_sequential")
    if not fused < seq["stats"]["rounds"]:
        raise AssertionError(f"fused rounds {fused} not below sequential "
                             f"{seq['stats']['rounds']}")
    log(f"    serve_sequential: {seq['stats']['rounds']} rounds "
        f"({seq['seconds']:.3f} s), round_robin equal to it bitwise; "
        f"weighted g1 {fused} rounds ({fused / seq['stats']['rounds']:.3f}x)"
        f"  [{card}]")
    return out


def server_stream(small: tuple, card: str) -> dict:
    """A streaming BFS tenant (2 delta batches) beside two batch tenants
    under ``kernel="megakernel"``: the warning is logged, the batch
    tenants launch no drain kernel, the stream B3-slotted once a batch,
    and its dist equals a cold drain's on the replayed graph."""
    import logging

    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import edge_delta_stream
    from repro_torch.server import JobSpec
    from repro_torch.stream import StreamSpec, replay

    registry, graphs = small
    graph = graphs["rmat"]
    deltas = edge_delta_stream(graph, 2, 1024, seed=7)
    specs = [JobSpec("bfs", "rmat", {"source": 0},
                     stream=StreamSpec(deltas=tuple(deltas),
                                       compact_every=2)),
             JobSpec("coloring", "grid"), JobSpec("bfs", "grid", {"source": 5})]
    cfg = SchedulerConfig(num_workers=SERVER_SMALL["workers"],
                          fetch_size=SERVER_SMALL["fetch"],
                          kernel="megakernel")
    warnings = []

    class Keep(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    logger = logging.getLogger("repro_torch.server")
    handler = Keep(level=logging.WARNING)
    logger.addHandler(handler)
    try:
        reset_counts()
        server, res, secs = serve(registry, specs, cfg, lanes=2)
        counts = read_counts()
    finally:
        logger.removeHandler(handler)
    if not any("megakernel" in w and "per-round" in w for w in warnings):
        raise AssertionError(f"no megakernel warning: {warnings}")
    batches = len(server.jobs[0].stream_result.batches)
    check_server("stream server", server, res, counts,
                 drains={"bfs_drain": batches})
    cold, _, _, _ = run_algo("bfs", replay(graph, deltas),
                             algo_config("single.persistent", workers=256),
                             {"source": 0})
    if not np.array_equal(res.results[0], cold.dist.cpu().numpy()):
        raise AssertionError("the streaming tenant's dist differs from a "
                             "cold drain's")
    log(f"    streaming BFS tenant under kernel='megakernel': warning "
        f"logged; {batches} batch drains, {counts['bfs_drain']} bfs_drain "
        f"launches, none for the batch tenants; dist equals a cold drain's "
        f"on the replayed graph; {secs:.3f} s  [{card}]")
    return {"batches": batches, "counts": counts, "seconds": secs}


def server_autotune(small: tuple, out_dir, card: str) -> dict:
    """``Autotuner.tune("bfs", rmat)`` with the real runner on the card,
    then again from its cache, measuring nothing."""
    from repro_torch.server import Autotuner

    cache = out_dir / "autotune.json"
    cache.unlink(missing_ok=True)
    graph = small[1]["rmat"]
    tuner = Autotuner(cache_path=cache, warmup=0, iters=1)
    t0 = time.perf_counter()
    chosen = tuner.tune("bfs", graph)
    secs = time.perf_counter() - t0
    entry = json.loads(cache.read_text())[Autotuner.cache_key("bfs", graph)]
    reset_counts()
    t0 = time.perf_counter()
    again = Autotuner(cache_path=cache).tune("bfs", graph)
    hit_secs = time.perf_counter() - t0
    if again != chosen or any(read_counts().values()):
        raise AssertionError(f"the cache hit measured or differs: {again} "
                             f"vs {chosen}, {read_counts()}")
    if entry["cells_skipped"]:
        raise AssertionError(f"the card skipped {entry['cells_skipped']}")
    log(f"    autotune bfs at rmat: {entry['cells_measured']} of "
        f"{entry['cells_total']} cells measured in {secs:.1f} s, chose "
        f"{entry['chosen']} ({entry['trials'][entry['chosen']]:.4f} s vs "
        f"default {entry['default_wall']:.4f} s); the second call hit the "
        f"cache in {1e3 * hit_secs:.1f} ms, no launch  [{card}]")
    return {"chosen": entry["chosen"], "seconds": secs,
            "cells_measured": entry["cells_measured"],
            "cells_total": entry["cells_total"], "hit_seconds": hit_secs}


def start_server_cli(small_scale: int):
    """The task-server CLI as a child process on the card."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.taskserver", "--jobs",
           "9", "--lanes", "4", "--scale", str(small_scale), "--grid-side",
           str(SERVER_SMALL["grid_side"]), "--workers", "256", "--fetch", "4",
           "--compare-sequential"]
    proc = subprocess.Popen(cmd, env=dict(os.environ,
                                          PYTHONPATH=str(ROOT / "src")),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    CHILDREN.append(proc)
    return proc, cmd, time.perf_counter()


def wait_server_cli(started, card: str) -> dict:
    proc, cmd, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CLI exited {proc.returncode}:\n"
                             f"{stderr[-3000:]}")
    lines = stdout.splitlines()
    fused = int(next(l for l in lines if l.startswith("server: "))
                .split("rounds=")[1].split()[0])
    seq = int(next(l for l in lines if l.startswith("sequential: "))
              .split("rounds=")[1].split()[0])
    if not fused < seq:
        raise AssertionError(f"the CLI's fused rounds {fused} not below its "
                             f"sequential rounds {seq}")
    log(f"    CLI `{' '.join(cmd[1:])}`: exit 0 in {secs:.1f} s, fused "
        f"{fused} rounds vs sequential {seq}  [{card}]")
    for line in lines[-4:]:
        log(f"      {line}")
    return {"rounds": fused, "sequential_rounds": seq, "seconds": secs,
            "stdout": stdout}


def server_path(graph, grid, source: int, want, want_grid,
                cpu_children: dict, out_dir, card: str,
                small_scale: int) -> dict:
    """Phase 4h: the multi-tenant task server on the card.  It first waits
    for the CPU children (the small cells' reference, started after [2]),
    so the full-width run and its profile run alone; then the small cells
    run in child processes on the card (one a cell, and
    ``serve_sequential``) beside the CLI's, while this process checks the
    second BFS source against scipy and runs the streaming tenant and the
    autotuner (whose trials therefore share the card and the host)."""
    t0 = time.perf_counter()
    cpu = {cell: wait_server_child(child)
           for cell, child in cpu_children.items()}
    log("    the CPU children ran " + ", ".join(
        f"{cell} {run['ran']:.1f} s" for cell, run in cpu.items())
        + f"; [4h] waited {time.perf_counter() - t0:.1f} s for them")
    full = server_full_width(graph, grid, source, want, want_grid, card)
    children = {}
    for cell in (*SERVER_CELLS, "sequential"):
        children[cell] = start_server_child(small_scale, "cuda", [cell],
                                            cell)
    cli = start_server_cli(small_scale)
    t1 = time.perf_counter()
    want_second = host_bfs(graph, full["second_source"])
    if not np.array_equal(full.pop("second_dist"), want_second):
        raise AssertionError("full-width server: the second source's BFS "
                             "differs from scipy's")
    log(f"    the second source's dist equals scipy's "
        f"({time.perf_counter() - t1:.1f} s of scipy)")
    out = {"full": full}
    small = small_registry(small_scale, "cuda")
    out["stream"] = server_stream(small, card)
    out["autotune"] = server_autotune(small, out_dir, card)
    out["small"] = server_small(cpu, children, card)
    out["cli"] = wait_server_cli(cli, card)
    out["seconds"] = time.perf_counter() - t0
    log(f"    [4h] took {out['seconds']:.1f} s  [{card}]")
    return out


# ------------------------------- phase 4i: the sharded topology (A12)
SHARD_W = {"workers": 1024, "fetch": 4}        # W = 4096 a shard, as [4]
#: the two full-width meshes: four shards on one card, 1-D and strict; and
#: 2x2 with deferred delivery, the codec and stealing
SHARD_CELLS = {
    "s4": {"num_shards": 4},
    "2x2": {"num_shards": 4, "mesh_shape": (2, 2), "defer_rounds": 1,
            "compress": True, "steal_threshold": 0.5},
    "2x2-raw": {"num_shards": 4, "mesh_shape": (2, 2), "defer_rounds": 1,
                "steal_threshold": 0.5},
}
SHARD_FIRST_ROUNDS = 32                 # full-width PageRank and coloring
#: whole drains at the small scale, on the card against the CPU child:
#: (algorithm, cell, kernel strategy); the CPU runs the codec and the
#: shards' bodies slowly, so one cell an algorithm.  PageRank's s4 drain
#: is [4j]'s: its sharded stream's batch 0 drains that cell whole
SHARD_SMALL_CELLS = [("bfs", "2x2-raw", "discrete"),
                     ("coloring", "s4", "persistent")]
#: B2 launches a shard a predicated step: the local push and the delivered
#: push (strict), or the staged push and the local push (deferred; none in
#: the first round, one flush at the end), and the steal push
_SHARD_CHILD = """
import os, sys
sys.path.insert(0, os.environ["REPO"])
import chip_smoke
chip_smoke.shard_child()
"""


def shard_config(cell: str, kernel: str = "persistent", **kw):
    from repro_torch.core import SchedulerConfig
    from repro_torch.runtime import config_for, parse_policy

    return config_for(SchedulerConfig(num_workers=SHARD_W["workers"],
                                      fetch_size=SHARD_W["fetch"],
                                      **SHARD_CELLS[cell], **kw),
                      parse_policy(f"sharded.{kernel}"))


def shard_mesh(cfg, device):
    from repro_torch.launch.mesh import make_shard_mesh, make_shard_mesh2d

    devices = [torch.device(device)] * cfg.num_shards
    if cfg.mesh_shape is None:
        return make_shard_mesh(cfg.num_shards, devices=devices)
    return make_shard_mesh2d(*cfg.mesh_shape, devices=devices)


def shard_params(algo: str, source: int):
    return ({"source": source} if algo == "bfs" else
            dict(PR_PARAMS) if algo == "pagerank" else {})


def shard_run(algo: str, graph, cfg, source: int, device) -> tuple:
    """One sharded drain through ``execute`` on a mesh of four shards on
    ``device``: ``(state, RunStats, info, seconds)``."""
    from repro_torch.runtime import build_program, execute

    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats, info = execute(
        build_program(algo, graph, cfg, params=shard_params(algo, source)),
        graph, cfg, mesh=shard_mesh(cfg, device))
    if on_card:
        torch.cuda.synchronize()
    return state, stats, info, time.perf_counter() - t0


def host_outcome(state, stats, info) -> dict:
    """What the card's run is held against: the state's leaves, RunStats
    and info, on the host."""
    return {"leaves": [x.cpu() for x in leaves(state)],
            "stats": [int(x) for x in stats], "info": info}


def shard_child() -> None:
    """The body of a CPU child (``SHARD_CHILD`` names its part): ``full``,
    the full-width PageRank on the 1-D mesh over its first
    ``HOST_ROUNDS``; ``small``, each ``SHARD_SMALL_CELLS`` drain whole,
    and [4j]'s traced 2x2 BFS and sharded PageRank stream; pickled for
    [4i] and [4j].  (The CPU expands coloring's flat budget, 17.5 M
    units a shard body at rmat(21), in seconds: the full-width coloring is
    held against the plain backend on the card instead, as [4d] holds
    its persistent drain.)"""
    import os
    import pickle

    started = time.perf_counter()
    spec = json.loads(os.environ["SHARD_CHILD"])
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    from repro_torch.graph import rmat

    out = {}
    graph = rmat(spec["scale"], edge_factor=16, seed=1, device="cpu")
    if spec["part"] == "full":
        cfg = shard_config("s4", max_rounds=HOST_ROUNDS)
        out["pagerank"] = host_outcome(*shard_run("pagerank", graph, cfg, 0,
                                                  "cpu")[:3])
    else:
        source = int(torch.argmax(graph.degrees()))
        for algo, cell, kernel in SHARD_SMALL_CELLS:
            out[f"{algo}.{cell}"] = host_outcome(*shard_run(
                algo, graph, shard_config(cell, kernel), source, "cpu")[:3])
        # [4j]'s cells
        out["bfs.2x2.traced"] = traced_small(graph, source, "cpu")
        out["pagerank.stream"] = shard_stream_small(graph, "cpu")
    out["ran"] = time.perf_counter() - started
    with open(spec["out"] + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(spec["out"] + ".tmp", spec["out"])


def start_shard_child(part: str, scale: int) -> dict:
    """Start ``shard_child`` on the CPU (it sees no card; one thread, as
    the server's CPU children, so the host-bound phases keep their
    cores)."""
    import os

    path = ROOT / "build" / f"chip_smoke_shard_{part}.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.unlink(missing_ok=True)
    env = dict(os.environ, REPO=str(ROOT), CUDA_VISIBLE_DEVICES="",
               SHARD_CHILD=json.dumps({"part": part, "scale": scale,
                                       "out": str(path)}))
    logfile = open(path.with_suffix(".log"), "w")
    proc = subprocess.Popen([sys.executable, "-c", _SHARD_CHILD], env=env,
                            stdout=logfile, stderr=subprocess.STDOUT)
    logfile.close()
    CHILDREN.append(proc)
    return {"proc": proc, "path": path, "tag": f"shard.{part}",
            "started": time.perf_counter()}


def same_outcome(label: str, got: dict, want: dict) -> None:
    if len(got["leaves"]) != len(want["leaves"]) or not all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got["leaves"], want["leaves"])):
        raise AssertionError(f"{label}: the state differs from the CPU's")
    if got["stats"] != want["stats"] or got["info"] != want["info"]:
        raise AssertionError(f"{label}: stats differ from the CPU's: "
                             f"{got['stats']} {got['info']} vs "
                             f"{want['stats']} {want['info']}")


def shard_launches(algo: str, cell: str, steps: int) -> dict:
    """The launches a persistent sharded drain of ``steps`` predicated
    steps implies on four shards: B1 a body (three for coloring's flat
    gathers), the ordered scatter-add a PageRank body, and B2 two pushes a
    shard a step plus the steal push when stealing (a deferred cell has no
    staged push in its first step and one flush at the end)."""
    s = SHARD_CELLS[cell]["num_shards"]
    pushes = 2 + (SHARD_CELLS[cell].get("steal_threshold", 0) > 0)
    counts = {"lbs": s * steps * (3 if algo == "coloring" else 1),
              "compact": s * steps * pushes}
    if algo == "pagerank":
        counts["ordered_scatter_add"] = s * steps
    return only(**counts)


@contextlib.contextmanager
def first_window_profiled(window: dict):
    """Run the first poll window (``POLL_EVERY`` predicated steps) of the
    first persistent sharded drain inside under the profiler: ``window``
    gets its wall ``secs`` (synchronized) and the profiler ``prof``.  Only
    that window is recorded: the profiler's cost grows with the ops it
    records, and a whole drain records hundreds of thousands."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.shard import driver

    real = driver.no_host_sync

    @contextlib.contextmanager
    def guard(device):
        if window:
            with real(device):
                yield
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with real(device):
                yield
            torch.cuda.synchronize()
            window["secs"] = time.perf_counter() - t0
        window["prof"] = prof

    driver.no_host_sync = guard
    try:
        yield
    finally:
        driver.no_host_sync = real


def sharded_bfs(graph, source: int, dist, cell: str, card: str) -> dict:
    """One full-width sharded BFS: launches, dist, meters and wall (not
    profiled: [4j] profiles its traced ``s4`` cell)."""
    from repro_torch.core.scheduler import POLL_EVERY

    cfg = shard_config(cell)
    reset_counts()
    state, stats, info, secs = shard_run("bfs", graph, cfg, source, "cuda")
    counts = read_counts()
    steps = -(-info["rounds"] // POLL_EVERY) * POLL_EVERY
    if not torch.equal(state.dist, dist):
        bad = int((state.dist != dist).sum())
        raise AssertionError(f"sharded BFS {cell}: dist differs from [4]'s "
                             f"single drain at {bad} vertices")
    if info["mis_routed"] or info["dropped"]:
        raise AssertionError(f"sharded BFS {cell}: mis_routed "
                             f"{info['mis_routed']}, dropped "
                             f"{info['dropped']} (route drops included)")
    if SHARD_CELLS[cell].get("steal_threshold") and not info["donated"]:
        raise AssertionError(f"sharded BFS {cell}: stealing donated nothing")
    implied = shard_launches("bfs", cell, steps)
    if counts != implied:
        raise AssertionError(f"sharded BFS {cell}: launches {counts}, the "
                             f"{steps} predicated steps imply {implied}")
    log(f"    BFS sharded.persistent {cell} ({cfg.mesh_shape or '1-D'}, "
        f"defer {cfg.defer_rounds}, compress {cfg.compress}, steal "
        f"{cfg.steal_threshold}): dist equals [4]'s; rounds "
        f"{info['rounds']}, exchanged {info['exchanged']} (row "
        f"{info['exchanged_row']}, col {info['exchanged_col']}), donated "
        f"{info['donated']}, wire {info['wire_ints']} ints (payload "
        f"{info['payload_ints']}, padding {info['padding_ints']}), deferred "
        f"{info['deferred']}, balance {info['occupancy_balance']:.3f}; "
        f"launches {counts} as {steps} steps imply; wall {secs:.3f} s "
        f"({1e3 * secs / steps:.2f} ms a step)  [{card}]")
    return {"info": info, "launches": counts, "steps": steps,
            "seconds": secs}


def sharded_first_rounds(algo: str, graph, source: int, card: str,
                         want: dict) -> dict:
    """PageRank or coloring on the 1-D mesh at full width, cut at
    ``SHARD_FIRST_ROUNDS``: the launches its steps imply, nothing
    mis-routed or dropped; its first rounds bitwise equal to ``want``
    (``{"rounds": r, "outcome": ...}``).  (Every shard is seeded with its
    whole block, so no occupancy skew arises early to steal from.)"""
    cut = want["rounds"]
    if cut != SHARD_FIRST_ROUNDS:
        got = host_outcome(*shard_run(algo, graph, shard_config(
            "s4", max_rounds=cut), source, "cuda")[:3])
        same_outcome(f"{algo} s4, first {cut} rounds", got,
                     want["outcome"])
    reset_counts()
    state, stats, info, secs = shard_run(
        algo, graph, shard_config("s4", max_rounds=SHARD_FIRST_ROUNDS),
        source, "cuda")
    counts = read_counts()
    if cut == SHARD_FIRST_ROUNDS:
        same_outcome(f"{algo} s4, first {cut} rounds",
                     host_outcome(state, stats, info), want["outcome"])
    implied = shard_launches(algo, "s4", SHARD_FIRST_ROUNDS)
    if counts != implied or info["rounds"] != SHARD_FIRST_ROUNDS:
        raise AssertionError(f"sharded {algo}: rounds {info['rounds']}, "
                             f"launches {counts}, implied {implied}")
    if info["mis_routed"] or info["dropped"]:
        raise AssertionError(f"sharded {algo}: {info}")
    log(f"    {algo} sharded.persistent s4 at full width: the first {cut} "
        f"rounds equal {want['held_against']} bit for bit (state, RunStats, "
        f"info); {SHARD_FIRST_ROUNDS} rounds: exchanged "
        f"{info['exchanged']}, donated {info['donated']}, wire "
        f"{info['wire_ints']}, launches {counts} as implied; wall "
        f"{secs:.3f} s ({1e3 * secs / SHARD_FIRST_ROUNDS:.2f} ms a round)"
        f"  [{card}]")
    return {"info": info, "launches": counts, "seconds": secs,
            "held_rounds": cut, "held_against": want["held_against"]}


def sharded_path(graph, source: int, dist, children: dict, card: str,
                 small_scale: int) -> dict:
    """Phase 4i: the sharded topology on four shards of one card (ROADMAP
    A12).  BFS from [4]'s source on the 2x2 deferred, compressed, stealing
    mesh, its dist [4]'s (the 1-D strict mesh's drain runs in [4j]);
    PageRank and
    coloring on the 1-D mesh over their first rounds (PageRank's first
    ``HOST_ROUNDS`` against the CPU child, coloring's against the plain
    backend on the card); every ``SHARD_SMALL_CELLS`` drain whole at
    ``small_scale`` against the CPU child."""
    from repro_torch.graph import rmat
    from repro_torch.shard import block_bounds

    t_start = time.perf_counter()
    # the edges each shard's col_idx holds, from row_ptr (partition_graph
    # cuts the same slices)
    rp = graph.row_ptr.cpu().numpy()
    n = graph.num_vertices
    own = [int(rp[hi] - rp[lo])
           for lo, hi in (block_bounds(d, n, 4) for d in range(4))]
    stored = {"no halo": own,
              "halo": [own[d] + own[(d - 1) % 4] for d in range(4)]}
    log(f"    the partition's col_idx, edges a shard: {stored} (int32; "
        f"the widest with the halo {4 * max(stored['halo']) / 2**20:.1f} "
        f"MiB, all {4 * sum(stored['halo']) / 2**20:.1f} MiB)")
    # the s4 drain runs in [4j], as batch 0 of the sharded stream and as
    # the traced server job (profiled there); the 2x2 drain's profiled
    # window (about 7 s) is left out to pay for [4j]
    out = {"edges_stored": stored,
           "bfs": {"2x2": sharded_bfs(graph, source, dist, "2x2", card)}}
    # coloring's reference: the same cell on the plain backend on the card
    # (integer work: bitwise there, as [4d] holds its persistent drain)
    plain = host_outcome(*shard_run("coloring", graph, shard_config(
        "s4", max_rounds=HOST_ROUNDS, backend="torch"), source, "cuda")[:3])
    out["coloring"] = sharded_first_rounds(
        "coloring", graph, source, card,
        {"rounds": HOST_ROUNDS, "outcome": plain,
         "held_against": "the plain backend on the card"})
    full = wait_server_child(children["full"])
    log(f"    CPU child (the full-width PageRank): ran {full['ran']:.1f} s, "
        f"waited {full['waited']:.1f} s")
    out["pagerank"] = sharded_first_rounds(
        "pagerank", graph, source, card,
        {"rounds": HOST_ROUNDS, "outcome": full["pagerank"],
         "held_against": "the CPU"})

    small = wait_server_child(children["small"])
    children["small_result"] = small  # [4j] holds its cells against it too
    log(f"    CPU child (the rmat({small_scale}) cells): ran "
        f"{small['ran']:.1f} s, waited {small['waited']:.1f} s")
    g_small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    s_source = int(torch.argmax(g_small.degrees()))
    out["small"] = {}
    for algo, cell, kernel in SHARD_SMALL_CELLS:
        label = f"{algo}.{cell}"
        state, stats, info, secs = shard_run(
            algo, g_small, shard_config(cell, kernel), s_source, "cuda")
        same_outcome(f"rmat({small_scale}) {label} {kernel}",
                     host_outcome(state, stats, info), small[label])
        if info["mis_routed"] or info["dropped"]:
            raise AssertionError(f"{label}: {info}")
        out["small"][label] = {"kernel": kernel, "info": info,
                               "seconds": secs}
    log(f"    rmat({small_scale}) whole drains on the card equal the CPU's "
        f"bit for bit: " + ", ".join(
            f"{k} {v['kernel']} {v['info']['rounds']} rounds "
            f"{v['seconds']:.2f} s" for k, v in out["small"].items())
        + f"  [{card}]")
    out["seconds"] = time.perf_counter() - t_start
    out["children"] = {"full": {"ran": full["ran"], "waited": full["waited"]},
                       "small": {"ran": small["ran"],
                                 "waited": small["waited"]}}
    log(f"    [4i] took {out['seconds']:.1f} s  [{card}]")
    return out


# -------------- phase 4j: sharded streams, jobs and tracing (A12)
#: the rmat(14) sharded streams' log (PageRank takes its first batch, at
#: eps 1e-4: each of its rounds is host-bound on the card)
SHARD_STREAM_SMALL = {"num_batches": 2, "batch_size": 256, "seed": 7,
                      "insert_frac": 0.5}
SHARD_PR_STREAM = {"damping": 0.85, "eps": 1e-4, "check_size": 64}
#: the sharding CLI at a small scale, on the card and on the CPU
SHARD_CLI = ["--jobs", "3", "--scale", "8", "--grid-side", "12",
             "--shards", "4", "--mesh", "2", "2", "--overlap", "--compress",
             "--stream", "2"]


@contextlib.contextmanager
def batch_ends(record):
    """Call ``record(state)`` with each batch drain's final state of the
    streams run inside (``stream/driver``'s two drive functions, wrapped
    for the duration): the per-batch results a stream does not return."""
    from repro_torch.stream import driver

    shared, sharded = driver._drive_shared, driver._drive_sharded

    def drive_shared(*a, **k):
        carry = shared(*a, **k)
        record(carry[1])
        return carry

    def drive_sharded(*a, **k):
        out = sharded(*a, **k)
        record(out[1])
        return out

    driver._drive_shared, driver._drive_sharded = drive_shared, drive_sharded
    try:
        yield
    finally:
        driver._drive_shared, driver._drive_sharded = shared, sharded


@contextlib.contextmanager
def shard_stats(sink: list):
    """Append the ``ShardRunStats`` of each ``shard.run_sharded`` call made
    inside (the stream driver looks it up at each call)."""
    import repro_torch.shard as shard

    real = shard.run_sharded

    def run(*a, **k):
        state, stats = real(*a, **k)
        sink.append(stats)
        return state, stats

    shard.run_sharded = run
    try:
        yield
    finally:
        shard.run_sharded = real


@contextlib.contextmanager
def timed_reshards(rows: list):
    """Append ``{"seconds", "dirty"}`` for each ``stream.reshard`` the
    stream driver calls inside: its wall (synchronized) and the shards it
    rebuilt (all of them for the first, full build)."""
    from repro_torch.stream import driver

    real = driver.reshard

    def timed(*a, **k):
        prev = k.get("parts")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = real(*a, **k)
        torch.cuda.synchronize()
        rows.append({"seconds": time.perf_counter() - t0, "dirty": [
            d for d in range(parts.num_shards)
            if prev is None or parts.col_idx[d] is not prev.col_idx[d]]})
        return parts

    driver.reshard = timed
    try:
        yield
    finally:
        driver.reshard = real


def shard_stream_small(graph, device) -> tuple:
    """The rmat(14) sharded PageRank stream on ``device`` (s4, persistent):
    ``(outcome, records, info)``; ``outcome`` is the final state's leaves
    as :func:`host_outcome` gives them."""
    from repro_torch.graph import edge_delta_stream
    from repro_torch.runtime import stream_execute

    cfg = shard_config("s4")
    deltas = edge_delta_stream(graph, **SHARD_STREAM_SMALL)[:1]
    res = stream_execute("pagerank", graph, deltas, cfg,
                         params=dict(SHARD_PR_STREAM),
                         mesh=shard_mesh(cfg, device), **STREAM_KNOBS)
    info = {k: v for k, v in res.info.items() if k != "commit_seconds"}
    return ({"leaves": [x.cpu() for x in leaves(res.state)]},
            records_of(res), info)


def traced_small(graph, source: int, device) -> dict:
    """BFS on the rmat(14) 2x2 mesh with deferred delivery, the codec and
    stealing under ``sharded.discrete``, traced: outcome, rows and the
    shard_run doc."""
    from repro_torch.obs import Trace
    from repro_torch.runtime import build_program, execute

    cfg = shard_config("2x2", "discrete")
    trace = Trace(capacity=TRACE_CAPACITY)
    state, stats, info = execute(
        build_program("bfs", graph, cfg, params={"source": source}), graph,
        cfg, mesh=shard_mesh(cfg, device), trace=trace)
    out = host_outcome(state, stats, info)
    out["rows"] = trace.records
    out["docs"] = trace.metrics
    return out


def start_shard_cli(device: str) -> tuple:
    """The sharding CLI as a child process: on the card, its four shards
    stacked on ``cuda:0``; on the CPU, seeing no card."""
    import os

    cmd = [sys.executable, "-m", "repro_torch.launch.taskserver",
           *SHARD_CLI, "--device", device]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    if device == "cuda":
        cmd += ["--shard-devices", ",".join(["cuda:0"] * 4)]
    else:  # one thread, as the other CPU children
        env.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    CHILDREN.append(proc)
    return proc, cmd, time.perf_counter()


def wait_shard_cli(started) -> tuple:
    proc, cmd, t0 = started
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"`{' '.join(cmd[1:])}` exited "
                             f"{proc.returncode}:\n{stderr[-3000:]}")
    return stdout, time.perf_counter() - t0


def sharded_server_job(graph, source: int, dist, s4: dict, card: str,
                       small_scale: int) -> dict:
    """[4j](a): BFS on ``graph`` as a ``JobSpec(shards=4)`` on four shards
    of the card beside one small fused tenant, traced: dist equal to [4]'s
    and the telemetry to the untraced s4 drain's (``s4``: batch 0 of
    (b)'s stream, the same drain); rows rounds x 4, their pops and
    exchanged sums the run's; B1 and B2 as the steps imply; the job's
    first ``POLL_EVERY`` steps under the profiler."""
    from repro_torch.core import SchedulerConfig
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.graph import rmat
    from repro_torch.obs import Trace
    from repro_torch.server import JobRegistry, JobSpec, TaskServer

    reg = JobRegistry()
    reg.register_graph("rmat", graph)
    reg.register_graph("small", rmat(small_scale, edge_factor=16, seed=1,
                                     device="cuda"))
    trace = Trace(capacity=TRACE_CAPACITY)
    server = TaskServer(reg, num_lanes=2,
                        config=SchedulerConfig(num_workers=SHARD_W["workers"],
                                               fetch_size=SHARD_W["fetch"]),
                        trace=trace, device="cuda",
                        shard_devices=[torch.device("cuda", 0)] * 4)
    server.submit(JobSpec("bfs", "rmat", {"source": source}, shards=4))
    server.submit(JobSpec("bfs", "small", {"source": 0}))
    window = {}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with first_window_profiled(window):
        res = server.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    info = s4["info"]
    if not np.array_equal(res.results[0], dist.cpu().numpy()):
        raise AssertionError("the sharded server job's dist differs from "
                             "[4]'s")
    doc = next(d for d in trace.metrics if d["kind"] == "shard_run")
    tel = res.telemetry[0]
    mine = {"rounds": doc["rounds"], "work": tel.work,
            "dropped": doc["dropped"] + doc["route_dropped"],
            "exchanged": doc["exchanged"], "donated": doc["donated"],
            "steal_rounds": doc["steal_rounds"],
            "mis_routed": doc["mis_routed"],
            "occupancy_balance": doc["occupancy_balance"],
            "exchanged_row": doc["exchanged_row"],
            "exchanged_col": doc["exchanged_col"],
            "payload_ints": doc["payload_ints"],
            "padding_ints": doc["padding_ints"],
            "wire_ints": doc["wire_ints"],
            "deferred": doc["deferred_delivered"],
            "overlap_rounds": doc["overlap_rounds"],
            "overlap_occupancy": doc["overlap_occupancy"]}
    if mine != {k: info[k] for k in mine} or tel.rounds_active != \
            info["rounds"] or tel.dropped != info["dropped"] or \
            tel.items_processed != doc["items_processed"]:
        raise AssertionError(f"the sharded job's telemetry differs from "
                             f"the untraced s4 drain's: {mine} vs {info}")
    rows = [r for r in trace.records if r["engine"] == "server.job0.sharded"]
    if len(rows) != 4 * info["rounds"] or trace.truncated \
            or sum(r["pops"] for r in rows) != doc["items_processed"] \
            or sum(r["exchanged"] for r in rows) != info["exchanged"]:
        raise AssertionError(f"the sharded job's rows: {len(rows)} for "
                             f"{info['rounds']} rounds x 4, sums "
                             f"{sum(r['pops'] for r in rows)} pops, "
                             f"{sum(r['exchanged'] for r in rows)} exchanged")
    steps = -(-info["rounds"] // POLL_EVERY) * POLL_EVERY
    tenant = server.jobs[1]
    implied = shard_launches("bfs", "s4", steps)
    implied["lbs"] += B1_PER_STEP["bfs"] * tenant.lane_steps
    implied["compact"] += tenant.lane_steps + tenant.empty_steps + 1
    if counts != implied or res.stats.sharded_jobs != 1 \
            or res.stats.sharded_rounds != info["rounds"]:
        raise AssertionError(f"the sharded server run: launches {counts}, "
                             f"implied {implied}; stats {res.stats}")
    prof_rows = sorted(device_rows(window["prof"]), key=lambda r: -r[1])
    dev_ms = sum(ms for _, ms, _ in prof_rows)
    ops = sum(calls for _, _, calls in prof_rows) / POLL_EVERY
    busy = dev_ms / (1e3 * window["secs"]) if dev_ms > 0 else None
    log(f"    server: JobSpec(shards=4) BFS on rmat from [4]'s source beside "
        f"a fused BFS on rmat({small_scale}), traced: dist equals [4]'s, "
        f"telemetry the untraced s4 drain's; {len(rows)} rows = "
        f"{info['rounds']} "
        f"rounds x 4, pops and exchanged sums equal the run's; launches "
        f"{counts} as the {steps} steps and the tenant's "
        f"{tenant.lane_steps} lane steps imply; sharded_jobs 1; server run "
        f"{secs:.3f} s (its first {POLL_EVERY} steps under the profiler, "
        f"{window['secs']:.3f} s of it) against the untraced s4 drain's "
        f"{s4['seconds']:.3f} s  [{card}]")
    log(f"    the server job's first {POLL_EVERY} steps under the profiler: "
        f"{ops:.1f} device ops a step, busy "
        f"{busy if busy is None else round(busy, 3)}, "
        f"{1e3 * window['secs'] / POLL_EVERY:.2f} ms a step  [{card}]")
    return {"launches": counts, "steps": steps, "seconds": secs,
            "tenant_lane_steps": tenant.lane_steps, "rows": len(rows),
            "window_seconds": window["secs"], "window_device_ms": dev_ms,
            "device_ops_a_step": ops, "busy": busy,
            "profile_rows": prof_rows[:12]}


def sharded_stream_full(graph, deltas, source: int, dist,
                        batch_dists: list, card: str) -> dict:
    """[4j](b): BFS on ``sharded.persistent`` s4 over [4g]'s delta log,
    incremental, with [4g]'s compaction knobs: each batch's dist equals
    [4g]'s ``single.megakernel`` stream's at that batch (batch 0's is
    [4]'s); nothing mis-routed or dropped.  Batch 0 is the whole s4 drain
    on the base graph: its ``ShardRunStats`` and wall are (a)'s untraced
    reference."""
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.runtime import stream_execute

    cfg = shard_config("s4")
    dists, reshards, stats = [], [], []
    with batch_ends(lambda st: dists.append(st.dist.clone())), \
            timed_reshards(reshards), shard_stats(stats):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = stream_execute("bfs", graph, deltas, cfg,
                             params={"source": source},
                             mesh=shard_mesh(cfg, "cuda"), **STREAM_KNOBS)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    counts = read_counts()
    if len(dists) != len(batch_dists) or not all(
            torch.equal(a, b) for a, b in zip(dists, batch_dists)):
        bad = [b for b, (x, y) in enumerate(zip(dists, batch_dists))
               if not torch.equal(x, y)]
        raise AssertionError(f"the sharded stream's dist differs from "
                             f"[4g]'s at batches {bad}")
    if not torch.equal(dists[0], dist):
        raise AssertionError("the sharded stream's batch 0 (the whole s4 "
                             "drain) differs from [4]'s dist")
    if res.info["mis_routed"] or res.info["dropped"]:
        raise AssertionError(f"the sharded stream: {res.info}")
    # BFS's commit and reseed run no kernel: every launch is a shard body's
    steps = [-(-st.rounds // POLL_EVERY) * POLL_EVERY for st in stats]
    implied = shard_launches("bfs", "s4", sum(steps))
    if counts != implied:
        raise AssertionError(f"the sharded stream's launches {counts}, the "
                             f"{sum(steps)} predicated steps imply {implied}")
    rows = log_batches("BFS sharded.persistent s4", res, card)
    for row, rs in zip(rows, reshards):
        row["reshard_s"], row["dirty_shards"] = rs["seconds"], rs["dirty"]
        log(f"      batch {row['batch']}: reshard {rs['seconds']:.4f} s "
            f"(in its commit seconds), rebuilt shards {rs['dirty']}  "
            f"[{card}]")
    info = {k: v for k, v in res.info.items() if k != "commit_seconds"}
    # batch 0 is one run_sharded call (no snapshots): the untraced s4 drain
    first = stats[0]
    s4 = {"seconds": res.batches[0].drain_seconds, "stats": first,
          "info": {"rounds": first.rounds,
                   "work": res.batches[0].work,
                   "dropped": first.dropped + first.route_dropped,
                   "exchanged": first.exchanged, "donated": first.donated,
                   "steal_rounds": first.steal_rounds,
                   "mis_routed": first.mis_routed,
                   "occupancy_balance": first.occupancy_balance,
                   "exchanged_row": first.exchanged_row,
                   "exchanged_col": first.exchanged_col,
                   "payload_ints": first.payload_ints,
                   "padding_ints": first.padding_ints,
                   "wire_ints": first.wire_ints,
                   "deferred": first.deferred_delivered,
                   "overlap_rounds": first.overlap_rounds,
                   "overlap_occupancy": first.overlap_occupancy}}
    log(f"    BFS stream sharded.persistent s4: every batch's dist equals "
        f"[4g]'s single.megakernel stream's, batch 0's [4]'s; info {info}; "
        f"launches {counts} as its {sum(steps)} predicated steps imply; "
        f"batch 0, the whole s4 drain: {first.rounds} rounds, "
        f"{s4['seconds']:.3f} s; the stream {secs:.3f} s  [{card}]")
    return {"seconds": secs, "launches": counts, "info": info,
            "batches": rows, "steps": steps, "s4": s4}


def sharded_small(small: dict, card: str, small_scale: int) -> dict:
    """[4j](c): at rmat(14) the traced 2x2 discrete BFS and the sharded
    PageRank stream on the card against the CPU child's, bitwise, the
    stream's launches as its steps and reseeds imply; a sharded BFS
    stream snapshotted and resumed on the card, the resumed run
    bit-identical to the snapshotted one (the CPU tests hold a
    snapshotted stream equal to an uninterrupted one)."""
    from repro_torch.core.scheduler import POLL_EVERY
    from repro_torch.graph import edge_delta_stream, rmat
    from repro_torch.runtime import stream_execute

    g_small = rmat(small_scale, edge_factor=16, seed=1, device="cuda")
    s_source = int(torch.argmax(g_small.degrees()))
    out = {}
    reset_counts()
    t0 = time.perf_counter()
    traced = traced_small(g_small, s_source, "cuda")
    counts = read_counts()
    want = small["bfs.2x2.traced"]
    same_outcome(f"rmat({small_scale}) traced 2x2 discrete BFS", traced,
                 want)
    if traced["rows"] != want["rows"] or [
            d for d in traced["docs"] if d["kind"] == "shard_run"] != [
            d for d in want["docs"] if d["kind"] == "shard_run"]:
        raise AssertionError("the traced 2x2 BFS's rows or shard_run doc "
                             "differ from the CPU's")
    if not (counts["lbs"] and counts["compact"]) or counts != only(
            lbs=counts["lbs"], compact=counts["compact"]):
        raise AssertionError(f"the traced 2x2 BFS's launches: {counts}")
    out["traced"] = {"seconds": time.perf_counter() - t0,
                     "rows": len(traced["rows"]),
                     "rounds": traced["info"]["rounds"], "launches": counts}
    stats = []
    reset_counts()
    t0 = time.perf_counter()
    with shard_stats(stats):
        outcome_, records, info = shard_stream_small(g_small, "cuda")
    counts = read_counts()
    w_out, w_records, w_info = small["pagerank.stream"]
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(outcome_["leaves"], w_out["leaves"])) \
            or records != w_records or info != w_info:
        raise AssertionError(f"the rmat({small_scale}) sharded PageRank "
                             f"stream differs from the CPU's: {info} vs "
                             f"{w_info}")
    # the shard bodies at every predicated step, and the reseed's float64
    # sums: once, and once a decay sweep, an incremental batch
    steps = sum(-(-st.rounds // POLL_EVERY) * POLL_EVERY for st in stats)
    reseed_sums = sum(1 + r["reseed_sweeps"] for r in records
                      if r["incremental"])
    implied = shard_launches("pagerank", "s4", steps)
    implied["ordered_scatter_add"] += reseed_sums
    if counts != implied:
        raise AssertionError(f"the sharded PageRank stream's launches "
                             f"{counts}, its {steps} predicated steps and "
                             f"{reseed_sums} reseed sums imply {implied}")
    out["pagerank_stream"] = {"seconds": time.perf_counter() - t0,
                              "info": info, "launches": counts,
                              "steps": steps, "reseed_sums": reseed_sums}
    # snapshots every 4 rounds of a sharded BFS stream, resumed in-process
    snap_dir = ROOT / "build" / "chip_smoke_shard_snapshots"
    shutil.rmtree(snap_dir, ignore_errors=True)
    cfg = shard_config("s4")
    deltas = edge_delta_stream(g_small, **SHARD_STREAM_SMALL)

    def bfs_stream(**kw):
        return stream_execute("bfs", g_small, deltas, cfg,
                              params={"source": s_source},
                              mesh=shard_mesh(cfg, "cuda"), **STREAM_KNOBS,
                              snapshot_every=4, checkpoint_dir=str(snap_dir),
                              keep=1000, **kw)

    t0 = time.perf_counter()
    ticks = []
    whole = bfs_stream(snapshot_hook=lambda t, b: ticks.append((t, b)))
    tick, batch = [t for t in ticks if t[1] == 1][-1]
    for t, _ in ticks:
        if t > tick:
            shutil.rmtree(snap_dir / f"snap_{t}")
    resumed = bfs_stream(resume=True)
    shutil.rmtree(snap_dir, ignore_errors=True)
    if resumed.info["resumed_at"] != batch \
            or not same_leaves(resumed.state, whole.state) \
            or records_of(resumed) != records_of(whole)[batch:]:
        raise AssertionError(f"the sharded stream resumed from snapshot "
                             f"{tick} differs: {resumed.info}")
    out["resume"] = {"seconds": time.perf_counter() - t0,
                     "snapshots": len(ticks), "resumed_at": batch}
    log(f"    rmat({small_scale}) on the card equal to the CPU bit for bit: "
        f"the traced 2x2 discrete BFS ({traced['info']['rounds']} rounds, "
        f"{len(traced['rows'])} rows, the shard_run doc; launches "
        f"{out['traced']['launches']}), the sharded PageRank stream (state, "
        f"records, info; {info['rounds']} rounds; launches {counts} as its "
        f"{steps} steps and {reseed_sums} reseed sums imply); the sharded "
        f"BFS stream resumed from snapshot {tick} of {len(ticks)} (batch "
        f"{batch}) bit-identical to the snapshotted run  [{card}]")
    return out


def sharded_more_path(graph, source: int, dist, sharded: dict, stream: dict,
                      children: dict, card: str, small_scale: int) -> dict:
    """Phase 4j: the sharded stream, sharded server jobs, the CLI's
    sharding flags and sharded tracing on four shards of one card -- a
    traced sharded server job, the sharded stream over [4g]'s log, the
    rmat(14) cells against the CPU, the sharding CLI on the card against
    the CPU (its CPU child started after [2])."""
    t_start = time.perf_counter()
    out = {"stream": sharded_stream_full(graph, stream.pop("log"), source,
                                         dist, stream.pop("batch_dists"),
                                         card)}
    s4 = out["stream"].pop("s4")
    out["s4_untraced"] = {"seconds": s4["seconds"], "info": s4["info"]}
    out["server_job"] = sharded_server_job(graph, source, dist, s4, card,
                                           small_scale)
    # the CLI on the card runs beside the small cells (as [4h]'s CLI child
    # runs beside its cells), not beside the timed full-width runs
    cli = start_shard_cli("cuda")
    out["small"] = sharded_small(children.pop("small_result"), card,
                                 small_scale)
    card_out, card_secs = wait_shard_cli(cli)
    cpu_out, cpu_secs = wait_shard_cli(children["cli"])

    def table(text):
        return [line.split(" wall=")[0] for line in text.splitlines()]

    if table(card_out) != table(cpu_out):
        raise AssertionError(f"the sharding CLI on the card differs from "
                             f"the CPU's:\n{card_out}\n---\n{cpu_out}")
    log(f"    CLI `{' '.join(SHARD_CLI)} --device cuda --shard-devices "
        f"cuda:0,cuda:0,cuda:0,cuda:0`: its table equals --device cpu's, "
        f"wall aside (the card's child {card_secs:.1f} s; the CPU's, "
        f"started after [2], read {cpu_secs:.1f} s after its start)  "
        f"[{card}]")
    for line in card_out.splitlines()[:12]:
        log(f"      {line}")
    out["cli"] = {"seconds": card_secs, "cpu_read_after": cpu_secs,
                  "stdout": card_out}
    out["seconds"] = time.perf_counter() - t_start
    log(f"    [4j] took {out['seconds']:.1f} s  [{card}]")
    return out


# ------------------------------------------------------ B5, phases 3 and 6
# (label, B, H, KVH, Sq, Skv, D, dtype, causal, window); the first is the
# LM path's per-layer shape (minitron-4b prefill, B=2 x T=4096)
FLASH_MAIN = ("minitron-4b layer", 2, 24, 8, 4096, 4096, 128,
              torch.bfloat16, True, 0)
FLASH_CASES = [
    FLASH_MAIN,
    ("h2o-danube-3-4b layer", 1, 32, 8, 8192, 8192, 120, torch.bfloat16,
     True, 4096),
    ("stablelm-1.6b layer (MHA)", 2, 32, 32, 4096, 4096, 64, torch.bfloat16,
     True, 0),
    ("JAX test 2x2x128 D128", 1, 2, 2, 128, 128, 128, torch.float32, True, 0),
    ("JAX test 2x2x128 D128", 1, 2, 2, 128, 128, 128, torch.float32, False,
     0),
    ("JAX test 4x2x256 D128", 1, 4, 2, 256, 256, 128, torch.float32, True, 0),
    ("JAX test 4x2x256 D128", 1, 4, 2, 256, 256, 128, torch.float32, False,
     0),
    ("JAX test 4x1x256 D256", 1, 4, 1, 256, 256, 256, torch.float32, True, 0),
    ("JAX test 4x1x256 D256", 1, 4, 1, 256, 256, 256, torch.float32, False,
     0),
    ("Sq > Skv + window, fully masked rows", 2, 8, 2, 384, 128, 120,
     torch.float32, True, 64),
    ("Sq > Skv + window, fully masked rows", 2, 8, 2, 384, 128, 120,
     torch.bfloat16, True, 64),
]
F32_TOL = 2e-5      # the JAX tests' tolerance for the Pallas kernel


def flash_inputs(case, seed: int) -> tuple:
    _, b, h, kvh, s_q, s_kv, d, dtype, _, _ = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b * h, s_q, d), (b * kvh, s_kv, d),
                               (b * kvh, s_kv, d)))


def bf16_excess(got, want) -> torch.Tensor:
    """How far each element of two bf16 results lies beyond one bf16 step
    at the larger magnitude (<= 0 within one step)."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    return (got - want).abs() - torch.exp2(torch.floor(torch.log2(mag)) - 7)


def check_flash() -> float:
    """Phase 3 for B5: the kernel against ``attention_ref`` on the card.
    f32 within F32_TOL; bf16: both sides round f32 math once, so every
    element must lie within one bf16 step (plus 1e-6 where a row's sum
    cancels to near zero).  Rows with no live key must give mean(v).
    Returns the max |error| at the main shape."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    log(f"  B5 plain version in f32 with allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")
    main_err = None
    for i, case in enumerate(FLASH_CASES):
        label, b, h, kvh, s_q, s_kv, d, dtype, causal, window = case
        q, k, v = flash_inputs(case, seed=i)
        got = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if dtype == torch.float32:
            ok = err <= F32_TOL
            rule = f"<= {F32_TOL}"
        else:
            excess = float(bf16_excess(got, want).max())
            ok = excess <= 1e-6
            rule = (f"within one bf16 step everywhere (excess {excess:.3g}), "
                    f"{float((got != want).float().mean()):.3%} of elements "
                    f"differ")
        dead = s_kv + window - 1 if window else s_q
        if dead < s_q:
            mean_v = v.float().mean(dim=1).repeat_interleave(h // kvh, dim=0)
            mean_err = float((got[:, dead:].float()
                              - mean_v[:, None]).abs().max())
            ok = ok and mean_err <= (F32_TOL if dtype == torch.float32
                                     else 2 ** -7)
            rule += f"; rows {dead}.. equal mean(v) within {mean_err:.3g}"
        log(f"  B5 flash_attention {label}: B={b} H={h} KVH={kvh} Sq={s_q} "
            f"Skv={s_kv} D={d} {str(dtype)[6:]} causal={causal} "
            f"window={window}: max_abs_err={err:.3g} {rule}")
        if not ok:
            raise AssertionError(f"flash attention kernel disagrees with "
                                 f"attention_ref: {label}")
        if case is FLASH_MAIN:
            main_err = err
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return main_err


def flash_bound() -> tuple:
    """(bound ms, bound_by) of one call at the main shape (bf16, causal,
    Sq == Skv): flops 4 B H D S(S+1)/2 at the bf16 tensor-core peak
    against q, k, v read and o written once."""
    _, b, h, kvh, s, _, d, _, _, _ = FLASH_MAIN
    flops = 4 * b * h * d * s * (s + 1) // 2
    nbytes = 2 * d * s * (2 * b * h + 2 * b * kvh)
    ms_ops, ms_bytes = 1e3 * flops / BF16_FLOPS, 1e3 * nbytes / HBM_BYTES_PER_S
    return ((ms_ops, "operations") if ms_ops >= ms_bytes
            else (ms_bytes, "bytes"))


SASS_OPS = ("HGMMA", "UTMALDG")     # wgmma and TMA loads in B5's SASS


def flash_sass() -> dict:
    """How often each of SASS_OPS occurs in the built B5 library
    (``cuobjdump -sass``); fails if either is missing."""
    from repro_torch.kernels import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass",
                           str(build.library_path("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in SASS_OPS}
    if not all(counts.values()):
        raise AssertionError(f"B5's SASS lacks the tensor-core or TMA "
                             f"instructions: {counts}")
    return counts


def time_flash() -> dict:
    """Phase 6: B5, its plain version and SDPA (enable_gqa) at the main
    shape, by profiler device time over 20 calls and between CUDA events."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    _, b, h, kvh, s, _, d, _, causal, window = FLASH_MAIN
    q, k, v = flash_inputs(FLASH_MAIN, seed=0)
    q4, k4, v4 = (x.view(b, -1, x.shape[1], d) for x in (q, k, v))
    fns = [lambda: flash_attention_cuda(q, k, v, causal=causal,
                                        window=window),
           lambda: attention_ref(q, k, v, causal=causal, window=window),
           lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                  enable_gqa=True)]
    lib = fns[2]().view(b * h, s, d)
    lib_err = float((lib.float() - fns[0]().float()).abs().max())
    profiles = []
    for fn in fns:
        for _ in range(PROFILE_TRIES):  # the profiler may keep no record
            ms, rows = device_profile(fn, reps=20)
            if ms is not None:
                break
        profiles.append((ms, rows))
    by_profiler = [ms for ms, _ in profiles]
    by_events = [cuda_ms(fn, reps=20) for fn in fns]
    timed_by = "profiler device time"
    if None in by_profiler:
        by_profiler, timed_by = by_events, "cuda events"
    bound, bound_by = flash_bound()
    # the CUDA-core instance at the same shape in f32 (its inputs' type)
    q32, k32, v32 = q.float(), k.float(), v.float()
    core_ms = cuda_ms(lambda: flash_attention_cuda(
        q32, k32, v32, causal=causal, window=window), reps=5, warmup=1)
    del q32, k32, v32
    torch.cuda.empty_cache()
    return {"ms": by_profiler[0], "plain_ms": by_profiler[1],
            "cuda_core_f32_event_ms": core_ms,
            "library_ms": by_profiler[2], "timed_by": timed_by,
            "event_ms": by_events[0], "plain_event_ms": by_events[1],
            "library_event_ms": by_events[2], "bound_ms": bound,
            "bound_by": bound_by, "library_vs_kernel_max_abs": lib_err,
            "profiler_rows": [rows[:4] for _, rows in profiles]}


# ------------------------------------------------------- phase 7, LM path
LM_ARCH = "minitron-4b"
LM_BATCH, LM_SEQ = 2, 4096
DECODE_STEPS = 32
#: kernel path error may be this many times the plain bf16 path's ...
BF16_ERR_FACTOR = 1.25
#: ... plus this many bf16 steps at the reference logits' largest
#: magnitude: the logits come out of a bf16 product, whose rounding alone
#: moves the largest ones by half a step
BF16_ABS_STEPS = 1.0
#: f32 prefill through B5: within this share of max |logit| of the f32 plain
#: path, and at most F32_CONTROL_SHARE of the error of the same prefill with
#: bf16 probabilities (``attn_impl="blocked"``), the negative control: a B5
#: that computed its softmax or p @ v in bf16 would err like the control
#: and fail the second test even where the first one let it through
F32_REL = 1e-3
F32_CONTROL_SHARE = 0.1


def lm_positions(seed: int = 0, batch: int = LM_BATCH, seq: int = LM_SEQ,
                 decode_steps: int = DECODE_STEPS) -> tuple:
    """(batch index, position) pairs whose logits are kept: 64 seeded ones,
    each sequence's last position, and the first ``decode_steps`` of
    sequence 0 (the decode replay)."""
    rng = np.random.default_rng(seed)
    rows = list(rng.integers(0, batch, 64))
    cols = list(rng.integers(0, seq, 64))
    rows += list(range(batch)) + [0] * decode_steps
    cols += [seq - 1] * batch + list(range(decode_steps))
    return (torch.tensor(rows, device="cuda"),
            torch.tensor(cols, device="cuda"))


def sampled_prefill(params, cfg, batch: dict, where, attn_impl: str) -> tuple:
    """(f32 logits at ``where``, host seconds, B5 launches) of one prefill
    of ``batch``; the full logits are dropped at once (8.4 GB in f32 for
    minitron-4b at 2 x 4096)."""
    from repro_torch.models import transformer as T

    b, n_text = batch["tokens"].shape
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = T.prefill(params, cfg, batch, n_text, attn_impl=attn_impl)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = read_counts()
    if not torch.isfinite(logits).all() or logits.shape != (
            b, n_text, cfg.vocab_size):
        raise AssertionError(f"{cfg.name} prefill ({attn_impl}, "
                             f"{logits.dtype}) gave non-finite logits or "
                             f"shape {tuple(logits.shape)}")
    kept = logits[where].float()
    del logits
    torch.cuda.empty_cache()
    others = {k: n for k, n in counts.items() if k != "flash_attention"}
    if any(others.values()):
        raise AssertionError(f"the LM prefill launched graph kernels: "
                             f"{counts}")
    return kept, secs, counts["flash_attention"]


def smoke_schedule(requests, arch: str = LM_ARCH) -> dict:
    """The engine's schedule for these request lengths at ``arch``'s smoke
    config on the CPU: (wavefronts, mean occupancy) per mode.  The
    schedule depends only on the lengths, so tokens are taken modulo the
    smoke vocabulary."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import ContinuousBatchingEngine, Request

    cfg = smoke_config(arch)
    params = init_params(T.model_spec(cfg), 0, torch.float32, device="cpu")
    small = [Request(r.uid, [int(t) % cfg.vocab_size for t in r.prompt],
                     r.max_new_tokens) for r in requests]
    out = {}
    for mode in ("continuous", "bsp"):
        st = ContinuousBatchingEngine(cfg, params, num_slots=4, max_len=64,
                                      mode=mode).run(small)["stats"]
        out[mode] = (st.wavefronts, st.mean_occupancy)
    return out


def lm_path(card: str) -> dict:
    """Phase 7; returns what the summary and the kernels line need."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.engine import ContinuousBatchingEngine

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = init_params(T.model_spec(cfg), 0, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    log(f"    {LM_ARCH}: {cfg.param_count()} parameters, {cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.num_heads} q / "
        f"{cfg.num_kv_heads} kv heads of {cfg.hd}, vocab {cfg.vocab_size}; "
        f"bf16 weights made on the card in {time.perf_counter() - t0:.3f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=g, device="cuda")
    where = lm_positions()
    torch.cuda.reset_peak_memory_stats()

    # the main path: bf16 prefill through B5, counts set to 0 just before
    batch = {"tokens": tokens}
    got, secs_cold, launches = sampled_prefill(params, cfg, batch, where,
                                               "auto")
    instances = flash_instances()
    if launches != cfg.num_layers or instances != {
            "tensor_core": cfg.num_layers, "cuda_core": 0}:
        raise AssertionError(f"expected one B5 launch per layer "
                             f"({cfg.num_layers}), all of the tensor-core "
                             f"instance, got {launches} {instances}")
    _, secs_warm, _ = sampled_prefill(params, cfg, batch, where, "auto")
    plain, secs_plain, plain_launches = sampled_prefill(params, cfg, batch,
                                                        where, "torch")
    if plain_launches:
        raise AssertionError("attn_impl='torch' launched B5")
    log(f"    bf16 prefill {LM_BATCH}x{LM_SEQ} through B5: {launches} B5 "
        f"launches; cold {secs_cold:.3f} s, warm {secs_warm:.3f} s "
        f"({LM_BATCH * LM_SEQ / secs_warm:.0f} tokens/s); plain path "
        f"{secs_plain:.3f} s  [{card}]")

    params32 = tree_map(lambda a: a.float(), params)
    ref, secs_ref, _ = sampled_prefill(params32, cfg, batch, where, "torch")
    got32, secs_k32, launches32 = sampled_prefill(params32, cfg, batch,
                                                  where, "auto")
    instances32 = flash_instances()
    control, _, _ = sampled_prefill(params32, cfg, batch, where, "blocked")
    del params32
    torch.cuda.empty_cache()
    if launches32 != cfg.num_layers or instances32 != {
            "tensor_core": 0, "cuda_core": cfg.num_layers}:
        raise AssertionError(f"f32 prefill: {launches32} B5 launches, "
                             f"{instances32}; expected all of the CUDA-core "
                             f"instance")

    scale = float(ref.abs().max())
    abs_term = BF16_ABS_STEPS * 2.0 ** (np.floor(np.log2(scale)) - 7)
    err_k = float((got - ref).abs().max())
    err_p = float((plain - ref).abs().max())
    limit = BF16_ERR_FACTOR * err_p + abs_term
    log(f"    bf16 logits vs the f32 reference at {where[0].numel()} "
        f"positions (max |logit| {scale:.4g}): kernel path {err_k:.4g}, "
        f"plain path {err_p:.4g}; limit {BF16_ERR_FACTOR} x plain + "
        f"{abs_term:.4g} = {limit:.4g}")
    if not err_k <= limit:
        raise AssertionError(f"bf16 kernel-path logits err {err_k} > {limit}")
    err_32 = float((got32 - ref).abs().max())
    err_ctl = float((control - ref).abs().max())
    log(f"    f32 prefill through B5 vs f32 plain: {err_32:.4g} "
        f"({err_32 / scale:.3g} of max |logit|; limit {F32_REL}); bf16-"
        f"probability control (blocked) {err_ctl:.4g}; limit "
        f"{F32_CONTROL_SHARE} x control = {F32_CONTROL_SHARE * err_ctl:.4g}")
    if not (err_32 <= F32_REL * scale
            and err_32 <= F32_CONTROL_SHARE * err_ctl):
        raise AssertionError(f"f32 kernel-path logits err {err_32}: limits "
                             f"{F32_REL * scale}, {F32_CONTROL_SHARE * err_ctl}")

    # decode: replay the first DECODE_STEPS tokens of sequence 0
    reset_counts()
    cache = T.init_cache(cfg, 1, DECODE_STEPS, torch.bfloat16, device="cuda")
    first = len(where[0]) - DECODE_STEPS
    plain_err_0 = float((plain[first:] - ref[first:]).abs().max())
    dec_limit = BF16_ERR_FACTOR * plain_err_0 + abs_term
    dec_errs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(DECODE_STEPS):
        logits, cache = T.decode_step(params, cfg, cache, tokens[:1, t:t + 1])
        dec_errs.append(float((logits[0].float() - ref[first + t]).abs()
                              .max()))
    secs_dec = time.perf_counter() - t0
    if any(read_counts().values()):
        raise AssertionError(f"decode launched a kernel: {read_counts()}")
    log(f"    {DECODE_STEPS} decode steps through the bf16 cache vs the f32 "
        f"reference at the same positions: max err {max(dec_errs):.4g} "
        f"(limit {BF16_ERR_FACTOR} x plain prefill's {plain_err_0:.4g} + "
        f"{abs_term:.4g} = {dec_limit:.4g}); "
        f"{1e3 * secs_dec / DECODE_STEPS:.2f} ms per step (B=1, "
        f"logit checks included)  [{card}]")
    if not max(dec_errs) <= dec_limit:
        raise AssertionError(f"decode logits err {max(dec_errs)} > "
                             f"{dec_limit}")
    # one more step under the profiler: its device time over its wall time
    held = {}

    def one_step():
        t1 = time.perf_counter()
        T.decode_step(params, cfg, cache, tokens[:1, :1])
        torch.cuda.synchronize()
        held["secs"] = time.perf_counter() - t1

    dec_dev_ms, dec_rows = device_profile(one_step)
    dec_ops = sum(calls for _, _, calls in dec_rows)
    log(f"    one decode step under the profiler: {1e3 * held['secs']:.2f} ms "
        f"wall, {dec_dev_ms} ms device time in {dec_ops} device ops, busy "
        f"share {None if dec_dev_ms is None else dec_dev_ms / (1e3 * held['secs'])}"
        f"  [{card}]")

    # serving: the engine over the reference's synthetic requests
    requests = synthetic_requests(8, cfg.vocab_size, seed=0)
    want_schedule = smoke_schedule(requests)
    engine = {}
    for mode in ("continuous", "bsp"):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ContinuousBatchingEngine(cfg, params, num_slots=4, max_len=64,
                                       mode=mode, dtype=torch.bfloat16
                                       ).run(requests)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        st = res["stats"]
        steps = st.wavefronts + sum(len(r.prompt) - 1 for r in requests)
        tokens_out = sum(len(v) for v in res["outputs"].values())
        engine[mode] = {"wavefronts": st.wavefronts,
                        "mean_occupancy": st.mean_occupancy,
                        "completed": st.completed, "seconds": secs,
                        "decode_steps": steps, "tokens": tokens_out,
                        "ms_per_step": 1e3 * secs / steps,
                        "tokens_per_s": tokens_out / secs}
        log(f"    engine {mode}: {st.completed} requests, {tokens_out} "
            f"tokens, {st.wavefronts} wavefronts (CPU smoke schedule "
            f"{want_schedule[mode][0]}), mean occupancy "
            f"{st.mean_occupancy:.4f} ({want_schedule[mode][1]:.4f}); "
            f"{secs:.3f} s, {1e3 * secs / steps:.2f} ms per decode step "
            f"({steps} steps incl. prompt replay), "
            f"{tokens_out / secs:.1f} tokens/s  [{card}]")
        if any(len(res["outputs"][r.uid]) != r.max_new_tokens
               for r in requests) or st.completed != len(requests):
            raise AssertionError(f"engine {mode}: a request did not get "
                                 f"its max_new_tokens")
        if (st.wavefronts, st.mean_occupancy) != want_schedule[mode]:
            raise AssertionError(f"engine {mode} schedule differs from the "
                                 f"CPU smoke schedule {want_schedule[mode]}")
    if not engine["continuous"]["wavefronts"] < engine["bsp"]["wavefronts"]:
        raise AssertionError("continuous batching took no fewer wavefronts "
                             "than bsp")

    # where a warm prefill's device time goes: B5, the other kernels, and
    # the logits product alone
    dev_ms, rows = device_profile(
        lambda: T.prefill(params, cfg, {"tokens": tokens}, LM_SEQ))
    b5_ms = sum(ms for key, ms, _ in rows if "flash_fwd" in key)
    gemm_ms = sum(ms for key, ms, _ in rows
                  if any(w in key.lower() for w in ("gemm", "xmma", "cutlass",
                                                    "nvjet")))
    h = torch.randn(LM_BATCH, LM_SEQ, cfg.d_model, generator=g,
                    device="cuda").to(torch.bfloat16)
    logits_ms = cuda_ms(lambda: h @ params["embed"]["head"], reps=5)
    peak = torch.cuda.max_memory_allocated()
    log(f"    warm prefill under the profiler: {dev_ms} ms device time; B5 "
        f"{b5_ms:.2f} ms, matrix-product kernels {gemm_ms:.2f} ms (the "
        f"logits product alone {logits_ms:.2f} ms by CUDA events); peak "
        f"memory {peak / 2 ** 30:.1f} GiB; top device ops (ms, calls):")
    for key, ms, calls in rows[:8]:
        log(f"      {ms:10.3f} {calls:7d}  {key[:90]}")
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "instances": instances,
            "f32_instances": instances32, "prefill_seconds": {
                "cold": secs_cold, "warm": secs_warm, "plain": secs_plain,
                "f32_plain": secs_ref, "f32_kernel": secs_k32},
            "tokens_per_s": LM_BATCH * LM_SEQ / secs_warm,
            "errors": {"bf16_kernel": err_k, "bf16_plain": err_p,
                       "bf16_limit": limit, "f32_kernel": err_32,
                       "f32_control": err_ctl, "max_logit": scale,
                       "decode": dec_errs, "decode_limit": dec_limit},
            "decode_ms_per_step": 1e3 * secs_dec / DECODE_STEPS,
            "decode_profiled": {"seconds": held["secs"],
                                "device_ms": dec_dev_ms,
                                "device_ops": dec_ops,
                                "rows": dec_rows[:10]},
            "engine": engine, "cpu_schedule": want_schedule,
            "profile": {"device_ms": dev_ms, "b5_ms": b5_ms,
                        "gemm_ms": gemm_ms, "logits_ms": logits_ms,
                        "rows": rows[:20]},
            "peak_bytes": peak}


# --------------------------------------- phase 7b, the other model families
#: each family's configuration on the card: (batch, text tokens a sequence,
#: layers run (None: all), decode steps replayed).  The cuts are listed in
#: PERF.md section 4: olmoe-1b-7b runs whole; falcon-mamba-7b's prefill is
#: short because its scan is a host loop of two device ops a step; the VLM
#: runs 8 of its 60 layers, whose 68.8 GB in bf16 would not sit beside the
#: f32 reference; its text is 320 tokens, so that patches and text make
#: 3,200 positions, the multiple of 128 that B5 takes
FAMILIES = {"olmoe-1b-7b": (2, 4096, None, 16),
            "falcon-mamba-7b": (1, 128, None, 8),
            "zamba2-1.2b": (1, 512, None, 8),
            "seamless-m4t-medium": (2, 256, None, 8),
            "llava-next-34b": (1, 320, 8, 8)}
#: B5 launches of one prefill: a layer (MoE, VLM), the hybrid's shared block
#: once a group, the encoder-decoder's decoder layers (its encoder and
#: cross-attention run the plain einsum path, as the reference's), none in
#: the SSM
B5_PER_PREFILL = {"olmoe-1b-7b": 16, "falcon-mamba-7b": 0, "zamba2-1.2b": 2,
                  "seamless-m4t-medium": 12, "llava-next-34b": 8}
#: MoE routing flips: the share of (token, layer) routings whose expert set
#: differs between the bf16 kernel path and the f32 reference may be at
#: most FLIP_FACTOR x the plain bf16 path's share + FLIP_SLACK (B5 adds no
#: flips beyond bf16 rounding's), and never past FLIP_CAP (a routing that
#: picked experts at random would differ almost everywhere); PERF.md 6
FLIP_FACTOR = 1.25
FLIP_SLACK = 0.01
FLIP_CAP = 0.5
#: the SSM and the hybrid: bf16 against the f32 reference held after their
#: first two layers (zamba2-1.2b: two groups of one mamba layer and the
#: shared block), within SSM_BF16_REL x max |logit|.  Through the whole
#: random-weight stack bf16 noise grows to the logits' own scale (it is
#: printed there, not held); two unrelated logit rows differ by up to
#: about twice it.  PERF.md 6
SSM_SHALLOW = {"falcon-mamba-7b": {"num_layers": 2},
               "zamba2-1.2b": {"num_layers": 2, "attn_every": 1}}
SSM_BF16_REL = 0.4


class MoERecorder:
    """While entered, wraps ``models.moe.route`` and ``models.moe.apply_moe``:
    records each routing's expert ids and each layer's dropped count, and,
    with ``force`` set (``force(call_index) -> ids``), routes to given ids
    with the gate values of the call's own probabilities."""

    def __init__(self):
        from repro_torch.models import moe

        self.moe = moe
        self.route0, self.apply0 = moe.route, moe.apply_moe
        self.routes, self.dropped, self.force = [], [], None

    def __enter__(self):
        self.moe.route, self.moe.apply_moe = self._route, self._apply
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe.apply_moe = self.route0, self.apply0

    def take(self) -> tuple:
        """(the expert ids of each call, the dropped total) since the last
        take."""
        routes, dropped = self.routes, self.dropped
        self.routes, self.dropped = [], []
        return routes, sum(int(d) for d in dropped)

    def _route(self, params, cfg, xf):
        probs, vals, idx = self.route0(params, cfg, xf)
        if self.force is not None:
            idx = self.force(len(self.routes))
            vals = probs.gather(1, idx)
            vals = vals / vals.sum(dim=-1, keepdim=True)
        self.routes.append(idx)
        return probs, vals, idx

    def _apply(self, *args, **kw):
        out, metrics = self.apply0(*args, **kw)
        self.dropped.append(metrics["dropped"])
        return out, metrics


class B5Capture:
    """While entered, keeps the inputs of the first and the last B5 launch
    of ``ops.multihead_attention``: the main path's own tensors, on which
    :func:`check_captured` holds the kernel against ``attention_ref``."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops

        self.ops, self.kernel0 = ops, ops.flash_attention_cuda
        self.first = self.last = None

    def __enter__(self):
        self.ops.flash_attention_cuda = self._launch
        return self

    def __exit__(self, *exc):
        self.ops.flash_attention_cuda = self.kernel0

    def _launch(self, q, k, v, **kw):
        if self.first is None:
            self.first = (q, k, v, kw)
        else:
            self.last = (q, k, v, kw)
        return self.kernel0(q, k, v, **kw)

    def calls(self) -> list:
        return [c for c in (self.first, self.last) if c is not None]


def check_captured(arch: str, calls: list, card: str) -> list:
    """B5 against ``attention_ref`` on each captured launch's inputs, each
    element within one bf16 step, as phase 3 holds it.  Returns the max
    |error| of each."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    errs = []
    for which, (q, k, v, kw) in zip(("first", "last"), calls):
        got = flash_attention_cuda(q, k, v, **kw)
        want = attention_ref(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        excess = float(bf16_excess(got, want).max())
        log(f"    {arch}: B5's {which} prefill launch, q {str(q.dtype)[6:]}"
            f"{list(q.shape)}, k/v {list(k.shape)}, {kw}, rerun on its own "
            f"inputs against attention_ref: max_abs_err {err:.3g}, within "
            f"one bf16 step everywhere (excess {excess:.3g})  [{card}]")
        if not excess <= 1e-6:
            raise AssertionError(f"{arch}: B5 disagrees with attention_ref "
                                 f"on its {which} prefill launch's inputs")
        errs.append(err)
        del got, want
    return errs


def ssm_shallow(arch: str, batch_n: int, n_text: int, card: str) -> dict:
    """The SSM's or the hybrid's first two layers (SSM_SHALLOW): bf16 logits
    through the kernel path against the f32 plain reference, within
    SSM_BF16_REL x max |logit|, and the hybrid's also within
    :func:`bf16_bound` of its plain bf16 path."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map

    cfg = dataclasses.replace(get_config(arch), **SSM_SHALLOW[arch])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = init_params(T.model_spec(cfg), 0, torch.bfloat16, device="cuda")
    batch = family_inputs(cfg, batch_n, n_text)
    where = lm_positions(1, batch_n, n_text, 0)
    want = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    got, _, launches = sampled_prefill(params, cfg, batch, where, "auto")
    if launches != want:
        raise AssertionError(f"{arch} at {cfg.num_layers} layers: "
                             f"{launches} B5 launches, not {want}")
    plain = (sampled_prefill(params, cfg, batch, where, "torch")[0] if want
             else got)
    ref = sampled_prefill(tree_map(lambda a: a.float(), params), cfg32,
                          batch, where, "torch")[0]
    scale = float(ref.abs().max())
    err_k, err_p, limit = bf16_bound(ref, plain, got, scale)
    if not want:  # no attention: the plain path is the kernel path
        limit = float("inf")
    rel_limit = SSM_BF16_REL * scale
    log(f"    {arch} at its first {cfg.num_layers} layers "
        f"({SSM_SHALLOW[arch]}), bf16 prefill {batch_n}x{n_text}, {launches} "
        f"B5 launches: logits vs the f32 reference at {len(where[0])} "
        f"positions (max |logit| {scale:.4g}): kernel {err_k:.4g}, plain "
        f"{err_p:.4g}; limits {SSM_BF16_REL} x max |logit| = "
        f"{rel_limit:.4g}{'' if not want else f' and {limit:.4g}'}  [{card}]")
    if not err_k <= min(rel_limit, limit):
        raise AssertionError(f"{arch} at {cfg.num_layers} layers: bf16 "
                             f"logits err {err_k} > {min(rel_limit, limit)}")
    del params
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "launches": launches, "kernel": err_k,
            "plain": err_p, "limit": min(rel_limit, limit),
            "max_logit": scale}


def flipped(a: list, b: list) -> torch.Tensor:
    """[layers, tokens] bool: where two runs' top-k expert sets differ."""
    return torch.stack([(x.sort(dim=1).values != y.sort(dim=1).values)
                        .any(dim=1) for x, y in zip(a, b)])


def bf16_bound(ref, plain, got, scale: float) -> tuple:
    """(kernel path's error, plain path's, the limit BF16_ERR_FACTOR x plain
    + the abs term)."""
    abs_term = BF16_ABS_STEPS * 2.0 ** (np.floor(np.log2(scale)) - 7)
    err_k = float((got - ref).abs().max())
    err_p = float((plain - ref).abs().max())
    return err_k, err_p, BF16_ERR_FACTOR * err_p + abs_term


def family_inputs(cfg, batch_n: int, n_text: int) -> dict:
    """Seeded tokens, and the VLM's patch embeddings or the encoder-decoder's
    frames, made in bf16 on the card (exact in the f32 reference too)."""
    g = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (batch_n, n_text),
                                     generator=g, device="cuda")}
    extra = {"vlm": "patch_emb", "encdec": "frames"}.get(cfg.family)
    if extra:
        batch[extra] = torch.randn(batch_n, cfg.frontend_len, cfg.d_model,
                                   generator=g, device="cuda").bfloat16()
    return batch


def family_path(arch: str, card: str) -> dict:
    """Phase 7b for one family: a bf16 prefill through B5 (its launches as
    B5_PER_PREFILL says, all of the tensor-core instance; its first and last
    launch rerun against ``attention_ref`` on their own inputs), the plain
    bf16 path, an f32 plain reference at the sampled positions; decode
    steps through the bf16 cache replayed against them.  MoE also: the
    routing flips, a reference routed as the kernel path was, the dropped
    count, the engine and a profiled step.  The SSM and the hybrid: bf16
    held at their first two layers (:func:`ssm_shallow`), the recurrence
    against the scan in f32 at full depth."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import synthetic_requests
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.engine import ContinuousBatchingEngine

    batch_n, n_text, layers, n_dec = FAMILIES[arch]
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    moe = cfg.family == "moe"
    out = {}
    if cfg.ssm_state:
        out["shallow"] = ssm_shallow(arch, batch_n, n_text, card)
    t0 = time.perf_counter()
    params = init_params(T.model_spec(cfg), 0, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    out.update(params=cfg.param_count(), layers=cfg.num_layers,
               batch=batch_n, text_tokens=n_text,
               init_seconds=time.perf_counter() - t0)
    batch = family_inputs(cfg, batch_n, n_text)
    batch32 = {k: v.float() if v.is_floating_point() else v
               for k, v in batch.items()}
    where = lm_positions(1, batch_n, n_text, n_dec)
    want = B5_PER_PREFILL[arch]
    secs = {}
    with MoERecorder() as rec:
        with B5Capture() as cap:
            got, secs["kernel"], launches = sampled_prefill(
                params, cfg, batch, where, "auto")
        instances = flash_instances()
        routes_k, dropped_k = rec.take()
        if launches != want or instances != {"tensor_core": want,
                                             "cuda_core": 0}:
            raise AssertionError(f"{arch}: expected {want} B5 launches, all "
                                 f"of the tensor-core instance, got "
                                 f"{launches} {instances}")
        out["b5_captured_err"] = check_captured(arch, cap.calls(), card)
        del cap
        if moe:
            _, secs["kernel_warm"], _ = sampled_prefill(params, cfg, batch,
                                                        where, "auto")
            rec.take()
        if want:
            plain, secs["plain"], n = sampled_prefill(params, cfg, batch,
                                                      where, "torch")
            if n:
                raise AssertionError(f"{arch}: attn_impl='torch' launched B5")
        else:  # no attention: the plain path is the same computation
            plain = got
        routes_p, dropped_p = rec.take()
        params32 = tree_map(lambda a: a.float(), params)
        ref, secs["f32_reference"], _ = sampled_prefill(
            params32, cfg32, batch32, where, "torch")
        routes_f, dropped_f = rec.take()
        if moe:
            # a reference and a plain path routed as the kernel path was:
            # what is left between them is arithmetic, at every position
            rec.force = lambda i: routes_k[i % cfg.num_layers]
            ref_forced, _, _ = sampled_prefill(params32, cfg32, batch32,
                                               where, "torch")
            plain_forced, _, _ = sampled_prefill(params, cfg, batch, where,
                                                 "torch")
            rec.force = None
            rec.take()
        if cfg.family == "vlm":
            # decode reads text only: its references are a text-only prefill
            text = {"tokens": batch["tokens"][:1, :n_dec]}
            every = (torch.zeros(n_dec, dtype=torch.long, device="cuda"),
                     torch.arange(n_dec, device="cuda"))
            dec_ref = sampled_prefill(params32, cfg32, text, every,
                                      "torch")[0]
            dec_plain = sampled_prefill(params, cfg, text, every, "torch")[0]

        scale = float(ref.abs().max())
        dec_rows = slice(len(where[0]) - n_dec, None)
        if moe:
            err_k, err_p, limit = bf16_bound(ref_forced, plain_forced, got,
                                             scale)
            dec_ref, dec_plain = ref_forced[dec_rows], plain_forced[dec_rows]
        else:
            err_k, err_p, limit = bf16_bound(ref, plain, got, scale)
            if cfg.family != "vlm":
                dec_ref, dec_plain = ref[dec_rows], plain[dec_rows]
        out["errors"] = {"kernel": err_k, "plain": err_p, "limit": limit,
                         "max_logit": scale}
        # the SSMs' full-depth bf16 logits are noise of their own scale:
        # printed, and held at their first two layers instead
        logits_held = not cfg.ssm_state
        log(f"    {arch}: {out['params']} parameters, {cfg.num_layers} "
            f"layers, bf16 prefill {batch_n}x{n_text}"
            f"{' + ' + str(cfg.frontend_len) + ' patches' if cfg.family == 'vlm' else ''}"
            f"{' over ' + str(cfg.frontend_len) + ' frames' if cfg.family == 'encdec' else ''}"
            f": {launches} B5 launches ({instances}); kernel path "
            f"{secs['kernel']:.3f} s, plain {secs.get('plain', 0.0):.3f} s, "
            f"f32 reference {secs['f32_reference']:.3f} s; logits vs the f32 "
            f"reference{' routed as the kernel path' if moe else ''} at "
            f"{len(where[0])} positions (max |logit| {scale:.4g}): kernel "
            f"{err_k:.4g}, plain {err_p:.4g}, "
            f"{f'limit {limit:.4g}' if logits_held else 'not held (bf16 noise through the random stack)'}"
            f"  [{card}]")
        if logits_held and not err_k <= limit:
            raise AssertionError(f"{arch}: bf16 kernel-path logits err "
                                 f"{err_k} > {limit}")

        if moe:
            n_tok = batch_n * n_text
            flip_k = flipped(routes_k, routes_f)          # [layers, tokens]
            flip_p = flipped(routes_p, routes_f)
            share_k = float(flip_k.float().mean())
            share_p = float(flip_p.float().mean())
            tok_k = flip_k.any(dim=0)
            out["moe"] = {
                "dropped": {"kernel": dropped_k, "plain": dropped_p,
                            "f32_reference": dropped_f},
                "capacity_factor": cfg.capacity_factor,
                "flip_share": share_k, "plain_flip_share": share_p,
                "flipped_tokens": int(tok_k.sum()), "tokens": n_tok,
                "flips_by_layer": flip_k.float().mean(dim=1).tolist()}
            log(f"    {arch} MoE at capacity factor {cfg.capacity_factor}: "
                f"dropped {dropped_k} (plain {dropped_p}, f32 {dropped_f}) "
                f"of {n_tok * cfg.num_experts_per_tok * cfg.num_layers} "
                f"assignments ({cfg.num_layers} layers); routing flips against the f32 "
                f"reference: {int(tok_k.sum())} of {n_tok} tokens, "
                f"{share_k:.4f} of (token, layer) routings (plain bf16 "
                f"{share_p:.4f}; limit {FLIP_FACTOR} x plain + {FLIP_SLACK},"
                f" at most {FLIP_CAP}); by layer "
                f"{[round(x, 4) for x in out['moe']['flips_by_layer']]}"
                f"  [{card}]")
            if not (share_k <= FLIP_FACTOR * share_p + FLIP_SLACK
                    and share_k <= FLIP_CAP):
                raise AssertionError(f"{arch}: routing flip share {share_k} "
                                     f"past its limits (plain {share_p})")

        # decode: the first n_dec tokens of sequence 0 through the cache
        def replay(p, c, dtype):
            cache = T.init_cache(c, 1, n_dec, dtype, device="cuda")
            if c.family == "encdec":
                cache = cache._replace(enc=T._encode(p, c,
                                                     batch["frames"][:1]))
            rows = []
            for t in range(n_dec):
                if moe:
                    rec.force = (lambda i, t=t:
                                 routes_k[i % cfg.num_layers][t:t + 1])
                logits, cache = T.decode_step(p, c, cache,
                                              batch["tokens"][:1, t:t + 1])
                rows.append(logits[0].float())
            rec.force = None
            rec.take()
            return torch.stack(rows), cache

        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec, cache = replay(params, cfg, torch.bfloat16)
        torch.cuda.synchronize()
        secs["decode_step"] = (time.perf_counter() - t0) / n_dec
        if cfg.ssm_state:
            # the recurrence against the scan in f32, where bf16 rounding
            # (which the deep random-weight stack amplifies) is out of it
            dec32 = replay(params32, cfg32, torch.float32)[0]
            rec32 = float((dec32 - ref[dec_rows]).abs().max())
            out["errors"]["decode_f32"] = rec32
            log(f"    {arch}: {n_dec} f32 decode steps (the recurrence) vs "
                f"the f32 prefill (the scan): {rec32:.4g} (limit {F32_REL} "
                f"x max |logit| = {F32_REL * scale:.4g})  [{card}]")
            if not rec32 <= F32_REL * scale:
                raise AssertionError(f"{arch}: f32 recurrence vs scan err "
                                     f"{rec32}")
        del params32
        torch.cuda.empty_cache()
    if any(read_counts().values()):
        raise AssertionError(f"{arch}: decode launched a kernel: "
                             f"{read_counts()}")
    dec_err, dec_plain_err, dec_limit = bf16_bound(dec_ref, dec_plain, dec,
                                                   scale)
    out["errors"].update(decode=dec_err, decode_plain=dec_plain_err,
                         decode_limit=dec_limit)
    log(f"    {arch}: {n_dec} decode steps through the bf16 cache "
        f"({'the recurrence' if cfg.ssm_state else 'the KV cache'}) vs the "
        f"f32 {'text-only ' if cfg.family == 'vlm' else ''}reference "
        f"{'routed as the kernel path ' if moe else ''}at the same "
        f"positions: {dec_err:.4g} (plain prefill {dec_plain_err:.4g}; "
        f"{f'limit {dec_limit:.4g}' if logits_held else 'not held: the f32 recurrence is'}"
        f"); {1e3 * secs['decode_step']:.2f} ms a step (B=1)  [{card}]")
    if logits_held and not dec_err <= dec_limit:
        raise AssertionError(f"{arch}: decode logits err {dec_err} > "
                             f"{dec_limit}")
    out.update(launches=launches, instances=instances, seconds=secs,
               b5_shape=f"q bf16[{batch_n * cfg.num_heads}, "
                        f"{n_text + (cfg.frontend_len if cfg.family == 'vlm' else 0)}"
                        f", {cfg.hd}], k/v bf16[{batch_n * cfg.num_kv_heads}"
                        f", same, {cfg.hd}], causal"
                        f"{', window ' + str(cfg.sliding_window) if cfg.sliding_window else ''}")

    if moe:
        requests = synthetic_requests(8, cfg.vocab_size, seed=0)
        want_schedule = smoke_schedule(requests, arch)
        out["engine"] = {}
        for mode in ("continuous", "bsp"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ContinuousBatchingEngine(cfg, params, num_slots=4,
                                           max_len=64, mode=mode,
                                           dtype=torch.bfloat16).run(requests)
            torch.cuda.synchronize()
            st = res["stats"]
            run = {"wavefronts": st.wavefronts,
                   "mean_occupancy": st.mean_occupancy,
                   "completed": st.completed,
                   "seconds": time.perf_counter() - t0,
                   "tokens": sum(len(v) for v in res["outputs"].values())}
            out["engine"][mode] = run
            log(f"    {arch} engine {mode}: {st.completed} requests, "
                f"{run['tokens']} tokens, {st.wavefronts} wavefronts (CPU "
                f"smoke schedule {want_schedule[mode][0]}), occupancy "
                f"{st.mean_occupancy:.4f} ({want_schedule[mode][1]:.4f}); "
                f"{run['seconds']:.3f} s  [{card}]")
            if (st.wavefronts, st.mean_occupancy) != want_schedule[mode] \
                    or st.completed != len(requests) or any(
                        len(res["outputs"][r.uid]) != r.max_new_tokens
                        for r in requests):
                raise AssertionError(f"{arch} engine {mode}: schedule or "
                                     f"outputs differ from the CPU smoke "
                                     f"schedule {want_schedule[mode]}")
        held = {}

        def one_step():
            t1 = time.perf_counter()
            T.decode_step(params, cfg, cache, batch["tokens"][:1, :1])
            torch.cuda.synchronize()
            held["secs"] = time.perf_counter() - t1

        dev_ms, rows = device_profile(one_step)
        ops = sum(calls for _, _, calls in rows)
        out["decode_profiled"] = {"seconds": held["secs"],
                                  "device_ms": dev_ms, "device_ops": ops,
                                  "rows": rows[:10]}
        log(f"    {arch} one decode step under the profiler: "
            f"{1e3 * held['secs']:.2f} ms wall, {dev_ms} ms device time in "
            f"{ops} device ops, busy share "
            f"{None if dev_ms is None else dev_ms / (1e3 * held['secs'])}"
            f"  [{card}]")
    del params, cache
    torch.cuda.empty_cache()
    return out


def start_examples() -> dict:
    """``repro_torch.examples.quickstart`` as two child processes, on the
    card and on the CPU (one thread)."""
    import os

    procs = {}
    for device in ("cuda", "cpu"):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        procs[device] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.examples.quickstart",
             "--device", device], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        CHILDREN.append(procs[device])
    return {"procs": procs, "started": time.perf_counter()}


def wait_examples(started: dict, card: str) -> dict:
    """Both quickstart runs: exit 0, and every line equal but the PageRank
    error, which is printed for both."""
    import re

    out = {}
    for device, proc in started["procs"].items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"quickstart --device {device} exited "
                                 f"{proc.returncode}:\n{stderr[-3000:]}")
        out[device] = stdout.splitlines()
    err = re.compile(r" err=(\S+)")
    masked = {d: [err.sub(" err=*", line) for line in lines]
              for d, lines in out.items()}
    if masked["cuda"] != masked["cpu"] or len(masked["cuda"]) < 8:
        raise AssertionError(f"quickstart on the card differs from the "
                             f"CPU:\n{out['cuda']}\n{out['cpu']}")
    errs = {d: [m.group(1) for line in lines for m in [err.search(line)]
                if m] for d, lines in out.items()}
    secs = time.perf_counter() - started["started"]
    log(f"    quickstart --device cuda and --device cpu: every line equal "
        f"(rounds, work, validity); PageRank err card {errs['cuda']}, CPU "
        f"{errs['cpu']}; both done {secs:.1f} s after [7b] started  "
        f"[{card}]")
    for line in out["cuda"]:
        if line:
            log(f"      {line}")
    return {"lines": out["cuda"], "errors": errs, "seconds": secs}


def families_path(card: str) -> dict:
    """Phase 7b: the examples' children, then each family in turn."""
    examples = start_examples()
    out = {}
    for arch in FAMILIES:
        t0 = time.perf_counter()
        out[arch] = family_path(arch, card)
        out[arch]["wall_seconds"] = time.perf_counter() - t0
        log(f"    {arch} done in {out[arch]['wall_seconds']:.1f} s  [{card}]")
    out["examples"] = wait_examples(examples, card)
    return out


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
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)
    from repro_torch.kernels.scatter_add.ref import ordered_scatter_add_ref
    from repro_torch.kernels.flash_attention.kernel import tile_plan
    from repro_torch.runtime import config_for, parse_policy

    out_dir = ROOT / "chiprun_out" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    reports = build.build(build.PATH_SOURCES)
    log(f"[2] built {', '.join(build.PATH_SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        log(f"  ptxas report for csrc/{name}.cu:")
        for line in report.strip().splitlines():
            log(f"    {line}")
    # the small task-server cells run on the CPU meanwhile, a child process
    # (one thread) a cell; [4h] waits for them before it measures anything
    cpu_children = {cell: start_server_child(min(args.scale, 14), "cpu",
                                             [cell], f"cpu.{cell}")
                    for cell in SERVER_CELLS}
    # and [4i]'s CPU reference: the full-width first rounds, the small cells
    shard_children = {"full": start_shard_child("full", args.scale),
                      "small": start_shard_child("small",
                                                 min(args.scale, 14)),
                      "cli": start_shard_cli("cpu")}
    sass = flash_sass()
    log(f"  B5 (csrc/flash_attention.cu) SASS: "
        + ", ".join(f"{op} {n}" for op, n in sass.items()))

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
    main_scan, (col_scan, col_budget), lbs_err = check_lbs(graph, budget,
                                                           dev, rng)
    n_push = budget + cfg.wavefront
    (items, mask), compact_err = check_compact(n_push, dev, rng)
    main_starts, stream_err = check_stream(graph, dev, rng)
    slab_inputs, slab_err = check_stream_slotted(graph, budget, dev, rng)
    scatter_main, scatter_f64, scatter_err, scatter_plain = check_scatter(
        graph, budget, rng)
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_err = check_flash()

    log(f"[4] main path: BFS rmat({args.scale}) single.persistent g1 "
        f"merge_path backend=auto")
    check_guard(dev)
    reset_counts()
    state, stats, info, secs = drain(graph, cfg, source)
    counts = read_counts()
    steps = -(-info["rounds"] // POLL_EVERY) * POLL_EVERY
    log(f"    counts={counts} info={info} drain {secs:.3f} s")
    if counts != only(lbs=steps, compact=steps + 1):
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
    # through drain_setup, so that [4e] holds its g4 megakernel drain
    # against this drain's final queue without running it again
    reset_counts()
    carry_g, secs_g = drive("bfs", grid, cfg_g4, {"source": 0})
    counts_g = read_counts()
    state_g = carry_g[1]
    info_g = {"rounds": int(carry_g[2]),
              "work": int(state_g.counter.work),
              "dropped": int(carry_g[0].dropped),
              "splits": int(state_g.counter.splits),
              "launches": int(carry_g[2])}
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

    log(f"[4c] PageRank rmat({args.scale}) damping 0.85 eps 1e-6 check_size "
        f"64, W=4096 g1: single.persistent (B1, B2, the ordered "
        f"scatter-add) and single.megakernel (B3-pr)")
    pr = pagerank_path(graph, card, min(args.scale, 14))
    log(f"[4d] coloring rmat({args.scale}) W=4096 g1: single.persistent (B1, "
        f"B2) and single.megakernel (B3-col)")
    col = coloring_path(graph, card, min(args.scale, 14))
    log(f"[4e] the megakernel beyond G = 1: BFS merge_path g4 and per_item "
        f"g1/g4, PageRank g4, coloring g4 on rmat({args.scale}) and "
        f"grid2d({side},{side}), each one launch of its drain kernel")
    wide = {"bfs": wide_bfs(graph, grid, source, want, want_grid, card,
                            min(args.scale, 14), (carry_g, secs_g)),
            "pagerank": wide_pagerank(graph, grid, card,
                                      min(args.scale, 14)),
            "coloring": wide_coloring(graph, card, min(args.scale, 14))}
    log(f"[4f] the fused topology and the traced drains: BFS "
        f"fused.persistent, each program's fused.megakernel (g1, g2) and "
        f"traced megakernel as one launch of its drain kernel's fused or "
        f"traced mode, on rmat({args.scale}) and grid2d({side},{side})")
    fused = fused_and_traced(graph, grid, source, want, want_grid, mega, pr,
                             col, (state, stats, info), card,
                             min(args.scale, 14))
    for path in (pr, col):
        path.pop("carry")
    log(f"[4g] streaming graphs: stream_execute over {STREAM['num_batches']} "
        f"delta batches of {STREAM['batch_size']} pairs on rmat({args.scale})"
        f", BFS, PageRank and coloring, each megakernel batch drain one "
        f"launch of its drain kernel's slotted mode")
    stream = streaming_path(graph, source, card, min(args.scale, 14))
    log(f"[4h] the task server: BFS x2, coloring on rmat({args.scale}) and "
        f"BFS on grid2d({side},{side}) fused in 4 lanes (B1, B2 a lane "
        f"step); the 8-job mix at rmat({min(args.scale, 14)}) on the card "
        f"against the CPU; a streaming tenant (B3-slotted), the autotuner, "
        f"the CLI")
    server = server_path(graph, grid, source, want, want_grid, cpu_children,
                         out_dir, card, min(args.scale, 14))
    log(f"[4i] the sharded topology, four shards on one card: BFS "
        f"rmat({args.scale}) from 4's source on a 2x2 deferred, compressed, "
        f"stealing mesh (B1, B2 a shard body and push; the 1-D strict "
        f"mesh's drain runs in [4j]); PageRank (and the ordered "
        f"scatter-add) and coloring on the 1-D mesh over their first {SHARD_FIRST_ROUNDS} rounds; "
        f"rmat({min(args.scale, 14)}) whole drains against the CPU")
    sharded = sharded_path(graph, source, state.dist, shard_children, card,
                           min(args.scale, 14))
    log(f"[4j] sharded streams, jobs and tracing, four shards on one card: "
        f"a traced JobSpec(shards=4) BFS on rmat({args.scale}) beside a "
        f"fused tenant; the sharded BFS stream over [4g]'s log; at "
        f"rmat({min(args.scale, 14)}) a traced 2x2 drain and a sharded "
        f"PageRank stream against the CPU, a snapshot resumed; the "
        f"sharding CLI on the card against the CPU")
    sharded_more = sharded_more_path(graph, source, state.dist, sharded,
                                     stream, shard_children, card,
                                     min(args.scale, 14))

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
    slab, slab_starts, slab_width = slab_inputs
    padded_slab = torch.cat([slab, slab.new_zeros(slab_width)])
    slab_window = torch.arange(slab_width, device=dev)
    col_k = torch.arange(col_budget, dtype=torch.int32, device=dev)
    versions = {
        "lbs": (lambda: lbs_cuda(main_scan, budget),
                lambda: lbs_ref(main_scan, budget),
                lambda: torch.searchsorted(main_scan, k, right=True,
                                           out_int32=True)),
        "lbs.coloring_g1": (lambda: lbs_cuda(col_scan, col_budget),
                            lambda: lbs_ref(col_scan, col_budget),
                            lambda: torch.searchsorted(col_scan, col_k,
                                                       right=True,
                                                       out_int32=True)),
        "compact": (lambda: compact_cuda(items, mask),
                    lambda: compact_ref(items, mask), library_compact),
        "csr_stream": (
            lambda: stream_row_slices_cuda(graph.col_idx, main_starts, 4096),
            lambda: stream_row_slices_ref(graph.col_idx, main_starts, 4096),
            lambda: padded_main[main_starts[:, None].long() + window]),
        "csr_stream.slotted": (
            lambda: stream_row_slices_cuda(slab, slab_starts, slab_width),
            lambda: stream_row_slices_ref(slab, slab_starts, slab_width),
            lambda: padded_slab[slab_starts[:, None].long() + slab_window]),
        "ordered_scatter_add": (
            lambda: ordered_scatter_add_cuda(*scatter_main),
            lambda: ordered_scatter_add_ref(*scatter_main),
            lambda: scatter_main[0].clone().index_add_(
                0, scatter_main[1], scatter_main[2])),
        "ordered_scatter_add.f64": (
            lambda: ordered_scatter_add_cuda(*scatter_f64),
            lambda: ordered_scatter_add_ref(*scatter_f64),
            lambda: scatter_f64[0].clone().index_add_(
                0, scatter_f64[1], scatter_f64[2])),
    }
    # the float64 sum at k = m takes milliseconds a call (its plain version
    # a sort of m), so fewer calls
    reps = {"ordered_scatter_add.f64": (3, 5)}
    times = {}
    # device ops a call of each kernel's own wrapper, from its profiled calls
    ops_a_call = {}
    for name, fns in versions.items():
        profile_reps, event_reps = reps.get(name, (20, 50))
        # the profiler now and then keeps no record of a run: up to five
        # tries a version
        by_profiler = []
        for fn in fns:
            ms = None
            for _ in range(5):
                ms, rows = device_profile(fn, reps=profile_reps)
                if ms is not None:
                    break
            by_profiler.append(ms)
            if fn is fns[0] and ms is not None:
                ops_a_call[name] = sum(max(1, round(calls / profile_reps))
                                       for _, _, calls in rows)
        by_events = [cuda_ms(fn, reps=event_reps, warmup=2) for fn in fns]
        if None in by_profiler:
            times[name] = (by_events, "cuda events", by_events)
        else:
            times[name] = (by_profiler, "profiler device time", by_events)
    # the redesigned wrappers run their own launches and nothing else: no
    # library sort or clone beside the scatter-add's four passes, and B2 in
    # one pass after the fill that zeroes its output
    for name, want in (("ordered_scatter_add", 4),
                       ("ordered_scatter_add.f64", 4), ("compact", 2)):
        if ops_a_call.get(name) != want:
            raise AssertionError(f"{name}: {ops_a_call.get(name)} device ops "
                                 f"a call by the profiler, expected {want}")
    # least time: each input read once, each output written once
    bound_bytes = {"lbs": 4 * main_scan.shape[0] + 8 * budget,
                   "lbs.coloring_g1": 4 * col_scan.shape[0] + 8 * col_budget,
                   "compact": 5 * n_push + 4 * n_push + 4,
                   "csr_stream": 4 * 4096 + 2 * 4 * 4096 * 4096,
                   "csr_stream.slotted": 4 * 48 + 2 * 4 * 48 * slab_width,
                   "ordered_scatter_add": 8 * scatter_main[1].shape[0]
                   + 8 * graph.num_vertices,
                   "ordered_scatter_add.f64": 12 * graph.num_edges
                   + 16 * graph.num_vertices}

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
    b3_event_ms = cuda_ms(lambda: drive("bfs", graph, cfg_mega,
                                        {"source": source}),
                          reps=3, warmup=1)
    b3_ms, b3_timed_by = kernel_device_ms(
        mega_rows, "bfs_drain", b3_event_ms,
        "CUDA events around the whole drive, setup included")
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
    if plain_dev_ms is None:
        raise AssertionError("the profiler saw no device time of the plain "
                             "fused drain")
    plain_ms = plain_dev_ms
    pushed = scalars(mega["carry"])[1]
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
        f"; between events around the whole drive, setup included, "
        f"{b3_event_ms:.3f} ms); "
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

    log(f"[6] B5 flash attention at the LM path's per-layer shape "
        f"{FLASH_MAIN[1:7]} bf16 causal  [{card}]")
    flash = time_flash()
    flash["sass"] = sass
    log(f"    kernel {flash['ms']:.4f} ms, plain {flash['plain_ms']:.4f} ms, "
        f"F.scaled_dot_product_attention {flash['library_ms']:.4f} ms by "
        f"{flash['timed_by']}; bound {flash['bound_ms']:.4f} ms "
        f"({flash['bound_by']}); between events {flash['event_ms']:.4f}, "
        f"{flash['plain_event_ms']:.4f}, {flash['library_event_ms']:.4f} ms;"
        f" SDPA vs kernel max |diff| {flash['library_vs_kernel_max_abs']:.3g}"
        f"  [{card}]")
    log(f"    the tensor-core instance ({tile_plan(128, torch.bfloat16)}) "
        f"has {', '.join(f'{op} {n}' for op, n in sass.items())} in its "
        f"library's SASS; the CUDA-core instance takes "
        f"{flash['cuda_core_f32_event_ms']:.4f} ms at the same shape in f32 "
        f"between events  [{card}]")

    log(f"[7] LM serving path: {LM_ARCH} at full width and depth, bf16, "
        f"device=cuda, attn_impl=auto")
    lm = lm_path(card)
    log(f"[7b] the other model families at full width, bf16, device=cuda, "
        f"attn_impl=auto: {', '.join(FAMILIES)}; quickstart on the card "
        f"and on the CPU meanwhile")
    families = families_path(card)

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
            "device_ops_a_call": ops_a_call.get(name), "shape": shape})
    # B1 at coloring's flat budget, where most tiles lie past the total
    (kd, pd, ld), timed_by, (ke, pe, le) = times["lbs.coloring_g1"]
    kernels[0]["coloring_g1"] = {
        "launches": col["counts"]["lbs"], "ms": kd, "plain_ms": pd,
        "bound_ms": 1e3 * bound_bytes["lbs.coloring_g1"] / HBM_BYTES_PER_S,
        "bound_by": "bytes", "library_ms": ld, "timed_by": timed_by,
        "event_ms": ke, "plain_event_ms": pe, "library_event_ms": le,
        "device_ops_a_call": ops_a_call.get("lbs.coloring_g1"),
        "shape": f"scan int32[{col_scan.shape[0]}] of vertices 0 .. 4095 "
                 f"(the first round's assign gather), flat budget "
                 f"{col_budget}"}
    # B4's staging (csrc/csr_stream.cuh) runs inside the B3-pr launch on the
    # megakernel path (B3-BFS reads each unit's word itself); its
    # standalone wrapper is not launched there
    pr_counts = pr["counts_megakernel"]
    kernels[-1]["launches"] = (pr_counts["pagerank_drain"]
                               if pr["units_expanded"] > 0 else 0)
    kernels[-1]["launched_in"] = (f"pagerank_drain: {pr['units_expanded']} "
                                  f"units staged through csr_stream.cuh")
    kernels[-1]["wrapper_launches"] = pr_counts["csr_stream"]
    (kd, pd, ld), timed_by, (ke, pe, le) = times["csr_stream.slotted"]
    kernels.append({
        "name": "csr_stream.slotted", "route": "cuda",
        "source": "src/repro_torch/csrc/csr_stream.cu",
        "replaces": "src/repro/kernels/drain_loop/csr_stream.py:147 (the "
                    "overlay arm over stream_row_slices, :72)",
        "launches": stream["pagerank"]["counts"]["pagerank_drain"],
        "launched_in": "pagerank_drain.slotted on the streaming path: each "
                       "unit's slab word staged through csr_stream.cuh",
        "wrapper_launches": 0,
        "bit_equal": slab_err == 0, "max_abs_err": slab_err,
        "ms": kd, "plain_ms": pd,
        "bound_ms": 1e3 * bound_bytes["csr_stream.slotted"]
        / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": ld,
        "timed_by": timed_by, "event_ms": ke, "plain_event_ms": pe,
        "library_event_ms": le,
        "device_ops_a_call": ops_a_call.get("csr_stream.slotted"),
        "shape": f"48 starts from slab_ptr, width {slab_width} "
                 f"(SLAB_SLACK x (budget + 1)) of the slab array"})
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
    plan_tc = tile_plan(128, torch.bfloat16)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:82",
        "launches": lm["launches"], "max_abs_err": flash_err,
        "instances": {
            "tensor_core": {
                "kernel": "flash_fwd_tc (wgmma + TMA, bf16, D % 8 == 0)",
                "launches": lm["instances"]["tensor_core"],
                "q_tile": plan_tc.q_tile, "kv_tile": plan_tc.kv_tile,
                "sass": flash["sass"], "ms": flash["ms"]},
            "cuda_core": {
                "kernel": "flash_fwd (f32 math on the CUDA cores; f32, and "
                          "bf16 with D % 8 != 0)",
                "launches": lm["instances"]["cuda_core"],
                "f32_prefill_launches": lm["f32_instances"]["cuda_core"],
                "event_ms_f32_main_shape": flash["cuda_core_f32_event_ms"]}},
        "p_terms": plan_tc.p_terms,
        "tolerance": "bf16: within one bf16 step of attention_ref; f32: 2e-5",
        "ms": flash["ms"], "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"], "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"], "timed_by": flash["timed_by"],
        "event_ms": flash["event_ms"],
        "plain_event_ms": flash["plain_event_ms"],
        "library_event_ms": flash["library_event_ms"],
        "shape": "q bf16[48, 4096, 128], k/v bf16[16, 4096, 128], causal "
                 "(minitron-4b layer, B=2 x T=4096)",
        # phase 7b: the other families' prefills, each B5 launch counted
        "family_launches": {
            arch: {"launches": run["launches"],
                   "instances": run["instances"], "shape": run["b5_shape"],
                   "max_abs_err_first_last_launch": run["b5_captured_err"]}
            for arch, run in families.items() if arch in FAMILIES}})
    scatter_k = scatter_main[1].shape[0]
    (kd, pd, ld), timed_by, (ke, pe, le) = times["ordered_scatter_add"]
    kernels.append({
        "name": "ordered_scatter_add", "route": "cuda",
        "source": "src/repro_torch/csrc/ordered_scatter_add.cu",
        "replaces": "none: the deterministic form of residue.at[nbr].add "
                    "(src/repro/algorithms/pagerank.py:122)",
        "launches": pr["counts"]["ordered_scatter_add"],
        "launched_in": f"the persistent PageRank drain's first "
                       f"{pr['persistent_cut_rounds']} rounds (phase 4c)",
        "bit_equal": scatter_err == 0, "max_abs_err": scatter_err,
        "tolerance": "bitwise against the sequential sum (numpy's add.at)",
        "ms": kd, "plain_ms": pd,
        "bound_ms": 1e3 * bound_bytes["ordered_scatter_add"]
        / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": ld,
        "library": "index_add_ (atomics, not bitwise)", "timed_by": timed_by,
        "event_ms": ke, "plain_event_ms": pe, "library_event_ms": le,
        "plain_on_cuda": scatter_plain,
        "device_ops_a_call": ops_a_call.get("ordered_scatter_add"),
        "shape": f"f32[{graph.num_vertices}] += f32[{scatter_k}] at "
                 f"int32[{scatter_k}] (a PageRank round's units)"})
    (kd, pd, ld), timed_by, (ke, pe, le) = times["ordered_scatter_add.f64"]
    kernels.append({
        "name": "ordered_scatter_add.f64", "route": "cuda",
        "source": "src/repro_torch/csrc/ordered_scatter_add.cu",
        "replaces": "none: the streaming PageRank reseed's sums "
                    "(src/repro/stream/incremental.py, numpy bincount)",
        "launches": stream["pagerank"]["counts"]["ordered_scatter_add"],
        "launched_in": "the PageRank stream's reseeds (phase 4g): one a "
                       "batch and one a decay sweep",
        "bit_equal": scatter_err == 0, "max_abs_err": scatter_err,
        "tolerance": "bitwise against numpy's bincount",
        "ms": kd, "plain_ms": pd,
        "bound_ms": 1e3 * bound_bytes["ordered_scatter_add.f64"]
        / HBM_BYTES_PER_S, "bound_by": "bytes", "library_ms": ld,
        "library": "index_add_ (atomics, not bitwise)", "timed_by": timed_by,
        "event_ms": ke, "plain_event_ms": pe, "library_event_ms": le,
        "device_ops_a_call": ops_a_call.get("ordered_scatter_add.f64"),
        "shape": f"f64[{graph.num_vertices}] zeros += f64[{graph.num_edges}]"
                 f" at col_idx int32[{graph.num_edges}] (k = m)"})
    for name, path, source_file in (
            ("pagerank_drain", pr, "src/repro_torch/csrc/pagerank_drain.cu"),
            ("coloring_drain", col,
             "src/repro_torch/csrc/coloring_drain.cu")):
        first = path["first_rounds"]
        kernels.append({
            "name": name, "route": "cuda", "source": source_file,
            "replaces": "src/repro/kernels/drain_loop/kernel.py:82",
            "launches": path["counts_megakernel"][name],
            "bit_equal": first["bit_equal"],
            "max_abs_err": first["max_abs_err"],
            "tolerance": f"bitwise against {first['held_against']} over "
                         f"the rounds timed or the fewer it names, and against the persistent drain "
                         f"over the whole drain",
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": path["first_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "timed_by": first["timed_by"],
            "event_ms": first["event_ms"],
            "plain_wall_ms": first["plain_wall_ms"],
            **{k: first[k] for k in ("plain_on_cuda_max_abs_err",
                                     "cpu_plain_seconds") if k in first},
            "timed_over": f"the first {path['first_rounds_n']} rounds of the "
                          f"rmat({args.scale}) drain",
            "drain_ms": path["megakernel_profiled"]["b3_ms"],
            "drain_bound_ms": path["drain_bound_ms"],
            "rounds": path["info"]["rounds"],
            "shape": f"rmat({args.scale}) drain, W={cfg.wavefront}, g1"})
    wb, wp, wc = wide["bfs"], wide["pagerank"], wide["coloring"]
    small_scale = min(args.scale, 14)
    per_item = wb["small per_item g4"]
    pi = wb["per_item_rmat_g1"]
    cut = pi["cut"]
    kernels += [
        {"name": "bfs_drain.g4", "route": "cuda",
         "source": "src/repro_torch/csrc/bfs_drain.cu",
         "replaces": "src/repro/kernels/drain_loop/kernel.py:82",
         "launches": wb["rmat"]["counts"]["bfs_drain"],
         "bit_equal": wb["plain"]["max_abs_err"] == 0,
         "max_abs_err": wb["plain"]["max_abs_err"],
         "tolerance": "bitwise against the plain fused drain, the "
                      "persistent g4 cell and scipy",
         "ms": wb["timing"]["kernel_ms"], "plain_ms": wb["plain"]["device_ms"],
         "bound_ms": 1e3 * wb["bound_bytes"] / HBM_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": None,
         "timed_by": wb["timing"]["timed_by"],
         "busy_share": wb["timing"]["busy_share"],
         "rounds": wb["rmat"]["carry"][3], "units_expanded":
         wb["rmat"]["units"],
         "shape": f"rmat({args.scale}) BFS drain, merge path, W=4096, g4"},
        {"name": "bfs_drain.per_item", "route": "cuda",
         "source": "src/repro_torch/csrc/bfs_drain.cu",
         "replaces": "src/repro/kernels/drain_loop/kernel.py:82",
         "launches": pi["counts"]["bfs_drain"],
         "bit_equal": cut["max_abs_err"] == 0,
         "max_abs_err": cut["max_abs_err"],
         "tolerance": "bitwise against the plain fused drain and the "
                      "persistent per_item cell over these rounds, scipy "
                      "over the whole drain",
         "ms": cut["kernel_ms"], "plain_ms": cut["plain_ms"],
         "bound_ms": 1e3 * cut["bound_bytes"] / HBM_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": None,
         "timed_by": cut["timed_by"],
         "timed_over": f"the first {cut['rounds']} rounds of the "
                       f"rmat({args.scale}) per_item g1 drain",
         "drain_ms": pi["timing"]["kernel_ms"],
         "drain_bound_ms": 1e3 * pi["bound_bytes"] / HBM_BYTES_PER_S,
         "busy_share": pi["timing"]["busy_share"],
         "rounds": pi["carry"][3], "units_expanded": cut["units"],
         "small_g4": {"shape": f"rmat({small_scale}) per_item g4, W=1024",
                      "ms": per_item["kernel_ms"],
                      "plain_ms": per_item["plain_ms"],
                      "max_abs_err": per_item["max_abs_err"]},
         "shape": f"rmat({args.scale}) BFS drain, per_item, W=4096, g1"}]
    for name, path, source_file in (
            ("pagerank_drain.g4", wp,
             "src/repro_torch/csrc/pagerank_drain.cu"),
            ("coloring_drain.g4", wc,
             "src/repro_torch/csrc/coloring_drain.cu")):
        first = path["first_rounds"]
        main_cell = path["rmat"] if name.startswith("pagerank") else path
        kernels.append({
            "name": name, "route": "cuda", "source": source_file,
            "replaces": "src/repro/kernels/drain_loop/kernel.py:82",
            "launches": main_cell["counts"][name.split(".")[0]],
            "bit_equal": first["bit_equal"],
            "max_abs_err": first["max_abs_err"],
            "tolerance": f"bitwise against {first['held_against']} over "
                         f"the rounds timed or the fewer it names, and against the persistent g4 "
                         f"cell over its first rounds",
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": path["first_bound_ms"], "bound_by": "bytes",
            "library_ms": None, "timed_by": first["timed_by"],
            "event_ms": first["event_ms"],
            "timed_over": f"the first {FIRST_ROUNDS} rounds of the "
                          f"rmat({args.scale}) g4 drain",
            "drain_ms": main_cell["timing"]["kernel_ms"],
            "drain_bound_ms": 1e3 * main_cell["bound_bytes"]
            / HBM_BYTES_PER_S,
            "busy_share": main_cell["timing"]["busy_share"],
            "rounds": main_cell["info"]["rounds"],
            "shape": f"rmat({args.scale}) drain, W=4096, g4"})
    drain_bound_bytes = {"bfs_drain": bfs_bytes(mega["units"], mega["carry"]),
                         "pagerank_drain": pr["drain_bound_ms"] * 1e-3
                         * HBM_BYTES_PER_S,
                         "coloring_drain": col["drain_bound_ms"] * 1e-3
                         * HBM_BYTES_PER_S}
    for algo, name in DRAINS.items():
        mode_times = fused["timing"][algo]
        for mode, run in (("fused", mode_times["fused"]),
                          ("traced", mode_times["single_traced"])):
            first = fused["first_rounds"][f"{algo}.{mode}"]
            rows = (ROW_BYTES * mode_times["rounds"] if mode == "traced"
                    else 0)
            kernels.append({
                "name": f"{name}.{mode}", "route": "cuda",
                "source": f"src/repro_torch/csrc/{name}.cu",
                "replaces": "src/repro/kernels/drain_loop/kernel.py:82",
                "launches": run["launches"],
                "bit_equal": first["max_abs_err"] == 0,
                "max_abs_err": first["max_abs_err"],
                "tolerance": f"bitwise against {first['held_against']} "
                             f"over the rounds timed or the fewer it "
                             f"names, and against "
                             f"single.megakernel (untraced) over the whole "
                             f"drain",
                "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
                "bound_ms": 1e3 * first["bound_bytes"] / HBM_BYTES_PER_S,
                "bound_by": "bytes", "library_ms": None,
                "timed_by": first["timed_by"],
                "timed_over": f"the first {first['rounds']} rounds of the "
                              f"rmat({args.scale}) drain",
                "drain_ms": run["kernel_ms"],
                "single_drain_ms": mode_times["single"]["kernel_ms"],
                "drain_bound_ms": 1e3 * (drain_bound_bytes[name] + rows)
                / HBM_BYTES_PER_S,
                "rounds": mode_times["rounds"],
                "shape": f"rmat({args.scale}) drain, W={cfg.wavefront}, g1, "
                         + ("fused.megakernel (packed lane)"
                            if mode == "fused" else
                            f"single.megakernel with a "
                            f"[{TRACE_CAPACITY}, 13] trace ring")})
    stream_launches = {
        "bfs": stream["bfs"]["cells"]["single.megakernel"]["counts"],
        "pagerank": stream["pagerank"]["counts"],
        "coloring": stream["coloring"]["recolor"]["counts"]}
    for algo, name in DRAINS.items():
        first = stream["first_rounds"][algo]
        whole = stream["whole"].get(algo)
        kernels.append({
            "name": f"{name}.slotted", "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": "src/repro/kernels/drain_loop/kernel.py:82 with "
                        "csr_stream.py:147 (the overlay arm)",
            "launches": stream_launches[algo][name],
            "bit_equal": first["max_abs_err"] == 0,
            "max_abs_err": first["max_abs_err"],
            "tolerance": f"bitwise against {first['held_against']} over "
                         f"the rounds timed or the fewer it names; the "
                         f"streams against scipy, cold "
                         f"drains and one another",
            "ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": 1e3 * first["bound_bytes"] / HBM_BYTES_PER_S,
            "bound_by": "bytes", "library_ms": None,
            "timed_by": first["timed_by"],
            "timed_over": f"the first {first['rounds']} rounds of a cold "
                          f"drain on batch 1's slotted view of "
                          f"rmat({args.scale})",
            "paired_ms": first["paired_ms"],
            "canonical_ms": first["canonical_ms"],
            "paired_timed_by": first["paired_timed_by"],
            "drain_ms": None if whole is None else whole["slotted_ms"],
            "canonical_drain_ms": (None if whole is None
                                   else whole["canonical_ms"]),
            "drain_timed_by": None if whole is None else whole["timed_by"],
            "shape": f"rmat({args.scale}) after one delta batch, overlay "
                     f"{stream['overlay']} entries, W={cfg.wavefront}, g1"})
    # the task server's launches ([4h]): the full-width run, the small
    # cells on the card, the streaming tenant's batch drains
    full_counts = server["full"]["counts"]
    small_counts = {cell: c["counts"] for cell, c in server["small"].items()
                    if cell != "sequential"}
    for kern in kernels:
        name = kern["name"]
        if name in ("lbs", "compact", "ordered_scatter_add"):
            kern["server_launches"] = {
                "full_width": full_counts[name],
                **{f"small {cell}": c[name]
                   for cell, c in small_counts.items()}}
        elif name == "bfs_drain.slotted":
            kern["server_launches"] = {
                "streaming tenant": server["stream"]["counts"]["bfs_drain"]}
    for name in ("lbs", "compact"):
        if not full_counts[name]:
            raise AssertionError(f"the full-width server launched no {name}")
    # the sharded topology's launches ([4i]): the full-width runs
    for kern in kernels:
        name = kern["name"]
        if name in ("lbs", "compact", "ordered_scatter_add"):
            kern["sharded_launches"] = {
                **{f"bfs {cell}": run["launches"][name]
                   for cell, run in sharded["bfs"].items()},
                **{f"{algo} s4 first {SHARD_FIRST_ROUNDS} rounds":
                   sharded[algo]["launches"][name]
                   for algo in ("pagerank", "coloring")},
                "server job s4 traced (a fused tenant beside)":
                sharded_more["server_job"]["launches"][name],
                "bfs stream s4": sharded_more["stream"]["launches"][name],
                f"pagerank stream s4 at rmat({min(args.scale, 14)})":
                sharded_more["small"]["pagerank_stream"]["launches"][name],
                f"bfs 2x2 traced discrete at rmat({min(args.scale, 14)})":
                sharded_more["small"]["traced"]["launches"][name]}
    timed_alone = ("lbs", "compact", "csr_stream", "csr_stream.slotted",
                   "ordered_scatter_add", "ordered_scatter_add.f64")
    for kern in (k for k in kernels if k["name"] in timed_alone):
        log(f"    {kern['name']}: {kern['ms']:.4f} ms (plain "
            f"{kern['plain_ms']:.4f}, library {kern['library_ms']:.4f}, "
            f"bound {kern['bound_ms']:.4f}; between events {kern['event_ms']:.4f}, "
            f"plain {kern['plain_event_ms']:.4f}, library "
            f"{kern['library_event_ms']:.4f}; "
            f"{kern['device_ops_a_call']} device ops a call)  [{card}]")
    at_col = kernels[0]["coloring_g1"]
    log(f"    lbs at coloring's flat budget {col_budget}: {at_col['ms']:.4f} "
        f"ms (plain {at_col['plain_ms']:.4f}, torch.searchsorted "
        f"{at_col['library_ms']:.4f}, bound {at_col['bound_ms']:.4f}; "
        f"between events {at_col['event_ms']:.4f}, plain "
        f"{at_col['plain_event_ms']:.4f}, searchsorted "
        f"{at_col['library_event_ms']:.4f}; {at_col['device_ops_a_call']} "
        f"device ops a call; {at_col['launches']} launches in the "
        f"persistent coloring drain)  [{card}]")
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
        "flash_attention": flash,
        "lm": lm,
        "families": families,
        "pagerank": pr,
        "coloring": col,
        "wide": wide,
        "fused_traced": fused,
        "streaming": stream,
        "server": server,
        "sharded": sharded,
        "sharded_more": sharded_more,
        "kernels": kernels,
    }
    summary["script_seconds"] = time.perf_counter() - started
    summary["phase_seconds"] = phase_walls()
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    log(f"[8] chip_smoke.py took {summary['script_seconds']:.1f} s; phase "
        f"walls: " + ", ".join(f"{label} {secs:.1f}" for label, secs in
                               summary["phase_seconds"].items())
        + f" s  [{card}]")

    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.exit(rc)
