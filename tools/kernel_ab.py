"""Time the ordered scatter-add and B2 of checkouts of the port on one card.

    python3 tools/kernel_ab.py OLD_ROOT NEW_ROOT            # rmat(21)
    python3 tools/kernel_ab.py --cases compact A B C        # B2 alone
    python3 tools/kernel_ab.py --scale 14 --reps 2 . .      # a quick rehearsal

A checkout is a directory that holds ``src/repro_torch``.  The trees run in
turns, in the order given and then reversed (OLD NEW NEW OLD for two;
``tools/drain_ab.py``'s runner), each turn a process of its own that
imports the checkout's package, builds ``ordered_scatter_add`` and
``compact`` from its own sources (ptxas's register and spill lines are
printed), makes rmat(scale, 16, seed 1) on the card, and times each case
of ``--cases`` (``scatter``, ``compact``, ``drain``; all three unless
given) by torch.profiler's device time (each device op's total over
``--reps`` calls, so its split is kept), between CUDA events, and by the
host's microseconds to issue a call (``--reps`` calls back to back, timed
before the closing synchronize):

* ``scatter_f32``: the ordered scatter-add at a PageRank round's shape, as
  ``chip_smoke.py`` [3] makes it (``budget`` updates, the edges of
  consecutive rows, into n slots; the last tenth idle lanes adding +0.0 at
  ``lane % n``);
* ``scatter_f64``: the float64 instance at k = m, the streaming reseed's
  sum (``col_idx`` as the index, from zeros);
* ``segments_of_L``: the float32 instance on as many updates as
  ``scatter_f32``, into segments of exactly L updates each (shuffled), L in
  ``SEGMENT_LENGTHS``: one tier of the sum at a time;
* ``compact``: B2 at the push's shape, int32[budget + 4096], p = 0.3;
* ``pagerank_persistent`` (the ``drain`` case): the persistent PageRank
  drain (W = 4096, damping 0.85, eps 1e-6, check_size 64) cut at
  ``--rounds`` rounds once under the profiler (device time, device ops a round, busy share); then cut at
  a quarter of that and at all of it, twice each without the profiler:
  the difference of the medians over the rounds between is the host-bound
  drain's milliseconds a round, its setup left out.

Every result is held bit for bit against the sequential sum (numpy's
``add.at`` in float32, ``bincount`` in float64) and ``compact_ref``.  Each
turn prints one JSON line; the last lines are the card and the median per
tree and case.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from drain_ab import alternate, card

CASES = ("scatter", "compact", "drain")
SEGMENT_LENGTHS = (1, 8, 64, 512, 2048, 16384)


def profiled(fn, reps: int):
    """``(device ms a call, device ops a call, [(op, ms a call, launches a
    call)], host seconds a call)`` from torch.profiler over ``reps`` calls
    after one warm-up call.  The profiler may drop some records of
    back-to-back launches, so an op's time a call is its mean recorded time
    times its launches a call (its recorded count over ``reps``, rounded, at
    least 1), as ``chip_smoke.device_profile`` takes it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the profiler now and then keeps no record of a run: up to three tries
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
        rows = []
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                calls = max(1, round(e.count / reps))
                rows.append((e.key, e.self_device_time_total / 1e3 / e.count
                             * calls, calls))
        if rows:
            rows.sort(key=lambda r: -r[1])
            return (sum(r[1] for r in rows), sum(r[2] for r in rows), rows,
                    wall)
    raise RuntimeError("the profiler recorded no device op in three tries")


def events_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, reps: int) -> float:
    """Microseconds the host takes to issue one call: ``reps`` calls back to
    back after three warm-up calls, timed before the closing synchronize,
    so the card's own time is left out while it keeps up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * issued / reps


def segment_lengths(index, n: int) -> dict:
    """Segments and updates by segment length (the sum's tiers)."""
    import torch

    lengths = torch.bincount(index.long(), minlength=n)
    out = {}
    for lo, hi in ((1, 1), (2, 8), (9, 64), (65, 2048), (2049, 2 ** 31)):
        sel = lengths[(lengths >= lo) & (lengths <= hi)]
        out[f"{lo}-{hi}"] = [int(sel.numel()), int(sel.sum())]
    out["longest"] = int(lengths.max())
    return out


def turn(root: Path, scale: int, reps: int, rounds: int,
         cases: tuple) -> dict:
    """One tree's readings of ``cases``, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.algorithms.common import default_work_budget
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels import build
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.queue_compact.ref import compact_ref
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    reports = build.build(
        ["compact"] + (["ordered_scatter_add"]
                       if {"scatter", "drain"} & set(cases) else []))
    registers = {name: [line.strip() for line in text.splitlines()
                        if "Used" in line or "spill" in line]
                 for name, text in reports.items()}
    graph = rmat(scale, edge_factor=16, seed=1, device="cuda")
    n, m = graph.num_vertices, graph.num_edges
    cfg = config_for(SchedulerConfig(num_workers=1024, fetch_size=4),
                     parse_policy("single.persistent"))
    budget = default_work_budget(graph, cfg.wavefront)
    rng = np.random.default_rng(0)
    n_push = budget + cfg.wavefront
    out = {"root": str(root), "registers": registers, "ms": {},
           "events_ms": {}, "host_us": {}, "ops": {}, "split": {},
           "shapes": {"n": n, "m": m, "k": budget, "n_push": n_push}}

    timed = {}
    if "scatter" in cases:
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
        want32 = base.cpu().numpy().copy()
        np.add.at(want32, index.cpu().numpy(), values.cpu().numpy())
        w64 = torch.as_tensor(rng.random(m) * 1e-3, device="cuda")
        zeros = torch.zeros(n, dtype=torch.float64, device="cuda")
        want64 = np.bincount(graph.col_idx.cpu().numpy(),
                             weights=w64.cpu().numpy(), minlength=n)
        timed["scatter_f32"] = (lambda: ordered_scatter_add_cuda(
            base, index, values), torch.from_numpy(want32))
        timed["scatter_f64"] = (lambda: ordered_scatter_add_cuda(
            zeros, graph.col_idx, w64), torch.from_numpy(want64))
        # k updates in segments of exactly `length` each (shuffled),
        # float32: one tier of the sum at a time
        for length in SEGMENT_LENGTHS:
            slots = -(-k // length)
            seg_index = rng.permutation(
                np.repeat(np.arange(slots), length)[:k])
            want = np.zeros(slots, dtype=np.float32)
            np.add.at(want, seg_index, values.cpu().numpy())
            seg_index = torch.as_tensor(seg_index.astype(np.int32),
                                        device="cuda")
            seg_base = torch.zeros(slots, dtype=torch.float32,
                                   device="cuda")
            timed[f"segments_of_{length}"] = (
                lambda seg_base=seg_base, seg_index=seg_index:
                ordered_scatter_add_cuda(seg_base, seg_index, values),
                torch.from_numpy(want))
        out["segments"] = {"scatter_f32": segment_lengths(index, n),
                           "scatter_f64": segment_lengths(graph.col_idx, n)}
    if "compact" in cases:
        items = torch.as_tensor(
            rng.integers(-2 ** 31, 2 ** 31 - 1, size=n_push),
            dtype=torch.int32, device="cuda")
        mask = torch.as_tensor(rng.random(n_push) < 0.3, device="cuda")
        timed["compact"] = (lambda: compact_cuda(items, mask),
                            compact_ref(items, mask))
    for name, (fn, want) in timed.items():
        got = fn()
        same = (torch.equal(got[0].cpu(), want[0].cpu())
                and int(got[1]) == int(want[1])) if name == "compact" \
            else torch.equal(got.cpu(), want)
        if not same:
            raise AssertionError(f"{name} differs from its oracle")
        case_reps = max(2, reps // 10) if name == "scatter_f64" else reps
        ms, ops, rows, _ = profiled(fn, case_reps)
        out["ms"][name], out["ops"][name] = ms, ops
        out["split"][name] = rows[:12]
        out["events_ms"][name] = events_ms(fn, case_reps)
        out["host_us"][name] = host_us(fn, case_reps)
    if "drain" not in cases:
        return out

    params = {"damping": 0.85, "eps": 1e-6, "check_size": 64}

    def drain(cut):
        c = config_for(SchedulerConfig(num_workers=1024, fetch_size=4,
                                       max_rounds=cut),
                       parse_policy("single.persistent"))
        return execute(build_program("pagerank", graph, c, params=params),
                       graph, c)

    ms, ops, rows, wall = profiled(lambda: drain(rounds), 1)
    # the host-bound drain's own time without the profiler's cost per op,
    # cut at rounds / 4 and at rounds: their difference is the time a round
    # without the setup
    walls = {}
    for cut in (rounds // 4, rounds):
        seconds = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drain(cut)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        walls[cut] = statistics.median(seconds)
    out["pagerank_persistent"] = {
        "rounds": rounds, "seconds": walls[rounds],
        "ms_a_round": 1e3 * (walls[rounds] - walls[rounds // 4])
        / (rounds - rounds // 4),
        "profiled_seconds": wall, "device_ms": ms,
        "device_ops_a_round": ops / rounds, "busy_share": ms / 1e3 / wall,
        "split": rows[:12]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", type=Path, nargs="+")
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=1024)
    ap.add_argument("--cases", default=",".join(CASES),
                    help="a comma list of " + ", ".join(CASES))
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    cases = tuple(args.cases.split(","))
    if not set(cases) <= set(CASES):
        ap.error(f"--cases takes {', '.join(CASES)}")
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.scale, args.reps,
                              args.rounds, cases)), flush=True)
        return 0
    trees = [tree.resolve() for tree in args.trees]
    readings = alternate(__file__, trees,
                         ["--scale", str(args.scale), "--reps",
                          str(args.reps), "--rounds", str(args.rounds),
                          "--cases", args.cases])
    name = card()
    print(name)
    medians = {}
    for at, (tree, runs) in enumerate(zip(args.trees, readings)):
        medians[f"{at} {tree}"] = median = {
            f"{case}_{key}": statistics.median(r[key][case] for r in runs)
            for case in runs[0]["ms"]
            for key in ("ms", "ops", "host_us", "events_ms")}
        if "drain" in cases:
            for key in ("seconds", "ms_a_round", "device_ops_a_round"):
                median[f"pagerank_persistent_{key}"] = statistics.median(
                    r["pagerank_persistent"][key] for r in runs)
    print(json.dumps({"median": medians, "card": name, "scale": args.scale}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
