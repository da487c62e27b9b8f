"""Time the megakernel drains of checkouts of the port on one card.

    python3 tools/drain_ab.py OLD_ROOT NEW_ROOT            # rmat(21)
    python3 tools/drain_ab.py --drains coloring,coloring.g4 A B C
    python3 tools/drain_ab.py --scale 14 --reps 2 . .      # a quick rehearsal

A checkout is a directory that holds ``src/repro_torch``.  The trees run in
turns, in the order given and then reversed (OLD NEW NEW OLD for two), each
turn a process of its own that imports the checkout's package, builds its
drain kernels from its own sources (ptxas's register and spill lines are
printed), makes rmat(scale, 16, seed 1) on the card, and times each drain
under ``single.megakernel`` with W = 4096 (1024 workers x 4): one warm-up
drain, then ``--reps`` drains, each under torch.profiler; a drain's time is
its kernel's device time.  BFS runs from the highest-degree vertex at
granularity 1, 4 (``bfs.g4``) and with per_item expansion at granularity 1
(``bfs.per_item``), coloring whole at granularity 1 and 4 (``coloring.g4``),
PageRank (damping 0.85, eps 1e-6, check_size 64) at granularity 1 cut at
``--pagerank-rounds`` rounds; ``--drains`` takes a part.  Only the public
entry points (``build_program``, ``execute``) are called, so every tree
takes the same calls.  Each turn prints one JSON line; the last lines are
the card and the median per tree and drain.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

DRAINS = ("bfs", "bfs.g4", "bfs.per_item", "pagerank", "coloring",
          "coloring.g4")


def turn(root: Path, scale: int, reps: int, pagerank_rounds: int,
         drains: tuple = DRAINS) -> dict:
    """One tree's ``drains``, in this process."""
    sys.path.insert(0, str(root / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels import build
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    if not torch.cuda.is_available():
        raise SystemExit("drain_ab needs a CUDA card")
    reports = build.build(sorted({f"{drain.partition('.')[0]}_drain"
                                  for drain in drains}))
    registers = {name: [line.strip() for line in text.splitlines()
                        if "Used" in line or "spill" in line]
                 for name, text in reports.items()}
    graph = rmat(scale, edge_factor=16, seed=1, device="cuda")
    source = int(torch.argmax(graph.degrees()))
    params = {"bfs": {"source": source}, "coloring": None,
              "pagerank": {"damping": 0.85, "eps": 1e-6, "check_size": 64}}
    out = {"root": str(root), "registers": registers, "ms": {}, "rounds": {}}
    for drain in drains:
        algo, _, variant = drain.partition(".")
        cut = {"max_rounds": pagerank_rounds} if algo == "pagerank" else {}
        granularity = variant if variant.startswith("g") else ""
        cfg = config_for(SchedulerConfig(num_workers=1024, fetch_size=4,
                                         **cut),
                         parse_policy("single.megakernel"
                                      + (f".{granularity}" if granularity
                                         else "")))
        drain_params = params[algo]
        if variant == "per_item":
            drain_params = {**drain_params, "strategy": "per_item"}

        def run():
            return execute(build_program(algo, graph, cfg,
                                         params=drain_params), graph, cfg)

        out["rounds"][drain] = run().info["rounds"]
        times = []
        for _ in range(reps):
            # the profiler now and then keeps no record of a run: up to
            # three tries
            for _ in range(3):
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                ms = sum(e.self_device_time_total / 1e3
                         for e in prof.key_averages()
                         if f"{algo}_drain" in e.key)
                if ms > 0:
                    break
            else:
                raise AssertionError(f"the profiler saw no {algo}_drain in "
                                     f"three tries")
            times.append(ms)
        out["ms"][drain] = times
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def alternate(script: str, trees: list, flags: list) -> list:
    """Run ``script TREES... FLAGS --turn TREE`` for each tree in the order
    TREES, then TREES reversed (OLD NEW NEW OLD for two), each turn a
    process of its own.  Prints each turn's JSON line (its last line of
    output) with the tree's place in TREES; returns the readings of each
    tree, in the order of TREES."""
    readings = [[] for _ in trees]
    order = [*range(len(trees)), *reversed(range(len(trees)))]
    for at in order:
        done = subprocess.run(
            [sys.executable, script, *map(str, trees), *flags,
             "--turn", str(trees[at])], capture_output=True, text=True)
        if done.returncode != 0:
            sys.stderr.write(done.stderr)
            raise SystemExit(f"the turn of {trees[at]} failed "
                             f"({done.returncode})")
        result = json.loads(done.stdout.strip().splitlines()[-1])
        readings[at].append(result)
        print(json.dumps({"turn": at, **result}), flush=True)
    return readings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", type=Path, nargs="+")
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--pagerank-rounds", type=int, default=512)
    ap.add_argument("--drains", default=",".join(DRAINS),
                    help="a comma list of " + ", ".join(DRAINS))
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    drains = tuple(args.drains.split(","))
    if not set(drains) <= set(DRAINS):
        ap.error(f"--drains takes {', '.join(DRAINS)}")
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.scale, args.reps,
                              args.pagerank_rounds, drains)), flush=True)
        return 0
    readings = alternate(__file__, [tree.resolve() for tree in args.trees],
                         ["--scale", str(args.scale), "--reps",
                          str(args.reps), "--pagerank-rounds",
                          str(args.pagerank_rounds), "--drains",
                          args.drains])
    name = card()
    print(name)
    print(json.dumps({"median_ms": {
        f"{at} {tree}": {drain: statistics.median(
            ms for r in runs for ms in r["ms"][drain]) for drain in drains}
        for at, (tree, runs) in enumerate(zip(args.trees, readings))},
        "card": name, "scale": args.scale}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
