"""Time ``core/task.chunk_seeds`` of checkouts of the port on the host.

    python3 tools/chunk_seeds_ab.py OLD_ROOT NEW_ROOT       # rmat(21)
    python3 tools/chunk_seeds_ab.py --scale 14 . .          # a quick run

A checkout is a directory that holds ``src/repro_torch``.  The trees run in
turns, in the order given and then reversed, each turn a process of its
own that imports the checkout's package, makes rmat(scale, 16, seed 1)
(on the card when there is one, else on the host) and times
``chunk_seeds(arange(n), ChunkCodec(G), row_ptr, split_threshold=T)`` for
the inits that call it at full size: PageRank's at G = 4 (``T`` = its work
budget at W = 4096) and coloring's at G = 4 and 2 (``T`` = None).  Each
case runs ``--reps`` times; its time is the median.  The chunks of every
tree must be equal (their CRC is printed).  Each turn prints one JSON
line; the last line is the median per tree and case.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path


def turn(root: Path, scale: int, reps: int) -> dict:
    """One tree's cases, in this process."""
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch

    from repro_torch.algorithms.common import default_work_budget
    from repro_torch.core import ChunkCodec, chunk_seeds
    from repro_torch.graph import rmat

    device = "cuda" if torch.cuda.is_available() else "cpu"
    graph = rmat(scale, edge_factor=16, seed=1, device=device)
    n = graph.num_vertices
    budget = default_work_budget(graph, 4096)
    cases = {"pagerank.g4": (4, budget), "coloring.g4": (4, None),
             "coloring.g2": (2, None)}
    out = {"root": str(root), "n": n, "seconds": {}, "crc": {}}
    for name, (g, threshold) in cases.items():
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            chunks = chunk_seeds(np.arange(n), ChunkCodec(g), graph.row_ptr,
                                 split_threshold=threshold)
            walls.append(time.perf_counter() - t0)
        out["seconds"][name] = statistics.median(walls)
        out["crc"][name] = [int(chunks.shape[0]), zlib.crc32(chunks.tobytes())]
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+", type=Path)
    ap.add_argument("--scale", type=int, default=21)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--turn", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn is not None:
        print(json.dumps(turn(args.turn.resolve(), args.scale, args.reps)))
        return
    order = list(args.roots) + list(reversed(args.roots))
    runs = []
    for root in order:
        proc = subprocess.run(
            [sys.executable, __file__, "--turn", str(root), "--scale",
             str(args.scale), "--reps", str(args.reps), "x"],
            capture_output=True, text=True, check=True)
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    crcs = {json.dumps(r["crc"], sort_keys=True) for r in runs}
    if len(crcs) != 1:
        raise SystemExit(f"the trees' chunks differ: {crcs}")
    medians = {}
    for root in dict.fromkeys(str(r.resolve()) for r in args.roots):
        mine = [r for r in runs if r["root"] == root]
        medians[root] = {case: statistics.median(r["seconds"][case]
                                                 for r in mine)
                         for case in mine[0]["seconds"]}
    print(json.dumps({"median_seconds": medians}))


if __name__ == "__main__":
    main()
