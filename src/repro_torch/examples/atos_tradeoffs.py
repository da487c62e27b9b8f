"""The paper's analysis experiments, reproduced:

  1. Fig-4 analogue -- runtime heatmap over (num_workers x fetch_size);
  2. section 6.4 -- vertex-ID permutation vs graph-coloring overwork;
  3. kernel strategy -- persistent vs discrete round/dispatch counts.

The counterpart of ``examples/atos_tradeoffs.py``, with ``--device``
(default ``cuda``; pass ``cpu`` to run on the host):

  PYTHONPATH=src python -m repro_torch.examples.atos_tradeoffs --device cpu

Timings are host-clock milliseconds ending in a device synchronize; the
rest (work/|V|, rounds, dispatches) is what the reference prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..algorithms.bfs import bfs_speculative
from ..algorithms.coloring import coloring_async
from ..core import SchedulerConfig
from ..graph import grid2d, permute_vertices, rmat


def _timed_bfs(g, cfg) -> tuple:
    """(info, milliseconds) of one BFS from vertex 0."""
    sync = torch.cuda.synchronize if g.device.type == "cuda" else (
        lambda: None)
    sync()
    t0 = time.perf_counter()
    _, info = bfs_speculative(g, 0, cfg)
    sync()
    return info, (time.perf_counter() - t0) * 1e3


def heatmap(device):
    print("=== Fig 4 analogue: BFS runtime (ms) over workers x fetch ===")
    g = rmat(9, 8, seed=1, device=device)
    print(f"{'':>8}" + "".join(f"fetch={f:<6}" for f in [1, 4, 16]))
    for w in [4, 16, 64]:
        cells = []
        for f in [1, 4, 16]:
            cfg = SchedulerConfig(num_workers=w, fetch_size=f,
                                  persistent=True, max_rounds=1 << 20)
            _timed_bfs(g, cfg)  # warm
            cells.append(f"{_timed_bfs(g, cfg)[1]:8.1f}    ")
        print(f"w={w:<6}" + "".join(cells))


def permutation(device):
    print("\n=== section 6.4: vertex-ID permutation vs coloring overwork ===")
    g = grid2d(24, 24, device=device)
    perm = np.random.default_rng(0).permutation(g.num_vertices).astype(np.int32)
    gp = permute_vertices(g, perm)
    cfg = SchedulerConfig(num_workers=16, fetch_size=8, persistent=True,
                          max_rounds=1 << 20)
    for name, gg in [("sorted IDs  ", g), ("permuted IDs", gp)]:
        _, info = coloring_async(gg, cfg)
        print(f"  {name}: work/|V| = {info['work'] / gg.num_vertices:.3f}")


def kernel_strategy(device):
    print("\n=== kernel strategy: persistent vs discrete (BFS, mesh) ===")
    g = grid2d(32, 32, device=device)
    for persistent in [True, False]:
        cfg = SchedulerConfig(num_workers=16, fetch_size=2,
                              persistent=persistent, max_rounds=1 << 20)
        info, dt = _timed_bfs(g, cfg)
        kind = "persistent" if persistent else "discrete  "
        n_dispatch = 1 if persistent else info["rounds"]
        print(f"  {kind}: rounds={info['rounds']:5d} wall={dt:7.1f} ms "
              f"({n_dispatch} host dispatches)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    device = ap.parse_args(argv).device
    heatmap(device)
    permutation(device)
    kernel_strategy(device)


if __name__ == "__main__":
    main()
