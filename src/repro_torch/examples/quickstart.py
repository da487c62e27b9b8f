"""Quickstart: the Atos task-parallel scheduler on the paper's three case
studies (BFS / PageRank / graph coloring), BSP vs relaxed-barrier.

The counterpart of ``examples/quickstart.py``, with ``--device`` (default
``cuda``; pass ``cpu`` to run on the host):

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

It prints what the reference prints: rounds, work and validity are the
same on either device and in either package; ``err`` is PageRank's
largest distance from the power iteration.
"""
from __future__ import annotations

import argparse

import torch

from ..algorithms.bfs import bfs_bsp, bfs_speculative
from ..algorithms.coloring import (coloring_async, coloring_bsp,
                                   validate_coloring)
from ..algorithms.pagerank import (pagerank_async, pagerank_bsp,
                                   pagerank_reference)
from ..core import SchedulerConfig
from ..graph import degree_stats, grid2d, rmat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    device = ap.parse_args(argv).device
    for name, g in [("scale-free (R-MAT)", rmat(9, 8, seed=1, device=device)),
                    ("mesh-like (grid)", grid2d(32, 32, device=device))]:
        print(f"\n=== {name}: {degree_stats(g)}")
        cfg = SchedulerConfig(num_workers=16, fetch_size=4, persistent=True,
                              max_rounds=1 << 20)

        dist, info_b = bfs_bsp(g, 0)
        dist_a, info_a = bfs_speculative(g, 0, cfg, strategy="merge_path")
        same = bool(torch.equal(dist, dist_a))
        print(f"BFS       BSP levels={info_b['levels']:4d} | Atos rounds="
              f"{info_a['rounds']:4d} work={info_a['work']} exact={same}")

        ref = pagerank_reference(g, iters=200)
        _, pb = pagerank_bsp(g, eps=1e-6)
        ra, pa = pagerank_async(g, cfg, eps=1e-6)
        err = float((ra - ref).abs().max())
        print(f"PageRank  BSP work={pb['work']:7d} | Atos work="
              f"{pa['work']:7d} (ratio {pa['work'] / pb['work']:.2f}) "
              f"err={err:.1e}")

        cb, ib = coloring_bsp(g)
        ca, ia = coloring_async(g, cfg)
        print(f"Coloring  BSP work/|V|={ib['work'] / g.num_vertices:.2f} | "
              f"Atos work/|V|={ia['work'] / g.num_vertices:.2f} "
              f"valid={validate_coloring(g, ca)} "
              f"colors={int(ca.max()) + 1}")


if __name__ == "__main__":
    main()
