"""Where B3-BFS's rounds spend their time, phase by phase, on one card.

    python3 tools/bfs_phases.py                # this checkout, rmat(21)
    python3 tools/bfs_phases.py OTHER_ROOT     # another checkout
    python3 tools/bfs_phases.py --scale 14     # a quick rehearsal

Copies the checkout's ``src/repro_torch`` under ``build/phases/`` (which
``.gitignore`` lists; ``tools/coloring_phases.py``'s ``instrumented_copy``)
and adds to that copy of ``csrc/bfs_drain.cu`` readings of the card's
global nanosecond clock (``%globaltimer``) by block 0's thread 0, summed
per phase over the drain:

* ``pop``: from the round's start (the last barrier of the round before)
  to the wavefront popped, and ``pop_scan``, its degrees scanned;
* ``expand``: the units' searches, loads and atomics, split further, by
  thread 0's own units, into ``search`` (the owners found, the col_idx
  loads issued), ``col_idx`` (until those words arrive and the dist loads
  go out), ``dist`` (until the dist words arrive and the atomics go out)
  and ``expand``, the rest;
* ``winners``: the kept units' dist writes (and at G > 1 the window adds
  and their barrier) up to the push;
* ``push``: the ring writes with the look-back, and the waiting tasks'
  lane data.

``expand_wait`` and ``push_wait`` are block 0's waits in the grid barriers
that end the expansion and the round.  A grid barrier ends a phase in
every block at once, so block 0's clock between two barriers is the
phase's time on the whole grid, the barrier's own cost included; a phase
that ends without a barrier is block 0's own.  The anchors fit this
design of the kernel (a push with no barrier of its own) and no earlier
one.  It builds the copy and drains BFS on rmat(scale,
16, seed 1) from its highest-degree vertex under ``single.megakernel``
(W = 4096): at G = 1, at G = 4 and with per_item expansion at G = 1, one
warm-up drain before each.  Prints one JSON line a drain: rounds,
microseconds a round in all and by phase.  The kernel in the checkout is
not changed; the copy's instance is the one measured.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from coloring_phases import CLOCK, instrumented_copy

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("pop", "expand", "expand_wait", "winners", "push", "push_wait",
          "search", "col_idx", "dist", "pop_scan")

PRELUDE = ("namespace {\n\nusing namespace drain;\n",
           "__device__ unsigned long long g_phase[10];\n\n"
           "namespace {\n\nusing namespace drain;\n\n" + CLOCK)
MARK = ("  long long units = 0;\n",
        "  long long units = 0;\n"
        "  const bool clocked = blockIdx.x == 0 && threadIdx.x == 0;\n"
        "  unsigned long long t_prev = now_ns();\n"
        "  auto mark = [&](int i) {\n"
        "    if (clocked) {\n"
        "      const unsigned long long t = now_ns();\n"
        "      g_phase[i] += t - t_prev;\n"
        "      t_prev = t;\n"
        "    }\n  };\n")

# (anchor, replacement) pairs, each anchor once in csrc/bfs_drain.cu
PATCHES = (
    PRELUDE, MARK,
    ("    __syncthreads();\n    scan_lanes<kThreads>(scan, W, warp_sums);\n",
     "    __syncthreads();\n    mark(0);\n"
     "    scan_lanes<kThreads>(scan, W, warp_sums);\n    mark(9);\n"),
    ("      gather(t0, u1, owner, src, nbr);\n",
     "      gather(t0, u1, owner, src, nbr);\n      mark(6);\n"),
    ("                          : cands[owner[s]];\n      }\n",
     "                          : cands[owner[s]];\n      }\n"
     "      mark(7);\n"),
    ("          d.unit_nbr[u] = kept;\n        }\n      }\n    }\n"
     "    grid_barrier(d.barrier);\n",
     "          d.unit_nbr[u] = kept;\n        }\n      }\n"
     "      mark(8);\n    }\n    mark(1);\n"
     "    grid_barrier(d.barrier);\n    mark(2);\n"),
    ("      } else {\n        push(t, t0, t1, kept, bw);\n      }\n",
     "      } else {\n        mark(3);\n"
     "        push(t, t0, t1, kept, bw);\n      }\n"),
    ("    if constexpr (kChunks) {\n      grid_barrier(d.barrier);\n",
     "    if constexpr (kChunks) {\n      grid_barrier(d.barrier);\n"
     "      mark(3);\n"),
    ("    // block 0 keeps the round's work, the widths",
     "    mark(4);\n    // block 0 keeps the round's work, the widths"),
    ("    grid_barrier(d.barrier);\n    preload(head_after);\n",
     "    grid_barrier(d.barrier);\n    mark(5);\n"
     "    preload(head_after);\n"),
)

READER = """
extern "C" int bfs_phases(unsigned long long* phase) {
  cudaError_t err = cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));
  if (err != cudaSuccess) return err;
  static unsigned long long zero[10] = {0};
  return cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
}
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--scale", type=int, default=21)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(instrumented_copy(
        tree, "bfs_drain", PATCHES, READER, "tools/bfs_phases.py")))
    import torch

    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels import build
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    if not torch.cuda.is_available():
        raise SystemExit("bfs_phases needs a CUDA card")
    build.build(["bfs_drain"])
    read = build.load("bfs_drain").bfs_phases
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    graph = rmat(args.scale, edge_factor=16, seed=1, device="cuda")
    source = int(torch.argmax(graph.degrees()))
    sums = (ctypes.c_ulonglong * 10)()
    for policy, strategy in (("single.megakernel", "merge_path"),
                             ("single.megakernel.g4", "merge_path"),
                             ("single.megakernel", "per_item")):
        cfg = config_for(SchedulerConfig(num_workers=1024, fetch_size=4),
                         parse_policy(policy))
        params = {"source": source, "strategy": strategy}

        def run():
            out = execute(build_program("bfs", graph, cfg, params=params),
                          graph, cfg)
            torch.cuda.synchronize()
            return out

        run()
        if read(sums):
            raise RuntimeError("reading the phase clock failed")
        rounds = run()[2]["rounds"]
        if read(sums):
            raise RuntimeError("reading the phase clock failed")
        print(json.dumps({
            "tree": str(tree), "policy": policy,
            "strategy": strategy, "rounds": rounds,
            "us_a_round": sum(sums) / 1e3 / rounds,
            "phases_us_a_round": {name: sums[i] / 1e3 / rounds
                                  for i, name in enumerate(PHASES)}}),
            flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
