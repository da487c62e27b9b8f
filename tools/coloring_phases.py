"""Where B3-col's rounds spend their time, phase by phase and warp by warp,
on one card.

    python3 tools/coloring_phases.py            # this checkout, rmat(21)
    python3 tools/coloring_phases.py --scale 14 # a quick rehearsal

Copies the checkout's ``src/repro_torch`` under ``build/phases/`` (which
``.gitignore`` lists) and adds to that copy of ``csrc/coloring_drain.cu``
readings of the card's global nanosecond clock (``%globaltimer``): by block
0's thread 0 after each grid barrier of a round and after its pop, summed
per phase; and by lane 0 of every warp around each of its two walks of a
round's visits (the forbidden colors, the detects), summed over the warps
and kept as the round's largest, with the walk's steps of 128 visits and
the lanes of the other kind it stepped over.  Then it builds the copy and
drains coloring on rmat(scale, 16, seed 1) under ``single.megakernel``
(W = 4096): whole at g1, its first 64 rounds at g1, whole at g4, one
warm-up drain before each.  Every grid barrier ends a phase in every block
at once, so block 0's clock between two barriers is the phase's time on
the whole grid, the barrier's own cost included; the pop is block 0's own.
Prints one JSON line a drain: rounds, microseconds a round by phase, and
for each walk a warp's mean and the slowest warp's microseconds a round,
steps and skipped lanes a warp a round, and the five rounds with the
slowest walks.  The kernel in the checkout is not changed; the copy's
instance is the one measured.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("pop", "or", "pick", "detect", "window", "push_count", "ring")
WALKS = ("or", "detect")
MAX_ROUNDS = 4096                  # rounds whose slowest walk is kept

# the card's global nanosecond clock, for a drain source's anonymous
# namespace; no memory access moves across a reading
CLOCK = ("__device__ __forceinline__ unsigned long long now_ns() {\n"
         "  unsigned long long t;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;"\n'
         '               : "=l"(t) :: "memory");\n'
         "  return t;\n}\n")

# (anchor, replacement) pairs, each anchor once in csrc/coloring_drain.cu
PATCH = (
    ("namespace {\n\nusing namespace drain;\n",
     "__device__ unsigned long long g_phase[8];\n"
     "__device__ unsigned long long g_walk[6];\n"
     f"__device__ unsigned long long g_slowest[2][{MAX_ROUNDS}];\n\n"
     "namespace {\n\n"
     "using namespace drain;\n\n" + CLOCK),
    ("  long long visits = 0;\n",
     "  long long visits = 0;\n"
     "  const bool stamp = blockIdx.x == 0 && threadIdx.x == 0;\n"
     "  unsigned long long t_prev = now_ns();\n"
     "  auto mark = [&](int i) {\n"
     "    if (stamp) {\n"
     "      const unsigned long long t = now_ns();\n"
     "      g_phase[i] += t - t_prev;\n"
     "      t_prev = t;\n"
     "    }\n  };\n"),
    ("    const int V = S[WG - 1];\n",
     "    const int V = S[WG - 1];\n    mark(0);\n"),
    ("    acc[warp][lane] = 0u;\n    grid_barrier(d.barrier);\n",
     "    acc[warp][lane] = 0u;\n    grid_barrier(d.barrier);\n"
     "    mark(1);\n"),
    ("      if (mine) d.colors[vertex_of(f)] = pick;\n    }\n"
     "    grid_barrier(d.barrier);\n",
     "      if (mine) d.colors[vertex_of(f)] = pick;\n    }\n"
     "    grid_barrier(d.barrier);\n    mark(2);\n"),
    ("d.bits[i] = 0u;\n      }\n    }\n    grid_barrier(d.barrier);\n",
     "d.bits[i] = 0u;\n      }\n    }\n    grid_barrier(d.barrier);\n"
     "    mark(3);\n"),
    ("          window_add(d.win, vertex_of(f), cc, r);\n        }\n"
     "      }\n      grid_barrier(d.barrier);\n",
     "          window_add(d.win, vertex_of(f), cc, r);\n        }\n"
     "      }\n      grid_barrier(d.barrier);\n      mark(4);\n"),
    ("    if (tid == 0) d.block_count[blockIdx.x] = kept;\n"
     "    grid_barrier(d.barrier);\n",
     "    if (tid == 0) d.block_count[blockIdx.x] = kept;\n"
     "    grid_barrier(d.barrier);\n    mark(5);\n"),
    ("        });\n    grid_barrier(d.barrier);\n\n    // 6.",
     "        });\n    grid_barrier(d.barrier);\n    mark(6);\n\n    // 6."),
    ("  auto walk = [&](int V, int want, auto visit, auto stepped) {\n",
     "  auto walk = [&](int V, int want, auto visit, auto stepped) {\n"
     "    const unsigned long long t_walk = now_ns();\n"
     "    unsigned long long n_steps = 0, n_skips = 0;\n"
     "    const int which = want == 1 ? 0 : 1;\n"
     "    auto done = [&]() {\n"
     "      if (lane == 0) {\n"
     "        const unsigned long long dt = now_ns() - t_walk;\n"
     "        atomicAdd(&g_walk[which], dt);\n"
     "        atomicAdd(&g_walk[2 + which], n_steps);\n"
     "        atomicAdd(&g_walk[4 + which], n_skips);\n"
     f"        if (rounds < {MAX_ROUNDS}) "
     "atomicMax(&g_slowest[which][rounds], dt);\n"
     "      }\n    };\n"),
    ("    if (s0 >= s1) return;\n",
     "    if (s0 >= s1) {\n      done();\n      return;\n    }\n"),
    ("        x = S[f];\n",
     "        x = S[f];\n        ++n_skips;\n"),
    ("      const int end = min(x + kStep, s1);\n",
     "      const int end = min(x + kStep, s1);\n      ++n_steps;\n"),
    ("      if (x < s1) f = owner_from(S, WG, f_last, x);\n    }\n  };\n",
     "      if (x < s1) f = owner_from(S, WG, f_last, x);\n    }\n"
     "    done();\n  };\n"),
)

READER = """
extern "C" int coloring_phases(unsigned long long* phase,
                               unsigned long long* walk,
                               unsigned long long* slowest) {
  cudaError_t err = cudaMemcpyFromSymbol(phase, g_phase, sizeof(g_phase));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(walk, g_walk, sizeof(g_walk));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(slowest, g_slowest, sizeof(g_slowest));
  if (err != cudaSuccess) return err;
  static unsigned long long zero[sizeof(g_slowest) / 8] = {0};
  err = cudaMemcpyToSymbol(g_phase, zero, sizeof(g_phase));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_walk, zero, sizeof(g_walk));
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_slowest, zero, sizeof(g_slowest));
  return err;
}
"""


def instrumented_copy(tree: Path, source: str = "coloring_drain",
                      patch=PATCH, reader: str = READER,
                      tool: str = "tools/coloring_phases.py") -> Path:
    """``tree``'s package copied under ``tree/build/phases/src``, with
    ``csrc/<source>.cu`` patched by the (anchor, replacement) pairs of
    ``patch`` (each anchor once in the source) and ``reader`` appended;
    returns the copy's ``src``."""
    src = tree / "build" / "phases" / "src"
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(tree / "src" / "repro_torch", src / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = src / "repro_torch" / "csrc" / f"{source}.cu"
    text = path.read_text()
    for anchor, replacement in patch:
        if text.count(anchor) != 1:
            raise SystemExit(f"{source}.cu no longer has one "
                             f"{anchor!r}: update {tool}")
        text = text.replace(anchor, replacement)
    path.write_text(text + reader)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=Path, nargs="?", default=ROOT)
    ap.add_argument("--scale", type=int, default=21)
    args = ap.parse_args()
    sys.path.insert(0, str(instrumented_copy(args.tree.resolve())))
    import torch

    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels import build
    from repro_torch.kernels.drain_loop.coloring_drain import _grid
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    if not torch.cuda.is_available():
        raise SystemExit("coloring_phases needs a CUDA card")
    build.build(["coloring_drain"])
    read = build.load("coloring_drain").coloring_phases
    read.argtypes = [ctypes.c_void_p] * 3
    read.restype = ctypes.c_int
    graph = rmat(args.scale, edge_factor=16, seed=1, device="cuda")
    sums = (ctypes.c_ulonglong * 8)()
    walks = (ctypes.c_ulonglong * 6)()
    slowest = (ctypes.c_ulonglong * (2 * MAX_ROUNDS))()
    for policy, cut in (("single.megakernel", None),
                        ("single.megakernel", 64),
                        ("single.megakernel.g4", None)):
        extra = {} if cut is None else {"max_rounds": cut}
        cfg = config_for(SchedulerConfig(num_workers=1024, fetch_size=4,
                                         **extra), parse_policy(policy))

        def run():
            out = execute(build_program("coloring", graph, cfg), graph, cfg)
            torch.cuda.synchronize()
            return out

        run()
        if read(sums, walks, slowest):
            raise RuntimeError("reading the phase clock failed")
        rounds = run()[2]["rounds"]
        if read(sums, walks, slowest):
            raise RuntimeError("reading the phase clock failed")
        warps = 16 * _grid(graph.row_ptr.device.index, cfg.wavefront,
                           cfg.granularity, False, False, False)[0]
        kept = min(rounds, MAX_ROUNDS)
        per_walk = {}
        for i, name in enumerate(WALKS):
            worst = slowest[i * MAX_ROUNDS:i * MAX_ROUNDS + kept]
            per_walk[name] = {
                "mean_warp_us": walks[i] / 1e3 / warps / rounds,
                "slowest_warp_us": sum(worst) / 1e3 / kept,
                "steps": walks[2 + i] / warps / rounds,
                "skipped_lanes": walks[4 + i] / warps / rounds,
                "slowest_rounds": sorted(
                    ((r, worst[r] / 1e3) for r in range(kept)),
                    key=lambda t: -t[1])[:5]}
        print(json.dumps({
            "policy": policy, "max_rounds": cut, "rounds": rounds,
            "warps": warps, "us_a_round": sum(sums[:7]) / 1e3 / rounds,
            "phases_us_a_round": {name: sums[i] / 1e3 / rounds
                                  for i, name in enumerate(PHASES)},
            "walks": per_walk}), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
