"""Hold ``chip_smoke.device_rows`` against torch.profiler's ``key_averages``.

    python3 tools/profile_rows_check.py      # needs one CUDA card

Profiles a BFS drain on rmat(16) (W = 4096, ``single.persistent``) and
3,000 small adds on the card and prints, for each, whether the two readers
give the same device ops and call counts, their largest difference in ms,
and the seconds each took to read the profile.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels import build
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    build.build(["lbs", "compact"])
    graph = rmat(16, 16, seed=1, device="cuda")
    cfg = config_for(SchedulerConfig(num_workers=1024, fetch_size=4),
                     parse_policy("single.persistent"))
    execute(build_program("bfs", graph, cfg), graph, cfg)   # warm
    cases = {
        "bfs": lambda: execute(build_program("bfs", graph, cfg), graph, cfg),
        "adds": lambda: [torch.ones(1000, device="cuda") + 1
                         for _ in range(3000)]}
    for name, fn in cases.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fast = sorted(chip_smoke.device_rows(prof))
        t1 = time.perf_counter()
        slow = sorted((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0)
        t2 = time.perf_counter()
        same_keys = [r[0] for r in fast] == [r[0] for r in slow]
        same_counts = [r[2] for r in fast] == [r[2] for r in slow]
        worst = (max(abs(a[1] - b[1]) for a, b in zip(fast, slow))
                 if same_keys else None)
        print(f"{name} {len(fast)} rows; keys equal {same_keys} counts equal "
              f"{same_counts} max ms diff {worst} fast {t1 - t0:.4f} s, "
              f"key_averages {t2 - t1:.4f} s")


if __name__ == "__main__":
    main()
