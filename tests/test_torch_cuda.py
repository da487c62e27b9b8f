"""The PyTorch port on the card: each CUDA kernel against its plain PyTorch
version at the main path's shapes and edge sizes, and BFS through both
kernels against the plain backend, bit for bit.

Every test carries the ``gpu`` marker and skips inside its body when no
CUDA device is available.  This file imports neither JAX nor the
reference package, so it runs on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.frontier_expand.ref import lbs_ref
from repro_torch.kernels.queue_compact.ref import compact_ref

pytestmark = pytest.mark.gpu

LBS_CASES = [(1, 128), (7, 64), (32, 1024), (100, 2048), (257, 4096),
             (1000, 1024), (4096, 495616), (70000, 4096)]


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card")


@pytest.mark.parametrize("w,budget", LBS_CASES)
def test_lbs_kernel_matches_plain(w, budget):
    """Includes W = 70000, whose scan (280 KB) exceeds shared memory and
    takes the global-memory search."""
    _require_cuda()
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda

    deg = np.random.default_rng(w).integers(0, 9, size=w)
    deg[::7] = 0                                    # zero-degree rows
    scan = torch.from_numpy(np.cumsum(deg).astype(np.int32)).cuda()
    o, r = lbs_cuda(scan, budget)
    ro, rr = lbs_ref(scan, budget)
    assert torch.equal(o, ro) and torch.equal(r, rr)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1023, 1024, 1025, 499712])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_kernel_matches_plain(n, p):
    _require_cuda()
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    rng = np.random.default_rng(n)
    items = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, size=n)
                             .astype(np.int32)).cuda()
    mask = torch.from_numpy(rng.random(n) < p).cuda()
    out, cnt = compact_cuda(items, mask)
    rout, rcnt = compact_ref(items, mask)
    assert torch.equal(out, rout) and int(cnt) == int(rcnt)


@pytest.mark.parametrize("policy", ["single.persistent", "single.discrete",
                                    "single.persistent.g4"])
def test_bfs_through_kernels_matches_plain_and_cpu(policy):
    _require_cuda()
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    results = []
    for device, backend in (("cuda", "auto"), ("cuda", "torch"),
                            ("cpu", "auto")):
        g = rmat(10, 16, seed=2, device=device)
        cfg = config_for(SchedulerConfig(num_workers=64, fetch_size=2,
                                         backend=backend),
                         parse_policy(policy))
        before = (lbs_cuda.launches, compact_cuda.launches)
        state, stats, info = execute(build_program("bfs", g, cfg,
                                                   params={"source": 0}),
                                     g, cfg)
        launched = (lbs_cuda.launches - before[0],
                    compact_cuda.launches - before[1])
        assert (min(launched) > 0) == (device == "cuda" and backend == "auto")
        results.append((state.dist.cpu(), [int(x) for x in stats], info))
    for dist, stats, info in results[1:]:
        assert torch.equal(dist, results[0][0])
        assert stats == results[0][1] and info == results[0][2]
