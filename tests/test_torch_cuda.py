"""The PyTorch port on the card: each CUDA kernel against its plain PyTorch
version at the main path's shapes and edge sizes, BFS through both kernels
against the plain backend, the ordered scatter-add against the CPU's
sequential sum and the PageRank and coloring drain kernels against their
persistent, plain and CPU drains, bit for bit, B3-col on hubs past a
warp's or a block's share of a round and on two streams, every drain
kernel at granularities 2, 3 and 8 (and BFS per_item) and in its fused,
traced and slotted modes against the plain fused drain, streams on the
card against the CPU, B3-pr's ordered sum on a hub graph past a block's
sort, B3-BFS where its design bends (a backlog past W, resumed segments,
a ring that drops, hubs whose round takes two tiles a block, a wavefront
in global scratch; every mode at G = 1, 2, 4, 64 and per_item), the drain
kernels' grid barrier alone (10^5 checked rounds), the
flash-attention kernel B5 (its tensor-core and CUDA-core instances)
against ``attention_ref`` within its stated tolerance, and the task
server's 8-job mix on the card against the same server on the CPU, with
the B1/B2 launches its lane steps imply, and the sharded topology: four
shards on one card against four CPU shards, and the exchange codec.

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
    """Includes W = 70000, a scan (280 KB) past shared memory, of which
    each block stages only its own window."""
    _require_cuda()
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda

    deg = np.random.default_rng(w).integers(0, 9, size=w)
    deg[::7] = 0                                    # zero-degree rows
    scan = torch.from_numpy(np.cumsum(deg).astype(np.int32)).cuda()
    o, r = lbs_cuda(scan, budget)
    ro, rr = lbs_ref(scan, budget)
    assert torch.equal(o, ro) and torch.equal(r, rr)


def _lbs_tie_case(case):
    """The scan (numpy int32) and budget of a case that decides the kernel's
    ties or partition: the kernel merges in tiles of 2048 items (units plus
    scan entries) and writes a tile wholly past the total without a
    search."""
    rng = np.random.default_rng(3)
    if case.startswith("W="):
        w, where = case[2:].split(" ")
        deg = rng.integers(0, 9, size=int(w))
        deg[::3] = 0
        deg[-1] = 5
        total = int(deg.sum())
        return (np.cumsum(deg).astype(np.int32),
                total + {"total-1": -1, "total": 0, "total+1": 1}[where])
    if case == "zero runs across tiles":
        deg = np.zeros(70000, dtype=np.int64)
        deg[::2500] = 3
        deg[4100] = 20000
        return np.cumsum(deg).astype(np.int32), int(deg.sum()) + 9000
    if case == "entries on each tile's last item":
        # entry j sits at merge position j + scan[j] = 2048 j + 2047
        return (np.cumsum(np.full(300, 2047)).astype(np.int32),
                300 * 2047 + 5000)
    if case == "entries on each tile's first item":
        # entry j at 2048 (j + 1), the first item of tile j + 1
        return (np.cumsum(np.r_[2048, np.full(299, 2047)]).astype(np.int32),
                2048 + 299 * 2047 + 100)
    if case == "all-zero scan":
        return np.zeros(300, dtype=np.int32), 1000
    if case == "budget 2^24":
        deg = rng.integers(0, 60, size=4096)
        return np.cumsum(deg).astype(np.int32), 2 ** 24
    if case == "budget below the total, W=2^16":
        deg = rng.integers(0, 40, size=2 ** 16)
        return np.cumsum(deg).astype(np.int32), int(deg.sum()) // 3
    raise ValueError(case)


LBS_TIES = ([f"W={w} {where}" for w in (1, 7, 4096, 2 ** 16)
             for where in ("total-1", "total", "total+1")]
            + ["zero runs across tiles", "entries on each tile's last item",
               "entries on each tile's first item", "all-zero scan",
               "budget 2^24", "budget below the total, W=2^16"])


@pytest.mark.parametrize("case", LBS_TIES)
def test_lbs_kernel_matches_plain_on_ties_and_tile_edges(case):
    """B1 bit for bit against ``lbs_ref`` on every unit: budgets at, one
    below and one above the scan's total; runs of zero-degree chunks longer
    than a tile; scan entries on a tile's first and last item; an all-zero
    scan; a budget of 2^24 (mostly tiles past the total); one launch a
    call."""
    _require_cuda()
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda

    scan, budget = _lbs_tie_case(case)
    scan = torch.from_numpy(scan).cuda()
    before = lbs_cuda.launches
    o, r = lbs_cuda(scan, budget)
    assert lbs_cuda.launches - before == 1
    ro, rr = lbs_ref(scan, budget)
    assert torch.equal(o, ro) and torch.equal(r, rr)


def test_lbs_is_one_device_op_a_call():
    _require_cuda()
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda

    deg = np.random.default_rng(5).integers(0, 200, size=4096)
    scan = torch.from_numpy(np.cumsum(deg).astype(np.int32)).cuda()
    ops = _device_ops(lambda: lbs_cuda(scan, 495616), 10)
    # the kernel and nothing else; the profiler may drop records, never
    # add them
    assert ops and all("lbs" in name for name in ops), ops
    assert sum(ops.values()) <= 10, ops


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1023, 1024, 1025, 499712,
                               4095, 4096, 4097, 131073, 2 ** 24])
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


def _compact_inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    items = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, size=n)
                             .astype(np.int32)).cuda()
    return items, torch.from_numpy(rng.random(n) < p).cuda()


def test_compact_same_input_three_times_and_unaligned():
    """Each call starts from its own zeroed status words and ticket: the
    same input three times in a row gives the same output, and so do
    inputs off the 16-byte grid (the kernel's scalar loads) between
    them."""
    _require_cuda()
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    items, mask = _compact_inputs(499712, 0.3, 5)
    want = compact_ref(items, mask)
    for _ in range(3):
        out, cnt = compact_cuda(items, mask)
        assert torch.equal(out, want[0]) and int(cnt) == int(want[1])
        odd_items, odd_mask = items[1:], mask[1:]
        odd = compact_cuda(odd_items, odd_mask)
        ref = compact_ref(odd_items, odd_mask)
        assert torch.equal(odd[0], ref[0]) and int(odd[1]) == int(ref[1])


def test_compact_on_two_streams():
    """Calls alternating on two streams, with no wait between them, each
    on its own zeroed buffer."""
    _require_cuda()
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    inputs = [_compact_inputs(300_000 + 4096 * i, 0.3 + 0.2 * i, i)
              for i in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(4):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[i].append(compact_cuda(*inputs[i]))
    torch.cuda.synchronize()
    for i in range(2):
        want = compact_ref(*inputs[i])
        for out, cnt in got[i]:
            assert torch.equal(out, want[0]) and int(cnt) == int(want[1])


def _device_ops(fn, calls):
    """The names of the device ops (kernels, copies, fills) of ``calls``
    calls, with their counts, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.self_device_time_total > 0}


def test_compact_is_one_launch_a_call():
    _require_cuda()
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    items, mask = _compact_inputs(499712, 0.3, 6)
    ops = _device_ops(lambda: compact_cuda(items, mask), 5)
    kernels = {name: n for name, n in ops.items() if "compact" in name}
    fills = {name: n for name, n in ops.items() if "compact" not in name}
    # one launch of the kernel a call, beside the fill that zeroes its
    # output; the profiler may drop records, never add them
    assert list(kernels) and sum(kernels.values()) <= 5, ops
    assert all("fill" in name.lower() or "memset" in name.lower()
               for name in fills) and sum(fills.values()) <= 5, ops


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


# ------------------------------------------------- B4, the row-slice stream
STREAM_CASES = [
    # (items, budget, how the starts are drawn)
    (0, 8, "random"), (1, 1, "random"), (1, 4096, "random"),
    (4096, 4096, "row_ptr"), (300, 4099, "near_end"), (257, 13, "random"),
    (64, 1000, "out_of_range"),
]


def _starts(rng, n_items, budget, how, row_ptr, m):
    if how == "row_ptr":
        rows = rng.integers(0, row_ptr.shape[0] - 1, size=n_items)
        return row_ptr[rows]
    if how == "near_end":
        return rng.integers(max(m - budget, 0), m + 1, size=n_items)
    if how == "out_of_range":
        return rng.integers(-3 * budget, m + 3 * budget, size=n_items)
    return rng.integers(0, m, size=n_items)


@pytest.mark.parametrize("n_items,budget,how", STREAM_CASES)
def test_stream_kernel_matches_plain(n_items, budget, how):
    _require_cuda()
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda, stream_row_slices_ref)

    g = rmat(10, 16, seed=2, device="cuda")
    rng = np.random.default_rng(n_items + budget)
    starts = _starts(rng, n_items, budget, how, g.row_ptr.cpu().numpy(),
                     g.num_edges)
    starts = torch.as_tensor(starts.astype(np.int32), device="cuda")
    before = stream_row_slices_cuda.launches
    got = stream_row_slices_cuda(g.col_idx, starts, budget)
    want = stream_row_slices_ref(g.col_idx, starts, budget)
    assert got.shape == want.shape == (n_items, budget)
    assert torch.equal(got, want)
    assert stream_row_slices_cuda.launches - before == (n_items > 0)


# ----------------------- B3, the drain megakernels (BFS, PageRank, coloring)
def _algo_setup(graph, algo, policy, backend="auto", params=None,
                trace=None, queue_capacity=None, init=None, **kw):
    from repro_torch.core import SchedulerConfig
    from repro_torch.runtime import build_program, config_for, parse_policy
    from repro_torch.runtime.api import drain_setup

    base = dict(num_workers=64, fetch_size=2, backend=backend)
    base.update(kw)
    cfg = config_for(SchedulerConfig(**base), parse_policy(policy))
    return drain_setup(build_program(algo, graph, cfg, params=params),
                       graph, cfg, trace=trace,
                       queue_capacity=queue_capacity, init=init)


def _setup(graph, policy, source=0, backend="auto", **kw):
    return _algo_setup(graph, "bfs", policy, backend, {"source": source},
                       **kw)


def _leaves(carry):
    """Every tensor of a drain carry on the host, in tree order."""
    from repro_torch.core.tree import tree_map

    out = []
    tree_map(lambda t: out.append(t.cpu()), carry)
    return out


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("graph", ["rmat(10)", "grid2d(32)"])
@pytest.mark.parametrize("workers", [64, 8192])
def test_bfs_drain_kernel_matches_persistent_and_plain(graph, workers):
    """dist, counters and the final queue against the persistent cell on
    the kernels and, at 64 workers, the plain fused drain.  8192 workers x
    4 puts the wavefront (512 KB) past shared memory, on the global-scratch
    path; there the plain stream's [W, budget] slices would not fit on the
    card."""
    _require_cuda()
    from repro_torch.core import (megakernel_drive, no_host_sync,
                                  persistent_drive)
    from repro_torch.graph import grid2d, rmat
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda

    g = (rmat(10, 16, seed=2, device="cuda") if graph == "rmat(10)"
         else grid2d(32, 32, device="cuda"))
    kw = dict(num_workers=workers, fetch_size=4 if workers > 64 else 2)
    persistent = _setup(g, "single.persistent", **kw)
    want = persistent_drive(persistent.step, persistent.cond,
                            persistent.carry)
    mega = _setup(g, "single.megakernel", **kw)
    before = bfs_drain_cuda.launches
    with no_host_sync(g.device):
        got = megakernel_drive(mega.step, mega.cond, mega.carry,
                               kernel=mega.kernel)
    torch.cuda.synchronize()
    assert bfs_drain_cuda.launches - before == 1
    _assert_same(got, want)
    assert int(got[0].dropped) == 0
    if workers == 64:
        plain = _setup(g, "single.megakernel", backend="torch", **kw)
        assert plain.kernel is None
        _assert_same(got, megakernel_drive(plain.step, plain.cond,
                                           plain.carry))


def test_megakernel_execute_is_one_b3_launch_and_no_b1_b2():
    _require_cuda()
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    g = rmat(10, 16, seed=2, device="cuda")
    results = []
    for policy in ("single.persistent", "single.megakernel"):
        cfg = config_for(SchedulerConfig(num_workers=64, fetch_size=2),
                         parse_policy(policy))
        counts = (bfs_drain_cuda.launches, lbs_cuda.launches,
                  compact_cuda.launches)
        state, stats, info = execute(build_program("bfs", g, cfg), g, cfg)
        launched = [now - was for now, was in zip(
            (bfs_drain_cuda.launches, lbs_cuda.launches,
             compact_cuda.launches), counts)]
        results.append((state.dist.cpu(), [int(x) for x in stats], info))
        if policy == "single.megakernel":
            assert launched == [1, 0, 0] and info["launches"] == 1
        else:
            assert launched[0] == 0 and min(launched[1:]) > 0
    assert torch.equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]
    assert {**results[0][2], "launches": 1} == results[1][2]


@pytest.mark.parametrize("every", [1, 3])
def test_bfs_drain_segments_equal_the_whole_drain(every):
    _require_cuda()
    from repro_torch.core import megakernel_drive, megakernel_segment
    from repro_torch.graph import rmat

    g = rmat(10, 16, seed=2, device="cuda")
    whole = _setup(g, "single.megakernel")
    want = megakernel_drive(whole.step, whole.cond, whole.carry,
                            kernel=whole.kernel)
    cut = _setup(g, "single.megakernel")
    seg = megakernel_segment(cut.step, cut.cond, cut.carry,
                             kernel=cut.kernel)
    carry, limit, segments = cut.carry, 0, 0
    while bool(cut.cond(carry)):
        limit += every
        carry = seg(carry, limit)
        segments += 1
        assert int(carry[2]) == min(limit, int(want[2]))
    assert segments == -(-int(want[2]) // every)
    _assert_same(carry, want)
    cut_rounds = _setup(g, "single.megakernel", max_rounds=5)
    short = megakernel_drive(cut_rounds.step, cut_rounds.cond,
                             cut_rounds.carry, kernel=cut_rounds.kernel)
    assert int(short[2]) == 5


# the megakernel beyond granularity 1: (algo, G, params, config fields)
WIDE_CASES = (
    [(algo, g, {}, {}) for algo in ("bfs", "pagerank", "coloring")
     for g in (2, 3, 8)]
    + [("bfs", g, {"strategy": "per_item"}, {}) for g in (1, 4)]
    # windows that split, and chunks past a tight budget re-queued whole
    + [("bfs", 3, {"work_budget": 128}, {"split_threshold": 8}),
       ("pagerank", 3, {"work_budget": 128}, {"split_threshold": 8}),
       ("coloring", 3, {}, {"split_threshold": 8}),
       ("bfs", 3, {"strategy": "per_item"}, {"split_threshold": 8})])


def _launches():
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    wrappers = (bfs_drain_cuda, _drain_kernel_of("pagerank"),
                _drain_kernel_of("coloring"), lbs_cuda, compact_cuda,
                ordered_scatter_add_cuda)
    return [w.launches for w in wrappers]


@pytest.mark.parametrize("graph", ["rmat(10)", "grid2d(32)"])
@pytest.mark.parametrize("algo,g,params,fields", WIDE_CASES)
def test_wide_megakernel_matches_the_plain_fused_drain(graph, algo, g, params,
                                                       fields):
    """single.megakernel.g<G> (and BFS per_item) on CUDA tensors: one launch
    of the program's drain kernel, no B1, B2 or scatter-add launch, and the
    carry bitwise equal to the plain fused drain over the same step run on
    the CPU (whose PageRank sums in update order), splits and final queue
    included; execute reports one launch."""
    _require_cuda()
    from repro_torch.core import megakernel_drive, no_host_sync
    from repro_torch.graph import grid2d, rmat
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)
    from repro_torch.core import SchedulerConfig

    g_cuda = (rmat(10, 16, seed=2, device="cuda") if graph == "rmat(10)"
              else grid2d(32, 32, device="cuda"))
    policy = "single.megakernel" + ("" if g == 1 else f".g{g}")
    if algo == "bfs":
        params = {"source": 0, **params}
    mega = _algo_setup(g_cuda, algo, policy, params=params, **fields)
    assert mega.kernel is not None
    before = _launches()
    with no_host_sync(g_cuda.device):
        got = megakernel_drive(mega.step, mega.cond, mega.carry,
                               kernel=mega.kernel)
    torch.cuda.synchronize()
    launched = [now - was for now, was in zip(_launches(), before)]
    which = ("bfs", "pagerank", "coloring").index(algo)
    assert launched == [int(i == which) for i in range(6)]
    plain = _algo_setup(g_cuda.to("cpu"), algo, policy, params=params,
                        **fields)
    assert plain.kernel is None
    _assert_same(got, megakernel_drive(plain.step, plain.cond, plain.carry))
    assert int(got[0].dropped) == 0 and int(got[2]) > 1
    cfg = config_for(SchedulerConfig(num_workers=64, fetch_size=2, **fields),
                     parse_policy(policy))
    _, _, info = execute(build_program(algo, g_cuda, cfg, params=params),
                         g_cuda, cfg)
    assert info["launches"] == 1


# B3-fused and B3-traced: (algo, mode, G); the traced ring (100 rows) wraps
# in PageRank's drains and not in BFS's
MODE_CASES = [(algo, mode, g) for algo in ("bfs", "pagerank", "coloring")
              for mode, g in (("fused", 1), ("fused", 2), ("traced", 1),
                              ("traced", 4), ("fused traced", 1))]


@pytest.mark.parametrize("algo,mode,g", MODE_CASES)
def test_drain_kernel_modes_match_the_plain_fused_drain(algo, mode, g):
    """The fused mode (a packed one-lane MultiQueue) and the traced mode (a
    TraceRing as the carry's fifth leaf) of each drain kernel at rmat(11):
    one launch of the program's drain kernel and no other, and the carry
    bitwise equal to the plain fused drain over the same step run on the
    CPU -- the lane's buffer and cursors, the ring's rows and cursor
    included."""
    _require_cuda()
    from repro_torch.core import MultiQueue, megakernel_drive, no_host_sync
    from repro_torch.graph import rmat
    from repro_torch.obs import Trace

    g_cuda = rmat(11, 16, seed=2, device="cuda")
    topology = "fused" if "fused" in mode else "single"
    policy = f"{topology}.megakernel" + ("" if g == 1 else f".g{g}")
    params = {"source": 0} if algo == "bfs" else None

    def trace():
        return Trace(capacity=100) if "traced" in mode else None

    mega = _algo_setup(g_cuda, algo, policy, params=params, trace=trace())
    assert mega.kernel is not None
    assert isinstance(mega.carry[0], MultiQueue) == (topology == "fused")
    before = _launches()
    with no_host_sync(g_cuda.device):
        got = megakernel_drive(mega.step, mega.cond, mega.carry,
                               kernel=mega.kernel)
    torch.cuda.synchronize()
    launched = [now - was for now, was in zip(_launches(), before)]
    which = ("bfs", "pagerank", "coloring").index(algo)
    assert launched == [int(i == which) for i in range(6)]
    assert len(got) == (5 if "traced" in mode else 4)
    plain = _algo_setup(g_cuda.to("cpu"), algo, policy, params=params,
                        trace=trace())
    assert plain.kernel is None
    _assert_same(got, megakernel_drive(plain.step, plain.cond, plain.carry))
    assert int(mega.dropped(got[0])) == 0 and int(got[2]) > 1
    if "traced" in mode:
        assert int(got[4].cursor) == int(got[2])


# B3-slotted: (algo, mode, G) on a streaming graph's slotted view
SLOTTED_CASES = [(algo, mode, g) for algo in ("bfs", "pagerank", "coloring")
                 for mode, g in (("single", 1), ("single", 4), ("fused", 1),
                                 ("traced", 1), ("fused traced", 4))] + [
    ("bfs", "per_item", 1), ("bfs", "per_item", 4)]


def _slotted_view():
    """rmat(11)'s slotted view on the card after two uncompacted batches
    of edge_delta_stream: rows spilled to a non-empty overlay."""
    from repro_torch.graph import SlottedCSR, edge_delta_stream, rmat

    g = rmat(11, 16, seed=2, device="cuda")
    s = SlottedCSR.from_csr(g)
    for d in edge_delta_stream(g, 2, 512, seed=3):
        s.apply(d.src, d.dst, d.insert)
    assert s.overlay_size > 0
    return s.view()


@pytest.mark.parametrize("algo,mode,g", SLOTTED_CASES)
def test_drain_kernel_slotted_mode_matches_the_plain_fused_drain(algo, mode,
                                                                 g):
    """Each drain kernel's slotted mode, alone and with the fused and
    traced modes, on a slotted view with an overlay: one launch of the
    program's drain kernel and no other, the carry bitwise equal to the
    plain fused drain over the same view on the CPU (the two-level gather
    through the overlay)."""
    _require_cuda()
    from repro_torch.core import megakernel_drive, no_host_sync
    from repro_torch.obs import Trace

    view = _slotted_view()
    topology = "fused" if "fused" in mode else "single"
    policy = f"{topology}.megakernel" + ("" if g == 1 else f".g{g}")
    params = {"source": 0} if algo == "bfs" else None
    if mode == "per_item":
        params["strategy"] = "per_item"

    def trace():
        return Trace(capacity=100) if "traced" in mode else None

    mega = _algo_setup(view, algo, policy, params=params, trace=trace())
    assert mega.kernel is not None
    before = _launches()
    with no_host_sync(view.device):
        got = megakernel_drive(mega.step, mega.cond, mega.carry,
                               kernel=mega.kernel)
    torch.cuda.synchronize()
    launched = [now - was for now, was in zip(_launches(), before)]
    which = ("bfs", "pagerank", "coloring").index(algo)
    assert launched == [int(i == which) for i in range(6)]
    plain = _algo_setup(view.to("cpu"), algo, policy, params=params,
                        trace=trace())
    assert plain.kernel is None
    _assert_same(got, megakernel_drive(plain.step, plain.cond, plain.carry))
    assert int(mega.dropped(got[0])) == 0 and int(got[2]) > 1


@pytest.mark.parametrize("g", [1, 4])
def test_stream_kernel_over_a_slab_matches_plain(g):
    """B4 at its slotted shape: slices of SLAB_SLACK * (budget + G) words
    of the slab array from slab_ptr[head], against the plain version."""
    _require_cuda()
    from repro_torch.graph.slotted import SLAB_SLACK
    from repro_torch.kernels.drain_loop.csr_stream import (
        stream_row_slices_cuda, stream_row_slices_ref)

    view = _slotted_view()
    heads = torch.randint(0, view.num_vertices, (48,),
                          generator=torch.Generator().manual_seed(g))
    starts = view.slab_ptr[heads.cuda()].contiguous()
    budget = SLAB_SLACK * (512 + g)
    got = stream_row_slices_cuda(view.slab_col, starts, budget)
    assert torch.equal(got, stream_row_slices_ref(view.slab_col, starts,
                                                  budget))


@pytest.mark.parametrize("algo,policy,params", [
    ("bfs", "single.megakernel", {"source": 0}),
    ("bfs", "fused.megakernel.g2", {"source": 0}),
    ("pagerank", "single.megakernel", None),
    ("coloring", "single.megakernel", {"dirty": "recolor"}),
    ("coloring", "single.megakernel", None)])
def test_stream_megakernel_is_one_launch_a_batch_and_matches_the_cpu(
        algo, policy, params):
    """``stream_execute`` on the card: each batch drain is one launch of the
    program's drain kernel (its slotted mode) and none of B1, B2 or the
    scatter-add (PageRank's reseed launches the float64 scatter-add once
    and once a decay sweep, and nothing else does); the result and the
    batch records equal the same stream on the CPU."""
    _require_cuda()
    import dataclasses

    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import edge_delta_stream, rmat
    from repro_torch.runtime import config_for, parse_policy, stream_execute

    g = rmat(10, 16, seed=4, device="cuda")
    deltas = edge_delta_stream(g, 4, 256, seed=5)
    cfg = config_for(SchedulerConfig(num_workers=64, fetch_size=2),
                     parse_policy(policy))
    before = _launches()
    got = stream_execute(algo, g, deltas, cfg, params=params,
                         compact_every=2)
    launched = [now - was for now, was in zip(_launches(), before)]
    which = ("bfs", "pagerank", "coloring").index(algo)
    reseed_sums = sum(1 + r.reseed_sweeps for r in got.batches[1:]) \
        if algo == "pagerank" else 0
    assert launched == [len(deltas) + 1 if i == which else 0
                        for i in range(5)] + [reseed_sums]
    want = stream_execute(algo, g.to("cpu"), deltas, cfg, params=params,
                          compact_every=2)
    assert torch.equal(got.result.cpu(), want.result)
    timing = ("commit_seconds", "reseed_seconds", "drain_seconds")
    for a, b in zip(got.batches, want.batches):
        a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert {k: v for k, v in a.items() if k not in timing} == \
            {k: v for k, v in b.items() if k not in timing}
    assert any(r.overlay > 0 for r in got.batches)


def test_megakernel_without_a_drain_kernel_raises_on_cuda():
    """A program with no drain kernel raises under single.megakernel on
    CUDA tensors; it never falls back to the plain fused drain."""
    _require_cuda()
    import dataclasses

    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import grid2d
    from repro_torch.runtime import (build_program, config_for, execute,
                                     parse_policy)

    g = grid2d(8, 8, device="cuda")
    cfg = config_for(SchedulerConfig(num_workers=8),
                     parse_policy("single.megakernel.g4"))
    program = dataclasses.replace(build_program("bfs", g, cfg),
                                  make_drain_kernel=None)
    with pytest.raises(NotImplementedError, match="no CUDA drain kernel"):
        execute(program, g, cfg)


# ------------------- the ordered scatter-add, B3-pr and B3-col (PageRank,
# coloring)
def _cpu_sequential_sum(base, index, values):
    """The CPU's left-to-right sum (``index_add_`` on CPU tensors)."""
    return base.cpu().clone().index_add_(0, index.cpu().long(),
                                         values.cpu())


def _scatter_inputs(case):
    rng = np.random.default_rng(len(case))
    if case == "one index 1e5 times, mixed magnitudes":
        n, k = 1000, 100_000
        index = np.full(k, 17)
        index[::7] = rng.integers(0, n, size=len(index[::7]))
        values = rng.standard_normal(k) * 10.0 ** rng.integers(-8, 8, size=k)
    elif case == "PageRank round shape":
        n, k = 1 << 16, 50_000
        index = rng.integers(0, n, size=k)
        index[rng.random(k) < 0.1] = 3             # a hub
        values = rng.random(k) * 1e-3
        values[-5000:] = 0.0                       # idle lanes add +0.0
        index[-5000:] = np.arange(5000) % n
    else:
        n, k = 7, 1
        index = np.array([6])
        values = np.array([0.5])
    base = torch.from_numpy(rng.random(n).astype(np.float32))
    return (base, torch.from_numpy(index.astype(np.int32)),
            torch.from_numpy(values.astype(np.float32)))


@pytest.mark.parametrize("case", ["one index 1e5 times, mixed magnitudes",
                                  "PageRank round shape", "one update"])
def test_ordered_scatter_add_matches_the_cpu_sum_bitwise(case):
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)
    from repro_torch.kernels.scatter_add.ref import ordered_scatter_add_ref

    base, index, values = _scatter_inputs(case)
    want = _cpu_sequential_sum(base, index, values)
    before = ordered_scatter_add_cuda.launches
    got = ordered_scatter_add_cuda(base.cuda(), index.cuda(), values.cuda())
    assert ordered_scatter_add_cuda.launches == before + 1
    assert torch.equal(got.cpu(), want)
    # the plain version on CUDA tensors (deterministic index_put_) sums in
    # another order: the same on every run, equal within float rounding
    plain = ordered_scatter_add_ref(base.cuda(), index.cuda(), values.cuda())
    assert torch.equal(plain, ordered_scatter_add_ref(
        base.cuda(), index.cuda(), values.cuda()))
    scale = float(values.abs().sum()) + float(base.abs().max())
    assert float((plain.cpu() - want).abs().max()) <= 1e-6 * scale
    assert not torch.are_deterministic_algorithms_enabled()


@pytest.mark.parametrize("case", ["one index 1e5 times, mixed magnitudes",
                                  "PageRank round shape"])
def test_ordered_scatter_add_f64_matches_numpy_bincount(case):
    """The float64 instance from zeros: numpy's ``bincount(index,
    weights)``, each slot's terms added left to right (the streaming
    PageRank rule's sums), bit for bit."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    base, index, values = _scatter_inputs(case)
    values = values.double() * 1.000000119
    want = np.bincount(index.numpy(), weights=values.numpy(),
                       minlength=base.shape[0])
    got = ordered_scatter_add_cuda(
        torch.zeros(base.shape[0], dtype=torch.float64, device="cuda"),
        index.cuda(), values.cuda())
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _sequential(base, index, values):
    """numpy's unbuffered ``add.at``: each update in turn, in the array's
    own precision."""
    out = base.copy()
    np.add.at(out, index, values)
    return out


def _segment_inputs(length, dtype, seed):
    """A slot (17) whose segment has ``length`` updates, interleaved at
    random with updates to 999 other slots, at mixed magnitudes."""
    rng = np.random.default_rng(seed)
    n, k = 1000, 2 * length + 100
    index = rng.integers(0, n, size=k)
    index[index == 17] = 18
    index[rng.choice(k, size=length, replace=False)] = 17
    values = rng.standard_normal(k) * 10.0 ** rng.integers(-8, 8, size=k)
    base = rng.random(n)
    return (base.astype(dtype), index.astype(np.int32), values.astype(dtype))


@pytest.mark.parametrize("length", [1, 2, 8, 9, 64, 65, 2048, 2049, 100_000])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_scatter_add_at_every_tier_edge(length, dtype):
    """Segment lengths at each edge of the thread (8), warp (64), block
    (2048) and merge tiers, bit for bit against the sequential sum."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    base, index, values = _segment_inputs(length, dtype, length)
    got = ordered_scatter_add_cuda(*(torch.from_numpy(x).cuda() for x in (
        base, index, values)))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _sequential(base, index, values))


def test_ordered_scatter_add_base_off_the_16_byte_grid():
    """A base that is a view 4 bytes into its storage is copied a value a
    thread, not 16 bytes at a time."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    base, index, values = _segment_inputs(65, np.float32, 1)
    whole = torch.from_numpy(np.concatenate([[7.0], base]).astype(
        np.float32)).cuda()
    got = ordered_scatter_add_cuda(whole[1:], torch.from_numpy(index).cuda(),
                                   torch.from_numpy(values).cuda())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _sequential(base, index, values))


def test_ordered_scatter_add_many_segments_past_a_block():
    """3,000 segments of 2,049 to 2,400 updates each in one call, shuffled:
    each goes through the merge tier, which must not read the whole call
    per segment."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    rng = np.random.default_rng(3)
    lengths = rng.integers(2049, 2401, size=3000)
    index = rng.permutation(np.repeat(np.arange(3000) * 7, lengths))
    values = (rng.standard_normal(index.size)
              * 10.0 ** rng.integers(-6, 6, size=index.size))
    base = rng.random(21_000).astype(np.float32)
    index, values = index.astype(np.int32), values.astype(np.float32)
    # numpy's add.at, not the CPU's index_add_: at millions of updates
    # index_add_ splits the work over threads and is no longer in order
    got = ordered_scatter_add_cuda(*(torch.from_numpy(x).cuda() for x in (
        base, index, values)))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _sequential(base, index, values))


def test_ordered_scatter_add_f64_at_k_equals_m_of_rmat16():
    """The streaming reseed's sum at rmat(16): the float64 instance over
    every edge (col_idx as the index) from zeros, against numpy's
    bincount."""
    _require_cuda()
    from repro_torch.graph import rmat
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    g = rmat(16, edge_factor=16, seed=1, device="cuda")
    col = g.col_idx.cpu().numpy()
    w = np.random.default_rng(4).random(col.size) * 1e-3
    want = np.bincount(col, weights=w, minlength=g.num_vertices)
    got = ordered_scatter_add_cuda(
        torch.zeros(g.num_vertices, dtype=torch.float64, device="cuda"),
        g.col_idx, torch.from_numpy(w).cuda())
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _held_scratch():
    from repro_torch.kernels.scatter_add import kernel

    return kernel._SCRATCH[(torch.cuda.current_device(),
                            torch.cuda.current_stream().cuda_stream)]


def test_ordered_scatter_add_scratch_is_clean_across_calls():
    """Calls one after another as n and k grow: every result bitwise, and
    the per-slot counts (and the words before them) zero after each."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    for i, (n, length) in enumerate([(1000, 70), (1000, 70), (5000, 3000),
                                     (5000, 9), (70_000, 2100)]):
        base, index, values = _segment_inputs(length, np.float32, i)
        base = np.resize(base, n)
        index = np.where(index % 3 == 0, index * 7 % n, index)
        got = ordered_scatter_add_cuda(*(torch.from_numpy(x).cuda() for x in (
            base, index.astype(np.int32), values)))
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      _sequential(base, index, values))
        counts, _ = _held_scratch()
        assert int(counts.abs().sum()) == 0


def test_ordered_scatter_add_on_two_streams():
    """Calls alternating on two streams with no wait between them: each
    stream has scratch of its own, so each result is bitwise."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    inputs = [_segment_inputs(length, np.float64, length)
              for length in (3000, 65)]
    want = [_sequential(*x) for x in inputs]
    on_card = [tuple(torch.from_numpy(x).cuda() for x in xs) for xs in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(4):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                got[i].append(ordered_scatter_add_cuda(*on_card[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for out in got[i]:
            np.testing.assert_array_equal(out.cpu().numpy(), want[i])


def test_ordered_scatter_add_sorts_nothing_and_launches_four_kernels():
    """No library sort and no separate copy: each call is the kernel's four
    launches."""
    _require_cuda()
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    base, index, values = (torch.from_numpy(x).cuda() for x in
                           _segment_inputs(3000, np.float32, 9))
    ops = _device_ops(lambda: ordered_scatter_add_cuda(base, index, values),
                      5)
    assert not any("sort" in name.lower() or "copy" in name.lower()
                   or "memcpy" in name.lower() for name in ops), ops
    assert sum(ops.values()) <= 4 * 5, ops


def _drain_kernel_of(algo):
    if algo == "pagerank":
        from repro_torch.kernels.drain_loop.pagerank_drain import (
            pagerank_drain_cuda as kernel)
    else:
        from repro_torch.kernels.drain_loop.coloring_drain import (
            coloring_drain_cuda as kernel)
    return kernel


@pytest.mark.parametrize("algo", ["pagerank", "coloring"])
@pytest.mark.parametrize("graph", ["rmat(10)", "grid2d(32)"])
@pytest.mark.parametrize("workers", [64, 8192])
def test_drain_kernel_matches_persistent_plain_and_cpu(algo, graph, workers):
    """The drain, counters and final queue against the persistent cell on
    the kernels and, at 64 workers, against the plain fused drain on the
    card and the persistent drain on the CPU.  8192 workers x 4 put the
    wavefront past shared memory, on the global-scratch path."""
    _require_cuda()
    from repro_torch.core import (megakernel_drive, no_host_sync,
                                  persistent_drive)
    from repro_torch.graph import grid2d, rmat

    g = (rmat(10, 16, seed=2, device="cuda") if graph == "rmat(10)"
         else grid2d(32, 32, device="cuda"))
    kw = dict(num_workers=workers, fetch_size=4 if workers > 64 else 2)
    persistent = _algo_setup(g, algo, "single.persistent", **kw)
    want = persistent_drive(persistent.step, persistent.cond,
                            persistent.carry)
    mega = _algo_setup(g, algo, "single.megakernel", **kw)
    kernel = _drain_kernel_of(algo)
    before = kernel.launches
    with no_host_sync(g.device):
        got = megakernel_drive(mega.step, mega.cond, mega.carry,
                               kernel=mega.kernel)
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    _assert_same(got, want)
    assert int(got[0].dropped) == 0 and int(got[2]) > 1
    if algo == "coloring":
        from repro_torch.algorithms.coloring import validate_coloring

        assert validate_coloring(g, got[1].colors)
    else:
        assert float(got[1].residue.max()) <= 1e-6
    if workers == 64:
        plain = _algo_setup(g, algo, "single.megakernel", backend="torch",
                            **kw)
        assert plain.kernel is None
        want_plain = megakernel_drive(plain.step, plain.cond, plain.carry)
        if algo == "coloring":
            _assert_same(got, want_plain)
        else:
            # the plain scatter-add on CUDA tensors sums in another order
            # (kernels/scatter_add/ref.py): the eps contract
            assert float(want_plain[1].residue.max()) <= 1e-6
            assert float((want_plain[1].rank - got[1].rank).abs().max()) \
                < 1e-3
        cpu = g.to("cpu")
        host = _algo_setup(cpu, algo, "single.persistent", **kw)
        _assert_same(got, persistent_drive(host.step, host.cond,
                                                  host.carry))


@pytest.mark.parametrize("algo", ["pagerank", "coloring"])
@pytest.mark.parametrize("every", [1, 3])
def test_drain_kernel_segments_equal_the_whole_drain(algo, every):
    _require_cuda()
    from repro_torch.core import megakernel_drive, megakernel_segment
    from repro_torch.graph import rmat

    g = rmat(9, 16, seed=2, device="cuda")
    whole = _algo_setup(g, algo, "single.megakernel")
    want = megakernel_drive(whole.step, whole.cond, whole.carry,
                            kernel=whole.kernel)
    cut = _algo_setup(g, algo, "single.megakernel")
    seg = megakernel_segment(cut.step, cut.cond, cut.carry,
                             kernel=cut.kernel)
    carry, limit, segments = cut.carry, 0, 0
    while bool(cut.cond(carry)):
        limit += every
        carry = seg(carry, limit)
        segments += 1
        assert int(carry[2]) == min(limit, int(want[2]))
    assert segments == -(-int(want[2]) // every)
    _assert_same(carry, want)
    short = _algo_setup(g, algo, "single.megakernel", max_rounds=5)
    cut5 = megakernel_drive(short.step, short.cond, short.carry,
                            kernel=short.kernel)
    assert int(cut5[2]) == 5


# B3-pr's ordered sum on a hub-heavy graph: a round's segments reach every
# tier (one thread, one warp, one block's sort, the block's pass in unit
# order past 2048 entries); (mode, G)
HUB_CASES = [(mode, g) for mode in ("single", "fused", "traced", "slotted")
             for g in (1, 4)]
HUB_CUT = 4                        # rounds held against the plain drain


def _hub_graph(device):
    """16,384 vertices: vertex 0 adjacent to all others, vertices 1..8 to
    100..1500 random others, 9..200 to 10..150, plus 4,096 random edges;
    symmetric.  With W = 2560 a round past the first gives vertex 0 more
    contributions than a block's sort holds (2048)."""
    from repro_torch.graph.csr import from_edges

    rng = np.random.default_rng(11)
    n = 16384
    src = [np.zeros(n - 1, dtype=np.int64)]
    dst = [np.arange(1, n, dtype=np.int64)]
    for h in range(1, 201):
        deg = 100 + 175 * h if h <= 8 else 10 + (h * 7) % 141
        src.append(np.full(deg, h))
        dst.append(rng.integers(201, n, size=deg))
    src.append(rng.integers(1, n, size=4096))
    dst.append(rng.integers(1, n, size=4096))
    return from_edges(n, np.concatenate(src), np.concatenate(dst),
                      symmetrize=True, device=device)


@pytest.mark.parametrize("mode,g", HUB_CASES)
def test_pagerank_drain_ordered_sum_on_a_hub_matches_persistent_and_plain(
        mode, g):
    """B3-pr in each mode at G = 1 and 4 on a hub whose segment outgrows a
    block's shared-memory sort: one launch, the whole drain bitwise equal
    to the persistent drain on the card (B1, B2, the ordered scatter-add)
    and on the CPU, and its first rounds to the plain fused drain on the
    CPU."""
    _require_cuda()
    from repro_torch.core import megakernel_drive, persistent_drive
    from repro_torch.graph import SlottedCSR
    from repro_torch.obs import Trace

    g_cuda = _hub_graph("cuda")
    if mode == "slotted":
        g_cuda = SlottedCSR.from_csr(g_cuda).view()
    topology = "fused" if mode == "fused" else "single"
    suffix = "" if g == 1 else f".g{g}"
    params = {"work_budget": 16384}
    kw = dict(num_workers=640, fetch_size=4)

    def trace():
        return Trace(capacity=64) if mode == "traced" else None

    def setup(graph, kernel, **more):
        cell = f"{topology}.{kernel}{suffix}"
        return _algo_setup(graph, "pagerank", cell, params=params,
                           trace=trace(), **kw, **more)

    mega = setup(g_cuda, "megakernel")
    before = _launches()
    got = megakernel_drive(mega.step, mega.cond, mega.carry,
                           kernel=mega.kernel)
    torch.cuda.synchronize()
    assert [now - was for now, was in zip(_launches(), before)] == \
        [0, 1, 0, 0, 0, 0]
    assert float(got[1].residue.max()) <= 1e-6
    assert int(mega.dropped(got[0])) == 0
    persistent = setup(g_cuda, "persistent")
    _assert_same(got, persistent_drive(persistent.step, persistent.cond,
                                       persistent.carry))
    host = setup(g_cuda.to("cpu"), "persistent")
    _assert_same(got, persistent_drive(host.step, host.cond, host.carry))
    cut = setup(g_cuda, "megakernel", max_rounds=HUB_CUT)
    first = megakernel_drive(cut.step, cut.cond, cut.carry,
                             kernel=cut.kernel)
    plain = setup(g_cuda.to("cpu"), "megakernel", max_rounds=HUB_CUT)
    assert plain.kernel is None
    _assert_same(first, megakernel_drive(plain.step, plain.cond,
                                         plain.carry))


# B3-col's load-balanced visits on hubs: (graph, mode, G)
COLOR_HUB_CASES = ([("star", "single", g) for g in (1, 2, 4, 64)]
                   + [("star", "fused", 1), ("star", "traced", 4),
                      ("star", "slotted", 1), ("hubs", "single", 1),
                      ("hubs", "single", 4), ("hubs", "fused", 2),
                      ("hubs", "traced", 1), ("hubs", "slotted", 4)])


def _coloring_hub_graph(kind, device):
    """``star``: vertex 0 adjacent to all 2^17 others.  ``hubs``: 32,768
    vertices, of which 0..7 are adjacent to 4,000 .. 25,000 random others
    each (all eight in the first wavefront), plus 30,000 random edges;
    symmetric."""
    from repro_torch.graph.csr import from_edges

    if kind == "star":
        n = 2 ** 17 + 1
        return from_edges(n, np.zeros(n - 1, np.int64),
                          np.arange(1, n, dtype=np.int64), symmetrize=True,
                          device=device)
    rng = np.random.default_rng(12)
    n = 32768
    src = [np.full(4000 + 3000 * h, h) for h in range(8)]
    dst = [rng.integers(8, n, size=4000 + 3000 * h) for h in range(8)]
    src.append(rng.integers(8, n, size=30000))
    dst.append(rng.integers(8, n, size=30000))
    return from_edges(n, np.concatenate(src), np.concatenate(dst),
                      symmetrize=True, device=device)


def _coloring_scratch_is_zero(stream=None):
    """Whether B3-col's marks and bitsets of ``stream`` (the current one by
    default) are all zero."""
    from repro_torch.kernels.drain_loop.coloring_drain import _SCRATCH

    stream = stream or torch.cuda.current_stream()
    bad, bits = _SCRATCH[(torch.cuda.current_device(), stream.cuda_stream)]
    return not bad.any() and not bits.any()


def _coloring_hub_setup(graph, mode, g, kernel, **more):
    from repro_torch.obs import Trace

    topology = "fused" if mode == "fused" else "single"
    suffix = "" if g == 1 else f".g{g}"
    return _algo_setup(graph, "coloring", f"{topology}.{kernel}{suffix}",
                       trace=Trace(capacity=64) if mode == "traced" else None,
                       num_workers=1024, fetch_size=4, **more)


@pytest.mark.parametrize("graph,mode,g", COLOR_HUB_CASES)
def test_coloring_drain_on_hubs_matches_persistent_and_plain(graph, mode, g):
    """B3-col where a row is far longer than a warp's or a block's share of
    a round's visits (a hub of degree 2^17; eight hubs in one wavefront), in
    each mode, at G = 1, 2, 4 and 64 (whose wavefront lives in global
    scratch): one launch, the whole drain bitwise equal to the persistent
    drain on the card (B1, B2) and to the plain fused drain on the CPU,
    ring rows in the traced mode, the final queue included; the marks and
    bitsets back at zero after it."""
    _require_cuda()
    from repro_torch.core import megakernel_drive, persistent_drive
    from repro_torch.graph import SlottedCSR

    g_cuda = _coloring_hub_graph(graph, "cuda")
    if mode == "slotted":
        g_cuda = SlottedCSR.from_csr(g_cuda).view()
    mega = _coloring_hub_setup(g_cuda, mode, g, "megakernel")
    before = _launches()
    got = megakernel_drive(mega.step, mega.cond, mega.carry,
                           kernel=mega.kernel)
    torch.cuda.synchronize()
    assert [now - was for now, was in zip(_launches(), before)] == \
        [0, 0, 1, 0, 0, 0]
    assert int(mega.dropped(got[0])) == 0 and int(got[2]) > 2
    assert _coloring_scratch_is_zero()
    persistent = _coloring_hub_setup(g_cuda, mode, g, "persistent")
    _assert_same(got, persistent_drive(persistent.step, persistent.cond,
                                       persistent.carry))
    plain = _coloring_hub_setup(g_cuda.to("cpu"), mode, g, "megakernel")
    assert plain.kernel is None
    _assert_same(got, megakernel_drive(plain.step, plain.cond, plain.carry))


def test_coloring_drains_on_two_streams_leave_their_scratch_zero():
    """Two drains issued on two streams with no wait between them, each
    with its own marks and bitsets, equal to the drain on the default
    stream; every stream's scratch zero after."""
    _require_cuda()
    from repro_torch.core import megakernel_drive

    g_cuda = _coloring_hub_graph("hubs", "cuda")
    want = _coloring_hub_setup(g_cuda, "single", 1, "megakernel")
    want = megakernel_drive(want.step, want.cond, want.carry,
                            kernel=want.kernel)
    setups = [_coloring_hub_setup(g_cuda, "single", 1, "megakernel")
              for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = []
    for setup, stream in zip(setups, streams):
        with torch.cuda.stream(stream):
            got.append(megakernel_drive(setup.step, setup.cond, setup.carry,
                                        kernel=setup.kernel))
    torch.cuda.synchronize()
    for carry in got:
        _assert_same(carry, want)
    assert all(_coloring_scratch_is_zero(s) for s in streams)
    assert _coloring_scratch_is_zero()



# B3-BFS where its design bends: (case, mode, G).  "rmat": rmat(12) (the
# slotted mode: rmat(11)'s slotted view) at W = 128; "backlog": 586 sources
# queued at launch, more than W; "resumed": the same drain cut every two
# rounds, tasks waiting at each cut; "drop": a ring of 48 slots at W = 32;
# "hub": a root, eight hubs of 100,000 edges each (onto 512 targets,
# duplicates kept) at W = 16 and a budget of 2^20, so the hub round's
# 800,000 units take two tiles a block; "hub_budget": the same at a budget
# of one hub's degree, which the first hub fills; "global": W = 16,384,
# whose wavefront lives in global scratch, at a budget of rmat(12)'s max
# degree
BFS_CASES = (
    [("rmat", mode, g) for g in (1, 2, 4, 64)
     for mode in ("single", "fused", "traced", "slotted", "per_item")]
    + [(case, "single", g) for case in ("backlog", "resumed", "drop", "hub",
                                        "hub_budget", "global")
       for g in (1, 4)]
    + [("backlog", "fused", 2), ("resumed", "traced", 1),
       ("drop", "per_item", 1), ("hub", "per_item", 1),
       ("hub_budget", "traced", 4), ("global", "per_item", 1)])


def _bfs_hub_graph(device):
    from repro_torch.graph.csr import CSRGraph

    rng = np.random.default_rng(21)
    hubs, width, targets = 8, 100_000, 512
    n = 1 + hubs + targets
    rows = ([np.arange(1, hubs + 1)]
            + [np.sort(rng.integers(hubs + 1, n, size=width))
               for _ in range(hubs)]
            + [np.zeros(1, np.int64)] * targets)
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return CSRGraph(
        row_ptr=torch.as_tensor(row_ptr.astype(np.int32), device=device),
        col_idx=torch.as_tensor(np.concatenate(rows).astype(np.int32),
                                device=device))


def _bfs_case_graph(case, mode):
    from repro_torch.graph import rmat

    if mode == "slotted":
        return _slotted_view()
    if case.startswith("hub"):
        return _bfs_hub_graph("cuda")
    return rmat(12, 16, seed=2, device="cuda")


def _bfs_case_setup(graph, case, mode, g, kernel):
    from repro_torch.algorithms.bfs import INF, BFSState
    from repro_torch.core import ChunkCodec, WorkCounter, chunk_seeds
    from repro_torch.obs import Trace

    topology = "fused" if mode == "fused" else "single"
    policy = f"{topology}.{kernel}" + ("" if g == 1 else f".g{g}")
    params = {"source": 0}
    if mode == "per_item":
        params["strategy"] = "per_item"
    workers = {"drop": (16, 2), "hub": (8, 2), "hub_budget": (8, 2),
               "global": (4096, 4)}.get(case, (64, 2))
    if case == "hub":
        params["work_budget"] = 2 ** 20
    elif case == "hub_budget":
        params["work_budget"] = 100_000
    elif case == "global":
        params["work_budget"] = int(graph.degrees().max())
    init = None
    if case in ("backlog", "resumed"):
        n = graph.num_vertices
        sources = np.arange(0, n, 7)
        dist = torch.full((n,), INF, dtype=torch.int32, device=graph.device)
        dist[torch.as_tensor(sources, device=graph.device)] = 0
        init = (BFSState(dist=dist, counter=WorkCounter.zero(graph.device)),
                chunk_seeds(sources, ChunkCodec(g), graph.row_ptr))
    return _algo_setup(graph, "bfs", policy, params=params,
                       trace=Trace(capacity=64) if mode == "traced" else None,
                       num_workers=workers[0], fetch_size=workers[1],
                       queue_capacity=48 if case == "drop" else None,
                       init=init)


@pytest.mark.parametrize("case,mode,g", BFS_CASES)
def test_bfs_drain_where_its_design_bends_matches_persistent_and_plain(
        case, mode, g):
    """B3-BFS on each case above, in each mode, at G = 1, 2, 4 and 64 and
    per_item: one launch a segment and no other kernel, the carry bitwise
    equal to the persistent drain on the card (B1, B2) and to the plain
    fused drain on the CPU -- the ring, dist, the cursors, the counters
    with splits and dropped, trace rows."""
    _require_cuda()
    from repro_torch.core import (megakernel_drive, megakernel_segment,
                                  persistent_drive)

    graph = _bfs_case_graph(case, mode)
    mega = _bfs_case_setup(graph, case, mode, g, "megakernel")
    assert mega.kernel is not None
    before = _launches()
    if case == "resumed":
        seg = megakernel_segment(mega.step, mega.cond, mega.carry,
                                 kernel=mega.kernel)
        got, limit, launches, waited = mega.carry, 0, 0, 0
        while bool(mega.cond(got)):
            limit += 2
            got = seg(got, limit)
            launches += 1
            waited += int(mega.ops.size(got[0])) > 128
        assert waited > 0
    else:
        got = megakernel_drive(mega.step, mega.cond, mega.carry,
                               kernel=mega.kernel)
        launches = 1
    torch.cuda.synchronize()
    assert [now - was for now, was in zip(_launches(), before)] == \
        [launches, 0, 0, 0, 0, 0]
    assert int(got[2]) > 2
    assert (int(mega.dropped(got[0])) > 0) == (case == "drop")
    persistent = _bfs_case_setup(graph, case, mode, g, "persistent")
    _assert_same(got, persistent_drive(persistent.step, persistent.cond,
                                       persistent.carry))
    plain = _bfs_case_setup(graph.to("cpu"), case, mode, g, "megakernel")
    assert plain.kernel is None
    _assert_same(got, megakernel_drive(plain.step, plain.cond, plain.carry))


@pytest.mark.parametrize("grid", ["full", "one"])
@pytest.mark.parametrize("instance", ["spin", "grid_sync"])
def test_grid_barrier_lets_no_block_through_early(instance, grid):
    """10^5 rounds of the drain kernels' grid barrier (and of cooperative
    groups' grid sync) over the co-resident grid of 512-thread blocks and
    over one block: every block adds to the round's word before the
    barrier and reads the grid's size there after it, and every thread
    makes a plain store of the round before it that a thread of another
    block reads after it (with __ldcg), or the launch traps."""
    _require_cuda()
    from repro_torch.kernels.drain_loop.grid_barrier import (
        barrier_grid, grid_barrier_cuda)

    most, sms = barrier_grid(instance)
    assert most >= sms >= 1
    grid_barrier_cuda(10 ** 5, most if grid == "full" else 1, instance)
    torch.cuda.synchronize()


# ------------------------------------------------ B5, flash attention
# (bh, bkv, s_q, s_kv, d, causal, window): the JAX tests' f32 shapes, the
# head dims 64 / 120 / 128 / 256, a window, and Sq > Skv + window, whose
# rows 191..255 have no live key and must give the mean of v
FLASH_CASES = [
    (2, 2, 128, 128, 128, True, 0), (2, 2, 128, 128, 128, False, 0),
    (4, 2, 256, 256, 128, True, 0), (4, 2, 256, 256, 128, False, 0),
    (4, 1, 256, 256, 256, True, 0), (4, 1, 256, 256, 256, False, 0),
    (4, 2, 256, 256, 64, True, 0), (8, 2, 384, 384, 120, True, 128),
    (4, 2, 256, 256, 128, True, 64), (4, 4, 512, 512, 64, False, 64),
    (2, 1, 256, 128, 64, True, 64), (2, 1, 384, 128, 120, False, 64),
]


def _flash_inputs(seed, bh, bkv, s_q, s_kv, d, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((bh, s_q, d), (bkv, s_kv, d), (bkv, s_kv, d))]


@pytest.mark.parametrize("bh,bkv,s_q,s_kv,d,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_f32(bh, bkv, s_q, s_kv, d,
                                                  causal, window):
    """f32 within 2e-5, the JAX tests' tolerance for the Pallas kernel."""
    _require_cuda()
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _flash_inputs(d + s_q, bh, bkv, s_q, s_kv, d, torch.float32)
    before = flash_attention_cuda.launches
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    if window and s_q > s_kv + window:
        dead = s_kv + window - 1
        mean_v = v.mean(dim=1).repeat_interleave(bh // bkv, dim=0)
        torch.testing.assert_close(out[:, dead:], mean_v[:, None].expand(
            -1, s_q - dead, -1), atol=1e-5, rtol=0)


@pytest.mark.parametrize("d,window", [(128, 0), (120, 256), (64, 0)])
def test_flash_attention_kernel_bf16_within_one_step(d, window):
    """bf16: kernel and plain version both round f32 math once; they may
    differ by one bf16 step (plus 1e-6 near zero) on a few elements."""
    _require_cuda()
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = _flash_inputs(d, 8, 2, 1024, 1024, d, torch.bfloat16)
    out = flash_attention_cuda(q, k, v, causal=True, window=window).float()
    want = attention_ref(q, k, v, causal=True, window=window).float()
    mag = torch.maximum(out.abs(), want.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    off = (out - want).abs()
    assert bool((off <= step + 1e-6).all()), float((off - step).max())
    assert float((off > 0).float().mean()) <= 1e-2


def _bf16_excess(got, want):
    """How far each element lies beyond one bf16 step at the larger
    magnitude (<= 0 within one step), as chip_smoke.check_flash holds."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    return (got - want).abs() - torch.exp2(torch.floor(torch.log2(mag)) - 7)


# (bh, bkv, s_q, s_kv, d, causal, window): the tensor-core kernel's head
# dims, windows, Sq != Skv, and rows with no live key (Sq > Skv + window)
TC_CASES = [
    (4, 2, 512, 512, 64, True, 0), (4, 2, 512, 512, 120, True, 128),
    (4, 2, 512, 512, 128, False, 0), (4, 2, 256, 512, 128, True, 0),
    (4, 1, 512, 256, 128, False, 64), (4, 2, 512, 512, 256, True, 0),
    (4, 2, 512, 512, 256, False, 128), (2, 1, 384, 128, 120, True, 64),
    (2, 1, 384, 128, 256, True, 64), (4, 4, 1024, 1024, 192, True, 256),
]


@pytest.mark.parametrize("bh,bkv,s_q,s_kv,d,causal,window", TC_CASES)
def test_flash_attention_tensor_core_bf16_within_one_step(
        bh, bkv, s_q, s_kv, d, causal, window):
    """bf16 with D % 8 == 0 runs the wgmma + TMA kernel: every element
    within one bf16 step of attention_ref (excess <= 1e-6), rows with no
    live key equal to mean(v)."""
    _require_cuda()
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, tile_plan)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    assert tile_plan(d, torch.bfloat16).instance == "tensor_core"
    q, k, v = _flash_inputs(d + s_q + s_kv, bh, bkv, s_q, s_kv, d,
                            torch.bfloat16)
    before = dict(flash_attention_cuda.instance_launches)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention_cuda.instance_launches == {
        "tensor_core": before["tensor_core"] + 1,
        "cuda_core": before["cuda_core"]}
    want = attention_ref(q, k, v, causal=causal, window=window)
    assert float(_bf16_excess(out, want).max()) <= 1e-6
    dead = s_kv + window - 1 if window else s_q
    if dead < s_q:
        mean_v = v.float().mean(dim=1).repeat_interleave(bh // bkv, dim=0)
        assert float((out[:, dead:].float() - mean_v[:, None]).abs().max()) \
            <= 2 ** -7


@pytest.mark.parametrize("d", [36, 100])
def test_flash_attention_bf16_head_dim_off_the_tma_grid_runs_cuda_cores(d):
    """bf16 rows that are not a multiple of 16 bytes (D % 8 != 0) run the
    CUDA-core kernel, by the tile plan, within one bf16 step."""
    _require_cuda()
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, tile_plan)
    from repro_torch.kernels.flash_attention.ref import attention_ref

    assert tile_plan(d, torch.bfloat16).instance == "cuda_core"
    q, k, v = _flash_inputs(d, 4, 2, 256, 256, d, torch.bfloat16)
    before = dict(flash_attention_cuda.instance_launches)
    out = flash_attention_cuda(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    assert flash_attention_cuda.instance_launches["cuda_core"] == \
        before["cuda_core"] + 1
    want = attention_ref(q, k, v, causal=True, window=0)
    assert float(_bf16_excess(out, want).max()) <= 1e-6


def test_flash_attention_copies_an_unaligned_input_for_tma():
    """A bf16 view 2 bytes past an aligned address goes through the
    tensor-core kernel (copied first) and equals the aligned input's run."""
    _require_cuda()
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)

    q, k, v = _flash_inputs(7, 2, 1, 128, 128, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view_as(q)
    shifted.copy_(q)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(flash_attention_cuda(shifted, k, v),
                       flash_attention_cuda(q, k, v))


def test_flash_attention_through_the_model_layout():
    """multihead_attention(impl="auto") on CUDA tensors launches B5 once
    and equals the plain einsum attention of the model layer."""
    _require_cuda()
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ops import multihead_attention
    from repro_torch.models.layers import _sdpa_xla

    g = torch.Generator(device="cuda").manual_seed(5)
    q = torch.randn(1, 256, 6, 128, generator=g, device="cuda")
    k = torch.randn(1, 256, 2, 128, generator=g, device="cuda")
    v = torch.randn(1, 256, 2, 128, generator=g, device="cuda")
    before = flash_attention_cuda.launches
    out = multihead_attention(q, k, v, causal=True, window=0, impl="auto")
    assert flash_attention_cuda.launches == before + 1
    torch.testing.assert_close(out, _sdpa_xla(q, k, v, causal=True, window=0),
                               atol=2e-5, rtol=2e-5)


def test_lm_prefill_goes_through_b5_and_matches_the_plain_path():
    """Smoke minitron-4b in f32 on the card: prefill with attn_impl auto
    launches B5 once per layer and equals the plain einsum path; decode
    steps through the cache equal the prefill's logits."""
    _require_cuda()
    from repro_torch.configs import smoke_config
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_config("minitron-4b")
    params = init_params(T.model_spec(cfg), 0, torch.float32)
    g = torch.Generator(device="cuda").manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=g,
                         device="cuda")
    before = flash_attention_cuda.launches
    got = T.prefill(params, cfg, {"tokens": toks}, 128)
    assert flash_attention_cuda.launches == before + cfg.num_layers
    want = T.prefill(params, cfg, {"tokens": toks}, 128, attn_impl="torch")
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    cache = T.init_cache(cfg, 2, 8, torch.float32)
    for t in range(8):
        logits, cache = T.decode_step(params, cfg, cache, toks[:, t:t + 1])
        torch.testing.assert_close(logits, want[:, t], atol=1e-4, rtol=0)


# ------------------------------------------------- the task server (A11)
SERVER_MIX = [("bfs", "grid", {"source": 0}, 1.0),
              ("bfs", "rmat", {"source": 3}, 1.0),
              ("pagerank", "grid", {"eps": 1e-6}, 1.0),
              ("coloring", "rmat", {}, 1.0),
              ("bfs", "grid", {"source": 17}, 2.0),
              ("coloring", "grid", {}, 1.0),
              ("pagerank", "rmat", {"eps": 1e-6}, 1.0),
              ("bfs", "rmat", {"source": 9}, 1.0)]
#: B1 launches of one lane step of each program's body
B1_PER_STEP = {"bfs": 1, "pagerank": 1, "coloring": 3}


def _serve_mix(device, policy, g, trace=None):
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import grid2d, rmat
    from repro_torch.server import JobRegistry, JobSpec, TaskServer

    reg = JobRegistry()
    reg.register_graph("rmat", rmat(9, edge_factor=8, seed=1, device=device))
    reg.register_graph("grid", grid2d(24, 24, device=device))
    server = TaskServer(reg, num_lanes=8, policy=policy, trace=trace,
                        device=device, config=SchedulerConfig(
                            num_workers=64, fetch_size=2, granularity=g))
    for a, gname, params, w in SERVER_MIX:
        server.submit(JobSpec(a, gname, dict(params), weight=w))
    return server, server.run()


def _server_wrappers():
    from repro_torch.kernels.drain_loop.bfs_drain import bfs_drain_cuda
    from repro_torch.kernels.drain_loop.coloring_drain import (
        coloring_drain_cuda)
    from repro_torch.kernels.drain_loop.pagerank_drain import (
        pagerank_drain_cuda)
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda
    from repro_torch.kernels.scatter_add.kernel import (
        ordered_scatter_add_cuda)

    return {"lbs": lbs_cuda, "compact": compact_cuda,
            "ordered_scatter_add": ordered_scatter_add_cuda,
            "bfs_drain": bfs_drain_cuda, "pagerank_drain": pagerank_drain_cuda,
            "coloring_drain": coloring_drain_cuda}


@pytest.mark.parametrize("policy,g", [("weighted", 1), ("weighted", 4),
                                      ("round_robin", 1)])
def test_server_mix_on_the_card_equals_the_cpu(policy, g):
    """The reference's 8-job mix (PageRank at eps 1e-6) through the
    kernels on the card, traced, bitwise equal to the same server on the
    CPU: results, every telemetry field, stats but wall, trace rows."""
    _require_cuda()
    import dataclasses

    from repro_torch.obs import Trace

    runs = {}
    for device in ("cpu", "cuda"):
        trace = Trace()
        _, res = _serve_mix(device, policy, g, trace=trace)
        stats = dataclasses.asdict(res.stats)
        stats.pop("wall_seconds")
        runs[device] = (res, stats, trace.records)
    (cres, cstats, crows), (kres, kstats, krows) = runs["cpu"], runs["cuda"]
    for i in cres.results:
        np.testing.assert_array_equal(kres.results[i], cres.results[i])
        assert kres.telemetry[i].as_dict() == cres.telemetry[i].as_dict()
    assert kstats == cstats and krows == crows


def test_server_lane_steps_launch_b1_and_b2():
    """Each lane step launches its body's B1 searches and one B2 push
    (PageRank's also the ordered scatter-add); each seed push and on_empty
    refill one B2; no drain kernel."""
    _require_cuda()
    wrappers = _server_wrappers()
    for w in wrappers.values():
        w.launches = 0
    server, _ = _serve_mix("cuda", "weighted", 1)
    counts = {name: w.launches for name, w in wrappers.items()}
    jobs = server.jobs
    assert counts == {
        "lbs": sum(B1_PER_STEP[j.program.algorithm] * j.lane_steps
                   for j in jobs),
        "compact": sum(j.lane_steps + j.empty_steps + 1 for j in jobs),
        "ordered_scatter_add": sum(j.lane_steps for j in jobs
                                   if j.program.algorithm == "pagerank"),
        "bfs_drain": 0, "pagerank_drain": 0, "coloring_drain": 0}
    assert counts["lbs"] > 0 and counts["compact"] > 0


# ------------------------------------------- the sharded topology (A12)
SHARD_GPU_CELLS = {
    "s4": dict(num_shards=4),
    "2x2": dict(num_shards=4, mesh_shape=(2, 2), defer_rounds=1,
                compress=True, steal_threshold=0.5),
}


def _sharded_run(algo, device, cell, persistent=True):
    from repro_torch.core import SchedulerConfig
    from repro_torch.graph import rmat
    from repro_torch.launch.mesh import make_shard_mesh, make_shard_mesh2d
    from repro_torch.runtime import build_program
    from repro_torch.runtime.api import execute

    g = rmat(9, edge_factor=8, seed=3, device=device)
    cfg = SchedulerConfig(num_workers=64, persistent=persistent,
                          **SHARD_GPU_CELLS[cell])
    devices = [torch.device(device)] * 4
    mesh = (make_shard_mesh(4, devices=devices) if cfg.mesh_shape is None
            else make_shard_mesh2d(2, 2, devices=devices))
    params = {"source": 0} if algo == "bfs" else {}
    return execute(build_program(algo, g, cfg, params=params), g, cfg,
                   mesh=mesh)


@pytest.mark.parametrize("cell", list(SHARD_GPU_CELLS))
@pytest.mark.parametrize("algo", ["bfs", "pagerank", "coloring"])
def test_sharded_drain_on_one_card_equals_the_cpu(algo, cell):
    """Four shards on ``cuda:0`` through B1, B2 (and the ordered
    scatter-add), no host sync inside a window: the state, RunStats and
    every meter bitwise equal to the same mesh of CPU shards."""
    _require_cuda()
    from repro_torch.kernels.frontier_expand.kernel import lbs_cuda
    from repro_torch.kernels.queue_compact.kernel import compact_cuda

    lbs_cuda.launches = compact_cuda.launches = 0
    got = _sharded_run(algo, "cuda", cell)
    assert lbs_cuda.launches > 0 and compact_cuda.launches > 0
    want = _sharded_run(algo, "cpu", cell)
    for a, b in zip(vars(got.state).values(), vars(want.state).values()):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a.cpu(), b)
    assert got.state.counter.work.item() == want.state.counter.work.item()
    assert [int(x) for x in got.stats] == [int(x) for x in want.stats]
    assert got.info == want.info
    assert got.info["mis_routed"] == 0 and got.info["dropped"] == 0


def test_sharded_discrete_drain_on_one_card_equals_the_cpu():
    _require_cuda()
    got = _sharded_run("coloring", "cuda", "2x2", persistent=False)
    want = _sharded_run("coloring", "cpu", "2x2", persistent=False)
    assert torch.equal(got.state.colors.cpu(), want.state.colors)
    assert got.info == want.info


def test_codec_on_the_card_equals_the_cpu():
    """The exchange codec's words, word count and decode on CUDA tensors
    equal the CPU's, in every layout and width."""
    _require_cuda()
    from repro_torch.shard.codec import decode_buffer, encode_buffer

    rng = np.random.default_rng(2)
    e = -(2 ** 31)
    for rows, width in ((1, 1), (4, 8), (3, 33), (2, 300), (4, 1024),
                        (2, 70000)):
        for regime in range(4):
            buf = np.full((rows, width), e, np.int64)
            for r in range(rows):
                k = int(rng.integers(0, width + 1))
                vals = (rng.integers(0, 512, k) if regime == 0 else
                        rng.integers(-2 ** 31 + 1, 2 ** 31 - 1, k)
                        if regime == 1 else
                        np.sort(rng.integers(0, 1 << 20, k)))
                if regime == 3:
                    buf[r, rng.choice(width, size=k, replace=False)] = vals
                else:
                    buf[r, :k] = vals
            cpu = torch.as_tensor(buf.astype(np.int32))
            w_cpu, n_cpu = encode_buffer(cpu)
            w_gpu, n_gpu = encode_buffer(cpu.cuda())
            assert torch.equal(w_gpu.cpu(), w_cpu)
            assert int(n_gpu) == int(n_cpu)
            assert torch.equal(decode_buffer(w_gpu, rows, width).cpu(),
                               decode_buffer(w_cpu, rows, width))
