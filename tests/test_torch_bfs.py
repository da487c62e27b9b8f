"""Speculative BFS through the PyTorch port's ``execute`` against the JAX
package's, bit for bit: ``dist``, ``RunStats`` and ``info`` under
``single.persistent`` and ``single.discrete``, at granularity 1 and 4, for
the merge-path and per-item strategies, on an R-MAT and a grid graph; the
level-synchronous ``bfs_bsp``; and a drain handed across mid-way."""
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.algorithms.bfs import bfs_bsp as j_bfs_bsp
from repro.core import SchedulerConfig as JConfig
from repro.runtime import build_program as j_build, execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro.runtime.api import _shared_setup as j_setup
from repro_torch.algorithms.bfs import bfs_bsp, bfs_speculative
from repro_torch.convert import (bfs_state_from_numpy, queue_from_numpy,
                                 to_numpy)
from repro_torch.core import SchedulerConfig
from repro_torch.runtime import build_program, config_for, parse_policy
from repro_torch.runtime.api import _shared_setup, execute

GRAPHS = {
    "rmat(8,8,1)": (lambda: jg.rmat(8, 8, seed=1),
                    lambda: tg.rmat(8, 8, seed=1, device="cpu")),
    "grid2d(16,16)": (lambda: jg.grid2d(16, 16),
                      lambda: tg.grid2d(16, 16, device="cpu")),
}


@pytest.fixture(scope="module")
def graphs():
    return {name: (mj(), mt()) for name, (mj, mt) in GRAPHS.items()}


def _configs(policy: str, **kw):
    base = dict(num_workers=16, fetch_size=4, **kw)
    return (j_config(policy, **base),
            config_for(SchedulerConfig(**base), parse_policy(policy)))


def j_config(policy, **kw):
    from repro.runtime import config_for as j_config_for

    return j_config_for(JConfig(**kw), j_parse(policy))


def _run_both(jgraph, tgraph, policy, params, **cfg_kw):
    jcfg, tcfg = _configs(policy, **cfg_kw)
    js, jstats, jinfo = j_execute(j_build("bfs", jgraph, jcfg, params=params),
                                  jgraph, jcfg)
    ts, tstats, tinfo = execute(build_program("bfs", tgraph, tcfg,
                                              params=params), tgraph, tcfg)
    np.testing.assert_array_equal(ts.dist.numpy(), np.asarray(js.dist))
    for field in ("work", "splits", "rounds"):
        assert int(getattr(ts.counter, field)) == int(
            getattr(js.counter, field)), field
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert all(x.dtype == torch.int32 for x in tstats)
    assert tinfo == jinfo
    return tinfo


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("strategy", ["merge_path", "per_item"])
@pytest.mark.parametrize("kernel", ["persistent", "discrete"])
def test_execute_bit_identical_to_jax(graphs, graph, g, strategy, kernel):
    jgraph, tgraph = graphs[graph]
    policy = f"single.{kernel}" + ("" if g == 1 else f".g{g}")
    info = _run_both(jgraph, tgraph, policy,
                     {"source": 3, "strategy": strategy})
    assert info["dropped"] == 0 and info["launches"] == info["rounds"]


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("kernel", ["persistent", "discrete"])
def test_truncation_and_splits_bit_identical(graphs, graph, kernel):
    """A work budget at the max degree re-queues truncated chunks every
    round, and a small split threshold makes the g4 coalescer split."""
    jgraph, tgraph = graphs[graph]
    max_degree = int(np.asarray(jgraph.degrees()).max())
    _run_both(jgraph, tgraph, f"single.{kernel}",
              {"source": 0, "work_budget": max_degree})
    info = _run_both(jgraph, tgraph, f"single.{kernel}.g4",
                     {"source": 0, "work_budget": 2 * max_degree},
                     split_threshold=6)
    assert info["splits"] > 0


@pytest.mark.parametrize("kernel", ["persistent", "discrete"])
def test_max_rounds_cut_is_identical(graphs, kernel):
    jgraph, tgraph = graphs["grid2d(16,16)"]
    info = _run_both(jgraph, tgraph, f"single.{kernel}", {"source": 0},
                     max_rounds=5)
    assert info["rounds"] == 5


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_bfs_bsp_matches_jax(graphs, graph):
    jgraph, tgraph = graphs[graph]
    jd, jinfo = j_bfs_bsp(jgraph, 5)
    td, tinfo = bfs_bsp(tgraph, 5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tinfo == jinfo


def test_bfs_speculative_driver(graphs):
    from repro.algorithms.bfs import bfs_speculative as j_bfs_speculative

    jgraph, tgraph = graphs["rmat(8,8,1)"]
    jd, jinfo = j_bfs_speculative(jgraph, 1, JConfig(num_workers=8))
    td, tinfo = bfs_speculative(tgraph, 1, SchedulerConfig(num_workers=8))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tinfo == jinfo


@pytest.mark.parametrize("g", [1, 4])
def test_drain_handed_across_mid_way(graphs, g):
    """Three JAX rounds, then the queue and BFS state cross to the port as
    numpy; the port's rounds continue exactly as JAX's would."""
    jgraph, tgraph = graphs["rmat(8,8,1)"]
    policy = "single.discrete" + ("" if g == 1 else f".g{g}")
    jcfg, tcfg = _configs(policy)
    params = {"source": 7}
    jq, js, _, jstep, _, _ = j_setup(j_build("bfs", jgraph, jcfg, params),
                                     jgraph, jcfg, j_parse(policy), None)
    _, _, tstep, _ = _shared_setup(build_program("bfs", tgraph, tcfg, params),
                                   tgraph, tcfg, None)
    zero = np.int32(0)
    carry = (jq, js, zero, zero)
    for _ in range(3):
        carry = jstep(carry)
    jq, js, jr, jp = carry
    tcarry = (queue_from_numpy(np.asarray(jq.buf), np.asarray(jq.head),
                               np.asarray(jq.tail), np.asarray(jq.dropped),
                               device="cpu"),
              bfs_state_from_numpy(np.asarray(js.dist),
                                   np.asarray(js.counter.work),
                                   np.asarray(js.counter.splits),
                                   np.asarray(js.counter.rounds),
                                   device="cpu"),
              torch.tensor(int(jr), dtype=torch.int32),
              torch.tensor(int(jp), dtype=torch.int32))
    for _ in range(4):
        carry = jstep(carry)
        tcarry = tstep(tcarry)
        got = to_numpy(tcarry)
        np.testing.assert_array_equal(got[0].buf, np.asarray(carry[0].buf))
        np.testing.assert_array_equal(got[1].dist, np.asarray(carry[1].dist))
        assert int(got[1].counter.work) == int(carry[1].counter.work)
        assert (int(got[2]), int(got[3])) == (int(carry[2]), int(carry[3]))
