"""The PyTorch port's scheduler against the JAX package's on synthetic
programs that reach the paths BFS does not: a ``stop`` predicate, an
``on_empty`` refill that keeps a drained queue alive, ``empty_means_done``
either way, and the ``max_rounds`` bound -- final state, RunStats and info
bit-identical under ``single.persistent`` and ``single.discrete``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.core import SchedulerConfig as JConfig
from repro.runtime import AtosProgram as JProgram
from repro.runtime import config_for as j_config_for
from repro.runtime import execute as j_execute
from repro.runtime import parse_policy as j_parse
from repro_torch.core import SchedulerConfig
from repro_torch.runtime import AtosProgram, config_for, parse_policy
from repro_torch.runtime.api import execute

SEEDS = [5, 3, 6, 2]


def _jax_program(stop, refill, empty_means_done):
    def body(graph, ctx):
        def f(items, valid, state):
            new = items - 1
            return new, valid & (new > 0), state + jnp.sum(
                valid.astype(jnp.int32))
        return f

    def on_empty(graph, ctx):
        return lambda s: (jnp.array([4, 2], jnp.int32),
                          jnp.array([True, True]) & (s < 300), s + 100)

    return JProgram(
        name="synthetic", init=lambda: (jnp.int32(0), jnp.asarray(SEEDS)),
        make_body=body, result=lambda s: s,
        make_on_empty=on_empty if refill else None,
        stop=(lambda s: s >= stop) if stop else None,
        empty_means_done=empty_means_done, work=lambda s: s)


def _torch_program(stop, refill, empty_means_done):
    def body(graph, ctx):
        def f(items, valid, state):
            new = items - 1
            return new, valid & (new > 0), state + valid.sum(
                dtype=torch.int32)
        return f

    def on_empty(graph, ctx):
        return lambda s: (torch.tensor([4, 2], dtype=torch.int32),
                          torch.tensor([True, True]) & (s < 300), s + 100)

    return AtosProgram(
        name="synthetic",
        init=lambda: (torch.zeros((), dtype=torch.int32), np.array(SEEDS)),
        make_body=body, result=lambda s: s,
        make_on_empty=on_empty if refill else None,
        stop=(lambda s: s >= stop) if stop else None,
        empty_means_done=empty_means_done, work=lambda s: s)


@pytest.mark.parametrize("kernel", ["persistent", "discrete"])
@pytest.mark.parametrize("stop,refill,empty_means_done,max_rounds", [
    (7, False, True, 100),      # stop fires mid-drain
    (None, True, True, 100),    # on_empty never fires: the queue drains
    (None, True, False, 40),    # rescan keeps a drained queue alive
    (450, True, False, 100),    # ... until stop fires
])
def test_synthetic_drains_match_jax(kernel, stop, refill, empty_means_done,
                                    max_rounds):
    jgraph, tgraph = jg.grid2d(2, 2), tg.grid2d(2, 2, device="cpu")
    policy = f"single.{kernel}"
    jcfg = j_config_for(JConfig(num_workers=2, max_rounds=max_rounds),
                        j_parse(policy))
    tcfg = config_for(SchedulerConfig(num_workers=2, max_rounds=max_rounds),
                      parse_policy(policy))
    js, jstats, jinfo = j_execute(_jax_program(stop, refill,
                                               empty_means_done), jgraph, jcfg)
    ts, tstats, tinfo = execute(_torch_program(stop, refill,
                                               empty_means_done), tgraph, tcfg)
    assert int(ts) == int(js)
    assert [int(x) for x in tstats] == [int(x) for x in jstats]
    assert tinfo == jinfo
