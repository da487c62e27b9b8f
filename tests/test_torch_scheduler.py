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


def _step_programs(kind):
    """A body that ticks a WorkCounter-bearing state and pushes one task
    even on a zero-valid wavefront, and an on_empty that pushes another,
    in both packages: the task server's lane-step contract."""
    if kind == "jax":
        from repro.core.counters import WorkCounter as WC

        def f(items, valid, state):
            n, wc = state
            out = jnp.concatenate([items + 1, jnp.array([90], jnp.int32)])
            mask = jnp.concatenate([valid & (items < 6),
                                    jnp.array([True])])
            return out, mask, (n + 7, wc.add(jnp.sum(valid.astype(
                jnp.int32))))

        def on_empty(state):
            n, wc = state
            return jnp.array([50], jnp.int32), jnp.array([True]), (n + 100,
                                                                     wc)

        return f, on_empty, (jnp.int32(3), WC.zero())

    from repro_torch.core import WorkCounter as WC

    def f(items, valid, state):
        n, wc = state
        out = torch.cat([items + 1, torch.tensor([90], dtype=torch.int32)])
        mask = torch.cat([valid & (items < 6), torch.tensor([True])])
        return out, mask, (n + 7, wc.add(valid.sum(dtype=torch.int32)))

    def on_empty(state):
        n, wc = state
        return (torch.tensor([50], dtype=torch.int32), torch.tensor([True]),
                (n + 100, wc))

    return f, on_empty, (torch.tensor(3, dtype=torch.int32),
                         WC.zero("cpu"))


@pytest.mark.parametrize("seeds", [[], [2, 5, 8]])
@pytest.mark.parametrize("always_run_body", [True, False])
def test_wavefront_step_always_run_body_matches_jax(seeds, always_run_body):
    """With the flag a zero-valid pop keeps the body's state and push and
    on_empty is not consulted; without it an empty pop takes on_empty's.
    Queue, state (counter included), rounds and processed bitwise with
    JAX's ``wavefront_step`` over three rounds."""
    from repro.core.queue import make_queue as j_make_queue
    from repro.core.scheduler import taskqueue_ops as j_ops
    from repro.core.scheduler import wavefront_step as j_step
    from repro_torch.core import make_queue, taskqueue_ops, wavefront_step

    jf, je, js = _step_programs("jax")
    tf, te, ts = _step_programs("torch")
    jq = j_make_queue(16, jnp.asarray(seeds, jnp.int32)) if seeds \
        else j_make_queue(16)
    tq = make_queue(16, np.asarray(seeds, np.int32) if seeds else None,
                    device="cpu")
    jcarry = (jq, js, jnp.int32(0), jnp.int32(0))
    tcarry = (tq, ts, torch.tensor(0, dtype=torch.int32),
              torch.tensor(0, dtype=torch.int32))
    jops = j_ops(JConfig(num_workers=4))
    tops = taskqueue_ops(SchedulerConfig(num_workers=4))
    for _ in range(3):
        jcarry = j_step(jf, je, jops, jcarry,
                        always_run_body=always_run_body)
        tcarry = wavefront_step(tf, te, tops, tcarry,
                                always_run_body=always_run_body)
        (jq, (jn, jwc), jr, jp), (tq, (tn, twc), tr, tp) = jcarry, tcarry
        for a, b in [(jq.buf, tq.buf), (jq.head, tq.head),
                     (jq.tail, tq.tail), (jq.dropped, tq.dropped),
                     (jn, tn), (jwc.work, twc.work),
                     (jwc.rounds, twc.rounds), (jr, tr), (jp, tp)]:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _seed_cases():
    rng = np.random.default_rng(11)
    rmat_ids = np.arange(1 << 8)
    gaps = np.sort(rng.choice(256, size=150, replace=False))
    runs = np.concatenate([np.arange(a, min(256, a + int(k)))
                           for a, k in zip(rng.integers(0, 256, 12),
                                           rng.integers(1, 40, 12))])
    return {"arange(n) of rmat(8)": rmat_ids, "sorted with gaps": gaps,
            "runs, unsorted, repeated": runs, "one id": np.array([7]),
            "empty": np.array([], dtype=np.int64)}


@pytest.mark.parametrize("threshold", [None, 0, 3, 40])
@pytest.mark.parametrize("g", [1, 2, 4, 64])
@pytest.mark.parametrize("case", list(_seed_cases()))
def test_chunk_seeds_matches_jax(case, g, threshold):
    """The vectorised greedy chunker (run ends, a ``searchsorted`` of
    ``row_ptr`` for the threshold, pointer doubling over the heads) equals
    JAX's one-id-at-a-time loop bit for bit."""
    from repro.core.task import ChunkCodec as JCodec
    from repro.core.task import chunk_seeds as j_chunk_seeds
    from repro_torch.core import ChunkCodec, chunk_seeds

    jgraph = jg.rmat(8, 8, seed=1)
    tgraph = tg.rmat(8, 8, seed=1, device="cpu")
    vids = _seed_cases()[case]
    want = j_chunk_seeds(vids, JCodec(g), np.asarray(jgraph.row_ptr),
                         split_threshold=threshold)
    got = chunk_seeds(vids, ChunkCodec(g), tgraph.row_ptr,
                      split_threshold=threshold)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
