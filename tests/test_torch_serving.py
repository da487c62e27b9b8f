"""The port's continuous-batching engine against the JAX package's on the
CPU, at smoke size and in f32, with the JAX weights carried across by
``params_from_numpy``: greedy tokens equal the JAX engine's and the port's
own one-request decode, and the schedule (wavefronts, mean occupancy)
equals the JAX engine's in both modes.  Also the serve CLI on the CPU."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as j_smoke
from repro.launch.serve import synthetic_requests as j_requests
from repro.models import transformer as JT
from repro.models.params import init_params as j_init
from repro.serving.engine import ContinuousBatchingEngine as JEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import synthetic_requests
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        decode_single)

REPO = Path(__file__).resolve().parent.parent
DENSE = ["minitron-4b", "h2o-danube-3-4b", "stablelm-1.6b"]


def _requests(reqs):
    return [(r.uid, [int(t) for t in r.prompt], r.max_new_tokens)
            for r in reqs]


@pytest.mark.parametrize("vocab", [512, 32000, 256000])
def test_synthetic_requests_are_the_reference_draws(vocab):
    assert _requests(synthetic_requests(8, vocab, seed=0)) == \
        _requests(j_requests(8, vocab, seed=0))


@pytest.mark.parametrize("mode", ["continuous", "bsp"])
@pytest.mark.parametrize("arch", DENSE)
def test_engine_matches_jax_engine(arch, mode):
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jp = j_init(JT.model_spec(jcfg), jax.random.PRNGKey(1), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = synthetic_requests(8, cfg.vocab_size, seed=0)
    res = ContinuousBatchingEngine(cfg, tp, num_slots=4, max_len=32,
                                   mode=mode).run(reqs)
    jres = JEngine(jcfg, jp, num_slots=4, max_len=32, mode=mode).run(
        j_requests(8, jcfg.vocab_size, seed=0))
    assert res["outputs"] == jres["outputs"]
    for r in reqs:
        assert len(res["outputs"][r.uid]) == r.max_new_tokens
    st, jst = res["stats"], jres["stats"]
    assert (st.wavefronts, st.completed) == (jst.wavefronts, jst.completed)
    assert st.mean_occupancy == pytest.approx(jst.mean_occupancy, abs=1e-12)
    if mode == "continuous":
        for r in reqs[:3]:
            assert decode_single(cfg, tp, r.prompt, r.max_new_tokens,
                                 32) == res["outputs"][r.uid], r.uid


def test_continuous_takes_fewer_wavefronts_than_bsp():
    cfg = smoke_config("stablelm-1.6b")
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params

    params = init_params(T.model_spec(cfg), 0, torch.float32, device="cpu")
    reqs = synthetic_requests(8, cfg.vocab_size, seed=0)
    stats = {mode: ContinuousBatchingEngine(cfg, params, num_slots=4,
                                            max_len=32, mode=mode
                                            ).run(reqs)["stats"]
             for mode in ("continuous", "bsp")}
    assert stats["continuous"].wavefronts < stats["bsp"].wavefronts
    assert stats["continuous"].mean_occupancy > stats["bsp"].mean_occupancy


def test_serve_cli_runs_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "minitron-4b", "--smoke", "--requests", "6", "--device", "cpu"],
        cwd=REPO, env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin"},
        capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "wavefronts=" in proc.stdout and "device=cpu" in proc.stdout


def test_serve_cli_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "minitron-4b", "--smoke", "--requests", "2"])
