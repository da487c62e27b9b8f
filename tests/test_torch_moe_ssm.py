"""The port's MoE layer and Mamba block against the JAX package on the CPU,
at smoke size and in f32, with the JAX weights carried across by
``params_from_numpy`` and numpy-made inputs.

Tolerances: MoE outputs 1e-5 absolute and ``aux_loss`` 1e-6 (measured
under 5e-6 and 1e-7), ``dropped`` exactly; the causal convolution 1e-6
(measured 0: the same products in the same order); the Mamba block and
its cache 1e-5 relative to the largest reference value (measured under
3e-7: XLA's ``exp`` and the port's differ in the last bits, and the state
carries that over the steps)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as j_smoke
from repro.models import moe as JM
from repro.models import ssm as JS
from repro.models.params import init_params as j_init
from repro_torch.configs import smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as M
from repro_torch.models import ssm as S

from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

MOE_TOL = 1e-5
AUX_TOL = 1e-6
SSM_REL = 1e-5
SSM_ARCHS = ["falcon-mamba-7b", "zamba2-1.2b"]
# jitted: the reference's eager ops compile again at every new shape
j_moe = jax.jit(JM.apply_moe, static_argnums=(1,),
                static_argnames=("capacity",))
j_mamba = jax.jit(JS.apply_mamba, static_argnums=(1,))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rel):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# --------------------------------------------------------------------- MoE


@pytest.fixture(scope="module")
def moe():
    """olmoe-1b-7b's smoke MoE layer (kimi-k2-1t's smoke layer has the same
    widths, experts and top-k)."""
    jcfg = j_smoke("olmoe-1b-7b")
    jp = j_init(JM.moe_spec(jcfg), jax.random.PRNGKey(3), jnp.float32)
    return (jcfg, jp, smoke_config("olmoe-1b-7b"),
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def _moe_pair(moe, x, **kw):
    jcfg, jp, cfg, tp = moe
    got, m = M.apply_moe(tp, cfg, torch.from_numpy(x), **kw)
    want, jm = j_moe(jp, jcfg, jnp.asarray(x), **kw)
    return got, m, want, jm


@pytest.mark.parametrize("capacity", [1, 4, None, 64])
def test_apply_moe_matches(moe, capacity):
    """Capacity 1 and 4 drop (as tests/test_models.py's capacity test),
    the config's own capacity and an ample one do not."""
    x = _x(11, (2, 16, 64), 2.0)
    got, m, want, jm = _moe_pair(moe, x, capacity=capacity)
    np.testing.assert_allclose(_np(got), _np(want), atol=MOE_TOL, rtol=0)
    assert abs(float(m["aux_loss"]) - float(jm["aux_loss"])) <= AUX_TOL
    assert int(m["dropped"]) == int(jm["dropped"])
    assert m["dropped"].dtype == torch.int32
    if capacity in (1, 4):
        assert int(m["dropped"]) > 0
    if capacity == 64:
        assert int(m["dropped"]) == 0


@pytest.mark.parametrize("n_tok,override", [(1, 0.0), (33, 0.0), (64, 0.5),
                                            (200, 1.0)])
def test_capacity_arithmetic_matches(moe, n_tok, override):
    """The default capacity (int(cf * n * k / e), up to a multiple of 8,
    at least 8) and ``moe_cap_factor_override``: ``dropped`` equals the
    reference's at token counts where the rounding bites."""
    jcfg, jp, cfg, tp = moe
    jcfg = dataclasses.replace(jcfg, moe_cap_factor_override=override)
    cfg = dataclasses.replace(cfg, moe_cap_factor_override=override)
    x = _x(n_tok, (1, n_tok, 64), 2.0)
    got, m = M.apply_moe(tp, cfg, torch.from_numpy(x))
    want, jm = j_moe(jp, jcfg, jnp.asarray(x))
    assert int(m["dropped"]) == int(jm["dropped"])
    np.testing.assert_allclose(_np(got), _np(want), atol=MOE_TOL, rtol=0)
    cf = override or cfg.capacity_factor
    want_cap = max(8, -(-int(cf * n_tok * cfg.num_experts_per_tok
                             / cfg.num_experts) // 8) * 8)
    assert M.capacity_of(cfg, n_tok) == want_cap


def test_equal_router_scores_pick_the_lower_experts_first(moe):
    """A zero router gives every expert the same probability: the reference's
    top_k takes experts 0..k-1 for every token, and so must the port, drops
    included."""
    jcfg, jp, cfg, tp = moe
    jp = {**jp, "router": jnp.zeros_like(jp["router"])}
    tp = {**tp, "router": torch.zeros_like(tp["router"])}
    x = _x(5, (2, 16, 64))
    _, _, idx = M.route(tp, cfg, torch.from_numpy(x).reshape(32, 64))
    assert torch.equal(idx, torch.arange(cfg.num_experts_per_tok).expand(
        32, -1))
    for capacity in (8, None):
        got, m = M.apply_moe(tp, cfg, torch.from_numpy(x), capacity=capacity)
        want, jm = j_moe(jp, jcfg, jnp.asarray(x), capacity=capacity)
        assert int(m["dropped"]) == int(jm["dropped"]) > 0
        np.testing.assert_allclose(_np(got), _np(want), atol=MOE_TOL, rtol=0)


# --------------------------------------------------------------------- SSM


@pytest.fixture(scope="module", params=SSM_ARCHS)
def mamba(request):
    jcfg = j_smoke(request.param)
    jp = j_init(JS.mamba_spec(jcfg), jax.random.PRNGKey(4), jnp.float32)
    return (jcfg, jp, smoke_config(request.param),
            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))


def test_softplus_is_logaddexp():
    """jax.nn.softplus to the last bits, also past 20 where F.softplus
    turns into the identity."""
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    np.testing.assert_allclose(_np(S.softplus(torch.from_numpy(x))),
                               _np(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv_matches(mamba, with_cache):
    jcfg, jp, cfg, tp = mamba
    x = _x(6, (2, 9, cfg.d_inner))
    cache = _x(7, (2, cfg.ssm_conv - 1, cfg.d_inner)) if with_cache else None
    got, gc = S._causal_conv(tp, torch.from_numpy(x),
                             None if cache is None else torch.from_numpy(cache))
    want, wc = JS._causal_conv(jp, jnp.asarray(x),
                               None if cache is None else jnp.asarray(cache))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_np(gc), _np(wc), atol=1e-6, rtol=0)


@pytest.mark.parametrize("t,with_cache", [(1, True), (3, True), (40, False)])
def test_apply_mamba_matches(mamba, t, with_cache):
    """The decode step (T = 1 from a cache), a short scan from a cache and
    a scan from zeros: output, conv cache and f32 state."""
    jcfg, jp, cfg, tp = mamba
    x = _x(8 + t, (2, t, 64))
    jcache = tcache = None
    if with_cache:
        conv = _x(1, (2, cfg.ssm_conv - 1, cfg.d_inner))
        state = _x(2, (2, cfg.d_inner, cfg.ssm_state))
        jcache = JS.SSMCache(jnp.asarray(conv), jnp.asarray(state))
        tcache = S.SSMCache(torch.from_numpy(conv), torch.from_numpy(state))
    got, gc = S.apply_mamba(tp, cfg, torch.from_numpy(x), cache=tcache)
    want, wc = j_mamba(jp, jcfg, jnp.asarray(x), cache=jcache)
    _close(got, want, SSM_REL)
    _close(gc.conv, wc.conv, SSM_REL)
    _close(gc.state, wc.state, SSM_REL)
    assert gc.state.dtype == torch.float32 and got.dtype == torch.float32


def test_scan_chunks_equal_one_chunk(mamba, monkeypatch):
    """The scan's per-step inputs are made a chunk of steps at a time; any
    chunking gives the same bits."""
    _, _, cfg, tp = mamba
    x = torch.from_numpy(_x(12, (2, 40, 64)))
    whole, wc = S.apply_mamba(tp, cfg, x)
    monkeypatch.setattr(S, "SCAN_CHUNK_BYTES",
                        7 * 4 * 2 * cfg.d_inner * cfg.ssm_state)
    cut, cc = S.apply_mamba(tp, cfg, x)
    assert torch.equal(whole, cut) and torch.equal(wc.state, cc.state)


def test_bf16_mamba_keeps_the_reference_dtypes(mamba):
    """bf16 weights and input: the state stays f32, the output and the conv
    cache bf16, within bf16 rounding of the f32 block."""
    _, _, cfg, tp = mamba
    tb = {k: v.bfloat16() for k, v in tp.items()}
    x = torch.from_numpy(_x(13, (1, 12, 64)))
    got, gc = S.apply_mamba(tb, cfg, x.bfloat16())
    want, _ = S.apply_mamba({k: v.float() for k, v in tb.items()},
                            cfg, x.bfloat16().float())
    assert got.dtype == torch.bfloat16 and gc.conv.dtype == torch.bfloat16
    assert gc.state.dtype == torch.float32
    scale = float(want.abs().max())
    assert float((got.float() - want).abs().max()) <= 0.05 * scale
