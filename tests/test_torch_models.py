"""The port's configs, parameters, layers and dense transformer against the
JAX package on the CPU, at smoke size, with the JAX weights carried across
by ``params_from_numpy`` and numpy-made inputs.

Tolerances, all f32: layers 1e-5 absolute (measured under 1e-6); logits of
``forward``/``prefill`` and of ``decode_step`` 1e-5 absolute (measured
under 8e-6; the sums run in another order on the two sides).  The blocked
path rounds its probabilities to bf16, so a 1e-7 upstream difference can
move one probability across a bf16 rounding boundary, a jump of one bf16
step (2**-8 relative).  Its forward logits are held at 5e-3 (measured
2.8e-3); the blocked attention itself, on identical inputs, at 5e-3 with
at most 1 % of the elements beyond 1e-5 (measured 0.26 %, where the two
sides' f32 logits differ by an ulp across blocks of 16)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import supports_shape as j_supports
from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get
from repro.configs.registry import smoke_config as j_smoke
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.params import count_params as j_count
from repro.models.params import init_params as j_init
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config, smoke_config,
                                 supports_shape)
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import count_params, init_params

DENSE = ["minitron-4b", "h2o-danube-3-4b", "stablelm-1.6b"]
TOL = 1e-5
BLOCKED_TOL = 5e-3


def _params(cfg_name, seed=0):
    jcfg = j_smoke(cfg_name)
    jp = j_init(JT.model_spec(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    return jcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                       device="cpu")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ configs


def test_arch_ids_and_shapes_match():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.parametrize("arch", J_ARCH_IDS)
def test_config_fields_and_param_count_match(arch):
    full, jfull = get_config(arch), j_get(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count()
    assert full.active_param_count() == jfull.active_param_count()
    assert count_params(T.model_spec(full)) == j_count(JT.model_spec(jfull))
    assert dataclasses.asdict(smoke_config(arch)) == \
        dataclasses.asdict(j_smoke(arch))
    for name, shape in SHAPES.items():
        assert supports_shape(full, shape) == j_supports(jfull,
                                                         J_SHAPES[name])


def test_minitron_is_5_1_billion_parameters():
    assert get_config("minitron-4b").param_count() == 5_096_279_040


def test_init_params_follows_the_reference_rule():
    """Same tree, shapes and dtypes as JAX's; f32 normal scaled by
    scale / sqrt(shape[-2]) (d for stacked [L, d, ff] leaves), ones and
    zeros where the spec says; deterministic per seed."""
    cfg = smoke_config("stablelm-1.6b")
    spec = T.model_spec(cfg)
    a = init_params(spec, 3, torch.float32, device="cpu")
    b = init_params(spec, 3, torch.float32, device="cpu")
    jp = j_init(JT.model_spec(j_smoke("stablelm-1.6b")),
                jax.random.PRNGKey(0), jnp.float32)
    jflat = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    assert len(jflat) == len(jax.tree.leaves(jp))

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                yield from walk(t[k], path + (k,))
        else:
            yield path, t

    leaves = dict(walk(a))
    assert len(leaves) == len(jflat)
    for (path, x), (_, y) in zip(walk(a), walk(b)):
        assert torch.equal(x, y)
    for jpath, jleaf in jflat.items():
        path = tuple(k.key for k in jpath)
        x = leaves[path]
        assert tuple(x.shape) == jleaf.shape and x.dtype == torch.float32
        if path[-1] == "scale":
            assert torch.equal(x, torch.ones_like(x))
        elif path[-1] == "bias":
            assert torch.equal(x, torch.zeros_like(x))
        else:
            fan_in = x.shape[-2]
            assert abs(float(x.std()) * fan_in ** 0.5 - 1.0) < 0.1, path
    assert a["layers"]["mlp"]["wi"].shape == (2, 64, 128)
    bf = init_params(spec, 3, torch.bfloat16, device="cpu")
    assert torch.equal(bf["embed"]["tok"], a["embed"]["tok"].bfloat16())


# ------------------------------------------------------------------- layers


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_apply_norm_matches(norm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 64)).astype(np.float32) * 3 + 1
    params = {"scale": rng.standard_normal(64).astype(np.float32)}
    if norm == "layernorm":
        params["bias"] = rng.standard_normal(64).astype(np.float32)
    got = L.apply_norm({k: torch.from_numpy(v) for k, v in params.items()},
                       torch.from_numpy(x))
    want = JL.apply_norm({k: jnp.asarray(v) for k, v in params.items()},
                         jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


def test_rope_matches():
    cfg, jcfg = smoke_config("minitron-4b"), j_smoke("minitron-4b")
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 8)).astype(np.int32)
    x = rng.standard_normal((2, 8, 4, cfg.hd)).astype(np.float32)
    s, c = L.rope_freqs(cfg, torch.from_numpy(pos))
    js, jc = JL.rope_freqs(jcfg, jnp.asarray(pos))
    # angles up to 5000 rad: sin/cos of nearly equal f32 angles
    np.testing.assert_allclose(_np(s), _np(js), atol=2e-4)
    np.testing.assert_allclose(_np(c), _np(jc), atol=2e-4)
    got = L.apply_rope(torch.from_numpy(x), s, c)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(_np(s)),
                         jnp.asarray(_np(c)))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    xb = torch.from_numpy(x).bfloat16()
    assert L.apply_rope(xb, s, c).dtype == torch.bfloat16


def _qkv(seed, b, tq, tk, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, tq, h, hd)).astype(np.float32),
            rng.standard_normal((b, tk, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, tk, kvh, hd)).astype(np.float32))


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_sdpa_xla_and_blocked_match(window, causal):
    q, k, v = _qkv(3 + window, 2, 48, 48, 4, 2, 16)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    got = L._sdpa_xla(tq, tk, tv, causal=causal, window=window)
    want = JL._sdpa_xla(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)
    for block in (0, 16):
        got = L._sdpa_blocked(tq, tk, tv, causal=causal, window=window,
                              block=block)
        want = JL._sdpa_blocked(jq, jk, jv, causal=causal, window=window,
                                block=block)
        off = np.abs(_np(got) - _np(want))
        assert off.max() <= BLOCKED_TOL, float(off.max())
        assert (off > TOL).mean() <= 0.01, float((off > TOL).mean())


@pytest.mark.parametrize("window,s_max", [(0, 16), (8, 8), (8, 16)])
def test_sdpa_decode_matches(window, s_max):
    """Per-row depths; with window 8 and s_max 8 the cache is a ring and
    rows past 8 tokens have wrapped."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((4, 1, 4, 16)).astype(np.float32)
    ck = rng.standard_normal((4, s_max, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((4, s_max, 2, 16)).astype(np.float32)
    lens = np.array([0, 3, 7, 12], np.int32)
    got = L._sdpa_decode(torch.from_numpy(q), torch.from_numpy(ck),
                         torch.from_numpy(cv), torch.from_numpy(lens), window)
    want = JL._sdpa_decode(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                           jnp.asarray(lens), window)
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ["minitron-4b", "seamless-m4t-medium"])
def test_apply_mlp_matches(arch):
    """swiglu, and gelu with the tanh approximation (jax.nn.gelu's
    default)."""
    cfg, jcfg = smoke_config(arch), j_smoke(arch)
    jp = j_init(JL.mlp_spec(jcfg), jax.random.PRNGKey(5), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(5).standard_normal((2, 8, 64)).astype(
        np.float32) * 2
    got = L.apply_mlp(tp, cfg, torch.from_numpy(x))
    want = JL.apply_mlp(jp, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL, rtol=TOL)


# ---------------------------------------------------------- forward, decode


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match(arch):
    """torch / auto (the plain version on CPU tensors) against JAX's xla
    and pallas (interpret) at T = 128, and blocked against blocked."""
    jcfg, jp, tp = _params(arch)
    cfg = smoke_config(arch)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 128))
    jt, tt = jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)
    want = {impl: _np(JT.forward(jp, jcfg, {"tokens": jt},
                                 attn_impl=impl)[0])
            for impl in ("xla", "pallas", "blocked")}
    for impl in ("torch", "auto"):
        got = _np(T.forward(tp, cfg, {"tokens": tt}, attn_impl=impl)[0])
        for w in ("xla", "pallas"):
            np.testing.assert_allclose(got, want[w], atol=TOL, rtol=0)
    got = _np(T.prefill(tp, cfg, {"tokens": tt}, 128, attn_impl="blocked"))
    np.testing.assert_allclose(got, want["blocked"], atol=BLOCKED_TOL, rtol=0)
    prefill = _np(JT.prefill(jp, jcfg, {"tokens": jt}, 128))
    np.testing.assert_allclose(
        _np(T.prefill(tp, cfg, {"tokens": tt}, 128, attn_impl="torch")),
        prefill, atol=TOL, rtol=0)


@pytest.mark.parametrize("arch,max_len", [("minitron-4b", 16),
                                          ("h2o-danube-3-4b", 4),
                                          ("stablelm-1.6b", 16)])
def test_decode_steps_match(arch, max_len):
    """8 decode steps from a fresh cache at per-row depths: logits and the
    whole cache against JAX's.  danube3 at max_len 4 (window 32) keeps a
    ring of 4 slots that wraps twice."""
    jcfg, jp, tp = _params(arch, seed=1)
    cfg = smoke_config(arch)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    jc = JT.init_cache(jcfg, 2, max_len, jnp.float32)
    tc = T.init_cache(cfg, 2, max_len, torch.float32, device="cpu")
    # row 1 starts two tokens deeper, as continuous batching mixes depths
    jc = jc._replace(length=jnp.asarray([0, 2], jnp.int32))
    tc = tc._replace(length=torch.tensor([0, 2], dtype=torch.int32))
    for i in range(8):
        jl, jc = JT.decode_step(jp, jcfg, jc, jnp.asarray(toks[:, i:i + 1],
                                                          jnp.int32))
        tl, tc = T.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(tl), _np(jl), atol=TOL, rtol=0)
        for a, b in zip(tc.kv, jc.kv):
            np.testing.assert_allclose(_np(a), _np(b), atol=TOL, rtol=0)
        np.testing.assert_array_equal(_np(tc.length), _np(jc.length))


def test_prefill_decode_consistency_dense():
    """The last forward logits equal 8 sequential decode steps."""
    cfg = smoke_config("minitron-4b")
    _, _, tp = _params("minitron-4b")
    toks = torch.from_numpy(
        np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 8)))
    fwd, _ = T.forward(tp, cfg, {"tokens": toks}, attn_impl="torch")
    cache = T.init_cache(cfg, 1, 16, torch.float32, device="cpu")
    for i in range(8):
        dec, cache = T.decode_step(tp, cfg, cache, toks[:, i:i + 1])
        torch.testing.assert_close(dec[0], fwd[0, i], atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch", [a for a in J_ARCH_IDS
                                  if j_get(a).family != "dense"])
def test_non_dense_families_raise_naming_a14(arch):
    cfg = smoke_config(arch)
    params = {"embed": {"tok": torch.zeros(cfg.vocab_size, cfg.d_model)}}
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="A14"):
        T.forward(params, cfg, {"tokens": toks})
    with pytest.raises(NotImplementedError, match="A14"):
        T.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    assert T.model_spec(cfg)  # the spec tree exists for every family


def test_unknown_attn_impl_raises():
    cfg = smoke_config("minitron-4b")
    _, _, tp = _params("minitron-4b")
    with pytest.raises(ValueError, match="unknown attn_impl"):
        T.forward(tp, cfg, {"tokens": torch.zeros((1, 4), dtype=torch.int64)},
                  attn_impl="pallas")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    cfg = smoke_config("minitron-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(T.model_spec(cfg), 0, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({"w": np.zeros(3, np.float32)})
