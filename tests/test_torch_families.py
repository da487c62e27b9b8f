"""The port's MoE, SSM, hybrid, encoder-decoder and VLM serving paths
against the JAX package on the CPU, at smoke size and in f32, with the
JAX weights carried across by ``params_from_numpy`` (one tree an
architecture, shared by the module's tests) and numpy-made inputs.

Tolerance: logits and cache leaves within 5e-5 of the larger of 1 and the
largest reference value (measured up to 1.8e-5, zamba2's forward at 128
positions; each block alone agrees within 7e-7 of its largest value: the
sums run in another order on the two sides and XLA's ``exp`` differs from
the port's in the last bits, and six blocks, the SSM state over 128 steps
and the final norm carry that further); ``length`` and the tree structure
exactly.  The reference's ``prefill`` is
its forward's logits, so both are held against one JAX forward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS
from repro.configs.registry import get_config as j_get
from repro.configs.registry import smoke_config as j_smoke
from repro.models import transformer as JT
from repro.models.params import init_params as j_init
from repro_torch.configs import smoke_config
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.models.params import init_params

from torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

NON_DENSE = [a for a in J_ARCH_IDS if j_get(a).family != "dense"]
REL = 5e-5
SEQ = 128                    # prompt positions, patches included
# jitted: the reference's eager ops compile again at every new shape
j_forward = jax.jit(JT.forward, static_argnums=(1,),
                    static_argnames=("attn_impl",))
j_decode = jax.jit(JT.decode_step, static_argnums=(1,))
j_encode = jax.jit(JT._encode, static_argnums=(1,))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, what=""):
    want = _np(want)
    tol = REL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol,
                               err_msg=what)


def _batches(cfg, seed):
    """The same prompt for both packages: tokens, and the VLM's patch
    embeddings or the encoder-decoder's frames."""
    rng = np.random.default_rng(seed)
    n_text = SEQ - (cfg.frontend_len if cfg.family == "vlm" else 0)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (2, n_text))}
    if cfg.family == "vlm":
        arrays["patch_emb"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        arrays["frames"] = rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else jnp.float32)
          for k, v in arrays.items()}
    return arrays, jb, {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.fixture(scope="module", params=NON_DENSE)
def fam(request):
    arch = request.param
    jcfg, cfg = j_smoke(arch), smoke_config(arch)
    jp = j_init(JT.model_spec(jcfg), jax.random.PRNGKey(2), jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return arch, jcfg, jp, cfg, tp


def _leaves(cache):
    """Every tensor leaf of a cache but ``length``, in field order."""
    return [leaf for group in (cache.kv, cache.ssm, cache.enc)
            if group is not None for leaf in group]


def _same_cache(tc, jc, what=""):
    want = [leaf for field in ("kv", "ssm", "enc")
            for leaf in jax.tree.leaves(getattr(jc, field))]
    got = _leaves(tc)
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        assert tuple(a.shape) == b.shape, (what, i)
        assert str(a.dtype)[6:] == str(b.dtype), (what, i)
        _close(a, b, f"{what} leaf {i}")
    np.testing.assert_array_equal(_np(tc.length), _np(jc.length))


def test_params_from_numpy_carries_every_tree(fam):
    """Stacked ``layers``, the hybrid's ``shared`` block and the encoder's
    ``enc_layers`` arrive whole: the same paths, shapes and values."""
    _, _, jp, _, tp = fam
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]

    def walk(t, path=()):
        if isinstance(t, dict):
            for k in t:
                yield from walk(t[k], path + (k,))
        else:
            yield path, t

    got = dict(walk(tp))
    assert len(got) == len(jflat)
    for jpath, leaf in jflat:
        x = got[tuple(k.key for k in jpath)]
        assert tuple(x.shape) == leaf.shape
        assert np.array_equal(_np(x), np.asarray(leaf))


def test_forward_and_prefill_match(fam):
    """torch and auto (the plain version on CPU tensors) against JAX's xla
    and pallas (interpret); MoE's aux loss; prefill's logits."""
    arch, jcfg, jp, cfg, tp = fam
    arrays, jb, tb = _batches(cfg, 6)
    want = {impl: j_forward(jp, jcfg, jb, attn_impl=impl)
            for impl in ("xla", "pallas")}
    n_text = arrays["tokens"].shape[1]
    for impl in ("torch", "auto"):
        logits, aux = T.forward(tp, cfg, tb, attn_impl=impl)
        assert tuple(logits.shape) == (2, n_text, cfg.vocab_size)
        for w, (jl, jaux) in want.items():
            _close(logits, jl, f"{arch} {impl} vs {w}")
            assert abs(float(aux["aux_loss"]) - float(jaux["aux_loss"])) \
                <= REL * max(1.0, abs(float(jaux["aux_loss"])))
    if cfg.family == "moe":
        assert float(aux["aux_loss"]) > 0
    _close(T.prefill(tp, cfg, tb, SEQ, attn_impl="auto"), want["xla"][0],
           f"{arch} prefill")


def test_decode_steps_match(fam):
    """8 decode steps from a fresh cache at per-row depths [0, 2]: logits
    and every cache leaf (kv, ssm conv and state, enc, length) after each
    step."""
    arch, jcfg, jp, cfg, tp = fam
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 8))
    jc = JT.init_cache(jcfg, 2, 16, jnp.float32)
    tc = T.init_cache(cfg, 2, 16, torch.float32, device="cpu")
    _same_cache(tc, jc, f"{arch} fresh")
    jc = jc._replace(length=jnp.asarray([0, 2], jnp.int32))
    tc = tc._replace(length=torch.tensor([0, 2], dtype=torch.int32))
    for i in range(8):
        jl, jc = j_decode(jp, jcfg, jc, jnp.asarray(toks[:, i:i + 1],
                                                    jnp.int32))
        tl, tc = T.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, i:i + 1]))
        _close(tl, jl, f"{arch} step {i}")
        _same_cache(tc, jc, f"{arch} step {i}")


def test_decode_from_a_jax_mid_stream_cache(fam):
    """Three JAX steps (the encoder-decoder's cache holding its encoded
    frames), the cache carried across by ``cache_from_numpy``, then one
    step on each side."""
    arch, jcfg, jp, cfg, tp = fam
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 4))
    jc = JT.init_cache(jcfg, 2, 16, jnp.float32)
    if cfg.family == "encdec":
        frames = np.random.default_rng(9).standard_normal(
            (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        jc = jc._replace(enc=j_encode(jp, jcfg, jnp.asarray(frames)))
    for i in range(3):
        _, jc = j_decode(jp, jcfg, jc, jnp.asarray(toks[:, i:i + 1],
                                                   jnp.int32))
    tc = cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    _same_cache(tc, jc, f"{arch} carried")
    jl, jc = j_decode(jp, jcfg, jc, jnp.asarray(toks[:, 3:], jnp.int32))
    tl, tc = T.decode_step(tp, cfg, tc, torch.from_numpy(toks[:, 3:]))
    _close(tl, jl, f"{arch} step after the carried cache")
    _same_cache(tc, jc, f"{arch} after")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b",
                                  "olmoe-1b-7b"])
def test_prefill_decode_consistency(arch):
    """The recurrence against the scan: forward's logits at each of 8
    positions equal 8 sequential decode steps (atol 1e-4, the reference's
    test_models.py consistency tolerance)."""
    cfg = smoke_config(arch)
    params = init_params(T.model_spec(cfg), 1, torch.float32, device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(10).integers(0, cfg.vocab_size, (1, 8)))
    fwd, _ = T.forward(params, cfg, {"tokens": toks}, attn_impl="torch")
    cache = T.init_cache(cfg, 1, 16, torch.float32, device="cpu")
    for i in range(8):
        dec, cache = T.decode_step(params, cfg, cache, toks[:, i:i + 1])
        torch.testing.assert_close(dec[0], fwd[0, i], atol=1e-4, rtol=0)
    assert int(cache.length) == 8
