"""Kernel B5's plain version and its GQA wrapper against the JAX package on
the CPU: the port's ``attention_ref`` and ``multihead_attention(impl=
"torch")`` against JAX's ``attention_ref`` and ``flash_attention_pallas``
(interpret mode), on numpy-made inputs.

Tolerances: f32 2e-5, the JAX tests' own for the Pallas kernel against its
reference (the sums run in another order).  bf16: both sides compute in
f32 from the same bf16 inputs and round once, so outputs may differ by one
bf16 step where the f32 values straddle a rounding boundary; the bound is
one step at the larger magnitude plus 1e-6 (outputs that cancel to near
zero), on at most 0.5 % of the elements (measured: 0.02 %).  The CUDA
kernel itself is held against ``attention_ref`` on the card in
tests/test_torch_cuda.py and in chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ops import multihead_attention as j_mha
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_cuda, tile_plan)
from repro_torch.kernels.flash_attention.ops import multihead_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import _sdpa_xla

F32_TOL = 2e-5


def bf16_step(x):
    """The spacing of bf16 values at magnitude |x| (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def _qkv(seed, bh, bkv, s_q, s_kv, d, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, s_q, d)).astype(dtype),
            rng.standard_normal((bkv, s_kv, d)).astype(dtype),
            rng.standard_normal((bkv, s_kv, d)).astype(dtype))


def _both(q, k, v, jdtype=jnp.float32, tdtype=torch.float32, **kw):
    """(port attention_ref, JAX Pallas kernel, JAX attention_ref) as f32
    numpy arrays."""
    tq, tk, tv = (torch.from_numpy(x).to(tdtype) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x, jdtype) for x in (q, k, v))
    port = attention_ref(tq, tk, tv, **kw).float().numpy()
    pallas = np.asarray(flash_attention_pallas(jq, jk, jv, **kw), np.float32)
    ref = np.asarray(j_ref(jq, jk, jv, **kw), np.float32)
    return port, pallas, ref


@pytest.mark.parametrize("bh,bkv,s,d", [(2, 2, 128, 128), (4, 2, 256, 128),
                                        (4, 1, 256, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_matches_jax_f32(bh, bkv, s, d, causal):
    port, pallas, ref = _both(*_qkv(bh * s + d, bh, bkv, s, s, d),
                              causal=causal)
    np.testing.assert_allclose(port, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(port, ref, atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("d", [64, 120])
@pytest.mark.parametrize("window", [0, 64])
def test_ref_matches_jax_head_dims_and_window(d, window):
    """danube3's head dim 120 (not a multiple of 16) and stablelm's 64,
    GQA group 2, with and without a sliding window."""
    port, pallas, ref = _both(*_qkv(d + window, 4, 2, 256, 256, d),
                              causal=True, window=window)
    np.testing.assert_allclose(port, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(port, ref, atol=F32_TOL, rtol=F32_TOL)


def test_ref_matches_jax_bf16():
    q, k, v = _qkv(7, 2, 2, 128, 128, 128)
    port, pallas, ref = _both(q, k, v, jdtype=jnp.bfloat16,
                              tdtype=torch.bfloat16, causal=True)
    for other in (pallas, ref):
        off = np.abs(port - other)
        step = bf16_step(np.maximum(np.abs(port), np.abs(other)))
        assert (off <= step + 1e-6).all(), float((off - step).max())
        assert (off > 0).mean() <= 5e-3, float((off > 0).mean())


def test_fully_masked_rows_give_the_mean_of_v():
    """Sq > Skv + window: rows 191..255 have no live key (causal, window
    64, Skv 128), so every key gets p = exp(0) = 1 and the row is mean(v),
    in the Pallas kernel and in both references -- not zeros."""
    q, k, v = _qkv(3, 2, 1, 256, 128, 64)
    port, pallas, ref = _both(q, k, v, causal=True, window=64)
    np.testing.assert_allclose(port, pallas, atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(port, ref, atol=F32_TOL, rtol=F32_TOL)
    mean_v = v.mean(axis=1)                       # [1, 64]
    for b in range(2):
        np.testing.assert_allclose(port[b, 191:], np.broadcast_to(
            mean_v[0], (65, 64)), atol=1e-6)
        assert np.abs(port[b, :191] - mean_v[0]).max() > 1e-2


@pytest.mark.parametrize("h,kvh,d,window", [(4, 2, 64, 0), (4, 1, 120, 64),
                                            (4, 4, 64, 0)])
def test_multihead_wrapper_matches_jax(h, kvh, d, window):
    """The [B, S, H, D] wrapper's head layout (q head b*H + h reads KV
    head b*KVH + h // group) against JAX's, with impl torch and auto on
    CPU tensors, against JAX's xla and pallas impls."""
    rng = np.random.default_rng(h * d + kvh)
    q = rng.standard_normal((2, 256, h, d)).astype(np.float32)
    k = rng.standard_normal((2, 256, kvh, d)).astype(np.float32)
    v = rng.standard_normal((2, 256, kvh, d)).astype(np.float32)
    want = [np.asarray(j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, window=window, impl=impl))
            for impl in ("xla", "pallas")]
    for impl in ("torch", "auto"):
        got = multihead_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=True,
                                  window=window, impl=impl).numpy()
        for w in want:
            np.testing.assert_allclose(got, w, atol=F32_TOL, rtol=F32_TOL)


def test_batch_one_layout_is_contiguous():
    """At B == 1 the head reshape is a strided view; the wrapper hands the
    kernel contiguous tensors all the same."""
    q = torch.randn(1, 128, 4, 16)
    k = torch.randn(1, 128, 2, 16)
    got = multihead_attention(q, k, k, impl="torch")
    want = _sdpa_xla(q, k, k, causal=True, window=0)
    torch.testing.assert_close(got, want, atol=F32_TOL, rtol=F32_TOL)


def test_cuda_impl_refuses_cpu_tensors():
    q = torch.zeros(2, 128, 4, 16)
    k = torch.zeros(2, 128, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        multihead_attention(q, k, k, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(torch.zeros(4, 128, 16), torch.zeros(2, 128, 16),
                             torch.zeros(2, 128, 16))
    with pytest.raises(ValueError, match="unknown impl"):
        multihead_attention(q, k, k, impl="pallas")


@pytest.mark.parametrize("s_q,s_kv", [(100, 128), (128, 64), (0, 128)])
def test_sequence_not_a_multiple_of_128_raises(s_q, s_kv):
    with pytest.raises(ValueError, match="multiple of 128"):
        flash_attention_cuda(torch.zeros(2, s_q, 16), torch.zeros(2, s_kv, 16),
                             torch.zeros(2, s_kv, 16))


def test_wrapper_refuses_bad_layouts():
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(torch.zeros(2, 16, 128).transpose(1, 2),
                             torch.zeros(2, 128, 16), torch.zeros(2, 128, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention_cuda(torch.zeros(3, 128, 16), torch.zeros(2, 128, 16),
                             torch.zeros(2, 128, 16))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(torch.zeros(2, 128, 264),
                             torch.zeros(2, 128, 264),
                             torch.zeros(2, 128, 264))
    with pytest.raises(ValueError, match="f32 or bf16"):
        flash_attention_cuda(torch.zeros(2, 128, 16, dtype=torch.float16),
                             torch.zeros(2, 128, 16, dtype=torch.float16),
                             torch.zeros(2, 128, 16, dtype=torch.float16))


SMEM_LIMIT = 232_448    # shared memory one block may use on an H100 (227 KB)
# the tensor-core instance's tiles by head dim: (d, padded, KV tile)
TC_PLANS = [(8, 64, 64), (64, 64, 64), (120, 128, 64), (128, 128, 64),
            (136, 192, 64), (192, 192, 64), (200, 256, 32), (256, 256, 32)]


@pytest.mark.parametrize("d,pad,kv", TC_PLANS)
def test_tile_plan_puts_bf16_rows_of_16_byte_multiples_on_the_tensor_cores(
        d, pad, kv):
    plan = tile_plan(d, torch.bfloat16)
    assert (plan.instance, plan.head_pad, plan.q_tile, plan.kv_tile,
            plan.p_terms) == ("tensor_core", pad, 128, kv, 3)
    # q, three K+V stages of 128-byte rows, the barriers and the alignment
    assert plan.smem_bytes == pad // 64 * 128 * (128 + 6 * kv) + 56 + 1024
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("d,dtype,pad", [
    (1, torch.bfloat16, 64), (36, torch.bfloat16, 64),
    (100, torch.bfloat16, 128), (250, torch.bfloat16, 256),
    (64, torch.float32, 64), (120, torch.float32, 128),
    (128, torch.float32, 128), (256, torch.float32, 256)])
def test_tile_plan_keeps_f32_and_unaligned_bf16_rows_on_the_cuda_cores(
        d, dtype, pad):
    plan = tile_plan(d, dtype)
    assert (plan.instance, plan.head_pad, plan.q_tile, plan.kv_tile,
            plan.p_terms) == ("cuda_core", pad, 64, 32, 0)
    assert plan.smem_bytes <= SMEM_LIMIT


def test_tile_plan_refuses_what_no_instance_takes():
    for d in (0, 257):
        with pytest.raises(ValueError, match="head dim"):
            tile_plan(d, torch.bfloat16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tile_plan(64, torch.float16)


@pytest.mark.parametrize("terms,worst", [(1, 2.0 ** -8), (2, 2.0 ** -17),
                                         (3, 0.0)])
def test_bf16_terms_of_p_carry_f32(terms, worst):
    """The tensor-core instance adds p . v as bf16 terms of p, each the
    rounding of what the terms before it leave: one term errs by up to
    2^-8 of p, two by 2^-17, and three give p back exactly (p >= 2^-100),
    which is why it takes three."""
    rng = np.random.default_rng(3)
    p = torch.from_numpy(np.concatenate([
        rng.random(200_000), np.exp2(-100 * rng.random(100_000)),
        [1.0, 1.0 - 2.0 ** -24]]).astype(np.float32))
    rest, total = p.clone(), torch.zeros_like(p, dtype=torch.float64)
    for _ in range(terms):
        term = rest.to(torch.bfloat16).float()
        total += term.double()
        rest = rest - term
    rel = ((total - p.double()).abs() / p.double()).max()
    assert float(rel) <= worst
