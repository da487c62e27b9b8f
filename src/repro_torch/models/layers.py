"""Transformer building blocks: norms, RoPE, GQA attention (bias/SWA), MLP.

The counterpart of ``repro/models/layers.py``.  Params are nested dicts of
tensors produced from the spec trees in this module.  Prefill attention
dispatches on ``attn_impl``:

  * ``"torch"``   -- ``_sdpa_xla``, the einsum path (the reference's ``"xla"``);
  * ``"blocked"`` -- ``_sdpa_blocked``, the block-skipping path;
  * ``"cuda"``    -- kernel B5 through ``multihead_attention(impl="cuda")``
    (the reference's ``"pallas"``); needs CUDA tensors;
  * ``"auto"``    -- B5 for CUDA tensors, its plain version for CPU tensors.

Where the reference takes a dot of bf16 operands with
``preferred_element_type=f32``, the port upcasts the operands to f32 and
multiplies in f32: a product of two bf16 values is exact in f32, so the two
agree up to the order of the sums, and the result is f32 as in the
reference (a bf16 ``torch.matmul`` would return bf16).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention.ops import multihead_attention
from .params import P

ATTN_IMPLS = ("torch", "blocked", "cuda", "auto")
NEG_INF = -1e30

# ----------------------------------------------------------------- norms


def norm_spec(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return {"scale": P((cfg.d_model,), (None,), "ones"),
                "bias": P((cfg.d_model,), (None,), "zeros")}
    return {"scale": P((cfg.d_model,), (None,), "ones")}


def apply_norm(params, x, eps: float = 1e-6):
    xf = x.float()
    if "bias" in params:  # layernorm; jnp.var is the population variance
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * params["scale"] + params["bias"]).to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * params["scale"]).to(x.dtype)


# ------------------------------------------------------------------ rope


def rope_freqs(cfg: ModelConfig, positions: torch.Tensor) -> tuple:
    """positions [*, T] -> (sin, cos) each [*, T, hd/2] f32."""
    half = cfg.hd // 2
    inv = 1.0 / (cfg.rope_theta ** (
        torch.arange(half, dtype=torch.float32, device=positions.device)
        / half))
    ang = positions.float()[..., None] * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor):
    """x [B, T, H, hd]; sin/cos [B, T, hd/2] (broadcast over heads).  A bf16
    x is promoted to f32 by the products, as in the reference, and the
    result cast back."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s, c = sin[..., None, :], cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------- attention


def attention_spec(cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.hd
    h = _eff_heads(cfg)
    spec = {
        "wq": P((d, h * hd), ("fsdp", "tp")),
        "wk": P((d, cfg.num_kv_heads * hd), ("fsdp", "tp")),
        "wv": P((d, cfg.num_kv_heads * hd), ("fsdp", "tp")),
        "wo": P((h * hd, d), ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        spec["bq"] = P((h * hd,), ("tp",), "zeros")
        spec["bk"] = P((cfg.num_kv_heads * hd,), ("tp",), "zeros")
        spec["bv"] = P((cfg.num_kv_heads * hd,), ("tp",), "zeros")
    return spec


def _eff_heads(cfg: ModelConfig) -> int:
    """The q head count, widened to ``pad_heads_to`` where that is set (the
    reference's tensor-parallel alignment variant)."""
    return cfg.pad_heads_to or cfg.num_heads


def _project_qkv(params, cfg: ModelConfig, x):
    b, t, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, t, _eff_heads(cfg), cfg.hd)
    k = k.reshape(b, t, cfg.num_kv_heads, cfg.hd)
    v = v.reshape(b, t, cfg.num_kv_heads, cfg.hd)
    return q, k, v


def _mask(tq: int, tk: int, q_lo, k_lo: int, causal: bool, window: int,
          device):
    q_pos = q_lo + torch.arange(tq, device=device)[:, None]
    k_pos = k_lo + torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    return mask


def _sdpa_xla(q, k, v, *, causal: bool, window: int, q_offset: int = 0):
    """Einsum attention (GQA-aware). q [B,Tq,H,hd]; k/v [B,Tk,KVH,hd].

    ``q_offset``: absolute position of q[0].  Logits, softmax and ``p @ v``
    in f32, as the reference's explicit upcasts.
    """
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, tq, kvh, g, hd)
    s = torch.einsum("btkgd,bskd->bktgs", qg.float(), k.float()) / (hd ** 0.5)
    mask = _mask(tq, tk, q_offset, 0, causal, window, q.device)
    s = torch.where(mask[None, None, :, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bktgs,bskd->btkgd", p, v.float())
    return o.reshape(b, tq, h, hd).to(q.dtype)


def _sdpa_blocked(q, k, v, *, causal: bool, window: int, block: int = 0):
    """Block-tiled attention with causal / sliding-window block skipping,
    bf16 probabilities and f32 running max and sum, as the reference's.
    Dots upcast their operands to f32 (see the module note)."""
    b, tq, h, hd = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    if block <= 0:
        block = max(1024, tq // 8)
    block = min(block, tq, tk)
    nq, nk = -(-tq // block), -(-tk // block)
    scale = 1.0 / (hd ** 0.5)
    qg = q.reshape(b, tq, kvh, g, hd)

    out = []
    for qi in range(nq):
        q_blk = qg[:, qi * block:(qi + 1) * block].float()
        qb = q_blk.shape[1]
        m_run = torch.full((b, kvh, qb, g), -torch.inf, device=q.device)
        l_run = torch.zeros((b, kvh, qb, g), device=q.device)
        acc = torch.zeros((b, kvh, qb, g, hd), device=q.device)
        q_lo, q_hi = qi * block, qi * block + qb - 1
        for ki in range(nk):
            k_lo, k_hi = ki * block, min((ki + 1) * block, tk) - 1
            if causal and k_lo > q_hi:
                continue  # block fully in the future
            if window > 0 and (q_lo - k_hi) >= window:
                continue  # block fully outside the window
            k_blk = k[:, k_lo:k_hi + 1].float()
            v_blk = v[:, k_lo:k_hi + 1].float()
            s = torch.einsum("bqkgd,bskd->bkqgs", q_blk, k_blk) * scale
            mask = _mask(qb, k_blk.shape[1], q_lo, k_lo, causal, window,
                         q.device)
            s = torch.where(mask[None, None, :, None, :], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]).to(torch.bfloat16).float()
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            pv = torch.einsum("bkqgs,bskd->bkqgd", p, v_blk)
            acc = acc * corr[..., None] + pv
            m_run = m_new
        o = acc / torch.clamp(l_run, min=1e-30)[..., None]
        out.append(o.permute(0, 2, 1, 3, 4).reshape(b, qb, h, hd))
    return torch.cat(out, dim=1).to(q.dtype)


def apply_attention(params, cfg: ModelConfig, x, *, positions=None,
                    attn_impl: str = "auto", kv_cache=None, cache_len=None):
    """Full attention sub-layer.

    Prefill: kv_cache=None -> causal self-attention over x through
    ``attn_impl``.  Decode: kv_cache=(k, v) [B, S, KVH, hd] + cache_len
    [B]; x is the single new token's hidden state [B, 1, d].  The cache is
    not written in place: the new cache is a copy with the token's slot
    set, so a caller may still blend it with the old one.
    Returns (out, new_kv_cache).
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {attn_impl!r}; expected one of "
                         f"{ATTN_IMPLS}")
    b, t, _ = x.shape
    if positions is None:
        if kv_cache is not None:
            # cache_len is PER-ROW [B]: continuous batching mixes depths
            positions = cache_len[:, None].to(torch.int32)
        else:
            positions = torch.arange(t, dtype=torch.int32,
                                     device=x.device).expand(b, t)
    q, k, v = _project_qkv(params, cfg, x)
    sin, cos = rope_freqs(cfg, positions)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)

    if kv_cache is not None:
        ck, cv = kv_cache
        s_max = ck.shape[1]
        if cfg.sliding_window > 0 and s_max <= cfg.sliding_window:
            slot = cache_len % s_max              # ring buffer for SWA
        else:
            slot = torch.clamp(cache_len, max=s_max - 1)
        slot = slot.long()
        rows = torch.arange(b, device=x.device)
        ck = ck.index_put((rows, slot), k[:, 0])
        cv = cv.index_put((rows, slot), v[:, 0])
        o = _sdpa_decode(q, ck, cv, cache_len, cfg.sliding_window)
        return o.reshape(b, t, -1) @ params["wo"], (ck, cv)

    if attn_impl in ("cuda", "auto"):
        o = multihead_attention(q, k, v, causal=True,
                                window=cfg.sliding_window, impl=attn_impl)
    elif attn_impl == "blocked":
        o = _sdpa_blocked(q, k, v, causal=True, window=cfg.sliding_window,
                          block=cfg.attn_block)
    else:
        o = _sdpa_xla(q, k, v, causal=True, window=cfg.sliding_window)
    return o.reshape(b, t, -1) @ params["wo"], None


def _sdpa_decode(q, ck, cv, cache_len, window: int):
    """One-token attention over the cache. q [B,1,H,hd], cache [B,S,KVH,hd],
    cache_len [B] (per-row depth).  Probabilities in the cache's type, as
    the reference's; dots upcast to f32 (see the module note)."""
    b, _, h, hd = q.shape
    s, kvh = ck.shape[1], ck.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(),
                          ck.float()) / (hd ** 0.5)
    k_pos = torch.arange(s, device=q.device)[None, None, None, :]
    lens = cache_len[:, None, None, None]
    valid = k_pos <= lens
    if window > 0 and s <= window:
        # ring buffer: every slot is live once the cache has wrapped
        valid = valid | (lens >= s)
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m).to(ck.dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgs,bskd->bkgd", p, cv.float())
    o = o / torch.clamp(l, min=1e-30)
    return o.reshape(b, 1, h, hd).to(q.dtype)


# ------------------------------------------------------------------- mlp


def mlp_spec(cfg: ModelConfig, d_ff: int | None = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": P((d, ff), ("fsdp", "tp")),
            "wg": P((d, ff), ("fsdp", "tp")),
            "wo": P((ff, d), ("tp", "fsdp")),
        }
    return {
        "wi": P((d, ff), ("fsdp", "tp")),
        "wo": P((ff, d), ("tp", "fsdp")),
    }


def apply_mlp(params, cfg: ModelConfig, x):
    if "wg" in params:
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]


# ------------------------------------------------------------- embeddings


def embedding_spec(cfg: ModelConfig):
    spec = {"tok": P((cfg.vocab_size, cfg.d_model), ("tp", "fsdp"),
                     "small_normal", scale=1.0)}
    if not cfg.tie_embeddings:
        spec["head"] = P((cfg.d_model, cfg.vocab_size), ("fsdp", "tp"))
    return spec


def embed_tokens(params, tokens):
    return params["tok"][tokens]


def lm_logits(params, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        return h @ params["tok"].T
    return h @ params["head"]
