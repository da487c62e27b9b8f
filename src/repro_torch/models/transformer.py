"""Family-dispatched backbone: decoder-only dense / VLM / MoE, SSM, hybrid,
encoder-decoder.

The counterpart of ``repro/models/transformer.py``, with its spec trees
for every family and its serving entry points for every family:

  * ``forward`` / ``prefill`` -- the full-sequence pass producing logits
    (MoE adds its layers' load-balance aux losses; the VLM prefix of patch
    embeddings is cut from the logits; the encoder-decoder encodes its
    frames first);
  * ``init_cache`` / ``decode_step`` -- one-token serving steps over the
    family's cache (KV, the SSM's conv and state, the encoder's K and V).

Training (the reference's ``loss_fn`` and its ``_remat``) waits for ROADMAP
A14b's training part.

Repeated layers are stacked on a leading 'layers' axis as in the
reference; its ``lax.scan`` over them is a Python loop over the same
stacked tensors here.  ``attn_impl`` reaches every causal self-attention
of a prefill (on CUDA tensors ``"auto"`` runs kernel B5): the dense, MoE
and VLM layers, the hybrid's shared block and the encoder-decoder's
decoder layers, whose self-attention the reference always runs on its
einsum path.  The encoder's bidirectional attention and the
cross-attention stay plain (``_sdpa_xla``), as in the reference.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..configs.base import ModelConfig
from ..core.backend import resolve_device
from . import layers as L
from . import moe as M
from . import ssm as S
from .params import stack_layers, tree_map

# ------------------------------------------------------------ spec trees


def block_spec(cfg: ModelConfig, kind: str):
    """kind: dense | moe | mamba | encdec_dec (self+cross attn)."""
    if kind == "mamba":
        return {"norm": L.norm_spec(cfg), "mamba": S.mamba_spec(cfg)}
    spec = {
        "norm1": L.norm_spec(cfg),
        "attn": L.attention_spec(cfg),
        "norm2": L.norm_spec(cfg),
    }
    if kind == "moe":
        spec["moe"] = M.moe_spec(cfg)
    else:
        spec["mlp"] = L.mlp_spec(cfg)
    if kind == "encdec_dec":
        spec["norm_x"] = L.norm_spec(cfg)
        spec["xattn"] = L.attention_spec(cfg)
    return spec


def model_spec(cfg: ModelConfig):
    spec: dict = {"embed": L.embedding_spec(cfg),
                  "final_norm": L.norm_spec(cfg)}
    fam = cfg.family
    if fam in ("dense", "vlm"):
        spec["layers"] = stack_layers(block_spec(cfg, "dense"), cfg.num_layers)
    elif fam == "moe":
        spec["layers"] = stack_layers(block_spec(cfg, "moe"), cfg.num_layers)
    elif fam == "ssm":
        spec["layers"] = stack_layers(block_spec(cfg, "mamba"), cfg.num_layers)
    elif fam == "hybrid":
        spec["layers"] = stack_layers(block_spec(cfg, "mamba"), cfg.num_layers)
        spec["shared"] = block_spec(cfg, "dense")   # one shared attn block
    elif fam == "encdec":
        spec["enc_layers"] = stack_layers(block_spec(cfg, "dense"),
                                          cfg.encoder_layers)
        spec["layers"] = stack_layers(block_spec(cfg, "encdec_dec"),
                                      cfg.num_layers)
    else:
        raise ValueError(fam)
    return spec


def _layer(stacked, i: int):
    """Layer ``i`` of a stacked [L, ...] parameter tree (views, no copy)."""
    return tree_map(lambda a: a[i], stacked)


# ----------------------------------------------------------- block apply


def _apply_dense_block(p, cfg, x, *, attn_impl="auto", kv_cache=None,
                       cache_len=None, positions=None):
    h, new_kv = L.apply_attention(
        p["attn"], cfg, L.apply_norm(p["norm1"], x), positions=positions,
        attn_impl=attn_impl, kv_cache=kv_cache, cache_len=cache_len)
    x = x + h
    x = x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["norm2"], x))
    return x, new_kv


def _apply_moe_block(p, cfg, x, *, attn_impl="auto", kv_cache=None,
                     cache_len=None):
    h, new_kv = L.apply_attention(
        p["attn"], cfg, L.apply_norm(p["norm1"], x),
        attn_impl=attn_impl, kv_cache=kv_cache, cache_len=cache_len)
    x = x + h
    y, aux = M.apply_moe(p["moe"], cfg, L.apply_norm(p["norm2"], x))
    return x + y, new_kv, aux


def _apply_mamba_block(p, cfg, x, *, cache=None):
    h, new_cache = S.apply_mamba(p["mamba"], cfg,
                                 L.apply_norm(p["norm"], x), cache=cache)
    return x + h, new_cache


def _apply_xattn_block(p, cfg, x, enc_kv, *, attn_impl="auto",
                       kv_cache=None, cache_len=None):
    """Encoder-decoder decoder block: self-attn, cross-attn, mlp."""
    h, new_kv = L.apply_attention(
        p["attn"], cfg, L.apply_norm(p["norm1"], x), attn_impl=attn_impl,
        kv_cache=kv_cache, cache_len=cache_len)
    x = x + h
    # cross attention: q from x, kv precomputed from the encoder's output
    xq = L.apply_norm(p["norm_x"], x)
    b, t, _ = xq.shape
    q = (xq @ p["xattn"]["wq"]).reshape(b, t, cfg.num_heads, cfg.hd)
    ek, ev = enc_kv
    o = L._sdpa_xla(q, ek, ev, causal=False, window=0)
    x = x + o.reshape(b, t, -1) @ p["xattn"]["wo"]
    x = x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["norm2"], x))
    return x, new_kv


def _groups(cfg: ModelConfig) -> tuple:
    """The hybrid's (groups, mamba layers a group): ``attn_every`` mamba
    layers, then the shared attention block."""
    every = cfg.attn_every or cfg.num_layers
    return cfg.num_layers // every, every


# --------------------------------------------------------------- forward


def forward(params, cfg: ModelConfig, batch: dict, *, attn_impl="auto"):
    """Prefill forward -> (logits_on_tokens, aux_metrics).

    batch: tokens [B, T_text] (an integer tensor on the parameters'
    device); vlm: + patch_emb [B, P, d]; encdec: + frames [B, S_enc, d].
    ``attn_impl`` as ``layers.apply_attention`` (see the module note).
    """
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens)
    n_prefix = 0
    if cfg.family == "vlm" and "patch_emb" in batch:
        x = torch.cat([batch["patch_emb"].to(x.dtype), x], dim=1)
        n_prefix = batch["patch_emb"].shape[1]

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    fam = cfg.family
    layers = params["layers"]
    if fam in ("dense", "vlm"):
        for i in range(cfg.num_layers):
            x, _ = _apply_dense_block(_layer(layers, i), cfg, x,
                                      attn_impl=attn_impl)
    elif fam == "moe":
        for i in range(cfg.num_layers):
            x, _, m = _apply_moe_block(_layer(layers, i), cfg, x,
                                       attn_impl=attn_impl)
            aux_total = aux_total + m["aux_loss"]
    elif fam == "ssm":
        for i in range(cfg.num_layers):
            x, _ = _apply_mamba_block(_layer(layers, i), cfg, x)
    elif fam == "hybrid":
        x = _hybrid_forward(params, cfg, x, attn_impl=attn_impl)
    elif fam == "encdec":
        enc_kv = _encode(params, cfg, batch["frames"])
        for i in range(cfg.num_layers):
            x, _ = _apply_xattn_block(_layer(layers, i), cfg, x, enc_kv,
                                      attn_impl=attn_impl)
    else:
        raise ValueError(fam)

    x = L.apply_norm(params["final_norm"], x)
    if n_prefix:
        x = x[:, n_prefix:]
    logits = L.lm_logits(params["embed"], cfg, x)
    return logits, {"aux_loss": aux_total}


def _hybrid_forward(params, cfg, x, *, attn_impl="auto"):
    """zamba2: groups of `attn_every` mamba layers + one shared attn block."""
    n_groups, every = _groups(cfg)
    for g in range(n_groups):
        for i in range(g * every, (g + 1) * every):
            x, _ = _apply_mamba_block(_layer(params["layers"], i), cfg, x)
        x, _ = _apply_dense_block(params["shared"], cfg, x,
                                  attn_impl=attn_impl)
    return x


def _encode(params, cfg, frames):
    """Encoder over stub frame embeddings -> cross-attn (k, v).

    A bidirectional encoder on the plain einsum attention (no RoPE, as the
    reference's).  Every decoder layer attends to one K and V, projected
    with layer 0's cross-attention weights: the reference's simplification,
    which keeps the cache single.
    """
    x = frames.to(getattr(torch, cfg.dtype))
    enc = params["enc_layers"]
    for i in range(cfg.encoder_layers):
        p = _layer(enc, i)
        xq = L.apply_norm(p["norm1"], x)
        q, k, v = L._project_qkv(p["attn"], cfg, xq)
        o = L._sdpa_xla(q, k, v, causal=False, window=0)
        x = x + o.reshape(x.shape[0], x.shape[1], -1) @ p["attn"]["wo"]
        x = x + L.apply_mlp(p["mlp"], cfg, L.apply_norm(p["norm2"], x))
    p0 = _layer(params["layers"], 0)
    b, s, _ = x.shape
    ek = (x @ p0["xattn"]["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.hd)
    ev = (x @ p0["xattn"]["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.hd)
    return ek, ev


# ----------------------------------------------------------- decode path


class DecodeCache(NamedTuple):
    """Family-polymorphic cache.

    dense/moe/vlm : kv = (k, v) stacked [L, B, S, KVH, hd]
    ssm           : ssm = SSMCache with [L, ...] leaves
    hybrid        : ssm [L, ...] + kv per shared-block invocation [G, ...]
    encdec        : kv (self) [L, ...] + enc (ek, ev) [B, S_enc, KVH, hd]
    length [B] int32: each row's depth.
    """
    kv: Any = None
    ssm: Any = None
    enc: Any = None
    length: torch.Tensor = None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cuda") -> DecodeCache:
    device = resolve_device(device)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    kvh, hd = cfg.num_kv_heads, cfg.hd

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    def kv(n):
        return zeros(n, batch, s, kvh, hd), zeros(n, batch, s, kvh, hd)

    def ssm():
        return S.SSMCache(
            conv=zeros(cfg.num_layers, batch, cfg.ssm_conv - 1, cfg.d_inner),
            state=zeros(cfg.num_layers, batch, cfg.d_inner, cfg.ssm_state,
                        dt=torch.float32))

    length = zeros(batch, dt=torch.int32)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return DecodeCache(kv=kv(cfg.num_layers), length=length)
    if fam == "ssm":
        return DecodeCache(ssm=ssm(), length=length)
    if fam == "hybrid":
        return DecodeCache(ssm=ssm(), kv=kv(_groups(cfg)[0]), length=length)
    if fam == "encdec":
        enc = (zeros(batch, cfg.frontend_len, kvh, hd),
               zeros(batch, cfg.frontend_len, kvh, hd))
        return DecodeCache(kv=kv(cfg.num_layers), enc=enc, length=length)
    raise ValueError(fam)


def _stack(pairs) -> tuple:
    """[(k, v), ...] per layer -> (k, v) stacked on a new leading axis."""
    return tuple(torch.stack(leaves) for leaves in zip(*pairs))


def decode_step(params, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor):
    """tokens [B, 1] -> (logits [B, V], new_cache). One serving step.

    The new cache's kv and ssm leaves are new tensors (each layer's update
    is out of place, then the layers are stacked), so ``cache`` stays
    valid for ``serving.engine.blend_cache``.
    """
    x = L.embed_tokens(params["embed"], tokens)
    fam = cfg.family
    clen = cache.length
    layers = params["layers"]

    def layer_kv(i):
        return cache.kv[0][i], cache.kv[1][i]

    def mamba(x, i):
        return _apply_mamba_block(
            _layer(layers, i), cfg, x,
            cache=S.SSMCache(cache.ssm.conv[i], cache.ssm.state[i]))

    if fam in ("dense", "vlm", "moe"):
        kvs = []
        for i in range(cfg.num_layers):
            if fam == "moe":
                x, new_kv, _ = _apply_moe_block(
                    _layer(layers, i), cfg, x, kv_cache=layer_kv(i),
                    cache_len=clen)
            else:
                x, new_kv = _apply_dense_block(
                    _layer(layers, i), cfg, x, kv_cache=layer_kv(i),
                    cache_len=clen)
            kvs.append(new_kv)
        new_cache = cache._replace(kv=_stack(kvs), length=clen + 1)
    elif fam == "ssm":
        ssms = []
        for i in range(cfg.num_layers):
            x, c = mamba(x, i)
            ssms.append(c)
        new_cache = cache._replace(ssm=S.SSMCache(*_stack(ssms)),
                                   length=clen + 1)
    elif fam == "hybrid":
        n_groups, every = _groups(cfg)
        ssms, kvs = [], []
        for g in range(n_groups):
            for i in range(g * every, (g + 1) * every):
                x, c = mamba(x, i)
                ssms.append(c)
            x, new_kv = _apply_dense_block(
                params["shared"], cfg, x, kv_cache=layer_kv(g),
                cache_len=clen)
            kvs.append(new_kv)
        new_cache = cache._replace(ssm=S.SSMCache(*_stack(ssms)),
                                   kv=_stack(kvs), length=clen + 1)
    elif fam == "encdec":
        kvs = []
        for i in range(cfg.num_layers):
            x, new_kv = _apply_xattn_block(
                _layer(layers, i), cfg, x, cache.enc, kv_cache=layer_kv(i),
                cache_len=clen)
            kvs.append(new_kv)
        new_cache = cache._replace(kv=_stack(kvs), length=clen + 1)
    else:
        raise ValueError(fam)

    x = L.apply_norm(params["final_norm"], x)
    logits = L.lm_logits(params["embed"], cfg, x[:, 0])
    return logits, new_cache


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int, *,
            attn_impl="auto"):
    """Forward over the prompt; returns the logits of every position, as
    the reference's ``prefill`` does (its cache is rebuilt by decode)."""
    logits, _ = forward(params, cfg, batch, attn_impl=attn_impl)
    return logits
