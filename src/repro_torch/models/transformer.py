"""Family-dispatched backbone: spec trees for every family, and prefill and
decode for the dense decoder.

The counterpart of ``repro/models/transformer.py``.  ``model_spec`` builds
every family's parameter tree, so ``ModelConfig.param_count`` agrees with
the reference for all ten configurations.  The entry points

  * ``forward`` / ``prefill`` -- the full-sequence pass producing logits;
  * ``init_cache`` / ``decode_step`` -- one-token serving steps over the KV
    cache

run the ``dense`` family.  MoE, SSM, hybrid, encoder-decoder and VLM
apply functions raise naming ROADMAP A14b, which also holds training
(the reference's ``loss_fn``).

Repeated layers are stacked on a leading 'layers' axis as in the
reference; its ``lax.scan`` over them is a Python loop over the same
stacked tensors here.
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


def _require_dense(cfg: ModelConfig, what: str) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{what} for the {cfg.family!r} family ({cfg.name}) is not "
            f"ported yet (ROADMAP A14b); the port runs the dense family")


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


# --------------------------------------------------------------- forward


def forward(params, cfg: ModelConfig, batch: dict, *, attn_impl="auto"):
    """Prefill forward -> (logits_on_tokens, aux_metrics).

    batch: tokens [B, T] (an integer tensor on the parameters' device).
    ``attn_impl`` as ``layers.apply_attention``: on CUDA tensors ``"auto"``
    runs kernel B5 once per layer.
    """
    _require_dense(cfg, "forward")
    tokens = batch["tokens"]
    x = L.embed_tokens(params["embed"], tokens)
    for i in range(cfg.num_layers):
        x, _ = _apply_dense_block(_layer(params["layers"], i), cfg, x,
                                  attn_impl=attn_impl)
    x = L.apply_norm(params["final_norm"], x)
    logits = L.lm_logits(params["embed"], cfg, x)
    return logits, {"aux_loss": torch.zeros((), device=logits.device)}


# ----------------------------------------------------------- decode path


class DecodeCache(NamedTuple):
    """The dense family's cache: kv = (k, v) stacked [L, B, S, KVH, hd],
    length [B] int32 (per-row depth).  The reference's ``ssm`` and ``enc``
    fields come with their families (ROADMAP A14b)."""
    kv: Any = None
    length: torch.Tensor = None


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
               device="cuda") -> DecodeCache:
    _require_dense(cfg, "init_cache")
    device = resolve_device(device)
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (cfg.num_layers, batch, s, cfg.num_kv_heads, cfg.hd)
    return DecodeCache(
        kv=(torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device)),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def decode_step(params, cfg: ModelConfig, cache: DecodeCache,
                tokens: torch.Tensor):
    """tokens [B, 1] -> (logits [B, V], new_cache). One serving step.

    The new cache's kv tensors are new tensors (each layer's slot write is
    out of place, then the layers are stacked), so ``cache`` stays valid
    for ``serving.engine.blend_cache``.
    """
    _require_dense(cfg, "decode_step")
    x = L.embed_tokens(params["embed"], tokens)
    clen = cache.length
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, (k, v) = _apply_dense_block(
            _layer(params["layers"], i), cfg, x,
            kv_cache=(cache.kv[0][i], cache.kv[1][i]), cache_len=clen)
        ks.append(k)
        vs.append(v)
    new_cache = cache._replace(kv=(torch.stack(ks), torch.stack(vs)),
                               length=clen + 1)
    x = L.apply_norm(params["final_norm"], x)
    logits = L.lm_logits(params["embed"], cfg, x[:, 0])
    return logits, new_cache


def prefill(params, cfg: ModelConfig, batch: dict, max_len: int, *,
            attn_impl="auto"):
    """Forward over the prompt; returns the logits of every position, as
    the reference's ``prefill`` does (its cache is rebuilt by decode)."""
    logits, _ = forward(params, cfg, batch, attn_impl=attn_impl)
    return logits
