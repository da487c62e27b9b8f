"""Assigned architecture registry: ``get_config(arch_id)`` + reduced smokes.

One module per architecture (``configs/<arch>.py``), each exposing
``CONFIG`` with the exact assigned hyperparameters; ``smoke_config`` shrinks
the same family for 1-CPU tests.  The counterpart of
``repro/configs/registry.py``; the port runs minitron-4b at full size on the
card (``chip_smoke.py``).
"""
from __future__ import annotations

import dataclasses

from .base import ModelConfig
from . import (qwen1_5_110b, minitron_4b, stablelm_1_6b, h2o_danube3_4b,
               llava_next_34b, seamless_m4t_medium, zamba2_1_2b, olmoe_1b_7b,
               kimi_k2_1t, falcon_mamba_7b)

_MODULES = [qwen1_5_110b, minitron_4b, stablelm_1_6b, h2o_danube3_4b,
            llava_next_34b, seamless_m4t_medium, zamba2_1_2b, olmoe_1b_7b,
            kimi_k2_1t, falcon_mamba_7b]

_REGISTRY: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_IDS = list(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; have {ARCH_IDS}")
    return _REGISTRY[arch_id]


def smoke_config(arch_id: str) -> ModelConfig:
    """Reduced same-family config for 1-CPU smoke tests."""
    full = get_config(arch_id)
    kw = dict(
        name=full.name + "-smoke",
        num_layers=2 if full.family != "hybrid" else 4,
        d_model=64, d_ff=128 if full.d_ff else 0, vocab_size=512,
        num_heads=4 if full.num_heads > 1 else 1,
        num_kv_heads=(2 if 1 < full.num_kv_heads < full.num_heads else
                      (4 if full.num_kv_heads == full.num_heads
                       and full.num_heads > 1 else 1)),
        head_dim=16 if full.hd else 0,
        encoder_layers=2 if full.encoder_layers else 0,
        sliding_window=32 if full.sliding_window else 0,
        num_experts=8 if full.num_experts else 0,
        num_experts_per_tok=2 if full.num_experts_per_tok else 0,
        ssm_state=8 if full.ssm_state else 0,
        attn_every=2 if full.attn_every else 0,
        frontend_len=8 if full.frontend_len else 0,
        dtype="float32", remat="none",
    )
    return dataclasses.replace(full, **kw)
