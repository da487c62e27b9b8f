"""Mixture-of-Experts parameter spec.

The counterpart of ``repro/models/moe.py``: only ``moe_spec``, so that the
port's ``model_spec`` and ``param_count`` cover MoE configurations.  The
capacity-dispatch apply function waits for ROADMAP A14b.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from .params import P


def moe_spec(cfg: ModelConfig):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": P((d, e), (None, None)),
        "wi": P((e, d, ff), ("expert", "fsdp", None)),
        "wg": P((e, d, ff), ("expert", "fsdp", None)),
        "wo": P((e, ff, d), ("expert", None, "fsdp")),
    }
