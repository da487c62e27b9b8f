"""Selective state-space (Mamba) parameter spec.

The counterpart of ``repro/models/ssm.py``: only ``mamba_spec``, so that
the port's ``model_spec`` and ``param_count`` cover SSM and hybrid
configurations.  The scan and the decode recurrence wait for ROADMAP A14b.
"""
from __future__ import annotations

from ..configs.base import ModelConfig
from .params import P


def mamba_spec(cfg: ModelConfig):
    d, di, n, k, r = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv,
                      cfg.dt_rank)
    return {
        "in_proj": P((d, 2 * di), ("fsdp", "tp")),
        "conv_w": P((k, di), (None, "tp")),
        "conv_b": P((di,), ("tp",), "zeros"),
        "x_proj": P((di, r + 2 * n), ("tp", None)),
        "dt_proj": P((r, di), (None, "tp")),
        "dt_bias": P((di,), ("tp",), "ones"),
        "a_log": P((di, n), ("tp", None), "ones"),
        "d_skip": P((di,), ("tp",), "ones"),
        "out_proj": P((di, d), ("tp", "fsdp")),
    }
