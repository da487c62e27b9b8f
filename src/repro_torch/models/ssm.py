"""Selective state-space blocks: Mamba1 (falcon-mamba) and Mamba2 (zamba2).

The counterpart of ``repro/models/ssm.py``.  Time mixing is a sequential
recurrence over time with a [B, d_inner, n] f32 state, the reference's
``lax.scan``; decode is the single recurrence step over the
(conv_state, ssm_state) cache.

The scan's per-step inputs (the state's decay ``exp(dt a)`` and its input
``dt x b``) are computed for a chunk of time steps at once, and only the
state update ``h = da * h + dbx`` runs in the time loop, two device ops a
step: the same products and sums as the reference's step, in its order.
``y`` is read from the stacked states of the chunk.  Dtypes follow the
reference: the state and its update in f32, ``y`` cast back to the
input's dtype, the out projection in the model's dtype.

``jax.nn.softplus`` is ``logaddexp(x, 0)``; ``F.softplus`` turns into the
identity above 20, so the port takes ``logaddexp`` too.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..core.backend import resolve_device
from .params import P

#: bytes of f32 per-step inputs (decay and input, each [chunk, B, di, n])
#: the scan holds at once
SCAN_CHUNK_BYTES = 1 << 28


class SSMCache(NamedTuple):
    conv: torch.Tensor   # [B, conv_k - 1, d_inner]
    state: torch.Tensor  # [B, d_inner, n] f32


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


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssm_params(params, cfg: ModelConfig, xz):
    """Shared pre-scan computation. xz [B, T, di] (post conv+silu)."""
    n, r = cfg.ssm_state, cfg.dt_rank
    proj = xz @ params["x_proj"]                      # [B, T, r + 2n]
    dt_r, b_mat, c_mat = torch.split(proj, [r, n, n], dim=-1)
    dt = softplus(dt_r @ params["dt_proj"] + params["dt_bias"])
    a = -torch.exp(params["a_log"].float())           # [di, n]
    return dt, b_mat, c_mat, a


def _causal_conv(params, x, cache=None):
    """Depthwise causal conv1d. x [B, T, di] -> ([B, T, di], new cache)."""
    k = params["conv_w"].shape[0]
    if cache is not None:
        ctx = torch.cat([cache, x], dim=1)            # [B, k-1+T, di]
    else:
        ctx = F.pad(x, (0, 0, k - 1, 0))
    t = x.shape[1]
    out = sum(ctx[:, i:i + t, :] * params["conv_w"][i] for i in range(k))
    new_cache = ctx[:, -(k - 1):, :] if k > 1 else None
    return out + params["conv_b"], new_cache


def _ssm_step(h, inp, a):
    """h [B, di, n]; inp = (x, dt, b, c) at one time step."""
    x_t, dt_t, b_t, c_t = inp                         # [B,di],[B,di],[B,n],[B,n]
    dt_f = dt_t.float()
    da = torch.exp(dt_f[..., None] * a[None])         # [B, di, n]
    dbx = (dt_f * x_t.float())[..., None] * b_t.float()[:, None, :]
    h = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h, c_t.float())
    return h, y.to(x_t.dtype)


def _scan(h, xs, dt, b_mat, c_mat, a):
    """The recurrence over all T steps from state ``h`` -> (last state,
    y [B, T, di] in xs's dtype)."""
    bsz, t, di = xs.shape
    n = a.shape[1]
    chunk = max(1, SCAN_CHUNK_BYTES // (4 * bsz * di * n))
    ys = []
    for lo in range(0, t, chunk):
        hi = min(t, lo + chunk)
        # time-major, so that each step's slice is contiguous
        dt_f = dt[:, lo:hi].float().transpose(0, 1).contiguous()
        x_f = xs[:, lo:hi].float().transpose(0, 1)
        b_f = b_mat[:, lo:hi].float().transpose(0, 1)
        da = torch.exp(dt_f[..., None] * a)           # [c, B, di, n]
        dbx = (dt_f * x_f)[..., None] * b_f[:, :, None, :]
        hs = torch.empty_like(da)
        for i in range(hi - lo):
            h = torch.mul(da[i], h, out=hs[i])
            h.add_(dbx[i])
        ys.append(torch.einsum("tbdn,btn->btd", hs,
                               c_mat[:, lo:hi].float()).to(xs.dtype))
    # the last state alone, not a view that keeps the chunk's states
    return h.clone(), torch.cat(ys, dim=1)


def apply_mamba(params, cfg: ModelConfig, x, *, cache: SSMCache | None = None):
    """x [B, T, d] -> ([B, T, d], new_cache).  T = 1 decode when cache given."""
    b, t, _ = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    xz = x @ params["in_proj"]                        # [B, T, 2di]
    xs, z = torch.chunk(xz, 2, dim=-1)
    conv_cache = cache.conv if cache is not None else None
    xs, new_conv = _causal_conv(params, xs, conv_cache)
    xs = F.silu(xs)
    dt, b_mat, c_mat, a = _ssm_params(params, cfg, xs)

    h0 = (cache.state if cache is not None
          else torch.zeros((b, di, n), dtype=torch.float32, device=x.device))

    if t == 1:  # decode fast path: one recurrence step
        h_last, y = _ssm_step(h0, (xs[:, 0], dt[:, 0], b_mat[:, 0],
                                   c_mat[:, 0]), a)
        y = y[:, None, :]
    else:
        h_last, y = _scan(h0, xs, dt, b_mat, c_mat, a)

    y = y + xs * params["d_skip"]
    y = y * F.silu(z)
    out = y.to(x.dtype) @ params["out_proj"]
    return out, SSMCache(conv=new_conv, state=h_last)


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device="cuda") -> SSMCache:
    device = resolve_device(device)
    return SSMCache(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=dtype,
                         device=device),
        state=torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                          dtype=torch.float32, device=device),
    )
