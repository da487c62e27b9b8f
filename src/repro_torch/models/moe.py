"""Mixture-of-Experts layer with Atos-style capacity dispatch.

The counterpart of ``repro/models/moe.py``.  Token-to-expert routing is a
dynamic irregular scatter, the pattern of the paper's task queue: slot
reservation inside each expert's capacity buffer is the prefix-sum
reservation of ``core/queue.py``.  For expert e the k-th routed token (in
token order) takes slot k; tokens past capacity are dropped, as Atos
drops on a full queue, and counted.

Where the reference leaves an order to XLA, the port fixes it so that a
run on the card gives the same result every time:

  * ``lax.top_k`` puts the lower index first among equal probabilities;
    :func:`route` takes a stable descending sort cut to k, which does the
    same (``torch.topk`` promises no order among ties);
  * kept tokens are placed by an index copy (each kept slot is unique) and
    dropped ones are masked out, where the reference adds them at an
    out-of-range sink with ``mode="drop"``;
  * each token's k expert outputs are combined one after another, in
    assignment order, with no atomics.

``moe_ep_axis`` names a mesh axis for the expert buffers in the reference;
it is a sharding hint and means nothing on one device, so it is ignored.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def capacity_of(cfg: ModelConfig, n_tok: int) -> int:
    """Slots an expert holds for ``n_tok`` tokens: the reference's Python
    arithmetic, rounded up to a multiple of 8 and at least 8."""
    cf = cfg.moe_cap_factor_override or cfg.capacity_factor
    capacity = int(cf * n_tok * cfg.num_experts_per_tok / cfg.num_experts)
    return max(8, -(-capacity // 8) * 8)


def route(params, cfg: ModelConfig, xf: torch.Tensor) -> tuple:
    """Router of ``xf`` [N, d] in f32 -> (probs [N, E], gate values [N, k]
    normalised to sum 1, expert ids [N, k] int64, best first, the lower id
    first among equal probabilities)."""
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    gate_vals, gate_idx = vals[:, :k], idx[:, :k]
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def apply_moe(params, cfg: ModelConfig, x, *, capacity: int | None = None):
    """x [B, T, d] -> ([B, T, d], {"aux_loss", "dropped"}) with top-k
    routing and capacity drop."""
    b, t, d = x.shape
    n_tok = b * t
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if capacity is None:
        capacity = capacity_of(cfg, n_tok)

    xf = x.reshape(n_tok, d)
    probs, gate_vals, gate_idx = route(params, cfg, xf)

    # prefix-sum slot reservation, sort-based: sort the assignments by
    # expert (stable, so token order within an expert); a slot is the
    # index within the expert's run, from a segmented iota
    flat_expert = gate_idx.reshape(-1)                          # [N*k]
    nk = flat_expert.shape[0]
    order = torch.argsort(flat_expert, stable=True)
    sorted_e = flat_expert[order]
    idx = torch.arange(nk, device=x.device)
    is_start = torch.ones(nk, dtype=torch.bool, device=x.device)
    is_start[1:] = sorted_e[1:] != sorted_e[:-1]
    group_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    slot = torch.empty_like(idx).index_copy_(0, order, idx - group_start)
    keep = slot < capacity
    dropped = (~keep).sum(dtype=torch.int32)

    # dispatch: the kept assignments into [E * cap, d], one row each
    tok_idx = torch.arange(n_tok, device=x.device).repeat_interleave(k)
    dst = flat_expert * capacity + slot
    kept = keep.nonzero().squeeze(1)
    buf = xf.new_zeros((e * capacity, d)).index_copy_(
        0, dst[kept], xf[tok_idx[kept]]).reshape(e, capacity, d)

    # expert FFN (swiglu), batched over experts
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, params["wg"])) * \
        torch.einsum("ecd,edf->ecf", buf, params["wi"])
    y = torch.einsum("ecf,efd->ecd", h, params["wo"])

    # return: each assignment's expert output weighted by its gate, summed
    # a token's k assignments in order (product first, then the add)
    y_flat = y.reshape(e * capacity, d)
    per_assign = torch.where(keep[:, None], y_flat[torch.where(keep, dst, 0)],
                             0.0).reshape(n_tok, k, d)
    weighted = per_assign * gate_vals.to(xf.dtype)[..., None]
    out = weighted[:, 0]
    for j in range(1, k):
        out = out + weighted[:, j]

    # load-balance aux (Switch-style) from the assignment counts
    frac_tokens = torch.bincount(flat_expert, minlength=e).float() / nk
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0))
    return out.reshape(b, t, d), {"aux_loss": aux, "dropped": dropped}
