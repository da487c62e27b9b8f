"""Plain PyTorch version of the flash-attention kernel (B5).

The counterpart of ``repro/kernels/flash_attention/ref.py``: it
materialises the full logits.  Logits, softmax and ``p @ v`` run in f32
whatever the input type, masked entries are set to the finite ``-1e30``
the kernel uses, and GQA repeats each KV head ``group`` times.  A row with
no live key therefore gets ``p = 1`` on every key and returns the mean of
``v``, as the Pallas kernel and the CUDA kernel do.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [BH, Sq, D]; k/v: [BKV, Skv, D] with BH % BKV == 0."""
    bh, s_q, d = q.shape
    bkv, s_kv = k.shape[0], k.shape[1]
    group = bh // bkv
    k = torch.repeat_interleave(k, group, dim=0)
    v = torch.repeat_interleave(v, group, dim=0)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    q_pos = torch.arange(s_q, device=q.device)[:, None]
    k_pos = torch.arange(s_kv, device=q.device)[None, :]
    mask = torch.ones((s_q, s_kv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
