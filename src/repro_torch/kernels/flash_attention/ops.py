"""Public wrapper around the flash-attention kernel (B5).

The counterpart of ``repro/kernels/flash_attention/ops.py``.  Takes the
model layer's ``[B, S, H, D]`` layout (GQA KV ``[B, S, KVH, D]``), lays
heads out as ``[B*H, S, D]`` so that q head ``b*H + h`` finds its KV head
at ``b*KVH + h // group``, and runs the kernel or the plain version.
``models/layers.apply_attention`` calls it on the prefill path.

``impl``: ``"torch"`` (the reference's ``"xla"``) is ``attention_ref`` on
any device; ``"cuda"`` (the reference's ``"pallas"``) is the kernel and
needs CUDA tensors; ``"auto"`` is the kernel for CUDA tensors and
``attention_ref`` for CPU tensors.
"""
from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref

IMPLS = ("torch", "cuda", "auto")


def multihead_attention(q, k, v, *, causal: bool = True, window: int = 0,
                        impl: str = "auto"):
    """q: [B, Sq, H, D], k/v: [B, Skv, KVH, D] -> [B, Sq, H, D]."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        impl = "cuda" if q.is_cuda else "torch"
    b, s_q, h, d = q.shape
    kvh = k.shape[2]
    # contiguous: at B == 1 the reshape is a strided view, not a copy
    qf = q.transpose(1, 2).reshape(b * h, s_q, d).contiguous()
    kf = k.transpose(1, 2).reshape(b * kvh, k.shape[1], d).contiguous()
    vf = v.transpose(1, 2).reshape(b * kvh, v.shape[1], d).contiguous()
    if impl == "cuda":
        out = flash_attention_cuda(qf, kf, vf, causal=causal, window=window)
    else:
        out = attention_ref(qf, kf, vf, causal=causal, window=window)
    return out.reshape(b, h, s_q, d).transpose(1, 2)
