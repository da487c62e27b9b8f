"""Kernel B5 wrapper: flash attention, ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attention/kernel.py``, with its contract: q
``[BH, Sq, D]``, k and v ``[BKV, Skv, D]``, ``BH % BKV == 0``, both
sequence lengths multiples of 128, f32 math inside for bf16 inputs, the
output in the input's type.  One block per (q tile, bh) loops over KV tiles
in shared memory; see the note in the source for what bounds it and why.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..build import check_launch, load

#: both sequence axes must be multiples of this, as the reference asserts
SEQ_MULTIPLE = 128
MAX_HEAD_DIM = 256


@functools.lru_cache(maxsize=None)
def _launch_fn():
    fn = load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous: the kernel maps q "
                             f"head bh to KV head bh // group through the "
                             f"[B*H, S, D] layout")
    if not (q.dtype == k.dtype == v.dtype) \
            or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q, k, v must share one type, f32 or bf16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    bh, s_q, d = q.shape
    bkv, s_kv, _ = k.shape
    if k.shape != v.shape or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"match each other and q's head dim {d}")
    if bkv == 0 or bh % bkv:
        raise ValueError(f"q heads {bh} must be a multiple of kv heads {bkv}")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    for name, s in (("Sq", s_q), ("Skv", s_kv)):
        if s <= 0 or s % SEQ_MULTIPLE:
            raise ValueError(f"{name} = {s} must be a positive multiple of "
                             f"{SEQ_MULTIPLE}")
    if bh > 65535:
        raise ValueError(f"BH = {bh} exceeds the kernel's grid limit 65535")
    if not (q.is_cuda and q.device == k.device == v.device):
        raise ValueError(f"flash_attention_cuda needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0):
    """``[BH, Sq, D]`` attention of q over k, v on a CUDA device, in q's
    type.  Launches on the current stream and does not synchronize."""
    _check(q, k, v)
    bh, s_q, d = q.shape
    bkv, s_kv, _ = k.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _launch_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            s_q, s_kv, d, bh // bkv, 1.0 / (d ** 0.5), int(causal),
            int(window), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    check_launch(err, "flash_attention")
    flash_attention_cuda.launches += 1
    return out


#: launches of the kernel since the count was last set to 0
flash_attention_cuda.launches = 0
