"""Kernel B5 wrapper: flash attention, ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas`` of
``repro/kernels/flash_attention/kernel.py``, with its contract: q
``[BH, Sq, D]``, k and v ``[BKV, Skv, D]``, ``BH % BKV == 0``, both
sequence lengths multiples of 128, f32 math inside for bf16 inputs, the
output in the input's type.

The source holds two kernels, and :func:`tile_plan` picks one by the input
type and head dim, before any launch (a dispatch by shape, never a fallback
on failure):

- ``"tensor_core"``, bf16 with ``D % 8 == 0`` (every bf16 head dim up to
  256 whose rows TMA can address: a row must be a multiple of 16 bytes):
  one block of a TMA producer and two ``wgmma`` consumer warpgroups per q
  tile of 128 rows; K and V tiles of 64 keys (32 past ``D`` = 192) in a
  three-stage ring; ``p . v`` as three bf16 terms of p
  (``p_terms``), so f32 accuracy survives the bf16 tensor cores.  An
  input whose address is not 16-byte aligned is copied first (TMA reads
  16-byte aligned rows).
- ``"cuda_core"``, f32, and bf16 with ``D % 8 != 0``: the CUDA cores in f32,
  q tiles of 64 rows, KV tiles of 32 keys.

See the note in the source for what bounds each and why.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from ..build import check_launch, load

#: both sequence axes must be multiples of this, as the reference asserts
SEQ_MULTIPLE = 128
MAX_HEAD_DIM = 256


@dataclass(frozen=True)
class TilePlan:
    """How the kernel runs a head dim: which instance, the head dim padded
    to the instance's width, the q and KV tile rows, the bf16 terms of p in
    ``p . v`` (0: p stays f32) and the block's dynamic shared memory."""

    instance: str
    head_pad: int
    q_tile: int
    kv_tile: int
    p_terms: int
    smem_bytes: int


def tile_plan(d: int, dtype: torch.dtype) -> TilePlan:
    """The kernel instance and tiles for head dim ``d`` of ``dtype``,
    mirroring the launch functions' checks in the source."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is outside 1..{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16 and d % 8 == 0:
        pad = -(-d // 64) * 64
        kv = 64 if pad <= 192 else 32
        # q, three stages of K and V (128-byte rows), seven mbarriers, 1024
        # bytes to align the swizzle atoms
        smem = pad // 64 * 128 * (128 + 2 * 3 * kv) + 8 * 7 + 1024
        return TilePlan("tensor_core", pad, 128, kv, 3, smem)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash attention takes f32 or bf16, not {dtype}")
    pad = 64 if d <= 64 else 128 if d <= 128 else 256
    smem = 4 * ((64 + 2 * 32) * (pad + 4) + 64 * (32 + 4))
    return TilePlan("cuda_core", pad, 64, 32, 0, smem)


@functools.lru_cache(maxsize=None)
def _launch_fns():
    lib = load("flash_attention")
    core = lib.flash_attention_launch
    core.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    core.restype = ctypes.c_int
    tensor = lib.flash_attention_tc_launch
    tensor.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    tensor.restype = ctypes.c_int
    return core, tensor


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


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0):
    """``[BH, Sq, D]`` attention of q over k, v on a CUDA device, in q's
    type, through the instance :func:`tile_plan` names.  Launches on the
    current stream and does not synchronize."""
    _check(q, k, v)
    bh, s_q, d = q.shape
    bkv, s_kv, _ = k.shape
    plan = tile_plan(d, q.dtype)
    core, tensor = _launch_fns()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if plan.instance == "tensor_core":
            q, k, v = _aligned(q), _aligned(k), _aligned(v)
            out = torch.empty_like(q)
            err = tensor(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), bh, s_q, s_kv, d, plan.head_pad,
                         plan.kv_tile, bh // bkv, 1.0 / (d ** 0.5),
                         int(causal), int(window), stream)
        else:
            out = torch.empty_like(q)
            err = core(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), bh, s_q, s_kv, d, bh // bkv,
                       1.0 / (d ** 0.5), int(causal), int(window),
                       int(q.dtype == torch.bfloat16), stream)
    check_launch(err, f"flash_attention ({plan.instance})")
    flash_attention_cuda.launches += 1
    flash_attention_cuda.instance_launches[plan.instance] += 1
    return out


#: launches of either kernel since the count was last set to 0
flash_attention_cuda.launches = 0
#: the same launches by instance ("tensor_core", "cuda_core")
flash_attention_cuda.instance_launches = {"tensor_core": 0, "cuda_core": 0}
