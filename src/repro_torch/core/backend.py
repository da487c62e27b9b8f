"""Kernel-backend selection: plain PyTorch vs the hand-written CUDA kernels.

The counterpart of ``repro/core/backend.py``.  One ``backend`` axis is
threaded through every layer that owns a hot loop:

    SchedulerConfig.backend
      -> core/frontier.expand_merge_path   (kernels/frontier_expand LBS)
      -> core/queue.TaskQueue.push         (kernels/queue_compact compaction)
      -> algorithms/bfs wavefront body

Values:

  * ``"torch"`` -- the plain PyTorch versions, on any device.  The
    bit-exact oracle.
  * ``"cuda"``  -- the hand-written kernels (``csrc/``).  They need CUDA
    tensors; asking for them with CPU tensors raises.
  * ``"auto"``  -- the kernels for CUDA tensors, the plain versions for CPU
    tensors.  A CUDA tensor never takes the plain path unless the caller
    names ``"torch"``.

Backend choice is a performance axis only: every dispatch site gives
bit-identical results on every backend.

Two internal values, as the reference's ``STREAM``: ``"stream"`` and
``"stream-torch"`` make ``core/frontier.expand_merge_path`` expand over
streamed row slices (``kernels/drain_loop/csr_stream``), with the B4 kernel
on CUDA tensors or with its plain version.  The runtime puts one of them in
the context of a megakernel body; they are never a valid
``SchedulerConfig.backend``, and ``resolve_backend`` rejects them.
"""
from __future__ import annotations

import torch

#: the public axis values, in the order they appear in docs.
BACKENDS = ("torch", "cuda", "auto")

#: internal expansion values for megakernel bodies (see the module doc)
STREAM = "stream"
STREAM_TORCH = "stream-torch"
#: each internal value -> the backend its row-slice stream runs on
STREAMS = {STREAM: "auto", STREAM_TORCH: "torch"}


def has_cuda() -> bool:
    """True when PyTorch sees at least one CUDA device."""
    return torch.cuda.is_available()


def resolve_device(device) -> torch.device:
    """Validate a device argument of an entry point.

    Entry points default to ``"cuda"``; on a host without a card they raise
    here instead of failing later inside an allocation.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            f"device={str(device)!r} was requested but no CUDA device is "
            f"available; pass device='cpu' to run on the host")
    return dev


def resolve_backend(backend: str, tensor: torch.Tensor) -> str:
    """Collapse the axis to an executable value, ``"torch"`` or ``"cuda"``,
    for operands that live where ``tensor`` lives."""
    if backend not in BACKENDS:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "auto":
        return "cuda" if tensor.is_cuda else "torch"
    if backend == "cuda" and not tensor.is_cuda:
        raise ValueError(
            f"backend='cuda' runs the hand-written kernels, which need CUDA "
            f"tensors; got a tensor on {tensor.device}")
    return backend
