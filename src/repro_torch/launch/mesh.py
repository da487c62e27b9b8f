"""Shard meshes for the sharded task scheduler (``repro_torch/shard``).

The counterpart of ``repro/launch/mesh.py``'s shard meshes.  The port's
mesh is single-controller, as the reference's ``shard_map`` is: one
Python process drives every shard, and a :class:`ShardMesh` is only the
list of the shards' devices and the mesh's shape.  Shard ``d`` keeps its
CSR slice, queue replica and state replica on ``devices[d]``; the
collectives (``shard/exchange.py``) move tensors between those devices.
Shard ids stay linear on a 2-D mesh: ``id = row * cols + col``.

With ``devices=None`` a mesh takes ``cuda:0 .. cuda:S-1`` and raises when
fewer cards are visible; it never stacks shards on one card by itself.  A
caller stacks them on purpose with ``devices=[torch.device("cuda:0")] *
S`` (one card hosting an S-shard exchange) or ``[torch.device("cpu")] *
S`` (the host tests).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """S shard devices in linear shard order and the mesh's shape: ``(S,)``
    for the 1-D ring, ``(rows, cols)`` for the 2-D mesh."""

    devices: Tuple[torch.device, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def dims(self) -> Optional[Tuple[int, int]]:
        """``(rows, cols)`` of a 2-D mesh, None for the 1-D ring."""
        return self.shape if len(self.shape) == 2 else None


def require_devices(n: int, purpose: str = "a sharded run") -> None:
    """Raise unless ``n`` CUDA devices are visible, naming ``devices=``."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(
            f"{purpose} needs {n} CUDA devices but {have} "
            f"{'is' if have == 1 else 'are'} visible.  To place several "
            f"shards on one device, pass them explicitly: devices="
            f"[torch.device('cuda:0')] * {n} on one card, or devices="
            f"[torch.device('cpu')] * {n} on the host.")


def _devices(n: int, devices: Optional[Sequence], purpose: str):
    if devices is None:
        require_devices(n, purpose)
        return tuple(torch.device("cuda", i) for i in range(n))
    devices = tuple(torch.device(d) for d in devices)
    if len(devices) != n:
        raise ValueError(f"{purpose} needs {n} devices, got {len(devices)}")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{purpose}: device {d} was requested but no CUDA device is "
                f"available")
    return devices


def parse_devices(text: str) -> Tuple[torch.device, ...]:
    """A comma-separated device list (``"cuda:0,cuda:0"``) as devices."""
    names = [t.strip() for t in text.split(",") if t.strip()]
    if not names:
        raise ValueError(f"no device in {text!r}")
    return tuple(torch.device(t) for t in names)


def make_shard_mesh(n: int, devices: Optional[Sequence] = None) -> ShardMesh:
    """1-D mesh of ``n`` shards: each owns one vertex block, one queue
    replica and one lane of every collective."""
    if n < 1:
        raise ValueError(f"num_shards must be >= 1, got {n}")
    return ShardMesh(_devices(n, devices, f"make_shard_mesh({n})"), (n,))


def make_shard_mesh2d(rows: int, cols: int,
                      devices: Optional[Sequence] = None) -> ShardMesh:
    """2-D ``(rows, cols)`` mesh: the same linear ownership as the 1-D
    ring, but the routed exchange takes two per-axis hops (a column hop
    inside each row, then a row hop inside each column)."""
    if rows < 1 or cols < 1:
        raise ValueError(
            f"mesh_shape must be positive, got ({rows}, {cols})")
    return ShardMesh(_devices(rows * cols, devices,
                              f"make_shard_mesh2d({rows}, {cols})"),
                     (rows, cols))
