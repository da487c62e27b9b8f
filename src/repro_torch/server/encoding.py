"""Packed ``(job_id, payload)`` task encoding of a ``MultiQueue`` lane.

The counterpart of ``repro/server/encoding.py``.  Every task a lane
carries is a single positive int32

    packed = (job_id << PAYLOAD_BITS) | zigzag(natural_task)

where the *natural* task is what the program's body consumes (a vertex id
or chunk code for BFS and PageRank, a signed ``±(code + 1)`` for
coloring); zigzag folds the sign into the low bit so negatives survive
the bit field.

Layout (int32, sign bit always 0):
    bit 31    : 0
    bits 24-30: job_id                (MAX_JOBS = 128 tenants)
    bits 0-23 : zigzag(natural task)  (naturals up to ±MAX_NATURAL)

Torch's int32 ``<<`` wraps and ``>>`` is arithmetic, as JAX's are, so the
bits are the reference's at every boundary.
"""
from __future__ import annotations

import torch

PAYLOAD_BITS = 24
PAYLOAD_MASK = (1 << PAYLOAD_BITS) - 1
MAX_JOBS = 1 << (31 - PAYLOAD_BITS)          # 128
MAX_NATURAL = (1 << (PAYLOAD_BITS - 1)) - 1  # |natural| bound after zigzag

_I32 = torch.int32


def _int32(t) -> torch.Tensor:
    return torch.as_tensor(t).to(_I32)


def zigzag(t) -> torch.Tensor:
    """Map signed int32 to unsigned-style: 0,-1,1,-2,2 -> 0,1,2,3,4."""
    t = _int32(t)
    return (t << 1) ^ (t >> 31)  # arithmetic shift propagates the sign


def unzigzag(z) -> torch.Tensor:
    z = _int32(z)
    return (z >> 1) ^ -(z & 1)


def pack(job_id, natural) -> torch.Tensor:
    """Pack natural tasks for ``job_id`` (an int or a tensor that
    broadcasts against ``natural``)."""
    natural = _int32(natural)
    job = (job_id.to(_I32) if isinstance(job_id, torch.Tensor)
           else int(job_id))
    return (job << PAYLOAD_BITS) | (zigzag(natural) & PAYLOAD_MASK)


def unpack_job(packed) -> torch.Tensor:
    return (_int32(packed) >> PAYLOAD_BITS) & (MAX_JOBS - 1)


def unpack_natural(packed) -> torch.Tensor:
    return unzigzag(_int32(packed) & PAYLOAD_MASK)


def packed_width(task_width):
    """Lift a *natural*-task chunk-width function to the packed wire
    format (used by the fused pop's vertex quota and by lane loads)."""
    return lambda p: task_width(unpack_natural(p))


def check_job_fits(job_id: int, num_vertices: int,
                   granularity: int = 1) -> None:
    """Host-side admission: the encoding must be lossless.

    At ``granularity > 1`` tasks are ``(vertex, width)`` chunk codes, so
    the payload must hold the vertex id shifted by the codec's width bits
    -- each doubling of the chunk width halves the largest graph.
    """
    from ..core.task import ChunkCodec  # lazy: server<->core layering

    if not 0 <= job_id < MAX_JOBS:
        raise ValueError(f"job_id {job_id} out of range [0, {MAX_JOBS})")
    # coloring's natural tasks reach ±(task + 1), where task is the vertex
    # id at granularity 1 and a chunk code beyond
    max_code = ChunkCodec(granularity).max_code(num_vertices + 1)
    if max_code + 1 > MAX_NATURAL:
        raise ValueError(
            f"graph too large for {PAYLOAD_BITS}-bit payload at "
            f"granularity {granularity}: n={num_vertices} needs chunk codes "
            f"up to {max_code + 1} > {MAX_NATURAL - 1}")
