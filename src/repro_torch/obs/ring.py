"""The device-side trace ring buffer (DESIGN.md §15).

The counterpart of ``repro/obs/ring.py``.  A :class:`TraceRing` is a
fixed-size ``(capacity, NUM_FIELDS)`` int32 tensor plus a monotone int32
cursor on the drain's device.  It rides the drain carry as one more leaf,
through the persistent driver's predicated rounds and the discrete loop;
a megakernel cell hands it to the drain kernel, which writes the rows
itself (B3-traced, ``csrc/drain_common.cuh``).

:meth:`TraceRing.record` writes one row at ``cursor % capacity`` and
bumps the cursor with device ops only -- no host sync -- and returns a
**new** buffer.  That matters under the persistent driver: a predicated
round selects between the stepped carry and the old one, and passes a leaf
through uncopied when both hold the same tensor, so a row written in place
would survive a round that did not run.  :func:`ring_rows` reads the ring
once, at run end; when a drain outruns the capacity the newest
``capacity`` rows survive and the count of overwritten ones is reported.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from ..core.backend import resolve_device
from .schema import NUM_FIELDS, TRACE_FIELDS

_FIELD_INDEX = {name: i for i, name in enumerate(TRACE_FIELDS)}
_I32 = torch.int32

#: default ring capacity (rounds) when the caller does not size it
DEFAULT_CAPACITY = 4096


@dataclasses.dataclass(frozen=True)
class TraceRing:
    """Fixed-size per-round trace buffer, carried through the drain."""

    buf: torch.Tensor     # (capacity, NUM_FIELDS) int32
    cursor: torch.Tensor  # 0-dim int32: total records ever written

    @property
    def capacity(self) -> int:
        return int(self.buf.shape[0])

    @staticmethod
    def make(capacity: int = DEFAULT_CAPACITY,
             device="cuda") -> "TraceRing":
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        device = resolve_device(device)
        return TraceRing(
            buf=torch.zeros((capacity, NUM_FIELDS), dtype=_I32,
                            device=device),
            cursor=torch.zeros((), dtype=_I32, device=device))

    def record(self, **fields) -> "TraceRing":
        """Write one row (unnamed columns are 0) and advance the cursor.

        Values are ints or 0-dim tensors on the ring's device; the row is
        assembled and written by device ops (``index_copy`` at a
        one-element index), so the call makes no host sync.
        """
        unknown = set(fields) - set(TRACE_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown trace fields {sorted(unknown)}; the row layout is "
                f"{TRACE_FIELDS} (obs/schema.TRACE_FIELDS)")
        device = self.buf.device
        cols = [torch.zeros((), dtype=_I32, device=device)] * NUM_FIELDS
        for name, value in fields.items():
            cols[_FIELD_INDEX[name]] = (
                value.to(device=device, dtype=_I32).reshape(())
                if isinstance(value, torch.Tensor)
                else torch.full((), int(value), dtype=_I32, device=device))
        row = torch.stack(cols)[None]
        idx = (self.cursor % self.capacity).reshape(1).long()
        return TraceRing(buf=self.buf.index_copy(0, idx, row),
                         cursor=self.cursor + 1)


def ring_rows(ring: TraceRing) -> Tuple[List[dict], int]:
    """Read a ring to the host: ``(records, truncated)``.

    Records come back oldest first as ``{field: int}`` dicts over
    :data:`~repro_torch.obs.schema.TRACE_FIELDS`; ``truncated`` is how many
    of the oldest rounds the wraparound overwrote.  This is the run's one
    device-to-host read for tracing.
    """
    cursor = int(ring.cursor)
    cap = ring.capacity
    buf = ring.buf.cpu().numpy()
    if cursor <= cap:
        data, truncated = buf[:cursor], 0
    else:
        k = cursor % cap
        data = list(buf[k:]) + list(buf[:k])
        truncated = cursor - cap
    records = [{name: int(row[i]) for i, name in enumerate(TRACE_FIELDS)}
               for row in data]
    return records, truncated


def stacked_rings(ring: TraceRing, count: int) -> TraceRing:
    """``count`` replica rings as one stacked ring (a leading axis per
    replica), as the sharded driver takes them."""
    return TraceRing(
        buf=ring.buf.unsqueeze(0).expand(count, *ring.buf.shape).clone(),
        cursor=ring.cursor.unsqueeze(0).expand(count).clone())


def unstack_ring(ring_st: TraceRing, device: int) -> TraceRing:
    """One replica's ring out of a stacked ring (host side, after the
    drain)."""
    return TraceRing(buf=ring_st.buf[device], cursor=ring_st.cursor[device])
