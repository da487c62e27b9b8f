"""Functional task queue: the wavefront analogue of Atos's shared queue.

The counterpart of ``repro/core/queue.py``.  A fixed-capacity ring buffer
of int32 task ids where

  * ``pop(n)`` removes up to ``n`` items at once -- one wavefront of
    ``num_workers x fetch_size`` tasks; and
  * ``push(items, mask)`` reserves slots with an exclusive prefix sum over
    the mask instead of an atomic ticket, so the buffer is deterministic.
    On the ``"cuda"`` backend the reservation runs through the stream
    compaction kernel (``kernels/queue_compact``); the queue is
    bit-identical either way.

Every operation returns a new queue and leaves its operands untouched, as
the reference's pytrees do.  ``MultiQueue`` comes with the fused-topology
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .backend import resolve_backend, resolve_device

EMPTY = -(2 ** 31)  # sentinel for "no item"

_I32 = torch.int32


def _scatter_drop(buf: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``buf.at[idx].set(vals, mode="drop")`` for ``idx`` in ``[0, len]``:
    index ``len(buf)`` lands in a spare slot that is sliced off."""
    ext = torch.cat([buf, buf.new_zeros(1)])
    ext[idx.long()] = vals.to(buf.dtype)
    return ext[:-1]


@dataclasses.dataclass(frozen=True)
class TaskQueue:
    """Fixed-capacity ring buffer of int32 task ids.

    Invariants: ``0 <= tail - head <= capacity``, and
    ``buf[(head + i) % capacity]`` for ``i`` in ``[0, size)`` are the live
    items.  Cursors are 0-dim int32 tensors on the buffer's device.
    """

    buf: torch.Tensor      # [capacity] int32
    head: torch.Tensor     # pop cursor
    tail: torch.Tensor     # push cursor
    dropped: torch.Tensor  # items lost to overflow (diagnostic)

    @property
    def capacity(self) -> int:
        return self.buf.shape[0]

    @property
    def size(self) -> torch.Tensor:
        return self.tail - self.head

    def pop(self, n: int) -> Tuple[torch.Tensor, torch.Tensor, "TaskQueue"]:
        """Pop up to ``n`` items: ``(items[n], valid[n], queue')``; missing
        items are EMPTY with ``valid=False``."""
        return self.pop_upto(n, n)

    def pop_upto(self, n: int, quota, width_of=None):
        """Pop up to ``quota``'s worth of items into an ``n``-wide wavefront.

        Without ``width_of`` the quota counts slots; with it (an item ->
        chunk-width function) the quota counts vertices and the pop takes
        the longest slot prefix whose summed widths fit.  Quota 0 or
        negative pops nothing.
        """
        if isinstance(quota, torch.Tensor):
            quota = quota.to(_I32)
        lane = torch.arange(n, dtype=_I32, device=self.buf.device)
        items = self.buf[(self.head + lane) % self.capacity]
        in_queue = lane < torch.clamp(self.size, max=n)
        if width_of is None:
            valid = in_queue & (lane < quota)
        else:
            w = torch.where(in_queue, width_of(items).to(_I32), 0)
            # widths >= 1 inside the queue keep the cumsum strictly
            # increasing over live slots, so the quota cut is a prefix.
            valid = in_queue & (torch.cumsum(w, 0, dtype=_I32) <= quota)
        k = valid.sum(dtype=_I32)
        items = torch.where(valid, items, EMPTY)
        return items, valid, dataclasses.replace(self, head=self.head + k)

    def vertex_size(self, width_of=None) -> torch.Tensor:
        """Occupancy in vertices: the sum of live slots' chunk widths."""
        if width_of is None:
            return self.size
        i = torch.arange(self.capacity, dtype=_I32, device=self.buf.device)
        live = ((i - self.head) % self.capacity) < self.size
        return torch.where(live, width_of(self.buf).to(_I32), 0).sum(dtype=_I32)

    def push(self, items: torch.Tensor, mask: torch.Tensor,
             backend: str = "auto") -> "TaskQueue":
        """Push ``items[mask]`` with prefix-sum slot reservation.

        Valid item i gets slot ``tail + excl_cumsum(mask)[i]``; items beyond
        capacity are dropped and counted.  ``backend`` resolving to
        ``"cuda"`` reserves through the compaction kernel instead, with a
        bit-identical result.
        """
        if resolve_backend(backend, self.buf) == "cuda":
            return self._push_compact(items, mask)
        m = mask.to(_I32)
        offs = torch.cumsum(m, 0, dtype=_I32) - m   # exclusive prefix sum
        free = self.capacity - self.size
        will_fit = (offs < free) & (m > 0)
        slots = (self.tail + offs) % self.capacity
        buf = _scatter_drop(self.buf,
                            torch.where(will_fit, slots, self.capacity), items)
        n_push = will_fit.sum(dtype=_I32)
        n_drop = m.sum(dtype=_I32) - n_push
        return dataclasses.replace(self, buf=buf, tail=self.tail + n_push,
                                   dropped=self.dropped + n_drop)

    def _push_compact(self, items: torch.Tensor,
                      mask: torch.Tensor) -> "TaskQueue":
        """Kernel-backed push: compact the valid items, then one contiguous
        ring write.  The compaction gives valid item i the rank the prefix
        sum gives it, so survivors, slots and the drop count all match."""
        from ..kernels.queue_compact.ops import compact  # lazy: kernels->core

        compacted, count = compact(items.to(_I32).contiguous(),
                                   mask.to(torch.bool).contiguous())
        free = self.capacity - self.size
        n_push = torch.minimum(count, free)
        j = torch.arange(items.shape[0], dtype=_I32, device=self.buf.device)
        live = j < n_push
        slots = (self.tail + j) % self.capacity
        buf = _scatter_drop(self.buf, torch.where(live, slots, self.capacity),
                            compacted)
        return dataclasses.replace(self, buf=buf, tail=self.tail + n_push,
                                   dropped=self.dropped + (count - n_push))

    def push_dense(self, items: torch.Tensor,
                   backend: str = "auto") -> "TaskQueue":
        """Push every element of ``items`` (all valid)."""
        return self.push(items, torch.ones(items.shape, dtype=torch.bool,
                                           device=items.device),
                         backend=backend)


def make_queue(capacity: int, init_items=None, device="cuda") -> TaskQueue:
    """Build an empty queue on ``device``, optionally seeded with
    ``init_items`` (1-D)."""
    device = resolve_device(device)

    def zero():
        return torch.zeros((), dtype=_I32, device=device)

    q = TaskQueue(buf=torch.full((capacity,), EMPTY, dtype=_I32, device=device),
                  head=zero(), tail=zero(), dropped=zero())
    if init_items is not None:
        q = q.push_dense(torch.as_tensor(init_items, dtype=_I32, device=device))
    return q
