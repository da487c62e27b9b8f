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

``MultiQueue`` stacks independent lanes with a round-robin pop pointer:
the fused topology's queue (one packed lane, ``runtime.api``).

Every operation returns a new queue and leaves its operands untouched, as
the reference's pytrees do.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .backend import resolve_backend, resolve_device
from .tree import tree_map

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


@dataclasses.dataclass(frozen=True)
class MultiQueue:
    """``num_lanes`` independent ring buffers with a round-robin pop pointer.

    ``lanes`` is a TaskQueue whose buffer is ``[L, capacity]`` and whose
    cursors are ``[L]``.  Pops rotate across non-empty lanes; pushes name a
    lane.  A lane id is a Python int or a one-element (or 0-dim) tensor; a
    tensor id is read with ``index_select``, never with ``x[t]``, which
    would read the id on the host.
    """

    lanes: TaskQueue      # stacked: buf [L, capacity], cursors [L]
    rr: torch.Tensor      # 0-dim int32 round-robin pointer

    @property
    def num_lanes(self) -> int:
        return self.lanes.buf.shape[0]

    @property
    def capacity(self) -> int:
        return self.lanes.buf.shape[1]

    @property
    def size(self) -> torch.Tensor:
        return (self.lanes.tail - self.lanes.head).sum(dtype=_I32)

    def empty(self) -> torch.Tensor:
        return self.size == 0

    # -------------------------------------------------------- lane plumbing
    def _index(self, lane_id) -> torch.Tensor:
        if isinstance(lane_id, torch.Tensor):
            return lane_id.reshape(1).long()
        return torch.full((1,), int(lane_id), dtype=torch.long,
                          device=self.lanes.buf.device)

    def lane(self, lane_id) -> TaskQueue:
        """View of a single lane as a standalone ``TaskQueue``."""
        if isinstance(lane_id, torch.Tensor):
            idx = self._index(lane_id)
            return tree_map(lambda x: x.index_select(0, idx)[0], self.lanes)
        return tree_map(lambda x: x[int(lane_id)], self.lanes)

    def with_lane(self, lane_id, lane: TaskQueue) -> "MultiQueue":
        """Write a (possibly updated) lane back into the stack.  A one-lane
        stack is the lane itself, with no copy."""
        if self.num_lanes == 1:
            lanes = tree_map(lambda new: new.unsqueeze(0), lane)
        else:
            idx = self._index(lane_id)
            lanes = tree_map(
                lambda full, new: full.index_copy(0, idx, new.unsqueeze(0)),
                self.lanes, lane)
        return dataclasses.replace(self, lanes=lanes)

    def reset_lane(self, lane_id) -> "MultiQueue":
        """Recycle a lane for a new tenant: empty buffer, zeroed cursors."""
        return self.with_lane(lane_id, make_queue(
            self.capacity, device=self.lanes.buf.device))

    def lane_sizes(self) -> torch.Tensor:
        return self.lanes.tail - self.lanes.head

    def lane_loads(self, width_of=None) -> torch.Tensor:
        """Per-lane occupancy in vertices (chunk-width weighted);
        ``width_of=None`` is :meth:`lane_sizes`."""
        if width_of is None:
            return self.lane_sizes()
        cap = self.capacity
        i = torch.arange(cap, dtype=_I32, device=self.lanes.buf.device)[None]
        live = ((i - self.lanes.head[:, None]) % cap) < \
            self.lane_sizes()[:, None]
        w = width_of(self.lanes.buf).to(_I32)
        return torch.where(live, w, 0).sum(dim=1, dtype=_I32)

    def lane_dropped(self) -> torch.Tensor:
        return self.lanes.dropped

    # ----------------------------------------------------------------- api
    def pop(self, n: int) -> Tuple[torch.Tensor, torch.Tensor, "MultiQueue"]:
        """Pop up to ``n`` items from the next non-empty lane (round robin);
        the pointer is kept modulo ``num_lanes``."""
        lanes = self.num_lanes
        order = (self.rr + torch.arange(lanes, dtype=_I32,
                                        device=self.rr.device)) % lanes
        nonempty = self.lane_sizes()[order.long()] > 0
        # the first non-empty lane in rr order, as a one-element tensor
        pick = order.index_select(0, torch.argmax(nonempty.to(_I32))
                                  .reshape(1))
        items, valid, lane2 = self.lane(pick).pop(n)
        return items, valid, dataclasses.replace(
            self.with_lane(pick, lane2), rr=((pick + 1) % lanes).reshape(()))

    def pop_lane(self, lane_id, n: int, quota=None, width_of=None):
        """Pop up to ``quota``'s worth of items from one named lane; the
        quota counts slots, or vertices with ``width_of`` (see
        :meth:`TaskQueue.pop_upto`).  The round-robin pointer stays."""
        items, valid, lane2 = self.lane(lane_id).pop_upto(
            n, n if quota is None else quota, width_of=width_of)
        return items, valid, self.with_lane(lane_id, lane2)

    def push(self, lane_id, items: torch.Tensor, mask: torch.Tensor,
             backend: str = "auto") -> "MultiQueue":
        return self.with_lane(
            lane_id, self.lane(lane_id).push(items, mask, backend=backend))


def make_multiqueue(capacity: int, num_lanes: int,
                    device="cuda") -> MultiQueue:
    """``num_lanes`` empty lanes of ``capacity`` on ``device``."""
    device = resolve_device(device)
    zeros = torch.zeros((num_lanes,), dtype=_I32, device=device)
    lanes = TaskQueue(
        buf=torch.full((num_lanes, capacity), EMPTY, dtype=_I32,
                       device=device),
        head=zeros, tail=zeros.clone(), dropped=zeros.clone())
    return MultiQueue(lanes=lanes,
                      rr=torch.zeros((), dtype=_I32, device=device))
