"""Routed wavefront delivery and the mesh's collectives.

The counterpart of ``repro/shard/exchange.py``.  After each shard runs its
wavefront body, every produced task is routed to the shard that owns its
head vertex: locally owned tasks go straight into the shard's queue
replica; remote ones are compacted into per-destination send rows and
exchanged.  On the 1-D mesh that is one ``S``-wide all-to-all; on a
``(rows, cols)`` mesh it is dimension-ordered: a column hop inside each
row (keyed by the owner's column), then a row hop inside each column
(keyed by the owner's row).  ``EMPTY`` doubles as the wire sentinel, and
with ``compress=True`` each hop's buffer runs through the delta codec
(``shard/codec.py``): the collective ships the decoded buffer while the
meter records the codec's word count, as the reference does.

The port is single-controller, so every function here takes the list of
per-shard tensors (shard ``d``'s on ``mesh.devices[d]``) and returns a
list.  The collectives move tensors with ``.to(device, non_blocking=True)``
(no copy between shards on one device):

  * ``all_to_all``: row ``d`` of sender ``s`` becomes row ``s`` of
    receiver ``d``, in sender order;
  * ``ppermute``: the ring shift, shard ``s`` to shard ``(s + 1) % S``;
  * ``all_gather``: every shard's value, stacked in shard order;
  * ``psum`` / ``pmin`` / ``pmax``: the reduction over shards, computed
    once on shard 0's device and copied to every shard.  ``psum`` adds in
    shard order, ``((x0 + x1) + x2) + ...``: the order of JAX's CPU
    all-reduce over forced host devices, so float sums (PageRank's merge)
    are the reference's bit for bit.

``route_tasks`` pushes the locally owned tasks itself and hands back each
shard's arrivals as a flat EMPTY-padded ``delivered`` buffer for the
driver to push (strict) or stage one round (deferred), with each shard's
``meters``: ``sent``, ``rdrop``, ``sent_col``, ``sent_row``, ``payload``,
``padding`` and ``wire``, as in the reference.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ..core.queue import EMPTY, MultiQueue
from .codec import decode_buffer, encode_buffer
from .partition import owner_of

#: lane of each queue replica holding owned (seeded, routed or requeued)
#: tasks, always expandable from the shard's own CSR slice
LANE_LOCAL = 0
#: lane holding tasks freshly donated by the ring predecessor, expandable
#: from the steal halo and never donated again (``shard/steal.py``)
LANE_STOLEN = 1
NUM_LANES = 2

_I32 = torch.int32


# ------------------------------------------------------------ collectives
def _moved(x: torch.Tensor, device) -> torch.Tensor:
    return x.to(device, non_blocking=True)


def all_to_all(sends: Sequence[torch.Tensor], groups, devices
               ) -> List[torch.Tensor]:
    """Per group (shard ids in axis order), receiver ``g[i]`` gets
    ``stack(sends[g[j]][i] for j)``: row ``i`` of member ``j``'s send
    becomes row ``j`` of member ``i``'s receive."""
    recv: List[Optional[torch.Tensor]] = [None] * len(sends)
    for group in groups:
        if len({devices[d] for d in group}) == 1:
            # one device: one stack, then views
            flipped = torch.stack([sends[d] for d in group]).transpose(0, 1)
            for i, d in enumerate(group):
                recv[d] = flipped[i]
            continue
        for i, d in enumerate(group):
            recv[d] = torch.stack([_moved(sends[s][i], devices[d])
                                   for s in group])
    return recv


def ppermute(xs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """The ring shift: shard ``s``'s tensor lands on shard ``(s+1) % S``."""
    s = len(xs)
    return [_moved(xs[(d - 1) % s], devices[d]) for d in range(s)]


def broadcast(x: torch.Tensor, devices) -> List[torch.Tensor]:
    """``x`` on every shard's device (the same tensor where it is there)."""
    return [_moved(x, dev) for dev in devices]


def all_gather(xs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """Every shard gets ``stack(xs)`` in shard order."""
    return broadcast(torch.stack([_moved(x, devices[0]) for x in xs]),
                      devices)


def reduce_sum(xs: Sequence[torch.Tensor], device) -> torch.Tensor:
    """``((x0 + x1) + x2) + ...`` on ``device``: the fixed order of
    :func:`psum`."""
    total = _moved(xs[0], device)
    for x in xs[1:]:
        total = total + _moved(x, device)
    return total


def psum(xs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    """The shard-order sum on every shard."""
    return broadcast(reduce_sum(xs, devices[0]), devices)


def pmin(xs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    total = _moved(xs[0], devices[0])
    for x in xs[1:]:
        total = torch.minimum(total, _moved(x, devices[0]))
    return broadcast(total, devices)


def pmax(xs: Sequence[torch.Tensor], devices) -> List[torch.Tensor]:
    total = _moved(xs[0], devices[0])
    for x in xs[1:]:
        total = torch.maximum(total, _moved(x, devices[0]))
    return broadcast(total, devices)


# --------------------------------------------------------------- routing
def delivered_width(route_width: int, num_shards: int,
                    mesh_dims: Optional[Tuple[int, int]] = None) -> int:
    """Width of the flat ``delivered`` buffer :func:`route_tasks` returns:
    ``S * w`` on the 1-D mesh; on ``(R, C)`` the column hop's ``C * w``
    plus the row hop's ``R * C * w`` (wide enough for every column-hop
    arrival, so the row hop never drops)."""
    if mesh_dims is None:
        return num_shards * route_width
    rows, cols = mesh_dims
    return cols * route_width + rows * (cols * route_width)


def _compact_send(items: torch.Tensor, take: torch.Tensor, key: torch.Tensor,
                  nrows: int, width: int):
    """Scatter the taken items into ``[nrows, width]`` destination rows,
    each a rank-compacted EMPTY-padded prefix (item i's slot in row
    ``key[i]`` counts the earlier taken items of that key).  Returns
    ``(send, n_fit, n_drop)``."""
    k = items.shape[0]
    key = torch.clamp(key.to(_I32), 0, nrows - 1)
    lane = torch.arange(k, dtype=_I32, device=items.device)
    # one flat scan over the [nrows, k] membership (a scan over the outer
    # dim of a [k, nrows] table is far slower on the card): the exclusive
    # count at (r, i), less the count at (r, 0), is item i's rank in row r
    member = ((torch.arange(nrows, dtype=_I32, device=items.device)[:, None]
               == key[None, :]) & take[None, :]).reshape(-1).to(_I32)
    excl = torch.cumsum(member, 0, dtype=_I32) - member
    row = (key * k).long()
    rank = excl[row + lane.long()] - excl[row]
    fits = take & (rank < width)
    flat = torch.full((nrows * width + k,), EMPTY, dtype=_I32,
                      device=items.device)
    flat[torch.where(fits, key * width + rank, nrows * width + lane).long()] \
        = torch.where(fits, items.to(_I32), EMPTY)
    n_fit = fits.sum(dtype=_I32)
    return (flat[:nrows * width].reshape(nrows, width), n_fit,
            take.sum(dtype=_I32) - n_fit)


def _encoded(send: torch.Tensor, compress: bool):
    """``(buffer to ship, wire ints)``: with ``compress`` the buffer is
    encoded and decoded back (what arrives is the decoded stream) and the
    wire is the codec's word count."""
    nrows, width = send.shape
    if not compress:
        return send, torch.full((), nrows * width, dtype=_I32,
                                device=send.device)
    words, n_words = encode_buffer(send)
    return decode_buffer(words, nrows, width), n_words


def _payload(send: torch.Tensor, self_row: int):
    """(valid ints, valid ints in the self-addressed row)."""
    valid = send != EMPTY
    return valid.sum(dtype=_I32), valid[self_row].sum(dtype=_I32)


def route_tasks(mqs: Sequence[MultiQueue], items: Sequence[torch.Tensor],
                masks: Sequence[torch.Tensor], *, devices,
                num_vertices: int, task_vertex,
                route_width: Optional[int] = None, backend: str = "auto",
                mesh_dims: Optional[Tuple[int, int]] = None,
                compress: bool = False):
    """Deliver every shard's produced tasks toward their owners.

    Returns ``(mqs', delivered, meters)``, each a list over shards:
    the replicas with their own tasks pushed to ``LANE_LOCAL``, the flat
    arrivals (``delivered_width(route_width, S, mesh_dims)`` wide, EMPTY
    padded) and the meters.  ``route_width`` bounds the tasks a shard
    sends each destination on the first hop (default: the body's output
    width); the row hop cannot drop.
    """
    s = len(mqs)
    n = num_vertices
    w1 = items[0].shape[0] if route_width is None else route_width
    dests, out_mqs = [], []
    for d in range(s):
        verts = task_vertex(torch.where(masks[d], items[d], 0))
        dest = owner_of(verts, n, s)
        dests.append(dest)
        out_mqs.append(mqs[d].push(LANE_LOCAL, items[d],
                                   masks[d] & (dest == d), backend=backend))

    if mesh_dims is None:
        sends, meters = [], []
        for d in range(s):
            send, n_sent, n_drop = _compact_send(
                items[d], masks[d] & (dests[d] != d), dests[d], s, w1)
            payload, own = _payload(send, d)
            send, wire = _encoded(send, compress)
            sends.append(send)
            meters.append({
                "sent": n_sent, "rdrop": n_drop, "sent_col": payload - own,
                "sent_row": torch.zeros_like(payload), "payload": payload,
                "padding": s * w1 - payload, "wire": wire})
        recv = all_to_all(sends, [list(range(s))], devices)
        return out_mqs, [r.reshape(-1) for r in recv], meters

    rows, cols = mesh_dims
    # hop 1, the column hop inside each row: a remote task moves to the
    # shard of its row that sits in the owner's column
    sends1, meters = [], []
    for d in range(s):
        send1, n_sent, drop1 = _compact_send(
            items[d], masks[d] & (dests[d] != d), dests[d] % cols, cols, w1)
        payload1, own1 = _payload(send1, d % cols)
        send1, wire1 = _encoded(send1, compress)
        sends1.append(send1)
        meters.append({"sent": n_sent, "rdrop": drop1,
                       "sent_col": payload1 - own1, "payload": payload1,
                       "wire": wire1})
    row_groups = [[r * cols + c for c in range(cols)] for r in range(rows)]
    recv1 = all_to_all(sends1, row_groups, devices)

    # hop 2, the row hop inside each column: arrivals owned in my row are
    # delivered, the rest go on to the owner's row
    sends2, mine = [], []
    for d in range(s):
        flat1 = recv1[d].reshape(-1)
        v1 = flat1 != EMPTY
        dest1 = owner_of(task_vertex(torch.where(v1, flat1, 0)), n, s)
        mine1 = v1 & (dest1 // cols == d // cols)
        send2, _, drop2 = _compact_send(flat1, v1 & ~mine1, dest1 // cols,
                                        rows, cols * w1)
        payload2, own2 = _payload(send2, d // cols)
        send2, wire2 = _encoded(send2, compress)
        sends2.append(send2)
        mine.append(torch.where(mine1, flat1, EMPTY))
        m = meters[d]
        m["rdrop"] = m["rdrop"] + drop2
        m["sent_row"] = payload2 - own2
        m["padding"] = (cols * w1 + rows * cols * w1) - m["payload"] \
            - payload2
        m["payload"] = m["payload"] + payload2
        m["wire"] = m["wire"] + wire2
    col_groups = [[r * cols + c for r in range(rows)] for c in range(cols)]
    recv2 = all_to_all(sends2, col_groups, devices)
    delivered = [torch.cat([mine[d], recv2[d].reshape(-1)]) for d in range(s)]
    return out_mqs, delivered, meters


def pop_wavefront(mq: MultiQueue, wavefront: int):
    """Pop one shard's wavefront, stolen tasks first.

    Both lane pops are ``wavefront`` wide; the stolen prefix and the local
    remainder are fused into one ``(items, valid)`` pair, each lane's FIFO
    order kept.  Returns ``(items, valid, n_stolen, mq')``.
    """
    s_items, s_valid, mq = mq.pop_lane(LANE_STOLEN, wavefront)
    k1 = s_valid.sum(dtype=_I32)
    l_items, l_valid, mq = mq.pop_lane(LANE_LOCAL, wavefront,
                                       quota=wavefront - k1)
    k0 = l_valid.sum(dtype=_I32)
    lane = torch.arange(wavefront, dtype=_I32, device=s_items.device)
    shifted = l_items[torch.clamp(lane - k1, 0, wavefront - 1).long()]
    items = torch.where(lane < k1, s_items, shifted)
    valid = lane < (k1 + k0)
    return torch.where(valid, items, EMPTY), valid, k1, mq

