"""Delta compression for exchange payloads.

The counterpart of ``repro/shard/codec.py``, word for word.  An exchange
hop ships a ``[rows, width]`` int32 send buffer whose valid task ints are
a per-row prefix padded with the ``EMPTY`` sentinel (``shard/exchange``).
Sorting a row's tasks and shipping first-order deltas packs most batches
into 4-16 bits an int.  The wire format (int32 words):

    word 0          header: bits 0-1 mode (0 = RAW, 1/2/3 = packed at
                    b = 4/8/16 bits a delta), bits 2-3 layout (0 = counts8,
                    1 = bitmask, 2 = counts16), bits 4.. the valid count n
    RAW             words 1..rows*width: the buffer verbatim
    PACKED, n == 0  the header only
    PACKED, n >= 1  layout words (an 8-bit or 16-bit valid count a row for
                    prefix-compact rows, else a bit a slot), the base word
                    (the stream's first value), then the n - 1 deltas of
                    the sorted-run stream (each row's valid values
                    ascending, rows concatenated), zigzag-mapped and packed
                    at b bits each

The encoder takes the smallest feasible b and the cheapest layout, and
falls back to RAW unless packing is strictly smaller.  Arithmetic is
two's-complement int32 and the zigzag map runs on the uint32 pattern,
here held in int64 and masked to 32 bits (torch has no full uint32
arithmetic), so the round trip is exact for every int32 value.  Decoding
gives exact valid positions and each row's values ascending.

Plain torch integer work on the buffer's device: the reference's codec is
no Pallas kernel, and the port's is no hand-written one.  Where the
reference assembles every (mode, layout) candidate and selects one, the
port builds the chosen layout's words and the chosen width's data words
once and places them by index: the same words, without the eight unused
candidates.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.queue import EMPTY

#: packed-delta widths searched by the encoder (each divides 32)
PACKED_WIDTHS: Tuple[int, ...] = (4, 8, 16)

_MODE_RAW = 0                          # packed modes 1, 2, 3: b = 4, 8, 16
_LAYOUT_COUNTS8 = 0
_LAYOUT_BITMASK = 1
_LAYOUT_COUNTS16 = 2
_LAYOUTS = (_LAYOUT_COUNTS8, _LAYOUT_BITMASK, _LAYOUT_COUNTS16)
_N_SHIFT = 4
_M32 = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64


def _u32(x: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of an int32 tensor, as int64."""
    return x.to(_I64) & _M32


def _i32(u: torch.Tensor) -> torch.Tensor:
    """An int64 tensor's low 32 bits as two's-complement int32."""
    u = u & _M32
    return (u - ((u >> 31) << 32)).to(_I32)


def zigzag(v: torch.Tensor) -> torch.Tensor:
    """int32 -> uint32 pattern (int64) with small magnitudes small."""
    u = _u32(v)
    return ((u << 1) & _M32) ^ ((u >> 31) * _M32)


def unzigzag(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`zigzag` (uint32 pattern -> int32)."""
    z = z & _M32
    return _i32((z >> 1) ^ ((-(z & 1)) & _M32))


def _counts8_words(rows: int) -> int:
    return -(-rows // 4)


def _counts16_words(rows: int) -> int:
    return -(-rows // 2)


def _mask_words(rows: int, width: int) -> int:
    return -(-(rows * width) // 32)


def _layout_words(layout: int, rows: int, width: int) -> int:
    if layout == _LAYOUT_COUNTS8:
        return _counts8_words(rows)
    if layout == _LAYOUT_COUNTS16:
        return _counts16_words(rows)
    return _mask_words(rows, width)


def _data_words_max(rows: int, width: int, b: int) -> int:
    return -(-((rows * width - 1) * b) // 32) if rows * width > 1 else 0


def codec_capacity(rows: int, width: int) -> int:
    """Static word capacity covering every mode's worst case."""
    f = rows * width
    lw = max(_layout_words(lay, rows, width) for lay in _LAYOUTS)
    return max(1 + f, 2 + lw + _data_words_max(rows, width,
                                                max(PACKED_WIDTHS)))


def _pack_bits(values: torch.Tensor, nwords: int, bits) -> torch.Tensor:
    """``nwords`` uint32 words (int64) holding ``values[i]`` at bit
    ``i * bits`` (``bits`` an int or a 0-dim tensor, dividing 32); the
    fields never overlap, so the adds are ORs."""
    idx = torch.arange(values.shape[0], dtype=_I64, device=values.device)
    words = torch.zeros(nwords, dtype=_I64, device=values.device)
    if values.shape[0]:
        words.index_add_(0, idx * bits // 32,
                         (values << (idx * bits % 32)) & _M32)
    return words & _M32


def _gather(words: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``words[index]`` with the index clamped, as JAX clamps gathers (0
    from an empty ``words``)."""
    if words.shape[0] == 0:
        return torch.zeros(index.shape, dtype=words.dtype,
                           device=words.device)
    return words[torch.clamp(index, 0, words.shape[0] - 1)]


def encode_buffer(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode a ``[rows, width]`` int32 buffer (EMPTY = padding).

    Returns ``(words, n_words)``: ``codec_capacity(rows, width)`` int32
    words whose first ``n_words`` are the stream (the rest zero), and the
    stream's length as a 0-dim int32 tensor.  No host sync.
    """
    rows, width = buf.shape
    f = rows * width
    dev = buf.device
    cap = codec_capacity(rows, width)
    buf = buf.to(_I32)
    valid = buf != EMPTY
    k = valid.sum(1, dtype=_I32)                           # per-row counts
    n = k.sum(dtype=_I32)

    jidx = torch.arange(width, dtype=_I32, device=dev)[None, :]
    prefix_ok = (valid == (jidx < k[:, None])).all()
    use_c8 = prefix_ok & (width <= 255)
    use_c16 = prefix_ok & ~use_c8 & (width <= 65535)
    layout = torch.where(use_c8, _LAYOUT_COUNTS8,
                         torch.where(use_c16, _LAYOUT_COUNTS16,
                                     _LAYOUT_BITMASK))

    # ---- sorted-run stream: each row's ascending valid values, rows
    # concatenated (one sort, the padding keyed past every int32)
    past = 1 << 32
    skey = torch.sort(torch.where(valid, buf.to(_I64), past), dim=1).values
    off = torch.cumsum(k, 0, dtype=_I32) - k
    pos = (off[:, None] + jidx).reshape(-1)
    slot = torch.arange(f, dtype=_I32, device=dev)
    stream = torch.zeros(2 * f, dtype=_I32, device=dev)
    stream[torch.where(skey.reshape(-1) < past, pos, f + slot).long()] = \
        skey.reshape(-1).to(_I32)
    stream = stream[:f]

    prev = torch.cat([stream[:1], stream[:-1]])
    live_d = (slot >= 1) & (slot < n)
    dz = torch.where(live_d, zigzag(_i32(stream.to(_I64) - prev.to(_I64))),
                     0)
    max_dz = dz.max() if f > 1 else torch.zeros((), dtype=_I64, device=dev)

    # ---- layout words: a row's valid count in an 8- or 16-bit field, or a
    # bit a slot
    lw_max = max(_layout_words(lay, rows, width) for lay in _LAYOUTS)
    ridx = torch.arange(rows, dtype=_I64, device=dev)
    field = torch.where(use_c16, 16, 8).to(_I64)
    counts = torch.minimum(k.to(_I64), (1 << field) - 1)
    lwords = torch.zeros(lw_max, dtype=_I64, device=dev).index_add_(
        0, ridx * field // 32, counts << (ridx * field % 32))
    maskw = _pack_bits(valid.reshape(-1).to(_I64), _mask_words(rows, width),
                       1)
    lwords = torch.where(layout == _LAYOUT_BITMASK, torch.cat([
        maskw, maskw.new_zeros(lw_max - maskw.shape[0])]), lwords)
    lw = torch.where(use_c8, _counts8_words(rows),
                     torch.where(use_c16, _counts16_words(rows),
                                 _mask_words(rows, width)))

    # ---- mode: the smallest feasible packed width, RAW otherwise
    widths = 4 << torch.arange(len(PACKED_WIDTHS), dtype=_I64, device=dev)
    n_data = (torch.clamp(n - 1, min=0).to(_I64) * widths + 31) // 32
    n_packed = torch.where(n == 0, 1, 2 + lw + n_data)
    take = (max_dz < (1 << widths)) & (n_packed < 1 + f)
    first = torch.argmax(take.to(_I32))
    # read by index_select: ``x[t]`` with a 0-dim tensor reads t on the host
    pick = first.reshape(1)
    packs = take.any()
    mode = torch.where(packs, first + 1, _MODE_RAW).to(_I32)
    best_words = torch.where(packs, n_packed.index_select(0, pick)[0],
                             1 + f).to(_I32)
    header = mode | (torch.where(mode == 0, 0, layout) << 2) | (
        n << _N_SHIFT)

    # ---- the chosen width's data words (a narrower width's words end
    # before the widest's, zero past them)
    dw_max = _data_words_max(rows, width, max(PACKED_WIDTHS))
    dwords = _pack_bits(dz[1:], dw_max, widths.index_select(0, pick)[0])

    # ---- assemble: header | layout words | base | data words | zeros
    idx = torch.arange(cap, dtype=_I64, device=dev)
    j_d = idx - 2 - lw
    packed = torch.where(
        (idx >= 1) & (idx < 1 + lw), _gather(lwords, idx - 1),
        torch.where(idx == 1 + lw, stream[0].to(_I64),
                    torch.where((j_d >= 0) & (j_d < dw_max),
                                _gather(dwords, j_d), 0)))
    packed = torch.where(n > 0, _i32(packed), 0)
    raw = torch.cat([torch.zeros(1, dtype=_I32, device=dev), buf.reshape(-1),
                     torch.zeros(cap - 1 - f, dtype=_I32, device=dev)])
    words = torch.where(mode == _MODE_RAW, raw, packed)
    words = torch.cat([header.reshape(1), words[1:]])
    return words, best_words


def decode_buffer(words: torch.Tensor, rows: int, width: int) -> torch.Tensor:
    """Decode an :func:`encode_buffer` stream back to ``[rows, width]``:
    RAW verbatim, PACKED with exact valid positions and each row's values
    ascending.  Reads only the stream's own words."""
    f = rows * width
    dev = words.device
    words = words.to(_I32)
    header = words[0]
    mode = header & 3
    lay = (header >> 2) & 3
    n = header >> _N_SHIFT
    uw = _u32(words)

    raw_dec = words[1:1 + f].reshape(rows, width)

    jidx = torch.arange(width, dtype=_I32, device=dev)[None, :]
    ridx = torch.arange(rows, dtype=_I64, device=dev)
    fidx = torch.arange(f, dtype=_I64, device=dev)
    field = torch.where(lay == _LAYOUT_COUNTS16, 16, 8).to(_I64)
    counts = (_gather(uw, 1 + ridx * field // 32) >> (ridx * field % 32)) \
        & ((1 << field) - 1)
    maskbits = (_gather(uw, 1 + fidx // 32) >> (fidx % 32)) & 1
    valid = torch.where(lay == _LAYOUT_BITMASK,
                        (maskbits == 1).reshape(rows, width),
                        jidx < counts[:, None])
    lw = torch.where(lay == _LAYOUT_COUNTS8, _counts8_words(rows),
                     torch.where(lay == _LAYOUT_COUNTS16,
                                 _counts16_words(rows),
                                 _mask_words(rows, width)))
    base = _gather(words, (1 + lw).reshape(1))[0]

    didx = torch.arange(max(f - 1, 0), dtype=_I64, device=dev)
    bits = 1 << (mode.to(_I64) + 1)             # modes 1, 2, 3: 4, 8, 16
    dz = (_gather(uw, 2 + lw + didx * bits // 32) >> (didx * bits % 32)) \
        & ((1 << bits) - 1)
    deltas = torch.where(didx < (n - 1).to(_I64), unzigzag(dz).to(_I64), 0)
    vals = _i32(base.to(_I64) + torch.cat([
        torch.zeros(1, dtype=_I64, device=dev), torch.cumsum(deltas, 0)]))
    # a valid slot's place in the stream: the valid slots before it in
    # row-major order (its row's offset plus its rank in the row), by one
    # flat scan
    v = valid.reshape(-1).to(_I32)
    g = (torch.cumsum(v, 0, dtype=_I32) - v).reshape(rows, width).long()
    unpacked = torch.where(valid & (n > 0), vals[torch.clamp(g, 0, f - 1)],
                           EMPTY)
    return torch.where((mode != _MODE_RAW) & (lay < 3), unpacked, raw_dec)
