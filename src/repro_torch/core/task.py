"""Task granularity: packed ``(vertex, width)`` chunk tasks.

The counterpart of ``repro/core/task.py``.  A task is a chunk of
``width`` consecutive CSR rows starting at a head vertex, packed into one
int32 queue slot:

    task = (vertex << width_bits) | (width - 1),   width_bits = ceil(log2 G)

``G = 1`` packs zero width bits, so every task is its vertex id.

  * :class:`ChunkCodec` -- encode/decode on int32 tensors;
  * :func:`coalesce_chunks` -- the push-side chunk former (no sort, no host
    sync), identical to the reference lane for lane;
  * :func:`chunk_seeds` -- host-side greedy chunker for initial frontiers
    (numpy; its own copy of the reference's host code);
  * :func:`flatten_chunks` -- chunk wavefront -> per-vertex wavefront.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: widest chunk any codec may express (the server slice packs width bits
#: beside the job id, so the bound is shared with the reference).
MAX_GRANULARITY = 64

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class ChunkCodec:
    """Bit-packed ``(vertex, width)`` chunk codec for one granularity ``G``."""

    granularity: int = 1

    def __post_init__(self):
        if not 1 <= self.granularity <= MAX_GRANULARITY:
            raise ValueError(
                f"granularity must be in [1, {MAX_GRANULARITY}], got "
                f"{self.granularity}")

    @property
    def width_bits(self) -> int:
        return (self.granularity - 1).bit_length()

    @property
    def width_mask(self) -> int:
        return (1 << self.width_bits) - 1

    def encode(self, vertex: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
        """Pack a chunk; ``width`` lanes must be in [1, granularity]."""
        return ((vertex.to(_I32) << self.width_bits)
                | ((width.to(_I32) - 1) & self.width_mask))

    def head(self, task: torch.Tensor) -> torch.Tensor:
        """Head vertex of a chunk task (identity when G = 1)."""
        return task.to(_I32) >> self.width_bits

    def width(self, task: torch.Tensor) -> torch.Tensor:
        """Chunk width in [1, granularity] (all ones when G = 1)."""
        return (task.to(_I32) & self.width_mask) + 1

    def decode(self, task: torch.Tensor):
        return self.head(task), self.width(task)

    def max_code(self, num_vertices: int) -> int:
        """Largest chunk code a graph of ``num_vertices`` can produce: the
        admission bound of the packed lane encoding."""
        if num_vertices <= 0:
            return 0
        return ((num_vertices - 1) << self.width_bits) | self.width_mask


def coalesce_chunks(vids: torch.Tensor, mask: torch.Tensor, codec: ChunkCodec,
                    row_ptr: torch.Tensor, *, split_threshold=None):
    """Pack marked vertex ids into chunk tasks, in place.

    Each maximal set of marked vertices in one G-aligned window
    ``[bG, bG + G)`` that is contiguous and within ``split_threshold``
    total degree becomes a single chunk on its head lane; everything else
    stays a width-1 chunk on its own lane.  Returns ``(items, out_mask,
    n_splits)``.  Identity at G = 1.  (The reference's shard-ownership
    bound comes with the sharded slice.)
    """
    vids = vids.to(_I32)
    mask = mask.to(torch.bool)
    if codec.granularity == 1:
        return (torch.where(mask, vids, 0), mask,
                torch.zeros((), dtype=_I32, device=vids.device))

    g = codec.granularity
    n = row_ptr.shape[0] - 1
    nb = n // g + 2                       # aligned windows + overflow slot
    # masked lanes add the identities (0, n, -1) below; the reference sends
    # them all to the overflow slot, here each goes to a window of its own
    # so that, on the card, they do not contend for one address.
    lane = torch.arange(vids.shape[0], device=vids.device)
    blk = torch.where(mask, (vids // g).long(), lane % nb)

    def window(fill):
        return torch.full((nb,), fill, dtype=_I32, device=vids.device)

    cnt = window(0).index_add_(0, blk, mask.to(_I32))
    vmin = window(n).scatter_reduce_(0, blk, torch.where(mask, vids, n),
                                     "amin", include_self=True)
    vmax = window(-1).scatter_reduce_(0, blk, torch.where(mask, vids, -1),
                                      "amax", include_self=True)

    contiguous = (cnt > 0) & (vmax - vmin + 1 == cnt)
    head = torch.clamp(vmin, 0, max(n - 1, 0))
    degsum = row_ptr[torch.clamp(vmin + cnt, 0, n)] - row_ptr[head]
    fits = (torch.ones_like(contiguous) if split_threshold is None
            else degsum <= split_threshold)
    form = contiguous & fits

    form_b = form[blk]
    is_head = mask & form_b & (vids == vmin[blk])
    single = mask & ~form_b
    out_mask = is_head | single
    width = torch.where(is_head, cnt[blk], 1)
    items = torch.where(out_mask,
                        codec.encode(torch.where(out_mask, vids, 0), width), 0)
    n_splits = (contiguous & (cnt > 1) & ~fits).sum(dtype=_I32)
    return items, out_mask, n_splits


def chunk_seeds(vids, codec: ChunkCodec, row_ptr, *,
                split_threshold=None) -> np.ndarray:
    """Host-side greedy chunker for an initial frontier (numpy).

    Emits maximal chunks of consecutive ids bounded by the codec width and
    the degree-sum ``split_threshold``; returns the encoded int32 chunk
    array, every entry valid.
    """
    vids = np.asarray(vids, dtype=np.int64)
    g = codec.granularity
    if g == 1 or vids.size == 0:
        return vids.astype(np.int32)
    if isinstance(row_ptr, torch.Tensor):
        row_ptr = row_ptr.cpu().numpy()
    rp = np.asarray(row_ptr, dtype=np.int64)
    chunks = []
    head = int(vids[0])
    width = 1

    def flush():
        chunks.append((head << codec.width_bits)
                      | ((width - 1) & codec.width_mask))

    for v in vids[1:]:
        v = int(v)
        extends = (
            v == head + width
            and width < g
            and (split_threshold is None
                 or rp[v + 1] - rp[head] <= split_threshold)
        )
        if extends:
            width += 1
        else:
            flush()
            head, width = v, 1
    flush()
    return np.asarray(chunks, dtype=np.int32)


def flatten_chunks(heads: torch.Tensor, widths: torch.Tensor,
                   valid: torch.Tensor, max_width: int):
    """Explode a chunk wavefront into a per-vertex wavefront.

    ``[k]`` chunks become ``[k * max_width]`` vertex lanes: lane
    ``i * max_width + j`` carries ``heads[i] + j``, valid iff chunk ``i`` is
    valid and ``j < widths[i]``.  Returns ``(vids, flat_valid, owner)``.
    """
    heads = heads.to(_I32)
    widths = widths.to(_I32)
    k = heads.shape[0]
    j = torch.arange(max_width, dtype=_I32, device=heads.device)
    vids = (heads[:, None] + j[None, :]).reshape(-1)
    flat_valid = (valid[:, None] & (j[None, :] < widths[:, None])).reshape(-1)
    owner = torch.arange(k, dtype=_I32, device=heads.device)[:, None].expand(
        k, max_width).reshape(-1)
    return torch.where(flat_valid, vids, 0), flat_valid, owner
