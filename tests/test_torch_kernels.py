"""Kernels B1 (LBS) and B2 (stream compaction) of the PyTorch port against
the JAX package: the plain versions and the kernel-path glue on the CPU,
bit-exact, on numpy-made inputs.  The CUDA kernels themselves are held
against their plain versions on the card in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ChunkCodec as JCodec, make_queue as j_make_queue
from repro.core.frontier import chunk_degrees as j_chunk_degrees
from repro.core.frontier import expand_merge_path as j_expand
from repro.core.frontier import expand_per_item as j_expand_per_item
from repro.core.frontier import searchsorted_right as j_searchsorted_right
from repro.graph import rmat as j_rmat
from repro.kernels.frontier_expand.kernel import lbs_pallas
from repro.kernels.frontier_expand.ops import frontier_expand as j_frontier
from repro.kernels.frontier_expand.ref import lbs_ref as j_lbs_ref
from repro.kernels.queue_compact.ops import compact as j_compact
from repro.kernels.queue_compact.ref import compact_ref as j_compact_ref
from repro_torch.convert import graph_from_numpy, queue_from_numpy
from repro_torch.core import (ChunkCodec, expand_merge_path, expand_per_item,
                              searchsorted_right)
from repro_torch.kernels.frontier_expand.ops import frontier_expand, lbs
from repro_torch.kernels.frontier_expand.ref import lbs_ref
from repro_torch.kernels.queue_compact.ops import compact
from repro_torch.kernels.queue_compact.ref import compact_ref

LBS_SWEEP = [(1, 128), (7, 64), (32, 1024), (100, 2048), (257, 4096),
             (1000, 1024)]


def _scan(deg):
    return np.cumsum(deg).astype(np.int32)


def _eq(port, ref, err=""):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref), err_msg=err)


# ----------------------------------------------------------- B1, LBS
@pytest.mark.parametrize("w,budget", LBS_SWEEP)
def test_lbs_plain_matches_jax_ref_every_unit(w, budget):
    scan = _scan(np.random.default_rng(w).integers(0, 9, size=w))
    o, r = lbs_ref(torch.from_numpy(scan), budget)
    jo, jr = j_lbs_ref(jnp.asarray(scan), budget)
    _eq(o, jo)
    _eq(r, jr)


@pytest.mark.parametrize("w,budget", LBS_SWEEP)
def test_lbs_plain_matches_pallas_interpret(w, budget):
    """Against the TPU kernel itself (interpret mode): owner on the first
    ``total`` units (the kernel pads W, so its owner past the total is the
    padded width), rank on every unit."""
    scan = _scan(np.random.default_rng(100 + w).integers(0, 9, size=w))
    o, r = lbs(torch.from_numpy(scan), budget)
    po, pr = lbs_pallas(jnp.asarray(scan), budget, interpret=True)
    total = min(int(scan[-1]), budget)
    _eq(o[:total], np.asarray(po)[:total])
    _eq(r, pr)


@pytest.mark.parametrize("w,budget", LBS_SWEEP)
def test_searchsorted_right_matches_jax(w, budget):
    scan = _scan(np.random.default_rng(200 + w).integers(0, 9, size=w))
    k = np.arange(budget, dtype=np.int32)
    got = searchsorted_right(torch.from_numpy(scan), torch.from_numpy(k))
    assert got.dtype == torch.int32
    _eq(got, j_searchsorted_right(jnp.asarray(scan), jnp.asarray(k)))


def test_lbs_zero_degrees_and_budget_past_total():
    scan = _scan(np.array([0, 0, 5, 0, 3, 0]))
    o, r = lbs(torch.from_numpy(scan), 64)
    jo, jr = j_lbs_ref(jnp.asarray(scan), 64)
    _eq(o, jo)
    _eq(r, jr)
    assert set(o[:8].tolist()) <= {2, 4}   # only nonzero rows own units
    assert (o[8:] == 6).all()              # past the total: owner = W


# -------------------------------------------------------- B2, compaction
@pytest.mark.parametrize("n", [1, 5, 255, 256, 257, 1000, 2048])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_plain_matches_jax(n, p):
    rng = np.random.default_rng(n * 10 + int(p * 10))
    items = rng.integers(-1000, 1000, size=n).astype(np.int32)
    mask = rng.random(n) < p
    out, cnt = compact(torch.from_numpy(items), torch.from_numpy(mask))
    for jout, jcnt in (j_compact_ref(jnp.asarray(items), jnp.asarray(mask)),
                       j_compact(jnp.asarray(items), jnp.asarray(mask))):
        _eq(out, jout)
        assert int(cnt) == int(jcnt)
    assert out.dtype == torch.int32 and cnt.dtype == torch.int32
    assert cnt.dim() == 0


@pytest.mark.parametrize("n", [3072, 4097, 10_001, 65_537])
@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_compact_plain_matches_jax_across_many_tiles(n, p):
    """N across many 1024-item tiles (and the CUDA kernel's 4096-item
    tiles), against JAX's ``compact_ref``."""
    rng = np.random.default_rng(n + int(p * 10))
    items = rng.integers(-2 ** 31, 2 ** 31 - 1, size=n).astype(np.int32)
    mask = rng.random(n) < p
    out, cnt = compact(torch.from_numpy(items), torch.from_numpy(mask))
    jout, jcnt = j_compact_ref(jnp.asarray(items), jnp.asarray(mask))
    _eq(out, jout)
    assert int(cnt) == int(jcnt)


def test_compact_is_stable():
    out, cnt = compact_ref(torch.arange(600, dtype=torch.int32),
                           torch.arange(600) % 3 == 0)
    got = out[:int(cnt)].numpy()
    assert (np.diff(got) > 0).all()
    assert (out[int(cnt):] == 0).all()


# ------------------------------------------- Expansion over a wrapped ring
@pytest.fixture(scope="module")
def wrapped_wavefronts():
    """The regime of test_kernels.py's multi-tile case: chunk wavefronts
    popped across a wrapped ring head whose degree sum spills past one LBS
    tile, made by the JAX queue and handed to the port as numpy."""
    jg = j_rmat(8, 8, seed=3)
    out = {}
    # (ring capacity, first push, pop, second push); the g1 ring is wider so
    # that its single-row wavefront also spills past one tile
    rings = {1: (256, 192, 160, 192), 4: (64, 48, 40, 48)}
    for g, (cap, first, popped, second) in rings.items():
        codec = JCodec(g)
        n = jg.num_vertices
        local = np.random.default_rng(7)

        def chunks(k, base):
            heads = local.integers(0, n - 4, size=k).astype(np.int32) + base
            widths = local.integers(1, g + 1, size=k).astype(np.int32)
            return codec.encode(jnp.asarray(heads % (n - 4)),
                                jnp.asarray(widths))

        q = j_make_queue(cap)
        q = q.push_dense(chunks(first, 0))
        _, _, q = q.pop(popped)
        q = q.push_dense(chunks(second, 100))
        head_before = int(q.head)
        items, valid, q = q.pop(cap)
        assert head_before + int(np.asarray(valid).sum()) > cap
        safe = jnp.where(valid, items, 0)
        heads, widths = codec.decode(safe)
        out[g] = (jg, heads, widths, valid)
    return out


def _port_graph(jg):
    return graph_from_numpy(np.asarray(jg.row_ptr), np.asarray(jg.col_idx),
                            device="cpu")


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("budget", [1024, 4096])
def test_expansion_fields_match_jax_on_both_paths(wrapped_wavefronts, g,
                                                  budget):
    jg, heads, widths, valid = wrapped_wavefronts[g]
    total = int(jnp.cumsum(j_chunk_degrees(heads, widths, valid,
                                           jg.row_ptr))[-1])
    assert total > 1024                     # multi-tile
    jw = widths if g > 1 else None
    ref = j_expand(heads, valid, jg.row_ptr, jg.col_idx, budget, widths=jw,
                   max_width=g)
    pal = j_frontier(heads, valid, jg.row_ptr, jg.col_idx, budget,
                     interpret=True, widths=jw, max_width=g)
    pg = _port_graph(jg)
    th = torch.from_numpy(np.asarray(heads))
    tv = torch.from_numpy(np.asarray(valid))
    tw = torch.from_numpy(np.asarray(widths)) if g > 1 else None
    plain = expand_merge_path(th, tv, pg.row_ptr, pg.col_idx, budget,
                              backend="torch", widths=tw, max_width=g)
    glue = frontier_expand(th, tv, pg.row_ptr, pg.col_idx, budget,
                           widths=tw, max_width=g)
    for name, got in (("plain", plain), ("kernel glue", glue)):
        for field, x, y, z in zip(ref._fields, got, ref, pal):
            _eq(x, y, f"{name} {field} vs jnp")
            _eq(x, z, f"{name} {field} vs pallas")


def test_expand_per_item_matches_jax(wrapped_wavefronts):
    jg, heads, _, valid = wrapped_wavefronts[1]
    max_degree = int(jnp.max(jg.degrees()))
    ref = j_expand_per_item(heads, valid, jg.row_ptr, jg.col_idx, max_degree)
    pg = _port_graph(jg)
    got = expand_per_item(torch.from_numpy(np.asarray(heads)),
                          torch.from_numpy(np.asarray(valid)), pg.row_ptr,
                          pg.col_idx, max_degree)
    for field, x, y in zip(ref._fields, got, ref):
        _eq(x, y, field)


def test_codec_matches_jax():
    rng = np.random.default_rng(5)
    for g in (1, 2, 4, 8, 64):
        v = rng.integers(0, 1 << 20, size=100).astype(np.int32)
        w = rng.integers(1, g + 1, size=100).astype(np.int32)
        jc, tc = JCodec(g), ChunkCodec(g)
        code = tc.encode(torch.from_numpy(v), torch.from_numpy(w))
        _eq(code, jc.encode(jnp.asarray(v), jnp.asarray(w)))
        _eq(tc.head(code), v)
        _eq(tc.width(code), w)


def test_ring_pop_from_numpy_queue():
    """The mid-drain ring handed across by ``queue_from_numpy`` pops the
    same wavefront in both packages."""
    q = j_make_queue(16, jnp.arange(12, dtype=jnp.int32))
    _, _, q = q.pop(10)
    q = q.push_dense(jnp.arange(100, 110, dtype=jnp.int32))
    tq = queue_from_numpy(np.asarray(q.buf), np.asarray(q.head),
                          np.asarray(q.tail), np.asarray(q.dropped),
                          device="cpu")
    ji, jv, _ = q.pop(8)
    ti, tv, _ = tq.pop(8)
    _eq(ti, ji)
    _eq(tv, jv)
