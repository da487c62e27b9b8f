"""The port's packed lane encoding (``repro_torch.server.encoding``) against
the reference's (``repro.server.encoding``), bit for bit: every function on
seeded int32 arrays and on the boundary cases of ``tests/test_encoding.py``
(the last job id, ±MAX_NATURAL, -(MAX_NATURAL + 1), INT_MIN and INT_MAX,
naturals past the payload that wrap), and the admission check at its exact
limit for every granularity."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.task import ChunkCodec as JCodec
from repro.server import encoding as je
from repro_torch.core import ChunkCodec
from repro_torch.server import encoding as te

INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1
BOUNDARY = np.array([0, 1, -1, 2, -2, te.MAX_NATURAL, -te.MAX_NATURAL,
                     -(te.MAX_NATURAL + 1), te.MAX_NATURAL + 1,
                     -(te.MAX_NATURAL + 2), 2 ** 24, -(2 ** 24), 2 ** 30,
                     INT_MIN, INT_MAX, INT_MIN + 1, INT_MAX - 1],
                    dtype=np.int32)


def _seeded(seed: int, size: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    wide = rng.integers(INT_MIN, INT_MAX, size=size, endpoint=True)
    narrow = rng.integers(-te.MAX_NATURAL - 1, te.MAX_NATURAL, size=size,
                          endpoint=True)
    return np.concatenate([wide, narrow, BOUNDARY]).astype(np.int32)


def _same(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    assert port.dtype == torch.int32 and ref.dtype == np.int32
    np.testing.assert_array_equal(port.numpy(), ref)


def test_constants_match():
    for name in ("PAYLOAD_BITS", "PAYLOAD_MASK", "MAX_JOBS", "MAX_NATURAL"):
        assert getattr(te, name) == getattr(je, name), name


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["zigzag", "unzigzag", "unpack_job",
                                "unpack_natural"])
def test_unary_functions_bit_for_bit(fn, seed):
    x = _seeded(seed)
    _same(getattr(te, fn)(torch.from_numpy(x)),
          getattr(je, fn)(jnp.asarray(x)))


@pytest.mark.parametrize("job_id", [0, 1, 77, te.MAX_JOBS - 1])
def test_pack_bit_for_bit_and_round_trips(job_id):
    x = _seeded(job_id)
    packed = te.pack(job_id, torch.from_numpy(x))
    _same(packed, je.pack(job_id, jnp.asarray(x)))
    # a job id given as a tensor packs the same bits
    _same(te.pack(torch.tensor(job_id, dtype=torch.int32),
                  torch.from_numpy(x)), je.pack(job_id, jnp.asarray(x)))
    # the job field is never corrupted, and naturals inside the payload
    # survive; the sign bit stays clear
    assert (te.unpack_job(packed) == job_id).all()
    inside = (x >= -(te.MAX_NATURAL + 1)) & (x <= te.MAX_NATURAL)
    np.testing.assert_array_equal(te.unpack_natural(packed).numpy()[inside],
                                  x[inside])
    assert (packed >= 0).all()


def test_pack_broadcasts_per_item_job_ids():
    rng = np.random.default_rng(5)
    jobs = rng.integers(0, te.MAX_JOBS, size=512).astype(np.int32)
    x = _seeded(5, size=256)[:512]
    _same(te.pack(torch.from_numpy(jobs), torch.from_numpy(x)),
          je.pack(jnp.asarray(jobs), jnp.asarray(x)))


def test_beyond_boundary_wraps_like_the_reference():
    """One past the payload is lossy in both packages, identically, and
    never reaches the job bits."""
    for v in (te.MAX_NATURAL + 1, -(te.MAX_NATURAL + 2), INT_MAX, INT_MIN):
        p = te.pack(te.MAX_JOBS - 1, torch.tensor([v], dtype=torch.int32))
        _same(p, je.pack(je.MAX_JOBS - 1, jnp.asarray([v], jnp.int32)))
        assert int(te.unpack_job(p)) == te.MAX_JOBS - 1
    assert int(te.zigzag(torch.tensor(-(te.MAX_NATURAL + 1)))) == \
        (1 << te.PAYLOAD_BITS) - 1


@pytest.mark.parametrize("g", [1, 3, 4, 64])
def test_packed_width_bit_for_bit(g):
    rng = np.random.default_rng(g)
    codes = rng.integers(0, 1 << 17, size=1024).astype(np.int32)
    packed = te.pack(3, torch.from_numpy(codes))
    _same(te.packed_width(ChunkCodec(g).width)(packed),
          je.packed_width(JCodec(g).width)(jnp.asarray(packed.numpy())))


def _raises(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 8, 16, 33, 64])
def test_check_job_fits_at_its_limit(g):
    """The largest admissible graph at each granularity, and one past it,
    decided alike by both packages (same messages)."""
    bits = (g - 1).bit_length()
    # max_code(n + 1) + 1 = (n << bits) | mask + 1 must stay <= MAX_NATURAL
    largest = (te.MAX_NATURAL - 1 - ((1 << bits) - 1)) >> bits
    for n in (1, largest - 1, largest, largest + 1, largest + 2):
        for job in (0, te.MAX_JOBS - 1):
            got = _raises(te.check_job_fits, job, n, granularity=g)
            assert got == _raises(je.check_job_fits, job, n, granularity=g)
            assert (got is None) == (n <= largest), (n, largest)
    for job in (-1, te.MAX_JOBS):
        got = _raises(te.check_job_fits, job, 16, granularity=g)
        assert got is not None and got == _raises(je.check_job_fits, job,
                                                  16, granularity=g)


def test_chunk_codec_max_code_matches():
    for g in (1, 2, 3, 4, 7, 8, 64):
        for n in (0, 1, 2, 1000, 2 ** 21):
            assert ChunkCodec(g).max_code(n) == JCodec(g).max_code(n)


def test_rmat21_admission_at_the_main_path_widths():
    """rmat(21): g1 and g2 fit, g4 needs codes up to 8,388,612; grid2d
    (1024^2) fits at g4."""
    n = 2 ** 21
    te.check_job_fits(0, n, granularity=1)
    te.check_job_fits(0, n, granularity=2)
    with pytest.raises(ValueError, match="8388612 > 8388606"):
        te.check_job_fits(0, n, granularity=4)
    te.check_job_fits(0, 1024 * 1024, granularity=4)
