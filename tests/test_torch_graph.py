"""The PyTorch port's CSR graphs against the JAX package's: one seed gives
byte-identical ``row_ptr``/``col_idx`` and the same degree statistics."""
import numpy as np
import pytest
import torch

import repro.graph as jg
import repro_torch.graph as tg
from repro.algorithms.common import default_work_budget as j_budget
from repro_torch.algorithms.common import default_work_budget, max_degree_of
from repro_torch.convert import graph_from_numpy, to_numpy

GRAPHS = {
    "rmat(8,8,1)": (lambda: jg.rmat(8, 8, seed=1),
                    lambda: tg.rmat(8, 8, seed=1, device="cpu")),
    "rmat(10,16,7)": (lambda: jg.rmat(10, 16, seed=7),
                      lambda: tg.rmat(10, 16, seed=7, device="cpu")),
    "grid2d(16,16)": (lambda: jg.grid2d(16, 16),
                      lambda: tg.grid2d(16, 16, device="cpu")),
    "grid2d(12,9,extra)": (lambda: jg.grid2d(12, 9, seed=3, extra_frac=0.2),
                           lambda: tg.grid2d(12, 9, seed=3, extra_frac=0.2,
                                             device="cpu")),
    "erdos(200,800,2)": (lambda: jg.erdos(200, 800, seed=2),
                         lambda: tg.erdos(200, 800, seed=2, device="cpu")),
}


@pytest.fixture(scope="module", params=list(GRAPHS))
def pair(request):
    make_j, make_t = GRAPHS[request.param]
    return make_j(), make_t()


def test_csr_byte_identical(pair):
    j, t = pair
    assert t.row_ptr.dtype == torch.int32 and t.col_idx.dtype == torch.int32
    np.testing.assert_array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr))
    np.testing.assert_array_equal(t.col_idx.numpy(), np.asarray(j.col_idx))
    assert (t.num_vertices, t.num_edges) == (j.num_vertices, j.num_edges)
    np.testing.assert_array_equal(t.degrees().numpy(), np.asarray(j.degrees()))


def test_degree_stats_and_budget_match(pair):
    j, t = pair
    assert tg.degree_stats(t) == jg.degree_stats(j)
    assert max_degree_of(t) == int(np.asarray(j.degrees()).max())
    for wavefront in (1, 64, 4096):
        assert default_work_budget(t, wavefront) == j_budget(j, wavefront)


@pytest.mark.parametrize("seed", range(4))
def test_from_edges_dedupes_like_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 60))
    src = rng.integers(0, n, size=4 * n)
    dst = rng.integers(0, n, size=4 * n)
    for sym in (False, True):
        j = jg.from_edges(n, src, dst, symmetrize=sym)
        t = tg.from_edges(n, src, dst, symmetrize=sym, device="cpu")
        np.testing.assert_array_equal(t.row_ptr.numpy(), np.asarray(j.row_ptr))
        np.testing.assert_array_equal(t.col_idx.numpy(), np.asarray(j.col_idx))


def test_graph_handed_across_as_numpy(pair):
    j, _ = pair
    t = graph_from_numpy(np.asarray(j.row_ptr), np.asarray(j.col_idx),
                         device="cpu")
    back = to_numpy(t.to("cpu"))
    np.testing.assert_array_equal(back.row_ptr, np.asarray(j.row_ptr))
    np.testing.assert_array_equal(back.col_idx, np.asarray(j.col_idx))
