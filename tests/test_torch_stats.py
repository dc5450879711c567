"""The port's one-pass statistics engine against the JAX package's.

The same seeded matrices go through `stats_engine.run_stats` of both
packages, the port on the CPU through its fused route and through its
streamed route with the tile rows forced small (host float64 merge of
per-tile states), each held to the JAX single-program route. Tolerances:
non-zero counts and min / max exact; under unit weights the counts and the
contingency tables of integer-valued columns exact too (integer sums in
f32); moments, correlations, the Pearson matrix, the other columns'
contingency sums, and every sum under non-integer row weights within
rtol 1e-5 / atol 1e-6 (f32 reductions in another order,
docs/performance.md:718-736). One column has mean 1e4 and unit variance:
without the first-tile shift and Chan's merge its f32 variance would lose
its digits, and its correlation with the label is held to the float64
value within 1e-7 on every route.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import stats as JS
from transmogrifai_tpu.ops import stats_engine as JE

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.ops import stats_engine as PE

RTOL, ATOL = 1e-5, 1e-6
EXACT = ("num_non_zeros", "min", "max", "label_min", "label_max")
COUNTS = ("count", "wsum", "label_count")
INTEGER_COLUMNS = [2, 3, 4, 7]   # indicator, multi-hot, constant, ties
CLOSE = ("mean", "variance", "m2", "fill_rate", "corr_label", "label_mean",
         "label_variance")


def data(n=5000, seed=0, weights=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 9)).astype(np.float32)
    X[:, 1] = 1e4 + rng.normal(size=n)                 # large mean, unit var
    X[:, 2] = (rng.uniform(size=n) < 0.3)              # indicator
    X[:, 3] = (rng.uniform(size=n) < 0.5) * 2.0        # multi-hot count
    X[:, 4] = 0.0                                      # constant
    X[rng.uniform(size=n) < 0.1, 5] = np.nan
    X[rng.uniform(size=n) < 0.05, 6] = np.inf
    X[:, 7] = rng.integers(0, 5, size=n)               # ties
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-X[:, 0] - X[:, 2]))
         ).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32) if weights else None
    return X, y, w


def compare(got, want, weighted=False):
    for k in COUNTS:
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=RTOL if weighted else 0, err_msg=k)
    for k in EXACT:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)), err_msg=k)
    for k in CLOSE:
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k in ("corr_matrix",):
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    if want.contingency is not None:
        ints = INTEGER_COLUMNS
        np.testing.assert_allclose(got.contingency[ints],
                                   want.contingency[ints],
                                   rtol=RTOL if weighted else 0)
        np.testing.assert_allclose(got.contingency, want.contingency,
                                   rtol=RTOL)


@pytest.mark.parametrize("route,tile_rows", [("fused", None),
                                             ("streamed", 700),
                                             ("streamed", 5000)])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("extras", ["moments", "matrix", "contingency"])
def test_run_stats_matches_the_jax_engine(route, tile_rows, weights, extras):
    X, y, w = data(weights=weights)
    kw = {}
    if extras == "matrix":
        kw["corr_matrix"] = True
    if extras == "contingency":
        kw["distinct"] = np.unique(y)
        kw["clip"] = np.arange(X.shape[1]) == 3
    want = JE.run_stats(X, y, w, driver="fused", **kw)
    got = PE.run_stats(X, y, w, driver=route, tile_rows=tile_rows,
                       device="cpu", **kw)
    assert PE.last_pass["driver"] == route
    compare(got, want, weighted=weights)


@pytest.mark.parametrize("route,tile_rows", [("fused", None),
                                             ("streamed", 512)])
def test_large_mean_column_correlation_is_exact(route, tile_rows):
    X, y, _ = data(n=3000, seed=2)
    got = PE.run_stats(X, y, driver=route, tile_rows=tile_rows,
                       device="cpu")
    exact = np.corrcoef(X[:, 1].astype(np.float64), y)[0, 1]
    assert abs(got.corr_label[1] - exact) < 1e-7
    assert PE.last_pass["tiles"] == (6 if route == "streamed" else 1)


def test_large_mean_column_keeps_its_variance():
    X, y, _ = data(n=20000, seed=3)
    got = PE.run_stats(X, y, driver="streamed", tile_rows=4096,
                       corr_matrix=True, device="cpu")
    exact = np.var(X[:, 1].astype(np.float64), ddof=1)
    assert abs(got.variance[1] - exact) < 1e-4 * exact
    assert abs(got.corr_matrix[1, 1] - 1.0) < 1e-6


def test_router_streams_only_large_host_matrices(monkeypatch):
    X, y, _ = data(n=1000)
    PE.run_stats(X, y, device="cpu")
    assert PE.last_pass["driver"] == "fused"
    monkeypatch.setattr(PE, "STREAM_THRESHOLD_BYTES", X.nbytes - 1)
    PE.run_stats(X, y, device="cpu")
    assert PE.last_pass["driver"] == "streamed"
    # a matrix already in a tensor is never streamed
    PE.run_stats(torch.as_tensor(X), torch.as_tensor(y), device="cpu")
    assert PE.last_pass["driver"] == "fused"


@pytest.mark.parametrize("weights", [False, True])
def test_spearman_ranks_match(weights):
    X, y, w = data(n=2000, seed=4, weights=weights)
    jrx, jry = JE.rank_matrices(X, y, w, col_block=4)
    prx, pry = PE.rank_matrices(X, y, w, col_block=4, device="cpu")
    assert prx.is_contiguous()
    np.testing.assert_array_equal(prx.numpy(), np.asarray(jrx))
    np.testing.assert_array_equal(pry.numpy(), np.asarray(jry))
    want = JE.run_stats(jrx, jry, w).corr_label
    got = PE.run_stats(prx, pry, w, device="cpu").corr_label
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if not weights:   # the legacy per-column route agrees unweighted
        ref = np.asarray(JS.spearman_with_label(X, y))
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("table", [
    [[10, 0], [0, 10]], [[5, 5], [5, 5]], [[3, 1, 0], [0, 2, 7], [1, 1, 1]],
    [[0, 0], [4, 6]], [[12, 3]]])
def test_contingency_stats_match(table):
    want = JS.contingency_stats_host(np.asarray(table, float))
    got = PE.contingency_stats_host(np.asarray(table, float))
    for k in want._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, k)),
                                   np.asarray(getattr(want, k)),
                                   rtol=1e-12, atol=1e-12, err_msg=k)


def test_gram_cap():
    X = np.zeros((10, PE.GRAM_MAX_D + 1), np.float32)
    with pytest.raises(ValueError, match="capped"):
        PE.run_stats(X, np.zeros(10, np.float32), corr_matrix=True,
                     device="cpu")
