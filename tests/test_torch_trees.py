"""Port boosted-tree fit (transmogrifai_tpu_torch/ops/trees.py) against the
JAX package's: binning, the fold-fused fit and ensemble traversal.

The JAX fit runs its Pallas kernels in interpret mode with bf16 histogram
inputs off (set_hist_bf16(False)), so both packages accumulate f32
payloads. Tree decisions (feat, thresh, miss) must be identical; margins
agree to f32 summation order (tolerances stated at each test).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.ops import pallas_hist as PH
from transmogrifai_tpu.ops import trees as JT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.ops import trees as PT


@pytest.fixture
def f32_hist():
    prev = PH._HIST_BF16
    PH.set_hist_bf16(False)
    try:
        yield
    finally:
        PH.set_hist_bf16(prev)


def _features(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 7)).astype(np.float32)
    X[rng.uniform(size=n) < 0.15, 0] = np.nan          # missing values
    X[:, 3] = rng.integers(0, 4, size=n)               # discrete: ties
    X[:, 4] = np.round(X[:, 4] * 3) / 7                # repeated values
    X[:, 5] = 2.5                                      # constant
    X[:, 6] = np.nan                                   # all missing
    return X


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("n,n_bins", [(3000, 32), (140_000, 16)])
def test_quantile_edges_and_bins_identical(n, n_bins):
    """Above 131,072 rows both sketch a strided sample."""
    X = _features(n, seed=n)
    ej = np.asarray(JT.quantile_edges(jnp.asarray(X), n_bins))
    ep = PT.quantile_edges(torch.from_numpy(X), n_bins)
    np.testing.assert_array_equal(_np(ep), ej)            # NaN == NaN here
    bj = np.asarray(JT.bin_matrix(jnp.asarray(X), jnp.asarray(ej)))
    bp = PT.bin_matrix(torch.from_numpy(X), ep)
    assert bp.dtype == torch.int8 and bj.dtype == np.int8
    np.testing.assert_array_equal(_np(bp), bj)
    assert (_np(bp)[np.isnan(X)] == 0).all()


@pytest.mark.parametrize("n_bins,dtype", [(127, torch.int8),
                                          (255, torch.uint8),
                                          (256, torch.int32)])
def test_bin_dtype_widths(n_bins, dtype):
    assert PT.bin_dtype(n_bins) == dtype
    assert np.dtype(JT.bin_dtype(n_bins)) == np.dtype(
        str(dtype).replace("torch.", ""))


def test_thresholds_to_values_identical():
    X = _features(2000, seed=3)
    edges = np.array(JT.quantile_edges(jnp.asarray(X), 16))   # writable
    rng = np.random.default_rng(4)
    feat = rng.integers(0, 5, size=(3, 7)).astype(np.int32)
    thresh = rng.integers(0, 17, size=(3, 7)).astype(np.int32)  # 0 .. n_bins
    want = np.asarray(JT.thresholds_to_values(
        jnp.asarray(feat), jnp.asarray(thresh), jnp.asarray(edges)))
    got = PT.thresholds_to_values(torch.from_numpy(feat),
                                  torch.from_numpy(thresh),
                                  torch.from_numpy(edges))
    np.testing.assert_array_equal(_np(got), want)


def _fit_inputs(n, folds, unit_w, seed):
    X = _features(n, seed=seed)[:, :5]
    rng = np.random.default_rng(seed + 1)
    logit = 2.0 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - 0.5 * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    W = (rng.integers(0, folds, size=n)[None, :]
         != np.arange(folds)[:, None]).astype(np.float32)
    if not unit_w:
        W = W * rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    edges = np.asarray(JT.quantile_edges(jnp.asarray(X), 16))
    Xb = np.array(JT.bin_matrix(jnp.asarray(X), jnp.asarray(edges)))
    return Xb, y, W


@pytest.mark.parametrize("loss,unit_w,n,kw", [
    ("logistic", True, 1500, {}),
    ("squared", True, 1500, {}),
    # non-unit weights and a ragged row count (no 4096-row multiple)
    ("logistic", False, 1001, {}),
    # the XGBoost tail: L1, step cap, complexity penalty, pinned prior
    ("logistic", True, 1200, dict(alpha=0.5, max_delta_step=0.7, gamma=0.1,
                                  base_score=0.3)),
])
def test_fit_gbt_folds_matches_jax(f32_hist, loss, unit_w, n, kw):
    """Against both histogram paths of the reference: the Pallas kernels in
    interpret mode and the jnp twins. The two reference paths themselves
    differ by up to ~2e-5 in margins on this data (the interpret-mode
    one-hot contraction sums in another order, and sibling subtraction
    amplifies that in small children), so the port is held to atol 1e-5
    against the twins, whose segment sums it mirrors, and to 5e-5 against
    the interpret-mode kernels. Decisions must be identical against both.
    The base score is the log-odds of two weighted sums: exact sums for
    unit weights (one logf ulp apart at most), f32-order apart otherwise."""
    Xb, y, W = _fit_inputs(n, folds=3, unit_w=unit_w, seed=n)
    common = dict(n_rounds=4, depth=3, n_bins=16, learning_rate=0.3,
                  reg_lambda=1.0, min_child_weight=1.0, loss=loss, **kw)
    tp, bp, mp = PT.fit_gbt_folds(torch.from_numpy(Xb), torch.from_numpy(y),
                                  torch.from_numpy(W), **common)
    assert mp.shape == (3, n)
    for interpret, atol in ((True, 5e-5), (False, 1e-5)):
        tj, bj, mj = JT.fit_gbt_folds(jnp.asarray(Xb), jnp.asarray(y),
                                      jnp.asarray(W), jax.random.PRNGKey(0),
                                      interpret=interpret, **common)
        for field in ("feat", "thresh", "miss"):
            np.testing.assert_array_equal(_np(getattr(tp, field)),
                                          np.asarray(getattr(tj, field)))
        np.testing.assert_allclose(_np(bp), np.asarray(bj), atol=0,
                                   rtol=2.4e-7 if unit_w else 2e-6)
        np.testing.assert_allclose(_np(tp.leaf), np.asarray(tj.leaf),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(_np(mp), np.asarray(mj), rtol=0,
                                   atol=atol)


def test_fit_gbt_folds_lanes_are_independent():
    """A lane's fit does not depend on the other lanes it shares passes
    with: the 3-lane fit equals three 1-lane fits."""
    Xb, y, W = _fit_inputs(900, folds=3, unit_w=False, seed=9)
    kw = dict(n_rounds=3, depth=3, n_bins=16, learning_rate=0.2)
    Xt, yt = torch.from_numpy(Xb), torch.from_numpy(y)
    trees, base, margins = PT.fit_gbt_folds(Xt, yt, torch.from_numpy(W), **kw)
    for k in range(3):
        t1, b1, m1 = PT.fit_gbt_folds(Xt, yt, torch.from_numpy(W[k:k + 1]),
                                      **kw)
        torch.testing.assert_close(m1[0], margins[k], rtol=0, atol=1e-6)
        assert torch.equal(t1.feat[:, 0], trees.feat[:, k])
        assert float(b1[0]) == float(base[k])


def test_subsampled_fit_quality_gate(f32_hist):
    """Row and column subsampling draw from a torch.Generator, not JAX's
    threefry bits, so the draws differ: the two fits are held together at
    the metric level only (training AuPR within 0.03), and the port's fit
    is reproducible from its seed."""
    from transmogrifai_tpu.ops import metrics_ops as JM
    from transmogrifai_tpu_torch.ops import metrics_ops as PM
    Xb, y, W = _fit_inputs(1500, folds=2, unit_w=True, seed=21)
    kw = dict(n_rounds=6, depth=3, n_bins=16, learning_rate=0.3,
              subsample=0.7, feature_frac=0.6, colsample_bylevel=0.8)
    _, _, mj = JT.fit_gbt_folds(jnp.asarray(Xb), jnp.asarray(y),
                                jnp.asarray(W), jax.random.PRNGKey(3),
                                interpret=True, **kw)

    def port_fit():
        gen = torch.Generator().manual_seed(3)
        return PT.fit_gbt_folds(torch.from_numpy(Xb), torch.from_numpy(y),
                                torch.from_numpy(W), generator=gen, **kw)[2]
    mp = port_fit()
    assert torch.equal(mp, port_fit())
    for k in range(2):
        aj = float(JM.au_pr(mj[k], jnp.asarray(y), jnp.asarray(W[k])))
        ap = float(PM.au_pr(mp[k], torch.from_numpy(y),
                            torch.from_numpy(W[k])))
        assert abs(aj - ap) < 0.03, (aj, ap)
    with pytest.raises(ValueError, match="Generator"):
        PT.fit_gbt_folds(torch.from_numpy(Xb), torch.from_numpy(y),
                         torch.from_numpy(W), **kw)


def test_predict_ensemble_matches_numpy_traversal():
    rng = np.random.default_rng(5)
    T_, depth, F = 6, 3, 5
    X = rng.normal(size=(700, F)).astype(np.float32)
    X[rng.uniform(size=X.shape) < 0.1] = np.nan
    feat = rng.integers(0, F, size=(T_, 7)).astype(np.int32)
    tv = rng.normal(size=(T_, 7)).astype(np.float32)
    tv[0, 0], tv[1, 2] = np.inf, -np.inf                 # dead / all-right
    miss = rng.integers(0, 2, size=(T_, 7)).astype(np.int32)
    leaf = rng.normal(size=(T_, 8, 1)).astype(np.float32)
    want = JT.np_predict_ensemble(feat, tv, leaf, X, depth, miss=miss)
    got = PT.predict_ensemble(*[torch.from_numpy(a) for a in
                                (feat, tv, leaf, X)], depth,
                              miss=torch.from_numpy(miss))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-6)
