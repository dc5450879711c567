"""Port rank metrics (transmogrifai_tpu_torch/ops/metrics_ops.py) against the
JAX package's: exact sorted AuPR/AuROC with ties and weights, and the
lane-batched binned counts the sweep scores its folds with.

Counts of 0/1 labels under integer weights are exact in f32; metric values
agree within 1e-6 (f32 summation order differs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.ops import metrics_ops as JM
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.ops import metrics_ops as PM

TOL = 1e-6


def _scored(n, seed, ties=False, weights="unit"):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    s = (rng.normal(size=n) + 1.2 * y).astype(np.float32)
    if ties:
        s = np.round(s * 2) / 2           # many equal scores
    w = {"unit": np.ones(n, np.float32),
         "mask": (rng.uniform(size=n) < 0.7).astype(np.float32),
         "real": rng.uniform(0.2, 3.0, size=n).astype(np.float32)}[weights]
    return s, y, w


@pytest.mark.parametrize("metric", ["au_pr", "au_roc"])
@pytest.mark.parametrize("n,ties,weights", [
    (500, False, "unit"), (2000, True, "mask"), (1000, True, "real")])
def test_exact_rank_metrics_match_jax(metric, n, ties, weights):
    s, y, w = _scored(n, seed=n, ties=ties, weights=weights)
    want = float(getattr(JM, metric)(jnp.asarray(s), jnp.asarray(y),
                                     jnp.asarray(w)))
    got = float(getattr(PM, metric)(torch.from_numpy(s), torch.from_numpy(y),
                                    torch.from_numpy(w)))
    assert abs(got - want) < TOL, (got, want)


@pytest.mark.parametrize("L,n,n_bins,weights", [
    (5, 800, 4096, "mask"), (3, 1000, 256, "unit"), (2, 700, 4096, "real")])
def test_binned_lanes_match_jax(L, n, n_bins, weights):
    rng = np.random.default_rng(L * n)
    s = rng.normal(size=(L, n)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.4).astype(np.float32)
    wl = np.stack([_scored(n, seed=k, weights=weights)[2] for k in range(L)])
    args_j = [jnp.asarray(a) for a in (s, y, wl)]
    args_p = [torch.from_numpy(a) for a in (s, y, wl)]
    tj, fj = JM.binned_cum_counts_lanes(*args_j, n_bins)
    tp, fp = PM.binned_cum_counts_lanes(*args_p, n_bins)
    exact = weights != "real"
    for got, want in ((tp, tj), (fp, fj)):
        if exact:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-4)
    for name in ("au_pr_binned_lanes", "au_roc_binned_lanes"):
        want = np.asarray(getattr(JM, name)(*args_j, n_bins))
        got = getattr(PM, name)(*args_p, n_bins).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_evaluators_on_arrays():
    s, y, w = _scored(900, seed=4, ties=True, weights="mask")
    p = 1 / (1 + np.exp(-s))                       # probabilities rank alike
    for make, metric in ((Evaluators.BinaryClassification.au_pr, "au_pr"),
                         (Evaluators.BinaryClassification.au_roc, "au_roc")):
        ev = make()
        assert ev.default_metric == metric and ev.is_larger_better()
        want = float(getattr(JM, metric)(jnp.asarray(s), jnp.asarray(y),
                                         jnp.asarray(w)))
        assert abs(ev.evaluate(y, p, w) - want) < 1e-5
