"""The port's first slice end to end against the JAX package: the XGBoost
mask-fold CV sweep, the refit of the winner and its scoring.

On the CPU the JAX validator fits each fold with fit_gbt + grow_tree (its
fold-fused route needs a TPU), while the port always takes the fold-fused
fit, so the two agree at the metric level: the same winning grid point,
each cell's mean fold AuPR within 5e-3, and the refit winner's holdout AuPR
within 1e-3. Carried-over parameters (convert.py) score identically.
"""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu.automl.tuning.validators import \
    CrossValidation as JCrossValidation
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEvaluators
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops import metrics_ops as JM
from transmogrifai_tpu.ops import trees as JT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl.tuning.validators import (
    CrossValidation, TrainValidationSplit)
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

# well-separated grid points: the winner must not hinge on a near tie
GRIDS = [dict(num_round=3, max_depth=1, eta=0.05, max_bins=32),
         dict(num_round=4, max_depth=2, eta=0.1, max_bins=32),
         dict(num_round=8, max_depth=3, eta=0.3, max_bins=32),
         dict(num_round=2, max_depth=3, eta=0.02, reg_lambda=5.0,
              max_bins=32)]


def _data(n=4000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 0] = np.nan
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    logit = (1.5 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2]
             + np.sin(2 * X[:, 4]) - 0.5)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def fitted():
    """Both packages' sweeps and refits on one seeded split (module-scoped:
    the JAX sweep compiles once per grid point)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TMOG_NO_HOST_TREES", "1")
    try:
        X, y = _data()
        Xtr, ytr, Xho, yho = X[:3000], y[:3000], X[3000:], y[3000:]
        jbest = JCrossValidation(
            JEvaluators.BinaryClassification.au_pr(), num_folds=3
        ).validate([(JXGB(), [dict(g) for g in GRIDS])], Xtr, ytr)
        jmodel = jbest.estimator.fit_arrays(Xtr, ytr)
        pbest = CrossValidation(
            Evaluators.BinaryClassification.au_pr(), num_folds=3,
            device="cpu"
        ).validate([(OpXGBoostClassifier(device="cpu"),
                     [dict(g) for g in GRIDS])], Xtr, ytr)
        pmodel = pbest.estimator.fit_arrays(Xtr, ytr)
    finally:
        mp.undo()
    return dict(jbest=jbest, pbest=pbest, jmodel=jmodel, pmodel=pmodel,
                Xho=Xho, yho=yho)


def test_sweep_picks_the_same_winner(fitted):
    jbest, pbest = fitted["jbest"], fitted["pbest"]
    assert pbest.best_grid == jbest.best_grid
    assert pbest.estimator.get_param("max_depth") == \
        jbest.estimator.get_param("max_depth")
    for jv, pv in zip(jbest.validated, pbest.validated):
        assert pv.grid == jv.grid and pv.route == "mask_folds"
        assert len(pv.fold_metrics) == 3
        assert abs(pv.mean_metric - jv.mean_metric) < 5e-3, (pv.grid,
                                                              pv.mean_metric,
                                                              jv.mean_metric)


def test_refit_winner_holdout_aupr(fitted):
    Xho, yho = fitted["Xho"], fitted["yho"]
    _, _, jprob = fitted["jmodel"].predict_arrays(Xho)
    pred, raw, pprob = fitted["pmodel"].predict_arrays(Xho)
    assert pprob.shape == (len(yho), 2) and raw.shape == (len(yho), 2)
    assert np.isfinite(pprob).all()
    np.testing.assert_array_equal(pred, (pprob[:, 1] >= 0.5))
    j = float(JM.au_pr(jprob[:, 1], yho))
    p = Evaluators.BinaryClassification.au_pr().evaluate(yho, pprob[:, 1])
    assert p > yho.mean() + 0.2            # far above the label prevalence
    assert abs(p - j) < 1e-3, (p, j)


def test_jax_fitted_model_scores_identically_in_the_port(fitted):
    Xho = fitted["Xho"]
    jm = fitted["jmodel"]
    pm = convert.tree_model_from_jax(jm.save_args(), device="cpu")
    _, jraw, jprob = jm.predict_arrays(Xho)
    _, praw, pprob = pm.predict_arrays(Xho)
    np.testing.assert_allclose(pprob, jprob, rtol=0, atol=1e-6)
    np.testing.assert_allclose(praw, jraw, rtol=0, atol=1e-5)


def test_tree_from_jax_freezes_like_jax():
    """A JAX-grown binned Tree carried over freezes to the same raw-value
    thresholds in both packages."""
    import jax
    import jax.numpy as jnp
    X, y = _data(n=1200, seed=3)
    edges = JT.quantile_edges(jnp.asarray(X), 16)
    Xb = JT.bin_matrix(jnp.asarray(X), edges)
    trees, _ = JT.fit_gbt(Xb, jnp.asarray(y), jnp.ones_like(jnp.asarray(y)),
                          jax.random.PRNGKey(0), n_rounds=2, depth=3,
                          n_bins=16)
    tree = convert.tree_from_jax(trees.feat, trees.thresh, trees.leaf,
                                 trees.miss, device="cpu")
    want = JXGB()._freeze(trees, edges)
    got = OpXGBoostClassifier(device="cpu")._freeze(
        tree, torch.from_numpy(np.array(edges)))
    for k in ("feat", "thresh_val", "leaf", "miss"):
        np.testing.assert_array_equal(got[k], want[k])


def test_train_validation_split_and_unported_routes():
    X, y = _data(n=600, seed=5)
    tvs = TrainValidationSplit(Evaluators.BinaryClassification.au_roc(),
                               device="cpu")
    best = tvs.validate([(OpXGBoostClassifier(device="cpu"), GRIDS[:2])],
                        X, y)
    assert len(best.validated[0].fold_metrics) == 1
    assert 0.5 < best.best_metric <= 1.0
    # softmax boosting has no scalar prior: a base_score raises
    with pytest.raises(ValueError, match="base_score"):
        OpXGBoostClassifier(device="cpu", base_score=0.5).fit_arrays(
            X, np.where(y > 0, 2, 0))
    with pytest.raises(ValueError, match="unknown problem type"):
        tvs.validate([(OpXGBoostClassifier(device="cpu"), GRIDS[:1])], X, y,
                     problem_type="ranking")


def test_fit_on_cuda_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data(n=100, seed=6)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OpXGBoostClassifier().fit_arrays(X, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CrossValidation(Evaluators.BinaryClassification.au_pr()).validate(
            [(OpXGBoostClassifier(), GRIDS[:1])], X, y)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, transmogrifai_tpu_torch\n"
            "import transmogrifai_tpu_torch.automl.tuning.validators\n"
            "import transmogrifai_tpu_torch.convert\n"
            "from transmogrifai_tpu_torch.stages import registry\n"
            "assert 'DateMapUnitCircleModel' in registry.stage_registry()\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'transmogrifai_tpu' or "
            "m.startswith('transmogrifai_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-S", "-c", code],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(pathlib.Path(__file__).resolve().parents[1]),
                         env={"PATH": "/usr/bin:/bin",
                              "PYTHONPATH": ":".join(p for p in sys.path
                                                     if p)})
    assert res.returncode == 0, res.stdout + res.stderr
