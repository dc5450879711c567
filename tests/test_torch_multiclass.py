"""The port's multiclass slice against the JAX package, on the CPU: the
multiclass and thresholded metrics, the evaluators, DataCutter, the
softmax and naive Bayes solvers, the softmax lane sweep, K-class forests
and softmax boosting, the models carried across, the selector's defaults.

The same seeded numpy inputs go through both packages. Tolerances: counts
exact; metrics within 1e-6; `fit_softmax` coefficients within 1e-4 and its
probabilities within 1e-5; naive Bayes log-probabilities within 1e-6
relative; tree splits identical (these fits are shallow, their gains well
separated) and leaves within 1e-5; fold metrics within 5e-3 with the same
winner; scores within 1e-5. Forests draw the reference's bootstrap weights
and node masks (`test_torch_tree_models._ReferenceDraws`); the JAX package
takes its device route (TMOG_NO_HOST_TREES=1).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.automl import selectors as JS
from transmogrifai_tpu.automl.tuning import splitters as JSp
from transmogrifai_tpu.automl.tuning import validators as JV
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEv
from transmogrifai_tpu.models import glm as JG
from transmogrifai_tpu.models import trees as JM
from transmogrifai_tpu.models.prediction import make_prediction_column as jcol
from transmogrifai_tpu.ops import glm as JOG
from transmogrifai_tpu.ops import metrics_ops as JMO
from transmogrifai_tpu.ops import trees as JT

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl import selectors as PS
from transmogrifai_tpu_torch.automl.tuning import splitters as PSp
from transmogrifai_tpu_torch.automl.tuning import validators as PV
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PEv
from transmogrifai_tpu_torch.models import glm as PG
from transmogrifai_tpu_torch.models import trees as PM
from transmogrifai_tpu_torch.models.prediction import \
    make_prediction_column as pcol
from transmogrifai_tpu_torch.ops import glm as POG
from transmogrifai_tpu_torch.ops import metrics_ops as PMO
from transmogrifai_tpu_torch.ops import trees as PT

import chip_smoke
from test_torch_tree_models import _ReferenceDraws


def _data(n=900, K=3, seed=0, d=5):
    """Features with 10% missing in one column and K classes cut from a
    noisy linear score, so trees and GLMs separate them only in part."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    score = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 2] \
        + 0.5 * rng.normal(size=n)
    y = np.digitize(score, np.quantile(score, np.arange(1, K) / K))
    X[rng.uniform(size=n) < 0.1, 3] = np.nan
    return X, y.astype(np.float32)


@pytest.fixture
def reference_draws(monkeypatch):
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")

    def use(n_trees):
        monkeypatch.setattr(PT, "ForestDraws", lambda *a, **kw:
                            _ReferenceDraws(n_trees, *a, **kw))
    return use


# -- metrics -------------------------------------------------------------------

@pytest.mark.parametrize("K,weighted", [(3, False), (7, True)])
def test_multiclass_metrics_match_jax(K, weighted):
    rng = np.random.default_rng(K)
    n = 2000
    y = rng.integers(0, K, n).astype(np.float32)
    pred = np.where(rng.uniform(size=n) < 0.6, y,
                    rng.integers(0, K, n)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, n).astype(np.float32) if weighted else None
    got = PMO.multiclass_metrics(torch.from_numpy(pred), torch.from_numpy(y),
                                 K, None if w is None else torch.from_numpy(w))
    want = JMO.multiclass_metrics(pred, y, K, None if w is None
                                  else jnp.asarray(w))
    for a, b in zip(got, want):
        assert abs(float(a) - float(b)) <= 1e-6


def test_threshold_metrics_match_jax():
    """Ties inside a row (the stable-sort rank rule), scores on the
    thresholds, labels outside [0, C): the counts equal."""
    rng = np.random.default_rng(4)
    n, C = 1500, 5
    raw = np.round(rng.uniform(size=(n, C)) * 20) / 20
    probs = (raw / np.maximum(raw.sum(1, keepdims=True), 1e-9)) \
        .astype(np.float32)
    probs[::7] = np.float32(0.2)                # five-way ties
    labels = rng.integers(-1, C + 1, n).astype(np.float32)
    got = PMO.multiclass_threshold_metrics(torch.from_numpy(probs),
                                           torch.from_numpy(labels))
    want = JMO.multiclass_threshold_metrics(probs, labels)
    assert got.top_ns == want.top_ns == (1, 3)
    for f in ("correct_counts", "incorrect_counts", "no_prediction_counts"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.to_json() == want.to_json()


@pytest.mark.parametrize("metric", ["precision", "recall", "f1", "error",
                                    "brier_score"])
def test_binary_thresholded_evaluators_match_jax(metric):
    rng = np.random.default_rng(9)
    n = 1200
    y = rng.integers(0, 2, n).astype(np.float32)
    p1 = np.clip(0.3 * y + 0.7 * rng.uniform(size=n), 0, 1).astype(np.float32)
    prob = np.stack([1 - p1, p1], 1)
    raw = np.stack([-p1, p1], 1)
    pred = (p1 >= 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, n).astype(np.float32)
    pe = getattr(PEv.BinaryClassification, metric)()
    pe.device = "cpu"
    je = getattr(JEv.BinaryClassification, metric)()
    got = pe.evaluate_all(y, pcol(pred, raw, prob), w)
    want = je.evaluate_all(y, jcol(pred, raw, prob), w)
    assert pe.default_metric == je.default_metric == metric
    assert abs(got[metric] - want[metric]) <= 1e-6
    assert pe.is_larger_better() == je.is_larger_better()
    if metric != "brier_score":   # the sweep's thresholded branch
        s = np.log(p1 / (1 - p1 + 1e-9) + 1e-9).astype(np.float32)
        fn_p = PV._metric_fn("binary", metric)
        fn_j = JV._metric_fn("binary", metric)
        assert abs(float(fn_p(torch.from_numpy(s), torch.from_numpy(y),
                              torch.from_numpy(w), 0.1))
                   - float(fn_j(jnp.asarray(s), jnp.asarray(y),
                                jnp.asarray(w), 0.1))) <= 1e-6


def test_multiclass_evaluator_matches_jax():
    rng = np.random.default_rng(12)
    n, C = 800, 4
    y = rng.integers(0, C, n).astype(np.float32)
    logits = rng.normal(size=(n, C)).astype(np.float32)
    logits[np.arange(n), y.astype(int)] += 1.0
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    pred = prob.argmax(1).astype(np.float32)
    for metric in ("error", "f1", "precision", "recall"):
        pe = getattr(PEv.MultiClassification, metric)()
        pe.device = "cpu"
        je = getattr(JEv.MultiClassification, metric)()
        got = pe.evaluate_all(y, pcol(pred, logits, prob))
        want = je.evaluate_all(y, jcol(pred, logits, prob))
        assert set(got) == set(want)
        for k, v in want.items():
            if isinstance(v, float):
                assert abs(got[k] - v) <= 1e-6, k
        assert got["threshold_metrics"] == want["threshold_metrics"]
        assert abs(pe.evaluate(y, pcol(pred, logits, prob))
                   - je.evaluate(y, jcol(pred, logits, prob))) <= 1e-6


# -- DataCutter ------------------------------------------------------------------

@pytest.mark.parametrize("max_cats,min_frac", [(100, 0.0), (3, 0.0),
                                               (100, 0.05)])
def test_data_cutter_matches_jax(max_cats, min_frac):
    rng = np.random.default_rng(3)
    y = rng.choice([2.0, 5.0, 7.0, 9.0, 11.0], 600,
                   p=[0.4, 0.3, 0.2, 0.07, 0.03]).astype(np.float32)
    y[::97] = np.nan
    kw = dict(seed=5, reserve_test_fraction=0.2,
              max_label_categories=max_cats, min_label_fraction=min_frac)
    got = PSp.DataCutter(**kw).prepare(y)
    want = JSp.DataCutter(**kw).prepare(y)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.summary == want.summary and got.label_map == want.label_map
    args = PSp.DataCutter(**kw).save_args()
    assert args == JSp.DataCutter(**kw).save_args()
    for cut in (PSp.splitter_from_args(args), PSp.splitter_from_args(
            JSp.DataCutter(**kw).save_args())):
        assert type(cut).__name__ == "DataCutter"
        assert cut.save_args() == args
        np.testing.assert_array_equal(cut.split(600)[1],
                                      JSp.DataCutter(**kw).split(600)[1])


# -- GLM solvers -----------------------------------------------------------------

@pytest.mark.parametrize("reg,en,standardize,intercept", [
    (0.0, 0.0, True, True), (0.1, 0.5, True, True), (0.01, 0.0, False, True),
    (0.05, 1.0, True, False)])
def test_fit_softmax_matches_jax(reg, en, standardize, intercept):
    X, y = _data(700, K=4, seed=21)
    X = np.nan_to_num(X)
    X[:, 4] = 30.0 + 8.0 * X[:, 4]              # a large-mean column
    w = np.random.default_rng(2).uniform(0.3, 1.7, len(y)).astype(np.float32)
    Y = np.eye(4, dtype=np.float32)[y.astype(int)]
    kw = dict(max_iter=30, fit_intercept=intercept, standardize=standardize)
    jB, jb0 = JOG.fit_softmax(jnp.asarray(X), jnp.asarray(Y), jnp.asarray(w),
                              jnp.float32(reg), jnp.float32(en), **kw)
    pB, pb0 = POG.fit_softmax(torch.from_numpy(X), torch.from_numpy(Y),
                              torch.from_numpy(w), reg, en, **kw)
    np.testing.assert_allclose(pB.numpy(), np.asarray(jB), rtol=0, atol=1e-4)
    np.testing.assert_allclose(pb0.numpy(), np.asarray(jb0), rtol=0,
                               atol=1e-4)

    def probs(B, b0):
        z = X @ np.asarray(B, np.float64) + np.asarray(b0, np.float64)
        e = np.exp(z - z.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)
    np.testing.assert_allclose(probs(pB.numpy(), pb0.numpy()),
                               probs(jB, jb0), rtol=0, atol=1e-5)
    # lanes: the same fit as lane 1 of a two-lane call
    W = np.stack([np.ones_like(w), w])
    LB, Lb0 = POG.fit_softmax(torch.from_numpy(X), torch.from_numpy(Y),
                              torch.from_numpy(W), torch.tensor([0.3, reg]),
                              torch.tensor([0.0, en]), **kw)
    np.testing.assert_allclose(LB[1].numpy(), pB.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(Lb0[1].numpy(), pb0.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("smoothing", [1.0, 0.25])
def test_fit_naive_bayes_matches_jax(smoothing):
    X, y = _data(600, K=3, seed=8)
    X = np.nan_to_num(X)
    w = np.random.default_rng(1).uniform(0.5, 1.5, len(y)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[y.astype(int)]
    jl, jp = JOG.fit_naive_bayes(jnp.asarray(X), jnp.asarray(Y),
                                 jnp.asarray(w), smoothing)
    pl, pp = POG.fit_naive_bayes(torch.from_numpy(X), torch.from_numpy(Y),
                                 torch.from_numpy(w), smoothing)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-6, atol=0)
    np.testing.assert_allclose(pp.numpy(), np.asarray(jp), rtol=1e-6, atol=0)
    jm = JG.OpNaiveBayes(smoothing=smoothing).fit_arrays(X, y, w)
    pm = PG.OpNaiveBayes(device="cpu", smoothing=smoothing).fit_arrays(X, y, w)
    for got, want in zip(pm.predict_arrays(X), jm.predict_arrays(X)):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


# -- the sweep -------------------------------------------------------------------

def _validate(pkg_models, X, y, package):
    if package == "jax":
        cv = JV.CrossValidation(JEv.MultiClassification.error(), num_folds=3,
                                seed=7)
    else:
        cv = PV.CrossValidation(PEv.MultiClassification.error(), num_folds=3,
                                seed=7, device="cpu")
    return cv.validate(pkg_models, X, y, problem_type="multiclass")


def _same_sweep(pbest, jbest, tol=5e-3):
    assert pbest.name == jbest.name and pbest.best_grid == jbest.best_grid
    assert len(pbest.validated) == len(jbest.validated)
    for a, b in zip(pbest.validated, jbest.validated):
        assert (a.model_name, a.grid, a.route) == (b.model_name, b.grid,
                                                   b.route)
        for p, q in zip(a.fold_metrics, b.fold_metrics):
            assert abs(p - q) <= tol, (a, b)


@pytest.mark.parametrize("metric", ["error", "f1"])
def test_softmax_lane_sweep_matches_reference(metric):
    """The vmapped route: softmax lanes over folds x grid points, scored
    by the confusion-matrix metrics, against the reference's `_sweep`."""
    X, y = _data(900, K=3, seed=31)
    X = np.nan_to_num(X)
    grids = [dict(reg_param=r, elastic_net_param=e, max_iter=50)
             for r in (0.001, 0.1) for e in (0.1, 0.5)]
    jcv = JV.CrossValidation(getattr(JEv.MultiClassification, metric)(),
                             num_folds=3, seed=7)
    pcv = PV.CrossValidation(getattr(PEv.MultiClassification, metric)(),
                             num_folds=3, seed=7, device="cpu")
    jbest = jcv.validate([(JG.OpLogisticRegression(), grids)], X, y,
                         problem_type="multiclass")
    pbest = pcv.validate([(PG.OpLogisticRegression(device="cpu"), grids)],
                         X, y, problem_type="multiclass")
    assert {v.route for v in pbest.validated} == {"vmapped"}
    _same_sweep(pbest, jbest)


def test_multiclass_tree_and_nb_sweep_matches_jax(reference_draws):
    """Forests and softmax boosting on the mask-fold route, naive Bayes on
    the sequential route."""
    X, y = _data(900, K=3, seed=41)
    reference_draws(4)
    Xp = np.abs(np.nan_to_num(X))

    def models(G, M, dev):
        kw = {} if dev is None else dict(device=dev)
        return [(M.OpRandomForestClassifier(**kw),
                 [dict(num_trees=4, max_depth=d) for d in (2, 4)]),
                (M.OpXGBoostClassifier(**kw), [dict(num_round=3,
                                                    max_depth=3)]),
                (G.OpNaiveBayes(**kw), [dict(smoothing=1.0)])]
    jbest = _validate(models(JG, JM, None), Xp, y, "jax")
    pbest = _validate(models(PG, PM, "cpu"), Xp, y, "port")
    assert [v.route for v in pbest.validated] == \
        ["mask_folds"] * 3 + ["sequential"]
    _same_sweep(pbest, jbest)


# -- trees -----------------------------------------------------------------------

@pytest.mark.parametrize("K,name,params", [
    (3, "OpRandomForestClassifier", dict(num_trees=4, max_depth=3)),
    (7, "OpRandomForestClassifier", dict(num_trees=3, max_depth=4,
                                         min_instances_per_node=5)),
    (7, "OpDecisionTreeClassifier", dict(max_depth=4)),
])
def test_multiclass_forest_matches_jax(reference_draws, K, name, params):
    X, y = _data(1200, K=K, seed=K)
    reference_draws(params.get("num_trees", 1))
    jm = getattr(JM, name)(**params).fit_arrays(X, y)
    pm = getattr(PM, name)(device="cpu", **params).fit_arrays(X, y)
    assert pm.mode == jm.mode == "classify_mean" and pm.n_classes == K
    for field in ("feat", "miss", "thresh_val"):
        np.testing.assert_array_equal(getattr(pm, field), getattr(jm, field))
    assert pm.leaf.shape[-1] == K
    np.testing.assert_allclose(pm.leaf, jm.leaf, rtol=0, atol=1e-5)
    for got, want in zip(pm.predict_arrays(X), jm.predict_arrays(X)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("K,depth,kw", [(3, 3, {}), (5, 2, dict(
    reg_lambda=2.0, min_child_weight=0.5, gamma=0.1, learning_rate=0.3))])
def test_fit_gbt_softmax_matches_jax(K, depth, kw):
    X, y = _data(800, K=K, seed=50 + K)
    edges = JT.quantile_edges(jnp.asarray(X), 16)
    Xb = np.asarray(JT.bin_matrix(jnp.asarray(X), edges))
    w = np.random.default_rng(K).uniform(0.5, 1.5, len(y)).astype(np.float32)
    jt = JT.fit_gbt_softmax(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(w),
                            jax.random.PRNGKey(0), n_rounds=4, depth=depth,
                            n_bins=16, n_classes=K, **kw)
    with chip_smoke.record_refit_levels([], all_lanes=True) as levels:
        pt = PT.fit_gbt_softmax(torch.from_numpy(Xb), torch.from_numpy(y),
                                torch.from_numpy(w), n_rounds=4, depth=depth,
                                n_bins=16, n_classes=K, **kw)
    got = np.stack([getattr(pt, f).numpy() for f in ("feat", "thresh",
                                                     "miss")], -1)
    want = np.stack([np.asarray(getattr(jt, f)) for f in ("feat", "thresh",
                                                          "miss")], -1)
    # a node the two split apart must be a tie: its two candidates' gains,
    # in float64 from the port's histograms, within f32 noise (1e-6)
    apart = np.argwhere((got != want).any(-1))
    for r, c, h in apart:
        lvl = int(np.log2(h + 1))
        rec = levels[(r * depth + lvl) * K + c]
        assert rec["lane"] == c
        g64, _ = PT._level_gains(rec["full"].double(), rec["split_kw"],
                                 *rec["masks"])
        gains = [float(g64[0, h - (2 ** lvl - 1)][tuple(v[r, c, h])])
                 for v in (got, want)]
        assert abs(gains[0] - gains[1]) <= 1e-6 * max(1.0, abs(gains[1]))
    first = apart[0][0] * K + apart[0][1] if len(apart) else 4 * K
    # the trees grown before the first tie agree in their leaves too
    np.testing.assert_allclose(
        pt.leaf.numpy().reshape(4 * K, -1)[:first],
        np.asarray(jt.leaf).reshape(4 * K, -1)[:first], rtol=0, atol=1e-5)
    # the fold lanes: lane 1 of a two-lane fit is the one-lane fit
    W = np.stack([np.ones_like(w), w])
    trees2, margins = PT.fit_gbt_softmax_folds(
        torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(W),
        n_rounds=4, depth=depth, n_bins=16, n_classes=K, **kw)
    assert margins.shape == (2, len(y), K)
    np.testing.assert_array_equal(trees2.feat[:, 1].numpy(), pt.feat.numpy())


def test_multiclass_xgboost_model_matches_jax(monkeypatch):
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")
    X, y = _data(900, K=4, seed=60)
    params = dict(num_round=4, max_depth=3, eta=0.3)
    jm = JM.OpXGBoostClassifier(**params).fit_arrays(X, y)
    pm = PM.OpXGBoostClassifier(device="cpu", **params).fit_arrays(X, y)
    assert type(pm).__name__ == type(jm).__name__ == "SoftmaxEnsembleModel"
    for field in ("feat", "miss", "thresh_val"):
        np.testing.assert_array_equal(getattr(pm, field), getattr(jm, field))
    for got, want in zip(pm.predict_arrays(X), jm.predict_arrays(X)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_multiclass_models_carried_across(monkeypatch):
    """SoftmaxModel, NaiveBayesModel and SoftmaxEnsembleModel fitted by the
    JAX package score alike in the port (convert and the registry)."""
    from transmogrifai_tpu_torch.stages.registry import build_stage
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")
    X, y = _data(600, K=3, seed=70)
    Xn = np.abs(np.nan_to_num(X))
    fitted = [
        (JG.OpLogisticRegression(reg_param=0.01).fit_arrays(Xn, y),
         convert.softmax_model_from_jax),
        (JG.OpNaiveBayes().fit_arrays(Xn, y),
         convert.naive_bayes_model_from_jax),
        (JM.OpXGBoostClassifier(num_round=3, max_depth=2).fit_arrays(Xn, y),
         convert.softmax_ensemble_from_jax)]
    for jm, conv in fitted:
        args = jm.save_args()
        for pm in (conv(args, device="cpu"),
                   build_stage(type(jm).__name__, args, device="cpu")):
            assert type(pm).__name__ == type(jm).__name__
            for got, want in zip(pm.predict_arrays(Xn),
                                 jm.predict_arrays(Xn)):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# -- the selector ----------------------------------------------------------------

def test_multiclass_selector_defaults_match_jax():
    sel = PS.MultiClassificationModelSelector.with_cross_validation(
        device="cpu", seed=3)
    jsel = JS.MultiClassificationModelSelector.with_cross_validation(seed=3)
    assert [(type(e).__name__, g) for e, g in sel.models] == \
        [(type(e).__name__, g) for e, g in jsel.models]
    assert [type(e).__name__ for e, _ in sel.models] == [
        "OpLogisticRegression", "OpRandomForestClassifier"]
    assert sel.validator.evaluator.default_metric == "error"
    assert sel.splitter.save_args() == jsel.splitter.save_args()
    assert type(sel.splitter).__name__ == "DataCutter"
    assert sel.problem_type == "multiclass"
    assert PS.default_grid_for("OpNaiveBayes") == \
        JS.default_grid_for("OpNaiveBayes")
    # the MLP resolves (reference default grid [{}]) and runs
    mlp_sel = PS.MultiClassificationModelSelector.with_cross_validation(
        model_types=["OpLogisticRegression",
                     "OpMultilayerPerceptronClassifier"], device="cpu")
    jmlp_sel = JS.MultiClassificationModelSelector.with_cross_validation(
        model_types=["OpLogisticRegression",
                     "OpMultilayerPerceptronClassifier"])
    (mlp, grid), (jmlp, jgrid) = mlp_sel.models[1], jmlp_sel.models[1]
    assert type(mlp).__name__ == type(jmlp).__name__
    assert grid == jgrid == [dict()]
    assert mlp.param_values() == jmlp.param_values()
    X, y = _data(300, K=3, seed=81)
    model = mlp.copy(max_iter=20).fit_arrays(np.nan_to_num(X), y)
    assert model.predict_arrays(np.nan_to_num(X))[2].shape == (300, 3)


def test_selector_fit_maps_labels_back():
    """Labels 3, 5 and 8 are cut to 0..2 for the sweep and mapped back in
    the predictions, as in the JAX package."""
    X, y = _data(600, K=3, seed=80)
    X = np.nan_to_num(X)
    y = np.array([3.0, 5.0, 8.0], np.float32)[y.astype(int)]
    kw = dict(seed=4, models_and_parameters=None,
              model_types=["OpLogisticRegression"])
    pm = PS.MultiClassificationModelSelector.with_cross_validation(
        device="cpu", **kw).fit_arrays(X, y)
    jm = JS.MultiClassificationModelSelector.with_cross_validation(
        **kw).fit_arrays(X, y)
    assert pm.label_map == jm.label_map == {3: 0, 5: 1, 8: 2}
    got, want = pm.predict_arrays(X), jm.predict_arrays(X)
    np.testing.assert_array_equal(got[0], want[0])
    assert set(np.unique(got[0])) <= {3.0, 5.0, 8.0}
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    assert abs(pm.summary.holdout_evaluation["error"]
               - jm.summary.holdout_evaluation["error"]) <= 1e-6
