"""The regression half of the model search in the port — solvers, the Gram
sweep, metrics, the evaluator, the validator's regression routes, the
RegressionModelSelector and the port's op_boston example — against the
JAX package on the same seeded numpy inputs, on the CPU.

Tolerances: coefficients and intercepts within 1e-4 (those
tests/test_torch_glm.py holds logistic regression to: f32 reductions in
another order inside a Newton solve with tol 1e-6); the Gram route's and
the per-lane route's coefficients each against the reference's own;
regression metrics within 1e-6 relative; the tree routes' fold metrics
within 1e-4 relative (fits whose splits are identical, their f32 sums in
another order); the example's matrix bit-identical, the same winner, every
cell within 5e-3 (but those the reference's own IRLS diverges on, which
must diverge in the port too) and the scores within 1e-5 of the largest. Random forests draw as the
reference's (tests/test_torch_tree_models._ReferenceDraws).
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.automl import selectors as JS
from transmogrifai_tpu.automl.tuning import validators as JV
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JE
from transmogrifai_tpu.models import glm as JGM
from transmogrifai_tpu.models import trees as JTM
from transmogrifai_tpu.models.prediction import \
    make_prediction_column as j_pred_col
from transmogrifai_tpu.ops import glm as JG
from transmogrifai_tpu.ops import glm_sweep as JGS
from transmogrifai_tpu.ops import metrics_ops as JM
from transmogrifai_tpu.utils import uid as JU

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl import selectors as PS
from transmogrifai_tpu_torch.automl.tuning import validators as PV
from transmogrifai_tpu_torch.automl.tuning.splitters import DataSplitter
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.models import glm as PGM
from transmogrifai_tpu_torch.models import trees as PTM
from transmogrifai_tpu_torch.models.prediction import \
    make_prediction_column as p_pred_col
from transmogrifai_tpu_torch.ops import glm as PG
from transmogrifai_tpu_torch.ops import glm_sweep as PGS
from transmogrifai_tpu_torch.ops import metrics_ops as PM
from transmogrifai_tpu_torch.readers import ListReader as PList
from transmogrifai_tpu_torch.stages.registry import build_stage
from transmogrifai_tpu_torch.utils import uid as PU

from test_torch_tree_models import reference_draws  # noqa: F401

TOL = 1e-4


def _data(n=1200, d=6, seed=0):
    """Shifted, scaled features, a linear label with noise, nonuniform
    row weights."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * np.linspace(0.5, 3.0, d)
         + np.linspace(-2.0, 2.0, d)).astype(np.float32)
    beta = np.linspace(1.2, -1.2, d) / np.linspace(0.5, 3.0, d)
    y = ((X - np.linspace(-2.0, 2.0, d)) @ beta + 0.7
         + 0.4 * rng.normal(size=n)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    return X, y, w


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=tol)


def _masks(n, folds=3, seed=0):
    fold_of = np.random.default_rng(seed).integers(0, folds, n)
    return np.stack([(fold_of != f) for f in range(folds)]).astype(np.float32)


# -- solvers -------------------------------------------------------------------

@pytest.mark.parametrize("elastic_net", [0.0, 0.5])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_fit_linear_matches_jax(standardize, fit_intercept, elastic_net):
    X, y, w = _data()
    jb, jb0 = JG.fit_linear(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                            jnp.float32(0.05), jnp.float32(elastic_net),
                            max_iter=40, fit_intercept=fit_intercept,
                            standardize=standardize)
    pb, pb0 = PG.fit_linear(torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(w), 0.05, elastic_net,
                            max_iter=40, fit_intercept=fit_intercept,
                            standardize=standardize)
    assert pb.shape == (X.shape[1],) and pb0.dim() == 0
    _close(pb, jb)
    _close(float(pb0), float(jb0))
    if not fit_intercept:
        assert float(pb0) == 0.0


def test_fit_linear_lanes_are_single_fits():
    X, y, w = _data(seed=1)
    masks = _masks(len(y), seed=1)
    regs = np.array([0.001, 0.1, 0.3], np.float32)
    alphas = np.array([0.0, 0.5, 0.1], np.float32)
    B, b0 = PG.fit_linear(torch.from_numpy(X), torch.from_numpy(y),
                          torch.from_numpy(masks * w), regs, alphas)
    assert B.shape == (3, X.shape[1])
    for lane in range(3):
        jb, jb0 = JG.fit_linear(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(masks[lane] * w),
                                jnp.float32(regs[lane]),
                                jnp.float32(alphas[lane]))
        _close(B[lane], jb)
        _close(float(b0[lane]), float(jb0))


@pytest.mark.parametrize("family", ["gaussian", "poisson", "gamma"])
def test_fit_glr_matches_jax(family):
    X, y, w = _data(seed=2)
    X = X / 4.0
    if family != "gaussian":     # counts / positive values on a log link
        y = np.round(np.exp(0.3 * y)).astype(np.float32)
    y = np.maximum(y, 1e-6 if family == "gamma" else 0.0).astype(np.float32)
    jb, jb0 = JG.fit_glr(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                         jnp.float32(0.01), family=family, max_iter=25)
    pb, pb0 = PG.fit_glr(torch.from_numpy(X), torch.from_numpy(y),
                         torch.from_numpy(w), 0.01, family=family,
                         max_iter=25)
    _close(pb, jb)
    _close(float(pb0), float(jb0))
    jm = JGM.OpGeneralizedLinearRegression(family=family).fit_arrays(X, y, w)
    pm = PGM.OpGeneralizedLinearRegression(
        family=family, device="cpu").fit_arrays(X, y, w)
    assert pm.link == jm.link
    _close(pm.predict_arrays(X)[0], jm.predict_arrays(X)[0],
           tol=TOL * max(1.0, float(np.abs(y).max())))


def test_fit_glr_tweedie_raises_in_both():
    X, y, w = _data(n=50)
    with pytest.raises(ValueError, match="tweedie"):
        JG.fit_glr(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                   jnp.float32(0.0), family="tweedie")
    with pytest.raises(ValueError, match="tweedie"):
        PG.fit_glr(torch.from_numpy(X), torch.from_numpy(y),
                   torch.from_numpy(w), 0.0, family="tweedie")


def test_gram_solvers_match_jax():
    X, y, w = _data(n=600, seed=3)
    masks = _masks(len(y), seed=3)
    Wl = masks * w                                    # [L, n]
    Xs = (X - X.mean(0)) / X.std(0)
    G = np.einsum("ln,nd,ne->lde", Wl, Xs, Xs).astype(np.float32)
    c = (Wl * y) @ Xs
    sx, sy, sw = Wl @ Xs, Wl @ y, Wl.sum(1)
    l1 = np.array([0.0, 0.02, 0.05], np.float32)
    l2 = np.array([0.01, 0.03, 0.0], np.float32)
    args = [a.astype(np.float32) for a in (G, c, sx, sy, sw)]
    j_prox = jax.jit(JG.prox_newton_gram, static_argnames="fit_intercept")
    for fit_intercept in (True, False):
        jb, jb0 = JG.ridge_gram_solve(*map(jnp.asarray, args),
                                      jnp.asarray(l2),
                                      fit_intercept=fit_intercept)
        pb, pb0 = PG.ridge_gram_solve(*map(torch.from_numpy, args),
                                      torch.from_numpy(l2),
                                      fit_intercept=fit_intercept)
        _close(pb, jb)
        _close(pb0, jb0)
        jb2, jb02, ji = j_prox(
            *map(jnp.asarray, args), jnp.asarray(l1), jnp.asarray(l2),
            jb, jb0, 50, 1e-6, fit_intercept=fit_intercept)
        pb2, pb02, pi = PG.prox_newton_gram(
            *map(torch.from_numpy, args), torch.from_numpy(l1),
            torch.from_numpy(l2), pb, pb0, 50, 1e-6,
            fit_intercept=fit_intercept)
        _close(pb2, jb2)
        _close(pb02, jb02)
        assert abs(pi - int(ji)) <= 1
        np.testing.assert_array_equal(pb2.numpy() == 0, np.asarray(jb2) == 0)


@pytest.mark.parametrize("standardize", [True, False])
def test_gram_sweep_matches_jax(standardize):
    X, y, w = _data(seed=4)
    masks = _masks(len(y), seed=4)
    regs = np.array([0.001, 0.01, 0.1, 0.2], np.float32)
    alphas = np.array([0.1, 0.0, 0.5, 0.1], np.float32)
    jB, jb0, _ = JGS.sweep_glm_squared_gram(
        *map(jnp.asarray, (X, y, w, masks, regs, alphas)), 50, 1e-6,
        standardize=standardize)
    pB, pb0, _ = PGS.sweep_glm_squared_gram(
        *map(torch.from_numpy, (X, y, w, masks)), regs, alphas, 50, 1e-6,
        standardize=standardize)
    assert pB.shape == (3, 4, X.shape[1])
    _close(pB, jB)
    _close(pb0, jb0)


# -- metrics and the evaluator -----------------------------------------------

def _rel_close(got, want, rel=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= rel * np.maximum(np.abs(want), 1e-12)
                  + 1e-12), (got, want)


@pytest.mark.parametrize("weighted", [False, True])
def test_regression_metrics_match_jax(weighted):
    rng = np.random.default_rng(5)
    y = rng.normal(3.0, 2.0, 1000).astype(np.float32)
    pred = (y + rng.normal(0, 0.5, 1000)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, 1000).astype(np.float32) if weighted else None
    jm = JM.regression_metrics(jnp.asarray(pred), jnp.asarray(y),
                               None if w is None else jnp.asarray(w))
    pm = PM.regression_metrics(torch.from_numpy(pred), torch.from_numpy(y),
                               None if w is None else torch.from_numpy(w))
    for k in ("rmse", "mse", "mae", "r2"):
        _rel_close(float(getattr(pm, k)), float(getattr(jm, k)))
    lanes = PM.regression_metrics(
        torch.from_numpy(np.stack([pred, y])), torch.from_numpy(y),
        torch.ones(2, 1000) if w is None
        else torch.from_numpy(np.stack([w, w])))
    _rel_close(float(lanes.rmse[0]), float(jm.rmse))
    assert float(lanes.mse[1]) == 0.0 and float(lanes.r2[1]) == 1.0


@pytest.mark.parametrize("metric", ["rmse", "mse", "mae", "r2"])
def test_regression_evaluator_matches_jax(metric):
    rng = np.random.default_rng(6)
    y = rng.normal(size=400).astype(np.float32)
    pred = (y + rng.normal(0, 0.3, 400)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, 400).astype(np.float32)
    jev = getattr(JE.Regression, metric)()
    pev = getattr(PE.Regression, metric)()
    pev.device = "cpu"
    jall = jev.evaluate_all(y, j_pred_col(pred, None, None), w)
    pall = pev.evaluate_all(y, p_pred_col(pred, None, None), w)
    assert set(pall) == set(jall)
    for k in jall:
        _rel_close(pall[k], jall[k])
    assert pev.is_larger_better() == jev.is_larger_better() == \
        (metric == "r2")
    assert pev.evaluate(y, p_pred_col(pred, None, None), w) == \
        pall[metric]


# -- the validator's regression routes ---------------------------------------

def _validate(pkg, models, X, y, ev=None, seed=7):
    V, E = (JV, JE) if pkg == "jax" else (PV, PE)
    ev = ev or E.Regression.rmse()
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return V.CrossValidation(ev, num_folds=3, seed=seed, **kw).validate(
        models, X, y, problem_type="regression")


def _same_cells(pbest, jbest, rel):
    assert pbest.name == jbest.name and pbest.best_grid == jbest.best_grid
    assert len(pbest.validated) == len(jbest.validated)
    for pv, jv in zip(pbest.validated, jbest.validated):
        assert (pv.model_name, pv.grid) == (jv.model_name, jv.grid)
        _rel_close(pv.fold_metrics, jv.fold_metrics, rel)


def test_sequential_route_matches_jax():
    """Generalized linear regression has no lane-batched fit: both
    packages fit it fold by fold."""
    X, y, _ = _data(n=900, seed=8)
    X = X / 4.0
    grid = [dict(family="gaussian", reg_param=r) for r in (0.001, 0.1)]
    jbest = _validate("jax", [(JGM.OpGeneralizedLinearRegression(), grid)],
                      X, y)
    pbest = _validate("port", [(PGM.OpGeneralizedLinearRegression(
        device="cpu"), grid)], X, y)
    assert {v.route for v in pbest.validated} == {"sequential"}
    _same_cells(pbest, jbest, 1e-4)


def test_custom_evaluator_takes_the_sequential_route():
    X, y, _ = _data(n=600, seed=9)

    def max_err(labels, col, w):
        return float(np.max(np.abs(col.data[:, 0] - labels)))
    grid = [dict(reg_param=0.01)]
    jbest = _validate("jax", [(JGM.OpLinearRegression(), grid)], X, y,
                      ev=JE.custom("max_err", False, max_err))
    pbest = _validate("port", [(PGM.OpLinearRegression(device="cpu"), grid)],
                      X, y, ev=PE.custom("max_err", False, max_err))
    assert pbest.validated[0].route == "sequential"
    _same_cells(pbest, jbest, 1e-4)


@pytest.mark.parametrize("route", ["vmapped", "streamed"])
def test_linear_regression_routes_match_jax(monkeypatch, route):
    """The lane-batched per-lane solve below the streamed floor, the Gram
    route above it (the floor lowered in both packages)."""
    if route == "streamed":
        for mod in (JV, PV):
            monkeypatch.setattr(mod, "STREAMED_SWEEP_MIN_ROWS", 500)
    X, y, _ = _data(n=1500, seed=10)
    grid = [dict(reg_param=r, elastic_net_param=a)
            for r in (0.001, 0.1) for a in (0.1, 0.5)]
    jbest = _validate("jax", [(JGM.OpLinearRegression(), grid)], X, y)
    pbest = _validate("port", [(PGM.OpLinearRegression(device="cpu"), grid)],
                      X, y)
    assert [v.route for v in pbest.validated] == [route] * 4
    _same_cells(pbest, jbest, 1e-5)


TREES = [
    ("OpRandomForestRegressor", dict(num_trees=3, max_depth=3)),
    ("OpGBTRegressor", dict(max_iter=4, max_depth=3)),
    ("OpXGBoostRegressor", dict(num_round=4, max_depth=3, eta=0.3)),
]


@pytest.mark.parametrize("name,grid", TREES, ids=[t[0] for t in TREES])
def test_mask_fold_regression_route_matches_jax(reference_draws, name,
                                                grid):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(600, 5)).astype(np.float32)
    X[rng.uniform(size=600) < 0.1, 0] = np.nan
    y = (1.5 * X[:, 1] - np.nan_to_num(X[:, 0]) * X[:, 2]
         + 0.3 * rng.normal(size=600)).astype(np.float32)
    reference_draws(grid.get("num_trees", 1))
    jbest = _validate("jax", [(getattr(JTM, name)(), [dict(grid)])], X, y)
    pbest = _validate("port", [(getattr(PTM, name)(device="cpu"),
                                [dict(grid)])], X, y)
    assert pbest.validated[0].route == "mask_folds"
    _same_cells(pbest, jbest, 1e-4)


# -- the selector and the example --------------------------------------------

def test_regression_selector_defaults():
    sel = PS.RegressionModelSelector.with_cross_validation(device="cpu",
                                                           seed=3)
    jsel = JS.RegressionModelSelector.with_cross_validation(seed=3)
    got = [(type(e).__name__, g) for e, g in sel.models]
    assert got == [(type(e).__name__, g) for e, g in jsel.models]
    assert [n for n, _ in got] == ["OpLinearRegression",
                                   "OpRandomForestRegressor",
                                   "OpGBTRegressor"]
    assert sel.problem_type == "regression"
    assert sel.validator.evaluator.default_metric == "rmse"
    assert type(sel.splitter) is DataSplitter
    for name in ("OpLinearRegression", "OpGeneralizedLinearRegression"):
        assert PS.default_grid_for(name) == JS.default_grid_for(name)
    # the multiclass selector is ported: its defaults resolve
    multi = PS.MultiClassificationModelSelector.with_cross_validation(
        device="cpu")
    assert multi.problem_type == "multiclass" and len(multi.models) == 2


@pytest.mark.parametrize("family", [None, "poisson"])
def test_jax_linear_regression_model_rebuilds_in_port(family):
    """A JAX LinearRegressionModel's save_args rebuild the port's, as a
    saved model or convert.workflow_model_from_jax rebuilds it."""
    X, y, w = _data(n=300, seed=12)
    if family is None:
        jm = JGM.OpLinearRegression(reg_param=0.01).fit_arrays(X, y, w)
    else:
        X = X / 4.0
        y = np.round(np.exp(0.3 * y)).astype(np.float32)
        jm = JGM.OpGeneralizedLinearRegression(family=family) \
            .fit_arrays(X, y, w)
    pm = build_stage("LinearRegressionModel", jm.save_args(), device="cpu")
    assert type(pm) is PGM.LinearRegressionModel and pm.link == jm.link
    want = jm.predict_arrays(X)[0]
    _close(pm.predict_arrays(X)[0], want,
           tol=1e-5 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def boston():
    sys.path.insert(0, str(__import__("pathlib").Path(__file__)
                           .resolve().parents[1]))
    from examples import op_boston as JB
    from transmogrifai_tpu_torch.examples import op_boston as PB
    types = ["OpLinearRegression", "OpGeneralizedLinearRegression"]
    rows = PB.synthetic_housing()
    assert rows == JB.synthetic_housing()
    JU.reset_uids()
    jwf, jpred = JB.build_workflow(model_types=types)
    from transmogrifai_tpu.readers.readers import ListReader as JList
    jmodel = jwf.set_reader(JList(rows)).train()
    PU.reset_uids()
    pwf, ppred = PB.build_workflow(model_types=types, device="cpu")
    pmodel = pwf.set_reader(PList(rows)).train()
    return dict(jmodel=jmodel, pmodel=pmodel, jpred=jpred, ppred=ppred,
                rows=rows)


def test_op_boston_matches_jax(boston):
    b = boston
    jm, pm = b["jmodel"], b["pmodel"]
    assert b["ppred"].name == b["jpred"].name
    js, ps = jm.selector_summary(), pm.selector_summary()
    assert ps.best_model_name == js.best_model_name
    assert ps.best_grid == js.best_grid
    assert ps.problem_type == js.problem_type == "regression"
    assert len(ps.validation_results) == len(js.validation_results) == 16
    best = js.validation_results[0]["mean_metric"]
    diverged = 0
    for a, c in zip(ps.validation_results, js.validation_results):
        assert (a["model_name"], a["grid"]) == (c["model_name"], c["grid"])
        if not np.isfinite(c["mean_metric"]) or c["mean_metric"] > 10 * best:
            # the poisson family's IRLS on the raw-scaled housing columns
            # (tax ~ 200-700) diverges in the reference: such a cell
            # diverges in the port too, from f32 noise that the divergence
            # amplifies, so only its divergence is compared
            diverged += 1
            assert not np.isfinite(a["mean_metric"]) \
                or a["mean_metric"] > 10 * best
            continue
        assert abs(a["mean_metric"] - c["mean_metric"]) < 5e-3
    assert diverged <= 3
    vec = next(st for st in pm.stages if type(st).__name__
               == "SanityCheckerModel").input_names()[1]
    assert np.array_equal(pm._train_data.data(vec), jm._train_data.data(vec))
    assert pm.sanity_checker_summary().dropped == \
        jm.sanity_checker_summary().dropped
    got = np.asarray(pm.score().data(b["ppred"].name), np.float64)
    want = np.asarray(jm.score().data(b["jpred"].name), np.float64)
    assert got.shape == (len(b["rows"]), 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(
        want).max())
    assert ps.holdout_evaluation["r2"] > 0.5
