"""The port's batched LOCO knockouts (insights/knockout.py) against the JAX
package's.

Every case of tests/test_loco_batched.py: the five GLM families, the five
tree modes, inactive features at zero delta, row chunking, the
SelectedModel unwrap and the unknown-model fallback. Each model is fitted
by the JAX package on seeded numpy data, carried across with
`convert.*_from_jax` (the linear regression through the stage registry,
as a saved stage loads), and its [n, d, c] deltas taken by both packages:
the reference's batched route (`force_tree=True` for trees), the port's
batched route on the CPU, and the port's one-pass-per-column loop (the
parity oracle). Tolerances: GLM deltas atol 1e-6, rtol 1e-4 (the
reference's own); tree deltas atol 1e-5 (f32 sums over the trees in
another order; every row takes the same leaves in both packages).
"""
import numpy as np
import pytest

from transmogrifai_tpu.automl.selector import \
    ModelSelectorSummary as JSummary
from transmogrifai_tpu.automl.selector import SelectedModel as JSelected
from transmogrifai_tpu.insights.knockout import knockout_deltas as j_knock
from transmogrifai_tpu.models.glm import (
    OpGeneralizedLinearRegression, OpLinearRegression, OpLinearSVC,
    OpLogisticRegression, OpNaiveBayes)
from transmogrifai_tpu.models.trees import (
    OpGBTClassifier, OpGBTRegressor, OpRandomForestClassifier,
    OpRandomForestRegressor, OpXGBoostClassifier, OpXGBoostRegressor)

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert as C
from transmogrifai_tpu_torch.automl.selector import \
    ModelSelectorSummary as PSummary
from transmogrifai_tpu_torch.automl.selector import SelectedModel as PSelected
from transmogrifai_tpu_torch.insights import knockout as PK
from transmogrifai_tpu_torch.insights.loco import RecordInsightsLOCO
from transmogrifai_tpu_torch.stages.registry import build_stage

GLM_TOL = dict(atol=1e-6, rtol=1e-4)
TREE_ATOL = 1e-5


def _data(seed=0, n=80, d=6, classes=2):
    """tests/test_loco_batched.py's data."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    if classes == 1:   # regression
        y = (X[:, 0] * 2 - X[:, 2] + rng.normal(size=n) * 0.1).astype(
            np.float32)
    else:
        y = (np.argsort(X[:, 0] + 0.5 * X[:, 1])
             * classes // n).astype(np.float32)
    return X, y


_CONVERT = {
    "LinearBinaryModel": C.linear_model_from_jax,
    "SoftmaxModel": C.softmax_model_from_jax,
    "NaiveBayesModel": C.naive_bayes_model_from_jax,
    "TreeEnsembleModel": C.tree_model_from_jax,
    "SoftmaxEnsembleModel": C.softmax_ensemble_from_jax,
}


def _port(jm):
    """The JAX-fitted model as the port's, on the CPU."""
    name = type(jm).__name__
    if name in _CONVERT:
        return _CONVERT[name](jm.save_args(), device="cpu")
    return build_stage(name, jm.save_args(), device="cpu")


def _assert_parity(jm, X, tree=False):
    pm = _port(jm)
    want = j_knock(jm, X, force_tree=True if tree else None)
    got = PK.knockout_deltas(pm, X)
    loop = RecordInsightsLOCO(model=pm).insights_matrix_loop(X)
    assert got is not None and got.dtype == np.float64
    assert got.shape == want.shape == loop.shape
    if tree:
        np.testing.assert_allclose(got, want, atol=TREE_ATOL, rtol=0)
        np.testing.assert_allclose(got, loop, atol=TREE_ATOL, rtol=0)
    else:
        np.testing.assert_allclose(got, want, **GLM_TOL)
        np.testing.assert_allclose(got, loop, **GLM_TOL)
    # the default entry point takes the batched route implicitly
    np.testing.assert_array_equal(
        RecordInsightsLOCO(model=pm).insights_matrix(X), got)
    return pm, got


GLM_CASES = {
    "logistic_binary": (lambda: OpLogisticRegression(max_iter=25), 1, 2),
    "svc_margin": (lambda: OpLinearSVC(), 2, 2),
    "softmax_multiclass": (lambda: OpLogisticRegression(max_iter=25), 3, 3),
    "linear_regression": (lambda: OpLinearRegression(), 4, 1),
    "naive_bayes": (lambda: OpNaiveBayes(), 5, 2),
}


@pytest.mark.parametrize("case", sorted(GLM_CASES))
def test_glm_family_matches_jax(case):
    make, seed, classes = GLM_CASES[case]
    X, y = _data(seed, classes=classes)
    if case == "naive_bayes":
        X = np.abs(X)
    _assert_parity(make().fit_arrays(X, y), X)


def test_log_link_regression_matches_jax():
    """A poisson GLR (log link): the closed form's exp branch."""
    X, _ = _data(16, classes=1)
    rng = np.random.default_rng(16)
    y = rng.poisson(np.exp(0.4 * X[:, 0] - 0.3 * X[:, 3])).astype(
        np.float32)
    jm = OpGeneralizedLinearRegression(family="poisson").fit_arrays(X, y)
    assert jm.link == "log"
    _assert_parity(jm, X)


TREE_CASES = {
    "rf_classifier_mean": (
        lambda: OpRandomForestClassifier(num_trees=5, max_depth=3), 6, 2,
        "classify_mean"),
    "gbt_classifier_margin": (
        lambda: OpGBTClassifier(max_iter=5, max_depth=3), 7, 2, "margin"),
    "rf_regressor_mean": (
        lambda: OpRandomForestRegressor(num_trees=5, max_depth=3), 8, 1,
        "regress_mean"),
    "gbt_regressor_sum": (
        lambda: OpGBTRegressor(max_iter=5, max_depth=3), 9, 1, "regress_sum"),
    "xgb_regressor": (
        lambda: OpXGBoostRegressor(num_round=5, max_depth=3), 10, 1,
        "regress_sum"),
    "xgb_softmax_multiclass": (
        lambda: OpXGBoostClassifier(num_round=4, max_depth=3), 11, 3,
        "softmax"),
}


@pytest.mark.parametrize("case", sorted(TREE_CASES))
def test_tree_family_matches_jax(case):
    make, seed, classes, mode = TREE_CASES[case]
    X, y = _data(seed, classes=classes)
    jm = make().fit_arrays(X, y)
    assert getattr(jm, "mode", "softmax") == mode
    _assert_parity(jm, X, tree=True)


def test_inactive_features_have_zero_delta():
    X, y = _data(12, d=8)
    jm = OpGBTClassifier(max_iter=3, max_depth=2).fit_arrays(X, y)
    pm, deltas = _assert_parity(jm, X, tree=True)
    act = set(PK.active_features(pm.feat, pm.thresh_val).tolist())
    assert act and len(act) < 8
    for j in range(8):
        if j not in act:
            assert np.abs(deltas[:, j, :]).max() == 0.0


@pytest.mark.parametrize("budget", [None, 3 * 7 * 5])
def test_row_chunking_matches_single_chunk(monkeypatch, budget):
    """`row_chunk` = 32 (3 chunks, the last ragged), and a traversal budget
    that leaves a chunk a few rows, give the single chunk's deltas; the
    JAX package's chunked route agrees."""
    X, y = _data(13, n=70)
    jm = OpGBTClassifier(max_iter=3, max_depth=3).fit_arrays(X, y)
    pm = _port(jm)
    full = PK.knockout_deltas(pm, X)
    if budget is not None:
        monkeypatch.setattr(PK, "_KNOCK_ELEMENTS", budget)
    chunked = PK.knockout_deltas(pm, X, row_chunk=32)
    np.testing.assert_allclose(chunked, full, atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        chunked, j_knock(jm, X, row_chunk=32, force_tree=True),
        atol=TREE_ATOL, rtol=0)


def _summary(cls):
    return cls(validation_type="cv", validation_parameters={},
               data_prep_parameters={}, data_prep_results={},
               evaluation_metric="au_pr", metric_larger_better=True,
               problem_type="binary", best_model_uid="u",
               best_model_name="lr", best_model_type="OpLogisticRegression",
               best_grid={})


def test_selected_model_unwraps():
    X, y = _data(14)
    jm = OpLogisticRegression(max_iter=25).fit_arrays(X, y)
    pm = _port(jm)
    sel = PSelected(pm, _summary(PSummary), device="cpu")
    np.testing.assert_array_equal(PK.knockout_deltas(sel, X),
                                  PK.knockout_deltas(pm, X))
    np.testing.assert_allclose(
        PK.knockout_deltas(sel, X),
        j_knock(JSelected(jm, _summary(JSummary)), X), **GLM_TOL)


class _Opaque:
    """A model no batched route knows: a fallback to the loop."""

    device = None

    def predict_arrays(self, X):
        s = X.sum(axis=1)
        return (s > 0).astype(np.float32), None, None


def test_unknown_model_falls_back_to_loop():
    X, _ = _data(15)
    assert PK.knockout_deltas(_Opaque(), X) is None
    deltas = RecordInsightsLOCO(model=_Opaque()).insights_matrix(X)
    assert deltas.shape == (80, 6, 1)
    base = (X.sum(axis=1) > 0).astype(np.float64)
    for j in range(6):
        Xj = X.copy()
        Xj[:, j] = 0.0
        np.testing.assert_array_equal(
            deltas[:, j, 0], base - (Xj.sum(axis=1) > 0))


def test_force_tree_false_takes_the_loop():
    """`force_tree=False` sends a tree ensemble to the loop (None); the
    port's default is the batched route on the CPU too."""
    X, y = _data(6)
    pm = _port(OpRandomForestClassifier(num_trees=3, max_depth=2)
               .fit_arrays(X, y))
    assert PK.knockout_deltas(pm, X, force_tree=False) is None
    assert PK.knockout_deltas(pm, X) is not None
