"""Insights on the card: the batched LOCO knockouts of every model family
on a CUDA device against the same program's plain run on the CPU, and
`model_insights()` / `loco_insights` of a workflow trained on the card.
Every test needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_insights_gpu.py

Tolerance: knockout deltas within 1e-5 absolute of the CPU's (f32 sums in
another order on the card; TF32 stays off, `device.resolve_device`).
"""
import json

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.automl.preparators import SanityChecker
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
from transmogrifai_tpu_torch.insights import knockout as K
from transmogrifai_tpu_torch.models.glm import (
    OpGeneralizedLinearRegression, OpLinearRegression, OpLinearSVC,
    OpLogisticRegression, OpNaiveBayes)
from transmogrifai_tpu_torch.models.trees import (
    OpGBTClassifier, OpGBTRegressor, OpRandomForestClassifier,
    OpRandomForestRegressor, OpXGBoostClassifier)
from transmogrifai_tpu_torch.workflow import Workflow

pytestmark = pytest.mark.gpu

TOL = 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's run of the program)")


def _data(seed, n=3000, d=12, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    if classes == 1:
        y = (X[:, 0] * 2 - X[:, 2] + rng.normal(size=n) * 0.1)
    else:
        y = np.argsort(X[:, 0] + 0.5 * X[:, 1]) * classes // n
    return X, y.astype(np.float32)


FAMILIES = {
    "logistic": (lambda: OpLogisticRegression(max_iter=25), 2),
    "svc": (lambda: OpLinearSVC(), 2),
    "softmax": (lambda: OpLogisticRegression(max_iter=25), 3),
    "linear": (lambda: OpLinearRegression(), 1),
    "poisson": (lambda: OpGeneralizedLinearRegression(family="poisson"), 0),
    "naive_bayes": (lambda: OpNaiveBayes(), 2),
    "rf_classify_mean": (
        lambda: OpRandomForestClassifier(num_trees=8, max_depth=5), 2),
    "gbt_margin": (lambda: OpGBTClassifier(max_iter=6, max_depth=4), 2),
    "rf_regress_mean": (
        lambda: OpRandomForestRegressor(num_trees=8, max_depth=5), 1),
    "gbt_regress_sum": (lambda: OpGBTRegressor(max_iter=6, max_depth=4), 1),
    "xgb_softmax": (lambda: OpXGBoostClassifier(num_round=4, max_depth=4),
                    3),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_knockouts_on_the_card_match_the_cpu(family):
    _need_cuda()
    make, classes = FAMILIES[family]
    X, y = _data(len(family), classes=max(classes, 1))
    if family == "poisson":
        y = np.random.default_rng(3).poisson(
            np.exp(0.4 * np.nan_to_num(X[:, 0]))).astype(np.float32)
    glm = family in ("logistic", "svc", "softmax", "linear", "poisson",
                     "naive_bayes")
    if glm:
        X = np.nan_to_num(X)
    if family == "naive_bayes":
        X = np.abs(X)
    est = make()
    est.device = "cpu"
    model = est.fit_arrays(X, y)
    on_cpu = K.knockout_deltas(model, X, device="cpu")
    model.device = "cuda"
    on_card = K.knockout_deltas(model, X)
    assert on_card.shape == on_cpu.shape and on_card.shape[:2] == X.shape
    np.testing.assert_allclose(on_card, on_cpu, atol=TOL, rtol=0)
    if not glm:
        inactive = sorted(set(range(X.shape[1])) - set(
            K.active_features(model.feat, model.thresh_val).tolist()))
        assert all(np.abs(on_card[:, j]).max() == 0.0 for j in inactive)


def test_row_chunks_on_the_card(monkeypatch):
    """A traversal budget of a few rows a chunk gives the single chunk's
    deltas on the card."""
    _need_cuda()
    X, y = _data(7, n=5000)
    model = OpGBTClassifier(max_iter=4, max_depth=4).fit_arrays(X, y)
    full = K.knockout_deltas(model, X)
    monkeypatch.setattr(K, "_KNOCK_ELEMENTS", 13 * 4 * 37)
    np.testing.assert_allclose(K.knockout_deltas(model, X), full,
                               atol=1e-7, rtol=0)


def test_model_insights_and_loco_of_a_card_trained_workflow():
    """A workflow trained on the card (no device given): model_insights()
    ranks the causal column first and serializes; loco_insights through
    the dsl, reusing the fitted stages, maps every row."""
    _need_cuda()
    rng = np.random.default_rng(11)
    n = 4000
    cols = {k: rng.normal(size=n) for k in ("strong", "weak", "noise")}
    y = (2.5 * cols["strong"] + 0.3 * cols["weak"]
         + rng.normal(0, 0.5, n) > 0).astype(float)
    ds = Dataset.from_features(
        [(k, PT.Real, v.tolist()) for k, v in cols.items()]
        + [("label", PT.RealNN, y.tolist())])
    feats = [FB.Real(k).as_predictor() for k in cols]
    fy = FB.RealNN("label").as_response()
    checked = SanityChecker().set_input(fy, transmogrify(feats)).get_output()
    pred = BinaryClassificationModelSelector.with_train_validation_split(
        models_and_parameters=[(OpGBTClassifier(max_iter=5, max_depth=3),
                                [dict()])]).set_input(fy, checked) \
        .get_output()
    model = Workflow().set_input_dataset(ds).set_result_features(pred) \
        .train()
    assert model.selected_model().best_model.device is None   # CUDA
    mi = model.model_insights()
    by = {f.feature_name: f.max_contribution() for f in mi.features}
    assert by["strong"] == max(by.values())
    assert json.dumps(mi.to_json())
    loco = checked.loco_insights(model.selected_model(), top_k=2)
    maps = Workflow().with_model_stages(model).set_input_dataset(ds) \
        .set_result_features(loco).train().score(ds).data(loco.name)
    assert len(maps) == n and all(len(m) == 2 for m in maps)
    assert all(len(json.loads(v)) == 2 for v in maps[0].values())
