"""The port's tree estimators, their ensemble modes, the selector's default
model types and the converter, against the JAX package.

Both packages fit the same seeded numpy arrays on the CPU; the JAX package
takes its device route (TMOG_NO_HOST_TREES=1). Random forests draw their
bootstrap weights and node masks from the reference's key schedule in both
packages: the port's ForestDraws is replaced, for these tests, by a
stand-in that draws them the reference's way (jax.random.split(key,
n_trees); per tree kb, kf = split(k), poisson(kb, subsample); per level
key, sub = split(key), _feature_mask(sub, 2^d, F, frac)).

Tolerances: the fitted trees' decisions identical (these fits are
shallow, their gains well separated); predictions within 1e-5 (f32 sums in
another order, sibling subtraction); a JAX model carried over by
convert.tree_model_from_jax scores within 1e-6; the selectors' default
model types and grids equal; a small selector sweep over LR, RF, GBT and
SVC picks the same winner with every cell's mean AuPR within 5e-3.
"""
import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.automl import selectors as JS
from transmogrifai_tpu.automl.tuning.validators import \
    CrossValidation as JCV
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEv
from transmogrifai_tpu.models import glm as JG
from transmogrifai_tpu.models import trees as JM
from transmogrifai_tpu.ops import trees as JT

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl import selectors as PS
from transmogrifai_tpu_torch.automl.tuning.validators import \
    CrossValidation as PCV
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PEv
from transmogrifai_tpu_torch.models import glm as PG
from transmogrifai_tpu_torch.models import trees as PM
from transmogrifai_tpu_torch.ops import trees as PT


def _data(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 0] = np.nan
    X[:, 4] = rng.integers(0, 4, size=n)
    logit = 1.6 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - 0.5 * X[:, 4]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    yr = (logit + 0.5 * rng.normal(size=n)).astype(np.float32)
    return X, y, yr


class _ReferenceDraws:
    """ForestDraws' interface, drawing as the reference's fit_forest does
    for `n_trees` trees from PRNGKey(seed)."""

    def __init__(self, n_trees, seed, n_rows, n_feat, *, subsample,
                 feature_frac, bootstrap, device):
        self.key = (seed, n_rows, n_feat, subsample, feature_frac, bootstrap)
        self.F, self.frac = n_feat, feature_frac
        self.trees = []
        for k in jax.random.split(jax.random.PRNGKey(seed), n_trees):
            kb, kf = jax.random.split(k)
            rw = jax.random.poisson(kb, subsample, (n_rows,)) if bootstrap \
                else jax.random.uniform(kb, (n_rows,)) < subsample
            self.trees.append((torch.tensor(np.asarray(rw, np.float32)), kf))

    def row_weights(self, t):
        return self.trees[t][0]

    def node_masks(self, t):
        if max(1, int(round(self.frac * self.F))) >= self.F:
            return None
        # drawn once a tree, level by level as the reference splits its key
        state, masks = self.__dict__.setdefault("_masks", {}).setdefault(
            t, ([self.trees[t][1]], []))

        def level(d):   # levels are asked for in order, 0 first
            while len(masks) <= d:
                state[0], sub = jax.random.split(state[0])
                masks.append(torch.from_numpy(np.array(JT._feature_mask(
                    sub, 1 << len(masks), self.F, self.frac))))
            return masks[d]
        return level


@pytest.fixture
def reference_draws(monkeypatch):
    """Make the port's forests draw as the reference's; call with the
    forest's tree count."""
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")

    def use(n_trees):
        monkeypatch.setattr(PT, "ForestDraws", lambda *a, **kw:
                            _ReferenceDraws(n_trees, *a, **kw))
    return use


ESTIMATORS = [
    ("OpRandomForestClassifier",
     dict(num_trees=4, max_depth=3, min_instances_per_node=5), "y"),
    ("OpRandomForestClassifier",
     dict(num_trees=3, max_depth=4, subsampling_rate=0.8,
          feature_subset_strategy="all"), "y"),
    ("OpRandomForestRegressor", dict(num_trees=4, max_depth=3), "yr"),
    ("OpDecisionTreeClassifier", dict(max_depth=4, min_info_gain=0.001), "y"),
    ("OpDecisionTreeRegressor", dict(max_depth=4), "yr"),
    ("OpGBTClassifier", dict(max_iter=5, max_depth=3, step_size=0.3), "y"),
    ("OpGBTRegressor", dict(max_iter=5, max_depth=3), "yr"),
    ("OpXGBoostRegressor", dict(num_round=5, max_depth=3, eta=0.3), "yr"),
]


@pytest.mark.parametrize("name,params,target", ESTIMATORS,
                         ids=[f"{e[0]}-{i}" for i, e in enumerate(ESTIMATORS)])
def test_estimator_matches_jax(reference_draws, name, params, target):
    X, y, yr = _data(seed=len(name))
    yy = y if target == "y" else yr
    reference_draws(params.get("num_trees", 1))
    jm = getattr(JM, name)(**params).fit_arrays(X, yy)
    pm = getattr(PM, name)(device="cpu", **params).fit_arrays(X, yy)
    assert pm.mode == jm.mode and pm.depth == jm.depth
    for field in ("feat", "miss"):
        np.testing.assert_array_equal(getattr(pm, field), getattr(jm, field))
    np.testing.assert_array_equal(pm.thresh_val, jm.thresh_val)
    np.testing.assert_allclose(pm.leaf, jm.leaf, rtol=0, atol=1e-5)
    assert abs(pm.base - jm.base) <= 1e-6 * max(1.0, abs(jm.base))
    for got, want in zip(pm.predict_arrays(X), jm.predict_arrays(X)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,params,target", [
    ("OpRandomForestClassifier", dict(num_trees=3, max_depth=3), "y"),
    ("OpRandomForestRegressor", dict(num_trees=3, max_depth=3), "yr"),
    ("OpGBTClassifier", dict(max_iter=3, max_depth=3), "y"),
    ("OpGBTRegressor", dict(max_iter=3, max_depth=3), "yr"),
    ("OpDecisionTreeClassifier", dict(max_depth=3), "y"),
])
def test_converted_model_scores_identically(monkeypatch, name, params,
                                            target):
    """Each ensemble mode of a fitted JAX model, carried over."""
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")
    X, y, yr = _data(900, seed=2)
    jm = getattr(JM, name)(**params).fit_arrays(X, y if target == "y"
                                                else yr)
    pm = convert.tree_model_from_jax(jm.save_args(), device="cpu")
    assert pm.mode == jm.mode
    Xs = X.copy()
    Xs[::7, 1] = np.nan                 # serving rows with new missing values
    for got, want in zip(pm.predict_arrays(Xs), jm.predict_arrays(Xs)):
        if want is None:
            assert got is None
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_unknown_ensemble_mode_raises():
    with pytest.raises(NotImplementedError, match="softmax"):
        PM.TreeEnsembleModel(np.zeros((1, 1)), np.zeros((1, 1)),
                             np.zeros((1, 2, 1)), 1, "softmax")


def test_multiclass_forest_and_boosting_raise():
    """Multiclass forests and softmax boosting fit; what still raises is
    what the reference refuses: a base_score for softmax boosting, and a
    multiclass sweep of Spark's binary GBT."""
    X, y, _ = _data(300)
    y3 = (y + (X[:, 1] > 1)).astype(np.float32)
    rf = PM.OpRandomForestClassifier(device="cpu", num_trees=2).fit_arrays(
        X, y3)
    assert rf.leaf.shape[-1] == 3 and rf.predict_arrays(X)[2].shape == (300, 3)
    xgb = PM.OpXGBoostClassifier(device="cpu", num_round=2).fit_arrays(X, y3)
    assert type(xgb).__name__ == "SoftmaxEnsembleModel"
    with pytest.raises(ValueError, match="base_score"):
        PM.OpXGBoostClassifier(device="cpu", num_round=2,
                               base_score=0.3).fit_arrays(X, y3)
    gbt = PM.OpGBTClassifier(device="cpu")
    with pytest.raises(ValueError, match="binary"):
        gbt.mask_fit_scores(gbt.mask_sweep_context(torch.from_numpy(X)),
                            torch.from_numpy(y3), torch.ones(300),
                            torch.ones(2, 300), n_classes=3, multiclass=True)


def test_default_grids_equal_the_reference():
    names = sorted(PS._models_by_name())
    assert len(names) == 14
    for name in names:
        assert PS.default_grid_for(name) == JS.default_grid_for(name), name


def test_default_model_types_resolve():
    sel = PS.BinaryClassificationModelSelector.with_cross_validation(
        device="cpu", seed=3)
    jsel = JS.BinaryClassificationModelSelector.with_cross_validation(seed=3)
    got = [(type(e).__name__, g) for e, g in sel.models]
    assert got == [(type(e).__name__, g) for e, g in jsel.models]
    assert [n for n, _ in got] == ["OpLogisticRegression",
                                   "OpRandomForestClassifier",
                                   "OpGBTClassifier", "OpLinearSVC"]
    assert [len(g) for _, g in got] == [8, 18, 18, 4]
    assert all(e.get_param("seed") == 3 for e, _ in sel.models
               if e.has_param("seed"))


def test_small_selector_sweep_over_the_default_families(reference_draws):
    """LR, RF, GBT and SVC with reduced grids through each package's
    CrossValidation: the same winner, every cell within 5e-3."""
    X, y, _ = _data(2000, seed=8)
    reference_draws(5)
    grids = {
        "lr": [dict(reg_param=r, elastic_net_param=0.1, max_iter=50)
               for r in (0.01, 0.1)],
        "rf": [dict(max_depth=3, min_instances_per_node=m,
                    min_info_gain=0.001, num_trees=5) for m in (10, 100)],
        "gbt": [dict(max_depth=3, min_instances_per_node=10,
                     min_info_gain=0.001, max_iter=5, step_size=0.3)],
        "svc": [dict(reg_param=0.01, max_iter=50)],
    }

    def models(G, M, dev):
        kw = {} if dev is None else dict(device=dev)
        return [(G.OpLogisticRegression(**kw), grids["lr"]),
                (M.OpRandomForestClassifier(**kw), grids["rf"]),
                (M.OpGBTClassifier(**kw), grids["gbt"]),
                (G.OpLinearSVC(**kw), grids["svc"])]
    jbest = JCV(JEv.BinaryClassification.au_pr(), num_folds=3,
                seed=42).validate(models(JG, JM, None), X, y)
    pbest = PCV(PEv.BinaryClassification.au_pr(), num_folds=3, seed=42,
                device="cpu").validate(models(PG, PM, "cpu"), X, y)
    assert pbest.name == jbest.name and pbest.best_grid == jbest.best_grid
    assert len(pbest.validated) == len(jbest.validated) == 6
    for a, b in zip(pbest.validated, jbest.validated):
        assert (a.model_name, a.grid) == (b.model_name, b.grid)
        assert abs(a.mean_metric - b.mean_metric) < 5e-3, (a, b)
