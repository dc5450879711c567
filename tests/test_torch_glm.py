"""The port's GLM solvers and estimators (transmogrifai_tpu_torch/ops/glm.py,
models/glm.py, convert.linear_model_from_jax) against the JAX package on
the same seeded numpy inputs, on the CPU.

Tolerance: coefficients and intercepts within 1e-4. Both packages run the
same Newton iteration with tol 1e-6 in f32; their reductions (the Gram
products, the weighted moments, the batched solve) sum in different
orders, which moves each iterate by f32 rounding, ~1e-7 at these sizes.
Scores of one carried-over model agree within 1e-6 (one product of
identical coefficients).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.models.glm import OpLinearSVC as JSVC
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.ops import glm as JG
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.models.glm import (LinearBinaryModel,
                                                OpLinearSVC,
                                                OpLogisticRegression)
from transmogrifai_tpu_torch.ops import glm as PG

TOL = 1e-4   # f32 reduction order inside a Newton solve with tol 1e-6


def _data(n=1500, d=6, seed=0):
    """Shifted, scaled features (standardization matters), a logistic
    label and nonuniform row weights."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) * np.linspace(0.5, 3.0, d)
         + np.linspace(-2.0, 2.0, d)).astype(np.float32)
    beta = np.linspace(1.2, -1.2, d) / np.linspace(0.5, 3.0, d)
    p = 1 / (1 + np.exp(-((X - np.linspace(-2.0, 2.0, d)) @ beta + 0.3)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=n).astype(np.float32)
    return X, y, w


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=tol)


@pytest.mark.parametrize("elastic_net", [0.0, 0.5])
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_fit_logistic_matches_jax(standardize, fit_intercept, elastic_net):
    X, y, w = _data()
    jb, jb0 = JG.fit_logistic(jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
                              jnp.float32(0.03), jnp.float32(elastic_net),
                              max_iter=40, fit_intercept=fit_intercept,
                              standardize=standardize)
    pb, pb0 = PG.fit_logistic(torch.from_numpy(X), torch.from_numpy(y),
                              torch.from_numpy(w), 0.03, elastic_net,
                              max_iter=40, fit_intercept=fit_intercept,
                              standardize=standardize)
    assert pb.shape == (X.shape[1],) and pb0.dim() == 0
    _close(pb, jb)
    _close(float(pb0), float(jb0))
    if not fit_intercept:
        assert float(pb0) == 0.0
    if elastic_net:   # the proximal step zeroes some coefficients alike
        np.testing.assert_array_equal(pb.numpy() == 0, np.asarray(jb) == 0)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("standardize", [True, False])
def test_fit_linear_svc_matches_jax(standardize, fit_intercept):
    X, y, w = _data(seed=1)
    jb, jb0 = JG.fit_linear_svc(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(w), jnp.float32(0.05),
                                max_iter=40, fit_intercept=fit_intercept,
                                standardize=standardize)
    pb, pb0 = PG.fit_linear_svc(torch.from_numpy(X), torch.from_numpy(y),
                                torch.from_numpy(w), 0.05, max_iter=40,
                                fit_intercept=fit_intercept,
                                standardize=standardize)
    _close(pb, jb)
    _close(float(pb0), float(jb0))


@pytest.mark.parametrize("loss", ["logistic", "svc"])
@pytest.mark.parametrize("standardize", [True, False])
def test_lanes_match_one_fit_each(loss, standardize):
    """L lanes in one call (each with its own weights, penalties and
    stopping point) against L single fits of the JAX package — the
    vmapped route's fit."""
    X, y, w = _data(n=1200, seed=2)
    rng = np.random.default_rng(3)
    W = np.stack([w * (rng.uniform(size=len(y)) < 0.7) for _ in range(4)])
    regs = np.array([0.001, 0.02, 0.2, 1.0], np.float32)
    alphas = np.array([0.0, 0.25, 0.5, 0.0], np.float32)
    if loss == "logistic":
        pB, pb0 = PG.fit_logistic(torch.from_numpy(X), torch.from_numpy(y),
                                  torch.from_numpy(W), torch.from_numpy(regs),
                                  torch.from_numpy(alphas), max_iter=30,
                                  standardize=standardize)
    else:
        pB, pb0 = PG.fit_linear_svc(torch.from_numpy(X), torch.from_numpy(y),
                                    torch.from_numpy(W),
                                    torch.from_numpy(regs), max_iter=30,
                                    standardize=standardize)
    assert pB.shape == (4, X.shape[1]) and pb0.shape == (4,)
    for lane in range(4):
        args = (jnp.asarray(X), jnp.asarray(y), jnp.asarray(W[lane]),
                jnp.float32(regs[lane]))
        if loss == "logistic":
            jb, jb0 = JG.fit_logistic(*args, jnp.float32(alphas[lane]),
                                      max_iter=30, standardize=standardize)
        else:
            jb, jb0 = JG.fit_linear_svc(*args, max_iter=30,
                                        standardize=standardize)
        _close(pB[lane], jb)
        _close(float(pb0[lane]), float(jb0))


def test_max_iter_stops_each_lane():
    """A lane stops at max_iter even while others converge: one Newton
    step from zero, as the JAX solver takes under max_iter=1."""
    X, y, w = _data(n=800, seed=4)
    pB, pb0 = PG.fit_logistic(torch.from_numpy(X), torch.from_numpy(y),
                              torch.from_numpy(np.stack([w, w])),
                              torch.tensor([0.01, 0.5]), 0.0, max_iter=1)
    for lane, reg in enumerate((0.01, 0.5)):
        jb, jb0 = JG.fit_logistic(jnp.asarray(X), jnp.asarray(y),
                                  jnp.asarray(w), jnp.float32(reg),
                                  jnp.float32(0.0), max_iter=1)
        _close(pB[lane], jb)
        _close(float(pb0[lane]), float(jb0))


@pytest.mark.parametrize("name", ["logistic", "svc"])
def test_estimator_fit_and_scores_match_jax(name):
    X, y, w = _data(n=1000, seed=5)
    params = dict(reg_param=0.02, max_iter=30)
    if name == "logistic":
        jm = JLR(elastic_net_param=0.25, **params).fit_arrays(X, y, w)
        pm = OpLogisticRegression(elastic_net_param=0.25, device="cpu",
                                  **params).fit_arrays(X, y, w)
    else:
        jm = JSVC(**params).fit_arrays(X, y, w)
        pm = OpLinearSVC(device="cpu", **params).fit_arrays(X, y, w)
    assert isinstance(pm, LinearBinaryModel)
    _close(pm.beta, jm.beta)
    _close(pm.intercept, jm.intercept)
    jpred, jraw, jprob = jm.predict_arrays(X)
    ppred, praw, pprob = pm.predict_arrays(X)
    # margins within the coefficients' tolerance times |x| (~6 here)
    _close(praw, jraw, tol=10 * TOL)
    assert (ppred != jpred).mean() < 0.01   # rows at the margin may flip
    assert (pprob is None) == (jprob is None) == (name == "svc")
    if pprob is not None:
        _close(pprob, jprob, tol=10 * TOL)
        np.testing.assert_array_equal(ppred, pprob[:, 1] >= 0.5)


@pytest.mark.parametrize("est", [JLR, JSVC])
def test_linear_model_from_jax_scores_identically(est):
    X, y, w = _data(n=700, seed=6)
    jm = est(reg_param=0.05, max_iter=20).fit_arrays(X, y, w)
    pm = convert.linear_model_from_jax(jm.save_args(), device="cpu")
    assert pm.probabilistic == jm.probabilistic
    jpred, jraw, jprob = jm.predict_arrays(X)
    ppred, praw, pprob = pm.predict_arrays(X)
    _close(praw, jraw, tol=1e-6)
    np.testing.assert_array_equal(ppred, jpred)
    if jprob is None:
        assert pprob is None
    else:
        _close(pprob, jprob, tol=1e-6)
    again = LinearBinaryModel(**{k: v for k, v in pm.save_args().items()
                                 if k != "uid"}, device="cpu")
    np.testing.assert_array_equal(again.predict_arrays(X)[1], praw)


def test_batched_fit_fn_axes_and_model_from_params():
    lr = OpLogisticRegression(device="cpu")
    fit_one, axes = lr.batched_fit_fn()
    assert axes == ("reg_param", "elastic_net_param")
    assert OpLinearSVC(device="cpu").batched_fit_fn()[1] == ("reg_param",)
    m = lr.model_from_params(np.ones(3, np.float32), 0.5)
    assert m.probabilistic and m.device == "cpu"
    assert not OpLinearSVC(device="cpu").model_from_params(
        np.ones(3), 0.0).probabilistic
    # three classes swap in the softmax lanes under the same signature
    fit3, axes3 = lr.batched_fit_fn(n_classes=3)
    assert axes3 == axes
    X, y, _ = _data(n=120, seed=3)
    y3 = torch.from_numpy(np.where(X[:, 0] > 0.5, 2.0, y)).float()
    B, b0 = fit3(torch.from_numpy(X), y3, torch.ones(2, 120),
                 torch.tensor([0.1, 0.01]), torch.tensor([0.0, 0.5]))
    assert B.shape == (2, X.shape[1], 3) and b0.shape == (2, 3)
    assert type(lr.model_from_params(B[0].numpy(), b0[0].numpy())
                ).__name__ == "SoftmaxModel"


def test_multiclass_raises_and_cuda_is_the_default(monkeypatch):
    X, y, _ = _data(n=300, seed=7)
    # multiclass logistic regression fits softmax; the SVC stays binary
    y3 = np.where(y > 0, 2, 0)
    m = OpLogisticRegression(device="cpu").fit_arrays(X, y3)
    assert type(m).__name__ == "SoftmaxModel" and m.B.shape[1] == 3
    with pytest.raises(ValueError, match="binary"):
        OpLinearSVC(device="cpu").fit_arrays(X, y3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for est in (OpLogisticRegression(), OpLinearSVC()):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            est.fit_arrays(X, y)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LinearBinaryModel(np.ones(X.shape[1]), 0.0).predict_arrays(X)
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CrossValidation(Evaluators.BinaryClassification.au_pr()).validate(
            [(OpLogisticRegression(), [{"reg_param": 0.1}])], X, y)
