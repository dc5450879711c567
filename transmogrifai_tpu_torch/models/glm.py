"""GLM-family predictors (counterpart of models/glm.py): logistic
regression (binary and softmax), the linear SVC, naive Bayes, linear and
generalized linear regression.

Reference wrappers: core/.../impl/classification/{OpLogisticRegression,
OpLinearSVC, OpNaiveBayes}.scala, core/.../impl/regression/{OpLinearRegression,
OpGeneralizedLinearRegression}.scala. Param names mirror the Spark params the reference
grids over (DefaultSelectorParams.scala:35-56). Fits run through the
lane-batched ops/glm solvers, so the model selector fits (fold x grid)
lanes in one call (`batched_fit_fn`) or streams them
(`streamed_loss`, ops/glm_sweep.py; linear regression's squared loss
takes its Gram route); a multiclass sweep fits softmax lanes. Generalized
linear regression and naive Bayes have no lane-batched fit: the selector
sweeps them through the validator's sequential route.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..ops import glm as G
from ..stages.params import Param
from .base import PredictionModel, PredictorEstimator, stable_sigmoid


class LinearBinaryModel(PredictionModel):
    """Binary linear scorer: logistic (prob via sigmoid) or SVC (margin).
    The margins are computed on the model's device; results are numpy."""

    def __init__(self, beta: np.ndarray, intercept: float,
                 probabilistic: bool = True,
                 operation_name: str = "linBin", uid: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.beta = np.array(beta, np.float32)
        self.intercept = float(intercept)
        self.probabilistic = probabilistic

    def predict_arrays(self, X):
        dev = resolve_device(self.device)
        Xd = to_device(X, dev, label="predict")
        margin = (Xd @ torch.as_tensor(self.beta, device=dev)
                  + self.intercept).cpu().numpy()
        raw = np.stack([-margin, margin], axis=1)
        if self.probabilistic:
            p1 = stable_sigmoid(margin)
            prob = np.stack([1.0 - p1, p1], axis=1)
            pred = (p1 >= 0.5).astype(np.float32)
        else:
            prob = None
            pred = (margin >= 0.0).astype(np.float32)
        return pred, raw, prob

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(beta=self.beta.tolist(), intercept=self.intercept,
                 probabilistic=self.probabilistic)
        return d


def _softmax_rows(raw: torch.Tensor) -> torch.Tensor:
    e = torch.exp(raw - raw.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


class SoftmaxModel(PredictionModel):
    """Multinomial logistic scorer: logits X B + b0 [n, c], computed on the
    model's device; results are numpy."""

    def __init__(self, B: np.ndarray, b0: np.ndarray,
                 operation_name: str = "softmax", uid: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.B = np.array(B, np.float32)
        self.b0 = np.array(b0, np.float32)

    def predict_arrays(self, X):
        dev = resolve_device(self.device)
        logits = (to_device(X, dev, label="predict")
                  @ torch.as_tensor(self.B, device=dev)
                  + torch.as_tensor(self.b0, device=dev)[None, :])
        logits = logits - logits.amax(dim=1, keepdim=True)
        prob = _softmax_rows(logits)
        pred = prob.argmax(dim=1).to(torch.float32)
        return pred.cpu().numpy(), logits.cpu().numpy(), prob.cpu().numpy()

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(B=self.B.tolist(), b0=self.b0.tolist())
        return d


class NaiveBayesModel(PredictionModel):
    """Multinomial naive Bayes scorer: raw max(X, 0) log_prob^T + log_prior
    [n, c] on the model's device; results are numpy."""

    def __init__(self, log_prob: np.ndarray, log_prior: np.ndarray,
                 operation_name: str = "nb", uid: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.log_prob = np.array(log_prob, np.float32)
        self.log_prior = np.array(log_prior, np.float32)

    def predict_arrays(self, X):
        dev = resolve_device(self.device)
        raw = (torch.clamp(to_device(X, dev, label="predict"), min=0.0)
               @ torch.as_tensor(self.log_prob, device=dev).T
               + torch.as_tensor(self.log_prior, device=dev)[None, :])
        prob = _softmax_rows(raw)
        pred = raw.argmax(dim=1).to(torch.float32)
        return pred.cpu().numpy(), raw.cpu().numpy(), prob.cpu().numpy()

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(log_prob=self.log_prob.tolist(),
                 log_prior=self.log_prior.tolist())
        return d


class LinearRegressionModel(PredictionModel):
    """Linear predictor with the identity or the log link (generalized
    linear regression's poisson and gamma families). The products run on
    the model's device; results are numpy."""

    def __init__(self, beta: np.ndarray, intercept: float,
                 link: str = "identity",
                 operation_name: str = "linReg", uid: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.beta = np.array(beta, np.float32)
        self.intercept = float(intercept)
        self.link = link

    def predict_arrays(self, X):
        dev = resolve_device(self.device)
        eta = (to_device(X, dev, label="predict")
               @ torch.as_tensor(self.beta, device=dev) + self.intercept)
        pred = torch.exp(eta) if self.link == "log" else eta
        return pred.cpu().numpy().astype(np.float32), None, None

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(beta=self.beta.tolist(), intercept=self.intercept,
                 link=self.link)
        return d


def _weights(y: torch.Tensor, w) -> torch.Tensor:
    return torch.ones_like(y) if w is None else \
        torch.as_tensor(w, dtype=torch.float32, device=y.device)


def _one_hot(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    return torch.nn.functional.one_hot(y.long(), n_classes).to(torch.float32)


# the selector's lane-batched fit: fit_one(X [n, d], y [n], w [L, n],
# reg [L], alpha [L]) -> (B [L, d], b0 [L]), every lane its own fit
def _batched_logistic(max_iter, fit_intercept, standardize):
    def fit_one(X, y, w, reg, alpha):
        return G.fit_logistic(X, y, w, reg, alpha, max_iter=max_iter,
                              fit_intercept=fit_intercept,
                              standardize=standardize)
    return fit_one


def _batched_softmax(max_iter, fit_intercept, standardize, n_classes):
    """The multiclass fit_one: the binary closure's signature, the labels
    one-hot inside; returns (B [L, d, c], b0 [L, c])."""
    def fit_one(X, y, w, reg, alpha):
        return G.fit_softmax(X, _one_hot(y, n_classes), w, reg, alpha,
                             max_iter=max_iter, fit_intercept=fit_intercept,
                             standardize=standardize)
    return fit_one


def _batched_svc(max_iter, fit_intercept, standardize):
    def fit_one(X, y, w, reg, _alpha):
        return G.fit_linear_svc(X, y, w, reg, max_iter=max_iter,
                                fit_intercept=fit_intercept,
                                standardize=standardize)
    return fit_one


def _batched_linear(max_iter, fit_intercept, standardize):
    def fit_one(X, y, w, reg, alpha):
        return G.fit_linear(X, y, w, reg, alpha, max_iter=max_iter,
                            fit_intercept=fit_intercept,
                            standardize=standardize)
    return fit_one


class OpLogisticRegression(PredictorEstimator):
    """Reference OpLogisticRegression (impl/classification/, 212 LoC):
    binary logistic regression, softmax from three classes on (at most 30
    iterations, as the reference's)."""

    problem_types = ("binary", "multiclass")
    supports_grid_vmap = True
    supports_multiclass_vmap = True
    # large binary sweeps stream ALL (fold x grid) lanes through shared
    # X passes (ops/glm_sweep.py); the round driver retires each lane at
    # its OWN delta <= tol — the stopping rule of fit_arrays' solver
    streamed_loss = "logistic"

    @classmethod
    def _declare_params(cls):
        return [
            Param("reg_param", "regularization strength", 0.0),
            Param("elastic_net_param", "L1 ratio", 0.0),
            Param("max_iter", "Newton iterations", 50),
            Param("tol", "termination tolerance", 1e-6),
            Param("fit_intercept", "fit intercept", True),
            Param("standardization", "standardize features", True),
        ]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("logreg", uid=uid, device=device, **params)

    def _softmax_iters(self) -> int:
        return min(int(self.get_param("max_iter")), 30)

    def fit_arrays(self, X, y, w=None):
        dev = resolve_device(self.device)
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        n_classes = int(yd.max()) + 1 if yd.numel() else 2
        Xd = to_device(X, dev, label="fit")
        reg = float(self.get_param("reg_param"))
        alpha = float(self.get_param("elastic_net_param"))
        fit_intercept = bool(self.get_param("fit_intercept"))
        standardize = bool(self.get_param("standardization"))
        if n_classes > 2:
            B, b0 = G.fit_softmax(
                Xd, _one_hot(yd, n_classes), _weights(yd, w), reg, alpha,
                max_iter=self._softmax_iters(), fit_intercept=fit_intercept,
                standardize=standardize)
            return self.model_from_params(B.cpu().numpy(), b0.cpu().numpy())
        beta, b0 = G.fit_logistic(
            Xd, yd, _weights(yd, w), reg, alpha,
            max_iter=int(self.get_param("max_iter")),
            tol=float(self.get_param("tol")), fit_intercept=fit_intercept,
            standardize=standardize)
        return self.model_from_params(beta.cpu().numpy(), float(b0))

    def batched_fit_fn(self, n_classes: int = 2):
        """The lane fit of the selector's sweep; from three classes on the
        softmax lanes, with the same closure signature."""
        if n_classes > 2:
            fit_one = _batched_softmax(
                self._softmax_iters(), bool(self.get_param("fit_intercept")),
                bool(self.get_param("standardization")), int(n_classes))
        else:
            fit_one = _batched_logistic(
                int(self.get_param("max_iter")),
                bool(self.get_param("fit_intercept")),
                bool(self.get_param("standardization")))
        return fit_one, ("reg_param", "elastic_net_param")

    def model_from_params(self, beta, b0):
        beta = np.asarray(beta)
        if beta.ndim == 2:          # a softmax fit: B [d, c], b0 [c]
            return SoftmaxModel(beta, np.asarray(b0),
                                operation_name=self.operation_name,
                                device=self.device)
        return LinearBinaryModel(beta, float(b0),
                                 probabilistic=True,
                                 operation_name=self.operation_name,
                                 device=self.device)


class OpLinearSVC(PredictorEstimator):
    """Reference OpLinearSVC (impl/classification/, 166 LoC)."""

    problem_types = ("binary",)
    supports_grid_vmap = True
    produces_probabilities = False
    # same retirement parity contract as OpLogisticRegression; the
    # 0.5*gap^2 loss scaling keeps reg_param's effective L2 identical on
    # the streamed and per-lane routes
    streamed_loss = "squared_hinge"

    @classmethod
    def _declare_params(cls):
        return [
            Param("reg_param", "L2 strength", 0.0),
            Param("max_iter", "Newton iterations", 50),
            Param("tol", "termination tolerance", 1e-6),
            Param("fit_intercept", "fit intercept", True),
            Param("standardization", "standardize features", True),
        ]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("svc", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> LinearBinaryModel:
        dev = resolve_device(self.device)
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if yd.numel() and int(yd.max()) > 1:
            raise ValueError("the linear SVC is binary, as Spark's LinearSVC")
        beta, b0 = G.fit_linear_svc(
            to_device(X, dev, label="fit"), yd,
            _weights(yd, w), float(self.get_param("reg_param")),
            max_iter=int(self.get_param("max_iter")),
            tol=float(self.get_param("tol")),
            fit_intercept=bool(self.get_param("fit_intercept")),
            standardize=bool(self.get_param("standardization")))
        return LinearBinaryModel(beta.cpu().numpy(), float(b0),
                                 probabilistic=False,
                                 operation_name=self.operation_name,
                                 device=self.device)

    def batched_fit_fn(self):
        fit_one = _batched_svc(int(self.get_param("max_iter")),
                               bool(self.get_param("fit_intercept")),
                               bool(self.get_param("standardization")))
        return fit_one, ("reg_param",)

    def model_from_params(self, beta, b0) -> LinearBinaryModel:
        return LinearBinaryModel(np.asarray(beta), float(b0),
                                 probabilistic=False,
                                 operation_name=self.operation_name,
                                 device=self.device)


class OpNaiveBayes(PredictorEstimator):
    """Reference OpNaiveBayes (multinomial; 112 LoC), binary and
    multiclass: the selector sweeps it through the sequential route."""

    problem_types = ("binary", "multiclass")

    @classmethod
    def _declare_params(cls):
        return [Param("smoothing", "Laplace smoothing", 1.0)]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("naiveBayes", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> NaiveBayesModel:
        dev = resolve_device(self.device)
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        n_classes = max(int(yd.max()) + 1 if yd.numel() else 2, 2)
        log_prob, log_prior = G.fit_naive_bayes(
            to_device(X, dev, label="fit"), _one_hot(yd, n_classes),
            _weights(yd, w), float(self.get_param("smoothing")))
        return NaiveBayesModel(log_prob.cpu().numpy(),
                               log_prior.cpu().numpy(),
                               operation_name=self.operation_name,
                               device=self.device)


class OpLinearRegression(PredictorEstimator):
    """Reference OpLinearRegression (impl/regression/, 186 LoC)."""

    problem_types = ("regression",)
    supports_grid_vmap = True
    produces_probabilities = False
    # the squared loss's curvature is 1, so large sweeps take the Gram
    # route (ops/glm_sweep.sweep_glm_squared_gram): one pass over X for
    # every fold's moments, then the grid solves from them
    streamed_loss = "squared"

    @classmethod
    def _declare_params(cls):
        return [
            Param("reg_param", "regularization strength", 0.0),
            Param("elastic_net_param", "L1 ratio", 0.0),
            Param("max_iter", "iterations", 50),
            Param("tol", "termination tolerance", 1e-6),
            Param("fit_intercept", "fit intercept", True),
            Param("standardization", "standardize features", True),
            Param("solver", "auto|normal|l-bfgs (ignored; Newton used)",
                  "auto"),
        ]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("linReg", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> LinearRegressionModel:
        dev = resolve_device(self.device)
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        beta, b0 = G.fit_linear(
            to_device(X, dev, label="fit"), yd, _weights(yd, w),
            float(self.get_param("reg_param")),
            float(self.get_param("elastic_net_param")),
            max_iter=int(self.get_param("max_iter")),
            tol=float(self.get_param("tol")),
            fit_intercept=bool(self.get_param("fit_intercept")),
            standardize=bool(self.get_param("standardization")))
        return self.model_from_params(beta.cpu().numpy(), float(b0))

    def batched_fit_fn(self):
        fit_one = _batched_linear(int(self.get_param("max_iter")),
                                  bool(self.get_param("fit_intercept")),
                                  bool(self.get_param("standardization")))
        return fit_one, ("reg_param", "elastic_net_param")

    def model_from_params(self, beta, b0) -> LinearRegressionModel:
        return LinearRegressionModel(np.asarray(beta), float(b0),
                                     operation_name=self.operation_name,
                                     device=self.device)


class OpGeneralizedLinearRegression(PredictorEstimator):
    """Reference OpGeneralizedLinearRegression (198 LoC): family/link
    GLR by IRLS."""

    problem_types = ("regression",)
    produces_probabilities = False

    @classmethod
    def _declare_params(cls):
        return [
            Param("family", "gaussian|poisson|gamma", "gaussian",
                  lambda v: v in G.GLR_FAMILIES),
            Param("reg_param", "L2 strength", 0.0),
            Param("max_iter", "IRLS iterations", 25),
            Param("fit_intercept", "fit intercept", True),
        ]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("glr", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> LinearRegressionModel:
        dev = resolve_device(self.device)
        family = self.get_param("family")
        y = np.asarray(y, np.float32)
        if family in ("poisson", "gamma"):
            y = np.maximum(y, np.float32(1e-6 if family == "gamma" else 0.0))
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        beta, b0 = G.fit_glr(
            to_device(X, dev, label="fit"), yd, _weights(yd, w),
            float(self.get_param("reg_param")), family=family,
            max_iter=int(self.get_param("max_iter")),
            fit_intercept=bool(self.get_param("fit_intercept")))
        return LinearRegressionModel(
            beta.cpu().numpy(), float(b0),
            link="log" if family in ("poisson", "gamma") else "identity",
            operation_name=self.operation_name, device=self.device)
