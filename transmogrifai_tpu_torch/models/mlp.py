"""Multilayer perceptron classifier + isotonic regression calibrator
(counterpart of models/mlp.py).

Reference: core/.../impl/classification/OpMultilayerPerceptronClassifier.scala
(Spark MLP = sigmoid hidden layers + softmax out) and
core/.../impl/regression/IsotonicRegressionCalibrator.scala.

The MLP trains full-batch Adam (b1 0.9, b2 0.999, eps 1e-8, bias
correction at step t = i + 1) on the weighted cross-entropy divided by the
weight sum plus `reg_param` times the squared weights (never the biases),
as a plain loop of steps on the estimator's device: matrix products,
sigmoids and a log-softmax, which the JAX package too computes outside any
kernel of its own. `torch.optim.Adam` without weight decay makes the same
update (its weight decay would decay the biases and halve the l2 term's
gradient, so the l2 term is in the loss). The initial weights are an input
(`fit_arrays(..., init=[(W, b), ...])`); without one they are He-normal
draws, normal * sqrt(2 / fan_in), from a CPU `torch.Generator` seeded with
`seed`, so the CPU and the card start from the same weights.

Isotonic regression is the pool-adjacent-violators pass on the host in
float64 (O(n) after a sort); the fitted step function is applied with a
float64 `searchsorted` on the model's device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.dataset import Column
from ..device import DeviceLike, resolve_device, to_device
from ..stages.base import Estimator, Transformer
from ..stages.params import Param
from ..types import ColumnKind, RealNN
from .base import PredictionModel, PredictorEstimator

Layers = List[Tuple[np.ndarray, np.ndarray]]


def init_params(sizes: Sequence[int], seed: int) -> Layers:
    """He-normal weights [fan_in, fan_out] and zero biases of each layer,
    drawn from a CPU generator seeded with `seed`."""
    gen = torch.Generator().manual_seed(int(seed))
    out = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn(fan_in, fan_out, generator=gen) \
            * math.sqrt(2.0 / fan_in)
        out.append((w.numpy(), np.zeros(fan_out, np.float32)))
    return out


class MLP(nn.Module):
    """The layers: weights [fan_in, fan_out] and biases, sigmoid hidden
    units, logits out."""

    def __init__(self, layers: Layers, device: torch.device):
        super().__init__()
        self.weights = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(w, np.float32),
                                      device=device)) for w, _ in layers)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.tensor(np.asarray(b, np.float32),
                                      device=device)) for _, b in layers)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        h = X
        for w, b in zip(self.weights[:-1], self.biases[:-1]):
            h = torch.sigmoid(h @ w + b)   # Spark MLP uses sigmoid units
        return h @ self.weights[-1] + self.biases[-1]

    def layers(self) -> Layers:
        return [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
                for w, b in zip(self.weights, self.biases)]


def fit_mlp(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
            init: Layers, steps: int, lr: float, l2: float) -> MLP:
    """Full-batch Adam on X [n, d], one-hot Y [n, c] and row weights w
    [n], from the layers `init`."""
    net = MLP(init, X.device)
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    wsum = w.sum() + 1e-12
    for _ in range(int(steps)):
        opt.zero_grad(set_to_none=True)
        logp = torch.log_softmax(net(X), dim=1)
        ce = -(Y * logp).sum(dim=1)
        reg = sum((v * v).sum() for v in net.weights)
        ((w * ce).sum() / wsum + l2 * reg).backward()
        opt.step()
    return net


class MLPModel(PredictionModel):
    """Fitted MLP: (W, b) layers, sigmoid hidden + softmax out, scored on
    the model's device; results are numpy."""

    def __init__(self, weights: List[np.ndarray], biases: List[np.ndarray],
                 operation_name: str = "mlp", uid: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.weights = [np.asarray(w, np.float32) for w in weights]
        self.biases = [np.asarray(b, np.float32) for b in biases]

    def predict_arrays(self, X):
        dev = resolve_device(self.device)
        net = MLP(list(zip(self.weights, self.biases)), dev)
        with torch.no_grad():
            logits = net(to_device(X, dev, label="predict"))
            prob = torch.softmax(logits, dim=1)
        pred = prob.argmax(dim=1).to(torch.float32)
        return pred.cpu().numpy(), logits.cpu().numpy(), prob.cpu().numpy()

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(weights=self.weights, biases=self.biases)
        return d


class OpMultilayerPerceptronClassifier(PredictorEstimator):
    """Reference OpMultilayerPerceptronClassifier (149 LoC), binary and
    multiclass: the selector sweeps it through the sequential route."""

    problem_types = ("binary", "multiclass")

    @classmethod
    def _declare_params(cls):
        return [
            Param("hidden_layers", "hidden layer sizes", [10, 10]),
            Param("max_iter", "Adam steps", 200),
            Param("step_size", "learning rate", 0.05),
            Param("reg_param", "L2 strength", 1e-4),
            Param("seed", "init seed", 42),
        ]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("mlpClassifier", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None,
                   init: Optional[Layers] = None) -> MLPModel:
        """Fit on X [n, d], labels y [n] (0..c-1) and weights w [n] from
        the layers `init` (default: `init_params` of the `seed` param)."""
        dev = resolve_device(self.device)
        Xd = to_device(X, dev, label="fit")
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        n_classes = max(int(yd.max()) + 1 if yd.numel() else 2, 2)
        Y = torch.nn.functional.one_hot(yd.long(), n_classes) \
            .to(torch.float32)
        wd = torch.ones_like(yd) if w is None else \
            torch.as_tensor(w, dtype=torch.float32, device=dev)
        if init is None:
            hidden = [int(h) for h in self.get_param("hidden_layers")]
            init = init_params([Xd.shape[1]] + hidden + [n_classes],
                               int(self.get_param("seed")))
        net = fit_mlp(Xd, Y, wd, init, int(self.get_param("max_iter")),
                      float(self.get_param("step_size")),
                      float(self.get_param("reg_param")))
        layers = net.layers()
        return MLPModel([a for a, _ in layers], [b for _, b in layers],
                        operation_name=self.operation_name,
                        device=self.device)


# -- isotonic regression ----------------------------------------------------

def pav_fit(x: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Pool-adjacent-violators: weighted isotonic fit of y on x, in float64
    on the host.

    Returns (boundaries, values): step function value[i] on x >=
    boundaries[i] (right-continuous), non-decreasing. Rows are taken in
    the stable order of x; a block pools into its predecessor while the
    predecessor's mean is >= its own (ties in x are not pooled as such)."""
    order = np.argsort(x, kind="stable")
    xs, ys = x[order], y[order].astype(np.float64)
    ws = (np.ones(len(y)) if w is None else w[order]).astype(np.float64)
    vals: List[float] = []      # per block: sum of w*y, sum of w, x start
    wsum: List[float] = []
    xstart: List[float] = []
    for xi, yi, wi in zip(xs, ys, ws):
        vals.append(yi * wi)
        wsum.append(wi)
        xstart.append(xi)
        while len(vals) > 1 and vals[-2] / wsum[-2] >= vals[-1] / wsum[-1]:
            v, s = vals.pop(), wsum.pop()
            xstart.pop()
            vals[-1] += v
            wsum[-1] += s
    values = np.array([v / s for v, s in zip(vals, wsum)])
    return np.asarray(xstart, np.float64), values


class IsotonicRegressionCalibrator(Estimator):
    """(RealNN label, RealNN score) -> RealNN calibrated score (reference
    IsotonicRegressionCalibrator.scala:63 wrapping Spark
    IsotonicRegression). `isotonic=False` fits a non-increasing function
    (the score negated)."""

    input_types = (RealNN, RealNN)
    output_type = RealNN

    @classmethod
    def _declare_params(cls):
        return [Param("isotonic", "non-decreasing if true", True)]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        self.device = device
        super().__init__("isoCalibrator", uid=uid, **params)

    def fit_columns(self, *cols) -> Transformer:
        label = np.asarray(cols[0].data, np.float64)
        score = np.asarray(cols[1].data, np.float64)
        ok = ~(np.isnan(label) | np.isnan(score))
        x, y = score[ok], label[ok]
        if not bool(self.get_param("isotonic")):
            x = -x
        bounds, values = pav_fit(x, y)
        return IsotonicRegressionModel(
            boundaries=bounds, values=values,
            increasing=bool(self.get_param("isotonic")),
            operation_name=self.operation_name, device=self.device)


class IsotonicRegressionModel(Transformer):
    """The fitted step function: value[searchsorted(boundaries, x, right)
    - 1], the index clipped to the steps, in float64 on the model's
    device."""

    input_types = (RealNN, RealNN)
    output_type = RealNN

    def __init__(self, boundaries: Optional[np.ndarray] = None,
                 values: Optional[np.ndarray] = None, increasing: bool = True,
                 uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        self.boundaries = np.asarray(
            boundaries if boundaries is not None else [0.0], np.float64)
        self.values = np.asarray(values if values is not None else [0.0],
                                 np.float64)
        self.increasing = bool(increasing)
        self.device = device
        super().__init__(params.pop("operation_name", "isoCalibrator"),
                         uid=uid, **params)

    def apply(self, score) -> np.ndarray:
        """Calibrated values of `score` (array or tensor) as float64."""
        dev = resolve_device(self.device)
        x = torch.as_tensor(np.asarray(score, np.float64), device=dev) \
            if not isinstance(score, torch.Tensor) \
            else score.to(dev, torch.float64)
        if not self.increasing:
            x = -x
        b = torch.as_tensor(self.boundaries, device=dev)
        idx = torch.clamp(torch.searchsorted(b, x, right=True) - 1,
                          0, len(self.values) - 1)
        return torch.as_tensor(self.values, device=dev)[idx].cpu().numpy()

    def transform_value(self, *vals):
        return RealNN(float(self.apply(np.asarray([vals[-1].value]))[0]))

    def transform_columns(self, *cols):
        return Column(kind=ColumnKind.FLOAT,
                      data=self.apply(np.asarray(cols[-1].data, np.float64)))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(boundaries=self.boundaries, values=self.values,
                 increasing=self.increasing)
        return d
