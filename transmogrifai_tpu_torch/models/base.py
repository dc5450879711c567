"""Predictor estimator/model bases (counterpart of models/base.py).

Reference: core/.../sparkwrappers/specific/OpPredictorWrapper.scala:67 —
every model is an Estimator2(RealNN label, OPVector features) producing a
Prediction. `fit_arrays` / `predict_arrays` are the tensor path the
model-selector sweep uses; `fit_columns` / `transform_columns` wire them to
the workflow's columns (the Prediction column layout of
models/prediction.py).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..data.dataset import Column
from ..device import DeviceLike
from ..stages.base import Estimator, Transformer
from ..types import OPVector, Prediction, RealNN
from .prediction import make_prediction_column, row_prediction


def stable_sigmoid(x: np.ndarray) -> np.ndarray:
    """Overflow-safe logistic: exp only ever sees non-positive arguments."""
    x = np.asarray(x)
    out = np.empty_like(
        x, dtype=x.dtype if x.dtype.kind == "f" else np.float64)
    pos = x >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-x[pos]))
    ex = np.exp(x[~pos])
    out[~pos] = ex / (1.0 + ex)
    return out


def _as_matrix(col: Column) -> np.ndarray:
    m = col.data
    if m.ndim == 1:
        m = m[:, None]
    return np.ascontiguousarray(m, dtype=np.float32)


def _as_labels(col: Column) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(col.data, dtype=np.float64),
                                dtype=np.float32)


class PredictionModel(Transformer):
    """Fitted model: (label, features) -> Prediction column; X -> (prediction,
    raw prediction, probability) on the tensor path."""

    input_types = (RealNN, OPVector)
    output_type = Prediction

    def __init__(self, operation_name: str, uid: Optional[str] = None,
                 device: DeviceLike = None, **params: Any):
        self.device = device
        super().__init__(operation_name, uid=uid, **params)

    # -- tensor path -------------------------------------------------------
    def predict_arrays(self, X) -> Tuple[np.ndarray, Optional[np.ndarray],
                                         Optional[np.ndarray]]:
        """X [n,d] -> (prediction [n], raw [n,c]|None, prob [n,c]|None)."""
        raise NotImplementedError

    # -- column path -------------------------------------------------------
    def transform_columns(self, *cols: Column) -> Column:
        vec = cols[-1]  # features are the last input
        pred, raw, prob = self.predict_arrays(_as_matrix(vec))
        return make_prediction_column(pred, raw, prob)

    def transform_value(self, *vals):
        X = np.asarray(vals[-1].value, dtype=np.float32)[None, :]
        return row_prediction(
            make_prediction_column(*self.predict_arrays(X)), 0)

    def transform_keyvalue(self, row: Dict[str, Any]) -> Any:
        X = np.asarray(row.get(self.input_names()[-1]),
                       dtype=np.float32)[None, :]
        return row_prediction(
            make_prediction_column(*self.predict_arrays(X)), 0).value


class PredictorEstimator(Estimator):
    """Unfitted model: fit(label, features) -> PredictionModel, and
    fit_arrays(X, y, w) on the tensor path. `device` is where fits run:
    None means CUDA (device.resolve_device)."""

    input_types = (RealNN, OPVector)
    output_type = Prediction
    # model-selector hints
    problem_types = ("binary",)   # subset of binary|multiclass|regression
    supports_grid_vmap = False    # GLMs override: grid+fold axes batched
    produces_probabilities = True  # margin-only models (SVC) override False

    def __init__(self, operation_name: str, uid: Optional[str] = None,
                 device: DeviceLike = None, **params: Any):
        self.device = device
        super().__init__(operation_name, uid=uid, **params)

    def copy(self, **param_overrides: Any) -> "PredictorEstimator":
        """Fresh instance (new uid, same device) with the current params and
        `param_overrides` — used by the model selector to expand grids."""
        clone = type(self)(device=self.device, **self.param_values())
        clone.set_params(**param_overrides)
        if self.input_features:
            clone.set_input(*self.input_features)
        return clone

    def fit_arrays(self, X, y, w=None) -> PredictionModel:
        raise NotImplementedError

    def fit_columns(self, *cols: Column) -> PredictionModel:
        label_col, vec_col = cols
        return self.fit_arrays(_as_matrix(vec_col), _as_labels(label_col))
