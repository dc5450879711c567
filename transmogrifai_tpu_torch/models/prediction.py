"""Dense columnar representation of Prediction outputs (counterpart of
models/prediction.py, the same layout).

The reference stores Prediction as a reserved-key Map column
(features/.../types/Maps.scala:302). A map-of-doubles per row would cripple
the tensor path, so here a prediction column is a dense float32 block
``[n, 1 + n_raw + n_prob]`` laid out [prediction, rawPrediction_*,
probability_*] with the layout carried in the column's VectorMetadata
(named columns, so it survives row gathers). Conversion
to/from the Prediction map type happens only at API boundaries (local
scoring, row access).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..data.dataset import Column
from ..data.vector import VectorColumnMetadata, VectorMetadata
from ..types import ColumnKind, Prediction

_PRED = Prediction.PREDICTION_NAME
_RAW = Prediction.RAW_PREDICTION_NAME
_PROB = Prediction.PROBABILITY_NAME


def make_prediction_column(prediction: np.ndarray,
                           raw_prediction: Optional[np.ndarray] = None,
                           probability: Optional[np.ndarray] = None) -> Column:
    pred = np.asarray(prediction, dtype=np.float32).reshape(-1, 1)
    parts = [pred]
    names = [_PRED]
    for arr, prefix in ((raw_prediction, _RAW), (probability, _PROB)):
        if arr is None:
            continue
        a = np.asarray(arr, dtype=np.float32)
        if a.ndim == 1:
            a = a[:, None]
        parts.append(a)
        names.extend(f"{prefix}_{i}" for i in range(a.shape[1]))
    data = np.concatenate(parts, axis=1)
    md = VectorMetadata(name=_PRED, columns=[
        VectorColumnMetadata(parent_feature_name=_PRED,
                             parent_feature_type="Prediction",
                             descriptor_value=nm, index=i)
        for i, nm in enumerate(names)])
    return Column(kind=ColumnKind.VECTOR, data=data, metadata=md)


def _layout(col: Column) -> Tuple[int, int]:
    """(n_raw, n_prob) from metadata; fallback: symmetric split."""
    if col.metadata is not None and col.metadata.columns and \
            col.metadata.columns[0].descriptor_value == _PRED:
        n_raw = sum(1 for c in col.metadata.columns
                    if (c.descriptor_value or "").startswith(_RAW + "_"))
        n_prob = sum(1 for c in col.metadata.columns
                     if (c.descriptor_value or "").startswith(_PROB + "_"))
        return n_raw, n_prob
    width = col.data.shape[1]
    c = (width - 1) // 2
    return c, c


def n_classes_of(col: Column) -> int:
    n_raw, n_prob = _layout(col)
    return int(max(n_raw, n_prob))


def prediction_of(col: Column) -> np.ndarray:
    return col.data[:, 0]


def raw_prediction_of(col: Column) -> Optional[np.ndarray]:
    n_raw, _ = _layout(col)
    return col.data[:, 1:1 + n_raw] if n_raw else None


def probability_of(col: Column) -> Optional[np.ndarray]:
    n_raw, n_prob = _layout(col)
    return col.data[:, 1 + n_raw:1 + n_raw + n_prob] if n_prob else None


def positive_score_of(col: Column) -> np.ndarray:
    """Score used by binary evaluators: P(class 1) when the model is
    probabilistic, else the positive-class margin (rawPrediction_1 — how the
    reference evaluates LinearSVC), else the hard prediction."""
    prob = probability_of(col)
    if prob is not None and prob.shape[1] >= 2:
        return prob[:, 1]
    raw = raw_prediction_of(col)
    if raw is not None and raw.shape[1] >= 2:
        return raw[:, 1]
    return col.data[:, 0]


def row_prediction(col: Column, i: int) -> Prediction:
    row = col.data[i]
    n_raw, n_prob = _layout(col)
    return Prediction(
        prediction=float(row[0]),
        raw_prediction=[float(x) for x in row[1:1 + n_raw]] if n_raw else None,
        probability=[float(x) for x in row[1 + n_raw:1 + n_raw + n_prob]]
        if n_prob else None)
