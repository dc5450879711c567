"""Numeric vectorizers: imputation + null tracking (counterpart of
automl/vectorizers/numeric.py; host numpy, as there).

Reference: core/.../impl/feature/{RealVectorizer, IntegralVectorizer,
BinaryVectorizer}.scala. The bucketizers (NumericBucketizer,
DecisionTreeNumericBucketizer) are not ported yet.

Layout matches the reference: for each input feature, its (imputed) value
column, then — when track_nulls — its null-indicator column.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Type

import numpy as np

from ...data.dataset import Column
from ...data.vector import NULL_STRING, VectorColumnMetadata, VectorMetadata
from ...stages.params import Param
from ...types import Binary, Integral, OPNumeric, Real, RealNN
from .base import SequenceVectorizer, VectorizerModel, numeric_block


class NumericVectorizerModel(VectorizerModel):
    """Fitted numeric vectorizer: impute with per-feature fill, track nulls."""

    # any numeric flavor: the Real/Integral/RealNN estimators all fit this
    input_types = (OPNumeric,)

    def __init__(self, fills: Sequence[float], track_nulls: bool = True,
                 operation_name: str = "vecReal", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.fills = np.asarray(fills, dtype=np.float64)
        self.track_nulls = bool(track_nulls)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        X = numeric_block(cols)
        isnan = np.isnan(X)
        filled = np.where(isnan, self.fills[None, :], X)
        if not self.track_nulls:
            return filled
        k = X.shape[1]
        out = np.empty((X.shape[0], 2 * k), dtype=np.float64)
        out[:, 0::2] = filled
        out[:, 1::2] = isnan.astype(np.float64)
        return out

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(fills=self.fills.tolist(), track_nulls=self.track_nulls)
        return d


class NumericVectorizer(SequenceVectorizer):
    """Impute (mean / constant) + null-track N numeric features.

    Reference RealVectorizer.scala (fillWithMean default true,
    TransmogrifierDefaults.TrackNulls=true).
    """

    input_types = (Real,)
    # fitted-model class; subclasses narrow it so save/load records the
    # faithful class name (BinaryVectorizer -> BinaryVectorizerModel)
    model_cls: Type["NumericVectorizerModel"]

    @classmethod
    def _declare_params(cls):
        return [
            Param("fill_mode", "mean|constant|mode", "mean",
                  lambda v: v in ("mean", "constant", "mode")),
            Param("fill_value", "constant fill value", 0.0),
            Param("track_nulls", "append null-indicator columns", True),
        ]

    def __init__(self, operation_name: str = "vecReal",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> NumericVectorizerModel:
        X = numeric_block(cols)
        mode = self.get_param("fill_mode")
        if mode == "mean":
            with np.errstate(invalid="ignore"):
                fills = np.nan_to_num(np.nanmean(X, axis=0), nan=0.0)
        elif mode == "mode":
            fills = []
            for j in range(X.shape[1]):
                col = X[:, j]
                col = col[np.isfinite(col)]
                if col.size == 0:
                    fills.append(0.0)
                else:
                    vals, counts = np.unique(col, return_counts=True)
                    fills.append(float(vals[np.argmax(counts)]))
            fills = np.asarray(fills)
        else:
            fills = np.full((X.shape[1],), float(self.get_param("fill_value")))
        track = self.get_param("track_nulls")
        model = self.model_cls(
            fills=fills, track_nulls=track, operation_name=self.operation_name)
        model.set_metadata(self._make_metadata(track))
        return model

    def _make_metadata(self, track_nulls: bool) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            cols.append(VectorColumnMetadata(
                parent_feature_name=f.name, parent_feature_type=f.type_name))
            if track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    indicator_value=NULL_STRING))
        return VectorMetadata(name=self.output_name(), columns=cols)


NumericVectorizer.model_cls = NumericVectorizerModel


class BinaryVectorizerModel(NumericVectorizerModel):
    pass


class BinaryVectorizer(NumericVectorizer):
    """Booleans -> {0,1} with fill=false + null tracking
    (reference BinaryVectorizer.scala, BinaryFillValue=false)."""

    input_types = (Binary,)
    model_cls = BinaryVectorizerModel

    def __init__(self, operation_name: str = "vecBin",
                 uid: Optional[str] = None, **params):
        params.setdefault("fill_mode", "constant")
        params.setdefault("fill_value", 0.0)
        super().__init__(operation_name, uid=uid, **params)


class IntegralVectorizer(NumericVectorizer):
    """Integers, default fill with mode (reference IntegralVectorizer,
    FillWithMode=true)."""

    input_types = (Integral,)

    def __init__(self, operation_name: str = "vecInt",
                 uid: Optional[str] = None, **params):
        params.setdefault("fill_mode", "mode")
        super().__init__(operation_name, uid=uid, **params)


class RealNNVectorizer(SequenceVectorizer):
    """Non-nullable reals pass straight through (no imputation needed)."""

    input_types = (RealNN,)

    def __init__(self, operation_name: str = "vecRealNN",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> NumericVectorizerModel:
        model = NumericVectorizerModel(
            fills=np.zeros(len(cols)), track_nulls=False,
            operation_name=self.operation_name)
        md_cols = [VectorColumnMetadata(parent_feature_name=f.name,
                                        parent_feature_type=f.type_name)
                   for f in self.input_features]
        model.set_metadata(VectorMetadata(name=self.output_name(), columns=md_cols))
        return model
