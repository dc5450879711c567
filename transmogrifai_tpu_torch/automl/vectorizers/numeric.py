"""Numeric vectorizers: imputation + null tracking (counterpart of
automl/vectorizers/numeric.py; host numpy, as there).

Reference: core/.../impl/feature/{RealVectorizer, IntegralVectorizer,
BinaryVectorizer, NumericBucketizer}.scala. The label-driven
DecisionTreeNumericBucketizer lives in transformers/misc.py.

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


class NumericBucketizerModel(VectorizerModel):
    """Fixed-split bucketing -> one-hot bucket indicators (+ null column).

    Reference NumericBucketizer.scala:303: splits are [-inf, s1), [s1, s2)...
    """

    input_types = (OPNumeric,)  # mirrors NumericBucketizer's numeric family

    def __init__(self, splits: Sequence[Sequence[float]],
                 track_nulls: bool = True, track_invalid: bool = False,
                 operation_name: str = "bucketize",
                 uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.splits = [np.asarray(s, dtype=np.float64) for s in splits]
        self.track_nulls = track_nulls
        self.track_invalid = track_invalid

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        X = numeric_block(cols)
        blocks = []
        for j, s in enumerate(self.splits):
            x = X[:, j]
            nbuckets = len(s) - 1
            idx = np.clip(np.searchsorted(s, x, side="right") - 1, 0,
                          nbuckets - 1)
            onehot = np.zeros((x.shape[0], nbuckets), dtype=np.float64)
            valid = np.isfinite(x)
            onehot[np.arange(x.shape[0])[valid], idx[valid]] = 1.0
            blocks.append(onehot)
            if self.track_nulls:
                blocks.append((~valid).astype(np.float64)[:, None])
        return np.concatenate(blocks, axis=1)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(splits=[s.tolist() for s in self.splits],
                 track_nulls=self.track_nulls,
                 track_invalid=self.track_invalid)
        return d


class NumericBucketizer(SequenceVectorizer):
    """Quantile or fixed-split bucketizer (reference NumericBucketizer)."""

    input_types = (Real,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("splits", "explicit split points per feature "
                  "(list of lists)", None),
            Param("num_buckets", "quantile bucket count when splits not "
                  "given", 4),
            Param("track_nulls", "append null-indicator columns", True),
        ]

    def __init__(self, operation_name: str = "bucketize",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> NumericBucketizerModel:
        X = numeric_block(cols)
        given = self.get_param("splits")
        nb = int(self.get_param("num_buckets"))
        track = self.get_param("track_nulls")
        splits: List[np.ndarray] = []
        for j in range(X.shape[1]):
            if given is not None:
                s = np.asarray(given[j], dtype=np.float64)
            else:
                col = X[:, j][np.isfinite(X[:, j])]
                if col.size == 0:
                    s = np.array([-np.inf, np.inf])
                else:
                    qs = np.quantile(col, np.linspace(0, 1, nb + 1)[1:-1])
                    s = np.concatenate([[-np.inf], np.unique(qs), [np.inf]])
            splits.append(s)
        model = NumericBucketizerModel(
            splits=splits, track_nulls=track,
            operation_name=self.operation_name)
        md_cols: List[VectorColumnMetadata] = []
        for f, s in zip(self.input_features, splits):
            for b in range(len(s) - 1):
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.type_name,
                    grouping=f.name, indicator_value=f"bucket_{b}"))
            if track:
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.type_name,
                    grouping=f.name, indicator_value=NULL_STRING))
        model.set_metadata(VectorMetadata(name=self.output_name(),
                                          columns=md_cols))
        return model
