"""Misc feature transformers, the numeric and vector part (counterpart of
transformers/misc.py): alias, occurrence, scaling, calibration,
missing-value fill, vector index drops, label-driven bucketization, value
replacement, and the map and date stages.

Reference: core/.../impl/feature/{AliasTransformer, ToOccurTransformer,
ScalerTransformer(186), FillMissingWithMean, PercentileCalibrator,
DropIndicesByTransformer, DecisionTreeNumericBucketizer(300),
DecisionTreeNumericMapBucketizer, DateToUnitCircleTransformer}.scala.
Fits are float64 numpy, as in the JAX package; the fitted numeric stages
are TorchTransformers, run by the layer runner in f32 on their device.
The map, date, phone and MIME stages are host code, as there.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import Column
from ..data.vector import NULL_STRING, VectorColumnMetadata, VectorMetadata
from ..device import DeviceLike, resolve_device
from ..stages.base import Estimator, TorchTransformer, Transformer
from ..stages.params import Param
from ..types import (Binary, BinaryMap, ColumnKind, DateList, DateTime,
                     DateTimeList, FeatureType, Integral, OPMap, OPVector,
                     PickListMap, Real, RealMap, RealNN, TextMap)


class AliasTransformer(TorchTransformer):
    """Identity renaming a feature (reference AliasTransformer)."""

    input_types = (FeatureType,)
    output_type = Real  # replaced at set_input time

    def __init__(self, name: str = "alias", uid: Optional[str] = None,
                 **params):
        self.alias = name
        params.pop("operation_name", None)
        super().__init__(f"alias_{name}", uid=uid, **params)

    def set_input(self, *features):
        out = super().set_input(*features)
        self.output_type = features[0].feature_type
        return out

    def get_torch_fn(self):
        return lambda a: a

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(name=self.alias)
        return d


class ToOccurTransformer(Transformer):
    """Any feature -> Binary(non-empty) (reference ToOccurTransformer)."""

    input_types = (FeatureType,)
    output_type = Binary

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "toOccur"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        return Binary(not vals[0].is_empty)

    def transform_columns(self, *cols: Column) -> Column:
        c = cols[0]
        if c.kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
            data = (~np.isnan(np.asarray(c.data, np.float64))) \
                .astype(np.float64)
        else:
            data = np.array([0.0 if self._is_empty(v) else 1.0
                             for v in c.data], np.float64)
        return Column(kind=ColumnKind.BOOL, data=data)

    @staticmethod
    def _is_empty(v) -> bool:
        if v is None:
            return True
        if isinstance(v, float) and np.isnan(v):
            return True
        return isinstance(v, (str, list, tuple, set, dict)) and len(v) == 0


class ScalerTransformer(TorchTransformer):
    """Linear or log scaling with its scaling args recorded, so that a
    downstream DescalerTransformer can invert predictions (reference
    ScalerTransformer.scala:186)."""

    input_types = (Real,)
    output_type = Real

    @classmethod
    def _declare_params(cls):
        return [Param("scaling_type", "linear|logarithmic", "linear"),
                Param("slope", "linear slope", 1.0),
                Param("intercept", "linear intercept", 0.0)]

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, uid: Optional[str] = None,
                 **params):
        params.setdefault("scaling_type", scaling_type)
        params.setdefault("slope", slope)
        params.setdefault("intercept", intercept)
        super().__init__(params.pop("operation_name", "scaled"),
                         uid=uid, **params)

    def scaling_args(self) -> Dict[str, Any]:
        return {"scaling_type": self.get_param("scaling_type"),
                "slope": self.get_param("slope"),
                "intercept": self.get_param("intercept")}

    def get_torch_fn(self):
        if self.get_param("scaling_type") == "logarithmic":
            return lambda a: torch.where(
                a > 0, torch.log(a.clamp(min=1e-12)),
                torch.full_like(a, float("nan")))
        # the JAX package's compiler fuses m * a + b into a multiply-add
        # (the product unrounded); float64 holds the f32 product exactly
        m = float(np.float32(self.get_param("slope")))
        b = float(np.float32(self.get_param("intercept")))
        return lambda a: (a.double() * m + b).to(torch.float32)


class DescalerTransformer(Transformer):
    """Inverts a ScalerTransformer's scaling on another feature (reference
    DescalerTransformer reads ScalingArgs from metadata; here the dsl
    hands the scaler stage over)."""

    input_types = (Real, Real)   # (value_to_descale, scaled_source)
    output_type = Real

    def __init__(self, scaler: Optional[ScalerTransformer] = None,
                 uid: Optional[str] = None, **params):
        self.scaler = scaler
        super().__init__(params.pop("operation_name", "descaled"),
                         uid=uid, **params)

    def _invert(self, arr: np.ndarray) -> np.ndarray:
        args = self.scaler.scaling_args() if self.scaler else \
            {"scaling_type": "linear", "slope": 1.0, "intercept": 0.0}
        if args["scaling_type"] == "logarithmic":
            return np.exp(arr)
        m = float(args["slope"]) or 1.0
        return (arr - float(args["intercept"])) / m

    def transform_value(self, *vals):
        v = vals[0].value
        if v is None:
            return Real(None)
        return Real(float(self._invert(np.asarray([v]))[0]))

    def transform_columns(self, *cols: Column) -> Column:
        return Column(kind=ColumnKind.FLOAT,
                      data=self._invert(np.asarray(cols[0].data,
                                                   np.float64)))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(scaling_args=self.scaler.scaling_args() if self.scaler
                 else None)
        return d

    @classmethod
    def from_save_args(cls, args: Dict[str, Any]) -> "DescalerTransformer":
        t = cls(uid=args.get("uid"))
        sa = args.get("scaling_args")
        if sa:
            t.scaler = ScalerTransformer(**sa)
        return t


class FillMissingWithMean(Estimator):
    """Real -> RealNN, empties replaced by the train mean (reference
    FillMissingWithMean.scala)."""

    input_types = (Real,)
    output_type = RealNN

    @classmethod
    def _declare_params(cls):
        return [Param("default_value", "fill when column all-empty", 0.0)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "fillWithMean"),
                         uid=uid, **params)

    def fit_columns(self, *cols: Column) -> Transformer:
        data = np.asarray(cols[0].data, np.float64)
        valid = data[~np.isnan(data)]
        mean = float(valid.mean()) if len(valid) else \
            float(self.get_param("default_value"))
        return FillMissingWithMeanModel(mean,
                                        operation_name=self.operation_name)


class FillMissingWithMeanModel(TorchTransformer):
    input_types = (Real,)
    output_type = RealNN

    def __init__(self, mean: float = 0.0, uid: Optional[str] = None,
                 **params):
        self.mean = float(mean)
        super().__init__(params.pop("operation_name", "fillWithMean"),
                         uid=uid, **params)

    def get_torch_fn(self):
        m = self.mean
        return lambda a: torch.where(torch.isnan(a), torch.full_like(a, m),
                                     a)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(mean=self.mean)
        return d


class PercentileCalibrator(Estimator):
    """RealNN score -> RealNN percentile bucket [0, buckets - 1] (reference
    PercentileCalibrator.scala)."""

    input_types = (RealNN,)
    output_type = RealNN

    @classmethod
    def _declare_params(cls):
        return [Param("buckets", "number of percentile buckets", 100)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name",
                                    "percentileCalibrator"),
                         uid=uid, **params)

    def fit_columns(self, *cols: Column) -> Transformer:
        b = int(self.get_param("buckets"))
        data = np.asarray(cols[0].data, np.float64)
        qs = np.quantile(data[~np.isnan(data)],
                         np.arange(1, b) / b) if len(data) \
            else np.zeros(b - 1)
        return PercentileCalibratorModel(np.asarray(qs, np.float64),
                                         operation_name=self.operation_name)


class PercentileCalibratorModel(TorchTransformer):
    input_types = (RealNN,)
    output_type = RealNN

    def __init__(self, splits: Optional[np.ndarray] = None,
                 uid: Optional[str] = None, **params):
        self.splits = np.asarray(splits if splits is not None else [],
                                 np.float64)
        super().__init__(params.pop("operation_name",
                                    "percentileCalibrator"),
                         uid=uid, **params)

    def get_torch_fn(self):
        splits = self.splits.astype(np.float32)

        def fn(a):
            s = torch.as_tensor(splits, device=a.device)
            return torch.searchsorted(s, a.contiguous(),
                                      right=True).to(torch.float32)
        return fn

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(splits=self.splits)
        return d


class DropIndicesByTransformer(Transformer):
    """OPVector -> OPVector without the columns whose metadata matches a
    predicate (reference DropIndicesByTransformer, e.g. null indicators
    before LOCO)."""

    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, predicate: Optional[Callable[[VectorColumnMetadata],
                                                    bool]] = None,
                 uid: Optional[str] = None, **params):
        self.predicate = predicate or (lambda c: False)
        self._keep: Optional[List[int]] = None
        super().__init__(params.pop("operation_name", "dropIndices"),
                         uid=uid, **params)

    def transform_columns(self, *cols: Column) -> Column:
        vec = cols[0]
        md = vec.metadata
        if md is None:
            return vec
        keep = [c.index for c in md.columns if not self.predicate(c)]
        self._keep = keep
        return Column(kind=ColumnKind.VECTOR,
                      data=np.ascontiguousarray(vec.data[:, keep]),
                      metadata=md.select(keep))

    def transform_value(self, *vals):
        X = np.asarray(vals[0].value, np.float32)
        if self._keep is None:
            return OPVector(X)
        return OPVector(X[self._keep])


def find_label_splits(x: np.ndarray, label: np.ndarray, max_splits: int,
                      min_info_gain: float,
                      device: DeviceLike = None) -> List[float]:
    """Label-aware bucket boundaries for one numeric column: grow a single
    decision tree on (x -> label) with ops/trees.grow_tree on `device` and
    read the split thresholds off the grown nodes (reference
    DecisionTreeNumericBucketizer.scala:300). The tree draws nothing at
    random: every node sees every feature."""
    from ..ops import trees as T

    ok = ~(np.isnan(x) | np.isnan(label))
    depth = max(1, math.ceil(math.log2(max_splits + 1)))
    splits: List[float] = []
    if ok.sum() >= 4 and np.nanstd(x[ok]) > 0:
        dev = resolve_device(device)
        xv = torch.as_tensor(x[ok].astype(np.float32)[:, None], device=dev)
        yv = label[ok].astype(np.float32)
        n_classes = int(yv.max()) + 1 if yv.size else 2
        G = (np.eye(max(n_classes, 2), dtype=np.float32)[yv.astype(int)]
             if n_classes <= 20 else yv[:, None])
        edges = T.quantile_edges(xv, 64)
        tree = T.grow_tree(
            T.bin_matrix(xv, edges), torch.as_tensor(G, device=dev),
            torch.ones(len(yv), dtype=torch.float32, device=dev),
            depth=depth, n_bins=64, leaf_mode="mean",
            min_info_gain=min_info_gain,
            min_instances=max(1.0, 0.01 * len(yv)))
        tv = T.thresholds_to_values(tree.feat, tree.thresh, edges).cpu()
        splits = sorted({float(t) for t in tv.numpy() if np.isfinite(t)})
        splits = splits[:max_splits]
    return splits


class DecisionTreeNumericBucketizer(Estimator):
    """(label RealNN, Real) -> OPVector one-hot of label-driven buckets.

    Reference DecisionTreeNumericBucketizer.scala:300 fits a single Spark
    decision tree on (feature -> label) and uses its split points as bucket
    boundaries; here the tree is ops/trees.grow_tree on the one feature.
    """

    input_types = (RealNN, Real)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("max_splits", "max bucket boundaries", 15),
                Param("min_info_gain", "min split gain", 0.01),
                Param("track_nulls", "emit null indicator column", True),
                Param("track_invalid", "keep bucketizing when no signal",
                      False)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "dtBucketizer"),
                         uid=uid, **params)

    def fit_columns(self, *cols: Column) -> Transformer:
        label = np.asarray(cols[0].data, np.float64)
        x = np.asarray(cols[1].data, np.float64)
        splits = find_label_splits(
            x, label, int(self.get_param("max_splits")),
            float(self.get_param("min_info_gain")), device=self.device)
        return DecisionTreeNumericBucketizerModel(
            splits=np.asarray(splits, np.float64),
            track_nulls=bool(self.get_param("track_nulls")),
            feature_name=(self._input_features[1].name
                          if len(self._input_features) > 1 else "feature"),
            operation_name=self.operation_name)


class DecisionTreeNumericBucketizerModel(Transformer):
    input_types = (RealNN, Real)
    output_type = OPVector

    def __init__(self, splits: Optional[np.ndarray] = None,
                 track_nulls: bool = True, feature_name: str = "feature",
                 uid: Optional[str] = None, **params):
        self.splits = np.asarray(splits if splits is not None else [],
                                 np.float64)
        self.track_nulls = bool(track_nulls)
        self.feature_name = feature_name
        super().__init__(params.pop("operation_name", "dtBucketizer"),
                         uid=uid, **params)

    @property
    def n_buckets(self) -> int:
        return len(self.splits) + 1

    def _encode(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        width = self.n_buckets + (1 if self.track_nulls else 0)
        out = np.zeros((n, width), np.float32)
        isnan = np.isnan(x)
        bucket = np.searchsorted(self.splits, x, side="right")
        bucket = np.where(isnan, 0, bucket)
        out[np.arange(n), bucket] = (~isnan).astype(np.float32)
        if self.track_nulls:
            out[:, -1] = isnan.astype(np.float32)
        return out

    def transform_columns(self, *cols: Column) -> Column:
        x = np.asarray(cols[-1].data, np.float64)
        return Column(kind=ColumnKind.VECTOR, data=self._encode(x),
                      metadata=self.output_metadata())

    def transform_value(self, *vals):
        v = vals[-1].value
        x = np.asarray([np.nan if v is None else float(v)])
        return OPVector(self._encode(x)[0])

    def output_metadata(self) -> Optional[VectorMetadata]:
        cols = [VectorColumnMetadata(
            parent_feature_name=self.feature_name,
            parent_feature_type="Real", grouping=self.feature_name,
            indicator_value=f"bucket_{i}", index=i)
            for i in range(self.n_buckets)]
        if self.track_nulls:
            cols.append(VectorColumnMetadata(
                parent_feature_name=self.feature_name,
                parent_feature_type="Real", grouping=self.feature_name,
                indicator_value=NULL_STRING, index=self.n_buckets))
        return VectorMetadata(name=self.output_name() or "bucketized",
                              columns=cols)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(splits=self.splits, track_nulls=self.track_nulls,
                 feature_name=self.feature_name)
        return d


class DecisionTreeNumericMapBucketizer(Estimator):
    """(label RealNN, numeric OPMap) -> OPVector of label-driven buckets
    PER MAP KEY.

    Reference DecisionTreeNumericMapBucketizer.scala (170 LoC): the scalar
    DecisionTreeNumericBucketizer applied independently to every key of a
    Real/Integral/Currency/Percent map. Keys are discovered at fit; each
    key's split search is the same single tree on the stage's device
    (find_label_splits); keys with no informative splits emit only their
    null column (shouldSplit=false in the reference).
    """

    # declared RealMap for data-generation/tooling; check_input_types
    # accepts every numeric OPMap subtype
    input_types = (RealNN, RealMap)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("max_splits", "max bucket boundaries per key", 15),
                Param("min_info_gain", "min split gain", 0.01),
                Param("track_nulls", "emit per-key null indicator", True),
                Param("clean_keys", "normalize map keys", False)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "dtMapBucketizer"),
                         uid=uid, **params)

    def check_input_types(self, features) -> None:
        if len(features) != 2:
            raise TypeError(f"{self.stage_name} expects (label, map) inputs")
        if not issubclass(features[0].feature_type, RealNN):
            raise TypeError(f"{self.stage_name} label must be RealNN")
        if not issubclass(features[1].feature_type, OPMap):
            raise TypeError(f"{self.stage_name} input 1 must be an OPMap")

    def fit_columns(self, *cols: Column) -> Transformer:
        from ..automl.vectorizers.encoding import extract_key_columns
        from ..automl.vectorizers.maps import clean_key

        label = np.asarray(cols[0].data, np.float64)
        data = cols[1].data
        clean = bool(self.get_param("clean_keys"))
        keys = sorted({clean_key(str(k), clean)
                       for m in data if m for k in m})
        key_cols = extract_key_columns(
            data, keys, (lambda k: clean_key(k, True)) if clean else None)
        max_splits = int(self.get_param("max_splits"))
        min_gain = float(self.get_param("min_info_gain"))
        splits_per_key = []
        for k in keys:
            x = np.array([np.nan if v is None else float(v)
                          for v in key_cols[k]], np.float64)
            splits_per_key.append(find_label_splits(
                x, label, max_splits, min_gain, device=self.device))
        return DecisionTreeNumericMapBucketizerModel(
            keys=keys, splits_per_key=splits_per_key,
            track_nulls=bool(self.get_param("track_nulls")),
            clean_keys=clean,
            map_name=(self._input_features[1].name
                      if len(self._input_features) > 1 else "map"),
            operation_name=self.operation_name)


class DecisionTreeNumericMapBucketizerModel(Transformer):
    input_types = (RealNN, RealMap)
    output_type = OPVector
    is_sequence = False

    def __init__(self, keys: Optional[Sequence[str]] = None,
                 splits_per_key: Optional[Sequence[Sequence[float]]] = None,
                 track_nulls: bool = True, clean_keys: bool = False,
                 map_name: str = "map", uid: Optional[str] = None, **params):
        self.keys = list(keys or [])
        self.splits_per_key = [np.asarray(s, np.float64)
                               for s in (splits_per_key or [])]
        self.track_nulls = bool(track_nulls)
        self.clean_keys = bool(clean_keys)
        self.map_name = map_name
        super().__init__(params.pop("operation_name", "dtMapBucketizer"),
                         uid=uid, **params)

    def _key_width(self, splits: np.ndarray) -> int:
        # a key with no informative splits keeps only its null column
        buckets = len(splits) + 1 if len(splits) else 0
        return buckets + (1 if self.track_nulls else 0)

    def _encode(self, key_cols: Dict[str, List[Any]], n: int) -> np.ndarray:
        # width may legitimately be 0 (no informative splits, nulls
        # untracked) — a 0-wide block keeps width == len(metadata.columns),
        # the invariant downstream vector indexing relies on
        width = sum(self._key_width(s) for s in self.splits_per_key)
        out = np.zeros((n, width), np.float32)
        at = 0
        for k, splits in zip(self.keys, self.splits_per_key):
            x = np.array([np.nan if v is None else float(v)
                          for v in key_cols[k]], np.float64)
            isnan = np.isnan(x)
            if len(splits):
                nb = len(splits) + 1
                bucket = np.searchsorted(splits, x, side="right")
                bucket = np.where(isnan, 0, bucket)
                rows = np.arange(n)
                out[rows, at + bucket] = (~isnan).astype(np.float32)
                at += nb
            if self.track_nulls:
                out[:, at] = isnan.astype(np.float32)
                at += 1
        return out

    def transform_columns(self, *cols: Column) -> Column:
        from ..automl.vectorizers.encoding import extract_key_columns
        from ..automl.vectorizers.maps import clean_key
        data = cols[-1].data
        key_cols = extract_key_columns(
            data, self.keys,
            (lambda k: clean_key(k, True)) if self.clean_keys else None)
        return Column(kind=ColumnKind.VECTOR,
                      data=self._encode(key_cols, len(data)),
                      metadata=self.output_metadata())

    def transform_value(self, *vals):
        m = vals[-1].value or {}
        from ..automl.vectorizers.maps import clean_key
        if self.clean_keys:
            # first-wins on cleaned-key collisions — must mirror
            # extract_key_columns so row scoring matches the columnar path
            cleaned: Dict[str, Any] = {}
            for k, v in m.items():
                cleaned.setdefault(clean_key(str(k), True), v)
            m = cleaned
        key_cols = {k: [m.get(k)] for k in self.keys}
        return OPVector(self._encode(key_cols, 1)[0])

    def output_metadata(self) -> Optional[VectorMetadata]:
        cols: List[VectorColumnMetadata] = []
        i = 0
        for k, splits in zip(self.keys, self.splits_per_key):
            if len(splits):
                for b in range(len(splits) + 1):
                    cols.append(VectorColumnMetadata(
                        parent_feature_name=self.map_name,
                        parent_feature_type="OPMap", grouping=k,
                        indicator_value=f"bucket_{b}", index=i))
                    i += 1
            if self.track_nulls:
                cols.append(VectorColumnMetadata(
                    parent_feature_name=self.map_name,
                    parent_feature_type="OPMap", grouping=k,
                    indicator_value=NULL_STRING, index=i))
                i += 1
        return VectorMetadata(name=self.output_name() or "bucketizedMap",
                              columns=cols)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(keys=self.keys,
                 splits_per_key=[list(map(float, s))
                                 for s in self.splits_per_key],
                 track_nulls=self.track_nulls, clean_keys=self.clean_keys,
                 map_name=self.map_name)
        return d


class FilterMapKeys(Transformer):
    """OPMap -> OPMap keeping/blocking keys (reference
    RichMapFeature.filter:58 — whiteList/blackList key filtering)."""

    input_types = (OPMap,)

    def __init__(self, allow: Optional[Sequence[str]] = None,
                 block: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None, **params):
        self.allow = list(allow) if allow else None
        self._allow_set = set(self.allow) if self.allow is not None else None
        self.block = set(block) if block else set()
        super().__init__(params.pop("operation_name", "filterMapKeys"),
                         uid=uid, **params)

    def set_input(self, *features):
        out = super().set_input(*features)
        self.output_type = features[0].feature_type
        return out

    def _filter(self, m):
        if m is None:
            return None
        allowed = self._allow_set
        return {k: v for k, v in m.items()
                if (allowed is None or k in allowed) and k not in self.block}

    def transform_value(self, *vals):
        return self.output_type(self._filter(vals[0].value))

    def transform_columns(self, *cols: Column) -> Column:
        data = cols[0].data
        out = np.empty(len(data), dtype=object)
        for i, m in enumerate(data):
            out[i] = self._filter(m)
        return Column(kind=ColumnKind.MAP, data=out)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(allow=self.allow, block=sorted(self.block))
        return d


class DateToUnitCircleTransformer(Transformer):
    """Date -> OPVector [sin, cos] of one calendar period (reference
    DateToUnitCircleTransformer.scala; periods as in RichDateFeature
    .toUnitCircle — default HourOfDay). Missing dates map to the origin
    (0, 0), which is equidistant from every point on the circle."""

    input_types = (Integral,)  # Date/DateTime extend Integral
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("time_period", "HourOfDay|DayOfWeek|DayOfMonth|"
                      "DayOfYear|WeekOfYear|MonthOfYear", "HourOfDay")]

    def __init__(self, time_period: str = "HourOfDay",
                 uid: Optional[str] = None, **params):
        params.setdefault("time_period", time_period)
        super().__init__(params.pop("operation_name", "toUnitCircle"),
                         uid=uid, **params)

    def _encode(self, ms: np.ndarray) -> np.ndarray:
        from ..automl.vectorizers.dates import unit_circle
        s, c, _ = unit_circle(ms, str(self.get_param("time_period")))
        out = np.empty((len(ms), 2), np.float32)
        out[:, 0] = s
        out[:, 1] = c
        return out

    def transform_columns(self, *cols: Column) -> Column:
        ms = np.asarray(cols[0].data, np.float64)
        return Column(kind=ColumnKind.VECTOR, data=self._encode(ms),
                      metadata=self.output_metadata())

    def transform_value(self, *vals):
        v = vals[0].value
        ms = np.asarray([np.nan if v is None else float(v)])
        return OPVector(self._encode(ms)[0])

    def output_metadata(self) -> Optional[VectorMetadata]:
        name = (self._input_features[0].name if self._input_features
                else "date")
        p = str(self.get_param("time_period"))
        return VectorMetadata(name=self.output_name() or "unitCircle",
                              columns=[
            VectorColumnMetadata(parent_feature_name=name,
                                 parent_feature_type="Date",
                                 descriptor_value=f"{p}_sin", index=0),
            VectorColumnMetadata(parent_feature_name=name,
                                 parent_feature_type="Date",
                                 descriptor_value=f"{p}_cos", index=1)])


class DateToListTransformer(Transformer):
    """Date -> DateList (reference RichDateFeature.toDateList:54 — wraps
    the single timestamp so list aggregators/vectorizers apply)."""

    input_types = (Integral,)

    def __init__(self, uid: Optional[str] = None, **params):
        self.output_type = DateList
        super().__init__(params.pop("operation_name", "toDateList"),
                         uid=uid, **params)

    def set_input(self, *features):
        out = super().set_input(*features)
        if issubclass(features[0].feature_type, DateTime):
            self.output_type = DateTimeList
        return out

    def transform_value(self, *vals):
        v = vals[0].value
        return self.output_type([] if v is None else [float(v)])

    def transform_columns(self, *cols: Column) -> Column:
        data = np.asarray(cols[0].data, np.float64)
        out = np.empty(len(data), dtype=object)
        for i, v in enumerate(data):
            out[i] = [] if np.isnan(v) else [float(v)]
        return Column(kind=ColumnKind.FLOAT_LIST, data=out)


class ReplaceWithTransformer(Transformer):
    """Replace one value with another, any type (reference
    RichFeature.replaceWith:75). Values compare on the raw `.value`."""

    input_types = (FeatureType,)

    def __init__(self, old_value: Any = None, new_value: Any = None,
                 uid: Optional[str] = None, **params):
        self.old_value = old_value
        self.new_value = new_value
        super().__init__(params.pop("operation_name", "replaceWith"),
                         uid=uid, **params)

    def set_input(self, *features):
        out = super().set_input(*features)
        self.output_type = features[0].feature_type
        return out

    @staticmethod
    def _values_eq(a, b) -> bool:
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            return np.array_equal(np.asarray(a), np.asarray(b))
        return a == b

    def transform_value(self, *vals):
        v = vals[0].value
        return self.output_type(
            self.new_value if self._values_eq(v, self.old_value) else v)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(old_value=self.old_value, new_value=self.new_value)
        return d


class PhoneValidityMap(Transformer):
    """PhoneMap/TextMap -> BinaryMap of per-key phone validity (reference
    RichMapFeature.isValidPhoneDefaultCountryMap via libphonenumber;
    validation shares transformers/text.parse_phone)."""

    input_types = (TextMap,)  # PhoneMap is a TextMap subtype

    @classmethod
    def _declare_params(cls):
        return [Param("default_region", "region for bare numbers", "US")]

    output_type = BinaryMap

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "phoneValidMap"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        from ..transformers.text import parse_phone
        m = vals[0].value or {}
        region = str(self.get_param("default_region"))
        return BinaryMap({k: parse_phone(str(v), region)[0]
                          for k, v in m.items() if v is not None})


class MimeTypeMap(Transformer):
    """Base64Map -> PickListMap of per-key detected MIME types (reference
    RichMapFeature.detectMimeTypes via Tika; detection shares the scalar
    detector's magic-byte matcher, transformers/text.detect_mime)."""

    input_types = (TextMap,)  # Base64Map is a TextMap subtype
    output_type = PickListMap

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "mimeMap"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        from ..transformers.text import detect_mime
        m = vals[0].value or {}
        out = {}
        for k, v in m.items():
            mime = detect_mime(v)
            if mime is not None:
                out[k] = mime
        return PickListMap(out)
