"""Map vectorizers: per-key expansion of keyed features (counterpart of
automl/vectorizers/maps.py; host numpy, as there).

Reference: core/.../impl/feature/{OPMapVectorizer.scala:468,
TextMapPivotVectorizer, MultiPickListMapVectorizer, SmartTextMapVectorizer,
GeolocationMapVectorizer}. Fit discovers the key set per map feature (the
dynamic part), then each (feature, key) pair becomes a statically-shaped
column group: numeric keys impute+null-track, categorical keys pivot,
free-text keys smart-dispatch to pivot/hash, geolocation keys emit
(lat, lon, acc, null).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...data.dataset import Column
from ...data.vector import (NULL_STRING, OTHER_STRING, VectorColumnMetadata,
                            VectorMetadata)
from ...stages.params import Param
from ...types import (BinaryMap, GeolocationMap, MultiPickListMap,
                     NumericMap, OPMap, TextMap)
from .base import SequenceVectorizer, VectorizerModel
from .categorical import clean_text_value
from .encoding import (
    category_counts, empty_mask, extract_key_columns, float_column,
    null_mask, pivot_block_multi, pivot_block_single, triple_block,
)
from .geo import geo_mean
from .text import tokenize_hash_counts

_CATEGORICAL_MAP_TYPES = (
    "PickListMap", "ComboBoxMap", "CountryMap", "StateMap", "CityMap",
    "PostalCodeMap", "IDMap",
)


def clean_key(k: str, clean: bool) -> str:
    return clean_text_value(k, clean) if clean else k


class MapVectorizerModel(VectorizerModel):
    """Fitted map vectorizer: per (feature, key) column plans."""

    input_types = (OPMap,)  # mirrors MapVectorizer

    def __init__(self, feature_plans: Sequence[Dict[str, Any]],
                 clean_keys: bool = False,
                 operation_name: str = "vecMap", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        # feature_plans[i]: {kind: 'real'|'binary'|'categorical'|'hash'|
        #                    'multipicklist'|'geo',
        #                    keys: [...], fills: {key: float} | vocab: {key: [...]},
        #                    bins: int, track_nulls: bool, clean_text: bool}
        self.feature_plans = [dict(p) for p in feature_plans]
        self.clean_keys = clean_keys

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        blocks: List[np.ndarray] = []
        for plan, c in zip(self.feature_plans, cols):
            kind = plan["kind"]
            keys = plan["keys"]
            track = plan["track_nulls"]
            clean = plan["clean_text"]
            key_clean = (lambda s: clean_key(s, True)) if self.clean_keys \
                else None
            keycols = extract_key_columns(c.data, keys, key_clean)

            def clean_fn(s, _c=clean):
                return clean_text_value(s, _c)

            def nulls_of(vals):
                return null_mask(vals).astype(np.float64)[:, None]

            for key in keys:
                vals = keycols[key]
                if kind in ("real", "binary"):
                    col = float_column(vals, plan["fills"].get(key, 0.0))
                    parts = [col[:, None]]
                    if track:
                        parts.append(nulls_of(vals))
                    blocks.append(np.concatenate(parts, axis=1))
                elif kind == "categorical":
                    vocab = plan["vocab"].get(key, [])
                    if vocab is None:  # high-cardinality key -> hash space
                        counts = tokenize_hash_counts(vals, plan["bins"])
                        parts = [counts]
                        if track:
                            parts.append(nulls_of(vals))
                        blocks.append(np.concatenate(parts, axis=1))
                    else:
                        blocks.append(pivot_block_single(
                            vals, vocab, track, clean_fn))
                elif kind == "multipicklist":
                    blocks.append(pivot_block_multi(
                        vals, plan["vocab"].get(key, []), track, clean_fn))
                elif kind == "geo":
                    triples = triple_block(
                        vals, plan["fills"].get(key, [0.0, 0.0, 0.0]))
                    if track:
                        empt = empty_mask(vals).astype(np.float64)[:, None]
                        triples = np.concatenate([triples, empt], axis=1)
                    blocks.append(triples)
                else:
                    raise ValueError(f"Unknown map plan kind {kind}")
        return np.concatenate(blocks, axis=1) if blocks else np.zeros((len(cols[0]), 0))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(feature_plans=self.feature_plans, clean_keys=self.clean_keys)
        return d


class MapVectorizer(SequenceVectorizer):
    """Key-discovering map vectorizer for every OPMap subtype."""

    input_types = (OPMap,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("top_k", "pivot vocabulary cap per key", 20),
            Param("min_support", "min occurrences for pivot category", 10),
            Param("max_cardinality", "pivot if distinct <= this (text maps)", 30),
            Param("num_features", "hash bins for high-cardinality text keys", 512),
            Param("clean_text", "normalize category strings", True),
            Param("clean_keys", "normalize map keys", False),
            Param("track_nulls", "append null indicators", True),
            Param("allow_listed_keys", "restrict to these keys (None = all)", None),
            Param("block_listed_keys", "exclude these keys", None),
        ]

    def __init__(self, operation_name: str = "vecMap",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def _kind_of(self, t) -> str:
        name = t.__name__
        if issubclass(t, GeolocationMap):
            return "geo"
        if issubclass(t, MultiPickListMap):
            return "multipicklist"
        if issubclass(t, BinaryMap):
            return "binary"
        if issubclass(t, NumericMap):
            return "real"
        if name in _CATEGORICAL_MAP_TYPES:
            return "categorical"
        if issubclass(t, TextMap):
            return "smarttext"
        return "real"

    def fit_columns(self, *cols: Column) -> MapVectorizerModel:
        clean_keys_p = self.get_param("clean_keys")
        clean = self.get_param("clean_text")
        track = self.get_param("track_nulls")
        top_k = int(self.get_param("top_k"))
        min_support = int(self.get_param("min_support"))
        max_card = int(self.get_param("max_cardinality"))
        bins = int(self.get_param("num_features"))
        allow = self.get_param("allow_listed_keys")
        block = set(self.get_param("block_listed_keys") or ())

        plans: List[Dict[str, Any]] = []
        md_cols: List[VectorColumnMetadata] = []
        for f, c in zip(self.input_features, cols):
            kind = self._kind_of(f.feature_type)
            # discover keys
            key_counts: Counter = Counter()
            for m in c.data:
                if m:
                    for k in m:
                        key_counts[clean_key(str(k), clean_keys_p)] += 1
            keys = sorted(k for k in key_counts
                          if (allow is None or k in allow) and k not in block)
            plan: Dict[str, Any] = dict(kind=kind, keys=keys, track_nulls=track,
                                        clean_text=clean, bins=bins,
                                        fills={}, vocab={})
            key_clean = (lambda s: clean_key(s, True)) if clean_keys_p else None
            keycols = extract_key_columns(c.data, keys, key_clean)
            if kind in ("real", "binary"):
                for key in keys:
                    vals = keycols[key]
                    present = ~null_mask(vals)
                    plan["fills"][key] = (
                        float(float_column(vals, 0.0)[present].mean())
                        if kind == "real" and present.any() else 0.0)
            elif kind == "geo":
                for key in keys:
                    geo_vals = [v for v in keycols[key] if v]
                    plan["fills"][key] = geo_mean(geo_vals)
            elif kind in ("categorical", "multipicklist", "smarttext"):
                for key in keys:
                    counts, _ = category_counts(
                        keycols[key], lambda s: clean_text_value(s, clean),
                        multiset=(kind == "multipicklist"))
                    if kind == "smarttext" and len(counts) > max_card:
                        # high-cardinality free text -> hashing for this key
                        plan["vocab"][key] = None
                    else:
                        kept = [(v, n) for v, n in counts.items()
                                if n >= min_support and v != ""]
                        kept.sort(key=lambda kv: (-kv[1], kv[0]))
                        plan["vocab"][key] = [v for v, _ in kept[:top_k]]
            if kind == "smarttext":
                plan["kind"] = "categorical"  # vocab[key]=None marks hash keys
            plans.append(plan)
            md_cols.extend(self._metadata_for(f, plan))

        model = MapVectorizerModel(feature_plans=plans, clean_keys=clean_keys_p,
                                   operation_name=self.operation_name)
        model.set_metadata(VectorMetadata(name=self.output_name(), columns=md_cols))
        return model

    def _metadata_for(self, f, plan) -> List[VectorColumnMetadata]:
        out: List[VectorColumnMetadata] = []
        track = plan["track_nulls"]
        for key in plan["keys"]:
            if plan["kind"] in ("real", "binary"):
                out.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    grouping=key))
                if track:
                    out.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=key, indicator_value=NULL_STRING))
            elif plan["kind"] in ("categorical", "multipicklist"):
                vocab = plan["vocab"].get(key, [])
                if vocab is None:  # hashed key
                    for b in range(plan["bins"]):
                        out.append(VectorColumnMetadata(
                            parent_feature_name=f.name,
                            parent_feature_type=f.type_name,
                            grouping=key, descriptor_value=f"hash_{b}"))
                    if track:
                        out.append(VectorColumnMetadata(
                            parent_feature_name=f.name,
                            parent_feature_type=f.type_name,
                            grouping=key, indicator_value=NULL_STRING))
                    continue
                for v in vocab:
                    out.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=key, indicator_value=v))
                out.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    grouping=key, indicator_value=OTHER_STRING))
                if track:
                    out.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=key, indicator_value=NULL_STRING))
            elif plan["kind"] == "geo":
                for d in ("lat", "lon", "accuracy"):
                    out.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=key, descriptor_value=d))
                if track:
                    out.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=key, indicator_value=NULL_STRING))
        return out


def map_vectorizer_for(map_type_name: str, defaults) -> MapVectorizer:
    return MapVectorizer(
        top_k=defaults.top_k, min_support=defaults.min_support,
        max_cardinality=defaults.max_categorical_cardinality,
        num_features=defaults.default_num_of_features,
        clean_text=defaults.clean_text, clean_keys=defaults.clean_keys,
        track_nulls=defaults.track_nulls)


class DateMapUnitCircleModel(VectorizerModel):
    """Fitted DateMap -> per-key [sin, cos] unit-circle blocks (reference
    DateMapToUnitCircleVectorizer.scala via RichMapFeature
    .toUnitCircle:716). Missing keys map to the origin (0, 0) exactly like
    the scalar DateToUnitCircleTransformer."""

    input_types = (OPMap,)  # mirrors DateMapUnitCircleVectorizer

    def __init__(self, key_sets: Sequence[List[str]] = (),
                 time_period: str = "HourOfDay", clean_keys: bool = False,
                 operation_name: str = "dateMapUnitCircle",
                 uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.key_sets = [list(ks) for ks in key_sets]
        self.time_period = str(time_period)
        self.clean_keys = bool(clean_keys)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        from .dates import unit_circle
        key_clean = (lambda s: clean_key(s, True)) if self.clean_keys \
            else None
        blocks: List[np.ndarray] = []
        for keys, c in zip(self.key_sets, cols):
            keycols = extract_key_columns(c.data, keys, key_clean)
            for key in keys:
                ms = float_column(keycols[key], np.nan)
                s, co, _ = unit_circle(ms, self.time_period)
                blocks.append(np.stack([s, co], axis=1))
        n = len(cols[0].data) if cols else 0
        return (np.concatenate(blocks, axis=1) if blocks
                else np.zeros((n, 0)))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(key_sets=self.key_sets, time_period=self.time_period,
                 clean_keys=self.clean_keys)
        return d


class DateMapUnitCircleVectorizer(SequenceVectorizer):
    """Estimator: discover each DateMap's key set, emit [sin, cos] per key
    for one calendar period (reference RichMapFeature.toUnitCircle)."""

    input_types = (OPMap,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("time_period", "HourOfDay|DayOfWeek|DayOfMonth|DayOfYear|"
                  "WeekOfYear|MonthOfYear", "HourOfDay"),
            Param("clean_keys", "normalize map keys", False),
            Param("allow_listed_keys", "restrict to these keys (None = all)",
                  None),
            Param("block_listed_keys", "exclude these keys", None),
        ]

    def __init__(self, operation_name: str = "dateMapUnitCircle",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> DateMapUnitCircleModel:
        clean_keys_p = bool(self.get_param("clean_keys"))
        allow = self.get_param("allow_listed_keys")
        block = set(self.get_param("block_listed_keys") or ())
        period = str(self.get_param("time_period"))

        key_sets: List[List[str]] = []
        md_cols: List[VectorColumnMetadata] = []
        for f, c in zip(self.input_features, cols):
            seen: Dict[str, None] = {}
            for m in c.data:
                if m:
                    for k in m:
                        seen.setdefault(clean_key(str(k), clean_keys_p))
            keys = [k for k in sorted(seen)
                    if (allow is None or k in set(allow)) and k not in block]
            key_sets.append(keys)
            for key in keys:
                for d in ("sin", "cos"):
                    md_cols.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=key, descriptor_value=f"{period}_{d}"))
        model = DateMapUnitCircleModel(
            key_sets, time_period=period, clean_keys=clean_keys_p,
            operation_name=self.operation_name)
        model.set_metadata(VectorMetadata(
            name=self.output_name() or "dateMapUnitCircle",
            columns=md_cols))
        return model
