"""FeatureBuilder: the user API for declaring raw features.

Reference: features/.../FeatureBuilder.scala — e.g.
``FeatureBuilder.Real[Passenger].extract(_.getAge).asPredictor`` becomes::

    age = FeatureBuilder.Real("age").extract(lambda r: r["age"]).as_predictor()

plus ``FeatureBuilder.from_dataset`` mirroring ``fromDataFrame:190`` (schema
auto-inference: every column becomes a feature of its inferred type, the
named response becomes RealNN).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..types import (
    Binary, FeatureType, Geolocation, Integral, MultiPickList, PickList, Real,
    RealNN, Text, TextList,
)
from .aggregators import (FeatureAggregator, MonoidAggregator,
                          named_aggregator)
from .feature import Feature
from .generator import FeatureGeneratorStage


class _TypedFeatureBuilder:
    def __init__(self, name: str, type_cls: Type[FeatureType]):
        self.name = name
        self.type_cls = type_cls
        self._extract_fn: Optional[Callable[[Any], Any]] = None
        self._aggregator: Optional[FeatureAggregator] = None
        self._window_ms: Optional[int] = None
        self._event_time_fn: Optional[Callable[[Any], Optional[int]]] = None

    def extract(self, fn: Callable[[Any], Any]) -> "_TypedFeatureBuilder":
        """Set the record->value extraction function
        (reference FeatureBuilder.extract:246)."""
        self._extract_fn = fn
        return self

    def aggregate(self, plus,
                  zero: Callable[[], Any] = lambda: None) -> "_TypedFeatureBuilder":
        """Monoid for event aggregation (reference FeatureBuilder
        .aggregate:283-302). Pass a callable plus (with optional zero) or
        a named default: "sum" | "min" | "max" | "last" | "first" |
        "union" | "mean" | "mode" | "concat" | "logical_and" |
        "logical_or" | "logical_xor" | "midpoint" ("first"/"last" follow
        event TIME, not encounter order)."""
        if isinstance(plus, str):
            agg = named_aggregator(plus, self.type_cls)
        else:
            agg = MonoidAggregator(zero=zero, plus=plus)
        self._aggregator = FeatureAggregator(
            type_cls=self.type_cls, aggregator=agg)
        return self

    def window(self, ms: int) -> "_TypedFeatureBuilder":
        """Aggregation time window (reference FeatureBuilder.window:311)."""
        self._window_ms = ms
        return self

    def event_time(self, fn: Callable[[Any], Optional[int]]) -> "_TypedFeatureBuilder":
        self._event_time_fn = fn
        return self

    def _build(self, is_response: bool) -> Feature:
        if self._extract_fn is None:
            name = self.name
            self._extract_fn = lambda r: r.get(name) if isinstance(r, dict) \
                else getattr(r, name, None)
        agg = self._aggregator or FeatureAggregator(type_cls=self.type_cls,
                                                    window_ms=self._window_ms)
        if self._window_ms is not None:
            agg.window_ms = self._window_ms
        stage = FeatureGeneratorStage(
            name=self.name, feature_type=self.type_cls,
            extract_fn=self._extract_fn, is_response=is_response,
            aggregator=agg, event_time_fn=self._event_time_fn)
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


class _FeatureBuilderMeta(type):
    """FeatureBuilder.<TypeName>(name) for every registered feature type."""

    def __getattr__(cls, type_name: str):
        try:
            tcls = FeatureType.from_name(type_name)
        except ValueError:
            raise AttributeError(type_name) from None
        return lambda name: _TypedFeatureBuilder(name, tcls)


class FeatureBuilder(metaclass=_FeatureBuilderMeta):
    """``FeatureBuilder.Real("age")``, ``FeatureBuilder.PickList("sex")``, ..."""

    @staticmethod
    def of(name: str, type_cls: Type[FeatureType]) -> _TypedFeatureBuilder:
        return _TypedFeatureBuilder(name, type_cls)

    # -- schema inference (reference fromDataFrame:190) --------------------
    @staticmethod
    def from_rows(rows: Sequence[Dict[str, Any]], response: str,
                  non_nullable: Sequence[str] = ()) -> Tuple[Feature, List[Feature]]:
        """Infer a feature per key from example row dicts; the response
        becomes RealNN. Returns (response_feature, predictor_features)."""
        keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        feats: List[Feature] = []
        resp: Optional[Feature] = None
        for k in keys:
            vals = [r.get(k) for r in rows]
            tcls = RealNN if k == response else infer_feature_type(vals)
            b = _TypedFeatureBuilder(k, tcls).extract(_dict_getter(k, tcls))
            if k == response:
                resp = b.as_response()
            else:
                feats.append(b.as_predictor())
        if resp is None:
            raise ValueError(f"Response column '{response}' not found")
        return resp, feats


def _dict_getter(key: str, tcls: Type[FeatureType]) -> Callable[[Any], Any]:
    if issubclass(tcls, RealNN):
        return lambda r: float(r.get(key)) if r.get(key) is not None else 0.0
    return lambda r: r.get(key)


def infer_feature_type(values: Sequence[Any]) -> Type[FeatureType]:
    """Infer the FeatureType of a column from sample raw values (the analogue
    of fromDataFrame's schema mapping — here duck-typed since there is no
    Spark schema)."""
    non_null = [v for v in values if v is not None]
    if not non_null:
        return Text
    v = non_null[0]
    if isinstance(v, bool):
        return Binary
    if isinstance(v, (int, np.integer)):
        distinct = set(non_null)
        if distinct <= {0, 1}:
            return Binary
        return Integral
    if isinstance(v, (float, np.floating)):
        return Real
    if isinstance(v, str):
        distinct = {str(x) for x in non_null}
        if len(distinct) <= max(10, int(0.1 * len(non_null))) and len(distinct) < 100:
            return PickList
        return Text
    if isinstance(v, (list, tuple)):
        if v and isinstance(v[0], str):
            return TextList
        if len(v) == 3 and all(isinstance(x, (int, float)) for x in v):
            return Geolocation
        return TextList
    if isinstance(v, set):
        return MultiPickList
    if isinstance(v, dict):
        vv = next(iter(v.values()), None)
        from ..types import RealMap, TextMap
        return RealMap if isinstance(vv, (int, float)) else TextMap
    return Text
