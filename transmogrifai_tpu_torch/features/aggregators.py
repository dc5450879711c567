"""Monoid aggregators for event aggregation in readers (counterpart of
features/aggregators.py).

Reference: features/.../aggregators/ (9 files, ~1,200 LoC on algebird):
MonoidAggregatorDefaults.scala:41 default table, Numerics.scala
(sum/min/max/mean/logical ops), Text.scala (concat with separator, mode),
Geolocation.scala (3D geographic midpoint), Maps.scala (per-key value
monoids), TimeBasedAggregator.scala (event-date first/last). The same
palette as (prepare, zero, plus, present) quadruples per feature type,
applied on the host by the aggregate readers (readers/readers.py) when
they fold many events per key into one row. Pure Python: the values stay
Python objects, and float arithmetic is Python's float64, as in the JAX
package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Type

from ..types import (
    Binary, Date, DateTime, FeatureType, Geolocation, OPList, OPMap,
    OPNumeric, OPSet, OPVector, Percent, PickList, Text, TextArea,
)


@dataclass
class MonoidAggregator:
    """prepare -> zero/plus fold -> present (reference algebird
    MonoidAggregator shape).

    ``prepare(value, time)`` lifts a raw extracted value (+ its event
    time) into the accumulator domain; ``plus`` is associative over that
    domain; ``present`` lowers the final accumulator back to a raw value.
    Constructing with just (zero, plus) keeps the legacy two-field form:
    identity prepare (value only) and identity present.
    """

    zero: Callable[[], Any]
    plus: Callable[[Any, Any], Any]
    prepare: Optional[Callable[[Any, Optional[int]], Any]] = None
    present: Optional[Callable[[Any], Any]] = None

    def reduce(self, values, times=None) -> Any:
        """Fold raw values; `times` is an optional parallel sequence of
        event times (time-aware aggregators read them via prepare).
        Values and times are SEPARATE sequences on purpose: a raw value
        may itself be a tuple (lat/lon pairs), so pair-packing would be
        ambiguous."""
        acc = self.zero()
        if times is None:
            for val in values:
                item = self.prepare(val, None) if self.prepare else val
                acc = self.plus(acc, item)
        else:
            for val, t in zip(values, times):
                item = self.prepare(val, t) if self.prepare else val
                acc = self.plus(acc, item)
        return self.present(acc) if self.present else acc


# -- option-lifted scalar monoids -------------------------------------------

def _sum_option(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def _union_list(a, b):
    return (a or []) + (b or [])


def _union_set(a, b):
    return (a or set()) | (b or set())


def _logical_or(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a or b


def _logical_and(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a and b


def _logical_xor(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return bool(a) ^ bool(b)


def _min_option(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return min(a, b)


def _max_option(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return max(a, b)


# -- mean (count-carrying pair monoid, reference MeanDouble) ----------------

def _mean_prepare(v, _t):
    return None if v is None else (float(v), 1)


def _percent_prepare(v, _t):
    """Reference PercentPrepare.prepareFn: clamp to [0, 1]."""
    if v is None:
        return None
    return (min(max(float(v), 0.0), 1.0), 1)


def _pair_sum(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return (a[0] + b[0], a[1] + b[1])


def _mean_present(acc):
    if acc is None or acc[1] == 0:
        return None
    return acc[0] / acc[1]


def mean_aggregator(percent: bool = False) -> MonoidAggregator:
    """Reference MeanReal/MeanCurrency/MeanPercent (Numerics.scala:102)."""
    return MonoidAggregator(
        zero=lambda: None, plus=_pair_sum,
        prepare=_percent_prepare if percent else _mean_prepare,
        present=_mean_present)


# -- time-based first/last (reference TimeBasedAggregator.scala) ------------
# Missing-time semantics: an untimed event can never beat a timed one
# (+inf for first / -inf for last); among untimed-only streams the tie
# rules reduce to encounter order (first keeps the earliest encountered,
# last the latest). The reference never faces the mix — its Event.date is
# always set — so this is the conservative extension.

def _first_prepare(v, t):
    return None if v is None else (t if t is not None else math.inf, v)


def _last_prepare(v, t):
    return None if v is None else (t if t is not None else -math.inf, v)


def _last_by_time(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return b if b[0] >= a[0] else a


def _first_by_time(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return b if b[0] < a[0] else a


def _timed_present(acc):
    return None if acc is None else acc[1]


def first_aggregator() -> MonoidAggregator:
    """Value of the EARLIEST event by event time (reference
    FirstAggregator)."""
    return MonoidAggregator(zero=lambda: None, plus=_first_by_time,
                            prepare=_first_prepare, present=_timed_present)


def last_aggregator() -> MonoidAggregator:
    """Value of the LATEST event by event time (reference LastAggregator)."""
    return MonoidAggregator(zero=lambda: None, plus=_last_by_time,
                            prepare=_last_prepare, present=_timed_present)


# -- text: concat + mode (reference Text.scala) -----------------------------

def concat_aggregator(separator: str = ",") -> MonoidAggregator:
    """ConcatTextWithSeparator (Text/TextArea use " ", others ",")."""
    def plus(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return f"{a}{separator}{b}"
    return MonoidAggregator(zero=lambda: None, plus=plus)


def mode_aggregator() -> MonoidAggregator:
    """ModePickList: the most frequent non-empty value (ties: the
    lexicographically smallest, deterministic like the reference's
    min-by over the count map)."""
    def prepare(v, _t):
        return {} if v is None else {v: 1}

    def plus(a, b):
        out = dict(a)
        for k, c in b.items():
            out[k] = out.get(k, 0) + c
        return out

    def present(acc):
        if not acc:
            return None
        top = max(acc.values())
        return min(k for k, c in acc.items() if c == top)

    return MonoidAggregator(zero=dict, plus=plus, prepare=prepare,
                            present=present)


# -- geolocation midpoint (reference Geolocation.scala) ---------------------

def _geo_prepare(v, _t):
    """(lat, lon[, acc]) -> unit-sphere (x, y, z, acc, count)."""
    if not v:
        return None
    lat = math.radians(float(v[0]))
    lon = math.radians(float(v[1]))
    acc = float(v[2]) if len(v) > 2 else 0.0
    return (math.cos(lat) * math.cos(lon),
            math.cos(lat) * math.sin(lon),
            math.sin(lat), acc, 1.0)


def _geo_plus(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return tuple(x + y for x, y in zip(a, b))


def _geo_present(acc):
    """Average 3D position back to (lat, lon, max-ish accuracy). The
    reference derives accuracy from the aggregate bounding-box width
    (GeolocationAccuracy.forRangeInUnits); carrying the mean input
    accuracy keeps the same 3-slot value shape with a simpler, monotone
    summary."""
    if acc is None or acc[4] == 0:
        return None
    n = acc[4]
    x, y, z = acc[0] / n, acc[1] / n, acc[2] / n
    lat = math.degrees(math.atan2(z, math.sqrt(x * x + y * y)))
    lon = math.degrees(math.atan2(y, x))
    return [lat, lon, acc[3] / n]


def geolocation_midpoint_aggregator() -> MonoidAggregator:
    """Geographic midpoint by unit-sphere averaging (reference
    GeolocationMidpoint: 'each list really represents just one object,
    so the default is the geographic midpoint')."""
    return MonoidAggregator(zero=lambda: None, plus=_geo_plus,
                            prepare=_geo_prepare, present=_geo_present)


# -- maps: per-key value monoids (reference Maps.scala) ---------------------

def map_value_aggregator(value_plus: Callable[[Any, Any], Any],
                         value_prepare: Optional[Callable] = None,
                         value_present: Optional[Callable] = None
                         ) -> MonoidAggregator:
    """Union maps whose shared keys combine by a VALUE monoid (reference
    UnionSumNumericMap / UnionMeanDoubleMap / UnionConcat*Map...)."""
    def prepare(v, t):
        if not v:
            return {}
        if value_prepare:
            return {k: value_prepare(x, t) for k, x in v.items()}
        return dict(v)

    def plus(a, b):
        out = dict(a)
        for k, x in b.items():
            out[k] = value_plus(out[k], x) if k in out else x
        return out

    def present(acc):
        if value_present:
            return {k: value_present(x) for k, x in acc.items()}
        return acc

    return MonoidAggregator(zero=dict, plus=plus, prepare=prepare,
                            present=present)


def _vector_combine(a, b):
    """CombineVector (OPVector.scala:43): concatenation."""
    if a is None:
        return b
    if b is None:
        return a
    import numpy as np
    return np.concatenate([np.asarray(a), np.asarray(b)])


def named_aggregator(name: str, type_cls: Type[FeatureType]
                     ) -> MonoidAggregator:
    """Named monoids (reference aggregator case objects):
    sum|min|max|last|first|union|mean|mode|concat|logical_and|logical_or|
    logical_xor|midpoint."""
    if name == "sum":
        return MonoidAggregator(lambda: None, _sum_option)
    if name == "min":
        return MonoidAggregator(lambda: None, _min_option)
    if name == "max":
        return MonoidAggregator(lambda: None, _max_option)
    if name == "last":
        return last_aggregator()
    if name == "first":
        return first_aggregator()
    if name == "mean":
        return mean_aggregator(percent=issubclass(type_cls, Percent))
    if name == "mode":
        return mode_aggregator()
    if name == "concat":
        sep = " " if issubclass(type_cls, (TextArea,)) \
            or type_cls is Text else ","
        return concat_aggregator(sep)
    if name == "logical_or":
        return MonoidAggregator(lambda: None, _logical_or)
    if name == "logical_and":
        return MonoidAggregator(lambda: None, _logical_and)
    if name == "logical_xor":
        return MonoidAggregator(lambda: None, _logical_xor)
    if name == "midpoint":
        return geolocation_midpoint_aggregator()
    if name == "union":
        if issubclass(type_cls, OPSet):
            return MonoidAggregator(lambda: set(), _union_set)
        if issubclass(type_cls, OPMap):
            return map_value_aggregator(lambda a, b: b)  # last per key
        return MonoidAggregator(lambda: [], _union_list)
    raise ValueError(
        f"Unknown aggregator name {name!r} (sum|min|max|last|first|union|"
        f"mean|mode|concat|logical_and|logical_or|logical_xor|midpoint)")


class MonoidAggregatorDefaults:
    """Default aggregator per feature type — the reference dispatch table
    (MonoidAggregatorDefaults.scala:56-115): numerics sum, Percent mean
    (clamped), Binary logical OR, Date/DateTime max, text concat,
    PickList mode, sets union, lists concat, Geolocation midpoint,
    OPVector combine; maps union with the matching VALUE monoid per key.
    """

    @staticmethod
    def aggregator_for(type_cls: Type[FeatureType]) -> MonoidAggregator:
        # maps first (an OPMap is not a Text); per-key value monoid echoes
        # the scalar default of the value type. issubclass dispatch,
        # most-specific first (PercentMap/CurrencyMap/Prediction ARE
        # RealMaps, DateTimeMap IS a DateMap), so user subclasses of any
        # numeric map inherit the numeric monoid instead of string concat
        if issubclass(type_cls, OPMap):
            from ..types import (
                BinaryMap, DateMap, GeolocationMap, MultiPickListMap,
                NumericMap, PercentMap, Prediction,
            )
            if issubclass(type_cls, GeolocationMap):
                return map_value_aggregator(
                    _geo_plus, value_prepare=_geo_prepare,
                    value_present=_geo_present)
            if issubclass(type_cls, MultiPickListMap):
                return map_value_aggregator(
                    lambda a, b: (set(a) | set(b)))
            if issubclass(type_cls, BinaryMap):
                return map_value_aggregator(_logical_or)
            if issubclass(type_cls, DateMap):
                return map_value_aggregator(_max_option)
            if issubclass(type_cls, (PercentMap, Prediction)):
                return map_value_aggregator(
                    _pair_sum,
                    value_prepare=(_percent_prepare
                                   if issubclass(type_cls, PercentMap)
                                   else _mean_prepare),
                    value_present=_mean_present)
            if issubclass(type_cls, NumericMap):
                return map_value_aggregator(_sum_option)
            # text-valued maps: per-key concat — " " for free-text
            # TextMap/TextAreaMap themselves, "," for the structured
            # subclasses (reference UnionConcat*Map, Maps.scala:139-152)
            from ..types import TextAreaMap, TextMap
            sep = " " if type_cls in (TextMap, TextAreaMap) else ","

            def _concat_kv(a, b, _s=sep):
                if a is None:
                    return b
                if b is None:
                    return a
                return f"{a}{_s}{b}"

            return map_value_aggregator(_concat_kv)
        if issubclass(type_cls, Binary):
            return MonoidAggregator(lambda: None, _logical_or)
        if issubclass(type_cls, (Date, DateTime)):
            return MonoidAggregator(lambda: None, _max_option)
        if issubclass(type_cls, Percent):
            return mean_aggregator(percent=True)
        if issubclass(type_cls, OPNumeric):
            return MonoidAggregator(lambda: None, _sum_option)
        if issubclass(type_cls, OPSet):  # includes MultiPickList
            return MonoidAggregator(set, _union_set)
        if issubclass(type_cls, Geolocation):
            return geolocation_midpoint_aggregator()
        if issubclass(type_cls, OPVector):
            return MonoidAggregator(lambda: None, _vector_combine)
        if issubclass(type_cls, OPList):
            return MonoidAggregator(list, _union_list)
        if issubclass(type_cls, PickList):
            return mode_aggregator()
        if issubclass(type_cls, (TextArea,)) or type_cls is Text:
            return concat_aggregator(" ")
        if issubclass(type_cls, Text):
            return concat_aggregator(",")
        return MonoidAggregator(lambda: None,
                                lambda a, b: b if b is not None else a)


@dataclass
class FeatureAggregator:
    """Aggregator + optional event-time window filter (reference
    FeatureAggregator / TimeBasedAggregator)."""

    type_cls: Type[FeatureType]
    aggregator: Optional[MonoidAggregator] = None
    window_ms: Optional[int] = None  # only events within window of cutoff

    def __post_init__(self):
        if self.aggregator is None:
            self.aggregator = MonoidAggregatorDefaults.aggregator_for(self.type_cls)

    def extract(self, events, event_time_fn=None, cutoff_time: Optional[int] = None,
                is_response: bool = False) -> Any:
        """Aggregate raw extracted values from events.

        Window predicate matches the reference exactly
        (GenericFeatureAggregator.filterByDateWithCutoff,
        features/.../aggregators/FeatureAggregator.scala:114-124):
        predictors keep ``cutoff - window <= t < cutoff``, responses keep
        ``cutoff <= t <= cutoff + window`` (windows optional). Event times
        flow into the aggregator (time-based first/last).
        """
        vals, times = [], []
        for ev_val, ev_time in events:
            if cutoff_time is not None and ev_time is not None:
                if is_response:
                    if ev_time < cutoff_time:
                        continue
                    if self.window_ms is not None and \
                            ev_time > cutoff_time + self.window_ms:
                        continue
                else:
                    if ev_time >= cutoff_time:
                        continue
                    if self.window_ms is not None and \
                            ev_time < cutoff_time - self.window_ms:
                        continue
            vals.append(ev_val)
            times.append(ev_time)
        return self.aggregator.reduce(vals, times)
