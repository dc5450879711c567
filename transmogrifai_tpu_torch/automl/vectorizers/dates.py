"""Date/time vectorizers: time-since-reference + circular encodings
(counterpart of automl/vectorizers/dates.py; host numpy float64, as there).

Reference: core/.../impl/feature/{DateToUnitCircleTransformer.scala,
DateListVectorizer.scala:309}. Default circular periods per
TransmogrifierDefaults.CircularDateRepresentations: HourOfDay, DayOfWeek,
DayOfMonth, DayOfYear — each maps to (sin, cos) on the unit circle so
midnight is close to 23:59.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...data.dataset import Column
from ...data.vector import NULL_STRING, VectorColumnMetadata, VectorMetadata
from ...stages.params import Param
from ...types import DateList, Integral
from .base import SequenceVectorizer, VectorizerModel, numeric_block
from .encoding import list_reduce

MS_PER_DAY = 86400000.0

# name -> period length; extractors are derived from _PERIOD_FROM_DT64
# below (single source of truth — the vectorizer's one-pass block writer
# and the dsl DateToUnitCircleTransformer must stay bitwise-identical)
_PERIOD_LENGTHS: Dict[str, float] = {
    "HourOfDay": 24.0,
    "DayOfWeek": 7.0,   # epoch day 0 was a Thursday (+3 offset)
    "DayOfMonth": 31.0,
    "DayOfYear": 366.0,
    "WeekOfYear": 53.0,
    "MonthOfYear": 12.0,
}


def _dt64(ms: np.ndarray):
    """(datetime64[ms] array, finite mask) — calendar math fully in numpy;
    the previous per-row datetime.utcfromtimestamp loop was 1000x slower."""
    finite = np.isfinite(ms)
    safe = np.where(finite, ms, 0.0).astype(np.int64)
    return safe.astype("datetime64[ms]"), finite


def _cal_delta_d(d: np.ndarray, unit: str, anchor: str,
                 cache: Optional[Dict[str, np.ndarray]] = None
                 ) -> np.ndarray:
    """Elapsed `unit`s since the enclosing `anchor` period start, on a
    PRE-COMPUTED dt64 array. `cache` (unit -> d@[unit]) lets the one-pass
    block writer share casts across periods (DayOfMonth/DayOfYear/
    WeekOfYear all need d@[D])."""
    if cache is None:
        du = d.astype(f"M8[{unit}]")
        da = d.astype(f"M8[{anchor}]")
    else:
        du = cache.get(unit)
        if du is None:
            du = cache[unit] = d.astype(f"M8[{unit}]")
        da = cache.get(anchor)
        if da is None:
            da = cache[anchor] = d.astype(f"M8[{anchor}]")
    return (du - da.astype(f"M8[{unit}]")).astype(np.int64).astype(
        np.float64)


# calendar periods as DATA — (unit, anchor, divisor) — so the one-pass
# block writer (shared cast cache) and the standalone extractors read
# the same definition; ms-math periods live in _MS_PERIODS
_CAL_PERIODS = {
    "DayOfMonth": ("D", "M", 1.0),
    "DayOfYear": ("D", "Y", 1.0),
    "WeekOfYear": ("D", "Y", 7.0),
    "MonthOfYear": ("M", "Y", 1.0),
}
_MS_PERIODS = {
    "HourOfDay": lambda ms: (ms / 3600000.0) % 24.0,
    "DayOfWeek": lambda ms: ((ms / MS_PER_DAY) + 3.0) % 7.0,
}

# period -> value from (epoch ms, shared dt64) — derived views of the
# tables above; everything else (PERIODS, unit_circle) derives from this
# (x / 1.0 is bitwise x, so the uniform divide is exact)
_PERIOD_FROM_DT64 = {
    **{name: (lambda ms, d, _f=fn: _f(ms)) for name, fn in
       _MS_PERIODS.items()},
    **{name: (lambda ms, d, _u=u, _a=a, _dv=dv:
              _cal_delta_d(d, _u, _a) / _dv)
       for name, (u, a, dv) in _CAL_PERIODS.items()},
}


def _standalone_extract(name: str):
    """ms-only extractor (derives + masks the dt64 form): NaN where the
    input is NaN, matching the old _calendar_delta behavior."""
    fn = _PERIOD_FROM_DT64[name]

    def extract(ms: np.ndarray) -> np.ndarray:
        d, finite = _dt64(ms)
        val = fn(ms, d)
        return np.where(finite, val, np.nan)

    return extract


PERIODS: Dict[str, Any] = {
    name: (length, _standalone_extract(name))
    for name, length in _PERIOD_LENGTHS.items()
}


def unit_circle(ms: np.ndarray, period_name: str
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(sin, cos, finite_mask) of one calendar period for epoch-ms values —
    the circular encoding shared by DateVectorizer and the dsl-exposed
    DateToUnitCircleTransformer. Missing dates map to the origin (0, 0):
    equidistant from every point on the circle."""
    period, extract = PERIODS[period_name]
    finite = np.isfinite(ms)
    ang = 2.0 * np.pi * extract(ms) / period
    s = np.where(finite, np.sin(ang), 0.0)
    c = np.where(finite, np.cos(ang), 0.0)
    return s, c, finite


class DateVectorizerModel(VectorizerModel):
    input_types = (Integral,)  # mirrors DateVectorizer: Date/DateTime

    def __init__(self, reference_date_ms: float,
                 circular_periods: Sequence[str], track_nulls: bool = True,
                 operation_name: str = "vecDate", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.reference_date_ms = float(reference_date_ms)
        self.circular_periods = list(circular_periods)
        self.track_nulls = track_nulls

    def _feature_width(self) -> int:
        return 1 + 2 * len(self.circular_periods) + (
            1 if self.track_nulls else 0)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        n = len(cols[0]) if cols else 0
        out = np.zeros((n, self._feature_width() * len(cols)), np.float32)
        self.transform_block_into(cols, out)
        return out

    def transform_block_into(self, cols: Sequence[Column],
                             out: np.ndarray) -> None:
        # one pass per column: the dt64 representation and the angle
        # buffer are computed once and shared across periods (each
        # unit_circle call re-derived them — 4 periods paid 4x the
        # calendar casts), and sin/cos land in the destination slice
        X = numeric_block(cols)  # epoch millis, NaN missing
        at = 0
        for j in range(X.shape[1]):
            ms = X[:, j]
            finite = np.isfinite(ms)
            d, _ = _dt64(ms)
            cast_cache: Dict[str, np.ndarray] = {}
            out[:, at] = np.where(
                finite, (self.reference_date_ms - ms) / MS_PER_DAY, 0.0)
            k = at + 1
            for p in self.circular_periods:
                period = _PERIOD_LENGTHS[p]
                if p in _CAL_PERIODS:
                    u, a, dv = _CAL_PERIODS[p]
                    val = _cal_delta_d(d, u, a, cast_cache) / dv
                else:
                    val = _MS_PERIODS[p](ms)
                # same fp op order AND precision as unit_circle (f64 trig
                # then the f32 store) — bitwise parity with the dsl
                # DateToUnitCircleTransformer is a stated invariant
                ang = 2.0 * np.pi * val / period
                out[:, k] = np.where(finite, np.sin(ang), 0.0)
                out[:, k + 1] = np.where(finite, np.cos(ang), 0.0)
                k += 2
            if self.track_nulls:
                out[:, k] = ~finite
                k += 1
            at = k
        if at != out.shape[1]:  # python -O strips assert; sink fallback
            raise AssertionError((at, out.shape))  # relies on this firing

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(reference_date_ms=self.reference_date_ms,
                 circular_periods=self.circular_periods,
                 track_nulls=self.track_nulls)
        return d


class DateVectorizer(SequenceVectorizer):
    """Date/DateTime group vectorizer."""

    input_types = (Integral,)  # Date extends Integral; accepts Date/DateTime

    @classmethod
    def _declare_params(cls):
        return [
            Param("reference_date_ms", "reference time (None = fit time)", None),
            Param("circular_periods", "periods to encode",
                  ["HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear"]),
            Param("track_nulls", "append null indicators", True),
        ]

    def __init__(self, operation_name: str = "vecDate",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> DateVectorizerModel:
        ref = self.get_param("reference_date_ms")
        if ref is None:
            import time
            ref = time.time() * 1000.0
        periods = list(self.get_param("circular_periods"))
        track = self.get_param("track_nulls")
        model = DateVectorizerModel(
            reference_date_ms=float(ref), circular_periods=periods,
            track_nulls=track, operation_name=self.operation_name)
        md_cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            md_cols.append(VectorColumnMetadata(
                parent_feature_name=f.name, parent_feature_type=f.type_name,
                descriptor_value="daysSinceReference"))
            for p in periods:
                for trig in ("sin", "cos"):
                    md_cols.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        descriptor_value=f"{p}_{trig}"))
            if track:
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    indicator_value=NULL_STRING))
        model.set_metadata(VectorMetadata(name=self.output_name(), columns=md_cols))
        return model


class DateListVectorizerModel(VectorizerModel):
    """DateList pivot modes (reference DateListPivot): SinceLast (default) —
    days from reference to most recent event; also ModeDay etc. are reduced
    to SinceFirst/SinceLast here."""

    input_types = (DateList,)  # mirrors DateListVectorizer

    def __init__(self, reference_date_ms: float, mode: str = "SinceLast",
                 operation_name: str = "vecDateList", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.reference_date_ms = float(reference_date_ms)
        self.mode = mode

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        n = len(cols[0])
        blocks = []
        for c in cols:
            anchor, empty = list_reduce(
                c.data, "max" if self.mode == "SinceLast" else "min")
            out = np.zeros((n, 2), dtype=np.float64)
            out[:, 0] = np.where(
                empty, 0.0, (self.reference_date_ms - anchor) / MS_PER_DAY)
            out[:, 1] = empty.astype(np.float64)
            blocks.append(out)
        return np.concatenate(blocks, axis=1)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(reference_date_ms=self.reference_date_ms, mode=self.mode)
        return d


class DateListVectorizer(SequenceVectorizer):
    input_types = (DateList,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("reference_date_ms", "reference time (None = fit time)", None),
            Param("mode", "SinceLast|SinceFirst", "SinceLast",
                  lambda v: v in ("SinceLast", "SinceFirst")),
        ]

    def __init__(self, operation_name: str = "vecDateList",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> DateListVectorizerModel:
        ref = self.get_param("reference_date_ms")
        if ref is None:
            import time
            ref = time.time() * 1000.0
        model = DateListVectorizerModel(
            reference_date_ms=float(ref), mode=self.get_param("mode"),
            operation_name=self.operation_name)
        md_cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            md_cols.append(VectorColumnMetadata(
                parent_feature_name=f.name, parent_feature_type=f.type_name,
                descriptor_value=f"days{self.get_param('mode')}"))
            md_cols.append(VectorColumnMetadata(
                parent_feature_name=f.name, parent_feature_type=f.type_name,
                indicator_value=NULL_STRING))
        model.set_metadata(VectorMetadata(name=self.output_name(), columns=md_cols))
        return model
