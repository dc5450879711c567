"""Numeric feature types.

Reference: features/.../types/Numerics.scala:40-133 (Real, RealNN, Binary,
Integral, Percent, Currency, Date, DateTime).
"""
from __future__ import annotations

import math
from typing import Any, Optional

from .base import ColumnKind, FeatureType, SingleResponse


class OPNumeric(FeatureType):
    """Base for numeric value types."""

    column_kind = ColumnKind.FLOAT

    def to_double(self) -> Optional[float]:
        v = self.value
        if v is None:
            return None
        if isinstance(v, bool):
            return 1.0 if v else 0.0
        return float(v)


class Real(OPNumeric):
    """Optional real value (reference Numerics.scala:40)."""

    @classmethod
    def _convert(cls, value: Any) -> Optional[float]:
        if value is None:
            return None
        if isinstance(value, Real):
            return value.value
        if isinstance(value, bool):
            return 1.0 if value else 0.0
        v = float(value)
        if math.isnan(v):
            return None
        return v


class RealNN(Real, SingleResponse):
    """Non-nullable real — the required label/response type
    (reference Numerics.scala:59)."""
    is_non_nullable = True


class Binary(OPNumeric, SingleResponse):
    """Optional boolean (reference Numerics.scala:73)."""

    column_kind = ColumnKind.BOOL
    is_non_nullable = False

    @classmethod
    def _convert(cls, value: Any) -> Optional[bool]:
        if value is None:
            return None
        if isinstance(value, Binary):
            return value.value
        if isinstance(value, float) and math.isnan(value):
            return None
        return bool(value)

    def to_double(self) -> Optional[float]:
        v = self.value
        return None if v is None else (1.0 if v else 0.0)


class Integral(OPNumeric):
    """Optional integer (reference Numerics.scala:90)."""

    column_kind = ColumnKind.INT

    @classmethod
    def _convert(cls, value: Any) -> Optional[int]:
        if value is None:
            return None
        if isinstance(value, Integral):
            return value.value
        if isinstance(value, float):
            if math.isnan(value):
                return None
            return int(value)
        return int(value)


class Percent(Real):
    """Reference Numerics.scala:105."""


class Currency(Real):
    """Reference Numerics.scala:119."""


class Date(Integral):
    """Epoch-millis date (reference Numerics.scala:133)."""


class DateTime(Date):
    """Epoch-millis datetime (reference Numerics.scala:147)."""
