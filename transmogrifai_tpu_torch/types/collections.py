"""Collection feature types: lists, sets, geolocation, and OPVector.

Reference: features/.../types/{Lists.scala:38-64, Sets.scala:38,
Geolocation.scala:47, OPVector.scala:41}.

OPVector is the central type of the compute path: a fixed-width dense float
row. In the reference it wraps a Spark ml Vector; here it wraps a numpy
array — whole OPVector columns ARE the HBM feature matrix.
"""
from __future__ import annotations

import math
from typing import Any, List, Optional, Set, Tuple

import numpy as np

from .base import ColumnKind, FeatureType, Location, MultiResponse


class OPCollection(FeatureType):
    """Base for collection types: empty collection <=> empty value."""

    @property
    def is_empty(self) -> bool:
        return self._value is None or len(self._value) == 0

    @property
    def non_empty(self) -> bool:
        return not self.is_empty


class OPList(OPCollection):
    """Base of list-valued types (reference Lists.scala:38)."""

    @classmethod
    def _convert(cls, value: Any):
        if value is None:
            return []
        if isinstance(value, OPList):
            return list(value.value)
        return list(value)

    @property
    def value(self) -> List:
        return self._value

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


class TextList(OPList):
    """Reference Lists.scala:51."""
    column_kind = ColumnKind.STRING_LIST

    @classmethod
    def _convert(cls, value: Any):
        v = super()._convert(value)
        return [str(x) for x in v]


class DateList(OPList):
    """Epoch-millis list (reference Lists.scala:64)."""
    column_kind = ColumnKind.FLOAT_LIST

    @classmethod
    def _convert(cls, value: Any):
        v = super()._convert(value)
        return [int(x) for x in v]


class DateTimeList(DateList):
    """Reference Lists.scala:77."""


class OPSet(OPCollection):
    """Base of set-valued types (reference Sets.scala:38)."""

    @classmethod
    def _convert(cls, value: Any):
        if value is None:
            return set()
        if isinstance(value, OPSet):
            return set(value.value)
        return set(value)

    @property
    def value(self) -> Set:
        return self._value

    def __len__(self) -> int:
        return len(self._value)

    def __iter__(self):
        return iter(self._value)


class MultiPickList(OPSet, MultiResponse):
    """Categorical multi-select (reference Sets.scala:38)."""
    column_kind = ColumnKind.STRING_SET

    @classmethod
    def _convert(cls, value: Any):
        v = super()._convert(value)
        return {str(x) for x in v}


class Geolocation(OPList, Location):
    """(lat, lon, accuracy) triple (reference Geolocation.scala:47)."""

    column_kind = ColumnKind.GEO

    @classmethod
    def _convert(cls, value: Any):
        if value is None:
            return []
        if isinstance(value, Geolocation):
            return list(value.value)
        v = [float(x) for x in value]
        if len(v) == 0:
            return []
        if len(v) != 3:
            raise ValueError(
                f"Geolocation must have lat, lon, accuracy; got {len(v)} values")
        lat, lon, acc = v
        if not (-90.0 <= lat <= 90.0):
            raise ValueError(f"Latitude out of range: {lat}")
        if not (-180.0 <= lon <= 180.0):
            raise ValueError(f"Longitude out of range: {lon}")
        return [lat, lon, acc]

    @property
    def lat(self) -> Optional[float]:
        return self._value[0] if self.non_empty else None

    @property
    def lon(self) -> Optional[float]:
        return self._value[1] if self.non_empty else None

    @property
    def accuracy(self) -> Optional[float]:
        return self._value[2] if self.non_empty else None

    def to_unit_sphere(self) -> Optional[Tuple[float, float, float]]:
        """3-D unit-sphere embedding used by geo vectorizers so that mean
        imputation stays on the globe."""
        if self.is_empty:
            return None
        lat, lon = math.radians(self._value[0]), math.radians(self._value[1])
        return (math.cos(lat) * math.cos(lon),
                math.cos(lat) * math.sin(lon),
                math.sin(lat))


class OPVector(OPCollection):
    """Fixed-width dense float vector — one row of the device feature matrix
    (reference OPVector.scala:41 wrapping Spark ml Vector)."""

    column_kind = ColumnKind.VECTOR

    @classmethod
    def _convert(cls, value: Any) -> np.ndarray:
        if value is None:
            return np.zeros((0,), dtype=np.float32)
        if isinstance(value, OPVector):
            return value.value
        arr = np.asarray(value, dtype=np.float32)
        if arr.ndim != 1:
            arr = arr.reshape(-1)
        return arr

    @property
    def is_empty(self) -> bool:
        return self._value.size == 0

    def __len__(self) -> int:
        return int(self._value.size)

    def combine(self, *others: "OPVector") -> "OPVector":
        """Concatenate vectors (reference RichVector.combine)."""
        parts = [self._value] + [o.value for o in others]
        return OPVector(np.concatenate(parts))

    def _eq_value(self, other_value: Any) -> bool:
        return (isinstance(other_value, np.ndarray)
                and self._value.shape == other_value.shape
                and bool(np.allclose(self._value, other_value, equal_nan=True)))

    def __hash__(self) -> int:
        return hash((type(self).__name__, self._value.tobytes()))
