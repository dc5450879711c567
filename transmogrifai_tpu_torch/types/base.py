"""FeatureType hierarchy root.

TPU-native rebuild of the reference's typed feature-value system
(reference: features/src/main/scala/com/salesforce/op/features/types/FeatureType.scala:44).

Design departure from the reference: in the Scala/Spark original a FeatureType
instance wraps ONE row's value and transformers run row-by-row over RDDs. Here
feature *values* are lightweight wrappers used only at the API boundary
(row-level extraction, local scoring, testkit); the compute path is columnar —
each FeatureType class additionally declares its columnar storage spec
(`ColumnSpec`) so whole columns lower to dense arrays in HBM and transforms
compile to XLA programs over them.
"""
from __future__ import annotations

import math
from typing import Any, ClassVar, Dict, Type


class ColumnKind:
    """How a column of this feature type is stored host-side / on device."""

    FLOAT = "float"          # numpy float64 with NaN for missing -> f32 on device
    INT = "int"              # numpy float64 (NaN-able) or int64; lowered to f32/i32
    BOOL = "bool"            # float64 with NaN for missing (0/1)
    STRING = "string"        # host-only object array (tokenized/hashed before device)
    STRING_LIST = "string_list"
    FLOAT_LIST = "float_list"  # ragged host-side; fixed-width on device after vectorize
    STRING_SET = "string_set"
    MAP = "map"              # host-side dict per row; expanded per-key by vectorizers
    VECTOR = "vector"        # fixed-width dense f32 row -> the device feature matrix
    GEO = "geo"              # (lat, lon, accuracy) triple


class FeatureTypeMeta(type):
    """Metaclass keeping a registry of all feature types by name
    (mirrors FeatureType.typeName / isSubtype, reference FeatureType.scala:155,176)."""

    _registry: ClassVar[Dict[str, Type["FeatureType"]]] = {}

    def __new__(mcls, name, bases, ns):
        cls = super().__new__(mcls, name, bases, ns)
        FeatureTypeMeta._registry[name] = cls
        return cls


class FeatureType(metaclass=FeatureTypeMeta):
    """Root of the typed feature value hierarchy.

    Subclasses wrap a single (possibly empty) value. Emptiness is the
    nullability protocol: ``None`` value <=> empty (reference
    FeatureType.scala:62 ``isEmpty``).
    """

    __slots__ = ("_value",)

    # columnar storage spec, overridden per concrete type
    column_kind: ClassVar[str] = ColumnKind.FLOAT
    # True if the type never admits an empty value (RealNN etc.)
    is_non_nullable: ClassVar[bool] = False

    def __init__(self, value: Any = None):
        self._value = self._convert(value)
        if self.is_non_nullable and self._value is None:
            raise ValueError(
                f"{type(self).__name__} cannot be empty (NonNullable)")

    # -- value protocol ----------------------------------------------------
    @property
    def value(self) -> Any:
        return self._value

    @property
    def is_empty(self) -> bool:
        return self._value is None

    @property
    def non_empty(self) -> bool:
        return self._value is not None

    @classmethod
    def _convert(cls, value: Any) -> Any:
        """Coerce a raw python value into canonical stored form; None = empty."""
        return value

    @classmethod
    def coercer(cls):
        """A function of a raw value giving `cls(value).value`: `_convert`
        itself where the wrapper adds nothing to it (the readers' per-cell
        path builds no wrapper then)."""
        if cls.__init__ is FeatureType.__init__ and not cls.is_non_nullable:
            return cls._convert
        return lambda value: cls(value).value

    @classmethod
    def empty(cls) -> "FeatureType":
        return cls(None)

    @classmethod
    def type_name(cls) -> str:
        return cls.__name__

    @classmethod
    def is_subtype_of(cls, other: Type["FeatureType"]) -> bool:
        return issubclass(cls, other)

    @classmethod
    def from_name(cls, name: str) -> Type["FeatureType"]:
        try:
            return FeatureTypeMeta._registry[name]
        except KeyError:
            raise ValueError(f"Unknown feature type name: {name}") from None

    @classmethod
    def all_types(cls) -> Dict[str, Type["FeatureType"]]:
        return dict(FeatureTypeMeta._registry)

    # -- equality / hashing / repr ----------------------------------------
    def __eq__(self, other: Any) -> bool:
        return type(self) is type(other) and self._eq_value(other._value)

    def _eq_value(self, other_value: Any) -> bool:
        v = self._value
        if isinstance(v, float) and isinstance(other_value, float):
            if math.isnan(v) and math.isnan(other_value):
                return True
        return v == other_value

    def __hash__(self) -> int:
        v = self._value
        if isinstance(v, (dict, list, set)):
            return hash((type(self).__name__, repr(sorted(str(x) for x in v))))
        return hash((type(self).__name__, v))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._value!r})"

    def __bool__(self) -> bool:
        return self.non_empty


# -- marker traits (reference FeatureType.scala:122-150) -------------------
class NonNullable(FeatureType):
    """Types that may never be empty."""
    is_non_nullable = True


class Categorical(FeatureType):
    """Marker: categorical-valued (drives contingency-table stats)."""


class Location(FeatureType):
    """Marker: location-valued (geo handling)."""


class SingleResponse(NonNullable):
    """Marker: usable as single-response label."""


class MultiResponse(FeatureType):
    """Marker: usable as multi-response label."""
