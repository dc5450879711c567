"""Typed feature value system (reference features/.../types/).

Exports the full FeatureType hierarchy plus factory/default helpers
(reference FeatureTypeFactory.scala / FeatureTypeDefaults.scala /
package.scala implicit conversions).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Type

from .base import (
    Categorical,
    ColumnKind,
    FeatureType,
    Location,
    MultiResponse,
    NonNullable,
    SingleResponse,
)
from .numerics import (
    Binary,
    Currency,
    Date,
    DateTime,
    Integral,
    OPNumeric,
    Percent,
    Real,
    RealNN,
)
from .text import (
    ID,
    URL,
    Base64,
    City,
    ComboBox,
    Country,
    Email,
    Phone,
    PickList,
    PostalCode,
    State,
    Street,
    Text,
    TextArea,
)
from .collections import (
    DateList,
    DateTimeList,
    Geolocation,
    MultiPickList,
    OPCollection,
    OPList,
    OPSet,
    OPVector,
    TextList,
)
from .maps import (
    Base64Map,
    BinaryMap,
    CityMap,
    ComboBoxMap,
    CountryMap,
    CurrencyMap,
    DateMap,
    DateTimeMap,
    EmailMap,
    GeolocationMap,
    IDMap,
    IntegralMap,
    MultiPickListMap,
    NumericMap,
    OPMap,
    PercentMap,
    PhoneMap,
    PickListMap,
    PostalCodeMap,
    Prediction,
    RealMap,
    StateMap,
    StreetMap,
    TextAreaMap,
    TextMap,
    URLMap,
)


def make(type_cls: Type[FeatureType], value: Any) -> FeatureType:
    """Factory: build a feature value of the given type from a raw value
    (reference FeatureTypeFactory.scala)."""
    if isinstance(value, type_cls):
        return value
    return type_cls(value)


def default_of(type_cls: Type[FeatureType]) -> FeatureType:
    """The default (empty) instance of a type
    (reference FeatureTypeDefaults.scala). NonNullable numerics default to 0."""
    if type_cls.is_non_nullable:
        if issubclass(type_cls, Prediction):
            return Prediction(prediction=0.0)
        if issubclass(type_cls, RealNN):
            return RealNN(0.0)
        return type_cls(0)
    return type_cls.empty()


__all__ = [name for name in dir() if not name.startswith("_")]
