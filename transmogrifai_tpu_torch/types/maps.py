"""Map (keyed) feature types + the Prediction type.

Reference: features/.../types/Maps.scala:40-357. Map features carry a dynamic
set of keys per row; vectorizers expand them per-key into fixed columns during
fit (two-phase: key discovery -> static-shape transform).

Prediction (Maps.scala:302) is the reserved-key output type of every model:
key "prediction" plus optional "rawPrediction_*" and "probability_*" keys.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Set

from .base import ColumnKind, FeatureType, Location, MultiResponse, NonNullable, SingleResponse
from .collections import Geolocation


class OPMap(FeatureType):
    """Base of map-valued types: empty map <=> empty value."""

    column_kind = ColumnKind.MAP

    @classmethod
    def _convert(cls, value: Any) -> Dict:
        if value is None:
            return {}
        if isinstance(value, OPMap):
            return dict(value.value)
        return dict(value)

    @property
    def value(self) -> Dict:
        return self._value

    @property
    def is_empty(self) -> bool:
        return len(self._value) == 0

    @property
    def non_empty(self) -> bool:
        return len(self._value) > 0

    def __len__(self) -> int:
        return len(self._value)

    def __contains__(self, key: str) -> bool:
        return key in self._value

    def __getitem__(self, key: str):
        return self._value[key]

    def get(self, key: str, default=None):
        return self._value.get(key, default)

    def keys(self):
        return self._value.keys()

    def __hash__(self) -> int:
        return hash((type(self).__name__, tuple(sorted(self._value.items(),
                                                       key=lambda kv: kv[0]))))


# -- text maps (Maps.scala:40-135) -----------------------------------------
class TextMap(OPMap):
    @classmethod
    def _convert(cls, value: Any) -> Dict[str, str]:
        d = super()._convert(value)
        return {str(k): str(v) for k, v in d.items() if v is not None}


class EmailMap(TextMap): pass
class Base64Map(TextMap): pass
class PhoneMap(TextMap): pass
class IDMap(TextMap): pass
class URLMap(TextMap): pass
class TextAreaMap(TextMap): pass
class PickListMap(TextMap, SingleResponse):
    is_non_nullable = False
class ComboBoxMap(TextMap): pass
class CountryMap(TextMap, Location): pass
class StateMap(TextMap, Location): pass
class CityMap(TextMap, Location): pass
class PostalCodeMap(TextMap, Location): pass
class StreetMap(TextMap, Location): pass


# -- numeric maps (Maps.scala:139-211) -------------------------------------
class NumericMap(OPMap):
    def to_double_map(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self._value.items()}


class BinaryMap(NumericMap, SingleResponse):
    is_non_nullable = False

    @classmethod
    def _convert(cls, value: Any) -> Dict[str, bool]:
        d = OPMap._convert(value)
        return {str(k): bool(v) for k, v in d.items() if v is not None}

    def to_double_map(self) -> Dict[str, float]:
        return {k: (1.0 if v else 0.0) for k, v in self._value.items()}


class IntegralMap(NumericMap):
    @classmethod
    def _convert(cls, value: Any) -> Dict[str, int]:
        d = OPMap._convert(value)
        return {str(k): int(v) for k, v in d.items() if v is not None}


class RealMap(NumericMap):
    @classmethod
    def _convert(cls, value: Any) -> Dict[str, float]:
        d = OPMap._convert(value)
        out = {}
        for k, v in d.items():
            if v is None:
                continue
            f = float(v)
            if not math.isnan(f):
                out[str(k)] = f
        return out


class PercentMap(RealMap): pass
class CurrencyMap(RealMap): pass
class DateMap(IntegralMap): pass
class DateTimeMap(DateMap): pass


class MultiPickListMap(OPMap, MultiResponse):
    @classmethod
    def _convert(cls, value: Any) -> Dict[str, Set[str]]:
        d = OPMap._convert(value)
        return {str(k): {str(x) for x in v} for k, v in d.items() if v is not None}


class GeolocationMap(OPMap, Location):
    @classmethod
    def _convert(cls, value: Any) -> Dict[str, List[float]]:
        d = OPMap._convert(value)
        return {str(k): list(Geolocation(v).value) for k, v in d.items() if v is not None}


# -- Prediction (Maps.scala:302-357) ---------------------------------------
class Prediction(RealMap, NonNullable):
    """Reserved-key model output: 'prediction' (required),
    'rawPrediction_{i}', 'probability_{i}'."""

    is_non_nullable = True

    PREDICTION_NAME = "prediction"
    RAW_PREDICTION_NAME = "rawPrediction"
    PROBABILITY_NAME = "probability"

    def __init__(self, value: Any = None, *, prediction: Optional[float] = None,
                 raw_prediction: Optional[Sequence[float]] = None,
                 probability: Optional[Sequence[float]] = None):
        if value is None and prediction is not None:
            value = {self.PREDICTION_NAME: float(prediction)}
            for i, r in enumerate(raw_prediction if raw_prediction is not None else []):
                value[f"{self.RAW_PREDICTION_NAME}_{i}"] = float(r)
            for i, p in enumerate(probability if probability is not None else []):
                value[f"{self.PROBABILITY_NAME}_{i}"] = float(p)
        super().__init__(value)
        if self.PREDICTION_NAME not in self._value:
            raise ValueError(
                f"Prediction map must contain '{self.PREDICTION_NAME}' key, "
                f"got keys {sorted(self._value)}")

    @property
    def prediction(self) -> float:
        return self._value[self.PREDICTION_NAME]

    def _keys_starting_with(self, prefix: str) -> List[str]:
        ks = [k for k in self._value if k.startswith(prefix + "_")]
        return sorted(ks, key=lambda k: int(k.rsplit("_", 1)[1]))

    @property
    def raw_prediction(self) -> List[float]:
        return [self._value[k] for k in self._keys_starting_with(self.RAW_PREDICTION_NAME)]

    @property
    def probability(self) -> List[float]:
        return [self._value[k] for k in self._keys_starting_with(self.PROBABILITY_NAME)]

    @property
    def score(self) -> List[float]:
        """Probability vector if present else [prediction]
        (reference Maps.scala:346)."""
        prob = self.probability
        return prob if prob else [self.prediction]
