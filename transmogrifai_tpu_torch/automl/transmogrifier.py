"""Transmogrifier: automatic per-type default vectorization (counterpart of
automl/transmogrifier.py).

Reference: core/.../impl/feature/Transmogrifier.scala:92 — groups features
by static type and applies each group's default vectorizer, then combines
the group vectors. Defaults mirror TransmogrifierDefaults
(Transmogrifier.scala:52-90). The port has the numeric groups (Real,
Integral, Binary, RealNN), the categorical pivots (PickList-like text and
MultiPickList), free text (Text, TextArea: SmartTextVectorizer), TextList
hashing and OPVector combining; every other group (the structured text
types Email, Phone, URL and Base64, dates, geolocation, maps) raises
NotImplementedError naming the feature type.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Type

from ..features.feature import Feature
from ..types import (
    Base64, Binary, City, ComboBox, Country, Date, DateList, DateTime, Email,
    FeatureType, Geolocation, ID, Integral, MultiPickList, OPMap, OPVector,
    Phone, PickList, PostalCode, Real, RealNN, State, Street, Text, TextArea,
    TextList, URL,
)
from .vectorizers.categorical import OneHotVectorizer
from .vectorizers.combiner import VectorsCombiner
from .vectorizers.numeric import (
    BinaryVectorizer, IntegralVectorizer, NumericVectorizer, RealNNVectorizer,
)


@dataclass
class TransmogrifierDefaults:
    """Reference Transmogrifier.scala:52-90: the defaults the ported groups
    read (the date and map groups' defaults come with them)."""

    default_num_of_features: int = 512
    max_categorical_cardinality: int = 30
    top_k: int = 20
    min_support: int = 10
    fill_value: float = 0.0
    binary_fill_value: bool = False
    clean_text: bool = True
    fill_with_mode: bool = True
    fill_with_mean: bool = True
    track_nulls: bool = True


DEFAULTS = TransmogrifierDefaults()

# dispatch order matters: most-specific first (a PickList is a Text).
# Street pivots like a PickList (Transmogrifier.scala:338).
_CATEGORICAL_TEXT = (PickList, ComboBox, Country, State, City, PostalCode,
                     ID, Street)


def transmogrify(features: Sequence[Feature],
                 label: Optional[Feature] = None,
                 defaults: TransmogrifierDefaults = DEFAULTS) -> Feature:
    """Vectorize features by type and combine into one OPVector feature
    (reference Transmogrifier.transmogrify:102-348 + .transmogrify() dsl).

    ``label`` is consumed by label-aware vectorizers (the reference's
    decision-tree bucketizers, not ported yet); the ported groups ignore
    it, matching the reference when no response is in scope."""
    vector_feats = vectorize_by_type(features, label=label, defaults=defaults)
    if len(vector_feats) == 1:
        return vector_feats[0]
    combiner = VectorsCombiner()
    return combiner.set_input(*vector_feats).get_output()


def vectorize_by_type(features: Sequence[Feature],
                      label: Optional[Feature] = None,
                      defaults: TransmogrifierDefaults = DEFAULTS
                      ) -> List[Feature]:
    """One vectorizer per type group; returns the group vector features."""
    groups: Dict[str, List[Feature]] = {}
    order: List[str] = []
    for f in features:
        key = _group_key(f.feature_type)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(f)
    return [_vectorizer_for(key, defaults, groups[key])
            .set_input(*groups[key]).get_output() for key in order]


def _group_key(t: Type[FeatureType]) -> str:
    if issubclass(t, RealNN):
        return "realnn"
    if issubclass(t, Binary):
        return "binary"
    if issubclass(t, (Date, DateTime)) and issubclass(t, Integral):
        return "date"
    if issubclass(t, Integral):
        return "integral"
    if issubclass(t, Real):  # Real, Percent, Currency
        return "real"
    if issubclass(t, MultiPickList):
        return "multipicklist"
    if issubclass(t, _CATEGORICAL_TEXT):
        return "categorical"
    # structured text types get derivation-then-vectorize defaults
    # (Transmogrifier.scala:277-340)
    if issubclass(t, Email):
        return "email"
    if issubclass(t, Phone):
        return "phone"
    if issubclass(t, URL):
        return "url"
    if issubclass(t, Base64):
        return "base64"
    if issubclass(t, (TextArea, Text)):
        return "text"
    if issubclass(t, TextList):
        return "textlist"
    if issubclass(t, DateList):
        return "datelist"
    if issubclass(t, Geolocation):
        return "geolocation"
    if issubclass(t, OPVector):
        return "vector"
    if issubclass(t, OPMap):
        return f"map_{t.__name__}"
    raise TypeError(f"No default vectorizer for feature type {t.__name__}")


def _vectorizer_for(key: str, d: TransmogrifierDefaults,
                    feats: Sequence[Feature] = ()):
    if key == "realnn":
        return RealNNVectorizer()
    if key == "real":
        return NumericVectorizer(
            fill_mode="mean" if d.fill_with_mean else "constant",
            fill_value=d.fill_value, track_nulls=d.track_nulls)
    if key == "integral":
        return IntegralVectorizer(
            fill_mode="mode" if d.fill_with_mode else "constant",
            track_nulls=d.track_nulls)
    if key == "binary":
        return BinaryVectorizer(fill_value=float(d.binary_fill_value),
                                track_nulls=d.track_nulls)
    if key == "categorical":
        return OneHotVectorizer(top_k=d.top_k, min_support=d.min_support,
                                clean_text=d.clean_text,
                                track_nulls=d.track_nulls)
    if key == "multipicklist":
        return OneHotVectorizer(multiset=True, top_k=d.top_k,
                                min_support=d.min_support,
                                clean_text=d.clean_text,
                                track_nulls=d.track_nulls)
    if key == "text":
        from .vectorizers.text import SmartTextVectorizer
        return SmartTextVectorizer(
            max_cardinality=d.max_categorical_cardinality,
            num_features=d.default_num_of_features, top_k=d.top_k,
            min_support=d.min_support, track_nulls=d.track_nulls)
    if key == "textlist":
        from .vectorizers.text import TextListHashingVectorizer
        return TextListHashingVectorizer(
            num_features=d.default_num_of_features)
    if key == "vector":
        return VectorsCombiner()
    named = ", ".join(f"{f.name} ({f.type_name})" for f in feats) or key
    raise NotImplementedError(
        f"the default vectorizer of the '{key}' group is not ported yet: "
        f"cannot transmogrify {named}; the port vectorizes Real, "
        "Integral, Binary, RealNN, PickList-like text, MultiPickList, "
        "Text, TextArea, TextList and OPVector features")
