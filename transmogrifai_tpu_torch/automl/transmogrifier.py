"""Transmogrifier: automatic per-type default vectorization (counterpart of
automl/transmogrifier.py).

Reference: core/.../impl/feature/Transmogrifier.scala:92 — groups features
by static type and applies each group's default vectorizer, then combines
the group vectors. Defaults mirror TransmogrifierDefaults
(Transmogrifier.scala:52-90). Every group of the JAX package is ported:
numeric, categorical, free text and TextList, dates and date lists,
geolocation, every OPMap subtype, OPVector, and the structured text types
(Email, URL, Base64, Phone), which derive a categorical or binary feature
first.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Type

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
    """Reference Transmogrifier.scala:52-90."""

    default_num_of_features: int = 512
    max_num_of_features: int = 16384
    top_k: int = 20
    min_support: int = 10
    fill_value: float = 0.0
    binary_fill_value: bool = False
    clean_text: bool = True
    clean_keys: bool = False
    fill_with_mode: bool = True
    fill_with_mean: bool = True
    track_nulls: bool = True
    track_invalid: bool = False
    track_text_len: bool = False
    min_doc_frequency: int = 0
    max_categorical_cardinality: int = 30
    reference_date_ms: Optional[int] = None
    circular_date_periods: Tuple[str, ...] = (
        "HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear")


DEFAULTS = TransmogrifierDefaults()

# dispatch order matters: most-specific first (a PickList is a Text).
# Street pivots like a PickList (Transmogrifier.scala:338 — the reference
# ships no smarter Street default either).
_CATEGORICAL_TEXT = (PickList, ComboBox, Country, State, City, PostalCode,
                     ID, Street)


def transmogrify(features: Sequence[Feature],
                 label: Optional[Feature] = None,
                 defaults: TransmogrifierDefaults = DEFAULTS) -> Feature:
    """Vectorize features by type and combine into one OPVector feature
    (reference Transmogrifier.transmogrify:102-348 + .transmogrify() dsl).

    ``label`` is consumed by label-aware vectorizers (the reference's
    decision-tree bucketizers); groups without a label-aware default ignore
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

    out: List[Feature] = []
    for key in order:
        out.append(_vectorize_group(key, groups[key], defaults))
    return out


def _derivations():
    """key -> (derivation transformer, target vectorizer group) for
    structured text types (Transmogrifier.scala:277-340 via
    dsl/RichTextFeature.scala): Email/URL domain pivots
    (RichEmailFeature.vectorize:608, RichURLFeature.vectorize:666 —
    valid-URL domains only), phone validity bits
    (RichPhoneFeature.vectorize:558), Base64 MIME pivots
    (RichBase64Feature.vectorize:711)."""
    from ..transformers.text import (
        EmailToPickList, MimeTypeDetector, PhoneNumberParser,
        UrlToDomainPickList,
    )
    return {"email": (EmailToPickList, "categorical"),
            "url": (UrlToDomainPickList, "categorical"),
            "base64": (MimeTypeDetector, "categorical"),
            "phone": (PhoneNumberParser, "binary")}


def _vectorize_group(key: str, feats: List[Feature],
                     d: TransmogrifierDefaults) -> Feature:
    """Derive-then-vectorize for structured text groups; plain
    per-group default vectorizer otherwise. The derived group reuses
    _vectorizer_for's default for its target group, so categorical/binary
    defaults stay single-sourced."""
    derivation = _derivations().get(key)
    if derivation is not None:
        transformer_cls, target = derivation
        feats = [transformer_cls().set_input(f).get_output() for f in feats]
        key = target
    stage = _vectorizer_for(key, d)
    return stage.set_input(*feats).get_output()


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
    # (Transmogrifier.scala:277-340): domain pivots for Email/URL, phone
    # validity, MIME pivot for Base64 — generic hashing would discard the
    # structure these types declare
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


def _vectorizer_for(key: str, d: TransmogrifierDefaults):
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
    if key == "date":
        from .vectorizers.dates import DateVectorizer
        return DateVectorizer(reference_date_ms=d.reference_date_ms,
                              circular_periods=list(d.circular_date_periods),
                              track_nulls=d.track_nulls)
    if key == "datelist":
        from .vectorizers.dates import DateListVectorizer
        return DateListVectorizer(reference_date_ms=d.reference_date_ms)
    if key == "geolocation":
        from .vectorizers.geo import GeolocationVectorizer
        return GeolocationVectorizer(track_nulls=d.track_nulls)
    if key == "textlist":
        from .vectorizers.text import TextListHashingVectorizer
        return TextListHashingVectorizer(
            num_features=d.default_num_of_features)
    if key == "vector":
        return VectorsCombiner()
    if key.startswith("map_"):
        from .vectorizers.maps import map_vectorizer_for
        return map_vectorizer_for(key[4:], d)
    raise TypeError(f"No vectorizer for group {key}")
