"""Rich feature syntax: the reference's dsl implicits as Feature methods
(counterpart of dsl.py).

Reference: core/.../dsl/ (`Rich{Numeric,Text,Date,List,Map,Vector}Feature`
add `feature.tokenize()`, `f1 + f2`, `.pivot()`, `.sanityCheck()`,
`.transmogrify()` to features by implicit conversion). The methods are
installed on Feature when this module is imported (the package __init__
imports it), so ``fare + age``, ``age.fill_missing_with_mean()`` and
``features.transmogrify()`` read as in the Scala dsl.

Every name of the JAX package's dsl is installed, each building the port's
counterpart of its stage.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from .features.feature import Feature
from .types import Binary, OPMap, Prediction, RealNN, OPVector

# -- arithmetic (RichNumericFeature) ----------------------------------------


def _binary_op(self: Feature, other: Any, cls_scalar, cls_feature):
    if isinstance(other, Feature):
        return cls_feature().set_input(self, other).get_output()
    return cls_scalar(scalar=float(other)).set_input(self).get_output()


def _add(self, other):
    from .transformers.math import AddTransformer, ScalarAddTransformer
    return _binary_op(self, other, ScalarAddTransformer, AddTransformer)


def _sub(self, other):
    from .transformers.math import (ScalarSubtractTransformer,
                                    SubtractTransformer)
    return _binary_op(self, other, ScalarSubtractTransformer,
                      SubtractTransformer)


def _mul(self, other):
    from .transformers.math import (MultiplyTransformer,
                                    ScalarMultiplyTransformer)
    return _binary_op(self, other, ScalarMultiplyTransformer,
                      MultiplyTransformer)


def _div(self, other):
    from .transformers.math import DivideTransformer, ScalarDivideTransformer
    return _binary_op(self, other, ScalarDivideTransformer, DivideTransformer)


def _unary(self: Feature, cls, **kw):
    return cls(**kw).set_input(self).get_output()


def _abs(self):
    from .transformers.math import AbsTransformer
    return _unary(self, AbsTransformer)


def _log(self, base: float = 2.718281828459045):
    from .transformers.math import LogTransformer
    return _unary(self, LogTransformer, base=base)


def _exp(self):
    from .transformers.math import ExpTransformer
    return _unary(self, ExpTransformer)


def _sqrt(self):
    from .transformers.math import SqrtTransformer
    return _unary(self, SqrtTransformer)


def _round(self):
    from .transformers.math import RoundTransformer
    return _unary(self, RoundTransformer)


def _ceil(self):
    from .transformers.math import CeilTransformer
    return _unary(self, CeilTransformer)


def _floor(self):
    from .transformers.math import FloorTransformer
    return _unary(self, FloorTransformer)


def _power(self, p: float):
    from .transformers.math import PowerTransformer
    return _unary(self, PowerTransformer, exponent=p)


def _z_normalize(self):
    """Z-score scaling fit on the data (RichNumericFeature.zNormalize)."""
    from .transformers.math import ZNormalizeEstimator
    return ZNormalizeEstimator().set_input(self).get_output()


# -- misc (RichFeature) ------------------------------------------------------

def _alias(self, name: str):
    from .transformers.misc import AliasTransformer
    return _unary(self, AliasTransformer, name=name)


def _to_occur(self):
    from .transformers.misc import ToOccurTransformer
    return _unary(self, ToOccurTransformer)


def _fill_missing_with_mean(self):
    from .transformers.misc import FillMissingWithMean
    return _unary(self, FillMissingWithMean)


def _scale(self, scaling_type: str = "linear", slope: float = 1.0,
           intercept: float = 0.0):
    from .transformers.misc import ScalerTransformer
    return _unary(self, ScalerTransformer, scaling_type=scaling_type,
                  slope=slope, intercept=intercept)


def _autobucketize(self, label: Feature, max_splits: int = 15,
                   min_info_gain: float = 0.01):
    from .transformers.misc import DecisionTreeNumericBucketizer
    stage = DecisionTreeNumericBucketizer(max_splits=max_splits,
                                          min_info_gain=min_info_gain)
    return stage.set_input(label, self).get_output()


def _calibrate_percentile(self, buckets: int = 100):
    from .transformers.misc import PercentileCalibrator
    return _unary(self, PercentileCalibrator, buckets=buckets)


def _bucketize(self, splits=None, num_buckets: int = 4,
               track_nulls: bool = True):
    """Fixed-split or quantile buckets (RichNumericFeature.bucketize)."""
    from .automl.vectorizers.numeric import NumericBucketizer
    given = None if splits is None else [list(splits)]
    return NumericBucketizer(splits=given, num_buckets=num_buckets,
                             track_nulls=track_nulls) \
        .set_input(self).get_output()


def _replace_with(self, old_value, new_value):
    """Swap one raw value for another (RichFeature.replaceWith:75)."""
    from .transformers.misc import ReplaceWithTransformer
    return ReplaceWithTransformer(old_value=old_value, new_value=new_value) \
        .set_input(self).get_output()


def _drop_indices_by(self, predicate):
    """Drop vector columns whose metadata matches `predicate`
    (RichVectorFeature.dropIndicesBy)."""
    from .transformers.misc import DropIndicesByTransformer
    return DropIndicesByTransformer(predicate=predicate) \
        .set_input(self).get_output()


def _descale(self, scaled_source: Feature, scaler=None):
    """Invert a ScalerTransformer's scaling (RichNumericFeature.descale); a
    Prediction input descales its prediction value
    (RichPredictionFeature.descale:1113)."""
    from .transformers.misc import DescalerTransformer
    target = self
    if issubclass(self.feature_type, Prediction):
        target = _map_feature(self, lambda p: p.prediction, RealNN,
                              operation_name="predictionValue")
    return DescalerTransformer(scaler=scaler) \
        .set_input(target, scaled_source).get_output()


# -- lambda stages (RichFeature.map / exists / filter / collect) -------------
# A lambda stage runs its python function row by row on the host.

def _map_values(self, fn, output_type=None, operation_name: str = "map"):
    """Apply a python function per raw value (RichFeature.map:61)."""
    from .stages.base import LambdaTransformer
    out_t = output_type or self.feature_type
    return LambdaTransformer(
        operation_name,
        lambda v, _f=fn, _t=out_t: _t(_f(v.value)),
        (self.feature_type,), out_t).set_input(self).get_output()


def _map_feature(self, fn, output_type, operation_name: str = "map"):
    """Arbitrary row-level transform (RichFeature.map): `fn` takes and
    returns FeatureType instances."""
    from .stages.base import LambdaTransformer
    stage = LambdaTransformer(operation_name, fn,
                              input_types=(self.feature_type,),
                              output_type=output_type)
    return stage.set_input(self).get_output()


def _exists(self, pred, operation_name: str = "exists"):
    """Binary: the predicate holds for the raw value (RichFeature.exists:176)."""
    from .stages.base import LambdaTransformer
    return LambdaTransformer(
        operation_name,
        lambda v, _p=pred: Binary(None if v.value is None else
                                  bool(_p(v.value))),
        (self.feature_type,), Binary).set_input(self).get_output()


def _filter_values(self, pred, default, operation_name: str = "filter"):
    """Keep values passing the predicate, else the default
    (RichFeature.filter:134)."""
    from .stages.base import LambdaTransformer
    t = self.feature_type
    return LambdaTransformer(
        operation_name,
        lambda v, _p=pred, _d=default, _t=t: (
            v if (v.value is not None and _p(v.value)) else _t(_d)),
        (t,), t).set_input(self).get_output()


def _filter_not(self, pred, default, operation_name: str = "filterNot"):
    """Complement of filter_values (RichFeature.filterNot:148)."""
    return _filter_values(self, lambda v, _p=pred: not _p(v), default,
                          operation_name=operation_name)


def _collect(self, fn, default, output_type=None,
             operation_name: str = "collect"):
    """Partial map: `fn` returns None where undefined, replaced by
    `default` (RichFeature.collect:160)."""
    from .stages.base import LambdaTransformer
    out_t = output_type or self.feature_type

    def apply(v, _f=fn, _t=out_t, _d=default):
        r = None if v.value is None else _f(v.value)
        return _t(_d if r is None else r)

    return LambdaTransformer(operation_name, apply, (self.feature_type,),
                             out_t).set_input(self).get_output()


def _tupled(self):
    """Prediction -> (prediction RealNN, rawPrediction OPVector,
    probability OPVector) (RichPredictionFeature.tupled:1098)."""
    pred = _map_feature(self, lambda p: p.prediction, RealNN,
                        operation_name="predictionValue")
    raw = _map_feature(self, lambda p: p.raw_prediction, OPVector,
                       operation_name="rawPrediction")
    prob = _map_feature(self, lambda p: p.probability, OPVector,
                        operation_name="probability")
    return pred, raw, prob


# -- text (RichTextFeature, RichListFeature) ---------------------------------

def _tokenize(self, min_token_length: int = 1, to_lowercase: bool = True,
              filter_stopwords: bool = False):
    from .transformers.text import TextTokenizer
    return _unary(self, TextTokenizer, min_token_length=min_token_length,
                  to_lowercase=to_lowercase,
                  filter_stopwords=filter_stopwords)


def _text_len(self):
    from .transformers.text import TextLenTransformer
    return _unary(self, TextLenTransformer)


def _detect_languages(self):
    from .transformers.text import LangDetector
    return _unary(self, LangDetector)


def _to_multi_pick_list(self):
    from .transformers.text import TextToMultiPickList
    return _unary(self, TextToMultiPickList)


def _is_substring(self, other: Feature):
    """Binary: is this text contained in `other` (RichTextFeature
    .isSubstring)."""
    from .transformers.text import SubstringTransformer
    return SubstringTransformer().set_input(self, other).get_output()


def _tokenize_regex(self, pattern: str = r"\w+", to_lowercase: bool = True,
                    min_token_length: int = 1):
    from .transformers.text import RegexTokenizer
    return _unary(self, RegexTokenizer, pattern=pattern,
                  to_lowercase=to_lowercase,
                  min_token_length=min_token_length)


def _remove_stop_words(self):
    from .transformers.text import StopWordsRemover
    return _unary(self, StopWordsRemover)


def _ngram(self, n: int = 2):
    from .transformers.text import NGramTransformer
    return _unary(self, NGramTransformer, n=n)


def _index_string(self, handle_invalid: str = "keep"):
    from .transformers.text import OpStringIndexer
    return _unary(self, OpStringIndexer, handle_invalid=handle_invalid)


def _deindexed(self, labels: Sequence[str]):
    """Index -> original string label (RichNumericFeature.deindexed:418
    via OpIndexToString). `labels` is the indexer's fitted vocabulary —
    required here because, unlike Spark, no column metadata carries it."""
    if not labels:
        raise ValueError("deindexed() needs the fitted label vocabulary "
                         "(the paired OpStringIndexer's ordering)")
    from .transformers.text import OpIndexToString
    return OpIndexToString(labels=list(labels)).set_input(self).get_output()


def _count_vectorize(self, vocab_size: int = 512, min_df: int = 1,
                     binary: bool = False):
    from .transformers.text import OpCountVectorizer
    return _unary(self, OpCountVectorizer, vocab_size=vocab_size,
                  min_df=min_df, binary=binary)


def _tf_idf(self, vocab_size: int = 512, min_df: int = 1):
    from .transformers.text import TfIdfVectorizer
    return _unary(self, TfIdfVectorizer, vocab_size=vocab_size, min_df=min_df)


def _idf(self, min_doc_freq: int = 0):
    """Inverse-document-frequency rescaling of a count vector
    (RichVectorFeature.idf:56)."""
    from .transformers.text import OpIDF
    return _unary(self, OpIDF, min_doc_freq=min_doc_freq)


def _lda(self, k: int = 10, max_iter: int = 50, seed: int = 42):
    from .transformers.topics import OpLDA
    return _unary(self, OpLDA, k=k, max_iter=max_iter, seed=seed)


def _word2vec(self, vector_size: int = 100, vocab_bins: int = 2048,
              window_size: int = 5, seed: int = 42):
    from .transformers.topics import OpWord2Vec
    return _unary(self, OpWord2Vec, vector_size=vector_size,
                  vocab_bins=vocab_bins, window_size=window_size, seed=seed)


def _recognize_entities(self):
    from .transformers.ner import NameEntityRecognizer
    return _unary(self, NameEntityRecognizer)


def _ngram_similarity(self, other: Feature, n: int = 3):
    from .transformers.text import NGramSimilarity
    return NGramSimilarity(n=n).set_input(self, other).get_output()


def _jaccard_similarity(self, other: Feature):
    from .transformers.text import JaccardSimilarity
    return JaccardSimilarity().set_input(self, other).get_output()


def _tf(self, num_features: int = 512):
    """Hashed term frequencies (RichListFeature.tf via HashingTF)."""
    from .automl.vectorizers.text import TextListHashingVectorizer
    return TextListHashingVectorizer(num_features=num_features) \
        .set_input(self).get_output()


def _smart_vectorize(self, *others, **kwargs):
    """Cardinality-adaptive text vectorization (RichTextFeature
    .smartVectorize:223 -> SmartTextVectorizer); text-map inputs route
    through the key-discovering map vectorizer, whose 'smarttext' kind is
    the SmartTextMapVectorizer equivalent (RichMapFeature:280,425)."""
    if issubclass(self.feature_type, OPMap):
        from .automl.vectorizers.maps import MapVectorizer
        return MapVectorizer(**kwargs).set_input(self, *others).get_output()
    from .automl.vectorizers.text import SmartTextVectorizer
    return SmartTextVectorizer(**kwargs).set_input(self, *others) \
        .get_output()


# -- structured text (RichEmailFeature, RichURLFeature, RichPhoneFeature,
# RichBase64Feature) ----------------------------------------------------------

def _email_domain(self):
    from .transformers.text import EmailToPickList
    return _unary(self, EmailToPickList)


def _is_valid_email(self):
    from .transformers.text import ValidEmailTransformer
    return _unary(self, ValidEmailTransformer)


def _email_prefix(self):
    from .transformers.text import EmailPrefixTransformer
    return _unary(self, EmailPrefixTransformer)


def _url_domain(self):
    from .transformers.text import UrlPartsTransformer
    return _unary(self, UrlPartsTransformer, part="domain")


def _url_protocol(self):
    from .transformers.text import UrlPartsTransformer
    return _unary(self, UrlPartsTransformer, part="protocol")


def _is_valid_url(self, protocols=None):
    from .transformers.text import ValidUrlTransformer
    stage = ValidUrlTransformer()
    if protocols is not None:
        stage.set_param("protocols", list(protocols))
    return stage.set_input(self).get_output()


def _detect_mime_types(self):
    from .transformers.text import MimeTypeDetector
    return _unary(self, MimeTypeDetector)


def _is_valid_phone(self, default_region: str = "US"):
    from .transformers.text import PhoneNumberParser
    return _unary(self, PhoneNumberParser, default_region=default_region)


def _parse_phone(self, default_region: str = "US"):
    """Normalized E.164 text (RichTextFeature.parsePhone:464 /
    parsePhoneDefaultCountry:489)."""
    from .transformers.text import PhoneParser
    return _unary(self, PhoneParser, default_region=default_region)


# -- dates (RichDateFeature) -------------------------------------------------

def _to_unit_circle(self, time_period: str = "HourOfDay", **kwargs):
    """Date -> [sin, cos] of a calendar period (RichDateFeature
    .toUnitCircle:68); DateMap/DateTimeMap inputs take the per-key map
    route (RichMapFeature.toUnitCircle:716)."""
    if issubclass(self.feature_type, OPMap):
        return _to_unit_circle_map(self, time_period=time_period, **kwargs)
    from .transformers.misc import DateToUnitCircleTransformer
    return _unary(self, DateToUnitCircleTransformer, time_period=time_period)


def _to_unit_circle_map(self, time_period: str = "HourOfDay",
                        clean_keys: bool = False,
                        allow_listed_keys=None, block_listed_keys=None):
    """DateMap -> per-key [sin, cos] unit-circle vector (RichMapFeature
    .toUnitCircle:716 -> DateMapToUnitCircleVectorizer)."""
    from .automl.vectorizers.maps import DateMapUnitCircleVectorizer
    return DateMapUnitCircleVectorizer(
        time_period=time_period, clean_keys=clean_keys,
        allow_listed_keys=allow_listed_keys,
        block_listed_keys=block_listed_keys).set_input(self).get_output()


def _to_date_list(self):
    """Date -> DateList / DateTime -> DateTimeList (RichDateFeature
    .toDateList:54)."""
    from .transformers.misc import DateToListTransformer
    return _unary(self, DateToListTransformer)


def _vectorize_dates(self, *others, **kwargs):
    """Date features -> circular-encoded vector (RichDateFeature
    .vectorize:97)."""
    from .automl.vectorizers.dates import DateVectorizer
    return DateVectorizer(**kwargs).set_input(self, *others).get_output()


# -- maps and geolocation (RichMapFeature, RichLocationFeature) --------------

def _filter_keys(self, allow: Optional[Sequence[str]] = None,
                 block: Optional[Sequence[str]] = None):
    """Keep/drop map keys (RichMapFeature.filter:58 whiteList/blackList)."""
    from .transformers.misc import FilterMapKeys
    return FilterMapKeys(allow=allow, block=block) \
        .set_input(self).get_output()


def _vectorize_map(self, *others, **kwargs):
    """Per-key map vectorization dispatched on the map's type
    (RichMapFeature.vectorize overloads)."""
    from .automl.transmogrifier import TransmogrifierDefaults
    from .automl.vectorizers.maps import map_vectorizer_for
    stage = map_vectorizer_for(self.type_name, TransmogrifierDefaults)
    for k, v in kwargs.items():
        stage.set_param(k, v)
    return stage.set_input(self, *others).get_output()


def _autobucketize_map(self, label: Feature, **kwargs):
    """Label-aware bucketization of every numeric map key
    (RichMapFeature.autoBucketize:542 ->
    DecisionTreeNumericMapBucketizer)."""
    from .transformers.misc import DecisionTreeNumericMapBucketizer
    return DecisionTreeNumericMapBucketizer(**kwargs) \
        .set_input(label, self).get_output()


def _is_valid_phone_map(self, default_region: str = "US"):
    """Per-key phone validity (RichMapFeature
    .isValidPhoneDefaultCountryMap)."""
    from .transformers.misc import PhoneValidityMap
    return _unary(self, PhoneValidityMap, default_region=default_region)


def _detect_mime_types_map(self):
    """Per-key MIME detection on Base64 maps (RichMapFeature
    .detectMimeTypes)."""
    from .transformers.misc import MimeTypeMap
    return _unary(self, MimeTypeMap)


def _vectorize_geo(self, *others, **kwargs):
    """Geolocation -> mean-imputed (lat, lon, acc) block
    (RichLocationFeature.vectorize:63)."""
    from .automl.vectorizers.geo import GeolocationVectorizer
    return GeolocationVectorizer(**kwargs).set_input(self, *others) \
        .get_output()


# -- vectors, selection (RichVectorFeature, RichFeaturesCollection) ----------

def _combine_with(self, *others):
    """Concatenate OPVector features (RichVectorFeature combine)."""
    from .automl.vectorizers.combiner import VectorsCombiner
    return VectorsCombiner().set_input(self, *others).get_output()


def _vectorize(self, **kwargs):
    from .automl.transmogrifier import transmogrify as tm
    return tm([self], **kwargs)


def _pivot(self, top_k: int = 20):
    from .automl.vectorizers.categorical import OneHotVectorizer
    return OneHotVectorizer(top_k=top_k).set_input(self).get_output()


def _sanity_check(self, label: Feature, **kwargs):
    from .automl.preparators import SanityChecker
    return SanityChecker(**kwargs).set_input(label, self).get_output()


def _loco_insights(self, model, top_k: int = 20):
    """Per-row top-K leave-one-column-out deltas of a fitted model over this
    vector (RichVectorFeature via RecordInsightsLOCO)."""
    from .insights import RecordInsightsLOCO
    return RecordInsightsLOCO(model=model, top_k=top_k) \
        .set_input(self).get_output()


def _to_isotonic_calibrated(self, label: Feature, isotonic: bool = True):
    """Calibrate a score against a label by isotonic regression
    (RichNumericFeature.toIsotonicCalibrated)."""
    from .models.mlp import IsotonicRegressionCalibrator
    return IsotonicRegressionCalibrator(isotonic=isotonic) \
        .set_input(label, self).get_output()


def _random_forest_vec(self, label: Feature, **params):
    """Fit a random-forest classifier on (label, vector) and emit the
    Prediction feature (RichVectorFeature.randomForest:77)."""
    from .models.trees import OpRandomForestClassifier
    return OpRandomForestClassifier(**params) \
        .set_input(label, self).get_output()


def install() -> None:
    """Install the dsl methods on Feature (idempotent)."""
    ops = {
        "__add__": _add, "__radd__": _add, "__sub__": _sub,
        "__mul__": _mul, "__rmul__": _mul, "__truediv__": _div,
        "abs": _abs, "log": _log, "exp": _exp, "sqrt": _sqrt,
        "round": _round, "ceil": _ceil, "floor": _floor, "power": _power,
        "alias": _alias, "to_occur": _to_occur,
        "fill_missing_with_mean": _fill_missing_with_mean, "scale": _scale,
        "autobucketize": _autobucketize,
        "calibrate_percentile": _calibrate_percentile,
        "tokenize": _tokenize,
        "vectorize": _vectorize, "pivot": _pivot,
        "sanity_check": _sanity_check, "loco_insights": _loco_insights,
        "tupled": _tupled,
        "combine_with": _combine_with, "descale": _descale,
        "map_values": _map_values, "replace_with": _replace_with,
        "exists": _exists, "filter_values": _filter_values,
        "bucketize": _bucketize, "z_normalize": _z_normalize,
        "to_isotonic_calibrated": _to_isotonic_calibrated,
        "tf": _tf, "drop_indices_by": _drop_indices_by,
        "map": _map_feature, "filter_not": _filter_not,
        "collect": _collect, "random_forest": _random_forest_vec,
        "smart_vectorize": _smart_vectorize,
        "email_domain": _email_domain, "is_valid_email": _is_valid_email,
        "email_prefix": _email_prefix, "url_domain": _url_domain,
        "url_protocol": _url_protocol, "is_valid_url": _is_valid_url,
        "detect_mime_types": _detect_mime_types,
        "is_valid_phone": _is_valid_phone, "parse_phone": _parse_phone,
        "to_unit_circle": _to_unit_circle,
        "to_unit_circle_map": _to_unit_circle_map,
        "to_date_list": _to_date_list,
        "to_date_time_list": _to_date_list,  # DateTime in -> DateTimeList
        "vectorize_dates": _vectorize_dates,
        "filter_keys": _filter_keys, "vectorize_map": _vectorize_map,
        "autobucketize_map": _autobucketize_map,
        "is_valid_phone_map": _is_valid_phone_map,
        "detect_mime_types_map": _detect_mime_types_map,
        "vectorize_geo": _vectorize_geo,
        "auto_transform": _vectorize,  # RichFeaturesCollection alias
        "text_len": _text_len, "detect_languages": _detect_languages,
        "index_string": _index_string, "count_vectorize": _count_vectorize,
        "tf_idf": _tf_idf, "lda": _lda, "word2vec": _word2vec,
        "recognize_entities": _recognize_entities,
        "ngram_similarity": _ngram_similarity,
        "jaccard_similarity": _jaccard_similarity,
        "to_multi_pick_list": _to_multi_pick_list,
        "is_substring": _is_substring, "tokenize_regex": _tokenize_regex,
        "remove_stop_words": _remove_stop_words, "ngram": _ngram,
        "deindexed": _deindexed, "idf": _idf,
    }
    for name, fn in ops.items():
        setattr(Feature, name, fn)


def transmogrify(features: Sequence[Feature], **kwargs):
    """Module-level shortcut mirroring RichFeaturesCollection.transmogrify."""
    from .automl.transmogrifier import transmogrify as tm
    return tm(list(features), **kwargs)


def combine(features: Sequence[Feature]):
    """Concatenate OPVector features into one (RichFeaturesCollection
    .combine:76 -> VectorsCombiner)."""
    from .automl.vectorizers.combiner import VectorsCombiner
    return VectorsCombiner().set_input(*list(features)).get_output()


install()
