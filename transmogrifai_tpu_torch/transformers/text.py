"""Text-processing transformers: the analyzers, n-grams and similarities,
string indexers, count / TF-IDF / IDF vectors, language, MIME and phone
detection and the structured text derivations of Email and URL
(counterpart of transformers/text.py).

Reference: core/.../impl/feature/{TextTokenizer(196), NGramSimilarity,
JaccardSimilarity, OpCountVectorizer, TextLenTransformer,
SubstringTransformer, OpStringIndexer, OpIndexToString, LangDetector,
MimeTypeDetector, PhoneNumberParser(566)}.scala and the dsl's
RichTextFeature, RichEmailFeature, RichURLFeature and RichVectorFeature.
Parsing stays on the host: strings never reach the device. The reference
leaned on Lucene, Optimaize, Tika and libphonenumber (all JVM); these are
the JAX package's self-contained re-implementations of the behaviours the
AutoML pipeline consumes, copied with their tables.
"""
from __future__ import annotations

import base64 as b64mod
import json
import math
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Column
from ..stages.base import Estimator, Transformer
from ..stages.params import Param
from ..types import (URL, Binary, ColumnKind, Email, Integral,
                     MultiPickList, OPVector, PickList, RealNN, Text,
                     TextList)

# token = maximal run of unicode alphanumerics or apostrophes (underscore
# is a separator). For pure-ASCII text this is the [A-Za-z0-9'] rule;
# non-ASCII text keeps unicode tokens, as Lucene's standard analyzer does.
# The JAX package matches (?:[^\W_]|')+; with every underscore made a space
# first, the one character class [\w'] gives the same runs, 2-3x faster.
_TOKEN_RE = re.compile(r"[\w']+")
_STOPWORDS = {
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "if",
    "in", "into", "is", "it", "no", "not", "of", "on", "or", "such", "that",
    "the", "their", "then", "there", "these", "they", "this", "to", "was",
    "will", "with",
}


def tokenize_text(value: Optional[str], min_token_length: int = 1,
                  to_lowercase: bool = True,
                  filter_stopwords: bool = False) -> List[str]:
    """The default analyzer (reference TextTokenizer.Analyzer, the Lucene
    standard analyzer's behavior)."""
    if not value:
        return []
    s = (value.lower() if to_lowercase else value).replace("_", " ")
    toks = [t for t in _TOKEN_RE.findall(s) if len(t) >= min_token_length]
    if filter_stopwords:
        toks = [t for t in toks if t not in _STOPWORDS]
    return toks


class TextTokenizer(Transformer):
    """Text -> TextList (reference TextTokenizer.scala:196)."""

    input_types = (Text,)
    output_type = TextList

    @classmethod
    def _declare_params(cls):
        return [Param("min_token_length", "min token length", 1),
                Param("to_lowercase", "lowercase before split", True),
                Param("filter_stopwords", "drop english stopwords", False)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "tokenize"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        return TextList(tokenize_text(
            vals[0].value, int(self.get_param("min_token_length")),
            bool(self.get_param("to_lowercase")),
            bool(self.get_param("filter_stopwords"))))


_UNSEEN = object()


class DistinctValueTransformer(Transformer):
    """A one-input host stage whose output depends on the raw input value
    alone. Its column transform calls `transform_value` once for each
    distinct value of the column and repeats the result (a column of URLs
    or payloads repeats its values); the rows are those of the per-row
    path."""

    def transform_columns(self, *cols):
        t = (self._input_features[0].feature_type if self._input_features
             else self.input_types[0])
        memo: Dict[Any, Any] = {}
        out = []
        for v in cols[0].data:
            try:
                r = memo.get(v, _UNSEEN)
                if r is _UNSEEN:
                    r = memo[v] = self.transform_value(t(v))
            except TypeError:   # an unhashable value: no memo
                r = self.transform_value(t(v))
            out.append(r)
        return self._column_from_outputs(out)


class RegexTokenizer(DistinctValueTransformer):
    """Text -> TextList by a custom token pattern (reference
    RichTextFeature.tokenizeRegex — Lucene pattern analyzer)."""

    input_types = (Text,)
    output_type = TextList

    @classmethod
    def _declare_params(cls):
        return [Param("pattern", "regex matching TOKENS", r"\w+"),
                Param("to_lowercase", "lowercase before match", True),
                Param("min_token_length", "min token length", 1)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "tokenizeRegex"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        if not v:
            return TextList([])
        if bool(self.get_param("to_lowercase")):
            v = v.lower()
        ml = int(self.get_param("min_token_length"))
        pattern = re.compile(str(self.get_param("pattern")))
        # findall returns group captures (or tuples) for a pattern with
        # groups: there, each whole match's group(0)
        found = pattern.findall(v) if not pattern.groups else \
            [m.group(0) for m in pattern.finditer(v)]
        return TextList([t for t in found if len(t) >= ml])


class StopWordsRemover(Transformer):
    """TextList -> TextList without english stopwords (reference
    RichListFeature.removeStopWords via Spark StopWordsRemover)."""

    input_types = (TextList,)
    output_type = TextList

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "rmStopWords"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        toks = vals[0].value or []
        return TextList([t for t in toks if t.lower() not in _STOPWORDS])


class NGramTransformer(Transformer):
    """TextList -> TextList of word n-grams joined by spaces (reference
    RichListFeature.ngram via Spark NGram)."""

    input_types = (TextList,)
    output_type = TextList

    @classmethod
    def _declare_params(cls):
        return [Param("n", "gram size", 2)]

    def __init__(self, n: int = 2, uid: Optional[str] = None, **params):
        params.setdefault("n", n)
        super().__init__(params.pop("operation_name", "ngram"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        toks = vals[0].value or []
        n = max(int(self.get_param("n")), 1)
        return TextList([" ".join(toks[i:i + n])
                         for i in range(max(len(toks) - n + 1, 0))])


class TextLenTransformer(DistinctValueTransformer):
    """Text -> Integral length (reference TextLenTransformer); empty -> 0."""

    input_types = (Text,)
    output_type = Integral

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "textLen"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        return Integral(0 if v is None else len(v))


class SubstringTransformer(Transformer):
    """(Text, Text) -> Binary: second contains first (reference
    SubstringTransformer)."""

    input_types = (Text, Text)
    output_type = Binary

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "substring"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        sub, s = vals[0].value, vals[1].value
        if sub is None or s is None:
            return Binary(None)
        return Binary(sub.lower() in s.lower())


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    joined = " ".join(tokens)
    return Counter([joined[i:i + n]
                    for i in range(max(len(joined) - n + 1, 0))])


class NGramSimilarity(Transformer):
    """(TextList, TextList) -> RealNN cosine similarity over char n-grams
    (reference NGramSimilarity.scala, Lucene NGramDistance)."""

    input_types = (TextList, TextList)
    output_type = RealNN

    @classmethod
    def _declare_params(cls):
        return [Param("n", "gram size", 3)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "nGramSimilarity"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        a, b = vals[0].value or [], vals[1].value or []
        if not a or not b:
            return RealNN(0.0)
        n = int(self.get_param("n"))
        ca, cb = _ngrams(a, n), _ngrams(b, n)
        dot = sum(ca[g] * cb[g] for g in ca.keys() & cb.keys())
        na = math.sqrt(sum(v * v for v in ca.values()))
        nb = math.sqrt(sum(v * v for v in cb.values()))
        return RealNN(dot / (na * nb) if na and nb else 0.0)


class JaccardSimilarity(Transformer):
    """(MultiPickList, MultiPickList) -> RealNN (reference
    JaccardSimilarity.scala); both empty -> 1.0."""

    input_types = (MultiPickList, MultiPickList)
    output_type = RealNN

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "jaccardSimilarity"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        a = set(vals[0].value or ())
        b = set(vals[1].value or ())
        if not a and not b:
            return RealNN(1.0)
        union = len(a | b)
        return RealNN(len(a & b) / union if union else 0.0)


class OpStringIndexer(Estimator):
    """Text -> RealNN frequency-rank index (reference OpStringIndexer;
    unseen/null handled per handle_invalid like StringIndexer)."""

    input_types = (Text,)
    output_type = RealNN

    @classmethod
    def _declare_params(cls):
        return [Param("handle_invalid", "error|skip|keep", "keep")]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "stringIndexer"),
                         uid=uid, **params)

    def fit_columns(self, *cols: Column) -> Transformer:
        # Counter.most_common is a stable sort: tied labels keep the order
        # of their first occurrence
        counts = Counter(v for v in cols[0].data
                         if v is not None and v != "")
        labels = [w for w, _ in counts.most_common()]
        return OpStringIndexerModel(
            labels=labels,
            handle_invalid=str(self.get_param("handle_invalid")),
            operation_name=self.operation_name)


class OpStringIndexerModel(DistinctValueTransformer):
    input_types = (Text,)
    output_type = RealNN

    def __init__(self, labels: Optional[Sequence[str]] = None,
                 handle_invalid: str = "keep",
                 uid: Optional[str] = None, **params):
        self.labels = list(labels or [])
        self.handle_invalid = handle_invalid
        self._index = {w: i for i, w in enumerate(self.labels)}
        super().__init__(params.pop("operation_name", "stringIndexer"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        idx = self._index.get(v)
        if idx is None:
            if self.handle_invalid == "error":
                raise ValueError(f"Unseen label: {v!r}")
            idx = len(self.labels)  # keep: unseen bucket
        return RealNN(float(idx))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(labels=self.labels, handle_invalid=self.handle_invalid)
        return d


class OpIndexToString(Transformer):
    """RealNN index -> Text label (reference OpIndexToString)."""

    input_types = (RealNN,)
    output_type = Text

    def __init__(self, labels: Optional[Sequence[str]] = None,
                 uid: Optional[str] = None, **params):
        self.labels = list(labels or [])
        super().__init__(params.pop("operation_name", "indexToString"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        i = int(vals[0].value)
        return Text(self.labels[i] if 0 <= i < len(self.labels) else None)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(labels=self.labels)
        return d


def _document_frequencies(col: Column) -> Counter:
    """Term -> number of documents holding it. The loop is the JAX
    package's: terms enter the Counter in the iteration order of each
    document's `set`, and `most_common` keeps that order among ties, so
    both packages rank a vocabulary alike within one process."""
    df: Counter = Counter()
    for toks in col.data:
        if toks:
            df.update(set(toks))
    return df


class OpCountVectorizer(Estimator):
    """TextList -> OPVector of top-K vocabulary counts (reference
    OpCountVectorizer wrapping Spark CountVectorizer)."""

    input_types = (TextList,)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("vocab_size", "max vocabulary", 512),
                Param("min_df", "min docs containing term", 1),
                Param("binary", "0/1 instead of counts", False)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "countVec"),
                         uid=uid, **params)

    def _vocab(self, df: Counter) -> List[str]:
        min_df = int(self.get_param("min_df"))
        vocab = [w for w, c in df.most_common() if c >= min_df]
        return vocab[: int(self.get_param("vocab_size"))]

    def fit_columns(self, *cols: Column) -> Transformer:
        return OpCountVectorizerModel(
            vocab=self._vocab(_document_frequencies(cols[0])),
            binary=bool(self.get_param("binary")),
            operation_name=self.operation_name)


class OpCountVectorizerModel(Transformer):
    input_types = (TextList,)
    output_type = OPVector

    def __init__(self, vocab: Optional[Sequence[str]] = None,
                 binary: bool = False, idf: Optional[np.ndarray] = None,
                 uid: Optional[str] = None, **params):
        self.vocab = list(vocab or [])
        self.binary = bool(binary)
        self.idf = None if idf is None else np.asarray(idf, np.float64)
        self._index = {w: i for i, w in enumerate(self.vocab)}
        super().__init__(params.pop("operation_name", "countVec"),
                         uid=uid, **params)

    def _finish(self, counts: np.ndarray) -> np.ndarray:
        """float32 counts -> the output: 0/1 when binary; times the float64
        idf (a float64 result) when fitted as TF-IDF."""
        if self.binary:
            counts = (counts > 0).astype(np.float32)
        if self.idf is not None:
            counts = counts * self.idf
        return counts

    def _encode(self, toks) -> np.ndarray:
        out = np.zeros(len(self.vocab), np.float32)
        for t in toks or []:
            i = self._index.get(t)
            if i is not None:
                out[i] += 1.0
        return self._finish(out)

    def transform_value(self, *vals):
        return OPVector(self._encode(vals[0].value))

    def transform_columns(self, *cols: Column) -> Column:
        # one flat pass over every row's tokens: float32 increments of 1
        # are exact, so the counts are the per-row loop's
        data = cols[0].data
        n, V = len(data), len(self.vocab)
        if not n:
            X = np.zeros((0, V), np.float32)
        else:
            index = self._index
            lengths = np.fromiter((len(t) if t else 0 for t in data),
                                  np.int64, n)
            ids = np.fromiter((index.get(t, -1) for toks in data if toks
                               for t in toks), np.int64, int(lengths.sum()))
            rows = np.repeat(np.arange(n), lengths)
            hit = ids >= 0
            X = np.zeros((n, V), np.float32)
            np.add.at(X, (rows[hit], ids[hit]), np.float32(1.0))
            X = self._finish(X)
        return Column(kind=ColumnKind.VECTOR, data=X,
                      metadata=self.output_metadata())

    def output_metadata(self):
        from ..data.vector import VectorColumnMetadata, VectorMetadata
        parent = (self.input_features[0].name
                  if self.input_features else "text")
        ptype = (self.input_features[0].type_name
                 if self.input_features else "TextList")
        return VectorMetadata(
            name=self.output_name(),
            columns=[VectorColumnMetadata(
                parent_feature_name=parent, parent_feature_type=ptype,
                indicator_value=term) for term in self.vocab])

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(vocab=self.vocab, binary=self.binary, idf=self.idf)
        return d


class TfIdfVectorizer(OpCountVectorizer):
    """TextList -> OPVector TF-IDF (reference `idf` dsl on tokenized text
    wrapping Spark IDF): idf = log((n + 1) / (df + 1)) in float64."""

    def __init__(self, uid: Optional[str] = None, **params):
        Estimator.__init__(self, "tfidf", uid=uid, **params)

    def fit_columns(self, *cols: Column) -> Transformer:
        counts = _document_frequencies(cols[0])
        vocab = self._vocab(counts)
        df = np.array([counts[w] for w in vocab], np.float64)
        idf = np.log((len(cols[0]) + 1.0) / (df + 1.0))
        return OpCountVectorizerModel(vocab=vocab, idf=idf,
                                      operation_name=self.operation_name)


# -- language detection (the reference wraps Optimaize's JVM profiles; these
# are the JAX package's hand-compacted tables) --------------------------------

# Script ranges decide non-Latin languages outright (deterministic — these
# scripts map 1:1 or nearly so to a language for detection purposes).
_SCRIPT_LANGS: List[Tuple[int, int, str]] = [
    (0x0400, 0x04FF, "ru"),   # Cyrillic (uk split off below)
    (0x0370, 0x03FF, "el"),   # Greek
    (0x0590, 0x05FF, "he"),   # Hebrew
    (0x0600, 0x06FF, "ar"),   # Arabic (fa split off below)
    (0x0900, 0x097F, "hi"),   # Devanagari
    (0x0980, 0x09FF, "bn"),   # Bengali
    (0x0B80, 0x0BFF, "ta"),   # Tamil
    (0x0C00, 0x0C7F, "te"),   # Telugu
    (0x0E00, 0x0E7F, "th"),   # Thai
    (0x10A0, 0x10FF, "ka"),   # Georgian
    (0x0530, 0x058F, "hy"),   # Armenian
    (0x1100, 0x11FF, "ko"),   # Hangul Jamo
    (0xAC00, 0xD7AF, "ko"),   # Hangul syllables
    (0x3040, 0x309F, "ja"),   # Hiragana
    (0x30A0, 0x30FF, "ja"),   # Katakana
    (0x4E00, 0x9FFF, "zh"),   # CJK unified (ja wins if kana present)
]

# Latin-script profiles: top stopwords + characteristic trigrams +
# diacritics distinctive of the language (the same n-gram-profile family
# as Optimaize's detector, hand-compacted). Stopword hit = 2, trigram = 1,
# diacritic = 3 (rarely shared between these languages).
_LATIN_PROFILES: Dict[str, Tuple[set, set, str]] = {
    "en": (set("the and of to in is you that it he was for are with".split()),
           {"the", "ing", "and", "ion", "ent"}, ""),
    "de": (set("der die das und ist ein nicht mit sich den auf werden"
               .split()),
           {"der", "ein", "ich", "sch", "und"}, "äöüß"),
    "fr": (set("le la les de et un une est que dans pour qui pas vous"
               .split()),
           {"les", "des", "ent", "que", "ait"}, "àâçéèêëîïôùûœ"),
    "es": (set("el la los las de y un una es que en por con para no"
               .split()),
           {"que", "ión", "los", "ado", "nte"}, "áéíóúñ¿¡"),
    "pt": (set("o a os as de e um uma é que em não com para mais".split()),
           {"que", "ção", "não", "ado", "com"}, "ãõáâêéíóôúç"),
    "it": (set("il lo la i gli le di e un una è che in per non".split()),
           {"che", "ion", "lla", "ato", "gli"}, "àèéìòù"),
    "nl": (set("de het een en van ik dat niet met op zijn voor".split()),
           {"een", "van", "het", "ijk", "aar"}, "ĳ"),
    "sv": (set("och att det som en på är av för med den inte".split()),
           {"och", "att", "för", "ing", "den"}, "åäö"),
    "da": (set("og at det som en på er af for med den ikke".split()),
           {"det", "og", "ikke", "der", "til"}, "æøå"),
    "no": (set("og i det som en på er av for med den ikke å".split()),
           {"det", "og", "ikke", "som", "til"}, "æøå"),
    "fi": (set("ja on ei se että en hän oli mutta kun".split()),
           {"en ", "in ", "ssa", "lla", "sta"}, "äö"),
    "pl": (set("i w nie na się z do to że jest jak po".split()),
           {"nie", "się", "rze", "ych", "ego"}, "ąćęłńóśźż"),
    "cs": (set("a je se v na to že s z do o ale".split()),
           {"je", "na", "pro", "ost", "ter"}, "áčďéěíňóřšťúůýž"),
    "ro": (set("și de la a în cu o pe un este nu ce".split()),
           {"ul ", "în ", "are", "eșt", "lui"}, "ăâîșț"),
    "tr": (set("ve bir bu da ne için de ile çok ama ben".split()),
           {"bir", "lar", "ler", "içi", "dır"}, "çğıöşü"),
    "hu": (set("a az és hogy nem is egy van ez meg".split()),
           {"egy", "nek", "ban", "ogy", "tal"}, "áéíóöőúüű"),
    "id": (set("yang dan di itu dengan untuk tidak ini dari ke".split()),
           {"ang", "men", "kan", "nya", "ber"}, ""),
    "vi": (set("là và của có không được cho người trong một".split()),
           {"ng ", "nh ", "anh", "ông", "ười"},
           "ăâđêôơưáàảãạếềểễệ"),
}


def _trigrams(profiles: Dict[str, Tuple[set, set, str]]) -> set:
    """Every 3-character trigram of a profile table (a shorter entry can
    never equal a 3-character window)."""
    return {t for _, tris, _ in profiles.values() for t in tris
            if len(t) == 3}


def _ascii_marks(profiles: Dict[str, Tuple[set, set, str]]
                 ) -> Dict[str, str]:
    """Each profile's ASCII marks (none of the builtin table's)."""
    return {lang: "".join(m for m in marks if m.isascii())
            for lang, (_, _, marks) in profiles.items()}


_LATIN_TRIGRAMS = _trigrams(_LATIN_PROFILES)
_LATIN_ASCII_MARKS = _ascii_marks(_LATIN_PROFILES)


def build_language_profiles(samples: Dict[str, str], top_tokens: int = 24,
                            top_trigrams: int = 10) -> Dict[str, Any]:
    """Train Latin-script language profiles from sample text — the
    Optimaize-profile-building role. Returns the JSON structure
    `LangDetector(model_path=...)` loads: per language, the most frequent
    tokens (stopword slot), most frequent letter trigrams, and observed
    non-ASCII marks."""
    out: Dict[str, Any] = {}
    for lang, text in samples.items():
        low = text.lower()
        toks = Counter(t for t in tokenize_text(low) if len(t) <= 6)
        grams = Counter(low[i:i + 3] for i in range(max(len(low) - 2, 0))
                        if low[i:i + 3].isalpha())
        marks = "".join(sorted({c for c in low if ord(c) > 0x7f}))
        out[lang] = {
            "stopwords": [w for w, _ in toks.most_common(top_tokens)],
            "trigrams": [g for g, _ in grams.most_common(top_trigrams)],
            "marks": marks,
        }
    return out


def load_language_profiles(path: str) -> Dict[str, Tuple[set, set, str]]:
    """JSON profile file -> the _LATIN_PROFILES runtime shape. Loaded
    profiles EXTEND the builtin table (same-language entries override)."""
    with open(path) as fh:
        raw = json.load(fh)
    return {lang: (set(p.get("stopwords", ())),
                   set(p.get("trigrams", ())),
                   str(p.get("marks", "")))
            for lang, p in raw.items()}


def detect_language(text: str,
                    extra_profiles: Optional[
                        Dict[str, Tuple[set, set, str]]] = None
                    ) -> Optional[str]:
    """Best-effort language code for a document: script ranges decide
    non-Latin languages; Latin scripts score stopword/trigram/diacritic
    profiles over ~18 languages (reference LangDetector wraps Optimaize's
    n-gram profiles — same algorithm family, hand-compacted tables;
    `extra_profiles` adds trained ones, see build_language_profiles)."""
    if not text:
        return None
    head = text[:512]
    # script pass (ASCII characters never count, so an ASCII head skips it)
    script_counts: Dict[str, int] = {}
    kana = False
    if not head.isascii():
        for ch in head:
            cp = ord(ch)
            if cp < 0x80:
                continue
            if 0x3040 <= cp <= 0x30FF:
                kana = True
            for lo, hi, lang in _SCRIPT_LANGS:
                if lo <= cp <= hi:
                    script_counts[lang] = script_counts.get(lang, 0) + 1
                    break
    if script_counts:
        lang = max(script_counts, key=script_counts.get)
        if lang == "zh" and kana:
            return "ja"
        if lang == "ru" and any(c in head for c in "іїєґ"):
            return "uk"  # letters absent from Russian orthography
        if lang == "ar" and any(c in head for c in "\u067e\u0686\u0698\u06af"):
            return "fa"  # pe/che/zhe/gaf: Persian additions to Arabic script
        return lang
    # latin pass, over the same first 512 characters. A profile's trigram
    # counts when it is one of the head's 3-character windows: each
    # trigram of the table is looked for once
    low = head.lower()
    toks = set(tokenize_text(low))
    if extra_profiles:
        profiles = {**_LATIN_PROFILES, **extra_profiles}
        trigrams, ascii_marks = _trigrams(profiles), _ascii_marks(profiles)
    else:
        profiles, trigrams, ascii_marks = \
            _LATIN_PROFILES, _LATIN_TRIGRAMS, _LATIN_ASCII_MARKS
    grams = {t for t in trigrams if t in low}
    ascii_head = low.isascii()
    best, score = None, 0
    for lang, (stops, tris, marks) in profiles.items():
        s = 2 * len(toks & stops) + len(grams & tris)
        if ascii_head:      # an ASCII head holds no other mark
            marks = ascii_marks[lang]
        if marks:
            s += 3 * sum(1 for m in marks if m in low)
        if s > score:
            best, score = lang, s
    return best or "unknown"


class LangDetector(DistinctValueTransformer):
    """Text -> PickList language code over ~30 languages: deterministic
    script detection (Cyrillic/Greek/Hebrew/Arabic/CJK/Hangul/Thai/indic/
    ...) + stopword/trigram/diacritic profiles for 18 Latin-script
    languages (reference LangDetector via Optimaize's n-gram profiles)."""

    input_types = (Text,)
    output_type = PickList

    @classmethod
    def _declare_params(cls):
        return [Param("model_path", "JSON language-profile file "
                      "(build_language_profiles output) extending the "
                      "builtin table; None = builtin only", None)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "langDetect"),
                         uid=uid, **params)
        self._profiles: Optional[Dict[str, Tuple[set, set, str]]] = None
        self._profiles_loaded = False

    def _extra_profiles(self):
        if not self._profiles_loaded:
            self._profiles_loaded = True
            path = self.get_param("model_path")
            if path:
                self._profiles = load_language_profiles(path)
        return self._profiles

    def transform_value(self, *vals):
        return PickList(detect_language(vals[0].value,
                                        self._extra_profiles()))


_MIME_MAGIC: List[Tuple[bytes, str]] = [
    (b"\x89PNG", "image/png"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"GIF8", "image/gif"),
    (b"%PDF", "application/pdf"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"<?xml", "application/xml"),
    (b"{", "application/json"),
]


def load_mime_magic(path: str) -> List[Tuple[bytes, str]]:
    """JSON magic-rule file -> prepended detection table (the Tika
    custom-mimetypes.xml role): [{"magic_hex": "424d", "mime":
    "image/bmp"}, ...]. Longest-prefix entries should come first."""
    with open(path) as fh:
        raw = json.load(fh)
    return [(bytes.fromhex(r["magic_hex"]), str(r["mime"])) for r in raw]


def detect_mime(b64_value: Optional[str],
                extra_magic: Optional[List[Tuple[bytes, str]]] = None
                ) -> Optional[str]:
    """MIME type of a base64 payload via magic bytes, or None for
    empty/undecodable input (shared by the scalar and map detectors).
    `extra_magic` rules are checked before the builtin table."""
    if not b64_value:
        return None
    try:
        head = b64mod.b64decode(
            b64_value[:64] + "=" * (-len(b64_value[:64]) % 4))
    except Exception:
        return None
    for magic, mime in (extra_magic or []):
        if head.startswith(magic):
            return mime
    for magic, mime in _MIME_MAGIC:
        if head.startswith(magic):
            return mime
    try:
        head.decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


class MimeTypeDetector(DistinctValueTransformer):
    """Base64 -> PickList MIME type via magic bytes (reference
    MimeTypeDetector via Tika; `model_path` loads extra magic rules the
    way Tika loads custom-mimetypes.xml)."""

    input_types = (Text,)   # Base64 is a Text subtype
    output_type = PickList

    @classmethod
    def _declare_params(cls):
        return [Param("model_path", "JSON magic-rule file checked before "
                      "the builtin table; None = builtin only", None)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "mimeDetect"),
                         uid=uid, **params)
        self._magic: Optional[List[Tuple[bytes, str]]] = None
        self._magic_loaded = False

    def _extra_magic(self):
        if not self._magic_loaded:
            self._magic_loaded = True
            path = self.get_param("model_path")
            if path:
                self._magic = load_mime_magic(path)
        return self._magic

    def transform_value(self, *vals):
        return PickList(detect_mime(vals[0].value, self._extra_magic()))


# Per-region phone metadata: (country code, set of valid NATIONAL number
# lengths, trunk prefix stripped from national format). A hand-compacted
# slice of the ITU numbering plans libphonenumber ships in full — covers
# the regions the reference's PhoneNumberParser tests exercise plus the
# majors. NANP members share cc=1 with 10-digit nationals and no trunk 0.
_PHONE_REGIONS: Dict[str, Tuple[int, frozenset, str]] = {
    "US": (1, frozenset({10}), ""), "CA": (1, frozenset({10}), ""),
    "MX": (52, frozenset({10}), ""),
    "GB": (44, frozenset({9, 10}), "0"), "IE": (353, frozenset({7, 8, 9}), "0"),
    "DE": (49, frozenset(range(6, 12)), "0"),
    "FR": (33, frozenset({9}), "0"), "ES": (34, frozenset({9}), ""),
    "IT": (39, frozenset(range(8, 12)), ""),
    "PT": (351, frozenset({9}), ""), "NL": (31, frozenset({9}), "0"),
    "BE": (32, frozenset({8, 9}), "0"), "CH": (41, frozenset({9}), "0"),
    "AT": (43, frozenset(range(7, 14)), "0"),
    "SE": (46, frozenset(range(7, 10)), "0"),
    "NO": (47, frozenset({8}), ""), "DK": (45, frozenset({8}), ""),
    "FI": (358, frozenset(range(6, 12)), "0"),
    "PL": (48, frozenset({9}), ""), "CZ": (420, frozenset({9}), ""),
    "RO": (40, frozenset({9}), "0"), "GR": (30, frozenset({10}), ""),
    "TR": (90, frozenset({10}), "0"), "RU": (7, frozenset({10}), "8"),
    "UA": (380, frozenset({9}), "0"), "IL": (972, frozenset({8, 9}), "0"),
    "SA": (966, frozenset({8, 9}), "0"), "AE": (971, frozenset({8, 9}), "0"),
    "IN": (91, frozenset({10}), "0"), "PK": (92, frozenset({9, 10}), "0"),
    "BD": (880, frozenset({8, 9, 10}), "0"),
    "CN": (86, frozenset({11}), "0"), "JP": (81, frozenset({9, 10}), "0"),
    "KR": (82, frozenset(range(8, 11)), "0"),
    "TW": (886, frozenset({8, 9}), "0"),
    "SG": (65, frozenset({8}), ""), "HK": (852, frozenset({8}), ""),
    "MY": (60, frozenset(range(7, 10)), "0"),
    "TH": (66, frozenset({8, 9}), "0"), "VN": (84, frozenset({9, 10}), "0"),
    "ID": (62, frozenset(range(8, 12)), "0"),
    "PH": (63, frozenset({8, 10}), "0"),
    "AU": (61, frozenset({9}), "0"), "NZ": (64, frozenset(range(8, 10)), "0"),
    "BR": (55, frozenset({10, 11}), "0"), "AR": (54, frozenset({10}), "0"),
    "CL": (56, frozenset({9}), ""), "CO": (57, frozenset({10}), ""),
    "PE": (51, frozenset({9}), "0"),
    "ZA": (27, frozenset({9}), "0"), "NG": (234, frozenset({8, 10}), "0"),
    "EG": (20, frozenset({9, 10}), "0"), "KE": (254, frozenset({9}), "0"),
}

# cc -> candidate regions (longest-prefix match over 1-3 digit codes)
_CC_TO_REGIONS: Dict[int, List[str]] = {}
for _r, (_cc, _lens, _tp) in _PHONE_REGIONS.items():
    _CC_TO_REGIONS.setdefault(_cc, []).append(_r)


def _resolve_phone(raw: str, default_region: str = "US"
                   ) -> Tuple[bool, Optional[str], Optional[str]]:
    """(is_valid, region, e164) — THE phone resolution path (reference
    PhoneNumberParser.scala:566 wraps libphonenumber; this is a compacted
    50-region metadata table with the same decision shape: resolve region
    from +cc or the default, strip trunk prefix, check national length).
    Validity (parse_phone) and normalization (parse_phone_e164) are views
    of this one function so they can never disagree."""
    if not raw:
        return False, None, None
    s = raw.strip()
    digits = re.sub(r"[^\d+]", "", s)
    if digits.count("+") > 1 or ("+" in digits and not digits.startswith("+")):
        return False, None, None
    if digits.startswith("+"):
        body = digits[1:]
        if not body.isdigit():
            return False, None, None
        for cc_len in (3, 2, 1):
            cc = int(body[:cc_len]) if len(body) >= cc_len else -1
            for region in _CC_TO_REGIONS.get(cc, ()):
                _, lens, _trunk = _PHONE_REGIONS[region]
                if len(body) - cc_len in lens:
                    return True, region, "+" + body
        # unknown cc: fall back to the ITU E.164 structural bound
        ok = 8 <= len(body) <= 15
        return ok, None, ("+" + body) if ok else None
    if not digits.isdigit() or not digits:
        return False, None, None
    region = default_region.upper()
    meta = _PHONE_REGIONS.get(region)
    if meta is None:
        # structurally plausible but no metadata to produce a +cc form
        return 7 <= len(digits) <= 15, None, None
    cc, lens, trunk = meta
    national = digits
    cc_str = str(cc)
    # NANP-style: national form may carry the country code (1-555-...)
    if national.startswith(cc_str) and (len(national) - len(cc_str)) in lens:
        national = national[len(cc_str):]
    elif trunk and national.startswith(trunk) and \
            (len(national) - len(trunk)) in lens:
        national = national[len(trunk):]
    ok = len(national) in lens
    return ok, region, f"+{cc}{national}" if ok else None


def parse_phone(raw: str, default_region: str = "US"
                ) -> Tuple[bool, Optional[str]]:
    """(is_valid, region) for a raw phone string — see _resolve_phone."""
    ok, region, _ = _resolve_phone(raw, default_region)
    return ok, region


class PhoneNumberParser(DistinctValueTransformer):
    """Phone -> Binary validity against per-region numbering metadata
    (country code, national length set, trunk prefix) for ~50 regions
    (reference PhoneNumberParser.scala:566 via libphonenumber)."""

    input_types = (Text,)
    output_type = Binary

    @classmethod
    def _declare_params(cls):
        return [Param("default_region", "region for bare numbers", "US"),
                Param("strict", "strict length validation", True)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "phoneValid"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        if not v:
            return Binary(None)
        ok, _region = parse_phone(v, str(self.get_param("default_region")))
        if not ok and not bool(self.get_param("strict")):
            digits = re.sub(r"\D", "", v)
            ok = 7 <= len(digits) <= 15
        return Binary(bool(ok))


def parse_phone_e164(raw: str, default_region: str = "US") -> Optional[str]:
    """Normalized ``+<cc><national>`` form, or None when invalid
    (reference RichPhoneFeature.parsePhone -> libphonenumber E164).
    Same single resolution path as parse_phone (_resolve_phone)."""
    return _resolve_phone(raw, default_region)[2]


class PhoneParser(DistinctValueTransformer):
    """Phone/Text -> normalized E.164 Text, empty when unparseable
    (reference RichPhoneFeature.parsePhone / parsePhoneDefaultCountry)."""

    input_types = (Text,)
    output_type = Text

    @classmethod
    def _declare_params(cls):
        return [Param("default_region", "region for bare numbers", "US")]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "parsePhone"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        if not v:
            return Text(None)
        return Text(parse_phone_e164(v, str(self.get_param("default_region"))))


class EmailToPickList(DistinctValueTransformer):
    """Email -> PickList of the domain (reference RichEmailFeature
    .toEmailDomain)."""

    input_types = (Text,)
    output_type = PickList

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "emailDomain"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        e = vals[0] if isinstance(vals[0], Email) else Email(vals[0].value)
        return PickList(e.domain())


_EMAIL_RE = re.compile(
    r"^[A-Za-z0-9.!#$%&'*+/=?^_`{|}~-]+@"
    r"[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?"
    r"(?:\.[A-Za-z0-9](?:[A-Za-z0-9-]{0,61}[A-Za-z0-9])?)+\Z")


class ValidEmailTransformer(DistinctValueTransformer):
    """Email -> Binary RFC-shaped validity (reference RichEmailFeature
    .isValidEmail:591 / ValidEmailTransformer)."""

    input_types = (Text,)
    output_type = Binary

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "validEmail"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        if not v:
            return Binary(None)
        return Binary(bool(_EMAIL_RE.match(v)))


class EmailPrefixTransformer(DistinctValueTransformer):
    """Email -> Text local part (reference RichEmailFeature
    .toEmailPrefix:578)."""

    input_types = (Text,)
    output_type = Text

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "emailPrefix"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        e = vals[0] if isinstance(vals[0], Email) else Email(vals[0].value)
        return Text(e.prefix())


class UrlPartsTransformer(DistinctValueTransformer):
    """URL -> Text domain or protocol (reference RichURLFeature
    .toDomain:630 / .toProtocol:635); `part` selects which. Parsing
    delegates to the URL type helpers (types/text.py) — ONE urllib-based
    parser in the codebase, java.net.URL.getHost semantics (userinfo and
    port stripped)."""

    input_types = (Text,)
    output_type = Text

    @classmethod
    def _declare_params(cls):
        return [Param("part", "domain|protocol", "domain")]

    def __init__(self, part: str = "domain", uid: Optional[str] = None,
                 **params):
        params.setdefault("part", part)
        super().__init__(params.pop("operation_name", "urlParts"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        u = vals[0] if isinstance(vals[0], URL) else URL(vals[0].value)
        return Text(u.domain() if str(self.get_param("part")) == "domain"
                    else u.protocol())


class ValidUrlTransformer(DistinctValueTransformer):
    """URL -> Binary validity, optionally restricted to protocols
    (reference RichURLFeature.isValidUrl:642,650 — defaults http/https/ftp,
    dotless hosts like localhost accepted, matching java.net.URL parsing).
    Delegates to URL.is_valid (types/text.py)."""

    input_types = (Text,)
    output_type = Binary

    @classmethod
    def _declare_params(cls):
        return [Param("protocols", "accepted schemes",
                      ["http", "https", "ftp"])]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "validUrl"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        if vals[0].value is None:
            return Binary(None)
        u = vals[0] if isinstance(vals[0], URL) else URL(vals[0].value)
        return Binary(u.is_valid(tuple(self.get_param("protocols"))))


class UrlToDomainPickList(DistinctValueTransformer):
    """URL -> PickList of the domain when the URL is valid, empty
    otherwise (reference RichURLFeature.vectorize:676: `if (v.isValid)
    v.domain.toPickList else PickList.empty`) — the derivation step of
    the URL transmogrify default."""

    input_types = (Text,)
    output_type = PickList

    @classmethod
    def _declare_params(cls):
        return [Param("protocols", "accepted schemes",
                      ["http", "https", "ftp"])]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "urlDomainPick"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        u = vals[0] if isinstance(vals[0], URL) else URL(vals[0].value)
        if u.value is None or not u.is_valid(tuple(self.get_param("protocols"))):
            return PickList(None)
        return PickList(u.domain())


class OpIDF(Estimator):
    """OPVector -> OPVector rescaled by inverse document frequency
    (reference RichVectorFeature.idf:56 wrapping Spark ml IDF): per column
    j, idf_j = log((m + 1) / (df_j + 1)) with df_j = #rows where x_j > 0;
    columns under min_doc_freq get idf 0 (Spark's semantics). Fit is one
    columnwise reduction over the dense matrix."""

    input_types = (OPVector,)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        return [Param("min_doc_freq", "df below this zeroes the column", 0)]

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "idf"), uid=uid,
                         **params)

    def fit_columns(self, *cols: Column) -> Transformer:
        X = np.asarray(cols[0].data, np.float32)
        m = X.shape[0]
        df = (X > 0).sum(axis=0).astype(np.float64)
        idf = np.log((m + 1.0) / (df + 1.0))
        idf[df < int(self.get_param("min_doc_freq"))] = 0.0
        return OpIDFModel(idf=idf, operation_name=self.operation_name)


class OpIDFModel(Transformer):
    input_types = (OPVector,)
    output_type = OPVector

    def __init__(self, idf: Optional[Sequence[float]] = None,
                 uid: Optional[str] = None, **params):
        self.idf = np.asarray([] if idf is None else idf, np.float32)
        super().__init__(params.pop("operation_name", "idf"), uid=uid,
                         **params)

    def transform_columns(self, *cols: Column) -> Column:
        vec = cols[0]
        if not len(self.idf):  # unfitted default: identity
            return vec
        return Column(kind=ColumnKind.VECTOR,
                      data=np.asarray(vec.data, np.float32) * self.idf[None, :],
                      metadata=vec.metadata)

    def transform_value(self, *vals):
        x = np.asarray(vals[0].value, np.float32)
        return OPVector(x * self.idf if len(self.idf) else x)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(idf=[float(v) for v in self.idf])
        return d


class TextToMultiPickList(DistinctValueTransformer):
    """Text -> MultiPickList singleton set (reference RichTextFeature
    .toMultiPickList:58)."""

    input_types = (Text,)
    output_type = MultiPickList

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "toMultiPickList"),
                         uid=uid, **params)

    def transform_value(self, *vals):
        v = vals[0].value
        return MultiPickList(set() if not v else {v})
