"""Text-processing transformers: the analyzer, MIME and phone detection
and the structured text derivations of Email and URL (counterpart of
transformers/text.py).

Reference: core/.../impl/feature/{TextTokenizer(196), MimeTypeDetector,
PhoneNumberParser(566)}.scala and the dsl's RichEmailFeature and
RichURLFeature. Parsing stays on the host: strings never reach the
device. The reference leaned on Lucene, Tika and libphonenumber (all JVM);
these are the JAX package's self-contained re-implementations of the
behaviours the AutoML pipeline consumes, copied with their tables. The
other text transformers of the JAX module (n-grams, similarity, indexers,
language detection, counts and IDF) are not ported yet.
"""
from __future__ import annotations

import base64 as b64mod
import json
import re
from typing import Any, Dict, List, Optional, Tuple

from ..stages.base import Transformer
from ..stages.params import Param
from ..types import URL, Binary, Email, PickList, Text, TextList

# token = maximal run of unicode alphanumerics or apostrophes (underscore
# is a separator). For pure-ASCII text this is the [A-Za-z0-9'] rule;
# non-ASCII text keeps unicode tokens, as Lucene's standard analyzer does.
_TOKEN_RE = re.compile(r"(?:[^\W_]|')+", re.UNICODE)
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
    s = value.lower() if to_lowercase else value
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
