"""Text feature types.

Reference: features/.../types/Text.scala:48-298 — Text plus 13 refined
subtypes. The subtypes matter because the Transmogrifier dispatches default
vectorization per static type (PickList -> one-hot pivot, Text -> smart
vectorize, Email -> domain pivot, etc).
"""
from __future__ import annotations

from typing import Any, Optional

from .base import Categorical, ColumnKind, FeatureType


class Text(FeatureType):
    """Optional string (reference Text.scala:48)."""

    column_kind = ColumnKind.STRING

    @classmethod
    def _convert(cls, value: Any) -> Optional[str]:
        if value is None:
            return None
        if isinstance(value, Text):
            return value.value
        if isinstance(value, float):
            import math
            if math.isnan(value):
                return None
        s = str(value)
        return s if s != "" else None


class Email(Text):
    """Reference Text.scala:65. `prefix`/`domain` helpers mirror
    RichTextFeature's email ops."""

    def prefix(self) -> Optional[str]:
        p = self._split()
        return p[0] if p else None

    def domain(self) -> Optional[str]:
        p = self._split()
        return p[1] if p else None

    def _split(self):
        v = self.value
        if v is None or v.count("@") != 1:
            return None
        pre, dom = v.split("@")
        if not pre or not dom:
            return None
        return pre, dom


class Base64(Text):
    """Reference Text.scala:101."""

    def as_bytes(self) -> Optional[bytes]:
        if self.value is None:
            return None
        import base64
        try:
            return base64.b64decode(self.value)
        except Exception:
            return None


class Phone(Text):
    """Reference Text.scala:139."""


class ID(Text):
    """Reference Text.scala:153."""


class URL(Text):
    """Reference Text.scala:167."""

    def domain(self) -> Optional[str]:
        v = self.value
        if v is None:
            return None
        from urllib.parse import urlparse
        try:
            # hostname strips userinfo and port (java.net.URL.getHost
            # semantics, which the reference's RichURLFeature relies on)
            return urlparse(v).hostname or None
        except Exception:
            return None

    def protocol(self) -> Optional[str]:
        v = self.value
        if v is None:
            return None
        from urllib.parse import urlparse
        try:
            scheme = urlparse(v).scheme
            return scheme or None
        except Exception:
            return None

    def is_valid(self, protocols=("http", "https", "ftp")) -> bool:
        v = self.value
        if v is None:
            return False
        from urllib.parse import urlparse
        try:
            p = urlparse(v)
            return p.scheme in tuple(s.lower() for s in protocols) \
                and bool(p.netloc)
        except Exception:
            return False


class TextArea(Text):
    """Long-form text (reference Text.scala:201)."""


class PickList(Text, Categorical):
    """Categorical single-select (reference Text.scala:215)."""


class ComboBox(Text, Categorical):
    """Categorical with free entry (reference Text.scala:228)."""


class Country(Text, Categorical):
    """Reference Text.scala:242."""


class State(Text, Categorical):
    """Reference Text.scala:256."""


class PostalCode(Text, Categorical):
    """Reference Text.scala:270."""


class City(Text, Categorical):
    """Reference Text.scala:284."""


class Street(Text):
    """Reference Text.scala:298."""
