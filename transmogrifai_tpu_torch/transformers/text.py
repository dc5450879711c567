"""Text-processing transformers, the analyzer only (counterpart of
transformers/text.py:39-80).

Reference: core/.../impl/feature/TextTokenizer.scala:196 and the Lucene
standard analyzer it wraps. Tokenization stays on the host: strings never
reach the device. The other text transformers of the JAX module (n-grams,
similarity, indexers, language, MIME and phone detection, the structured
text derivations) are not ported yet.
"""
from __future__ import annotations

import re
from typing import List, Optional

from ..stages.base import Transformer
from ..stages.params import Param
from ..types import Text, TextList

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
