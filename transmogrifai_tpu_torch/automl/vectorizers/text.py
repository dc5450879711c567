"""Text vectorizers: smart cardinality dispatch, hashing, tokenization
(counterpart of automl/vectorizers/text.py; host numpy, as there).

Reference: core/.../impl/feature/{SmartTextVectorizer.scala:60,
OPCollectionHashingVectorizer.scala, TextTokenizer.scala}. SmartText
counts each feature's distinct values during fit: low-cardinality features
pivot (one-hot), high-cardinality features hash into a fixed bin space, so
the width is known before any row is transformed.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...data.dataset import Column
from ...data.vector import (NULL_STRING, OTHER_STRING, VectorColumnMetadata,
                            VectorMetadata)
from ...ops.hashing import hash_tokens_to_counts
from ...stages.params import Param
from ...transformers.text import tokenize_text
from ...types import Text, TextList
from .base import SequenceVectorizer, VectorizerModel
from .categorical import clean_text_value
from .encoding import (category_counts, factorize, null_mask,
                       pivot_block_single)

MIN_TOKEN_LENGTH = 1  # reference TextTokenizer.MinTokenLength


def tokenize(s: Optional[str], to_lowercase: bool = True,
             min_token_length: int = MIN_TOKEN_LENGTH) -> List[str]:
    """The default analyzer (reference TextTokenizer.scala:196, Lucene's
    standard analyzer): maximal runs of unicode alphanumerics and
    apostrophes, lowercased."""
    return tokenize_text(s, min_token_length, to_lowercase, False)


def tokenize_hash_counts(docs: Sequence[Optional[str]], bins: int,
                         seed: int = 0, pad_cols: int = 0,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
    """Documents -> [n, bins + pad_cols] hashed token counts. `pad_cols`
    appends zero columns for in-place indicator writes (the null tracker).
    `out`: pre-zeroed in-place destination (may be a strided slice of the
    final combined matrix; the combiner sink). Each distinct document is
    tokenized and counted once (a missing one as the empty document)."""
    uniq, inv, _ = factorize(docs)
    counts = hash_tokens_to_counts([tokenize(d) for d in uniq], bins,
                                   seed=seed)[inv]
    if out is not None:
        out[:, :bins] = counts
        return out
    if pad_cols:
        res = np.zeros((counts.shape[0], bins + pad_cols), np.float32)
        res[:, :bins] = counts
        return res
    return counts


class SmartTextModel(VectorizerModel):
    """Fitted smart text: each feature either a pivot vocabulary or a hash
    space."""

    input_types = (Text,)  # mirrors SmartTextVectorizer

    def __init__(self, plans: Sequence[Dict[str, Any]],
                 operation_name: str = "smartTxt", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        # each plan: {mode: 'pivot'|'hash', vocab: [...], bins: int,
        #            track_nulls: bool, clean_text: bool}
        self.plans = [dict(p) for p in plans]

    def _plan_width(self, plan: Dict[str, Any]) -> int:
        extra = 1 if plan["track_nulls"] else 0
        if plan["mode"] == "pivot":
            return len(plan["vocab"]) + 1 + extra
        return plan["bins"] + extra

    def _plan_block(self, plan: Dict[str, Any], c: Column,
                    out: Optional[np.ndarray]) -> np.ndarray:
        data = c.data
        track = plan["track_nulls"]
        if plan["mode"] == "pivot":
            clean = plan["clean_text"]
            return pivot_block_single(
                data, plan["vocab"], track,
                lambda s: clean_text_value(s, clean), out=out)
        # hash: the counts land in a [n, bins (+1)] destination, and the
        # null indicator fills the trailing column in place
        block = tokenize_hash_counts(data, plan["bins"],
                                     pad_cols=1 if track else 0, out=out)
        if track:
            block[:, plan["bins"]] = null_mask(data)
        return block

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        blocks = [np.asarray(self._plan_block(plan, c, None), np.float32)
                  for plan, c in zip(self.plans, cols)]
        if len(blocks) == 1:
            return blocks[0]
        return np.concatenate(blocks, axis=1)

    def transform_block_into(self, cols: Sequence[Column],
                             out: np.ndarray) -> None:
        at = 0
        for plan, c in zip(self.plans, cols):
            w = self._plan_width(plan)
            self._plan_block(plan, c, out[:, at:at + w])
            at += w
        if at != out.shape[1]:  # the sink's fallback relies on this firing
            raise AssertionError((at, out.shape))

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(plans=self.plans)
        return d


class SmartTextVectorizer(SequenceVectorizer):
    """Cardinality-dispatched text vectorizer (reference
    SmartTextVectorizer.fitFn:79: cardinality <= maxCardinality (30) =>
    pivot, else hash into num_features bins)."""

    input_types = (Text,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("max_cardinality", "pivot if distinct values <= this", 30),
            Param("num_features", "hash bins for high-cardinality text", 512),
            Param("top_k", "pivot vocabulary cap", 20),
            Param("min_support", "min occurrences for pivot category", 10),
            Param("clean_text", "normalize strings", True),
            Param("track_nulls", "append null indicators", True),
        ]

    def __init__(self, operation_name: str = "smartTxt",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> SmartTextModel:
        max_card = int(self.get_param("max_cardinality"))
        bins = int(self.get_param("num_features"))
        top_k = int(self.get_param("top_k"))
        min_support = int(self.get_param("min_support"))
        clean = self.get_param("clean_text")
        track = self.get_param("track_nulls")
        plans: List[Dict[str, Any]] = []
        md_cols: List[VectorColumnMetadata] = []
        for f, c in zip(self.input_features, cols):
            counts, _ = category_counts(
                c.data, lambda s: clean_text_value(s, clean))
            if len(counts) <= max_card:
                kept = [(val, n) for val, n in counts.items()
                        if n >= min_support and val != ""]
                kept.sort(key=lambda kv: (-kv[1], kv[0]))
                vocab = [v for v, _ in kept[:top_k]]
                plans.append(dict(mode="pivot", vocab=vocab, bins=0,
                                  track_nulls=track, clean_text=clean))
                for v in vocab:
                    md_cols.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=f.name, indicator_value=v))
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.type_name,
                    grouping=f.name, indicator_value=OTHER_STRING))
            else:
                plans.append(dict(mode="hash", vocab=[], bins=bins,
                                  track_nulls=track, clean_text=clean))
                for b in range(bins):
                    md_cols.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=f.name, descriptor_value=f"hash_{b}"))
            if track:
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name,
                    parent_feature_type=f.type_name,
                    grouping=f.name, indicator_value=NULL_STRING))
        model = SmartTextModel(plans=plans,
                               operation_name=self.operation_name)
        model.set_metadata(VectorMetadata(name=self.output_name(),
                                          columns=md_cols))
        return model


class HashingModel(VectorizerModel):
    """Pure hashing-trick vectorizer (no fit statistics beyond widths)."""

    # class-level: TextList (is_list=True) or untokenized Text;
    # Estimator.fit pins each fitted instance to its estimator's contract
    input_types = (None,)

    def __init__(self, num_features: int = 512,
                 shared_hash_space: bool = False, binary_freq: bool = False,
                 is_list: bool = True, operation_name: str = "hashText",
                 uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.num_features = int(num_features)
        self.shared_hash_space = shared_hash_space
        self.binary_freq = binary_freq
        self.is_list = is_list

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        # token-hash counts are additive: a shared hash space is the SUM of
        # the per-column matrices
        mats = [hash_tokens_to_counts(c.data, self.num_features)
                if self.is_list
                else tokenize_hash_counts(c.data, self.num_features)
                for c in cols]
        if self.shared_hash_space:
            out = mats[0] if len(mats) == 1 else np.sum(mats, axis=0)
            return np.minimum(out, 1.0) if self.binary_freq else out
        if self.binary_freq:
            mats = [np.minimum(m, 1.0) for m in mats]
        return np.concatenate(mats, axis=1)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(num_features=self.num_features,
                 shared_hash_space=self.shared_hash_space,
                 binary_freq=self.binary_freq, is_list=self.is_list)
        return d


class TextListHashingVectorizer(SequenceVectorizer):
    """TextList -> hashed token counts (reference
    OPCollectionHashingVectorizer.scala:398; HashSpaceStrategy.Auto =>
    separate spaces unless many features)."""

    input_types = (TextList,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("num_features", "hash bins per feature", 512),
            Param("shared_hash_space", "share one hash space", False),
            Param("binary_freq", "0/1 instead of counts", False),
        ]

    def __init__(self, operation_name: str = "hashList",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> HashingModel:
        nf = int(self.get_param("num_features"))
        shared = self.get_param("shared_hash_space")
        model = HashingModel(
            num_features=nf, shared_hash_space=shared,
            binary_freq=self.get_param("binary_freq"), is_list=True,
            operation_name=self.operation_name)
        md_cols: List[VectorColumnMetadata] = []
        if shared:
            for b in range(nf):
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name="+".join(self.input_names()),
                    parent_feature_type=self.input_features[0].type_name,
                    descriptor_value=f"hash_{b}"))
        else:
            for f in self.input_features:
                for b in range(nf):
                    md_cols.append(VectorColumnMetadata(
                        parent_feature_name=f.name,
                        parent_feature_type=f.type_name,
                        grouping=f.name, descriptor_value=f"hash_{b}"))
        model.set_metadata(VectorMetadata(name=self.output_name(),
                                          columns=md_cols))
        return model
