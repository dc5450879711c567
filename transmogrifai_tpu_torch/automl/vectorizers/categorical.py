"""Categorical one-hot / pivot vectorizers.

Reference: core/.../impl/feature/OpOneHotVectorizer.scala (top-K pivot with
OTHER + null-indicator columns, min support, text cleaning) and
OpSetVectorizer for MultiPickList.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...data.dataset import Column
from ...data.vector import NULL_STRING, OTHER_STRING, VectorColumnMetadata, VectorMetadata
from ...stages.params import Param
from ...types import MultiPickList, Text
from .base import SequenceVectorizer, VectorizerModel
from .encoding import category_counts, pivot_block_multi, pivot_block_single

_CLEAN_RE = re.compile(r"[^\w\s]|_", re.UNICODE)


def clean_text_value(s: str, clean: bool = True) -> str:
    """Reference TextParams.cleanTextFn: trim, strip punctuation, lowercase."""
    if not clean:
        return s
    return _CLEAN_RE.sub("", s).strip().lower()


class OneHotModel(VectorizerModel):
    """Fitted pivot: per feature, topK indicator cols + OTHER + null."""

    # class-level: any element (Text-ish or MultiPickList); Estimator.fit
    # pins each fitted instance to its estimator's concrete contract
    input_types = (None,)

    def __init__(self, vocabs: Sequence[Sequence[str]], track_nulls: bool = True,
                 clean_text: bool = True, multiset: bool = False,
                 operation_name: str = "pivot", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.vocabs = [list(v) for v in vocabs]
        self.track_nulls = track_nulls
        self.clean_text = clean_text
        self.multiset = multiset

    def _width(self, j: int) -> int:
        return len(self.vocabs[j]) + 1 + (1 if self.track_nulls else 0)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        n = len(cols[0]) if cols else 0
        out = np.zeros((n, sum(self._width(j) for j in range(len(cols)))),
                       np.float32)
        self.transform_block_into(cols, out)
        return out

    def transform_block_into(self, cols: Sequence[Column],
                             out: np.ndarray) -> None:
        # indicator scatters land straight in the final combined matrix
        clean = self.clean_text
        pivot = pivot_block_multi if self.multiset else pivot_block_single
        at = 0
        for j, c in enumerate(cols):
            w = self._width(j)
            pivot(c.data, self.vocabs[j], self.track_nulls,
                  lambda s: clean_text_value(s, clean),
                  out=out[:, at:at + w])
            at += w
        if at != out.shape[1]:  # python -O strips assert; sink fallback
            raise AssertionError((at, out.shape))  # relies on this firing

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(vocabs=self.vocabs, track_nulls=self.track_nulls,
                 clean_text=self.clean_text, multiset=self.multiset)
        return d


class OneHotVectorizer(SequenceVectorizer):
    """Top-K categorical pivot estimator (reference OpOneHotVectorizer:
    TopK=20, MinSupport=10, CleanText=true, TrackNulls=true)."""

    input_types = (Text,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("top_k", "max categories per feature", 20,
                  lambda v: v > 0),
            Param("min_support", "min occurrences to keep a category", 10,
                  lambda v: v >= 0),
            Param("clean_text", "normalize category strings", True),
            Param("track_nulls", "append null-indicator columns", True),
            Param("max_pct_cardinality",
                  "drop pivot if distinct/count exceeds this", 1.0),
        ]

    def __init__(self, operation_name: str = "pivot",
                 uid: Optional[str] = None, multiset: bool = False, **params):
        self.multiset = multiset
        if multiset:
            self.input_types = (MultiPickList,)
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> OneHotModel:
        top_k = int(self.get_param("top_k"))
        min_support = int(self.get_param("min_support"))
        clean = self.get_param("clean_text")
        track = self.get_param("track_nulls")
        max_pct = float(self.get_param("max_pct_cardinality"))
        vocabs: List[List[str]] = []
        for c in cols:
            counts, n_present = category_counts(
                c.data, lambda s: clean_text_value(s, clean),
                multiset=self.multiset)
            if n_present > 0 and len(counts) / n_present > max_pct:
                # near-unique (ID-like) column: drop the pivot entirely
                # (reference OpOneHotVectorizer.MaxPctCardinality guard)
                vocabs.append([])
                continue
            kept = [(val, n) for val, n in counts.items()
                    if n >= min_support and val != ""]
            # order: by count desc then value asc (stable, reproducible)
            kept.sort(key=lambda kv: (-kv[1], kv[0]))
            vocabs.append([val for val, _ in kept[:top_k]])
        model = OneHotModel(vocabs=vocabs, track_nulls=track, clean_text=clean,
                            multiset=self.multiset,
                            operation_name=self.operation_name)
        md_cols: List[VectorColumnMetadata] = []
        for f, vocab in zip(self.input_features, vocabs):
            for v in vocab:
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    grouping=f.name, indicator_value=v))
            md_cols.append(VectorColumnMetadata(
                parent_feature_name=f.name, parent_feature_type=f.type_name,
                grouping=f.name, indicator_value=OTHER_STRING))
            if track:
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    grouping=f.name, indicator_value=NULL_STRING))
        model.set_metadata(VectorMetadata(name=self.output_name(), columns=md_cols))
        return model
