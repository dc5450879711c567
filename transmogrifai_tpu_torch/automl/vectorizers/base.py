"""Vectorizer base machinery.

Vectorizers are sequence estimators/transformers: N same-typed input features
-> one OPVector output whose columns carry VectorMetadata provenance
(reference: the vectorizer family under core/.../impl/feature/ — each is a
SequenceEstimator producing OPVector with OpVectorMetadata).

Two-phase contract: fit computes a static shape (vocabularies, fill values,
hash widths) as concrete host values; the resulting model's transform is
host numpy, as in the JAX package (counterpart of
automl/vectorizers/base.py).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...data.dataset import Column
from ...data.vector import VectorMetadata
from ...stages.base import Estimator, Transformer
from ...types import ColumnKind, FeatureType, OPVector


class VectorizerModel(Transformer):
    """Base fitted vectorizer: emits a dense [n, width] block + metadata."""

    output_type = OPVector
    is_sequence = True

    def __init__(self, operation_name: str, uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)
        self._metadata: Optional[VectorMetadata] = None

    def output_metadata(self) -> Optional[VectorMetadata]:
        if self._metadata is not None and self._metadata.name != self.output_name():
            self._metadata = VectorMetadata(
                name=self.output_name(), columns=self._metadata.columns,
                history=self._metadata.history)
        return self._metadata

    def set_metadata(self, md: VectorMetadata) -> "VectorizerModel":
        self._metadata = md
        return self

    # columnar protocol: subclasses implement transform_block
    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        raise NotImplementedError

    def transform_block_into(self, cols: Sequence[Column],
                             out: np.ndarray) -> None:
        """Write this vectorizer's block into `out` (pre-zeroed, possibly a
        strided column-slice of the final combined matrix). Serving sink
        fusion: the DAG runner hands each producer its slice of the
        VectorsCombiner output so wide blocks never materialize twice
        (the fused row-map's one-pass discipline,
        reference FitStagesUtil.scala:96-118, applied to memory traffic).
        Default: materialize and copy; hot families override to write in
        place."""
        out[:] = np.asarray(self.transform_block(cols), np.float32)

    def transform_columns(self, *cols: Column) -> Column:
        block = self.transform_block(list(cols))
        block = np.asarray(block, dtype=np.float32)
        md = self.output_metadata()
        if md is not None and block.shape[1] != md.size:
            raise AssertionError(
                f"{self.stage_name}: produced {block.shape[1]} cols, "
                f"metadata has {md.size}")
        return Column(kind=ColumnKind.VECTOR, data=block, metadata=md)

    def transform_value(self, *vals: FeatureType):
        cols = [_single_value_column(v) for v in vals]
        block = self.transform_block(cols)
        return OPVector(np.asarray(block, dtype=np.float32)[0])


def _single_value_column(v: FeatureType) -> Column:
    from ...data.dataset import column_from_values
    return column_from_values(type(v), [v])


def numeric_block(cols: Sequence[Column]) -> np.ndarray:
    """Stack numeric columns into [n, k] float64 (NaN = missing)."""
    return np.stack([np.asarray(c.data, dtype=np.float64) for c in cols], axis=1)


class SequenceVectorizer(Estimator):
    """Base estimator for N same-typed inputs -> OPVector."""

    output_type = OPVector
    is_sequence = True

    def feature_names(self) -> List[str]:
        return self.input_names()
