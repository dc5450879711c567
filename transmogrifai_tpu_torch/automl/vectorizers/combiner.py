"""VectorsCombiner: concatenate OPVector features into the final matrix.

Reference: core/.../impl/feature/VectorsCombiner.scala — a SequenceTransformer
assembling per-family vectors into the single feature vector consumed by
SanityChecker and models. The combined 2-D block is the matrix the
statistics pass and the model sweep move to the device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...data.dataset import Column
from ...data.vector import VectorMetadata
from ...types import OPVector
from .base import VectorizerModel


class VectorsCombiner(VectorizerModel):
    """Transformer (no fitting): concat vector columns + their metadata."""

    input_types = (OPVector,)
    is_sequence = True

    def __init__(self, operation_name: str = "combineVectors",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        # single preallocated f32 pass — input vector columns are already
        # f32, so each part is one slice copy, never an f64 round-trip
        n = len(cols[0]) if cols else 0
        mats = []
        for c in cols:
            m = c.data
            if m.ndim == 1:
                m = m[:, None]
            mats.append(m)
        out = np.empty((n, sum(m.shape[1] for m in mats)), np.float32)
        at = 0
        for m in mats:
            out[:, at:at + m.shape[1]] = m
            at += m.shape[1]
        return out

    def combine_metadata(self, cols: Sequence[Column]) -> VectorMetadata:
        parts: List[VectorMetadata] = []
        for c, f in zip(cols, self.input_features):
            if c.metadata is not None:
                parts.append(c.metadata)
            else:
                from ...data.vector import VectorColumnMetadata
                width = c.data.shape[1] if c.data.ndim == 2 else 1
                parts.append(VectorMetadata(name=f.name, columns=[
                    VectorColumnMetadata(parent_feature_name=f.name,
                                         parent_feature_type=f.type_name,
                                         descriptor_value=str(i))
                    for i in range(width)]))
        md = VectorMetadata.concat(self.output_name(), parts)
        self.set_metadata(md)
        return md

    def transform_columns(self, *cols: Column) -> Column:
        self.combine_metadata(cols)
        return super().transform_columns(*cols)
