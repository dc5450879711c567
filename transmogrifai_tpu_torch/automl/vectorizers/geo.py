"""Geolocation vectorizer: mean-impute with null tracking (counterpart of
automl/vectorizers/geo.py; host numpy float64, as there).

Reference: core/.../impl/feature/GeolocationVectorizer.scala:156 — fills
missing locations with the geographic mean (computed on the unit sphere so
the mean stays on the globe), emitting (lat, lon, accuracy, null) columns.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ...data.dataset import Column
from ...data.vector import NULL_STRING, VectorColumnMetadata, VectorMetadata
from ...stages.params import Param
from ...types import Geolocation
from .base import SequenceVectorizer, VectorizerModel
from .encoding import empty_mask, triple_block


def geo_mean(values: Sequence[Sequence[float]]) -> List[float]:
    """Unit-sphere mean of (lat, lon, acc) triples (vectorized)."""
    if not len(values):
        return [0.0, 0.0, 0.0]
    arr = np.asarray(values, np.float64)[:, :3]
    la = np.radians(arr[:, 0])
    lo = np.radians(arr[:, 1])
    xs = float(np.mean(np.cos(la) * np.cos(lo)))
    ys = float(np.mean(np.cos(la) * np.sin(lo)))
    zs = float(np.mean(np.sin(la)))
    hyp = math.sqrt(xs * xs + ys * ys)
    return [math.degrees(math.atan2(zs, hyp)),
            math.degrees(math.atan2(ys, xs)), float(np.mean(arr[:, 2]))]


class GeolocationModel(VectorizerModel):
    input_types = (Geolocation,)  # mirrors GeolocationVectorizer

    def __init__(self, fills: Sequence[Sequence[float]], track_nulls: bool = True,
                 operation_name: str = "vecGeo", uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.fills = [list(f) for f in fills]
        self.track_nulls = track_nulls

    def transform_block(self, cols: Sequence[Column]) -> np.ndarray:
        blocks = []
        for j, c in enumerate(cols):
            triples = triple_block(c.data, self.fills[j])
            if self.track_nulls:
                nulls = empty_mask(c.data).astype(np.float64)[:, None]
                triples = np.concatenate([triples, nulls], axis=1)
            blocks.append(triples)
        return np.concatenate(blocks, axis=1)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(fills=self.fills, track_nulls=self.track_nulls)
        return d


class GeolocationVectorizer(SequenceVectorizer):
    input_types = (Geolocation,)

    @classmethod
    def _declare_params(cls):
        return [
            Param("fill_with_mean", "impute with spherical mean", True),
            Param("fill_value", "constant (lat, lon, acc)", (0.0, 0.0, 0.0)),
            Param("track_nulls", "append null indicators", True),
        ]

    def __init__(self, operation_name: str = "vecGeo",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)

    def fit_columns(self, *cols: Column) -> GeolocationModel:
        track = self.get_param("track_nulls")
        fills = []
        for c in cols:
            if self.get_param("fill_with_mean"):
                vals = [v for v in c.data if v]
                fills.append(geo_mean(vals))
            else:
                fills.append(list(self.get_param("fill_value")))
        model = GeolocationModel(fills=fills, track_nulls=track,
                                 operation_name=self.operation_name)
        md_cols: List[VectorColumnMetadata] = []
        for f in self.input_features:
            for d in ("lat", "lon", "accuracy"):
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    descriptor_value=d))
            if track:
                md_cols.append(VectorColumnMetadata(
                    parent_feature_name=f.name, parent_feature_type=f.type_name,
                    indicator_value=NULL_STRING))
        model.set_metadata(VectorMetadata(name=self.output_name(), columns=md_cols))
        return model
