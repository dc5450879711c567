"""RecordInsightsLOCO: per-row leave-one-column-out attribution
(counterpart of insights/loco.py).

Reference: core/.../impl/insights/RecordInsightsLOCO.scala:62 — for each
row, each feature-vector column is knocked out (set to the vector's zero)
and the fitted model re-scored; the top-K absolute score deltas are emitted
as an ordered map {column_name: [(class, delta), ...]}.

The knockouts of a known model family are one batched device program
(insights/knockout.py); any other model takes one forward pass per column
over the whole row block (`insights_matrix_loop`, also the parity oracle).
The knockouts run on the stage's device, else the model's (None: CUDA). A
model the stage rebuilt from its saved args takes the stage's device; a
model handed in keeps its own.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.dataset import Column, column_from_values
from ..stages.base import Transformer
from ..types import OPVector, TextMap
from ..types.base import ColumnKind


def _place(model: Any, device) -> None:
    """Give `model` (and a SelectedModel's winner) `device` where it has
    none."""
    if device is None or model is None:
        return
    if hasattr(model, "device") and model.device is None:
        model.device = device
    _place(getattr(model, "best_model", None), device)


class RecordInsightsLOCO(Transformer):
    """Transformer: features OPVector -> TextMap of top-K column deltas."""

    input_types = (OPVector,)
    output_type = TextMap

    def __init__(self, model: Any = None, top_k: int = 20,
                 operation_name: str = "locoInsights",
                 uid: Optional[str] = None, **params):
        super().__init__(operation_name, uid=uid, **params)
        self.model = model
        self.top_k = int(top_k)
        # True for a model from_save_args rebuilt: the stage places it
        self._owns_model = False

    # -- scoring ------------------------------------------------------------
    def _placed_model(self):
        if self._owns_model:
            _place(self.model, self.device)
        return self.model

    def _base_scores(self, X: np.ndarray) -> np.ndarray:
        """Score vector used for deltas: P(class) columns when the model is
        probabilistic, else margin/prediction (the reference uses
        rawPrediction per class)."""
        pred, raw, prob = self._placed_model().predict_arrays(X)
        if prob is not None:
            return np.asarray(prob, np.float64)
        if raw is not None:
            return np.asarray(raw, np.float64)
        return np.asarray(pred, np.float64)[:, None]

    def insights_matrix(self, X: np.ndarray) -> np.ndarray:
        """[n, d, c] deltas: base_score - score_with_column_zeroed.

        Known model families take one device program per family
        (insights/knockout.py: closed-form GLM shifts, the tree
        re-traversal over the ensemble's active features); anything else
        falls back to the one-pass-per-column loop below."""
        X = np.ascontiguousarray(X, np.float32)
        from .knockout import knockout_deltas
        batched = knockout_deltas(self._placed_model(), X,
                                  device=self.device)
        if batched is not None:
            return batched
        return self.insights_matrix_loop(X)

    def insights_matrix_loop(self, X: np.ndarray) -> np.ndarray:
        """Generic knockout loop (one forward pass per column); also the
        parity oracle for the batched routes."""
        X = np.ascontiguousarray(X, np.float32)
        base = self._base_scores(X)                       # [n, c]
        n, d = X.shape
        out = np.zeros((n, d, base.shape[1]), np.float64)
        for j in range(d):
            Xj = X.copy()
            Xj[:, j] = 0.0
            out[:, j, :] = base - self._base_scores(Xj)
        return out

    # -- column path ---------------------------------------------------------
    def transform_columns(self, *cols: Column) -> Column:
        vec = cols[-1]
        X = np.asarray(vec.data, np.float32)
        names = (vec.metadata.column_names() if vec.metadata is not None
                 else [f"f{j}" for j in range(X.shape[1])])
        deltas = self.insights_matrix(X)                  # [n, d, c]
        strength = np.abs(deltas).max(axis=2)             # [n, d]
        k = min(self.top_k, X.shape[1])
        # top-k per row in one vectorized argpartition + within-k sort
        orders = np.argpartition(-strength, kth=k - 1, axis=1)[:, :k]
        part = np.take_along_axis(strength, orders, axis=1)
        orders = np.take_along_axis(orders, np.argsort(-part, axis=1), axis=1)
        n_classes = deltas.shape[2]
        vals: List[Dict[str, Any]] = []
        for i in range(X.shape[0]):
            # TextMap values are strings: per-class deltas as JSON, matching
            # the reference's serialized insight arrays
            vals.append({
                names[j]: json.dumps([[int(c), float(deltas[i, j, c])]
                                      for c in range(n_classes)])
                for j in orders[i]
            })
        return column_from_values(TextMap, vals)

    def transform_value(self, *vals):
        X = np.asarray(vals[-1].value, np.float32)[None, :]
        col = self.transform_columns(
            Column(kind=ColumnKind.VECTOR, data=X,
                   metadata=getattr(vals[-1], "metadata", None)))
        return TextMap(col.data[0])

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(top_k=self.top_k,
                 model_class=type(self.model).__name__ if self.model else None,
                 model_args=self.model.save_args() if self.model else None)
        return d

    @classmethod
    def from_save_args(cls, args: Dict[str, Any]) -> "RecordInsightsLOCO":
        """The wrapped model rebuilt through the registry (the JAX
        package's save or the port's); it runs on the stage's device."""
        model = None
        if args.get("model_class"):
            from ..stages.registry import build_stage
            model = build_stage(args["model_class"], args["model_args"])
        stage = cls(model=model, top_k=args.get("top_k", 20),
                    operation_name=args.get("operation_name", "locoInsights"),
                    uid=args.get("uid"))
        stage._owns_model = model is not None
        return stage
