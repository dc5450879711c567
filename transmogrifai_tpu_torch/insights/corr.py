"""RecordInsightsCorr: correlation-based per-record insights (counterpart
of insights/corr.py).

Reference: core/.../impl/insights/RecordInsightsCorr.scala — per-column
Pearson correlation between feature values and the model's score over the
scored batch; each record's insight is the correlation-weighted, centered
feature value (columns that both correlate with the score and deviate from
their mean on this record rank highest).

From _FUSED_MIN_ELEMENTS matrix elements the column means, deviations and
score cross-moments come from one pass of the statistics engine
(ops/stats_engine.run_stats, float64 sums) on the stage's device (None:
CUDA), with the score as the label and the population sd from the returned
M2; a smaller batch takes two numpy reductions on the host. The
per-record contribution assembly is O(n * d) host work either way.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np

from ..data.dataset import Column, column_from_values
from ..stages.base import Transformer
from ..types import OPVector, Prediction, TextMap

EPS = 1e-12

# Elements below which the scored batch stays on the numpy reductions:
# transform-time batches vary in shape (a ragged last batch, a serving
# request), and a copy to the device and back costs more than two
# vectorized numpy passes until the matrix is big enough to be
# bandwidth-bound.
_FUSED_MIN_ELEMENTS = 1 << 20


class RecordInsightsCorr(Transformer):
    """(features OPVector, prediction) -> TextMap of top-K contributions."""

    input_types = (OPVector, Prediction)
    output_type = TextMap

    def __init__(self, top_k: int = 20, uid: Optional[str] = None, **params):
        self.top_k = int(top_k)
        super().__init__(params.pop("operation_name", "corrInsights"),
                         uid=uid, **params)

    @staticmethod
    def _scores(pred_col: Column) -> np.ndarray:
        """Score per row: the last probability column when present
        (P(class 1) for binary), else the prediction itself. Prediction
        columns are dense [pred, raw_*, prob_*] blocks with named metadata;
        map-kind columns of Prediction dicts (the row-level API boundary)
        are also accepted."""
        if pred_col.data.dtype == object:
            out = np.empty(len(pred_col.data), np.float64)
            for i, m in enumerate(pred_col.data):
                prob_keys = sorted(
                    (k for k in m if k.startswith("probability_")),
                    key=lambda k: int(k.rsplit("_", 1)[1]))
                out[i] = m[prob_keys[-1]] if prob_keys else m["prediction"]
            return out
        data = np.asarray(pred_col.data, np.float64)
        if data.ndim == 1:
            return data
        md = pred_col.metadata
        if md is not None:
            prob_idx = [c.index for c in md.columns
                        if (c.descriptor_value or "").startswith(
                            "probability_")]
            if prob_idx:
                return data[:, prob_idx[-1]]
        return data[:, 0]

    def transform_columns(self, *cols: Column) -> Column:
        from ..ops import stats_engine as SE

        vec, pred = cols
        X = np.asarray(vec.data, np.float64)          # [n, d]
        s = self._scores(pred)                        # [n]
        n, d = X.shape
        names = (vec.metadata.column_names() if vec.metadata is not None
                 else [f"f{j}" for j in range(d)])
        if X.size >= _FUSED_MIN_ELEMENTS:
            # means + score cross-moments in one engine pass; population
            # sd reconstructed from the returned M2 (np.std's convention)
            st = SE.run_stats(np.asarray(vec.data, np.float32),
                              s.astype(np.float32), device=self.device)
            mu = st.mean
            sd = np.sqrt(np.maximum(st.m2 / np.maximum(st.count, 1.0),
                                    0.0)) + EPS
            corr = st.corr_label
        else:
            mu = X.mean(axis=0)
            sd = X.std(axis=0) + EPS
            s_c = s - s.mean()
            corr = ((X - mu) * s_c[:, None]).sum(axis=0) / (
                n * sd * (s.std() + EPS))
        contrib = corr[None, :] * (X - mu) / sd       # [n, d]
        k = min(self.top_k, d)
        vals: List[Dict[str, str]] = []
        for i in range(n):
            order = np.argsort(-np.abs(contrib[i]))[:k]
            vals.append({names[j]: json.dumps(
                {"contribution": float(contrib[i, j]),
                 "correlation": float(corr[j])}) for j in order})
        return column_from_values(TextMap, vals)

    def transform_value(self, *vals):
        # single-record correlation is undefined; emit empty (the
        # reference's Corr insights are batch-only as well)
        return TextMap({})

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(top_k=self.top_k)
        return d
