"""Binary rank metrics and regression metrics in PyTorch (counterpart of
ops/metrics_ops.py).

`au_pr` / `au_roc` are sort-based with exact tie handling (metrics taken at
threshold boundaries only), matching Spark MLlib's
BinaryClassificationMetrics. The lane-batched binned forms score every CV
fold of a sweep cell at once from a score histogram: one `hist_folds`
launch over all lanes (the lane is the slot axis), no sort. Every function
takes row weights, so fold masks cost nothing. `binary_metrics` adds the thresholded metrics
(precision, recall, F1, error, confusion counts) the evaluators report.
`regression_metrics` gives RMSE, MSE, MAE and R2, weighted, for one lane or
for lanes along the leading axes.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from . import tree_kernels as TK

EPS = 1e-12


def _sorted_cum_counts(scores, labels, w: Optional[torch.Tensor] = None):
    """Sort by score desc; cumulative weighted TP/FP; tie-boundary mask
    (the last row of each group of equal scores)."""
    if w is None:
        w = torch.ones_like(scores)
    order = torch.argsort(-scores, stable=True)
    s = scores[order]
    tps = torch.cumsum(labels[order] * w[order], 0)
    fps = torch.cumsum((1.0 - labels[order]) * w[order], 0)
    nxt = torch.cat([s[1:], s.new_full((1,), -float("inf"))])
    return tps, fps, s != nxt


def au_roc(scores: torch.Tensor, labels: torch.Tensor,
           w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area under ROC (trapezoid over tie-boundary points)."""
    tps, fps, boundary = _sorted_cum_counts(scores, labels, w)
    tpr = (tps / torch.clamp(tps[-1], min=EPS))[boundary]
    fpr = (fps / torch.clamp(fps[-1], min=EPS))[boundary]
    zero = tpr.new_zeros(1)
    dfpr = torch.diff(fpr, prepend=zero)
    return (dfpr * (tpr + torch.cat([zero, tpr[:-1]])) * 0.5).sum()


def au_pr(scores: torch.Tensor, labels: torch.Tensor,
          w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Area under precision-recall (step interpolation / average precision)."""
    tps, fps, boundary = _sorted_cum_counts(scores, labels, w)
    recall = (tps / torch.clamp(tps[-1], min=EPS))[boundary]
    precision = (tps / torch.clamp(tps + fps, min=EPS))[boundary]
    return (torch.diff(recall, prepend=recall.new_zeros(1)) * precision).sum()


def _bin_idx(scores: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Score -> bucket rule of every binned-counts route (through a sigmoid,
    monotone, so margins and probabilities rank alike)."""
    p = torch.sigmoid(scores.to(torch.float32))
    return torch.clamp((p * n_bins).to(torch.int32), 0, n_bins - 1)


def binned_cum_counts_lanes(scores: torch.Tensor, labels: torch.Tensor,
                            w_lanes: torch.Tensor, n_bins: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane weighted TP/FP cumulative counts [L, n_bins] from the high
    score end: scores [L, n] (one lane per fold over the SAME rows), labels
    [n], w_lanes [L, n]. One `hist_folds` call for all lanes: the bucket is
    the bin axis (F = 1), the lane the slot axis, and the positive and
    negative weights the two payload channels."""
    L, n = scores.shape
    total = L * n
    idx = _bin_idx(scores, n_bins).reshape(1, total)
    pay = torch.stack([(w_lanes * labels[None, :]).reshape(total),
                       (w_lanes * (1.0 - labels[None, :])).reshape(total)])
    lane = torch.arange(L, dtype=torch.float32, device=scores.device)
    lane = lane.repeat_interleave(n)[None, :]
    hist = TK.hist_folds(idx, pay, lane, n_slots=L,
                         n_bins=n_bins).reshape(L, 2, n_bins)
    tps = torch.cumsum(hist[:, 0].flip(-1), dim=1)
    fps = torch.cumsum(hist[:, 1].flip(-1), dim=1)
    return tps, fps


def _au_pr_from_counts(tps: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Average precision from cumulative counts; bins on the LAST axis."""
    recall = tps / torch.clamp(tps[..., -1:], min=EPS)
    precision = tps / torch.clamp(tps + fps, min=EPS)
    dr = torch.diff(recall, dim=-1, prepend=torch.zeros_like(recall[..., :1]))
    return (dr * precision).sum(dim=-1)


def _au_roc_from_counts(tps: torch.Tensor, fps: torch.Tensor) -> torch.Tensor:
    """Trapezoid AuROC from cumulative counts; bins on the LAST axis."""
    tpr = tps / torch.clamp(tps[..., -1:], min=EPS)
    fpr = fps / torch.clamp(fps[..., -1:], min=EPS)
    zero = torch.zeros_like(tpr[..., :1])
    dfpr = torch.diff(fpr, dim=-1, prepend=zero)
    tpr_prev = torch.cat([zero, tpr[..., :-1]], dim=-1)
    return (dfpr * (tpr + tpr_prev) * 0.5).sum(dim=-1)


def au_pr_binned_lanes(scores, labels, w_lanes, n_bins: int) -> torch.Tensor:
    """[L] average precision from per-lane binned counts: the score mass
    sharing a 1/n_bins-wide bucket is the approximation (~1e-4 at 4096 bins
    for smooth score distributions)."""
    return _au_pr_from_counts(
        *binned_cum_counts_lanes(scores, labels, w_lanes, n_bins))


def au_roc_binned_lanes(scores, labels, w_lanes, n_bins: int) -> torch.Tensor:
    """[L] AuROC from per-lane binned counts."""
    return _au_roc_from_counts(
        *binned_cum_counts_lanes(scores, labels, w_lanes, n_bins))


class BinaryMetrics(NamedTuple):
    au_roc: torch.Tensor
    au_pr: torch.Tensor
    precision: torch.Tensor
    recall: torch.Tensor
    f1: torch.Tensor
    error: torch.Tensor
    tp: torch.Tensor
    tn: torch.Tensor
    fp: torch.Tensor
    fn: torch.Tensor


def binary_metrics(scores: torch.Tensor, labels: torch.Tensor,
                   w: Optional[torch.Tensor] = None,
                   threshold: float = 0.5) -> BinaryMetrics:
    """The rank metrics and the confusion counts at `threshold` (rows with
    score >= threshold predicted positive), weighted."""
    if w is None:
        w = torch.ones_like(scores)
    pred = (scores >= threshold).to(scores.dtype)
    tp = (w * pred * labels).sum()
    fp = (w * pred * (1 - labels)).sum()
    tn = (w * (1 - pred) * (1 - labels)).sum()
    fn = (w * (1 - pred) * labels).sum()
    precision = tp / torch.clamp(tp + fp, min=EPS)
    recall = tp / torch.clamp(tp + fn, min=EPS)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=EPS)
    error = (fp + fn) / torch.clamp(tp + tn + fp + fn, min=EPS)
    return BinaryMetrics(
        au_roc=au_roc(scores, labels, w), au_pr=au_pr(scores, labels, w),
        precision=precision, recall=recall, f1=f1, error=error,
        tp=tp, tn=tn, fp=fp, fn=fn)


class RegressionMetrics(NamedTuple):
    rmse: torch.Tensor
    mse: torch.Tensor
    mae: torch.Tensor
    r2: torch.Tensor


def regression_metrics(pred: torch.Tensor, labels: torch.Tensor,
                       w: Optional[torch.Tensor] = None) -> RegressionMetrics:
    """Weighted RMSE, MSE, MAE and R2 of predictions against labels. The
    rows are the last axis: `pred` or `w` [L, n] give [L] metrics, one a
    lane (the sweep's folds or grid points), with labels [n] shared."""
    if w is None:
        w = torch.ones_like(pred)
    tot = torch.clamp(w.sum(-1), min=EPS)
    err = pred - labels
    ss_res = (w * err * err).sum(-1)
    mse = ss_res / tot
    mae = (w * torch.abs(err)).sum(-1) / tot
    ybar = (w * labels).sum(-1) / tot
    ss_tot = (w * (labels - ybar[..., None]) ** 2).sum(-1)
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=EPS)
    return RegressionMetrics(rmse=torch.sqrt(mse), mse=mse, mae=mae, r2=r2)
