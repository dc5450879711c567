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
for lanes along the leading axes. `multiclass_metrics` gives the weighted
precision, recall, F1 and error from one confusion-matrix product, and
`multiclass_threshold_metrics` the top-N counts per threshold of the
reference's multiclass evaluator.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

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


class MultiMetrics(NamedTuple):
    precision: torch.Tensor  # weighted by each true class's share
    recall: torch.Tensor
    f1: torch.Tensor
    error: torch.Tensor


def multiclass_metrics(pred: torch.Tensor, labels: torch.Tensor,
                       n_classes: int,
                       w: Optional[torch.Tensor] = None) -> MultiMetrics:
    """Weighted precision, recall, F1 and error from predicted and true
    class ids: the confusion matrix [true, pred] is one product of the
    row-weighted true one-hot with the predicted one-hot; the per-class
    values are averaged with each true class's weight share."""
    if w is None:
        w = torch.ones(pred.shape, dtype=torch.float32, device=pred.device)
    P = torch.nn.functional.one_hot(pred.long(), n_classes).to(w.dtype)
    Y = torch.nn.functional.one_hot(labels.long(), n_classes).to(w.dtype) \
        * w[:, None]
    conf = Y.T @ P
    tp = torch.diagonal(conf)
    per_pred = conf.sum(dim=0)
    per_true = conf.sum(dim=1)
    prec_c = tp / torch.clamp(per_pred, min=EPS)
    rec_c = tp / torch.clamp(per_true, min=EPS)
    f1_c = 2 * prec_c * rec_c / torch.clamp(prec_c + rec_c, min=EPS)
    weights = per_true / torch.clamp(per_true.sum(), min=EPS)
    return MultiMetrics(
        precision=(prec_c * weights).sum(), recall=(rec_c * weights).sum(),
        f1=(f1_c * weights).sum(),
        error=1.0 - tp.sum() / torch.clamp(conf.sum(), min=EPS))


class ThresholdMetrics(NamedTuple):
    """Top-N correctness counts per threshold (the reference's
    OpMultiClassificationEvaluator ThresholdMetrics). For each (top-N,
    threshold) cell over n rows: correct, the true class's score in the top
    N and >= threshold; incorrect, the top score >= threshold and the true
    class not in the top N or below the threshold; no_prediction, the top
    score below the threshold. The three [len(top_ns), T] counts sum to n
    in every cell."""

    top_ns: Tuple[int, ...]
    thresholds: torch.Tensor            # [T]
    correct_counts: torch.Tensor        # [len(top_ns), T] int32
    incorrect_counts: torch.Tensor      # [len(top_ns), T] int32
    no_prediction_counts: torch.Tensor  # [len(top_ns), T] int32

    def to_json(self) -> Dict[str, object]:
        def per_n(counts):
            return {str(t): counts[i].tolist()
                    for i, t in enumerate(self.top_ns)}
        return {"top_ns": list(self.top_ns),
                "thresholds": self.thresholds.tolist(),
                "correct_counts": per_n(self.correct_counts),
                "incorrect_counts": per_n(self.incorrect_counts),
                "no_prediction_counts": per_n(self.no_prediction_counts)}


def _threshold_counts(probs, labels, thresholds, top_ns):
    """(correct, incorrect) [len(top_ns), T] int32 counts in one pass over
    [n, C] scores, no sort: the true class's rank under a stable
    descending sort is the count of strictly greater scores plus equal
    scores at a lower class index; each row's threshold cut-off is the
    first threshold above its score (T where none is)."""
    C = probs.shape[1]
    T = thresholds.shape[0]
    lbl = labels.long()
    valid = (lbl >= 0) & (lbl < C)
    onehot = torch.nn.functional.one_hot(torch.where(valid, lbl, 0), C) \
        .to(probs.dtype)
    s_true = torch.where(valid, (probs * onehot).sum(1), 0.0)
    s_top = probs.max(dim=1).values
    idx = torch.arange(C, device=probs.device)[None, :]
    rank = ((probs > s_true[:, None]).sum(1)
            + ((probs == s_true[:, None]) & (idx < lbl[:, None])).sum(1))

    def cutoff(score):
        over = thresholds[None, :] > score[:, None]           # [n, T]
        return torch.where(over.any(1), torch.argmax(over.to(torch.int8), 1),
                           T)
    k = torch.arange(T, device=probs.device)[None, :]
    before_true = k < cutoff(s_true)[:, None]
    before_top = k < cutoff(s_top)[:, None]
    correct, incorrect = [], []
    for t in top_ns:
        in_topn = (valid & (rank < t))[:, None]
        corr = in_topn & before_true
        incorr = torch.where(in_topn, ~before_true & before_top, before_top)
        correct.append(corr.sum(0, dtype=torch.int32))
        incorrect.append(incorr.sum(0, dtype=torch.int32))
    return torch.stack(correct), torch.stack(incorrect)


def multiclass_threshold_metrics(probs: torch.Tensor, labels: torch.Tensor,
                                 top_ns: Tuple[int, ...] = (1, 3),
                                 thresholds: Optional[torch.Tensor] = None
                                 ) -> ThresholdMetrics:
    """Top-N threshold metrics of multiclass probabilities [n, C] (the
    reference's calculateThresholdMetrics; thresholds 0.00 to 1.00 in steps
    of 0.01 by default)."""
    if thresholds is None:
        thresholds = torch.arange(101, dtype=torch.float32,
                                  device=probs.device) / 100.0
    else:
        thresholds = torch.as_tensor(thresholds, dtype=torch.float32,
                                     device=probs.device)
    top_ns = tuple(int(t) for t in top_ns)
    if not top_ns or any(t <= 0 for t in top_ns):
        raise ValueError("top_ns must be non-empty positive ints")
    correct, incorrect = _threshold_counts(probs, labels, thresholds, top_ns)
    return ThresholdMetrics(
        top_ns=top_ns, thresholds=thresholds, correct_counts=correct,
        incorrect_counts=incorrect,
        no_prediction_counts=probs.shape[0] - correct - incorrect)


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
