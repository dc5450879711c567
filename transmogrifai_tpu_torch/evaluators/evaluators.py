"""Binary, multiclass, bin-score, regression and custom evaluators
(counterpart of evaluators/evaluators.py).

Reference: core/.../evaluators/{OpBinaryClassificationEvaluator.scala:56,
OpMultiClassificationEvaluator.scala:58, OpBinScoreEvaluator.scala,
OpRegressionEvaluator.scala:61, Evaluators.scala:40}. `evaluate_all(labels, pred_col, w)` computes the
metric bundle of a Prediction column (models/prediction.py): AuROC, AuPR,
and precision / recall / F1 / error / confusion counts at the threshold
(probability `threshold` for probabilistic models, margin 0 for margin
models such as the linear SVC), plus the threshold curves. `evaluate`
returns the default metric of a Prediction column or of a score array;
validators rank models by it. A Prediction column's metrics run on the
evaluator's `device` (None = CUDA; the model selector and the workflow
fill it with theirs); a score array's where it lies. `RegressionEvaluator`
reports RMSE, MSE, MAE and R2 of a regression Prediction column on its
device; `MultiClassificationEvaluator` the weighted precision, recall,
F1 and error of the predicted classes on its device, with the top-N
accuracies and threshold counts of the probabilities; `BinScoreEvaluator`
the Brier score and calibration bins on the host, as the JAX package
computes them; `Evaluators.custom` wraps a user's metric function, which
validators can only call on host columns (their sequential route).
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import Column
from ..device import DeviceLike, resolve_device
from ..models.prediction import (n_classes_of, positive_score_of,
                                 prediction_of, probability_of)
from ..ops import metrics_ops as M

# metric name of a top-N hit rate, e.g. "top_1_accuracy"
_TOP_N_RE = re.compile(r"^top_(\d+)_accuracy$")

_SMALLER_BETTER = {"error", "rmse", "mse", "mae", "log_loss", "brier_score"}


class Evaluator:
    """Base: named, with a default metric and a larger-is-better flag."""

    name: str = "evaluator"
    default_metric: str = ""

    def __init__(self, metric: Optional[str] = None,
                 device: DeviceLike = None):
        if metric is not None:
            self.default_metric = metric
        self.device = device

    def evaluate_all(self, labels, pred_col: Column, w=None
                     ) -> Dict[str, Any]:
        raise NotImplementedError

    def evaluate(self, labels, pred_col: Column, w=None) -> float:
        """The default metric of a Prediction column."""
        return self.evaluate_all(labels, pred_col, w)[self.default_metric]

    def is_larger_better(self, metric: Optional[str] = None) -> bool:
        return (metric or self.default_metric) not in _SMALLER_BETTER

    @staticmethod
    def larger_better_metric(metric: str) -> bool:
        """Direction of a metric by name (single source of truth)."""
        return metric not in _SMALLER_BETTER

    def __repr__(self) -> str:
        return f"{type(self).__name__}(metric={self.default_metric})"


class BinaryClassificationEvaluator(Evaluator):
    """AuROC/AuPR/Precision/Recall/F1/Error/confusion counts."""

    name = "binEval"
    default_metric = "au_pr"

    def __init__(self, metric: Optional[str] = None, threshold: float = 0.5,
                 device: DeviceLike = None):
        super().__init__(metric, device)
        self.threshold = threshold
        if self.default_metric not in M.BinaryMetrics._fields:
            raise NotImplementedError(
                f"binary metric {self.default_metric!r} is not ported; the "
                f"port has {list(M.BinaryMetrics._fields)}")

    @staticmethod
    def _tensors(labels, scores, w, dev=None):
        """(scores, labels, weights) as float32 tensors on `dev` (None:
        the scores' device; host arrays stay on the host)."""
        s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
        y = torch.as_tensor(labels, dtype=torch.float32, device=s.device)
        wt = None if w is None else \
            torch.as_tensor(w, dtype=torch.float32, device=s.device)
        return s, y, wt

    def _scalar_metrics(self, labels, pred_col: Column,
                        w=None) -> Dict[str, float]:
        # non-probabilistic models (SVC) score by margin: the decision
        # boundary is 0, not probability 0.5
        thr = self.threshold if probability_of(pred_col) is not None else 0.0
        m = M.binary_metrics(
            *self._tensors(labels, positive_score_of(pred_col), w,
                           resolve_device(self.device)), thr)
        return {k: float(v) for k, v in m._asdict().items()}

    def evaluate(self, labels, scores, w=None) -> float:
        """The default metric of a Prediction column (computed on the
        evaluator's device), or of `scores` — the positive-class
        probability or any score monotone in it, for the rank metrics —
        computed where the scores lie (a tensor's device; host arrays on
        the host)."""
        if isinstance(scores, Column):
            return self._scalar_metrics(labels, scores, w)[
                self.default_metric]
        if self.default_metric not in ("au_pr", "au_roc"):
            raise ValueError(f"{self.default_metric} needs a Prediction "
                             "column: its threshold depends on the model")
        fn = M.au_pr if self.default_metric == "au_pr" else M.au_roc
        return float(fn(*self._tensors(labels, scores, w)))

    def evaluate_all(self, labels, pred_col: Column, w=None
                     ) -> Dict[str, Any]:
        """Scalar metrics + threshold curves (the summary path; curve
        values are lists, which summary builders filter on)."""
        out: Dict[str, Any] = self._scalar_metrics(labels, pred_col, w)
        out.update(self.threshold_curves(labels, pred_col, w))
        return out

    def threshold_curves(self, labels, pred_col: Column, w=None,
                         num_bins: int = 100) -> Dict[str, list]:
        """Per-threshold P/R/F1 + ROC points at num_bins score cutoffs
        (reference OpBinaryClassificationEvaluator.scala:68, numBins 100) —
        one sort + cumsums on the host, as in the JAX package."""
        score = np.asarray(positive_score_of(pred_col), np.float64)
        y = np.asarray(labels, np.float64)
        if len(y) == 0:
            return {k: [] for k in
                    ("thresholds", "precision_by_threshold",
                     "recall_by_threshold", "f1_by_threshold",
                     "false_positive_rate_by_threshold")}
        wv = np.ones_like(y) if w is None else np.asarray(w, np.float64)
        order = np.argsort(-score, kind="stable")
        ys, ws, ss = y[order], wv[order], score[order]
        tp_cum = np.cumsum(ws * ys)
        fp_cum = np.cumsum(ws * (1.0 - ys))
        P = max(tp_cum[-1], 1e-12)
        N = max(fp_cum[-1], 1e-12)
        lo, hi = float(ss.min()), float(ss.max())
        thresholds = np.linspace(hi, lo, num_bins)
        # rows with score >= t are predicted positive: index of the last
        # such row in descending order
        idx = np.searchsorted(-ss, -thresholds, side="right") - 1
        valid = idx >= 0
        tp = np.where(valid, tp_cum[np.maximum(idx, 0)], 0.0)
        fp = np.where(valid, fp_cum[np.maximum(idx, 0)], 0.0)
        precision = tp / np.maximum(tp + fp, 1e-12)
        recall = tp / P
        f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
        return {
            "thresholds": [float(t) for t in thresholds],
            "precision_by_threshold": [float(v) for v in precision],
            "recall_by_threshold": [float(v) for v in recall],
            "f1_by_threshold": [float(v) for v in f1],
            "false_positive_rate_by_threshold": [float(v) for v in fp / N],
        }


class BinScoreEvaluator(Evaluator):
    """Calibration bins and the Brier score of the positive-class score
    (reference OpBinScoreEvaluator.scala), on the host."""

    name = "binScoreEval"
    default_metric = "brier_score"

    def __init__(self, num_bins: int = 100, metric: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(metric, device)
        self.num_bins = num_bins

    def evaluate_all(self, labels, pred_col: Column, w=None
                     ) -> Dict[str, Any]:
        score = np.asarray(positive_score_of(pred_col), np.float64)
        y = np.asarray(labels, np.float64)
        if w is None:
            w = np.ones_like(y)
        brier = float((w * (score - y) ** 2).sum() / max(w.sum(), 1e-12))
        bins = np.clip((score * self.num_bins).astype(int), 0,
                       self.num_bins - 1)
        counts = np.bincount(bins, weights=w, minlength=self.num_bins)
        avg_score = np.bincount(bins, weights=w * score,
                                minlength=self.num_bins)
        avg_label = np.bincount(bins, weights=w * y, minlength=self.num_bins)
        nz = counts > 0
        avg_score[nz] /= counts[nz]
        avg_label[nz] /= counts[nz]
        return {
            "brier_score": brier,
            "bin_centers": list((np.arange(self.num_bins) + 0.5)
                                / self.num_bins),
            "bin_counts": [float(c) for c in counts],
            "bin_avg_scores": [float(v) for v in avg_score],
            "bin_avg_labels": [float(v) for v in avg_label],
        }


class MultiClassificationEvaluator(Evaluator):
    """Weighted precision/recall/F1/error and the top-N threshold metrics
    (reference OpMultiClassificationEvaluator.scala:58)."""

    name = "multiEval"
    default_metric = "error"

    def __init__(self, metric: Optional[str] = None,
                 top_ns: Sequence[int] = (1, 3), device: DeviceLike = None):
        super().__init__(metric, device)
        self.top_ns = tuple(top_ns)

    def _scalar_metrics(self, labels, pred_col: Column,
                        w=None) -> Dict[str, float]:
        y = np.asarray(labels, np.float32)
        pred = np.asarray(prediction_of(pred_col), np.float32)
        n_classes = max(int(y.max()) + 1 if y.size else 1,
                        n_classes_of(pred_col),
                        int(pred.max()) + 1 if pred.size else 1)
        dev = resolve_device(self.device)
        m = M.multiclass_metrics(
            torch.as_tensor(pred, device=dev), torch.as_tensor(y, device=dev),
            n_classes, None if w is None else
            torch.as_tensor(np.asarray(w, np.float32), device=dev))
        return {k: float(v) for k, v in m._asdict().items()}

    @staticmethod
    def _top_n(y, prob, w, n: int) -> float:
        ww = np.ones_like(y) if w is None else np.asarray(w, np.float64)
        hit = (np.argsort(-prob, axis=1)[:, :n]
               == y[:, None].astype(int)).any(axis=1)
        return float((ww * hit).sum() / max(ww.sum(), 1e-12))

    def evaluate(self, labels, pred_col: Column, w=None) -> float:
        """The default metric; a top-N accuracy needs only the host's
        argsort of the probabilities."""
        m = _TOP_N_RE.match(self.default_metric)
        if m:
            prob = probability_of(pred_col)
            if prob is None or not prob.size:
                return float("nan")
            return self._top_n(np.asarray(labels, np.float32), prob, w,
                               int(m.group(1)))
        return self._scalar_metrics(labels, pred_col, w)[self.default_metric]

    def evaluate_all(self, labels, pred_col: Column, w=None
                     ) -> Dict[str, Any]:
        y = np.asarray(labels, np.float32)
        prob = probability_of(pred_col)
        out: Dict[str, Any] = self._scalar_metrics(labels, pred_col, w)
        if prob is not None and prob.size:
            for topn in self.top_ns:
                out[f"top_{topn}_accuracy"] = self._top_n(y, prob, w, topn)
            # unweighted counts, as the reference's
            dev = resolve_device(self.device)
            tm = M.multiclass_threshold_metrics(
                torch.as_tensor(np.asarray(prob, np.float32), device=dev),
                torch.as_tensor(y, device=dev), top_ns=self.top_ns)
            out["threshold_metrics"] = tm.to_json()
        return out


class RegressionEvaluator(Evaluator):
    """RMSE/MSE/MAE/R2 (reference OpRegressionEvaluator.scala:61)."""

    name = "regEval"
    default_metric = "rmse"

    def __init__(self, metric: Optional[str] = None,
                 device: DeviceLike = None):
        super().__init__(metric, device)
        if self.default_metric not in M.RegressionMetrics._fields:
            raise ValueError(
                f"unknown regression metric {self.default_metric!r}; "
                f"there are {list(M.RegressionMetrics._fields)}")

    def evaluate_all(self, labels, pred_col: Column, w=None
                     ) -> Dict[str, Any]:
        dev = resolve_device(self.device)
        pred = torch.as_tensor(np.asarray(prediction_of(pred_col),
                                          np.float32), device=dev)
        y = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
        wt = None if w is None else \
            torch.as_tensor(np.asarray(w, np.float32), device=dev)
        m = M.regression_metrics(pred, y, wt)
        return {k: float(v) for k, v in m._asdict().items()}


class CustomEvaluator(Evaluator):
    """A user's metric (reference Evaluators.*.custom):
    `evaluate_fn(labels, pred_col, w) -> float` under a name and a
    direction. No kernel computes it, so validators run every candidate
    through their sequential route, the one that calls `evaluate` on host
    columns."""

    name = "customEval"
    device_metric = False

    def __init__(self, metric_name: str, larger_better: bool, evaluate_fn,
                 device: DeviceLike = None):
        super().__init__(metric_name, device)
        self.larger_better = bool(larger_better)
        self._fn = evaluate_fn

    @property
    def metric_key(self) -> str:
        """Checkpoint identity: the metric's name and a fingerprint of the
        function's bytecode, so an edited function never replays cells of
        the old one."""
        import hashlib
        try:
            code = self._fn.__code__
            fp = hashlib.sha1(code.co_code + repr(code.co_consts).encode()
                              ).hexdigest()[:10]
        except AttributeError:      # a callable object
            fp = type(self._fn).__name__
        return f"{self.default_metric}@{fp}"

    def evaluate_all(self, labels, pred_col: Column, w=None
                     ) -> Dict[str, Any]:
        return {self.default_metric: float(self._fn(labels, pred_col, w))}

    def is_larger_better(self, metric: Optional[str] = None) -> bool:
        return self.larger_better


class Evaluators:
    """Factory namespace (reference Evaluators.scala:40)."""

    @staticmethod
    def custom(metric_name: str, larger_better: bool,
               evaluate_fn) -> CustomEvaluator:
        """Reference Evaluators.*.custom(metricName, isLargerBetter,
        evaluateFn); `evaluate_fn(labels, pred_col, w) -> float`."""
        return CustomEvaluator(metric_name, larger_better, evaluate_fn)

    class BinaryClassification:
        @staticmethod
        def au_pr() -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(metric="au_pr")

        auPR = au_pr

        @staticmethod
        def au_roc() -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(metric="au_roc")

        auROC = au_roc

        @staticmethod
        def precision() -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(metric="precision")

        @staticmethod
        def recall() -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(metric="recall")

        @staticmethod
        def f1() -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(metric="f1")

        @staticmethod
        def error() -> BinaryClassificationEvaluator:
            return BinaryClassificationEvaluator(metric="error")

        @staticmethod
        def brier_score() -> BinScoreEvaluator:
            return BinScoreEvaluator()

    class MultiClassification:
        @staticmethod
        def precision() -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(metric="precision")

        @staticmethod
        def recall() -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(metric="recall")

        @staticmethod
        def f1() -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(metric="f1")

        @staticmethod
        def error() -> MultiClassificationEvaluator:
            return MultiClassificationEvaluator(metric="error")

    class Regression:
        @staticmethod
        def rmse() -> RegressionEvaluator:
            return RegressionEvaluator(metric="rmse")

        @staticmethod
        def mse() -> RegressionEvaluator:
            return RegressionEvaluator(metric="mse")

        @staticmethod
        def mae() -> RegressionEvaluator:
            return RegressionEvaluator(metric="mae")

        @staticmethod
        def r2() -> RegressionEvaluator:
            return RegressionEvaluator(metric="r2")
