"""ModelSelector: validated model search + final refit (counterpart of
automl/selector.py).

Reference: core/.../impl/selector/ModelSelector.scala:73 (fit:135 — splitter
prep, validator.validate, best-estimator refit on the full prepared train
set, train/holdout evaluation, ModelSelectorSummary metadata; SelectedModel
:216) and ModelSelectorSummary.scala. The sweep is the port's
`Validator.validate` (folds as weight masks on the device); the
selector's `device` (None = CUDA) fills the device of its validator,
evaluators and candidate estimators where those have none. A
workflow-level CV (Workflow.with_workflow_cv) narrows `models` to its
winner before the fit and leaves its sweep in
`_extra_validation_results`, which the summary lists first.
`SelectedModel.save_args()` is plain numpy and JSON; `from_save_args`
rebuilds the wrapped best model on a device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import DeviceLike
from ..evaluators.evaluators import Evaluator
from ..models.base import PredictionModel, PredictorEstimator
from ..models.prediction import make_prediction_column
from ..stages.params import ParamMap
from .tuning.splitters import PreparedData, Splitter
from .tuning.validators import BestEstimator, Validator


@dataclass
class ModelSelectorSummary:
    """Validation results metadata (reference ModelSelectorSummary.scala)."""

    validation_type: str
    validation_parameters: Dict[str, Any]
    data_prep_parameters: Dict[str, Any]
    data_prep_results: Dict[str, Any]
    evaluation_metric: str
    problem_type: str
    best_model_uid: str
    best_model_name: str
    best_model_type: str
    best_grid: ParamMap
    validation_results: List[Dict[str, Any]] = field(default_factory=list)
    train_evaluation: Dict[str, float] = field(default_factory=dict)
    holdout_evaluation: Dict[str, float] = field(default_factory=dict)
    # direction of evaluation_metric as the EVALUATOR declared it — name
    # lookup alone misranks custom smaller-is-better metrics; None (old
    # saved summaries) falls back to the name-based table
    metric_larger_better: Optional[bool] = None

    def to_json(self) -> Dict[str, Any]:
        from dataclasses import asdict
        return asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ModelSelectorSummary":
        return ModelSelectorSummary(**d)

    def pretty(self) -> str:
        """Human summary mirroring the reference's summaryPretty tables."""
        lines = [
            f"Evaluated {len(self.validation_results)} model configurations "
            f"({self.validation_type}, metric: {self.evaluation_metric})",
            f"Selected: {self.best_model_name} "
            f"(uid {self.best_model_uid}) grid={self.best_grid}",
        ]
        larger = (self.metric_larger_better
                  if self.metric_larger_better is not None
                  else _larger_better(self.evaluation_metric))
        ranked = sorted(
            self.validation_results,
            key=lambda v: v.get("mean_metric", float("nan")),
            reverse=larger)
        from ..utils.table import format_table
        lines.append(format_table(
            ["Model", "Grid", self.evaluation_metric],
            [[v["model_name"], str(v.get("grid", {})),
              float(v.get("mean_metric", float("nan")))]
             for v in ranked[:20]],
            title="Evaluated models"))
        if self.train_evaluation:
            lines.append("Train evaluation: " + ", ".join(
                f"{k}={v:.6f}" for k, v in sorted(self.train_evaluation.items())
                if isinstance(v, float)))
        if self.holdout_evaluation:
            lines.append("Holdout evaluation: " + ", ".join(
                f"{k}={v:.6f}" for k, v in sorted(self.holdout_evaluation.items())
                if isinstance(v, float)))
        return "\n".join(lines)


def _larger_better(metric: str) -> bool:
    return Evaluator.larger_better_metric(metric)


def _remap_labels(arr: np.ndarray, mapping: Dict[int, int]) -> np.ndarray:
    """Vectorized label remap that is safe on empty arrays."""
    out = np.asarray(arr, np.float32).copy()
    for src, dst in mapping.items():
        out[np.asarray(arr) == src] = dst
    return out


class SelectedModel(PredictionModel):
    """The fitted winner (reference SelectedModel, ModelSelector.scala:216):
    delegates scoring to the wrapped best model; carries the summary."""

    def __init__(self, best_model: PredictionModel,
                 summary: ModelSelectorSummary,
                 label_map: Optional[Dict[int, int]] = None,
                 operation_name: str = "modelSelector",
                 uid: Optional[str] = None, device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.best_model = best_model
        self.summary = summary
        self.label_map = label_map

    def predict_arrays(self, X):
        pred, raw, prob = self.best_model.predict_arrays(X)
        if self.label_map:
            inv = {v: k for k, v in self.label_map.items()}
            if any(k != v for k, v in inv.items()):
                pred = _remap_labels(pred, inv)
        return pred, raw, prob

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(
            best_model_class=type(self.best_model).__name__,
            best_model_args=self.best_model.save_args(),
            summary=self.summary.to_json(),
            label_map={str(k): v for k, v in (self.label_map or {}).items()},
        )
        return d

    @classmethod
    def from_save_args(cls, args: Dict[str, Any],
                       device: DeviceLike = None) -> "SelectedModel":
        """Reference ModelSelector.scala:235-240: the wrapped best model is
        rebuilt from its own class and args (the JAX package's or the
        port's), it and the selected model on `device`."""
        from ..stages.registry import build_stage
        best = build_stage(args["best_model_class"],
                           args["best_model_args"], device=device)
        return cls(
            best_model=best,
            summary=ModelSelectorSummary.from_json(args["summary"]),
            label_map={int(k): int(v) for k, v in
                       (args.get("label_map") or {}).items()} or None,
            operation_name=args.get("operation_name", "modelSelector"),
            uid=args.get("uid"), device=device)


class ModelSelector(PredictorEstimator):
    """Estimator2(RealNN label, OPVector features) -> Prediction running the
    validated sweep (reference ModelSelector.scala:73)."""

    problem_type = "binary"

    def __init__(self, validator: Validator, splitter: Optional[Splitter],
                 models: Sequence[Tuple[PredictorEstimator, List[ParamMap]]],
                 evaluators: Sequence[Evaluator] = (),
                 operation_name: str = "modelSelector",
                 uid: Optional[str] = None, device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.validator = validator
        self.splitter = splitter
        self.models = list(models)
        self.extra_evaluators = list(evaluators)
        # wall seconds of the last fit: "sweep", "refit", "evaluate"
        self.walls: Dict[str, float] = {}

    def _bind_device(self) -> None:
        """The selector's device for every part of the sweep that has
        none (a part given its own device keeps it)."""
        parts = [self.validator, self.validator.evaluator,
                 *self.extra_evaluators, *(est for est, _ in self.models)]
        for part in parts:
            if part.device is None:
                part.device = self.device

    # -- the sweep ---------------------------------------------------------
    def fit_arrays(self, X: np.ndarray, y: np.ndarray,
                   w: Optional[np.ndarray] = None) -> SelectedModel:
        n = len(y)
        if w is None:
            w = np.ones(n, np.float32)

        if self.splitter is not None and self.splitter.reserve_test_fraction > 0:
            train_idx, test_idx = self.splitter.split(n)
        else:
            train_idx, test_idx = np.arange(n), np.arange(0)

        y_train = y[train_idx]
        prep = (self.splitter.prepare(y_train) if self.splitter is not None
                else PreparedData(indices=np.arange(len(train_idx)),
                                  weights=np.ones(len(train_idx), np.float32)))
        use_idx = train_idx[prep.indices]
        Xt, yt = X[use_idx], y[use_idx]
        wt = w[use_idx] * prep.weights
        if prep.label_map and any(k != v for k, v in prep.label_map.items()):
            yt = _remap_labels(yt, prep.label_map)

        self._bind_device()
        t0 = time.perf_counter()
        best: BestEstimator = self.validator.validate(
            self.models, Xt, yt, wt, problem_type=self.problem_type)
        t1 = time.perf_counter()

        # refit winner on the full prepared train set (reference :159)
        best_model = best.estimator.fit_arrays(Xt, yt, wt)
        t2 = time.perf_counter()

        evaluator = self.validator.evaluator
        train_eval = self._evaluate(evaluator, best_model, Xt, yt, wt)
        holdout_eval: Dict[str, float] = {}
        if len(test_idx):
            yh = y[test_idx]
            if prep.label_map and any(k != v for k, v in prep.label_map.items()):
                keep = np.isin(yh, list(prep.label_map.keys()))
                test_idx = test_idx[keep]
                yh = _remap_labels(yh[keep], prep.label_map)
            if len(test_idx):
                holdout_eval = self._evaluate(
                    evaluator, best_model, X[test_idx], yh, w[test_idx])
        self.walls = {"sweep": t1 - t0, "refit": t2 - t1,
                      "evaluate": time.perf_counter() - t2}

        summary = ModelSelectorSummary(
            validation_type=type(self.validator).__name__,
            validation_parameters=self._validator_params(),
            data_prep_parameters=(self.splitter.save_args()
                                  if self.splitter else {}),
            data_prep_results=prep.summary,
            evaluation_metric=evaluator.default_metric,
            metric_larger_better=bool(evaluator.is_larger_better()),
            problem_type=self.problem_type,
            best_model_uid=best.estimator.uid,
            best_model_name=best.name,
            best_model_type=type(best.estimator).__name__,
            best_grid=best.best_grid,
            validation_results=(
                # a workflow-level CV's sweep (in-fold DAG refits,
                # Workflow._run_workflow_cv) comes first
                list(getattr(self, "_extra_validation_results", []))
                + [{"model_name": v.model_name, "model_uid": v.model_uid,
                    "grid": v.grid, "metric_name": v.metric_name,
                    "fold_metrics": v.fold_metrics,
                    "mean_metric": v.mean_metric, "route": v.route}
                   for v in best.validated]),
            train_evaluation=train_eval,
            holdout_evaluation=holdout_eval,
        )
        return SelectedModel(best_model, summary,
                             label_map=prep.label_map,
                             operation_name=self.operation_name,
                             device=self.device)

    def _evaluate(self, evaluator: Evaluator, model: PredictionModel,
                  X: np.ndarray, y: np.ndarray,
                  w: np.ndarray) -> Dict[str, Any]:
        pred, raw, prob = model.predict_arrays(X)
        col = make_prediction_column(pred, raw, prob)
        out: Dict[str, Any] = dict(evaluator.evaluate_all(y, col, w))
        for ev in self.extra_evaluators:
            for k, v in ev.evaluate_all(y, col, w).items():
                out.setdefault(f"{ev.name}_{k}", v)
        # floats are the metric scalars; dicts carry structured curves
        # (multiclass threshold_metrics) into the summary JSON — the
        # pretty printer formats floats only
        return {k: v for k, v in out.items()
                if isinstance(v, (float, dict))}

    def _validator_params(self) -> Dict[str, Any]:
        v = self.validator
        out: Dict[str, Any] = {"seed": v.seed, "stratify": v.stratify}
        if hasattr(v, "num_folds"):
            out["num_folds"] = v.num_folds
        if hasattr(v, "train_ratio"):
            out["train_ratio"] = v.train_ratio
        return out

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d["problem_type"] = self.problem_type
        return d
