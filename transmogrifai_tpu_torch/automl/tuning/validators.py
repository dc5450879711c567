"""Validators: cross-validation and train/validation split
(counterpart of automl/tuning/validators.py).

Reference: core/.../impl/tuning/{OpValidator.scala:94,
OpCrossValidation.scala:41, OpTrainValidationSplit.scala:34}. Folds are
weight masks over one device-resident feature matrix: no data moves
between folds. Three routes, picked per estimator as the reference picks
them:

- streamed (`_validate_streamed`): large GLM sweeps fit every (fold x
  grid) lane through shared passes over X: logistic regression and the
  linear SVC with per-lane retirement, linear regression from one Gram
  pass (ops/glm_sweep.py); each fold's grid chunk is then scored by one
  product and one lane-batched metric call;
- vmapped (`_validate_vmapped`): smaller GLM sweeps fit the (fold x grid
  chunk) lanes in one lane-batched solve (ops/glm.py);
- mask folds (`_validate_mask_folds`): tree sweeps bin the matrix once per
  `max_bins` value and fit all folds of a grid point in one fold-fused
  call; with TMOG_GRID_FUSE on, the grid points of one structure
  (`grid_fuse_signature`) fit together, lanes = configs x folds
  (`mask_fit_scores_grid`, route "mask_folds:grid_fused");
- sequential (`_validate_sequential`): every other estimator (generalized
  linear regression, naive Bayes) and every estimator under a custom
  evaluator: one `fit_arrays` a fold on its training rows, the evaluator
  on the held-out rows' Prediction column.

Binary sweeps score margins (rank metrics, or the thresholded metrics at
the evaluator's threshold as a margin); multiclass sweeps score [n, c]
class scores, whose argmax feeds the confusion-matrix metrics; the
streamed route stays binary and regression only, as in the reference.

At 2M rows and more, in-sweep AuPR/AuROC come from the lane-batched
binned-counts kernel instead of a sort per lane; regression metrics are
lane-batched sums. GLM cells can be checkpointed (`checkpoint_path`), and
the streamed route also per retirement round. `validate(..., masks=)`
takes the folds from outside (workflow-level CV runs one fold at a time).
`sweep_dtype` (None: f32; or torch.bfloat16) is the dtype of the sweep's
device-resident X on the streamed, vmapped and mask-fold routes: bf16
halves it, the GLM solvers keep f32 state and f32 products out
(ops/glm._mm), and trees read X only through binning; the sequential
route fits on f32 X.
While the run-metrics collector is on (utils/metrics.collector) each
route's fits are a "sweep_fit" span, each finished (model x grid) cell a
`sweep_cell_landed` event, each retirement round of the streamed route a
`glm_round_retired` event and its telemetry a sweep_convergence record.
Mesh sharding arrives in a later slice.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import DeviceLike, resolve_device, to_device
from ...evaluators.evaluators import Evaluator
from ...models.base import PredictorEstimator
from ...models.prediction import make_prediction_column
from ...ops import glm as G
from ...ops import glm_sweep as GS
from ...ops import metrics_ops as M
from ...stages.params import ParamMap
from ...utils.metrics import collector


@dataclass
class ValidatedModel:
    """Validation record for one (estimator, grid point). `route` names
    the sweep route that produced the metrics ("streamed" | "vmapped" |
    "mask_folds")."""

    model_name: str
    model_uid: str
    grid: ParamMap
    metric_name: str
    fold_metrics: List[float]
    route: str = ""

    @property
    def mean_metric(self) -> float:
        vals = [v for v in self.fold_metrics if np.isfinite(v)]
        return float(np.mean(vals)) if vals else float("nan")


@dataclass
class BestEstimator:
    """Winner of validation (reference OpValidator.wrapBestEstimator:147)."""

    name: str
    estimator: PredictorEstimator  # configured with the best grid
    best_grid: ParamMap
    best_metric: float
    validated: List[ValidatedModel] = field(default_factory=list)


# In-sweep AuPR/AuROC switch from exact sorts to binned-counts kernels at
# this many rows (the winner's final metrics remain exact).
BINNED_RANK_METRIC_MIN_ROWS = 2_000_000
RANK_METRIC_BINS = 4096

# Device-memory budget the auto grid-chunker assumes for one sweep call:
# each lane of the vmapped route holds [n, d] row-scaled products, so
# lanes are capped at budget / (n * d * itemsize).
SWEEP_LANE_BUDGET_BYTES = 12e9

# Rows from which GLM sweeps take the streamed route (one X pass per
# Newton iteration for ALL lanes instead of one per lane). The reference's
# planner may move this floor from measurements; the planner is not
# ported, so the hand default holds.
STREAMED_SWEEP_MIN_ROWS = 200_000

_RANK_METRICS = {"au_pr": M.au_pr, "au_roc": M.au_roc}
PROBLEM_TYPES = ("binary", "multiclass", "regression")
SWEEP_DTYPES = (torch.float32, torch.bfloat16)


def grid_fuse_enabled() -> bool:
    """TMOG_GRID_FUSE on ("1", "true" or "on"): the mask-fold route fits
    each same-signature group of grid points in one fused fit. Off by
    default, as the reference's hand gate is (its plan-time autotuner is
    not ported)."""
    return os.environ.get("TMOG_GRID_FUSE", "").strip().lower() \
        in ("1", "true", "on")


def _dtype_name(dtype: torch.dtype) -> str:
    """"float32" / "bfloat16": the reference's dtype names in checkpoint
    path tags."""
    return str(dtype).replace("torch.", "")


def _lanes_metric_fn(metric: str, problem_type: str, rank_bins):
    """(scores [L, n], labels [n], w_lanes [L, n]) -> [L] metric values
    when the metric has a lane-batched form (the binned rank kernel, the
    regression sums), else None."""
    if problem_type == "regression":
        return lambda s, y, wl: getattr(M.regression_metrics(s, y, wl),
                                        metric)
    if not (rank_bins and problem_type == "binary"):
        return None
    if metric == "au_pr":
        return lambda s, y, wl: M.au_pr_binned_lanes(s, y, wl, rank_bins)
    if metric == "au_roc":
        return lambda s, y, wl: M.au_roc_binned_lanes(s, y, wl, rank_bins)
    return None


def _metric_fn(problem_type: str, metric: str,
               rank_bins: Optional[int] = None,
               n_classes: int = 2) -> Callable:
    """(scores, labels, weights, margin_threshold) -> scalar for one lane.
    Binary scores [n] are margins (monotone in probability, so rank metrics
    match), and the thresholded metrics cut them at the margin equivalent
    of the evaluator's threshold; multiclass scores are [n, c] class
    scores, their argmax (invariant to softmax) the predicted class of the
    confusion-matrix metrics; regression scores are the predictions."""
    fields = {"binary": M.BinaryMetrics._fields,
              "multiclass": M.MultiMetrics._fields,
              "regression": M.RegressionMetrics._fields}.get(problem_type)
    if fields is None:
        raise ValueError(f"unknown problem type {problem_type!r}; one of "
                         f"{PROBLEM_TYPES}")
    if metric not in fields:
        raise ValueError(f"no in-sweep {problem_type} metric {metric!r}; "
                         f"there are {list(fields)}")
    if problem_type == "multiclass":
        return lambda s, y, w, thr: getattr(M.multiclass_metrics(
            torch.argmax(s, dim=1), y, n_classes, w), metric)
    lanes = _lanes_metric_fn(metric, problem_type, rank_bins)
    if lanes is not None:
        return lambda s, y, w, thr: lanes(s[None], y, w[None])[0]
    if metric in _RANK_METRICS:
        exact = _RANK_METRICS[metric]
        return lambda s, y, w, thr: exact(s, y, w)
    return lambda s, y, w, thr: getattr(
        M.binary_metrics(s, y, w, threshold=thr), metric)


def _lane_metrics(metric: str, problem_type: str, rank_bins, thr: float,
                  n_classes: int = 2):
    """(scores [L, n] or [L, n, c], labels [n], w_lanes [L, n]) -> [L]
    metric values: one lane-batched kernel call where the metric has one,
    else the one-lane metric per lane."""
    lanes = _lanes_metric_fn(metric, problem_type, rank_bins)
    if lanes is not None:
        return lanes
    mfn = _metric_fn(problem_type, metric, rank_bins=rank_bins,
                     n_classes=n_classes)
    return lambda s, y, wl: torch.stack(
        [mfn(s[j], y, wl[j], thr) for j in range(s.shape[0])])


def _streamed_eval(X, y, vw, Bc, b0c, thr, *, metric, problem_type,
                   rank_bins=None):
    """Metrics for one fold's grid chunk of streamed-sweep coefficients:
    scores in one product, then one lane-batched metric call for the
    chunk (the binned kernel where the metric has one)."""
    s = GS.sweep_scores_fold(X, Bc, b0c)                # [n, chunk]
    wl = vw[None, :].expand(s.shape[1], vw.shape[0])
    return _lane_metrics(metric, problem_type, rank_bins, thr)(s.T, y, wl)


class Validator:
    """Base validator (reference OpValidator.scala:94). `device` is where
    the sweep runs: None means CUDA. `grid_chunk` is the number of grid
    points per vmapped-route call (None: from the memory budget).
    `sweep_dtype` is the dtype of the sweep's device-resident X (None:
    f32; torch.bfloat16 halves it)."""

    # the streamed route scores each fold in grid chunks of this many
    # lanes, one metric-kernel call each
    _STREAMED_EVAL_CHUNK = 8

    def __init__(self, evaluator: Evaluator, seed: int = 42,
                 stratify: bool = False, device: DeviceLike = None,
                 grid_chunk: Optional[int] = None,
                 sweep_dtype: Optional[torch.dtype] = None):
        if sweep_dtype is not None and sweep_dtype not in SWEEP_DTYPES:
            raise ValueError(f"sweep_dtype must be None or one of "
                             f"{SWEEP_DTYPES}, got {sweep_dtype!r}")
        self.evaluator = evaluator
        self.seed = int(seed)
        self.stratify = bool(stratify)
        self.device = device
        self.grid_chunk = grid_chunk
        self.sweep_dtype = sweep_dtype
        # optional sweep checkpoint (resume skips finished model x grid
        # cells of the GLM routes; the streamed route also resumes at its
        # last retirement round)
        self.checkpoint_path: Optional[str] = None
        # round/pass telemetry of the LAST streamed GLM sweep
        self.last_streamed_telemetry: Optional[Dict[str, Any]] = None
        # host wall (s) of each model type's sweep in the LAST validate();
        # each ends in reading its fold metrics, a device synchronise
        self.family_walls: Dict[str, float] = {}
        self._external_mask_tag = ""  # set per validate() call

    # -- folds -------------------------------------------------------------
    def fold_masks(self, y: np.ndarray) -> np.ndarray:
        """[F, n] float32 train-membership masks (1=train, 0=validation)."""
        raise NotImplementedError

    def _assign_folds(self, y: np.ndarray, n_folds: int) -> np.ndarray:
        """Per-row fold id; stratified round-robin within each class when
        stratify is on (reference prepareStratification:203)."""
        rng = np.random.default_rng(self.seed)
        n = len(y)
        fold_of = np.empty(n, np.int32)
        if self.stratify:
            for cls in np.unique(y):
                idx = np.flatnonzero(y == cls)
                rng.shuffle(idx)
                fold_of[idx] = np.arange(len(idx)) % n_folds
        else:
            perm = rng.permutation(n)
            fold_of[perm] = np.arange(n) % n_folds
        return fold_of

    # -- validation --------------------------------------------------------
    def validate(self, models: Sequence[Tuple[PredictorEstimator,
                                              List[ParamMap]]],
                 X, y, w=None, problem_type: str = "binary",
                 masks: Optional[np.ndarray] = None) -> BestEstimator:
        """Score every (estimator, grid point) over the folds and return
        the winner, configured with its grid. X [n, d], y [n] and w [n]
        may be numpy arrays or tensors; `masks` overrides
        self.fold_masks(y)."""
        if problem_type not in PROBLEM_TYPES:
            raise ValueError(f"unknown problem type {problem_type!r}; one "
                             f"of {PROBLEM_TYPES}")
        dev = resolve_device(self.device)
        if getattr(self.evaluator, "device", None) is None:
            self.evaluator.device = self.device
        y_host = y.cpu().numpy() if isinstance(y, torch.Tensor) \
            else np.asarray(y)
        if masks is None:
            masks = self.fold_masks(y_host)
            self._external_mask_tag = ""
        else:
            # checkpoint cells must be keyed by WHICH masks ran
            self._external_mask_tag = hashlib.sha1(
                np.ascontiguousarray(masks, np.float32).tobytes()
            ).hexdigest()[:12]
        metric = self.evaluator.default_metric
        larger = self.evaluator.is_larger_better()
        # a user's metric (Evaluators.custom) has no device form: every
        # candidate takes the sequential route, the only one that calls
        # evaluator.evaluate on host columns
        device_metric = getattr(self.evaluator, "device_metric", True)
        dtype = self.sweep_dtype or torch.float32
        Xd = to_device(X, dev, dtype=dtype, label="sweep")
        # the sequential route fits on f32 X: made when first needed
        X_seq = Xd if dtype == torch.float32 else None
        yd = torch.as_tensor(y_host, dtype=torch.float32, device=dev)
        wd = torch.ones_like(yd) if w is None else \
            torch.as_tensor(w, dtype=torch.float32, device=dev)
        md = torch.as_tensor(masks, dtype=torch.float32, device=dev)
        n_classes = int(np.max(y_host)) + 1 \
            if problem_type == "multiclass" else 2

        validated: List[ValidatedModel] = []
        self.family_walls = {}
        for est, grids in models:
            t0 = time.perf_counter()
            if not grids:
                grids = [dict()]
            if device_metric and self._streamable(
                    est, grids, problem_type, Xd, md.shape[0]):
                validated.extend(self._validate_streamed(
                    est, grids, Xd, yd, wd, md, metric, problem_type))
            elif device_metric and self._vmappable(est, grids,
                                                   problem_type):
                validated.extend(self._validate_vmapped(
                    est, grids, Xd, yd, wd, md, metric, problem_type,
                    n_classes))
            elif (device_metric
                  and getattr(est, "supports_mask_folds", False)
                  and problem_type in getattr(est, "problem_types", ())):
                validated.extend(self._validate_mask_folds(
                    est, grids, Xd, yd, wd, md, metric, problem_type,
                    n_classes))
            else:
                if X_seq is None:
                    X_seq = to_device(X, dev, label="sweep")
                validated.extend(self._validate_sequential(
                    est, grids, X_seq, y_host, w, masks))
            name = type(est).__name__
            self.family_walls[name] = (self.family_walls.get(name, 0.0)
                                       + time.perf_counter() - t0)

        if not validated:
            raise ValueError("No models to validate")
        key = (lambda v: v.mean_metric if np.isfinite(v.mean_metric)
               else (-np.inf if larger else np.inf))
        best = max(validated, key=key) if larger else min(validated, key=key)
        winner = next(e for e, _ in models
                      if e.uid == best.model_uid).copy(**best.grid)
        return BestEstimator(name=best.model_name, estimator=winner,
                             best_grid=best.grid,
                             best_metric=best.mean_metric, validated=validated)

    def _rank_bins(self, n_rows: int) -> Optional[int]:
        return RANK_METRIC_BINS if n_rows >= BINNED_RANK_METRIC_MIN_ROWS \
            else None

    # -- GLM route tests -----------------------------------------------------
    @staticmethod
    def _constant_off_axis(est: PredictorEstimator, grids: List[ParamMap],
                           axes) -> bool:
        """Every non-axis grid key must be constant across the grid (it
        binds once, via copy, for all lanes)."""
        others = {k for g in grids for k in g if k not in axes}
        for k in others:
            vals = {repr(g.get(k, est.get_param(k))) for g in grids}
            if len(vals) > 1:
                return False
        return True

    @staticmethod
    def _vmappable(est: PredictorEstimator, grids: List[ParamMap],
                   problem_type: str) -> bool:
        if not getattr(est, "supports_grid_vmap", False):
            return False
        if problem_type == "multiclass":
            if not getattr(est, "supports_multiclass_vmap", False):
                return False
        elif problem_type not in ("binary", "regression"):
            return False
        _, axes = est.batched_fit_fn()
        return Validator._constant_off_axis(est, grids, axes)

    def _streamable(self, est: PredictorEstimator, grids: List[ParamMap],
                    problem_type: str, X, n_folds: int) -> bool:
        """Large binary/regression GLM sweeps take the streamed route; the
        guard beyond the row floor is the per-iteration [L, d, d] Hessian
        and solve footprint against the sweep memory budget (lanes L =
        folds x grid points)."""
        if getattr(est, "streamed_loss", None) is None:
            return False
        if problem_type not in ("binary", "regression"):
            return False
        if X.shape[0] < STREAMED_SWEEP_MIN_ROWS:
            return False
        lanes = n_folds * max(len(grids), 1)
        if not GS.streamed_route_ok(X.shape[1], lanes,
                                    SWEEP_LANE_BUDGET_BYTES):
            return False
        _, axes = est.batched_fit_fn()
        return self._constant_off_axis(est, grids, axes)

    # -- shared helpers for the GLM routes -----------------------------------
    def _margin_threshold(self, est) -> float:
        """Thresholded metrics: probability threshold t maps to margin
        logit(t) for probabilistic models; margin models cut at 0 (their
        decision rule)."""
        thr = float(getattr(self.evaluator, "threshold", 0.5))
        if getattr(est, "produces_probabilities", True) and 0.0 < thr < 1.0:
            return float(np.log(thr / (1.0 - thr)))
        return 0.0

    def _auto_grid_chunk(self, n: int, d: int, n_folds: int,
                         itemsize: int, n_grids: int) -> int:
        if self.grid_chunk is not None:
            return max(1, int(self.grid_chunk))
        lane_bytes = max(n * d * itemsize, 1)
        lanes = max(int(SWEEP_LANE_BUDGET_BYTES / lane_bytes), 1)
        # the reference caps a call at 8 grid points (its compile time
        # grows with lanes); the cap is kept so the chunks, and with them
        # the checkpoint granularity, match
        return int(np.clip(lanes // max(n_folds, 1), 1, min(n_grids, 8)))

    def _sweep_path(self, base: str) -> str:
        """Checkpoint path tag: externally supplied fold masks must not
        replay one fold's cells into another."""
        if self._external_mask_tag:
            base = f"{base}:masks{self._external_mask_tag}"
        return base

    def _checkpoint(self):
        if self.checkpoint_path is None:
            return None
        from .checkpoint import SweepCheckpoint
        return SweepCheckpoint(self.checkpoint_path)

    def _cell_bookkeeping(self, est, grids, X, y, metric, n_folds,
                          path: str = ""):
        """(checkpoint, per-grid keys, finished results) — cell-level
        records shared across resumes of the SAME sweep path. `path` names
        the compute path: metrics from one path are never replayed into
        another."""
        from .checkpoint import data_fingerprint, sweep_key
        ckpt = self._checkpoint()
        if ckpt is None:
            return None, [None] * len(grids), {}
        data_fp = data_fingerprint(X, y)
        base_params = est.param_values() if hasattr(est, "param_values") \
            else None
        metric_key = getattr(self.evaluator, "metric_key", metric)
        keys = [sweep_key(type(est).__name__, g, n_folds,
                          self.seed, self.stratify, metric_key,
                          data_fp=data_fp, base_params=base_params,
                          path=path)
                for g in grids]
        results = {}
        for gi, key in enumerate(keys):
            done = ckpt.get(key)
            if done is not None:
                results[gi] = [float(v) for v in done["fold_metrics"]]
        return ckpt, keys, results

    @staticmethod
    def _grid_axis_arrays(est, grids) -> Tuple[np.ndarray, np.ndarray]:
        """Per-grid (regs, alphas) along the estimator's sweep axes —
        shared by the vmapped and streamed routes."""
        _, axes = est.batched_fit_fn()
        regs = np.array([g.get(axes[0], est.get_param(axes[0]))
                         for g in grids], np.float32)
        second = axes[1] if len(axes) > 1 else None
        alphas = np.array([g.get(second, est.get_param(second)) if second
                           else 0.0 for g in grids], np.float32)
        return regs, alphas

    def _land(self, est, grids, keys, ckpt, results, pending, out, metric,
              route: str):
        """Record each pending cell's fold metrics (out [F, len(pending)]),
        checkpoint it and announce it."""
        for j, gi in enumerate(pending):
            fm = [float(v) for v in out[:, j]]
            results[gi] = fm
            if ckpt is not None:
                ckpt.record(keys[gi], type(est).__name__, grids[gi], fm,
                            metric)
            self._cell_event(est, gi, fm, route)

    @staticmethod
    def _cell_event(est, gi, fm, route):
        """One `sweep_cell_landed` event per finished (model x grid) cell,
        so `tail -f events.jsonl` shows the sweep's progress cell by cell."""
        finite = [v for v in fm if np.isfinite(v)]
        collector.event(
            "sweep_cell_landed", model=type(est).__name__,
            grid_index=int(gi), route=route, n_folds=len(fm),
            mean_metric=float(np.mean(finite)) if finite else None)

    def _record_sweep_telemetry(self, est, info):
        self.last_streamed_telemetry = dict(info, model=type(est).__name__)
        collector.sweep_convergence(
            family=type(est).__name__, kernel=info["kernel"],
            rounds=info.get("glm_rounds", 0),
            data_passes=info.get("data_passes", 0),
            lane_passes=info.get("lane_passes", 0),
            lanes_total=info.get("lanes_total", 0),
            lanes_retired=info.get("lanes_retired", 0),
            active_per_round=info.get("active_per_round", ()),
            iters_per_round=info.get("iters_per_round", ()),
            bucket_sizes=info.get("bucket_sizes", ()))

    @staticmethod
    def _validated(est, grids, metric, results, route):
        """The ValidatedModels of one estimator's grid: `route` one label
        for every cell, or {grid index: label}."""
        return [
            ValidatedModel(model_name=type(est).__name__, model_uid=est.uid,
                           grid=g, metric_name=metric,
                           fold_metrics=results[gi],
                           route=route[gi] if isinstance(route, dict)
                           else route)
            for gi, g in enumerate(grids)
        ]

    # -- vmapped GLM route ---------------------------------------------------
    def _validate_vmapped(self, est, grids, X, y, w, masks, metric,
                          problem_type, n_classes=2) -> List[ValidatedModel]:
        """GLM-family sweep: one lane-batched solve per grid chunk over
        (folds x chunk) lanes, each lane fitting on its fold's training
        weights and scored on the held-out rows (softmax lanes and [n, c]
        scores for a multiclass sweep). Chunking bounds the per-call
        memory (each lane holds [n, d] row-scaled products) and gives the
        checkpoint mid-grid granularity."""
        base = est.copy(**{k: v for k, v in grids[0].items()})
        multiclass = problem_type == "multiclass"
        fit_one, _ = base.batched_fit_fn(n_classes=n_classes) \
            if multiclass else base.batched_fit_fn()
        regs, alphas = self._grid_axis_arrays(est, grids)
        F, n = masks.shape
        ckpt, keys, results = self._cell_bookkeeping(
            est, grids, X, y, metric, F,
            path=self._sweep_path(f"vmapped:{_dtype_name(X.dtype)}"))
        pending = [gi for gi in range(len(grids)) if gi not in results]
        if pending:
            lane_metrics = _lane_metrics(metric, problem_type,
                                         self._rank_bins(n),
                                         self._margin_threshold(est),
                                         n_classes)
            chunk = self._auto_grid_chunk(n, X.shape[1], F,
                                          X.element_size(), len(pending))
            dev = X.device
            w_fit = masks * w[None, :]                       # [F, n]
            w_eval = (1.0 - masks) * w[None, :]
            for start in range(0, len(pending), chunk):
                idx = pending[start:start + chunk]
                k = len(idx)
                # lanes fold-major: l = f * k + j

                def lanes(a):
                    return a[:, None, :].expand(F, k, n).reshape(F * k, n)

                def grid_vec(v):
                    return torch.as_tensor(v[idx], device=dev).repeat(F)
                with collector.trace_span(
                        f"glm_vmapped:{type(est).__name__}",
                        kind="sweep_fit", folds=int(F), chunk=int(k)):
                    B, b0 = fit_one(X, y, lanes(w_fit), grid_vec(regs),
                                    grid_vec(alphas))
                    if X.dtype != torch.float32:   # f32 out of bf16 X
                        scores = (G._mm(X, B) + b0[:, None, :] if multiclass
                                  else (G._mm(X, B.T) + b0[None, :]).T)
                    elif multiclass:   # B [F*k, d, c] -> [F*k, n, c]
                        scores = torch.matmul(X, B) + b0[:, None, :]
                    else:
                        scores = (X @ B.T + b0[None, :]).T   # [F*k, n]
                    vals = lane_metrics(scores, y, lanes(w_eval)) \
                        .reshape(F, k).cpu().numpy()
                self._land(est, grids, keys, ckpt, results, idx, vals,
                           metric, "vmapped")
        return self._validated(est, grids, metric, results, "vmapped")

    # -- streamed GLM route --------------------------------------------------
    def _round_checkpoint(self, keys, pending, fit_kwargs):
        """(RoundCheckpoint, key, resumable state) for the round driver —
        keyed by the pending cells' sweep keys (which already fold in the
        data fingerprint, masks, base params and compute path) plus the
        solver knobs, so state from a different sweep is never replayed."""
        if self.checkpoint_path is None or keys[0] is None:
            return None, None, None
        from .checkpoint import RoundCheckpoint
        payload = json.dumps(
            [[keys[gi] for gi in pending],
             {k: repr(v) for k, v in sorted(fit_kwargs.items())},
             os.environ.get("TMOG_GLM_ROUND_ITERS", "")], sort_keys=True)
        rkey = hashlib.sha256(payload.encode()).hexdigest()[:24]
        rc = RoundCheckpoint(self.checkpoint_path + ".glm_rounds.npz")
        return rc, rkey, rc.load(rkey)

    def _streamed_fit(self, est, fit_kwargs, X, y, w, masks, regs_p,
                      alphas_p, keys, pending):
        """Fit every pending (fold x grid) lane through the streamed
        route: the squared loss from one Gram pass; the IRLS losses
        through the host-driven round loop with per-lane retirement
        (round-granular checkpointing when a checkpoint path is set), or,
        with TMOG_GLM_ROUNDS=0, the legacy single-program global-max
        route. Returns (B [F, Gp, d], b0 [F, Gp] tensors in RAW units,
        telemetry, round checkpoint or None — the CALLER clears it only
        after the cells land in the JSONL checkpoint)."""
        F = int(masks.shape[0])
        L = F * len(pending)
        if fit_kwargs["loss"] == "squared":
            fk = {k: v for k, v in fit_kwargs.items() if k != "loss"}
            B, b0, giters = GS.sweep_glm_squared_gram(
                X, y, w, masks, regs_p, alphas_p, fk.pop("max_iter"),
                fk.pop("tol"), **fk)
            return B, b0, {"route": "streamed", "kernel": "gram",
                           "glm_rounds": 1, "data_passes": 1,
                           "lane_passes": F, "padded_lane_passes": F,
                           "lanes_total": L, "lanes_retired": L,
                           "gram_solve_iters": int(giters)}, None
        if GS.env_on("TMOG_GLM_ROUNDS"):
            rc, rkey, state = self._round_checkpoint(keys, pending,
                                                     fit_kwargs)

            def on_round(st):
                # one event per retirement boundary: the tail of
                # events.jsonl is the live convergence picture of a sweep
                if rc is not None:
                    rc.save(rkey, st)
                    collector.event("round_checkpoint_written",
                                    path=rc.path, rounds=int(st["rounds"]))
                collector.event(
                    "glm_round_retired", rounds=int(st["rounds"]),
                    lanes_retired=int(st["retired"].sum()),
                    lanes_active=int((~st["retired"]).sum()),
                    lane_passes=int(st["lane_passes"]))
            B, b0, info = GS.sweep_glm_streamed_rounds(
                X, y, w, masks, regs_p, alphas_p, state=state,
                on_round=on_round, **fit_kwargs)
            dev = X.device
            return (torch.as_tensor(B, device=dev),
                    torch.as_tensor(b0, device=dev), info, rc)
        B, b0 = GS.sweep_glm_streamed(X, y, w, masks, regs_p, alphas_p,
                                      **fit_kwargs)
        return B, b0, {"route": "streamed", "kernel": "global",
                       "lanes_total": L}, None

    def _validate_streamed(self, est, grids, X, y, w, masks, metric,
                           problem_type) -> List[ValidatedModel]:
        """Streamed convergence-aware sweep: every pending (fold x grid)
        cell fits through _streamed_fit; metrics then run per fold in grid
        chunks of one scoring product and one metric call each."""
        regs, alphas = self._grid_axis_arrays(est, grids)
        # constant off-axis grid keys (admitted by _constant_off_axis) bind
        # exactly as on the vmapped route: est.copy(**grids[0])
        base = est.copy(**{k: v for k, v in grids[0].items()})
        # stale telemetry must never survive into a sweep that runs no fit
        self.last_streamed_telemetry = None
        F = masks.shape[0]
        ckpt, keys, results = self._cell_bookkeeping(
            est, grids, X, y, metric, F,
            path=self._sweep_path(f"streamed:{_dtype_name(X.dtype)}"))
        pending = [gi for gi in range(len(grids)) if gi not in results]
        if pending:
            fit_kwargs = dict(
                loss=est.streamed_loss,
                max_iter=int(base.get_param("max_iter")),
                tol=float(base.get_param("tol")),
                fit_intercept=bool(base.get_param("fit_intercept"))
                if base.has_param("fit_intercept") else True,
                standardize=bool(base.get_param("standardization"))
                if base.has_param("standardization") else True)
            with collector.trace_span(
                    f"glm_streamed:{type(est).__name__}", kind="sweep_fit",
                    folds=int(F), grids=len(pending)) as sp:
                B, b0, sweep_info, round_ckpt = self._streamed_fit(
                    est, fit_kwargs, X, y, w, masks, regs[pending],
                    alphas[pending], keys, pending)
                if sp is not None:
                    sp.attrs["kernel"] = sweep_info.get("kernel")
            self._record_sweep_telemetry(est, sweep_info)
            rank_bins = self._rank_bins(X.shape[0])
            thr = self._margin_threshold(est)
            chunk = min(self._STREAMED_EVAL_CHUNK, len(pending))
            out = np.empty((F, len(pending)), np.float64)
            with collector.trace_span(
                    f"glm_streamed_eval:{type(est).__name__}",
                    kind="sweep_eval", cells=len(pending)):
                for f in range(F):
                    vw = (1.0 - masks[f]) * w
                    for s in range(0, len(pending), chunk):
                        sl = slice(s, min(s + chunk, len(pending)))
                        vals = _streamed_eval(
                            X, y, vw, B[f, sl], b0[f, sl], thr,
                            metric=metric, problem_type=problem_type,
                            rank_bins=rank_bins)
                        out[f, sl] = vals.cpu().numpy()
            self._land(est, grids, keys, ckpt, results, pending, out, metric,
                       "streamed")
            if round_ckpt is not None:
                # only NOW are all cells in the JSONL checkpoint: a
                # preemption during the evaluation above resumes from the
                # fully-retired round state instead of refitting
                round_ckpt.clear()
        return self._validated(est, grids, metric, results, "streamed")

    # -- mask-fold tree route ------------------------------------------------
    def _validate_mask_folds(self, est, grids, X, y, w, masks, metric,
                             problem_type, n_classes=2
                             ) -> List[ValidatedModel]:
        """Tree-family sweep with folds as weight masks: the feature matrix
        is quantile-binned ONCE per max_bins value on the device, then each
        grid point fits all folds at once against it, with the folds'
        training masks as sample weights, and scores the held-out rows
        (margins of a binary classifier, [n, c] class scores of a
        multiclass one, a regressor's predictions)."""
        fold_metrics = _lane_metrics(metric, problem_type,
                                     self._rank_bins(X.shape[0]),
                                     self._margin_threshold(est), n_classes)
        multiclass = problem_type == "multiclass"
        w_eval = (1.0 - masks) * w[None, :]
        fuse = grid_fuse_enabled()
        sig_of = getattr(est, "grid_fuse_signature", lambda g: None)

        def bins_of(g):
            return g.get("max_bins", est.get_param("max_bins"))

        groups: Dict[Any, List[int]] = {}
        for gi, g in enumerate(grids):
            groups.setdefault(bins_of(g), []).append(gi)
        results: Dict[int, List[float]] = {}
        routes: Dict[int, str] = {}

        def record(gi, scores, route):
            results[gi] = [float(v) for v in
                           fold_metrics(scores, y, w_eval).cpu()]
            routes[gi] = route
            self._cell_event(est, gi, results[gi], route)

        for _, group in sorted(groups.items(), key=lambda kv: str(kv[0])):
            ctx = est.copy(**grids[group[0]]).mask_sweep_context(X)
            # grid points of one structural signature differ only in the
            # per-lane split and leaf scalars: with fusion on, a group of
            # two or more fits in one fused call (lanes = configs x folds)
            sig_groups: Dict[Any, List[int]] = {}
            for gi in group:
                sig = sig_of(grids[gi]) if fuse else None
                key = ("solo", gi) if sig is None else ("fuse", sig)
                sig_groups.setdefault(key, []).append(gi)
            for key, gis in sig_groups.items():
                fused = None
                if key[0] == "fuse" and len(gis) > 1:
                    # no fallback on failure: a fused fit that raises
                    # raises out of validate()
                    with collector.trace_span(
                            f"mask_folds_grid_fused:{type(est).__name__}",
                            kind="sweep_fit", folds=int(masks.shape[0]),
                            configs=len(gis)):
                        fused = est.mask_fit_scores_grid(
                            ctx, y, w, masks, [grids[gi] for gi in gis],
                            n_classes=n_classes, multiclass=multiclass)
                        if fused is not None:
                            route = "mask_folds:" + est._last_grid_route
                            for k, gi in enumerate(gis):
                                record(gi, fused[k], route)
                if fused is not None:
                    continue
                for gi in gis:
                    with collector.trace_span(
                            f"mask_folds:{type(est).__name__}",
                            kind="sweep_fit", folds=int(masks.shape[0]),
                            grid_index=int(gi)):
                        record(gi, est.copy(**grids[gi]).mask_fit_scores(
                            ctx, y, w, masks, n_classes=n_classes,
                            multiclass=multiclass), "mask_folds")
            del ctx  # free the binned matrix before the next group
        return self._validated(est, grids, metric, results, routes)


    # -- sequential route ----------------------------------------------------
    def _validate_sequential(self, est, grids, X, y, w, masks
                             ) -> List[ValidatedModel]:
        """One `fit_arrays` a (grid point, fold) on the fold's training
        rows, scored by the evaluator on the held-out rows' Prediction
        column (reference OpValidator's per-fold fits): the route of
        estimators without a lane-batched fit and of custom evaluators.
        X is the sweep's device tensor; y, w and masks are host arrays."""
        metric = self.evaluator.default_metric
        y = np.asarray(y, np.float32)
        w = np.ones_like(y) if w is None else \
            (w.cpu().numpy() if isinstance(w, torch.Tensor)
             else np.asarray(w, np.float32))
        masks = np.asarray(masks)
        ckpt, keys, results = self._cell_bookkeeping(
            est, grids, X, y, metric, masks.shape[0],
            path=self._sweep_path("sequential"))
        for gi, g in enumerate(grids):
            if gi in results:
                continue
            est_g = est.copy(**g)
            fold_vals: List[float] = []
            with collector.trace_span(
                    f"sequential:{type(est).__name__}", kind="sweep_fit",
                    folds=int(masks.shape[0]), grid_index=int(gi)):
                for f in range(masks.shape[0]):
                    tr = masks[f] > 0
                    va = ~tr
                    model = est_g.fit_arrays(
                        X[torch.as_tensor(tr, device=X.device)], y[tr],
                        w[tr])
                    pred, raw, prob = model.predict_arrays(
                        X[torch.as_tensor(va, device=X.device)])
                    col = make_prediction_column(pred, raw, prob)
                    fold_vals.append(float(self.evaluator.evaluate(
                        y[va], col, w[va])))
            results[gi] = fold_vals
            if ckpt is not None:
                ckpt.record(keys[gi], type(est).__name__, g, fold_vals,
                            metric)
            self._cell_event(est, gi, fold_vals, "sequential")
        return self._validated(est, grids, metric, results, "sequential")


class CrossValidation(Validator):
    """k-fold CV (reference OpCrossValidation.scala:41; NumFolds default 3)."""

    def __init__(self, evaluator: Evaluator, num_folds: int = 3,
                 seed: int = 42, stratify: bool = False,
                 device: DeviceLike = None, **kwargs):
        super().__init__(evaluator, seed=seed, stratify=stratify,
                         device=device, **kwargs)
        if num_folds < 2:
            raise ValueError("num_folds must be >= 2")
        self.num_folds = int(num_folds)

    def fold_masks(self, y: np.ndarray) -> np.ndarray:
        fold_of = self._assign_folds(y, self.num_folds)
        masks = np.ones((self.num_folds, len(y)), np.float32)
        for f in range(self.num_folds):
            masks[f, fold_of == f] = 0.0
        return masks


class TrainValidationSplit(Validator):
    """Single split (reference OpTrainValidationSplit.scala:34;
    TrainRatio default 0.75)."""

    def __init__(self, evaluator: Evaluator, train_ratio: float = 0.75,
                 seed: int = 42, stratify: bool = False,
                 device: DeviceLike = None, **kwargs):
        super().__init__(evaluator, seed=seed, stratify=stratify,
                         device=device, **kwargs)
        if not 0.0 < train_ratio < 1.0:
            raise ValueError("train_ratio must be in (0, 1)")
        self.train_ratio = float(train_ratio)

    def fold_masks(self, y: np.ndarray) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        n = len(y)
        mask = np.ones((1, n), np.float32)
        if self.stratify:
            for cls in np.unique(y):
                idx = np.flatnonzero(y == cls)
                rng.shuffle(idx)
                n_val = int(round(len(idx) * (1.0 - self.train_ratio)))
                mask[0, idx[:n_val]] = 0.0
        else:
            perm = rng.permutation(n)
            n_val = int(round(n * (1.0 - self.train_ratio)))
            mask[0, perm[:n_val]] = 0.0
        return mask
