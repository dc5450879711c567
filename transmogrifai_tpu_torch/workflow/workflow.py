"""Workflow: DAG assembly, training, scoring (counterpart of
workflow/workflow.py).

Reference: core/.../OpWorkflow.scala:59 (setResultFeatures:85 reconstructs
the stage DAG from feature lineage; train:332 / fitStages:368),
core/.../OpWorkflowCore.scala:52 (withWorkflowCV:104) and
core/.../OpWorkflowModel.scala:59 (score:254, scoreAndEvaluate:291,
evaluate:319, summaryPretty:205, save:219).

`Workflow(device=...)` is the one device switch of a whole workflow: the
layer runner passes it to every stage that touches tensors and has no
device of its own (None = CUDA; "cpu" runs the plain PyTorch versions of
the kernels). `with_raw_feature_filter` drops unreliable raw features
before the DAG is fitted (filters/raw_feature_filter.py).
`with_workflow_cv` refits the stages that feed the model selector inside
each fold; `with_model_stages` reuses a fitted model's stages;
`WorkflowModel.save` / `load` (workflow/io.py) write and read the JAX
package's format. train(), transform() and score() run with the cyclic
garbage collector paused (utils/gcpause.py) and, while the run-metrics
collector is on, as "workflow" spans of its trace. The runner
(workflow/runner.py) drives a workflow by run type. A fitted model serves
through `score_fixed` (the engine's fixed-shape batches, no spans),
`score_function()` (local/scoring.py, one record replayed on the CPU) and
`serving_engine()` (serve/engine.py). `model_insights()` joins the
fitted stages' diagnostics (insights/model_insights.py).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Column, Dataset
from ..device import DeviceLike
from ..evaluators.evaluators import Evaluator
from ..features.feature import Feature
from ..readers.readers import KEY_COLUMN, Reader
from ..stages.base import PipelineStage, Transformer
from ..types import Prediction
from ..utils.gcpause import paused_gc
from ..utils.metrics import collector
from .dag import (StagesDAG, collect_raw_features, compute_dag, cut_dag,
                  validate_stages)
from .fitting import LayerRunner


def _copy_dag(dag: StagesDAG) -> StagesDAG:
    """Fresh unfitted copies of every stage, wiring (inputs, output names,
    uids) preserved — each fold of a workflow-level CV refits these."""
    layers = []
    for layer in dag.layers:
        row = []
        for st in layer:
            c = st.copy()
            c.uid = st.uid
            c.set_output_name(st.output_name())
            row.append(c)
        layers.append(row)
    return StagesDAG(layers=layers)


def _grid_key(g: Dict[str, Any]) -> str:
    return json.dumps({k: g[k] for k in sorted(g)}, sort_keys=True,
                      default=str)


class Workflow:
    """Assembles the stage DAG from result features and trains it."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        self._result_features: Tuple[Feature, ...] = ()
        self._reader: Optional[Reader] = None
        self._input_dataset: Optional[Dataset] = None
        self._raw_feature_filter = None  # set via with_raw_feature_filter
        self._blacklist: List[str] = []
        self._prefitted: Optional[Dict[str, Transformer]] = None
        self._workflow_cv = False
        # the last workflow-level CV: the route of each (model, grid) cell
        # and each fold's walls (during-DAG refit, transform, sweep)
        self.workflow_cv_routes: Dict[tuple, str] = {}
        self.workflow_cv_walls: List[Dict[str, Any]] = []

    # -- configuration (reference OpWorkflow setters) ----------------------
    def set_result_features(self, *features: Feature) -> "Workflow":
        self._result_features = tuple(features)
        validate_stages(compute_dag(self._result_features))
        return self

    def set_reader(self, reader: Reader) -> "Workflow":
        self._reader = reader
        return self

    def set_input_dataset(self, ds: Dataset) -> "Workflow":
        self._input_dataset = ds
        return self

    def with_raw_feature_filter(self, rff) -> "Workflow":
        """Attach a RawFeatureFilter (reference
        OpWorkflow.withRawFeatureFilter:523); applied to raw data before
        fitting, its exclusions become the workflow blacklist. A filter
        without a device of its own runs on the workflow's."""
        self._raw_feature_filter = rff
        return self

    def with_model_stages(self, model: "WorkflowModel") -> "Workflow":
        """Splice a fitted model's stages into this workflow (reference
        OpWorkflow.withModelStages:457): on the next train(), an estimator
        whose uid matches a fitted stage reuses it instead of refitting."""
        self._prefitted = {st.uid: st for st in model.stages}
        return self

    def with_workflow_cv(self) -> "Workflow":
        """Leakage-free workflow-level CV (reference OpWorkflowCore
        .withWorkflowCV:104): every estimator between the first fitted
        statistic and the model selector is refit inside each fold, so no
        fold's validation rows reach the vectorizers' or the sanity
        checker's statistics. A workflow without a selector trains as
        without it."""
        self._workflow_cv = True
        return self

    @property
    def result_features(self) -> Tuple[Feature, ...]:
        return self._result_features

    def raw_features(self) -> List[Feature]:
        return collect_raw_features(self._result_features)

    # -- data --------------------------------------------------------------
    def generate_raw_data(self) -> Dataset:
        """Reference OpWorkflow.generateRawData:222."""
        raw = self.raw_features()
        if self._reader is not None:
            ds = self._reader.generate_dataset(raw)
        elif self._input_dataset is not None:
            ds = self._input_dataset
            missing = [f.name for f in raw if f.name not in ds]
            if missing:
                raise ValueError(
                    f"Input dataset is missing raw feature columns: {missing}")
        else:
            raise ValueError(
                "Set a reader or an input dataset before training")
        rff = self._raw_feature_filter
        if rff is not None:
            if rff.device is None:
                rff.device = self.device
            result = rff.apply(ds, raw)
            self._blacklist = list(result.dropped)
            ds = result.cleaned
        return ds

    # -- training ----------------------------------------------------------
    def train(self) -> "WorkflowModel":
        """Fit the DAG layer by layer on the raw data (reference
        OpWorkflow.train:332)."""
        with paused_gc(), collector.trace_span(
                f"{type(self).__name__}.train", kind="workflow"):
            return self._train()

    def _train(self) -> "WorkflowModel":
        raw_data = self.generate_raw_data()
        dag = compute_dag(self._result_features)
        validate_stages(dag)
        runner = LayerRunner(self.device)
        if self._workflow_cv:
            cut = cut_dag(dag)
            if cut.model_selector is not None:
                self._run_workflow_cv(raw_data, cut, runner)
        transformed, fitted_dag = runner.fit_dag(raw_data, dag,
                                                 prefitted=self._prefitted)
        rff = self._raw_feature_filter
        model = WorkflowModel(
            result_features=self._result_features, dag=fitted_dag,
            runner=runner, blacklist=self._blacklist,
            rff_results=rff.results if rff is not None else None)
        model._train_data = transformed
        model._reader = self._reader
        return model

    def _run_workflow_cv(self, raw_data: Dataset, cut, runner: LayerRunner
                         ) -> None:
        """Reference ModelSelector.findBestEstimator:112 + OpValidator
        .applyDAG:228: per fold, refit the in-CV ('during') DAG on the
        fold's train rows only, transform ALL rows with those fold-fitted
        stages, then run the (model x grid) sweep through the validator's
        device routes with the fold as one weight mask over the
        fold-fitted matrix (streamed / vmapped GLM lanes, mask-fold trees):
        no host fit loop. Each fold gets its own matrix, because its
        vocabularies and fills may differ. The winning configuration
        replaces the selector's candidate list before the full fit; the
        whole sweep goes into the selector summary."""
        from ..models.base import _as_labels, _as_matrix

        sel = cut.model_selector
        runner._bind(sel)
        sel._bind_device()
        ds1, _ = runner.fit_dag(raw_data, cut.before)
        label_name, vec_name = sel.input_names()
        y = _as_labels(ds1.column(label_name))
        masks = sel.validator.fold_masks(y)
        evaluator = sel.validator.evaluator
        metric = evaluator.default_metric
        larger = evaluator.is_larger_better()
        problem_type = getattr(sel, "problem_type", "binary")

        cells: Dict[tuple, List[float]] = {}
        self.workflow_cv_routes = {}
        self.workflow_cv_walls = []
        grid_keys = {}
        for mi, (est, grids) in enumerate(sel.models):
            for g in (grids or [dict()]):
                grid_keys[(est.uid, _grid_key(g))] = (mi, _grid_key(g))
        for f in range(masks.shape[0]):
            tr = np.flatnonzero(masks[f] > 0)
            va = np.flatnonzero(masks[f] <= 0)
            t0 = time.perf_counter()
            # fresh copies a fold, so the real stages stay unfitted for
            # the full fit; fit_dag transforms the train rows, the
            # validation rows go through the same fitted stages
            fold_runner = LayerRunner(self.device)
            ds_tr, fitted_during = fold_runner.fit_dag(
                ds1.take(tr), _copy_dag(cut.during))
            t1 = time.perf_counter()
            ds_va = fold_runner.apply_dag(ds1.take(va), fitted_during)
            Xtr = _as_matrix(ds_tr.column(vec_name))
            Xva = _as_matrix(ds_va.column(vec_name))
            Xf = np.empty((len(y), Xtr.shape[1]), Xtr.dtype)
            Xf[tr] = Xtr
            Xf[va] = Xva
            del ds_tr, ds_va, Xtr, Xva
            t2 = time.perf_counter()
            candidates = [(est, [dict(g) for g in (grids or [dict()])])
                          for est, grids in sel.models]
            fold_best = sel.validator.validate(
                candidates, Xf, y, problem_type=problem_type,
                masks=masks[f:f + 1])
            for v in fold_best.validated:
                key = grid_keys[(v.model_uid, _grid_key(v.grid))]
                cells.setdefault(key, []).append(float(v.fold_metrics[0]))
                self.workflow_cv_routes[key] = v.route
            self.workflow_cv_walls.append(dict(
                fold=f, refit_s=t1 - t0, transform_s=t2 - t1,
                sweep_s=time.perf_counter() - t2,
                family_sweep_s=dict(sel.validator.family_walls)))
        means = {k: float(np.mean(v)) for k, v in cells.items()}
        # a degenerate fold's NaN metric never wins by comparison
        fallback = -np.inf if larger else np.inf
        rank = {k: (v if np.isfinite(v) else fallback)
                for k, v in means.items()}
        best_key = (max if larger else min)(rank, key=rank.get)
        mi, _ = best_key
        winner_est, winner_grids = sel.models[mi]
        best_grid = next(g for g in (winner_grids or [dict()])
                         if _grid_key(g) == best_key[1])
        sel._extra_validation_results = [
            {"model_name": type(sel.models[k[0]][0]).__name__,
             "model_uid": sel.models[k[0]][0].uid,
             "grid": dict(next(g for g in (sel.models[k[0]][1] or [dict()])
                               if _grid_key(g) == k[1])),
             "metric_name": metric, "fold_metrics": v,
             "mean_metric": means[k], "workflow_cv": True}
            for k, v in cells.items()]
        sel.models = [(winner_est.copy(**best_grid), [dict(best_grid)])]

    def compute_data_up_to(self, feature: Feature) -> Dataset:
        """Materialize the DAG only up to `feature` (reference
        OpWorkflow.computeDataUpTo / runner Features run type)."""
        sub = Workflow(self.device).set_result_features(feature)
        if self._reader is not None:
            sub.set_reader(self._reader)
        if self._input_dataset is not None:
            sub.set_input_dataset(self._input_dataset)
        out, _ = LayerRunner(self.device).fit_dag(
            sub.generate_raw_data(), compute_dag((feature,)))
        return out

    def load_model(self, path: str,
                   custom_stages: Optional[Dict[str, PipelineStage]] = None,
                   device: DeviceLike = None) -> "WorkflowModel":
        """A saved model (workflow/io.py), its stages on `device` (None:
        this workflow's)."""
        from .io import load_model
        return load_model(path, custom_stages=custom_stages,
                          device=self.device if device is None else device)


class WorkflowModel:
    """Fitted workflow: every stage is a transformer; scoring applies the
    layers in order."""

    def __init__(self, result_features: Sequence[Feature], dag: StagesDAG,
                 runner: Optional[LayerRunner] = None,
                 blacklist: Sequence[str] = (), rff_results=None):
        self.result_features = tuple(result_features)
        self.dag = dag
        self.runner = runner or LayerRunner()
        self.blacklist = list(blacklist)
        self.rff_results = rff_results
        self._train_data: Optional[Dataset] = None
        self._reader: Optional[Reader] = None
        # the directory a loaded model came from (workflow/io.load_model)
        self.source_path: Optional[str] = None

    @property
    def device(self) -> DeviceLike:
        return self.runner.device

    # -- access ------------------------------------------------------------
    @property
    def stages(self) -> List[Transformer]:
        return self.dag.stages  # type: ignore[return-value]

    def raw_features(self) -> List[Feature]:
        return collect_raw_features(self.result_features)

    def set_reader(self, reader: Reader) -> "WorkflowModel":
        self._reader = reader
        return self

    def _stage_of(self, cls):
        return next((st for st in self.stages if isinstance(st, cls)), None)

    # -- scoring (reference OpWorkflowModel.score:254 / scoreFn:326) -------
    def transform(self, ds: Optional[Dataset] = None) -> Dataset:
        """Apply the full DAG; returns raw+derived columns."""
        if ds is None:
            if self._reader is None:
                raise ValueError("score needs a dataset or a reader")
            ds = self._reader.generate_dataset(self.raw_features())
        with paused_gc(), collector.trace_span(
                f"{type(self).__name__}.transform", kind="workflow",
                n_rows=len(ds)):
            return self.runner.apply_dag(ds, self.dag)

    def score(self, ds: Optional[Dataset] = None,
              keep_raw_features: bool = False) -> Dataset:
        """Reference saveScores:376 — keep result-feature columns (+ raw if
        asked), plus the row key when the reader produced one."""
        with paused_gc():
            full = self.transform(ds)
        keep = [KEY_COLUMN] if KEY_COLUMN in full else []
        keep += [f.name for f in self.result_features if f.name in full]
        if keep_raw_features:
            keep = [f.name for f in self.raw_features() if f.name in full] \
                + keep
        return full.select(keep)

    def score_fixed(self, ds: Dataset) -> Dataset:
        """Fixed-shape serving entry (serve/engine.py): the stages of
        score() on the model's devices with no per-call span, wall or gc
        bookkeeping, which a request loop must not grow. The caller pads
        each batch to a prewarmed bucket, so the caching allocator reuses
        the blocks the bucket's first batch reserved."""
        full = self.runner.apply_dag(ds, self.dag, traced=False)
        keep = [KEY_COLUMN] if KEY_COLUMN in full else []
        keep += [f.name for f in self.result_features if f.name in full]
        return full.select(keep)

    def score_and_evaluate(self, evaluator: Evaluator,
                           ds: Optional[Dataset] = None
                           ) -> Tuple[Dataset, Dict[str, Any]]:
        """Reference OpWorkflowModel.scoreAndEvaluate:291."""
        full = self.transform(ds)
        metrics = self._evaluate_on(full, evaluator)
        keep = [f.name for f in self.result_features if f.name in full]
        return full.select(keep), metrics

    def evaluate(self, evaluator: Evaluator,
                 ds: Optional[Dataset] = None) -> Dict[str, Any]:
        """Reference OpWorkflowModel.evaluate:319 (falls back to the cached
        training data like the reference's evaluate-on-train)."""
        if ds is None and self._train_data is not None:
            return self._evaluate_on(self._train_data, evaluator)
        return self._evaluate_on(self.transform(ds), evaluator)

    def _evaluate_on(self, full: Dataset,
                     evaluator: Evaluator) -> Dict[str, Any]:
        if evaluator.device is None:
            evaluator.device = self.device
        labels = np.asarray(full.data(self._response_name()),
                            dtype=np.float64)
        pred_col = full.column(self._prediction_name())
        mask = ~np.isnan(labels)
        if not mask.all():
            labels = labels[mask]
            pred_col = Column(kind=pred_col.kind, data=pred_col.data[mask],
                              metadata=pred_col.metadata)
        return evaluator.evaluate_all(labels, pred_col)

    def _response_name(self) -> str:
        for f in self.raw_features():
            if f.is_response:
                return f.name
        raise ValueError("No response raw feature in this workflow")

    def _prediction_name(self) -> str:
        for f in self.result_features:
            if issubclass(f.feature_type, Prediction):
                return f.name
        sel = self.selected_model()
        if sel is not None:
            return sel.output_name()
        raise ValueError("No Prediction result feature")

    # -- introspection -----------------------------------------------------
    def selected_model(self):
        from ..automl.selector import SelectedModel
        return self._stage_of(SelectedModel)

    def selector_summary(self):
        sel = self.selected_model()
        return sel.summary if sel is not None else None

    def _sanity_checker(self):
        from ..automl.preparators import SanityCheckerModel
        return self._stage_of(SanityCheckerModel)

    def sanity_checker_summary(self):
        sc = self._sanity_checker()
        return sc.summary if sc is not None else None

    def model_insights(self):
        """Reference OpWorkflowModel.modelInsights: the vector's columns
        joined with the SanityChecker's statistics, the selector's summary,
        the RawFeatureFilter's results and the winner's contributions."""
        from ..insights.model_insights import extract_insights
        return extract_insights(self)

    def summary(self) -> Dict[str, Any]:
        """Reference OpWorkflowModel.summary: stages, blacklist, model
        selection, sanity-check and raw-feature-filter results as JSON-able
        dicts."""
        out: Dict[str, Any] = {"stages": [st.stage_name for st in self.stages],
                               "blacklisted_features": self.blacklist}
        sel = self.selector_summary()
        if sel is not None:
            out["model_selection"] = sel.to_json()
        sc = self.sanity_checker_summary()
        if sc is not None:
            out["sanity_check"] = sc.to_json()
        if self.rff_results is not None:
            out["raw_feature_filter"] = self.rff_results.to_json()
        return out

    def summary_pretty(self) -> str:
        """Reference OpWorkflowModel.summaryPretty:205 — the README table."""
        lines: List[str] = []
        sel = self.selector_summary()
        if sel is not None:
            lines.append(sel.pretty())
        sc = self.sanity_checker_summary()
        if sc is not None:
            lines.append(f"SanityChecker dropped {len(sc.dropped)} columns: "
                         f"{sc.dropped[:10]}")
        if self.blacklist:
            lines.append(f"RawFeatureFilter excluded: {self.blacklist}")
        return "\n".join(lines) if lines else "(no selector in workflow)"

    # -- persistence (reference OpWorkflowModel.save:219) ------------------
    def save(self, path: str, overwrite: bool = True) -> None:
        """One op-model.json and one arrays.npz, the JAX package's format
        (workflow/io.py)."""
        from .io import save_model
        save_model(self, path, overwrite=overwrite)

    @staticmethod
    def load(path: str,
             custom_stages: Optional[Dict[str, PipelineStage]] = None,
             device: DeviceLike = None) -> "WorkflowModel":
        """A saved model of either package, every fitted stage on `device`
        (None: CUDA); `custom_stages` by uid for stages whose function does
        not travel (lambda stages)."""
        from .io import load_model
        return load_model(path, custom_stages=custom_stages, device=device)

    # -- local scoring (reference local/OpWorkflowModelLocal) --------------
    def score_function(self) -> Callable[[Dict[str, Any]], Dict[str, Any]]:
        """The per-record scorer (local/scoring.py): replays the fitted
        stages on one record dict, on the CPU."""
        from ..local.scoring import score_function
        return score_function(self)

    # -- serving (serve/engine.py) -----------------------------------------
    def serving_engine(self, **kwargs) -> Any:
        """A ServingEngine over this fitted model: shape-bucketed batches
        prewarmed at startup; keyword args go to
        serve.engine.ServingEngine."""
        from ..serve.engine import ServingEngine
        return ServingEngine(self, **kwargs)
