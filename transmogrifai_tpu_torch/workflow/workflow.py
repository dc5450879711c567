"""Workflow: DAG assembly, training, scoring (counterpart of
workflow/workflow.py).

Reference: core/.../OpWorkflow.scala:59 (setResultFeatures:85 reconstructs
the stage DAG from feature lineage; train:332 / fitStages:368),
core/.../OpWorkflowCore.scala:52 and core/.../OpWorkflowModel.scala:59
(score:254, scoreAndEvaluate:291, evaluate:319, summaryPretty:205).

`Workflow(device=...)` is the one device switch of a whole workflow: the
layer runner passes it to every stage that touches tensors and has no
device of its own (None = CUDA; "cpu" runs the plain PyTorch versions of
the kernels). `with_raw_feature_filter` drops unreliable raw features
before the DAG is fitted (filters/raw_feature_filter.py). Not ported yet:
workflow-level CV, splicing fitted stages into a new workflow, saving and
loading, insights, the runner and serving.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Column, Dataset
from ..device import DeviceLike
from ..evaluators.evaluators import Evaluator
from ..features.feature import Feature
from ..readers.readers import KEY_COLUMN, Reader
from ..stages.base import Transformer
from ..types import Prediction
from .dag import StagesDAG, collect_raw_features, compute_dag, validate_stages
from .fitting import LayerRunner


class Workflow:
    """Assembles the stage DAG from result features and trains it."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        self._result_features: Tuple[Feature, ...] = ()
        self._reader: Optional[Reader] = None
        self._input_dataset: Optional[Dataset] = None
        self._raw_feature_filter = None  # set via with_raw_feature_filter
        self._blacklist: List[str] = []

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
        raw_data = self.generate_raw_data()
        dag = compute_dag(self._result_features)
        validate_stages(dag)
        runner = LayerRunner(self.device)
        transformed, fitted_dag = runner.fit_dag(raw_data, dag)
        rff = self._raw_feature_filter
        model = WorkflowModel(
            result_features=self._result_features, dag=fitted_dag,
            runner=runner, blacklist=self._blacklist,
            rff_results=rff.results if rff is not None else None)
        model._train_data = transformed
        model._reader = self._reader
        return model


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
        return self.runner.apply_dag(ds, self.dag)

    def score(self, ds: Optional[Dataset] = None,
              keep_raw_features: bool = False) -> Dataset:
        """Reference saveScores:376 — keep result-feature columns (+ raw if
        asked), plus the row key when the reader produced one."""
        full = self.transform(ds)
        keep = [KEY_COLUMN] if KEY_COLUMN in full else []
        keep += [f.name for f in self.result_features if f.name in full]
        if keep_raw_features:
            keep = [f.name for f in self.raw_features() if f.name in full] \
                + keep
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

    def sanity_checker_summary(self):
        from ..automl.preparators import SanityCheckerModel
        sc = self._stage_of(SanityCheckerModel)
        return sc.summary if sc is not None else None

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
