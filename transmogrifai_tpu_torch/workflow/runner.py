"""OpParams run configuration + OpWorkflowRunner/OpApp entry points
(counterpart of workflow/runner.py).

Reference: features/.../OpParams.scala:81 (JSON run config: per-stage param
overrides withValues:116, reader params :229, model/write/metrics locations,
fromFile:300) and core/.../OpWorkflowRunner.scala:70 / OpApp.scala:49 —
run types Train/Score/Features/Evaluate (:296, 358-365) dispatched from CLI
args, each returning a typed result and writing its artifacts.

The runner runs where its workflow runs (`Workflow(device=...)`: CUDA
unless "cpu"); a model it loads goes onto the same device. With
`OpParams(collect_stage_metrics=True, metrics_location=dir)` a run is
traced by the run-metrics collector (utils/metrics.py) and writes
`<run>_stage_metrics.json` (AppMetrics and the span tree),
`<run>_trace.json` (Chrome trace) and `events.jsonl` (the event log) into
`dir`; `<run>_metrics.json` (the run's result) is written whenever
`metrics_location` is set. `OpParams(debug_nans=True)` runs inside
`utils.sanitizers.debug_nans()`. StreamingScore scores a streaming
reader (readers/streaming.py) through the tileplane in fixed record tiles
(`custom_params["score_tile_rows"]`; 0 = the per-record route) and
appends one JSON line a record to `<write_location>/scores.jsonl`.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..types import ColumnKind
from ..utils.metrics import collector


# -- params -----------------------------------------------------------------

@dataclass
class ReaderParams:
    """Reference ReaderParams:229 — per-reader path/partition overrides."""

    path: Optional[str] = None
    limit: Optional[int] = None
    custom: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"path": self.path, "limit": self.limit, "custom": self.custom}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ReaderParams":
        return ReaderParams(path=d.get("path"), limit=d.get("limit"),
                            custom=d.get("custom", {}))


@dataclass
class OpParams:
    """Reference OpParams.scala:81 — the JSON-file run configuration."""

    stage_params: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    reader_params: Dict[str, ReaderParams] = field(default_factory=dict)
    model_location: Optional[str] = None
    write_location: Optional[str] = None
    metrics_location: Optional[str] = None
    custom_params: Dict[str, Any] = field(default_factory=dict)
    collect_stage_metrics: bool = False
    # sanitizer opt-in (utils/sanitizers): raise on a NaN any stage
    # produces during the run
    debug_nans: bool = False

    def with_values(self, **kwargs: Any) -> "OpParams":
        """Reference withValues:116 — functional update."""
        out = OpParams(**{**self.__dict__})
        for k, v in kwargs.items():
            setattr(out, k, v)
        return out

    def to_json(self) -> Dict[str, Any]:
        return {
            "stage_params": self.stage_params,
            "reader_params": {k: v.to_json()
                              for k, v in self.reader_params.items()},
            "model_location": self.model_location,
            "write_location": self.write_location,
            "metrics_location": self.metrics_location,
            "custom_params": self.custom_params,
            "collect_stage_metrics": self.collect_stage_metrics,
            "debug_nans": self.debug_nans,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "OpParams":
        return OpParams(
            stage_params=d.get("stage_params", {}),
            reader_params={k: ReaderParams.from_json(v)
                           for k, v in d.get("reader_params", {}).items()},
            model_location=d.get("model_location"),
            write_location=d.get("write_location"),
            metrics_location=d.get("metrics_location"),
            custom_params=d.get("custom_params", {}),
            collect_stage_metrics=d.get("collect_stage_metrics", False),
            debug_nans=d.get("debug_nans", False),
        )

    @staticmethod
    def from_file(path: str) -> "OpParams":
        """Reference OpParams.fromFile:300."""
        with open(path) as f:
            return OpParams.from_json(json.load(f))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)


def apply_stage_params(workflow, params: OpParams) -> None:
    """Reference OpWorkflow.setStageParameters:166-188 — override stage
    params by stage class name or uid before fitting."""
    if not params.stage_params:
        return
    from .dag import compute_dag
    dag = compute_dag(workflow.result_features)
    for st in dag.stages:
        for key in (st.uid, type(st).__name__):
            overrides = params.stage_params.get(key)
            if overrides:
                for name, value in overrides.items():
                    if st.has_param(name):
                        st.set_param(name, value)


# -- run results ------------------------------------------------------------

@dataclass
class RunResult:
    run_type: str
    wall_seconds: float = 0.0


@dataclass
class TrainResult(RunResult):
    model_summary: str = ""
    model_location: Optional[str] = None


@dataclass
class ScoreResult(RunResult):
    n_rows: int = 0
    metrics: Dict[str, float] = field(default_factory=dict)
    write_location: Optional[str] = None


@dataclass
class FeaturesResult(RunResult):
    n_rows: int = 0
    feature_name: str = ""
    write_location: Optional[str] = None


@dataclass
class EvaluateResult(RunResult):
    metrics: Dict[str, float] = field(default_factory=dict)


class OpWorkflowRunner:
    """Reference OpWorkflowRunner.scala:70: one object owning the workflow,
    readers and evaluator, dispatching run types."""

    TRAIN = "Train"
    SCORE = "Score"
    STREAMING_SCORE = "StreamingScore"
    FEATURES = "Features"
    EVALUATE = "Evaluate"

    def __init__(self, workflow, train_reader=None, score_reader=None,
                 evaluator=None, features_to_compute: Sequence[Any] = ()):
        self.workflow = workflow
        self.train_reader = train_reader
        self.score_reader = score_reader
        self.evaluator = evaluator
        self.features_to_compute = list(features_to_compute)
        self._end_handlers: List[Callable[[RunResult], None]] = []
        self._owns_collection = True

    def add_application_end_handler(self, fn: Callable[[RunResult], None]
                                    ) -> "OpWorkflowRunner":
        """Reference addApplicationEndHandler:145."""
        self._end_handlers.append(fn)
        return self

    def _finish(self, result: RunResult, params: OpParams) -> RunResult:
        run = result.run_type.lower()
        if params.collect_stage_metrics and params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            # a collection this run joined (an outer enable) is not
            # finished from here: snapshots, the tree stays open
            close = self._owns_collection
            collector.save(os.path.join(params.metrics_location,
                                        f"{run}_stage_metrics.json"),
                           close=close)
            # the same span tree as a Chrome trace (Perfetto,
            # chrome://tracing), checked by utils.tracing.trace_report
            collector.save_chrome_trace(os.path.join(
                params.metrics_location, f"{run}_trace.json"), close=close)
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            payload = {k: v for k, v in result.__dict__.items()
                       if isinstance(v, (str, int, float, dict, list,
                                         type(None)))}
            with open(os.path.join(params.metrics_location,
                                   f"{run}_metrics.json"), "w") as f:
                json.dump(payload, f, indent=2, default=str)
        for fn in self._end_handlers:
            fn(result)
        return result

    # -- dispatch (reference run:296) --------------------------------------
    def run(self, run_type: str, params: Optional[OpParams] = None
            ) -> RunResult:
        params = params or OpParams()
        # a collection this run starts it also ends (finish + disable
        # below), or the next run's enable() would join it; a collection
        # an outer caller started is joined and left alone
        started_collection = (params.collect_stage_metrics
                              and not collector.collecting)
        self._owns_collection = started_collection
        attached_log = False
        error: Optional[str] = None
        # all setup inside the try: a failing makedirs/attach after
        # enable() must still reach the finally
        try:
            if params.collect_stage_metrics:
                collector.enable(app_name=type(self.workflow).__name__,
                                 device=self.workflow.device)
            if params.metrics_location and not collector.has_event_log:
                # the event log attaches whenever a metrics dir is given;
                # a log the caller attached is kept and left open
                os.makedirs(params.metrics_location, exist_ok=True)
                collector.attach_event_log(
                    os.path.join(params.metrics_location, "events.jsonl"))
                attached_log = True
            collector.event("run_start", run_type=run_type,
                            app=type(self.workflow).__name__)
            if params.debug_nans:
                from ..utils.sanitizers import debug_nans
                with debug_nans():
                    return self._dispatch(run_type, params)
            return self._dispatch(run_type, params)
        except BaseException as e:
            error = type(e).__name__
            raise
        finally:
            collector.event("run_end", run_type=run_type,
                            error=error is not None,
                            **({"error_type": error} if error else {}))
            if attached_log:  # never close a log this run did not open
                collector.detach_event_log()
            if started_collection:
                # idempotent after _finish's save; collector.current stays
                # readable, and the next enable() starts afresh
                collector.finish()
                collector.disable()

    def _dispatch(self, run_type: str, params: OpParams) -> RunResult:
        t0 = time.time()
        with collector.trace_span(run_type, kind="run"):
            if run_type == self.TRAIN:
                out = self._train(params)
            elif run_type == self.SCORE:
                out = self._score(params)
            elif run_type == self.STREAMING_SCORE:
                out = self._streaming_score(params)
            elif run_type == self.FEATURES:
                out = self._features(params)
            elif run_type == self.EVALUATE:
                out = self._evaluate(params)
            else:
                raise ValueError(f"Unknown run type: {run_type!r}")
        out.wall_seconds = time.time() - t0
        return self._finish(out, params)

    def _train(self, params: OpParams) -> TrainResult:
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        apply_stage_params(self.workflow, params)
        model = self.workflow.train()
        loc = params.model_location
        if loc:
            model.save(loc)
        return TrainResult(run_type=self.TRAIN,
                           model_summary=model.summary_pretty(),
                           model_location=loc)

    def _load_model(self, params: OpParams):
        from .workflow import WorkflowModel
        if not params.model_location:
            raise ValueError("model_location required")
        return WorkflowModel.load(params.model_location,
                                  device=self.workflow.device)

    def _score(self, params: OpParams) -> ScoreResult:
        model = self._load_model(params)
        if self.score_reader is not None:
            model.set_reader(self.score_reader)
        if self.evaluator is not None:
            scores, metrics = model.score_and_evaluate(self.evaluator)
        else:
            scores, metrics = model.score(), {}
        loc = params.write_location
        if loc:
            os.makedirs(loc, exist_ok=True)
            self._write_scores(scores, model, loc)
        return ScoreResult(run_type=self.SCORE, n_rows=scores.n_rows,
                           metrics=metrics, write_location=loc)

    @staticmethod
    def _write_scores(scores, model, loc: str) -> None:
        col = scores.column(model._prediction_name())
        rows = [v if not isinstance(v, np.ndarray) else v.tolist()
                for v in (col.data if col.kind != ColumnKind.VECTOR
                          else list(col.data))]
        with open(os.path.join(loc, "scores.jsonl"), "w") as f:
            for v in rows:
                f.write(json.dumps(v, default=str) + "\n")

    def _streaming_score(self, params: OpParams) -> ScoreResult:
        """Reference StreamingScore:232 — per-batch scoring over a
        StreamingReader (self.score_reader must be one)."""
        from ..readers.streaming import StreamingReader, score_stream
        if not isinstance(self.score_reader, StreamingReader):
            raise ValueError("StreamingScore needs a StreamingReader as "
                             "score_reader")
        model = self._load_model(params)
        loc = params.write_location
        n = 0
        out_f = None
        if loc:
            os.makedirs(loc, exist_ok=True)
            out_f = open(os.path.join(loc, "scores.jsonl"), "a")
        # custom_params["score_tile_rows"] overrides the fixed scoring
        # tile (TMOG_SCORE_TILE_ROWS; 0 = the per-record route) per run
        tile_rows = params.custom_params.get("score_tile_rows")
        try:
            for batch_scores in score_stream(model, self.score_reader,
                                             tile_rows=tile_rows):
                n += len(batch_scores)
                if out_f is not None:
                    for s in batch_scores:
                        out_f.write(json.dumps(s, default=str) + "\n")
        finally:
            if out_f is not None:
                out_f.close()
        return ScoreResult(run_type=self.STREAMING_SCORE, n_rows=n,
                           write_location=loc)

    def _features(self, params: OpParams) -> FeaturesResult:
        """Reference Features run type: computeDataUpTo(feature, path)."""
        if not self.features_to_compute:
            raise ValueError("features_to_compute required for Features run")
        feat = self.features_to_compute[0]
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        ds = self.workflow.compute_data_up_to(feat)
        loc = params.write_location
        if loc:
            os.makedirs(loc, exist_ok=True)
            cols = {}
            for name in ds.column_names():
                c = ds.column(name)
                if c.kind == ColumnKind.VECTOR:
                    cols[name] = np.asarray(c.data)
                elif c.kind in (ColumnKind.FLOAT, ColumnKind.INT,
                                ColumnKind.BOOL):
                    cols[name] = np.asarray(c.data, np.float64)
            np.savez(os.path.join(loc, "features.npz"), **cols)
        return FeaturesResult(run_type=self.FEATURES, n_rows=ds.n_rows,
                              feature_name=feat.name, write_location=loc)

    def _evaluate(self, params: OpParams) -> EvaluateResult:
        model = self._load_model(params)
        if self.score_reader is not None:
            model.set_reader(self.score_reader)
        if self.evaluator is None:
            raise ValueError("evaluator required for Evaluate run")
        metrics = model.evaluate(self.evaluator)
        return EvaluateResult(run_type=self.EVALUATE, metrics=metrics)


class OpApp:
    """Reference OpApp.scala:49 — arg parsing -> runner.run. Subclass and
    implement `runner()`; call `main(argv)`."""

    def runner(self) -> OpWorkflowRunner:  # pragma: no cover - abstract
        raise NotImplementedError

    def parse_args(self, argv: Optional[Sequence[str]] = None
                   ) -> argparse.Namespace:
        p = argparse.ArgumentParser(description=type(self).__name__)
        p.add_argument("--run-type", required=True,
                       choices=["Train", "Score", "Features", "Evaluate"])
        p.add_argument("--param-location", default=None,
                       help="JSON OpParams file")
        p.add_argument("--model-location", default=None)
        p.add_argument("--read-location", default=None)
        p.add_argument("--write-location", default=None)
        p.add_argument("--metrics-location", default=None)
        return p.parse_args(argv)

    def main(self, argv: Optional[Sequence[str]] = None) -> RunResult:
        a = self.parse_args(argv)
        params = (OpParams.from_file(a.param_location) if a.param_location
                  else OpParams())
        for k in ("model_location", "write_location", "metrics_location"):
            v = getattr(a, k)
            if v:
                setattr(params, k, v)
        return self.runner().run(a.run_type, params)
