"""Layer fit/transform execution (counterpart of workflow/fitting.py).

Reference: core/.../utils/stages/FitStagesUtil.scala —
``fitAndTransformDAG:213`` fits a DAG layer by layer; within a layer every
estimator is fitted, then ``applyOpTransformations:96`` runs all row-level
transformers of the layer in ONE pass. Here every transformer of a layer
that has a torch function (stages/base.py `get_torch_fn`) runs in one pass
over device tensors: each input column moves to the device once, the
functions run in sequence (no compiler fusion), and the outputs come back
to the host as columns. Host-only transformers (string/object columns, the
vectorizers) run columnar on the host; at score time they write straight
into their slice of the VectorsCombiner's output (the combiner sinks).

The runner's `device` (Workflow(device=...)) fills the device of every
stage it fits or runs that has none; a stage given its own device keeps
it. `walls` holds the wall seconds of every fit and transform of its last
run (`fit_dag` or `apply_dag`), in order. While the run-metrics collector
is on (utils/metrics.collector) each layer is a "layer" span and each fit
and transform a "stage" span of its trace; `apply_dag(..., traced=False)`
(the serving path, WorkflowModel.score_fixed) keeps neither spans nor
walls; inside
`utils.sanitizers.debug_nans()` / `debug_infs()` every column a stage
outputs is checked for NaN / Inf it produced. Missing response columns at
scoring time are synthesized as all-NaN columns so (label, features) stages
score without labels.
"""
from __future__ import annotations

import contextlib
import copy
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.dataset import Column, Dataset
from ..device import DeviceLike, resolve_device, to_device
from ..stages.base import (TENSOR_KINDS, Estimator, PipelineStage,
                           Transformer, to_host)
from ..types import ColumnKind
from ..utils import sanitizers
from ..utils.metrics import collector
from .dag import StagesDAG


def _ensure_input_columns(ds: Dataset, stage: PipelineStage) -> Dataset:
    """Synthesize all-NaN columns for missing *response* inputs (score path)."""
    for f in stage.input_features:
        if f.name not in ds and f.is_response:
            kind = f.feature_type.column_kind
            if kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
                ds = ds.with_column(f.name, Column(
                    kind=kind, data=np.full(ds.n_rows, np.nan)))
            else:
                arr = np.empty(ds.n_rows, dtype=object)
                ds = ds.with_column(f.name, Column(kind=kind, data=arr))
    return ds


class LayerRunner:
    """Fits and applies the stages of DAG layers; the torch functions of a
    layer run together on device tensors."""

    def __init__(self, device: DeviceLike = None):
        self.device = device
        # {"stage": stage name(s), "op": "fit" | "transform", "seconds"}
        self.walls: List[Dict[str, Any]] = []

    def _bind(self, stage: PipelineStage) -> None:
        if stage.device is None:
            stage.device = self.device

    def _timed(self, stage: str, op: str, fn: Callable[[], Any],
               uid: str = "", n_rows: int = 0, n_fused: int = 1,
               traced: bool = True) -> Any:
        if not traced:
            return fn()
        t0 = time.perf_counter()
        with collector.span(stage[:120], uid, op, n_rows=n_rows,
                            n_stages_fused=n_fused):
            out = fn()
        self.walls.append({"stage": stage, "op": op.split("-")[-1],
                           "seconds": time.perf_counter() - t0})
        return out

    @staticmethod
    def _check(ds: Dataset, stages: Sequence[Transformer]) -> None:
        """Under debug_nans / debug_infs: each stage's output column."""
        if sanitizers.checking():
            for st in stages:
                sanitizers.check_stage_output(
                    st, ds.column(st.output_name()),
                    [ds.column(n) for n in st.input_names()])

    # -- one layer ---------------------------------------------------------
    def apply_layer(self, ds: Dataset,
                    transformers: Sequence[Transformer],
                    sinks: Optional[Tuple[Dict, Dict]] = None,
                    traced: bool = True) -> Dataset:
        producer_views, combiner_plans = sinks or ({}, {})
        for st in transformers:
            self._bind(st)
            ds = _ensure_input_columns(ds, st)
        tensor: List[Transformer] = []
        host: List[Transformer] = []
        for st in transformers:
            ok = st.get_torch_fn() is not None and all(
                ds.column(n).kind in TENSOR_KINDS for n in st.input_names())
            (tensor if ok else host).append(st)
        if tensor:
            ds = self._timed("+".join(st.stage_name for st in tensor),
                             "fused-transform",
                             lambda: self._apply_tensor_stages(ds, tensor),
                             uid=tensor[0].uid, n_rows=len(ds),
                             n_fused=len(tensor), traced=traced)
            self._check(ds, tensor)
        for st in host:
            plan = combiner_plans.get(st.uid)
            view = producer_views.get(st.uid)
            if plan is not None:
                run = (lambda st=st, d=ds:
                       self._apply_combiner_sink(d, st, plan))
            elif view is not None:
                run = (lambda st=st, d=ds:
                       self._apply_into_sink(d, st, view))
            else:
                run = (lambda st=st, d=ds: st.transform(d))
            ds = self._timed(st.stage_name, "transform", run, uid=st.uid,
                             n_rows=len(ds), traced=traced)
            self._check(ds, [st])
        return ds

    def _apply_tensor_stages(self, ds: Dataset,
                             stages: List[Transformer]) -> Dataset:
        """Every input column on each stage's device once, each stage's
        torch function on them, the outputs back as host columns."""
        on_device: Dict[Tuple[str, str], object] = {}
        outs = []
        for st in stages:
            dev = resolve_device(st.device)
            args = []
            for n in st.input_names():
                key = (n, str(dev))
                if key not in on_device:
                    on_device[key] = to_device(
                        np.asarray(ds.data(n), np.float32), dev,
                        label="layer")
                args.append(on_device[key])
            outs.append(to_host(st.get_torch_fn()(*args)))
        del on_device
        for st, out in zip(stages, outs):
            ds = ds.with_column(st.output_name(),
                                st.column_from_tensor_output(out))
        return ds

    # -- combiner sinks ------------------------------------------------------
    # The reference ran a layer's row transforms in ONE pass
    # (FitStagesUtil.applyOpTransformations:96). The memory-traffic analog:
    # at score time the VectorsCombiner's [n, W] output is allocated up
    # front and every host vectorizer writes its block straight into its
    # column slice, so wide blocks exist exactly once.
    def _apply_into_sink(self, ds: Dataset, st, view: np.ndarray) -> Dataset:
        try:
            cols = [ds.column(n) for n in st.input_names()]
            st.transform_block_into(cols, view)
            col = Column(kind=ColumnKind.VECTOR, data=view,
                         metadata=st.output_metadata())
            return ds.with_column(st.output_name(), col)
        except Exception:
            # partially-written view is dead weight: the combiner sees the
            # fallback column object (not the view) and re-copies over it
            view[:] = 0.0
            return st.transform(ds)

    def _apply_combiner_sink(self, ds: Dataset, st, plan) -> Dataset:
        final, views = plan
        try:
            cols = [ds.column(n) for n in st.input_names()]
            for n, c in zip(st.input_names(), cols):
                v = views[n]
                if c.data is not v:
                    d = c.data
                    if d.ndim == 1:
                        d = d[:, None]
                    if d.shape != v.shape:
                        raise AssertionError(
                            f"combiner input {n}: block {d.shape} vs "
                            f"planned slice {v.shape}")
                    v[:] = d
            md = st.combine_metadata(cols)
            col = Column(kind=ColumnKind.VECTOR, data=final, metadata=md)
            return ds.with_column(st.output_name(), col)
        except Exception:
            return st.transform(ds)

    def _plan_sinks(self, ds: Dataset,
                    dag: StagesDAG) -> Tuple[Dict, Dict]:
        """(producer uid -> slice view, combiner uid -> (final, views)).

        A sink forms when every input of a VectorsCombiner has a fitted
        vectorizer producer whose metadata pins its width. Host producers
        get their slice to write in place; tensor producers' blocks are
        copied in at combiner time."""
        from ..automl.vectorizers.base import VectorizerModel
        from ..automl.vectorizers.combiner import VectorsCombiner
        n = ds.n_rows
        stages = [st for layer in dag.layers for st in layer]
        by_out = {st.output_name(): st for st in stages}
        producer_views: Dict[str, np.ndarray] = {}
        combiner_plans: Dict[str, Tuple[np.ndarray,
                                        Dict[str, np.ndarray]]] = {}
        for st in stages:
            if not isinstance(st, VectorsCombiner):
                continue
            producers, widths = [], []
            for name in st.input_names():
                p = by_out.get(name)
                size = None
                if isinstance(p, VectorizerModel):
                    md = p.output_metadata()
                    if md is not None:
                        size = md.size
                if size is None:
                    break
                producers.append(p)
                widths.append(size)
            else:
                if not widths:
                    continue
                final = np.zeros((n, int(sum(widths))), np.float32)
                views: Dict[str, np.ndarray] = {}
                at = 0
                for name, p, w in zip(st.input_names(), producers, widths):
                    views[name] = final[:, at:at + w]
                    if p.get_torch_fn() is None:
                        producer_views[p.uid] = views[name]
                    at += w
                combiner_plans[st.uid] = (final, views)
        return producer_views, combiner_plans

    # -- whole DAG ---------------------------------------------------------
    def apply_dag(self, ds: Dataset, dag: StagesDAG,
                  traced: bool = True) -> Dataset:
        """Score path: every stage must already be a transformer (reference
        OpWorkflowCore.applyTransformationsDAG:290). traced=False skips the
        per-layer and per-stage spans and walls (the serving path,
        WorkflowModel.score_fixed)."""
        for layer in dag.layers:
            for st in layer:
                if isinstance(st, Estimator):
                    raise ValueError(
                        f"DAG contains unfitted estimator {st.stage_name}; "
                        f"train the workflow first")
        self.walls = []
        sinks = self._plan_sinks(ds, dag)
        for i, layer in enumerate(dag.layers):
            span = collector.trace_span(f"layer_{i}", kind="layer",
                                        n_stages=len(layer)) if traced \
                else contextlib.nullcontext()
            with span:
                ds = self.apply_layer(ds, layer,  # type: ignore[arg-type]
                                      sinks, traced=traced)
        return ds

    def fit_dag(self, ds: Dataset, dag: StagesDAG,
                prefitted: Optional[Dict[str, Transformer]] = None
                ) -> Tuple[Dataset, StagesDAG]:
        """Train path (reference fitAndTransformDAG:213): per layer — fit all
        estimators, then apply the layer's transformers (originals + freshly
        fitted models) in one pass. `prefitted` maps stage uid -> an
        already-fitted transformer (Workflow.with_model_stages, reference
        OpWorkflow.withModelStages:457): an estimator of that uid reuses a
        copy of it, wired to this DAG's features, instead of refitting."""
        prefitted = prefitted or {}
        fitted_layers: List[List[Transformer]] = []
        self.walls = []
        for li, layer in enumerate(dag.layers):
            with collector.trace_span(f"layer_{li}", kind="layer",
                                      n_stages=len(layer)):
                fitted: List[Transformer] = []
                for st in layer:
                    self._bind(st)
                    prev = prefitted.get(st.uid) \
                        if isinstance(st, Estimator) else None
                    if prev is not None:
                        # a copy: the source model's DAG still holds prev,
                        # and rewiring it in place would corrupt that model
                        prev = copy.deepcopy(prev)
                        prev.set_input(*st.input_features)
                        prev.set_output_name(st.output_name())
                        fitted.append(prev)
                    elif isinstance(st, Estimator):
                        data = _ensure_input_columns(ds, st)
                        fitted.append(self._timed(
                            st.stage_name, "fit", lambda: st.fit(data),
                            uid=st.uid, n_rows=len(data)))
                    else:
                        fitted.append(st)  # type: ignore[arg-type]
                ds = self.apply_layer(ds, fitted)
                fitted_layers.append(fitted)
        return ds, StagesDAG(layers=fitted_layers)  # type: ignore[arg-type]
