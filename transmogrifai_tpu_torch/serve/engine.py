"""ServingEngine: shape-bucketed scoring batches, prewarmed at startup
(counterpart of serve/engine.py).

The JAX package compiles one XLA program per (layer, batch shape) and
buckets batch sizes so that a server never compiles on the request path.
The port runs eagerly and compiles nothing per shape, but a first batch of
a new size still pays on the request path: the CUDA caching allocator
reserves new device segments (a cudaMalloc each) for blocks of a size it
has not held before. The engine keeps the JAX package's discipline, and
the cold starts it avoids are those:

- a POWER-OF-TWO BUCKET LADDER (1, 8, 16, ..., max_batch): every request
  batch pads up to the smallest bucket that holds it, so the set of batch
  shapes the device sees is fixed and finite;
- PREWARM scores one template batch a bucket through
  :meth:`WorkflowModel.score_fixed`, so the allocator holds each bucket's
  blocks before traffic arrives; ``serve --prewarm-only`` writes the
  ladder to serve.json beside the model and a later start prewarms the
  same ladder;
- PREALLOCATED INPUT COLUMNS per bucket: the raw-feature columns are
  allocated once and refilled in place each batch;
- ONE DEVICE THREAD: every batch the engine scores, prewarm included,
  runs on a thread of its own, whichever thread submitted it (the
  batcher's dispatcher, an HTTP worker with a bulk request). cuBLAS keeps
  a handle and a workspace for each thread, allocated on the thread's
  first product: scored on the caller's threads, each new thread would
  reserve memory on the request path;
- a COLD-START WATCH: after warmup the engine reads the
  ``utils.tracing.tracker`` after every batch (nvcc builds, new allocator
  segments on the serving device); any that lands after warmup adds to
  ``post_warmup_compiles`` and emits a ``serve_recompile`` event, which
  ``trace-report --check`` treats as a failure.

The batch route scores on the model's device (None: CUDA). The
single-record local route (``single_record="local"``) is the one route that
scores elsewhere, on the CPU by name (local/scoring.score_function).

Observability: per-batch ``batch_assemble`` / ``device_score`` spans (span
emission stops after TMOG_SERVE_SPAN_BUDGET batches so the in-memory tree
stays bounded under traffic; histograms and events continue),
``serve_batch`` / ``serve_prewarm`` / ``serve_recompile`` events, and
streaming-quantile latency histograms (utils/metrics.LatencyHistogram) that
the ``/metrics`` endpoint serves.

Not ported: the planner's bucket floor (the ladder is `bucket_ladder`,
which the JAX package's planner also returns on a cold corpus) and the
drift monitor (transmogrifai_tpu/monitor/): `monitor=` other than None
raises NotImplementedError.
"""
from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column, Dataset, column_from_values
from ..device import DeviceLike, resolve_device
from ..local.scoring import _extract as _extract_typed
from ..local.scoring import record_validator, score_function
from ..types import ColumnKind
from ..utils import tracing
from ..utils.metrics import LatencyHistogram, collector
from ..workflow.io import (load_serve_manifest, manifest_stamp,
                           save_serve_manifest, verify_serve_manifest)

Record = Dict[str, Any]

_log = logging.getLogger("transmogrifai_tpu_torch.serve")

DEFAULT_MAX_BATCH = 64
#: first ladder rung above the single-record bucket: buckets 2..7 would
#: each save less than a row of padding a request at the cost of one more
#: shape to prewarm
_BUCKET_FLOOR = 8

_NUMERIC_KINDS = (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL)


def bucket_ladder(max_batch: int,
                  floor: Optional[int] = None) -> Tuple[int, ...]:
    """(1, 8, 16, ..., 2^ceil(log2(max_batch))): the fixed batch shapes the
    engine scores. The top rung rounds max_batch UP to a power of two.
    ``floor`` overrides the first rung above the single-record bucket
    (default `_BUCKET_FLOOR`)."""
    mb = max(int(max_batch), 1)
    rungs = [1]
    if mb == 1:
        return (1,)
    b = max(int(floor) if floor else _BUCKET_FLOOR, 2)
    while b < mb:
        rungs.append(b)
        b *= 2
    rungs.append(b)
    return tuple(rungs)


_TEMPLATE_BY_KIND = {
    ColumnKind.FLOAT: 0.0,
    ColumnKind.INT: 0,
    ColumnKind.BOOL: False,
    ColumnKind.STRING: "",
    ColumnKind.STRING_LIST: [],
    ColumnKind.FLOAT_LIST: [],
    ColumnKind.STRING_SET: [],
    ColumnKind.MAP: {},
    ColumnKind.GEO: None,
    ColumnKind.VECTOR: None,
}


def template_record(raw_features: Sequence[Any]) -> Record:
    """A valid record for prewarm batches: one neutral value a predictor
    feature (responses are never extracted at serving time). The scores of
    a prewarm batch are discarded."""
    return {f.name: _TEMPLATE_BY_KIND.get(f.feature_type.column_kind)
            for f in raw_features if not f.is_response}


def _numeric_value(v: Any) -> float:
    """The record -> numeric cell coercion of the buffer fill: None -> NaN
    (missing), bools -> 1/0, else float (the JAX package's
    filters/sketches.numeric_value)."""
    if v is None:
        return float("nan")
    if v is True:
        return 1.0
    if v is False:
        return 0.0
    return float(v)


def _row_value(col: Column, i: int, feature_type: Any = None) -> Any:
    """One row of a scored column in the shape the per-record
    score_function yields (the JAX package's readers/streaming._row_value):
    a map-typed result feature (Prediction) stored as a named vector column
    unpacks into its {name: float} dict; other vectors stay arrays; a
    numeric NaN becomes None."""
    v = col.data[i]
    if col.kind == ColumnKind.VECTOR:
        if (feature_type is not None
                and getattr(feature_type, "column_kind", None)
                == ColumnKind.MAP and col.metadata is not None):
            from ..models.prediction import row_prediction
            return row_prediction(col, i).value
        return np.asarray(v)
    if col.kind in _NUMERIC_KINDS:
        f = float(v)
        return None if np.isnan(f) else f
    return v


class ServingEngine:
    """Loads (or wraps) a fitted WorkflowModel and serves fixed-shape score
    batches.

    `model`: a WorkflowModel or a saved-model directory, loaded onto
    `device` (None: CUDA). `buckets` / `example` default from the model
    directory's ``serve.json`` prewarm manifest when present (written by
    ``serve --prewarm-only``), else from `max_batch` / :func:`template_record`.
    `single_record="local"` routes batches of one through the per-record
    replay on the CPU (local/scoring.score_function) instead of the bucket-1
    batch. `monitor`: drift monitoring is not ported; only None is taken.
    """

    def __init__(self, model: Any, *, max_batch: int = DEFAULT_MAX_BATCH,
                 buckets: Optional[Sequence[int]] = None,
                 example: Optional[Record] = None,
                 single_record: str = "bucket",
                 strict_keys: bool = True,
                 monitor: Optional[Any] = None,
                 device: DeviceLike = None):
        if monitor is not None:
            raise NotImplementedError(
                "drift monitoring is not ported to transmogrifai_tpu_torch "
                "(transmogrifai_tpu/monitor/): serve with monitor=None")
        if isinstance(model, str):
            from ..workflow.workflow import WorkflowModel
            model = WorkflowModel.load(model, device=device)
        self.model = model
        #: the device of the batch route; its allocator is the one watched
        self.device = resolve_device(model.device)
        manifest = load_serve_manifest(getattr(model, "source_path", None))
        if buckets is None and manifest and manifest.get("buckets"):
            buckets = [int(b) for b in manifest["buckets"]]
        if example is None and manifest and \
                isinstance(manifest.get("example"), dict):
            example = manifest["example"]
        self.buckets: Tuple[int, ...] = (
            tuple(sorted({int(b) for b in buckets})) if buckets
            else bucket_ladder(max_batch))
        if self.buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1: {self.buckets}")
        # manifest freshness: the stamp written at --prewarm-only time must
        # still describe THIS artifact. A mismatch is a warning here;
        # `serve --strict-manifest` refuses to start on it
        self.manifest_mismatch: List[str] = verify_serve_manifest(
            getattr(model, "source_path", None), manifest)
        if manifest and manifest.get("buckets") and \
                self.buckets != tuple(sorted({int(b) for b
                                              in manifest["buckets"]})):
            self.manifest_mismatch.append(
                f"bucket ladder {list(self.buckets)} != manifest "
                f"{manifest['buckets']} (prewarmed executables cover "
                f"different shapes)")
        if self.manifest_mismatch:
            _log.warning("serve: STALE serve.json manifest — %s. Re-run "
                         "`serve --prewarm-only` after saving the model.",
                         "; ".join(self.manifest_mismatch))
        self.max_batch = self.buckets[-1]
        if single_record not in ("bucket", "local"):
            raise ValueError("single_record must be 'bucket' or 'local'")
        self.single_record = single_record

        self.raw = model.raw_features()
        self._predictors = [(f, f.origin_stage) for f in self.raw
                            if not f.is_response]
        self._result_types = {f.name: f.feature_type
                              for f in model.result_features}
        self.example: Record = (dict(example) if example
                                else template_record(self.raw))
        #: typed 400-class validation (local/scoring.record_validator): the
        #: batcher runs it BEFORE admission so one bad record can never
        #: poison a batch
        self.validate_record = record_validator(model,
                                                strict_keys=strict_keys)
        self._local_fn: Optional[Callable[[Record], Record]] = (
            score_function(model) if single_record == "local" else None)

        # preallocated per-bucket raw-feature columns (filled in place)
        self._buffers: Dict[int, Dict[str, Column]] = {}
        # serializes device scoring AND buffer reuse: batches from the
        # micro-batcher, bulk requests and prewarm never interleave on the
        # same buffers
        self._lock = threading.RLock()
        # the thread every batch is scored on (created on first use)
        self._device_thread: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        # leaf lock of the shared counters below (note_shed / observe_*
        # fire from every HTTP worker thread and the dispatcher, /metrics
        # reads from another). Always taken AFTER _lock, never around
        # device work
        self._stat_lock = threading.Lock()

        self.hist: Dict[str, LatencyHistogram] = {
            "total": LatencyHistogram("serve_total"),
            "queue_wait": LatencyHistogram("serve_queue_wait"),
            "batch_assemble": LatencyHistogram("serve_batch_assemble"),
            "device_score": LatencyHistogram("serve_device_score"),
            "monitor_observe": LatencyHistogram("serve_monitor_observe"),
        }
        self.n_requests = 0
        self.n_batches = 0
        self.n_rows = 0
        #: pad accounting: bucket_rows = device rows scored (padding
        #: included), pad_rows = the padding share; plain sums, so merged
        #: counters give the pad fraction exactly
        self.pad_rows = 0
        self.bucket_rows = 0
        self.n_shed = 0
        self.warm = False
        self.post_warmup_compiles = 0
        #: prewarm() summary, served again under /metrics "prewarm"
        self.prewarm_summary: Optional[Dict[str, Any]] = None
        self._warm_compiles = 0
        self._anchor = None
        self._span_budget = int(os.environ.get("TMOG_SERVE_SPAN_BUDGET",
                                               "10000"))

    # -- buckets -----------------------------------------------------------
    def pick_bucket(self, n: int) -> int:
        """Smallest bucket >= n (n must fit the top rung)."""
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(f"batch of {n} exceeds max bucket "
                         f"{self.max_batch}")

    def _score_fixed(self, ds: Dataset) -> Dataset:
        """model.score_fixed(ds) on the engine's device thread. Caller
        holds self._lock."""
        if self._device_thread is None:
            self._device_thread = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="serve-device")
        return self._device_thread.submit(self.model.score_fixed,
                                          ds).result()

    # -- assembly ----------------------------------------------------------
    def _bucket_columns(self, bucket: int) -> Dict[str, Column]:
        cols = self._buffers.get(bucket)
        if cols is None:
            cols = {}
            for f in self.raw:
                kind = f.feature_type.column_kind
                if kind == ColumnKind.VECTOR:
                    continue  # rare raw vectors: built fresh a batch
                if kind in _NUMERIC_KINDS:
                    arr = np.full(bucket, np.nan, np.float64)
                else:
                    arr = np.empty(bucket, dtype=object)
                # responses stay all-missing (serving records are
                # unlabeled); predictors refill every batch
                cols[f.name] = Column(kind=kind, data=arr)
            self._buffers[bucket] = cols
        return cols

    def _assemble(self, records: List[Record], bucket: int) -> Dataset:
        """Raw-feature Dataset of one padded batch, written into the
        bucket's preallocated columns. Caller holds self._lock."""
        cols = dict(self._bucket_columns(bucket))
        for f, gen in self._predictors:
            col = cols.get(f.name)
            if col is None:  # vector-kind raw feature: no reusable buffer
                cols[f.name] = column_from_values(
                    f.feature_type, [_extract_typed(gen, r)
                                     for r in records])
                continue
            data = col.data
            if col.kind in _NUMERIC_KINDS:
                for i, rec in enumerate(records):
                    data[i] = _numeric_value(_extract_typed(gen, rec))
            else:
                for i, rec in enumerate(records):
                    data[i] = _extract_typed(gen, rec)
        return Dataset(cols, n_rows=bucket)

    # -- scoring -----------------------------------------------------------
    def score_batch(self, records: Sequence[Record],
                    batch_trace: Optional[Any] = None) -> List[Record]:
        """Score records through the bucket ladder; one {result_feature:
        value} dict a record (the rows of the local per-record path:
        map-typed predictions unpack to dicts). Batches above the top
        bucket chunk into max-bucket slices. `batch_trace`
        (reqtrace.BatchTrace) receives the batch's shared assemble / device
        walls and pad accounting; chunked bulk accumulates across the
        slices."""
        records = list(records)
        if not records:
            return []
        if len(records) > self.max_batch:
            out: List[Record] = []
            for s in range(0, len(records), self.max_batch):
                out.extend(self.score_batch(records[s:s + self.max_batch],
                                            batch_trace=batch_trace))
            return out
        with self._stat_lock:
            warm = self.warm
        if len(records) == 1 and self._local_fn is not None and warm:
            t0 = time.perf_counter()
            res = self._local_fn(records[0])  # CPU replay: no device lock
            row = self._local_row(res)
            t1 = time.perf_counter()
            with self._lock:  # counters and histograms share the lock
                self._observe_batch(1, 1, 0.0, t1 - t0, path="local")
            if batch_trace is not None:
                batch_trace.add(1, 1, 0.0, t1 - t0, path="local")
            return [row]
        n = len(records)
        bucket = self.pick_bucket(n)
        # pad by repeating the last record: real values keep every stage's
        # numerics ordinary; pad rows are dropped after scoring
        padded = records + [records[-1]] * (bucket - n)
        with self._lock:
            t0 = time.perf_counter()
            ds = self._assemble(padded, bucket)
            t1 = time.perf_counter()
            # the batch lock serializes device scoring and buffer reuse
            scored = self._score_fixed(ds)
            cols = [(nm, scored.column(nm), t)
                    for nm, t in self._result_types.items() if nm in scored]
            out = [{nm: _row_value(col, i, t) for nm, col, t in cols}
                   for i in range(n)]
            t2 = time.perf_counter()
            self._observe_batch(bucket, n, t1 - t0, t2 - t1)
            self._check_recompiles()
        if batch_trace is not None:
            batch_trace.add(bucket, n, t1 - t0, t2 - t1)
        return out

    def _local_row(self, res: Record) -> Record:
        # normalize maps to plain dicts as the batch unpack does
        return {k: (dict(v.value) if hasattr(v, "value")
                    and isinstance(v.value, dict) else
                    (v.value if hasattr(v, "value") else v))
                for k, v in res.items()}

    def score_record(self, record: Record) -> Record:
        (out,) = self.score_batch([record])
        return out

    # -- prewarm -----------------------------------------------------------
    def prewarm(self) -> Dict[str, Any]:
        """Score one template batch a bucket, smallest first, so the
        caching allocator holds every bucket's blocks (and the kernel
        library is built, were a stage to launch one) before traffic.
        Returns a summary dict; afterwards the cold-start watch is
        armed."""
        from ..ops._build import BUILD_DIR

        with self._lock:
            if collector.enabled:
                with self._stat_lock:
                    self._anchor = collector.trace.current()
            t0 = time.perf_counter()
            if self.device.type == "cuda":
                # a context without an allocation, so that the first read
                # below sets the allocator's baseline before any bucket
                torch.cuda.init()
            tracing.tracker.sample_allocator(self.device)
            compiles0 = tracing.tracker.true_compiles
            hits0 = tracing.tracker.total_cache_hits
            per_bucket: List[Dict[str, Any]] = []
            for b in self.buckets:
                tb = time.perf_counter()
                cb0 = tracing.tracker.true_compiles
                recs = [dict(self.example) for _ in range(b)]
                ds = self._assemble(recs, b)
                # prewarm scores serially under the batch lock: no traffic
                # is admitted before warm
                self._score_fixed(ds)
                tracing.tracker.sample_allocator(self.device)
                per_bucket.append({
                    "bucket": b,
                    "wall_s": round(time.perf_counter() - tb, 4),
                    "compiles": tracing.tracker.true_compiles - cb0})
            wall = time.perf_counter() - t0
            with self._stat_lock:
                self.warm = True
                self._warm_compiles = tracing.tracker.true_compiles
                self.post_warmup_compiles = 0
            summary = {"buckets": list(self.buckets),
                       "wall_s": round(wall, 4),
                       "compiles": (self._warm_compiles - compiles0
                                    if collector.enabled else None),
                       "cache_hits": (tracing.tracker.total_cache_hits
                                      - hits0 if collector.enabled
                                      else None),
                       "compile_cache_dir": str(BUILD_DIR),
                       "per_bucket": per_bucket}
            with self._stat_lock:
                self.prewarm_summary = {
                    "wall_s": summary["wall_s"],
                    "compiles": summary["compiles"],
                    "cache_hits": summary["cache_hits"]}
            collector.event("serve_prewarm", buckets=list(self.buckets),
                            wall_seconds=round(wall, 6),
                            compiles=summary["compiles"],
                            cache_hits=summary["cache_hits"])
            _log.info("serve prewarm: %d bucket(s) %s in %.2fs on %s "
                      "(%s cold starts, %s cache hits; kernel builds in %s)",
                      len(self.buckets), list(self.buckets), wall,
                      self.device, summary["compiles"],
                      summary["cache_hits"], BUILD_DIR)
        return summary

    def write_manifest(self) -> Optional[str]:
        """Write the prewarm manifest (serve.json) beside the model so the
        next start prewarms the same ladder (`serve --prewarm-only`)."""
        src = getattr(self.model, "source_path", None)
        if not src:
            return None
        return save_serve_manifest(src, {
            "buckets": list(self.buckets),
            "max_batch": self.max_batch,
            "single_record": self.single_record,
            "example": self.example,
            # freshness stamp: adoption re-verifies it
            **manifest_stamp(src),
        })

    # -- telemetry ---------------------------------------------------------
    # Every mutable counter below is touched only under _stat_lock:
    # observe_request / note_shed run on HTTP worker threads,
    # _observe_batch on the dispatcher, metrics() on whoever asks. The
    # histograms keep their own locks.
    def observe_queue_wait(self, seconds: float) -> None:
        self.hist["queue_wait"].record(seconds)
        collector.latency("serve_queue_wait", seconds)
        with self._stat_lock:
            in_budget = self.n_batches <= self._span_budget
            anchor = self._anchor
        if collector.enabled and in_budget:
            collector.trace.add_complete("queue_wait", "serve", seconds,
                                         parent_span=anchor)

    def observe_request(self, seconds: float, bucket: int) -> None:
        with self._stat_lock:
            self.n_requests += 1
        self.hist["total"].record(seconds)
        collector.latency("serve_total", seconds)
        collector.event("serve_request",
                        wall_ms=round(seconds * 1e3, 3), bucket=bucket)

    def note_shed(self, queue_len: int) -> None:
        with self._stat_lock:
            self.n_shed += 1
            shed_total = self.n_shed
        collector.event("serve_shed", queue_len=queue_len,
                        shed_total=shed_total)

    def _observe_batch(self, bucket: int, n_valid: int,
                       assemble_s: float, score_s: float,
                       path: str = "bucket") -> None:
        with self._stat_lock:
            self.n_batches += 1
            self.n_rows += n_valid
            self.pad_rows += bucket - n_valid
            self.bucket_rows += bucket
            in_budget = self.n_batches <= self._span_budget
            anchor = self._anchor
        self.hist["batch_assemble"].record(assemble_s)
        self.hist["device_score"].record(score_s)
        collector.latency("serve_batch_assemble", assemble_s)
        collector.latency("serve_device_score", score_s)
        collector.event("serve_batch", bucket=bucket, rows=n_valid,
                        path=path, assemble_ms=round(assemble_s * 1e3, 3),
                        score_ms=round(score_s * 1e3, 3))
        if collector.enabled and in_budget:
            collector.trace.add_complete(
                "batch_assemble", "serve", assemble_s,
                parent_span=anchor, bucket=bucket, rows=n_valid)
            collector.trace.add_complete(
                "device_score", "serve", score_s,
                parent_span=anchor, bucket=bucket, rows=n_valid,
                path=path)

    def _check_recompiles(self) -> None:
        """Post-warmup cold-start watch: with the tracker active (collection
        enabled), any build or new allocator segment after prewarm is booked
        and flagged."""
        if not collector.enabled:
            return
        tracing.tracker.sample_allocator(self.device)
        with self._stat_lock:
            if not self.warm:
                return
            delta = tracing.tracker.true_compiles - self._warm_compiles
            new = delta - self.post_warmup_compiles
            if new > 0:
                self.post_warmup_compiles = delta
        if new > 0:
            collector.event("serve_recompile", compiles=new,
                            total_post_warmup=delta)
            _log.warning("serve: %d cold start(s) (kernel build or new "
                         "allocator segment) landed AFTER warmup (total "
                         "%d) — a request escaped the prewarmed ladder",
                         new, delta)

    def metrics(self) -> Dict[str, Any]:
        """Counters and latency quantiles: the /metrics payload."""
        with self._stat_lock:
            out = {"warm": self.warm,
                   "buckets": list(self.buckets),
                   "max_batch": self.max_batch,
                   "single_record": self.single_record,
                   "requests": self.n_requests,
                   "batches": self.n_batches,
                   "rows": self.n_rows,
                   "pad_rows": self.pad_rows,
                   "bucket_rows": self.bucket_rows,
                   "shed": self.n_shed,
                   "post_warmup_compiles": self.post_warmup_compiles,
                   "prewarm": self.prewarm_summary}
        out["latency"] = {k: h.to_json() for k, h in self.hist.items()}
        return out

    def gauge_state(self) -> Dict[str, Any]:
        """One cheap gauge snapshot (counters only): the GaugeSampler's
        read for the ``GET /metrics/history`` ring."""
        with self._stat_lock:
            return {"requests": self.n_requests,
                    "rows": self.n_rows,
                    "shed": self.n_shed,
                    "post_warmup_compiles": self.post_warmup_compiles,
                    "warm": self.warm}
