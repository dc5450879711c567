"""Run metrics + tracing registry (counterpart of utils/metrics.py).

Reference: utils/.../spark/OpSparkListener.scala:56-164 — per-stage/job/app
metrics collected by a listener, opt-in via OpParams.collectStageMetrics,
surfaced at app end. Here: per-stage wall clock and row counts, the tree
fits' kernel records with their analytic bytes, the GLM sweeps' round
telemetry, the statistics passes and the sharded ingest's parse passes.
The streamed data plane (parallel/tileplane.py, parallel/ingest.py) adds
`tile_copy`, `tile_compute` and `tile_parse` spans (kind "tile") with
`tile`, `rows` and `label` attributes, and a parse worker's `lane`.

Collection is opt-in and process-local: `collector.enable()` (or
`OpParams(collect_stage_metrics=True)` through the runner) turns it on;
every producer does nothing while it is off. Every record is also a node
of a span TREE (utils/tracing.py): enable() opens a root span;
span() / trace_span() nest under it; kernel() and sweep_convergence()
attach as child spans. `save()` writes the AppMetrics JSON with the tree
under "spans", `save_chrome_trace()` the Chrome trace, and an attached
event log (`attach_event_log` / `event`) streams run events as JSONL.

The roof of the card (`DEVICE_ROOFS`) is the one source of the HBM rate
and the float32 rate that the kernel records and chip_smoke.py's bounds
divide by.
"""
from __future__ import annotations

import collections
import contextlib
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

from . import tracing
from .tracing import EventLog, TraceTree


@dataclass
class StageMetric:
    """One fit/transform span (reference StageMetrics case class). A span
    is recorded even when its body raises, with error / error_type."""

    stage_name: str
    uid: str
    phase: str              # 'fit' | 'transform' | 'fused-transform'
    wall_seconds: float
    n_rows: int = 0
    n_stages_fused: int = 1
    error: bool = False
    error_type: Optional[str] = None

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


#: (device-name substring, HBM bytes/s, float32 operations/s outside the
#: tensor cores), most specific first: the published figures of each card
#: the port is measured on. The name is torch.cuda.get_device_name().
DEVICE_ROOFS: List[Tuple[str, float, float]] = [
    ("H100 80GB HBM3", 3.35e12, 67e12),     # H100 SXM
    ("H100 SXM", 3.35e12, 67e12),
]


def device_roof(device_name: str) -> Optional[Tuple[float, float]]:
    """(HBM bytes/s, f32 ops/s) of a card by its name, or None for a card
    not in DEVICE_ROOFS (and the CPU)."""
    name = device_name or ""
    return next(((b, f) for s, b, f in DEVICE_ROOFS if s in name), None)


def hbm_roof_gbps(device_name: str) -> Optional[float]:
    """HBM roof in GB/s of a card by its name, or None."""
    roof = device_roof(device_name)
    return None if roof is None else roof[0] / 1e9


def roofline_fields(wall_seconds: float, bytes_hbm: float,
                    roof_gbps: Optional[float]) -> Dict[str, Any]:
    """The achieved-GB/s / %-of-roof arithmetic shared by every kernel
    record; 3-decimal GB/s so small CPU figures stay nonzero; the roof
    fields None off the card."""
    gbps = bytes_hbm / max(wall_seconds, 1e-9) / 1e9
    return {"achieved_gbps": round(gbps, 3),
            "roof_gbps": roof_gbps,
            "pct_of_roof": (round(100.0 * gbps / roof_gbps, 2)
                            if roof_gbps else None)}


@dataclass
class KernelRoofline:
    """One timed fit with analytic HBM traffic attached. bytes_hbm comes
    from the kernels' own traffic model (ops/tree_kernels.fused_fit_bytes);
    achieved_gbps = bytes_hbm / wall; pct_of_roof against the card's HBM
    roof (None on the CPU). cold=True marks the first fit of its shape in
    the process (its wall includes the kernels' build)."""

    kernel: str
    wall_seconds: float
    bytes_hbm: float
    achieved_gbps: float = 0.0
    roof_gbps: Optional[float] = None
    pct_of_roof: Optional[float] = None
    cold: Optional[bool] = None

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class SweepConvergence:
    """Round/pass telemetry of one streamed GLM sweep (ops/glm_sweep.py).
    kernel: "gram" (squared loss, one pass), "rounds" (the retirement
    driver) or "global" (the legacy run-to-global-convergence route)."""

    family: str
    kernel: str
    rounds: int
    data_passes: int
    lane_passes: int
    lanes_total: int
    lanes_retired: int
    active_per_round: List[int] = field(default_factory=list)
    iters_per_round: List[int] = field(default_factory=list)
    bucket_sizes: List[int] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class StatsPass:
    """One pass of the statistics engine (ops/stats_engine.py): `passes`
    logical reads of X, `tiles` inside that read, `bytes_hbm` the
    analytic traffic (stats_pass_bytes)."""

    driver: str             # 'fused' | 'streamed'
    rows: int
    cols: int
    tiles: int
    bytes_hbm: float
    wall_seconds: float
    passes: int = 1
    label: str = "stats"
    cold: Optional[bool] = None

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class IngestPass:
    """One parse pass of the sharded ingest engine (parallel/ingest.py
    ShardedSource): `workers` the parse workers the pass ran with (after
    the min(workers, shards) clamp), `parse_seconds` the SUM of the
    workers' decode time (above `wall_seconds` when the pool decoded in
    parallel), `chunks` the columnar chunks reassembled in shard order.
    Serial passes (workers <= 1) are recorded too."""

    label: str
    workers: int
    shards: int
    chunks: int
    rows: int
    parse_seconds: float
    wall_seconds: float

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


class LatencyHistogram:
    """Streaming-quantile latency histogram.

    Fixed log-spaced buckets — `_BPD` per decade from 1 us to ~1000 s — so
    recording is O(1) and memory constant; quantiles come from the
    cumulative bucket counts with log-linear interpolation inside the
    winning bucket. Thread-safe."""

    _BPD = 7                     # buckets per decade
    _LO = 1e-6                   # 1 us floor
    _DECADES = 9                 # 1 us .. 1000 s
    _N = _BPD * _DECADES

    def __init__(self, name: str = "latency") -> None:
        self.name = name
        self.count = 0
        self.total_seconds = 0.0
        self.max_seconds = 0.0
        self._counts = [0] * (self._N + 1)  # +1 overflow bucket
        self._lock = threading.Lock()

    def _bucket(self, seconds: float) -> int:
        if seconds <= self._LO:
            return 0
        b = int(math.log10(seconds / self._LO) * self._BPD)
        return min(b, self._N)

    def _bound(self, b: int) -> float:
        """Upper bound of bucket b in seconds."""
        return self._LO * 10.0 ** ((b + 1) / self._BPD)

    def record(self, seconds: float) -> None:
        s = max(float(seconds), 0.0)
        with self._lock:
            self.count += 1
            self.total_seconds += s
            if s > self.max_seconds:
                self.max_seconds = s
            self._counts[self._bucket(s)] += 1

    def quantile(self, q: float) -> float:
        """Latency (seconds) at quantile q in [0, 1]; 0.0 when empty."""
        with self._lock:
            if not self.count:
                return 0.0
            target = q * self.count
            seen = 0
            for b, c in enumerate(self._counts):
                if not c:
                    continue
                if seen + c >= target:
                    lo = self._LO * 10.0 ** (b / self._BPD) \
                        if b else 0.0
                    hi = min(self._bound(b), self.max_seconds)
                    frac = (target - seen) / c
                    return lo + (max(hi, lo) - lo) * frac
                seen += c
            return self.max_seconds

    @property
    def mean_seconds(self) -> float:
        return self.total_seconds / self.count if self.count else 0.0

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add `other`'s observations into this histogram, in place: the
        buckets are identical across instances, so the merged counts are
        those of recording the union stream and every quantile of the
        merge equals the union stream's. Locks are taken one at a time."""
        with other._lock:
            counts = list(other._counts)
            count, total = other.count, other.total_seconds
            mx = other.max_seconds
        with self._lock:
            self.count += count
            self.total_seconds += total
            if mx > self.max_seconds:
                self.max_seconds = mx
            for b, c in enumerate(counts):
                if c:
                    self._counts[b] += c
        return self

    #: bucket key (the "buckets_ms" label of to_json) -> bucket index
    _KEY_TO_BUCKET: Optional[Dict[str, int]] = None

    @classmethod
    def _key_map(cls) -> Dict[str, int]:
        if cls._KEY_TO_BUCKET is None:
            lo = cls._LO
            cls._KEY_TO_BUCKET = {
                f"{lo * 10.0 ** ((b + 1) / cls._BPD) * 1e3:.3g}": b
                for b in range(cls._N + 1)}
        return cls._KEY_TO_BUCKET

    @staticmethod
    def from_json(doc: Dict[str, Any]) -> "LatencyHistogram":
        """Rebuild a histogram from its to_json() payload. Bucket counts
        and the total count round-trip exactly; mean/max carry to_json()'s
        4-decimal-ms rounding, so to_json(from_json(j)) == j."""
        h = LatencyHistogram(str(doc.get("name", "latency")))
        count = int(doc.get("count", 0))
        h.count, h.total_seconds, h.max_seconds = (
            count, float(doc.get("mean_ms", 0.0)) * count / 1e3,
            float(doc.get("max_ms", 0.0)) / 1e3)
        key_map = h._key_map()
        for key, c in (doc.get("buckets_ms") or {}).items():
            b = key_map.get(str(key))
            if b is None:
                raise ValueError(f"unknown latency bucket key {key!r}")
            h._counts[b] += int(c)
        return h

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            count, total = self.count, self.total_seconds
            mx = self.max_seconds
            nonzero = {f"{self._bound(b) * 1e3:.3g}": c
                       for b, c in enumerate(self._counts) if c}
        ms = 1e3
        return {"name": self.name, "count": count,
                "mean_ms": round(total / count * ms, 4) if count else 0.0,
                "p50_ms": round(self.quantile(0.50) * ms, 4),
                "p95_ms": round(self.quantile(0.95) * ms, 4),
                "p99_ms": round(self.quantile(0.99) * ms, 4),
                "max_ms": round(mx * ms, 4),
                "buckets_ms": nonzero}


class GaugeRing:
    """Fixed-length ring of gauge snapshots, each stamped with the ring's
    monotonic `t` (seconds since construction) and wall `ts` (epoch); the
    oldest snapshot drops out. Thread-safe."""

    def __init__(self, maxlen: int = 720) -> None:
        self._snaps: "collections.deque[Dict[str, Any]]" = \
            collections.deque(maxlen=int(maxlen))
        self._lock = threading.Lock()
        self._mono0 = time.perf_counter()

    def append(self, **gauges: Any) -> Dict[str, Any]:
        snap: Dict[str, Any] = {
            "t": round(time.perf_counter() - self._mono0, 3),
            "ts": round(time.time(), 3)}
        snap.update(gauges)
        with self._lock:
            self._snaps.append(snap)
        return snap

    def to_json(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(s) for s in self._snaps]

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)


@dataclass
class AppMetrics:
    """Whole-run metrics (reference AppMetrics)."""

    app_name: str = "transmogrifai_tpu_torch"
    start_time: float = 0.0
    end_time: float = 0.0
    stage_metrics: List[StageMetric] = field(default_factory=list)
    kernel_metrics: List[KernelRoofline] = field(default_factory=list)
    sweep_metrics: List[SweepConvergence] = field(default_factory=list)
    stats_metrics: List[StatsPass] = field(default_factory=list)
    ingest_metrics: List[IngestPass] = field(default_factory=list)
    latency_metrics: Dict[str, LatencyHistogram] = field(
        default_factory=dict)

    @property
    def duration_seconds(self) -> float:
        return max(self.end_time - self.start_time, 0.0)

    def total_stage_seconds(self) -> float:
        return sum(m.wall_seconds for m in self.stage_metrics)

    def to_json(self) -> Dict[str, Any]:
        """Empty kernel, sweep, stats, ingest and latency lists stay
        omitted."""
        out = {"app_name": self.app_name,
               "duration_seconds": self.duration_seconds,
               "total_stage_seconds": self.total_stage_seconds(),
               "stage_metrics": [m.to_json() for m in self.stage_metrics]}
        if self.kernel_metrics:
            out["kernel_metrics"] = [m.to_json()
                                     for m in self.kernel_metrics]
        if self.sweep_metrics:
            out["sweep_metrics"] = [m.to_json()
                                    for m in self.sweep_metrics]
        if self.stats_metrics:
            out["stats_metrics"] = [m.to_json()
                                    for m in self.stats_metrics]
        if self.ingest_metrics:
            out["ingest_metrics"] = [m.to_json()
                                     for m in self.ingest_metrics]
        if self.latency_metrics:
            out["latency_metrics"] = {k: h.to_json() for k, h
                                      in self.latency_metrics.items()}
        return out


class MetricsCollector:
    """Process-local registry (the listener's slot in this runtime).

    Lock order: `_lock` may be held while taking the tree's or the event
    log's lock, never the reverse."""

    def __init__(self) -> None:
        self.enabled = False
        self.current = AppMetrics()
        self.trace = TraceTree()
        self._finished = False
        self._event_log: Optional[EventLog] = None
        self._lock = threading.RLock()

    def enable(self, app_name: str = "transmogrifai_tpu_torch",
               device: Any = None) -> None:
        """Start (or join) a collected run. Reentrancy-safe: while a run is
        already being collected, a nested enable (runner.run with
        collect_stage_metrics inside an outer enable) joins the existing
        tree instead of resetting it. disable(), or finish() having closed
        the run, re-arms a fresh enable. `device`: the device whose memory
        the spans report (None: the current CUDA device once CUDA is
        initialised; "cpu": none)."""
        with self._lock:
            if self.enabled and not self._finished:
                return
            self.enabled = True
            self._finished = False
            self.current = AppMetrics(app_name=app_name,
                                      start_time=time.time())
            self.trace = TraceTree(device)
            # the cold-start tracker counts while a run is collected
            tracing.tracker.activate(self.trace)
            self.trace.open(app_name, "run")

    @property
    def collecting(self) -> bool:
        """True while an unfinished run is being collected — the state a
        nested enable() joins instead of resetting."""
        with self._lock:
            return self.enabled and not self._finished

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            tracing.tracker.deactivate()

    def finish(self) -> AppMetrics:
        """Close the run. Idempotent: end_time freezes on the first call."""
        with self._lock:
            if not self._finished:
                self.current.end_time = time.time()
                self.trace.close_all()
                self._finished = True
            return self.current

    # -- event log ---------------------------------------------------------
    @property
    def has_event_log(self) -> bool:
        with self._lock:
            return self._event_log is not None

    def attach_event_log(self, path: str) -> EventLog:
        """Open (append) the streaming JSONL event log. Events flow whether
        or not span collection is on. The new log opens before the old one
        closes: a failed open raises with the working log still attached."""
        new_log = EventLog(path)
        with self._lock:
            if self._event_log is not None:
                self._event_log.close()
            self._event_log = new_log
        return new_log

    def detach_event_log(self) -> None:
        with self._lock:
            log = self._event_log
            self._event_log = None
        if log is not None:
            log.close()

    def event(self, event: str, **fields: Any) -> None:
        """Emit one run event to the attached log (no-op without one). The
        log is taken under the lock, the write happens outside it."""
        with self._lock:
            log = self._event_log
        if log is not None:
            log.emit(event, **fields)

    # -- spans ---------------------------------------------------------------
    _EVENTED_KINDS = ("run", "workflow", "stage")

    @contextlib.contextmanager
    def trace_span(self, name: str, kind: str = "span",
                   **attrs: Any) -> Iterator[Optional[tracing.Span]]:
        """Generic span context: nests under the innermost open span,
        records error/error_type when the body raises, the device memory
        at close. Yields the Span (None when collection is off) so callers
        can add attrs."""
        with self._lock:
            if not self.enabled:
                sp = trace = None
            else:
                # the tree that opened the span closes it, even if an
                # enable() swaps self.trace meanwhile
                trace = self.trace
                sp = trace.open(name, kind, **attrs)
        if sp is None:
            yield None
            return
        if kind in self._EVENTED_KINDS:
            self.event("span_start", name=name, kind=kind)
        err: Optional[str] = None
        try:
            yield sp
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            trace.close(sp, error_type=err)
            if kind in self._EVENTED_KINDS:
                self.event("span_end", name=name, kind=kind,
                           wall_seconds=round(sp.duration, 6),
                           error=err is not None,
                           **({"error_type": err} if err else {}))

    @contextlib.contextmanager
    def span(self, stage_name: str, uid: str, phase: str,
             n_rows: int = 0, n_stages_fused: int = 1) -> Iterator[None]:
        """A stage's fit or transform: a "stage" span and a StageMetric."""
        with self._lock:
            if not self.enabled:
                sp = trace = cur = None
            else:
                t0 = time.time()
                trace = self.trace
                cur = self.current
                sp = trace.open(stage_name, "stage", uid=uid,
                                phase=phase, n_rows=n_rows,
                                n_stages_fused=n_stages_fused)
        if sp is None:
            yield
            return
        self.event("stage_start", stage=stage_name, uid=uid, phase=phase)
        err: Optional[str] = None
        try:
            yield
        except BaseException as e:
            err = type(e).__name__
            raise
        finally:
            trace.close(sp, error_type=err)
            wall = time.time() - t0
            cur.stage_metrics.append(StageMetric(
                stage_name=stage_name, uid=uid, phase=phase,
                wall_seconds=wall, n_rows=n_rows,
                n_stages_fused=n_stages_fused,
                error=err is not None, error_type=err))
            self.event("stage_end", stage=stage_name, uid=uid, phase=phase,
                       wall_seconds=round(wall, 6), error=err is not None,
                       **({"error_type": err} if err else {}))

    def kernel(self, name: str, wall_seconds: float, bytes_hbm: float,
               cold: Optional[bool] = None,
               attrs: Optional[Dict[str, Any]] = None,
               device: Any = None) -> Optional[KernelRoofline]:
        """Record one kernel-roofline span (no-op unless enabled). The roof
        is the card of `device` (None: the current CUDA device) from
        DEVICE_ROOFS, None on the CPU. The record also lands as a `kernel`
        child span of the innermost open span, with `attrs` merged in."""
        with self._lock:
            if not self.enabled:
                return None
            cur, trace = self.current, self.trace
        roof = None
        dev = tracing._cuda_device(device)
        if dev is not None:
            import torch
            roof = hbm_roof_gbps(torch.cuda.get_device_name(dev))
        rec = KernelRoofline(
            kernel=name, wall_seconds=round(wall_seconds, 4),
            bytes_hbm=float(bytes_hbm), cold=cold,
            **roofline_fields(wall_seconds, bytes_hbm, roof))
        cur.kernel_metrics.append(rec)
        trace.add_complete(
            name, "kernel", wall_seconds, bytes_hbm=rec.bytes_hbm,
            achieved_gbps=rec.achieved_gbps, roof_gbps=rec.roof_gbps,
            pct_of_roof=rec.pct_of_roof, cold=rec.cold, **(attrs or {}))
        return rec

    def sweep_convergence(self, family: str, kernel: str, rounds: int,
                          data_passes: int, lane_passes: int,
                          lanes_total: int, lanes_retired: int,
                          active_per_round=(), iters_per_round=(),
                          bucket_sizes=()) -> Optional[SweepConvergence]:
        """Record one streamed sweep's round/pass telemetry (no-op unless
        enabled)."""
        with self._lock:
            if not self.enabled:
                return None
            cur, trace = self.current, self.trace
        rec = SweepConvergence(
            family=family, kernel=kernel, rounds=int(rounds),
            data_passes=int(data_passes), lane_passes=int(lane_passes),
            lanes_total=int(lanes_total), lanes_retired=int(lanes_retired),
            active_per_round=[int(v) for v in active_per_round],
            iters_per_round=[int(v) for v in iters_per_round],
            bucket_sizes=[int(v) for v in bucket_sizes])
        cur.sweep_metrics.append(rec)
        trace.add_complete(
            f"{family}:{kernel}", "sweep", 0.0, **rec.to_json())
        return rec

    def stats_pass(self, driver: str, rows: int, cols: int, tiles: int,
                   bytes_hbm: float, wall_seconds: float,
                   cold: Optional[bool] = None, passes: int = 1,
                   label: str = "stats", device: Any = None
                   ) -> Optional[StatsPass]:
        """Record one statistics-engine pass (no-op unless enabled): a
        StatsPass record ("stats_metrics"), a kernel-roofline span named
        stats_pass[<driver>] and a `stats_pass` event."""
        with self._lock:
            if not self.enabled:
                return None
            cur = self.current
        rec = StatsPass(driver=driver, rows=int(rows), cols=int(cols),
                        tiles=int(tiles), bytes_hbm=float(bytes_hbm),
                        wall_seconds=round(wall_seconds, 6),
                        passes=int(passes), label=label, cold=cold)
        cur.stats_metrics.append(rec)
        self.kernel(f"stats_pass[{driver}]", wall_seconds, bytes_hbm,
                    cold=cold, attrs={"rows": int(rows), "cols": int(cols),
                                      "tiles": int(tiles),
                                      "passes": int(passes),
                                      "label": label}, device=device)
        self.event("stats_pass", driver=driver, rows=int(rows),
                   cols=int(cols), tiles=int(tiles), passes=int(passes),
                   bytes_hbm=float(bytes_hbm),
                   wall_seconds=round(wall_seconds, 6), label=label)
        return rec

    def ingest_pass(self, label: str, workers: int, shards: int,
                    chunks: int, rows: int, parse_seconds: float,
                    wall_seconds: float) -> Optional[IngestPass]:
        """Record one sharded-ingest parse pass (no-op unless enabled): an
        IngestPass record ("ingest_metrics") and an `ingest_pass` event.
        The per-chunk decode walls ride as `tile_parse` spans that the
        parse workers add, one `lane` attribute a worker."""
        with self._lock:
            if not self.enabled:
                return None
            cur = self.current
        rec = IngestPass(label=label, workers=int(workers),
                         shards=int(shards), chunks=int(chunks),
                         rows=int(rows),
                         parse_seconds=round(parse_seconds, 6),
                         wall_seconds=round(wall_seconds, 6))
        cur.ingest_metrics.append(rec)
        self.event("ingest_pass", label=label, workers=int(workers),
                   shards=int(shards), chunks=int(chunks), rows=int(rows),
                   parse_seconds=round(parse_seconds, 6),
                   wall_seconds=round(wall_seconds, 6))
        return rec

    def latency(self, name: str, wall_seconds: float
                ) -> Optional[LatencyHistogram]:
        """Record one latency observation into the named histogram (no-op
        unless enabled); it rides AppMetrics JSON as "latency_metrics"."""
        with self._lock:
            if not self.enabled:
                return None
            hist = self.current.latency_metrics.get(name)
            if hist is None:
                hist = self.current.latency_metrics.setdefault(
                    name, LatencyHistogram(name))
        hist.record(wall_seconds)  # the histogram has its own lock
        return hist

    def save(self, path: str, close: bool = True) -> None:
        """AppMetrics JSON + the span tree under "spans". close=False
        writes a snapshot without finishing: a run that joined an outer
        collection must not close the outer tree mid-run."""
        with self._lock:
            if close:
                doc = self.finish().to_json()
            else:
                doc = self.current.to_json()
                if not self._finished:
                    doc["duration_seconds"] = max(
                        time.time() - self.current.start_time, 0.0)
            if self.trace.spans:
                doc["spans"] = self.trace.to_json()
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)

    def save_chrome_trace(self, path: str, close: bool = True) -> None:
        """Chrome trace_event export of the span tree (Perfetto,
        chrome://tracing). close=False exports still-open spans drawn up
        to now instead of closing them."""
        if close:
            self.finish()
        with self._lock:
            trace, app_name = self.trace, self.current.app_name
        tracing.write_chrome_trace(path, trace, app_name=app_name)


# the process-wide collector the workflow engine reports to
collector = MetricsCollector()
