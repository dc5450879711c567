"""Per-request tracing of the serving path (counterpart of
serve/reqtrace.py, the same header, records and payloads).

A request crosses the frontend, the micro-batcher and the engine, and
merged histograms cannot say where a p99 spike lives: queue wait, batch
padding, device wall. This module is the request-level layer that can:

- a caller (a router, or the client) may send a trace id in the
  ``X-Tmog-Trace`` header; the server adopts it (or mints one) and echoes
  it back stamped with its replica id, so one id names the whole chain;
- every hop stamps SEGMENT durations onto a flat, slotted
  :class:`RequestTrace` record — one ``perf_counter`` read and one list
  append per mark, no span-tree nodes on the hot path. Only durations
  cross a process boundary, never timestamps;
- TAIL-BASED sampling decides at completion, when the request's fate is
  known: errors, sheds, retries and anything past the live latency-SLO
  quantile are always kept; the rest keep with probability
  ``TMOG_TRACE_SAMPLE``. Kept traces land as ``request_trace`` events on
  events.jsonl, in the bounded kept ring (``GET /requests``) and, while
  span collection is on, as a per-tracer LANE of the Chrome trace;
- every segment also feeds a :class:`LatencyHistogram` (bucket sums that
  merge exactly across processes);
- a :class:`~transmogrifai_tpu_torch.utils.metrics.GaugeRing` of periodic
  gauge snapshots (queue depth, in-flight, shed, post-warmup compiles)
  backs ``GET /metrics/history``.

Ownership: a RequestTrace / BatchTrace is owned by one thread at a time —
the handler thread creates it, the batcher's dispatcher stamps it between
the queue pop and ``done.set()``, and the handler resumes only after
``done.wait()``; every handoff goes through that Event, so the records
carry no locks. The one exit that skips the Event — a submit() timeout
racing a dispatch — reclaims the trace (nulls the pending's slot under the
batcher's condition; the dispatcher reads it once), so at worst a stamp
already in progress lands on a sound record that misses late segments.
Everything shared (ReqTracer's counters, the kept ring, the histograms,
the gauge ring) is locked.
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time
import traceback
import uuid
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils.metrics import GaugeRing, LatencyHistogram, collector

__all__ = [
    "TRACE_HEADER", "DEBUG_SLEEP_HEADER", "SEGMENTS", "mint_trace_id",
    "parse_trace_header", "format_trace_header", "env_enabled",
    "RequestTrace", "BatchTrace", "TailSampler", "ReqTracer",
    "GaugeSampler", "thread_dump",
]

#: the hop-context header: request carries ``<trace_id>``, the reply
#: echoes ``<trace_id>;replica=<replica_id>`` so the caller learns WHO
#: served it without parsing the body
TRACE_HEADER = "X-Tmog-Trace"
#: test hook: when the server runs with TMOG_DEBUG_SLEEP_MAX_MS > 0,
#: this header makes /score sleep (bounded) before scoring
DEBUG_SLEEP_HEADER = "X-Tmog-Debug-Sleep"

#: the segment glossary (the JAX package's, router segments included):
#: histograms for these are preallocated so the hot path never mutates the hist dict
SEGMENTS = ("parse", "validate", "queue", "batch", "device", "monitor",
            "debug_sleep", "respond", "route", "upstream")
#: the port's own segments of the batcher's hand-offs, preallocated too:
#: "dispatch", a rider's time in the dispatcher outside the engine's
#: walls (the engine lock, the result rows, the stamps of the riders
#: before it; a bulk request's scoring call outside them), and "wake",
#: from the dispatcher's done.set() until the handler thread runs again
PORT_SEGMENTS = ("dispatch", "wake")

_HEX = frozenset("0123456789abcdef")


def mint_trace_id() -> str:
    """16 hex chars of a uuid4 — unique across servers for any
    realistic retention window."""
    return uuid.uuid4().hex[:16]


def parse_trace_header(value: Optional[str]
                       ) -> Tuple[Optional[str], Dict[str, str]]:
    """(trace_id, attrs) from an ``X-Tmog-Trace`` value; (None, {}) when
    absent or malformed — a garbage header mints a fresh id rather than
    poisoning the corpus with unparseable keys."""
    if not value:
        return None, {}
    parts = str(value).split(";")
    tid = parts[0].strip().lower()
    if not tid or len(tid) > 32 or not set(tid) <= _HEX:
        return None, {}
    attrs: Dict[str, str] = {}
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            attrs[k.strip()] = v.strip()
    return tid, attrs


def format_trace_header(trace_id: str, **attrs: Any) -> str:
    out = str(trace_id)
    for k, v in attrs.items():
        if v is not None:
            out += f";{k}={v}"
    return out


def env_enabled() -> bool:
    """Process-wide request-tracing kill switch (TMOG_REQTRACE=0)."""
    return os.environ.get("TMOG_REQTRACE", "1").strip().lower() \
        not in ("0", "off", "false", "no")


class RequestTrace:
    """One request's flat trace record.

    Slotted and preallocated at admission — the request path pays one
    object construction, then one ``(name, seconds)`` append per
    segment mark. The record is NOT a span tree; kept records are
    converted to lane spans once, at completion, off the latency path.
    Batch-level walls (assemble, device, monitor) are SHARED across
    every request of the batch by design: each rider really did wait
    out the whole device wall, so per-request segment sums still cover
    per-request e2e walls."""

    __slots__ = ("trace_id", "origin", "t0", "segs", "status",
                 "error_type", "shed", "retries", "shadow_dropped",
                 "bucket", "rows", "pad_fraction", "replica", "wall_s",
                 "kept")

    def __init__(self, trace_id: str, origin: str) -> None:
        self.trace_id = trace_id
        self.origin = origin           # "router" | "replica"
        self.t0 = time.perf_counter()
        self.segs: List[Tuple[str, float]] = []
        self.status: Optional[int] = None
        self.error_type: Optional[str] = None
        self.shed = False
        self.retries = 0
        self.shadow_dropped = False
        self.bucket: Optional[int] = None
        self.rows = 1
        self.pad_fraction: Optional[float] = None
        self.replica: Optional[str] = None
        self.wall_s = 0.0
        self.kept: Optional[str] = None

    def seg(self, name: str, seconds: float) -> None:
        """Stamp one segment duration (monotonic-clock arithmetic done
        by the caller; negatives clamp to 0 rather than corrupting the
        coverage sums)."""
        self.segs.append((name, max(float(seconds), 0.0)))

    def segments_ms(self) -> Dict[str, float]:
        """Segment durations in ms, same-name marks summed (a retried
        request has two `upstream` marks; their total is what covered
        the wall)."""
        out: Dict[str, float] = {}
        for name, s in self.segs:
            out[name] = out.get(name, 0.0) + s * 1e3
        return {k: round(v, 3) for k, v in out.items()}

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "trace_id": self.trace_id,
            "origin": self.origin,
            "replica": self.replica,
            "status": self.status,
            "wall_ms": round(self.wall_s * 1e3, 3),
            "segments": self.segments_ms(),
        }
        if self.kept is not None:
            out["kept"] = self.kept
        if self.error_type:
            out["error_type"] = self.error_type
        if self.shed:
            out["shed"] = True
        if self.retries:
            out["retries"] = self.retries
        if self.shadow_dropped:
            out["shadow_dropped"] = True
        if self.bucket is not None:
            out["bucket"] = self.bucket
        if self.rows != 1:
            out["rows"] = self.rows
        if self.pad_fraction is not None:
            out["pad_fraction"] = round(self.pad_fraction, 4)
        return out


class BatchTrace:
    """Per-dispatch batch accounting the engine fills while scoring: the
    assemble/device/monitor walls every request of the batch shares,
    plus pad accounting. One slotted object per TRACED dispatch (the
    batcher allocates it only when at least one rider carries a trace);
    bulk requests accumulate across the engine's internal max-bucket
    chunks."""

    __slots__ = ("bucket", "rows", "bucket_rows", "assemble_s",
                 "score_s", "monitor_s", "batches", "path")

    def __init__(self) -> None:
        self.bucket: Optional[int] = None
        self.rows = 0
        self.bucket_rows = 0
        self.assemble_s = 0.0
        self.score_s = 0.0
        self.monitor_s = 0.0
        self.batches = 0
        self.path = "bucket"

    def add(self, bucket: int, n: int, assemble_s: float, score_s: float,
            monitor_s: float = 0.0, path: str = "bucket") -> None:
        self.bucket = int(bucket)
        self.rows += int(n)
        self.bucket_rows += int(bucket)
        self.assemble_s += float(assemble_s)
        self.score_s += float(score_s)
        self.monitor_s += float(monitor_s)
        self.batches += 1
        self.path = path

    @property
    def pad_fraction(self) -> float:
        """Fraction of scored device rows that were padding."""
        return ((self.bucket_rows - self.rows) / self.bucket_rows
                if self.bucket_rows else 0.0)

    @property
    def walls_s(self) -> float:
        """The shared walls' sum (assemble + device + monitor)."""
        return self.assemble_s + self.score_s + self.monitor_s

    def stamp(self, rt: RequestTrace) -> None:
        """Write this batch's shared walls onto one rider's record."""
        rt.seg("batch", self.assemble_s)
        rt.seg("device", self.score_s)
        if self.monitor_s:
            rt.seg("monitor", self.monitor_s)
        rt.bucket = self.bucket
        rt.pad_fraction = self.pad_fraction


class TailSampler:
    """Keep/drop decided at request COMPLETION (tail-based sampling).

    Head-based sampling throws away exactly the traces worth keeping —
    the decision fires before anyone knows the request will shed, error,
    retry, or land in the tail. This sampler sees the outcome: errors
    (4xx/5xx/exception), sheds, retries and shadow-mirror drops are
    ALWAYS kept; anything at or past the live SLO quantile of the e2e
    histogram is kept as "slow"; the rest keep with probability `rate`.
    The SLO threshold is re-read from the shared histogram every
    `refresh` observations (a quantile walk is ~60 bucket reads — cheap,
    but not free per request)."""

    def __init__(self, hist: LatencyHistogram, *, rate: float = 0.01,
                 slo_quantile: float = 0.99,
                 min_count: Optional[int] = None,
                 refresh: int = 64) -> None:
        self.hist = hist
        self.rate = max(float(rate), 0.0)
        self.slo_quantile = float(slo_quantile)
        if min_count is None:
            # TMOG_TRACE_SLO_MIN_COUNT: how many observations before
            # the tail threshold is trusted — small deployments lower
            # it so a "slow" verdict exists within their traffic volume
            try:
                min_count = int(os.environ.get(
                    "TMOG_TRACE_SLO_MIN_COUNT", "200"))
            except ValueError:
                min_count = 200
        self.min_count = int(min_count)
        self.refresh = max(int(refresh), 1)
        self._lock = threading.Lock()
        self._cached_slo: Optional[float] = None
        self._cached_at = -1

    def slow_threshold(self) -> Optional[float]:
        """Current SLO-latency threshold in seconds, or None while the
        histogram has too few observations to estimate a tail."""
        count = self.hist.count
        if count < self.min_count:
            return None
        with self._lock:
            if self._cached_slo is None or \
                    count - self._cached_at >= self.refresh:
                self._cached_slo = self.hist.quantile(self.slo_quantile)
                self._cached_at = count
            return self._cached_slo

    def decide(self, rt: RequestTrace) -> Optional[str]:
        """The keep reason, or None to drop. Precedence: the rarest,
        most diagnostic outcomes first."""
        status = rt.status or 0
        if rt.shed or status == 503:
            return "shed"
        if rt.error_type is not None or status >= 400:
            return "error"
        if rt.retries:
            return "retry"
        if rt.shadow_dropped:
            return "shadow_drop"
        thr = self.slow_threshold()
        if thr is not None and rt.wall_s >= thr:
            return "slow"
        if self.rate > 0.0 and random.random() < self.rate:
            return "sample"
        return None


class ReqTracer:
    """Per-process request tracer: one per replica (and one in the
    router). Owns the mergeable aggregates — per-segment
    LatencyHistograms + counters — the bounded kept-trace ring, the
    tail sampler, and the lane export of kept traces into the span
    tree. Disabled (`enabled=False`), :meth:`start` returns None and
    the request path pays one attribute read."""

    def __init__(self, replica_id: str, *, origin: str = "replica",
                 enabled: bool = True,
                 sample_rate: Optional[float] = None,
                 slo_quantile: float = 0.99, keep: int = 64,
                 span_budget: Optional[int] = None) -> None:
        self.replica_id = str(replica_id)
        self.origin = origin
        self.enabled = bool(enabled)
        if sample_rate is None:
            try:
                sample_rate = float(os.environ.get("TMOG_TRACE_SAMPLE",
                                                   "0.01"))
            except ValueError:
                sample_rate = 0.01
        # preallocated segment families (the hot path never inserts)
        self.hist: Dict[str, LatencyHistogram] = {
            "e2e": LatencyHistogram("req_e2e")}
        for name in SEGMENTS + PORT_SEGMENTS:
            self.hist[name] = LatencyHistogram(f"req_{name}")
        self.sampler = TailSampler(self.hist["e2e"], rate=sample_rate,
                                   slo_quantile=slo_quantile)
        self._lock = threading.Lock()
        self.kept: "deque[Dict[str, Any]]" = deque(maxlen=int(keep))
        self.n_traces = 0
        self.n_kept = 0
        self.kept_by_reason: Dict[str, int] = {}
        self.in_flight = 0
        if span_budget is None:
            try:
                span_budget = int(os.environ.get(
                    "TMOG_REQTRACE_SPAN_BUDGET", "1000"))
            except ValueError:
                span_budget = 1000
        self._span_budget = int(span_budget)
        self._spans = 0

    # -- request lifecycle --------------------------------------------------
    def start(self, header: Optional[str] = None
              ) -> Optional[RequestTrace]:
        """A fresh RequestTrace (None when tracing is off): adopts the
        inbound header's trace id when one arrived (the router minted
        it, or the client supplied its own), mints otherwise."""
        if not self.enabled:
            return None
        tid, _ = parse_trace_header(header)
        rt = RequestTrace(tid or mint_trace_id(), self.origin)
        with self._lock:
            self.n_traces += 1
            self.in_flight += 1
        return rt

    def finish(self, rt: Optional[RequestTrace],
               wall_s: Optional[float] = None,
               status: Optional[int] = None,
               error_type: Optional[str] = None) -> Optional[str]:
        """Complete one record: stamp outcome, feed the segment
        histograms, run the tail sampler, and — only for KEPT traces —
        emit the event + lane spans. Returns the keep reason (None when
        dropped). None-safe so callers can finish unconditionally."""
        if rt is None:
            return None
        rt.wall_s = (float(wall_s) if wall_s is not None
                     else time.perf_counter() - rt.t0)
        if status is not None:
            rt.status = int(status)
        if error_type:
            rt.error_type = error_type
        if rt.replica is None and self.origin == "replica":
            rt.replica = self.replica_id
        # O(1) aggregate updates — these run for EVERY request; the
        # histograms carry their own locks
        self.hist["e2e"].record(rt.wall_s)
        for name, dur in rt.segs:
            h = self.hist.get(name)
            if h is None:
                with self._lock:
                    h = self.hist.setdefault(name,
                                             LatencyHistogram(
                                                 f"req_{name}"))
            h.record(dur)
        reason = self.sampler.decide(rt)
        with self._lock:
            self.in_flight = max(self.in_flight - 1, 0)
            if reason is not None:
                rt.kept = reason
                self.n_kept += 1
                self.kept_by_reason[reason] = \
                    self.kept_by_reason.get(reason, 0) + 1
                self.kept.append(rt.to_json())
        if reason is not None:
            self._emit(rt)
        return reason

    def _emit(self, rt: RequestTrace) -> None:
        """One kept trace -> a `request_trace` event + (span budget
        permitting) a request window with its segment chain on this
        tracer's LANE of the Chrome trace. Runs after the response was
        sent — never on the request's latency path."""
        collector.event("request_trace", **rt.to_json())
        if not collector.enabled:
            return
        with self._lock:
            if self._spans >= self._span_budget:
                return
            self._spans += 1
        tree = collector.trace
        lane = f"req:{self.replica_id}"
        end = tree.now()
        start = max(end - rt.wall_s, 0.0)
        sp = tree.add_window(
            f"request[{rt.trace_id}]", "request", start, end, lane=lane,
            trace_id=rt.trace_id, status=rt.status, kept=rt.kept,
            replica=rt.replica, error=rt.error_type is not None)
        # segments laid end-to-end inside the request window (their
        # recorded order; unattributed gaps collapse) — clamped so
        # children never escape the parent (trace-report containment)
        cur = start
        for name, dur in rt.segs:
            seg_end = min(cur + dur, end)
            tree.add_window(name, "request_seg", cur, seg_end,
                            parent_span=sp, lane=lane)
            cur = seg_end

    # -- payloads -----------------------------------------------------------
    def requests_payload(self) -> Dict[str, Any]:
        """The ``GET /requests`` body: per-segment histograms (exact
        bucket sums that merge across processes, like /metrics latency),
        the kept-trace ring newest-last, and counters."""
        with self._lock:
            hists = dict(self.hist)
            kept = list(self.kept)
            counters = {"traces": self.n_traces, "kept": self.n_kept,
                        "kept_by_reason": dict(self.kept_by_reason),
                        "in_flight": self.in_flight}
        return {"replica": self.replica_id, "origin": self.origin,
                "enabled": self.enabled,
                "sample_rate": self.sampler.rate,
                # families this process never recorded are omitted (a
                # replica preallocates the router's route/upstream too;
                # serving their empty histograms would make a merge
                # claim segments nobody measured)
                "segments": {nm: h.to_json() for nm, h in hists.items()
                             if h.count or nm == "e2e"},
                "kept": kept, "counters": counters}


class GaugeSampler:
    """Daemon thread appending one gauge snapshot per interval into a
    GaugeRing (``TMOG_GAUGE_INTERVAL_S``, default 1s). The sample
    callable runs OFF the request path on this thread; its failures are
    contained — a gauge bug must not take down sampling, let alone
    serving."""

    def __init__(self, fn: Callable[[], Dict[str, Any]],
                 ring: Optional[GaugeRing] = None,
                 interval_s: Optional[float] = None,
                 maxlen: int = 720) -> None:
        self.fn = fn
        self.ring = ring if ring is not None else GaugeRing(maxlen)
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    "TMOG_GAUGE_INTERVAL_S", "1.0"))
            except ValueError:
                interval_s = 1.0
        self.interval_s = max(float(interval_s), 0.05)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop,
                                        name="gauge-sampler", daemon=True)

    def start(self) -> "GaugeSampler":
        self.sample_once()  # history is never empty while serving
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(5.0)

    def sample_once(self) -> None:
        try:
            self.ring.append(**self.fn())
        except Exception:  # noqa: BLE001 - containment is the contract
            pass

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()


def thread_dump(limit_frames: int = 12) -> Dict[str, List[str]]:
    """{thread label: innermost stack frames} for every live thread
    (sys._current_frames) — the core of ``GET /debugz``, the "why is it
    stuck" snapshot: a wedged dispatcher or a lock convoy is visible as
    the frame every thread is parked on."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: Dict[str, List[str]] = {}
    for ident, frame in sys._current_frames().items():
        frames = [f"{os.path.basename(fs.filename)}:{fs.lineno} {fs.name}"
                  for fs in traceback.extract_stack(frame)[-limit_frames:]]
        out[f"{names.get(ident, 'unknown')} ({ident})"] = frames
    return out
