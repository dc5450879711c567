"""Dependency-light HTTP/JSON frontend and the `serve` CLI body
(counterpart of serve/frontend.py: the same endpoints, payloads and status
codes).

Stdlib only (http.server.ThreadingHTTPServer). The HTTP layer is thin:
every request body is one JSON record (or a list for bulk), the typed
errors of the admission path map to status codes (validation -> 400,
Overloaded -> 503, a timeout -> 504, anything else -> 500), and `/metrics`
serves the engine's own latency histograms. Tests drive the same
:class:`ServeFrontend` in process through ``submit()`` /
``submit_many()``: the HTTP layer is transport, not logic.

Endpoints:
  POST /score         {record} -> scores; [records] -> bulk (no queue)
  GET  /healthz       liveness + warm/bucket state (503 when draining)
  GET  /metrics       engine counters + p50/p95/p99 latency histograms
  GET  /metrics/history  ring of periodic gauge snapshots (queue depth,
                      in-flight, shed, cold starts) — the time series
                      behind the counters
  GET  /requests      request-tracing payload: per-segment latency
                      histograms + the tail-kept trace ring
  GET  /debugz        live thread names + stack frames, queue depth,
                      dispatcher heartbeat age — the "why is it stuck"
                      snapshot
  GET  /drain         flip /healthz to draining-503 (also SIGUSR1) so a
                      router/LB rotates this replica out BEFORE SIGTERM;
                      in-flight and still-arriving requests keep scoring
  GET  /drift         404: drift monitoring is not ported
  GET  /drift/window  404, as the JAX package answers with monitoring off

Request tracing: every /score request gets a RequestTrace (trace id
adopted from the caller's ``X-Tmog-Trace`` header or minted), segments
stamped through parse -> validate -> queue -> batch -> device -> dispatch
-> wake -> respond, tail-sampled at completion; the reply echoes the
header back with this replica's id.

The drift monitor (the JAX package's monitor/, a monitor.json beside a
model it saved) is not ported: `serve --monitor auto` serves such a model
unmonitored and says so, `--monitor on` refuses to start (rc 2).
"""
from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple, Union

from ..local.scoring import (InvalidFeatureError, MissingFeatureError,
                             UnknownFeatureError)
from ..utils.metrics import GaugeRing, collector
from . import reqtrace
from .batcher import MicroBatcher, Overloaded
from .engine import ServingEngine
from .reqtrace import (BatchTrace, GaugeSampler, ReqTracer, RequestTrace,
                       thread_dump)

_log = logging.getLogger("transmogrifai_tpu_torch.serve")

#: the JAX package's drift monitor, which the port has not
UNPORTED_MONITOR = "transmogrifai_tpu/monitor/"

Record = Dict[str, Any]

#: the typed client errors -> HTTP 400 (bad request, not a server fault)
CLIENT_ERRORS = (UnknownFeatureError, MissingFeatureError,
                 InvalidFeatureError)


class ServeFrontend:
    """In-process API the HTTP handler and tests share.

    `max_bulk` bounds ONE HTTP bulk request (HTTP 413 above it): the bulk
    lane bypasses the admission queue, so without a bound a single giant
    list could hold the engine lock for minutes while single-record
    traffic starves behind it. In-process callers (batch jobs) call
    engine.score_batch directly for row floods."""

    def __init__(self, engine: ServingEngine, batcher: MicroBatcher,
                 max_bulk: int = 65536,
                 tracer: Optional[ReqTracer] = None):
        self.engine = engine
        self.batcher = batcher
        self.max_bulk = int(max_bulk)
        # drain flag (GET /drain or SIGUSR1): an Event — set/is_set are
        # atomic, shared by HTTP workers and the signal path
        self._draining = threading.Event()
        #: per-replica request tracer (reqtrace) + the gauge ring behind
        #: GET /metrics/history; run_serve passes the CLI-configured
        #: tracer, in-process embedders get the env-gated default
        self.tracer = tracer if tracer is not None else ReqTracer(
            f"pid{os.getpid()}", enabled=reqtrace.env_enabled())
        self.gauges = GaugeRing()
        #: the X-Tmog-Debug-Sleep test hook is OFF unless the operator
        #: opted in; the cap bounds what any client can inflict
        try:
            self.debug_sleep_max_ms = float(
                os.environ.get("TMOG_DEBUG_SLEEP_MAX_MS", "0"))
        except ValueError:
            self.debug_sleep_max_ms = 0.0
        # duck-typed engine stand-ins (tests, adapters) may not accept
        # batch_trace=; probe the signature ONCE so the traced bulk path
        # degrades to untraced batch walls instead of a 500 per request
        import inspect
        try:
            self._engine_takes_batch_trace = "batch_trace" in \
                inspect.signature(engine.score_batch).parameters
        except (TypeError, ValueError):
            self._engine_takes_batch_trace = False

    def submit(self, record: Record, timeout: Optional[float] = None,
               trace: Optional[RequestTrace] = None) -> Record:
        """One record through the micro-batching queue."""
        return self.batcher.submit(record, timeout=timeout, trace=trace)

    def submit_many(self, records: List[Record],
                    trace: Optional[RequestTrace] = None) -> List[Record]:
        """Bulk scoring straight through the bucket ladder (no queue —
        a bulk caller IS a batch already)."""
        t0 = time.perf_counter()
        for r in records:
            self.engine.validate_record(r)
        if trace is None:
            return self.engine.score_batch(records)
        trace.seg("validate", time.perf_counter() - t0)
        # request-thread-owned record (reqtrace single-owner contract)
        trace.rows = len(records)
        if not self._engine_takes_batch_trace:
            return self.engine.score_batch(records)
        bt = BatchTrace()
        t1 = time.perf_counter()
        out = self.engine.score_batch(records, batch_trace=bt)
        trace.seg("dispatch", time.perf_counter() - t1 - bt.walls_s)
        bt.stamp(trace)
        return out

    def debug_sleep(self, headers: Any,
                    trace: Optional[RequestTrace]) -> None:
        """Honor the X-Tmog-Debug-Sleep header (bounded by
        TMOG_DEBUG_SLEEP_MAX_MS, default 0 = hook disabled): the
        injected latency is its own trace segment, so a deliberately
        slow request still covers its e2e wall."""
        if self.debug_sleep_max_ms <= 0:
            return
        raw = headers.get(reqtrace.DEBUG_SLEEP_HEADER)
        if not raw:
            return
        try:
            ms = min(float(raw), self.debug_sleep_max_ms)
        except ValueError:
            return
        if ms <= 0:
            return
        time.sleep(ms / 1e3)
        if trace is not None:
            trace.seg("debug_sleep", ms / 1e3)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self) -> Dict[str, Any]:
        """Flip /healthz to draining-503 while the engine keeps scoring
        everything in flight (and anything that still arrives): the
        router (or any load balancer probing /healthz) takes
        the replica out of rotation, traffic bleeds off, and only THEN
        does the operator send SIGTERM. Before this endpoint the only
        drain was SIGTERM itself, which gave an LB no advance notice.
        Idempotent; there is deliberately no un-drain (a drained replica
        restarts, re-proving the compile-free-start contract)."""
        if not self._draining.is_set():
            self._draining.set()
            collector.event("serve_drain",
                            queue_len=self.batcher.queue_len)
            _log.info("serve: draining — /healthz now 503, in-flight "
                      "requests finishing")
        return self.healthz()

    def healthz(self) -> Dict[str, Any]:
        status = "ok" if self.engine.warm else "warming"
        out = {"warm": self.engine.warm,
               "buckets": list(self.engine.buckets),
               "queue_len": self.batcher.queue_len,
               "closed": self.batcher.closed}
        if self._draining.is_set():
            # draining wins over every other verdict: the whole point is
            # that probes stop selecting this replica
            status = "draining"
        out["draining"] = self._draining.is_set()
        out["status"] = status
        return out

    def metrics(self) -> Dict[str, Any]:
        return self.engine.metrics()

    def requests(self) -> Dict[str, Any]:
        """The ``GET /requests`` payload: this replica's per-segment
        histograms + tail-kept traces (observability.md)."""
        return self.tracer.requests_payload()

    def history(self) -> Dict[str, Any]:
        """The ``GET /metrics/history`` payload: the gauge ring."""
        return {"replica": self.tracer.replica_id,
                "interval_hint_s": None,
                "gauges": self.gauges.to_json()}

    def sample_gauges(self) -> Dict[str, Any]:
        """One gauge snapshot (GaugeSampler's read): queue depth +
        in-flight + the engine's counter gauges."""
        out = {"queue_depth": self.batcher.queue_len,
               "in_flight": self.tracer.in_flight,
               "draining": self.draining}
        out.update(self.engine.gauge_state())
        return out

    def debugz(self) -> Dict[str, Any]:
        """The "why is it stuck" snapshot: every live thread's name +
        innermost stack frames (sys._current_frames), queue depth, and
        the lock-ish health bits — batcher thread alive, dispatcher
        heartbeat age (a big age with a deep queue = the dispatcher is
        wedged inside a batch)."""
        return {"threads": thread_dump(),
                "queue_len": self.batcher.queue_len,
                "batcher_alive": self.batcher.alive,
                "batcher_closed": self.batcher.closed,
                "dispatcher_beat_age_s": round(self.batcher.beat_age(),
                                               4),
                "in_flight": self.tracer.in_flight,
                "warm": self.engine.warm,
                "draining": self.draining}


class _Handler(BaseHTTPRequestHandler):
    server_version = "transmogrifai-tpu-torch-serve"
    frontend: ServeFrontend  # attached by make_http_server

    def log_message(self, fmt: str, *args: Any) -> None:
        _log.debug("http: " + fmt, *args)

    def _reply(self, code: int, payload: Any,
               trace_header: Optional[str] = None) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if trace_header:
            # hop-context echo: the caller (router or client) learns the
            # serving replica id without parsing the body
            self.send_header(reqtrace.TRACE_HEADER, trace_header)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
        fe = self.server.frontend  # type: ignore[attr-defined]
        if self.path == "/healthz":
            h = fe.healthz()
            self._reply(503 if h["status"] in ("degraded", "draining")
                        else 200, h)
        elif self.path == "/metrics":
            self._reply(200, fe.metrics())
        elif self.path == "/metrics/history":
            self._reply(200, fe.history())
        elif self.path == "/requests":
            self._reply(200, fe.requests())
        elif self.path == "/debugz":
            self._reply(200, fe.debugz())
        elif self.path == "/drain":
            self._reply(200, fe.drain())
        elif self.path == "/drift/window":
            # the JAX package's answers with its monitor off (not ported)
            self._reply(404, {"error": "drift monitoring not enabled"})
        elif self.path == "/drift":
            self._reply(404, {"error": "drift monitoring not enabled "
                                       "(no monitor.json profile, or "
                                       "--monitor off)"})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802
        fe = self.server.frontend  # type: ignore[attr-defined]
        if self.path == "/drain":
            # REST-proper alias of GET /drain (kept on GET too for curl
            # ergonomics and the documented LB-rotation contract)
            self._reply(200, fe.drain())
            return
        if self.path != "/score":
            self._reply(404, {"error": f"unknown path {self.path}"})
            return
        # request trace: id adopted from the router's header (or the
        # client's), minted here otherwise; None when tracing is off —
        # every stamp below is behind one None check
        rt = fe.tracer.start(self.headers.get(reqtrace.TRACE_HEADER))
        t0 = time.perf_counter()
        code, payload = self._score_body(fe, rt, t0)
        t1 = time.perf_counter()
        header = (reqtrace.format_trace_header(
            rt.trace_id, replica=fe.tracer.replica_id)
            if rt is not None else None)
        try:
            self._reply(code, payload, trace_header=header)
        except OSError:
            # the client hung up (e.g. the router's timeout fired while
            # we were scoring) — exactly a trace worth keeping
            if rt is not None:
                rt.error_type = rt.error_type or "ClientDisconnect"
            raise
        finally:
            # tail sampling happens HERE, after the response left (or
            # failed to): finish must run on EVERY exit or in_flight
            # leaks and the interesting trace is dropped
            if rt is not None:
                rt.seg("respond", time.perf_counter() - t1)
                fe.tracer.finish(rt, time.perf_counter() - t0,
                                 status=code)

    def _score_body(self, fe: "ServeFrontend",
                    rt: Optional[RequestTrace],
                    t0: float) -> Tuple[int, Any]:
        """(status, payload) of one /score request; trace segments and
        the error/shed markers the tail sampler keys on are stamped on
        `rt` along the way."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
            doc: Union[Record, List[Record]] = json.loads(
                self.rfile.read(length) or b"null")
            if rt is not None:
                rt.seg("parse", time.perf_counter() - t0)
            fe.debug_sleep(self.headers, rt)
            if isinstance(doc, list):
                if len(doc) > fe.max_bulk:
                    return 413, {
                        "error": f"bulk request of {len(doc)} records "
                                 f"exceeds max_bulk={fe.max_bulk}; "
                                 f"split into smaller requests"}
                return 200, fe.submit_many(doc, trace=rt)
            elif isinstance(doc, dict):
                return 200, fe.submit(doc, trace=rt)
            else:
                return 400, {"error": "body must be a JSON record "
                                      "object or a list of records"}
        except json.JSONDecodeError as e:
            if rt is not None:
                # handler-thread-owned record (reqtrace contract)
                rt.error_type = "JSONDecodeError"
            return 400, {"error": f"invalid JSON: {e}"}
        except CLIENT_ERRORS as e:
            if rt is not None:
                rt.error_type = type(e).__name__
            return 400, {"error": str(e),
                         "error_type": type(e).__name__}
        except Overloaded as e:
            if rt is not None:
                rt.shed = True
            return 503, {"error": str(e), "error_type": "Overloaded"}
        except TimeoutError as e:
            if rt is not None:
                rt.error_type = "TimeoutError"
            return 504, {"error": str(e)}
        except Exception as e:  # pragma: no cover - systemic faults
            _log.exception("serve: request failed")
            if rt is not None:
                rt.error_type = type(e).__name__
            return 500, {"error": f"{type(e).__name__}: {e}"}


def make_http_server(frontend: ServeFrontend, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """ThreadingHTTPServer bound to (host, port); port 0 picks an
    ephemeral port (server.server_address[1] has the real one)."""
    httpd = ThreadingHTTPServer((host, port), _Handler)
    httpd.daemon_threads = True
    httpd.frontend = frontend  # type: ignore[attr-defined]
    return httpd


# -- the `serve` CLI body -----------------------------------------------------

def run_serve(args: Any) -> int:
    """Body of ``python -m transmogrifai_tpu_torch serve`` (cli.py parses).

    The model loads onto ``--device`` (None: CUDA) and the batch route
    scores there. --prewarm-only: prewarm every bucket, write the serve.json
    manifest beside the model, print one summary JSON line and exit.
    """
    if not logging.getLogger().handlers:
        logging.basicConfig(
            level=logging.INFO,
            format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ..workflow.io import load_monitor_profile
    from ..workflow.workflow import WorkflowModel

    device = getattr(args, "device", None)
    # drift monitoring: the JAX package turns it on (`auto`) when the
    # model carries a monitor.json; the port has no monitor
    mon_mode = getattr(args, "monitor", "auto")
    if mon_mode == "on":
        _log.error("serve: --monitor on, but drift monitoring is not "
                   "ported to transmogrifai_tpu_torch (%s); serve with "
                   "--monitor auto or off", UNPORTED_MONITOR)
        return 2
    if mon_mode == "auto" and load_monitor_profile(args.model_dir) \
            is not None:
        _log.info("serve: %s carries a monitor.json, but drift monitoring "
                  "is not ported (%s): serving unmonitored",
                  args.model_dir, UNPORTED_MONITOR)

    model = WorkflowModel.load(args.model_dir, device=device)
    metrics_loc = getattr(args, "metrics_location", None)
    if metrics_loc:
        os.makedirs(metrics_loc, exist_ok=True)
        collector.enable("serve", device=device)
        collector.attach_event_log(os.path.join(metrics_loc,
                                                "events.jsonl"))

    def _save_artifacts() -> None:
        if not metrics_loc:
            return
        collector.save(os.path.join(metrics_loc,
                                    "serve_stage_metrics.json"))
        collector.save_chrome_trace(os.path.join(metrics_loc,
                                                 "serve_trace.json"))
        collector.detach_event_log()
        collector.disable()

    buckets = None
    if getattr(args, "buckets", None):
        buckets = [int(b) for b in str(args.buckets).split(",") if b]
    example = None
    if getattr(args, "example", None):
        with open(args.example) as f:
            example = json.load(f)

    engine = ServingEngine(
        model, max_batch=args.max_batch, buckets=buckets, example=example,
        single_record=getattr(args, "single_record", "bucket"))
    if engine.manifest_mismatch and getattr(args, "strict_manifest",
                                            False):
        # a stale serve.json under --strict-manifest is a refusal to
        # start, not a warning
        _log.error("serve: --strict-manifest and the serve.json "
                   "manifest is stale: %s",
                   "; ".join(engine.manifest_mismatch))
        _save_artifacts()
        return 2
    summary = engine.prewarm()

    if getattr(args, "prewarm_only", False):
        manifest = engine.write_manifest()
        summary["manifest"] = manifest
        _save_artifacts()
        print(json.dumps({"prewarm": summary}, default=str))
        return 0

    batcher = MicroBatcher(engine, max_wait_ms=args.max_wait_ms,
                           max_queue=args.max_queue)
    # --replica-id is the identity echoed in the X-Tmog-Trace reply header
    # and stamped on every kept trace
    replica_id = getattr(args, "replica_id", None) or f"pid{os.getpid()}"
    rt_enabled = (getattr(args, "request_trace", "on") != "off"
                  and reqtrace.env_enabled())
    tracer = ReqTracer(replica_id, enabled=rt_enabled,
                       sample_rate=getattr(args, "trace_sample", None))
    frontend = ServeFrontend(engine, batcher, tracer=tracer)
    gauge_sampler = GaugeSampler(frontend.sample_gauges,
                                 ring=frontend.gauges).start()
    httpd = make_http_server(frontend, host=args.host, port=args.port)
    host, port = httpd.server_address[:2]
    _log.info("serving %s on http://%s:%s (device %s, buckets %s, "
              "max_wait %.1fms, queue %d, replica %s, request tracing %s)",
              args.model_dir, host, port, engine.device,
              list(engine.buckets), args.max_wait_ms, args.max_queue,
              replica_id, "on" if rt_enabled else "OFF")

    def _graceful(signum: int, frame: Any) -> None:
        _log.info("signal %s: draining and shutting down", signum)
        # shutdown() blocks until serve_forever returns: it must not run
        # on the signal-interrupted main thread itself
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    def _drain_signal(signum: int, frame: Any) -> None:
        frontend.drain()  # /healthz -> 503; serving continues

    try:
        signal.signal(signal.SIGTERM, _graceful)
        signal.signal(signal.SIGINT, _graceful)
        if hasattr(signal, "SIGUSR1"):
            # the signal twin of GET /drain
            signal.signal(signal.SIGUSR1, _drain_signal)
    except ValueError:  # not on the main thread (tests drive in process)
        pass

    try:
        httpd.serve_forever(poll_interval=0.1)
    finally:
        httpd.server_close()
        gauge_sampler.stop()
        batcher.shutdown(drain=True)
        _save_artifacts()
        _log.info("serve: drained; %d request(s), %d batch(es), "
                  "%d shed, %d post-warmup compile(s)",
                  engine.n_requests, engine.n_batches, engine.n_shed,
                  engine.post_warmup_compiles)
    return 0
