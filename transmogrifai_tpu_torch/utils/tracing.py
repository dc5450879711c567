"""Hierarchical run tracing: span tree, device-memory peaks, exports
(counterpart of utils/tracing.py).

A traced run is a process-local span TREE (run -> workflow -> layer ->
stage -> kernel / sweep) with the device memory of each span attributed
to it: the caching allocator's bytes in use at the span's close and the
peak inside the span (`DevicePeaks`; CUDA only, nothing on the CPU).

Three consumers, one tree:

- Chrome `trace_event` JSON (`chrome_trace` / `write_chrome_trace`),
  loadable in Perfetto or chrome://tracing;
- the AppMetrics JSON (`utils/metrics.MetricsCollector.save` appends the
  span list under a "spans" key);
- a streaming JSONL event log (`EventLog`) of timestamped run events, so
  a long sweep can be followed by tailing one file.

`trace_report(dir)` renders the spans by self time, the cold starts per
program, the kernel roofline table and the device memory peak;
`trace_report(dir, check=True)` is the schema validator, and fails a run
whose event log holds a `serve_recompile` or `drift_alert` event.
`requests_report(dir)` renders the kept request traces of a served run
(serve/reqtrace.py). `tracker` counts what the port pays on first use
where the JAX package counts XLA compiles (`RecompileTracker`).

The module imports torch only inside `device_memory_attrs` and
`DevicePeaks`, and touches CUDA only when it is already initialised, so
tracing a host-only run never creates a CUDA context.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Span", "TraceTree", "DevicePeaks", "RecompileTracker", "tracker",
    "EventLog", "device_memory_attrs", "chrome_trace", "write_chrome_trace",
    "trace_report", "trace_report_rc", "event_log_paths", "iter_events",
    "follow_events", "load_request_traces", "requests_report",
    "requests_report_rc", "fmt_table",
]


@dataclass
class Span:
    """One node of the run's span tree.

    t_start/t_end are seconds on the owning TraceTree's monotonic clock
    (perf_counter anchored at tree construction)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    kind: str               # run|workflow|layer|stage|sweep_fit|sweep|
    #                         tree_fit|kernel
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, Any] = field(default_factory=dict)
    error: bool = False
    error_type: Optional[str] = None

    @property
    def duration(self) -> float:
        end = self.t_end if self.t_end is not None else self.t_start
        return max(end - self.t_start, 0.0)

    def to_json(self) -> Dict[str, Any]:
        out = {"span_id": self.span_id, "parent_id": self.parent_id,
               "name": self.name, "kind": self.kind,
               "t_start": round(self.t_start, 6),
               "t_end": round(self.t_end, 6)
               if self.t_end is not None else None,
               "duration_seconds": round(self.duration, 6),
               "error": self.error}
        if self.error_type:
            out["error_type"] = self.error_type
        if self.attrs:
            out["attrs"] = _jsonable(self.attrs)
        return out


def _jsonable_value(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool, type(None))):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable_value(x) for x in v]
    return str(v)


def _jsonable(d: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _jsonable_value(v) for k, v in d.items()
            if not k.startswith("_")}


# -- device memory -----------------------------------------------------------

def _cuda_device(device: Any):
    """The CUDA device whose memory a span reports, or None: a CPU device,
    or CUDA absent or not yet initialised (tracing never creates a
    context)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() \
            or not torch.cuda.is_initialized():
        return None
    dev = torch.device("cuda" if device is None else device)
    return dev if dev.type == "cuda" else None


def device_memory_attrs(device: Any = None) -> Dict[str, Any]:
    """The caching allocator's bytes in use and its peak since the last
    reset on `device` (None: the current CUDA device), or {} on the CPU
    and wherever CUDA is not initialised."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    import torch
    return {"hbm_bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "hbm_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


class DevicePeaks:
    """Peak device memory of every span of a tree, nested spans included.

    The allocator keeps one peak counter. At a span's open the peak so far
    is folded into the enclosing span and the counter is reset; at its
    close the span's peak is the larger of the counter and its children's
    peaks, and is folded into its parent. Each span's `hbm_peak_bytes` is
    then the peak inside its own window. A caller reading
    `torch.cuda.max_memory_allocated()` across a traced block reads the
    root span's peak instead."""

    def __init__(self, device: Any = None) -> None:
        self.device = device

    def on_open(self, parent: Optional[Span]) -> None:
        dev = _cuda_device(self.device)
        if dev is None:
            return
        import torch
        if parent is not None:
            parent.attrs["_peak"] = max(
                parent.attrs.get("_peak", 0),
                int(torch.cuda.max_memory_allocated(dev)))
        torch.cuda.reset_peak_memory_stats(dev)

    def on_close(self, sp: Span, parent: Optional[Span]) -> None:
        mem = device_memory_attrs(self.device)
        if not mem:
            return
        peak = max(mem["hbm_peak_bytes"], sp.attrs.pop("_peak", 0))
        mem["hbm_peak_bytes"] = peak
        sp.attrs.update(mem)
        if parent is not None:
            parent.attrs["_peak"] = max(parent.attrs.get("_peak", 0), peak)


class TraceTree:
    """Span registry + open-span stack for one traced run (one enable()).
    `device` is the device whose memory the spans report (None: the
    current CUDA device when CUDA is initialised)."""

    def __init__(self, device: Any = None) -> None:
        self._clock0 = time.perf_counter()
        self._wall0 = time.time()
        self.spans: List[Span] = []
        self._stack: List[Span] = []
        self._next_id = 1
        self._lock = threading.RLock()
        # parent span_id -> children (self-time walks stay O(subtree))
        self._children: Dict[int, List[Span]] = {}
        self._by_id: Dict[int, Span] = {}
        self.peaks = DevicePeaks(device)

    # -- clock -------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._clock0

    # -- structure ---------------------------------------------------------
    def current(self) -> Optional[Span]:
        with self._lock:
            return self._stack[-1] if self._stack else None

    def _add(self, sp: Span) -> None:
        self.spans.append(sp)
        self._by_id[sp.span_id] = sp
        if sp.parent_id is not None:
            self._children.setdefault(sp.parent_id, []).append(sp)

    def open(self, name: str, kind: str, **attrs: Any) -> Span:
        with self._lock:
            parent = self._stack[-1] if self._stack else None
            self.peaks.on_open(parent)
            sp = Span(span_id=self._next_id,
                      parent_id=parent.span_id if parent else None,
                      name=name, kind=kind, t_start=self.now(),
                      attrs=dict(attrs))
            self._next_id += 1
            self._add(sp)
            self._stack.append(sp)
        return sp

    def children_of(self, span_id: int) -> List[Span]:
        with self._lock:
            return list(self._children.get(span_id, ()))

    def close(self, sp: Span, error_type: Optional[str] = None) -> None:
        with self._lock:
            # a double close (close_all() from save() racing a still-open
            # context manager's exit) keeps the first end: rewriting it
            # would stretch the span past its already-closed parent
            already_closed = sp.t_end is not None
            if not already_closed:
                sp.t_end = self.now()
            if error_type:
                sp.error = True
                sp.error_type = error_type
            # pop up to and including sp: children left open by an
            # exception unwinding through several context managers close
            # with it. A close of a span no longer on the stack must not
            # drain it.
            if any(top is sp for top in self._stack):
                while self._stack:
                    top = self._stack.pop()
                    if top is sp:
                        break
                    if top.t_end is None:
                        top.t_end = sp.t_end
            if already_closed:
                return
            parent = self._by_id.get(sp.parent_id) \
                if sp.parent_id is not None else None
            self.peaks.on_close(sp, parent)

    def add_complete(self, name: str, kind: str, duration: float,
                     parent_span: Optional[Span] = None,
                     **attrs: Any) -> Span:
        """Record an already-measured child span (a kernel wall timed by
        its own synchronised window): t_end = now, t_start = now -
        duration, parented to the innermost open span or `parent_span`."""
        with self._lock:
            if parent_span is not None:
                parent = parent_span.span_id
            else:
                parent = self._stack[-1].span_id if self._stack else None
            end = self.now()
            sp = Span(span_id=self._next_id, parent_id=parent, name=name,
                      kind=kind, t_start=max(end - max(duration, 0.0), 0.0),
                      t_end=end, attrs=dict(attrs))
            self._next_id += 1
            self._add(sp)
        return sp

    def add_window(self, name: str, kind: str, t_start: float,
                   t_end: float, parent_span: Optional[Span] = None,
                   **attrs: Any) -> Span:
        """Record an already-measured span at an explicit window on the
        tree clock (both ends values of :meth:`now`)."""
        with self._lock:
            parent = (parent_span.span_id if parent_span is not None
                      else (self._stack[-1].span_id if self._stack
                            else None))
            t0 = max(float(t_start), 0.0)
            t1 = max(float(t_end), t0)
            sp = Span(span_id=self._next_id, parent_id=parent, name=name,
                      kind=kind, t_start=t0, t_end=t1, attrs=dict(attrs))
            self._next_id += 1
            self._add(sp)
        return sp

    def close_all(self) -> None:
        while True:
            with self._lock:
                if not self._stack:
                    return
                sp = self._stack[-1]
            self.close(sp)

    # -- derived -----------------------------------------------------------
    def self_seconds(self, sp: Span) -> float:
        child = sum(s.duration for s in self.children_of(sp.span_id))
        return max(sp.duration - child, 0.0)

    def to_json(self) -> List[Dict[str, Any]]:
        return [s.to_json() for s in self.spans]


# -- cold-start attribution --------------------------------------------------

class RecompileTracker:
    """Counts the port's cold starts and books each to the innermost open
    span (counterpart of the JAX package's RecompileTracker, which counts
    XLA compiles).

    An eager PyTorch program compiles nothing per batch shape. What a first
    call pays on the port's request path, and what this tracker counts as
    a compile, is:

    - an nvcc build of the kernel library (`ops/_build._compile`,
      `note_build`);
    - a new memory segment that the CUDA caching allocator reserves on a
      serving device: `sample_allocator(device)` books the growth of
      ``torch.cuda.memory_stats(device)["segment.all.allocated"]`` since
      its last read of that device (a cudaMalloc on the request path is
      the eager form of a cold start; the first read of a device after
      `activate` only sets the baseline).

    A load of an already-built library from `ops/_build.BUILD_DIR` counts
    as a cache hit (`note_cache_hit`). `total_compiles` counts all three,
    `true_compiles` leaves the cache hits out: the JAX package's field
    names, so the serving engine's `post_warmup_compiles`, its
    `serve_recompile` event and `trace-report --check` read alike in both
    packages. Counting runs while a collected run is open
    (`utils.metrics.collector.enable` activates the tracker)."""

    def __init__(self) -> None:
        self._tree: Optional[TraceTree] = None
        self.total_compiles = 0
        self.total_compile_seconds = 0.0
        self.total_cache_hits = 0
        self.by_program: Dict[str, int] = {}
        # device -> the allocator's cumulative segment count at the last read
        self._segments: Dict[str, int] = {}
        # the counters are bumped from the serving dispatcher, HTTP worker
        # threads (bulk requests) and the build; /metrics reads them from
        # another. Ordering: _lock may be held while taking the tree's lock
        self._lock = threading.RLock()

    @property
    def true_compiles(self) -> int:
        """Builds and new allocator segments (cache hits excluded): the
        serving engine's zero-cold-start contract counts these."""
        with self._lock:
            return max(self.total_compiles - self.total_cache_hits, 0)

    def activate(self, tree: TraceTree) -> None:
        with self._lock:
            self._tree = tree
            self.total_compiles = 0
            self.total_compile_seconds = 0.0
            self.total_cache_hits = 0
            self.by_program = {}
            self._segments = {}

    def deactivate(self) -> None:
        with self._lock:
            self._tree = None

    def _book(self, program: str, n: int = 1, seconds: float = 0.0,
              hit: bool = False) -> None:
        with self._lock:
            tree = self._tree
            if tree is None or n <= 0:
                return
            self.total_compiles += n
            self.total_compile_seconds += float(seconds)
            if hit:
                self.total_cache_hits += n
            self.by_program[program] = self.by_program.get(program, 0) + n
            with tree._lock:
                sp = tree.current()
                if sp is None:
                    return
                sp.attrs["compiles"] = int(sp.attrs.get("compiles", 0)) + n
                sp.attrs["compile_seconds"] = round(
                    float(sp.attrs.get("compile_seconds", 0.0))
                    + float(seconds), 4)
                if hit:
                    sp.attrs["cache_hits"] = \
                        int(sp.attrs.get("cache_hits", 0)) + n

    def note_build(self, program: str, seconds: float) -> None:
        """One nvcc build of `program` that took `seconds`."""
        self._book(program, 1, seconds)

    def note_cache_hit(self, program: str) -> None:
        """One load of an already-built `program`."""
        self._book(program, 1, hit=True)

    def sample_allocator(self, device: Any = None) -> int:
        """Book the segments the caching allocator reserved on `device`
        (None: the current CUDA device) since the last read; returns how
        many. 0 on the CPU, where CUDA is not initialised, and while no
        run is collected."""
        dev = _cuda_device(device)
        if dev is None:
            return 0
        import torch
        n = int(torch.cuda.memory_stats(dev).get("segment.all.allocated", 0))
        key = str(dev if dev.index is not None
                  else torch.device("cuda", torch.cuda.current_device()))
        with self._lock:
            if self._tree is None:
                return 0
            last = self._segments.get(key)
            self._segments[key] = n
        new = 0 if last is None else n - last
        if new > 0:
            self._book("allocator_segment", new)
        return max(new, 0)


#: process-wide tracker the collector activates per enable()
tracker = RecompileTracker()


# -- streaming event log -----------------------------------------------------

#: default events.jsonl rotation threshold: an offline run never gets near
#: it, a long-running process that emits events forever stays bounded
DEFAULT_EVENTLOG_MAX_MB = 256.0


def _eventlog_max_bytes(max_mb: Optional[float]) -> int:
    """Resolved rotation threshold in bytes; 0 disables rotation."""
    if max_mb is None:
        raw = os.environ.get("TMOG_EVENTLOG_MAX_MB", "").strip().lower()
        if raw in ("", "auto"):
            max_mb = DEFAULT_EVENTLOG_MAX_MB
        elif raw in ("0", "off", "false", "no"):
            max_mb = 0.0
        else:
            try:
                max_mb = float(raw)
            except ValueError:
                max_mb = DEFAULT_EVENTLOG_MAX_MB
    return int(max(float(max_mb), 0.0) * 1e6)


class EventLog:
    """Append-only JSONL of timestamped run events.

    Each line: {"seq": N, "t": monotonic_seconds, "ts": wall_epoch,
    "event": type, ...fields}. `t` is non-decreasing and `seq` strictly
    increasing — the contract `trace_report --check` validates. Lines are
    flushed per event so `tail -f events.jsonl` follows a live run.

    Rotation: once the live file passes `max_mb` (``TMOG_EVENTLOG_MAX_MB``,
    default 256; 0/off disables) it shifts to ``events.jsonl.1`` (older
    segments to ``.2`` ... up to `keep`, the oldest dropped) and a fresh
    live file opens. `seq` and the clock continue across the boundary:
    the segments read oldest-first (:func:`event_log_paths`) are one
    monotone stream."""

    def __init__(self, path: str, max_mb: Optional[float] = None,
                 keep: Optional[int] = None) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._lock = threading.Lock()
        self._seq = 0
        self._mono0 = time.perf_counter()
        self._max_bytes = _eventlog_max_bytes(max_mb)
        if keep is None:
            try:
                keep = int(os.environ.get("TMOG_EVENTLOG_KEEP", "3"))
            except ValueError:
                keep = 3
        self.keep = max(int(keep), 1)
        self.rotations = 0

    def emit(self, event: str, **fields: Any) -> None:
        with self._lock:
            rec = {"seq": self._seq, "t": round(
                time.perf_counter() - self._mono0, 6),
                "ts": round(time.time(), 6), "event": event}
            rec.update(_jsonable(fields))
            self._seq += 1
            # the lock serialises the line write + flush: seq/t
            # monotonicity across threads is the file's contract
            try:
                self._f.write(json.dumps(rec, default=str) + "\n")
                self._f.flush()
                if self._max_bytes and self._f.tell() >= self._max_bytes:
                    self._rotate()
            except (ValueError, OSError):
                # closed file / full disk: the liveness side channel must
                # never kill the run it is monitoring
                pass

    def _rotate(self) -> None:
        """Shift the full live file to .1 (.1 -> .2 ... oldest dropped)
        and reopen. Caller holds the lock; `seq` and the clock survive."""
        try:
            self._f.close()
        except OSError:
            pass
        try:
            oldest = f"{self.path}.{self.keep}"
            if os.path.exists(oldest):
                os.remove(oldest)
            for i in range(self.keep - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError:
            pass  # a failed shift falls through to reopening in place
        self._f = open(self.path, "a", encoding="utf-8")
        self.rotations += 1

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


def event_log_paths(path: str) -> List[str]:
    """Every segment of a (possibly rotated) event log, OLDEST first —
    ``events.jsonl.N ... events.jsonl.1 events.jsonl``."""
    numbered: List[Tuple[int, str]] = []
    for p in _glob.glob(path + ".*"):
        suffix = p[len(path) + 1:]
        if suffix.isdigit():
            numbered.append((int(suffix), p))
    out = [p for _, p in sorted(numbered, reverse=True)]
    if os.path.exists(path):
        out.append(path)
    return out


def iter_events(path: str) -> Any:
    """Every parsed event record across all rotated segments of `path`,
    oldest first. Unparseable lines are skipped (validation is
    trace_report's job)."""
    for p in event_log_paths(path):
        try:
            with open(p, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue


def follow_events(path: str, *, stop: Optional[threading.Event] = None,
                  poll_s: float = 0.1, from_start: bool = False) -> Any:
    """Tail-subscribe to a (possibly rotating) event log: yield every parsed
    event whose `seq` is greater than the last one seen, until `stop` is
    set.

    It keeps an open handle and a byte offset on the live file and reads
    only appended lines each poll. `seq` strictly increases across the
    ``events.jsonl.N`` boundaries (the EventLog's contract), so when the
    live file is replaced under the handle (a new inode, or the file
    shrank) the follower rescans every segment oldest first
    (:func:`iter_events`) and yields only records past the last seq: an
    event appended just before the shift is seen once, from the ``.1``
    segment. A segment dropped past `keep` between polls is lost. A torn
    last line (a writer mid-append) waits for its newline; records without
    an integer `seq` are skipped.

    `from_start=False` (default) begins after the current end of the log:
    a subscriber attaching to a long-running server does not replay its
    history. The log may not exist yet; the follower waits for it."""
    last = -1
    # a tail-mode attach consumes the first full scan silently (advancing
    # `last` past the history), so history is parsed once either way
    primed = from_start

    f = None
    ino = None

    def _close():
        nonlocal f, ino
        if f is not None:
            try:
                f.close()
            except OSError:
                pass
        f, ino = None, None

    def _parse(line: str):
        nonlocal last
        line = line.strip()
        if not line:
            return None
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            return None
        s = rec.get("seq") if isinstance(rec, dict) else None
        if not isinstance(s, int) or s <= last:
            return None
        last = s
        return rec

    try:
        while stop is None or not stop.is_set():
            rotated = False
            try:
                st = os.stat(path)
            except OSError:
                _close()
                st = None
                if not primed:
                    # no live file at attach time: skip the rotated history
                    # that already exists; whatever lands later is new
                    for rec in iter_events(path):
                        s = rec.get("seq")
                        if isinstance(s, int) and s > last:
                            last = s
                    primed = True
            if st is not None:
                if f is None or st.st_ino != ino \
                        or st.st_size < f.tell():
                    # a fresh file under the path: the first attach, a
                    # rotation, or a truncate in place. Catch up through
                    # every segment by seq (on a first attach with
                    # from_start=False this only advances `last`)
                    rotated = True
                    _close()
                    for rec in iter_events(path):
                        s = rec.get("seq")
                        if isinstance(s, int) and s > last:
                            last = s
                            if primed:
                                yield rec
                    primed = True
                    try:
                        # read the live file from byte 0: lines the rescan
                        # yielded drop by seq, and a line appended between
                        # the rescan and this open is not missed
                        f = open(path, encoding="utf-8")
                        ino = st.st_ino
                    except OSError:
                        _close()
                if f is not None and not rotated:
                    while True:
                        pos = f.tell()
                        line = f.readline()
                        if not line:
                            break
                        if not line.endswith("\n"):
                            # torn tail: re-read once the line completes
                            f.seek(pos)
                            break
                        rec = _parse(line)
                        if rec is not None:
                            yield rec
            if stop is None:
                time.sleep(poll_s)
            elif stop.wait(poll_s):
                return
    finally:
        _close()


# -- Chrome trace_event export -----------------------------------------------

def chrome_trace(tree: TraceTree, app_name: str = "transmogrifai_tpu_torch"
                 ) -> Dict[str, Any]:
    """Chrome trace_event JSON: one complete ("ph": "X") event per span,
    microsecond timestamps on the tree's clock, span/parent ids and attrs
    in `args` so the hierarchy survives the viewer."""
    pid = os.getpid()
    events: List[Dict[str, Any]] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": app_name}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": 1,
         "args": {"name": "run"}},
    ]
    # spans carrying a `lane` attr render on their own row
    lanes: Dict[str, int] = {}
    for sp in tree.spans:
        lane = sp.attrs.get("lane")
        if isinstance(lane, str) and lane not in lanes:
            lanes[lane] = 2 + len(lanes)
    for lane, tid in lanes.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid,
                       "tid": tid, "args": {"name": lane}})
    end_default = tree.now()
    for sp in tree.spans:
        end = sp.t_end if sp.t_end is not None else end_default
        args = {"span_id": sp.span_id, "parent_id": sp.parent_id,
                "error": sp.error}
        if sp.error_type:
            args["error_type"] = sp.error_type
        args.update(_jsonable(sp.attrs))
        events.append({
            "ph": "X", "name": sp.name, "cat": sp.kind,
            "ts": round(sp.t_start * 1e6, 3),
            "dur": round(max(end - sp.t_start, 0.0) * 1e6, 3),
            "pid": pid, "tid": lanes.get(sp.attrs.get("lane"), 1),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"app_name": app_name,
                          "trace_wall_start": tree._wall0}}


def write_chrome_trace(path: str, tree: TraceTree,
                       app_name: str = "transmogrifai_tpu_torch") -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(chrome_trace(tree, app_name), f, indent=1)


# -- trace-report ------------------------------------------------------------

def _load_trace_spans(path: str) -> Tuple[List[Dict[str, Any]], List[str]]:
    """(span dicts from a chrome trace file, schema problems)."""
    problems: List[str] = []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [], [f"{path}: unreadable trace ({e})"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return [], [f"{path}: no traceEvents list"]
    spans = []
    ids = set()
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph is None:
            problems.append(f"{path}: event {i} missing 'ph'")
            continue
        if ph != "X":
            continue
        missing = [k for k in ("ts", "dur", "pid", "tid") if k not in ev]
        if missing:
            problems.append(f"{path}: X event {i} ({ev.get('name')}) "
                            f"missing {missing}")
            continue
        bad_num = [k for k in ("ts", "dur")
                   if not isinstance(ev[k], (int, float))
                   or isinstance(ev[k], bool) or ev[k] < 0]
        if bad_num:
            # flag AND drop: the containment arithmetic below must never
            # crash on the malformed input this validator exists to catch
            problems.append(f"{path}: X event {i} ({ev.get('name')}) "
                            f"non-numeric {bad_num}")
            continue
        args = ev.get("args", {})
        sid = args.get("span_id")
        if sid is not None:
            if sid in ids:
                problems.append(f"{path}: duplicate span_id {sid}")
            ids.add(sid)
        spans.append(ev)
    # parent integrity: every parent_id must be a recorded span_id
    for ev in spans:
        pid_ = ev.get("args", {}).get("parent_id")
        if pid_ is not None and pid_ not in ids:
            problems.append(f"{path}: span {ev.get('name')} has unknown "
                            f"parent_id {pid_}")
    # containment: a child's [ts, ts+dur] inside its parent's window (1 ms
    # slack for rounding)
    by_id = {ev["args"].get("span_id"): ev for ev in spans
             if ev.get("args", {}).get("span_id") is not None}
    slack_us = 1000.0
    for ev in spans:
        pid_ = ev.get("args", {}).get("parent_id")
        parent = by_id.get(pid_)
        if parent is None:
            continue
        if ev["ts"] + slack_us < parent["ts"] or \
                ev["ts"] + ev["dur"] > parent["ts"] + parent["dur"] \
                + slack_us:
            problems.append(
                f"{path}: span {ev.get('name')} escapes parent "
                f"{parent.get('name')} window")
    return spans, problems


def _check_event_log(paths: List[str]
                     ) -> Tuple[int, List[str], Dict[str, int]]:
    """(n valid events, schema problems, counts per event type) in one
    pass over the rotated segment chain, OLDEST first: `seq`/`t`
    monotonicity is validated across the rotation boundaries."""
    problems: List[str] = []
    counts: Dict[str, int] = {}
    n = 0
    last_t = None
    last_seq = None
    for path in paths:
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    problems.append(f"{path}:{lineno}: invalid JSON")
                    continue
                n += 1
                ev_name = rec.get("event", "?")
                counts[ev_name] = counts.get(ev_name, 0) + 1
                if "event" not in rec:
                    problems.append(f"{path}:{lineno}: missing 'event'")
                t = rec.get("t")
                if not isinstance(t, (int, float)):
                    problems.append(f"{path}:{lineno}: missing numeric "
                                    f"'t'")
                else:
                    # a re-attached log (a resumed run) restarts the
                    # clock: monotonicity holds per seq=0 segment
                    seq = rec.get("seq")
                    if last_t is not None and seq != 0 and t < last_t:
                        problems.append(f"{path}:{lineno}: timestamp "
                                        f"went backwards ({t} < "
                                        f"{last_t})")
                    last_t = t
                seq = rec.get("seq")
                if isinstance(seq, int) and isinstance(last_seq, int) \
                        and seq != 0 and seq <= last_seq:
                    problems.append(f"{path}:{lineno}: seq not "
                                    f"increasing")
                last_seq = seq if isinstance(seq, int) else last_seq
    return n, problems, counts


def fmt_table(rows: List[List[str]], header: List[str]) -> List[str]:
    """Left-justified fixed-width text table."""
    if not rows:
        return ["(empty)"]
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    out = ["  ".join(str(h).ljust(w) for h, w in zip(header, widths))]
    for r in rows:
        out.append("  ".join(str(c).ljust(w) for c, w in zip(r, widths)))
    return out


def trace_report_rc(run_dir: str, check: bool = False,
                    top: int = 15) -> Tuple[str, int]:
    """(report text, exit code): 0 = clean, 1 = validation problems
    found, 2 = `run_dir` holds nothing to read."""
    text, ok = trace_report(run_dir, check=check, top=top)
    if text.startswith("trace-report: nothing to read"):
        return text, 2
    return text, 0 if ok else 1


def trace_report(run_dir: str, check: bool = False,
                 top: int = 15) -> Tuple[str, bool]:
    """(report text, ok) for a traced run directory.

    Reads every `*trace.json` (chrome traces), `events.jsonl` and
    `*stage_metrics.json` under `run_dir`. With check=True the text is a
    validation verdict (schema problems listed) and ok=False on any."""
    trace_files = sorted(_glob.glob(os.path.join(run_dir, "*trace.json")))
    event_log = os.path.join(run_dir, "events.jsonl")
    log_paths = event_log_paths(event_log)
    metric_files = sorted(
        _glob.glob(os.path.join(run_dir, "*stage_metrics.json")))
    lines: List[str] = []
    problems: List[str] = []

    if not trace_files and not metric_files and not log_paths:
        return (f"trace-report: nothing to read in {run_dir} (no "
                f"*trace.json, *stage_metrics.json or events.jsonl)", False)

    # span ids restart at 1 in every trace file: key by (file, id)
    all_spans: List[Tuple[int, Dict[str, Any]]] = []
    for fidx, tf in enumerate(trace_files):
        spans, probs = _load_trace_spans(tf)
        all_spans.extend((fidx, ev) for ev in spans)
        problems.extend(probs)

    n_events = 0
    event_counts: Dict[str, int] = {}
    if log_paths:
        n_events, probs, event_counts = _check_event_log(log_paths)
        problems.extend(probs)
        # serving contract: the engine emits one serve_recompile event for
        # every cold start (a build, a new allocator segment) that lands
        # after its warmup; under the prewarmed bucket ladder there must
        # be none, so such an event fails --check like a schema problem
        n_rc = event_counts.get("serve_recompile", 0)
        if n_rc:
            problems.append(
                f"{event_log}: {n_rc} serve_recompile event(s) — "
                f"cold start(s) landed after serving warmup")
        # a drift_alert (the JAX package's serve-side monitor) fails too
        n_da = event_counts.get("drift_alert", 0)
        if n_da:
            problems.append(
                f"{event_log}: {n_da} drift_alert event(s) — serve-time "
                f"feature/prediction drift exceeded policy thresholds")

    for mf in metric_files:
        try:
            with open(mf) as f:
                doc = json.load(f)
            for key in ("app_name", "duration_seconds",
                        "total_stage_seconds", "stage_metrics"):
                if key not in doc:
                    problems.append(f"{mf}: missing AppMetrics key "
                                    f"'{key}'")
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"{mf}: unreadable ({e})")

    if check:
        lines.append(f"trace-report --check: {len(trace_files)} trace "
                     f"file(s), {n_events} event(s), "
                     f"{len(metric_files)} metrics file(s)")
        if problems:
            lines.append(f"{len(problems)} problem(s):")
            lines.extend(f"  {p}" for p in problems)
        else:
            lines.append("OK")
        return "\n".join(lines), not problems

    # -- report mode -------------------------------------------------------
    lines.append(f"# trace-report {run_dir}")
    if all_spans:
        # self time = dur - sum(direct children dur)
        child_dur: Dict[Any, float] = {}
        for fidx, ev in all_spans:
            pid_ = ev.get("args", {}).get("parent_id")
            if pid_ is not None:
                key = (fidx, pid_)
                child_dur[key] = child_dur.get(key, 0.0) + ev["dur"]
        rows = []
        for fidx, ev in all_spans:
            sid = (fidx, ev.get("args", {}).get("span_id"))
            self_us = max(ev["dur"] - child_dur.get(sid, 0.0), 0.0)
            rows.append((self_us, ev))
        rows.sort(key=lambda r: -r[0])
        table = [[ev.get("name", "?")[:48], ev.get("cat", ""),
                  f"{ev['dur'] / 1e6:.4f}", f"{self_us / 1e6:.4f}",
                  _gb(ev.get("args", {}).get("hbm_peak_bytes")),
                  "ERR" if ev.get("args", {}).get("error") else ""]
                 for self_us, ev in rows[:top]]
        lines.append(f"\n## Top spans by self-time "
                     f"({len(all_spans)} spans)")
        lines.extend(fmt_table(
            table, ["span", "kind", "total_s", "self_s", "peak_gb",
                    "err"]))

        # cold starts (builds, allocator segments) per program (span name)
        comp: Dict[str, Tuple[int, float]] = {}
        for _, ev in all_spans:
            args = ev.get("args", {})
            c = args.get("compiles")
            if c:
                n, sec = comp.get(ev.get("name", "?"), (0, 0.0))
                comp[ev.get("name", "?")] = (
                    n + int(c),
                    sec + float(args.get("compile_seconds", 0.0)))
        lines.append("\n## Recompiles per program")
        if comp:
            lines.extend(fmt_table(
                [[name[:48], str(n), f"{sec:.2f}"]
                 for name, (n, sec) in
                 sorted(comp.items(), key=lambda kv: -kv[1][0])],
                ["program", "compiles", "compile_s"]))
        else:
            lines.append("(none recorded)")

        # roofline table from kernel spans
        kern = [ev for _, ev in all_spans if ev.get("cat") == "kernel"]
        if kern:
            lines.append("\n## Kernel roofline")
            lines.extend(fmt_table(
                [[ev.get("name", "?")[:40],
                  f"{ev['dur'] / 1e6:.4f}",
                  str(ev.get("args", {}).get("bytes_hbm", "")),
                  str(ev.get("args", {}).get("achieved_gbps", "")),
                  str(ev.get("args", {}).get("pct_of_roof", "")),
                  str(ev.get("args", {}).get("cold", ""))]
                 for ev in kern],
                ["kernel", "wall_s", "bytes_hbm", "gbps", "pct_roof",
                 "cold"]))

        peaks = [ev.get("args", {}).get("hbm_peak_bytes")
                 for _, ev in all_spans
                 if ev.get("args", {}).get("hbm_peak_bytes") is not None]
        if peaks:
            lines.append(f"\nDevice memory peak across spans: "
                         f"{max(peaks) / 1e9:.3f} GB")

    if n_events:
        lines.append(f"\n## Event log ({n_events} events)")
        lines.extend(fmt_table(
            [[k, str(v)] for k, v in
             sorted(event_counts.items(), key=lambda kv: -kv[1])],
            ["event", "count"]))

    if problems:
        lines.append(f"\n## {len(problems)} schema problem(s)")
        lines.extend(f"  {p}" for p in problems)
    return "\n".join(lines), not problems


def _gb(n: Any) -> str:
    return f"{n / 1e9:.3f}" if isinstance(n, (int, float)) else ""


# -- trace-report --requests -------------------------------------------------

#: a request is flagged when its unattributed wall (e2e minus the sum of its
#: segments) exceeds both bounds: the fraction catches slow requests hiding
#: time outside the segment chain, the floor keeps millisecond requests from
#: flagging on scheduler-wake jitter
REQUEST_COVERAGE_TOLERANCE = 0.25
REQUEST_COVERAGE_FLOOR_MS = 25.0


def load_request_traces(run_dir: str) -> List[Dict[str, Any]]:
    """Every `request_trace` event under `run_dir` (the kept traces of the
    tail sampler, serve/reqtrace.py), across rotated segments, oldest
    first."""
    path = os.path.join(run_dir, "events.jsonl")
    return [rec for rec in iter_events(path)
            if rec.get("event") == "request_trace"]


def _coverage_problems(recs: List[Dict[str, Any]],
                       tolerance: float, floor_ms: float) -> List[str]:
    problems: List[str] = []
    by_id: Dict[str, Dict[str, float]] = {}
    for rec in recs:
        tid = rec.get("trace_id")
        wall = rec.get("wall_ms")
        segs = rec.get("segments") or {}
        if not isinstance(wall, (int, float)) or isinstance(wall, bool):
            problems.append(f"request {tid}: non-numeric wall_ms")
            continue
        seg_sum = sum(float(v) for v in segs.values()
                      if isinstance(v, (int, float)))
        slack = max(tolerance * wall, floor_ms)
        label = f"{rec.get('origin', '?')} request {tid}"
        if wall - seg_sum > slack:
            problems.append(
                f"{label}: segments cover {seg_sum:.1f}ms of "
                f"{wall:.1f}ms e2e wall ({wall - seg_sum:.1f}ms "
                f"unattributed > {slack:.1f}ms tolerance)")
        elif seg_sum - wall > slack:
            problems.append(
                f"{label}: segments sum to {seg_sum:.1f}ms, OVER the "
                f"{wall:.1f}ms e2e wall by more than {slack:.1f}ms")
        if isinstance(tid, str):
            by_id.setdefault(tid, {})[rec.get("origin", "?")] = \
                float(wall)
    # across processes, durations only (two hosts' clocks never meet): a
    # replica's e2e wall for a trace must fit inside the router's wall for
    # the same trace id, plus slack for serialization and transport
    for tid, origins in by_id.items():
        rep, rout = origins.get("replica"), origins.get("router")
        if rep is None or rout is None:
            continue
        slack = max(tolerance * rout, floor_ms)
        if rep > rout + slack:
            problems.append(
                f"request {tid}: replica-side wall {rep:.1f}ms exceeds "
                f"the router-side wall {rout:.1f}ms for the same trace")
    return problems


def requests_report(run_dir: str, top: int = 15,
                    tolerance: float = REQUEST_COVERAGE_TOLERANCE,
                    floor_ms: float = REQUEST_COVERAGE_FLOOR_MS
                    ) -> Tuple[str, bool]:
    """(report text, ok) over the kept request traces of a run dir: the
    `top` slowest with their segment breakdown, the kept reasons, and the
    coverage check (ok=False when a request's segments do not cover its
    end-to-end wall within tolerance)."""
    recs = load_request_traces(run_dir)
    if not recs:
        return (f"trace-report --requests: no request_trace events in "
                f"{run_dir} (request tracing off, or no kept traces)",
                False)
    problems = _coverage_problems(recs, tolerance, floor_ms)
    lines = [f"# trace-report --requests {run_dir}",
             f"{len(recs)} kept trace(s)"]
    reasons: Dict[str, int] = {}
    for rec in recs:
        k = str(rec.get("kept", "?"))
        reasons[k] = reasons.get(k, 0) + 1
    lines.append("kept by reason: " + ", ".join(
        f"{k}={v}" for k, v in sorted(reasons.items(), key=lambda kv:
                                      -kv[1])))
    ranked = sorted(
        recs, key=lambda r: -(r.get("wall_ms")
                              if isinstance(r.get("wall_ms"),
                                            (int, float)) else 0.0))
    rows = []
    for rec in ranked[:top]:
        segs = rec.get("segments") or {}
        seg_sum = sum(float(v) for v in segs.values()
                      if isinstance(v, (int, float)))
        wall = rec.get("wall_ms")
        cover = (f"{100.0 * seg_sum / wall:.0f}%"
                 if isinstance(wall, (int, float)) and wall else "?")
        rows.append([str(rec.get("trace_id", "?"))[:16],
                     str(rec.get("origin", "?")),
                     str(rec.get("replica", ""))[:20],
                     str(rec.get("status", "")),
                     str(rec.get("kept", "")),
                     f"{wall:.2f}" if isinstance(wall, (int, float))
                     else "?",
                     cover,
                     " ".join(f"{k}={v:.2f}" for k, v in segs.items()
                              if isinstance(v, (int, float)))[:72]])
    lines.append(f"\n## Top {min(top, len(ranked))} slowest kept traces")
    lines.extend(fmt_table(rows, ["trace", "origin", "replica",
                                  "status", "kept", "wall_ms", "cover",
                                  "segments_ms"]))
    if problems:
        lines.append(f"\n## {len(problems)} coverage problem(s)")
        lines.extend(f"  {p}" for p in problems)
    else:
        lines.append("\ncoverage OK (every kept trace's segments cover "
                     "its e2e wall within tolerance)")
    return "\n".join(lines), not problems


def requests_report_rc(run_dir: str, top: int = 15) -> Tuple[str, int]:
    """(text, exit code): 0 = clean, 1 = coverage problems, 2 = nothing to
    read (no kept request traces at all)."""
    text, ok = requests_report(run_dir, top=top)
    if text.startswith("trace-report --requests: no request_trace"):
        return text, 2
    return text, 0 if ok else 1
