"""Async micro-batching admission queue for the serving engine (counterpart
of serve/batcher.py).

Requests enter a BOUNDED queue; a dispatcher thread gathers them into the
largest batch that fills within ``max_wait_ms`` (or up to ``max_batch``,
whichever first) and drives one :meth:`ServingEngine.score_batch` call —
the engine pads the gathered batch up to its bucket ladder. The tradeoff
is explicit: waiting longer fills bigger buckets (throughput), waiting
less bounds the queue-wait term of tail latency; both ends are visible in
the engine's ``serve_queue_wait`` histogram.

Backpressure is load-shedding, not unbounded buffering: a full queue
raises the typed :class:`Overloaded` (HTTP 503 at the frontend) instead
of growing the queue until every request times out. Validation runs at
submit time (``engine.validate_record`` — the typed 400 errors of
local/scoring), so a malformed record is rejected before admission and
can never poison a batch that other requests share.

Shutdown is a graceful drain by default: new submissions are refused,
everything already admitted is scored, then the dispatcher exits.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, Optional

from .reqtrace import BatchTrace, RequestTrace

Record = Dict[str, Any]


class Overloaded(RuntimeError):
    """Typed load-shed: the admission queue is full. Clients should back
    off and retry; the frontend maps this to HTTP 503."""

    def __init__(self, queue_len: int, max_queue: int):
        self.queue_len = queue_len
        self.max_queue = max_queue
        super().__init__(f"serving queue full ({queue_len}/{max_queue}); "
                         f"request shed")


class _Pending:
    __slots__ = ("record", "t_enq", "t_set", "done", "result", "error",
                 "trace")

    def __init__(self, record: Record,
                 trace: Optional[RequestTrace] = None):
        self.record = record
        self.t_enq = time.perf_counter()
        #: when the dispatcher set `done` (the "wake" segment's start)
        self.t_set = self.t_enq
        self.done = threading.Event()
        self.result: Optional[Record] = None
        self.error: Optional[BaseException] = None
        #: per-request trace record (reqtrace):
        #: the dispatcher stamps queue/batch/device segments onto it
        self.trace = trace


class MicroBatcher:
    """Bounded queue + dispatcher thread in front of a ServingEngine."""

    def __init__(self, engine: Any, *, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0, max_queue: int = 1024):
        self.engine = engine
        # clamped to the engine's top bucket: a gathered batch must map
        # onto one prewarmed rung (the engine would chunk a bigger list,
        # but pick_bucket on the whole batch is the latency contract)
        self.max_batch = min(int(max_batch or engine.max_batch),
                             int(engine.max_batch))
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_wait_s = max(float(max_wait_ms), 0.0) / 1e3
        self.max_queue = int(max_queue)
        self._q: "collections.deque[_Pending]" = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        #: dispatcher heartbeat (written under _cond each loop pass):
        #: /debugz serves its age — a wedged dispatcher shows up as a
        #: beat that stopped advancing while the queue grows
        self._beat = time.perf_counter()
        self._thread = threading.Thread(target=self._loop,
                                        name="serve-batcher", daemon=True)
        self._thread.start()

    # -- client side -------------------------------------------------------
    def submit(self, record: Record,
               timeout: Optional[float] = None,
               trace: Optional[RequestTrace] = None) -> Record:
        """Validate, enqueue, block for the scored result.

        Raises the typed validation errors (unknown/missing/invalid
        feature — reject before admission), :class:`Overloaded` on a full
        queue, TimeoutError when `timeout` expires first, RuntimeError
        after shutdown. `trace` (reqtrace) rides the pending slot; the
        dispatcher stamps queue wait + the batch's shared walls onto it."""
        t0 = time.perf_counter()
        self.engine.validate_record(record)
        if trace is not None:
            trace.seg("validate", time.perf_counter() - t0)
        p = _Pending(record, trace)
        with self._cond:
            if self._closed:
                raise RuntimeError("batcher is shut down")
            if len(self._q) >= self.max_queue:
                qlen = len(self._q)
                self.engine.note_shed(qlen)
                raise Overloaded(qlen, self.max_queue)
            self._q.append(p)
            self._cond.notify_all()
        if not p.done.wait(timeout):
            # withdraw from the queue so an abandoned request is neither
            # scored nor counted, and stops holding queue capacity
            # against live traffic; if it already left the queue it is
            # mid-dispatch — give the race one more look, then discard
            with self._cond:
                try:
                    self._q.remove(p)
                    withdrawn = True
                except ValueError:
                    withdrawn = False
                # reclaim the trace record before raising: past this
                # point the CALLER finishes it, and a mid-dispatch
                # stamp would break the reqtrace single-owner handoff.
                # The dispatcher captures p.trace ONCE per pending, so
                # after this detach at most a stamp already in progress
                # lands — attribute/list ops are CPython-atomic, the
                # record stays structurally sound and can at worst miss
                # the late batch segments of a request that timed out
                # anyway
                p.trace = None
            if withdrawn or not p.done.is_set():
                raise TimeoutError(f"no result within {timeout}s "
                                   f"(queue depth {len(self._q)})")
        tr = p.trace
        if tr is not None:
            tr.seg("wake", time.perf_counter() - p.t_set)
        if p.error is not None:
            raise p.error
        return p.result  # type: ignore[return-value]

    @property
    def queue_len(self) -> int:
        return len(self._q)

    @property
    def alive(self) -> bool:
        """Dispatcher thread liveness (the /debugz health bit)."""
        return self._thread.is_alive()

    def beat_age(self) -> float:
        """Seconds since the dispatcher last passed the top of its loop
        — near zero on a healthy batcher (it wakes at least every 100ms
        idle); a growing age with a non-empty queue means the dispatcher
        is stuck inside a batch (device hang, lock convoy)."""
        with self._cond:
            return max(time.perf_counter() - self._beat, 0.0)

    # -- dispatcher --------------------------------------------------------
    def _loop(self) -> None:
        while True:
            with self._cond:
                self._beat = time.perf_counter()
                while not self._q and not self._closed:
                    self._cond.wait(0.1)
                    if not self._q and not self._closed:
                        break  # idle beat: refresh the heartbeat
                if not self._q:
                    if self._closed:
                        return  # closed AND drained
                    batch = None  # idle: no work gathered this beat
                else:
                    batch = [self._q.popleft()]
                    deadline = time.perf_counter() + self.max_wait_s
                    while len(batch) < self.max_batch:
                        if self._q:
                            batch.append(self._q.popleft())
                            continue
                        now = time.perf_counter()
                        if self._closed or now >= deadline:
                            break
                        self._cond.wait(min(deadline - now, 0.05))
            if batch is not None:
                self._dispatch(batch)

    def _dispatch(self, batch: List[_Pending]) -> None:
        t_d = time.perf_counter()
        for p in batch:
            self.engine.observe_queue_wait(t_d - p.t_enq)
        # one BatchTrace per traced dispatch: the engine fills the
        # shared assemble/device/monitor walls, every traced rider gets
        # them stamped below (an untraced batch allocates nothing)
        bt = (BatchTrace()
              if any(p.trace is not None for p in batch) else None)
        try:
            bucket = self.engine.pick_bucket(len(batch))
            records = [p.record for p in batch]
            # keyword only when tracing: duck-typed engine stands-ins
            # (tests, adapters) keep their plain score_batch signature
            results = (self.engine.score_batch(records) if bt is None
                       else self.engine.score_batch(records,
                                                    batch_trace=bt))
        except BaseException as e:
            # submit-time validation already rejected record-level
            # problems, so a failure here is systemic — every waiter of
            # THIS batch gets the typed cause instead of hanging
            for p in batch:
                tr = p.trace  # ONE read: a timeout may null it out
                p.t_set = time.perf_counter()
                if tr is not None:
                    tr.seg("queue", t_d - p.t_enq)
                    tr.seg("dispatch", p.t_set - t_d)
                p.error = e
                p.done.set()
            return
        t_end = time.perf_counter()
        for p, r in zip(batch, results):
            tr = p.trace  # ONE read: a timed-out submit reclaims it
            p.t_set = time.perf_counter()
            if tr is not None:
                tr.seg("queue", t_d - p.t_enq)
                if bt is not None:
                    bt.stamp(tr)
                    tr.seg("dispatch", p.t_set - t_d - bt.walls_s)
            p.result = r
            p.done.set()
            self.engine.observe_request(t_end - p.t_enq, bucket)

    # -- lifecycle ---------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop accepting; drain=True scores everything already queued
        before the dispatcher exits, drain=False fails queued requests
        with RuntimeError immediately."""
        with self._cond:
            self._closed = True
            if not drain:
                while self._q:
                    p = self._q.popleft()
                    p.error = RuntimeError("batcher shut down before "
                                           "this request was scored")
                    p.done.set()
            self._cond.notify_all()
        self._thread.join(timeout)

    @property
    def closed(self) -> bool:
        return self._closed
