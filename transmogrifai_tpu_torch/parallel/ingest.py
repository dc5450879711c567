"""Parallel sharded ingest: a parse-worker pool feeding the tileplane
(counterpart of parallel/ingest.py).

- `ShardedSource` is a RowSource over per-file-shard chunk factories.
  N parse workers each own a striped subset of shards (worker j owns
  shards j, j+N, j+2N, ...) and decode into bounded per-shard queues;
- `chunks()` drains those queues IN SHARD-INDEX ORDER, so the chunk
  sequence is exactly a serial read of the shards: the tileplane cuts the
  same tiles and every reduction (statistics moments, GLM accumulators,
  tree binning) is bit-identical at any worker count;
- a worker's exception lands on the queue of the shard it was parsing
  and is raised again when reassembly reaches that shard: a failed pass,
  never a hang;
- one shard, or workers <= 1, reads serially on the consumer's thread;
- decode is COLUMNAR: whole column blocks per chunk
  (readers/readers.csv_columnar_chunks, readers/avro.read_avro_columns),
  each column converted once (readers/readers.columnar_f32); an Avro file
  whose records are all float / double / boolean / int / long fields
  decodes a block at a time into numpy (`read_avro_columns(arrays=True)`);
- each decoded chunk is a `tile_parse` span with a per-worker `lane`
  attribute, so parse, copy and compute read off one trace.

TMOG_INGEST_WORKERS sizes the pool (default 1; the JAX package's planner,
which may move it, is not ported); a traced pass records an IngestPass
and an `ingest_pass` event. Multi-host striping is not ported.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np

from .tileplane import RowSource, _not_ported, _put

_INGEST_WORKERS_DEFAULT = 1
#: per-shard queue depth: how many chunks a worker may decode ahead of
#: reassembly on each shard it owns (host buffering is bounded by
#: shards * ahead chunks, independent of file size)
_SHARD_QUEUE_AHEAD = 2


def ingest_workers() -> int:
    """Parse-worker pool size for sharded sources: TMOG_INGEST_WORKERS,
    else 1. Each pass also clamps the pool to the shard count."""
    try:
        return max(1, int(os.environ.get(
            "TMOG_INGEST_WORKERS", str(_INGEST_WORKERS_DEFAULT))))
    except ValueError:
        return _INGEST_WORKERS_DEFAULT


def _parse_shard(factory: Callable[[], Iterable[Tuple[np.ndarray, ...]]],
                 si: int, worker: int, label: str, traced: bool,
                 anchor: Any, collector: Any
                 ) -> Iterator[Tuple[Tuple[np.ndarray, ...], float]]:
    """Shard `si`'s chunks, each made contiguous, with the seconds its
    parse took (the time the caller holds a chunk is not counted); a
    traced pass records each as a `tile_parse` span on lane
    ingest-w{worker}."""
    seq = 0
    t0 = time.perf_counter()
    for chunk in factory():
        chunk = tuple(np.ascontiguousarray(a) for a in chunk)
        dur = time.perf_counter() - t0
        if traced:
            collector.trace.add_complete(
                "tile_parse", "tile", dur, parent_span=anchor, shard=si,
                chunk=seq, worker=worker, rows=int(chunk[0].shape[0]),
                label=label, lane=f"ingest-w{worker}")
        yield chunk, dur
        seq += 1
        t0 = time.perf_counter()


def _parse_worker(factories: Sequence[Callable[[], Iterable[Tuple[np.ndarray, ...]]]],
                  owned: Sequence[int], qs: Sequence["queue.Queue"],
                  stop: threading.Event, traced: bool, anchor: Any,
                  label: str, worker_idx: int,
                  parse_s: List[float], collector: Any) -> None:
    """Worker body: decode owned shards IN ORDER into their per-shard
    queues. Module-level with explicit args — all pass state lives in
    the consumer's frame, none on shared objects. An exception lands on
    the queue of the shard being parsed: reassembly drains shards in
    index order, and every shard before the failed one either ended
    cleanly or fails first, so the consumer always reaches the error
    (failed pass) instead of blocking on a sentinel that never comes.
    `parse_s[worker_idx]` is a single-writer slot, read by the consumer
    only after join."""
    si = owned[0]
    try:
        for si in owned:
            for chunk, dur in _parse_shard(factories[si], si, worker_idx,
                                           label, traced, anchor,
                                           collector):
                parse_s[worker_idx] += dur
                if not _put(qs[si], ("chunk", chunk), stop):
                    return
            if not _put(qs[si], ("end", None), stop):
                return
    except BaseException as e:
        _put(qs[si], ("error", e), stop)


class ShardedSource(RowSource):
    """Order-preserving parallel-parse RowSource over file shards.

    `shard_factories[i]()` starts a fresh chunk iteration of shard i
    (tuples of same-leading-dim arrays, the RowSource chunk contract).
    `chunks()` yields shard 0's chunks, then shard 1's, ... — exactly a
    serial concatenated read — while up to `workers` threads decode
    ahead. Re-iterable: every `chunks()` call is a fresh pass with
    fresh threads (GLM rounds re-read disk through the same pool)."""

    def __init__(self, shard_factories: Sequence[
                     Callable[[], Iterable[Tuple[np.ndarray, ...]]]],
                 *, n_rows: Optional[int] = None,
                 workers: Optional[int] = None,
                 ahead: int = _SHARD_QUEUE_AHEAD,
                 label: str = "ingest"):
        self.shard_factories = list(shard_factories)
        self.n_rows = n_rows
        #: None = resolve ingest_workers() (env, else 1) per pass
        self.workers = workers
        self.ahead = max(1, int(ahead))
        self.label = label
        self._anchor: Any = None

    def set_span_anchor(self, anchor: Any) -> None:
        # caller's thread, BEFORE the pass's threads exist (run_tileplane
        # contract) — workers then receive it by argument
        self._anchor = anchor

    def effective_workers(self) -> int:
        """Pool size for the next pass: the requested workers (else
        TMOG_INGEST_WORKERS) clamped to the shard count — a single shard has no parallelism
        to exploit and degrades to the serial path."""
        w = self.workers if self.workers is not None else ingest_workers()
        return max(1, min(int(w), len(self.shard_factories)))

    def chunks(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n_workers = self.effective_workers()
        if n_workers <= 1 or len(self.shard_factories) <= 1:
            yield from self._serial_pass()
        else:
            yield from self._parallel_pass(n_workers)

    # -- serial degradation (single shard / workers=1 / tiny inputs) --------

    def _serial_pass(self) -> Iterator[Tuple[np.ndarray, ...]]:
        """The single-producer path, in-thread — same chunk sequence,
        same tile_parse spans (worker 0), so serial-vs-parallel A/B
        reads off one trace schema."""
        from ..utils.metrics import collector
        traced = bool(collector.enabled)
        anchor = self._anchor
        parse_s = 0.0
        rows = 0
        n_chunks = 0
        t_pass = time.perf_counter()
        for si, factory in enumerate(self.shard_factories):
            for chunk, dur in _parse_shard(factory, si, 0, self.label,
                                           traced, anchor, collector):
                parse_s += dur
                rows += int(chunk[0].shape[0])
                n_chunks += 1
                yield chunk
        if traced:
            collector.ingest_pass(
                label=self.label, workers=1,
                shards=len(self.shard_factories), chunks=n_chunks,
                rows=rows, parse_seconds=parse_s,
                wall_seconds=time.perf_counter() - t_pass)

    # -- the worker pool ----------------------------------------------------

    def _parallel_pass(self, n_workers: int
                       ) -> Iterator[Tuple[np.ndarray, ...]]:
        from ..utils.metrics import collector
        traced = bool(collector.enabled)
        anchor = self._anchor
        n_shards = len(self.shard_factories)
        qs = [queue.Queue(maxsize=self.ahead) for _ in range(n_shards)]
        stop = threading.Event()
        parse_s = [0.0] * n_workers
        threads = []
        for w in range(n_workers):
            th = threading.Thread(
                target=_parse_worker,
                args=(self.shard_factories, list(range(w, n_shards,
                                                       n_workers)),
                      qs, stop, traced, anchor, self.label, w, parse_s,
                      collector),
                name=f"ingest-{self.label}-w{w}", daemon=True)
            th.start()
            threads.append(th)
        rows = 0
        n_chunks = 0
        t_pass = time.perf_counter()
        try:
            for si in range(n_shards):
                # reassembly: global order = shard order = serial order
                while True:
                    kind, payload = qs[si].get()
                    if kind == "end":
                        break
                    if kind == "error":
                        raise payload
                    rows += int(payload[0].shape[0])
                    n_chunks += 1
                    yield payload
        finally:
            stop.set()
            # drain every queue so workers blocked on put observe the
            # flag (their _put loops re-check it each timeout)
            for q in qs:
                try:
                    while True:
                        q.get_nowait()
                except queue.Empty:
                    pass
            for th in threads:
                th.join(timeout=30.0)
            if traced:
                # parse_s read happens-after join
                collector.ingest_pass(
                    label=self.label, workers=n_workers,
                    shards=n_shards, chunks=n_chunks, rows=rows,
                    parse_seconds=sum(parse_s),
                    wall_seconds=time.perf_counter() - t_pass)

    def peek(self) -> Tuple[np.ndarray, ...]:
        """Width probe without spinning up the pool: read shard 0's
        first chunk in-thread (falls back to a full-pass probe when
        shard 0 is empty). Cached like the base peek."""
        if self._peek_cache is None:
            if self.shard_factories:
                it = iter(self.shard_factories[0]())
                try:
                    first = next(it)
                except StopIteration:
                    first = None
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
                if first is not None:
                    self._peek_cache = tuple(
                        np.ascontiguousarray(a) for a in first)
                    return self._peek_cache
            return super().peek()
        return self._peek_cache


def sharded_reader_source(paths: Sequence[str],
                          columns_fn: Callable[[Dict[str, np.ndarray]],
                                               Tuple[np.ndarray, ...]],
                          *, columns: Optional[Sequence[str]] = None,
                          batch_records: int = 8192,
                          n_rows: Optional[int] = None,
                          workers: Optional[int] = None,
                          label: str = "ingest",
                          stripe: Optional[bool] = None) -> ShardedSource:
    """ShardedSource over CSV/Avro file shards with COLUMNAR decode.

    Each shard decodes in whole column blocks — one vectorized
    float32 conversion per column per chunk, no per-record dicts —
    and `columns_fn({name -> float32 array})` maps one chunk's columns
    to the source's chunk tuple (e.g. `lambda c: (np.stack([c["x0"],
    c["x1"]], 1), c["y"], c["w"])`): the vectorized replacement for the
    per-record `row_fn` of tileplane.reader_row_source. Format is by
    extension per shard (.avro = container decode, else CSV);
    `columns` restricts decode to the named fields (CSV header names /
    Avro record fields). Shard ORDER is the caller's `paths` order —
    pass FileStreamingReader's deterministic listing for file globs.

    `stripe=True` (multi-host striping: each process keeps its own stripe
    of `paths`) is not ported and raises; None and False read every
    path."""
    if stripe:
        raise _not_ported("multi-host striping (stripe=True)")
    paths = [str(p) for p in paths]

    def factory_for(path: str) -> Callable[[], Iterator[Tuple[np.ndarray, ...]]]:
        if path.endswith(".avro"):
            def factory() -> Iterator[Tuple[np.ndarray, ...]]:
                from ..readers.avro import read_avro_columns
                from ..readers.readers import columnar_f32
                for cols in read_avro_columns(
                        path, fields=columns, batch_records=batch_records,
                        arrays=True):
                    yield columns_fn(
                        {k: columnar_f32(v) for k, v in cols.items()})
        else:
            def factory() -> Iterator[Tuple[np.ndarray, ...]]:
                from ..readers.readers import csv_columnar_chunks
                for cols in csv_columnar_chunks(
                        path, columns=columns,
                        batch_records=batch_records):
                    yield columns_fn(cols)
        return factory

    return ShardedSource([factory_for(p) for p in paths], n_rows=n_rows,
                         workers=workers, label=label)
