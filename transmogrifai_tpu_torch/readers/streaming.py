"""Streaming (micro-batch) readers for scoring (counterpart of
readers/streaming.py).

Reference: readers/.../StreamingReaders.scala:43-59 (`StreamingReaders
.Simple.avro` — Spark DStreams of new avro files) and the StreamingScore
run type (OpWorkflowRunner.scala:232). The DStream abstraction maps to a
plain iterator of record batches.

Scoring rides the tileplane (parallel/tileplane.py): incoming record
batches are re-grouped into FIXED-size record tiles whose raw-feature
Dataset is assembled on a background producer thread while the device
scores the previous tile through the fitted workflow's stages on the
model's device — one batch shape a tile (the ragged tail pads by
repeating its last record and the pad rows are dropped after scoring),
host record parsing overlapped with device compute. TMOG_TILEPLANE=0
restores the reference's per-record `score_function` loop.
"""
from __future__ import annotations

import glob
import os
import time
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

import numpy as np

from .readers import Reader

Record = Dict[str, Any]


class StreamingReader:
    """Base: iterate record micro-batches."""

    def __init__(self, key_fn: Optional[Callable[[Record], str]] = None):
        self.key_fn = key_fn

    def stream(self) -> Iterator[List[Record]]:
        raise NotImplementedError


class ListStreamingReader(StreamingReader):
    """Batches from an in-memory sequence (testing / replay)."""

    def __init__(self, records: Sequence[Record], batch_size: int = 100,
                 key_fn: Optional[Callable[[Record], str]] = None):
        super().__init__(key_fn)
        self.records = list(records)
        self.batch_size = int(batch_size)

    def stream(self) -> Iterator[List[Record]]:
        for i in range(0, len(self.records), self.batch_size):
            yield self.records[i:i + self.batch_size]


class FileStreamingReader(StreamingReader):
    """One batch per new file matching a glob pattern, in mtime order
    (the reference's 'new files in a directory' DStream source). `poll()`
    re-scans and yields only unseen files, enabling tail-follow loops.

    A file is only yielded once its SIZE is stable: each candidate is
    stat'd twice within the scan, and a file whose size changed — there
    or since the previous poll's observation — is deferred to the next
    poll (a writer is mid-flight; an mtime-ordered glob alone would hand
    a truncated container to the decoder). Stable files yield on first
    sight, so a quiet directory behaves exactly as before."""

    def __init__(self, pattern: str, reader_factory: Callable[[str], Reader],
                 key_fn: Optional[Callable[[Record], str]] = None,
                 stripe: bool = False):
        super().__init__(key_fn)
        self.pattern = pattern
        self.reader_factory = reader_factory
        #: multi-host striping (each process lists only its stripe of the
        #: files) is not ported
        if stripe:
            from ..parallel.tileplane import _not_ported
            raise _not_ported("multi-host striping (stripe=True)")
        self.stripe = stripe
        self._seen: set = set()
        # path -> last observed size, for candidates deferred mid-write
        self._pending: Dict[str, int] = {}
        # path -> (size, mtime) from the most recent _size stat: the
        # sort key reads mtime from HERE, so each candidate costs its
        # stability stats only — no third per-candidate stat per scan —
        # and ordering can't shift under a mid-scan mtime touch
        self._statted: Dict[str, Tuple[int, float]] = {}

    def _size(self, p: str) -> int:
        """Stat seam (monkeypatched by tests to simulate active writers);
        -1 = vanished between glob and stat. ONE os.stat serves both the
        size-stability check and the mtime ordering (cached in
        `_statted`)."""
        try:
            st = os.stat(p)
        except OSError:
            self._statted.pop(p, None)
            return -1
        self._statted[p] = (st.st_size, st.st_mtime)
        return st.st_size

    def _paths(self) -> List[str]:
        out = []
        matched = set()
        for p in glob.glob(self.pattern):
            matched.add(p)
            if p in self._seen:
                continue
            s1 = self._size(p)
            if s1 < 0:
                self._pending.pop(p, None)
                continue
            prev = self._pending.get(p)
            if prev is not None:
                # deferred last poll: admit only once the size held still
                if prev == s1:
                    self._pending.pop(p)
                    out.append(p)
                else:
                    self._pending[p] = s1
                continue
            s2 = self._size(p)
            if s2 == s1:
                out.append(p)
            elif s2 >= 0:
                self._pending[p] = s2  # actively growing: next poll
        # purge deferred entries whose file vanished (rotated temp files
        # would otherwise leak one ledger entry each in tail-follow loops)
        for p in list(self._pending):
            if p not in matched:
                self._pending.pop(p)

        def order(p: str) -> Tuple[float, str]:
            st = self._statted.get(p)
            if st is None:
                # only reachable when a test monkeypatches _size past
                # the cache; real scans always statted admitted paths
                try:
                    return (os.path.getmtime(p), p)
                except OSError:
                    return (0.0, p)
            return (st[1], p)

        # mtime order with the PATH as tiebreak: equal mtimes (same-run
        # shard writers, coarse filesystems) sort lexicographically, so
        # shard order — and everything downstream that must be
        # bit-identical across ingest worker counts — is deterministic
        return sorted(out, key=order)

    def stream(self) -> Iterator[List[Record]]:
        for p in self._paths():
            self._seen.add(p)
            yield self.reader_factory(p).read()

    def poll(self) -> List[List[Record]]:
        return [batch for batch in self.stream()]

    def snapshot_paths(self) -> List[str]:
        """Currently-stable unseen shards in deterministic order WITHOUT
        consuming them (`stream()` marks files seen; this does not).
        The sharded ingest engine (parallel/ingest.sharded_reader_source)
        builds its per-worker shard assignment from this listing and
        re-reads the same files once per pass."""
        return self._paths()


class IterStreamingReader(StreamingReader):
    """Batches of `batch_records` off a fresh-iterator factory — a
    file-backed stream that decodes LAZILY (the monitor's bulk replay
    route: the tileplane producer pulls the next batch only as the
    device drains the previous tiles, so a bulk file never materializes
    as one record list)."""

    def __init__(self, factory: Callable[[], Iterator[Record]],
                 batch_records: int = 1024,
                 key_fn: Optional[Callable[[Record], str]] = None):
        super().__init__(key_fn)
        self.factory = factory
        self.batch_records = max(1, int(batch_records))

    def stream(self) -> Iterator[List[Record]]:
        buf: List[Record] = []
        for rec in self.factory():
            buf.append(rec)
            if len(buf) >= self.batch_records:
                yield buf
                buf = []
        if buf:
            yield buf


class AvroStreamingReader(FileStreamingReader):
    """Reference StreamingReaders.Simple.avro."""

    def __init__(self, pattern: str,
                 key_fn: Optional[Callable[[Record], str]] = None):
        from .avro import AvroReader
        super().__init__(pattern, lambda p: AvroReader(p), key_fn)


class CSVStreamingReader(FileStreamingReader):
    def __init__(self, pattern: str,
                 key_fn: Optional[Callable[[Record], str]] = None):
        from .readers import CSVReader
        super().__init__(pattern, lambda p: CSVReader(p), key_fn)


# -- tileplane bulk scoring ---------------------------------------------------

def score_tile_rows_default() -> int:
    """Records per scoring tile, the fixed batch shape of every tile:
    TMOG_SCORE_TILE_ROWS, else 1024 (the JAX package's planner, which
    may move it, is not ported)."""
    return int(os.environ.get("TMOG_SCORE_TILE_ROWS", "1024"))


def _record_tiles(stream_reader: StreamingReader, tile_rows: int
                  ) -> Iterator[Tuple[List[Record], int]]:
    """Re-group ragged reader batches into fixed `tile_rows`-record
    tiles; the tail tile pads by REPEATING its last record (real values
    keep every stage's numerics on the fast path — zero-pad would
    inject synthetic NaN rows into vectorizers) and reports its valid
    count so the pad scores are dropped."""
    buf: List[Record] = []
    start = 0  # cursor instead of re-slicing: a whole-file reader batch
    # (FileStreamingReader yields one batch per FILE) would otherwise
    # memcpy the remaining pointer list once per tile — O(N^2)
    for batch in stream_reader.stream():
        buf.extend(batch)
        while len(buf) - start >= tile_rows:
            yield buf[start:start + tile_rows], tile_rows
            start += tile_rows
        if start:
            del buf[:start]
            start = 0
    if buf:
        n = len(buf)
        yield buf + [buf[-1]] * (tile_rows - n), n


def _scoring_dataset(records: List[Record], raw_feats):
    """Raw-feature Dataset for one record tile. Response features are NOT
    extracted (serving records are unlabeled — reference StreamingScore
    semantics, same as local/scoring.score_function): their columns fill
    with missing values so non-nullable response types (RealNN labels)
    never see a None."""
    from ..data.dataset import Column, Dataset, column_from_values
    from ..types import ColumnKind

    n = len(records)
    cols = {}
    for f in raw_feats:
        kind = f.feature_type.column_kind
        if f.is_response:
            if kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
                filled = np.full(n, np.nan, np.float64)
                cols[f.name] = Column(kind=kind, data=filled)
            else:
                empty = np.empty(n, dtype=object)
                cols[f.name] = Column(kind=kind, data=empty)
        else:
            cols[f.name] = column_from_values(
                f.feature_type, f.origin_stage.extract_all(records),
                coerced=True)
    return Dataset(cols)


def _row_value(col, i: int, feature_type=None):
    """One row of a scored column in the same shape the per-record
    score_function yields. A map-typed result feature (Prediction) that
    the batch path stored as a NAMED vector column unpacks back into its
    {metadata column -> float} dict; other vectors stay arrays; numeric
    NaN -> None like an absent FeatureType value."""
    v = col.data[i]
    if col.kind == "vector":
        if (feature_type is not None
                and getattr(feature_type, "column_kind", None) == "map"
                and col.metadata is not None):
            # the dense prediction block unpacks through the SAME
            # boundary converter the local scorer uses
            from ..models.prediction import row_prediction
            return row_prediction(col, i).value
        return np.asarray(v)
    if col.kind in ("float", "int", "bool"):
        f = float(v)
        return None if np.isnan(f) else f
    return v


def score_stream(model, stream_reader: StreamingReader, *,
                 tile_rows: Optional[int] = None
                 ) -> Iterator[List[Dict[str, Any]]]:
    """Score a record stream with the fitted workflow.

    Tileplane path (default): fixed-size record tiles, raw-feature
    Dataset assembly on the producer thread (`tile_copy` spans, the feed
    stage), batch scoring through the workflow's stages on the model's
    device on the caller's thread (`tile_compute` spans), pad rows
    dropped. Yields one list of {result_feature: value} dicts per TILE.

    TMOG_TILEPLANE=0 (or tile_rows=0) restores the reference semantics:
    per-batch, per-record scoring via `model.score_function()`
    (StreamingScore: scoreFn over the DStream), yielding one list per
    reader batch."""
    from ..parallel import tileplane as TP

    if tile_rows is None:
        tile_rows = score_tile_rows_default()
    if not TP.tileplane_enabled() or int(tile_rows) <= 0:
        fn = model.score_function()
        for batch in stream_reader.stream():
            yield [fn(r) for r in batch]
        return

    from ..utils.metrics import collector

    tile_rows = int(tile_rows)
    raw = model.raw_features()
    result_types = {f.name: f.feature_type for f in model.result_features}
    # tile spans anchor to the span current at STREAM start: the producer
    # thread must not adopt the stage spans the scoring thread opens
    anchor = collector.trace.current() if collector.enabled else None

    def produce():
        k = 0
        for recs, n_valid in _record_tiles(stream_reader, tile_rows):
            t0 = time.perf_counter()
            ds = _scoring_dataset(recs, raw)
            if collector.enabled:
                collector.trace.add_complete(
                    "tile_copy", "tile", time.perf_counter() - t0,
                    parent_span=anchor, tile=k, rows=int(n_valid),
                    label="score")
            k += 1
            yield ds, n_valid

    k = 0
    for ds, n_valid in TP.pipelined(produce(), label="score"):
        t0 = time.perf_counter()
        scored = model.score(ds)
        cols = [(nm, scored.column(nm), t)
                for nm, t in result_types.items() if nm in scored]
        out = [{nm: _row_value(col, i, t) for nm, col, t in cols}
               for i in range(n_valid)]
        if collector.enabled:
            collector.trace.add_complete(
                "tile_compute", "tile", time.perf_counter() - t0,
                parent_span=anchor, tile=k, rows=int(n_valid),
                label="score")
        k += 1
        yield out
