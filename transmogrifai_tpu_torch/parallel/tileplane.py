"""Double-buffered host -> device row-tile pipeline (counterpart of
parallel/tileplane.py).

Every streamed consumer of the port shares this one pipeline: the
statistics engine (`ops/stats_engine.stream_stats`), the GLM round
driver's row-source route (`ops/glm_sweep.sweep_glm_streamed_rounds`),
streamed tree binning (`ops/trees.stream_quantile_edges`,
`stream_bin_matrix`) and bulk scoring (`readers/streaming.score_stream`,
through `pipelined`).

- A background PRODUCER thread cuts the source's chunks into fixed-shape
  float32 tiles (`iter_fixed_tiles`: the ragged tail zero-padded, and the
  zero weights of the padded rows keep them inert in every consumer's
  arithmetic) and lands tile k+1 on the device while the caller's thread
  runs tile k's step. `TMOG_TILE_PREFETCH` (default 1) tiles may be
  copied ahead of the one computing; depth never moves a tile boundary,
  so a pass gives the same bits at any depth.
- On CUDA the copy is the port's own: each tile is assembled straight
  into one of `depth + 1` pinned host buffers allocated once a pass (a
  copy from pageable memory is synchronous, and the rows cross host
  memory once), copied on a dedicated copy stream, and a CUDA event a
  slot keeps the producer from refilling a buffer whose copy is still in
  flight. The compute stream waits on the copy's event,
  and the device tile is `record_stream`-ed on it, so the caching
  allocator cannot hand its memory to the next copy early. A `sink`'s
  output tile is copied into pinned memory on the compute stream and
  handed over one tile later, so its copy overlaps the next tile's step.
- The CARRY (moment state, GLM accumulators) stays on the device for the
  whole pass; the caller fetches it once.
- With tracing on (utils/metrics.collector), every tile adds a
  `tile_copy` span (producer thread, staging + copy to the copy's event)
  and a `tile_compute` span (caller's thread, the step to its end on the
  device), so the overlap is measured, not asserted.

`TMOG_TILEPLANE=0` runs the same tiles synchronously on the caller's
thread, on the same device (`_run_sync`): no producer thread and no
overlap; it is a switch, not a fallback, and no failure falls through to
it. `TMOG_TILE_MB` sizes tiles (default 32 MB of f32 rows). The JAX
package's plan-time autotuner, which may move both knobs, is not ported,
and neither are its mesh shardings.

Sources are re-iterable (`RowSource.chunks()` starts a fresh pass), so a
multi-pass consumer (GLM Newton iterations) re-reads disk instead of
holding X: a flow larger than the device's memory runs fit -> score
without ever materializing the matrix.
"""
from __future__ import annotations

import os
import queue
import threading
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from ..device import DeviceLike, active_recorder, resolve_device

_TILE_MB_DEFAULT = 32
_TILE_PREFETCH_DEFAULT = 1
# seconds a pass waits for its producer thread to stop on the way out
_JOIN_DEADLINE_S = 30.0


def env_on(name: str, default: str = "1") -> bool:
    """Tri-state TMOG_* toggle parse: off for 0, false and off (every
    TMOG_* switch of the package)."""
    return os.environ.get(name, default).strip().lower() \
        not in ("0", "false", "off")


def tileplane_enabled() -> bool:
    """THE switch: TMOG_TILEPLANE=0 runs every pass synchronously."""
    return env_on("TMOG_TILEPLANE")


def tile_budget_bytes() -> int:
    """Host/device bytes per tile (TMOG_TILE_MB, default 32)."""
    try:
        return int(os.environ.get("TMOG_TILE_MB",
                                  str(_TILE_MB_DEFAULT))) << 20
    except ValueError:
        return _TILE_MB_DEFAULT << 20


def tile_prefetch_depth() -> int:
    """Tiles the producer may copy ahead of the consumer
    (TMOG_TILE_PREFETCH, default 1: classic double buffering). The device
    holds depth + 1 tiles plus the carry."""
    try:
        return max(1, int(os.environ.get(
            "TMOG_TILE_PREFETCH", str(_TILE_PREFETCH_DEFAULT))))
    except ValueError:
        return _TILE_PREFETCH_DEFAULT


def tile_rows_for(row_bytes: int, n_rows: Optional[int] = None,
                  multiple: int = 1) -> int:
    """Rows per tile for a given per-row byte width, clamped to [256,
    2^20], rounded UP to `multiple`."""
    c = tile_budget_bytes() // max(int(row_bytes), 1)
    c = max(min(c, 1 << 20), 256)
    if n_rows is not None:
        c = max(min(c, int(n_rows)), 1)
    if multiple > 1:
        c = -(-c // multiple) * multiple
    return c


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported: the port streams to one device "
        "(multi-device and multi-host streaming: ROADMAP.md, A14)")


# -- row sources -------------------------------------------------------------

class RowSource:
    """Re-iterable source of host row chunks.

    `chunks()` starts a FRESH pass and yields tuples of numpy arrays that
    share a leading row dimension (chunk sizes may vary; the pipeline
    re-tiles them). Multi-pass consumers call `chunks()` once per data
    pass — for a file-backed source a re-read of disk."""

    #: row count if known up front (None for tail-follow sources)
    n_rows: Optional[int] = None

    def chunks(self) -> Iterator[Tuple[np.ndarray, ...]]:
        raise NotImplementedError

    _peek_cache: Optional[Tuple[np.ndarray, ...]] = None

    def peek(self) -> Tuple[np.ndarray, ...]:
        """First chunk of a fresh pass (the width probe of drivers that
        need d or F before streaming), cached: repeated probes cost one
        chunk read in all."""
        if self._peek_cache is None:
            it = self.chunks()
            try:
                self._peek_cache = next(it)
            except StopIteration:
                raise ValueError("empty row source") from None
            finally:
                close = getattr(it, "close", None)
                if close is not None:
                    close()
        return self._peek_cache

    def set_span_anchor(self, anchor: Any) -> None:
        """run_tileplane hands the span current at pass start here, on the
        caller's thread, before any pipeline thread starts: a source that
        records its own `tile_parse` spans (parallel/ingest.ShardedSource)
        parents them to it. Default: ignore."""


class ArraySource(RowSource):
    """Chunks sliced off resident host arrays (numpy views, no copies)."""

    def __init__(self, *arrays: Any, chunk_rows: Optional[int] = None):
        self.arrays = [np.asarray(a) for a in arrays]
        self.n_rows = int(self.arrays[0].shape[0])
        for a in self.arrays:
            if a.shape[0] != self.n_rows:
                raise ValueError("row-count mismatch across source arrays")
        self.chunk_rows = int(chunk_rows) if chunk_rows else None

    def chunks(self) -> Iterator[Tuple[np.ndarray, ...]]:
        c = self.chunk_rows or self.n_rows
        for s in range(0, self.n_rows, c):
            yield tuple(a[s:s + c] for a in self.arrays)


class IterSource(RowSource):
    """Chunks from a factory of fresh iterators (generators over files,
    record decoders...)."""

    def __init__(self, factory: Callable[[], Iterable[Tuple[np.ndarray, ...]]],
                 n_rows: Optional[int] = None):
        self.factory = factory
        self.n_rows = n_rows

    def chunks(self) -> Iterator[Tuple[np.ndarray, ...]]:
        for chunk in self.factory():
            yield tuple(np.asarray(a) for a in chunk)


class PaddedSource(RowSource):
    """A source padded to exactly `n_target` rows with zero rows (the
    inner source must own at least one row: its first chunk is the shape
    template of the padding). The JAX package's multi-host pass pads each
    process's stripe to one tile count with it; here it stands alone."""

    def __init__(self, inner: RowSource, n_target: int):
        self.inner = inner
        self.n_target = int(n_target)
        self.n_rows = int(n_target)

    def chunks(self) -> Iterator[Tuple[np.ndarray, ...]]:
        seen = 0
        template: Optional[Tuple[np.ndarray, ...]] = None
        for chunk in self.inner.chunks():
            if template is None:
                template = chunk
            seen += chunk[0].shape[0]
            if seen > self.n_target:
                raise ValueError(
                    f"PaddedSource: inner source produced {seen} rows, "
                    f"more than the layout's {self.n_target}")
            yield chunk
        if seen < self.n_target:
            if template is None:
                raise ValueError("PaddedSource: empty inner source — "
                                 "the padding needs one chunk as its "
                                 "shape template")
            miss = self.n_target - seen
            yield tuple(np.zeros((miss,) + tuple(a.shape[1:]), a.dtype)
                        for a in template)

    def peek(self) -> Tuple[np.ndarray, ...]:
        return self.inner.peek()

    def set_span_anchor(self, anchor: Any) -> None:
        self.inner.set_span_anchor(anchor)


def reader_row_source(read_records: Callable[[], Iterable[Dict[str, Any]]],
                      row_fn: Callable[[Dict[str, Any]],
                                       Sequence[Sequence[float]]],
                      batch_records: int = 4096,
                      n_rows: Optional[int] = None) -> RowSource:
    """The `records -> numpy chunk` adapter over the record readers
    (readers/avro.read_avro_file, readers/readers.CSVReader.read, the
    streaming readers): `read_records()` starts a fresh record iteration;
    `row_fn(record)` maps one record to a tuple of per-array row values
    (e.g. `(x_row [d], y, w)`). Records buffer `batch_records` at a time
    into float32 chunks."""

    def factory():
        buf: List[Sequence[Any]] = []

        def flush():
            cols = list(zip(*buf))
            return tuple(np.asarray(np.stack(c) if np.ndim(c[0]) else c,
                                    dtype=np.float32) for c in cols)

        for rec in read_records():
            buf.append(tuple(row_fn(rec)))
            if len(buf) >= batch_records:
                yield flush()
                buf = []
        if buf:
            yield flush()

    return IterSource(factory, n_rows=n_rows)


# -- fixed-shape re-tiling ---------------------------------------------------

def iter_fixed_tiles(source: RowSource, tile_rows: int,
                     track: Optional["TilePlaneStats"] = None,
                     alloc: Optional[Callable[..., Sequence[np.ndarray]]]
                     = None
                     ) -> Iterator[Tuple[Tuple[np.ndarray, ...], int]]:
    """Re-slice a chunk stream into fixed `[tile_rows, ...]` float32
    tiles, zero-padding the ragged tail; yields `(tile_arrays, n_valid)`.

    `alloc(shapes)` (optional) gives the float32 arrays each tile is
    written into (the pinned ring's next slot): the rows then cross host
    memory once, from the chunks straight into the buffer the device
    copies from.

    Synchronous: the producer thread and the TMOG_TILEPLANE=0 loop share
    it, so both paths see the same tiles. At most one tile of rows plus
    the chunk in hand is buffered here (`track.peak_host_rows` holds the
    <= 2-tile bound)."""
    pend: List[Tuple[np.ndarray, ...]] = []
    pend_rows = 0
    narr = None

    def pop_tile() -> Tuple[Tuple[np.ndarray, ...], int]:
        nonlocal pend, pend_rows
        take, have = [], 0
        while pend and have < tile_rows:
            chunk = pend.pop(0)
            r = chunk[0].shape[0]
            if have + r <= tile_rows:
                take.append(chunk)
                have += r
            else:
                cut = tile_rows - have
                take.append(tuple(a[:cut] for a in chunk))
                pend.insert(0, tuple(a[cut:] for a in chunk))
                have = tile_rows
        pend_rows -= have
        parts = list(zip(*take))
        if alloc is not None:
            dst = alloc(tuple((tile_rows,) + p[0].shape[1:] for p in parts))
            for out, pieces in zip(dst, parts):
                pos = 0
                for piece in pieces:
                    out[pos:pos + piece.shape[0]] = piece
                    pos += piece.shape[0]
                out[pos:] = 0
            return tuple(dst), have
        tile = []
        for ai in range(narr):
            arr = parts[ai][0] if len(parts[ai]) == 1 \
                else np.concatenate(parts[ai], axis=0)
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            if arr.shape[0] < tile_rows:
                pad = [(0, tile_rows - arr.shape[0])] \
                    + [(0, 0)] * (arr.ndim - 1)
                arr = np.pad(arr, pad)
            tile.append(arr)
        return tuple(tile), have

    chunks = source.chunks()
    try:
        for chunk in chunks:
            if narr is None:
                narr = len(chunk)
            pend.append(chunk)
            pend_rows += chunk[0].shape[0]
            if track is not None:
                # single writer (the tile assembly); read after the join
                track.peak_host_rows = max(track.peak_host_rows, pend_rows)
            while pend_rows >= tile_rows:
                yield pop_tile()
        while pend_rows > 0:
            yield pop_tile()
    finally:
        close = getattr(chunks, "close", None)
        if close is not None:
            close()   # a sharded source joins its parse workers here


# -- the pipeline ------------------------------------------------------------

class TilePlaneStats:
    """Per-pass pipeline telemetry (filled as the pass runs)."""

    def __init__(self, tile_rows: int, label: str, prefetch: int = 1):
        self.label = label
        self.tile_rows = int(tile_rows)
        self.prefetch_depth = int(prefetch)
        self.tiles = 0
        self.rows = 0
        #: max host rows buffered in the tile assembly at any instant:
        #: <= 2 * tile_rows by construction (one tile being assembled +
        #: one chunk in hand)
        self.peak_host_rows = 0
        #: bytes landed on the device (every tile, padding included)
        self.copy_bytes = 0
        #: pinned staging buffers the pass allocated (CUDA: one ring of
        #: depth + 1 slots a pass, not one a tile)
        self.pinned_slots = 0
        self.copy_seconds = 0.0      # traced passes only
        self.compute_seconds = 0.0   # traced passes only
        self.wall_seconds = 0.0
        self.overlapped = None  # True when traced copy/compute windows met

    def to_json(self) -> Dict[str, Any]:
        return {"label": self.label, "tiles": self.tiles, "rows": self.rows,
                "tile_rows": self.tile_rows,
                "prefetch_depth": self.prefetch_depth,
                "peak_host_rows": self.peak_host_rows,
                "copy_bytes": self.copy_bytes,
                "pinned_slots": self.pinned_slots,
                "copy_seconds": round(self.copy_seconds, 6),
                "compute_seconds": round(self.compute_seconds, 6),
                "wall_seconds": round(self.wall_seconds, 6),
                "overlapped": self.overlapped}


class _Stop(Exception):
    pass


_SENTINEL = object()


class _TileLander:
    """Lands fixed-shape host tiles on one device.

    On CUDA: a ring of `slots` pinned staging buffers, allocated at the
    first tile (tile shapes are fixed for the pass), each with the CUDA
    event of the last copy that read it. `alloc` hands out the next slot
    once that event has completed (the tile assembly writes into it);
    `land` copies the slot into a fresh device tile on `stream` (None:
    the current stream) and records the copy's event; the tile must have
    been assembled in the slot `alloc` handed out. Inside
    `device.record_copies()` each copy is recorded under `label`. On the
    CPU a tile is wrapped without a copy."""

    def __init__(self, device: torch.device, slots: int,
                 stream: Optional["torch.cuda.Stream"] = None,
                 label: str = "tile"):
        self.device = device
        self.label = label
        self.cuda = device.type == "cuda"
        self.n_slots = int(slots)
        self.stream = stream
        self._ring: Optional[List[Tuple[torch.Tensor, ...]]] = None
        self._events: List[Optional[Any]] = [None] * self.n_slots
        self._next = 0
        self._staged: Optional[int] = None
        self.pinned_allocs = 0   # ring buffers allocated (one a slot)

    def alloc(self, shapes) -> Tuple[np.ndarray, ...]:
        """The next slot's buffers as numpy views (CUDA only)."""
        if self._ring is None:
            self._ring = [tuple(torch.empty(sh, dtype=torch.float32,
                                            pin_memory=True)
                                for sh in shapes)
                          for _ in range(self.n_slots)]
            self.pinned_allocs = self.n_slots
        s = self._next
        self._next = (s + 1) % self.n_slots
        if self._events[s] is not None:
            self._events[s].synchronize()   # its last copy has finished
        self._staged = s
        return tuple(buf.numpy() for buf in self._ring[s])

    def land(self, tile: Tuple[np.ndarray, ...]
             ) -> Tuple[Tuple[torch.Tensor, ...], Optional[Any]]:
        if not self.cuda:
            return tuple(torch.from_numpy(a if a.flags.writeable
                                          else a.copy())
                         for a in tile), None
        s, self._staged = self._staged, None
        if s is None or any(a.ctypes.data != buf.data_ptr()
                            for a, buf in zip(tile, self._ring[s])):
            raise RuntimeError("land() takes a tile assembled in the slot "
                               "alloc() handed out")
        slot = self._ring[s]
        stream = self.stream or torch.cuda.current_stream(self.device)
        rec = active_recorder()
        with torch.cuda.stream(stream):
            dev = tuple(torch.empty(buf.shape, dtype=torch.float32,
                                    device=self.device) for buf in slot)
            if rec is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            for d, buf in zip(dev, slot):
                d.copy_(buf, non_blocking=True)
            ev = torch.cuda.Event(enable_timing=rec is not None)
            ev.record(stream)
        if rec is not None:
            rec.add(self.label, sum(buf.numel() * 4 for buf in slot),
                    start, ev)
        self._events[s] = ev
        return dev, ev


def _copy_span(collector, stats: TilePlaneStats, anchor, k: int,
               n_valid: int, tile, dur: float) -> None:
    stats.copy_seconds += dur
    collector.trace.add_complete(
        "tile_copy", "tile", dur, parent_span=anchor, tile=k,
        rows=int(n_valid), label=stats.label,
        bytes=int(sum(a.nbytes for a in tile)))


def _put(q: "queue.Queue", item: Any, stop: threading.Event) -> bool:
    """Bounded put that observes the stop flag; False = pass abandoned."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


def _producer(source: RowSource, tile_rows: int, q: "queue.Queue",
              copy_slot: threading.Semaphore, stop: threading.Event,
              stats: TilePlaneStats, lander: _TileLander,
              traced: bool, anchor=None) -> None:
    """Producer-thread body: assemble fixed tiles and land tile k+1 while
    the consumer computes tile k. `copy_slot` (depth tokens, each
    released when the consumer dequeues a tile) gates every landing, so
    at most depth + 1 device tiles are alive. Spans anchor to the span
    current at pass start: the consumer's own spans open and close
    concurrently and must not adopt them."""
    from ..utils.metrics import collector
    t0 = 0.0

    def alloc(shapes):
        nonlocal t0
        # a landing slot is taken once the consumer has dequeued a tile:
        # at most `depth` tiles wait landed while one computes
        while not copy_slot.acquire(timeout=0.1):
            if stop.is_set():
                raise _Stop
        if stop.is_set():
            raise _Stop
        t0 = time.perf_counter()
        return lander.alloc(shapes)

    tiles = iter_fixed_tiles(source, tile_rows, stats,
                             alloc if lander.cuda else None)
    try:
        for k, (tile, n_valid) in enumerate(tiles):
            if not lander.cuda:
                while not copy_slot.acquire(timeout=0.1):
                    if stop.is_set():
                        raise _Stop
                if stop.is_set():
                    raise _Stop
                t0 = time.perf_counter()
            dev, ev = lander.land(tile)
            # producer-owned fields, read after the join
            stats.copy_bytes += int(sum(a.nbytes for a in tile))
            if traced:
                # the span measures the copy, not its enqueue; the wait
                # blocks this thread only, the device keeps computing
                if ev is not None:
                    ev.synchronize()
                _copy_span(collector, stats, anchor, k, n_valid, tile,
                           time.perf_counter() - t0)
            if not _put(q, (dev, ev, n_valid, k), stop):
                raise _Stop
        _put(q, _SENTINEL, stop)
    except _Stop:
        pass
    except BaseException as e:  # raised again on the consumer's thread
        _put(q, ("__error__", e), stop)
    finally:
        tiles.close()


class _Consumer:
    """Per-tile step / sink / span logic, shared by the threaded loop and
    the synchronous one."""

    def __init__(self, step, first_tile, sink, stats: TilePlaneStats,
                 traced: bool, anchor, carry0, device: torch.device):
        self.step = step
        self.first_tile = first_tile
        self.sink = sink
        self.stats = stats
        self.traced = traced
        self.anchor = anchor
        self.carry = carry0
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.current_stream(device) if self.cuda \
            else None
        self._pending: Optional[Tuple[Any, Any, int]] = None

    def _to_host(self, out: torch.Tensor) -> Tuple[Any, Any]:
        """An output tile into pinned host memory on the compute stream;
        (host tensor, its copy's event). The caching host allocator keeps
        the buffer until the copy's recorded use has completed."""
        if not self.cuda:
            return out.detach(), None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return host, ev

    def _deliver(self) -> None:
        host, ev, n = self._pending
        self._pending = None
        if ev is not None:
            ev.synchronize()
        self.sink(host.numpy()[:n], n)

    def feed(self, dev, ev, n_valid: int, k: int) -> None:
        from ..utils.metrics import collector
        t0 = time.perf_counter()
        if ev is not None:
            self.stream.wait_event(ev)
            for t in dev:
                # the allocator must not reuse the tile's memory for a
                # later copy before this stream is done with it
                t.record_stream(self.stream)
        if k == 0 and self.first_tile is not None:
            self.carry = self.first_tile(self.carry, *dev)
        out = self.step(self.carry, *dev)
        if self.sink is not None:
            self.carry, out_tile = out
            staged = self._to_host(out_tile)
            if self._pending is not None:
                self._deliver()   # tile k-1's output, one tile late
            self._pending = (staged[0], staged[1], n_valid)
        else:
            self.carry = out
        if self.traced:
            if self.cuda:
                self.stream.synchronize()
            dur = time.perf_counter() - t0
            self.stats.compute_seconds += dur
            collector.trace.add_complete(
                "tile_compute", "tile", dur, parent_span=self.anchor,
                tile=k, rows=int(n_valid), label=self.stats.label)
        self.stats.tiles += 1
        self.stats.rows += int(n_valid)

    def flush(self) -> None:
        if self._pending is not None:
            self._deliver()


def _finish_pass(stats: TilePlaneStats, traced: bool,
                 t_pass: float) -> TilePlaneStats:
    from ..utils.metrics import collector
    stats.wall_seconds = time.perf_counter() - t_pass
    if traced:
        stats.overlapped = stats.copy_seconds + stats.compute_seconds \
            > stats.wall_seconds * 1.001
        collector.event(
            "tileplane_pass", label=stats.label, tiles=stats.tiles,
            rows=stats.rows, tile_rows=stats.tile_rows,
            prefetch_depth=stats.prefetch_depth,
            peak_host_rows=stats.peak_host_rows,
            copy_seconds=round(stats.copy_seconds, 6),
            compute_seconds=round(stats.compute_seconds, 6),
            wall_seconds=round(stats.wall_seconds, 6))
    return stats


def run_tileplane(source: RowSource, step: Callable[..., Any], carry0: Any,
                  *, tile_rows: int, label: str = "tileplane",
                  first_tile: Optional[Callable[..., Any]] = None,
                  sink: Optional[Callable[[np.ndarray, int], None]] = None,
                  shardings: Optional[Sequence[Any]] = None,
                  prefetch: Optional[int] = None,
                  device: DeviceLike = None
                  ) -> Tuple[Any, TilePlaneStats]:
    """ONE double-buffered pass of `source` through `step` on `device`
    (None: CUDA), returning the final DEVICE carry and the pass stats.

    `prefetch` is the ring depth (None: tile_prefetch_depth()). Depth
    changes the device footprint ((depth + 1) tiles + the carry) and the
    overlap, never a tile boundary, so the carry is bit-identical at any
    depth and under TMOG_TILEPLANE=0.

    step(carry, *tile_tensors) -> carry, or -> (carry, out_tile) when
    `sink` is given: output tiles are copied to the host with a one-tile
    lag and handed to `sink(np_out[:n_valid], n_valid)`, so the copy of
    tile k overlaps tile k+1's step (the array is the sink's to keep).
    `first_tile(carry, *tile_tensors) -> carry` runs once on tile 0 before
    its step (the stats engine derives its Gram shift there, on the
    device, instead of a host pre-pass over the same rows). A producer's
    error (a reader's, a parse worker's) is raised again here."""
    from ..utils.metrics import collector

    if shardings is not None:
        raise _not_ported("a sharded tile pipeline (shardings=)")
    dev = resolve_device(device)
    traced = bool(collector.enabled)
    anchor = collector.trace.current() if traced else None
    depth = max(1, int(prefetch)) if prefetch else tile_prefetch_depth()
    stats = TilePlaneStats(tile_rows, label, prefetch=depth)
    # handed over before any pipeline thread exists: a sharded source's
    # parse workers parent their tile_parse spans to the same span
    source.set_span_anchor(anchor)
    t_pass = time.perf_counter()
    consumer = _Consumer(step, first_tile, sink, stats, traced, anchor,
                         carry0, dev)
    if not tileplane_enabled():
        return _run_sync(source, consumer, tile_rows=tile_rows,
                         stats=stats, traced=traced, anchor=anchor,
                         t_pass=t_pass, device=dev, depth=depth)
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    lander = _TileLander(dev, depth + 1, copy_stream, f"{label} tile")
    q: "queue.Queue" = queue.Queue(maxsize=depth + 1)
    # `depth` copy slots, each released when a tile is DEQUEUED: while
    # tile k computes, tiles k+1..k+depth may be landed ahead
    copy_slot = threading.Semaphore(depth)
    stop = threading.Event()
    th = threading.Thread(
        target=_producer, args=(source, tile_rows, q, copy_slot, stop,
                                stats, lander, traced, anchor),
        name=f"tileplane-{label}", daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            if isinstance(item, tuple) and len(item) == 2 \
                    and isinstance(item[0], str) and item[0] == "__error__":
                raise item[1]
            tiles, ev, n_valid, k = item
            copy_slot.release()  # tile accepted: the producer may land k+1
            consumer.feed(tiles, ev, n_valid, k)
        consumer.flush()
    finally:
        stop.set()
        # drain so a producer blocked on put/acquire observes the flag
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=_JOIN_DEADLINE_S)
    stats.pinned_slots = lander.pinned_allocs
    return consumer.carry, _finish_pass(stats, traced, t_pass)


def _run_sync(source: RowSource, consumer: _Consumer, *, tile_rows: int,
              stats: TilePlaneStats, traced: bool, anchor, t_pass: float,
              device: torch.device, depth: int
              ) -> Tuple[Any, TilePlaneStats]:
    """TMOG_TILEPLANE=0: the identical pass on ONE thread — the same tiles
    (shared assembly), the same step, sink and spans, each tile landed on
    the compute stream itself, so copy and compute never overlap."""
    from ..utils.metrics import collector
    lander = _TileLander(device, depth + 1, None, f"{stats.label} tile")
    tiles = iter_fixed_tiles(source, tile_rows, stats,
                             lander.alloc if lander.cuda else None)
    try:
        for k, (tile, n_valid) in enumerate(tiles):
            t0 = time.perf_counter()
            dev, ev = lander.land(tile)
            stats.copy_bytes += int(sum(a.nbytes for a in tile))
            if traced:
                if ev is not None:
                    ev.synchronize()
                _copy_span(collector, stats, anchor, k, n_valid, tile,
                           time.perf_counter() - t0)
            consumer.feed(dev, ev, n_valid, k)
        consumer.flush()
    finally:
        tiles.close()
    stats.pinned_slots = lander.pinned_allocs
    return consumer.carry, _finish_pass(stats, traced, t_pass)


# -- generic pipelined producer/consumer (record-batch consumers) ------------

def pipelined(produce: Iterable[Any], *, label: str = "tileplane",
              depth: Optional[int] = None) -> Iterator[Any]:
    """Run `produce` (any host-side iterable — e.g. records -> fixed-size
    Dataset tiles for bulk scoring) on a background thread with a
    `depth`-deep queue, yielding its items on the caller's thread; an
    error in `produce` is raised here. Items are produced at most
    `depth` ahead (None: tile_prefetch_depth())."""
    d = max(1, int(depth)) if depth else tile_prefetch_depth()
    q: "queue.Queue" = queue.Queue(maxsize=d)
    stop = threading.Event()

    def body():
        try:
            for item in produce:
                if not _put(q, (None, item), stop):
                    return
            _put(q, _SENTINEL, stop)
        except BaseException as e:
            _put(q, (e, None), stop)

    th = threading.Thread(target=body, name=f"tileplane-{label}",
                          daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            err, value = item
            if err is not None:
                raise err
            yield value
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        th.join(timeout=_JOIN_DEADLINE_S)
