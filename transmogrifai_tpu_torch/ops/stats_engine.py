"""One-pass statistics engine for the SanityChecker (counterpart of
ops/stats_engine.py).

A single read of X accumulates every sufficient statistic the
SanityChecker needs, tile by tile on the device:

- per-column weighted count / mean / M2 / min / max / nnz: exact two-pass
  moments WITHIN a row tile, Chan's parallel merge ACROSS tiles (no
  catastrophic f32 cancellation for large-mean columns, unlike raw
  E[x^2] - mean^2). The moments are taken of the values less the first
  tile's column means (the shift), which keeps the tile means, and the
  merge's cross terms, precise for columns with large means;
- label co-moments and per-column-masked label moments with the same
  merge, giving pairwise-complete Pearson correlations with the label;
- the capped feature-feature Gram for the full Pearson matrix, of the
  same shifted values so its accumulators stay cancellation-safe (a plain
  `torch.matmul` per tile, in float64: the f32 product sums each cell's
  terms in one long chain);
- every categorical contingency table as one float64 product per tile
  against a one-hot of the label built per tile from the distinct label
  values (exact counts past 2^24 rows);
- whole-label moments (count / mean / variance / min / max);
- with `lo`, `hi` and `bins`, every column's fixed-range histogram in the
  same pass (RawFeatureFilter's numeric sketches): the binning rule of
  ops/stats.hist_bin_ids with the engine's finite-only validity mask, the
  rows' weights summed per tile with a float64 `torch.bincount`.

Two drivers, routed by `run_stats`:

- `fused_stats` — the matrix on the device in one piece (or already
  there), one loop over row tiles with the state merged on the device;
- `stream_stats` — a host matrix larger than `STREAM_THRESHOLD_BYTES`, or
  a `parallel.tileplane.RowSource` whose chunks yield (x, y, w) (the
  CSV / Avro readers through parallel/ingest.py), flows through the
  double-buffered tileplane in fixed tiles: each tile's state is merged
  in float64 into a carry that stays on the device and is fetched once
  at the end, so the matrix never lies on the device, or for a source
  anywhere, whole. `TMOG_TILEPLANE=0` runs the same tiles and the same
  merges on the caller's thread, with the same bits.

`rank_matrices` is Spearman's rank pre-pass (tie-aware average ranks,
the label re-ranked within each column's valid rows), fed back through the
same moment engine. Not ported: the mesh-sharded driver and the
multi-pass legacy route.
"""
from __future__ import annotations

import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..utils.metrics import collector
from . import stats as S

EPS = 1e-12

# Rows per row tile: bounds the [c, d] f32 tile transients at ~32MB.
_TILE_BUDGET_BYTES = 32 << 20

# Widest matrix for which the full d x d Pearson Gram is accumulated (the
# consumers cap far below: SanityChecker max_corr_matrix_columns, 256).
GRAM_MAX_D = 1024

# A host matrix larger than this takes the streamed driver (4 GiB).
STREAM_THRESHOLD_BYTES = 4096 << 20

# Rows per streamed tile of a host matrix (the JAX package's hand default;
# its planner, which may move it from measurements, is not ported).
STREAM_TILE_ROWS = 1 << 18

# route, rows, columns, tiles and wall seconds of the last run_stats pass
last_pass: Dict[str, Any] = {}

# the last streamed pass's pipeline stats (parallel.tileplane.
# TilePlaneStats: rows, tiles, peak host rows, copy/compute seconds)
_last_stream_stats = None


def stats_row_block(d: int, n: int) -> int:
    c = _TILE_BUDGET_BYTES // max(4 * d, 1)
    c = max(min(c, 1 << 16), 1024)
    return max(min(c, n), 1)


class FusedStats(NamedTuple):
    """Host-side (numpy) results of one engine pass.

    Per-column arrays are [d]; `m2` is the raw centered second moment.
    `corr_matrix` and `contingency` ([d, C] against the distinct label
    values, columns optionally clipped to 1 for multi-hot groups) and
    `hist` ([d, bins + 1]; last bin = missing mass) are None unless
    requested."""

    count: np.ndarray
    mean: np.ndarray
    variance: np.ndarray
    m2: np.ndarray
    min: np.ndarray
    max: np.ndarray
    num_non_zeros: np.ndarray
    fill_rate: np.ndarray
    corr_label: np.ndarray
    wsum: float
    label_count: float
    label_mean: float
    label_variance: float
    label_min: float
    label_max: float
    corr_matrix: Optional[np.ndarray] = None
    contingency: Optional[np.ndarray] = None
    hist: Optional[np.ndarray] = None


class _State(NamedTuple):
    """Mergeable sufficient-statistics state (device tensors or host
    arrays). Moment fields are Chan-mergeable; the rest merge by
    elementwise min / max / sum. Optional members are None when their
    statistic was not requested."""

    wsum: Any
    cnt: Any          # [d] valid weighted count
    mean: Any         # [d] mean less the pass's shift
    m2: Any           # [d]
    cy: Any           # [d] co-moment of column with label (column-masked)
    ymean: Any        # [d] label mean over column-valid rows
    ym2: Any          # [d]
    minv: Any         # [d]
    maxv: Any         # [d]
    nnz: Any          # [d]
    ycnt: Any         # scalar: label moments over finite-label rows
    lmean: Any
    lm2: Any
    lmin: Any
    lmax: Any
    gzz: Any = None   # [d, d] shift-centered Gram accumulators (f64)
    gzv: Any = None
    gvv: Any = None
    cont: Any = None  # [d, C] (f64)
    hist: Any = None  # [d, bins + 1] (f64)


def _chan_merge(nA, mA, m2A, nB, mB, m2B):
    """Chan/Welford parallel merge of weighted (count, mean, M2)."""
    n = nA + nB
    safe = torch.clamp(n, min=EPS)
    delta = mB - mA
    mean = mA + delta * (nB / safe)
    m2 = m2A + m2B + delta * delta * (nA * nB / safe)
    return n, mean, m2


def _tile_state(xb, yb, wb, shift, distinct, clip, hist_range, *,
                bins: int, corr_matrix: bool, y2d: bool,
                big: float) -> _State:
    """Exact two-pass moments of ONE row tile, shaped as a _State ready
    for the Chan merge. Means are taken of the values less `shift` (the
    first tile's column means): an f32 mean of values near 1e4 is off by
    ~1e-3, and the merge's cross terms would carry that error into the
    co-moments."""
    finite = torch.isfinite(xb)
    v01 = finite.to(torch.float32)
    v = v01 * wb[:, None]                                  # [c, d]
    xz = torch.where(finite, xb, 0.0)
    z = (xz - shift[None, :]) * v01                        # shifted values
    cnt = v.sum(0)
    safe = torch.clamp(cnt, min=EPS)
    mean = (z * v).sum(0) / safe                           # shifted mean
    dx = z - mean[None, :]
    m2 = (dx * dx * v).sum(0)

    yz2 = yb if y2d else yb[:, None]
    yz2 = torch.where(torch.isfinite(yz2), yz2, 0.0)
    ymean = (yz2 * v).sum(0) / safe
    dy = yz2 - ymean[None, :]
    ym2 = (dy * dy * v).sum(0)
    cy = (dx * dy * v).sum(0)

    minv = torch.where(v > 0, xz, big).amin(0)
    maxv = torch.where(v > 0, xz, -big).amax(0)
    nnz = ((xz != 0) & (v > 0)).to(torch.float32).sum(0)
    wsum = wb.sum()

    scalar = xb.new_zeros(())
    if y2d:
        ycnt, lmean, lm2 = scalar, scalar, scalar
        lmin, lmax = scalar + big, scalar - big
    else:
        ok = torch.isfinite(yb)
        lv = ok.to(torch.float32) * wb
        yz = torch.where(ok, yb, 0.0)
        ycnt = lv.sum()
        lmean = (yz * lv).sum() / torch.clamp(ycnt, min=EPS)
        lm2 = (((yz - lmean) ** 2) * lv).sum()
        lmin = torch.where(lv > 0, yz, big).amin()
        lmax = torch.where(lv > 0, yz, -big).amax()

    # the products accumulate in float64: an f32 product sums each cell's
    # c terms in one long chain (~1e-5 of a correlation at 4k rows)
    f8 = torch.float64
    gzz = gzv = gvv = None
    if corr_matrix:
        z8, v8, w8 = z.to(f8), v01.to(f8), wb.to(f8)[:, None]
        gzz = (z8 * w8).T @ z8
        gzv = (z8 * w8).T @ v8
        gvv = (v8 * w8).T @ v8

    cont = None
    if distinct is not None:
        yoh = (yb[:, None] == distinct[None, :]).to(f8)
        xc = xz
        if clip is not None:
            xc = torch.where(clip[None, :], torch.clamp(xz, max=1.0), xz)
        cont = (xc * v).to(f8).T @ yoh

    hist = None
    if bins > 0:
        ids = S.hist_bin_ids(xb, *hist_range, bins, finite)
        hist = S.segment_hist(ids, xb.shape[1], bins, wb)

    return _State(wsum=wsum, cnt=cnt, mean=mean, m2=m2, cy=cy, ymean=ymean,
                  ym2=ym2, minv=minv, maxv=maxv, nnz=nnz, ycnt=ycnt,
                  lmean=lmean, lm2=lm2, lmin=lmin, lmax=lmax, gzz=gzz,
                  gzv=gzv, gvv=gvv, cont=cont, hist=hist)


def _merge_states(a: _State, b: _State) -> _State:
    """Chan-merge two device states."""
    cnt, mean, m2 = _chan_merge(a.cnt, a.mean, a.m2, b.cnt, b.mean, b.m2)
    safe = torch.clamp(cnt, min=EPS)
    dxm = b.mean - a.mean
    dym = b.ymean - a.ymean
    cross = a.cnt * b.cnt / safe
    ycnt, lmean, lm2 = _chan_merge(a.ycnt, a.lmean, a.lm2,
                                   b.ycnt, b.lmean, b.lm2)

    def add(x, y):
        return None if x is None else x + y
    return _State(
        wsum=a.wsum + b.wsum, cnt=cnt, mean=mean, m2=m2,
        cy=a.cy + b.cy + dxm * dym * cross,
        ymean=a.ymean + dym * (b.cnt / safe),
        ym2=a.ym2 + b.ym2 + dym * dym * cross,
        minv=torch.minimum(a.minv, b.minv), maxv=torch.maximum(a.maxv, b.maxv),
        nnz=a.nnz + b.nnz, ycnt=ycnt, lmean=lmean, lm2=lm2,
        lmin=torch.minimum(a.lmin, b.lmin), lmax=torch.maximum(a.lmax, b.lmax),
        gzz=add(a.gzz, b.gzz), gzv=add(a.gzv, b.gzv), gvv=add(a.gvv, b.gvv),
        cont=add(a.cont, b.cont), hist=add(a.hist, b.hist))


def _f64(st: _State) -> _State:
    """A device state in float64: the streamed carry's precision."""
    return _State(*[None if x is None else x.to(torch.float64)
                    for x in st])


def _fetch_state(st: _State) -> _State:
    return _State(*[None if x is None else x.cpu().numpy() for x in st])


def _first_tile_shift(X: torch.Tensor, w: torch.Tensor, c: int
                      ) -> torch.Tensor:
    """Per-column masked mean of the first `c` rows: the pass's shift."""
    xb = X[:c]
    finite = torch.isfinite(xb)
    v = finite.to(torch.float32) * w[:c, None]
    s = (torch.where(finite, xb, 0.0) * v).sum(0)
    n = v.sum(0)
    return torch.where(n > 0, s / torch.clamp(n, min=EPS), 0.0)


def _scan_state(X, y, w, distinct, clip, hist_range, *, bins: int,
                corr_matrix: bool, shift) -> _State:
    """Every row tile's state, merged on the device in row order."""
    n, d = X.shape
    big = float(np.finfo(np.float32).max)
    c = stats_row_block(d, n)
    st = None
    for a in range(0, n, c):
        ts = _tile_state(X[a:a + c], y[a:a + c], w[a:a + c], shift,
                         distinct, clip, hist_range, bins=bins,
                         corr_matrix=corr_matrix,
                         y2d=y.dim() == 2, big=big)
        st = ts if st is None else _merge_states(st, ts)
    return st


def _extras(distinct, clip, dev):
    return (None if distinct is None else
            torch.as_tensor(np.asarray(distinct, np.float32), device=dev),
            None if clip is None else
            torch.as_tensor(np.asarray(clip, bool), device=dev))


def _hist_range(lo, hi, bins: int, dev):
    """The (lo, hi) f32 tensors of the in-pass histograms, or None."""
    if (lo is None) != (bins == 0) or (lo is None) != (hi is None):
        raise ValueError("histograms need both bins>0 and lo/hi ranges")
    if lo is None:
        return None
    return to_device(lo, dev), to_device(hi, dev)


def fused_stats(X, y, w=None, *, distinct=None, clip=None, lo=None,
                hi=None, bins: int = 0, corr_matrix: bool = False,
                device: DeviceLike = None) -> Tuple[_State, torch.Tensor]:
    """One-pass sufficient statistics of X in one piece on the device.

    X [n, d] (NaN = missing); y [n] label or [n, d] per-column label (rank
    mode); w [n] row weights (None = 1). distinct [C] enables the
    contingency accumulation (clip [d] bool marks multi-hot columns counted
    at most once); (lo, hi, bins) enables the in-pass histograms. Returns
    the raw (device state, shift) pair; `run_stats` is the finalizing
    front door."""
    dev = resolve_device(device)
    X = to_device(X, dev, label="stats")
    y = to_device(y, dev, label="stats label")
    n, d = X.shape
    if corr_matrix and d > GRAM_MAX_D:
        raise ValueError(f"corr_matrix capped at {GRAM_MAX_D} columns "
                         f"(got {d}); the consumers cap far below")
    hist_range = _hist_range(lo, hi, bins, dev)
    w = torch.ones(n, device=dev) if w is None else to_device(w, dev)
    distinct, clip = _extras(distinct, clip, dev)
    shift = _first_tile_shift(X, w, stats_row_block(d, n))
    return _scan_state(X, y, w, distinct, clip, hist_range, bins=bins,
                       corr_matrix=corr_matrix, shift=shift), shift


def _stream_source(X, y, w, tile_rows: Optional[int]):
    """(source, tile_rows, d) for the streamed driver. X is a
    parallel.tileplane.RowSource yielding (x, y, w) chunks (y and w then
    None) or a host matrix with its y and w arrays."""
    from ..parallel import tileplane as TP

    if isinstance(X, TP.RowSource):
        if y is not None or w is not None:
            raise ValueError("pass y/w inside the RowSource chunks")
        d = int(X.peek()[0].shape[1])
        c = int(tile_rows) if tile_rows else TP.tile_rows_for(4 * d,
                                                              X.n_rows)
        return X, c, d
    X = np.asarray(X)
    n, d = X.shape
    w = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
    c = int(tile_rows or min(STREAM_TILE_ROWS, max(n, 1)))
    return TP.ArraySource(X, np.asarray(y, np.float32), w,
                          chunk_rows=c), c, d


def stream_stats(X, y=None, w=None, *, tile_rows: Optional[int] = None,
                 distinct=None, clip=None, lo=None, hi=None, bins: int = 0,
                 corr_matrix: bool = False, mesh=None,
                 prefetch: Optional[int] = None,
                 device: DeviceLike = None) -> Tuple[_State, np.ndarray]:
    """Streamed driver for data larger than the device's memory.

    X is a host matrix (with y and w arrays) or a `tileplane.RowSource`
    whose chunks yield (x, y, w), so the matrix need never materialize
    anywhere. Fixed tiles flow through the double-buffered tileplane onto
    `device` (None: CUDA): the producer lands tile k+1 while the device
    folds tile k into the carry, whose state is merged in float64 and
    fetched once at the end. The Gram shift comes from the first tile, on
    the device. Exactly one read of every row per pass; `prefetch` is the
    ring depth (bit-identical at any depth and under TMOG_TILEPLANE=0).
    `mesh` (the JAX package's sharded tile lane) is not ported. Returns
    (merged host state in float64, shift)."""
    from ..parallel import tileplane as TP

    global _last_stream_stats
    if mesh is not None:
        raise TP._not_ported("the mesh-sharded streamed statistics pass")
    dev = resolve_device(device)
    source, c, d = _stream_source(X, y, w, tile_rows)
    if corr_matrix and d > GRAM_MAX_D:
        raise ValueError(f"corr_matrix capped at {GRAM_MAX_D} columns")
    hist_range = _hist_range(lo, hi, bins, dev)
    distinct, clip = _extras(distinct, clip, dev)

    def first_tile(carry, xt, yt, wt):
        return carry[0], _first_tile_shift(xt, wt, xt.shape[0])

    def step(carry, xt, yt, wt):
        st, shift = carry
        ts = _f64(_scan_state(xt, yt, wt, distinct, clip, hist_range,
                              bins=bins, corr_matrix=corr_matrix,
                              shift=shift))
        return (ts if st is None else _merge_states(st, ts)), shift

    (st, shift), ps = TP.run_tileplane(
        source, step, (None, None), tile_rows=c, label="stats",
        first_tile=first_tile, prefetch=prefetch, device=dev)
    _last_stream_stats = ps
    if st is None:
        raise ValueError("empty row source")
    # the ONE fetch of the pass
    return _fetch_state(st), shift.cpu().numpy()


def _finalize(st: _State, shift, bins: int = 0) -> FusedStats:
    """Moment state -> FusedStats. Host numpy in f64: the state is
    [d] / [d, d] shaped, and f64 keeps the final divisions exact (the
    unbiased variance clamp and EPS-guarded correlation denominators of
    ops/stats)."""
    def f8(x):
        return np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor)
                          else x, np.float64)

    cnt, m2 = f8(st.cnt), f8(st.m2)
    mean = f8(st.mean) + f8(shift)
    cy, ym2 = f8(st.cy), f8(st.ym2)
    wsum = float(f8(st.wsum))
    variance = np.maximum(m2 / np.maximum(cnt - 1.0, 1.0), 0.0)
    corr = cy / np.sqrt(np.maximum(m2 * ym2, EPS * EPS))
    ycnt = float(f8(st.ycnt))

    corr_matrix = None
    if st.gzz is not None:
        gzz, gzv, gvv = f8(st.gzz), f8(st.gzv), f8(st.gvv)
        a = f8(st.mean)
        cov = gzz - gzv * a[None, :] - (gzv * a[None, :]).T \
            + np.outer(a, a) * gvv
        sd = np.sqrt(np.maximum(np.diag(cov), EPS))
        corr_matrix = cov / (sd[:, None] * sd[None, :])

    return FusedStats(
        count=cnt, mean=mean, variance=variance, m2=m2,
        min=f8(st.minv), max=f8(st.maxv), num_non_zeros=f8(st.nnz),
        fill_rate=cnt / max(wsum, EPS), corr_label=corr, wsum=wsum,
        label_count=ycnt, label_mean=float(f8(st.lmean)),
        label_variance=float(max(f8(st.lm2) / max(ycnt - 1.0, 1.0), 0.0)),
        label_min=float(f8(st.lmin)), label_max=float(f8(st.lmax)),
        corr_matrix=corr_matrix,
        contingency=None if st.cont is None else f8(st.cont),
        hist=None if st.hist is None else f8(st.hist).reshape(-1, bins + 1))


def stats_pass_bytes(n: int, d: int, *, itemsize: int = 4,
                     y2d: bool = False, weighted: bool = False) -> int:
    """Analytic HBM bytes of one engine pass: one read of X, the label (a
    second [n, d] plane in the 2-D-label mode of the rank pass) and the
    optional weights; the [d]-shaped outputs are noise at any n worth
    measuring."""
    b = n * d * itemsize
    b += n * d * 4 if y2d else n * 4
    if weighted:
        b += n * 4
    return int(b)


# (driver, n, d, bins, corr_matrix, distinct, 2-D label) of the passes this
# process has run: the first pass of a shape is cold (its wall includes the
# allocator's first growth)
_seen_shapes: set = set()


def run_stats(X, y=None, w=None, *, distinct=None, clip=None, lo=None,
              hi=None, bins: int = 0, corr_matrix: bool = False,
              driver: Optional[str] = None, tile_rows: Optional[int] = None,
              mesh=None, label: str = "stats",
              device: DeviceLike = None) -> FusedStats:
    """One engine pass, finalized. `driver` in {"fused", "streamed"}
    forces a route; otherwise a `tileplane.RowSource` (chunks of (x, y,
    w)) or a host matrix larger than STREAM_THRESHOLD_BYTES streams and
    everything else takes the fused route. (lo, hi, bins) adds each
    column's fixed-range histogram (`FusedStats.hist`). The route, shape
    and wall of the pass land in `last_pass`; a streamed pass's pipeline
    stats in `_last_stream_stats`. `mesh` is not ported."""
    from ..parallel.tileplane import RowSource, _not_ported

    if mesh is not None:
        raise _not_ported("the mesh-sharded statistics pass")
    src_mode = isinstance(X, RowSource)
    if src_mode:
        driver, y2d = "streamed", False
    else:
        n, d = X.shape
        y2d = getattr(y, "ndim", 1) == 2
    if driver is None:
        driver = ("streamed" if isinstance(X, np.ndarray)
                  and X.nbytes > STREAM_THRESHOLD_BYTES else "fused")
    dev = resolve_device(device)
    kw = dict(distinct=distinct, clip=clip, lo=lo, hi=hi, bins=int(bins),
              corr_matrix=corr_matrix, device=dev)
    t0 = time.perf_counter()
    if driver == "streamed":
        st, shift = stream_stats(X, None if src_mode else np.asarray(y),
                                 w, tile_rows=tile_rows, **kw)
        ps = _last_stream_stats
        n, d, tiles = ps.rows, int(np.asarray(st.cnt).shape[0]), ps.tiles
    elif driver == "fused":
        st, shift = fused_stats(X, y, w, **kw)
        tiles = -(-n // stats_row_block(d, n))
    else:
        raise ValueError(f"unknown statistics driver {driver!r}")
    out = _finalize(st, shift, int(bins))
    wall = time.perf_counter() - t0
    last_pass.clear()
    last_pass.update(driver=driver, rows=int(n), cols=int(d),
                     tiles=int(tiles), seconds=wall)
    key = (driver, n, d, int(bins), corr_matrix, distinct is not None, y2d)
    collector.stats_pass(driver=driver, rows=int(n), cols=int(d),
                         tiles=int(tiles),
                         bytes_hbm=float(stats_pass_bytes(
                             n, d, y2d=y2d, weighted=w is not None)),
                         wall_seconds=wall, cold=key not in _seen_shapes,
                         label=label, device=dev)
    _seen_shapes.add(key)
    return out


# -- spearman rank pre-pass --------------------------------------------------

def _ranks(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Average (tie-aware) ranks along the LAST axis, scipy.stats.rankdata
    'average' semantics; invalid entries rank NaN. Tie groups come from two
    searchsorteds over the sorted values."""
    xk = torch.where(valid, x, float("inf"))
    xs, order = torch.sort(xk, dim=-1, stable=True)
    lo = torch.searchsorted(xs, xs, side="left")
    hi = torch.searchsorted(xs, xs, side="right")
    avg = (lo + hi + 1).to(x.dtype) / 2.0
    ranks = torch.empty_like(avg).scatter_(-1, order, avg)
    return torch.where(valid, ranks, float("nan"))


def rank_matrices(X, y, w=None, *, col_block: int = 128,
                  device: DeviceLike = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked rank pre-pass on the device: (Rx [n, d], Ry [n, d]) ready
    for the moment engine's 2-D-label mode. Each column ranks over its
    valid (finite, weighted) rows, and the label re-ranks within the same
    rows (pairwise-complete Spearman semantics)."""
    dev = resolve_device(device)
    X = to_device(X, dev, label="spearman ranks")
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    n, d = X.shape
    w = torch.ones(n, device=dev) if w is None else to_device(w, dev)
    rx_parts, ry_parts = [], []
    for s in range(0, d, col_block):
        xc = X[:, s:s + col_block].T.contiguous()           # [cb, n]
        valid = torch.isfinite(xc) & (w[None, :] > 0)
        rx_parts.append(_ranks(xc, valid).T)
        yb = torch.where(valid, y[None, :], float("nan"))
        ry_parts.append(_ranks(yb, valid & torch.isfinite(yb)).T)
    return torch.cat(rx_parts, 1), torch.cat(ry_parts, 1)


# -- contingency statistics (OpStatistics.scala) ----------------------------

class ContingencyStats(NamedTuple):
    chi2: float                 # chi-squared statistic
    cramers_v: float
    mutual_info: float          # natural log
    pointwise_mutual_info: np.ndarray  # [k, c]
    max_rule_confidences: np.ndarray   # [k] max_c P(c | row k)
    supports: np.ndarray        # [k] row support fraction


def contingency_stats_host(table) -> ContingencyStats:
    """Chi2 / Cramer's V / MI / PMI / max rule confidence of a [k, c] count
    table (ports OpStatistics.{chiSquaredTest:188, mutualInfo:234,
    maxConfidences:280, contingencyStats:300}); host numpy in f64 on the
    engine's tiny per-group tables."""
    t = np.asarray(table, dtype=np.float64)
    total = max(float(t.sum()), EPS)
    rows = t.sum(axis=1)
    cols = t.sum(axis=0)
    expected = rows[:, None] * cols[None, :] / total
    chi2 = float(np.where(expected > 0, (t - expected) ** 2
                          / np.maximum(expected, EPS), 0.0).sum())
    k = int((rows > 0).sum())
    c = int((cols > 0).sum())
    dof = max(min(k - 1, c - 1), 1)
    p = t / total
    pxy_ind = (rows / total)[:, None] * (cols / total)[None, :]
    pmi = np.where((p > 0) & (pxy_ind > 0),
                   np.log(np.maximum(p, EPS) / np.maximum(pxy_ind, EPS)),
                   0.0)
    conf = t / np.maximum(rows[:, None], EPS)
    return ContingencyStats(
        chi2=chi2, cramers_v=float(np.sqrt(chi2 / (total * dof))),
        mutual_info=float(np.where(p > 0, p * pmi, 0.0).sum()),
        pointwise_mutual_info=pmi, max_rule_confidences=conf.max(axis=1),
        supports=rows / total)
