"""Feature sketches: numeric histograms and crc32 hash bins (counterpart of
filters/sketches.py).

RawFeatureFilter (raw_feature_filter.py) sketches every raw feature
through these helpers. All numeric columns sketch together: one pass of
the statistics engine (ops/stats_engine.py) over the stacked [n, K] f32
matrix gives counts, nulls, min, max and sums, and every column bins with
the rule of ops/stats.hist_bin_ids — in the same pass when every range is
pinned up front (the scoring side, from the train-side Summary), else in
one `histogram_batched` call after it. Text, list and map values hash into
the same fixed bin space on the host (reference textBinsFormula:581).
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset
from ..device import DeviceLike, resolve_device, to_device
from ..types import ColumnKind

EPS = 1e-12
NUMERIC_KINDS = (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL)


def _normalize(h) -> Optional[np.ndarray]:
    """Histogram -> probability vector; None when the side is all-zero."""
    p = np.asarray(h, np.float64)
    s = p.sum()
    if not np.isfinite(s) or s <= 0.0:
        return None
    return p / s


def js_divergence_hist(p, q) -> float:
    """Jensen-Shannon divergence of two histograms scaled to [0, 1] (nats /
    ln 2); 0.0 when either side is all-zero (the JAX package's
    monitor/drift.js_divergence_hist)."""
    pn, qn = _normalize(p), _normalize(q)
    if pn is None or qn is None:
        return 0.0
    m = 0.5 * (pn + qn)

    def kl(a: np.ndarray) -> float:
        mask = a > 0
        return float(np.sum(a[mask] * np.log(a[mask] / m[mask])))

    nats = float(np.clip(0.5 * kl(pn) + 0.5 * kl(qn), 0.0, np.log(2.0)))
    return nats / float(np.log(2.0))


@dataclass
class FeatureDistribution:
    """Reference FeatureDistribution.scala:58 — per (feature[, map key])
    sketch: counts, nulls, histogram over `bins` buckets, numeric summary."""

    name: str
    key: Optional[str]          # map key, or None for plain features
    count: int
    nulls: int
    distribution: List[float]   # histogram mass per bin (unnormalized)
    summary: List[float]        # [min, max, sum, count] (reference Summary)

    def fill_rate(self) -> float:
        """Reference FeatureDistribution.fillRate:92."""
        return 0.0 if self.count == 0 else (self.count - self.nulls) / self.count

    def relative_fill_rate(self, other: "FeatureDistribution") -> float:
        return abs(self.fill_rate() - other.fill_rate())

    def relative_fill_ratio(self, other: "FeatureDistribution") -> float:
        a, b = self.fill_rate(), other.fill_rate()
        lo, hi = min(a, b), max(a, b)
        return float("inf") if lo == 0.0 else hi / lo

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence of the normalized histograms (reference
        FeatureDistribution.jsDivergence:138), scaled to [0, 1]; an all-zero
        side reports 0.0."""
        return js_divergence_hist(self.distribution, other.distribution)

    def to_json(self) -> Dict[str, Any]:
        return {"name": self.name, "key": self.key, "count": self.count,
                "nulls": self.nulls, "distribution": list(self.distribution),
                "summary": list(self.summary)}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "FeatureDistribution":
        return FeatureDistribution(
            name=d["name"], key=d.get("key"), count=int(d["count"]),
            nulls=int(d["nulls"]),
            distribution=[float(x) for x in d["distribution"]],
            summary=[float(x) for x in d.get("summary", [])])


def numeric_distributions_batched(items, bins: int, ranges,
                                  device: DeviceLike = None
                                  ) -> List[FeatureDistribution]:
    """Sketch EVERY numeric column through one engine pass on `device`.

    Histogram ranges come from the provided train-side Summary where
    present, else from that same pass's min/max. When every range is
    pinned up front the histograms ride the engine pass itself; otherwise
    one histogram_batched call bins all columns together.

    Missing means NaN only (FeatureDistribution convention): the engine
    masks on isfinite, so the rare +/-inf-bearing columns get their
    count/sum/range corrected on the host (inf is a valid value; sums and
    ranges go infinite, histogram mass clips into the edge bins)."""
    from ..ops import stats_engine as SE
    from ..ops.stats import histogram_batched

    dev = resolve_device(device)
    names = [nm for nm, col in items]
    V = np.stack([np.asarray(col.data, np.float32) for _, col in items],
                 axis=1)
    n = V.shape[0]
    Vt = to_device(V, dev, label="rff sketch") if n else None
    has_inf = bool(np.isinf(V).any()) if n else False
    provided = [ranges.get(nm) for nm in names]
    all_pinned = all(r is not None for r in provided)
    zeros = torch.zeros(n, device=dev)
    if all_pinned and n and not has_inf:
        lo = np.asarray([r[0] for r in provided], np.float32)
        hi = np.asarray([r[1] for r in provided], np.float32)
        st = SE.run_stats(Vt, zeros, lo=lo, hi=hi, bins=bins, device=dev)
        hist = st.hist
    else:
        st = SE.run_stats(Vt, zeros, device=dev) if n else None
        lo = np.asarray(
            [r[0] if r is not None else
             (st.min[k] if st is not None and st.count[k] > 0 else 0.0)
             for k, r in enumerate(provided)], np.float32)
        hi = np.asarray(
            [r[1] if r is not None else
             (st.max[k] if st is not None and st.count[k] > 0 else 0.0)
             for k, r in enumerate(provided)], np.float32)
        hist = None  # binned below, after any inf range corrections

    counts = st.count.copy() if st is not None else np.zeros(len(names))
    sums = (st.mean * st.count if st is not None
            else np.zeros(len(names)))
    los, his = lo.astype(np.float64), hi.astype(np.float64)
    if has_inf and st is not None:
        # inf-bearing columns (valid, not missing), corrected BEFORE
        # binning so the histogram sees the corrected ranges
        for k in np.flatnonzero(np.isinf(V).any(axis=0)):
            col = V[:, k].astype(np.float64)
            valid = col[~np.isnan(col)]
            counts[k] = len(valid)
            sums[k] = valid.sum() if len(valid) else 0.0
            if provided[k] is None and len(valid):
                los[k], his[k] = valid.min(), valid.max()
    if hist is None:
        hist = (histogram_batched(
            Vt, torch.as_tensor(los.astype(np.float32)),
            torch.as_tensor(his.astype(np.float32)), bins).cpu().numpy()
            if n else np.zeros((len(names), bins + 1)))

    out = []
    for k, nm in enumerate(names):
        cnt = int(counts[k])
        if cnt == 0:
            out.append(FeatureDistribution(nm, None, n, n, [0.0] * bins,
                                           [0.0, 0.0, 0.0, 0.0]))
            continue
        out.append(FeatureDistribution(
            nm, None, n, n - cnt,
            [float(v) for v in hist[k, :bins]],
            [float(los[k]), float(his[k]), float(sums[k]), float(cnt)]))
    return out


def hash_bin(value: Any, bins: int) -> int:
    """Stable host-side hash of a non-numeric value into [0, bins)
    (reference hashes text into bins, RawFeatureFilter textBinsFormula:581)."""
    s = value if isinstance(value, str) else repr(value)
    return zlib.crc32(s.encode("utf-8")) % bins


def is_empty(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    if isinstance(v, (str, list, tuple, set, dict)) and len(v) == 0:
        return True
    return False


def hash_hist_update(hist: np.ndarray, v: Any) -> bool:
    """Accumulate ONE non-empty object value into a crc32 hash-bin table
    (list-likes hash per item, everything else hashes whole). Returns False
    without touching `hist` when the value is empty or missing — the
    caller counts nulls."""
    if is_empty(v):
        return False
    bins = len(hist)
    if isinstance(v, (list, tuple, set)):
        for item in v:
            hist[hash_bin(item, bins)] += 1.0
    else:
        hist[hash_bin(v, bins)] += 1.0
    return True


def dist_object(name: str, data: np.ndarray, bins: int,
                key: Optional[str] = None) -> FeatureDistribution:
    n = len(data)
    hist = np.zeros(bins, np.float64)
    nulls = 0
    for v in data:
        if not hash_hist_update(hist, v):
            nulls += 1
    return FeatureDistribution(name, key, n, nulls, hist.tolist(),
                               [0.0, 0.0, float(hist.sum()), float(n - nulls)])


def map_key_distributions(name: str, data: np.ndarray, bins: int
                          ) -> List[FeatureDistribution]:
    """Per-key sketches for a map column (reference drops individual keys)."""
    n = len(data)
    per_key_hist: Dict[str, np.ndarray] = {}
    per_key_present: Dict[str, int] = {}
    for v in data:
        if not isinstance(v, dict):
            continue
        for k, item in v.items():
            if is_empty(item):
                continue
            h = per_key_hist.setdefault(k, np.zeros(bins, np.float64))
            if isinstance(item, (int, float, bool)):
                h[hash_bin(f"{float(item):.6g}", bins)] += 1.0
            elif isinstance(item, (list, tuple, set)):
                for x in item:
                    h[hash_bin(x, bins)] += 1.0
            else:
                h[hash_bin(item, bins)] += 1.0
            per_key_present[k] = per_key_present.get(k, 0) + 1
    return [
        FeatureDistribution(name, k, n, n - per_key_present[k],
                            per_key_hist[k].tolist(),
                            [0.0, 0.0, float(per_key_hist[k].sum()),
                             float(per_key_present[k])])
        for k in sorted(per_key_hist)
    ]


def compute_distributions(ds: Dataset, names: Sequence[str], bins: int,
                          ranges: Optional[Dict[str, Tuple[float, float]]]
                          = None, device: DeviceLike = None
                          ) -> List[FeatureDistribution]:
    """Sketch every named raw column (reference computeFeatureStats).

    `ranges` pins per-feature histogram bounds (pass the train-side summary
    bounds when sketching scoring data). Numeric columns sketch together in
    one engine pass on `device`; map columns sketch per key and whole."""
    numeric_items = [(name, ds.column(name)) for name in names
                     if name in ds and ds.column(name).kind in NUMERIC_KINDS]
    by_name: Dict[str, FeatureDistribution] = {}
    if numeric_items:
        by_name = {d.name: d for d in numeric_distributions_batched(
            numeric_items, bins, ranges or {}, device)}

    out: List[FeatureDistribution] = []
    for name in names:
        if name not in ds:
            continue
        col = ds.column(name)
        if col.kind in NUMERIC_KINDS:
            out.append(by_name[name])
        elif col.kind == ColumnKind.MAP:
            out.extend(map_key_distributions(name, col.data, bins))
            # whole-map sketch for feature-level fill decisions
            out.append(dist_object(name, col.data, bins))
        else:
            out.append(dist_object(name, col.data, bins))
    return out
