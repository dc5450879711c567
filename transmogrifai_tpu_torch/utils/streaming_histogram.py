"""Ben-Haim / Tom-Tov streaming histogram (counterpart of
utils/streaming_histogram.py; host Python, the same bins).

Reference: utils/src/main/java/com/salesforce/op/utils/stats/
StreamingHistogram.java (299 LoC, the reference's only Java file) +
RichStreamingHistogram.scala — a fixed-size mergeable histogram sketch
(merge the two closest centroids when over capacity) used for feature
distributions. Mergeability is what made it Spark-reduce-friendly; here the
same property makes it the host-side sketch for >HBM streams feeding
RawFeatureFilter.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence, Tuple


class StreamingHistogram:
    """At most `max_bins` (centroid, count) pairs, kept sorted."""

    def __init__(self, max_bins: int = 100):
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.max_bins = int(max_bins)
        self._p: List[float] = []   # centroids (sorted)
        self._m: List[float] = []   # counts

    # -- updates ------------------------------------------------------------
    def update(self, value: float, count: float = 1.0) -> "StreamingHistogram":
        i = bisect.bisect_left(self._p, value)
        if i < len(self._p) and self._p[i] == value:
            self._m[i] += count
        else:
            self._p.insert(i, float(value))
            self._m.insert(i, float(count))
            self._compress()
        return self

    def update_all(self, values: Iterable[float]) -> "StreamingHistogram":
        for v in values:
            self.update(float(v))
        return self

    def merge(self, other: "StreamingHistogram") -> "StreamingHistogram":
        """Union of sketches (the treeAggregate combine step)."""
        out = StreamingHistogram(max(self.max_bins, other.max_bins))
        for p, m in sorted(zip(self._p + other._p, self._m + other._m)):
            i = bisect.bisect_left(out._p, p)
            if i < len(out._p) and out._p[i] == p:
                out._m[i] += m
            else:
                out._p.insert(i, p)
                out._m.insert(i, m)
        out._compress()
        return out

    def _compress(self) -> None:
        while len(self._p) > self.max_bins:
            # merge the pair with the smallest centroid gap (BHTT rule)
            gaps = [self._p[i + 1] - self._p[i]
                    for i in range(len(self._p) - 1)]
            i = min(range(len(gaps)), key=gaps.__getitem__)
            m = self._m[i] + self._m[i + 1]
            self._p[i] = (self._p[i] * self._m[i]
                          + self._p[i + 1] * self._m[i + 1]) / m
            self._m[i] = m
            del self._p[i + 1]
            del self._m[i + 1]

    # -- queries ------------------------------------------------------------
    def bins(self) -> List[Tuple[float, float]]:
        return list(zip(self._p, self._m))

    def total(self) -> float:
        return sum(self._m)

    def sum_to(self, b: float) -> float:
        """Estimated count of points <= b (reference `sum` procedure:
        trapezoidal interpolation within the straddling bin)."""
        if not self._p:
            return 0.0
        if b < self._p[0]:
            return 0.0
        if b >= self._p[-1]:
            return self.total()
        i = bisect.bisect_right(self._p, b) - 1
        p_i, p_j = self._p[i], self._p[i + 1]
        m_i, m_j = self._m[i], self._m[i + 1]
        frac = (b - p_i) / (p_j - p_i)
        m_b = m_i + (m_j - m_i) * frac
        s = (m_i + m_b) * frac / 2.0
        return sum(self._m[:i]) + m_i / 2.0 + s

    def quantile(self, q: float) -> float:
        """Inverse of sum_to by bisection over the centroid span."""
        if not self._p:
            return 0.0
        target = q * self.total()
        lo, hi = self._p[0], self._p[-1]
        for _ in range(64):
            mid = (lo + hi) / 2.0
            if self.sum_to(mid) < target:
                lo = mid
            else:
                hi = mid
        return (lo + hi) / 2.0

    def density(self, edges: Sequence[float]) -> List[float]:
        """Histogram mass between consecutive edges (for JS-divergence
        against a fixed binning)."""
        out = []
        prev = self.sum_to(edges[0])
        for e in edges[1:]:
            cur = self.sum_to(e)
            out.append(max(cur - prev, 0.0))
            prev = cur
        return out
