"""Splitters: test holdout + class rebalancing (counterpart of
automl/tuning/splitters.py, the same numpy draws bit for bit).

Reference: core/.../impl/tuning/Splitter.scala:47 (reserveTestFraction 0.1),
DataSplitter.scala:62 (regression), DataBalancer.scala:73 (binary up/down
sampling to a target minority fraction, maxTrainingSample cap),
DataCutter.scala:76 (multiclass label cutting).

Splits are index/weight computations on the host label vector: balancing
emits a kept-row index set and per-row sample weights, which the model
selector applies to the feature matrix before the sweep.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclass
class PreparedData:
    """Training data after splitter preparation.

    indices: rows of the original train set to use (post up/down-sampling)
    weights: per-kept-row sample weights
    summary: what the splitter decided (recorded in ModelSelectorSummary)
    label_map: old label -> new contiguous label (multiclass cutting)
    """

    indices: np.ndarray
    weights: np.ndarray
    summary: Dict[str, Any] = field(default_factory=dict)
    label_map: Optional[Dict[int, int]] = None


class Splitter:
    """Base: reserve a test holdout fraction (reference Splitter.scala:57)."""

    def __init__(self, seed: int = 42, reserve_test_fraction: float = 0.1):
        if not 0.0 <= reserve_test_fraction < 1.0:
            raise ValueError("reserve_test_fraction must be in [0, 1)")
        self.seed = int(seed)
        self.reserve_test_fraction = float(reserve_test_fraction)

    def split(self, n_rows: int) -> Tuple[np.ndarray, np.ndarray]:
        """(train_indices, test_indices) — random holdout."""
        rng = np.random.default_rng(self.seed)
        perm = rng.permutation(n_rows)
        n_test = int(round(n_rows * self.reserve_test_fraction))
        return np.sort(perm[n_test:]), np.sort(perm[:n_test])

    def prepare(self, y: np.ndarray) -> PreparedData:
        """Rebalance/cut the (already holdout-split) train labels. Default:
        keep everything, unit weights."""
        n = len(y)
        return PreparedData(indices=np.arange(n), weights=np.ones(n, np.float32))

    def save_args(self) -> Dict[str, Any]:
        return {"kind": type(self).__name__, "seed": self.seed,
                "reserve_test_fraction": self.reserve_test_fraction}


class DataSplitter(Splitter):
    """Regression splitter: holdout only (reference DataSplitter.scala:62)."""


class DataBalancer(Splitter):
    """Binary-classification rebalancer (reference DataBalancer.scala:73).

    If the minority-class fraction is below ``sample_fraction``, downsample
    the majority (and/or upsample the minority) so the minority fraction
    reaches the target, respecting ``max_training_sample``. Already-balanced
    data is only subsampled if it exceeds ``max_training_sample``.
    """

    def __init__(self, seed: int = 42, reserve_test_fraction: float = 0.1,
                 sample_fraction: float = 0.1,
                 max_training_sample: int = 1_000_000):
        super().__init__(seed=seed, reserve_test_fraction=reserve_test_fraction)
        if not 0.0 < sample_fraction < 0.5:
            raise ValueError("sample_fraction must be in (0, 0.5)")
        self.sample_fraction = float(sample_fraction)
        self.max_training_sample = int(max_training_sample)

    def prepare(self, y: np.ndarray) -> PreparedData:
        rng = np.random.default_rng(self.seed)
        n = len(y)
        pos = np.flatnonzero(y == 1.0)
        neg = np.flatnonzero(y != 1.0)
        n_pos, n_neg = len(pos), len(neg)
        small, big = (pos, neg) if n_pos < n_neg else (neg, pos)
        s, b = len(small), len(big)
        f = self.sample_fraction
        summary: Dict[str, Any] = {
            "positive_count": int(n_pos), "negative_count": int(n_neg),
            "sample_fraction": f, "max_training_sample": self.max_training_sample,
        }

        if s == 0 or b == 0:
            summary["already_balanced"] = True
            return PreparedData(indices=np.arange(n),
                                weights=np.ones(n, np.float32), summary=summary)

        if s / n >= f:
            # already balanced: only cap total size (reference :230)
            summary["already_balanced"] = True
            if n > self.max_training_sample:
                keep = rng.choice(n, self.max_training_sample, replace=False)
                keep.sort()
                summary["down_sample_fraction"] = self.max_training_sample / n
                return PreparedData(indices=keep,
                                    weights=np.ones(len(keep), np.float32),
                                    summary=summary)
            return PreparedData(indices=np.arange(n),
                                weights=np.ones(n, np.float32), summary=summary)

        # target: s' / (s' + b') = f   (reference getProportions:84)
        summary["already_balanced"] = False
        max_train = self.max_training_sample
        big_target = s * (1.0 - f) / f      # keep small as-is, shrink big
        if s + big_target <= max_train:
            down = min(big_target / b, 1.0)
            up = 1.0
        else:
            # cap total at max_train while hitting fraction f
            small_target = max_train * f
            up = small_target / s
            down = (max_train * (1.0 - f)) / b
            down = min(down, 1.0)
        summary["down_sample_fraction"] = float(down)
        summary["up_sample_fraction"] = float(up)

        big_keep = rng.choice(big, max(int(round(b * down)), 1), replace=False)
        if up > 1.0:
            extra = rng.choice(small, int(round(s * (up - 1.0))), replace=True)
            small_keep = np.concatenate([small, extra])
        elif up < 1.0:
            small_keep = rng.choice(small, max(int(round(s * up)), 1),
                                    replace=False)
        else:
            small_keep = small
        idx = np.concatenate([small_keep, big_keep])
        idx.sort()
        return PreparedData(indices=idx, weights=np.ones(len(idx), np.float32),
                            summary=summary)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(sample_fraction=self.sample_fraction,
                 max_training_sample=self.max_training_sample)
        return d


class DataCutter(Splitter):
    """Multiclass label cutter (reference DataCutter.scala:76): keep at most
    ``max_label_categories`` labels, each with at least
    ``min_label_fraction`` of the rows; drop the rows of other labels and
    relabel the kept ones contiguously (`PreparedData.label_map`)."""

    def __init__(self, seed: int = 42, reserve_test_fraction: float = 0.1,
                 max_label_categories: int = 100,
                 min_label_fraction: float = 0.0):
        super().__init__(seed=seed, reserve_test_fraction=reserve_test_fraction)
        if not 0.0 <= min_label_fraction < 0.5:
            raise ValueError("min_label_fraction must be in [0, 0.5)")
        self.max_label_categories = int(max_label_categories)
        self.min_label_fraction = float(min_label_fraction)

    def prepare(self, y: np.ndarray) -> PreparedData:
        labels, counts = np.unique(y[~np.isnan(y)], return_counts=True)
        frac_ok = counts / len(y) >= self.min_label_fraction
        kept = labels[frac_ok]
        kept_counts = counts[frac_ok]
        if len(kept) > self.max_label_categories:
            order = np.argsort(-kept_counts)[: self.max_label_categories]
            kept = kept[np.sort(order)]
        kept_set = set(float(v) for v in kept)
        dropped = [float(v) for v in labels if float(v) not in kept_set]
        label_map = {int(v): i for i, v in enumerate(sorted(kept_set))}
        idx = np.flatnonzero(np.isin(y, list(kept_set)))
        summary = {
            "labels_kept": sorted(kept_set),
            "labels_dropped": dropped,
            "labels_dropped_total": len(dropped),
        }
        return PreparedData(indices=idx, weights=np.ones(len(idx), np.float32),
                            summary=summary, label_map=label_map)

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(max_label_categories=self.max_label_categories,
                 min_label_fraction=self.min_label_fraction)
        return d


def splitter_from_args(d: Dict[str, Any]) -> Splitter:
    """The splitter a `save_args()` dict describes (either package's)."""
    kinds = {c.__name__: c for c in (Splitter, DataSplitter, DataBalancer,
                                     DataCutter)}
    args = dict(d)
    return kinds[args.pop("kind")](**args)
