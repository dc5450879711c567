"""RawFeatureFilter: pre-training exclusion of unreliable RAW features
(counterpart of filters/raw_feature_filter.py).

Reference: core/.../filters/RawFeatureFilter.scala:90 (exclusion logic
getFeaturesToExclude:441, generateFilteredRaw:482), FeatureDistribution.scala:58
(fillRate:92, jsDivergence:138), Summary.scala:43, RawFeatureFilterResults.scala.

Per-feature distributions of the training reader and of the scoring reader
(filters/sketches.py: the numeric columns in one statistics-engine pass on
the device, with their histograms; text, list and map values hashed into
the same bins on the host) decide which raw features to drop: too low a
fill rate, train/score fill rates or histograms that diverge, or a null
pattern that leaks the label.

Dropped features are *nulled in place* (column of all-missing) rather than
removed, keeping every downstream stage's input arity; their vectorized
output collapses to constant columns which the SanityChecker then removes.
Dropped map keys are removed per key. The drop set is also recorded as the
workflow blacklist (reference setBlacklist:112).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..data.dataset import Column, Dataset
from ..device import DeviceLike
from . import sketches
from .sketches import FeatureDistribution, compute_distributions

EPS = sketches.EPS
_NUMERIC_KINDS = sketches.NUMERIC_KINDS
_is_empty = sketches.is_empty


# -- results ----------------------------------------------------------------

@dataclass
class ExclusionReasons:
    """Reference RawFeatureFilterResults exclusion reasons per feature."""

    name: str
    key: Optional[str] = None
    train_fill_rate: float = 1.0
    low_fill_rate: bool = False
    fill_rate_diff: float = 0.0
    high_fill_rate_diff: bool = False
    fill_ratio: float = 1.0
    high_fill_ratio_diff: bool = False
    js_divergence: float = 0.0
    high_js_divergence: bool = False
    null_label_correlation: float = 0.0
    null_leakage: bool = False

    @property
    def excluded(self) -> bool:
        return (self.low_fill_rate or self.high_fill_rate_diff
                or self.high_fill_ratio_diff or self.high_js_divergence
                or self.null_leakage)

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "ExclusionReasons":
        return ExclusionReasons(**d)


@dataclass
class RawFeatureFilterResults:
    """Persisted record of the filter run (reference
    RawFeatureFilterResults.scala); round-trips through the model JSON."""

    config: Dict[str, Any] = field(default_factory=dict)
    train_distributions: List[FeatureDistribution] = field(default_factory=list)
    score_distributions: List[FeatureDistribution] = field(default_factory=list)
    exclusion_reasons: List[ExclusionReasons] = field(default_factory=list)
    dropped_features: List[str] = field(default_factory=list)
    dropped_map_keys: Dict[str, List[str]] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "config": self.config,
            "train_distributions": [d.to_json()
                                    for d in self.train_distributions],
            "score_distributions": [d.to_json()
                                    for d in self.score_distributions],
            "exclusion_reasons": [r.to_json() for r in self.exclusion_reasons],
            "dropped_features": list(self.dropped_features),
            "dropped_map_keys": {k: list(v)
                                 for k, v in self.dropped_map_keys.items()},
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "RawFeatureFilterResults":
        return RawFeatureFilterResults(
            config=d.get("config", {}),
            train_distributions=[FeatureDistribution.from_json(x)
                                 for x in d.get("train_distributions", [])],
            score_distributions=[FeatureDistribution.from_json(x)
                                 for x in d.get("score_distributions", [])],
            exclusion_reasons=[ExclusionReasons.from_json(x)
                               for x in d.get("exclusion_reasons", [])],
            dropped_features=list(d.get("dropped_features", [])),
            dropped_map_keys={k: list(v) for k, v in
                              d.get("dropped_map_keys", {}).items()},
        )


@dataclass
class RffResult:
    cleaned: Dataset
    dropped: List[str]
    dropped_map_keys: Dict[str, List[str]]
    results: RawFeatureFilterResults


# -- the filter -------------------------------------------------------------

def _null_column(col: Column) -> Column:
    """All-missing replacement preserving kind (keeps DAG arity static)."""
    n = len(col)
    if col.kind in _NUMERIC_KINDS:
        return Column(kind=col.kind, data=np.full(n, np.nan, np.float64))
    data = np.empty(n, dtype=object)
    return Column(kind=col.kind, data=data)


class RawFeatureFilter:
    """Reference RawFeatureFilter.scala:90; defaults from
    OpWorkflow.withRawFeatureFilter:523."""

    def __init__(self, score_reader=None, bins: int = 100,
                 min_fill_rate: float = 0.001,
                 max_fill_difference: float = 0.90,
                 max_fill_ratio_diff: float = 20.0,
                 max_js_divergence: float = 0.90,
                 max_correlation: float = 0.95,
                 protected_features: Sequence[str] = (),
                 device: DeviceLike = None):
        """`device` runs the numeric sketches (None: CUDA, unless the
        workflow that applies the filter passes its own)."""
        self.score_reader = score_reader
        self.bins = int(bins)
        self.min_fill_rate = float(min_fill_rate)
        self.max_fill_difference = float(max_fill_difference)
        self.max_fill_ratio_diff = float(max_fill_ratio_diff)
        self.max_js_divergence = float(max_js_divergence)
        self.max_correlation = float(max_correlation)
        self.protected_features = set(protected_features)
        self.device = device
        self.results: Optional[RawFeatureFilterResults] = None

    # -- null-label leakage ------------------------------------------------
    def _null_label_corr(self, ds: Dataset, name: str,
                         label: np.ndarray) -> float:
        col = ds.column(name)
        if col.kind in _NUMERIC_KINDS:
            is_null = np.isnan(np.asarray(col.data, np.float64))
        else:
            is_null = np.array([_is_empty(v) for v in col.data], bool)
        x = is_null.astype(np.float64)
        ok = ~np.isnan(label)
        if ok.sum() < 2 or x[ok].std() < EPS or label[ok].std() < EPS:
            return 0.0
        return float(abs(np.corrcoef(x[ok], label[ok])[0, 1]))

    def apply(self, ds: Dataset, raw_features: Sequence[Any],
              score_ds: Optional[Dataset] = None) -> RffResult:
        """Compute sketches, decide exclusions, null out dropped features.

        Reference generateFilteredRaw:482: distributions on the training
        reader and (if present) the scoring reader; score-side checks only
        run when scoring data exists.
        """
        predictors = [f for f in raw_features if not f.is_response]
        responses = [f for f in raw_features if f.is_response]
        pred_names = [f.name for f in predictors]

        if score_ds is None and self.score_reader is not None:
            score_ds = self.score_reader.generate_dataset(list(raw_features))

        train_dists = compute_distributions(ds, pred_names, self.bins,
                                            device=self.device)
        train_ranges = {d.name: (d.summary[0], d.summary[1])
                        for d in train_dists
                        if d.key is None and d.summary[3] > 0}
        score_dists = (compute_distributions(score_ds, pred_names, self.bins,
                                             ranges=train_ranges,
                                             device=self.device)
                       if score_ds is not None else [])
        score_by_key = {(d.name, d.key): d for d in score_dists}

        label: Optional[np.ndarray] = None
        if responses and responses[0].name in ds:
            lcol = ds.column(responses[0].name)
            if lcol.kind in _NUMERIC_KINDS:
                label = np.asarray(lcol.data, np.float64)

        reasons: List[ExclusionReasons] = []
        for d in train_dists:
            r = ExclusionReasons(name=d.name, key=d.key,
                                 train_fill_rate=d.fill_rate())
            r.low_fill_rate = r.train_fill_rate < self.min_fill_rate
            other = score_by_key.get((d.name, d.key))
            if other is not None and other.count > 0:
                r.fill_rate_diff = d.relative_fill_rate(other)
                r.high_fill_rate_diff = (r.fill_rate_diff
                                         > self.max_fill_difference)
                r.fill_ratio = d.relative_fill_ratio(other)
                r.high_fill_ratio_diff = (r.fill_ratio
                                          > self.max_fill_ratio_diff)
                r.js_divergence = d.js_divergence(other)
                r.high_js_divergence = (r.js_divergence
                                        > self.max_js_divergence)
            if label is not None and d.key is None:
                r.null_label_correlation = self._null_label_corr(
                    ds, d.name, label)
                r.null_leakage = (r.null_label_correlation
                                  > self.max_correlation)
            reasons.append(r)

        dropped: List[str] = []
        dropped_keys: Dict[str, List[str]] = {}
        for r in reasons:
            if r.name in self.protected_features or not r.excluded:
                continue
            if r.key is None:
                if r.name not in dropped:
                    dropped.append(r.name)
            else:
                dropped_keys.setdefault(r.name, []).append(r.key)
        # keys of dropped map features need no separate listing
        dropped_keys = {k: v for k, v in dropped_keys.items()
                        if k not in dropped}

        cleaned = ds
        for name in dropped:
            if name in cleaned:
                cleaned = cleaned.with_column(
                    name, _null_column(cleaned.column(name)))
        for name, keys in dropped_keys.items():
            col = cleaned.column(name)
            kept = np.empty(len(col), dtype=object)
            drop = set(keys)
            for i, v in enumerate(col.data):
                kept[i] = ({k: x for k, x in v.items() if k not in drop}
                           if isinstance(v, dict) else v)
            cleaned = cleaned.with_column(name,
                                          Column(kind=col.kind, data=kept))

        self.results = RawFeatureFilterResults(
            config={"bins": self.bins, "min_fill_rate": self.min_fill_rate,
                    "max_fill_difference": self.max_fill_difference,
                    "max_fill_ratio_diff": self.max_fill_ratio_diff,
                    "max_js_divergence": self.max_js_divergence,
                    "max_correlation": self.max_correlation},
            train_distributions=train_dists,
            score_distributions=score_dists,
            exclusion_reasons=reasons,
            dropped_features=dropped,
            dropped_map_keys=dropped_keys,
        )
        return RffResult(cleaned=cleaned, dropped=dropped,
                         dropped_map_keys=dropped_keys, results=self.results)
