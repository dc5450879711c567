"""Monoid aggregators, as far as the feature builder needs them.

Counterpart of features/aggregators.py of the JAX package, cut to the two
types FeatureBuilder and FeatureGeneratorStage hold: `MonoidAggregator`
(prepare, zero/plus fold, present) and `FeatureAggregator` (an aggregator
plus an event-time window). The aggregate readers that fold many events
per key into one row, and the per-type default palette they use
(MonoidAggregatorDefaults, the named aggregators), are not ported yet:
`ListReader` and `CSVReader` read one record per row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Type

from ..types import FeatureType


@dataclass
class MonoidAggregator:
    """prepare -> zero/plus fold -> present (reference algebird
    MonoidAggregator shape). Constructing with just (zero, plus) gives
    identity prepare (value only) and identity present."""

    zero: Callable[[], Any]
    plus: Callable[[Any, Any], Any]
    prepare: Optional[Callable[[Any, Optional[int]], Any]] = None
    present: Optional[Callable[[Any], Any]] = None

    def reduce(self, values, times=None) -> Any:
        """Fold raw values; `times` is an optional parallel sequence of
        event times."""
        acc = self.zero()
        if times is None:
            for val in values:
                item = self.prepare(val, None) if self.prepare else val
                acc = self.plus(acc, item)
        else:
            for val, t in zip(values, times):
                item = self.prepare(val, t) if self.prepare else val
                acc = self.plus(acc, item)
        return self.present(acc) if self.present else acc


@dataclass
class FeatureAggregator:
    """Aggregator + optional event-time window (reference
    FeatureAggregator). `aggregator` None means the type's default, which
    only the aggregate readers (not ported yet) apply."""

    type_cls: Type[FeatureType]
    aggregator: Optional[MonoidAggregator] = None
    window_ms: Optional[int] = None
