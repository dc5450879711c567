"""Vector column metadata: provenance of every column of the feature matrix.

Reference: features/.../utils/spark/{OpVectorMetadata,OpVectorColumnMetadata}.scala.
In the reference this provenance rides Spark DataFrame Metadata; here it is an
explicit sidecar carried next to the dense matrix, preserved through
save/load, and consumed by the SanityChecker (feature-to-drop reasons keyed by
column) and ModelInsights (per-feature contributions).
"""
from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, Sequence

NULL_STRING = "NullIndicatorValue"   # reference OpVectorColumnMetadata.NullString
OTHER_STRING = "OTHER"               # reference OpVectorColumnMetadata.OtherString


@dataclass(frozen=True)
class VectorColumnMetadata:
    """One column of an assembled feature vector.

    parent_feature_name: raw/derived feature this column came from
    parent_feature_type: FeatureType type name of the parent
    grouping: name of the group (e.g. the categorical value set or map key)
    indicator_value: the categorical value this column indicates, if any
    descriptor_value: descriptor for non-indicator derived cols (e.g. 'x', 'y')
    index: position in the assembled vector
    """

    parent_feature_name: str
    parent_feature_type: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0

    @property
    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_STRING

    @property
    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_STRING

    def column_name(self) -> str:
        parts = [self.parent_feature_name]
        if self.grouping is not None:
            parts.append(self.grouping)
        if self.indicator_value is not None:
            parts.append(self.indicator_value)
        elif self.descriptor_value is not None:
            parts.append(self.descriptor_value)
        return "_".join(parts)

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "VectorColumnMetadata":
        return VectorColumnMetadata(**d)


@dataclass
class VectorMetadata:
    """Metadata of a whole assembled vector (reference OpVectorMetadata)."""

    name: str
    columns: List[VectorColumnMetadata] = field(default_factory=list)
    history: Dict[str, List[str]] = field(default_factory=dict)  # feature -> origin stage chain

    def __post_init__(self):
        self.columns = [
            VectorColumnMetadata(**{**c.to_json(), "index": i})
            if c.index != i else c
            for i, c in enumerate(self.columns)
        ]

    @property
    def size(self) -> int:
        return len(self.columns)

    def column_names(self) -> List[str]:
        return [c.column_name() for c in self.columns]

    def parent_features(self) -> List[str]:
        seen, out = set(), []
        for c in self.columns:
            if c.parent_feature_name not in seen:
                seen.add(c.parent_feature_name)
                out.append(c.parent_feature_name)
        return out

    def index_of(self, column_name: str) -> int:
        for c in self.columns:
            if c.column_name() == column_name:
                return c.index
        raise KeyError(column_name)

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        """Metadata after keeping only `indices` (SanityCheckerModel slice)."""
        cols = [VectorColumnMetadata(**{**self.columns[i].to_json(), "index": j})
                for j, i in enumerate(indices)]
        return VectorMetadata(name=self.name, columns=cols, history=dict(self.history))

    @staticmethod
    def concat(name: str, parts: Sequence["VectorMetadata"]) -> "VectorMetadata":
        cols: List[VectorColumnMetadata] = []
        history: Dict[str, List[str]] = {}
        for p in parts:
            for c in p.columns:
                cols.append(VectorColumnMetadata(**{**c.to_json(), "index": len(cols)}))
            history.update(p.history)
        return VectorMetadata(name=name, columns=cols, history=history)

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "columns": [c.to_json() for c in self.columns],
            "history": self.history,
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "VectorMetadata":
        return VectorMetadata(
            name=d["name"],
            columns=[VectorColumnMetadata.from_json(c) for c in d["columns"]],
            history=dict(d.get("history", {})),
        )
