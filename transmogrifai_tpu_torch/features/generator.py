"""FeatureGeneratorStage: the origin stage of every raw feature.

Reference: features/.../stages/FeatureGeneratorStage.scala:61 — holds the
user's extract function, the monoid aggregator, and the time window. Readers
call these to turn raw records into feature columns.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

from ..stages.base import PipelineStage
from ..types import FeatureType
from .aggregators import FeatureAggregator
from .feature import Feature


class FeatureGeneratorStage(PipelineStage):
    """Origin stage: record -> feature value."""

    input_types = ()  # source stage: extracts from raw records, no inputs

    def __init__(self, name: str, feature_type: Type[FeatureType],
                 extract_fn: Callable[[Any], Any],
                 is_response: bool = False,
                 aggregator: Optional[FeatureAggregator] = None,
                 event_time_fn: Optional[Callable[[Any], Optional[int]]] = None,
                 uid: Optional[str] = None):
        self.feature_name = name
        self.feature_type = feature_type
        self.extract_fn = extract_fn
        self.is_response = is_response
        self.aggregator = aggregator or FeatureAggregator(type_cls=feature_type)
        self.event_time_fn = event_time_fn
        # which reader's records this feature extracts from (JoinedReader
        # routing; set directly on the stage)
        self.reader_hint: Optional[Any] = None
        super().__init__(operation_name=f"gen_{name}", uid=uid)
        self.output_type = feature_type

    def extract(self, record: Any) -> Any:
        """Extract the raw value from one record (row dict or object)."""
        v = self.extract_fn(record)
        if isinstance(v, FeatureType):
            return v.value
        return self.feature_type.coercer()(v)

    def extract_all(self, records) -> list:
        """`extract` of every record, in order."""
        coerce = self.feature_type.coercer()
        return [v.value if isinstance(v, FeatureType) else coerce(v)
                for v in map(self.extract_fn, records)]

    def get_output(self) -> Feature:
        return Feature(
            name=self.feature_name,
            feature_type=self.feature_type,
            is_response=self.is_response,
            origin_stage=self,
            parents=(),
        )

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(name=self.feature_name, type=self.feature_type.type_name(),
                 is_response=self.is_response)
        return d

    @classmethod
    def from_save_args(cls, args: Dict[str, Any]) -> "FeatureGeneratorStage":
        """A rebuilt generator extracts by field name from dict records (or
        attributes of objects): the user's extract function does not travel,
        as in the reference; scoring reads the named columns."""
        name = args["name"]
        return cls(name=name, feature_type=FeatureType.from_name(args["type"]),
                   extract_fn=lambda rec: rec.get(name)
                   if isinstance(rec, dict) else getattr(rec, name, None),
                   is_response=bool(args.get("is_response", False)),
                   uid=args.get("uid"))
