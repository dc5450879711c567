"""Feature: lazy, immutable DAG node.

Reference: features/.../FeatureLike.scala:48 (transformWith:210, traverse:309,
parentStages:363) and Feature.scala. A Feature names a typed column that will
exist once its origin stage runs; the workflow reconstructs the whole stage
DAG from result features by walking parents (OpWorkflow.setStagesDAG).

TransientFeature (reference TransientFeature.scala) — the serializable handle
that avoids dragging the whole graph into stage closures — is unnecessary
here (no JVM closure shipping), so stages hold plain (name, type, is_response)
handles produced by ``Feature.to_handle``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple, Type, TYPE_CHECKING

from ..types import FeatureType
from ..utils.uid import make_uid

if TYPE_CHECKING:
    from ..stages.base import PipelineStage


@dataclass(frozen=True)
class FeatureHandle:
    """Lightweight (name, typeName, isResponse) handle used inside stages
    (reference TransientFeature)."""
    name: str
    type_name: str
    is_response: bool = False

    @property
    def feature_type(self) -> Type[FeatureType]:
        return FeatureType.from_name(self.type_name)


@dataclass(frozen=True)
class FeatureHistory:
    """Provenance: originating raw features + stage chain
    (reference utils FeatureHistory)."""
    origin_features: Tuple[str, ...]
    stages: Tuple[str, ...]


class Feature:
    """A typed node in the feature lineage DAG."""

    def __init__(self, name: str, feature_type: Type[FeatureType],
                 is_response: bool = False,
                 origin_stage: Optional["PipelineStage"] = None,
                 parents: Sequence["Feature"] = (),
                 uid: Optional[str] = None):
        self.name = name
        self.feature_type = feature_type
        self.is_response = is_response
        self.origin_stage = origin_stage
        self.parents: Tuple[Feature, ...] = tuple(parents)
        self.uid = uid or make_uid("Feature")

    # -- basic protocol ----------------------------------------------------
    @property
    def is_raw(self) -> bool:
        from ..features.generator import FeatureGeneratorStage
        return self.origin_stage is None or isinstance(self.origin_stage, FeatureGeneratorStage)

    @property
    def type_name(self) -> str:
        return self.feature_type.type_name()

    def to_handle(self) -> FeatureHandle:
        return FeatureHandle(name=self.name, type_name=self.type_name,
                             is_response=self.is_response)

    def __repr__(self) -> str:
        return (f"Feature(name={self.name!r}, type={self.type_name}, "
                f"response={self.is_response}, raw={self.is_raw})")

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Feature) and other.uid == self.uid

    def __hash__(self) -> int:
        return hash(self.uid)

    # -- graph operations --------------------------------------------------
    def transform_with(self, stage: "PipelineStage", *others: "Feature") -> "Feature":
        """Apply a stage to (self, *others) yielding the stage's output feature
        (reference FeatureLike.transformWith:210-275)."""
        return stage.set_input(self, *others).get_output()

    def traverse(self, visit: Callable[["Feature"], None]) -> None:
        """Depth-first over ancestors, self first (reference traverse:309)."""
        seen: Set[str] = set()

        def go(f: "Feature") -> None:
            if f.uid in seen:
                return
            seen.add(f.uid)
            visit(f)
            for p in f.parents:
                go(p)

        go(self)

    def all_features(self) -> List["Feature"]:
        out: List[Feature] = []
        self.traverse(out.append)
        return out

    def raw_features(self) -> List["Feature"]:
        return [f for f in self.all_features() if f.is_raw]

    def parent_stages(self) -> Dict["PipelineStage", int]:
        """All ancestor stages with their distance from this feature
        (reference parentStages:363). Distance = max hops to this node."""
        dist: Dict[str, int] = {}
        stages: Dict[str, "PipelineStage"] = {}

        def go(f: "Feature", d: int) -> None:
            st = f.origin_stage
            if st is not None:
                if st.uid not in dist or dist[st.uid] < d:
                    dist[st.uid] = d
                    stages[st.uid] = st
            for p in f.parents:
                go(p, d + 1)

        go(self, 0)
        return {stages[u]: d for u, d in dist.items()}

    def history(self) -> FeatureHistory:
        origins: List[str] = []
        stage_uids: List[str] = []
        for f in self.all_features():
            if f.is_raw and f.name not in origins:
                origins.append(f.name)
            if f.origin_stage is not None and f.origin_stage.uid not in stage_uids:
                stage_uids.append(f.origin_stage.uid)
        return FeatureHistory(origin_features=tuple(sorted(origins)),
                              stages=tuple(stage_uids))

    def pretty_parent_stages(self, indent: int = 0) -> str:
        lines: List[str] = []

        def go(f: "Feature", depth: int) -> None:
            tag = f.origin_stage.stage_name if f.origin_stage else "raw"
            lines.append("  " * depth + f"+-- {f.name} [{f.type_name}] <- {tag}")
            for p in f.parents:
                go(p, depth + 1)

        go(self, indent)
        return "\n".join(lines)

    def copy_with(self, **kwargs: Any) -> "Feature":
        args = dict(name=self.name, feature_type=self.feature_type,
                    is_response=self.is_response, origin_stage=self.origin_stage,
                    parents=self.parents, uid=self.uid)
        args.update(kwargs)
        return Feature(**args)
