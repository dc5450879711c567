"""Feature-DAG computation & layering — the scheduler (counterpart of
workflow/dag.py).

Reference: core/.../utils/stages/FitStagesUtil.scala — ``computeDAG:173``
layers stages by max distance-to-result so that independent stages land in
the same layer, are fitted together, and their transforms run in one pass
(``fitAndTransformLayer:254``; the port's layer runner runs a layer's torch
functions together on the device, workflow/fitting.py). The DAG cut for
workflow-level CV (``cutDAG:305``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Set, Tuple

from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..stages.base import PipelineStage


@dataclass
class StagesDAG:
    """Layers of stages, executed first-to-last; stages within a layer are
    independent (same max distance to a result feature)."""

    layers: List[List[PipelineStage]]

    @property
    def stages(self) -> List[PipelineStage]:
        return [s for layer in self.layers for s in layer]

    def __len__(self) -> int:
        return len(self.layers)


def collect_raw_features(result_features: Sequence[Feature]) -> List[Feature]:
    """All leaf (raw, FeatureGeneratorStage-origin) features reachable from
    the results, in first-seen order."""
    seen: Set[str] = set()
    out: List[Feature] = []

    def visit(f: Feature) -> None:
        if f.uid in seen:
            return
        seen.add(f.uid)
        if f.is_raw:
            if f.name not in {g.name for g in out}:
                out.append(f)
            return
        for p in f.parents:
            visit(p)

    for f in result_features:
        visit(f)
    return out


def collect_features(result_features: Sequence[Feature]) -> List[Feature]:
    """Every feature in the lineage graph (raw + derived), topological-ish
    (parents before children)."""
    seen: Set[str] = set()
    out: List[Feature] = []

    def visit(f: Feature) -> None:
        if f.uid in seen:
            return
        seen.add(f.uid)
        for p in f.parents:
            visit(p)
        out.append(f)

    for f in result_features:
        visit(f)
    return out


def compute_dag(result_features: Sequence[Feature]) -> StagesDAG:
    """Layer non-generator stages by max distance-to-result (reference
    FitStagesUtil.computeDAG:173: ``distance = longest path to a leaf``;
    stages at the same distance form a layer, furthest first)."""
    # stage -> set of consumer stages, discovered by walking the graph
    features = collect_features(result_features)
    stages: Dict[str, PipelineStage] = {}
    consumers: Dict[str, Set[str]] = {}
    for f in features:
        st = f.origin_stage
        if st is None or isinstance(st, FeatureGeneratorStage):
            continue
        stages[st.uid] = st
        consumers.setdefault(st.uid, set())
        for p in f.parents:
            ps = p.origin_stage
            if ps is not None and not isinstance(ps, FeatureGeneratorStage):
                consumers.setdefault(ps.uid, set()).add(st.uid)

    # distance-to-leaf: 0 for stages nothing consumes (they produce results)
    dist: Dict[str, int] = {}

    def distance(uid: str, trail: Tuple[str, ...] = ()) -> int:
        if uid in dist:
            return dist[uid]
        if uid in trail:
            raise ValueError(f"Cycle detected in feature DAG at stage {uid}")
        cons = consumers.get(uid, set())
        d = 0 if not cons else 1 + max(distance(c, trail + (uid,)) for c in cons)
        dist[uid] = d
        return d

    for uid in stages:
        distance(uid)

    if not stages:
        return StagesDAG(layers=[])
    max_d = max(dist.values())
    layers: List[List[PipelineStage]] = []
    for d in range(max_d, -1, -1):
        layer = [stages[uid] for uid in stages if dist[uid] == d]
        if layer:
            # deterministic order within a layer
            layer.sort(key=lambda s: s.uid)
            layers.append(layer)
    return StagesDAG(layers=layers)


def validate_stages(dag: StagesDAG) -> None:
    """Uniqueness checks (reference OpWorkflow.scala:265-323: distinct uids,
    ctor-uid match)."""
    seen: Dict[str, PipelineStage] = {}
    for st in dag.stages:
        if st.uid in seen and seen[st.uid] is not st:
            raise ValueError(
                f"Duplicate stage uid {st.uid}: {st} vs {seen[st.uid]}")
        seen[st.uid] = st
    names: Dict[str, str] = {}
    for st in dag.stages:
        out = st.output_name()
        if out in names and names[out] != st.uid:
            raise ValueError(f"Two stages produce output column '{out}'")
        names[out] = st.uid
