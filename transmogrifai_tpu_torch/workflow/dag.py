"""Feature-DAG computation & layering — the scheduler (counterpart of
workflow/dag.py).

Reference: core/.../utils/stages/FitStagesUtil.scala — ``computeDAG:173``
layers stages by max distance-to-result so that independent stages land in
the same layer, are fitted together, and their transforms run in one pass
(``fitAndTransformLayer:254``; the port's layer runner runs a layer's torch
functions together on the device, workflow/fitting.py). ``cut_dag``
(``cutDAG:305``) splits the DAG around the model selector for
workflow-level CV.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..stages.base import Estimator, PipelineStage


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


@dataclass
class CutDAG:
    """DAG split around a model selector (reference FitStagesUtil.cutDAG:305)."""

    before: StagesDAG     # stages whose output does not depend on the selector
    during: StagesDAG     # stages feeding the selector (refit per CV fold)
    after: StagesDAG      # selector + downstream
    model_selector: Optional[PipelineStage]


def cut_dag(dag: StagesDAG) -> CutDAG:
    """Split layers at the model selector for workflow-level CV: the
    selector's ancestors in and after the first layer that holds one of
    them that is an estimator are 'during' (refit in each fold: they see
    fitted statistics, so fitting them on all rows would leak the
    validation rows); the rest before the selector's layer are 'before';
    the selector's layer and those after it are 'after'. Two selectors
    raise, as in the reference."""
    from ..automl.selector import ModelSelector

    selector = None
    for st in dag.stages:
        if isinstance(st, ModelSelector):
            if selector is not None:
                raise ValueError(
                    "Multiple ModelSelectors in one workflow not supported "
                    "(matches reference restriction)")
            selector = st
    if selector is None:
        return CutDAG(before=dag, during=StagesDAG([]), after=StagesDAG([]),
                      model_selector=None)

    anc: Set[str] = set()

    def mark(f: Feature) -> None:
        st = f.origin_stage
        if st is None or isinstance(st, FeatureGeneratorStage):
            return
        if st.uid in anc:
            return
        anc.add(st.uid)
        for p in st.input_features:
            mark(p)

    for p in selector.input_features:
        mark(p)

    before_layers: List[List[PipelineStage]] = []
    during_layers: List[List[PipelineStage]] = []
    after_layers: List[List[PipelineStage]] = []
    est_seen = False
    sel_seen = False
    for layer in dag.layers:
        if any(st.uid == selector.uid for st in layer):
            sel_seen = True
        if sel_seen:
            after_layers.append(list(layer))
            continue
        if not est_seen and any(isinstance(st, Estimator) and st.uid in anc
                                for st in layer):
            est_seen = True
        b = [st for st in layer if not (st.uid in anc and est_seen)]
        d = [st for st in layer if st.uid in anc and est_seen]
        if b:
            before_layers.append(b)
        if d:
            during_layers.append(d)
    return CutDAG(before=StagesDAG(before_layers),
                  during=StagesDAG(during_layers),
                  after=StagesDAG(after_layers),
                  model_selector=selector)
