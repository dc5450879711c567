"""ModelInsights: merged per-feature diagnostics of a fitted workflow
(counterpart of insights/model_insights.py).

Reference: core/.../ModelInsights.scala:72 (extractFromStages used at
OpWorkflowModel.scala:173, prettyPrint:99) — joins the assembled vector's
column provenance (VectorMetadata) with SanityChecker statistics, the
ModelSelector summary, RawFeatureFilter results, and the winning model's
per-column contributions into one JSON artifact + pretty tables. Host
work over the fitted stages' numpy state: nothing here touches a device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


# -- contributions ----------------------------------------------------------

def model_contributions(model: Any, n_cols: int) -> Optional[np.ndarray]:
    """Per-column contribution of a fitted model: |coefficient| for linear
    family, split-frequency importance for tree ensembles (reference exposes
    Spark's coefficients/featureImportances through ModelInsights).
    Returns [n_cols] or None when the model family has no notion of it
    (the MLP, the isotonic calibrator)."""
    from ..models import glm
    from ..models import trees as tr
    from ..automl.selector import SelectedModel

    if isinstance(model, SelectedModel):
        return model_contributions(model.best_model, n_cols)
    if isinstance(model, glm.LinearBinaryModel):
        return np.abs(model.beta[:n_cols])
    if isinstance(model, glm.LinearRegressionModel):
        return np.abs(model.beta[:n_cols])
    if isinstance(model, glm.SoftmaxModel):
        return np.abs(model.B[:n_cols, :]).sum(axis=1)
    if isinstance(model, glm.NaiveBayesModel):
        return np.abs(model.log_prob.T[:n_cols, :]).sum(axis=1)
    if isinstance(model, (tr.TreeEnsembleModel, tr.SoftmaxEnsembleModel)):
        live = np.isfinite(model.thresh_val)          # dead splits are +inf
        counts = np.bincount(model.feat[live].ravel(), minlength=n_cols)
        total = counts.sum()
        return (counts / total if total else counts).astype(np.float64)[:n_cols]
    return None


def model_contributions_per_class(model: Any,
                                  n_cols: int) -> Optional[np.ndarray]:
    """[n_cols, c] per-class contributions where the family has them
    (reference Insights.contribution is a Seq — one weight per class for
    multinomial models); single-column for binary/regression/tree models."""
    from ..models import glm
    from ..automl.selector import SelectedModel

    if isinstance(model, SelectedModel):
        return model_contributions_per_class(model.best_model, n_cols)
    if isinstance(model, glm.SoftmaxModel):
        return np.abs(model.B[:n_cols, :])
    if isinstance(model, glm.NaiveBayesModel):
        return np.abs(model.log_prob.T[:n_cols, :])
    flat = model_contributions(model, n_cols)
    return None if flat is None else flat[:, None]


# -- insight records --------------------------------------------------------

@dataclass
class LabelSummary:
    """Label provenance + distribution (reference LabelSummary,
    ModelInsights.scala:291)."""

    label_name: Optional[str] = None
    raw_feature_name: List[str] = field(default_factory=list)
    raw_feature_type: List[str] = field(default_factory=list)
    stages_applied: List[str] = field(default_factory=list)
    sample_size: Optional[float] = None
    # {"kind": "continuous", min, max, mean, variance} or
    # {"kind": "discrete", "domain": [...], "prob": [...]}
    distribution: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class DerivedFeatureInsights:
    """One column of the model's input vector (reference Insights per
    derived feature, ModelInsights.scala:372)."""

    column_name: str
    column_index: int
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    stages_applied: List[str] = field(default_factory=list)
    excluded: Optional[bool] = None
    contribution: Optional[float] = None
    contributions: List[float] = field(default_factory=list)  # per class
    corr_label: Optional[float] = None
    cramers_v: Optional[float] = None
    mutual_information: Optional[float] = None
    pointwise_mutual_information: Dict[str, float] = field(default_factory=dict)
    count_matrix: Dict[str, float] = field(default_factory=dict)
    variance: Optional[float] = None
    mean: Optional[float] = None
    min: Optional[float] = None
    max: Optional[float] = None

    def to_json(self) -> Dict[str, Any]:
        return dict(self.__dict__)


@dataclass
class FeatureInsights:
    """All derived columns of one raw feature + exclusion info
    (reference FeatureInsights, ModelInsights.scala:336)."""

    feature_name: str
    feature_type: str = ""
    derived: List[DerivedFeatureInsights] = field(default_factory=list)
    excluded_by: Optional[str] = None     # 'SanityChecker'|'RawFeatureFilter'
    exclusion_reasons: List[str] = field(default_factory=list)
    # RawFeatureFilter artifacts for this raw feature, when it ran
    rff_metrics: List[Dict[str, Any]] = field(default_factory=list)
    rff_distributions: List[Dict[str, Any]] = field(default_factory=list)

    def max_contribution(self) -> float:
        vals = [d.contribution for d in self.derived
                if d.contribution is not None]
        return max(vals) if vals else 0.0

    def max_corr(self) -> float:
        vals = [abs(d.corr_label) for d in self.derived
                if d.corr_label is not None and np.isfinite(d.corr_label)]
        return max(vals) if vals else 0.0

    def to_json(self) -> Dict[str, Any]:
        return {"feature_name": self.feature_name,
                "feature_type": self.feature_type,
                "derived": [d.to_json() for d in self.derived],
                "excluded_by": self.excluded_by,
                "exclusion_reasons": list(self.exclusion_reasons),
                "rff_metrics": list(self.rff_metrics),
                "rff_distributions": list(self.rff_distributions)}


@dataclass
class ModelInsights:
    """The merged artifact (reference ModelInsights case class)."""

    label_name: Optional[str]
    problem_type: Optional[str]
    features: List[FeatureInsights] = field(default_factory=list)
    selected_model: Optional[Dict[str, Any]] = None
    validation_results: List[Dict[str, Any]] = field(default_factory=list)
    train_evaluation: Dict[str, float] = field(default_factory=dict)
    holdout_evaluation: Dict[str, float] = field(default_factory=dict)
    stage_names: List[str] = field(default_factory=list)
    blacklisted: List[str] = field(default_factory=list)
    label: Optional[LabelSummary] = None
    # per-stage parameter snapshot (reference stageInfo map)
    stage_info: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {
            "label_name": self.label_name,
            "problem_type": self.problem_type,
            "label": self.label.to_json() if self.label else None,
            "features": [f.to_json() for f in self.features],
            "selected_model": self.selected_model,
            "validation_results": self.validation_results,
            "train_evaluation": self.train_evaluation,
            "holdout_evaluation": self.holdout_evaluation,
            "stage_names": self.stage_names,
            "stage_info": self.stage_info,
            "blacklisted": self.blacklisted,
        }

    # -- pretty (reference prettyPrint:99 -> README tables) ----------------
    def pretty(self, top_k: int = 15) -> str:
        lines: List[str] = []
        if self.selected_model:
            lines.append(
                f"Selected model: {self.selected_model.get('best_model_type')}"
                f" grid={self.selected_model.get('best_grid')}")
        # scalar metrics only: structured entries (threshold_metrics
        # curves) live in the JSON artifact, not the table
        if self.train_evaluation:
            ev = ", ".join(f"{k}={v:.4f}"
                           for k, v in sorted(self.train_evaluation.items())
                           if isinstance(v, float))
            lines.append(f"Train evaluation: {ev}")
        if self.holdout_evaluation:
            ev = ", ".join(f"{k}={v:.4f}"
                           for k, v in sorted(self.holdout_evaluation.items())
                           if isinstance(v, float))
            lines.append(f"Holdout evaluation: {ev}")

        ranked = sorted(self.features, key=lambda f: -f.max_contribution())
        lines.append("")
        lines.append(f"{'Top Model Contributions':<32}{'Contribution':>14}")
        for f in ranked[:top_k]:
            lines.append(f"{f.feature_name:<32}{f.max_contribution():>14.4f}")

        by_corr = sorted(self.features, key=lambda f: -f.max_corr())
        lines.append("")
        lines.append(f"{'Top Correlations':<32}{'Correlation':>14}")
        for f in by_corr[:top_k]:
            lines.append(f"{f.feature_name:<32}{f.max_corr():>14.4f}")

        excluded = [f for f in self.features if f.excluded_by]
        if excluded:
            lines.append("")
            lines.append("Excluded features:")
            for f in excluded:
                why = "; ".join(f.exclusion_reasons) or f.excluded_by
                lines.append(f"  {f.feature_name} ({f.excluded_by}): {why}")
        return "\n".join(lines)


# -- extraction -------------------------------------------------------------

def _final_vector_metadata(model) -> Optional[Any]:
    """Metadata of the vector the winning model consumed: the sanity
    checker's post-slice metadata when present, else the last vector-
    producing stage's."""
    sc = model._sanity_checker()
    if sc is not None and getattr(sc, "metadata", None) is not None:
        # the fitted checker's metadata is already the POST-slice view
        # (SanityChecker.fit builds it via meta.select(keep))
        return sc.metadata
    for st in reversed(model.stages):
        md = st.output_metadata()
        if md is not None:
            return md
    return None


def _feature_graph_by_name(model) -> Dict[str, Any]:
    """name -> Feature for every node reachable from the result features."""
    out: Dict[str, Any] = {}
    for rf in getattr(model, "result_features", ()):
        for f in rf.all_features():
            out.setdefault(f.name, f)
    return out


def _stages_applied(feature) -> List[str]:
    """Stage-name chain that produced this feature from its raw inputs
    (reference Insights.stagesApplied via FeatureHistory)."""
    if feature is None:
        return []
    names: List[str] = []
    for st in feature.parent_stages():
        nm = getattr(st, "stage_name", None) or type(st).__name__
        if nm not in names:
            names.append(nm)
    return names


def _label_summary(model, sc_summary, label_name) -> LabelSummary:
    """Reference LabelSummary: provenance from the label feature's history,
    distribution from the checker's label stats."""
    graph = _feature_graph_by_name(model)
    lf = graph.get(label_name) if label_name else None
    raws = [f.name for f in lf.raw_features()] if lf is not None else []
    raw_types = [f.type_name for f in lf.raw_features()] if lf is not None \
        else []
    sample, dist = None, None
    if sc_summary is not None and sc_summary.column_stats:
        ls = sc_summary.column_stats[0]
        sample = ls.get("count")
        ld = getattr(sc_summary, "label_distribution", None)
        if ld:
            total = sum(ld["counts"]) or 1.0
            dist = {"kind": "discrete",
                    "domain": [str(v) for v in ld["domain"]],
                    "prob": [c / total for c in ld["counts"]]}
        else:
            dist = {"kind": "continuous", "min": ls.get("min"),
                    "max": ls.get("max"), "mean": ls.get("mean"),
                    "variance": ls.get("variance")}
    return LabelSummary(label_name=label_name, raw_feature_name=raws,
                        raw_feature_type=raw_types,
                        stages_applied=_stages_applied(lf),
                        sample_size=sample, distribution=dist)


def extract_insights(model) -> ModelInsights:
    """Build ModelInsights from a fitted WorkflowModel (reference
    extractFromStages, OpWorkflowModel.scala:173)."""
    sel = model.selected_model()
    sel_summary = model.selector_summary()
    sc_summary = model.sanity_checker_summary()
    md = _final_vector_metadata(model)

    # sanity-checker stats by column name (first entry is the label)
    stats_by_name: Dict[str, Dict[str, Any]] = {}
    label_name = None
    if sc_summary is not None:
        cs = sc_summary.column_stats
        if cs:
            label_name = cs[0]["name"]
        for st in cs[1:]:
            stats_by_name[st["name"]] = st

    # categorical group stats indexed by member column name: the group's
    # MI is shared, the PMI / contingency columns are per member
    cat_by_col: Dict[str, Dict[str, Any]] = {}
    label_domain: List[str] = []
    if sc_summary is not None:
        ld = getattr(sc_summary, "label_distribution", None)
        if ld:
            label_domain = [str(v) for v in ld["domain"]]
        for g in sc_summary.categorical_stats:
            for pos, col in enumerate(g.get("categorical_features", [])):
                cat_by_col[col] = {"group": g, "pos": pos}

    contrib = None
    contrib_pc = None
    if sel is not None and md is not None:
        contrib = model_contributions(sel, md.size)
        contrib_pc = model_contributions_per_class(sel, md.size)

    graph = _feature_graph_by_name(model)
    dropped_set = set(sc_summary.dropped) if sc_summary is not None else set()

    features: Dict[str, FeatureInsights] = {}
    if md is not None:
        for c in md.columns:
            fi = features.setdefault(
                c.parent_feature_name,
                FeatureInsights(feature_name=c.parent_feature_name,
                                feature_type=c.parent_feature_type))
            name = c.column_name()
            st = stats_by_name.get(name, {})
            mi = pmi = counts = None
            cat = cat_by_col.get(name)
            if cat is not None:
                # contingency/PMI rows are the group's member features,
                # columns the label values (preparators._categorical_tests)
                g, pos = cat["group"], cat["pos"]
                mi = g.get("mutual_info")
                pm = g.get("pointwise_mutual_info")
                cm = g.get("contingency_matrix")

                def _label_row(matrix):
                    if matrix is None or pos >= len(matrix):
                        return None
                    row = matrix[pos]
                    dom = (label_domain if len(label_domain) == len(row)
                           else [str(i) for i in range(len(row))])
                    return {dom[j]: float(v) for j, v in enumerate(row)}

                pmi = _label_row(pm)
                counts = _label_row(cm)
            fi.derived.append(DerivedFeatureInsights(
                column_name=name, column_index=c.index,
                grouping=c.grouping, indicator_value=c.indicator_value,
                stages_applied=_stages_applied(
                    graph.get(c.parent_feature_name)),
                excluded=(name in dropped_set) if sc_summary is not None
                else None,
                contribution=(float(contrib[c.index])
                              if contrib is not None and c.index < len(contrib)
                              else None),
                contributions=([float(v) for v in contrib_pc[c.index]]
                               if contrib_pc is not None
                               and c.index < len(contrib_pc) else []),
                corr_label=st.get("corr_label"),
                cramers_v=st.get("cramers_v"),
                mutual_information=mi,
                pointwise_mutual_information=pmi or {},
                count_matrix=counts or {},
                variance=st.get("variance"),
                mean=st.get("mean"),
                min=st.get("min"), max=st.get("max")))

    # columns the SanityChecker dropped still deserve a line w/ reasons.
    # Their parents come from the summary's dropped_parents map (resolved
    # at fit time from the PRE-slice metadata) — string-splitting the
    # column name breaks for any raw feature whose name contains an
    # underscore (e.g. 'pickup_time').
    dropped_parent: Dict[str, str] = {}
    if sc_summary is not None and sc_summary.dropped:
        dropped_parent = dict(getattr(sc_summary, "dropped_parents", {}))
    if sc_summary is not None:
        for dropped_col in sc_summary.dropped:
            reasons = sc_summary.drop_reasons.get(dropped_col, [])
            parent = dropped_parent.get(dropped_col,
                                        dropped_col.split("_")[0])
            fi = features.setdefault(parent, FeatureInsights(parent))
            if fi.excluded_by is None and all(
                    d.column_name != dropped_col for d in fi.derived):
                fi.derived.append(DerivedFeatureInsights(
                    column_name=dropped_col, column_index=-1))
            # only mark the whole feature excluded when ALL its columns drop
        kept_parents = {c.parent_feature_name for c in md.columns} if md else set()
        for name, fi in features.items():
            if name not in kept_parents and sc_summary.dropped:
                fi.excluded_by = "SanityChecker"
                fi.exclusion_reasons = sorted({
                    r for col in sc_summary.dropped
                    if dropped_parent.get(col, col.split("_")[0]) == name
                    for r in sc_summary.drop_reasons.get(col, [])})

    # raw-feature-filter exclusions
    if model.rff_results is not None:
        for name in model.rff_results.dropped_features:
            fi = features.setdefault(name, FeatureInsights(name))
            fi.excluded_by = "RawFeatureFilter"
            fi.exclusion_reasons = [
                k for r in model.rff_results.exclusion_reasons
                if r.name == name and r.key is None and r.excluded
                for k, v in r.to_json().items()
                if isinstance(v, bool) and v]

    # RawFeatureFilter per-feature artifacts (reference FeatureInsights
    # metrics/distributions fields)
    if model.rff_results is not None:
        rff = model.rff_results
        for fd in rff.train_distributions:
            fi = features.get(fd.name)
            if fi is not None:
                d = fd.to_json() if hasattr(fd, "to_json") else dict(
                    fd.__dict__)
                fi.rff_distributions.append(d)
        for er in rff.exclusion_reasons:
            fi = features.get(er.name)
            if fi is not None:
                fi.rff_metrics.append(er.to_json()
                                      if hasattr(er, "to_json")
                                      else dict(er.__dict__))

    stage_info: Dict[str, Dict[str, Any]] = {}
    for st in model.stages:
        try:
            stage_info[st.stage_name] = {
                k: v for k, v in st.param_values().items()
                if isinstance(v, (int, float, str, bool, type(None)))}
        except Exception:
            stage_info[st.stage_name] = {}

    problem_type = sel_summary.problem_type if sel_summary else None
    return ModelInsights(
        label_name=label_name,
        problem_type=problem_type,
        label=_label_summary(model, sc_summary, label_name),
        stage_info=stage_info,
        features=list(features.values()),
        selected_model=({"best_model_type": sel_summary.best_model_type,
                         "best_model_name": sel_summary.best_model_name,
                         "best_grid": sel_summary.best_grid}
                        if sel_summary else None),
        validation_results=(sel_summary.validation_results
                            if sel_summary else []),
        train_evaluation=(sel_summary.train_evaluation if sel_summary else {}),
        holdout_evaluation=(sel_summary.holdout_evaluation
                            if sel_summary else {}),
        stage_names=[st.stage_name for st in model.stages],
        blacklisted=list(model.blacklist),
    )
