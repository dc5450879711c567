"""SanityChecker: automated feature validation (counterpart of
automl/preparators.py).

Reference: core/.../impl/preparators/SanityChecker.scala:236 (fitFn:535,
reasonsToRemove:783, categoricalTests:420, defaults :721-736) and
SanityCheckerMetadata.scala.

Every statistic comes from ONE pass of the statistics engine
(ops/stats_engine.py) over the feature matrix on the device: per-column
moments, label correlations, the capped feature-feature Pearson matrix,
label moments and every categorical contingency table. Spearman adds the
engine's rank pre-pass and a second moment pass over the ranks. The
per-group contingency statistics (Cramer's V, rule confidences) then run
on the host on tiny [k, C] tables. The fitted model is a static column
gather, a torch function the layer runner runs on the device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Column
from ..data.vector import VectorColumnMetadata, VectorMetadata
from ..device import DeviceLike, resolve_device
from ..ops import stats_engine as SE
from ..stages.base import Estimator, Transformer
from ..stages.params import Param
from ..types import ColumnKind, OPVector, RealNN

_TEXT_PARENTS = {"Text", "TextArea", "TextMap", "TextAreaMap"}


@dataclass
class ColumnStatistics:
    """Per-column stats + removal reasons (reference ColumnStatistics)."""

    name: str
    column: Optional[VectorColumnMetadata]
    is_label: bool
    count: float
    mean: float
    min: float
    max: float
    variance: float
    corr_label: Optional[float] = None
    cramers_v: Optional[float] = None
    parent_corr: Optional[float] = None
    parent_cramers_v: Optional[float] = None
    max_rule_confidences: List[float] = field(default_factory=list)
    supports: List[float] = field(default_factory=list)

    def reasons_to_remove(self, min_variance: float, min_correlation: float,
                          max_correlation: float, max_cramers_v: float,
                          max_rule_confidence: float,
                          min_required_rule_support: float,
                          remove_feature_group: bool,
                          protect_text_shared_hash: bool,
                          removed_groups: Sequence[str]) -> List[str]:
        if self.is_label:
            return []
        reasons = []
        if self.variance <= min_variance:
            reasons.append(
                f"variance {self.variance} lower than min variance {min_variance}")
        if self.corr_label is not None and np.isfinite(self.corr_label):
            if abs(self.corr_label) < min_correlation:
                reasons.append(f"correlation {self.corr_label} lower than "
                               f"min correlation {min_correlation}")
            if abs(self.corr_label) > max_correlation:
                reasons.append(f"correlation {self.corr_label} higher than "
                               f"max correlation {max_correlation}")
        if self.cramers_v is not None and self.cramers_v > max_cramers_v:
            reasons.append(f"Cramer's V {self.cramers_v} higher than "
                           f"max Cramer's V {max_cramers_v}")
        for conf, sup in zip(self.max_rule_confidences, self.supports):
            if conf > max_rule_confidence and sup > min_required_rule_support:
                reasons.append(
                    f"association rule confidence {conf} above "
                    f"{max_rule_confidence} with support {sup} above "
                    f"{min_required_rule_support}")
                break
        group = self.feature_group()
        if group is not None and group in removed_groups:
            reasons.append(f"other feature in indicator group {group} flagged "
                           "for removal via rule confidence checks")
        if remove_feature_group and not (
                protect_text_shared_hash and self.is_text_shared_hash()):
            if self.parent_cramers_v is not None and \
                    self.parent_cramers_v > max_cramers_v:
                reasons.append(
                    f"Cramer's V {self.parent_cramers_v} for something in "
                    f"parent feature set higher than max Cramer's V "
                    f"{max_cramers_v}")
            if self.parent_corr is not None and self.parent_corr > max_correlation:
                reasons.append(
                    f"correlation {self.parent_corr} for something in parent "
                    f"feature set higher than max correlation {max_correlation}")
        return reasons

    def feature_group(self) -> Optional[str]:
        if self.column is None or self.column.grouping is None:
            return None
        return f"{self.column.parent_feature_name}_{self.column.grouping}"

    def is_text_shared_hash(self) -> bool:
        c = self.column
        return (c is not None and c.parent_feature_type in _TEXT_PARENTS
                and c.grouping is None and c.indicator_value is None)


@dataclass
class CategoricalGroupStats:
    """Contingency-test results for one indicator group (reference
    CategoricalGroupStats in SanityCheckerMetadata.scala)."""

    group: str
    categorical_features: List[str]
    contingency_matrix: List[List[float]]
    cramers_v: float
    chi2: float
    mutual_info: float
    pointwise_mutual_info: List[List[float]]
    max_rule_confidences: List[float]
    supports: List[float]


@dataclass
class SanityCheckerSummary:
    """Everything the checker measured (reference SanityCheckerSummary)."""

    correlation_type: str
    names: List[str]
    column_stats: List[Dict[str, Any]]
    categorical_stats: List[Dict[str, Any]]
    dropped: List[str]
    drop_reasons: Dict[str, List[str]]
    sample_fraction: float
    correlations_matrix: Optional[List[List[float]]] = None
    # discrete label domain + per-value counts when the label was treated
    # as categorical (feeds ModelInsights LabelSummary.distribution)
    label_distribution: Optional[Dict[str, List[float]]] = None
    # dropped column name -> parent raw feature (resolved from the
    # PRE-slice metadata, which the fitted model no longer carries)
    dropped_parents: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        from dataclasses import asdict
        return asdict(self)

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "SanityCheckerSummary":
        return SanityCheckerSummary(**d)


class SanityCheckerModel(Transformer):
    """Fitted checker: static index slice of the feature vector (reference
    SanityCheckerModel:697 indicesToKeep)."""

    input_types = (RealNN, OPVector)
    output_type = OPVector

    def __init__(self, indices_to_keep: Sequence[int],
                 metadata: Optional[VectorMetadata] = None,
                 summary: Optional[SanityCheckerSummary] = None,
                 operation_name: str = "sanityCheck",
                 uid: Optional[str] = None):
        super().__init__(operation_name, uid=uid)
        self.indices_to_keep = [int(i) for i in indices_to_keep]
        self.metadata = metadata
        self.summary = summary

    def get_torch_fn(self):
        idx = torch.as_tensor(self.indices_to_keep, dtype=torch.long,
                              device=resolve_device(self.device))

        def keep(_label, vec):
            return torch.index_select(vec, -1, idx)

        return keep

    def transform_columns(self, *cols: Column) -> Column:
        vec = cols[-1]
        data = vec.data[:, self.indices_to_keep]
        return Column(kind=ColumnKind.VECTOR,
                      data=np.ascontiguousarray(data),
                      metadata=self.output_metadata() or
                      (vec.metadata.select(self.indices_to_keep)
                       if vec.metadata else None))

    def transform_value(self, *vals):
        vec = np.asarray(vals[-1].value, np.float32)
        return OPVector(vec[self.indices_to_keep])

    def output_metadata(self) -> Optional[VectorMetadata]:
        return self.metadata

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(indices_to_keep=self.indices_to_keep,
                 metadata=self.metadata.to_json() if self.metadata else None,
                 summary=self.summary.to_json() if self.summary else None)
        return d

    @classmethod
    def from_save_args(cls, args: Dict[str, Any]) -> "SanityCheckerModel":
        return cls(
            indices_to_keep=args["indices_to_keep"],
            metadata=(VectorMetadata.from_json(args["metadata"])
                      if args.get("metadata") else None),
            summary=(SanityCheckerSummary.from_json(args["summary"])
                     if args.get("summary") else None),
            operation_name=args.get("operation_name", "sanityCheck"),
            uid=args.get("uid"))


class SanityChecker(Estimator):
    """Estimator2(RealNN label, OPVector) -> cleaned OPVector."""

    input_types = (RealNN, OPVector)
    output_type = OPVector

    @classmethod
    def _declare_params(cls):
        # defaults: reference SanityChecker.scala:721-736
        return [
            Param("check_sample", "fraction of data to check", 1.0),
            Param("sample_lower_limit", "min rows sampled", 1000),
            Param("sample_upper_limit", "max rows sampled", 1_000_000),
            Param("sample_seed", "sampling seed", 42),
            Param("remove_bad_features", "actually drop flagged columns", False),
            Param("max_correlation", "max |corr| with label", 0.95),
            Param("min_correlation", "min |corr| with label", 0.0),
            Param("min_variance", "min column variance", 1e-5),
            Param("max_cramers_v", "max Cramer's V vs label", 0.95),
            Param("correlation_type", "pearson|spearman", "pearson",
                  lambda v: v in ("pearson", "spearman")),
            Param("categorical_label", "force categorical-label tests", None),
            Param("remove_feature_group", "drop whole flagged groups", True),
            Param("protect_text_shared_hash", "keep shared text hash cols", False),
            Param("max_rule_confidence", "label-leakage rule confidence", 1.0),
            Param("min_required_rule_support", "rule support threshold", 1.0),
            Param("feature_label_corr_only", "skip full corr matrix", False),
            Param("max_corr_matrix_columns",
                  "widest vector for which the full d x d correlation matrix "
                  "is stored in the summary", 256),
        ]

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        self.device = device
        super().__init__("sanityCheck", uid=uid, **params)

    # -- sampling ----------------------------------------------------------
    def _fraction(self, total: int) -> float:
        """Reference SanityChecker.fraction:525."""
        ck = float(self.get_param("check_sample"))
        min_frac = min(1.0, float(self.get_param("sample_lower_limit")) / max(total, 1))
        max_frac = max(0.0, float(self.get_param("sample_upper_limit")) / max(total, 1))
        return max(min(ck, max_frac), min_frac)

    def fit_columns(self, *cols: Column) -> SanityCheckerModel:
        label_col, vec_col = cols
        y_all = np.asarray(label_col.data, np.float64).astype(np.float32)
        X_all = vec_col.data
        if X_all.ndim == 1:
            X_all = X_all[:, None]
        n_total = len(y_all)

        frac = self._fraction(n_total)
        if frac < 1.0:
            rng = np.random.default_rng(int(self.get_param("sample_seed")))
            take = rng.uniform(size=n_total) < frac
            X, y = X_all[take], y_all[take]
        else:
            X, y = X_all, y_all
        n = len(y)

        meta = vec_col.metadata
        names = (meta.column_names() if meta is not None
                 else [f"f{i}" for i in range(X.shape[1])])
        columns = (list(meta.columns) if meta is not None
                   else [None] * X.shape[1])

        # distinct label domain + per-value counts in ONE host pass over
        # the label only (np.unique(return_counts) — the previous
        # (y[:, None] == distinct[None, :]).sum(0) broadcast materialized
        # an O(n * k) boolean matrix, ~4GB at 10M rows x 100 classes)
        distinct, distinct_counts = np.unique(y, return_counts=True)
        cat_param = self.get_param("categorical_label")
        is_cat = (bool(cat_param) if cat_param is not None
                  else len(distinct) < min(100.0, n * 0.1))

        # full feature-feature matrix (one X^T X Gram) unless the user opts
        # out (reference featureLabelCorrOnly, SanityChecker.scala:193)
        # cap on columns for which the full d x d matrix is materialized and
        # stored in the summary: beyond this the matrix costs O(d^2) host
        # memory + JSON size for little diagnostic value (the drop logic only
        # needs corr-with-label)
        corr_matrix_cap = int(self.get_param("max_corr_matrix_columns"))
        want_matrix = (not bool(self.get_param("feature_label_corr_only"))
                       and self.get_param("correlation_type") == "pearson"
                       and X.shape[1] <= corr_matrix_cap)
        corr_matrix: Optional[np.ndarray] = None
        do_cat = is_cat and meta is not None and len(distinct) > 1
        group_stats: List[CategoricalGroupStats] = []
        cramers_by_col: Dict[int, float] = {}
        conf_by_col: Dict[int, Tuple[List[float], List[float]]] = {}

        # ONE engine pass over X; a raised max_corr_matrix_columns past the
        # engine's Gram cap computes the matrix in a second fused pass
        matrix_fused = want_matrix and X.shape[1] <= SE.GRAM_MAX_D
        (counts, means, mins, maxs, variances, corr, corr_matrix,
         label_stats_tuple, cont) = self._fused_device_stats(
            X, y, distinct if do_cat else None, columns, matrix_fused)
        if want_matrix and not matrix_fused:
            corr_matrix = _pearson_matrix(X, self.device)
        if do_cat and cont is not None:
            group_stats, cramers_by_col, conf_by_col = \
                self._categorical_from_contingency(
                    cont, columns, names, distinct_counts.astype(np.float64))

        # -- assemble per-column statistics --------------------------------
        col_stats_list: List[ColumnStatistics] = []
        for i, nm in enumerate(names):
            col_stats_list.append(ColumnStatistics(
                name=nm, column=columns[i], is_label=False,
                count=float(counts[i]), mean=float(means[i]),
                min=float(mins[i]), max=float(maxs[i]),
                variance=float(variances[i]),
                corr_label=float(corr[i]) if np.isfinite(corr[i]) else None,
                cramers_v=cramers_by_col.get(i),
                max_rule_confidences=conf_by_col.get(i, ([], []))[0],
                supports=conf_by_col.get(i, ([], []))[1],
            ))
        l_count, l_mean, l_var, l_min, l_max = label_stats_tuple
        label_stats = ColumnStatistics(
            name=self.input_names()[0] if self.input_names() else "label",
            column=None, is_label=True, count=l_count, mean=l_mean,
            min=l_min, max=l_max, variance=l_var)

        # parent-level maxima (reference maxByParent / corrParentMap)
        by_parent_corr: Dict[str, float] = {}
        by_parent_cv: Dict[str, float] = {}
        for st in col_stats_list:
            if st.column is None:
                continue
            p = st.column.parent_feature_name
            if st.corr_label is not None and not st.column.is_null_indicator:
                v = abs(st.corr_label)
                if np.isfinite(v):
                    by_parent_corr[p] = max(by_parent_corr.get(p, 0.0), v)
            if st.cramers_v is not None:
                by_parent_cv[p] = max(by_parent_cv.get(p, 0.0), st.cramers_v)
        for st in col_stats_list:
            if st.column is None:
                continue
            p = st.column.parent_feature_name
            if p in by_parent_corr:
                st.parent_corr = by_parent_corr[p]
            if p in by_parent_cv:
                st.parent_cramers_v = by_parent_cv[p]

        # rule-confidence group removals propagate to the whole group
        removed_groups = [
            st.feature_group() for st in col_stats_list
            if st.feature_group() is not None and any(
                conf > float(self.get_param("max_rule_confidence")) and
                sup > float(self.get_param("min_required_rule_support"))
                for conf, sup in zip(st.max_rule_confidences, st.supports))
        ]

        drop_reasons: Dict[str, List[str]] = {}
        drop_indices: List[int] = []
        for i, st in enumerate(col_stats_list):
            reasons = st.reasons_to_remove(
                min_variance=float(self.get_param("min_variance")),
                min_correlation=float(self.get_param("min_correlation")),
                max_correlation=float(self.get_param("max_correlation")),
                max_cramers_v=float(self.get_param("max_cramers_v")),
                max_rule_confidence=float(self.get_param("max_rule_confidence")),
                min_required_rule_support=float(
                    self.get_param("min_required_rule_support")),
                remove_feature_group=bool(self.get_param("remove_feature_group")),
                protect_text_shared_hash=bool(
                    self.get_param("protect_text_shared_hash")),
                removed_groups=removed_groups)
            if reasons:
                drop_reasons[st.name] = reasons
                drop_indices.append(i)

        if bool(self.get_param("remove_bad_features")):
            keep = [i for i in range(X.shape[1]) if i not in set(drop_indices)]
            if not keep:  # never drop everything
                keep = list(range(X.shape[1]))
        else:
            keep = list(range(X.shape[1]))

        summary = SanityCheckerSummary(
            correlation_type=self.get_param("correlation_type"),
            names=names,
            column_stats=[{
                "name": st.name, "count": st.count, "mean": st.mean,
                "min": st.min, "max": st.max, "variance": st.variance,
                "corr_label": st.corr_label, "cramers_v": st.cramers_v,
                "parent_corr": st.parent_corr,
                "parent_cramers_v": st.parent_cramers_v,
            } for st in [label_stats] + col_stats_list],
            categorical_stats=[{
                "group": g.group, "categorical_features": g.categorical_features,
                "cramers_v": g.cramers_v, "chi2": g.chi2,
                "mutual_info": g.mutual_info,
                "pointwise_mutual_info": g.pointwise_mutual_info,
                "contingency_matrix": g.contingency_matrix,
                "max_rule_confidences": g.max_rule_confidences,
                "supports": g.supports,
            } for g in group_stats],
            dropped=[names[i] for i in drop_indices],
            drop_reasons=drop_reasons,
            sample_fraction=frac,
            correlations_matrix=(corr_matrix.tolist()
                                 if corr_matrix is not None else None),
            label_distribution=(
                {"domain": [float(v) for v in distinct],
                 "counts": [float(c) for c in distinct_counts]}
                if is_cat else None),
            dropped_parents={
                names[i]: columns[i].parent_feature_name
                for i in drop_indices if columns[i] is not None},
        )
        out_meta = meta.select(keep) if meta is not None else None
        return SanityCheckerModel(indices_to_keep=keep, metadata=out_meta,
                                  summary=summary,
                                  operation_name=self.operation_name)

    # -- fused one-pass statistics ----------------------------------------
    @staticmethod
    def _grouped_columns(columns: Sequence[Optional[VectorColumnMetadata]]
                         ) -> Dict[str, List[int]]:
        """Indicator groups: columns carrying both grouping and
        indicator_value, keyed parent_grouping (reference :420)."""
        groups: Dict[str, List[int]] = {}
        for i, c in enumerate(columns):
            if c is None or c.grouping is None or c.indicator_value is None:
                continue
            groups.setdefault(f"{c.parent_feature_name}_{c.grouping}",
                              []).append(i)
        return groups

    def _fused_device_stats(self, X, y, distinct, columns, want_matrix):
        """ONE engine pass: moments + correlations (+ Pearson matrix +
        batched contingency) for pearson mode; spearman adds the blocked
        device rank pre-pass and a second moment pass over the ranks."""
        groups = self._grouped_columns(columns)
        distinct_dev = distinct if groups else None
        clip = None
        if distinct_dev is not None:
            # MultiPickList parents: multi-hot counts clip to 1 (ref :428).
            # Group-wise in the reference; per-column here with every
            # member of an MPL-touched group marked — same result.
            clip = np.zeros(X.shape[1], bool)
            for idxs in groups.values():
                if any(columns[i].parent_feature_type == "MultiPickList"
                       for i in idxs):
                    clip[idxs] = True
            if not clip.any():
                clip = None
        st = SE.run_stats(X, y, distinct=distinct_dev, clip=clip,
                          corr_matrix=want_matrix, device=self.device)
        if self.get_param("correlation_type") == "spearman":
            rx, ry = SE.rank_matrices(X, y, device=self.device)
            corr = SE.run_stats(rx, ry, device=self.device).corr_label
        else:
            corr = st.corr_label
        label_stats = (st.label_count, st.label_mean, st.label_variance,
                       st.label_min, st.label_max)
        return (st.count, st.mean, st.min, st.max, st.variance, corr,
                st.corr_matrix, label_stats, st.contingency)

    def _categorical_from_contingency(self, cont: np.ndarray,
                                      columns, names,
                                      label_totals: np.ndarray):
        """Per-group contingency statistics off the engine's batched
        [d, C] table — host numpy on tiny [k, C] slices, zero device
        round-trips (the legacy path dispatched one contingency matmul
        PLUS one contingency_stats program per group)."""
        groups = self._grouped_columns(columns)
        group_stats: List[CategoricalGroupStats] = []
        cramers_by_col: Dict[int, float] = {}
        conf_by_col: Dict[int, Tuple[List[float], List[float]]] = {}
        for group, idxs in groups.items():
            table = np.asarray(cont[idxs], np.float64)
            if len(idxs) == 1:
                # single indicator: synthesize the complement row (ref :477)
                table = np.concatenate(
                    [table, (label_totals - table[0])[None, :]], axis=0)
            st = SE.contingency_stats_host(table)
            k = len(idxs)
            confs = [float(v) for v in st.max_rule_confidences[:k]]
            sups = [float(v) for v in st.supports[:k]]
            cv = float(st.cramers_v)
            for j, i in enumerate(idxs):
                cramers_by_col[i] = cv
                conf_by_col[i] = ([confs[j]], [sups[j]])
            group_stats.append(CategoricalGroupStats(
                group=group,
                categorical_features=[names[i] for i in idxs],
                contingency_matrix=[[float(v) for v in row]
                                    for row in table],
                cramers_v=cv, chi2=float(st.chi2),
                mutual_info=float(st.mutual_info),
                pointwise_mutual_info=[[float(v) for v in row]
                                       for row in st.pointwise_mutual_info],
                max_rule_confidences=confs, supports=sups))
        return group_stats, cramers_by_col, conf_by_col


def _pearson_matrix(X: np.ndarray, device: DeviceLike) -> np.ndarray:
    """Full Pearson matrix past the engine's Gram cap, one product
    (reference ops/stats.pearson_matrix): missing values imputed to their
    column's mean."""
    Xd = torch.as_tensor(X, dtype=torch.float32,
                         device=resolve_device(device))
    finite = torch.isfinite(Xd)
    mean = torch.where(finite, Xd, 0.0).sum(0) / torch.clamp(
        finite.sum(0), min=1)
    Xf = torch.where(finite, Xd, mean[None, :])
    Xc = Xf - Xf.mean(0, keepdim=True)
    cov = Xc.T @ Xc
    sd = torch.sqrt(torch.clamp(torch.diag(cov), min=SE.EPS))
    return (cov / (sd[:, None] * sd[None, :])).cpu().numpy()
