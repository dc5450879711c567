"""XGBoost-class boosted-tree predictor (counterpart of models/trees.py).

Reference wrapper: core/.../impl/classification/OpXGBoostClassifier.scala;
param names mirror the XGBoost params the reference grids over. This slice
ports the binary classifier on the fold-fused fit (ops/trees.py): the
model selector's sweep fits every CV fold of a grid point in one
`fit_gbt_folds` call over one binned matrix, and the refit is the same fit
with one lane. Multiclass softprob boosting, the random-forest and
decision-tree families and the config-fused grid route come in later
slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..ops import trees as T
from ..stages.params import Param
from .base import PredictionModel, PredictorEstimator, stable_sigmoid


class TreeEnsembleModel(PredictionModel):
    """Fitted tree ensemble scored on raw feature values. `feat` /
    `thresh_val` / `miss` [n_trees, 2^depth - 1], `leaf` [n_trees, 2^depth,
    1]. This slice scores mode 'margin': logistic margins summed over the
    trees plus `base`."""

    def __init__(self, feat: np.ndarray, thresh_val: np.ndarray,
                 leaf: np.ndarray, depth: int, mode: str,
                 base: float = 0.0, n_classes: int = 2,
                 miss: Optional[np.ndarray] = None,
                 operation_name: str = "treeEnsemble",
                 uid: Optional[str] = None, device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        # owned, writable copies: the arrays may come from another
        # package's read-only buffers (convert.tree_model_from_jax)
        self.feat = np.array(feat, np.int32)
        self.thresh_val = np.array(thresh_val, np.float32)
        self.leaf = np.array(leaf, np.float32)
        self.miss = (np.zeros_like(self.feat) if miss is None
                     else np.array(miss, np.int32))
        self.depth = int(depth)
        self.mode = mode
        self.base = float(base)
        self.n_classes = int(n_classes)

    def predict_arrays(self, X):
        """X [n, d] -> (prediction [n], raw [n, 2], probability [n, 2]) as
        numpy arrays; the traversal runs on the model's device."""
        if self.mode != "margin":
            raise NotImplementedError(
                f"tree ensemble mode {self.mode!r} is not ported yet: the "
                "random-forest/decision-tree slice brings the other modes")
        dev = resolve_device(self.device)
        Xd = to_device(X, dev, label="predict")
        agg = T.predict_ensemble(
            torch.as_tensor(self.feat, device=dev),
            torch.as_tensor(self.thresh_val, device=dev),
            torch.as_tensor(self.leaf, device=dev), Xd, self.depth,
            miss=torch.as_tensor(self.miss, device=dev))
        margin = agg[:, 0].cpu().numpy() + self.base
        p1 = stable_sigmoid(margin)
        prob = np.stack([1.0 - p1, p1], axis=1)
        raw = np.stack([-margin, margin], axis=1)
        return (p1 >= 0.5).astype(np.float32), raw, prob

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(feat=self.feat, thresh_val=self.thresh_val, leaf=self.leaf,
                 miss=self.miss, depth=self.depth, mode=self.mode,
                 base=self.base, n_classes=self.n_classes)
        return d


class _TreeEstimator(PredictorEstimator):
    """Shared: quantile-bin on the device, grow, freeze raw-value thresholds."""

    # validator protocol: folds enter as weight masks over one binned matrix
    # (Validator._validate_mask_folds); bin edges come from the full
    # feature columns (labels never take part)
    supports_mask_folds = True

    def _bin(self, X: torch.Tensor):
        """(binned matrix, edges, n_bins) of X on X's device. NaN gets the
        dedicated bin 0 and routes by each node's learned direction."""
        n_bins = int(self.get_param("max_bins"))
        edges = T.quantile_edges(X, n_bins)
        return T.bin_matrix(X, edges), edges, n_bins

    def mask_sweep_context(self, X: torch.Tensor):
        """Binned context shared by every (grid point, fold) fit."""
        return self._bin(X)

    def _freeze(self, trees: T.Tree, edges: torch.Tensor) -> Dict[str, np.ndarray]:
        tv = T.thresholds_to_values(trees.feat, trees.thresh, edges)
        n_int = trees.feat.shape[-1]
        leaf = trees.leaf
        return dict(
            feat=trees.feat.reshape(-1, n_int).cpu().numpy(),
            thresh_val=tv.reshape(-1, n_int).cpu().numpy(),
            leaf=leaf.reshape(-1, leaf.shape[-2], leaf.shape[-1]).cpu().numpy(),
            miss=trees.miss.reshape(-1, n_int).cpu().numpy())

    def _key(self, device: torch.device) -> torch.Generator:
        """The fit's random stream, seeded from the `seed` param."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(self.get_param("seed")))
        return gen


class _XGBBase(_TreeEstimator):
    _regression = False

    @classmethod
    def _declare_params(cls):
        return [
            Param("num_round", "boosting rounds", 100),
            Param("eta", "learning rate", 0.3),
            Param("max_depth", "tree depth", 6),
            Param("max_bins", "histogram bins", 256),
            Param("min_child_weight", "min hessian per child", 1.0),
            Param("reg_lambda", "L2 on leaves", 1.0),
            Param("alpha", "L1 on leaf weights (soft-threshold)", 0.0),
            Param("gamma", "complexity penalty per split", 0.0),
            Param("subsample", "row subsample per round", 1.0),
            Param("colsample_bytree", "feature subsample per tree", 1.0),
            Param("colsample_bylevel", "feature subsample per level", 1.0),
            Param("scale_pos_weight", "positive-class weight multiplier "
                  "(binary; xgboost imbalance control)", 1.0),
            Param("max_delta_step", "cap on each leaf's raw newton step "
                  "(imbalanced-logistic stabilizer)", 0.0),
            Param("base_score", "initial prediction (None = weighted "
                  "label mean, a better-calibrated prior than xgboost's "
                  "fixed 0.5)", None),
            Param("seed", "rng seed", 42),
        ]

    def _common(self):
        base_score = self.get_param("base_score")
        return dict(
            n_rounds=int(self.get_param("num_round")),
            depth=int(self.get_param("max_depth")),
            learning_rate=float(self.get_param("eta")),
            reg_lambda=float(self.get_param("reg_lambda")),
            min_child_weight=float(self.get_param("min_child_weight")),
            gamma=float(self.get_param("gamma")),
            subsample=float(self.get_param("subsample")),
            feature_frac=float(self.get_param("colsample_bytree")),
            alpha=float(self.get_param("alpha")),
            max_delta_step=float(self.get_param("max_delta_step")),
            colsample_bylevel=float(self.get_param("colsample_bylevel")),
            base_score=None if base_score is None else float(base_score))

    def _apply_spw(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """scale_pos_weight: multiply positive-class weights — for the
        logistic objective exactly xgboost's g/h scaling of positive rows."""
        spw = float(self.get_param("scale_pos_weight"))
        if spw == 1.0 or self._regression:
            return w
        return w * torch.where(y == 1, spw, 1.0).to(torch.float32)

    def mask_fit_scores(self, ctx, y, w, masks, n_classes: int = 2,
                        multiclass: bool = False) -> torch.Tensor:
        """[F, n] margins: every fold of this grid point in one fold-fused
        fit against the shared binned matrix (masks [F, n] 1 = train)."""
        if multiclass:
            raise NotImplementedError(
                "multiclass boosting is not ported yet: softprob boosting "
                "comes with the grow_tree/forest slice")
        Xb, _, n_bins = ctx
        w = self._apply_spw(y, w)
        _, _, margins = T.fit_gbt_folds(
            Xb, y, masks * w[None, :], n_bins=n_bins,
            loss="squared" if self._regression else "logistic",
            generator=self._key(Xb.device), **self._common())
        return margins


class OpXGBoostClassifier(_XGBBase):
    """Reference OpXGBoostClassifier (JNI -> libxgboost): binary logistic,
    histogram algorithm."""

    problem_types = ("binary",)

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("xgbClassifier", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> TreeEnsembleModel:
        dev = resolve_device(self.device)
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        if yd.numel() and int(yd.max()) > 1:
            raise NotImplementedError(
                "multiclass boosting is not ported yet: softprob boosting "
                "comes with the grow_tree/forest slice")
        wd = torch.ones_like(yd) if w is None else \
            torch.as_tensor(w, dtype=torch.float32, device=dev)
        wd = self._apply_spw(yd, wd)
        Xb, edges, n_bins = self._bin(
            to_device(X, dev, label="fit"))
        kw = self._common()
        trees, base, _ = T.fit_gbt_folds(
            Xb, yd, wd[None, :], n_bins=n_bins, loss="logistic",
            generator=self._key(dev), **kw)
        frozen = self._freeze(trees, edges)
        return TreeEnsembleModel(depth=kw["depth"], mode="margin",
                                 base=float(base[0]),
                                 operation_name=self.operation_name,
                                 device=self.device, **frozen)
