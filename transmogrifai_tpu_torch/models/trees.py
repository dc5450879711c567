"""Tree-family predictors: decision tree, random forest, Spark GBT and
XGBoost (counterpart of models/trees.py).

Reference wrappers: core/.../impl/classification/{OpDecisionTreeClassifier,
OpRandomForestClassifier, OpGBTClassifier, OpXGBoostClassifier}.scala and
core/.../impl/regression/{OpDecisionTreeRegressor, OpRandomForestRegressor,
OpGBTRegressor, OpXGBoostRegressor}.scala; param names mirror the Spark and
XGBoost params the reference grids over. Every fit runs through the
level-wise grower of ops/trees.py on the four tree kernels: the model
selector's sweep fits every CV fold of a grid point as a lane of one fit
over one binned matrix (`mask_fit_scores`), and the refit is the same fit
with one lane. A K-class forest's lanes carry K + 2 histogram channels;
multiclass XGBoost grows each round's K class trees as K lanes of one fit
(`SoftmaxEnsembleModel`); Spark's GBT stays binary. While the run-metrics
collector is on, each fit is a "tree_fit" span of the trace and a kernel
record: its synchronised wall, its analytic HBM bytes
(ops/tree_kernels.fused_fit_bytes) and the launches of each kernel in it.
Config-fused grid route (`mask_fit_scores_grid`): the boosted families'
grid points of one structure (`grid_fuse_signature`) differ only in the
split and leaf scalars (`_LANE_KEYS`), so a group of them fits as one
fold-fused fit whose lanes are (config, fold) pairs, fold-major, each lane
with its own scalars; the lane planner (ops/tree_kernels.plan_lane_chunk)
bounds how many configs a fit takes.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..ops import tree_kernels as TK
from ..ops import trees as T
from ..utils.metrics import collector
from ..stages.params import Param
from .base import PredictionModel, PredictorEstimator, stable_sigmoid


class TreeEnsembleModel(PredictionModel):
    """Fitted tree ensemble scored on raw feature values. `feat` /
    `thresh_val` / `miss` [n_trees, 2^depth - 1], `leaf` [n_trees, 2^depth,
    K]. The traversal runs on the model's device.

    mode: 'classify_mean' — payload K = n_classes distributions, averaged
          'margin'        — payload K = 1 logistic margins, summed + base
          'regress_mean'  — payload K = 1 values, averaged
          'regress_sum'   — payload K = 1 boosting steps, summed + base
    """

    MODES = ("classify_mean", "margin", "regress_mean", "regress_sum")

    def __init__(self, feat: np.ndarray, thresh_val: np.ndarray,
                 leaf: np.ndarray, depth: int, mode: str,
                 base: float = 0.0, n_classes: int = 2,
                 miss: Optional[np.ndarray] = None,
                 operation_name: str = "treeEnsemble",
                 uid: Optional[str] = None, device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        if mode not in self.MODES:
            raise NotImplementedError(
                f"tree ensemble mode {mode!r} is not ported yet (the port "
                f"has {self.MODES})")
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
        """X [n, d] -> (prediction [n], raw [n, c] or None, probability
        [n, c] or None) as numpy arrays."""
        dev = resolve_device(self.device)
        Xd = to_device(X, dev, label="predict")
        agg = T.predict_ensemble(
            torch.as_tensor(self.feat, device=dev),
            torch.as_tensor(self.thresh_val, device=dev),
            torch.as_tensor(self.leaf, device=dev), Xd, self.depth,
            miss=torch.as_tensor(self.miss, device=dev)).cpu().numpy()
        n_trees = self.feat.shape[0]
        if self.mode == "classify_mean":
            prob = np.clip(agg / n_trees, 0.0, None)
            prob = prob / np.maximum(prob.sum(axis=1, keepdims=True), 1e-12)
            return prob.argmax(axis=1).astype(np.float32), agg, prob
        if self.mode == "margin":
            margin = agg[:, 0] + self.base
            p1 = stable_sigmoid(margin)
            prob = np.stack([1.0 - p1, p1], axis=1)
            raw = np.stack([-margin, margin], axis=1)
            return (p1 >= 0.5).astype(np.float32), raw, prob
        if self.mode == "regress_mean":
            return (agg[:, 0] / n_trees).astype(np.float32), None, None
        return (agg[:, 0] + self.base).astype(np.float32), None, None

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(feat=self.feat, thresh_val=self.thresh_val, leaf=self.leaf,
                 miss=self.miss, depth=self.depth, mode=self.mode,
                 base=self.base, n_classes=self.n_classes)
        return d


class SoftmaxEnsembleModel(PredictionModel):
    """Multiclass boosted ensemble (reference SoftmaxEnsembleModel): trees
    round-major, [rounds * n_classes, ...], class c's trees at c::n_classes
    with one-channel leaves; class margins are their payload sums, traversed
    on the model's device; probabilities their softmax."""

    def __init__(self, feat: np.ndarray, thresh_val: np.ndarray,
                 leaf: np.ndarray, depth: int, n_classes: int,
                 miss: Optional[np.ndarray] = None,
                 operation_name: str = "xgbSoftmax",
                 uid: Optional[str] = None, device: DeviceLike = None):
        super().__init__(operation_name, uid=uid, device=device)
        self.feat = np.array(feat, np.int32)
        self.thresh_val = np.array(thresh_val, np.float32)
        self.leaf = np.array(leaf, np.float32)
        self.miss = (np.zeros_like(self.feat) if miss is None
                     else np.array(miss, np.int32))
        self.depth = int(depth)
        self.n_classes = int(n_classes)

    def predict_arrays(self, X):
        dev = resolve_device(self.device)
        Xd = to_device(X, dev, label="predict")
        C = self.n_classes

        def part(a, c):
            return torch.as_tensor(np.ascontiguousarray(a[c::C]), device=dev)
        margins = torch.stack([T.predict_ensemble(
            part(self.feat, c), part(self.thresh_val, c),
            part(self.leaf, c), Xd, self.depth,
            miss=part(self.miss, c))[:, 0] for c in range(C)], dim=1)
        e = torch.exp(margins - margins.amax(dim=1, keepdim=True))
        prob = e / e.sum(dim=1, keepdim=True)
        pred = prob.argmax(dim=1).to(torch.float32)
        return pred.cpu().numpy(), margins.cpu().numpy(), prob.cpu().numpy()

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d.update(feat=self.feat, thresh_val=self.thresh_val, leaf=self.leaf,
                 miss=self.miss, depth=self.depth, n_classes=self.n_classes)
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
        """Context shared by every (grid point, fold) fit of a group: the
        binned matrix, its edges, n_bins, and a store for the forests'
        random draws (the group's grid points share them)."""
        return (*self._bin(X), {})

    def _freeze(self, trees: T.Tree, edges: torch.Tensor) -> Dict[str, np.ndarray]:
        tv = T.thresholds_to_values(trees.feat, trees.thresh, edges)
        n_int = trees.feat.shape[-1]
        leaf = trees.leaf
        return dict(
            feat=trees.feat.reshape(-1, n_int).cpu().numpy(),
            thresh_val=tv.reshape(-1, n_int).cpu().numpy(),
            leaf=leaf.reshape(-1, leaf.shape[-2], leaf.shape[-1]).cpu().numpy(),
            miss=trees.miss.reshape(-1, n_int).cpu().numpy())

    # (device, label, binned shape, lanes, depth, rounds) of the fits this
    # process has timed: the first of a shape is cold (its wall includes
    # the kernels' build)
    _WARM_SHAPES: set = set()

    @staticmethod
    def _timed_fit(label: str, Xb: torch.Tensor, lanes: int, depth: int,
                   n_rounds: int, call: Callable[[], Any]) -> Any:
        """Run one fit; while the collector is on, as a "tree_fit" span,
        timed to the device's completion and recorded as a kernel record
        with its analytic bytes and each kernel's launches in it."""
        if not collector.enabled:
            return call()
        sig = (str(Xb.device), label, tuple(Xb.shape), str(Xb.dtype),
               int(lanes), int(depth), int(n_rounds))
        cold = sig not in _TreeEstimator._WARM_SHAPES
        before = dict(TK.launches)
        with collector.trace_span(label, kind="tree_fit", lanes=int(lanes),
                                  depth=int(depth)):
            t0 = time.perf_counter()
            out = call()
            if Xb.device.type == "cuda":
                torch.cuda.synchronize(Xb.device)
            wall = time.perf_counter() - t0
        collector.kernel(
            label, wall,
            TK.fused_fit_bytes(Xb.shape[0], Xb.shape[1], int(lanes),
                               int(depth), int(n_rounds),
                               xb_itemsize=Xb.element_size()),
            cold=cold, device=Xb.device,
            attrs=dict(lanes=int(lanes), depth=int(depth),
                       n_rounds=int(n_rounds), n_rows=int(Xb.shape[0]),
                       n_feat=int(Xb.shape[1]),
                       launches={k: TK.launches[k] - before.get(k, 0)
                                 for k in TK.launches}))
        _TreeEstimator._WARM_SHAPES.add(sig)
        return out

    # -- config-fused sweep (grid points batched into the lane axis) -------
    # fit_gbt_folds' scalars that may vary a lane; every other keyword must
    # match across a fused group
    _LANE_KEYS = T.LANE_KEYS
    _LANE_DEFAULTS = {"learning_rate": 0.1, "reg_lambda": 1.0,
                      "min_child_weight": 0.0, "gamma": 0.0}
    # the fused form of the last mask_fit_scores_grid call (the validator
    # labels its cells "mask_folds:" + this)
    _last_grid_route = "grid_fused"

    def _sweep_kw(self) -> Optional[Dict[str, Any]]:
        """The keywords this family passes to fit_gbt_folds (hook); None:
        the family does not fuse."""
        return None

    def grid_fuse_signature(self, grid) -> Optional[tuple]:
        """Hashable structural signature of a grid point: grid points of
        equal signatures fit as lanes of one fit (they differ only in
        `_LANE_KEYS`); None: this grid point does not fuse. The seed comes
        from the grid-applied copy: a swept seed splits the group (one
        generator drives the shared subsample and column draws)."""
        est_g = self.copy(**grid)
        kw = est_g._sweep_kw()
        if kw is None:
            return None
        items = tuple(sorted((k, v) for k, v in kw.items()
                             if k not in self._LANE_KEYS))
        return items + (("loss", getattr(self, "_loss", "logistic")),
                        ("seed", int(est_g.get_param("seed"))
                         if est_g.has_param("seed") else 0))

    def mask_fit_scores_grid(self, ctx, y, w, masks, grids,
                             n_classes: int = 2, multiclass: bool = False
                             ) -> Optional[torch.Tensor]:
        """[G, F, n] scores of a group of same-signature grid points from
        as few fused fits as the lane planner allows, or None (the
        validator then fits config by config): a multiclass classifier, a
        family without `_sweep_kw` (forests), fewer than 2 grid points,
        mixed signatures, or a planner answer of 0. Lanes are fold-major,
        lane = fold x chunk + config, over the shared binned matrix; each
        config's W carries its own scale_pos_weight (`_apply_spw`) and its
        lanes their own `_LANE_KEYS`; the group's generator is the first
        grid point's."""
        regression = (getattr(self, "_regression", False)
                      or getattr(self, "_loss", "logistic") == "squared")
        if (multiclass and not regression) or len(grids) < 2:
            return None
        kws = [self.copy(**g)._sweep_kw() for g in grids]
        if any(k is None for k in kws):
            return None
        if len({self.grid_fuse_signature(g) for g in grids}) != 1:
            return None
        Xb, _, n_bins, _ = ctx
        F, n = masks.shape
        G = len(grids)
        depth = kws[0]["depth"]
        chunk = TK.plan_lane_chunk(Xb.shape[1], n_bins + 1, F, G, depth, n,
                                   device=Xb.device,
                                   xb_itemsize=Xb.element_size())
        if chunk == 0:
            return None
        self._last_grid_route = "grid_fused"
        dev = Xb.device
        outs = []
        for lo in range(0, G, chunk):
            sub = kws[lo:lo + chunk]
            g_here = len(sub)
            w_cfg = torch.stack([
                self.copy(**grids[gi])._apply_spw(y, w, multiclass)
                if hasattr(self, "_apply_spw") else w
                for gi in range(lo, lo + g_here)])            # [g, n]
            W_lanes = (masks[:, None, :] * w_cfg[None]).reshape(
                F * g_here, n)
            lane_vec = {
                key: torch.tensor(
                    [float(k.get(key, self._LANE_DEFAULTS[key]))
                     for k in sub], dtype=torch.float32,
                    device=dev).repeat(F)
                for key in self._LANE_KEYS}
            shared = {k: v for k, v in sub[0].items()
                      if k not in self._LANE_KEYS}
            gen = self.copy(**grids[lo])._key(dev)
            _, _, margins = self._timed_fit(
                "tree_sweep_grid_fused", Xb, F * g_here, depth,
                shared["n_rounds"],
                lambda W_lanes=W_lanes, lane_vec=lane_vec, shared=shared,
                gen=gen: T.fit_gbt_folds(
                    Xb, y, W_lanes, n_bins=n_bins, loss=self._loss,
                    generator=gen, **shared, **lane_vec))
            outs.append(margins.reshape(F, g_here, n).transpose(0, 1))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _key(self, device: torch.device) -> torch.Generator:
        """The fit's random stream, seeded from the `seed` param."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(self.get_param("seed")))
        return gen

    def _device_arrays(self, X, y, w):
        """(X, y, w) as float32 tensors on the estimator's device (w of
        ones when None)."""
        dev = resolve_device(self.device)
        yd = torch.as_tensor(y, dtype=torch.float32, device=dev)
        wd = torch.ones_like(yd) if w is None else \
            torch.as_tensor(w, dtype=torch.float32, device=dev)
        return to_device(X, dev, label="fit"), yd, wd

    def _fit_boosted(self, Xd, yd, wd, mode: str, loss: str,
                     kw: Dict[str, Any]) -> TreeEnsembleModel:
        """The boosted refit (Spark GBT, XGBoost): bin, one-lane fit_gbt
        with `kw`, frozen trees behind the base score."""
        Xb, edges, n_bins = self._bin(Xd)
        trees, base = self._timed_fit(
            "tree_refit", Xb, 1, kw["depth"], kw["n_rounds"],
            lambda: T.fit_gbt(Xb, yd, wd, n_bins=n_bins, loss=loss,
                              generator=self._key(Xb.device), **kw))
        return TreeEnsembleModel(depth=kw["depth"], mode=mode,
                                 base=float(base),
                                 operation_name=self.operation_name,
                                 device=self.device,
                                 **self._freeze(trees, edges))


def _feature_frac(strategy: str, n_feat: int, classification: bool) -> float:
    """Spark featureSubsetStrategy -> fraction (RandomForest.scala
    defaults)."""
    if strategy == "all":
        return 1.0
    if strategy == "auto":
        return (np.sqrt(n_feat) / n_feat) if classification else (1.0 / 3.0)
    if strategy == "sqrt":
        return np.sqrt(n_feat) / n_feat
    if strategy == "log2":
        return max(np.log2(max(n_feat, 2)) / n_feat, 1.0 / n_feat)
    if strategy == "onethird":
        return 1.0 / 3.0
    try:
        return float(strategy)
    except ValueError:
        return 1.0


def _class_payload(y: torch.Tensor, W: torch.Tensor,
                   n_classes: int) -> torch.Tensor:
    """[Fo, n_classes, n] one-hot labels times each lane's weights."""
    onehot = torch.nn.functional.one_hot(y.long(), n_classes).T
    return onehot.to(torch.float32)[None] * W[:, None, :]


class _ForestBase(_TreeEstimator):
    classification = True

    @classmethod
    def _declare_params(cls):
        return [
            Param("num_trees", "ensemble size", 50),
            Param("max_depth", "tree depth", 5),
            Param("max_bins", "histogram bins", 32),
            Param("min_instances_per_node", "min rows per child", 1),
            Param("min_info_gain", "min impurity decrease", 0.0),
            Param("subsampling_rate", "bootstrap rate", 1.0),
            Param("feature_subset_strategy", "auto|all|sqrt|log2|onethird",
                  "auto"),
            Param("impurity", "gini|entropy|variance (variance-equivalent "
                  "gain used)", "gini"),
            Param("seed", "rng seed", 42),
        ]

    def _forest_cfg(self, n_feat: int) -> Dict[str, Any]:
        return dict(
            n_trees=int(self.get_param("num_trees")),
            subsample=float(self.get_param("subsampling_rate")),
            feature_frac=float(_feature_frac(
                str(self.get_param("feature_subset_strategy")), n_feat,
                self.classification)),
            bootstrap=True)

    def _forest_kw(self, n_feat: int) -> Dict[str, Any]:
        return dict(self._forest_cfg(n_feat),
                    depth=int(self.get_param("max_depth")),
                    min_instances=float(
                        self.get_param("min_instances_per_node")),
                    min_info_gain=float(self.get_param("min_info_gain")),
                    seed=int(self.get_param("seed")), leaf_mode="mean")

    def _draws(self, Xb: torch.Tensor, kw: Dict[str, Any],
               store: dict) -> T.ForestDraws:
        """The sweep group's draws for this grid point's seed and rates
        (`store`: the mask_sweep_context's), drawn once for the group."""
        draws = T.ForestDraws(kw["seed"], Xb.shape[0], Xb.shape[1],
                              subsample=kw["subsample"],
                              feature_frac=kw["feature_frac"],
                              bootstrap=kw["bootstrap"], device=Xb.device)
        return store.setdefault(draws.key, draws)

    def mask_fit_scores(self, ctx, y, w, masks, n_classes: int = 2,
                        multiclass: bool = False) -> torch.Tensor:
        """[F, n] scores: every fold of this grid point as a lane of one
        forest fit against the shared binned matrix (masks [F, n], 1 =
        train); the folds share the bootstrap and the feature subsets.
        Binary classifiers return the margin log(p1 / (1 - p1)) of the
        averaged class distribution (p1 clipped to [1e-7, 1 - 1e-7]),
        multiclass ones the distribution itself [F, n, c], regressors the
        averaged value, as the reference's sweep scores them."""
        Xb, _, n_bins, store = ctx
        kw = self._forest_kw(Xb.shape[1])
        W = masks * w[None, :]
        G = _class_payload(y, W, n_classes) if self.classification \
            else (y[None, :] * W)[:, None, :]
        _, agg = self._timed_fit(
            "forest_sweep_fold_fused", Xb, masks.shape[0], kw["depth"],
            kw["n_trees"],
            lambda: T.fit_forest_folds(Xb, G, W, n_bins=n_bins,
                                       draws=self._draws(Xb, kw, store),
                                       **kw))
        if not self.classification:
            return agg[:, 0] / kw["n_trees"]
        prob = torch.clamp(agg / kw["n_trees"], min=0.0)
        prob = prob / torch.clamp(prob.sum(dim=1, keepdim=True), min=1e-12)
        if multiclass:
            return prob.transpose(1, 2)
        p1 = torch.clamp(prob[:, 1], 1e-7, 1.0 - 1e-7)
        return torch.log(p1 / (1.0 - p1))

    def _fit_forest(self, X, y, w, n_classes: Optional[int]):
        """Frozen trees of the refit (classes one-hot when `n_classes`)."""
        Xd, yd, wd = self._device_arrays(X, y, w)
        Xb, edges, n_bins = self._bin(Xd)
        G = _class_payload(yd, wd[None, :], n_classes)[0].T \
            if n_classes is not None else (yd * wd)[:, None]
        kw = self._forest_kw(Xb.shape[1])
        trees = self._timed_fit(
            "forest_refit", Xb, 1, kw["depth"], kw["n_trees"],
            lambda: T.fit_forest(Xb, G, wd, n_bins=n_bins, **kw))
        return self._freeze(trees, edges)


class OpRandomForestClassifier(_ForestBase):
    """Reference OpRandomForestClassifier (impl/classification/), binary
    and multiclass: K classes grow with K + 2 histogram channels."""

    problem_types = ("binary", "multiclass")
    classification = True

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("randomForestClassifier", uid=uid, device=device,
                         **params)

    def fit_arrays(self, X, y, w=None) -> TreeEnsembleModel:
        y = np.asarray(y)
        n_classes = max(int(np.max(y)) + 1 if y.size else 2, 2)
        frozen = self._fit_forest(X, y, w, n_classes)
        return TreeEnsembleModel(depth=int(self.get_param("max_depth")),
                                 mode="classify_mean", n_classes=n_classes,
                                 operation_name=self.operation_name,
                                 device=self.device, **frozen)


class OpRandomForestRegressor(_ForestBase):
    """Reference OpRandomForestRegressor (impl/regression/)."""

    problem_types = ("regression",)
    classification = False
    produces_probabilities = False

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("randomForestRegressor", uid=uid, device=device,
                         **params)

    def fit_arrays(self, X, y, w=None) -> TreeEnsembleModel:
        frozen = self._fit_forest(X, y, w, None)
        return TreeEnsembleModel(depth=int(self.get_param("max_depth")),
                                 mode="regress_mean",
                                 operation_name=self.operation_name,
                                 device=self.device, **frozen)


def _single_tree_params():
    return [p for p in _ForestBase._declare_params()
            if p.name not in ("num_trees", "subsampling_rate",
                              "feature_subset_strategy")]


class OpDecisionTreeClassifier(OpRandomForestClassifier):
    """Reference OpDecisionTreeClassifier: one tree, every feature, no
    bagging."""

    def _forest_cfg(self, n_feat: int) -> Dict[str, Any]:
        return dict(n_trees=1, subsample=1.0, feature_frac=1.0,
                    bootstrap=False)

    @classmethod
    def _declare_params(cls):
        return _single_tree_params()

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        PredictorEstimator.__init__(self, "decisionTreeClassifier", uid=uid,
                                    device=device, **params)


class OpDecisionTreeRegressor(OpRandomForestRegressor):
    """Reference OpDecisionTreeRegressor."""

    _forest_cfg = OpDecisionTreeClassifier._forest_cfg

    @classmethod
    def _declare_params(cls):
        return _single_tree_params()

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        PredictorEstimator.__init__(self, "decisionTreeRegressor", uid=uid,
                                    device=device, **params)


class _GBTBase(_TreeEstimator):
    """Spark's GBT: Newton leaves, reg_lambda 1, no minimum child weight,
    `min_instances_per_node` and `min_info_gain` on the splits."""

    _loss = "logistic"

    @classmethod
    def _declare_params(cls):
        return [
            Param("max_iter", "boosting rounds", 20),
            Param("max_depth", "tree depth", 5),
            Param("max_bins", "histogram bins", 32),
            Param("step_size", "learning rate", 0.1),
            Param("min_instances_per_node", "min rows per child", 1),
            Param("min_info_gain", "min gain to split", 0.0),
            Param("subsampling_rate", "row subsample per round", 1.0),
            Param("seed", "rng seed", 42),
        ]

    def _gbt_kw(self):
        return dict(
            n_rounds=int(self.get_param("max_iter")),
            depth=int(self.get_param("max_depth")),
            learning_rate=float(self.get_param("step_size")),
            min_instances=float(self.get_param("min_instances_per_node")),
            min_info_gain=float(self.get_param("min_info_gain")),
            subsample=float(self.get_param("subsampling_rate")))

    _sweep_kw = _gbt_kw   # config-fused sweep hook

    def mask_fit_scores(self, ctx, y, w, masks, n_classes: int = 2,
                        multiclass: bool = False) -> torch.Tensor:
        """[F, n] margins (classifier) or values (regressor): every fold of
        this grid point as a lane of one boosted fit."""
        if multiclass:
            raise ValueError("Spark's GBT is binary: it takes no "
                             "multiclass sweep")
        Xb, _, n_bins, _ = ctx
        kw = self._gbt_kw()
        _, _, margins = self._timed_fit(
            "tree_sweep_fold_fused", Xb, masks.shape[0], kw["depth"],
            kw["n_rounds"],
            lambda: T.fit_gbt_folds(
                Xb, y, masks * w[None, :], n_bins=n_bins, loss=self._loss,
                generator=self._key(Xb.device), **kw))
        return margins

    def _fit(self, X, y, w, mode: str) -> TreeEnsembleModel:
        return self._fit_boosted(*self._device_arrays(X, y, w), mode,
                                 self._loss, self._gbt_kw())


class OpGBTClassifier(_GBTBase):
    """Reference OpGBTClassifier: binary only, as Spark's GBTClassifier."""

    problem_types = ("binary",)

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("gbtClassifier", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> TreeEnsembleModel:
        return self._fit(X, y, w, "margin")


class OpGBTRegressor(_GBTBase):
    """Reference OpGBTRegressor."""

    problem_types = ("regression",)
    produces_probabilities = False
    _loss = "squared"

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("gbtRegressor", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> TreeEnsembleModel:
        return self._fit(X, y, w, "regress_sum")


class _XGBBase(_TreeEstimator):
    _regression = False
    _loss = "logistic"

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

    _sweep_kw = _common   # config-fused sweep hook

    def _apply_spw(self, y: torch.Tensor, w: torch.Tensor,
                   multiclass: bool = False) -> torch.Tensor:
        """scale_pos_weight: multiply positive-class weights — for the
        logistic objective exactly xgboost's g/h scaling of positive rows;
        a multiclass fit has no positive class."""
        spw = float(self.get_param("scale_pos_weight"))
        if spw == 1.0 or self._regression or multiclass:
            return w
        return w * torch.where(y == 1, spw, 1.0).to(torch.float32)

    def _check_multiclass_params(self) -> None:
        if self.get_param("base_score") is not None:
            # softmax boosting has no scalar prior: dropping the param in
            # silence would ignore it
            raise ValueError(
                "base_score is only supported for binary/regression "
                "xgboost fits (softmax margins start at 0, matching "
                "xgboost multi:softprob)")

    def _softmax_kw(self) -> Dict[str, Any]:
        self._check_multiclass_params()
        return {k: v for k, v in self._common().items() if k != "base_score"}

    def mask_fit_scores(self, ctx, y, w, masks, n_classes: int = 2,
                        multiclass: bool = False) -> torch.Tensor:
        """[F, n] margins (binary classifier) or values (regressor), [F, n,
        c] class margins (multiclass): every fold of this grid point in one
        fold-fused fit against the shared binned matrix (masks [F, n] 1 =
        train)."""
        Xb, _, n_bins, _ = ctx
        multiclass = multiclass and not self._regression
        W = masks * self._apply_spw(y, w, multiclass)[None, :]
        if multiclass:
            kw = self._softmax_kw()
            _, margins = self._timed_fit(
                "tree_sweep_softmax_fused", Xb, masks.shape[0] * n_classes,
                kw["depth"], kw["n_rounds"],
                lambda: T.fit_gbt_softmax_folds(
                    Xb, y, W, n_bins=n_bins, n_classes=n_classes,
                    generator=self._key(Xb.device), **kw))
            return margins
        kw = self._common()
        _, _, margins = self._timed_fit(
            "tree_sweep_fold_fused", Xb, masks.shape[0], kw["depth"],
            kw["n_rounds"],
            lambda: T.fit_gbt_folds(
                Xb, y, W, n_bins=n_bins, loss=self._loss,
                generator=self._key(Xb.device), **kw))
        return margins

    def _fit(self, X, y, w, mode: str) -> PredictionModel:
        Xd, yd, wd = self._device_arrays(X, y, w)
        n_classes = int(yd.max()) + 1 if yd.numel() else 2
        if self._regression or n_classes <= 2:
            return self._fit_boosted(Xd, yd, self._apply_spw(yd, wd), mode,
                                     self._loss, self._common())
        kw = self._softmax_kw()
        Xb, edges, n_bins = self._bin(Xd)
        trees = self._timed_fit(
            "tree_refit_softmax", Xb, n_classes, kw["depth"],
            kw["n_rounds"],
            lambda: T.fit_gbt_softmax(Xb, yd, wd, n_bins=n_bins,
                                      n_classes=n_classes,
                                      generator=self._key(Xb.device), **kw))
        return SoftmaxEnsembleModel(depth=kw["depth"], n_classes=n_classes,
                                    operation_name=self.operation_name,
                                    device=self.device,
                                    **self._freeze(trees, edges))


class OpXGBoostClassifier(_XGBBase):
    """Reference OpXGBoostClassifier (JNI -> libxgboost): binary logistic
    or multiclass softprob, histogram algorithm."""

    problem_types = ("binary", "multiclass")

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("xgbClassifier", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> PredictionModel:
        return self._fit(X, y, w, "margin")


class OpXGBoostRegressor(_XGBBase):
    """Reference OpXGBoostRegressor: squared-error objective."""

    problem_types = ("regression",)
    produces_probabilities = False
    _regression = True
    _loss = "squared"

    def __init__(self, uid: Optional[str] = None, device: DeviceLike = None,
                 **params):
        super().__init__("xgbRegressor", uid=uid, device=device, **params)

    def fit_arrays(self, X, y, w=None) -> TreeEnsembleModel:
        return self._fit(X, y, w, "regress_sum")
