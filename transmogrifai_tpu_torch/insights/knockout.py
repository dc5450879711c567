"""Batched LOCO knockouts, one device program per model family
(counterpart of insights/knockout.py).

Reference RecordInsightsLOCO.scala:62 loops rows x columns through the
fitted Spark model. Here the knockout axis is part of the tensor program:

- GLM families (logistic / SVC / softmax / linear / naive Bayes): zeroing
  column j shifts the margin by ``-X[:, j] * beta[j]``, so all [n, d]
  knockouts are one elementwise program in closed form.
- Tree ensembles: every tree is traversed for the base rows and for each
  feature the ensemble splits on (the others have identically zero delta),
  all knockouts of a row chunk as one leading axis of one traversal.

Plain PyTorch on the model's device (None: CUDA), float32 inside, float64
numpy out, the same [n, d, c] delta tensor as the host loop
(`RecordInsightsLOCO.insights_matrix_loop`). The JAX package sends trees
on the CPU to its native host traversal when that library is present; the
port has none, so trees take the batched route on both devices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_ROW_CHUNK = 4096
# Elements of one traversal step ([knockouts + 1, rows, trees]) at most: a
# chunk's index and value planes then stay within ~1 GB on the device
_KNOCK_ELEMENTS = 1 << 24


def _rows(n: int, per_row: int, row_chunk: int) -> int:
    """Rows a chunk takes: at most `row_chunk`, and at most
    _KNOCK_ELEMENTS // per_row."""
    return max(1, min(row_chunk, n, _KNOCK_ELEMENTS // max(per_row, 1)))


# -- GLM closed forms --------------------------------------------------------

def _logistic_deltas(X, beta, b0):
    """[n, d, 2] probability deltas for a binary logistic model."""
    m = X @ beta + b0                                   # [n]
    knocked = m[:, None] - X * beta[None, :]            # [n, d]
    dp1 = torch.sigmoid(m)[:, None] - torch.sigmoid(knocked)
    return torch.stack([-dp1, dp1], dim=2)


def _margin_deltas(X, beta):
    """[n, d, 2] raw-margin deltas (SVC: no probabilities, score = raw)."""
    dm = X * beta[None, :]                              # [n, d]
    return torch.stack([-dm, dm], dim=2)


def _softmax_deltas(X, B, b0):
    """[n, d, c] probability deltas for a multinomial logistic model."""
    logits = X @ B + b0[None, :]                        # [n, c]
    knocked = logits[:, None, :] - X[:, :, None] * B[None, :, :]  # [n, d, c]
    return (torch.softmax(logits, dim=-1)[:, None, :]
            - torch.softmax(knocked, dim=-1))


def _linreg_deltas(X, beta, b0, log_link: bool):
    """[n, d, 1] prediction deltas for a (log-)linear regression."""
    if not log_link:
        return (X * beta[None, :])[:, :, None]
    eta = X @ beta + b0
    knocked = eta[:, None] - X * beta[None, :]
    return (torch.exp(eta)[:, None] - torch.exp(knocked))[:, :, None]


def _nb_deltas(X, log_prob, log_prior):
    """[n, d, c] probability deltas for naive Bayes (raw = relu(X) @ W.T)."""
    A = torch.clamp(X, min=0.0)
    raw = A @ log_prob.T + log_prior[None, :]           # [n, c]
    knocked = raw[:, None, :] - A[:, :, None] * log_prob.T[None, :, :]
    return (torch.softmax(raw, dim=-1)[:, None, :]
            - torch.softmax(knocked, dim=-1))


def _glm_deltas(fn, X: torch.Tensor, *params) -> np.ndarray:
    """`fn(X_chunk, *params)` over row chunks of at most
    _KNOCK_ELEMENTS // d rows, as one float64 [n, d, c] array."""
    n, d = X.shape
    c = _rows(n, d, n)
    parts = [fn(X[s:s + c], *params).cpu().numpy().astype(np.float64)
             for s in range(0, n, c)]
    return np.concatenate(parts) if parts else \
        fn(X, *params).cpu().numpy().astype(np.float64)


# -- tree ensembles ----------------------------------------------------------

def _traverse_pertree(feat, thresh, miss, X, depth: int,
                      knock: Optional[torch.Tensor] = None):
    """Leaf index per (row, tree) on raw values: [N, T] int64, or with
    `knock` [A] (feature ids, -1 for none) [A, N, T], row i of knockout a
    read with column knock[a] zeroed.

    Same routing contract as ops/trees.predict_ensemble: present values go
    right iff x >= thresh (NaN compares False), missing rows follow the
    learned ``miss`` direction."""
    N = X.shape[0]
    T = feat.shape[0]
    lead = () if knock is None else (knock.shape[0],)
    rows = torch.arange(N, device=X.device).view(
        *(1,) * len(lead), N, 1)
    t_idx = torch.arange(T, device=X.device).view(
        *(1,) * len(lead), 1, T)
    rel = torch.zeros(lead + (N, T), dtype=torch.int64, device=X.device)
    for d in range(depth):
        gi = (1 << d) - 1 + rel
        f = feat[t_idx, gi]                             # [(A,) N, T]
        tv = thresh[t_idx, gi]
        x = X[rows, f]
        if knock is not None:
            x = torch.where(f == knock.view(-1, 1, 1), 0.0, x)
        nan = torch.isnan(x)
        right = (~nan & (x >= tv)) | (nan & (miss[t_idx, gi] > 0))
        rel = 2 * rel + right.to(torch.int64)
    return rel


def _tree_knockout_sums(feat, thresh, leaf, miss, W, X, active, depth: int):
    """Aggregate scores, base and knocked out, in one traversal.

    leaf: [T, L, K]; W: [T, G] per-tree group weights (softmax boosting
    groups trees by class; binary and regression use G = 1, all ones).
    Returns (base [N, G, K], knocked [A, N, G, K]) where knocked[a] is the
    aggregate with column active[a] zeroed."""
    T = feat.shape[0]
    knock = torch.cat([torch.full((1,), -1, dtype=active.dtype,
                                  device=active.device), active])
    rel = _traverse_pertree(feat, thresh, miss, X, depth, knock)  # [A+1,N,T]
    per = leaf[torch.arange(T, device=X.device).view(1, 1, T), rel]
    agg = torch.einsum("antk,tg->angk", per, W)         # [A + 1, N, G, K]
    return agg[0], agg[1:]


def active_features(feat: np.ndarray, thresh: np.ndarray) -> np.ndarray:
    """Features the ensemble actually splits on (finite threshold nodes).
    Dead and degenerate nodes carry +/-inf thresholds: their routing cannot
    change under knockout, so their features contribute zero delta."""
    real = np.isfinite(thresh)
    return np.unique(np.asarray(feat)[real]).astype(np.int32)


def _scores_from_agg(agg: torch.Tensor, mode: str, base: float,
                     n_trees: int) -> torch.Tensor:
    """[.., G, K] aggregate -> [.., c] score columns matching the tree
    models' predict_arrays (the probability when probabilistic, else the
    prediction)."""
    if mode == "classify_mean":
        p = torch.clamp(agg[..., 0, :] / n_trees, min=0.0)
        return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-12)
    if mode == "margin":
        p1 = torch.sigmoid(agg[..., 0, 0] + base)
        return torch.stack([1.0 - p1, p1], dim=-1)
    if mode == "regress_mean":
        return agg[..., 0, :] / n_trees
    if mode == "regress_sum":
        return agg[..., 0, :] + base
    if mode == "softmax":
        return torch.softmax(agg[..., 0], dim=-1)       # G = classes, K = 1
    raise ValueError(f"unknown ensemble mode: {mode}")


def tree_knockout_deltas(feat, thresh, leaf, miss, X, depth: int, mode: str,
                         base: float = 0.0,
                         class_of_tree: Optional[np.ndarray] = None,
                         row_chunk: int = _ROW_CHUNK,
                         device: DeviceLike = None) -> np.ndarray:
    """[n, d, c] LOCO deltas for a heap-layout ensemble on `device`,
    traversing only for the features the ensemble uses. A row chunk takes
    at most `row_chunk` rows, and fewer where its knockouts x rows x trees
    would pass _KNOCK_ELEMENTS."""
    dev = resolve_device(device)
    Xd = torch.as_tensor(np.ascontiguousarray(X, np.float32), device=dev)
    n, d = Xd.shape
    T = feat.shape[0]
    act = active_features(feat, thresh)
    if class_of_tree is not None:
        G = int(class_of_tree.max()) + 1
        W = np.zeros((T, G), np.float32)
        W[np.arange(T), class_of_tree] = 1.0
    else:
        W = np.ones((T, 1), np.float32)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)
    feat_t, thresh_t = t(feat, torch.int64), t(thresh, torch.float32)
    leaf_t, miss_t = t(leaf, torch.float32), t(miss, torch.int64)
    W_t, act_t = t(W, torch.float32), t(act, torch.int64)

    chunk = _rows(n, (len(act) + 1) * T, row_chunk)
    out = None
    for s in range(0, n, chunk):
        b, k = _tree_knockout_sums(feat_t, thresh_t, leaf_t, miss_t, W_t,
                                   Xd[s:s + chunk], act_t, depth)
        sb = _scores_from_agg(b, mode, base, T)         # [rows, c]
        sk = _scores_from_agg(k, mode, base, T)         # [A, rows, c]
        deltas = (sb[None] - sk).permute(1, 0, 2).cpu().numpy()
        if out is None:
            out = np.zeros((n, d, deltas.shape[-1]), np.float64)
        out[s:s + chunk, act, :] = deltas
    if out is None:
        return np.zeros((0, d, 1), np.float64)
    return out


# -- dispatch ----------------------------------------------------------------

def knockout_deltas(model, X: np.ndarray, row_chunk: int = _ROW_CHUNK,
                    force_tree: Optional[bool] = None,
                    device: DeviceLike = None) -> Optional[np.ndarray]:
    """[n, d, c] LOCO deltas through the family's device program, or None
    when the family has no batched route (the caller falls back to the
    host knockout loop). Runs on `device`, else the model's (None: CUDA).
    ``force_tree`` False sends a tree ensemble to the loop too; the port
    takes the batched tree route otherwise, on either device."""
    from ..automl.selector import SelectedModel
    from ..models.glm import (LinearBinaryModel, LinearRegressionModel,
                              NaiveBayesModel, SoftmaxModel)
    from ..models.trees import SoftmaxEnsembleModel, TreeEnsembleModel

    if isinstance(model, SelectedModel):
        # the wrapper only remaps `pred`; deltas are computed on prob/raw,
        # which delegate unchanged to the wrapped winner
        device = device if device is not None else model.device
        model = model.best_model
    if device is None:
        device = getattr(model, "device", None)
    X = np.ascontiguousarray(X, np.float32)

    def dev_t(a):
        return torch.as_tensor(np.asarray(a, np.float32),
                               device=resolve_device(device))

    if isinstance(model, LinearBinaryModel):
        if model.probabilistic:
            return _glm_deltas(_logistic_deltas, dev_t(X),
                               dev_t(model.beta), model.intercept)
        return _glm_deltas(_margin_deltas, dev_t(X), dev_t(model.beta))
    if isinstance(model, SoftmaxModel):
        return _glm_deltas(_softmax_deltas, dev_t(X),
                           dev_t(model.B), dev_t(model.b0))
    if isinstance(model, LinearRegressionModel):
        return _glm_deltas(_linreg_deltas, dev_t(X),
                           dev_t(model.beta), model.intercept,
                           model.link == "log")
    if isinstance(model, NaiveBayesModel):
        return _glm_deltas(_nb_deltas, dev_t(X),
                           dev_t(model.log_prob), dev_t(model.log_prior))
    if isinstance(model, (SoftmaxEnsembleModel, TreeEnsembleModel)):
        if force_tree is False:
            return None
        if isinstance(model, SoftmaxEnsembleModel):
            C = model.n_classes
            class_of_tree = (np.arange(model.feat.shape[0]) % C) \
                .astype(np.int32)
            return tree_knockout_deltas(
                model.feat, model.thresh_val, model.leaf, model.miss, X,
                model.depth, "softmax", class_of_tree=class_of_tree,
                row_chunk=row_chunk, device=device)
        return tree_knockout_deltas(
            model.feat, model.thresh_val, model.leaf, model.miss, X,
            model.depth, model.mode, base=model.base, row_chunk=row_chunk,
            device=device)
    return None

