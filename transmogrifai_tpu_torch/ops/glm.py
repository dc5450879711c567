"""Generalized-linear-model solvers in PyTorch (counterpart of ops/glm.py).

Binary logistic regression (IRLS-Newton with a proximal L1 step),
multinomial (softmax) logistic regression under Boehning's bound, the
linear SVC (squared hinge, Newton on the active set), linear regression
(squared loss, elastic net), generalized linear regression (IRLS,
gaussian / poisson / gamma) and multinomial naive Bayes, as the
reference's OpLogisticRegression / OpLinearSVC / OpLinearRegression /
OpGeneralizedLinearRegression / OpNaiveBayes wrappers fit them. `ridge_gram_solve` and `prox_newton_gram` solve squared-loss
lanes from their sufficient statistics (the Gram route of
ops/glm_sweep.py). Every solver takes
per-row weights, so fold masks enter as weights and no data moves between
folds.

X may be bfloat16 (the validator's `sweep_dtype`): the standardized copy
and the data products then stay bf16 (`_mm`: bf16 operands, f32
accumulation, f32 out), while coefficients, Hessians, solves and the
standardization's statistics stay f32 (`_solver_dtype`); an f32 X takes
exactly the f32 code it always took.

The JAX package vmaps its per-lane `while_loop` over (fold x grid) lanes.
Here the same fits are lane-batched: weights `w` [L, n] and penalties [L]
give L fits at once, each stopping at its own `delta <= tol` (or
`max_iter`) exactly as under `vmap`, where a lane whose condition fails
keeps its state frozen while the others iterate. The loop asks the host
once per iteration whether any lane is still active. A single fit is the
one-lane case: `w` [n] and scalar penalties.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

EPS = 1e-12
_F32 = torch.float32

# rows of the low-precision operand upcast at once where the device's
# PyTorch has no f32-out low-precision product (the CPU): bounds the f32
# copy of a bf16 X to one block
_MM_BLOCK = 1 << 16


def _solver_dtype(X: torch.Tensor) -> torch.dtype:
    """Solver-state dtype: never below f32 even when X is bf16 (the
    reference's `_solver_dtype`). Coefficients, Hessians and solves run
    in it whatever X's dtype."""
    return torch.promote_types(X.dtype, _F32)


def _solver_input(X: torch.Tensor) -> torch.Tensor:
    """X as the solvers take it: a bf16 sweep matrix stays bf16, any
    other dtype becomes f32."""
    return X if X.dtype == torch.bfloat16 else X.to(_F32)


_OUT_DTYPE: dict = {}   # (device type, op) -> whether out_dtype= works


def _out_dtype_ok(op, a: torch.Tensor, b: torch.Tensor) -> bool:
    """Does `op(a, b, out_dtype=torch.float32)` run on a's device (asked
    once a device type and op, on two-element operands)?"""
    key = (a.device.type, op.__name__)
    if key not in _OUT_DTYPE:
        try:
            op(a[..., :1, :1].contiguous(), b[..., :1, :1].contiguous(),
               out_dtype=_F32)
            _OUT_DTYPE[key] = True
        except (RuntimeError, TypeError, NotImplementedError):
            _OUT_DTYPE[key] = False
    return _OUT_DTYPE[key]


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with b cast to a's dtype, accumulated and returned in the
    solver dtype (the reference's `_mm`): a bf16 a stays bf16, no f32
    copy of it is made. An f32 a is a plain product. On a device whose
    PyTorch computes low-precision products with `out_dtype` (CUDA
    mm / bmm) that product runs; elsewhere the operands are upcast a block
    of `_MM_BLOCK` rows (or, for a wide a, contraction columns) at a time.
    bf16 x bf16 products are exact in f32, so both give the f32-accumulated
    product up to summation order."""
    out = _solver_dtype(a)
    if a.dtype == out:
        return torch.matmul(a, b.to(out))
    b = b.to(a.dtype)
    if a.is_cuda and a.dim() == b.dim() and a.dim() in (2, 3):
        op = torch.mm if a.dim() == 2 else torch.bmm
        if _out_dtype_ok(op, a, b):
            return op(a, b, out_dtype=out)
    rows, inner = a.shape[-2], a.shape[-1]
    bf = b.to(out)
    if rows >= inner:
        return torch.cat([torch.matmul(a[..., r:r + _MM_BLOCK, :].to(out),
                                       bf)
                          for r in range(0, rows, _MM_BLOCK)], dim=-2)
    acc = None
    for k in range(0, inner, _MM_BLOCK):
        part = torch.matmul(a[..., k:k + _MM_BLOCK].to(out),
                            bf[..., k:k + _MM_BLOCK, :])
        acc = part if acc is None else acc + part
    return acc


def _moments(X: torch.Tensor, w: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted two-pass column moments in f32: (centered, mean, std).
    `w` [n] gives mean/std [d] and centered [n, d]; `w` [L, n] gives
    [L, d] and [L, n, d]. One-pass E[x^2] - mean^2 would cancel
    catastrophically in f32 for large-mean columns.

    A column constant over the rows a lane weighs has that value as its
    mean exactly, so it centers to 0 and standardizes to 0: the matmul's
    f32 sum of n equal terms need not divide back to the value, and the
    rounding error over the clamped std would be a second intercept.

    A bf16 X keeps its dtype as the reference's `_standardize` does: the
    weights cast to it, each elementwise product rounded to it, the sums
    over rows f32; `centered` is bf16, mean and std f32."""
    wsum = torch.clamp(w.sum(-1), min=EPS)
    low = X.dtype != _F32
    if low:
        wx = w.to(X.dtype)[..., :, None]
        mean = (X * wx).sum(-2, dtype=_F32) / wsum[..., None]
    else:
        mean = (w @ X) / wsum[..., None]
    if X.shape[-2]:
        x0 = X[..., :1, :]
        if low:
            differs = ((w > 0)[..., :, None] & (X != x0)).sum(-2)
            x0 = x0.to(_F32)
        else:
            differs = (w > 0).to(X.dtype) @ (X != x0).to(X.dtype)
        mean = torch.where(differs == 0, x0[..., 0, :], mean)
    if low:
        centered = X - mean.to(X.dtype)[..., None, :]
        var = (centered * centered * wx).sum(-2, dtype=_F32) \
            / wsum[..., None]
    else:
        centered = X - mean[..., None, :]
        var = (w[..., None, :] @ (centered * centered))[..., 0, :] \
            / wsum[..., None]
    std = torch.sqrt(torch.clamp(var, min=EPS))
    return centered, mean, std


def _standardize(X: torch.Tensor, w: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Weighted column standardization; returns (Xs, mean, std), per lane
    when `w` is [L, n]. Xs keeps X's dtype; mean and std are f32."""
    centered, mean, std = _moments(X, w)
    return centered / std.to(X.dtype)[..., None, :], mean, std


def _unstandardize_beta(beta: torch.Tensor, intercept: torch.Tensor,
                        mean: torch.Tensor, std: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    b = beta / std
    return b, intercept - (b * mean).sum(-1)


def _soft_threshold(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def _lanes_eta(Xs: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """[L, n] linear predictors of the lanes' beta [L, d] on Xs, shared
    [n, d] or per lane [L, n, d] (a bf16 Xs: beta cast to bf16, f32
    accumulation, as the reference's `_mm(Xs, beta)`)."""
    if Xs.dtype != _F32:
        if Xs.dim() == 2:
            return _mm(Xs, beta.T).T
        return _mm(Xs, beta[:, :, None])[..., 0]
    if Xs.dim() == 2:
        return beta @ Xs.T
    return torch.bmm(Xs, beta[:, :, None])[..., 0]


def _lanes_xt(Xs: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """[L, d] = Xs^T r for each lane's row vector r [L, n] (a bf16 Xs: r
    cast to bf16, as the reference's `_mm(Xs.T, r)`)."""
    if Xs.dtype != _F32:
        if Xs.dim() == 2:
            return _mm(Xs.T, r.T).T
        return _mm(Xs.transpose(1, 2), r[:, :, None])[..., 0]
    if Xs.dim() == 2:
        return r @ Xs
    return torch.bmm(r[:, None, :], Xs)[:, 0]


def _lanes_gram(Xs: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[L, d, d] = Xs^T diag(s_l) Xs: each lane's row-scaled [n, d] copy,
    as the reference's vmapped lanes build theirs (in Xs's dtype, the
    product accumulated in f32)."""
    if Xs.dtype != _F32:
        return _mm((Xs * s.to(Xs.dtype)[..., None]).transpose(-1, -2), Xs)
    return torch.matmul((Xs * s[..., None]).transpose(-1, -2), Xs)


def _newton_prox_fit(grad_hess_fn: Callable, L: int, d: int,
                     reg: torch.Tensor, alpha: torch.Tensor, max_iter: int,
                     tol: float, device: torch.device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Damped Newton with L2 in the Hessian and L1 by a proximal step, for
    L lanes at once. grad_hess_fn(beta [L, d], b0 [L]) -> (g [L, d],
    H [L, d, d], g0 [L], h0 [L]) for the unpenalized loss; the intercept
    is unregularized. Each lane iterates while its own iteration count is
    below max_iter and its own delta above tol; the others stay frozen."""
    f32 = torch.float32
    l1 = (reg * alpha)[:, None]
    l2 = reg * (1.0 - alpha)
    eye = torch.eye(d, dtype=f32, device=device)
    beta = torch.zeros((L, d), dtype=f32, device=device)
    b0 = torch.zeros(L, dtype=f32, device=device)
    delta = torch.full((L,), float("inf"), dtype=f32, device=device)
    it = torch.zeros(L, dtype=torch.int64, device=device)
    while True:
        active = (it < max_iter) & (delta > tol)
        if not bool(active.any()):     # the iteration's one host check
            break
        g, H, g0, h0 = grad_hess_fn(beta, b0)
        g = g + l2[:, None] * beta
        H = H + l2[:, None, None] * eye
        # solve with jitter for safety
        step = torch.linalg.solve(H + 1e-6 * eye, g[..., None])[..., 0]
        # proximal L1 using diagonal curvature as scaling
        hdiag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=EPS)
        beta_new = _soft_threshold(beta - step, l1 / hdiag)
        b0_new = b0 - g0 / torch.clamp(h0, min=EPS)
        d_new = (beta_new - beta).abs().amax(1) + (b0_new - b0).abs()
        beta = torch.where(active[:, None], beta_new, beta)
        b0 = torch.where(active, b0_new, b0)
        delta = torch.where(active, d_new, delta)
        it = it + active.long()
    return beta, b0


def _lanes(X: torch.Tensor, w: torch.Tensor, reg, elastic_net):
    """(w [L, n], reg [L], alpha [L], single) from one fit's or L fits'
    arguments; X's device and f32 throughout."""
    dev = X.device
    single = w.dim() == 1
    w = w.to(device=dev, dtype=torch.float32).reshape(-1, X.shape[0])
    L = w.shape[0]

    def lane_vec(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=dev).reshape(-1).expand(L)
    return w, lane_vec(reg), lane_vec(elastic_net), single


def _fit(X, y, w, reg, alpha, max_iter, tol, fit_intercept, standardize,
         grad_hess):
    """The shared frame of the binary solvers: lanes, standardization,
    the Newton loop and the way back to raw feature units."""
    X = _solver_input(X)
    n, d = X.shape
    w, reg, alpha, single = _lanes(X, w, reg, alpha)
    L = w.shape[0]
    if standardize:
        # one lane standardizes into a shared [n, d]; L lanes into [L, n, d]
        Xs, mean, std = _standardize(X, w[0] if single else w)
    else:
        Xs = X
    wsum = torch.clamp(w.sum(-1), min=EPS)
    y = y.to(device=X.device, dtype=torch.float32)

    def gh(beta, b0):
        g, H, g0, h0 = grad_hess(Xs, y, w, wsum, beta, b0)
        if not fit_intercept:
            g0 = torch.zeros_like(b0)
            h0 = torch.ones_like(b0)
        return g, H, g0, h0

    beta, b0 = _newton_prox_fit(gh, L, d, reg, alpha, int(max_iter),
                                float(tol), X.device)
    if standardize:
        beta, b0 = _unstandardize_beta(beta, b0, mean, std)
    if not fit_intercept:
        b0 = torch.zeros_like(b0)
    return (beta[0], b0[0]) if single else (beta, b0)


def _logistic_grad_hess(Xs, y, w, wsum, beta, b0):
    eta = _lanes_eta(Xs, beta) + b0[:, None]
    p = torch.sigmoid(eta)
    r = (p - y) * w
    g = _lanes_xt(Xs, r) / wsum[:, None]
    s = torch.clamp(p * (1 - p), min=1e-6) * w
    H = _lanes_gram(Xs, s) / wsum[:, None, None]
    return g, H, r.sum(-1) / wsum, s.sum(-1) / wsum


def _svc_grad_hess(Xs, y, w, wsum, beta, b0):
    ypm = 2.0 * y - 1.0  # {0,1} -> {-1,+1}
    margin = ypm * (_lanes_eta(Xs, beta) + b0[:, None])
    active = (margin < 1.0).to(torch.float32) * w
    r = -ypm * torch.clamp(1.0 - margin, min=0.0) * w
    g = _lanes_xt(Xs, r) / wsum[:, None]
    H = _lanes_gram(Xs, active) / wsum[:, None, None]
    return (g, H, r.sum(-1) / wsum,
            torch.clamp(active.sum(-1) / wsum, min=1e-6))


def _linear_grad_hess(Xs, y, w, wsum, beta, b0):
    r = (_lanes_eta(Xs, beta) + b0[:, None] - y) * w
    g = _lanes_xt(Xs, r) / wsum[:, None]
    H = _lanes_gram(Xs, w) / wsum[:, None, None]
    return g, H, r.sum(-1) / wsum, w.sum(-1) / wsum


def fit_logistic(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                 reg, elastic_net, max_iter: int = 50, tol: float = 1e-6,
                 fit_intercept: bool = True, standardize: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Binary logistic regression via IRLS-Newton (+proximal L1).

    `w` [n] with scalar reg / elastic_net returns (coefficients [d],
    intercept); `w` [L, n] with [L] (or scalar) penalties returns L fits,
    ([L, d], [L]), each standardized with its own weights. Matches Spark's
    LogisticRegression(standardization=true, family=binomial) closely."""
    return _fit(X, y, w, reg, elastic_net, max_iter, tol, fit_intercept,
                standardize, _logistic_grad_hess)


def fit_linear_svc(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                   reg, max_iter: int = 50, tol: float = 1e-6,
                   fit_intercept: bool = True, standardize: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Linear SVM with squared-hinge loss + L2 (Spark LinearSVC
    semantics). Squared hinge is differentiable, so Newton steps apply
    with the active-set (margin < 1) indicator inside the Hessian. Lanes
    as in fit_logistic."""
    return _fit(X, y, w, reg, 0.0, max_iter, tol, fit_intercept,
                standardize, _svc_grad_hess)


def fit_linear(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               reg, elastic_net, max_iter: int = 50, tol: float = 1e-6,
               fit_intercept: bool = True, standardize: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted linear regression with elastic net (Spark
    LinearRegression): Newton steps on the squared loss, L1 by the
    proximal step. Lanes as in fit_logistic."""
    return _fit(X, y, w, reg, elastic_net, max_iter, tol, fit_intercept,
                standardize, _linear_grad_hess)


# -- sufficient-statistics (Gram) solvers for the squared loss ---------------
#
# For the squared loss the Newton curvature is identically 1, so every
# lane's Hessian is its fold's weighted Gram X^T diag(w) X, the same at
# every iteration. ops/glm_sweep gathers those moments in one pass over X;
# the two solvers below replay `_newton_prox_fit`'s update rule in moment
# space.


def ridge_gram_solve(Gm: torch.Tensor, cm: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor, sw: torch.Tensor, l2: torch.Tensor,
                     fit_intercept: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form weighted ridge from per-lane sufficient statistics.

    Gm [L, d, d] = X^T W_l X, cm [L, d] = X^T W_l y, sx [L, d] = X^T W_l 1,
    sy [L] = 1^T W_l y, sw [L] = 1^T W_l 1, l2 [L]: the stationary point of
    `_newton_prox_fit` on the squared loss without L1, the intercept
    eliminated: (G/sw - xbar xbar^T + (l2 + 1e-6) I) beta = c/sw - xbar
    ybar, b0 = ybar - xbar.beta. Returns (beta [L, d], b0 [L])."""
    d = Gm.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=Gm.device)
    sw_ = torch.clamp(sw, min=EPS)
    if fit_intercept:
        xbar = sx / sw_[:, None]
        ybar = sy / sw_
        A = (Gm / sw_[:, None, None]
             - xbar[:, :, None] * xbar[:, None, :]
             + (l2 + 1e-6)[:, None, None] * eye[None])
        rhs = cm / sw_[:, None] - xbar * ybar[:, None]
        beta = torch.linalg.solve(A, rhs[..., None])[..., 0]
        b0 = ybar - (beta * xbar).sum(1)
    else:
        A = Gm / sw_[:, None, None] + (l2 + 1e-6)[:, None, None] * eye[None]
        beta = torch.linalg.solve(A, (cm / sw_[:, None])[..., None])[..., 0]
        b0 = torch.zeros_like(sy)
    return beta, b0


def prox_newton_gram(Gm: torch.Tensor, cm: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor, sw: torch.Tensor, l1: torch.Tensor,
                     l2: torch.Tensor, beta0: torch.Tensor,
                     b00: torch.Tensor, max_iter: int, tol: float,
                     fit_intercept: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Lane-batched proximal Newton on cached squared-loss moments.

    `_newton_prox_fit`'s update with every data term rebuilt from the
    statistics: grad = (G beta + b0 sx - c)/sw + l2 beta, H = G/sw +
    (l2 + 1e-6) I (the same every iteration: factored once), proximal L1
    against H's diagonal, intercept step b0 - g0. Started from beta0 /
    b00; all lanes iterate until the largest delta clears tol or max_iter
    iterations ran, as the reference's one while loop. Returns (beta
    [L, d], b0 [L], iterations run)."""
    d = Gm.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=Gm.device)
    sw_ = torch.clamp(sw, min=EPS)
    H = Gm / sw_[:, None, None] + (l2 + 1e-6)[:, None, None] * eye[None]
    hdiag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=EPS)
    lu, piv = torch.linalg.lu_factor(H)
    beta = beta0.to(torch.float32)
    b0 = b00.to(torch.float32)
    i, delta = 0, float("inf")
    while i < int(max_iter) and delta > float(tol):
        g = ((torch.einsum("lde,le->ld", Gm, beta) + b0[:, None] * sx - cm)
             / sw_[:, None] + l2[:, None] * beta)
        step = torch.linalg.lu_solve(lu, piv, g[..., None])[..., 0]
        beta_new = _soft_threshold(beta - step, l1[:, None] / hdiag)
        if fit_intercept:
            b0_new = b0 - ((sx * beta).sum(1) + b0 * sw_ - sy) / sw_
        else:
            b0_new = b0
        delta = float(((beta_new - beta).abs().amax(1)
                       + (b0_new - b0).abs()).max())  # the one host check
        beta, b0 = beta_new, b0_new
        i += 1
    return beta, b0, i


def fit_softmax(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor, reg,
                elastic_net, max_iter: int = 100, fit_intercept: bool = True,
                standardize: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multinomial logistic regression; Y one-hot [n, c].

    Boehning's (1992) bound H <= 0.5 (1 - 1/c) X^T W X for every class block
    makes the preconditioner A = 0.5 (1 - 1/c) X^T W X / sum(w) + l2 I
    (+1e-6 I) constant: it is Cholesky-factored once, and each of the
    `max_iter` iterations (no tolerance: the count is fixed) is products
    and triangular solves, with L1 by a proximal step against A's diagonal
    and an unpenalized intercept step. `w` [n] with scalar penalties
    returns (B [d, c], b0 [c]); `w` [L, n] with [L] (or scalar) penalties
    returns L fits, ([L, d, c], [L, c]), each standardized with its own
    weights. A bf16 X keeps its products bf16 (`_mm`); the preconditioner
    is the same float64 Gram of its values."""
    f32 = torch.float32
    X = _solver_input(X)
    n, d = X.shape
    Y = Y.to(device=X.device, dtype=f32)
    c = Y.shape[1]
    w, reg, alpha, single = _lanes(X, w, reg, elastic_net)
    L = w.shape[0]
    if standardize:
        Xs, mean, std = _standardize(X, w[0] if single else w)
    else:
        Xs = X
    wsum = torch.clamp(w.sum(-1), min=EPS)                     # [L]
    l2 = (reg * (1.0 - alpha))[:, None, None]
    l1 = (reg * alpha)[:, None, None]
    eye = torch.eye(d, dtype=f32, device=X.device)
    coef = 0.5 * (1.0 - 1.0 / c)
    # the preconditioner's Gram in float64, lane by lane: a one-hot group's
    # standardized columns are collinear, so only l2 keeps A positive
    # definite, and an f32 sum over hundreds of thousands of rows (cuBLAS's
    # on the card) errs by more than the smallest l2 of the default grid
    lanes_x = Xs if Xs.dim() == 3 else Xs.expand(L, n, d)
    gram = torch.stack([((x.double() * wl[:, None]).T @ x.double()).to(f32)
                        for x, wl in zip(lanes_x, w.double())])
    A = coef * gram / wsum[:, None, None] + l2 * eye + 1e-6 * eye
    chol = torch.linalg.cholesky(A)
    hdiag = torch.clamp(torch.diagonal(A, dim1=1, dim2=2), min=EPS)
    h0 = torch.clamp(coef * w.sum(-1) / wsum, min=1e-6)        # [L]
    XsT = Xs.transpose(-1, -2)
    mm = torch.matmul if Xs.dtype == f32 else _mm
    B = torch.zeros((L, d, c), dtype=f32, device=X.device)
    b0 = torch.zeros((L, c), dtype=f32, device=X.device)
    for _ in range(int(max_iter)):
        P = torch.softmax(mm(Xs, B) + b0[:, None, :], dim=-1)
        R = (P - Y) * w[..., None]                              # [L, n, c]
        G = mm(XsT, R) / wsum[:, None, None] + l2 * B
        B = _soft_threshold(B - torch.cholesky_solve(G, chol),
                            l1 / hdiag[..., None])
        if fit_intercept:
            b0 = b0 - (R.sum(1) / wsum[:, None]) / h0[:, None]
    if standardize:
        B = B / std.reshape(-1, d, 1)
        b0 = b0 - (B * mean.reshape(-1, d, 1)).sum(1)
    return (B[0], b0[0]) if single else (B, b0)


def fit_naive_bayes(X: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
                    smoothing: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multinomial naive Bayes (Spark NaiveBayes, modelType multinomial) on
    the positive part of the features. Y one-hot [n, c]. Returns (log_prob
    [c, d], log_prior [c])."""
    f32 = torch.float32
    X = X.to(f32)
    Y = Y.to(device=X.device, dtype=f32)
    w_ = w.to(device=X.device, dtype=f32)[:, None]
    class_count = (Y * w_).sum(0)                               # [c]
    feat_count = Y.T @ (torch.clamp(X, min=0.0) * w_)           # [c, d]
    log_prior = (torch.log(torch.clamp(class_count, min=EPS))
                 - torch.log(torch.clamp(class_count.sum(), min=EPS)))
    num = feat_count + smoothing
    den = feat_count.sum(1, keepdim=True) + smoothing * X.shape[1]
    return torch.log(num) - torch.log(den), log_prior


GLR_FAMILIES = ("gaussian", "poisson", "gamma")


def fit_glr(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, reg,
            family: str = "gaussian", max_iter: int = 25,
            fit_intercept: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized linear regression by IRLS (Spark
    GeneralizedLinearRegression): gaussian with the identity link, poisson
    and gamma with the log link, `max_iter` iterations exactly, an L2 of
    `reg` (+1e-6 jitter) on the unstandardized coefficients. Other
    families (tweedie) raise, as in the reference. Returns (coefficients
    [d], intercept)."""
    if family not in GLR_FAMILIES:
        raise ValueError(f"Unsupported GLR family: {family}")
    f32 = torch.float32
    X = X.to(f32)
    dev = X.device
    y = y.to(device=dev, dtype=f32)
    w = w.to(device=dev, dtype=f32)
    n, d = X.shape
    wsum = torch.clamp(w.sum(), min=EPS)
    eye = torch.eye(d, dtype=f32, device=dev)
    reg = float(reg)
    beta = torch.zeros(d, dtype=f32, device=dev)
    b0 = torch.zeros((), dtype=f32, device=dev)
    for _ in range(int(max_iter)):
        eta = X @ beta + b0
        if family == "gaussian":
            z, s = y, w
        else:
            mu = torch.exp(eta)
            mu_c = torch.clamp(mu, min=EPS)
            # the log link's working response; working weights mu for
            # poisson, 1 for gamma (mu^2 / var)
            z = eta + (y - mu) / mu_c
            s = w if family == "gamma" else w * mu_c
        A = (X * s[:, None]).T @ X / wsum + reg * eye + 1e-6 * eye
        rhs = X.T @ (s * (z - b0)) / wsum
        beta_new = torch.linalg.solve(A, rhs)
        if fit_intercept:
            b0 = (s * (z - X @ beta_new)).sum() / torch.clamp(s.sum(),
                                                              min=EPS)
        beta = beta_new
    return beta, b0
