"""Lane-batched streaming GLM sweep (counterpart of ops/glm_sweep.py):
every (fold x grid) fit in one pass over the feature matrix per Newton
iteration, and only for the lanes that still need it.

Per Newton iteration one row-block scan carries per-lane accumulators
(gradients [L, d], Hessians [L, d, d], intercept sums); the lanes' linear
predictors come from one product `X_blk @ B.T`, and every lane's weighted
Gram from one product of the curvature weights S [c, L] with the block's
pairwise feature products (`_gram_fns`). The per-lane d x d Newton solves,
proximal L1 and intercept steps are batched linear algebra on [L, d, d].
The JAX package has no Pallas kernel here: its einsums, matmuls and
batched solves are plain XLA products, so they are plain PyTorch products
(f32; TF32 stays off, `device.resolve_device`). A bf16 X (the validator's
`sweep_dtype`) stays bf16: each scan block is upcast alone, its on-the-fly
standardization rounded back to X's dtype and the coefficients to it for
the linear predictors, as the reference's bf16 contraction sees them; the
accumulators, solves and scores are f32.

Routes, as in the reference. The squared loss (linear regression) takes
`sweep_glm_squared_gram`: its curvature is identically 1, so one pass over
X gathers each fold's weighted Gram and moments, and the whole grid solves
from them (ops/glm.ridge_gram_solve, prox_newton_gram). For the IRLS
losses (logistic, squared hinge):
1. `sweep_glm_round` + the host driver `sweep_glm_streamed_rounds`: rounds
   of K iterations with a per-lane delta; after each round the host
   retires the converged lanes (coefficients frozen, the per-lane solvers'
   own stopping rule, ops/glm._newton_prox_fit) and runs the survivors in
   the next round. Round 0 may fit only each fold's strongest-
   regularization lane and seed the rest of the fold from it (pathwise
   warm start).
2. `sweep_glm_streamed`: the legacy single-program global-max route, the
   kill-switch fallback (TMOG_GLM_ROUNDS=0) and the parity reference.

The reference pads each round's lanes to a power-of-two bucket
(`bucket_lanes`) to bound XLA recompiles. Eager PyTorch compiles nothing,
so a round here runs exactly its active lanes; the padded lanes of the
reference are inert (zero fold weights), so the results are the same.
`streamed_route_ok` keeps the bucket in its memory guard, so the port
picks the route the reference picks. The round driver also takes a
`parallel.tileplane.RowSource` for X: every data pass then streams fixed
tiles from the source (disk, for a reader-backed one) through the
double-buffered tileplane, so X is never resident (`_source_rounds`). The
mesh-sharded drivers (the Gram route's too) and the across-time
`warm_seed` are not ported.

Fold masks enter as weights (mask * w), exactly like the per-lane solvers.
Standardization: the per-lane solvers standardize with each lane's own
fold-masked weights; these routes standardize once with the global
weights, applied on the fly per block, so no standardized [n, d] copy is
ever made.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from . import glm as G
# the TMOG_* toggle parse of every sweep knob (TMOG_GLM_ROUNDS in the
# validator routing, TMOG_GLM_WARMSTART here)
from ..parallel.tileplane import env_on  # noqa: F401

EPS = 1e-12

# Rows per scan block on the narrow path: bounds the [c, d, d] pairwise
# product the Gram builds (f32, 512MB at d=64/c=32768) and the [c, L]
# residual/curvature blocks. _row_block() halves c as d grows so the
# transient never exceeds that budget.
_ROW_BLOCK = 32_768


def _row_block(d: int) -> int:
    c = _ROW_BLOCK
    while c > 4_096 and c * d * d * 4 > 512 * (1 << 20):
        c //= 2
    return c


# Widest matrix the single-pass (narrow) Gram handles; past it the
# pairwise block outgrows the transient budget and the Gram accumulates
# by feature tiles (same math, tile-pair granularity).
TRI_MAX_D = 128

# Feature-tile edge for the wide path: each block builds one [c, TILE^2]
# pair product per tile pair.
_FEATURE_TILE = 64

# Rows per scan block on the wide path — c * TILE^2 * 4B = 64MB at 4096.
_ROW_BLOCK_WIDE = 4_096

# Ceiling on tile pairs (d_pad 1792, 28 tiles): the reference unrolls the
# pair loop into its program; the route guard keeps the same limit.
_MAX_TILE_PAIRS = 406

# Newton iterations per round on the retirement route: the retirement
# granularity / wasted-iteration tradeoff (a lane converging mid-round
# keeps iterating until the round ends). TMOG_GLM_ROUND_ITERS overrides.
ROUND_ITERS_DEFAULT = 5

# Smallest lane bucket of the reference's compaction ladder. Its planner
# may move it; the planner is not ported, so the hand default holds.
_BUCKET_MIN = 8


def bucket_lanes(n_active: int) -> int:
    """Smallest power-of-two bucket >= n_active (floor _BUCKET_MIN): the
    lane count the reference's round program runs for n_active lanes."""
    b = _BUCKET_MIN
    while b < n_active:
        b *= 2
    return b


def streamed_route_ok(d: int, lanes: int, budget_bytes: float) -> bool:
    """Can the streamed route take a (d features, lanes) sweep within
    `budget_bytes` of device memory? The per-iteration footprint is the
    assembled [L, d, d] Hessian + solve workspace + tile accumulators
    (~4x) at the reference's first-round bucket, and the tiled path's
    tile-pair count is capped."""
    if d <= TRI_MAX_D:
        d_work = d
    else:
        nt = -(-d // _FEATURE_TILE)
        if nt * (nt + 1) // 2 > _MAX_TILE_PAIRS:
            return False
        d_work = nt * _FEATURE_TILE
    return bucket_lanes(lanes) * d_work * d_work * 4.0 * 4.0 <= budget_bytes


def _residual_curvature(loss: str) -> Callable:
    """Unweighted per-row residual r and curvature s for eta [c, L]."""
    if loss == "logistic":
        def rc(eta, y):
            p = torch.sigmoid(eta)
            return p - y[:, None], torch.clamp(p * (1.0 - p), min=1e-6)
    elif loss == "squared_hinge":
        def rc(eta, y):
            # loss 0.5*gap^2 (NOT gap^2): matches glm.fit_linear_svc's
            # residual/curvature so the streamed and per-lane routes see
            # the same effective L2 for a given reg_param
            ypm = (2.0 * y - 1.0)[:, None]
            gap = torch.clamp(1.0 - ypm * eta, min=0.0)
            return -gap * ypm, (gap > 0.0).to(eta.dtype)
    elif loss == "squared":
        def rc(eta, y):
            return eta - y[:, None], torch.ones_like(eta)
    else:
        raise ValueError(f"unknown streamed loss {loss!r}")
    return rc


# -- shared scan geometry ----------------------------------------------------

def _tiling(d: int):
    """(tiled, d_work, bt, tile_pairs) — the narrow/wide Gram geometry for
    a d-feature matrix, shared by every streamed route."""
    if d <= TRI_MAX_D:
        return False, d, 0, []
    bt = _FEATURE_TILE
    nt = -(-d // bt)
    return True, nt * bt, bt, [(a, b) for a in range(nt)
                               for b in range(a, nt)]


def _gram_fns(tiled: bool, d_work: int, lanes: int, bt: int, tile_pairs,
              device: torch.device):
    """(hess_blocks, assemble, blocks0) for `lanes` weighted Grams of a
    d_work-wide block. `hess_blocks(acc, xf [c, d_work], S [c, lanes])`
    adds one block's contribution to the accumulator in place; `assemble`
    turns the summed accumulator into the full symmetric
    [lanes, d_work, d_work].

    The reference's einsum 'cl,cd,ce->lde' is one product here: the
    block's pairwise products P [c, d*d] (512MB at the _row_block budget)
    and S^T P [lanes, d*d]. Neither an [L, c, d] nor a [c, L, d]
    intermediate is made, so the transient stays inside the budget that
    _row_block sets, whatever the lane count."""
    f32 = torch.float32
    if tiled:
        def hess_blocks(acc, xf, S):
            # off-diagonal tile pairs are computed once and mirrored at
            # assembly, keeping the triangle savings at tile granularity
            St = S.T
            for p, (a, b) in enumerate(tile_pairs):
                xa = xf[:, a * bt:(a + 1) * bt]
                xb = xf[:, b * bt:(b + 1) * bt]
                P = (xa[:, :, None] * xb[:, None, :]).reshape(-1, bt * bt)
                acc[p].addmm_(St, P)

        def assemble(hA):
            H = torch.zeros((lanes, d_work, d_work), dtype=f32,
                            device=device)
            for p, (a, b) in enumerate(tile_pairs):
                blk = hA[p].reshape(lanes, bt, bt)
                H[:, a * bt:(a + 1) * bt, b * bt:(b + 1) * bt] = blk
                if a != b:
                    H[:, b * bt:(b + 1) * bt, a * bt:(a + 1) * bt] = \
                        blk.transpose(1, 2)
            return H

        blocks0 = torch.zeros((len(tile_pairs), lanes, bt * bt), dtype=f32,
                              device=device)
        return hess_blocks, assemble, blocks0

    def hess_blocks(acc, xf, S):
        P = (xf[:, :, None] * xf[:, None, :]).reshape(xf.shape[0], -1)
        acc.addmm_(S.T, P)

    return (hess_blocks, lambda hA: hA.reshape(lanes, d_work, d_work),
            torch.zeros((lanes, d_work * d_work), dtype=f32, device=device))


def _blocked(X, y, w, fold_masks, c: int) -> Iterator[Tuple]:
    """Scan blocks (x [c, d], y [c], w [c], fold masks [F, c]) of c rows,
    views of the inputs. The reference zero-pads the tail to a whole
    block (w = 0, inert everywhere) to keep one program shape; here the
    tail block is simply shorter, which adds the same nothing."""
    n = X.shape[0]
    for s in range(0, n, c):
        yield X[s:s + c], y[s:s + c], w[s:s + c], fold_masks[:, s:s + c]


def _newton_prox_update(B, b0, gA, hA, g0A, h0A, wsum_l, l1, l2, eye,
                        assemble, fit_intercept: bool):
    """THE damped-Newton + proximal-L1 + intercept update from streamed
    accumulators, shared by the legacy global-max route and the
    retirement round — the parity contract between the two routes lives
    in this one function. Returns (B_new, b0_new, delta_vec [L])."""
    g = gA / wsum_l[:, None] + l2[:, None] * B
    H = assemble(hA) / wsum_l[:, None, None]
    H = H + (l2[:, None, None] + 1e-6) * eye[None]
    step = torch.linalg.solve(H, g[..., None])[..., 0]
    B_new = B - step
    hdiag = torch.clamp(torch.diagonal(H, dim1=1, dim2=2), min=EPS)
    B_new = (torch.sign(B_new)
             * torch.clamp(torch.abs(B_new) - l1[:, None] / hdiag, min=0.0))
    if fit_intercept:
        b0_new = b0 - (g0A / wsum_l) / torch.clamp(h0A / wsum_l, min=EPS)
    else:
        b0_new = b0
    delta = (B_new - B).abs().amax(1) + (b0_new - b0).abs()
    return B_new, b0_new, delta


def glm_standardize_stats(X: torch.Tensor, w: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global-weight column (mean, std), two-pass in f32 (the reference's
    `_psum_moments` on one device) — computed once per sweep, applied on
    the fly inside every scan block."""
    _, mean, std = G._moments(X.to(torch.float32), w)
    return mean, std


class _Lanes:
    """The lanes' side of a streaming pass, shared by the resident routes
    (`_Scan`) and the row-source route: per-lane accumulators (g [Lb,
    d_work], Hessian accumulator, g0 [Lb], h0 [Lb]) of the lanes'
    coefficients B [Lb, d_work] / b0 [Lb], one row block at a time, with
    sel [F, Lb] mapping each lane to its fold (one-hot columns), and the
    Newton / proximal / intercept update from them."""

    def __init__(self, d: int, rows: int, sel, mean, std, loss: str,
                 wsum_f, x_dtype=torch.float32):
        dev = sel.device
        self.sel = sel
        self.rc = _residual_curvature(loss)
        self.d = d
        self.x_dtype = x_dtype
        tiled, self.d_work, bt, pairs = _tiling(d)
        dp = self.d_work - d
        # zero columns are inert end to end: mean 0 -> centered 0, grad 0,
        # H diagonal = l2 + 1e-6 ridge -> Newton step 0, so padded betas
        # stay exactly 0 and are sliced off by the caller
        self.mean = None if mean is None else Fn.pad(mean, (0, dp))
        self.std = None if std is None else Fn.pad(std, (0, dp), value=1.0)
        self.c = min(_ROW_BLOCK_WIDE if tiled else _row_block(self.d_work),
                     rows)
        Lb = sel.shape[1]
        self.hess_blocks, self.assemble, self.h_acc0 = _gram_fns(
            tiled, self.d_work, Lb, bt, pairs, dev)
        self.wsum_l = torch.clamp((wsum_f[:, None] * sel).sum(0), min=EPS)
        self.eye = torch.eye(self.d_work, dtype=torch.float32, device=dev)

    def zeros(self):
        Lb = self.sel.shape[1]
        dev = self.sel.device
        return (torch.zeros((Lb, self.d_work), dtype=torch.float32,
                            device=dev),
                self.h_acc0.clone(),
                torch.zeros(Lb, dtype=torch.float32, device=dev),
                torch.zeros(Lb, dtype=torch.float32, device=dev))

    def coef_t(self, B):
        """B.T as the blocks' products read it: a bf16 X's contraction
        sees the coefficients rounded to bf16."""
        Bt = B.T
        if self.x_dtype != torch.float32:
            Bt = Bt.to(self.x_dtype).to(torch.float32)
        return Bt

    def add_block(self, acc, x_blk, y_blk, wlf, Bt, b0) -> None:
        """Fold one row block into `acc` in place; wlf [c, F] holds each
        row's fold weights (fold mask * row weight)."""
        gA, hA, g0A, h0A = acc
        xf = x_blk.to(torch.float32)
        dp = self.d_work - self.d
        if dp:
            xf = Fn.pad(xf, (0, dp))
        if self.mean is not None:      # standardize on the fly
            xf = (xf - self.mean) / self.std
            if self.x_dtype != torch.float32:
                # the standardized block in X's dtype, then f32
                xf = xf.to(self.x_dtype).to(torch.float32)
        eta = xf @ Bt + b0
        r0, s0 = self.rc(eta, y_blk)                # [c, Lb]
        wl = wlf @ self.sel                         # [c, Lb]
        R = r0 * wl
        S = s0 * wl
        gA.addmm_(R.T, xf)
        self.hess_blocks(hA, xf, S)
        g0A += R.sum(0)
        h0A += S.sum(0)

    def update(self, B, b0, acc, l1, l2, fit_intercept: bool):
        return _newton_prox_update(B, b0, *acc, self.wsum_l, l1, l2,
                                   self.eye, self.assemble, fit_intercept)


class _Scan(_Lanes):
    """The per-iteration pass over a resident X [n, d] with y [n], w [n]
    and fold masks [F, n] on one device."""

    def __init__(self, X, y, w, fold_masks, sel, mean, std, loss: str):
        super().__init__(X.shape[1], X.shape[0], sel, mean, std, loss,
                         torch.clamp(fold_masks @ w, min=EPS), X.dtype)
        self.X, self.y, self.w, self.m = X, y, w, fold_masks

    def accumulate(self, B, b0):
        acc = self.zeros()
        Bt = self.coef_t(B)
        for x_blk, y_blk, w_blk, m_blk in _blocked(self.X, self.y, self.w,
                                                   self.m, self.c):
            self.add_block(acc, x_blk, y_blk, m_blk.T * w_blk[:, None],
                           Bt, b0)
        return acc


def _fold_sel(F: int, Gn: int, device) -> torch.Tensor:
    """[F, F*Gn] one-hot fold of each fold-major lane l = f * Gn + g."""
    return torch.repeat_interleave(
        torch.eye(F, dtype=torch.float32, device=device), Gn, dim=1)


def _stats(X, w, standardize: bool):
    if standardize:
        return glm_standardize_stats(X, w)
    return None, None


# -- legacy single-program route (global-max convergence) --------------------

def sweep_glm_streamed(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       fold_masks: torch.Tensor, regs, alphas, *,
                       loss: str = "logistic", max_iter=50, tol=1e-6,
                       fit_intercept: bool = True, standardize: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All (fold, grid) fits iterated together until every lane's delta
    clears tol (or max_iter): returns (B [F, G, d] f32, b0 [F, G]) in RAW
    feature units. Lanes are fold-major, l = f * G + g."""
    n, d = X.shape
    dev = X.device
    F = fold_masks.shape[0]
    regs = torch.as_tensor(regs, dtype=torch.float32, device=dev)
    alphas = torch.as_tensor(alphas, dtype=torch.float32, device=dev)
    Gn = regs.shape[0]
    L = F * Gn
    mean, std = _stats(X, w, standardize)
    scan = _Scan(X, y, w, fold_masks, _fold_sel(F, Gn, dev), mean, std, loss)
    l1 = (regs * alphas).repeat(F)                      # [L]
    l2 = (regs * (1.0 - alphas)).repeat(F)              # [L]
    B = torch.zeros((L, scan.d_work), dtype=torch.float32, device=dev)
    b0 = torch.zeros(L, dtype=torch.float32, device=dev)
    i, delta = 0, float("inf")
    while i < int(max_iter) and delta > float(tol):
        B, b0, dvec = scan.update(B, b0, scan.accumulate(B, b0), l1, l2,
                                  fit_intercept)
        delta = float(dvec.max())       # the iteration's one host check
        i += 1
    if standardize:
        B = B / scan.std[None, :]
        b0 = b0 - (B * scan.mean[None, :]).sum(1)
    B = B[:, :d]  # drop inert padded columns on the tiled path
    return B.reshape(F, Gn, d), b0.reshape(F, Gn)


# -- squared-loss sufficient-statistics route ---------------------------------

def sweep_glm_squared_gram(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                           fold_masks: torch.Tensor, regs, alphas,
                           max_iter=50, tol=1e-6, *,
                           fit_intercept: bool = True,
                           standardize: bool = True
                           ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Squared-loss (fold x grid) sweep from ONE pass over X.

    The pass accumulates each fold's weighted Gram [F, d, d] (the same
    pairwise-product blocks as the IRLS routes' Hessians), X^T W_f y,
    X^T W_f 1 and the sums, standardizing each block on the fly with the
    global-weight column moments (one stats pass first: raw-moment
    standardization would cancel in f32 for large-mean columns). The grid
    then solves from the cached moments: ridge lanes in closed form,
    elastic-net lanes by proximal Newton started at the ridge solution of
    the same L2. Lanes are fold-major, l = f * G + g. Returns (B [F, G, d]
    f32 in RAW feature units, b0 [F, G], the proximal solve's
    iterations)."""
    n, d = X.shape
    dev = X.device
    f32 = torch.float32
    F = fold_masks.shape[0]
    regs = torch.as_tensor(regs, dtype=f32, device=dev)
    alphas = torch.as_tensor(alphas, dtype=f32, device=dev)
    Gn = regs.shape[0]
    tiled, d_work, bt, pairs = _tiling(d)
    dp = d_work - d
    if standardize:
        mean, std = glm_standardize_stats(X, w)
    else:
        mean = torch.zeros(d, dtype=f32, device=dev)
        std = torch.ones(d, dtype=f32, device=dev)
    mean_p, std_p = Fn.pad(mean, (0, dp)), Fn.pad(std, (0, dp), value=1.0)
    wsum_f = torch.clamp(fold_masks @ w, min=EPS)               # [F]
    c = min(_ROW_BLOCK_WIDE if tiled else _row_block(d_work), n)
    hess_blocks, assemble, hA = _gram_fns(tiled, d_work, F, bt, pairs, dev)
    cA = torch.zeros((F, d_work), dtype=f32, device=dev)
    sxA = torch.zeros((F, d_work), dtype=f32, device=dev)
    syA = torch.zeros(F, dtype=f32, device=dev)
    for x_blk, y_blk, w_blk, m_blk in _blocked(X, y, w, fold_masks, c):
        xf = x_blk.to(f32)
        if dp:
            xf = Fn.pad(xf, (0, dp))
        xf = (xf - mean_p) / std_p
        wlf = m_blk.T * w_blk[:, None]                  # [c, F]
        wy = wlf * y_blk[:, None]                       # [c, F]
        hess_blocks(hA, xf, wlf)
        cA.addmm_(wy.T, xf)
        sxA.addmm_(wlf.T, xf)
        syA += wy.sum(0)
    Gm_f = assemble(hA)                                 # [F, d_work, d_work]

    # each fold's moments along the fold-major lane axis l = f * Gn + g
    l1 = (regs * alphas).repeat(F)                      # [L]
    l2 = (regs * (1.0 - alphas)).repeat(F)              # [L]
    Gm = Gm_f.repeat_interleave(Gn, dim=0)
    cm = cA.repeat_interleave(Gn, dim=0)
    sx = sxA.repeat_interleave(Gn, dim=0)
    sy = syA.repeat_interleave(Gn)
    sw = wsum_f.repeat_interleave(Gn)
    beta_r, b0_r = G.ridge_gram_solve(Gm, cm, sx, sy, sw, l2,
                                      fit_intercept=fit_intercept)
    beta_p, b0_p, iters = G.prox_newton_gram(
        Gm, cm, sx, sy, sw, l1, l2, beta_r, b0_r, max_iter, tol,
        fit_intercept=fit_intercept)
    is_l1 = l1 > 0.0
    B = torch.where(is_l1[:, None], beta_p, beta_r)
    b0 = torch.where(is_l1, b0_p, b0_r)
    B = B / std_p[None, :]
    b0 = b0 - (B * mean_p[None, :]).sum(1)
    B = B[:, :d]
    return B.reshape(F, Gn, d), b0.reshape(F, Gn), iters


# -- round kernel + host retirement driver (IRLS losses) ---------------------

def sweep_glm_round(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                    fold_masks: torch.Tensor, sel: torch.Tensor,
                    l1: torch.Tensor, l2: torch.Tensor, B0: torch.Tensor,
                    b00: torch.Tensor, mean: Optional[torch.Tensor],
                    std: Optional[torch.Tensor], iters_budget: int,
                    tol: float, *, loss: str, fit_intercept: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One retirement round: up to `iters_budget` Newton iterations for
    the lanes of sel [F, Lb] (each lane's fold as a one-hot column), with
    a per-lane delta. B0 [Lb, d] / b00 [Lb] carry the lanes' standardized-
    space state between rounds; mean/std (None: no standardization) apply
    on the fly per block. The round ends early as soon as every lane's
    delta clears tol. Returns (B [Lb, d], b0 [Lb], delta [Lb], iters)."""
    scan = _Scan(X, y, w, fold_masks, sel, mean, std, loss)
    d = X.shape[1]
    B = Fn.pad(B0.to(torch.float32), (0, scan.d_work - d))
    b0 = b00.to(torch.float32)
    delta = torch.full((sel.shape[1],), float("inf"), dtype=torch.float32,
                       device=X.device)
    i = 0
    while i < int(iters_budget):
        B, b0, delta = scan.update(B, b0, scan.accumulate(B, b0), l1, l2,
                                   fit_intercept)
        i += 1
        if float(delta.max()) <= float(tol):   # the iteration's host check
            break
    return B[:, :d], b0, delta, i


# -- tileplane row-source route (X streamed, never resident) ----------------

def _source_prep_step(carry, xt, yt, wt, mt):
    """The streamed prep pass's tile step: global-weight column moments by
    an exact Chan merge of each tile's two-pass moments (one-pass E[x^2]
    would cancel in f32 for large-mean columns) and the per-fold weight
    sums. f32, as the reference's."""
    cnt, mean, m2, wsum_f = carry
    c_t = wt.sum()
    safe = torch.clamp(c_t, min=EPS)
    mean_t = (xt * wt[:, None]).sum(0) / safe
    m2_t = (((xt - mean_t[None, :]) ** 2) * wt[:, None]).sum(0)
    n = cnt + c_t
    nsafe = torch.clamp(n, min=EPS)
    delta = mean_t - mean
    return (n, mean + delta * (c_t / nsafe),
            m2 + m2_t + delta * delta * (cnt * c_t / nsafe),
            wsum_f + (mt * wt[:, None]).sum(0))


def _source_prep(source, d: int, F: int, standardize: bool, tile_rows: int,
                 prefetch: int, dev: torch.device):
    """ONE streamed pass before round 0: (mean, std) of the standardization
    (None, None without it) and the per-fold weight sums [F] in float64 on
    the host. The resident route takes these from the resident arrays;
    here they are pass-invariant, so one extra read of the stream
    hoists them out of every round."""
    from ..parallel import tileplane as TP

    f32 = torch.float32
    prep0 = (torch.zeros((), dtype=f32, device=dev),
             torch.zeros(d, dtype=f32, device=dev),
             torch.zeros(d, dtype=f32, device=dev),
             torch.zeros(F, dtype=f32, device=dev))
    (cnt, mu, m2, wsum_f), _ = TP.run_tileplane(
        source, _source_prep_step, prep0, tile_rows=tile_rows,
        label="glm_prep", prefetch=prefetch, device=dev)
    wsum_f_h = np.maximum(wsum_f.cpu().numpy().astype(np.float64), EPS)
    if not standardize:
        return None, None, wsum_f_h
    var = torch.clamp(m2 / torch.clamp(cnt, min=EPS), min=EPS)
    return mu, torch.sqrt(var), wsum_f_h


def _source_round(source, sel, l1, l2, B0, b00, mean, std, budget: int,
                  tol: float, wsum_f_h, *, loss: str, fit_intercept: bool,
                  tile_rows: int, prefetch: int):
    """One retirement round over a row source: each Newton iteration is
    one double-buffered pass of the source accumulating every lane's
    gradient and Hessian (the resident scan's block step, `_Lanes.
    add_block`, on each tile) and one update, with the resident round's
    early exit. Returns (B [Lb, d], b0 [Lb], delta [Lb], iters)."""
    from ..parallel import tileplane as TP

    dev = sel.device
    d = B0.shape[1]
    wsum_f = torch.as_tensor(wsum_f_h.astype(np.float32), device=dev)
    lanes = _Lanes(d, tile_rows, sel, mean, std, loss, wsum_f)
    c = lanes.c
    B = Fn.pad(B0, (0, lanes.d_work - d))
    b0 = b00
    delta = torch.full((sel.shape[1],), float("inf"), dtype=torch.float32,
                       device=dev)
    i = 0
    while i < int(budget):
        Bt = lanes.coef_t(B)

        def step(acc, xt, yt, wt, mt, Bt=Bt, b0=b0):
            for s in range(0, xt.shape[0], c):
                lanes.add_block(acc, xt[s:s + c], yt[s:s + c],
                                mt[s:s + c] * wt[s:s + c, None], Bt, b0)
            return acc

        acc, _ = TP.run_tileplane(source, step, lanes.zeros(),
                                  tile_rows=tile_rows, label="glm_round",
                                  prefetch=prefetch, device=dev)
        B, b0, delta = lanes.update(B, b0, acc, l1, l2, fit_intercept)
        i += 1
        if float(delta.max()) <= float(tol):   # the iteration's one fetch
            break
    return B[:, :d], b0, delta, i


def _new_round_state(L: int, d: int) -> Dict[str, Any]:
    return {"B": np.zeros((L, d), np.float32),
            "b0": np.zeros(L, np.float32),
            "delta": np.full(L, np.inf, np.float32),
            "iters": np.zeros(L, np.int32),
            "retired": np.zeros(L, bool), "warmed": False,
            "rounds": 0, "data_passes": 0, "lane_passes": 0,
            "padded_lane_passes": 0,
            "active_per_round": [], "iters_per_round": [],
            "bucket_sizes": []}


def sweep_glm_streamed_rounds(X, y, w, fold_masks, regs, alphas, *,
                              loss: str, max_iter: int = 50,
                              tol: float = 1e-6, fit_intercept: bool = True,
                              standardize: bool = True, mesh=None,
                              round_iters: Optional[int] = None,
                              warm_start: bool = True,
                              warm_seed: Optional[Tuple] = None,
                              state: Optional[Dict[str, Any]] = None,
                              on_round: Optional[Callable] = None,
                              device=None
                              ) -> Tuple[np.ndarray, np.ndarray,
                                         Dict[str, Any]]:
    """Host-driven convergence-aware streamed sweep for the IRLS losses.

    Runs `sweep_glm_round` (K = round_iters or TMOG_GLM_ROUND_ITERS,
    default ROUND_ITERS_DEFAULT, Newton iterations a round); after each
    round, lanes whose own delta cleared `tol` — or that exhausted
    `max_iter` — RETIRE with their coefficients frozen, and the survivors
    run in the next round. When `warm_start`, round 0 fits only each
    fold's strongest-regularization lane and seeds the rest of the fold
    from it; TMOG_GLM_WARMSTART=0 disables.

    X [n, d], y [n], w [n] and fold_masks [F, n] are tensors on one
    device — OR X is a `parallel.tileplane.RowSource` whose chunks yield
    (x [c, d], y [c], w [c], fold_masks [c, F]), with y / w / fold_masks
    None: then one prep pass streams the standardization moments and the
    fold weight sums, and every Newton iteration of every round streams
    the source's tiles onto `device` (None: CUDA) through the
    double-buffered tileplane (info["driver"] == "tileplane"), so X is
    never resident. `state`/`on_round` are the round-granular checkpoint
    hooks (automl/tuning/checkpoint.RoundCheckpoint): `on_round(state)`
    fires after every retirement boundary with the full resumable state
    dict, and passing that dict back as `state` resumes bit-identically.
    `mesh` (row-sharded sweeps) and `warm_seed` (the retrain refit's
    across-time seed) are not ported and raise.

    Returns (B [F, G, d] f32 RAW units, b0 [F, G], info) where info holds
    the convergence telemetry (glm_rounds, data_passes, lane_passes,
    lanes_retired, active_per_round, iters_per_round, bucket_sizes — the
    lanes each round actually ran)."""
    from ..parallel import tileplane as TP

    if mesh is not None:
        raise TP._not_ported("a mesh-sharded GLM sweep (mesh=)")
    if warm_seed is not None:
        raise NotImplementedError(
            "warm_seed (the retrain refit's across-time seed) is not ported")

    src_mode = isinstance(X, TP.RowSource)
    if src_mode:
        if any(a is not None for a in (y, w, fold_masks)):
            raise ValueError("with a RowSource, y/w/fold_masks ride the "
                             "source chunks — pass them as None")
        from ..device import resolve_device
        dev = resolve_device(device)
        probe = X.peek()
        d = int(probe[0].shape[1])
        F = int(probe[3].shape[1])
        tile_rows = TP.tile_rows_for(4 * (d + F + 2), X.n_rows)
        # one ring depth for the whole sweep (prep pass + every round)
        prefetch = TP.tile_prefetch_depth()
    elif not isinstance(X, torch.Tensor):
        raise TypeError("X must be a tensor or a tileplane RowSource "
                        f"(got {type(X).__name__})")
    else:
        dev = X.device
        F = int(fold_masks.shape[0])
        d = int(X.shape[1])
    regs = np.asarray(regs, np.float32)
    alphas = np.asarray(alphas, np.float32)
    Gn = int(regs.shape[0])
    L = F * Gn
    K = int(round_iters if round_iters is not None
            else os.environ.get("TMOG_GLM_ROUND_ITERS",
                                str(ROUND_ITERS_DEFAULT)))
    K = max(K, 1)
    max_iter = int(max_iter)
    tol_f = float(tol)
    if src_mode:
        mean, std, wsum_f_h = _source_prep(X, d, F, standardize, tile_rows,
                                           prefetch, dev)
    else:
        mean, std = _stats(X, w, standardize)

    lane_fold = np.repeat(np.arange(F, dtype=np.int64), Gn)
    l1v = np.tile(regs * alphas, F).astype(np.float32)
    l2v = np.tile(regs * (1.0 - alphas), F).astype(np.float32)
    st = state if state is not None else _new_round_state(L, d)

    def put(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def run_round(idx, budget):
        k = len(idx)
        sel = np.zeros((F, k), np.float32)
        sel[lane_fold[idx], np.arange(k)] = 1.0
        args = (put(sel), put(l1v[idx]), put(l2v[idx]), put(st["B"][idx]),
                put(st["b0"][idx]), mean, std, budget, tol_f)
        if src_mode:
            Bb, b0b, db, it = _source_round(
                X, *args, wsum_f_h, loss=loss, fit_intercept=fit_intercept,
                tile_rows=tile_rows, prefetch=prefetch)
        else:
            Bb, b0b, db, it = sweep_glm_round(
                X, y, w, fold_masks, *args, loss=loss,
                fit_intercept=fit_intercept)
        st["B"][idx] = Bb.cpu().numpy()
        st["b0"][idx] = b0b.cpu().numpy()
        st["delta"][idx] = db.cpu().numpy()
        st["iters"][idx] += it
        st["rounds"] += 1
        st["data_passes"] += it
        st["lane_passes"] += it * k
        # the lanes the device ran: exactly the active ones (no bucket)
        st["padded_lane_passes"] += it * k
        st["active_per_round"].append(k)
        st["iters_per_round"].append(it)
        st["bucket_sizes"].append(k)

    def retire(idx):
        st["retired"][idx] = (st["delta"][idx] <= tol_f) \
            | (st["iters"][idx] >= max_iter)

    if (warm_start and env_on("TMOG_GLM_WARMSTART") and not st["warmed"]
            and Gn > 1
            and not st["retired"].any() and int(st["iters"].max()) == 0):
        g_star = int(np.argmax(regs))
        warm_idx = np.arange(F, dtype=np.int64) * Gn + g_star
        run_round(warm_idx, min(K, max_iter))
        # pathwise continuation: every other lane of the fold starts at
        # its fold's strongest-regularization solution instead of zero
        for f in range(F):
            rows = np.arange(f * Gn, (f + 1) * Gn)
            others = rows[rows != warm_idx[f]]
            st["B"][others] = st["B"][warm_idx[f]]
            st["b0"][others] = st["b0"][warm_idx[f]]
        retire(warm_idx)
        st["warmed"] = True
        if on_round is not None:
            on_round(st)

    while True:
        active = np.flatnonzero(~st["retired"])
        if active.size == 0:
            break
        budget = max(1, min(K, int((max_iter - st["iters"][active]).min())))
        run_round(active, budget)
        retire(active)
        if on_round is not None:
            on_round(st)

    # host-side unstandardize, f32 like the legacy route
    if standardize:
        mean_h = mean.cpu().numpy().astype(np.float32)
        std_h = std.cpu().numpy().astype(np.float32)
    else:
        mean_h = np.zeros(d, np.float32)
        std_h = np.ones(d, np.float32)
    B = st["B"] / std_h[None, :]
    b0 = st["b0"] - (B * mean_h[None, :]).sum(1, dtype=np.float32)
    info = {"route": "streamed", "kernel": "rounds",
            "driver": "tileplane" if src_mode else "resident",
            "glm_rounds": int(st["rounds"]),
            "data_passes": int(st["data_passes"]),
            "lane_passes": int(st["lane_passes"]),
            "padded_lane_passes": int(st["padded_lane_passes"]),
            "lanes_total": L,
            "lanes_retired": int((st["delta"] <= tol_f).sum()),
            "lanes_at_cap": int(((st["delta"] > tol_f)
                                 & (st["iters"] >= max_iter)).sum()),
            "active_per_round": [int(v) for v in st["active_per_round"]],
            "iters_per_round": [int(v) for v in st["iters_per_round"]],
            "bucket_sizes": [int(v) for v in st["bucket_sizes"]],
            "warm_start": bool(st["warmed"]),
            "warm_seeded": False}
    return B.reshape(F, Gn, d), b0.reshape(F, Gn), info


def sweep_scores_fold(X: torch.Tensor, B_f: torch.Tensor,
                      b0_f: torch.Tensor) -> torch.Tensor:
    """[n, Gc] margins for one fold's grid chunk: one product, f32 (a bf16
    X stays bf16, the product accumulated in f32: `glm._mm`)."""
    if X.dtype != torch.float32:
        return G._mm(X, B_f.T) + b0_f[None, :]
    return X @ B_f.T.to(X.dtype) + b0_f[None, :]
