"""The validator's `sweep_dtype` in the port (transmogrifai_tpu_torch): a
bf16 sweep matrix on the vmapped and streamed logistic-regression routes
and in the trees' binning, against the JAX package's `jnp.bfloat16` sweep
on the same seeded numpy inputs, on the CPU.

Tolerances, and why:
- bin ids from a bf16 X equal: both packages sketch and digitize an f32
  copy of the same bf16 values;
- coefficients within 1e-4, as for f32 (tests/test_torch_glm_sweep.py):
  both packages round each elementwise bf16 product (the standardization,
  the row-scaled Hessian operand) to bf16 and accumulate the products in
  f32, in different orders (measured up to 4e-6 here);
- fold AuPR within 1e-4 as for f32. Both packages score a bf16 X with
  the coefficients cast to bf16, and two coefficient vectors within the
  tolerance above can round apart there; the JAX package's vmapped sweep
  also compiles its fits, scoring and metric into one program, which XLA
  on the CPU may evaluate otherwise than the same functions called one by
  one. Where a fold differs by more than 1e-4, the JAX package's own
  functions on that lane, called one by one (fit, scoring with the cast,
  metric), must reproduce the port's fold AuPR within 1e-6 (the printed
  witness);
- the same winner and the same route labels.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.automl.tuning import validators as JV
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JE
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.ops import glm as JG
from transmogrifai_tpu.ops import glm_sweep as JGS
from transmogrifai_tpu.ops import metrics_ops as JM
from transmogrifai_tpu.ops import trees as JT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.tuning import checkpoint as PC
from transmogrifai_tpu_torch.automl.tuning import validators as PV
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier as PXGB
from transmogrifai_tpu_torch.ops import glm as PG
from transmogrifai_tpu_torch.ops import glm_sweep as PGS
from transmogrifai_tpu_torch.ops import trees as PT

COEF_TOL = 1e-4
METRIC_TOL = 1e-4
LR_GRIDS = [{"reg_param": r, "elastic_net_param": a}
            for r in (0.001, 0.05, 0.3) for a in (0.0, 0.5)]


def _data(n=2400, d=8, seed=11):
    """Binary data whose columns have spread means and scales (so the
    bf16 standardization matters) and non-unit row weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.linspace(1.5, -1.5, d)
    p = 1 / (1 + np.exp(-(X @ beta * 0.6 + 0.3)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    X = (X * np.linspace(0.5, 3.0, d) + np.linspace(-2, 2, d)) \
        .astype(np.float32)
    w = rng.uniform(0.3, 1.7, size=n).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("n,n_bins", [(3000, 32), (140_000, 16)])
def test_bins_of_a_bf16_matrix_match_jax(n, n_bins):
    """Edges and bin ids from a bf16 X equal the JAX package's (above
    131 072 rows both sketch a strided sample)."""
    rng = np.random.default_rng(n)
    X = (rng.normal(size=(n, 6)) * [1, 10, 100, 0.01, 3, 1]).astype(
        np.float32)
    X[rng.uniform(size=n) < 0.1, 0] = np.nan
    X[:, 4] = np.round(X[:, 4])                       # ties
    Xj = jnp.asarray(X, jnp.bfloat16)
    Xp = torch.from_numpy(X).bfloat16()
    np.testing.assert_array_equal(np.asarray(Xj.astype(jnp.float32)),
                                  Xp.float().numpy())
    ej = np.asarray(JT.quantile_edges(Xj, n_bins))
    ep = PT.quantile_edges(Xp, n_bins)
    np.testing.assert_array_equal(ep.numpy(), ej)
    bj = np.asarray(JT.bin_matrix(Xj, jnp.asarray(ej)))
    bp = PT.bin_matrix(Xp, ep)
    np.testing.assert_array_equal(bp.numpy(), bj)
    assert (bp.numpy()[np.isnan(X)] == 0).all()


def _route(monkeypatch, route):
    for mod in (JV, PV):
        monkeypatch.setattr(mod, "STREAMED_SWEEP_MIN_ROWS",
                            0 if route == "streamed" else 10 ** 12)


def _lane_coefficients(route, X, y, w, masks, standardize, grids):
    """Both packages' bf16 coefficients of every (fold, grid point) lane as
    their routes fit them: {(f, gi): (jax (beta, b0), port (beta, b0))}."""
    regs = np.array([g["reg_param"] for g in grids], np.float32)
    alphas = np.array([g["elastic_net_param"] for g in grids], np.float32)
    out = {}
    if route == "streamed":
        kw = dict(loss="logistic", max_iter=20, tol=1e-6,
                  standardize=standardize)
        jB, jb0, _ = JGS.sweep_glm_streamed_rounds(
            jnp.asarray(X, jnp.bfloat16), jnp.asarray(y), jnp.asarray(w),
            jnp.asarray(masks), regs, alphas, **kw)
        pB, pb0, _ = PGS.sweep_glm_streamed_rounds(
            torch.from_numpy(X).bfloat16(), torch.from_numpy(y),
            torch.from_numpy(w), torch.from_numpy(masks), regs, alphas, **kw)
        for f in range(masks.shape[0]):
            for gi in range(len(grids)):
                out[f, gi] = ((np.asarray(jB)[f, gi], float(jb0[f, gi])),
                              (np.asarray(pB)[f, gi], float(pb0[f, gi])))
        return out
    F = masks.shape[0]
    lanes_w = np.repeat(masks * w[None, :], len(grids), axis=0)
    pB, pb0 = PG.fit_logistic(
        torch.from_numpy(X).bfloat16(), torch.from_numpy(y),
        torch.from_numpy(lanes_w), torch.from_numpy(np.tile(regs, F)),
        torch.from_numpy(np.tile(alphas, F)), max_iter=20,
        standardize=standardize)
    for f in range(F):
        for gi in range(len(grids)):
            jb, jb0 = JG.fit_logistic(
                jnp.asarray(X, jnp.bfloat16), jnp.asarray(y),
                jnp.asarray(masks[f] * w), regs[gi], alphas[gi], max_iter=20,
                standardize=standardize)
            lane = f * len(grids) + gi
            out[f, gi] = ((np.asarray(jb), float(jb0)),
                          (pB[lane].numpy(), float(pb0[lane])))
    return out


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("route", ["vmapped", "streamed"])
def test_bf16_lr_routes_match_jax(monkeypatch, route, standardize):
    _route(monkeypatch, route)
    X, y, w = _data()
    grids = [dict(g) for g in LR_GRIDS]
    jval = JV.CrossValidation(JE.BinaryClassification.au_pr(), num_folds=3,
                              seed=7, sweep_dtype=jnp.bfloat16)
    jbest = jval.validate([(JLR(max_iter=20, standardization=standardize),
                            grids)], X, y, w)
    pval = PV.CrossValidation(PE.BinaryClassification.au_pr(), num_folds=3,
                              seed=7, device="cpu",
                              sweep_dtype=torch.bfloat16)
    pbest = pval.validate([(PLR(max_iter=20, standardization=standardize,
                                device="cpu"), grids)], X, y, w)
    assert pbest.best_grid == jbest.best_grid
    assert {v.route for v in pbest.validated} == {route}
    masks = pval.fold_masks(y)
    coefs = _lane_coefficients(route, X, y, w, masks, standardize, grids)
    worst = max(max(np.abs(jb - pb).max(), abs(j0 - p0))
                for (jb, j0), (pb, p0) in coefs.values())
    print(f"largest coefficient difference {worst:.3g}")
    assert worst <= COEF_TOL
    Xj = jnp.asarray(X, jnp.bfloat16)
    for gi, (jv, pv) in enumerate(zip(jbest.validated, pbest.validated)):
        assert pv.grid == jv.grid and pv.route == jv.route
        for f, (a, b) in enumerate(zip(jv.fold_metrics, pv.fold_metrics)):
            if abs(a - b) <= METRIC_TOL:
                continue
            # the witness: the JAX package's functions on this lane, one
            # by one: its coefficients, scored with the cast, its metric
            (jb, j0), _ = coefs[f, gi]
            score = jnp.matmul(Xj, jnp.asarray(jb).astype(jnp.bfloat16),
                               preferred_element_type=jnp.float32) + j0
            alone = float(JM.au_pr(score, jnp.asarray(y),
                                   jnp.asarray((1.0 - masks[f]) * w)))
            print(f"cell {pv.grid} fold {f}: |dAuPR| {abs(a - b):.3g}; the "
                  f"JAX package's functions one by one: {alone} (port {b}, "
                  f"JAX sweep {a})")
            assert abs(alone - b) <= 1e-6, (pv.grid, f, a, b, alone)


def test_mm_keeps_bf16_operands_and_returns_f32():
    """`_mm` casts the second operand to the first's dtype and returns
    the f32-accumulated product, blocked on the CPU: the same as an f32
    product of the bf16 values (exact products, f32 sums)."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(3000, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5, 4)).astype(np.float32))
    ab = a.bfloat16()
    for got, want in (
            (PG._mm(ab, b), ab.float() @ b.bfloat16().float()),
            (PG._mm(ab.T, torch.ones(3000, 2)),
             ab.float().T @ torch.ones(3000, 2)),
            (PG._mm(ab[None].expand(2, -1, -1), b),
             ab.float()[None].expand(2, -1, -1) @ b.bfloat16().float())):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(PG._mm(a, b), torch.matmul(a, b))   # f32: plain
    assert PG._solver_dtype(ab) == torch.float32


def test_f32_results_unchanged_when_sweep_dtype_is_none(monkeypatch):
    """sweep_dtype None and torch.float32 are the same f32 sweep, cell for
    cell, on the GLM routes and the mask-fold route."""
    X, y, w = _data(n=1500, seed=3)
    for route in ("vmapped", "streamed"):
        _route(monkeypatch, route)
        cells = []
        for dtype in (None, torch.float32):
            val = PV.CrossValidation(PE.BinaryClassification.au_pr(),
                                     num_folds=3, seed=7, device="cpu",
                                     sweep_dtype=dtype)
            best = val.validate(
                [(PLR(max_iter=20, device="cpu"), [dict(g) for g in
                                                   LR_GRIDS[:4]]),
                 (PXGB(device="cpu"), [dict(num_round=2, max_depth=2,
                                            max_bins=8, eta=e)
                                       for e in (0.1, 0.3)])], X, y, w)
            cells.append([(v.route, v.fold_metrics) for v in best.validated])
        assert cells[0] == cells[1]
    with pytest.raises(ValueError, match="sweep_dtype"):
        PV.CrossValidation(PE.BinaryClassification.au_pr(),
                           sweep_dtype=torch.float16)


def test_checkpoint_tag_splits_f32_from_bf16(monkeypatch, tmp_path):
    """A checkpointed f32 sweep's cells never replay into a bf16 sweep
    (and the reverse): the path tag carries the dtype ("vmapped:float32",
    "vmapped:bfloat16"), as the reference's does."""
    _route(monkeypatch, "vmapped")
    X, y, w = _data(n=800, seed=15)
    path = str(tmp_path / "sweep.jsonl")
    fits = []
    orig = PLR.batched_fit_fn

    def counting(self, *a, **k):
        fit_one, axes = orig(self, *a, **k)
        return (lambda *fa, **fk: fits.append(1) or fit_one(*fa, **fk)), axes
    monkeypatch.setattr(PLR, "batched_fit_fn", counting)
    paths = []
    book = PV.Validator._cell_bookkeeping

    def tagging(self, *a, path="", **k):
        paths.append(path)
        return book(self, *a, path=path, **k)
    monkeypatch.setattr(PV.Validator, "_cell_bookkeeping", tagging)

    def run(dtype):
        val = PV.CrossValidation(PE.BinaryClassification.au_pr(),
                                 num_folds=2, seed=3, device="cpu",
                                 sweep_dtype=dtype)
        val.checkpoint_path = path
        return val.validate([(PLR(max_iter=20, device="cpu"),
                              [dict(g) for g in LR_GRIDS[:3]])], X, y)

    run(None)
    assert len(fits) == 1 and len(PC.SweepCheckpoint(path)) == 3
    bf = run(torch.bfloat16)
    assert len(fits) == 2 and len(PC.SweepCheckpoint(path)) == 6
    run(torch.bfloat16)                       # its own cells replay
    assert len(fits) == 2
    assert paths == ["vmapped:float32", "vmapped:bfloat16",
                     "vmapped:bfloat16"]
    assert {v.route for v in bf.validated} == {"vmapped"}
