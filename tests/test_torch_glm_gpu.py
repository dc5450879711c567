"""The port's GLM sweep on the card against the same functions on the CPU.
Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_glm_gpu.py

Tolerances: coefficients within 1e-4 (f32 sums in another order on the
card inside a Newton solve with tol 1e-6; TF32 stays off), the same
retirement telemetry (unless a lane's delta lay within 1e-7 of tol at a
round boundary, printed), fold AuPR within 1e-4, and the rank-metric
histogram exact (0/1 weights: integer sums in f32).
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.automl.tuning import validators as PV
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.models.glm import OpLinearSVC, OpLogisticRegression
from transmogrifai_tpu_torch.ops import glm as G
from transmogrifai_tpu_torch.ops import glm_sweep as GS
from transmogrifai_tpu_torch.ops import metrics_ops as M
from transmogrifai_tpu_torch.ops import tree_kernels as TK

TOL = 1e-4
TEL_KEYS = ("glm_rounds", "data_passes", "lane_passes", "active_per_round",
            "iters_per_round", "lanes_retired", "lanes_at_cap")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _data(n=6000, d=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.linspace(1.5, -1.5, d)
    p = 1 / (1 + np.exp(-(X @ beta * 0.5 + 0.3)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    X = (X * 2.0 + 1.0).astype(np.float32)
    w = rng.uniform(0.3, 1.7, size=n).astype(np.float32)
    fold = rng.integers(0, 3, size=n)
    masks = np.stack([(fold != k).astype(np.float32) for k in range(3)])
    return X, y, w, masks


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


def _same_telemetry(a, b, deltas, tol):
    diff = {k: (a[k], b[k]) for k in TEL_KEYS if a[k] != b[k]}
    if diff:
        near = sorted({float(v) for dl in deltas for v in dl
                       if abs(float(v) - tol) < 1e-7})
        print(f"telemetry differs {diff}; deltas within 1e-7 of tol: {near}")
        assert near, diff


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
@pytest.mark.parametrize("warm_start", [True, False])
def test_round_driver_cuda_matches_cpu(cuda_device, loss, warm_start):
    X, y, w, masks = _data()
    regs = np.array([0.001, 0.02, 0.3, 1.0], np.float32)
    alphas = (np.array([0.0, 0.25, 0.5, 0.0], np.float32)
              if loss == "logistic" else np.zeros(4, np.float32))
    out, deltas = {}, []
    for dev in ("cpu", cuda_device):
        out[str(dev)] = GS.sweep_glm_streamed_rounds(
            *_on(dev, X, y, w, masks), regs, alphas, loss=loss, max_iter=30,
            tol=1e-6, round_iters=3, warm_start=warm_start,
            on_round=lambda st: deltas.append(st["delta"].copy()))
    (cB, cb0, ci), (gB, gb0, gi) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(gB, cB, rtol=0, atol=TOL)
    np.testing.assert_allclose(gb0, cb0, rtol=0, atol=TOL)
    _same_telemetry(ci, gi, deltas, 1e-6)


@pytest.mark.gpu
def test_legacy_and_tiled_streamed_cuda_matches_cpu(cuda_device):
    """The global-max route, at d = 136 (the tiled Gram) with a tail block."""
    X, y, w, masks = _data(n=5000, d=136, seed=1)
    regs = np.array([0.05, 0.5], np.float32)
    alphas = np.array([0.0, 0.5], np.float32)
    got = [GS.sweep_glm_streamed(*_on(dev, X, y, w, masks), regs, alphas,
                                 loss="logistic", max_iter=15)
           for dev in ("cpu", cuda_device)]
    for c, g in zip(*got):
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("standardize", [True, False])
def test_lane_batched_solver_cuda_matches_cpu(cuda_device, standardize):
    """The vmapped route's solver: 6 lanes, each with its own fold weights
    and penalties, on the card and on the CPU."""
    X, y, w, masks = _data(seed=2)
    W = np.concatenate([masks * w, masks * w])
    regs = np.repeat(np.array([0.002, 0.2], np.float32), 3)
    alphas = np.repeat(np.array([0.0, 0.5], np.float32), 3)
    got = [G.fit_logistic(*_on(dev, X, y, W, regs, alphas), max_iter=30,
                          standardize=standardize)
           for dev in ("cpu", cuda_device)]
    for c, g in zip(*got):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=0,
                                   atol=TOL)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["streamed", "vmapped"])
@pytest.mark.parametrize("est", [OpLogisticRegression, OpLinearSVC])
def test_validate_cuda_matches_cpu(cuda_device, monkeypatch, route, est):
    monkeypatch.setattr(PV, "STREAMED_SWEEP_MIN_ROWS",
                        0 if route == "streamed" else 10 ** 12)
    monkeypatch.setattr(PV, "BINNED_RANK_METRIC_MIN_ROWS", 0)
    X, y, w, _ = _data(n=8000, seed=3)
    grids = [{"reg_param": r} for r in (0.001, 0.03, 0.3)]
    best = {}
    for dev in ("cpu", "cuda"):
        cv = PV.CrossValidation(Evaluators.BinaryClassification.au_pr(),
                                num_folds=3, device=dev)
        best[dev] = (cv, cv.validate([(est(max_iter=20, device=dev),
                                       [dict(g) for g in grids])], X, y, w))
    (ccv, cb), (gcv, gb) = best["cpu"], best["cuda"]
    assert gb.best_grid == cb.best_grid
    for a, b in zip(cb.validated, gb.validated):
        assert a.route == b.route == route
        np.testing.assert_allclose(b.fold_metrics, a.fold_metrics, rtol=0,
                                   atol=TOL)
    if route == "streamed":
        _same_telemetry(ccv.last_streamed_telemetry,
                        gcv.last_streamed_telemetry, [], 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [8, 3])
def test_rank_metric_counts_at_the_glm_eval_shape(cuda_device, lanes):
    """B1 (hist_folds) as the streamed eval launches it: F = 1, 4096
    buckets, the grid chunk's lanes in the slot axis, 0/1 weights."""
    rng = np.random.default_rng(4)
    n = 50_000
    s = rng.normal(size=(lanes, n)).astype(np.float32) * 3
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    vw = (rng.uniform(size=n) < 0.2).astype(np.float32)
    wl = np.broadcast_to(vw, (lanes, n)).copy()
    want = M.binned_cum_counts_lanes(*_on("cpu", s, y, wl), 4096)
    before = TK.launches["hist_folds"]
    got = M.binned_cum_counts_lanes(*_on(cuda_device, s, y, wl), 4096)
    torch.cuda.synchronize()
    assert TK.launches["hist_folds"] == before + 1
    for g, c in zip(got, want):
        assert torch.equal(g.cpu(), c)
