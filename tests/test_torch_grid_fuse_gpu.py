"""The config-fused sweep and the bf16 sweep dtype on the card: the four
kernels at a fused sweep's 40 lanes, the lane planner against the card's
free memory, the fused fit's residency model against its measured peak,
`glm._mm` on bf16 operands, and a small fused sweep against the per-config
one. Every test needs a CUDA device and skips without one.
This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_grid_fuse_gpu.py

Tolerances: route and table_lookup exact, histogram counts exact, g/h
cells held to the float64 sums within 1e-4 of a cell's sum of |terms| or
the plain version's own error (`hist_paths.accuracy`); `_mm` within 1e-5
relative of the f32 product of the same bf16 values (exact products, f32
sums in another order); fused fold metrics within 1e-3 of the per-config
sweep's (the card-against-card bound of boosted fold metrics: the kernels'
atomic flushes sum in a changing order); the residency model at or above
the fit's measured peak and within 15% of it.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.automl.tuning.validators import CrossValidation
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.ops import glm as G
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.tools import hist_paths as HP

pytestmark = pytest.mark.gpu

LANES = 40        # a depth's 8 XGBoost configs x 5 folds
ROWS = 200_003    # no multiple of any tile


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module")
def inputs():
    _need_cuda()
    return HP.kernel_inputs(ROWS, seed=11, lanes=LANES)


def _shapes(d):
    return [s for s in HP.hist_shapes(d) + HP.lane_shapes(d)
            if not s[0].startswith("rank")]


@pytest.mark.parametrize("index", range(12))
def test_kernels_at_40_lanes(inputs, index):
    """hist_folds at the root (uniform and skewed bins), route_hist at S = 1
    to 16, route at 8 and 32 nodes (and 32 with shared tables),
    table_lookup at 16 and 64 leaves, 40 lanes each, against the plain
    versions; route_hist also forced onto its rows path."""
    label, name, S, args, kw = _shapes(inputs)[index]
    assert args[1].shape[0] in (LANES, 2 * LANES)
    for path in ((None, "rows") if name == "route_hist" else (None,)):
        got = getattr(TK, name)(*args, **kw, path=path)
        torch.cuda.synchronize()
        want = HP.plain(name, args, kw)
        acc = HP.accuracy(name, got, want, args, kw)
        assert acc["ok"], (label, path, acc)


def test_lane_planner_against_free_memory():
    """plan_lane_chunk on the card: the largest halving of the configs
    whose lanes fit the lane cap and GRID_FUSE_MEMORY_SHARE of the bytes
    free to the allocator, 0 where one config's lanes do not."""
    _need_cuda()
    dev = torch.device("cuda")
    free, _ = torch.cuda.mem_get_info(dev)
    free += torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    budget = TK.GRID_FUSE_MEMORY_SHARE * free
    cap = TK.grid_fuse_lane_cap()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for rows in (10_000_000, 50_000_000, 200_000_000, 10 ** 9):
        got = TK.plan_lane_chunk(64, 33, 5, 16, 6, rows, device=dev)
        want, chunk = 0, 16
        while True:
            lanes = 5 * chunk
            if lanes <= cap and TK.grid_fused_resident_bytes(
                    rows, 64, chunk, 5, 16, 6, 33, n_sm=n_sm) <= budget:
                want = chunk
                break
            if chunk == 1:
                break
            chunk = (chunk + 1) // 2
        assert got == want, (rows, got, want)
        if got:
            assert TK.grid_fused_resident_bytes(
                rows, 64, got, 5, 16, 6, 33, n_sm=n_sm) <= budget
    assert TK.plan_lane_chunk(64, 33, 5, 8, 6, 10_000_000, device=dev) == 8
    assert TK.plan_lane_chunk(64, 33, 5, 8, 6, 10 ** 9, device=dev) == 0


@pytest.mark.parametrize("chunk", [8, 2])
def test_resident_model_covers_measured_peak(chunk):
    """One depth-4 group of 8 configs at 2M rows, 5 folds, through the
    grid-fused path with the planner pinned to `chunk` configs a fit (40
    and 10 lanes): each fit's own peak above its start, and the group's
    above the bytes allocated when the planner was asked, at or below
    their models and within 15% of them (tools/fit_memory.py)."""
    _need_cuda()
    from transmogrifai_tpu_torch.tools import fit_memory as FM
    ctx, y, w, masks, _ = FM.sweep_inputs(2_000_000, seed=3)
    got = FM.measure(ctx, y, w, masks, depth=4, chunk=chunk)
    assert got["lanes"] == 5 * chunk and got["fits"] == 8 // chunk
    assert 1.0 <= got["model_over_fit_peak"] <= 1.15, got
    assert 1.0 <= got["group_model_over_group_peak"] <= 1.15, got


def test_mm_of_bf16_returns_f32():
    """_mm keeps bf16 operands bf16 and returns the f32-accumulated
    product: the 2-D and batched products and the blocked form."""
    _need_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn((300_001, 64), generator=gen, device="cuda").bfloat16()
    b = torch.randn((64, 48), generator=gen, device="cuda")
    for got, want in (
            (G._mm(a, b), a.double() @ b.bfloat16().double()),
            (G._mm(a[None].expand(3, -1, -1).contiguous(),
                   b[None].expand(3, -1, -1).contiguous()),
             (a.double() @ b.bfloat16().double())[None].expand(3, -1, -1)),
            (G._mm(a.T, torch.ones((300_001, 2), device="cuda")),
             a.double().T @ torch.ones((300_001, 2), device="cuda",
                                       dtype=torch.float64))):
        assert got.dtype == torch.float32
        err = (got.double() - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item() + 1e-4, err


def test_small_fused_sweep_against_per_config(monkeypatch):
    """Two depth groups of 4 XGBoost configs at 60 000 rows, 3 folds:
    every cell of the fused sweep (lanes = 12) within 1e-3 of the
    per-config sweep's, the same routes as the CPU's."""
    _need_cuda()
    rng = np.random.default_rng(2)
    X = rng.normal(size=(60_000, 12)).astype(np.float32)
    X[rng.uniform(size=X.shape[0]) < 0.05, 0] = np.nan
    logit = 1.5 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - X[:, 4]
    y = (rng.uniform(size=X.shape[0]) < 1 / (1 + np.exp(-logit))) \
        .astype(np.float32)
    grids = [dict(num_round=4, max_depth=d, eta=e, reg_lambda=lam,
                  max_bins=32) for d in (3, 5) for e in (0.1, 0.3)
             for lam in (1.0, 5.0)]
    cells = {}
    for fuse in ("0", "1"):
        monkeypatch.setenv("TMOG_GRID_FUSE", fuse)
        best = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                               num_folds=3).validate(
            [(OpXGBoostClassifier(), [dict(g) for g in grids])], X, y)
        cells[fuse] = best.validated
    assert {v.route for v in cells["1"]} == {"mask_folds:grid_fused"}
    for a, b in zip(cells["0"], cells["1"]):
        assert a.grid == b.grid
        gaps = np.abs(np.subtract(a.fold_metrics, b.fold_metrics))
        assert gaps.max() <= 1e-3, (a.grid, gaps)
