"""The port's GLM sweep (transmogrifai_tpu_torch/ops/glm_sweep.py, the
streamed and vmapped routes of automl/tuning/validators.py and
automl/tuning/checkpoint.py) against the JAX package on the same seeded
numpy inputs, on the CPU.

Tolerances, and why:
- coefficients within 1e-4: both packages run the same Newton update with
  tol 1e-6 in f32, and their reductions (Gram products, gradients,
  moments, the batched solve) sum in different orders, moving each iterate
  by f32 rounding (~1e-7 here);
- retirement telemetry equal (rounds, data passes, lane passes, active
  lanes and iterations per round, lanes retired and at the cap). A lane
  whose delta lies within 1e-7 of tol may retire a round apart in the two
  packages; only then may the telemetry differ, and the test prints that
  delta;
- fold AuPR within 1e-4 with the exact metric. With the binned metric a
  held-out score within f32 rounding of one of the 4096 bucket edges may
  land in the neighbouring bucket in the other package; such a cell may
  differ by one row's step (2 w / positives of the fold), and the test
  prints the rows on the edge;
- the same winner and the same route labels.
"""
import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.automl.tuning import validators as JV
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JE
from transmogrifai_tpu.models.glm import OpLinearSVC as JSVC
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops import glm_sweep as JGS
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.tuning import checkpoint as PC
from transmogrifai_tpu_torch.automl.tuning import validators as PV
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.models.glm import OpLinearSVC as PSVC
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier as PXGB
from transmogrifai_tpu_torch.ops import glm_sweep as PGS
from transmogrifai_tpu_torch.ops import metrics_ops as PM

TOL = 1e-4          # coefficients: f32 order in a Newton solve, tol 1e-6
METRIC_TOL = 1e-4   # fold AuPR
TEL_KEYS = ("glm_rounds", "data_passes", "lane_passes", "active_per_round",
            "iters_per_round", "lanes_retired", "lanes_at_cap")


def _data(n=1500, d=6, seed=0, shift=True):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    beta = np.linspace(1.5, -1.5, d)
    p = 1 / (1 + np.exp(-(X @ beta * 0.6 + 0.3)))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    if shift:   # so that standardization matters
        X = (X * np.linspace(0.5, 3.0, d) + np.linspace(-2, 2, d)) \
            .astype(np.float32)
    w = rng.uniform(0.3, 1.7, size=n).astype(np.float32)
    return X, y, w


def _masks(n, folds=3, seed=1):
    fold = np.random.default_rng(seed).integers(0, folds, size=n)
    return np.stack([(fold != k).astype(np.float32) for k in range(folds)])


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0, atol=tol)


def _same_telemetry(ji, pi, deltas, tol):
    """Equal retirement telemetry, unless some lane's delta at a round
    boundary lay within 1e-7 of tol in either package (printed)."""
    diff = {k: (ji[k], pi[k]) for k in TEL_KEYS if ji[k] != pi[k]}
    if diff:
        near = sorted({float(v) for dl in deltas for v in dl
                       if abs(float(v) - tol) < 1e-7})
        print(f"telemetry differs {diff}; lane deltas within 1e-7 of tol "
              f"{tol}: {near}")
        assert near, diff


def _rounds_both(X, y, w, masks, regs, alphas, **kw):
    """Both packages' round drivers on the same inputs, with each round
    boundary's lane deltas recorded."""
    deltas = []
    rec = lambda st: deltas.append(st["delta"].copy())   # noqa: E731
    jB, jb0, ji = JGS.sweep_glm_streamed_rounds(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(masks),
        regs, alphas, on_round=rec, **kw)
    pB, pb0, pi = PGS.sweep_glm_streamed_rounds(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(masks), regs, alphas, on_round=rec, **kw)
    return (jB, jb0, ji), (pB, pb0, pi), deltas


REGS = np.array([0.002, 0.03, 0.4], np.float32)
ALPHAS = np.array([0.0, 0.25, 0.5], np.float32)


@pytest.mark.parametrize("warm_start", [True, False])
@pytest.mark.parametrize("round_iters", [1, 3, 40])
def test_round_driver_matches_jax(round_iters, warm_start):
    X, y, w = _data()
    masks = _masks(len(y))
    tol = 1e-6
    (jB, jb0, ji), (pB, pb0, pi), deltas = _rounds_both(
        X, y, w, masks, REGS, ALPHAS, loss="logistic", max_iter=30, tol=tol,
        round_iters=round_iters, warm_start=warm_start)
    assert pB.shape == (3, 3, X.shape[1]) and pb0.shape == (3, 3)
    _close(pB, jB)
    _close(pb0, jb0)
    _same_telemetry(ji, pi, deltas, tol)
    assert pi["kernel"] == "rounds" and pi["warm_start"] == warm_start
    assert pi["bucket_sizes"] == pi["active_per_round"]   # no padded lanes
    assert pi["padded_lane_passes"] == pi["lane_passes"]
    if warm_start:
        assert pi["active_per_round"][0] == masks.shape[0]


@pytest.mark.parametrize("standardize", [True, False])
def test_round_driver_svc_matches_jax(standardize):
    X, y, w = _data(seed=3)
    masks = _masks(len(y), folds=2, seed=4)
    regs = np.array([0.01, 0.2], np.float32)
    (jB, jb0, ji), (pB, pb0, pi), deltas = _rounds_both(
        X, y, w, masks, regs, np.zeros(2, np.float32), loss="squared_hinge",
        max_iter=30, tol=1e-6, standardize=standardize, round_iters=4)
    _close(pB, jB)
    _close(pb0, jb0)
    _same_telemetry(ji, pi, deltas, 1e-6)


def test_max_iter_caps_every_lane():
    X, y, w = _data(n=900, seed=5)
    masks = _masks(len(y), folds=2, seed=5)
    (jB, jb0, ji), (pB, pb0, pi), deltas = _rounds_both(
        X, y, w, masks, np.array([0.01], np.float32),
        np.array([0.0], np.float32), loss="logistic", max_iter=1, tol=1e-9,
        round_iters=5)
    _close(pB, jB)
    _close(pb0, jb0)
    assert pi["data_passes"] == 1 and pi["lanes_at_cap"] == pi["lanes_total"]
    _same_telemetry(ji, pi, deltas, 1e-9)


@pytest.mark.parametrize("standardize", [True, False])
@pytest.mark.parametrize("loss", ["logistic", "squared_hinge"])
def test_legacy_streamed_matches_jax(loss, standardize):
    X, y, w = _data(seed=6)
    masks = _masks(len(y), seed=6)
    jB, jb0 = JGS.sweep_glm_streamed(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(masks),
        jnp.asarray(REGS), jnp.asarray(ALPHAS), loss=loss, max_iter=30,
        standardize=standardize)
    pB, pb0 = PGS.sweep_glm_streamed(
        torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
        torch.from_numpy(masks), REGS, ALPHAS, loss=loss, max_iter=30,
        standardize=standardize)
    _close(pB, np.asarray(jB))
    _close(pb0, np.asarray(jb0))


@pytest.mark.parametrize("driver", ["legacy", "rounds"])
@pytest.mark.parametrize("d", [6, 136])
def test_blocks_not_a_multiple_of_the_row_block(monkeypatch, driver, d):
    """Several scan blocks with a short tail (the row blocks shrunk in
    both packages), at d = 6 (narrow Gram) and d = 136 (the tiled Gram:
    3 tiles of 64, 6 tile pairs, 56 zero-padded columns)."""
    for mod in (JGS, PGS):
        monkeypatch.setattr(mod, "_ROW_BLOCK", 512)
        monkeypatch.setattr(mod, "_ROW_BLOCK_WIDE", 256)
    X, y, w = _data(n=1300, d=d, seed=7)
    masks = _masks(len(y), folds=2, seed=7)
    regs = np.array([0.05, 0.5], np.float32)
    alphas = np.array([0.0, 0.5], np.float32)
    if driver == "legacy":
        jB, jb0 = JGS.sweep_glm_streamed(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
            jnp.asarray(masks), jnp.asarray(regs), jnp.asarray(alphas),
            loss="logistic", max_iter=12)
        pB, pb0 = PGS.sweep_glm_streamed(
            torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
            torch.from_numpy(masks), regs, alphas, loss="logistic",
            max_iter=12)
        jB, jb0 = np.asarray(jB), np.asarray(jb0)
    else:
        (jB, jb0, ji), (pB, pb0, pi), deltas = _rounds_both(
            X, y, w, masks, regs, alphas, loss="logistic", max_iter=12,
            tol=1e-6, round_iters=3)
        _same_telemetry(ji, pi, deltas, 1e-6)
    assert pB.shape == (2, 2, d)
    _close(pB, jB)
    _close(pb0, jb0)


@pytest.mark.parametrize("n_active,d,lanes", [
    (1, 64, 240), (8, 16, 60), (9, 64, 20), (240, 136, 5),
    (17, 2000, 240), (1000, 64, 10000)])
def test_route_geometry_matches_jax(n_active, d, lanes):
    assert PGS.bucket_lanes(n_active) == JGS.bucket_lanes(n_active)
    assert PGS._row_block(d) == JGS._row_block(d)
    assert PGS._tiling(d) == JGS._tiling(d)
    for budget in (1e6, PV.SWEEP_LANE_BUDGET_BYTES):
        assert PGS.streamed_route_ok(d, lanes, budget) == \
            JGS.streamed_route_ok(d, lanes, budget)


@pytest.mark.parametrize("value,on", [("0", False), ("false", False),
                                      (" OFF ", False), ("1", True),
                                      ("yes", True), (None, True)])
def test_env_on_parse(monkeypatch, value, on):
    if value is None:
        monkeypatch.delenv("TMOG_GLM_ROUNDS", raising=False)
    else:
        monkeypatch.setenv("TMOG_GLM_ROUNDS", value)
    assert PGS.env_on("TMOG_GLM_ROUNDS") is on
    assert JGS.env_on("TMOG_GLM_ROUNDS") is on


def test_unported_options_raise():
    X, y, w = (torch.from_numpy(a) for a in _data(n=200))
    m = torch.from_numpy(_masks(200))
    r = np.array([0.1], np.float32)
    with pytest.raises(NotImplementedError, match="mesh"):
        PGS.sweep_glm_streamed_rounds(X, y, w, m, r, r, loss="logistic",
                                      mesh=object())
    with pytest.raises(NotImplementedError, match="warm_seed"):
        PGS.sweep_glm_streamed_rounds(X, y, w, m, r, r, loss="logistic",
                                      warm_seed=(np.zeros(6), 0.0))
    with pytest.raises(TypeError, match="RowSource"):
        PGS.sweep_glm_streamed_rounds(object(), None, None, m, r, r,
                                      loss="logistic")
    # the squared loss is ported (the Gram route's slice): the legacy
    # route fits it as the JAX package's does
    B, b0 = PGS.sweep_glm_streamed(X, y, w, m, r, r, loss="squared")
    jB, jb0 = JGS.sweep_glm_streamed(*(a.numpy() for a in (X, y, w, m)),
                                     r, r, loss="squared")
    np.testing.assert_allclose(B.numpy(), np.asarray(jB), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b0.numpy(), np.asarray(jb0), rtol=1e-4,
                               atol=1e-5)


# -- the validator's GLM routes ------------------------------------------------

LR_GRIDS = [{"reg_param": r, "elastic_net_param": a}
            for r in (0.001, 0.05, 0.3) for a in (0.0, 0.5)]
SVC_GRIDS = [{"reg_param": r} for r in (0.001, 0.05, 0.3)]


def _route(monkeypatch, route, binned):
    for mod in (JV, PV):
        monkeypatch.setattr(mod, "STREAMED_SWEEP_MIN_ROWS",
                            0 if route == "streamed" else 10 ** 12)
        monkeypatch.setattr(mod, "BINNED_RANK_METRIC_MIN_ROWS",
                            0 if binned else 2_000_000)


def _edge_rows(scores, held):
    """Held-out rows whose score lies within 1e-3 of a bucket edge (in
    bucket units): the f32 distance between the packages' scores."""
    u = torch.sigmoid(torch.as_tensor(scores)).numpy() * PV.RANK_METRIC_BINS
    return np.flatnonzero(held & (np.abs(u - np.round(u)) < 1e-3))


def _compare_cells(jbest, pbest, binned, cell_scores, y, w, masks):
    for jv, pv in zip(jbest.validated, pbest.validated):
        assert pv.grid == jv.grid and pv.route == jv.route
        for f, (a, b) in enumerate(zip(jv.fold_metrics, pv.fold_metrics)):
            if abs(a - b) <= METRIC_TOL:
                continue
            assert binned, (pv.grid, f, a, b)
            held = masks[f] == 0
            rows = _edge_rows(cell_scores(pv.grid, f), held)
            step = 2 * w[held].max() / (w * y)[held].sum()
            print(f"cell {pv.grid} fold {f}: |dAuPR| {abs(a - b):.3g}, "
                  f"held-out rows on a bucket edge {rows.tolist()}")
            assert rows.size and abs(a - b) <= step, (pv.grid, f, a, b)


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("route", ["streamed", "vmapped"])
@pytest.mark.parametrize("family", ["logistic", "svc"])
def test_validate_glm_routes_match_jax(monkeypatch, family, route, binned):
    _route(monkeypatch, route, binned)
    X, y, w = _data(n=2400, d=8, seed=11, shift=False)
    if family == "logistic":
        J, P, grids = JLR, PLR, LR_GRIDS
    else:
        J, P, grids = JSVC, PSVC, SVC_GRIDS
    jval = JV.CrossValidation(JE.BinaryClassification.au_pr(), num_folds=3,
                              seed=7)
    jbest = jval.validate([(J(max_iter=20), [dict(g) for g in grids])],
                          X, y, w)
    pval = PV.CrossValidation(PE.BinaryClassification.au_pr(), num_folds=3,
                              seed=7, device="cpu")
    pbest = pval.validate([(P(max_iter=20, device="cpu"),
                            [dict(g) for g in grids])], X, y, w)
    assert pbest.best_grid == jbest.best_grid
    assert {v.route for v in pbest.validated} == {route}
    masks = pval.fold_masks(y)
    np.testing.assert_array_equal(masks, jval.fold_masks(y))
    if route == "streamed":
        ji, pi = jval.last_streamed_telemetry, pval.last_streamed_telemetry
        assert pi["kernel"] == ji["kernel"] == "rounds"
        assert pi["lanes_total"] == ji["lanes_total"] == 3 * len(grids)
        _same_telemetry(ji, pi, [], 1e-6)

    def cell_scores(grid, f):   # the port's held-out scores of one cell
        m = P(max_iter=20, device="cpu").copy(**grid).fit_arrays(
            X, y, masks[f] * w)
        return X @ m.beta + m.intercept
    _compare_cells(jbest, pbest, binned, cell_scores, y, w, masks)


def test_kill_switch_and_knobs_route_like_jax(monkeypatch):
    """TMOG_GLM_ROUNDS=0 takes the legacy global route in both packages;
    TMOG_GLM_ROUND_ITERS and TMOG_GLM_WARMSTART reach the round driver."""
    _route(monkeypatch, "streamed", False)
    X, y, w = _data(n=900, seed=12, shift=False)
    grids = [{"reg_param": 0.01}, {"reg_param": 0.2}]

    def both():
        jv = JV.CrossValidation(JE.BinaryClassification.au_pr(),
                                num_folds=2, seed=2)
        jb = jv.validate([(JLR(max_iter=15), [dict(g) for g in grids])],
                         X, y)
        pv = PV.CrossValidation(PE.BinaryClassification.au_pr(),
                                num_folds=2, seed=2, device="cpu")
        pb = pv.validate([(PLR(max_iter=15, device="cpu"),
                           [dict(g) for g in grids])], X, y)
        assert pb.best_grid == jb.best_grid
        for a, b in zip(jb.validated, pb.validated):
            _close(b.fold_metrics, a.fold_metrics, METRIC_TOL)
        return jv.last_streamed_telemetry, pv.last_streamed_telemetry

    monkeypatch.setenv("TMOG_GLM_ROUNDS", "0")
    ji, pi = both()
    assert ji["kernel"] == pi["kernel"] == "global"
    monkeypatch.setenv("TMOG_GLM_ROUNDS", "1")
    monkeypatch.setenv("TMOG_GLM_ROUND_ITERS", "2")
    monkeypatch.setenv("TMOG_GLM_WARMSTART", "off")
    ji, pi = both()
    assert pi["kernel"] == "rounds" and not pi["warm_start"]
    assert max(pi["iters_per_round"]) <= 2
    _same_telemetry(ji, pi, [], 1e-6)


def test_joint_lr_and_xgb_sweep_picks_the_same_winner(monkeypatch):
    """One validate over a logistic-regression grid (streamed route) and
    an XGBoost grid (mask-fold route), as the BASELINE sweep runs them.
    The JAX trees fit per fold on the CPU, the port's fold-fused, so
    their cells agree to 5e-3 (tests/test_torch_slice.py)."""
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")
    _route(monkeypatch, "streamed", False)
    X, y, w = _data(n=1500, d=6, seed=13, shift=False)
    lr = [{"reg_param": 0.001}, {"reg_param": 0.3, "elastic_net_param": 0.5}]
    xgb = [dict(num_round=4, max_depth=2, eta=0.1, max_bins=32)]
    jbest = JV.CrossValidation(JE.BinaryClassification.au_pr(), num_folds=3,
                               seed=5).validate(
        [(JLR(max_iter=20), [dict(g) for g in lr]),
         (JXGB(), [dict(g) for g in xgb])], X, y)
    pbest = PV.CrossValidation(PE.BinaryClassification.au_pr(), num_folds=3,
                               seed=5, device="cpu").validate(
        [(PLR(max_iter=20, device="cpu"), [dict(g) for g in lr]),
         (PXGB(device="cpu"), [dict(g) for g in xgb])], X, y)
    assert pbest.name == jbest.name and pbest.best_grid == jbest.best_grid
    assert [v.route for v in pbest.validated] == \
        ["streamed", "streamed", "mask_folds"]
    for jv, pv in zip(jbest.validated, pbest.validated):
        tol = METRIC_TOL if pv.route == "streamed" else 5e-3
        assert abs(pv.mean_metric - jv.mean_metric) <= tol
    model = pbest.estimator.fit_arrays(X, y)
    _, _, prob = model.predict_arrays(X)
    assert prob.shape == (len(y), 2) and np.isfinite(prob).all()


def test_unported_problem_types_raise():
    X, y, _ = _data(n=300, seed=14)
    val = PV.CrossValidation(PE.BinaryClassification.au_pr(), device="cpu")
    with pytest.raises(ValueError, match="unknown problem type"):
        val.validate([(PLR(device="cpu"), [{}])], X, y,
                     problem_type="ranking")
    # every binary, multiclass and regression metric is ported; a metric
    # of another problem type is not an in-sweep metric
    assert callable(PV._metric_fn("multiclass", "error", n_classes=3))
    with pytest.raises(ValueError, match="no in-sweep multiclass metric"):
        PV._metric_fn("multiclass", "au_pr")


# -- checkpoints -----------------------------------------------------------------

def test_sweep_checkpoint_resume_skips_finished_cells(monkeypatch, tmp_path):
    _route(monkeypatch, "vmapped", False)
    X, y, w = _data(n=800, seed=15, shift=False)
    grids = [{"reg_param": r} for r in (0.001, 0.05, 0.3)]
    path = str(tmp_path / "sweep.jsonl")

    def run():
        val = PV.CrossValidation(PE.BinaryClassification.au_pr(),
                                 num_folds=2, seed=3, device="cpu")
        val.checkpoint_path = path
        return val.validate([(PLR(max_iter=20, device="cpu"),
                              [dict(g) for g in grids])], X, y)

    first = run()
    assert len(PC.SweepCheckpoint(path)) == 3
    fits = []
    orig = PLR.batched_fit_fn

    def counting(self, *a, **k):
        fit_one, axes = orig(self, *a, **k)
        return (lambda *fa, **fk: fits.append(1) or fit_one(*fa, **fk)), axes
    monkeypatch.setattr(PLR, "batched_fit_fn", counting)
    second = run()
    assert fits == []                  # every cell replayed, none refit
    assert second.best_grid == first.best_grid
    for a, b in zip(first.validated, second.validated):
        assert a.fold_metrics == b.fold_metrics


def test_round_checkpoint_resume_is_bit_identical():
    X, y, w = _data(n=1200, seed=16)
    masks = _masks(len(y), folds=2, seed=16)
    regs = np.array([0.005, 0.08, 0.4], np.float32)
    kw = dict(loss="logistic", max_iter=30, tol=1e-6, round_iters=2,
              warm_start=True)
    args = [torch.from_numpy(a) for a in (X, y, w, masks)]
    snaps = []
    B_full, b0_full, info_full = PGS.sweep_glm_streamed_rounds(
        *args, regs, np.zeros(3, np.float32),
        on_round=lambda st: snaps.append(copy.deepcopy(st)), **kw)
    assert len(snaps) == info_full["glm_rounds"] >= 3
    B_res, b0_res, info_res = PGS.sweep_glm_streamed_rounds(
        *args, regs, np.zeros(3, np.float32), state=copy.deepcopy(snaps[1]),
        **kw)
    assert np.array_equal(B_full, B_res)
    assert np.array_equal(b0_full, b0_res)
    assert {k: info_res[k] for k in TEL_KEYS} == \
        {k: info_full[k] for k in TEL_KEYS}


def test_round_checkpoint_file_roundtrip(tmp_path):
    rc = PC.RoundCheckpoint(str(tmp_path / "sweep.jsonl.glm_rounds.npz"))
    st = PGS._new_round_state(6, 4)
    st["B"][:] = 1.5
    st["rounds"] = 2
    st["active_per_round"] = [6, 3]
    st["warmed"] = True
    rc.save("k1", st)
    assert rc.load("other-key") is None
    got = rc.load("k1")
    assert np.array_equal(got["B"], st["B"])
    assert got["rounds"] == 2 and got["warmed"] is True
    assert got["active_per_round"] == [6, 3]
    rc.clear()
    assert rc.load("k1") is None


def test_validator_round_checkpoint_resume(monkeypatch, tmp_path):
    """A streamed sweep killed mid-rounds resumes at the last retirement
    boundary and lands on the clean run's fold metrics."""
    _route(monkeypatch, "streamed", False)
    X, y, w = _data(n=1400, seed=17, shift=False)
    grids = [{"reg_param": 0.002}, {"reg_param": 0.05}, {"reg_param": 0.4}]

    class _Boom(RuntimeError):
        pass

    orig = PGS.sweep_glm_streamed_rounds
    seen = []

    def dying(*a, **k):
        inner = k["on_round"]

        def bomb(st):
            inner(st)
            seen.append(copy.deepcopy(st))
            if st["rounds"] >= 2:
                raise _Boom()
        k["on_round"] = bomb
        return orig(*a, **k)

    def val():
        v = PV.CrossValidation(PE.BinaryClassification.au_pr(), num_folds=2,
                               seed=5, device="cpu")
        v.checkpoint_path = str(tmp_path / "ck.jsonl")
        return v

    monkeypatch.setattr(PGS, "sweep_glm_streamed_rounds", dying)
    with pytest.raises(_Boom):
        val().validate([(PLR(max_iter=30, device="cpu"),
                         [dict(g) for g in grids])], X, y)
    resumed = []

    def resuming(*a, **k):
        resumed.append(copy.deepcopy(k.get("state")))
        return orig(*a, **k)

    monkeypatch.setattr(PGS, "sweep_glm_streamed_rounds", resuming)
    b2 = val().validate([(PLR(max_iter=30, device="cpu"),
                          [dict(g) for g in grids])], X, y)
    assert resumed[0] is not None
    assert resumed[0]["rounds"] == seen[-1]["rounds"]
    clean = PV.CrossValidation(PE.BinaryClassification.au_pr(), num_folds=2,
                               seed=5, device="cpu")
    b3 = clean.validate([(PLR(max_iter=30, device="cpu"),
                          [dict(g) for g in grids])], X, y)
    assert b2.best_grid == b3.best_grid
    for a, b in zip(b2.validated, b3.validated):
        assert a.fold_metrics == b.fold_metrics


def test_data_fingerprint_of_tensors_and_arrays():
    X, y, _ = _data(n=3000, seed=18)
    fp = PC.data_fingerprint(X, y)
    assert fp == PC.data_fingerprint(torch.from_numpy(X), torch.from_numpy(y))
    X2 = X.copy()
    X2[0, 0] += 1.0
    assert PC.data_fingerprint(X2, y) != fp


def test_streamed_eval_matches_per_lane_metric():
    """The streamed route's chunk metric (one lane-batched call) against
    the one-lane metric of each lane, exact and binned."""
    X, y, w = (torch.from_numpy(a) for a in _data(n=600, seed=19,
                                                  shift=False))
    rng = np.random.default_rng(19)
    B = torch.from_numpy(rng.normal(size=(5, X.shape[1])).astype(np.float32))
    b0 = torch.from_numpy(rng.normal(size=5).astype(np.float32))
    for bins in (None, 64):
        got = PV._streamed_eval(X, y, w, B, b0, 0.0, metric="au_pr",
                                problem_type="binary", rank_bins=bins)
        mfn = PV._metric_fn("binary", "au_pr", rank_bins=bins)
        want = torch.stack([mfn(X @ B[j] + b0[j], y, w, 0.0)
                            for j in range(5)])
        _close(got, want, 1e-6)
    exact = PM.au_pr(X @ B[0] + b0[0], y, w)
    _close(PV._metric_fn("binary", "au_pr")(X @ B[0] + b0[0], y, w, 0.0),
           exact, 0.0)
