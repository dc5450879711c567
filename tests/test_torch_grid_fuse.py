"""The config-fused tree sweep in the port (transmogrifai_tpu_torch): per-lane
split and leaf scalars in ops/trees.fit_gbt_folds, the lane planner
ops/tree_kernels.plan_lane_chunk, the estimators' grid_fuse_signature and
mask_fit_scores_grid, and the validator's TMOG_GRID_FUSE route, against the
JAX package on the same seeded numpy inputs, on the CPU.

Tolerances, and why:
- fit_gbt_folds with [lanes] scalars against the JAX package's two
  histogram paths (f32 histogram inputs), as tests/test_torch_trees.py
  holds the one-scalar fit: against its jnp twins, whose segment sums the
  port mirrors, split decisions identical and leaves and margins within
  1e-5; against its interpret-mode Pallas kernels, which sum in another
  order, margins within 5e-5 on every lane whose trees agree, and a split
  decision may differ only where the JAX package's two paths differ from
  each other (a candidate on a validity edge: min_child_weight, gamma);
  base scores within 2.4e-7 relative;
- the fused lanes against each config's own fold-fused fit on the port's
  CPU path: bit for bit (a lane's histograms, sums and split algebra read
  only its own rows and scalars, in the same order);
- a fused validate against a per-config one in the port: identical cells
  and winner; against the JAX package's per-config validate: the same
  winner and every cell within 5e-3, as the mask-fold route is held in
  tests/test_torch_glm_sweep.py (the JAX trees fit fold by fold).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transmogrifai_tpu.automl.tuning import validators as JV
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JE
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.ops import pallas_hist as PH
from transmogrifai_tpu.ops import trees as JT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.tuning import validators as PV
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PE
from transmogrifai_tpu_torch.models import trees as PM
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.ops import trees as PT

# the configs of the reference's own lane test
# (tests/test_fold_fused_trees.py::test_config_fused_lanes_match_per_config_calls)
CONFIGS = [
    dict(learning_rate=0.1, reg_lambda=1.0, min_child_weight=0.0,
         gamma=0.0),
    dict(learning_rate=0.3, reg_lambda=5.0, min_child_weight=2.0,
         gamma=0.1),
    dict(learning_rate=0.05, reg_lambda=0.5, min_child_weight=1.0,
         gamma=0.0),
]


@pytest.fixture
def f32_hist():
    prev = PH._HIST_BF16
    PH.set_hist_bf16(False)
    try:
        yield
    finally:
        PH.set_hist_bf16(prev)


def _fit_inputs(n=640, f=5, n_bins=16, folds=2, seed=3, squared=False):
    """Binned features with missing values and ties, labels, fold weights."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[rng.uniform(size=n) < 0.15, 0] = np.nan
    X[:, 3] = rng.integers(0, 4, size=n)
    logit = 2.0 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - 0.5 * X[:, 3]
    y = (logit + rng.normal(size=n)).astype(np.float32) if squared else \
        (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    W = (rng.integers(0, folds, size=n)[None, :]
         != np.arange(folds)[:, None]).astype(np.float32)
    edges = np.asarray(JT.quantile_edges(jnp.asarray(X), n_bins))
    Xb = np.array(JT.bin_matrix(jnp.asarray(X), jnp.asarray(edges)))
    return Xb, y, W


def _lanes(W):
    """Config-major lanes (as the reference's test lays them out): lane =
    config x folds + fold, and each scalar repeated over the folds."""
    F = W.shape[0]
    W_l = np.concatenate([W for _ in CONFIGS], axis=0)
    lane = {k: np.repeat(np.asarray([c[k] for c in CONFIGS], np.float32), F)
            for k in CONFIGS[0]}
    return W_l, lane


@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_lane_scalars_match_jax(f32_hist, loss):
    Xb, y, W = _fit_inputs(squared=loss == "squared")
    W_l, lane = _lanes(W)
    kw = dict(n_rounds=3, depth=3, n_bins=16, loss=loss)
    ref = {interpret: JT.fit_gbt_folds(
        jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(W_l),
        jax.random.PRNGKey(0), interpret=interpret, **kw,
        **{k: jnp.asarray(v) for k, v in lane.items()})
        for interpret in (False, True)}
    tp, bp, mp = PT.fit_gbt_folds(
        torch.from_numpy(Xb), torch.from_numpy(y), torch.from_numpy(W_l),
        **kw, **{k: torch.from_numpy(v) for k, v in lane.items()})
    fields = ("feat", "thresh", "miss")
    tw, bw, mw = ref[False]
    for field in fields:
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(tw, field)))
    np.testing.assert_allclose(tp.leaf.numpy(), np.asarray(tw.leaf),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(mp.numpy(), np.asarray(mw), rtol=0, atol=1e-5)
    ti, bi, mi = ref[True]
    same = np.ones(W_l.shape[0], bool)
    for field in fields:
        port = getattr(tp, field).numpy() != np.asarray(getattr(ti, field))
        twins = np.asarray(getattr(tw, field)) != \
            np.asarray(getattr(ti, field))
        if port.any():
            print(f"{field}: the port and the interpret-mode kernels part at "
                  f"(round, lane, node) {np.argwhere(port).tolist()}; the "
                  f"JAX twins part from them at "
                  f"{np.argwhere(twins).tolist()}")
        np.testing.assert_array_equal(port, twins)
        same &= ~port.any(axis=(0, 2))
    np.testing.assert_allclose(mp.numpy()[same], np.asarray(mi)[same],
                               rtol=0, atol=5e-5)
    for bj in (bw, bi):
        np.testing.assert_allclose(bp.numpy(), np.asarray(bj), atol=0,
                                   rtol=2.4e-7)
    # the lanes differ: each config's scalars reached its own lanes
    F = W.shape[0]
    assert not torch.equal(mp[:F], mp[F:2 * F])


@pytest.mark.parametrize("loss", ["logistic", "squared"])
def test_fused_lanes_equal_each_configs_own_fit(loss):
    """Bit for bit, as the reference asserts for its lanes."""
    Xb, y, W = _fit_inputs(squared=loss == "squared", seed=5)
    W_l, lane = _lanes(W)
    F = W.shape[0]
    kw = dict(n_rounds=3, depth=3, n_bins=16, loss=loss)
    Xt, yt = torch.from_numpy(Xb), torch.from_numpy(y)
    tl, bl, ml = PT.fit_gbt_folds(
        Xt, yt, torch.from_numpy(W_l), **kw,
        **{k: torch.from_numpy(v) for k, v in lane.items()})
    for ci, c in enumerate(CONFIGS):
        t1, b1, m1 = PT.fit_gbt_folds(Xt, yt, torch.from_numpy(W), **kw, **c)
        sl = slice(ci * F, (ci + 1) * F)
        assert torch.equal(bl[sl], b1), ci
        assert torch.equal(ml[sl], m1), ci
        for a, b in zip(tl, t1):
            assert torch.equal(a[:, sl], b), ci


def test_float_scalars_keep_the_one_scalar_fit():
    """A float for every lane and a tensor holding that float for each
    lane give the same fit, bit for bit; a lane tensor of the wrong length
    raises."""
    Xb, y, W = _fit_inputs(seed=7)
    kw = dict(n_rounds=2, depth=3, n_bins=16)
    Xt, yt, Wt = (torch.from_numpy(a) for a in (Xb, y, W))
    _, b1, m1 = PT.fit_gbt_folds(Xt, yt, Wt, **kw, **CONFIGS[1])
    _, b2, m2 = PT.fit_gbt_folds(
        Xt, yt, Wt, **kw,
        **{k: torch.full((2,), v) for k, v in CONFIGS[1].items()})
    assert torch.equal(b1, b2) and torch.equal(m1, m2)
    with pytest.raises(ValueError, match="lane tensor"):
        PT.fit_gbt_folds(Xt, yt, Wt, learning_rate=torch.ones(3), **kw)


def test_grid_fuse_signature_groups_correctly():
    """The reference's test_grid_fuse_signature_groups_correctly, and the
    families that do not fuse."""
    est = PM.OpXGBoostClassifier(num_round=5, max_depth=3, max_bins=16)
    s1 = est.grid_fuse_signature({"eta": 0.1, "reg_lambda": 1.0})
    s2 = est.grid_fuse_signature({"eta": 0.3, "reg_lambda": 5.0})
    s3 = est.grid_fuse_signature({"eta": 0.1, "max_depth": 4})
    s4 = est.grid_fuse_signature({"min_child_weight": 3.0, "gamma": 0.2,
                                  "scale_pos_weight": 2.0})
    s5 = est.grid_fuse_signature({"seed": 7})
    assert s1 == s2 == s4      # algebra scalars and spw fuse
    assert s1 != s3            # structure (depth) splits
    assert s1 != s5            # a swept seed splits (shared draws)
    gbt = PM.OpGBTClassifier(max_iter=3, max_depth=3, max_bins=16)
    g1 = gbt.grid_fuse_signature({"step_size": 0.1})
    g2 = gbt.grid_fuse_signature({"step_size": 0.2})
    g3 = gbt.grid_fuse_signature({"subsampling_rate": 0.8})
    assert g1 == g2
    assert g1 != g3            # subsample draw must match to share a key
    # the same signatures as the reference's estimators
    jest = JXGB(num_round=5, max_depth=3, max_bins=16)
    assert s1 == jest.grid_fuse_signature({"eta": 0.1, "reg_lambda": 1.0})
    assert s3 == jest.grid_fuse_signature({"eta": 0.1, "max_depth": 4})
    assert PM.OpRandomForestClassifier().grid_fuse_signature({}) is None
    assert PM.OpGBTRegressor().grid_fuse_signature({}) != \
        PM.OpGBTClassifier().grid_fuse_signature({})   # the loss splits


class TestPlanner:
    """plan_lane_chunk's halving, its 0 contract and its lane cap (the
    reference's tests/test_hist_batched.py::TestPlanner, without its v5e
    VMEM and out-block checks, which the port has no counterpart of)."""

    def test_respects_the_lane_cap(self, monkeypatch):
        monkeypatch.setenv("TMOG_GRID_FUSE_HBM_LANES", "20")
        # 16 configs x 5 folds = 80 lanes > 20: halve to 4 x 5 = 20
        assert TK.plan_lane_chunk(8, 9, 5, 16, 3, 1000) == 4

    def test_default_cap_takes_the_sweep_groups_whole(self, monkeypatch):
        monkeypatch.delenv("TMOG_GRID_FUSE_HBM_LANES", raising=False)
        assert TK.grid_fuse_lane_cap() == TK.GRID_FUSE_LANES == 64
        # the BASELINE grid's two groups of 8 configs: 40 lanes each
        assert TK.plan_lane_chunk(64, 33, 5, 8, 6, 10_000_000) == 8
        # all 16 at once would be 80 lanes: halved to 8
        assert TK.plan_lane_chunk(64, 33, 5, 16, 6, 10_000_000) == 8
        # halving rounds up: 13 configs -> 7 -> 4 (35 lanes, then 20)
        monkeypatch.setenv("TMOG_GRID_FUSE_HBM_LANES", "35")
        assert TK.plan_lane_chunk(64, 33, 5, 13, 6, 1000) == 7

    def test_zero_when_one_configs_lanes_bust_the_cap(self, monkeypatch):
        monkeypatch.setenv("TMOG_GRID_FUSE_HBM_LANES", "3")
        assert TK.plan_lane_chunk(8, 9, 5, 16, 3, 1000) == 0
        assert TK.plan_lane_chunk(8, 9, 5, 1, 3, 1000) == 0

    def test_cpu_is_capped_by_lanes_alone(self, monkeypatch):
        monkeypatch.setenv("TMOG_GRID_FUSE_HBM_LANES", "100000")
        # a shape no card holds: the CPU plans it all the same
        assert TK.plan_lane_chunk(64, 33, 5, 1000, 6, 10 ** 9,
                                  device="cpu") == 1000

    def test_resident_bytes(self):
        """fused_fit_resident_bytes: the binned copy, then linear in the
        lanes; the sorted workspace is 24 B a row and lane of it."""
        one = TK.fused_fit_resident_bytes(10 ** 6, 64, 1, 6, 33)
        two = TK.fused_fit_resident_bytes(10 ** 6, 64, 2, 6, 33)
        xb = 64 * 10 ** 6
        assert two - one == one - xb
        assert one - xb >= (9 + 6) * 4 * 10 ** 6


def _validate_data(n=1200, seed=21):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 0] = np.nan
    logit = 1.5 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - X[:, 4]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


XGB_GRID = [dict(num_round=3, max_depth=d, eta=e, reg_lambda=lam,
                 max_bins=16)
            for d in (2, 3) for e in (0.1, 0.3) for lam in (1.0, 5.0)]


def _port_validate(models, X, y, fuse, monkeypatch):
    if fuse:
        monkeypatch.setenv("TMOG_GRID_FUSE", "1")
    else:
        monkeypatch.delenv("TMOG_GRID_FUSE", raising=False)
    return PV.CrossValidation(PE.BinaryClassification.au_pr(), num_folds=3,
                              seed=5, device="cpu").validate(models, X, y)


def test_fused_validate_equals_per_config_and_jax(monkeypatch):
    """The XGBoost grid (two depth groups of 4) with spw and min child
    weight varied, and a Spark GBT grid: fused cells equal the per-config
    route's and sit within 5e-3 of the JAX package's per-config sweep."""
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")
    X, y = _validate_data()
    xgb = [dict(g, scale_pos_weight=s, min_child_weight=m)
           for g, (s, m) in zip(XGB_GRID, [(1.0, 0.0), (2.0, 1.0)] * 4)]
    gbt = [dict(max_iter=3, max_depth=2, step_size=s) for s in (0.1, 0.3)]

    def models(M, dev):
        kw = {} if dev is None else dict(device=dev)
        return [(M.OpXGBoostClassifier(**kw), [dict(g) for g in xgb]),
                (M.OpGBTClassifier(**kw), [dict(g) for g in gbt])]
    per = _port_validate(models(PM, "cpu"), X, y, False, monkeypatch)
    fused = _port_validate(models(PM, "cpu"), X, y, True, monkeypatch)
    assert [v.route for v in per.validated] == ["mask_folds"] * 10
    assert [v.route for v in fused.validated] == \
        ["mask_folds:grid_fused"] * 10
    assert fused.best_grid == per.best_grid and fused.name == per.name
    for a, b in zip(fused.validated, per.validated):
        assert a.grid == b.grid and a.fold_metrics == b.fold_metrics
    from transmogrifai_tpu.models import trees as JM
    jbest = JV.CrossValidation(JE.BinaryClassification.au_pr(), num_folds=3,
                               seed=5).validate(models(JM, None), X, y)
    assert jbest.name == fused.name and jbest.best_grid == fused.best_grid
    for a, b in zip(fused.validated, jbest.validated):
        assert a.grid == b.grid
        assert abs(a.mean_metric - b.mean_metric) < 5e-3, (a, b)


def test_groups_that_do_not_fuse_fit_per_config(monkeypatch):
    """Groups of one, forests and a swept seed take the per-config route
    under TMOG_GRID_FUSE; so does a planner answer of 0."""
    X, y = _validate_data(n=600, seed=4)
    xgb = [dict(num_round=2, max_depth=2, max_bins=8, eta=0.1),
           dict(num_round=2, max_depth=3, max_bins=8, eta=0.1),
           dict(num_round=2, max_depth=2, max_bins=8, eta=0.1, seed=9)]
    rf = [dict(num_trees=2, max_depth=2, max_bins=8, min_info_gain=g)
          for g in (0.0, 0.01)]
    best = _port_validate([(PM.OpXGBoostClassifier(device="cpu"), xgb),
                           (PM.OpRandomForestClassifier(device="cpu"), rf)],
                          X, y, True, monkeypatch)
    assert {v.route for v in best.validated} == {"mask_folds"}
    monkeypatch.setenv("TMOG_GRID_FUSE_HBM_LANES", "2")      # < 3 folds
    best = _port_validate([(PM.OpXGBoostClassifier(device="cpu"),
                            [dict(g) for g in XGB_GRID[:2]])], X, y, True,
                          monkeypatch)
    assert {v.route for v in best.validated} == {"mask_folds"}


@pytest.mark.parametrize("value,on", [("1", True), ("true", True),
                                      ("ON", True), ("yes", False),
                                      ("0", False), ("", False)])
def test_grid_fuse_parse(monkeypatch, value, on):
    """The reference's opt-in parse: only 1 / true / on turn fusion on."""
    monkeypatch.setenv("TMOG_GRID_FUSE", value)
    assert PV.grid_fuse_enabled() is on


def test_a_failing_fused_fit_raises_out_of_validate(monkeypatch):
    """No quiet per-config fallback: the fused fit's error is the
    validate()'s."""
    X, y = _validate_data(n=600, seed=6)

    def broken(*a, **k):
        raise RuntimeError("fused kernel launch failed")
    monkeypatch.setattr(PM._TreeEstimator, "mask_fit_scores_grid", broken)
    with pytest.raises(RuntimeError, match="fused kernel launch failed"):
        _port_validate([(PM.OpXGBoostClassifier(device="cpu"),
                         [dict(g) for g in XGB_GRID[:2]])], X, y, True,
                       monkeypatch)
