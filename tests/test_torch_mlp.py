"""The port's MLP classifier and isotonic calibrator (models/mlp.py) against
the JAX package's, on the CPU.

The same seeded numpy inputs go through both packages; the port's MLP
starts from the JAX package's initial weights
(`transmogrifai_tpu.models.mlp._init_params(PRNGKey(seed), sizes)`, fed in
through `fit_arrays(init=...)`, or through `init_params` in a selector).
Tolerances: weights and biases within 5e-4 and probabilities within 1e-3
after up to 200 Adam steps (float32 rounding of the two frameworks'
products accumulates over the steps: measured 2.2e-5 / 2.3e-6 at 200 steps
on 3 000 x 12, K = 3), the predicted classes identical wherever the port's
two largest probabilities are more than 1e-3 apart; a fitted model scores
within 1e-6 of the reference's; selector cells within 5e-3 with the same
winner; `pav_fit`, the calibrator and its transform exact (float64 both).
"""
import numpy as np
import pytest
import torch

import jax

from transmogrifai_tpu.automl.selectors import \
    MultiClassificationModelSelector as JMCMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.data.dataset import Column as JColumn
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models import mlp as JM
from transmogrifai_tpu import types as JT
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.io import load_model as j_load

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl import selectors as PS
from transmogrifai_tpu_torch.automl.selectors import \
    MultiClassificationModelSelector as PMCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.data.dataset import Column as PColumn
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models import mlp as PM
from transmogrifai_tpu_torch import dsl as PD
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM

W_TOL, P_TOL = 5e-4, 1e-3


def _ref_init(sizes, seed=42):
    return [(np.asarray(w), np.asarray(b)) for w, b in
            JM._init_params(jax.random.PRNGKey(seed), tuple(sizes))]


def _data(n=1000, d=8, K=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    score = X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2] + 0.4 * rng.normal(size=n)
    y = np.digitize(score, np.quantile(score, np.arange(1, K) / K))
    return X, y.astype(np.float32), rng.uniform(0.5, 1.5, n).astype(np.float32)


def _assert_classes(jp, pp):
    top2 = np.sort(pp[2], axis=1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > P_TOL
    assert np.array_equal(jp[0][clear], pp[0][clear])


@pytest.mark.parametrize("K,steps,weighted",
                         [(2, 5, False), (2, 200, True), (3, 5, True),
                          (3, 50, False), (3, 200, True)])
def test_fit_arrays_matches_jax(K, steps, weighted):
    X, y, w = _data(K=K, seed=K + steps)
    w = w if weighted else None
    est = dict(hidden_layers=[10, 10], max_iter=steps, step_size=0.05,
               reg_param=1e-3)
    jm = JM.OpMultilayerPerceptronClassifier(**est).fit_arrays(X, y, w)
    pm = PM.OpMultilayerPerceptronClassifier(device="cpu", **est) \
        .fit_arrays(X, y, w, init=_ref_init([8, 10, 10, K]))
    assert [a.shape for a in pm.weights] == [a.shape for a in jm.weights]
    for a, b in zip(jm.weights + jm.biases, pm.weights + pm.biases):
        np.testing.assert_allclose(b, a, atol=W_TOL, rtol=0)
    jp, pp = jm.predict_arrays(X), pm.predict_arrays(X)
    assert pp[2].shape == (len(y), K)
    np.testing.assert_allclose(pp[2], jp[2], atol=P_TOL, rtol=0)
    _assert_classes(jp, pp)


def test_predict_arrays_matches_jax():
    X, y, _ = _data(K=4, seed=3)
    layers = _ref_init([8, 6, 5, 4], seed=7)
    jm = JM.MLPModel([w for w, _ in layers],
                     [b + 0.1 * i for i, (_, b) in enumerate(layers)])
    pm = PM.MLPModel(jm.weights, jm.biases, device="cpu")
    jp, pp = jm.predict_arrays(X), pm.predict_arrays(X)
    np.testing.assert_allclose(pp[1], jp[1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(pp[2], jp[2], atol=1e-6, rtol=0)
    assert np.array_equal(pp[0], jp[0])
    assert pp[0].dtype == np.float32


def test_default_init_is_he_normal_and_device_independent():
    layers = PM.init_params([50, 40, 3], seed=11)
    again = PM.init_params([50, 40, 3], seed=11)
    for (w, b), (w2, b2) in zip(layers, again):
        assert np.array_equal(w, w2) and not b.any()
    assert abs(layers[0][0].std() - np.sqrt(2 / 50)) < 0.02
    assert abs(layers[1][0].std() - np.sqrt(2 / 40)) < 0.05
    assert not np.array_equal(layers[0][0],
                              PM.init_params([50, 40, 3], 12)[0][0])


def test_solves_xor():
    """The reference's gate (tests/test_mlp_isotonic.py) on the port's own
    draws."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, size=(1500, 2)).astype(np.float32)
    y = ((X[:, 0] > 0) ^ (X[:, 1] > 0)).astype(np.float32)
    model = PM.OpMultilayerPerceptronClassifier(
        hidden_layers=[16, 16], max_iter=600, step_size=0.05,
        device="cpu").fit_arrays(X, y)
    pred, raw, prob = model.predict_arrays(X)
    assert (pred == y).mean() > 0.95
    assert prob.shape == (1500, 2) and raw.shape == (1500, 2)
    assert np.allclose(prob.sum(axis=1), 1.0, atol=1e-5)


def test_multiclass_gate():
    rng = np.random.default_rng(1)
    centers = rng.normal(scale=4, size=(3, 4))
    y = rng.integers(0, 3, 900)
    X = (centers[y] + rng.normal(size=(900, 4))).astype(np.float32)
    model = PM.OpMultilayerPerceptronClassifier(
        hidden_layers=[12], max_iter=400, device="cpu") \
        .fit_arrays(X, y.astype(np.float32))
    pred, _, prob = model.predict_arrays(X)
    assert prob.shape[1] == 3
    assert (pred == y).mean() > 0.9


def test_models_carry_across_both_ways():
    X, y, _ = _data(K=3, seed=5)
    jm = JM.OpMultilayerPerceptronClassifier(
        hidden_layers=[6], max_iter=30).fit_arrays(X, y)
    pm = convert.mlp_model_from_jax(jm.save_args(), device="cpu")
    np.testing.assert_allclose(pm.predict_arrays(X)[2],
                               jm.predict_arrays(X)[2], atol=1e-6, rtol=0)
    back = JM.MLPModel.from_save_args(pm.save_args())
    np.testing.assert_allclose(back.predict_arrays(X)[2],
                               pm.predict_arrays(X)[2], atol=1e-6, rtol=0)
    again = PM.MLPModel.from_save_args(pm.save_args())
    again.device = "cpu"
    assert np.array_equal(again.predict_arrays(X)[2],
                          pm.predict_arrays(X)[2])
    b, v = PM.pav_fit(X[:, 0].astype(np.float64), y.astype(np.float64))
    ji = JM.IsotonicRegressionModel(boundaries=b, values=v,
                                    increasing=False)
    pi = convert.isotonic_model_from_jax(ji.save_args(), device="cpu")
    q = np.linspace(-3, 3, 101)
    assert np.array_equal(pi.apply(q), ji._apply(q))
    assert not pi.increasing


def test_mlp_resolves_in_the_selectors():
    for sel_cls, kind in ((PS.BinaryClassificationModelSelector, "binary"),
                          (PS.MultiClassificationModelSelector,
                           "multiclass")):
        sel = sel_cls.with_cross_validation(
            model_types=["OpLogisticRegression",
                         "OpMultilayerPerceptronClassifier"], seed=9,
            device="cpu")
        est, grid = sel.models[1]
        assert type(est).__name__ == "OpMultilayerPerceptronClassifier"
        assert grid == [dict()] and est.get_param("seed") == 9
        assert kind in est.problem_types
    with pytest.raises(ValueError, match="regression"):
        PS.RegressionModelSelector.with_cross_validation(
            model_types=["OpMultilayerPerceptronClassifier"])


def test_pav_fit_exact():
    rng = np.random.default_rng(4)
    x = np.round(rng.uniform(size=4000), 2)       # many ties in x
    y = (rng.uniform(size=4000) < x ** 2).astype(np.float64)
    w = rng.uniform(0.1, 2.0, 4000)
    for args in ((x, y), (x, y, w), (-x, y)):
        jb, jv = JM.pav_fit(*args)
        pb, pv = PM.pav_fit(*args)
        assert np.array_equal(jb, pb) and np.array_equal(jv, pv)
        assert (np.diff(pv) >= 0).all()


@pytest.mark.parametrize("isotonic", [True, False])
def test_calibrator_matches_jax(isotonic):
    rng = np.random.default_rng(3 + isotonic)
    n = 2000
    score = rng.uniform(size=n)
    score[rng.uniform(size=n) < 0.02] = np.nan
    p = np.clip(np.nan_to_num(score) ** 2, 0, 1)
    if not isotonic:
        p = 1.0 - p
    label = (rng.uniform(size=n) < p).astype(float)
    jm = JM.IsotonicRegressionCalibrator(isotonic=isotonic).fit_columns(
        JColumn("float", label), JColumn("float", score))
    pm = PM.IsotonicRegressionCalibrator(isotonic=isotonic, device="cpu") \
        .fit_columns(PColumn("float", label), PColumn("float", score))
    assert np.array_equal(pm.boundaries, jm.boundaries)
    assert np.array_equal(pm.values, jm.values)
    q = np.concatenate([score, [np.nan, np.inf, -np.inf, -1.0, 2.0]])
    zeros = np.zeros(len(q))
    out = pm.transform_columns(PColumn("float", zeros), PColumn("float", q))
    ref = jm.transform_columns(JColumn("float", zeros), JColumn("float", q))
    assert out.data.dtype == np.float64
    assert np.array_equal(out.data, np.asarray(ref.data), equal_nan=True)
    order = np.argsort(score[~np.isnan(score)])
    cal = out.data[:n][~np.isnan(score)][order]
    assert ((np.diff(cal) >= 0) if isotonic else (np.diff(cal) <= 0)).all()
    assert pm.transform_value(PT.RealNN(0.0), PT.RealNN(0.5)).value == \
        jm.transform_value(JT.RealNN(0.0), JT.RealNN(0.5)).value


def test_to_isotonic_calibrated_is_ported():
    assert not hasattr(PD, "UNPORTED")
    f = PFB.RealNN("s").as_predictor()
    cal = f.to_isotonic_calibrated(PFB.RealNN("y").as_response(),
                                   isotonic=False)
    assert type(cal.origin_stage).__name__ == "IsotonicRegressionCalibrator"
    assert cal.origin_stage.get_param("isotonic") is False


# -- a small workflow in both packages ---------------------------------------

N = 600


def _values(n=N, seed=12):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 4))
    X[rng.uniform(size=n) < 0.05, 3] = np.nan
    score = X[:, 0] - 0.8 * X[:, 1] + 0.5 * rng.normal(size=n)
    y = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(float)
    s = 1.0 / (1.0 + np.exp(-score))
    vals = [(f"x{i}", "Real", [None if np.isnan(v) else float(v)
                               for v in X[:, i]]) for i in range(4)]
    return vals + [("s", "RealNN", s.tolist()), ("y", "RealNN", y.tolist())]


def _flow(pkg, values, dev=None):
    FB, U, tm, MCMS, MLP, DS, T = pkg
    U.reset_uids()
    ds = DS.from_features([(n, getattr(T, t), v) for n, t, v in values])
    feats = [FB.Real(f"x{i}").as_predictor() for i in range(4)]
    fy = FB.RealNN("y").as_response()
    fs = FB.RealNN("s").as_predictor()
    kw = {} if dev is None else {"device": dev}
    pred = MCMS.with_cross_validation(num_folds=3, models_and_parameters=[
        (MLP(hidden_layers=[8], max_iter=60, **kw),
         [dict(step_size=0.05), dict(step_size=0.2)])],
    ).set_input(fy, tm(feats)).get_output()
    cal = fs.to_isotonic_calibrated(fy)
    return ds, pred, cal


@pytest.fixture(scope="module")
def flows(tmp_path_factory):
    values = _values()
    jds, jpred, jcal = _flow((JFB, JU, j_tm, JMCMS,
                              JM.OpMultilayerPerceptronClassifier,
                              JDataset, JT), values)
    jmodel = JWorkflow().set_input_dataset(jds) \
        .set_result_features(jpred, jcal).train()
    mp = pytest.MonkeyPatch()
    mp.setattr(PM, "init_params", _ref_init)
    try:
        pds, ppred, pcal = _flow((PFB, PU, p_tm, PMCMS,
                                  PM.OpMultilayerPerceptronClassifier,
                                  PDataset, PT), values, "cpu")
        pmodel = PWorkflow(device="cpu").set_input_dataset(pds) \
            .set_result_features(ppred, pcal).train()
    finally:
        mp.undo()
    root = tmp_path_factory.mktemp("mlp_models")
    jpath, ppath = str(root / "jax"), str(root / "port")
    jmodel.save(jpath)
    pmodel.save(ppath)
    return dict(jds=jds, jpred=jpred, jcal=jcal, jmodel=jmodel, pds=pds,
                ppred=ppred, pcal=pcal, pmodel=pmodel, jpath=jpath,
                ppath=ppath)


def _scores(model, ds, pred, cal):
    out = model.score(ds)
    return (np.asarray(out.data(pred.name), np.float64),
            np.asarray(out.data(cal.name), np.float64))


def test_selector_cells_match_jax(flows):
    j = flows["jmodel"].selector_summary()
    p = flows["pmodel"].selector_summary()
    assert p.best_model_name == j.best_model_name
    assert p.best_grid == j.best_grid
    assert [v["route"] for v in p.validation_results] == \
        ["sequential"] * 2
    for a, b in zip(j.validation_results, p.validation_results):
        assert a["grid"] == b["grid"]
        np.testing.assert_allclose(b["fold_metrics"], a["fold_metrics"],
                                   atol=5e-3, rtol=0)


def test_workflow_scores_match_jax(flows):
    t = flows
    jp, jc = _scores(t["jmodel"], t["jds"], t["jpred"], t["jcal"])
    pp, pc = _scores(t["pmodel"], t["pds"], t["ppred"], t["pcal"])
    np.testing.assert_allclose(pp[:, -3:], jp[:, -3:], atol=P_TOL, rtol=0)
    assert np.array_equal(pc, jc)


def test_workflow_saves_load_both_ways(flows):
    t = flows
    pp, pc = _scores(t["pmodel"], t["pds"], t["ppred"], t["pcal"])
    same = PWM.load(t["ppath"], device="cpu")
    sp, sc = _scores(same, t["pds"], t["ppred"], t["pcal"])
    assert np.array_equal(sp, pp) and np.array_equal(sc, pc)
    in_jax = j_load(t["ppath"])
    jp, jc = _scores(in_jax, t["jds"], t["ppred"], t["pcal"])
    np.testing.assert_allclose(jp, pp, atol=1e-5, rtol=0)
    assert np.array_equal(jc, pc)
    jref, jcal = _scores(t["jmodel"], t["jds"], t["jpred"], t["jcal"])
    from_jax = PWM.load(t["jpath"], device="cpu")
    fp, fc = _scores(from_jax, t["pds"], t["jpred"], t["jcal"])
    np.testing.assert_allclose(fp, jref, atol=1e-5, rtol=0)
    assert np.array_equal(fc, jcal)
    carried = convert.workflow_model_from_jax(
        [t["ppred"], t["pcal"]],
        [convert.stage_state(st) for st in t["jmodel"].stages],
        device="cpu")
    cp, cc = _scores(carried, t["pds"], t["ppred"], t["pcal"])
    np.testing.assert_allclose(cp, jref, atol=1e-5, rtol=0)
    assert np.array_equal(cc, jcal)
    assert type(carried.selected_model().best_model).__name__ == "MLPModel"


def test_default_device_is_cuda():
    est = PM.OpMultilayerPerceptronClassifier()
    cal = PM.IsotonicRegressionCalibrator()
    X, y, _ = _data(n=20)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            est.fit_arrays(X, y)
        with pytest.raises(RuntimeError, match="CUDA"):
            PM.IsotonicRegressionModel(np.array([0.0]), np.array([1.0]),
                                       device=cal.device).apply(X[:, 0])
