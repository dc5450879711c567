"""The port's ModelInsights, RecordInsightsLOCO and RecordInsightsCorr
against the JAX package's.

The cases of tests/test_insights.py run on the port's own CPU-trained
workflow: contributions, correlations, the selector, JSON, the pretty
tables, the label summary, the derived columns, the stage info and the
titanic example listing every raw feature. Both packages then train the
same flow on the same seeded values (after `reset_uids()` in each):
`ModelInsights.to_json()` of the JAX-fitted workflow carried across
(`convert.workflow_model_from_jax`) equals the JAX package's (keys and
names identical, numbers within rtol 1e-5), and the port's own training
gives the same keys, names and statistics (rtol 1e-5: the port's
statistics engine sums in float64, the JAX package's in float32).
RecordInsightsCorr agrees on both sides of _FUSED_MIN_ELEMENTS (the numpy
reductions exactly, the engine pass within rtol 1e-5). A workflow with a
`loco_insights` result feature saved by either package loads in the
other with the same top-K keys and deltas within 1e-5.
"""
import json

import numpy as np
import pytest

from transmogrifai_tpu import types as JT
from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.data.dataset import Column as JColumn
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.insights import RecordInsightsCorr as JCorr
from transmogrifai_tpu.insights import extract_insights as j_extract
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.models.prediction import \
    make_prediction_column as j_pred_col
from transmogrifai_tpu.models.trees import OpGBTClassifier as JGBT
from transmogrifai_tpu.stages.params import param_grid as j_grid
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.io import load_model as j_load

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.data.dataset import Column as PColumn
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.insights import (
    RecordInsightsCorr, RecordInsightsLOCO, extract_insights,
    model_contributions)
from transmogrifai_tpu_torch.insights import corr as PCorr
from transmogrifai_tpu_torch.insights.model_insights import \
    model_contributions_per_class
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.models.prediction import \
    make_prediction_column as p_pred_col
from transmogrifai_tpu_torch.models.trees import OpGBTClassifier as PGBT
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.stages.params import param_grid as p_grid
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM

RTOL = 1e-5


def _values(n=500, seed=11):
    """tests/test_insights.py's rows, as columns."""
    rng = np.random.default_rng(seed)
    cols = {"strong": [], "weak": [], "noise": [], "label": []}
    for _ in range(n):
        strong = float(rng.normal())
        weak = float(rng.normal())
        noise = float(rng.normal())
        label = float(2.5 * strong + 0.3 * weak + rng.normal(0, 0.5) > 0)
        for k, v in zip(cols, (strong, weak, noise, label)):
            cols[k].append(v)
    return cols


def _flow(pkg, cols):
    """(dataset, checked vector, prediction) of the insights flow in one
    package: pkg = (FeatureBuilder, uid, transmogrify, SanityChecker,
    selector, LR, param_grid, Dataset, types, LR kwargs)."""
    FB, U, tm, SC, BCMS, LR, grid, DS, T, kw = pkg
    U.reset_uids()
    ds = DS.from_features(
        [(k, T.Real, cols[k]) for k in ("strong", "weak", "noise")]
        + [("label", T.RealNN, cols["label"])])
    feats = [FB.Real(k).as_predictor() for k in ("strong", "weak", "noise")]
    fy = FB.RealNN("label").as_response()
    checked = SC().set_input(fy, tm(feats)).get_output()
    pred = BCMS.with_train_validation_split(models_and_parameters=[
        (LR(**kw), grid(reg_param=[0.01]))]).set_input(fy, checked) \
        .get_output()
    return ds, checked, pred


JPKG = (JFB, JU, j_tm, JSC, JBCMS, JLR, j_grid, JDataset, JT, {})
PPKG = (PFB, PU, p_tm, PSC, PBCMS, PLR, p_grid, PDataset, PT,
        {"device": "cpu"})


@pytest.fixture(scope="module")
def fitted():
    cols = _values()
    jds, jchecked, jpred = _flow(JPKG, cols)
    jmodel = JWorkflow().set_input_dataset(jds) \
        .set_result_features(jpred).train()
    _, _, cpred = _flow(PPKG, cols)
    carried = convert.workflow_model_from_jax(
        (cpred,), [convert.stage_state(st) for st in jmodel.stages],
        device="cpu")
    pds, pchecked, ppred = _flow(PPKG, cols)
    pmodel = PWorkflow(device="cpu").set_input_dataset(pds) \
        .set_result_features(ppred).train()
    return dict(cols=cols, jds=jds, jchecked=jchecked, jpred=jpred,
                jmodel=jmodel, carried=carried, pds=pds, pchecked=pchecked,
                ppred=ppred, pmodel=pmodel)


# -- the reference's cases on the port's own training -------------------------

def test_contributions_rank_strong_first(fitted):
    mi = fitted["pmodel"].model_insights()
    by_name = {f.feature_name: f for f in mi.features}
    assert by_name["strong"].max_contribution() > \
        by_name["weak"].max_contribution()
    assert by_name["strong"].max_contribution() > \
        by_name["noise"].max_contribution()


def test_correlations_populated(fitted):
    by_name = {f.feature_name: f
               for f in fitted["pmodel"].model_insights().features}
    assert by_name["strong"].max_corr() > 0.5
    assert by_name["strong"].max_corr() > by_name["noise"].max_corr()


def test_selected_model_and_evals(fitted):
    mi = fitted["pmodel"].model_insights()
    assert mi.selected_model["best_model_type"] == "OpLogisticRegression"
    assert mi.problem_type == "binary"
    assert "au_pr" in mi.train_evaluation
    assert mi.label_name == "label"


def test_json_serializable(fitted):
    assert json.dumps(fitted["pmodel"].model_insights().to_json())


def test_pretty_tables(fitted):
    s = fitted["pmodel"].model_insights().pretty()
    assert "Top Model Contributions" in s
    assert "Top Correlations" in s
    assert "strong" in s


def test_tree_contributions_match_jax():
    """Split-frequency importances of a JAX-fitted GBT carried across equal
    the JAX package's; the port's own fit ranks the causal column first."""
    from transmogrifai_tpu.insights import model_contributions as j_contrib
    X = np.random.default_rng(5).normal(size=(400, 4)).astype(np.float32)
    y = (X[:, 1] > 0).astype(np.float32)
    jm = JGBT(max_iter=10, max_depth=3).fit_arrays(X, y)
    pm = convert.tree_model_from_jax(jm.save_args(), device="cpu")
    np.testing.assert_array_equal(model_contributions(pm, 4),
                                  j_contrib(jm, 4))
    own = model_contributions(
        PGBT(max_iter=10, max_depth=3, device="cpu").fit_arrays(X, y), 4)
    assert own is not None and own.argmax() == 1
    assert own.sum() == pytest.approx(1.0, abs=1e-6)
    assert model_contributions_per_class(pm, 4).shape == (4, 1)


def test_loco_ranks_causal_column():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(50, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    model = PLR(reg_param=0.01, device="cpu").fit_arrays(X, y)
    deltas = RecordInsightsLOCO(model=model, top_k=2).insights_matrix(X)
    assert deltas.shape == (50, 3, 2)
    strongest = np.abs(deltas).max(axis=2).argmax(axis=1)
    assert (strongest == 0).mean() > 0.9


def test_loco_transform_emits_topk_maps(fitted):
    model = fitted["pmodel"]
    sel, sc = model.selected_model(), model._sanity_checker()
    vec_col = model.transform(fitted["pds"]).column(sc.output_name())
    out = RecordInsightsLOCO(model=sel, top_k=2).transform_columns(vec_col)
    first = out.data[0]
    assert isinstance(first, dict) and len(first) == 2
    for k, v in first.items():
        assert isinstance(k, str) and len(json.loads(v)) == 2  # two classes


def test_loco_zero_for_constant_column():
    rng = np.random.default_rng(10)
    X = rng.normal(size=(30, 3)).astype(np.float32)
    X[:, 2] = 0.0
    y = (X[:, 0] > 0).astype(np.float32)
    model = PLR(device="cpu").fit_arrays(X, y)
    deltas = RecordInsightsLOCO(model=model).insights_matrix(X)
    assert np.abs(deltas[:, 2, :]).max() < 1e-6


def test_label_summary(fitted):
    lab = fitted["pmodel"].model_insights().label
    assert lab.label_name == "label"
    assert lab.raw_feature_name == ["label"]
    assert lab.raw_feature_type == ["RealNN"]
    assert lab.sample_size == 500
    assert lab.distribution["kind"] == "discrete"
    assert sorted(lab.distribution["domain"]) == ["0.0", "1.0"]
    assert sum(lab.distribution["prob"]) == pytest.approx(1.0)


def test_derived_columns_carry_stats_and_stages(fitted):
    by_name = {f.feature_name: f
               for f in fitted["pmodel"].model_insights().features}
    d = by_name["strong"].derived[0]
    assert d.mean is not None and d.variance is not None
    assert d.min is not None and d.max is not None
    assert d.excluded is False
    assert d.contributions, "per-class contributions missing"
    assert d.stages_applied


def test_stage_info_map(fitted):
    mi = fitted["pmodel"].model_insights()
    assert mi.stage_info, "stage_info empty"
    assert any("sanityCheck" in k for k in mi.stage_info)


def test_titanic_insights_list_every_raw_feature():
    """The port's titanic example: every raw predictor with derived
    columns, checker stats and a contribution; categorical columns with
    their contingency stats."""
    from transmogrifai_tpu_torch.examples import op_titanic_simple as t
    wf, _ = t.build_workflow(device="cpu")
    model = wf.set_reader(PList(t.synthetic_passengers(400))).train()
    mi = model.model_insights()
    by_name = {f.feature_name: f for f in mi.features}
    for raw in ("pClass", "age", "sibSp", "parCh", "embarked"):
        assert raw in by_name, f"{raw} missing from insights"
        fi = by_name[raw]
        assert fi.derived, f"{raw} has no derived columns"
        kept = [d for d in fi.derived if d.column_index >= 0]
        assert any(d.contribution is not None for d in kept) or \
            fi.excluded_by, raw
        assert any(d.mean is not None for d in kept) or fi.excluded_by
        assert all(d.stages_applied for d in kept), raw
    cat_cols = [d for f in mi.features for d in f.derived
                if d.indicator_value is not None and d.column_index >= 0]
    assert any(d.count_matrix for d in cat_cols), \
        "no contingency stats on categorical columns"
    assert any(d.mutual_information is not None for d in cat_cols)
    j = json.dumps(mi.to_json())
    assert "count_matrix" in j and "stages_applied" in j


# -- against the JAX package ----------------------------------------------------

def _assert_same(got, want, where="", numbers=True):
    """Identical structure, keys and strings; numbers within RTOL (or
    ignored where `numbers` is False)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (where, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}", numbers)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), \
            where
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{where}[{i}]", numbers)
    elif isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, (where, got, want)
    elif isinstance(want, (int, float)):
        assert isinstance(got, (int, float)) and not isinstance(got, bool), \
            where
        if numbers and not (np.isnan(want) and np.isnan(got)):
            assert got == pytest.approx(want, rel=RTOL, abs=1e-12), \
                (where, got, want)
    else:
        assert got == want, (where, got, want)


def test_carried_workflow_insights_json_matches_jax(fitted):
    want = j_extract(fitted["jmodel"]).to_json()
    got = extract_insights(fitted["carried"]).to_json()
    _assert_same(got, want)
    assert fitted["carried"].model_insights().pretty() == \
        j_extract(fitted["jmodel"]).pretty()


def test_port_trained_insights_match_jax_statistics(fitted):
    """The port's own training: the same keys, features, columns, label
    and stage names as the JAX package's, and the SanityChecker's
    statistics of each derived column within rtol 1e-5. (The port's
    validation results carry a `route` the JAX package's lack.)"""
    want = j_extract(fitted["jmodel"]).to_json()
    got = fitted["pmodel"].model_insights().to_json()
    assert set(got) == set(want)
    for key in ("label_name", "problem_type", "label", "features",
                "selected_model", "stage_names", "blacklisted"):
        _assert_same(got[key], want[key], key, numbers=False)
    for fg, fw in zip(got["features"], want["features"]):
        for dg, dw in zip(fg["derived"], fw["derived"]):
            for key in ("mean", "variance", "min", "max", "corr_label"):
                assert dg[key] == pytest.approx(dw[key], rel=RTOL), \
                    (dg["column_name"], key)
    assert got["label"]["distribution"] == want["label"]["distribution"]


def _corr_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] += 3.0
    p1 = 1.0 / (1.0 + np.exp(-(X[:, 0] - 0.5 * X[:, 2])))
    prob = np.stack([1.0 - p1, p1], axis=1).astype(np.float32)
    pred = (p1 > 0.5).astype(np.float32)
    return X, pred, prob


@pytest.mark.parametrize("n, d", [(400, 12), (1025, 1024)],
                         ids=["numpy", "engine"])
def test_corr_insights_match_jax(n, d):
    """Below _FUSED_MIN_ELEMENTS both packages take the same numpy
    reductions (identical maps); from it one statistics-engine pass (the
    port's in float64, the JAX package's in float32: rtol 1e-5)."""
    X, pred, prob = _corr_inputs(n, d, seed=d)
    assert (X.size >= PCorr._FUSED_MIN_ELEMENTS) == (d == 1024)
    stage = RecordInsightsCorr(top_k=3)
    stage.device = "cpu"
    got = stage.transform_columns(
        PColumn(kind="vector", data=X), p_pred_col(pred, None, prob))
    want = JCorr(top_k=3).transform_columns(
        JColumn(kind="vector", data=X), j_pred_col(pred, None, prob))
    assert len(got.data) == len(want.data) == n
    for g, w in zip(got.data, want.data):
        assert list(g) == list(w)
        for k in w:
            a, b = json.loads(g[k]), json.loads(w[k])
            if d < 1024:
                assert a == b
            else:
                for key in ("contribution", "correlation"):
                    assert a[key] == pytest.approx(b[key], rel=RTOL,
                                                   abs=1e-6)
    assert RecordInsightsCorr().transform_value(None, None).value == {}


def _loco_workflow(train, checked, sel, ds):
    """A workflow whose result is `checked.loco_insights(sel, top_k=3)`."""
    loco = checked.loco_insights(sel, top_k=3)
    return train().set_input_dataset(ds).set_result_features(loco) \
        .train(), loco


def _loco_maps(model, ds, loco):
    return list(model.score(ds).data(loco.name))


def _assert_loco_equal(got, want):
    assert len(got) == len(want) == 500
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            a, b = np.array(json.loads(g[k])), np.array(json.loads(w[k]))
            np.testing.assert_array_equal(a[:, 0], b[:, 0])
            np.testing.assert_allclose(a[:, 1], b[:, 1], atol=1e-5, rtol=0)


def test_loco_workflow_saved_by_each_loads_in_the_other(fitted, tmp_path):
    f = fitted
    jmodel, jloco = _loco_workflow(JWorkflow, f["jchecked"],
                                   f["jmodel"]._selected_model(), f["jds"])
    pmodel, ploco = _loco_workflow(lambda: PWorkflow(device="cpu"),
                                   f["pchecked"], f["pmodel"].selected_model(),
                                   f["pds"])
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    jmodel.save(jpath)
    pmodel.save(ppath)
    # the JAX save in the port: the same maps as the JAX package scores
    port_loaded = PWM.load(jpath, device="cpu")
    assert type(port_loaded.stages[-1]) is RecordInsightsLOCO
    _assert_loco_equal(_loco_maps(port_loaded, f["pds"], jloco),
                       _loco_maps(jmodel, f["jds"], jloco))
    # the port's save in the JAX package, against the port's own scores
    _assert_loco_equal(_loco_maps(j_load(ppath), f["jds"], ploco),
                       _loco_maps(pmodel, f["pds"], ploco))
    # the port's save in the port
    _assert_loco_equal(
        _loco_maps(PWM.load(ppath, device="cpu"), f["pds"], ploco),
        _loco_maps(pmodel, f["pds"], ploco))
