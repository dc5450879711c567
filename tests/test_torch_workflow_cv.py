"""Workflow-level cross-validation in the port (Workflow.with_workflow_cv,
workflow/dag.cut_dag) against the JAX package (tests/test_workflow_cv.py).

One workflow — a Real, a Real and a PickList through transmogrify,
SanityChecker and a 3-fold selector over linear regression (two grid
points) and Spark GBT — is built in each package with both uid counters
reset and trained with workflow CV on the same seeded records. Tolerances
(CPU): the same stages before, during and after the cut, by class and uid;
identical fold masks; the same winner; every per-fold cell within 5e-3
(the first slice's cell contract); scores within 1e-5 of the largest. A
workflow without a selector trains as without CV, and the linear
regression cells take a device route, never a host fit loop.
"""
import numpy as np
import pytest

from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    RegressionModelSelector as JRMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLinearRegression as JLin
from transmogrifai_tpu.models.trees import OpGBTRegressor as JGBT
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.dag import compute_dag as j_dag
from transmogrifai_tpu.workflow.dag import cut_dag as j_cut

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    RegressionModelSelector as PRMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLinearRegression as PLin
from transmogrifai_tpu_torch.models.trees import OpGBTRegressor as PGBT
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
from transmogrifai_tpu_torch.workflow.dag import compute_dag as p_dag
from transmogrifai_tpu_torch.workflow.dag import cut_dag as p_cut

LIN_GRID = [dict(reg_param=0.01), dict(reg_param=0.3, elastic_net_param=0.5)]
GBT_GRID = [dict(max_iter=5, max_depth=2)]


def rows(n=600, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x, z = float(rng.normal()), float(rng.normal())
        cat = str(int(rng.integers(0, 3)))
        out.append({"x": None if rng.uniform() < 0.05 else x, "z": z,
                    "cat": cat, "label": 2.0 * x + 0.5 * z + int(cat)
                    + float(rng.normal(0, 0.4))})
    return out


def build(FB, U, tm, SC, RMS, Lin, GBT, dev=None):
    U.reset_uids()
    kw = {} if dev is None else {"device": dev}
    feats = [FB.Real("x").as_predictor(), FB.Real("z").as_predictor(),
             FB.PickList("cat").as_predictor()]
    fy = FB.RealNN("label").as_response()
    checked = SC().set_input(fy, tm(feats)).get_output()
    return RMS.with_cross_validation(
        num_folds=3, seed=11, models_and_parameters=[
            (Lin(**kw), [dict(g) for g in LIN_GRID]),
            (GBT(**kw), [dict(g) for g in GBT_GRID]),
        ]).set_input(fy, checked).get_output()


J = (JFB, JU, j_tm, JSC, JRMS, JLin, JGBT)
P = (PFB, PU, p_tm, PSC, PRMS, PLin, PGBT)


@pytest.fixture(scope="module")
def trained():
    data = rows()
    mp = pytest.MonkeyPatch()
    mp.setenv("TMOG_NO_HOST_TREES", "1")
    try:
        jpred = build(*J)
        jwf = JWorkflow().set_reader(JList(data)).set_result_features(jpred)
        jmodel = jwf.with_workflow_cv().train()
        ppred = build(*P, dev="cpu")
        pwf = PWorkflow(device="cpu").set_reader(PList(data)) \
            .set_result_features(ppred)
        pmodel = pwf.with_workflow_cv().train()
    finally:
        mp.undo()
    return dict(jpred=jpred, ppred=ppred, jmodel=jmodel, pmodel=pmodel,
                jwf=jwf, pwf=pwf, data=data)


def _shape(dag):
    return [[(type(st).__name__, st.uid) for st in layer]
            for layer in dag.layers]


def test_cut_dag_matches_jax():
    jcut = j_cut(j_dag((build(*J),)))
    pcut = p_cut(p_dag((build(*P, dev="cpu"),)))
    for part in ("before", "during", "after"):
        assert _shape(getattr(pcut, part)) == _shape(getattr(jcut, part))
    assert pcut.model_selector.uid == jcut.model_selector.uid
    # every estimator feeds the selector: all of them refit in each fold
    assert _shape(pcut.before) == []
    assert [n for n, _ in sum(_shape(pcut.during), [])] == [
        "NumericVectorizer", "OneHotVectorizer", "VectorsCombiner",
        "SanityChecker"]
    assert _shape(pcut.after) == [[("ModelSelector",
                                    pcut.model_selector.uid)]]


def test_two_selectors_raise():
    PU.reset_uids()
    y = PFB.RealNN("y").as_response()
    vec = p_tm([PFB.Real("a").as_predictor()])
    p1 = PRMS.with_cross_validation(
        models_and_parameters=[(PLin(device="cpu"), [{}])]) \
        .set_input(y, vec).get_output()
    p2 = PRMS.with_cross_validation(
        models_and_parameters=[(PLin(device="cpu"), [{}])]) \
        .set_input(y, vec).get_output()
    with pytest.raises(ValueError, match="Multiple ModelSelectors"):
        p_cut(p_dag((p1, p2)))


def test_fold_masks_identical(trained):
    y = np.array([r["label"] for r in trained["data"]], np.float32)
    jsel = trained["jpred"].origin_stage
    psel = trained["ppred"].origin_stage
    assert np.array_equal(psel.validator.fold_masks(y),
                          jsel.validator.fold_masks(y))


def _cv_cells(model):
    return [v for v in model.selector_summary().validation_results
            if v.get("workflow_cv")]


def test_same_winner_and_cells(trained):
    js = trained["jmodel"].selector_summary()
    ps = trained["pmodel"].selector_summary()
    assert (ps.best_model_name, ps.best_grid) == \
        (js.best_model_name, js.best_grid)
    jc, pc = _cv_cells(trained["jmodel"]), _cv_cells(trained["pmodel"])
    assert len(pc) == len(jc) == 3
    for a, b in zip(pc, jc):
        assert (a["model_name"], a["grid"]) == (b["model_name"], b["grid"])
        assert len(a["fold_metrics"]) == 3
        np.testing.assert_allclose(a["fold_metrics"], b["fold_metrics"],
                                   rtol=0, atol=5e-3)
    # the selector then refits only the winner
    assert len(ps.validation_results) == len(js.validation_results) == 4


def test_scores_match(trained):
    got = np.asarray(trained["pmodel"].score().data(trained["ppred"].name))
    want = np.asarray(trained["jmodel"].score().data(trained["jpred"].name))
    assert got.shape == (len(trained["data"]), 1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_glm_takes_a_device_route(trained):
    routes = trained["pwf"].workflow_cv_routes
    assert len(routes) == 3
    assert {r for (m, _), r in routes.items() if m == 0} == {"vmapped"}
    assert {r for (m, _), r in routes.items() if m == 1} == {"mask_folds"}
    walls = trained["pwf"].workflow_cv_walls
    assert [w["fold"] for w in walls] == [0, 1, 2]
    assert all(w["refit_s"] >= 0 and set(w["family_sweep_s"])
               == {"OpLinearRegression", "OpGBTRegressor"} for w in walls)


def test_without_selector_is_noop():
    data = rows(100)
    PU.reset_uids()
    vec = p_tm([PFB.Real("x").as_predictor()])
    wf = PWorkflow(device="cpu").set_reader(PList(data)) \
        .set_result_features(vec)
    plain = wf.train().score().data(vec.name)
    cv = wf.with_workflow_cv().train().score().data(vec.name)
    assert np.array_equal(plain, cv)
    assert wf.workflow_cv_walls == []


def test_compute_data_up_to_matches_jax(trained):
    """The DAG materialized up to the sanity-checked vector only."""
    jvec = trained["jpred"].origin_stage.input_features[1]
    pvec = trained["ppred"].origin_stage.input_features[1]
    assert pvec.name == jvec.name
    jds = trained["jwf"].compute_data_up_to(jvec)
    pds = trained["pwf"].compute_data_up_to(pvec)
    assert trained["ppred"].name not in pds
    assert np.array_equal(pds.data(pvec.name), jds.data(jvec.name))


def test_with_model_stages_reuses_fitted_stages(trained):
    """A rebuilt workflow (same uids) spliced with the trained model's
    stages refits nothing: trained on other rows, it scores as the model
    it reused."""
    other = rows(300, seed=99)
    ppred = build(*P, dev="cpu")
    reused = PWorkflow(device="cpu").set_reader(PList(other)) \
        .set_result_features(ppred) \
        .with_model_stages(trained["pmodel"]).train()
    got = reused.score().data(ppred.name)
    want = trained["pmodel"].score(
        PList(other).generate_dataset(reused.raw_features())) \
        .data(trained["ppred"].name)
    assert np.array_equal(got, want)
    assert reused.selector_summary().to_json() == \
        trained["pmodel"].selector_summary().to_json()
