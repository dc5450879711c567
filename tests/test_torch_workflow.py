"""The port's Workflow entry end to end against the JAX package.

One titanic-shaped workflow without text or derived features —
FeatureBuilder -> transmogrify -> SanityChecker ->
BinaryClassificationModelSelector (logistic regression and XGBoost, 3-fold
CV) -> Workflow.train() -> score() — is built in each package from the
same seeded records, with both uid counters reset. Tolerances (CPU): the
same winner; every sweep cell's mean fold AuPR within 5e-3 (the contract
of the port's first slice; the JAX package fits tree folds one by one on
the CPU, the port fold-fused); the holdout AuPR within 1e-3; the scored
probabilities within 1e-5; the JAX-fitted workflow carried over through
convert.workflow_model_from_jax scores within 1e-5 of the JAX package.
The splitters' numpy draws agree bit for bit.
"""
import ast
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.automl.tuning import splitters as JSp
from transmogrifai_tpu.evaluators.evaluators import Evaluators as JEv
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpXGBoostClassifier as JXGB
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.automl.tuning import splitters as PSp
from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators as PEv
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier as PXGB
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

REPO = pathlib.Path(__file__).resolve().parents[1]
LR_GRID = [{"reg_param": 0.001, "elastic_net_param": 0.1},
           {"reg_param": 0.2, "elastic_net_param": 0.5}]
XGB_GRID = [dict(max_depth=3, eta=0.3, num_round=5, max_bins=32),
            dict(max_depth=1, eta=0.05, num_round=2, max_bins=32)]


def passengers(n=2500, seed=1912):
    """Titanic-shaped records: survival depends on sex, class, age, fare."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        sex = "female" if rng.uniform() < 0.35 else "male"
        pclass = int(rng.choice([1, 2, 3], p=[0.24, 0.21, 0.55]))
        age = float(np.clip(rng.normal(29, 14), 0.4, 80)) \
            if rng.uniform() > 0.2 else None
        sibsp, parch = int(rng.poisson(0.5)), int(rng.poisson(0.4))
        fare = float(np.clip(rng.lognormal(3.6 - 0.5 * (pclass - 1), 0.6),
                             4, 512))
        logit = (2.5 * (sex == "female") - 0.9 * (pclass - 2)
                 - 0.02 * ((age or 29) - 29) + 0.004 * fare
                 - 0.3 * (sibsp + parch > 3) - 0.7)
        rows.append({
            "survived": float(rng.uniform() < 1 / (1 + np.exp(-logit))),
            "pClass": str(pclass), "sex": sex, "age": age, "sibSp": sibsp,
            "parCh": parch, "fare": fare,
            "embarked": None if rng.uniform() < 0.02 else
            str(rng.choice(["S", "C", "Q"], p=[0.72, 0.19, 0.09])),
            "alone": None if rng.uniform() < 0.05 else sibsp + parch == 0,
            "cabinDeck": {d for d in "ABCDE" if rng.uniform() < 0.08},
        })
    return rows


def build(FB, U, tm, SC, BCMS, LR, XGB, dev):
    """The workflow's result feature and its pieces, built the user's way."""
    U.reset_uids()
    kw = {} if dev is None else {"device": dev}
    survived = FB.RealNN("survived").as_response()
    feats = [FB.PickList("pClass").as_predictor(),
             FB.PickList("sex").as_predictor(),
             FB.Real("age").as_predictor(),
             FB.Integral("sibSp").as_predictor(),
             FB.Integral("parCh").as_predictor(),
             FB.Real("fare").as_predictor(),
             FB.PickList("embarked").as_predictor(),
             FB.Binary("alone").as_predictor(),
             FB.MultiPickList("cabinDeck").as_predictor()]
    checked = SC(remove_bad_features=True).set_input(
        survived, tm(feats)).get_output()
    selector = BCMS.with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=[
            (LR(**kw), [dict(g) for g in LR_GRID]),
            (XGB(**kw), [dict(g) for g in XGB_GRID])])
    return selector.set_input(survived, checked).get_output()


@pytest.fixture(scope="module")
def trained():
    mp = pytest.MonkeyPatch()
    mp.setenv("TMOG_NO_HOST_TREES", "1")
    try:
        rows = passengers()
        jpred = build(JFB, JU, j_tm, JSC, JBCMS, JLR, JXGB, None)
        jmodel = JWorkflow().set_reader(JList(rows)) \
            .set_result_features(jpred).train()
        ppred = build(PFB, PU, p_tm, PSC, PBCMS, PLR, PXGB, "cpu")
        pmodel = PWorkflow(device="cpu").set_reader(PList(rows)) \
            .set_result_features(ppred).train()
    finally:
        mp.undo()
    new = passengers(400, seed=7)
    return dict(jpred=jpred, ppred=ppred, jmodel=jmodel, pmodel=pmodel,
                new=new)


def test_same_winner(trained):
    js = trained["jmodel"].selector_summary()
    ps = trained["pmodel"].selector_summary()
    assert ps.best_model_name == js.best_model_name
    assert ps.best_grid == js.best_grid
    assert ps.best_model_type == js.best_model_type
    assert trained["ppred"].name == trained["jpred"].name


def test_cell_metrics_within_5e3(trained):
    js = trained["jmodel"].selector_summary()
    ps = trained["pmodel"].selector_summary()
    assert len(ps.validation_results) == len(js.validation_results) == 4
    for a, b in zip(js.validation_results, ps.validation_results):
        assert (a["model_name"], a["grid"]) == (b["model_name"], b["grid"])
        assert abs(a["mean_metric"] - b["mean_metric"]) < 5e-3, (a, b)
    assert {v["route"] for v in ps.validation_results} == \
        {"vmapped", "mask_folds"}


def test_holdout_and_train_evaluation(trained):
    js = trained["jmodel"].selector_summary()
    ps = trained["pmodel"].selector_summary()
    assert abs(ps.holdout_evaluation["au_pr"]
               - js.holdout_evaluation["au_pr"]) < 1e-3
    for k in ("au_roc", "precision", "recall", "f1", "error"):
        assert abs(ps.holdout_evaluation[k] - js.holdout_evaluation[k]) \
            < 1e-3, k
        assert abs(ps.train_evaluation[k] - js.train_evaluation[k]) < 1e-3
    assert ps.data_prep_results == js.data_prep_results


def test_sanity_checker_decisions_agree(trained):
    js = trained["jmodel"].sanity_checker_summary()
    ps = trained["pmodel"].sanity_checker_summary()
    assert ps.names == js.names and ps.dropped == js.dropped


def _probabilities(model, pred, reader, rows):
    ds = reader(rows).generate_dataset(model.raw_features())
    return model.score(ds).data(pred.name)


def test_scores_within_1e5(trained):
    new = trained["new"]
    j = _probabilities(trained["jmodel"], trained["jpred"], JList, new)
    p = _probabilities(trained["pmodel"], trained["ppred"], PList, new)
    assert p.shape == j.shape == (len(new), 5)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


def test_score_and_evaluate(trained):
    new = trained["new"]
    jm, pm = trained["jmodel"], trained["pmodel"]
    _, jmet = jm.score_and_evaluate(
        JEv.BinaryClassification.au_pr(),
        JList(new).generate_dataset(jm.raw_features()))
    scored, pmet = pm.score_and_evaluate(
        PEv.BinaryClassification.au_pr(),
        PList(new).generate_dataset(pm.raw_features()))
    assert scored.column_names() == [trained["ppred"].name]
    for k in ("au_pr", "au_roc", "error"):
        assert abs(pmet[k] - jmet[k]) < 1e-3, k
    assert "Selected:" in pm.summary_pretty()
    summary = pm.summary()
    assert summary["model_selection"]["best_model_name"] == \
        jm.summary()["model_selection"]["best_model_name"]
    assert summary["sanity_check"]["dropped"] == \
        jm.summary()["sanity_check"]["dropped"]


def test_jax_fitted_workflow_scores_identically(trained):
    jm = trained["jmodel"]
    ppred = build(PFB, PU, p_tm, PSC, PBCMS, PLR, PXGB, "cpu")
    carried = convert.workflow_model_from_jax(
        [ppred], [convert.stage_state(st) for st in jm.stages],
        device="cpu")
    new = trained["new"]
    j = _probabilities(jm, trained["jpred"], JList, new)
    p = _probabilities(carried, ppred, PList, new)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


def test_port_fitted_workflow_carried_over_scores_identically(trained):
    pm, ppred = trained["pmodel"], trained["ppred"]
    carried = convert.workflow_model_from_jax(
        [ppred], [convert.stage_state(st) for st in pm.stages],
        device="cpu")
    new = trained["new"]
    np.testing.assert_array_equal(
        _probabilities(carried, ppred, PList, new),
        _probabilities(pm, ppred, PList, new))


def test_runner_walls_hold_the_last_run_only(trained):
    pm, new = trained["pmodel"], trained["new"]
    _probabilities(pm, trained["ppred"], PList, new)
    first = list(pm.runner.walls)
    _probabilities(pm, trained["ppred"], PList, new)
    assert first and len(pm.runner.walls) == len(first)
    assert {w["op"] for w in pm.runner.walls} == {"transform"}


def test_copies_are_recorded_only_inside_a_recorder_block():
    from transmogrifai_tpu_torch import device as D
    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    out = D.to_device(a, torch.device("cpu"), label="x")
    assert out.dtype == torch.float32 and D._recorder is None
    with D.record_copies() as outer:
        with D.record_copies() as inner:
            assert D._recorder is inner
            D.to_device(a, torch.device("cpu"), label="x")
        assert D._recorder is outer
    assert D._recorder is None
    # host-to-host moves are not copies onto a card
    assert outer.copies == [] and inner.copies == []


def _refit_levels(X, y, **kw):
    import chip_smoke
    with chip_smoke.record_refit_levels([]) as levels:
        PXGB(device="cpu", max_bins=32, **kw).fit_arrays(X, y)
    return levels


def test_split_witness_tells_a_tie_from_a_worse_split():
    """chip_smoke's witness for refits that split a node differently: the
    same fit twice does not diverge; a node re-split on the same partition
    (the other missing direction of a feature with nothing missing) is a
    tie, one re-split on a clearly worse candidate is not."""
    import copy
    import chip_smoke
    from transmogrifai_tpu_torch.ops import trees as T
    rng = np.random.default_rng(5)
    X = rng.normal(size=(4000, 4)).astype(np.float32)
    y = (rng.uniform(size=4000) < 1 / (1 + np.exp(-2 * X[:, 0]))) \
        .astype(np.float32)
    a = _refit_levels(X, y, max_depth=2, num_round=2, eta=0.3)
    assert len(a) == 4
    assert chip_smoke.first_divergence(a, _refit_levels(
        X, y, max_depth=2, num_round=2, eta=0.3)) is None
    gain, _ = T._level_gains(a[0]["full"], a[0]["split_kw"],
                             *a[0]["masks"])
    f, t, m = (int(s[0]) for s in a[0]["split"])
    assert float(gain[0, 0, f, t, 1 - m]) == float(gain[0, 0, f, t, m])
    flat = gain[0, 0].reshape(-1)
    worst = int(torch.argmin(torch.where(torch.isfinite(flat), flat,
                                         math.inf)))
    B = gain.shape[3]
    names = [f"x{j}" for j in range(4)]
    for split, tie in (((f, t, 1 - m), True),
                       ((worst // (2 * B), worst // 2 % B, worst % 2),
                        False)):
        b = copy.deepcopy(a)
        for k, v in enumerate(split):
            b[0]["split"][k][0] = v
        assert chip_smoke.first_divergence(a, b) == (0, 0)
        w = chip_smoke.split_witness(a, b, 0, 0, 2, names)
        assert w["counts_equal"] and w["tie"] is tie, w
        assert (w["round"], w["level"], w["split_a"][0]) == (0, 0, "x0")


def test_default_model_types_raise():
    """The defaults (LR, RF, GBT, SVC) resolve since the forest slice, the
    MLP since the MLP slice; a model type the port does not know raises,
    naming it."""
    sel = PBCMS.with_cross_validation(device="cpu")
    assert [type(e).__name__ for e, _ in sel.models] == \
        list(PBCMS.default_model_types)
    split = PBCMS.with_train_validation_split(
        model_types=["OpLogisticRegression", "OpGBTClassifier"],
        device="cpu")
    assert len(split.models) == 2
    # naive Bayes is ported (binary and multiclass)
    nb = PBCMS.with_cross_validation(model_types=["OpNaiveBayes"],
                                     device="cpu")
    assert [type(e).__name__ for e, _ in nb.models] == ["OpNaiveBayes"]
    # the MLP is ported: it resolves and runs (the sequential route)
    mlp = PBCMS.with_cross_validation(
        model_types=["OpLogisticRegression",
                     "OpMultilayerPerceptronClassifier"], device="cpu")
    assert [type(e).__name__ for e, _ in mlp.models] == \
        ["OpLogisticRegression", "OpMultilayerPerceptronClassifier"]
    rng = np.random.default_rng(4)
    X = rng.normal(size=(240, 3)).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float32)
    mlp.validator.device = "cpu"
    best = mlp.validator.validate(
        [(mlp.models[1][0].copy(max_iter=30), [dict()])], X, y)
    assert [v.route for v in best.validated] == ["sequential"]
    assert np.isfinite(best.best_metric)
    with pytest.raises(NotImplementedError, match="OpPerceptronOfDoom"):
        PBCMS.with_cross_validation(model_types=["OpPerceptronOfDoom"])


def test_ported_model_types_take_the_reference_grids():
    sel = PBCMS.with_cross_validation(
        model_types=["OpLogisticRegression", "OpLinearSVC",
                     "OpXGBoostClassifier"], seed=7, device="cpu")
    jsel = JBCMS.with_cross_validation(
        model_types=["OpLogisticRegression", "OpLinearSVC",
                     "OpXGBoostClassifier"], seed=7)
    assert [(type(e).__name__, g) for e, g in sel.models] == \
        [(type(e).__name__, g) for e, g in jsel.models]
    assert sel.models[2][0].get_param("seed") == 7
    assert all(e.device == "cpu" for e, _ in sel.models)
    assert isinstance(sel.splitter, PSp.DataBalancer)


def test_text_feature_raises_in_transmogrify():
    """Free text transmogrifies since the text slice and the structured
    text types since theirs: an Email derives its domain PickList first,
    as in the JAX package; nothing of these raises any more."""
    assert p_tm([PFB.Real("age").as_predictor(),
                 PFB.Text("name").as_predictor()]).type_name == "OPVector"
    names = []
    for FB, U, tm in ((JFB, JU, j_tm), (PFB, PU, p_tm)):
        U.reset_uids()
        vec = tm([FB.Real("age").as_predictor(),
                  FB.Email("contact").as_predictor()])
        names.append([(p.name, p.type_name) for p in vec.parents])
    assert names[1] == names[0]
    assert any(n.startswith("contact_emailDomain") for n, _ in names[1])


def test_train_validation_split_workflow_agrees():
    rows = passengers(1500, seed=3)

    def run(FB, U, tm, SC, BCMS, LR, Workflow, List, dev):
        U.reset_uids()
        kw = {} if dev is None else {"device": dev}
        y = FB.RealNN("survived").as_response()
        vec = tm([FB.PickList("sex").as_predictor(),
                  FB.Real("age").as_predictor(),
                  FB.Real("fare").as_predictor()])
        sel = BCMS.with_train_validation_split(
            seed=5, models_and_parameters=[(LR(**kw), [dict(g) for g in
                                                       LR_GRID])])
        pred = sel.set_input(y, SC().set_input(y, vec).get_output()) \
            .get_output()
        wf = Workflow(**kw).set_reader(List(rows)).set_result_features(pred)
        return wf.train().selector_summary()
    js = run(JFB, JU, j_tm, JSC, JBCMS, JLR, JWorkflow, JList, None)
    ps = run(PFB, PU, p_tm, PSC, PBCMS, PLR, PWorkflow, PList, "cpu")
    assert ps.best_grid == js.best_grid
    assert ps.validation_type == js.validation_type == "TrainValidationSplit"
    for a, b in zip(js.validation_results, ps.validation_results):
        assert abs(a["mean_metric"] - b["mean_metric"]) < 5e-3


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_workflow_runs_on_cuda_by_default_and_raises_without_it():
    rows = passengers(200)
    PU.reset_uids()
    y = PFB.RealNN("survived").as_response()
    vec = p_tm([PFB.Real("age").as_predictor()])
    pred = PBCMS.with_cross_validation(models_and_parameters=[
        (PLR(), [dict(LR_GRID[0])])]).set_input(
            y, PSC().set_input(y, vec).get_output()).get_output()
    with pytest.raises(RuntimeError, match="CUDA"):
        PWorkflow().set_reader(PList(rows)).set_result_features(pred).train()


def test_a_stage_given_its_own_device_keeps_it():
    rows = passengers(300)
    PU.reset_uids()
    y = PFB.RealNN("survived").as_response()
    vec = p_tm([PFB.Real("age").as_predictor(),
                PFB.PickList("sex").as_predictor()])
    checker = PSC(device="cpu")
    lr = PLR()
    pred = PBCMS.with_cross_validation(models_and_parameters=[
        (lr, [dict(LR_GRID[0])])]).set_input(
            y, checker.set_input(y, vec).get_output()).get_output()
    model = PWorkflow(device="cpu").set_reader(PList(rows)) \
        .set_result_features(pred).train()
    assert checker.device == "cpu" and lr.device == "cpu"
    assert all(st.device == "cpu" for st in model.stages
               if hasattr(st, "device") and st.get_torch_fn() is not None)


SPLIT_CASES = [(100, 0.1, 0.1, 1_000_000), (1000, 0.2, 0.1, 1_000_000),
               (1000, 0.1, 0.3, 1_000_000), (5000, 0.1, 0.05, 2000),
               (5000, 0.1, 0.4, 1000), (3000, 0.0, 0.2, 500)]


@pytest.mark.parametrize("n,reserve,pos_rate,max_train", SPLIT_CASES)
def test_splitter_draws_bit_for_bit(n, reserve, pos_rate, max_train):
    y = (np.random.default_rng(n).uniform(size=n) < pos_rate
         ).astype(np.float32)
    for J, P in ((JSp.Splitter, PSp.Splitter),
                 (JSp.DataSplitter, PSp.DataSplitter)):
        j, p = J(seed=3, reserve_test_fraction=reserve), \
            P(seed=3, reserve_test_fraction=reserve)
        for a, b in zip(j.split(n), p.split(n)):
            np.testing.assert_array_equal(a, b)
    j = JSp.DataBalancer(seed=3, reserve_test_fraction=reserve,
                         max_training_sample=max_train)
    p = PSp.DataBalancer(seed=3, reserve_test_fraction=reserve,
                         max_training_sample=max_train)
    jp, pp = j.prepare(y), p.prepare(y)
    np.testing.assert_array_equal(pp.indices, jp.indices)
    np.testing.assert_array_equal(pp.weights, jp.weights)
    assert pp.summary == jp.summary and p.save_args() == j.save_args()


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax and transmogrifai_tpu out of sys.modules; chip_smoke.py imports
    neither."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import transmogrifai_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, "
        "'transmogrifai_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'transmogrifai_tpu')"
        " or m.startswith(('jax.', 'jaxlib', 'transmogrifai_tpu.'))]\n"
        "need = {'transmogrifai_tpu_torch.' + m for m in ("
        "'dsl', 'transformers.math', 'transformers.misc', "
        "'transformers.text', 'ops.hashing', 'automl.vectorizers.text', "
        "'examples.op_titanic_simple')}\n"
        "print(len(names), bad, sorted(need - set(names)))\n"
        "sys.exit(1 if bad or need - set(names) or len(names) < 38 "
        "else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "transmogrifai_tpu"}, roots


@pytest.mark.parametrize("with_vector", [False, True])
def test_tensor_layer_matches_row_level_and_the_jax_layer(with_vector):
    """A layer's torch functions (run together on device tensors by the
    layer runner) give what each stage's row-level transform_value gives,
    and what the JAX package's fused layer program gives."""
    from transmogrifai_tpu.stages.base import JaxTransformer
    from transmogrifai_tpu.types import OPVector as JVec, Real as JReal
    from transmogrifai_tpu_torch.stages.base import TorchTransformer
    from transmogrifai_tpu_torch.types import OPVector as PVec, Real as PReal

    rows = passengers(300, seed=11)
    outs = {}
    for pkg, FB, U, Stage, Real, Vec, Workflow, List, kw in (
            ("jax", JFB, JU, JaxTransformer, JReal, JVec, JWorkflow, JList,
             {}),
            ("torch", PFB, PU, TorchTransformer, PReal, PVec, PWorkflow,
             PList, {"device": "cpu"})):
        U.reset_uids()
        age, fare = FB.Real("age").as_predictor(), FB.Real("fare").as_predictor()
        scaled = Stage("scale", fn=lambda a, f: a * 2.0 + f,
                       input_types=(Real, Real), output_type=Real) \
            .set_input(age, fare).get_output()
        results = [scaled]
        if with_vector:
            vec = (p_tm if pkg == "torch" else j_tm)([age, fare])
            results.append(Stage("half", fn=lambda v: v * 0.5,
                                 input_types=(Vec,), output_type=Vec)
                           .set_input(vec).get_output())
        model = Workflow(**kw).set_reader(List(rows)) \
            .set_result_features(*results).train()
        outs[pkg] = (model, results)
    (jm, jres), (pm, pres) = outs["jax"], outs["torch"]
    for jf, pf in zip(jres, pres):
        a = jm._train_data.data(jf.name)
        b = pm._train_data.data(pf.name)
        np.testing.assert_allclose(b, a, rtol=1e-6, equal_nan=True)
    st = next(s for s in pm.stages if s.operation_name == "scale")
    ds = pm._train_data
    for i in range(0, 300, 37):
        vals = [PReal(None if np.isnan(ds.data(n)[i]) else ds.data(n)[i])
                for n in st.input_names()]
        row = st.transform_value(*vals).value
        col = ds.data(st.output_name())[i]
        assert (row is None and np.isnan(col)) or \
            abs(row - col) <= 1e-5 * abs(col)
