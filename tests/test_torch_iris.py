"""The port's op_iris (transmogrifai_tpu_torch/examples/op_iris.py) against
the JAX package's examples/op_iris.py on the CPU, end to end: the
synthetic iris records through transmogrify, SanityChecker and the
MultiClassificationModelSelector (DataCutter, the multiclass error, 3-fold
CV over softmax logistic regression and random forests), then save/load of
the fitted workflow from one package into the other.

The example's random-forest grid reaches depth 12, which the port's plain
versions grow level by level over dense 4096-node levels (a minute on this
CPU); both packages here take the grid cut to depth {3, 6} and
min_info_gain 0.001 (4 grid points: depth x min_instances_per_node {10,
100}; with logistic regression's 8, 12 cells), each forest of 10 trees
instead of the default 50: the forests' 12 points of 50 trees took most
of the fixture here, and no assertion needs more than a few of them. The forests draw the
reference's bootstrap weights and node masks and the JAX package takes its
device route (TMOG_NO_HOST_TREES=1). Tolerances: the same vector columns
and SanityChecker drops, the same winner and grid, every fold metric within
5e-3, the scores within 1e-5; a saved model loaded in the other package
scores within 1e-5 of the model that was saved.
"""
import os
import sys

import numpy as np
import pytest

from transmogrifai_tpu.automl import selectors as JS
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow.io import load_model as j_load

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl import selectors as PS
from transmogrifai_tpu_torch.examples import op_iris as PI
from transmogrifai_tpu_torch.ops import trees as PT
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

from test_torch_tree_models import _ReferenceDraws

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from examples import op_iris as JI  # noqa: E402


RF_TREES = 10


def _cut_grid(module):
    full = module.default_grid_for

    def grid(name):
        g = full(name)
        if name == "OpRandomForestClassifier":
            g = [dict(p, num_trees=RF_TREES) for p in g
                 if p["max_depth"] <= 6 and p["min_info_gain"] == 0.001]
        return g
    return grid


@pytest.fixture(scope="module")
def iris(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMOG_NO_HOST_TREES", "1")
        mp.setattr(PT, "ForestDraws", lambda *a, **kw:
                   _ReferenceDraws(RF_TREES, *a, **kw))
        for module in (JS, PS):
            mp.setattr(module, "default_grid_for", _cut_grid(module))
        rows = PI.synthetic_iris()
        assert rows == JI.synthetic_iris()
        JU.reset_uids()
        jwf, jpred = JI.build_workflow()
        jmodel = jwf.set_reader(JList(rows)).train()
        PU.reset_uids()
        pwf, ppred = PI.build_workflow(device="cpu")
        pmodel = pwf.set_reader(PList(rows)).train()
    out = tmp_path_factory.mktemp("iris")
    jpath, ppath = str(out / "jax"), str(out / "port")
    jmodel.save(jpath)
    pmodel.save(ppath)
    return dict(jmodel=jmodel, pmodel=pmodel, jpred=jpred, ppred=ppred,
                rows=rows, jpath=jpath, ppath=ppath)


def _scores(model, pred):
    return np.asarray(model.score().data(pred.name), np.float64)


def test_op_iris_matches_jax(iris):
    jm, pm = iris["jmodel"], iris["pmodel"]
    assert iris["ppred"].name == iris["jpred"].name
    js, ps = jm.selector_summary(), pm.selector_summary()
    assert ps.problem_type == js.problem_type == "multiclass"
    assert ps.evaluation_metric == js.evaluation_metric == "error"
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name,
                                                  js.best_grid)
    assert len(ps.validation_results) == len(js.validation_results) == 12
    for a, b in zip(ps.validation_results, js.validation_results):
        assert (a["model_name"], a["grid"]) == (b["model_name"], b["grid"])
        for p, q in zip(a["fold_metrics"], b["fold_metrics"]):
            assert abs(p - q) <= 5e-3, (a, b)
    assert ps.data_prep_results == js.data_prep_results
    vec = next(st for st in pm.stages if type(st).__name__
               == "SanityCheckerModel").input_names()[1]
    assert np.array_equal(pm._train_data.data(vec), jm._train_data.data(vec))
    assert pm.sanity_checker_summary().dropped == \
        jm.sanity_checker_summary().dropped
    got, want = _scores(pm, iris["ppred"]), _scores(jm, iris["jpred"])
    assert got.shape == (len(iris["rows"]), 7)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for k, v in js.holdout_evaluation.items():
        if isinstance(v, float):
            assert abs(ps.holdout_evaluation[k] - v) <= 1e-6, k


def test_port_save_loads_in_jax(iris):
    loaded = j_load(iris["ppath"])
    got = np.asarray(loaded.set_reader(JList(iris["rows"])).score()
                     .data(iris["ppred"].name), np.float64)
    np.testing.assert_allclose(got, _scores(iris["pmodel"], iris["ppred"]),
                               rtol=0, atol=1e-5)


def test_jax_save_loads_in_port(iris):
    loaded = PWorkflow(device="cpu").load_model(iris["jpath"])
    got = np.asarray(loaded.set_reader(PList(iris["rows"])).score()
                     .data(iris["jpred"].name), np.float64)
    np.testing.assert_allclose(got, _scores(iris["jmodel"], iris["jpred"]),
                               rtol=0, atol=1e-5)


def test_op_titanic_mini_matches_jax():
    """The port's op_titanic_mini (features inferred from the rows, LR
    only) against the JAX package's flow of examples/op_titanic_mini.py:
    the same inferred features, winner and cells within 5e-3, the scores
    within 1e-5."""
    from examples.op_titanic_simple import synthetic_passengers as j_rows
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.automl import BinaryClassificationModelSelector
    from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
    from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
    from transmogrifai_tpu.workflow import Workflow as JWorkflow
    from transmogrifai_tpu_torch.examples import op_titanic_mini as PTM
    rows = PTM.synthetic_passengers()
    assert rows == j_rows()
    JU.reset_uids()
    survived, predictors = JFB.from_rows(rows, response="survived")
    checked = JSC(check_sample=1.0).set_input(
        survived, j_tm(predictors)).get_output()
    jpred = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, model_types=["OpLogisticRegression"],
    ).set_input(survived, checked).get_output()
    jm = JWorkflow().set_reader(JList(rows)).set_result_features(jpred) \
        .train()
    PU.reset_uids()
    pwf, ppred = PTM.build_workflow(rows, device="cpu")
    pm = pwf.set_reader(PList(rows)).train()
    assert [(f.name, f.type_name) for f in pm.raw_features()] == \
        [(f.name, f.type_name) for f in jm.raw_features()]
    js, ps = jm.selector_summary(), pm.selector_summary()
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name,
                                                  js.best_grid)
    for a, b in zip(ps.validation_results, js.validation_results):
        assert a["grid"] == b["grid"]
        assert abs(a["mean_metric"] - b["mean_metric"]) <= 5e-3
    np.testing.assert_allclose(_scores(pm, ppred), _scores(jm, jpred),
                               rtol=0, atol=1e-5)
