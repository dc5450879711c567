"""The port's example flow (transmogrifai_tpu_torch/examples/
op_titanic_simple.py) against the JAX package's (examples/
op_titanic_simple.py).

Both `build_workflow()`s are built after `reset_uids()` in each package
and trained on the CPU on the same seeded records:
- `synthetic_passengers(300)` with the default selector (logistic
  regression, train-validation split); its names are empty, so the Text
  feature takes SmartText's pivot route;
- 2 000 records in the Kaggle shapes (`chip_smoke.titanic_named_records`:
  names hash into 512 bins, high-cardinality tickets, mostly empty
  cabins, some non-ASCII names) with `reference_selector()` cut to
  logistic regression's most regularised default grid point (reg 0.2,
  elastic net 0.1) and a random forest of 10 trees at depth 5, which
  wins; the port's forests draw the reference's bootstrap weights and
  node masks (`test_torch_tree_models._ReferenceDraws`). One point of
  each family is all the assertions need: LR's 8 points (24 lanes over
  ~514 columns) would take most of a minute on one CPU thread.

Tolerances: the transmogrified matrix and its metadata identical; the
same SanityChecker drops for the same reasons; the same winner; every
sweep cell within 5e-3 (the contract of the Workflow entry's slice); the
scored probabilities of new records within 1e-5; the JAX-fitted workflow
carried over by `convert.workflow_model_from_jax` within 1e-5.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from examples import op_titanic_simple as JEX
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS, default_grid_for as j_grid
from transmogrifai_tpu.automl.tuning.splitters import \
    DataSplitter as JDataSplitter
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpRandomForestClassifier as JRF
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU

from torch_threads import one_torch_thread  # noqa: F401
import chip_smoke
from test_torch_tree_models import _ReferenceDraws
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl.selectors import \
    default_grid_for as p_grid
from transmogrifai_tpu_torch.examples import op_titanic_simple as PEX
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.models.trees import \
    OpRandomForestClassifier as PRF
from transmogrifai_tpu_torch.ops import trees as PT
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU

REPO = pathlib.Path(__file__).resolve().parents[1]
RF_CUT = [dict(max_depth=5, num_trees=10, min_instances_per_node=10)]


def lr_cut(grid):
    """Logistic regression's most regularised default grid point."""
    return [max(grid, key=lambda p: p["reg_param"])]


def jax_cut_selector():
    return JBCMS.with_cross_validation(
        num_folds=3, seed=42,
        splitter=JDataSplitter(seed=42, reserve_test_fraction=0.1),
        models_and_parameters=[
            (JLR(), lr_cut(j_grid("OpLogisticRegression"))),
            (JRF(), [dict(g) for g in RF_CUT])])


def port_cut_selector():
    return PEX.reference_selector(models_and_parameters=[
        (PLR(), lr_cut(p_grid("OpLogisticRegression"))),
        (PRF(), [dict(g) for g in RF_CUT])])


def _train(rows, jax_selector=None, port_selector=None):
    JU.reset_uids()
    jwf, jpred = JEX.build_workflow(jax_selector and jax_selector())
    jmodel = jwf.set_reader(JList(rows)).train()
    PU.reset_uids()
    pwf, ppred = PEX.build_workflow(port_selector and port_selector(),
                                    device="cpu")
    pmodel = pwf.set_reader(PList(rows)).train()
    return dict(jmodel=jmodel, jpred=jpred, pmodel=pmodel, ppred=ppred)


@pytest.fixture(scope="module")
def flows():
    mp = pytest.MonkeyPatch()
    mp.setenv("TMOG_NO_HOST_TREES", "1")
    mp.setattr(PT, "ForestDraws",
               lambda *a, **kw: _ReferenceDraws(10, *a, **kw))
    try:
        lr = _train(PEX.synthetic_passengers(300))
        lr["new"] = PEX.synthetic_passengers(200, seed=7)
        rf = _train(chip_smoke.titanic_named_records(2000, 21),
                    jax_cut_selector, port_cut_selector)
        rf["new"] = chip_smoke.titanic_named_records(400, 22)
    finally:
        mp.undo()
    return {"lr": lr, "rf": rf}


FLOWS = ["lr", "rf"]


def _vectors(model):
    return chip_smoke.vector_names(model)


@pytest.mark.parametrize("flow", FLOWS)
def test_matrix_and_metadata_identical(flows, flow):
    f = flows[flow]
    jvec, jchk = _vectors(f["jmodel"])
    pvec, pchk = _vectors(f["pmodel"])
    assert (pvec, pchk) == (jvec, jchk)
    for name in (jvec, jchk):
        a = f["jmodel"]._train_data.column(name)
        b = f["pmodel"]._train_data.column(name)
        assert b.data.dtype == a.data.dtype == np.float32
        assert a.data.tobytes() == b.data.tobytes(), name
        assert b.metadata.to_json() == a.metadata.to_json()


def test_the_named_flow_hashes_the_names(flows):
    pm = flows["rf"]["pmodel"]
    smart = next(s for s in pm.stages if type(s).__name__ == "SmartTextModel")
    assert [p["mode"] for p in smart.plans] == ["hash"]
    width = pm._train_data.data(_vectors(pm)[0]).shape[1]
    assert 512 < width <= 620, width
    lr = next(s for s in flows["lr"]["pmodel"].stages
              if type(s).__name__ == "SmartTextModel")
    assert [p["mode"] for p in lr.plans] == ["pivot"]


@pytest.mark.parametrize("flow", FLOWS)
def test_same_drops_for_the_same_reasons(flows, flow):
    js = flows[flow]["jmodel"].sanity_checker_summary()
    ps = flows[flow]["pmodel"].sanity_checker_summary()
    assert ps.names == js.names and ps.dropped == js.dropped
    assert list(ps.drop_reasons) == list(js.drop_reasons)
    assert ps.drop_reasons == js.drop_reasons


@pytest.mark.parametrize("flow", FLOWS)
def test_same_winner_and_cells(flows, flow):
    js = flows[flow]["jmodel"].selector_summary()
    ps = flows[flow]["pmodel"].selector_summary()
    assert (ps.best_model_name, ps.best_grid) == \
        (js.best_model_name, js.best_grid)
    assert len(ps.validation_results) == len(js.validation_results)
    for a, b in zip(js.validation_results, ps.validation_results):
        assert (a["model_name"], a["grid"]) == (b["model_name"], b["grid"])
        assert abs(a["mean_metric"] - b["mean_metric"]) < 5e-3, (a, b)
    assert flows[flow]["ppred"].name == flows[flow]["jpred"].name


def _probabilities(model, pred, reader, rows):
    ds = reader(rows).generate_dataset(model.raw_features())
    return model.score(ds).data(pred.name)


@pytest.mark.parametrize("flow", FLOWS)
def test_scores_within_1e5(flows, flow):
    f = flows[flow]
    j = _probabilities(f["jmodel"], f["jpred"], JList, f["new"])
    p = _probabilities(f["pmodel"], f["ppred"], PList, f["new"])
    assert p.shape == j.shape == (len(f["new"]), 5)
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("flow", FLOWS)
def test_summary_names_the_selected_model(flows, flow):
    text = flows[flow]["pmodel"].summary_pretty()
    best = flows[flow]["pmodel"].selector_summary().best_model_name
    assert f"Selected: {best}" in text
    assert "SanityChecker dropped" in text


@pytest.mark.parametrize("flow", FLOWS)
def test_jax_fitted_workflow_scores_within_1e5(flows, flow):
    f = flows[flow]
    PU.reset_uids()
    selector = port_cut_selector() if flow == "rf" else None
    _, ppred = PEX.build_workflow(selector, device="cpu")
    carried = convert.workflow_model_from_jax(
        [ppred], [convert.stage_state(st) for st in f["jmodel"].stages],
        device="cpu")
    j = _probabilities(f["jmodel"], f["jpred"], JList, f["new"])
    p = _probabilities(carried, ppred, PList, f["new"])
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-5)
    kinds = {type(st).__name__ for st in carried.stages}
    assert {"ZNormalizeModel", "FillMissingWithMeanModel", "SmartTextModel",
            "LambdaTransformer", "AddTransformer"} <= kinds


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is present")
def test_the_example_runs_on_cuda_unless_asked_and_raises_without_it():
    PU.reset_uids()
    wf, _ = PEX.build_workflow()
    with pytest.raises(RuntimeError, match="CUDA"):
        wf.set_reader(PList(PEX.synthetic_passengers(50))).train()
    with pytest.raises(RuntimeError, match="CUDA"):
        PEX.main([])


def test_the_example_imports_neither_jax_nor_the_jax_package():
    """The whole port imported and the example run on the CPU, in a fresh
    interpreter: sys.modules holds neither jax nor transmogrifai_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import transmogrifai_tpu_torch as P\n"
        "for m in pkgutil.walk_packages(P.__path__, "
        "'transmogrifai_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from transmogrifai_tpu_torch.examples import op_titanic_simple\n"
        "model = op_titanic_simple.main(['--device', 'cpu'])\n"
        "assert 'Selected:' in model.summary_pretty()\n"
        "bad = [m for m in sys.modules if m in ('jax', 'transmogrifai_tpu')"
        " or m.startswith(('jax.', 'jaxlib', 'transmogrifai_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "Selected: OpLogisticRegression" in out.stdout
