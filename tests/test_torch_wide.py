"""The wide schema (chip_smoke.wide_columns: bench.py's make_wide_rows
columns and one feature of each date, map, geolocation and structured text
group) through the whole flow, the port on the CPU against the JAX package.

transmogrify -> SanityChecker -> a 3-fold selector over logistic
regression's 2 grid points -> Workflow.train() -> score(), on 2 000 rows in
each package, after `reset_uids()` in each. Tolerances: the transmogrified
matrix bit-identical and its metadata identical; the same columns dropped
for the same reasons; the same winner; every cell's mean fold AuPR within
5e-3; scores within 1e-5; the JAX-fitted workflow carried across by
convert.workflow_model_from_jax scores within 1e-5 of the JAX package.
"""
import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
import chip_smoke as CS

from transmogrifai_tpu import types as JT
from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import (
    TransmogrifierDefaults as JDefaults, transmogrify as j_tm)
from transmogrifai_tpu.data.dataset import Column as JColumn
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import (
    TransmogrifierDefaults as PDefaults, transmogrify as p_tm)
from transmogrifai_tpu_torch.data.dataset import Column as PColumn
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

ROWS = 2_000
LR_GRID = [{"reg_param": 0.01, "elastic_net_param": 0.0},
           {"reg_param": 0.1, "elastic_net_param": 0.5}]
JAX = (JFB, JU, j_tm, JDefaults, JSC, JBCMS, JLR, JDataset, JColumn, JT)
PORT = (PFB, PU, p_tm, PDefaults, PSC, PBCMS, PLR, PDataset, PColumn, PT)


def build(pkg, dev=None):
    """(label, vector, checked vector, prediction) of the wide flow."""
    FB, U, tm, Defaults, SC, BCMS, LR = pkg[:7]
    U.reset_uids()
    label, vec = CS.wide_vector(FB, tm, Defaults)
    checked = SC().set_input(label, vec).get_output()
    kw = {} if dev is None else {"device": dev}
    selector = BCMS.with_cross_validation(
        num_folds=3, seed=42,
        models_and_parameters=[(LR(**kw), [dict(g) for g in LR_GRID])])
    return label, vec, checked, selector.set_input(label, checked) \
        .get_output()


def dataset(pkg, cols):
    return CS.wide_dataset(cols, *pkg[7:])


@pytest.fixture(scope="module")
def fitted():
    cols = CS.wide_columns(ROWS, 21)
    new = CS.wide_columns(500, 22)
    out = {}
    for name, pkg, wf in (("jax", JAX, JWorkflow()),
                          ("port", PORT, PWorkflow(device="cpu"))):
        *_, vec, checked, pred = build(pkg)
        model = wf.set_input_dataset(dataset(pkg, cols)) \
            .set_result_features(pred).train()
        scored = model.score(dataset(pkg, new)).data(pred.name)
        out[name] = dict(model=model, vec=vec, checked=checked, pred=pred,
                         scored=scored)
    out["new"] = new
    return out


def test_matrix_and_metadata_identical(fitted):
    j, p = fitted["jax"], fitted["port"]
    assert j["vec"].name == p["vec"].name
    a = j["model"]._train_data.column(j["vec"].name)
    b = p["model"]._train_data.column(p["vec"].name)
    assert b.data.dtype == np.float32 and b.data.shape == a.data.shape
    # 20 distinct texts at 2 000 rows: txt pivots here (it hashes into 512
    # bins at the main path's million rows)
    assert b.data.shape[1] > 150
    assert b.data.tobytes() == a.data.tobytes()
    assert b.metadata.to_json() == a.metadata.to_json()


def test_same_drops_for_the_same_reasons(fitted):
    a = fitted["jax"]["model"].sanity_checker_summary()
    b = fitted["port"]["model"].sanity_checker_summary()
    assert b.names == a.names and b.dropped == a.dropped
    assert list(b.drop_reasons) == list(a.drop_reasons)
    # the new groups carry signal: some of their columns are kept
    kept = set(b.names) - set(b.dropped)
    assert any(n.startswith(("email", "phone", "dt_", "mp_")) for n in kept)


def test_same_winner_and_cells(fitted):
    a = fitted["jax"]["model"].selector_summary()
    b = fitted["port"]["model"].selector_summary()
    assert (b.best_model_name, b.best_grid) == (a.best_model_name,
                                                a.best_grid)
    for x, y in zip(a.validation_results, b.validation_results):
        assert (x["model_name"], x["grid"]) == (y["model_name"], y["grid"])
        assert abs(x["mean_metric"] - y["mean_metric"]) < 5e-3, (x, y)


def test_scores_within_1e5(fitted):
    a, b = fitted["jax"]["scored"], fitted["port"]["scored"]
    assert b.shape == a.shape == (500, 5)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def test_jax_fitted_workflow_scores_within_1e5(fitted):
    j = fitted["jax"]
    *_, pred = build(PORT, "cpu")
    carried = convert.workflow_model_from_jax(
        [pred], [convert.stage_state(st) for st in j["model"].stages],
        device="cpu")
    scored = carried.score(dataset(PORT, fitted["new"])).data(pred.name)
    np.testing.assert_allclose(scored, j["scored"], rtol=0, atol=1e-5)
