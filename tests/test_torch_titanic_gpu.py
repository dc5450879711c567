"""The port's example flow (transmogrifai_tpu_torch/examples/
op_titanic_simple.py) on the card against the same flow on the CPU. Every
test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_titanic_gpu.py

2 000 records in the Kaggle shapes (`chip_smoke.titanic_named_records`:
hashed names, high-cardinality tickets, mostly empty cabins) through
`build_workflow(cut_selector())` (logistic regression's default grid,
random forests of 10 trees at depth {3, 5}, 3 folds, 10% holdout) on
each device. Tolerances: the transmogrified
matrix and its metadata bit-identical (host numpy, and f32 DSL math that
rounds alike on both devices); the same drops and winner; the scored
probabilities within 1e-5 a row or, where the refits split a node
differently, the first such node a tie within f32 noise
(`chip_smoke.split_witness`).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch.automl.selectors import default_grid_for
from transmogrifai_tpu_torch.examples import op_titanic_simple as EX
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.readers.readers import ListReader
from transmogrifai_tpu_torch.utils.uid import reset_uids

pytestmark = pytest.mark.gpu


def cut_selector():
    return EX.reference_selector(models_and_parameters=[
        (OpLogisticRegression(), default_grid_for("OpLogisticRegression")),
        (OpRandomForestClassifier(), [
            dict(max_depth=d, num_trees=10, min_instances_per_node=10)
            for d in (3, 5)])])


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rows = chip_smoke.titanic_named_records(2000, 31)
    new = chip_smoke.titanic_named_records(1000, 32)
    out = {}
    for dev in ("cpu", "cuda"):
        reset_uids()
        wf, pred = EX.build_workflow(cut_selector(), device=dev)
        TK.reset_launches()
        with chip_smoke.record_refit_levels([]) as levels:
            model = wf.set_reader(ListReader(rows)).train()
        launches = dict(TK.launches)
        scored = model.score(ListReader(new).generate_dataset(
            model.raw_features())).data(pred.name)
        out[dev] = dict(model=model, levels=levels, scored=scored,
                        launches=launches)
    return out


def test_the_card_run_launches_every_kernel(runs):
    assert all(n > 0 for n in runs["cuda"]["launches"].values()), \
        runs["cuda"]["launches"]
    assert not any(runs["cpu"]["launches"].values())


def test_matrix_and_metadata_identical(runs):
    c, g = runs["cpu"]["model"], runs["cuda"]["model"]
    for name in chip_smoke.vector_names(c):
        a, b = c._train_data.column(name), g._train_data.column(name)
        assert a.data.tobytes() == b.data.tobytes(), name
        assert a.metadata.to_json() == b.metadata.to_json()


def test_same_drops_and_winner(runs):
    c, g = runs["cpu"]["model"], runs["cuda"]["model"]
    cs, gs = c.sanity_checker_summary(), g.sanity_checker_summary()
    assert cs.dropped == gs.dropped and cs.drop_reasons == gs.drop_reasons
    a, b = c.selector_summary(), g.selector_summary()
    assert (a.best_model_name, a.best_grid) == \
        (b.best_model_name, b.best_grid)
    for x, y in zip(a.validation_results, b.validation_results):
        assert abs(x["mean_metric"] - y["mean_metric"]) < 5e-3


def test_scores_within_1e5_or_a_tie(runs):
    c, g = runs["cpu"], runs["cuda"]
    diff = np.abs(c["scored"] - g["scored"]).max()
    if diff <= 1e-5:
        return
    first = chip_smoke.first_divergence(c["levels"], g["levels"])
    assert first is not None, diff
    sel = c["model"].selector_summary()
    names = c["model"]._train_data.column(chip_smoke.vector_names(
        c["model"])[1]).metadata.column_names()
    w = chip_smoke.split_witness(c["levels"], g["levels"], *first,
                                 sel.best_grid.get("max_depth", 0), names)
    assert w["tie"], w
