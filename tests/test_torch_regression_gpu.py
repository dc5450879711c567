"""op_boston's flow with workflow-level CV on the card
(chip_smoke.regression_workflow over `housing_columns`: all 13 predictors,
transmogrify -> SanityChecker -> RegressionModelSelector over linear
regression, random forests and Spark GBT, Workflow.with_workflow_cv()).
Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_regression_gpu.py

4 000 rows trained on the card and on the CPU. Tolerances: the matrix and
its metadata bit-identical, the same winner, every workflow-CV fold metric
within 1e-3 relative or a tie at the first node that cell's fits split
differently, the scores within 1e-5 relative or a tie at the first node
the refits split differently (`chip_smoke.regression_runs_agree`); every
kernel launched on the card; a model saved from the card loads on the CPU
and one saved from the CPU loads on the card, each scoring within 1e-5
relative of the model that was saved, and a card model reloaded on the card
scores identically.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.workflow import WorkflowModel

pytestmark = pytest.mark.gpu
ROWS = 4_000


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cols = chip_smoke.housing_columns(ROWS, 51)
    new = chip_smoke.housing_columns(1_000, 52)
    TK.reset_launches()
    card = chip_smoke.regression_leg_run(cols, new, None)
    launches = dict(TK.launches)
    TK.reset_launches()
    cpu = chip_smoke.regression_leg_run(cols, new, "cpu")
    return dict(card=card, cpu=cpu, new=new, launches=launches,
                cpu_launches=dict(TK.launches))


def test_card_matches_cpu(runs):
    cmp = chip_smoke.compare_regression_runs(runs["cpu"], runs["card"])
    assert chip_smoke.regression_runs_agree(cmp), cmp
    assert cmp["cv_cells"] == 11


def test_every_kernel_launched_on_the_card_only(runs):
    assert set(runs["launches"]) == set(TK.KERNELS)
    assert all(n > 0 for n in runs["launches"].values())
    assert not any(runs["cpu_launches"].values())


@pytest.mark.parametrize("saved_on,loaded_on", [("card", "cpu"),
                                                ("cpu", "cuda"),
                                                ("card", "cuda")])
def test_save_on_one_device_load_on_the_other(runs, tmp_path, saved_on,
                                              loaded_on):
    run = runs[saved_on]
    path = str(tmp_path / "model")
    run["model"].save(path)
    loaded = WorkflowModel.load(path, device=loaded_on)
    got = chip_smoke.regression_scores(loaded, run["pred"], runs["new"])
    if (saved_on, loaded_on) == ("card", "cuda"):
        assert np.array_equal(got, run["scored"])
    else:
        assert chip_smoke.rel_diff(got, run["scored"]) <= 1e-5
