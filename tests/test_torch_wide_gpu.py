"""The wide flow (chip_smoke.wide_workflow: bench.py's wide schema with one
feature of each date, map, geolocation and structured text group) on the
card. Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_wide_gpu.py

20 000 rows (`chip_smoke.wide_columns`) through transmogrify ->
SanityChecker -> `chip_smoke.wide_selector(leg=True)` (logistic
regression's 2 least regularised default grid points, a forest of 5 trees
at depth 3, a GBT of 3 rounds at depth 3, 3 folds) -> Workflow().train()
-> score() on the card; the same rows transmogrified by
Workflow(device="cpu"). Tolerances: the transmogrified matrix and its
metadata bit-identical on both devices (host numpy); every kernel launched
on the card; the CPU run launches no kernel and allocates nothing on the
card.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.automl.transmogrifier import (
    TransmogrifierDefaults, transmogrify)
from transmogrifai_tpu_torch.data.dataset import Column, Dataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.utils.uid import reset_uids
from transmogrifai_tpu_torch.workflow import Workflow

pytestmark = pytest.mark.gpu
ROWS = 20_000


def _allocations() -> int:
    return torch.cuda.memory_stats().get("allocation.all.allocated", 0)


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cols = chip_smoke.wide_columns(ROWS, 41)
    new = chip_smoke.wide_columns(2_000, 42)
    reset_uids()
    wf, pred = chip_smoke.wide_workflow(cols, leg=True)
    TK.reset_launches()
    model = wf.train()
    card = dict(model=model, launches=dict(TK.launches),
                shape_launches=dict(TK.shape_launches),
                scored=chip_smoke.wide_scores(model, pred, new))
    # the CPU's transmogrified matrix of the same rows
    reset_uids()
    _, vec = chip_smoke.wide_vector(FeatureBuilder, transmogrify,
                                    TransmogrifierDefaults)
    TK.reset_launches()
    before = _allocations()
    cpu_model = Workflow(device="cpu").set_input_dataset(
        chip_smoke.wide_dataset(cols, Dataset, Column, T)) \
        .set_result_features(vec).train()
    cpu = dict(model=cpu_model, vec=vec, launches=dict(TK.launches),
               allocations=_allocations() - before)
    return card, cpu


def test_every_kernel_launches_on_the_card(runs):
    card, _ = runs
    assert set(card["launches"]) == set(TK.KERNELS)
    assert all(n > 0 for n in card["launches"].values()), card["launches"]
    assert any(n > 0 for k, n in card["shape_launches"].items()
               if k.startswith("route_hist") and not k.endswith(" S=1"))


def test_cpu_path_gives_the_same_matrix(runs):
    card, cpu = runs
    vec, _ = chip_smoke.vector_names(card["model"])
    assert vec == cpu["vec"].name
    a = card["model"]._train_data.column(vec)
    b = cpu["model"]._train_data.column(vec)
    assert a.data.shape[0] == ROWS and a.data.shape[1] > 600
    assert a.data.tobytes() == b.data.tobytes()
    assert a.metadata.to_json() == b.metadata.to_json()


def test_a_cpu_run_never_touches_the_card(runs):
    _, cpu = runs
    assert not any(cpu["launches"].values()), cpu["launches"]
    assert cpu["allocations"] == 0


def test_scores_are_finite_probabilities(runs):
    card, _ = runs
    p = card["scored"]
    assert p.shape == (2_000, 5) and np.isfinite(p).all()
    assert ((p[:, -1] >= 0) & (p[:, -1] <= 1)).all()
