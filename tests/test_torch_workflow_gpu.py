"""The port's Workflow entry on the card against the same workflow on the
CPU. Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_workflow_gpu.py

Tolerances: the transmogrified matrix bit-identical (host numpy on both
sides); statistics within rtol 1e-5 / atol 1e-6 (f32 reductions in another
order; TF32 stays off), contingency tables exact; the same SanityChecker
decisions; the same winner (logistic regression), every sweep cell within
5e-3 and the scored probabilities within 1e-4 (the GLM solves' card
contract; measured 1.1e-5 at most).
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.automl.preparators import SanityChecker
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.device import record_copies
from transmogrifai_tpu_torch.features.builder import FeatureBuilder
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
from transmogrifai_tpu_torch.ops import stats_engine as SE
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.readers.readers import ListReader
from transmogrifai_tpu_torch.utils.uid import reset_uids
from transmogrifai_tpu_torch.workflow import Workflow


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def records(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        s = rng.normal()
        m = rng.uniform(size=3) < 0.1
        y = float(rng.uniform() < 1 / (1 + np.exp(-1.5 * s)))
        rows.append({
            "y": y, "s": None if m[0] else s,
            "big": 1e4 + rng.normal(), "k": None if m[1] else
            int(rng.poisson(2.0)), "b": bool(rng.uniform() < 0.4),
            "c": None if m[2] else str(rng.choice(["r", "g", "b"])),
            "t": {t for t in "xyz" if rng.uniform() < 0.3},
        })
    return rows


def fit_workflow(dev):
    reset_uids()
    y = FeatureBuilder.RealNN("y").as_response()
    vec = transmogrify([FeatureBuilder.Real("s").as_predictor(),
                        FeatureBuilder.Real("big").as_predictor(),
                        FeatureBuilder.Integral("k").as_predictor(),
                        FeatureBuilder.Binary("b").as_predictor(),
                        FeatureBuilder.PickList("c").as_predictor(),
                        FeatureBuilder.MultiPickList("t").as_predictor()])
    checked = SanityChecker(remove_bad_features=True).set_input(
        y, vec).get_output()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=[
            (OpLogisticRegression(), [{"reg_param": r} for r in
                                      (0.001, 0.1)]),
            (OpXGBoostClassifier(), [dict(max_depth=d, eta=0.3, num_round=4,
                                          max_bins=32) for d in (2, 4)])])
    pred = sel.set_input(y, checked).get_output()
    model = Workflow(device=dev).set_reader(ListReader(records())) \
        .set_result_features(pred).train()
    return model, pred, vec


@pytest.mark.gpu
def test_workflow_on_the_card_matches_the_cpu(cuda_device):
    cm, cpred, cvec = fit_workflow("cpu")
    TK.reset_launches()
    gm, gpred, gvec = fit_workflow(None)                 # the default: CUDA
    assert all(n > 0 for n in TK.launches.values()), TK.launches
    assert gm._train_data.data(gvec.name).tobytes() == \
        cm._train_data.data(cvec.name).tobytes()
    cs, gs = cm.sanity_checker_summary(), gm.sanity_checker_summary()
    assert gs.dropped == cs.dropped and gs.drop_reasons.keys() == \
        cs.drop_reasons.keys()
    csel, gsel = cm.selector_summary(), gm.selector_summary()
    assert gsel.best_grid == csel.best_grid
    for a, b in zip(csel.validation_results, gsel.validation_results):
        assert abs(a["mean_metric"] - b["mean_metric"]) < 5e-3
    new = records(500, seed=9)
    cp = cm.score(ListReader(new).generate_dataset(cm.raw_features()))
    gp = gm.score(ListReader(new).generate_dataset(gm.raw_features()))
    # the winner is logistic regression: its Newton solves agree to ~1e-5
    # on the two devices (f32 sums in another order, tol 1e-6)
    np.testing.assert_allclose(gp.data(gpred.name), cp.data(cpred.name),
                               rtol=0, atol=1e-4)
    assert gsel.best_model_name == "OpLogisticRegression"


@pytest.mark.gpu
@pytest.mark.parametrize("route,tile_rows", [("fused", None),
                                             ("streamed", 1000)])
def test_stats_engine_on_the_card_matches_the_cpu(cuda_device, route,
                                                  tile_rows):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(20000, 12)).astype(np.float32)
    X[:, 1] += 1e4
    X[:, 2] = rng.uniform(size=20000) < 0.3
    X[rng.uniform(size=20000) < 0.1, 4] = np.nan
    y = (rng.uniform(size=20000) < 0.4).astype(np.float32)
    kw = dict(distinct=np.unique(y), corr_matrix=True, driver=route,
              tile_rows=tile_rows)
    want = SE.run_stats(X, y, device="cpu", **kw)
    with record_copies() as rec:
        got = SE.run_stats(X, y, device="cuda", **kw)
    assert rec.copies and all(c["bytes"] > 0 and c["seconds"] > 0
                              for c in rec.copies)
    for k in ("count", "num_non_zeros", "min", "max", "contingency"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    for k in ("mean", "variance", "corr_label", "corr_matrix",
              "label_mean", "label_variance"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.gpu
def test_spearman_ranks_on_the_card(cuda_device):
    rng = np.random.default_rng(4)
    X = rng.integers(0, 6, size=(5000, 5)).astype(np.float32)
    X[rng.uniform(size=5000) < 0.1, 2] = np.nan
    y = (rng.uniform(size=5000) < 0.5).astype(np.float32)
    crx, cry = SE.rank_matrices(X, y, device="cpu")
    grx, gry = SE.rank_matrices(X, y, device="cuda")
    np.testing.assert_array_equal(grx.cpu().numpy(), crx.numpy())
    np.testing.assert_array_equal(gry.cpu().numpy(), cry.numpy())
