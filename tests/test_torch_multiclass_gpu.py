"""Multiclass on the card: the histogram kernels at any channel count and
the Covertype-shaped flow (chip_smoke.multiclass_workflow over
`covertype_columns`: transmogrify -> SanityChecker ->
MultiClassificationModelSelector over softmax logistic regression, random
forests, softmax XGBoost and naive Bayes). Every test here needs a CUDA
device and skips without one. This file imports neither jax nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_multiclass_gpu.py

Tolerances: the histograms of every path (rows, private, owned) at C = 5,
9, 12 and 102 channels a lane within rtol 1e-5 / atol 1e-4 of the plain
version (f32 sums in another order), the counts and new node ids exact,
one launch a call whatever the channel count. The flow at 3 000 rows on
the card and on the CPU: the matrix identical, the same winner, every CV
fold metric within 1e-3 or a tie at the first node that cell's fold lanes
split differently (the MLP's within `chip_smoke.MLP_FOLD_TOL`), the scores within 1e-5 relative or a tie in the refit
(`chip_smoke.regression_runs_agree`); a model saved on either device loads
on the other and scores within 1e-5 relative.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.workflow import WorkflowModel

pytestmark = pytest.mark.gpu
ROWS = 3_000


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(name, F, S, Fo, Co, N=3001, B=33, seed=5):
    """One launch's inputs with Co - 1 payload channels a lane (the last a
    weight, 20% zero) and the derived count: bins and slots partly out of
    range (hist_folds)."""
    rng = np.random.default_rng(seed + Co)
    C = Co - 1
    Xb_t = rng.integers(-2, B + 2, size=(F, N)).astype(np.int8)
    pay = rng.normal(size=(Fo, C, N)).astype(np.float32)
    pay[:, C - 1] = np.where(rng.uniform(size=(Fo, N)) < 0.2, 0.0,
                             np.abs(pay[:, C - 1]) + 0.1)
    kw = dict(n_bins=B, derive_count=True)
    pay = pay.reshape(Fo * C, N)
    if name == "hist_folds":
        slot = rng.integers(-1, S + 2, size=(Fo, N)).astype(np.float32)
        return (Xb_t, pay, slot), dict(kw, n_slots=S)
    node = rng.integers(0, S, size=(Fo, N)).astype(np.float32)
    tables = [rng.integers(0, hi, size=(Fo, S)).astype(np.int32)
              for hi in (F, B, 2)]
    return (Xb_t, pay, node, *tables), dict(kw, n_nodes=S)


# (path, F, S) shapes each path fits at 4 channels a kernel lane
PATH_SHAPES = [("rows", 7, 4), ("private", 32, 1), ("owned", 64, 4)]


@pytest.mark.parametrize("Co", [5, 9, 12, 102])
@pytest.mark.parametrize("path,F,S", PATH_SHAPES)
@pytest.mark.parametrize("name", ["hist_folds", "route_hist"])
def test_any_channel_count_matches_plain(cuda_device, name, path, F, S, Co):
    args, kw = _case(name, F, S, 3, Co)
    cpu = TK.PLAIN[name](*[torch.from_numpy(a) for a in args], **kw)
    before = TK.launches[name]
    got = getattr(TK, name)(*[torch.from_numpy(a).to(cuda_device)
                              for a in args], **kw, path=path)
    torch.cuda.synchronize()
    assert TK.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    hist, want = got[0].cpu().numpy(), cpu[0].numpy()
    assert hist.shape == want.shape == (3 * S * Co, F * 33)
    np.testing.assert_allclose(hist, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        hist.reshape(-1, Co, hist.shape[1])[:, Co - 1],
        want.reshape(-1, Co, want.shape[1])[:, Co - 1])
    if name == "route_hist":
        np.testing.assert_array_equal(got[1].cpu().numpy(), cpu[1].numpy())


@pytest.fixture(scope="module")
def runs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cols = chip_smoke.covertype_columns(ROWS, 61)
    new = chip_smoke.covertype_columns(1_000, 62)
    TK.reset_launches()
    card = chip_smoke.multiclass_leg_run(cols, new, None)
    launches = dict(TK.launches)
    TK.reset_launches()
    cpu = chip_smoke.multiclass_leg_run(cols, new, "cpu")
    return dict(card=card, cpu=cpu, new=new, launches=launches,
                cpu_launches=dict(TK.launches))


def test_covertype_flow_card_matches_cpu(runs):
    cmp = chip_smoke.compare_regression_runs(runs["cpu"], runs["card"],
                                             workflow_cv=False, n_folds=3)
    assert chip_smoke.regression_runs_agree(cmp), cmp
    assert cmp["cv_cells"] == 14      # 12 + the MLP's random grid
    assert set(np.unique(runs["card"]["scored"][:, 0])) <= set(range(1, 8))


def test_covertype_kernels_launched_on_the_card_only(runs):
    assert set(runs["launches"]) == set(TK.KERNELS)
    assert all(n > 0 for n in runs["launches"].values())
    assert not any(runs["cpu_launches"].values())


@pytest.mark.parametrize("saved_on,loaded_on", [("card", "cpu"),
                                                ("cpu", "cuda")])
def test_covertype_model_loads_on_the_other_device(runs, tmp_path, saved_on,
                                                   loaded_on):
    run = runs[saved_on]
    path = str(tmp_path / "model")
    run["model"].save(path)
    loaded = WorkflowModel.load(path, device=loaded_on)
    got = chip_smoke.multiclass_scores(loaded, run["pred"], runs["new"])
    assert chip_smoke.rel_diff(got, run["scored"]) <= 1e-5
