"""The text stages' device math on the card: LDA's EM, its fold-in and the
word2vec ALS on a CUDA device against the same functions on the CPU from
the same draws; OpLDA and OpWord2Vec fitted inside a CUDA workflow; a
text workflow trained on the card, saved and loaded on the CPU. Every test
needs a CUDA device and skips without one. This file imports neither jax
nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_text_gpu.py

Tolerances (f32 matmuls and Cholesky solves summed in another order on the
card; TF32 stays off, `device.resolve_device`): LDA's theta and beta
within 1e-4 of the CPU's relative to each entry or to the largest entry,
the fold-in within 1e-6 absolute, the ALS embeddings within 1e-4 of the
largest entry, a loaded workflow's probabilities within 1e-5.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.data.dataset import Column, Dataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
from transmogrifai_tpu_torch.models.prediction import probability_of
from transmogrifai_tpu_torch.ops import embeddings as E
from transmogrifai_tpu_torch.ops import lda as L
from transmogrifai_tpu_torch.utils.uid import reset_uids
from transmogrifai_tpu_torch.workflow import Workflow
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel

pytestmark = pytest.mark.gpu

LDA_RTOL = 1e-4
FOLD_ATOL = 1e-6
ALS_TOL = 1e-4
SCORE_TOL = 1e-5


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's run of the program)")


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("n,v,k", [(2000, 512, 10), (30000, 512, 10)])
def test_lda_on_the_card_matches_the_cpu(n, v, k):
    _need_cuda()
    rng = np.random.default_rng(n)
    C = rng.poisson(0.3, size=(n, v)).astype(np.float32)
    g = torch.Generator().manual_seed(1)
    theta0, beta0 = torch.rand((n, k), generator=g) + 0.5, \
        torch.rand((k, v), generator=g) + 0.5
    cpu = L.fit_lda(torch.as_tensor(C), theta0, beta0, n_iter=50)
    card = L.fit_lda(torch.as_tensor(C, device="cuda"), theta0.cuda(),
                     beta0.cuda(), n_iter=50)
    assert card[1].device.type == "cuda"
    for a, b in zip(card, cpu):
        _close(a.cpu(), b, LDA_RTOL)
    fold = L.lda_fold_in(torch.as_tensor(C, device="cuda"), cpu[1].cuda())
    np.testing.assert_allclose(
        fold.cpu().numpy(), L.lda_fold_in(torch.as_tensor(C), cpu[1]).numpy(),
        rtol=0, atol=FOLD_ATOL)


def test_als_on_the_card_matches_the_cpu():
    _need_cuda()
    cols = chip_smoke.ticket_columns(3000, 2)
    toks = [None if b is None else b.lower().split() for b in cols["body"][1]]
    C = E.cooccurrence_matrix(toks, 2048, window=5, seed=42)
    g = torch.Generator().manual_seed(42)
    W0, H0 = torch.randn((2048, 100), generator=g), \
        torch.randn((2048, 100), generator=g)
    cpu = E.factorize_embeddings(torch.as_tensor(C), W0, H0, n_iter=10)
    card = E.factorize_embeddings(torch.as_tensor(C, device="cuda"),
                                  W0.cuda(), H0.cuda(), n_iter=10)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=ALS_TOL * float(cpu.abs().max()))
    pooled = E.mean_pool_docs(toks, card)
    np.testing.assert_allclose(
        pooled.cpu().numpy(), E.mean_pool_docs(toks, card.cpu()).numpy(),
        rtol=0, atol=1e-6)


def _flow(cols, device):
    reset_uids()
    label, vec, feats = chip_smoke.text_features(
        FB, transmogrify, chip_smoke.product_labels(cols))
    pred = OpLogisticRegression(reg_param=0.01).set_input(label, vec) \
        .get_output()
    wf = Workflow(device=device).set_input_dataset(chip_smoke.wide_dataset(
        cols, Dataset, Column, PT)).set_result_features(pred)
    return wf.train(), pred, feats


def _probs(model, pred, cols):
    return probability_of(model.score(chip_smoke.wide_dataset(
        cols, Dataset, Column, PT)).column(pred.name))[:, 1]


@pytest.fixture(scope="module")
def flows():
    if not torch.cuda.is_available():
        return None
    cols = chip_smoke.ticket_columns(2000, 7)
    return cols, _flow(cols, "cpu"), _flow(cols, None)


def test_lda_and_word2vec_fit_in_a_cuda_workflow(flows):
    _need_cuda()
    cols, (cm, _, cf), (gm, _, gf) = flows
    by = {type(st).__name__: st for st in gm.stages}
    cpu = {type(st).__name__: st for st in cm.stages}
    assert by["OpLDAModel"].device is None        # the workflow's: CUDA
    _close(by["OpLDAModel"].beta, cpu["OpLDAModel"].beta, LDA_RTOL)
    np.testing.assert_allclose(
        by["OpWord2VecModel"].embeddings, cpu["OpWord2VecModel"].embeddings,
        rtol=0, atol=ALS_TOL * np.abs(cpu["OpWord2VecModel"].embeddings).max())
    # the host stages' outputs are the CPU run's, bit for bit
    for name in ("tfidf", "bigrams", "entities", "language"):
        a = cm._train_data.column(cf[name].name).data
        b = gm._train_data.column(gf[name].name).data
        assert (a.tobytes() == b.tobytes()) if a.dtype != object \
            else list(a) == list(b)


def test_card_trained_text_workflow_loads_on_the_cpu(flows, tmp_path):
    _need_cuda()
    cols, _, (gm, pred, _) = flows
    new = chip_smoke.ticket_columns(500, 8)
    want = _probs(gm, pred, new)
    gm.save(str(tmp_path / "m"))
    on_cpu = WorkflowModel.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_allclose(_probs(on_cpu, pred, new), want, rtol=0,
                               atol=SCORE_TOL)
    on_card = WorkflowModel.load(str(tmp_path / "m"))
    np.testing.assert_array_equal(_probs(on_card, pred, new), want)
