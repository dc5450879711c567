"""LDA topics and word2vec embeddings of the port against the JAX package
on the CPU (tests/test_topics_ner.py's LDA and word2vec cases and the
embedding-cluster case of tests/test_ner_embedding_quality.py), and a text
workflow saved by each package and loaded by the other.

The JAX package draws its initial factors with `jax.random`; the port's
functions take them as tensors. Fed the JAX package's own draws (the test
computes `jax.random.split` / `uniform` / `normal` of the same key):
`fit_lda`'s theta and beta within rtol 1e-4 (measured: up to 5e-5 after
50 EM iterations: the JAX package iterates in float32, the port in
float64), `lda_fold_in` within 1e-6 absolute (measured 9e-8),
`factorize_embeddings` within 1e-4 of the largest entry (measured: 2.4e-6
to 1e-5 after 10 ALS iterations, the JAX package's float32 Cholesky
solves against the port's float64 ones). The
windowed co-occurrence counts, the hashed token ids and the mean pooling
are identical. The stages' own draws (a CPU torch.Generator seeded by
`seed`) differ from JAX's, so the stage-level cases are the reference's
quality gates on the port's fits; the text workflow carried across in
either direction scores within 1e-5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.automl.transmogrifier import \
    TransmogrifierDefaults as JDefaults
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.data.dataset import Column as JColumn
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.ops import embeddings as JE
from transmogrifai_tpu.ops import lda as JL
from transmogrifai_tpu.transformers import topics as JTop
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.io import load_model as j_load
import transmogrifai_tpu.data.dataset as JD
import transmogrifai_tpu.types as JT

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.transmogrifier import \
    TransmogrifierDefaults as PDefaults
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.data.dataset import Column as PColumn
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.data.dataset import column_from_values
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.ops import embeddings as PE
from transmogrifai_tpu_torch.ops import lda as PL
from transmogrifai_tpu_torch.stages.registry import build_stage
from transmogrifai_tpu_torch.transformers.topics import (
    OpLDA, OpLDAModel, OpWord2Vec, OpWord2VecModel)
from transmogrifai_tpu_torch.types import OPVector, TextList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM
import transmogrifai_tpu_torch.types as PT

LDA_RTOL = 1e-4
FOLD_ATOL = 1e-6
ALS_TOL = 1e-4      # of the largest |entry|
SCORE_TOL = 1e-5


def _topic_corpus(rng, n=120, v=30):
    """Two planted topics over disjoint vocab halves."""
    C = np.zeros((n, v), np.float32)
    for i in range(n):
        half = (0, v // 2) if i % 2 == 0 else (v // 2, v)
        np.add.at(C[i], rng.integers(half[0], half[1], size=40), 1.0)
    return C


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("n,v,k,iters,seed", [(200, 64, 10, 50, 7)])
def test_fit_lda_matches_jax_from_its_draws(n, v, k, iters, seed):
    rng = np.random.default_rng(seed)
    C = _topic_corpus(rng, n, v)
    C[rng.uniform(size=C.shape) < 0.05] += 3.0
    key = jax.random.PRNGKey(seed)
    j_theta, j_beta = JL.fit_lda(C, key, n_topics=k, n_iter=iters)
    k1, k2 = jax.random.split(key)
    theta0 = jax.random.uniform(k1, (n, k), minval=0.5, maxval=1.5)
    beta0 = jax.random.uniform(k2, (k, v), minval=0.5, maxval=1.5)
    p_theta, p_beta = PL.fit_lda(_t(C), _t(theta0), _t(beta0), n_iter=iters)
    np.testing.assert_allclose(p_theta.numpy(), np.asarray(j_theta),
                               rtol=LDA_RTOL, atol=1e-7)
    np.testing.assert_allclose(p_beta.numpy(), np.asarray(j_beta),
                               rtol=LDA_RTOL, atol=1e-7)
    fold_j = JL.lda_fold_in(C, j_beta)
    fold_p = PL.lda_fold_in(_t(C), _t(j_beta))
    np.testing.assert_allclose(fold_p.numpy(), np.asarray(fold_j), rtol=0,
                               atol=FOLD_ATOL)


def _family_docs(rng, n_words, n_docs=600, groups=4):
    words = [f"w{i}" for i in range(n_words)]
    size = n_words // groups
    return [list(rng.choice(words[(j % groups) * size:(j % groups + 1)
                                  * size], size=int(rng.integers(3, 15))))
            for j in range(n_docs)]


@pytest.mark.parametrize("n_words,V,dim,iters", [
    (200, 256, 16, 10), (60, 64, 8, 3)])
def test_factorize_embeddings_matches_jax_from_its_draws(n_words, V, dim,
                                                         iters):
    docs = _family_docs(np.random.default_rng(n_words), n_words)
    C = JE.cooccurrence_matrix(docs, V, window=5)
    key = jax.random.PRNGKey(iters)
    want = np.asarray(JE.factorize_embeddings(C, key, dim=dim,
                                              n_iter=iters))
    k1, k2 = jax.random.split(key)
    W0 = jax.random.normal(k1, (V, dim), jnp.float32)
    H0 = jax.random.normal(k2, (V, dim), jnp.float32)
    got = PE.factorize_embeddings(_t(C), _t(W0), _t(H0),
                                  n_iter=iters).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ALS_TOL * np.abs(want).max())


@pytest.mark.parametrize("window", [1, 3, 5, 12])
def test_cooccurrence_counts_and_hashed_ids_identical(window):
    rng = np.random.default_rng(window)
    vocab = ["flour", "sugar", "oven", "piston", "gear", "é", "ß", "東京",
             "x\ud800", "it's", ""]
    docs = [list(rng.choice(vocab, size=int(rng.integers(0, 9))))
            for _ in range(300)] + [None, [], ["solo"], ["a", "a"]]
    for V, seed in ((64, 0), (2048, 42)):
        j = JE.cooccurrence_matrix(docs, V, window=window, seed=seed)
        p = PE.cooccurrence_matrix(docs, V, window=window, seed=seed)
        assert p.dtype == j.dtype == np.float32
        assert p.tobytes() == j.tobytes()
        flat = [t for d in docs if d for t in d]
        np.testing.assert_array_equal(PE.hash_token_ids(flat, V, seed),
                                      JE.hash_token_ids(flat, V, seed))


def test_mean_pool_docs_identical():
    rng = np.random.default_rng(1)
    docs = [list(rng.choice(["a", "b", "c", "d", "é"],
                            size=int(rng.integers(0, 30))))
            for _ in range(200)] + [None, []]
    emb = rng.normal(size=(64, 7)).astype(np.float32)
    want = JE.mean_pool_docs(docs, emb, seed=3)
    got = PE.mean_pool_docs(docs, _t(emb), seed=3).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


# -- the stages on their own draws: the reference's quality gates ----------

def _vec_col(C):
    return column_from_values(OPVector, [OPVector(r) for r in C])


def _on_cpu(stage):
    stage.device = "cpu"
    return stage


def test_lda_recovers_planted_topics(rng):
    C = _topic_corpus(rng)
    col = _vec_col(C)
    model = _on_cpu(OpLDA(k=2, max_iter=80, seed=0)).fit_columns(col)
    model.device = "cpu"
    theta = model.transform_block([col])
    assert theta.shape == (len(C), 2)
    assert np.allclose(theta.sum(axis=1), 1.0, atol=1e-4)
    even, odd = theta[::2].mean(axis=0), theta[1::2].mean(axis=0)
    assert even.argmax() != odd.argmax()
    assert even.max() > 0.8 and odd.max() > 0.8
    # transforming the training docs twice gives the same assignment
    np.testing.assert_array_equal(model.transform_block([col]), theta)


def test_lda_draws_are_the_seed_s_and_save_load_round_trips(rng):
    C = _topic_corpus(rng, n=40)
    col = _vec_col(C)
    # one EM step from the seed's draws: the same seed the same topics,
    # another seed others
    first = [_on_cpu(OpLDA(k=2, max_iter=1, seed=seed)).fit_columns(col)
             for seed in (5, 5, 6)]
    assert first[0].beta.tobytes() == first[1].beta.tobytes()
    assert first[0].beta.tobytes() != first[2].beta.tobytes()
    a = _on_cpu(OpLDA(k=2, max_iter=30, seed=5)).fit_columns(col)
    rebuilt = build_stage(type(a).__name__, a.save_args(), device="cpu")
    np.testing.assert_array_equal(rebuilt.beta, a.beta)
    a.device = "cpu"
    np.testing.assert_array_equal(rebuilt.transform_block([col]),
                                  a.transform_block([col]))
    assert [m.descriptor_value for m in a.output_metadata().columns] == \
        ["topic_0", "topic_1"]


def test_jax_fitted_lda_carried_across_folds_in_alike(rng):
    C = _topic_corpus(rng, n=60)
    jm = JTop.OpLDA(k=3, max_iter=30, seed=1).fit_columns(
        JD.column_from_values(JT.OPVector, [JT.OPVector(r) for r in C]))
    pm = build_stage("OpLDAModel", jm.save_args(), device="cpu")
    assert isinstance(pm, OpLDAModel) and pm.alpha == jm.alpha
    np.testing.assert_allclose(
        pm.transform_block([_vec_col(C)]),
        jm.transform_block([JD.column_from_values(
            JT.OPVector, [JT.OPVector(r) for r in C])]),
        rtol=0, atol=FOLD_ATOL)
    assert sorted(pm.save_args()) == sorted(jm.save_args())


def test_word2vec_cooccurring_words_embed_nearby():
    docs_a = [["cat", "dog", "pet", "fur"] for _ in range(40)]
    docs_b = [["stock", "bond", "yield", "market"] for _ in range(40)]
    docs = [d for pair in zip(docs_a, docs_b) for d in pair]
    model = _on_cpu(OpWord2Vec(vector_size=8, vocab_bins=256, seed=1,
                               num_iterations=15)).fit_columns(
        column_from_values(TextList, docs))
    model.device = "cpu"

    def vec(w):
        return model.transform_block([column_from_values(TextList,
                                                         [[w]])])[0]

    def cos(u, w):
        return float(u @ w / (np.linalg.norm(u) * np.linalg.norm(w) + 1e-12))
    assert cos(vec("cat"), vec("dog")) > cos(vec("cat"), vec("stock"))


def test_word2vec_doc_embedding_is_word_mean_and_empty_is_zero():
    docs = [["a", "b"], ["a"], [], None]
    col = column_from_values(TextList, docs)
    model = _on_cpu(OpWord2Vec(vector_size=4, vocab_bins=64, seed=0,
                               num_iterations=3)).fit_columns(col)
    model.device = "cpu"
    out = model.transform_block([col])
    assert out.shape == (4, 4)
    va = model.transform_block([column_from_values(TextList, [["a"]])])[0]
    vb = model.transform_block([column_from_values(TextList, [["b"]])])[0]
    np.testing.assert_allclose(out[0], (va + vb) / 2, atol=1e-6)
    np.testing.assert_allclose(out[2], 0.0)
    np.testing.assert_allclose(out[3], 0.0)
    rebuilt = build_stage(type(model).__name__, model.save_args(),
                          device="cpu")
    assert isinstance(rebuilt, OpWord2VecModel)
    np.testing.assert_array_equal(rebuilt.embeddings, model.embeddings)
    assert rebuilt.seed == 0
    assert model.output_metadata().columns[3].descriptor_value == "dim_3"


def test_embedding_clusters_separate():
    """The port's ALS on its own draws: words that co-occur within a topic
    are closer than words across topics (the reference's margin 0.3)."""
    rng = np.random.default_rng(0)
    cooking = ["flour", "sugar", "butter", "oven", "bake", "dough"]
    engines = ["piston", "torque", "diesel", "engine", "gear", "clutch"]
    docs = [list(rng.choice(cooking if rng.uniform() < 0.5 else engines,
                            size=4)) for _ in range(300)]
    V = 256
    C = PE.cooccurrence_matrix(docs, V, window=3)
    g = torch.Generator().manual_seed(0)
    W0, H0 = torch.randn((V, 16), generator=g), \
        torch.randn((V, 16), generator=g)
    emb = PE.factorize_embeddings(torch.as_tensor(C), W0, H0,
                                  n_iter=10).numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)

    def vec(word):
        return emb[PE.hash_token_ids([word], V)[0]]

    def mean_cos(pairs):
        return float(np.mean([vec(a) @ vec(b) for a, b in pairs]))
    intra = mean_cos([(a, b) for a in cooking for b in cooking if a != b]
                     + [(a, b) for a in engines for b in engines if a != b])
    inter = mean_cos([(a, b) for a in cooking for b in engines])
    assert intra - inter > 0.3, (intra, inter)


# -- a text workflow saved by each package, loaded by the other -------------

def _text_flow(pkg, cols):
    """(workflow, prediction) of chip_smoke's ticket flow (LDA, word2vec,
    TF-IDF, NER, the indexer and the rest; narrow counts, vectors and
    bigram hashes) into a logistic regression, in package `pkg`."""
    if pkg == "jax":
        FB, tm, Defaults, Dataset, Column, T, LR, wf = (
            JFB, j_tm, JDefaults, JDataset, JColumn, JT, JLR, JWorkflow())
    else:
        FB, tm, Defaults, Dataset, Column, T, LR, wf = (
            PFB, p_tm, PDefaults, PDataset, PColumn, PT, PLR,
            PWorkflow(device="cpu"))
    label, vec, _ = chip_smoke.text_features(
        FB, functools.partial(tm, defaults=Defaults(
            default_num_of_features=64)),
        chip_smoke.product_labels(cols), vocab_size=40, vector_size=8,
        vocab_bins=128)
    pred = LR(reg_param=0.01).set_input(label, vec).get_output()
    wf.set_input_dataset(chip_smoke.wide_dataset(cols, Dataset, Column, T)) \
        .set_result_features(pred)
    return wf, pred


def _probs(model, pred, cols, Dataset, Column, T):
    from transmogrifai_tpu_torch.models.prediction import probability_of
    col = model.score(chip_smoke.wide_dataset(cols, Dataset, Column, T)) \
        .column(pred.name)
    return probability_of(col)[:, 1]


@pytest.fixture(scope="module")
def text_flows():
    cols = chip_smoke.ticket_columns(300, 3)
    out = {}
    for pkg, U in (("jax", JU), ("torch", PU)):
        U.reset_uids()
        wf, pred = _text_flow(pkg, cols)
        out[pkg] = (wf.train(), pred)
    return cols, out


def test_text_workflow_saved_by_each_loads_in_the_other(text_flows,
                                                        tmp_path):
    cols, flows = text_flows
    new = chip_smoke.ticket_columns(150, 4)
    (jm, jpred), (pm, ppred) = flows["jax"], flows["torch"]
    names = {type(st).__name__ for st in pm.stages}
    assert {"OpLDAModel", "OpWord2VecModel", "OpCountVectorizerModel",
            "NameEntityRecognizer", "OpStringIndexerModel",
            "OpIndexToString"} <= names
    jpath, ppath = str(tmp_path / "jax"), str(tmp_path / "port")
    jm.save(jpath)
    pm.save(ppath)
    j_own = _probs(jm, jpred, new, JDataset, JColumn, JT)
    p_own = _probs(pm, ppred, new, PDataset, PColumn, PT)
    # the JAX package's save in the port: its scores
    loaded = PWM.load(jpath, device="cpu")
    np.testing.assert_allclose(
        _probs(loaded, ppred, new, PDataset, PColumn, PT), j_own,
        rtol=0, atol=SCORE_TOL)
    # the port's save in the JAX package: the port's scores
    np.testing.assert_allclose(
        _probs(j_load(ppath), jpred, new, JDataset, JColumn, JT), p_own,
        rtol=0, atol=SCORE_TOL)
    # the port's save in the port: identical
    np.testing.assert_array_equal(
        _probs(PWM.load(ppath, device="cpu"), ppred, new, PDataset,
               PColumn, PT), p_own)
