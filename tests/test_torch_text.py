"""The port's MurmurHash3, text analyzer and text vectorizers against the
JAX package.

Hashes: `murmur3_32` and `hash_string` on 2 000 seeded strings (empty,
ASCII, non-ASCII, lone surrogates) equal the JAX package's. Analyzer:
`tokenize_text` gives the same tokens. Vectorizers: SmartText on its pivot
and hash routes, and TextList hashing, through a Workflow in both packages
(after `reset_uids()` in each) on ASCII and non-ASCII corpora, with
track_nulls on and off: the matrix bit-identical and the metadata equal.
The JAX package hashes ASCII corpora through its native C++ path where it
is built and through Python elsewhere; the port always through Python:
both give the same counts.
"""
import numpy as np
import pytest

from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm, \
    TransmogrifierDefaults as JDefaults
from transmogrifai_tpu.automl.vectorizers import text as JV
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.ops import hashing as JH
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.transformers import text as JTx
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch.automl.transmogrifier import \
    transmogrify as p_tm, TransmogrifierDefaults as PDefaults
from transmogrifai_tpu_torch.automl.vectorizers import text as PV
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.ops import hashing as PH
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.transformers import text as PTx
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

WORDS = ["the", "Quick", "brown", "fox's", "jumps", "over", "a", "lazy",
         "dog", "O'Brien", "x_y", "42", "3.14", "e-mail", "HELLO", "it",
         "naïve", "café", "Straße", "Ωmega", "東京", "smörgåsbord", "ﬁne",
         "İstanbul", "emoji😀", "Ǆemal"]


def seeded_strings(n=2000, seed=11):
    rng = np.random.default_rng(seed)
    out = ["", " ", "a", "ab", "abc", "abcd", "abcde", "\ud800", "x\udfffy",
           "\udc00\ud800", "é" * 7]
    while len(out) < n:
        k = int(rng.integers(1, 6))
        s = " ".join(WORDS[int(i)] for i in rng.integers(0, len(WORDS), k))
        if rng.uniform() < 0.05:   # a lone surrogate somewhere
            at = int(rng.integers(0, len(s) + 1))
            s = s[:at] + chr(int(rng.integers(0xD800, 0xE000))) + s[at:]
        if rng.uniform() < 0.05:
            s = "".join(chr(int(c)) for c in rng.integers(32, 0x3000, 6))
        out.append(s)
    return out


STRINGS = seeded_strings()


@pytest.mark.parametrize("seed", [0, 42])
def test_murmur3_and_hash_string_match_jax(seed):
    for s in STRINGS:
        b = s.encode("utf-8", errors="surrogatepass")
        assert PH.murmur3_32(b, seed) == JH.murmur3_32(b, seed), s
        for bins in (512, 7):
            assert PH.hash_string(s, bins, seed) == \
                JH.hash_string(s, bins, seed), s


def test_murmur3_reference_vectors():
    # the published MurmurHash3_x86_32 test vectors
    assert PH.murmur3_32(b"", 0) == 0
    assert PH.murmur3_32(b"", 1) == 0x514E28B7
    assert PH.murmur3_32(b"hello", 0) == 0x248BFA47
    assert PH.murmur3_32(b"Hello, world!", 1234) == 0xFAF6CDB3


@pytest.mark.parametrize("binary", [False, True])
def test_hash_tokens_to_counts_matches_jax(binary):
    lists = [PTx.tokenize_text(s) for s in STRINGS[:600]] + [None, []]
    np.testing.assert_array_equal(
        PH.hash_tokens_to_counts(lists, 64, binary=binary),
        JH.hash_tokens_to_counts(lists, 64, binary=binary))


@pytest.mark.parametrize("kw", [
    {}, dict(min_token_length=3), dict(to_lowercase=False),
    dict(filter_stopwords=True)])
def test_tokenize_text_gives_the_same_tokens(kw):
    for s in STRINGS + [None]:
        assert PTx.tokenize_text(s, **kw) == JTx.tokenize_text(s, **kw), s


def test_tokenize_hash_counts_pad_and_out_contract():
    docs = ["Braund, Mr. Owen Harris", None, "", "Heikkinen, Miss. Laina"]
    base = PV.tokenize_hash_counts(docs, 16)
    np.testing.assert_array_equal(base, JV.tokenize_hash_counts(docs, 16))
    padded = PV.tokenize_hash_counts(docs, 16, pad_cols=2)
    assert padded.shape == (4, 18) and not padded[:, 16:].any()
    np.testing.assert_array_equal(padded[:, :16], base)
    wide = np.zeros((4, 20), np.float32)
    out = PV.tokenize_hash_counts(docs, 16, pad_cols=1, out=wide[:, 2:19])
    assert out.base is wide or out is wide[:, 2:19] or np.shares_memory(
        out, wide)
    np.testing.assert_array_equal(wide[:, 2:18], base)
    assert not wide[:, :2].any() and not wide[:, 18:].any()


def corpus(n, seed, ascii_only, card):
    """Rows of three Text features (a high-cardinality name, a
    low-cardinality title, a sparse note) and a TextList of tags."""
    rng = np.random.default_rng(seed)
    pool = [w for w in WORDS if w.isascii()] if ascii_only else WORDS
    titles = ["Mr", "Mrs", "Miss", "Master", "Dr", "Rev"]
    rows = []
    for _ in range(n):
        k = int(rng.integers(1, 4))
        name = " ".join(pool[int(i)] for i in rng.integers(0, len(pool), k)) \
            + f" {int(rng.integers(0, card))}"
        rows.append({
            "name": None if rng.uniform() < 0.1 else name,
            "title": titles[int(rng.integers(0, len(titles)))]
            if rng.uniform() > 0.05 else None,
            "note": pool[int(rng.integers(0, len(pool)))]
            if rng.uniform() < 0.3 else None,
            "tags": [pool[int(i)] for i in
                     rng.integers(0, len(pool), int(rng.integers(0, 4)))]
            if rng.uniform() > 0.1 else None,
        })
    return rows


def _vectorized(pkg, rows, track_nulls, bins):
    FB, U, tm, Defaults, Workflow, List, kw = (
        (JFB, JU, j_tm, JDefaults, JWorkflow, JList, {}) if pkg == "jax"
        else (PFB, PU, p_tm, PDefaults, PWorkflow, PList, {"device": "cpu"}))
    U.reset_uids()
    d = Defaults(track_nulls=track_nulls, default_num_of_features=bins)
    feats = [FB.Text("name").as_predictor(), FB.Text("title").as_predictor(),
             FB.TextArea("note").as_predictor(),
             FB.TextList("tags").as_predictor()]
    vec = tm(feats, defaults=d)
    model = Workflow(**kw).set_reader(List(rows)) \
        .set_result_features(vec).train()
    return model, vec


@pytest.mark.parametrize("ascii_only", [True, False])
@pytest.mark.parametrize("track_nulls", [True, False])
def test_text_vectorizers_match_jax(ascii_only, track_nulls):
    rows = corpus(400, 5, ascii_only, card=300)
    jm, jv = _vectorized("jax", rows, track_nulls, 64)
    pm, pv = _vectorized("torch", rows, track_nulls, 64)
    assert pv.name == jv.name
    a, b = jm._train_data.column(jv.name), pm._train_data.column(pv.name)
    assert b.data.dtype == np.float32 and b.data.shape == a.data.shape
    assert a.data.tobytes() == b.data.tobytes()
    assert b.metadata.to_json() == a.metadata.to_json()
    smart = next(s for s in pm.stages if type(s).__name__ == "SmartTextModel")
    assert [p["mode"] for p in smart.plans] == ["hash", "pivot", "pivot"]
    jsmart = next(s for s in jm.stages
                  if type(s).__name__ == "SmartTextModel")
    assert smart.save_args()["plans"] == jsmart.save_args()["plans"]
    # row-level scoring of the fitted models agrees with the columnar pass
    for st in pm.stages:
        if type(st).__name__ in ("SmartTextModel", "HashingModel"):
            full = pm._train_data.data(st.output_name())
            for i in (0, 7, 33):
                from transmogrifai_tpu_torch.types import Text, TextList
                t = TextList if type(st).__name__ == "HashingModel" else Text
                vals = [t(pm._train_data.data(n)[i])
                        for n in st.input_names()]
                np.testing.assert_array_equal(
                    st.transform_value(*vals).value, full[i])


def test_carried_text_models_score_identically():
    rows = corpus(300, 9, False, card=200)
    jm, jv = _vectorized("jax", rows, True, 32)
    PU.reset_uids()
    feats = [PFB.Text("name").as_predictor(), PFB.Text("title").as_predictor(),
             PFB.TextArea("note").as_predictor(),
             PFB.TextList("tags").as_predictor()]
    pv = p_tm(feats, defaults=PDefaults(default_num_of_features=32))
    carried = convert.workflow_model_from_jax(
        [pv], [convert.stage_state(st) for st in jm.stages], device="cpu")
    new = corpus(120, 10, False, card=400)
    a = jm.score(JList(new).generate_dataset(jm.raw_features())).data(jv.name)
    b = carried.score(PList(new).generate_dataset(carried.raw_features())) \
        .data(pv.name)
    np.testing.assert_array_equal(b, a)


def test_structured_text_types_still_raise():
    """The structured text types no longer raise: since their slice each
    derives, as in the JAX package, before its group's default vectorizer
    (Email, URL and Base64 to a PickList, Phone to a Binary)."""
    for t, stage, vec in (("Email", "EmailToPickList", "OneHotVectorizer"),
                          ("Phone", "PhoneNumberParser", "BinaryVectorizer"),
                          ("URL", "UrlToDomainPickList", "OneHotVectorizer"),
                          ("Base64", "MimeTypeDetector", "OneHotVectorizer")):
        out = []
        for FB, U, tm in ((JFB, JU, j_tm), (PFB, PU, p_tm)):
            U.reset_uids()
            v = tm([getattr(FB, t)("f").as_predictor()])
            derived = v.parents[0]
            out.append((v.name, type(v.origin_stage).__name__,
                        derived.name, derived.type_name,
                        type(derived.origin_stage).__name__))
        assert out[1] == out[0], t
        assert out[1][1] == vec and out[1][4] == stage
