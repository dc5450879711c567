"""The port's text stages against the JAX package's on the CPU: the
reference's text cases (tests/test_transformers_dsl.py: TF-IDF, the string
indexer, the similarities, language detection, text length, substring,
regex tokens, n-grams and stop words; tests/test_dsl_round3b.py: the IDF
formula, min_doc_freq, index and deindex), each run through a Workflow in
both packages on the same records, and the stages' functions on seeded
inputs.

Host stages are bit-identical, dtype included: counts float32, TF-IDF
float64 (float32 counts times the float64 idf), IDF float32, similarities
float64; the count vectorizers' vocabularies (ties in first-seen order)
equal; the bulk MurmurHash3 equal to the scalar one.
"""
import json

import numpy as np
import pytest

from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.ops import hashing as JH
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.transformers import text as JTx
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
import transmogrifai_tpu.types as JT

from torch_text_flow import FOREIGN, text_records
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.ops import hashing as PH
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.stages.registry import build_stage
from transmogrifai_tpu_torch.transformers import text as PTx
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
import transmogrifai_tpu_torch.types as PT

PKGS = {"jax": (JFB, JU, JWorkflow, JList, {}),
        "torch": (PFB, PU, PWorkflow, PList, {"device": "cpu"})}


def run_both(records, build):
    """{pkg: [column of each feature `build(FB)` returns]} of a Workflow
    trained on `records` in each package (uids reset in each)."""
    out = {}
    for pkg, (FB, U, Workflow, List, kw) in PKGS.items():
        U.reset_uids()
        feats = build(FB)
        data = Workflow(**kw).set_reader(List(records)) \
            .set_result_features(*feats).train()._train_data
        out[pkg] = [data.column(f.name) for f in feats]
    return out


def assert_same(a, b):
    """Bit-identical columns: dtype, shape, bytes and vector metadata, or
    equal host values."""
    if a.data.dtype == object:
        assert list(b.data) == list(a.data)
        return
    assert b.data.dtype == a.data.dtype and b.data.shape == a.data.shape
    np.testing.assert_array_equal(b.data, a.data)
    assert b.data.tobytes() == a.data.tobytes()
    if a.data.ndim == 2:
        assert b.metadata.to_json() == a.metadata.to_json()


def both_same(records, build):
    cols = run_both(records, build)
    for a, b in zip(cols["jax"], cols["torch"]):
        assert_same(a, b)
    return cols["torch"]


def test_tokenize_tf_idf():
    docs = ["the cat sat on the mat", "the dog ate the bone",
            "cats and dogs", None]
    X, = both_same([{"txt": d} for d in docs],
                   lambda FB: [FB.Text("txt").as_predictor().tokenize()
                               .tf_idf(vocab_size=16)])
    assert X.data.dtype == np.float64
    assert X.data.shape == (4, min(16, X.data.shape[1]))
    assert np.abs(X.data[3]).sum() == 0.0   # empty doc -> zero vector


@pytest.mark.parametrize("binary,min_df,vocab", [
    (False, 1, 512), (True, 1, 512), (False, 3, 512), (False, 1, 7)])
def test_count_vectorizers_on_tied_terms(binary, min_df, vocab):
    """Many terms tie in document frequency: both packages rank them in
    first-seen order; counts, 0/1, min_df and the vocabulary cut agree."""
    recs = text_records(300, seed=9)

    def build(FB):
        toks = FB.Text("t").as_predictor().tokenize()
        return [toks.count_vectorize(vocab_size=vocab, min_df=min_df,
                                     binary=binary),
                toks.tf_idf(vocab_size=vocab, min_df=min_df)]
    counts, tfidf = both_same(recs, build)
    assert counts.data.dtype == np.float32 and tfidf.data.dtype == np.float64
    assert (counts.data.max() <= 1.0) == binary


def test_count_model_row_path_and_saved_state_match():
    """A JAX-fitted model's save_args rebuild the port's model, whose row
    path (an OPVector: float32) and column path (one flat pass, float64
    with idf) encode as the JAX model's and as its own per-row loop."""
    recs = text_records(120, seed=4)
    toks = [JTx.tokenize_text(r["t"]) for r in recs]
    jm = JTx.TfIdfVectorizer(vocab_size=12).fit_columns(_jcol(toks))
    pm = build_stage("OpCountVectorizerModel", jm.save_args())
    assert pm.vocab == jm.vocab and pm.idf.dtype == np.float64
    for t in toks[:20]:
        np.testing.assert_array_equal(
            pm.transform_value(PT.TextList(t)).value,
            jm.transform_value(JT.TextList(t)).value)
    got = pm.transform_columns(_pcol(toks)).data
    assert got.dtype == np.float64
    assert got.tobytes() == np.stack([pm._encode(t) for t in toks]).tobytes()
    assert got.tobytes() == jm.transform_columns(_jcol(toks)).data.tobytes()


def _jcol(values):
    from transmogrifai_tpu.data.dataset import column_from_values
    return column_from_values(JT.TextList, values)


def _pcol(values):
    from transmogrifai_tpu_torch.data.dataset import column_from_values
    return column_from_values(PT.TextList, values)


def test_string_indexer_ranks_by_frequency():
    vals = ["b", "a", "b", "b", "a", "c"]
    got, = both_same([{"txt": v} for v in vals],
                     lambda FB: [FB.Text("txt").as_predictor()
                                 .index_string()])
    assert got.data[0] == 0.0  # 'b' most frequent
    assert got.data[5] == 2.0  # 'c' least frequent


@pytest.mark.parametrize("a,b", [
    (["hello", "world"], ["hello", "world"]), (["hello"], ["help", "me"]),
    ([], ["x"]), (["abc"], ["xyz"]), (["a", "b"], ["a b"]),
    (["naïve", "café"], ["cafe", "naive"])])
@pytest.mark.parametrize("n", [2, 3])
def test_ngram_similarity(a, b, n):
    p = PTx.NGramSimilarity(n=n).transform_value(PT.TextList(a),
                                                 PT.TextList(b)).value
    j = JTx.NGramSimilarity(n=n).transform_value(JT.TextList(a),
                                                 JT.TextList(b)).value
    assert p == j
    if a == b and a:
        assert p == pytest.approx(1.0)


@pytest.mark.parametrize("a,b,want", [
    ({"a", "b"}, {"b", "c"}, 1 / 3), (set(), set(), 1.0),
    ({"a"}, set(), 0.0), ({"x", "y"}, {"y", "x"}, 1.0)])
def test_jaccard_similarity(a, b, want):
    p = PTx.JaccardSimilarity().transform_value(PT.MultiPickList(a),
                                                PT.MultiPickList(b)).value
    assert p == JTx.JaccardSimilarity().transform_value(
        JT.MultiPickList(a), JT.MultiPickList(b)).value
    assert p == pytest.approx(want)


LANG_CASES = {
    "the cat and the dog is in the house": "en",
    "le chat est dans la maison et il est content": "fr",
    "The quick brown fox jumps over the lazy dog and runs away": "en",
    "Der schnelle braune Fuchs springt über den faulen Hund und läuft":
        "de",
    "Le renard brun rapide saute par-dessus le chien paresseux dans": "fr",
    "El zorro marrón rápido salta sobre el perro perezoso y corre": "es",
    "O rápido cão castanho não salta sobre o cão preguiçoso em": "pt",
    "La volpe marrone veloce salta sopra il cane pigro che è in": "it",
    "Szybki brązowy lis skacze nad leniwym psem i nie jest że": "pl",
    "Hızlı kahverengi tilki tembel köpeğin üzerinden atlar ve bir bu": "tr",
    "Быстрая коричневая лиса прыгает через ленивую собаку": "ru",
    "השועל החום המהיר קופץ מעל הכלב העצלן": "he",
    "الثعلب البني السريع يقفز فوق الكلب الكسول": "ar",
    "素早い茶色のキツネは怠け者の犬を飛び越えます": "ja",
    "敏捷的棕色狐狸跳过了懒狗": "zh",
    "빠른 갈색 여우가 게으른 개를 뛰어넘는다": "ko",
    "สุนัขจิ้งจอกสีน้ำตาลกระโดดข้ามสุนัขขี้เกียจ": "th",
    "Γρήγορη καφέ αλεπού πηδά πάνω από το τεμπέλικο σκυλί": "el",
    "तेज भूरी लोमड़ी आलसी कुत्ते के ऊपर कूदती है": "hi",
    "Швидка руда лисиця стрибає через ліниву собаку і їсть": "uk",
    "روباه قهوه‌ای سریع از روی سگ تنبل می‌پرد پچ": "fa",
}


def test_lang_detector_scripts_and_latin_profiles():
    """The reference's cases (language part of test_lang_mime_phone_email
    and test_lang_detector_scripts_and_latin_profiles), the stage too."""
    for text, want in LANG_CASES.items():
        assert PTx.detect_language(text) == want, (text[:30], want)
        assert JTx.detect_language(text) == want
        assert PTx.LangDetector().transform_value(PT.Text(text)).value \
            == want
    assert PTx.detect_language("") is None
    assert PTx.detect_language(None) is None


def test_detect_language_matches_jax_on_seeded_text():
    """Seeded documents of every kind, long ones past the 512-character
    head, marks and 2-character table entries: the same code everywhere."""
    rng = np.random.default_rng(3)
    pool = list(LANG_CASES) + FOREIGN + [
        r["t"] or "" for r in text_records(200, seed=8)]
    docs = ["", "x", "je na og", "ĳ", "¿¡"] + [
        " ".join(rng.choice(pool, size=int(rng.integers(1, 6))))
        for _ in range(400)]
    for d in docs:
        assert PTx.detect_language(d) == JTx.detect_language(d), d[:40]
    extra = PTx.build_language_profiles({"ca": " ".join(pool[:6]),
                                         "xx": "aaa bbb aaa je x"})
    assert extra == JTx.build_language_profiles(
        {"ca": " ".join(pool[:6]), "xx": "aaa bbb aaa je x"})
    loaded = {k: (set(v["stopwords"]), set(v["trigrams"]), v["marks"])
              for k, v in extra.items()}
    # a hand-written profile: ASCII marks, 2- and 4-character "trigrams"
    loaded["zz"] = ({"je"}, {"na", "the ", "ing"}, "q!é")
    for d in docs:
        assert PTx.detect_language(d, loaded) == \
            JTx.detect_language(d, loaded), d[:40]


def test_language_profiles_file_loads_alike(tmp_path):
    path = tmp_path / "profiles.json"
    path.write_text(json.dumps(JTx.build_language_profiles(
        {"ca": "el que és una de les coses més importants i no hi ha cap "
               "dubte que això també ho és per als nostres amics"})))
    assert PTx.load_language_profiles(str(path)) == \
        JTx.load_language_profiles(str(path))
    text = "els nostres amics i això també"
    assert PTx.LangDetector(model_path=str(path)).transform_value(
        PT.Text(text)).value == JTx.LangDetector(
        model_path=str(path)).transform_value(JT.Text(text)).value == "ca"


def test_text_len():
    got, = both_same([{"txt": v} for v in ["abc", None, "", "naïve"]],
                     lambda FB: [FB.Text("txt").as_predictor().text_len()])
    assert list(got.data) == [3.0, 0.0, 0.0, 5.0]


def test_is_substring():
    recs = [{"a": a, "b": b} for a, b in (
        ("cat", "concatenate"), ("dog", "fish"), (None, "x"),
        ("CAT", "a cat"), ("", "x"), ("x", None))]
    out, = both_same(recs, lambda FB: [FB.Text("a").as_predictor()
                                       .is_substring(FB.Text("b")
                                                     .as_predictor())])
    assert out.data[0] == 1.0 and out.data[1] == 0.0 and out.data[3] == 1.0
    assert np.isnan(out.data[2]) and np.isnan(out.data[5])


def test_tokenize_regex_and_ngram_and_stopwords():
    recs = [{"t": v} for v in ["the Cat-sat on  the Mat", None,
                               "(a)(b) THE x_y it's"]]

    def build(FB):
        t = FB.Text("t").as_predictor()
        toks = t.tokenize_regex(pattern=r"[a-z]+")
        return [toks, toks.remove_stop_words(), toks.ngram(2),
                t.tokenize_regex(pattern=r"\((\w)\)", to_lowercase=False,
                                 min_token_length=3),
                t.tokenize_regex(), toks.ngram(1), toks.ngram(5)]
    toks, kept, bi, grouped, words, uni, five = both_same(recs, build)
    assert list(toks.data[0]) == ["the", "cat", "sat", "on", "the", "mat"]
    assert "the" not in list(kept.data[0])
    assert "the cat" in list(bi.data[0])
    assert list(toks.data[1]) == []
    assert list(grouped.data[2]) == ["(a)", "(b)"]   # whole matches
    assert list(words.data[2]) == ["a", "b", "the", "x_y", "it", "s"]


def test_idf_matches_spark_formula():
    docs = [["a", "b"], ["a"], ["a", "c"], []]

    def build(FB):
        counts = FB.Text("t").as_predictor().tokenize() \
            .count_vectorize(vocab_size=8)
        return [counts, counts.idf()]
    raw, got = both_same([{"t": " ".join(d)} for d in docs], build)
    m = raw.data.shape[0]
    df = (raw.data > 0).sum(axis=0)
    expect = raw.data * np.log((m + 1.0) / (df + 1.0))[None, :]
    np.testing.assert_allclose(got.data, expect, rtol=1e-5)
    assert got.data.dtype == np.float32
    assert got.metadata.size == raw.data.shape[1]


def test_idf_min_doc_freq_zeroes():
    def build(FB):
        counts = FB.Text("t").as_predictor().tokenize() \
            .count_vectorize(vocab_size=8)
        return [counts, counts.idf(min_doc_freq=2)]
    raw, got = both_same([{"t": v} for v in ["a b", "a b", "a c"]], build)
    df = (raw.data > 0).sum(axis=0)
    assert np.all(got.data[:, df < 2] == 0.0)
    assert np.any(got.data[:, df == 2] != 0.0)


def test_index_then_deindex_roundtrip():
    vals = ["red", "blue", "red", "green", None, "blue"]
    labels = ["red", "blue", "green"]

    def build(FB):
        idx = FB.Text("t").as_predictor().index_string()
        return [idx, idx.deindexed(labels=labels),
                FB.Text("t").as_predictor().to_multi_pick_list()]
    _, back, mpl = both_same([{"t": v} for v in vals], build)
    assert list(back.data) == vals
    assert list(mpl.data)[:2] == [{"red"}, {"blue"}]


def test_indexer_handle_invalid_and_saved_labels():
    jm = JTx.OpStringIndexer(handle_invalid="error").fit_columns(
        _col(JT.Text, ["x", "y", "x"]))
    pm = build_stage("OpStringIndexerModel", jm.save_args())
    assert pm.labels == ["x", "y"] and pm.handle_invalid == "error"
    assert pm.transform_value(PT.Text("y")).value == 1.0
    with pytest.raises(ValueError, match="Unseen label"):
        pm.transform_value(PT.Text("z"))
    keep = build_stage("OpStringIndexerModel",
                       dict(jm.save_args(), handle_invalid="keep"))
    assert keep.transform_value(PT.Text("z")).value == 2.0
    back = build_stage("OpIndexToString", JTx.OpIndexToString(
        labels=["x", "y"]).save_args())
    assert [back.transform_value(PT.RealNN(v)).value
            for v in (0.0, 1.0, 2.0)] == ["x", "y", None]


def _col(t, values):
    from transmogrifai_tpu.data.dataset import column_from_values
    return column_from_values(t, values)


def _strings(n=3000, seed=7):
    rng = np.random.default_rng(seed)
    alphabet = list("ab_'Z é中😀0-") + ["\ud800"]
    return [""] + ["".join(rng.choice(alphabet, size=int(rng.integers(0, 40))))
                   for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 - 1])
def test_bulk_murmur3_equals_the_scalar_one(seed):
    strs = _strings()
    want = [JH.murmur3_32(s.encode("utf-8", errors="surrogatepass"), seed)
            for s in strs]
    assert PH.murmur3_32_array(strs, seed).tolist() == want
    ascii_only = [s for s in strs if s.isascii()]
    assert PH.murmur3_32_array(ascii_only, seed).tolist() == [
        w for s, w in zip(strs, want) if s.isascii()]
    assert PH.hash_strings(strs, 512, seed).tolist() == [
        JH.hash_string(s, 512, seed) for s in strs]
