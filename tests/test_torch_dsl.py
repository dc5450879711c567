"""The port's numeric DSL, math and misc stages, lambda stages and
bucketizers against the JAX package.

Each stage is built through the DSL in both packages on the same seeded
records (after `reset_uids()` in each) and run in a `Workflow` on the CPU.
The columns carry NaN, zeros (divide), negatives (log, sqrt) and ties
(bucket splits). Tolerances: f32 outputs within 1 ulp (the JAX package's
layer program is XLA's, the port's is torch's: exp, log, sqrt and pow may
round apart by an ulp; a log of another base is the natural log times the
f32 reciprocal of ln(base) in both, so it is held to one ulp of that
natural log, carried through the product; every other op is
bit-identical); fitted parameters
within 1e-12; bucketizer splits, vectors and vector metadata identical;
lambda stages identical.
"""
import ast
import pathlib

import numpy as np
import pytest

from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
import transmogrifai_tpu.types as JT

import transmogrifai_tpu_torch  # noqa: F401 — installs the dsl
from torch_text_flow import text_records, text_stages
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import dsl as PD
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.features.feature import Feature as PFeature
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.stages.base import (LambdaTransformer,
                                                  binary_transformer,
                                                  unary_transformer)
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
import transmogrifai_tpu_torch.types as PT

REPO = pathlib.Path(__file__).resolve().parents[1]


def records(n=400, seed=3):
    """x: NaN, zeros, negatives; y: zeros (divide) and NaN; k: integers
    with ties; label: 0/1 tied to k and x."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, size=n)
    x[rng.uniform(size=n) < 0.1] = 0.0
    x[rng.uniform(size=n) < 0.1] = np.nan
    y = np.round(rng.normal(0, 2, size=n), 1)
    y[rng.uniform(size=n) < 0.15] = 0.0
    y[rng.uniform(size=n) < 0.05] = np.nan
    k = rng.integers(0, 12, size=n).astype(float)
    k[rng.uniform(size=n) < 0.05] = np.nan
    logit = 0.6 * (np.nan_to_num(k) - 6) + 0.3 * np.nan_to_num(x)
    label = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(float)
    return [{"x": None if np.isnan(x[i]) else float(x[i]),
             "y": None if np.isnan(y[i]) else float(y[i]),
             "k": None if np.isnan(k[i]) else float(k[i]),
             "label": float(label[i])} for i in range(n)]


def _derived(FB, T):
    """(name, feature) pairs of every stage, built through the DSL."""
    x = FB.Real("x").as_predictor()
    y = FB.Real("y").as_predictor()
    k = FB.Real("k").as_predictor()
    label = FB.RealNN("label").as_response()
    filled = x.fill_missing_with_mean()
    scaled = x.scale(slope=2.5, intercept=-1.0)
    out = [
        ("plus", x + y), ("minus", x - y), ("times", x * y),
        ("divide", x / y), ("plusS", x + 2.5), ("minusS", x - 1.5),
        ("timesS", x * 3.0), ("divideS", x / 7.0), ("divide0", x / 0.0),
        ("radd", 1.0 + x), ("rmul", 0.5 * y),
        ("abs", x.abs()), ("ceil", x.ceil()), ("floor", x.floor()),
        ("round", x.round()), ("exp", x.exp()), ("sqrt", x.sqrt()),
        ("log", x.log()), ("log10", x.log(10.0)), ("pow2", x.power(2.0)),
        ("pow05", y.power(0.5)), ("pow33", x.power(3.3)),
        ("alias", x.alias("xx")), ("occur", x.to_occur()),
        ("filled", filled), ("znorm", x.z_normalize()),
        ("filled_znorm", filled.z_normalize()),
        ("scaled", scaled), ("logscaled", y.scale("logarithmic")),
        ("descaled", scaled.descale(scaled,
                                    scaler=scaled.origin_stage)),
        ("percentile", filled.calibrate_percentile(10)),
        ("bucket_q", k.bucketize(num_buckets=4)),
        ("bucket_fixed", x.bucketize(splits=[-np.inf, -1.0, 0.0, 2.0,
                                             np.inf], track_nulls=False)),
        ("autobucket", k.autobucketize(label, max_splits=4,
                                       min_info_gain=0.001)),
        ("replaced", k.replace_with(3.0, 30.0)),
        ("mapped", x.map_values(
            lambda v: None if v is None else v * v + 1.0)),
        ("mapped_feature", k.map(
            lambda v: None if v.value is None
            else ("hi" if v.value > 5 else "lo"),
            output_type=T.PickList, operation_name="band")),
        ("exists", y.exists(lambda v: v > 0)),
        ("filtered", y.filter_values(lambda v: v > 0, default=-1.0)),
        ("filter_not", y.filter_not(lambda v: v > 0, default=-1.0)),
        ("collected", x.collect(lambda v: v if v > 0 else None, -7.0)),
    ]
    vec = k.bucketize(num_buckets=4)
    out.append(("dropped", vec.drop_indices_by(
        lambda c: c.indicator_value == "NullIndicatorValue")))
    return out


def _train(pkg):
    FB, U, T, Workflow, List, kw = (
        (JFB, JU, JT, JWorkflow, JList, {}) if pkg == "jax" else
        (PFB, PU, PT, PWorkflow, PList, {"device": "cpu"}))
    U.reset_uids()
    derived = _derived(FB, T)
    model = Workflow(**kw).set_reader(List(records())) \
        .set_result_features(*[f for _, f in derived]).train()
    return model, derived


@pytest.fixture(scope="module")
def trained():
    return _train("jax"), _train("torch")


def assert_f32_within_1ulp(a, b, name, scale=None):
    """a and b agree within one ulp; with `scale`, within one ulp of a / scale
    carried through the product (a = f32(value * scale))."""
    a = np.asarray(a, np.float64).astype(np.float32)
    b = np.asarray(b, np.float64).astype(np.float32)
    assert a.shape == b.shape, name
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
    ok = ~np.isnan(a)
    x, y = a[ok], b[ok]
    same = x == y
    gap = np.abs(x.astype(np.float64) - y.astype(np.float64))
    big = np.maximum(np.abs(x), np.abs(y))
    ulp = np.spacing(big).astype(np.float64)
    if scale is not None:
        ulp = np.spacing(big / np.float32(scale)).astype(np.float64) \
            * scale + ulp
    assert np.all(same | (gap <= ulp)), (name, np.max(gap / ulp))


SCALARS = ["plus", "minus", "times", "divide", "plusS", "minusS", "timesS",
           "divideS", "divide0", "radd", "rmul", "abs", "ceil", "floor",
           "round", "exp", "sqrt", "log", "log10", "pow2", "pow05", "pow33",
           "alias", "occur", "filled", "znorm", "filled_znorm", "scaled",
           "logscaled", "descaled", "percentile", "replaced", "mapped",
           "exists", "filtered", "filter_not", "collected"]
# ops whose f32 rounding is the same in XLA and torch
EXACT = {"plus", "minus", "times", "divide", "plusS", "minusS", "timesS",
         "divideS", "divide0", "radd", "rmul", "abs", "ceil", "floor",
         "round", "alias", "occur", "filled", "znorm", "filled_znorm",
         "scaled", "descaled", "percentile", "replaced", "mapped", "exists",
         "filtered", "filter_not", "collected"}


@pytest.mark.parametrize("name", SCALARS)
def test_scalar_stage_matches_jax(trained, name):
    (jm, jd), (pm, pd) = trained
    jf, pf = dict(jd)[name], dict(pd)[name]
    assert pf.name == jf.name and pf.type_name == jf.type_name
    a = jm._train_data.data(jf.name)
    b = pm._train_data.data(pf.name)
    if name in EXACT:
        np.testing.assert_array_equal(b, a)
    elif name == "log10":
        assert_f32_within_1ulp(a, b, name,
                               scale=np.float32(1) / np.float32(np.log(10)))
    else:
        assert_f32_within_1ulp(a, b, name)


def test_the_derived_columns_hold_the_empty_rules(trained):
    (_, _), (pm, pd) = trained
    d = {n: pm._train_data.data(f.name) for n, f in pd}
    x = np.array([np.nan if r["x"] is None else r["x"] for r in records()])
    y = np.array([np.nan if r["y"] is None else r["y"] for r in records()])
    assert np.isnan(d["divide"][y == 0]).all()
    assert np.isnan(d["divide0"]).all()
    assert np.isnan(d["sqrt"][x < 0]).all()
    assert np.isnan(d["log"][x <= 0]).all()
    assert not np.isnan(d["znorm"]).any() and not np.isnan(d["filled"]).any()
    assert (d["znorm"][np.isnan(x)] == 0).all()


@pytest.mark.parametrize("name", ["bucket_q", "bucket_fixed", "autobucket",
                                  "dropped", "mapped_feature"])
def test_vector_and_host_stage_matches_jax(trained, name):
    (jm, jd), (pm, pd) = trained
    jf, pf = dict(jd)[name], dict(pd)[name]
    assert pf.name == jf.name
    a, b = jm._train_data.column(jf.name), pm._train_data.column(pf.name)
    if name == "mapped_feature":
        assert list(b.data) == list(a.data)
        return
    np.testing.assert_array_equal(b.data, a.data)
    assert b.data.dtype == a.data.dtype == np.float32
    assert b.metadata.to_json() == a.metadata.to_json()


FITTED = {"ZNormalizeModel": ("mean", "std"),
          "FillMissingWithMeanModel": ("mean",),
          "PercentileCalibratorModel": ("splits",),
          "NumericBucketizerModel": ("splits",),
          "DecisionTreeNumericBucketizerModel": ("splits",)}


@pytest.mark.parametrize("cls", sorted(FITTED))
def test_fitted_parameters_match_jax(trained, cls):
    (jm, _), (pm, _) = trained
    js = [s for s in jm.stages if type(s).__name__ == cls]
    ps = [s for s in pm.stages if type(s).__name__ == cls]
    assert len(js) == len(ps) >= 1
    for a, b in zip(js, ps):
        assert a.uid == b.uid and a.output_name() == b.output_name()
        for key in FITTED[cls]:
            va, vb = a.save_args()[key], b.save_args()[key]
            if "Bucketizer" in cls:   # splits identical
                assert [np.asarray(s).tolist() for s in np.atleast_1d(vb)] \
                    == [np.asarray(s).tolist() for s in np.atleast_1d(va)]
            else:
                np.testing.assert_allclose(vb, va, rtol=0, atol=1e-12)


def test_label_splits_fall_on_the_ties(trained):
    (_, _), (pm, _) = trained
    st = next(s for s in pm.stages
              if type(s).__name__ == "DecisionTreeNumericBucketizerModel")
    assert 1 <= len(st.splits) <= 4
    assert all(float(s).is_integer() for s in st.splits), st.splits


def _ops_table_names():
    """The keys of the JAX package's dsl `ops` table."""
    tree = ast.parse((REPO / "transmogrifai_tpu" / "dsl.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "install")
    table = next(n.value for n in ast.walk(fn)
                 if isinstance(n, ast.Assign) and n.targets[0].id == "ops")
    return [k.value for k in table.keys]


def test_every_dsl_name_is_installed():
    names = _ops_table_names()
    assert len(names) >= 80
    missing = [n for n in names if not callable(getattr(PFeature, n, None))]
    assert missing == []
    # every name builds the port's own stage: none is left unported
    assert not hasattr(PD, "UNPORTED")


# the text dsl names ported last (tests/torch_text_flow.py builds them)
TEXT_NAMES = [name for name, _ in text_stages(PFB, text_records(4))]
# the names whose fit draws its initial factors: their outputs come from
# the JAX-fitted stages carried into the port, LDA's fold-in within this
# absolute tolerance (25 EM iterations of f32 matmuls summed in another
# order), word2vec's mean pooling bit-identical (None)
DRAWN = {"lda": 1e-5, "word2vec": None}


@pytest.fixture(scope="module")
def text_flows():
    from transmogrifai_tpu_torch import convert
    recs = text_records()
    out = {}
    for pkg, FB, U, Workflow, List, kw in (
            ("jax", JFB, JU, JWorkflow, JList, {}),
            ("torch", PFB, PU, PWorkflow, PList, {"device": "cpu"})):
        U.reset_uids()
        derived = text_stages(FB, recs)
        model = Workflow(**kw).set_reader(List(recs)) \
            .set_result_features(*[f for _, f in derived]).train()
        out[pkg] = (model, derived)
    (jm, jd), (_, pd) = out["jax"], out["torch"]
    carried = convert.workflow_model_from_jax(
        [f for _, f in pd], [convert.stage_state(st) for st in jm.stages],
        device="cpu")
    out["scored"] = (
        jm.score(JList(recs).generate_dataset(jm.raw_features())),
        carried.score(PList(recs).generate_dataset(carried.raw_features())))
    return out


@pytest.mark.parametrize("name", TEXT_NAMES)
def test_unported_dsl_name_raises_naming_its_stage(text_flows, name):
    """Each text dsl name the port once left unported builds the port's
    stage, whose output on seeded records equals the JAX package's: the
    host stages' outputs bit for bit (TF-IDF in float64, as there), LDA's
    and word2vec's from the JAX-fitted stages carried across (`DRAWN`)."""
    (jm, jd), (pm, pd) = text_flows["jax"], text_flows["torch"]
    jf, pf = dict(jd)[name], dict(pd)[name]
    assert pf.name == jf.name and pf.type_name == jf.type_name
    assert type(pf.origin_stage).__name__ == \
        type(jf.origin_stage).__name__
    if name in DRAWN:
        a, b = text_flows["scored"]
        assert_columns_equal(a.column(jf.name), b.column(pf.name), name,
                             atol=DRAWN[name])
        return
    assert_columns_equal(jm._train_data.column(jf.name),
                         pm._train_data.column(pf.name), name)


def test_tokenize_then_tf_idf_raises_and_tf_hashes():
    """The reference's own example, ``tokenize().tf_idf()``, gives the JAX
    package's float64 TF-IDF matrix and term metadata; `tf` still hashes."""
    docs = ["the cat sat on the mat", "the dog ate the bone",
            "cats and dogs", None, "", "dog dog cat"]

    def tfidf(FB, U, Workflow, List, kw):
        U.reset_uids()
        vec = FB.Text("t").as_predictor().tokenize().tf_idf(vocab_size=6)
        data = Workflow(**kw).set_reader(List([{"t": d} for d in docs])) \
            .set_result_features(vec).train()._train_data
        return data.column(vec.name)
    a = tfidf(JFB, JU, JWorkflow, JList, {})
    b = tfidf(PFB, PU, PWorkflow, PList, {"device": "cpu"})
    assert b.data.dtype == np.float64
    assert_columns_equal(a, b, "tf_idf")
    PU.reset_uids()
    toks = PFB.Text("t").as_predictor().tokenize()
    assert toks.type_name == "TextList"
    assert toks.tf(num_features=8).type_name == "OPVector"
    # a text map smart-vectorizes through the map vectorizer, as in the
    # JAX package: a low-cardinality key pivots, a free-text key hashes
    rng = np.random.default_rng(4)
    rows = [{"m": {"color": str(rng.choice(["red", "Blue", "green"])),
                   "note": f"note number {rng.integers(60)}"}}
            for _ in range(300)]

    def fit(FB, U, Workflow, List, kw):
        U.reset_uids()
        vec = FB.TextMap("m").as_predictor().smart_vectorize(
            num_features=16)
        data = Workflow(**kw).set_reader(List(rows)) \
            .set_result_features(vec).train()._train_data
        return data.column(vec.name)
    a = fit(JFB, JU, JWorkflow, JList, {})
    b = fit(PFB, PU, PWorkflow, PList, {"device": "cpu"})
    assert b.data.shape == a.data.shape == (300, 3 + 1 + 1 + 16 + 1)
    assert b.data.tobytes() == a.data.tobytes()
    assert b.metadata.to_json() == a.metadata.to_json()


def test_module_level_transmogrify_and_combine():
    PU.reset_uids()
    a, b = PFB.Real("a").as_predictor(), PFB.PickList("b").as_predictor()
    vec = PD.transmogrify([a, b])
    both = PD.combine([a.vectorize(), b.pivot()])
    rows = [{"a": 1.0, "b": "u"}, {"a": None, "b": "v"}] * 20
    model = PWorkflow(device="cpu").set_reader(PList(rows)) \
        .set_result_features(vec, both).train()
    assert model._train_data.data(vec.name).shape[0] == 40
    assert model._train_data.column(both.name).metadata.size == \
        model._train_data.data(both.name).shape[1]


def test_lambda_stage_helpers():
    PU.reset_uids()
    a, b = PFB.Real("a").as_predictor(), PFB.Real("b").as_predictor()
    neg = unary_transformer("neg", lambda v: PT.Real(
        None if v.value is None else -v.value), PT.Real, PT.Real)
    both = binary_transformer("both", lambda u, v: PT.Binary(
        u.value is not None and v.value is not None), PT.Real, PT.Real,
        PT.Binary)
    fa, fb = neg.set_input(a).get_output(), \
        both.set_input(a, b).get_output()
    assert isinstance(neg, LambdaTransformer) and neg.save_args()["lambda"]
    rows = [{"a": 1.5, "b": None}, {"a": None, "b": 2.0}, {"a": 2.0, "b": 1}]
    ds = PWorkflow(device="cpu").set_reader(PList(rows)) \
        .set_result_features(fa, fb).train()._train_data
    np.testing.assert_array_equal(ds.data(fa.name), [-1.5, np.nan, -2.0])
    np.testing.assert_array_equal(ds.data(fb.name), [0.0, 0.0, 1.0])


def test_jax_fitted_stages_carry_over(trained):
    """The JAX-fitted workflow of every stage, carried into the port by
    convert.workflow_model_from_jax (fitted means, std, percentile and
    bucket splits, with their metadata), scores new records as the JAX
    package does, at the tolerances above."""
    from transmogrifai_tpu_torch import convert
    (jm, jd), _ = trained
    PU.reset_uids()
    pd = _derived(PFB, PT)
    carried = convert.workflow_model_from_jax(
        [f for _, f in pd], [convert.stage_state(st) for st in jm.stages],
        device="cpu")
    new = records(150, seed=9)
    a = jm.score(JList(new).generate_dataset(jm.raw_features()))
    b = carried.score(PList(new).generate_dataset(carried.raw_features()))
    for (name, jf), (_, pf) in zip(jd, pd):
        x, y = a.column(jf.name), b.column(pf.name)
        if x.data.dtype == object:
            assert list(y.data) == list(x.data), name
        elif name in EXACT or x.data.ndim == 2:
            np.testing.assert_array_equal(y.data, x.data, err_msg=name)
        elif name == "log10":
            assert_f32_within_1ulp(x.data, y.data, name,
                                   scale=np.float32(1) / np.float32(
                                       np.log(10)))
        else:
            assert_f32_within_1ulp(x.data, y.data, name)
        if x.data.ndim == 2:
            assert y.metadata.to_json() == x.metadata.to_json()


# -- the date, map, geolocation and structured text names --------------------

def structured_records(n=300, seed=5):
    """Dates (pre-1970 and missing too), emails, URLs (userinfo, ports,
    localhost, invalid), phones (US, GB, DE, short), base64 payloads
    (headers, random bytes, undecodable, empty), locations, and date,
    real, phone and base64 maps with missing keys; a label that the map's
    k0 predicts."""
    import base64
    rng = np.random.default_rng(seed)
    heads = [b"\x89PNG\r\n", b"%PDF-1.4", b"GIF89a", b"PK\x03\x04", b"{"]
    urls = ["https://user:pw@example.com/a", "http://localhost:8080/x",
            "https://example.com:8443/a", "ftp://files.example.org/f",
            "nope", "mailto:x@y.com", "https://sub.example.com/p?q=1"]
    phones = ["(415) 555-0134", "+44 20 7946 0958", "+49 30 1234567",
              "030 1234567", "555-0134", "+1 415 555 0134", "1-415-555-0134"]
    out = []
    for _ in range(n):
        u = rng.uniform(size=8)
        k0 = float(rng.normal())
        ms = int(rng.integers(-10**11, 2 * 10**12))
        payload = base64.b64encode(heads[rng.integers(5)]
                                   + rng.bytes(6)).decode()
        out.append({
            "label": float(k0 + 0.3 * rng.normal() > 0),
            "dt": None if u[0] < 0.1 else ms,
            "dtt": None if u[1] < 0.1 else ms + 3_600_000,
            "em": (None if u[2] < 0.1 else "jane.doe@" if u[2] < 0.15 else
                   f"u{rng.integers(40)}@d{rng.integers(5)}.com"),
            "url": None if u[3] < 0.1 else urls[rng.integers(len(urls))],
            "ph": None if u[4] < 0.1 else phones[rng.integers(len(phones))],
            "b64": (None if u[5] < 0.1 else "!!not base64" if u[5] < 0.15
                    else base64.b64encode(rng.bytes(9)).decode()
                    if u[5] < 0.3 else payload),
            "geo": None if u[6] < 0.1 else [float(rng.uniform(-60, 60)),
                                            float(rng.uniform(-170, 170)),
                                            float(rng.integers(1, 6))],
            "dmap": {k: ms + int(rng.integers(0, 10**9)) for k, p in
                     (("a", 0.9), ("b", 0.5)) if rng.uniform() < p},
            "rmap": {k: v for k, v, p in (("k0", k0, 0.95),
                                          ("k1", float(rng.normal()), 0.7),
                                          ("k2", float(rng.normal()), 0.5))
                     if rng.uniform() < p},
            "phmap": {k: phones[rng.integers(len(phones))] for k in "hw"
                      if rng.uniform() < 0.7},
            "b64map": {k: payload for k in "xy" if rng.uniform() < 0.7},
        })
    return out


def _structured(FB):
    """(dsl name, feature) of each of the twenty names, built through the
    dsl."""
    label = FB.RealNN("label").as_response()
    dt, dtt = FB.Date("dt").as_predictor(), FB.DateTime("dtt").as_predictor()
    em, url = FB.Email("em").as_predictor(), FB.URL("url").as_predictor()
    ph, b64 = FB.Phone("ph").as_predictor(), FB.Base64("b64").as_predictor()
    geo = FB.Geolocation("geo").as_predictor()
    dmap, rmap = FB.DateMap("dmap").as_predictor(), \
        FB.RealMap("rmap").as_predictor()
    phmap = FB.PhoneMap("phmap").as_predictor()
    b64map = FB.Base64Map("b64map").as_predictor()
    return [
        ("to_unit_circle", dt.to_unit_circle("DayOfWeek")),
        ("to_unit_circle_map", dmap.to_unit_circle_map("HourOfDay")),
        ("to_date_list", dt.to_date_list()),
        ("to_date_time_list", dtt.to_date_time_list()),
        ("vectorize_dates", dt.vectorize_dates(
            dtt, reference_date_ms=1.6e12,
            circular_periods=["HourOfDay", "DayOfWeek", "DayOfMonth",
                              "DayOfYear", "WeekOfYear", "MonthOfYear"])),
        ("filter_keys", rmap.filter_keys(block=["k1"])),
        ("vectorize_map", rmap.vectorize_map()),
        ("autobucketize_map", rmap.autobucketize_map(label, max_splits=3)),
        ("vectorize_geo", geo.vectorize_geo()),
        ("is_valid_email", em.is_valid_email()),
        ("email_prefix", em.email_prefix()),
        ("email_domain", em.email_domain()),
        ("url_domain", url.url_domain()),
        ("url_protocol", url.url_protocol()),
        ("is_valid_url", url.is_valid_url()),
        ("detect_mime_types", b64.detect_mime_types()),
        ("detect_mime_types_map", b64map.detect_mime_types_map()),
        ("is_valid_phone", ph.is_valid_phone()),
        ("is_valid_phone_map", phmap.is_valid_phone_map()),
        ("parse_phone", ph.parse_phone()),
    ]


PORTED = ["to_unit_circle", "to_unit_circle_map", "to_date_list",
          "to_date_time_list", "vectorize_dates", "filter_keys",
          "vectorize_map", "autobucketize_map", "vectorize_geo",
          "is_valid_email", "email_prefix", "email_domain", "url_domain",
          "url_protocol", "is_valid_url", "detect_mime_types",
          "detect_mime_types_map", "is_valid_phone", "is_valid_phone_map",
          "parse_phone"]


@pytest.fixture(scope="module")
def structured():
    out = {}
    for pkg, FB, U, Workflow, List, kw in (
            ("jax", JFB, JU, JWorkflow, JList, {}),
            ("torch", PFB, PU, PWorkflow, PList, {"device": "cpu"})):
        U.reset_uids()
        derived = _structured(FB)
        model = Workflow(**kw).set_reader(List(structured_records())) \
            .set_result_features(*[f for _, f in derived]).train()
        out[pkg] = (model, derived)
    return out


def assert_columns_equal(a, b, name, atol=None):
    """Vectors bit for bit with their metadata (or, given `atol`, their
    values within it); host columns (strings, lists, maps) equal; Binary
    columns equal, NaN where missing."""
    if a.data.dtype == object:
        assert list(b.data) == list(a.data), name
        return
    assert b.data.dtype == a.data.dtype, name
    assert b.data.shape == a.data.shape, name
    if atol is not None:
        np.testing.assert_allclose(b.data, a.data, rtol=0, atol=atol,
                                   err_msg=name)
        assert b.metadata.to_json() == a.metadata.to_json(), name
        return
    np.testing.assert_array_equal(b.data, a.data, err_msg=name)
    if a.data.ndim == 2:
        assert b.data.tobytes() == a.data.tobytes(), name
        assert b.metadata.to_json() == a.metadata.to_json(), name


def test_ported_names_leave_unported():
    assert len(set(PORTED)) == 20 and set(PORTED) <= set(_ops_table_names())
    assert len(set(TEXT_NAMES)) == 17 and \
        set(TEXT_NAMES) <= set(_ops_table_names())
    assert not set(PORTED) & set(TEXT_NAMES)
    assert not hasattr(PD, "UNPORTED")


@pytest.mark.parametrize("name", PORTED)
def test_ported_dsl_name_matches_jax(structured, name):
    (jm, jd), (pm, pd) = structured["jax"], structured["torch"]
    jf, pf = dict(jd)[name], dict(pd)[name]
    assert pf.name == jf.name and pf.type_name == jf.type_name
    assert_columns_equal(jm._train_data.column(jf.name),
                         pm._train_data.column(pf.name), name)


def test_jax_fitted_structured_stages_carry_over(structured):
    """The JAX-fitted date, map and geolocation stages (reference times,
    map plans, fills, bucket splits, unit-circle key sets), carried into
    the port by convert.workflow_model_from_jax, score new records as the
    JAX package does."""
    from transmogrifai_tpu_torch import convert
    jm, jd = structured["jax"]
    PU.reset_uids()
    pd = _structured(PFB)
    carried = convert.workflow_model_from_jax(
        [f for _, f in pd], [convert.stage_state(st) for st in jm.stages],
        device="cpu")
    new = structured_records(120, seed=11)
    a = jm.score(JList(new).generate_dataset(jm.raw_features()))
    b = carried.score(PList(new).generate_dataset(carried.raw_features()))
    for (name, jf), (_, pf) in zip(jd, pd):
        assert_columns_equal(a.column(jf.name), b.column(pf.name), name)
