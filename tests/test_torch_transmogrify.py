"""transmogrify() in the port against the JAX package.

Both packages get the same seeded records and build the same features with
their uid counters reset, so vector and column names agree too. Tolerance:
none — both vectorize on the host in numpy float32, so the transmogrified
matrix is bit-identical and the vector metadata identical, for every
type group, with null tracking on and off, on the train path (fit +
columnar transform) and the score path (combiner sinks): the numeric and
categorical groups here at length, the date, map, geolocation and
structured text groups one case each, and every other OPMap subtype and
DateTimeList on the train path.
"""
import numpy as np
import pytest

from transmogrifai_tpu.automl.transmogrifier import (
    TransmogrifierDefaults as JDefaults, transmogrify as j_transmogrify)
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.transmogrifier import (
    TransmogrifierDefaults as PDefaults, transmogrify as p_transmogrify)
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

GROUPS = {
    "real": [("age", "Real"), ("fare", "Currency"), ("pct", "Percent")],
    "integral": [("sibSp", "Integral"), ("parCh", "Integral")],
    "binary": [("alone", "Binary")],
    "realnn": [("score", "RealNN")],
    "categorical": [("sex", "PickList"), ("port", "PickList"),
                    ("cabin", "ComboBox")],
    "multipicklist": [("tags", "MultiPickList")],
}


def records(n=600, seed=0):
    rng = np.random.default_rng(seed)
    cabins = [f"C{i}" for i in range(40)]
    out = []
    for _ in range(n):
        m = rng.uniform(size=10) < 0.12
        out.append({
            "age": None if m[0] else float(rng.normal(30, 12)),
            "fare": None if m[1] else float(rng.lognormal(3, 1)),
            "pct": None if m[2] else float(rng.uniform()),
            "sibSp": None if m[3] else int(rng.poisson(0.7)),
            "parCh": None if m[4] else int(rng.poisson(0.4)),
            "alone": None if m[5] else bool(rng.uniform() < 0.6),
            "score": float(rng.normal()),
            "sex": None if m[6] else str(rng.choice(["male", "Female",
                                                     "female!"])),
            "port": None if m[7] else str(rng.choice(
                ["S", "C", "Q", "X"], p=[0.6, 0.25, 0.13, 0.02])),
            "cabin": None if m[8] else str(rng.choice(cabins)),
            "tags": None if m[9] else {t for t in ("vip", "crew", "Kid", "x")
                                       if rng.uniform() < 0.35},
        })
    return out


def make_vector(FB, U, transmogrify, Defaults, groups, track_nulls):
    U.reset_uids()
    feats = [getattr(FB, t)(n).as_predictor()
             for g in groups for n, t in GROUPS[g]]
    return transmogrify(feats, defaults=Defaults(track_nulls=track_nulls))


def fit_both(groups, track_nulls, recs=None):
    recs = recs or records()
    jvec = make_vector(JFB, JU, j_transmogrify, JDefaults, groups, track_nulls)
    pvec = make_vector(PFB, PU, p_transmogrify, PDefaults, groups, track_nulls)
    jm = JWorkflow().set_reader(JList(recs)).set_result_features(jvec).train()
    pm = PWorkflow(device="cpu").set_reader(PList(recs)) \
        .set_result_features(pvec).train()
    return jvec, pvec, jm, pm


CASES = [[g] for g in GROUPS] + [list(GROUPS)]


@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("groups", CASES, ids=["+".join(c) for c in CASES])
def test_matrix_and_metadata_identical(groups, track_nulls):
    jvec, pvec, jm, pm = fit_both(groups, track_nulls)
    assert jvec.name == pvec.name
    jc, pc = jm._train_data.column(jvec.name), pm._train_data.column(pvec.name)
    assert jc.data.dtype == pc.data.dtype == np.float32
    assert jc.data.shape == pc.data.shape
    assert jc.data.tobytes() == pc.data.tobytes()          # bit-identical
    assert jc.metadata.to_json() == pc.metadata.to_json()
    # the score path (combiner sinks) gives the train path's matrix
    new = records(200, seed=9)
    js = jm.score(JList(new).generate_dataset(jm.raw_features()))
    ps = pm.score(PList(new).generate_dataset(pm.raw_features()))
    assert js.data(jvec.name).tobytes() == ps.data(pvec.name).tobytes()


@pytest.mark.parametrize("group", ["real", "integral", "categorical",
                                   "multipicklist"])
def test_row_level_matches_columnar(group):
    _, pvec, _, pm = fit_both([group], True)
    st = pm.stages[0]
    ds = pm._train_data
    cols = [ds.column(n) for n in st.input_names()]
    block = st.transform_columns(*cols).data
    types = [f.feature_type for f in st.input_features]
    for i in (0, 5, 17):
        vals = [t(c.data[i] if not (isinstance(c.data[i], float)
                                     and np.isnan(c.data[i])) else None)
                for c, t in zip(cols, types)]
        np.testing.assert_array_equal(st.transform_value(*vals).value,
                                      block[i])


def test_vocabulary_order_and_ties():
    """Top-K keeps count-descending, then value-ascending order; min
    support drops rare values; cleaning merges 'Female' and 'female!'."""
    recs = [{"sex": s} for s in ["b"] * 12 + ["a"] * 12 + ["Female"] * 6
            + ["female!"] * 6 + ["rare"] * 3]
    JU.reset_uids()
    jv = j_transmogrify([JFB.PickList("sex").as_predictor()])
    PU.reset_uids()
    pv = p_transmogrify([PFB.PickList("sex").as_predictor()])
    jm = JWorkflow().set_reader(JList(recs)).set_result_features(jv).train()
    pm = PWorkflow(device="cpu").set_reader(PList(recs)) \
        .set_result_features(pv).train()
    assert pm.stages[0].vocabs == jm.stages[0].vocabs == [["a", "b",
                                                           "female"]]


# the date, map, geolocation and structured text groups, one feature each
# beside a Real, on seeded values with their awkward cases: pre-1970 and
# missing dates, empty date lists, invalid emails and URLs, short phone
# numbers, empty and undecodable payloads, missing keys and locations
_MIME_HEADS = [b"\x89PNG\r\n", b"%PDF-1.4", b"GIF89a", b'{"a": 1}',
               b"PK\x03\x04"]


def _group_value(tname, rng):
    import base64
    u = rng.uniform()
    if tname == "Base64":
        if u < 0.2:
            return None if u < 0.1 else ""
        if u < 0.3:
            return base64.b64encode(rng.bytes(12)).decode()
        return base64.b64encode(_MIME_HEADS[rng.integers(5)]
                                + rng.bytes(6)).decode()
    if tname in ("Date", "DateTime"):
        return None if u < 0.1 else int(rng.integers(-10**11, 2 * 10**12))
    if tname == "DateList":
        return [int(v) for v in rng.integers(-10**10, 2 * 10**12,
                                             size=rng.integers(0, 6))]
    if tname == "Email":
        return (None if u < 0.1 else "not-an-email" if u < 0.15 else
                f"user{rng.integers(300)}@dom{rng.integers(12)}.com")
    if tname == "URL":
        return (None if u < 0.1 else "nope" if u < 0.15 else
                f"{rng.choice(['http', 'https', 'ftp'])}://"
                f"site{rng.integers(12)}.org/p")
    if tname == "Phone":
        return (None if u < 0.1 else "12345" if u < 0.2 else str(rng.choice(
            ["(415) 555-0134", "+44 20 7946 0958", "+49 30 1234567",
             "030 1234567"])))
    if tname == "TextMap":
        m = {}
        if rng.uniform() < 0.8:
            m["color"] = str(rng.choice(["red", "Blue", "green"]))
        if rng.uniform() < 0.8:
            m["note"] = f"free text {rng.integers(100)}"
        return m or None
    if tname == "Geolocation":
        return None if u < 0.1 else [float(rng.uniform(-60, 60)),
                                     float(rng.uniform(-170, 170)),
                                     float(rng.integers(1, 6))]
    if tname == "RealMap":
        return {k: float(rng.normal()) for k, p in (("k0", 0.9), ("k1", 0.5))
                if rng.uniform() < p}
    assert tname == "PickListMap"
    return {k: str(rng.choice(["a", "b", "c", "dd"])) for k in "pqr"
            if rng.uniform() < 0.8}


def group_records(tname, n=600, seed=0):
    rng = np.random.default_rng(seed)
    return [{"age": float(rng.normal()), "x": _group_value(tname, rng)}
            for _ in range(n)]


@pytest.mark.parametrize("tname", ["Base64", "DateList", "Email", "URL",
                                   "Phone", "Date", "DateTime", "TextMap",
                                   "Geolocation", "RealMap", "PickListMap"])
def test_ported_group_matches_jax(tname):
    """The group's default vectorizer (after its derivation for Email, URL,
    Base64 and Phone) gives the JAX package's matrix bit for bit and its
    metadata, on the train path and the score path."""
    def vector(FB, U, tm, Defaults):
        U.reset_uids()
        return tm([FB.Real("age").as_predictor(),
                   getattr(FB, tname)("x").as_predictor()],
                  defaults=Defaults(reference_date_ms=1.6e12))
    recs = group_records(tname)
    jvec = vector(JFB, JU, j_transmogrify, JDefaults)
    pvec = vector(PFB, PU, p_transmogrify, PDefaults)
    jm = JWorkflow().set_reader(JList(recs)).set_result_features(jvec).train()
    pm = PWorkflow(device="cpu").set_reader(PList(recs)) \
        .set_result_features(pvec).train()
    assert jvec.name == pvec.name
    jc, pc = jm._train_data.column(jvec.name), pm._train_data.column(pvec.name)
    assert pc.data.dtype == np.float32 and pc.data.shape == jc.data.shape
    assert pc.data.shape[1] > 2
    assert jc.data.tobytes() == pc.data.tobytes()
    assert jc.metadata.to_json() == pc.metadata.to_json()
    new = group_records(tname, 200, seed=9)
    js = jm.score(JList(new).generate_dataset(jm.raw_features()))
    ps = pm.score(PList(new).generate_dataset(pm.raw_features()))
    assert js.data(jvec.name).tobytes() == ps.data(pvec.name).tobytes()


def _map_value(tname, rng):
    """A map row of `tname` over keys a, b, c (each present 70% of rows)."""
    def one():
        if tname == "BinaryMap":
            return bool(rng.uniform() < 0.4)
        if tname in ("IntegralMap", "DateMap", "DateTimeMap"):
            return int(rng.integers(-10**11, 2 * 10**12))
        if tname in ("RealMap", "PercentMap", "CurrencyMap"):
            return float(rng.normal())
        if tname == "MultiPickListMap":
            return {t for t in ("x", "Y", "z") if rng.uniform() < 0.4}
        if tname == "GeolocationMap":
            return [float(rng.uniform(-60, 60)),
                    float(rng.uniform(-170, 170)), float(rng.integers(1, 6))]
        return str(rng.choice(["red", "Blue", "green!", "rare"],
                              p=[0.4, 0.3, 0.27, 0.03]))
    return {k: one() for k in "abc" if rng.uniform() < 0.7} or None


MAP_TYPES = ["EmailMap", "Base64Map", "PhoneMap", "IDMap", "URLMap",
             "TextAreaMap", "ComboBoxMap", "CountryMap", "StateMap", "CityMap",
             "PostalCodeMap", "StreetMap", "BinaryMap", "IntegralMap",
             "PercentMap", "CurrencyMap", "DateMap", "DateTimeMap",
             "MultiPickListMap", "GeolocationMap"]


@pytest.mark.parametrize("tname", MAP_TYPES + ["DateTimeList"])
def test_every_map_type_and_datetime_list_match_jax(tname):
    """Every other OPMap subtype (through its map_<type> group) and the
    DateTimeList group give the JAX package's matrix and metadata."""
    rng = np.random.default_rng(7)
    recs = [{"age": float(rng.normal()),
             "x": (_group_value("DateList", rng) if tname == "DateTimeList"
                   else _map_value(tname, rng))} for _ in range(400)]

    def vector(FB, U, tm, Defaults):
        U.reset_uids()
        return tm([FB.Real("age").as_predictor(),
                   getattr(FB, tname)("x").as_predictor()],
                  defaults=Defaults(reference_date_ms=1.6e12))
    jvec = vector(JFB, JU, j_transmogrify, JDefaults)
    pvec = vector(PFB, PU, p_transmogrify, PDefaults)
    jm = JWorkflow().set_reader(JList(recs)).set_result_features(jvec).train()
    pm = PWorkflow(device="cpu").set_reader(PList(recs)) \
        .set_result_features(pvec).train()
    jc, pc = jm._train_data.column(jvec.name), pm._train_data.column(pvec.name)
    assert pc.data.shape == jc.data.shape and pc.data.shape[1] > 2
    assert jc.data.tobytes() == pc.data.tobytes()
    assert jc.metadata.to_json() == pc.metadata.to_json()
