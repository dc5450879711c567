"""The map and geolocation stages of the port against the JAX package.

MapVectorizer of every kind (real and integral, binary, categorical,
multi-pick-list, smart text with a pivoted and a hashed key, geolocation),
with keys cleaned and not, keys blocked and allowed, and keys absent at
transform; FilterMapKeys; DecisionTreeNumericMapBucketizer;
DateMapUnitCircleVectorizer; PhoneValidityMap and MimeTypeMap;
GeolocationVectorizer with missing locations. Tolerances: blocks
bit-identical and metadata identical; what the JAX package computes as a
float64 (map fills, geo means, bucket splits) exactly equal; host outputs
(maps) equal.
"""
import base64

import numpy as np
import pytest

from transmogrifai_tpu.automl.vectorizers import geo as JG
from transmogrifai_tpu.automl.vectorizers import maps as JMaps
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.transformers import misc as JM
from transmogrifai_tpu.utils import uid as JU
import transmogrifai_tpu.types as JT

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.vectorizers import geo as PG
from transmogrifai_tpu_torch.automl.vectorizers import maps as PMaps
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.transformers import misc as PM
from transmogrifai_tpu_torch.utils import uid as PU
import transmogrifai_tpu_torch.types as PT

JAX = dict(FB=JFB, U=JU, Dataset=JDataset, T=JT, maps=JMaps, geo=JG, misc=JM)
PORT = dict(FB=PFB, U=PU, Dataset=PDataset, T=PT, maps=PMaps, geo=PG,
            misc=PM)
PHONES = ["(415) 555-0134", "+44 20 7946 0958", "+49 30 1234567", "555-01",
          "030 1234567", "+1 415 555 0134", "", None]
HEADS = [b"\x89PNG\r\n", b"%PDF-1.4", b"GIF89a", b"PK\x03\x04", b"{",
         b"\x1f\x8b", b"<?xml"]


def _value(tname, rng):
    keys = ["Alpha", "alpha!", "beta", "gamma"]
    m = {}
    for k in keys:
        if rng.uniform() < 0.3:
            continue
        if tname in ("RealMap", "IntegralMap", "CurrencyMap"):
            v = float(rng.normal()) if tname != "IntegralMap" \
                else int(rng.integers(0, 5))
        elif tname == "BinaryMap":
            v = bool(rng.uniform() < 0.4)
        elif tname == "PickListMap":
            v = str(rng.choice(["red", "Red!", "green", "blue", "rare"],
                               p=[0.3, 0.2, 0.3, 0.17, 0.03]))
        elif tname == "MultiPickListMap":
            v = {t for t in ("x", "Y", "z") if rng.uniform() < 0.4}
        elif tname == "TextMap":
            v = (str(rng.choice(["yes", "no"])) if k != "beta"
                 else f"free text number {rng.integers(200)}")
        elif tname == "GeolocationMap":
            v = [float(rng.uniform(-60, 60)), float(rng.uniform(-170, 170)),
                 float(rng.integers(1, 6))]
        elif tname == "PhoneMap":
            v = PHONES[rng.integers(len(PHONES))]
        elif tname == "Base64Map":
            v = base64.b64encode(HEADS[rng.integers(len(HEADS))]
                                 + rng.bytes(5)).decode()
        else:
            assert tname == "DateMap"
            v = int(rng.integers(-10**11, 2 * 10**12))
        m[k] = v
    return m or (None if rng.uniform() < 0.5 else {})


def map_values(tname, n=400, seed=0):
    rng = np.random.default_rng(seed)
    return [_value(tname, rng) for _ in range(n)]


def run(pkg, tname, values, make, new=None, label=None):
    """The stage `make(pkg, feature[, label])` builds, fitted on `values`
    (with `label` as a RealNN response where given) and run on `new` (or
    on `values`): (fitted stage, output column)."""
    pkg["U"].reset_uids()
    FB, T = pkg["FB"], pkg["T"]
    f = getattr(FB, tname)("m").as_predictor()
    pairs = [("m", getattr(T, tname), values)]
    if label is not None:
        y = FB.RealNN("y").as_response()
        stage = make(pkg, f, y)
        pairs = [("y", T.RealNN, label)] + pairs
    else:
        stage = make(pkg, f)
    if pkg is PORT:   # the split search runs on the stage's device
        stage.device = "cpu"
    ds = pkg["Dataset"].from_features(pairs)
    model = stage.fit(ds) if hasattr(stage, "fit") else stage
    if new is not None:
        ds = pkg["Dataset"].from_features(
            [(n, t, (new if n == "m" else [0.0] * len(new)))
             for n, t, _ in pairs])
    return model, model.transform(ds).column(model.output_name())


def assert_same(a, b):
    if a.data.dtype == object:
        assert list(b.data) == list(a.data)
        return
    assert b.data.dtype == a.data.dtype and b.data.shape == a.data.shape
    assert b.data.tobytes() == a.data.tobytes()
    assert b.metadata.to_json() == a.metadata.to_json()


KINDS = ["RealMap", "IntegralMap", "CurrencyMap", "BinaryMap",
         "PickListMap", "MultiPickListMap", "TextMap", "GeolocationMap"]


@pytest.mark.parametrize("clean_keys", [False, True])
@pytest.mark.parametrize("tname", KINDS)
def test_map_vectorizer_every_kind(tname, clean_keys):
    def make(pkg, f):
        return pkg["maps"].MapVectorizer(
            clean_keys=clean_keys, max_cardinality=30, num_features=16,
            min_support=5).set_input(f)
    (ja, a), (pb, b) = (run(pkg, tname, map_values(tname), make,
                            new=map_values(tname, 150, 3))
                        for pkg in (JAX, PORT))
    assert_same(a, b)
    assert pb.save_args()["feature_plans"] == ja.save_args()["feature_plans"]
    if tname == "TextMap":    # one pivoted key, one hashed key
        vocab = pb.feature_plans[0]["vocab"]
        assert vocab["beta"] is None and vocab["gamma"]


def test_map_keys_blocked_allowed_and_absent_at_transform():
    def make(pkg, f):
        return pkg["maps"].MapVectorizer(
            allow_listed_keys=["Alpha", "beta", "gamma"],
            block_listed_keys=["gamma"]).set_input(f)
    new = [{"delta": 9.0}, {}, None, {"beta": 1.5}]
    (_, a), (pb, b) = (run(pkg, "RealMap", map_values("RealMap"), make,
                           new=new) for pkg in (JAX, PORT))
    assert_same(a, b)
    assert pb.feature_plans[0]["keys"] == ["Alpha", "beta"]
    assert np.isfinite(b.data).all() and b.data.shape == (4, 4)
    # an absent key takes its fill and raises its null indicator
    fills = pb.feature_plans[0]["fills"]
    assert b.data[0].tolist() == [np.float32(fills["Alpha"]), 1.0,
                                  np.float32(fills["beta"]), 1.0]


@pytest.mark.parametrize("kw", [dict(block=["beta"]),
                                dict(allow=["Alpha", "gamma"]),
                                dict(allow=["gamma"], block=["gamma"])])
def test_filter_map_keys(kw):
    def make(pkg, f):
        return pkg["misc"].FilterMapKeys(**kw).set_input(f)
    (_, a), (st, b) = (run(pkg, "PickListMap", map_values("PickListMap"),
                           make) for pkg in (JAX, PORT))
    assert_same(a, b)
    assert st.get_output().type_name == "PickListMap"


def bucket_fixture(n=400, seed=3):
    """k0 predicts the label with a boundary at 0; k1 is noise; k2 is
    missing half the time (tests/test_map_bucketizer_dsl.py)."""
    rng = np.random.default_rng(seed)
    rows, labels = [], []
    for i in range(n):
        x = float(rng.normal())
        m = {"k0": x, "k1": float(rng.normal())}
        if i % 2 == 0:
            m["k2"] = float(rng.normal())
        rows.append(m)
        labels.append(float(x > 0))
    return rows, labels


@pytest.mark.parametrize("kw", [dict(max_splits=7), dict(track_nulls=False)])
def test_decision_tree_map_bucketizer(kw):
    rows, labels = bucket_fixture()

    def make(pkg, f, y):
        return pkg["misc"].DecisionTreeNumericMapBucketizer(
            **kw).set_input(y, f)
    (ja, a), (pb, b) = (run(pkg, "RealMap", rows, make, label=labels)
                        for pkg in (JAX, PORT))
    assert pb.keys == ja.keys == ["k0", "k1", "k2"]
    # the splits are the JAX package's float64 thresholds, exactly
    assert [s.tolist() for s in pb.splits_per_key] == \
        [s.tolist() for s in ja.splits_per_key]
    assert any(abs(s) < 0.25 for s in pb.splits_per_key[0])
    assert_same(a, b)
    if kw.get("track_nulls", True):
        null = [i for i, c in enumerate(b.metadata.columns)
                if c.grouping == "k2" and c.is_null_indicator]
        assert b.data[1, null[0]] == 1.0 and b.data[0, null[0]] == 0.0
    # the per-row path gives the column's rows, and the stage rebuilt from
    # its save_args (the converter's route) gives the same block
    for i in (0, 1, 7):
        np.testing.assert_array_equal(pb.transform_value(
            PT.RealNN(labels[i]), PT.RealMap(rows[i])).value, b.data[i])
    from transmogrifai_tpu_torch.stages.registry import build_stage
    rebuilt = build_stage(type(pb).__name__, pb.save_args())
    rebuilt.set_input(*pb.input_features)
    rebuilt.set_output_name(pb.output_name())
    ds = PDataset.from_features([("y", PT.RealNN, labels),
                                 ("m", PT.RealMap, rows)])
    assert rebuilt.transform(ds).column(pb.output_name()).data.tobytes() \
        == b.data.tobytes()


@pytest.mark.parametrize("period", ["HourOfDay", "DayOfWeek",
                                    "MonthOfYear"])
def test_date_map_unit_circle(period):
    def make(pkg, f):
        return pkg["maps"].DateMapUnitCircleVectorizer(
            time_period=period, clean_keys=True,
            block_listed_keys=["gamma"]).set_input(f)
    (ja, a), (pb, b) = (run(pkg, "DateMap", map_values("DateMap"), make,
                            new=map_values("DateMap", 100, 4))
                        for pkg in (JAX, PORT))
    assert pb.key_sets == ja.key_sets == [["alpha", "beta"]]
    assert_same(a, b)


@pytest.mark.parametrize("tname,cls", [("PhoneMap", "PhoneValidityMap"),
                                       ("Base64Map", "MimeTypeMap")])
def test_phone_and_mime_maps(tname, cls):
    def make(pkg, f):
        return getattr(pkg["misc"], cls)().set_input(f)
    (_, a), (_, b) = (run(pkg, tname, map_values(tname), make)
                      for pkg in (JAX, PORT))
    assert_same(a, b)
    assert any(m for m in b.data)


def test_geolocation_vectorizer_with_missing_values():
    rng = np.random.default_rng(2)
    values = [[37.7, -122.4, 5.0], None, [40.7, -74.0, 3.0], []] + [
        None if rng.uniform() < 0.2 else
        [float(rng.uniform(-80, 80)), float(rng.uniform(-179, 179)),
         float(rng.integers(1, 6))] for _ in range(300)]

    def make(pkg, f):
        return pkg["geo"].GeolocationVectorizer().set_input(f)
    (ja, a), (pb, b) = (run(pkg, "Geolocation", values, make)
                        for pkg in (JAX, PORT))
    assert pb.fills == ja.fills           # the spherical means, exactly
    assert_same(a, b)
    assert np.isfinite(b.data).all()
    assert b.data[1, 3] == b.data[3, 3] == 1.0 and b.data[0, 3] == 0.0
    assert PG.geo_mean([]) == JG.geo_mean([]) == [0.0, 0.0, 0.0]


def test_map_vectorizer_for_each_map_type():
    from transmogrifai_tpu.automl.transmogrifier import DEFAULTS as JDEF
    from transmogrifai_tpu_torch.automl.transmogrifier import \
        DEFAULTS as PDEF
    a = JMaps.map_vectorizer_for("TextMap", JDEF)
    b = PMaps.map_vectorizer_for("TextMap", PDEF)
    assert b.param_values() == a.param_values()
