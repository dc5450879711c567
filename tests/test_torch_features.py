"""The port's typed features, datasets and readers against the JAX package.

Both packages get the same seeded records. Tolerance: none — the raw
datasets are identical (host numpy float64 with NaN for missing numerics,
object arrays with None for missing strings and empty sets), and the
feature definitions, type inference and vector metadata agree exactly.
"""
import csv

import numpy as np
import pytest

import transmogrifai_tpu.data.dataset as JD
import transmogrifai_tpu.data.vector as JV
import transmogrifai_tpu.types as JT
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.features.builder import infer_feature_type as j_infer
from transmogrifai_tpu.readers.readers import CSVReader as JCSV
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU

import transmogrifai_tpu_torch.data.dataset as PD
import transmogrifai_tpu_torch.data.vector as PV
import transmogrifai_tpu_torch.types as PT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.features.builder import infer_feature_type as p_infer
from transmogrifai_tpu_torch.readers.readers import CSVReader as PCSV
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU

# (name, type name, raw value generator)
SCHEMA = [("age", "Real"), ("sibSp", "Integral"), ("alone", "Binary"),
          ("sex", "PickList"), ("cabin", "Text"), ("tags", "MultiPickList"),
          ("fare", "Currency"), ("survived", "RealNN")]


def records(n=300, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        miss = rng.uniform(size=8) < 0.15
        out.append({
            "age": None if miss[0] else float(rng.normal(30, 12)),
            "sibSp": None if miss[1] else int(rng.poisson(1.0)),
            "alone": None if miss[2] else bool(rng.uniform() < 0.5),
            "sex": None if miss[3] else str(rng.choice(["male", "female"])),
            "cabin": None if miss[4] else f"C{int(rng.integers(0, 40))}",
            "tags": {t for t in ("a", "b", "c") if rng.uniform() < 0.3},
            "fare": None if miss[6] else float(rng.lognormal(3, 1)),
            "survived": float(rng.uniform() < 0.4),
        })
    return out


def features(FB, U):
    U.reset_uids()
    out = []
    for name, tname in SCHEMA:
        b = getattr(FB, tname)(name)
        out.append(b.as_response() if tname == "RealNN" else b.as_predictor())
    return out


def assert_same_column(jc, pc):
    assert jc.kind == pc.kind
    if jc.data.dtype == object:
        assert pc.data.dtype == object
        assert list(jc.data) == list(pc.data)
    else:
        assert jc.data.dtype == pc.data.dtype
        np.testing.assert_array_equal(jc.data, pc.data)   # NaN at same rows


@pytest.mark.parametrize("name,tname", SCHEMA)
def test_list_reader_columns_identical(name, tname):
    recs = records()
    jds = JList(recs).generate_dataset(features(JFB, JU))
    pds = PList(recs).generate_dataset(features(PFB, PU))
    assert jds.column_names() == pds.column_names()
    assert jds.n_rows == pds.n_rows == len(recs)
    assert_same_column(jds.column(name), pds.column(name))


@pytest.mark.parametrize("header", [True, False])
def test_csv_reader_datasets_identical(tmp_path, header):
    recs = records(120, seed=3)
    names = ["age", "sibSp", "sex", "cabin", "survived"]
    path = tmp_path / "data.csv"
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        if header:
            w.writerow(names)
        for r in recs:
            w.writerow(["" if r[k] is None else r[k] for k in names])
    cols = None if header else names
    jr, pr = JCSV(str(path), columns=cols), PCSV(str(path), columns=cols)
    assert jr.read() == pr.read()
    keep = {"age", "sibSp", "sex", "cabin", "survived"}
    jf = [f for f in features(JFB, JU) if f.name in keep]
    pf = [f for f in features(PFB, PU) if f.name in keep]
    jds, pds = jr.generate_dataset(jf), pr.generate_dataset(pf)
    for n in names:
        assert_same_column(jds.column(n), pds.column(n))


def test_reader_key_column():
    recs = records(20)
    jds = JList(recs, key_fn=lambda r: r["cabin"]).generate_dataset(
        features(JFB, JU))
    pds = PList(recs, key_fn=lambda r: r["cabin"]).generate_dataset(
        features(PFB, PU))
    assert_same_column(jds.column("key"), pds.column("key"))


@pytest.mark.parametrize("tname", [
    "Real", "RealNN", "Integral", "Binary", "Percent", "Currency", "Date",
    "PickList", "Text", "Email", "MultiPickList", "TextList", "OPVector",
    "Geolocation", "RealMap", "Prediction"])
def test_type_registry_and_defaults(tname):
    jt, pt = JT.FeatureType.from_name(tname), PT.FeatureType.from_name(tname)
    assert pt.__name__ == jt.__name__
    assert pt.column_kind == jt.column_kind
    assert pt.is_non_nullable == jt.is_non_nullable
    assert [c.__name__ for c in pt.__mro__] == [c.__name__ for c in jt.__mro__]
    jv, pv = JT.default_of(jt), PT.default_of(pt)
    if isinstance(jv.value, np.ndarray):
        np.testing.assert_array_equal(jv.value, pv.value)
    else:
        assert jv.value == pv.value and jv.is_empty == pv.is_empty


@pytest.mark.parametrize("tname,raw", [
    ("Real", 1.5), ("Real", float("nan")), ("Real", None), ("Integral", 3.0),
    ("Binary", 0), ("Binary", float("nan")), ("Text", ""), ("Text", 7),
    ("PickList", "x"), ("MultiPickList", ["a", "b", "a"]),
    ("Geolocation", (10.0, 20.0, 1.0)), ("OPVector", [1.0, 2.0])])
def test_type_conversion(tname, raw):
    jv = JT.make(JT.FeatureType.from_name(tname), raw)
    pv = PT.make(PT.FeatureType.from_name(tname), raw)
    if isinstance(jv.value, np.ndarray):
        np.testing.assert_array_equal(jv.value, pv.value)
    else:
        assert jv.value == pv.value
    assert jv.is_empty == pv.is_empty


def test_realnn_rejects_empty_and_prediction_keys():
    with pytest.raises(ValueError):
        PT.RealNN(None)
    p = PT.Prediction(prediction=1.0, raw_prediction=[-2.0, 2.0],
                      probability=[0.1, 0.9])
    j = JT.Prediction(prediction=1.0, raw_prediction=[-2.0, 2.0],
                      probability=[0.1, 0.9])
    assert p.value == j.value and p.score == j.score


def test_dataset_operations_agree():
    recs = records(50, seed=5)
    schema_j = {n: JT.FeatureType.from_name(t) for n, t in SCHEMA}
    schema_p = {n: PT.FeatureType.from_name(t) for n, t in SCHEMA}
    jds = JD.Dataset.from_dicts(recs, schema_j)
    pds = PD.Dataset.from_dicts(recs, schema_p)
    idx = np.array([3, 1, 4, 1, 5, 9, 2, 6])
    for op in (lambda d: d.take(idx), lambda d: d.select(["age", "sex"]),
               lambda d: d.drop(["cabin"])):
        a, b = op(jds), op(pds)
        assert a.column_names() == b.column_names() and a.n_rows == b.n_rows
        for n in a.column_names():
            assert_same_column(a.column(n), b.column(n))
    assert repr(jds) == repr(pds)
    assert str(jds.head(3)) == str(pds.head(3))
    with pytest.raises(ValueError):
        pds.with_column("bad", PD.Column(kind="float", data=np.zeros(3)))


def test_vector_metadata_agrees():
    def md(V):
        cols = [V.VectorColumnMetadata("a", "Real"),
                V.VectorColumnMetadata("a", "Real",
                                       indicator_value=V.NULL_STRING),
                V.VectorColumnMetadata("s", "PickList", grouping="s",
                                       indicator_value="x"),
                V.VectorColumnMetadata("s", "PickList", grouping="s",
                                       indicator_value=V.OTHER_STRING)]
        m = V.VectorMetadata("v", cols)
        both = V.VectorMetadata.concat("w", [m, m.select([2, 0])])
        return m, both
    (jm, jb), (pm, pb) = md(JV), md(PV)
    assert jm.to_json() == pm.to_json() and jb.to_json() == pb.to_json()
    assert jb.column_names() == pb.column_names()
    assert jb.parent_features() == pb.parent_features()


@pytest.mark.parametrize("values", [
    [1, 0, 1, None], [1, 2, 5], [0.5, None, 2.0], ["a", "b", "a", None],
    [f"id{i}" for i in range(200)], [["x", "y"], ["z"]], [(1.0, 2.0, 3.0)],
    [{"a", "b"}], [{"k": 1.0}], [{"k": "v"}], [None, None], [True, False]])
def test_type_inference_agrees(values):
    assert p_infer(values).__name__ == j_infer(values).__name__


def test_feature_builder_graph_agrees():
    JU.reset_uids()
    jresp, jfeats = JFB.from_rows(records(40), response="survived")
    PU.reset_uids()
    presp, pfeats = PFB.from_rows(records(40), response="survived")
    assert (jresp.name, jresp.type_name, jresp.uid) == \
        (presp.name, presp.type_name, presp.uid)
    assert [(f.name, f.type_name, f.is_response, f.is_raw, f.uid)
            for f in jfeats] == \
        [(f.name, f.type_name, f.is_response, f.is_raw, f.uid)
         for f in pfeats]
    assert jresp.origin_stage.uid == presp.origin_stage.uid
    assert jresp.origin_stage.extract({"survived": 1}) == \
        presp.origin_stage.extract({"survived": 1})


def test_feature_builder_rejects_named_aggregators():
    # named aggregators are ported now: a name builds the JAX package's
    # monoid, an unknown one raises as there
    assert PFB.Real("x").aggregate("sum").as_predictor().origin_stage \
        .aggregator.aggregator.reduce([1.0, None, 2.0]) == 3.0
    with pytest.raises(ValueError, match="Unknown aggregator"):
        PFB.Real("x").aggregate("median")
    with pytest.raises(ValueError, match="Unknown aggregator"):
        JFB.Real("x").aggregate("median")
    agg = PFB.Real("x").aggregate(lambda a, b: (a or 0) + b).as_predictor()
    assert agg.origin_stage.aggregator.aggregator.reduce([1.0, 2.0]) == 3.0
