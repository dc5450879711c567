"""The port's testkit (transmogrifai_tpu_torch/testkit/) against the JAX
package's, on the CPU.

Mirrors tests/test_testkit.py case by case. Every generator draws the
same values from the same seed in both packages (the same FeatureType
class names, values equal, empties in the same places), and keeps the
reference's distribution checks; TestFeatureBuilder builds the same
columns and features; assert_feature / assert_transforms pass and fail
on the same declarations; format_table renders the same text.
"""
import numpy as np
import pytest

from transmogrifai_tpu import testkit as J

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import testkit as P
from transmogrifai_tpu_torch.types import (
    Binary, Country, Email, Geolocation, Integral, MultiPickList, PickList,
    Real, RealNN, TextList, TextMap,
)


def _same_draws(make, n):
    """`make(pkg)` -> a generator of each package; both draw n values."""
    got, want = make(P).take(n), make(J).take(n)
    assert [type(v).__name__ for v in got] \
        == [type(v).__name__ for v in want]
    for g, w in zip(got, want):
        gv, wv = g.value, w.value
        if isinstance(gv, np.ndarray):
            np.testing.assert_array_equal(gv, wv)
        else:
            assert gv == wv
        assert g.is_empty == w.is_empty
    return got


GENERATORS = {
    "normal": lambda k: k.RandomReal.normal(mean=5.0, sigma=2.0, seed=1),
    "uniform_empty": lambda k: k.RandomReal.uniform(seed=2)
    .with_probability_of_empty(0.3),
    "poisson": lambda k: k.RandomReal.poisson(3.0, seed=3),
    "exponential": lambda k: k.RandomReal.exponential(seed=4),
    "gamma": lambda k: k.RandomReal.gamma(seed=5),
    "lognormal": lambda k: k.RandomReal.lognormal(seed=6),
    "weibull": lambda k: k.RandomReal.weibull(seed=7),
    "normal_nn": lambda k: k.RandomReal.normal_nn(seed=8),
    "currencies": lambda k: k.RandomReal.currencies(seed=9),
    "percents": lambda k: k.RandomReal.percents(seed=10),
    "integrals": lambda k: k.RandomIntegral.integrals(0, 10, seed=3),
    "dates": lambda k: k.RandomIntegral.dates(seed=11),
    "datetimes": lambda k: k.RandomIntegral.datetimes(seed=12),
    "binary": lambda k: k.RandomBinary(probability_of_success=0.8, seed=4),
    "strings": lambda k: k.RandomText.strings(seed=13),
    "textareas": lambda k: k.RandomText.textareas(seed=14),
    "names": lambda k: k.RandomText.names(seed=15),
    "emails": lambda k: k.RandomText.emails(seed=5),
    "urls": lambda k: k.RandomText.urls(seed=16),
    "phones": lambda k: k.RandomText.phones(seed=8),
    "ids": lambda k: k.RandomText.ids(seed=17),
    "countries": lambda k: k.RandomText.countries(seed=6),
    "states": lambda k: k.RandomText.states(seed=18),
    "cities": lambda k: k.RandomText.cities(seed=19),
    "streets": lambda k: k.RandomText.streets(seed=20),
    "postal_codes": lambda k: k.RandomText.postal_codes(seed=21),
    "pick_lists": lambda k: k.RandomText.pick_lists(["a", "b", "c"],
                                                    seed=7),
    "combo_boxes": lambda k: k.RandomText.combo_boxes(["x", "y"], seed=22),
    "base64": lambda k: k.RandomText.base64(seed=23),
    "list_texts": lambda k: k.RandomList.of_texts(1, 4, seed=9),
    "list_dates": lambda k: k.RandomList.of_dates(seed=24),
    "sets": lambda k: k.RandomSet.of(["x", "y", "z"], 1, 3, seed=10),
    "map_reals": lambda k: k.RandomMap.of_reals(["k1", "k2"], seed=25),
    "map_texts": lambda k: k.RandomMap.of_texts(["k1", "k2"], seed=11),
    "map_geos": lambda k: k.RandomMap.of_geolocations(["a"], seed=26),
    "vectors": lambda k: k.RandomVector.normal(8, seed=13),
    "dense": lambda k: k.RandomVector.dense(4, seed=27),
    "geolocations": lambda k: k.RandomGeolocation(seed=12),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_draws_match_the_jax_package(name):
    _same_draws(GENERATORS[name], 200)


class TestGenerators:
    def test_normal_reals_shape_and_type(self):
        vals = _same_draws(GENERATORS["normal"], 2000)
        assert all(isinstance(v, Real) for v in vals)
        arr = np.array([v.value for v in vals])
        assert abs(arr.mean() - 5.0) < 0.2
        assert abs(arr.std() - 2.0) < 0.2

    def test_probability_of_empty(self):
        vals = _same_draws(GENERATORS["uniform_empty"], 3000)
        frac = sum(1 for v in vals if v.is_empty) / len(vals)
        assert 0.25 < frac < 0.35

    def test_reproducible_with_reset(self):
        g = P.RandomReal.normal(seed=7)
        a = [v.value for v in g.take(10)]
        assert a == [v.value for v in g.reset().take(10)]
        assert a == [v.value for v in J.RandomReal.normal(seed=7).take(10)]
        assert [v.value for v in g.reset(8).take(3)] \
            == [v.value for v in J.RandomReal.normal(seed=8).take(3)]
        assert [v.value for v in g.reset(8).limit(3)] \
            == [v.value for v in g.reset(8).take(3)]

    def test_integrals_and_binary(self):
        ints = _same_draws(GENERATORS["integrals"], 500)
        assert all(isinstance(v, Integral) and 0 <= v.value < 10
                   for v in ints)
        bins = _same_draws(GENERATORS["binary"], 1000)
        assert all(isinstance(v, Binary) for v in bins)
        assert 0.75 < sum(1 for v in bins if v.value) / 1000 < 0.85

    def test_text_families(self):
        emails = _same_draws(GENERATORS["emails"], 20)
        assert all(isinstance(v, Email) and "@" in v.value for v in emails)
        countries = _same_draws(GENERATORS["countries"], 20)
        assert all(isinstance(v, Country) for v in countries)
        picks = _same_draws(GENERATORS["pick_lists"], 50)
        assert {v.value for v in picks} <= {"a", "b", "c"}
        phones = _same_draws(GENERATORS["phones"], 5)
        assert all(v.value.startswith("+1") and len(v.value) == 12
                   for v in phones)

    def test_collections_and_maps(self):
        lists = _same_draws(GENERATORS["list_texts"], 30)
        assert all(isinstance(v, TextList) and 1 <= len(v.value) <= 4
                   for v in lists)
        sets_ = _same_draws(GENERATORS["sets"], 30)
        assert all(isinstance(v, MultiPickList) for v in sets_)
        maps = _same_draws(GENERATORS["map_texts"], 30)
        assert all(isinstance(v, TextMap) for v in maps)
        geos = _same_draws(GENERATORS["geolocations"], 10)
        assert all(isinstance(v, Geolocation) and len(v.value) == 3
                   for v in geos)

    def test_vectors(self):
        vecs = _same_draws(GENERATORS["vectors"], 10)
        assert all(len(v.value) == 8 for v in vecs)


def _same_dataset(got, want):
    ds, feats = got
    jds, jfeats = want
    assert ds.n_rows == jds.n_rows
    assert ds.column_names() == jds.column_names()
    for name in ds.column_names():
        a, b = ds.column(name), jds.column(name)
        assert a.kind == b.kind
        if a.data.dtype.kind == "f":
            np.testing.assert_array_equal(a.data, b.data)
        else:
            assert list(a.data) == list(b.data)
    assert [(f.name, f.is_response, f.feature_type.__name__)
            for f in feats] == [(f.name, f.is_response,
                                 f.feature_type.__name__) for f in jfeats]


class TestTestFeatureBuilder:
    def test_build_from_literals(self):
        got = P.TestFeatureBuilder.build(
            ("age", Real, [20.0, 30.0, None]),
            ("label", RealNN, [0.0, 1.0, 1.0]), response_index=1)
        from transmogrifai_tpu import types as JTy
        want = J.TestFeatureBuilder.build(
            ("age", JTy.Real, [20.0, 30.0, None]),
            ("label", JTy.RealNN, [0.0, 1.0, 1.0]), response_index=1)
        _same_dataset(got, want)
        ds, (age, label) = got
        assert ds.n_rows == 3
        assert age.name == "age" and not age.is_response
        assert label.is_response
        assert np.isnan(ds.column("age").data[2])

    def test_build_from_instances(self):
        ds, (c,) = P.TestFeatureBuilder.build(
            ("color", [PickList("red"), PickList("blue")]))
        assert ds.column("color").data[0] == "red"
        assert c.feature_type is PickList
        with pytest.raises(ValueError, match="FeatureType instances"):
            P.TestFeatureBuilder.build(("color", ["red"]))

    def test_random(self):
        got = P.TestFeatureBuilder.random(
            50, x=P.RandomReal.normal(seed=1), name=P.RandomText.names(seed=2))
        want = J.TestFeatureBuilder.random(
            50, x=J.RandomReal.normal(seed=1), name=J.RandomText.names(seed=2))
        _same_dataset(got, want)
        ds, (x, name) = got
        assert ds.n_rows == 50
        assert x.name == "x" and name.name == "name"

    def test_features_usable_in_workflow_stage(self):
        from transmogrifai_tpu_torch.automl.transmogrifier import \
            transmogrify
        from transmogrifai_tpu_torch.workflow import Workflow
        ds, (x, y, label) = P.TestFeatureBuilder.build(
            ("x", Real, [1.0, 2.0, 3.0, 4.0] * 25),
            ("y", Real, [1.0, 0.0] * 50),
            ("label", RealNN, [0.0, 1.0] * 50), response_index=2)
        vec = transmogrify([x, y])
        model = Workflow(device="cpu").set_input_dataset(ds) \
            .set_result_features(vec).train()
        out = model.transform(ds)
        assert out.column(vec.name).data.shape[0] == 100


def test_assert_feature_and_transforms():
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.transformers.text import TextLenTransformer
    from transmogrifai_tpu_torch.types import Text

    age = FeatureBuilder.Real("age").extract(
        lambda r: r.get("age")).as_predictor()
    P.assert_feature(age, in_row={"age": 33.0}, out=33.0, name="age",
                     feature_type=Real)
    label = FeatureBuilder.RealNN("y").extract(
        lambda r: r.get("y")).as_response()
    P.assert_feature(label, in_row={"y": 1.0}, out=1.0, name="y",
                     is_response=True, feature_type=RealNN)
    with pytest.raises(AssertionError, match="name"):
        P.assert_feature(age, in_row={}, out=None, name="wrong")
    with pytest.raises(AssertionError, match="extract"):
        P.assert_feature(age, in_row={"age": 1.0}, out=2.0, name="age")
    with pytest.raises(AssertionError, match="type"):
        P.assert_feature(age, in_row={"age": 1.0}, out=1.0, name="age",
                         feature_type=RealNN)

    windowed = FeatureBuilder.Real("w").extract(
        lambda r: r.get("w")).window(86_400_000).as_predictor()
    P.assert_feature(windowed, in_row={"w": 5.0}, out=5.0, name="w",
                     window_ms=86_400_000)

    t = TextLenTransformer().set_input(
        FeatureBuilder.Text("t").extract(lambda r: r.get("t")).as_predictor())
    P.assert_transforms(t, [Text("abc"), Text(None)], [3, 0])
    with pytest.raises(AssertionError):
        P.assert_transforms(t, [Text("abc")], [4])
    with pytest.raises(AssertionError, match="expected outputs"):
        P.assert_transforms(t, [Text("abc")], [3, 0])


def test_format_table():
    from transmogrifai_tpu.utils.table import format_table as j_format
    from transmogrifai_tpu_torch.utils.table import format_table
    args = (["name", "auc"], [["logReg", 0.912345678], ["gbt", 0.88]])
    out = format_table(*args, title="models")
    assert out == j_format(*args, title="models")
    lines = out.splitlines()
    assert "models" in lines[1]
    assert any("logReg" in ln and "0.912346" in ln for ln in lines)
    row = next(ln for ln in lines if "gbt" in ln)
    assert row.startswith("| gbt ")
    assert row.rstrip().endswith("0.88 |")
    out2 = format_table(["x"], [["y" * 100]], max_col_width=10)
    assert "…" in out2
    assert out2 == j_format(["x"], [["y" * 100]], max_col_width=10)
