"""The port's monoid aggregators against the JAX package.

Every named aggregator and every type's default
(`MonoidAggregatorDefaults.aggregator_for`) folds the same seeded raw
values and event times (ties included) in both packages. Tolerance: none —
both fold Python objects in Python float64, so results are identical, and
a name that cannot fold a type raises the same exception in both.
`FeatureAggregator.extract` keeps the same events at each window edge.
"""
import math

import numpy as np
import pytest

import transmogrifai_tpu.types as JT
from transmogrifai_tpu.features import aggregators as JA

import transmogrifai_tpu_torch.types as PT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.features import aggregators as PA
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB

NAMES = ["sum", "min", "max", "last", "first", "union", "mean", "mode",
         "concat", "logical_and", "logical_or", "logical_xor", "midpoint"]

_WORDS = ["b", "a", "c", "a b", "b"]


def _value(kind: str, rng) -> object:
    """One raw value of a type family (None and empties included)."""
    if rng.uniform() < 0.15:
        return None
    if kind == "num":
        return float(np.round(rng.normal(3, 2), 3))
    if kind == "int":
        return int(rng.integers(0, 40))
    if kind == "pct":
        return float(np.round(rng.uniform(-0.5, 1.5), 3))
    if kind == "bool":
        return bool(rng.uniform() < 0.5)
    if kind == "text":
        return str(rng.choice(_WORDS))
    if kind == "set":
        return {str(w) for w in rng.choice(_WORDS, size=rng.integers(0, 3))}
    if kind == "list":
        return [str(w) for w in rng.choice(_WORDS, size=rng.integers(0, 3))]
    if kind == "intlist":
        return [int(x) for x in rng.integers(0, 9, size=rng.integers(0, 3))]
    if kind == "geo":
        return [float(np.round(rng.uniform(-60, 60), 4)),
                float(np.round(rng.uniform(-170, 170), 4)),
                float(rng.integers(1, 6))]
    if kind == "vec":
        return np.round(rng.normal(size=2), 3)
    if kind.startswith("map:"):
        inner = kind[4:]
        return {k: v for k in ("k1", "k2", "k3") if rng.uniform() < 0.6
                for v in [_value(inner, rng)] if v is not None}
    raise ValueError(kind)


TYPES = [
    ("Real", "num"), ("RealNN", "num"), ("Integral", "int"),
    ("Currency", "num"), ("Percent", "pct"), ("Binary", "bool"),
    ("Date", "int"), ("DateTime", "int"), ("Text", "text"),
    ("TextArea", "text"), ("PickList", "text"), ("ComboBox", "text"),
    ("Email", "text"), ("URL", "text"), ("Phone", "text"), ("ID", "text"),
    ("Country", "text"), ("MultiPickList", "set"), ("TextList", "list"),
    ("DateList", "intlist"), ("Geolocation", "geo"), ("OPVector", "vec"),
    ("RealMap", "map:num"), ("IntegralMap", "map:int"),
    ("CurrencyMap", "map:num"), ("PercentMap", "map:pct"),
    ("BinaryMap", "map:bool"), ("DateMap", "map:int"),
    ("DateTimeMap", "map:int"), ("TextMap", "map:text"),
    ("TextAreaMap", "map:text"), ("PickListMap", "map:text"),
    ("EmailMap", "map:text"), ("MultiPickListMap", "map:set"),
    ("GeolocationMap", "map:geo"), ("Prediction", "map:num"),
]


def _events(kind: str, seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    vals = [_value(kind, rng) for _ in range(n)]
    # times with ties, one missing: first/last tie rules and the
    # untimed-event rule
    times = [int(t) for t in rng.integers(0, 5, size=n)]
    times[3] = None
    return vals, times


def _norm(v):
    """Comparable form: arrays as lists, NaN as a marker."""
    if isinstance(v, np.ndarray):
        return ("array", v.dtype.str, v.tolist())
    if isinstance(v, float) and math.isnan(v):
        return ("nan",)
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v).__name__, [_norm(x) for x in v]
    if isinstance(v, set):
        return ("set", sorted(map(repr, v)))
    return v


def _fold(agg, vals, times):
    try:
        return ("ok", _norm(agg.reduce(vals, times)))
    except Exception as e:   # the same failure in both packages
        return ("error", type(e).__name__)


@pytest.mark.parametrize("type_name,kind", TYPES,
                         ids=[t for t, _ in TYPES])
def test_named_and_default_aggregators_match_jax(type_name, kind):
    jt, pt = getattr(JT, type_name), getattr(PT, type_name)
    for seed in range(3):
        vals, times = _events(kind, seed)
        for name in NAMES:
            assert _fold(PA.named_aggregator(name, pt), vals, times) == \
                _fold(JA.named_aggregator(name, jt), vals, times), \
                (type_name, name, seed)
            # without times: encounter order
            assert _fold(PA.named_aggregator(name, pt), vals, None) == \
                _fold(JA.named_aggregator(name, jt), vals, None)
        assert _fold(PA.MonoidAggregatorDefaults.aggregator_for(pt),
                     vals, times) == \
            _fold(JA.MonoidAggregatorDefaults.aggregator_for(jt),
                  vals, times), (type_name, "default", seed)


def test_ties_and_separators():
    """first/last on tied times, mode on tied counts, the geolocation
    midpoint's float64 arithmetic and concat's separators."""
    vals, times = ["x", "y", "z", "y", "x"], [2, 1, 1, 2, 2]
    for name in ("first", "last", "mode"):
        assert PA.named_aggregator(name, PT.PickList).reduce(vals, times) \
            == JA.named_aggregator(name, JT.PickList).reduce(vals, times)
    assert PA.named_aggregator("first", PT.PickList).reduce(
        vals, times) == "y"
    assert PA.named_aggregator("last", PT.PickList).reduce(
        vals, times) == "x"
    assert PA.named_aggregator("mode", PT.PickList).reduce(vals) == "x"
    geo = [[10.0, 170.0, 1.0], [-10.0, -170.0, 3.0], [0.1, 179.9, 2.0]]
    assert PA.named_aggregator("midpoint", PT.Geolocation).reduce(geo) == \
        JA.named_aggregator("midpoint", JT.Geolocation).reduce(geo)
    for tname, sep in (("Text", " "), ("TextArea", " "), ("Email", ","),
                       ("PickList", ",")):
        got = PA.named_aggregator("concat", getattr(PT, tname)).reduce(
            ["a", None, "b"])
        assert got == f"a{sep}b"
    for tname, sep in (("TextMap", " "), ("TextAreaMap", " "),
                       ("EmailMap", ","), ("URLMap", ",")):
        agg = PA.MonoidAggregatorDefaults.aggregator_for(getattr(PT, tname))
        assert agg.reduce([{"k": "a"}, {"k": "b"}]) == {"k": f"a{sep}b"}
    assert PA._vector_combine([1.0], None) == [1.0]
    assert PA._vector_combine(np.ones(1), np.zeros(2)).tolist() == \
        [1.0, 0.0, 0.0]


@pytest.mark.parametrize("is_response", [False, True])
@pytest.mark.parametrize("window", [None, 10])
def test_feature_aggregator_window_edges(is_response, window):
    """Events exactly on the cutoff and on each window edge: predictors
    keep cutoff - window <= t < cutoff, responses cutoff <= t <=
    cutoff + window; untimed events are always kept."""
    cutoff = 100
    ts = [89, 90, 91, 99, 100, 101, 109, 110, 111, None]
    events = [(float(i + 1), t) for i, t in enumerate(ts)]
    for cut in (cutoff, None):
        p = PA.FeatureAggregator(PT.Real, window_ms=window).extract(
            events, cutoff_time=cut, is_response=is_response)
        j = JA.FeatureAggregator(JT.Real, window_ms=window).extract(
            events, cutoff_time=cut, is_response=is_response)
        assert p == j
    kept = [v for v, t in events if t is None or (
        (cutoff <= t and (window is None or t <= cutoff + window))
        if is_response else
        (t < cutoff and (window is None or t >= cutoff - window)))]
    got = PA.FeatureAggregator(PT.Real, window_ms=window).extract(
        events, cutoff_time=cutoff, is_response=is_response)
    assert got == sum(kept)


def test_builder_named_aggregate_and_window():
    f = PFB.Percent("p").aggregate("mean").window(7).as_predictor()
    agg = f.origin_stage.aggregator
    assert agg.window_ms == 7
    assert agg.aggregator.reduce([2.0, -1.0, 0.5]) == pytest.approx(0.5)
    with pytest.raises(ValueError, match="Unknown aggregator"):
        PFB.Real("x").aggregate("median")
