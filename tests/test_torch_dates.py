"""The date vectorizers and date stages of the port against the JAX package.

DateVectorizer (every circular period, null tracking on and off),
DateListVectorizer (SinceLast and SinceFirst), DateToUnitCircleTransformer
for every period, DateToListTransformer for Date and DateTime, on seeded
epoch milliseconds with the awkward cases: the epoch itself and a day
after it, dates before 1970, missing dates and empty lists. Both packages
compute in numpy float64 and store f32 once; tolerance: none, the blocks
are bit-identical and the metadata identical. The port's one-pass block
writer stays bit-identical to its unit_circle, as the JAX package
requires of its own (tests/test_vectorizer_edges.py).
"""
import numpy as np
import pytest

from transmogrifai_tpu.automl.vectorizers import dates as JD
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.transformers import misc as JM
from transmogrifai_tpu.utils import uid as JU
import transmogrifai_tpu.types as JT

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.vectorizers import dates as PD
from transmogrifai_tpu_torch.data.dataset import Column
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.transformers import misc as PM
from transmogrifai_tpu_torch.types import ColumnKind
from transmogrifai_tpu_torch.utils import uid as PU
import transmogrifai_tpu_torch.types as PT

PERIODS = ["HourOfDay", "DayOfWeek", "DayOfMonth", "DayOfYear",
           "WeekOfYear", "MonthOfYear"]
JAX = (JFB, JU, JDataset, JT, JD, JM)
PORT = (PFB, PU, PDataset, PT, PD, PM)
EDGES = [0, 86_400_000, -1, -86_400_000, -2_208_988_800_000, None,
         951_782_400_000, 1_709_164_800_000]   # 1900-01-01, 29 Feb


def dates(n=400, seed=0):
    rng = np.random.default_rng(seed)
    ms = rng.integers(-3 * 10**12, 3 * 10**12, size=n)
    return EDGES + [None if rng.uniform() < 0.1 else int(v) for v in ms]


def date_lists(n=300, seed=1):
    rng = np.random.default_rng(seed)
    return [[], [0], [-86_400_000, 86_400_000], None] + [
        [int(v) for v in rng.integers(-10**12, 2 * 10**12,
                                      size=rng.integers(0, 6))]
        for _ in range(n)]


def run(pkg, tname, values, make, *more):
    """The stage that `make(modules, feature, *more)` builds, fitted (where
    it is an estimator) and run on `values`: its output column."""
    FB, U, Dataset, T, D, M = pkg
    U.reset_uids()
    f = getattr(FB, tname)("d").as_predictor()
    stage = make(D, M, f, *more)
    ds = Dataset.from_features([("d", getattr(T, tname), values)])
    model = stage.fit(ds) if hasattr(stage, "fit") else stage
    return model.transform(ds).column(model.output_name())


def assert_same(a, b):
    assert b.data.dtype == a.data.dtype
    assert b.data.tobytes() == a.data.tobytes()
    if a.metadata is not None:
        assert b.metadata.to_json() == a.metadata.to_json()


@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("tname", ["Date", "DateTime"])
def test_date_vectorizer_every_period(tname, track_nulls):
    def make(D, M, f):
        return D.DateVectorizer(reference_date_ms=1.6e12,
                                circular_periods=PERIODS,
                                track_nulls=track_nulls).set_input(f)
    a, b = (run(pkg, tname, dates(), make) for pkg in (JAX, PORT))
    assert b.data.shape == (len(dates()), 1 + 12 + int(track_nulls))
    assert_same(a, b)


@pytest.mark.parametrize("mode", ["SinceLast", "SinceFirst"])
def test_date_list_vectorizer_every_mode(mode):
    def make(D, M, f):
        return D.DateListVectorizer(reference_date_ms=1.6e12,
                                    mode=mode).set_input(f)
    a, b = (run(pkg, "DateList", date_lists(), make) for pkg in (JAX, PORT))
    assert_same(a, b)
    # empty and missing lists: 0 days and the null indicator
    np.testing.assert_array_equal(b.data[[0, 3]], [[0.0, 1.0], [0.0, 1.0]])


@pytest.mark.parametrize("period", PERIODS)
def test_to_unit_circle_every_period(period):
    def make(D, M, f):
        return M.DateToUnitCircleTransformer(time_period=period) \
            .set_input(f)
    a, b = (run(pkg, "Date", dates(), make) for pkg in (JAX, PORT))
    assert_same(a, b)
    # missing dates sit at the origin
    assert (b.data[EDGES.index(None)] == 0).all()


@pytest.mark.parametrize("tname", ["Date", "DateTime"])
def test_to_date_list(tname):
    def make(D, M, f):
        return M.DateToListTransformer().set_input(f)
    a, b = (run(pkg, tname, dates(60), make) for pkg in (JAX, PORT))
    assert list(b.data) == list(a.data)
    assert b.data[0] == [0.0] and b.data[EDGES.index(None)] == []
    PU.reset_uids()
    out = PM.DateToListTransformer().set_input(
        getattr(PFB, tname)("d").as_predictor()).get_output()
    assert out.type_name == ("DateTimeList" if tname == "DateTime"
                             else "DateList")


def test_unit_circle_matches_jax_at_the_edges():
    ms = np.array([np.nan if v is None else v for v in dates(200)],
                  np.float64)
    for p in PERIODS:
        for x, y in zip(JD.unit_circle(ms, p), PD.unit_circle(ms, p)):
            assert x.tobytes() == y.tobytes(), p
        assert PD.PERIODS[p][0] == JD.PERIODS[p][0]


def test_date_block_bitwise_parity_with_unit_circle():
    """The port's one-pass block writer and its unit_circle store the same
    f32 values, for every period."""
    rng = np.random.default_rng(5)
    ms = np.where(rng.uniform(size=500) < 0.1, np.nan,
                  1.4e12 + rng.uniform(-2e12, 2e11, size=500))
    model = PD.DateVectorizerModel(reference_date_ms=1.5e12,
                                   circular_periods=PERIODS,
                                   track_nulls=True)
    block = model.transform_block([Column(kind=ColumnKind.FLOAT, data=ms)])
    finite = np.isfinite(ms)
    for i, p in enumerate(PERIODS):
        s, c, _ = PD.unit_circle(ms, p)
        np.testing.assert_array_equal(
            block[:, 1 + 2 * i], np.where(finite, s, 0.0).astype(np.float32))
        np.testing.assert_array_equal(
            block[:, 2 + 2 * i], np.where(finite, c, 0.0).astype(np.float32))
    np.testing.assert_array_equal(block[:, -1], ~finite)


def test_epoch_boundary_is_finite():
    def make(D, M, f):
        return D.DateVectorizer(reference_date_ms=1.6e12).set_input(f)
    out = run(PORT, "Date", [0, 86_400_000, None], make)
    assert np.isfinite(out.data).all() and out.data[2, -1] == 1.0
