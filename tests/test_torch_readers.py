"""The port's readers against the JAX package.

Aggregate, conditional, joined (outer / left / inner) and joined-aggregate
readers (per-feature windows, `combined`, `keep=False`) over the same
seeded event log, with events placed exactly on the cutoffs and window
edges; JSON lines; Avro files written and read by either package (null and
deflate codecs); Parquet where pyarrow is present. Tolerance: none — keys,
row order, values and nulls are identical.
"""
import importlib.util

import numpy as np
import pytest

from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers import avro as JAvro
from transmogrifai_tpu.readers import readers as JR

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.readers import avro as PAvro
from transmogrifai_tpu_torch.readers import readers as PR

DAY = 1000
CUTOFF = 30 * DAY


def event_log(n_users=60, n_events=900, seed=3):
    """Profiles and events; some event times sit exactly on the cutoff and
    on the 1-, 7- and 10-day window edges around it."""
    rng = np.random.default_rng(seed)
    users = [{"uid": f"u{i}", "plan": str(rng.choice(["free", "pro"])),
              "age": None if rng.uniform() < 0.1 else int(rng.integers(18, 80)),
              "cutoff": CUTOFF + DAY * int(rng.integers(0, 2))}
             for i in range(n_users)]
    edges = [CUTOFF, CUTOFF - DAY, CUTOFF - 7 * DAY, CUTOFF - 10 * DAY,
             CUTOFF + DAY, CUTOFF + 7 * DAY, CUTOFF + 10 * DAY]
    events = []
    for j in range(n_events):
        t = int(rng.choice(edges)) if j % 5 == 0 else \
            int(rng.integers(0, 45 * DAY))
        events.append({
            "user": f"u{int(rng.integers(0, n_users + 5))}",   # + orphans
            "t": t if j % 37 else None,
            "amount": None if rng.uniform() < 0.1
            else float(np.round(rng.gamma(2.0, 10.0), 2)),
            "cat": str(rng.choice(list("abcde"))),
            "tags": {str(x) for x in rng.choice(list("xyz"),
                                                 size=rng.integers(0, 3))},
            "chan": str(rng.choice(["web", "app", "mail"])),
            "flag": bool(rng.uniform() < 0.2),
            "pct": float(np.round(rng.uniform(-0.2, 1.2), 3)),
            "geo": [float(np.round(rng.uniform(-50, 50), 3)),
                    float(np.round(rng.uniform(-100, 100), 3)), 1.0],
            "kind": "buy" if rng.uniform() < 0.15 else "view",
        })
    return users, events


def event_features(FB, windows=True):
    """Event-side features: every aggregator family, per-feature windows
    and a response."""
    def w(b, ms):
        return b.window(ms) if windows else b
    return [
        w(FB.Real("amt1").extract(lambda r: r.get("amount"))
          .aggregate("sum"), DAY).as_predictor(),
        w(FB.Real("amt7").extract(lambda r: r.get("amount"))
          .aggregate("sum"), 7 * DAY).as_predictor(),
        FB.Real("amtMean").extract(lambda r: r.get("amount"))
        .aggregate("mean").as_predictor(),
        FB.Real("amtMax").extract(lambda r: r.get("amount"))
        .aggregate("max").as_predictor(),
        FB.PickList("lastCat").extract(lambda r: r.get("cat"))
        .aggregate("last").as_predictor(),
        FB.PickList("firstCat").extract(lambda r: r.get("cat"))
        .aggregate("first").as_predictor(),
        FB.PickList("modeCat").extract(lambda r: r.get("cat"))
        .aggregate("mode").as_predictor(),
        FB.MultiPickList("tags").extract(lambda r: r.get("tags"))
        .aggregate("union").as_predictor(),
        FB.Text("chans").extract(lambda r: r.get("chan"))
        .aggregate("concat").as_predictor(),
        FB.Binary("anyFlag").extract(lambda r: r.get("flag"))
        .aggregate("logical_or").as_predictor(),
        FB.Percent("pct").extract(lambda r: r.get("pct")).as_predictor(),
        FB.Geolocation("mid").extract(lambda r: r.get("geo"))
        .aggregate("midpoint").as_predictor(),
        FB.Integral("t").extract(lambda r: r.get("t"))
        .aggregate("max").as_predictor(),
        w(FB.RealNN("bought").extract(
            lambda r: 1.0 if r.get("kind") == "buy" else 0.0)
          .aggregate(lambda a, b: max(a, b), zero=lambda: 0.0),
          7 * DAY).as_response(),
    ]


def profile_features(FB):
    return [FB.PickList("plan").extract(lambda r: r.get("plan"))
            .as_predictor(),
            FB.Integral("age").extract(lambda r: r.get("age"))
            .as_predictor(),
            FB.Integral("cutoff").extract(lambda r: r.get("cutoff"))
            .as_predictor()]


def _cell(v):
    if isinstance(v, float) and np.isnan(v):
        return ("nan",)
    if isinstance(v, set):
        return ("set", sorted(v))
    if isinstance(v, np.ndarray):
        return ("array", v.tolist())
    return v


def assert_same_dataset(p, j):
    assert p.column_names() == j.column_names()
    assert p.n_rows == j.n_rows
    for name in j.column_names():
        pc, jc = p.column(name), j.column(name)
        assert pc.kind == jc.kind, name
        assert pc.data.dtype == jc.data.dtype, name
        assert [_cell(v) for v in pc.data] == [_cell(v) for v in jc.data], \
            name


def _both(make):
    """make(package readers module, FeatureBuilder) -> (reader, features)
    in each package; returns both datasets."""
    pr, pf = make(PR, PFB)
    jr, jf = make(JR, JFB)
    return pr.generate_dataset(pf), jr.generate_dataset(jf)


@pytest.mark.parametrize("cutoff", [None, CUTOFF])
def test_aggregate_reader(cutoff):
    _, events = event_log()

    def make(R, FB):
        return R.AggregateReader(R.ListReader(events),
                                 key_fn=lambda r: r["user"],
                                 cutoff_time=cutoff,
                                 event_time_fn=lambda r: r["t"]), \
            event_features(FB)
    p, j = _both(make)
    assert_same_dataset(p, j)
    assert p.n_rows > 50


def test_conditional_reader():
    _, events = event_log()
    for drop in (True, False):
        def make(R, FB):
            return R.ConditionalReader(
                R.ListReader(events), key_fn=lambda r: r["user"],
                condition_fn=lambda r: r["kind"] == "buy",
                event_time_fn=lambda r: r["t"],
                drop_if_no_condition=drop), event_features(FB)
        p, j = _both(make)
        assert_same_dataset(p, j)
    p_all = _both(lambda R, FB: (R.DataReaders.Conditional.records(
        events, lambda r: r["user"], lambda r: r["kind"] == "buy",
        lambda r: r["t"], drop_if_no_condition=False),
        event_features(FB)))
    assert_same_dataset(*p_all)


@pytest.mark.parametrize("join_type", ["outer", "left", "inner"])
def test_joined_reader(join_type):
    users, events = event_log()
    users = users + [{"uid": "lonely", "plan": "pro", "age": 3,
                      "cutoff": CUTOFF}]

    def make(R, FB):
        prof = R.AggregateReader(R.ListReader(users),
                                 key_fn=lambda r: r["uid"])
        ev = R.AggregateReader(R.ListReader(events),
                               key_fn=lambda r: r["user"],
                               cutoff_time=CUTOFF,
                               event_time_fn=lambda r: r["t"])
        pf, ef = profile_features(FB), event_features(FB)
        reader = R.JoinedReader(prof, ev, join_type=join_type,
                                left_features=[f.name for f in pf],
                                right_features=[f.name for f in ef])
        return reader, pf + ef
    p, j = _both(make)
    assert_same_dataset(p, j)


def test_joined_reader_routes_by_reader_hint():
    users, events = event_log(n_users=10, n_events=50)

    def make(R, FB):
        left = R.ListReader(users, key_fn=lambda r: r["uid"])
        right = R.ListReader(events, key_fn=lambda r: r["user"])
        pf, ef = profile_features(FB), event_features(FB)[:3]
        for f in pf:
            f.origin_stage.reader_hint = left
        for f in ef:
            f.origin_stage.reader_hint = right
        return left.outer_join(right), pf + ef
    p, j = _both(make)
    assert_same_dataset(p, j)
    unrouted = PFB.Real("x").as_predictor()
    with pytest.raises(ValueError, match="cannot route"):
        PR.JoinedReader(PR.ListReader([]), PR.ListReader([])) \
            .generate_dataset([unrouted])


@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("join_type", ["left", "outer"])
def test_joined_aggregate_reader(combined, keep, join_type):
    """Event-level join, then per-key re-aggregation: the filter's window
    and per-feature windows, responses after the cutoff, parent features
    one copy a key or window-filtered (`combined`), time columns kept or
    dropped; missing times read as 0."""
    users, events = event_log()

    def make(R, FB):
        left = R.ListReader(users, key_fn=lambda r: r["uid"])
        right = R.ListReader(events, key_fn=lambda r: r["user"])
        pf, ef = profile_features(FB), event_features(FB)
        reader = R.JoinedReader(
            left, right, join_type=join_type,
            left_features=[f.name for f in pf],
            right_features=[f.name for f in ef],
        ).with_secondary_aggregation(R.TimeBasedFilter(
            condition=R.TimeColumn("cutoff", keep=keep),
            primary=R.TimeColumn("t", keep=keep), time_window=10 * DAY),
            combined=combined)
        return reader, pf + ef
    p, j = _both(make)
    assert_same_dataset(p, j)
    assert ("t" in p) == keep and ("cutoff" in p) == keep


def test_jsonl_and_parquet(tmp_path):
    users, _ = event_log(n_users=30)
    path = tmp_path / "users.jsonl"
    import json
    path.write_text("\n".join(json.dumps(u) for u in users) + "\n\n")

    def make(R, FB):
        return R.DataReaders.Simple.json_lines(
            str(path), key_fn=lambda r: r["uid"]), profile_features(FB)
    p, j = _both(make)
    assert_same_dataset(p, j)
    if importlib.util.find_spec("pyarrow") is None:
        with pytest.raises(ImportError, match="pyarrow"):
            PR.ParquetReader(str(tmp_path / "x.parquet")).read()
    else:
        import pyarrow as pa
        import pyarrow.parquet as pq
        pq.write_table(pa.Table.from_pylist(users), tmp_path / "u.parquet")
        p, j = _both(lambda R, FB: (R.ParquetReader(
            str(tmp_path / "u.parquet")), profile_features(FB)))
        assert_same_dataset(p, j)


def _avro_rows(n=40, seed=5):
    rng = np.random.default_rng(seed)
    return [{"id": i, "name": None if i % 7 == 0 else f"n{i}é",
             "score": float(rng.normal()), "flag": bool(i % 2),
             "tags": [str(x) for x in rng.choice(list("ab"), size=i % 3)],
             "attrs": {"k": float(i)} if i % 4 else {}}
            for i in range(n)]


AVRO_SCHEMA = {"type": "record", "name": "Row", "fields": [
    {"name": "id", "type": "long"},
    {"name": "name", "type": ["null", "string"]},
    {"name": "score", "type": "double"},
    {"name": "flag", "type": "boolean"},
    {"name": "tags", "type": {"type": "array", "items": "string"}},
    {"name": "attrs", "type": {"type": "map", "values": "double"}}]}


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_avro_round_trip(tmp_path, codec):
    rows = _avro_rows()
    for writer, tag in ((PAvro.write_avro_file, "p"),
                        (JAvro.write_avro_file, "j")):
        path = str(tmp_path / f"{tag}.avro")
        writer(path, AVRO_SCHEMA, rows, codec=codec)
        assert list(PAvro.read_avro_file(path)) == rows
        assert list(JAvro.read_avro_file(path)) == rows
        assert list(PAvro.read_avro_columns(path, batch_records=16)) == \
            list(JAvro.read_avro_columns(path, batch_records=16))
    assert (tmp_path / "p.avro").read_bytes() == \
        (tmp_path / "j.avro").read_bytes()
    feats = [PFB.Real("score").as_predictor(),
             PFB.PickList("name").as_predictor()]
    ds = PAvro.AvroReader(str(tmp_path / "j.avro"),
                          key_fn=lambda r: r["id"]).generate_dataset(feats)
    assert ds.n_rows == len(rows) and ds.data("key")[3] == "3"
    with pytest.raises(ValueError, match="codec"):
        PAvro.write_avro_file(str(tmp_path / "x.avro"), AVRO_SCHEMA, rows,
                              codec="snappy")


def test_csv_to_avro_and_columnar(tmp_path):
    csv_path = tmp_path / "t.csv"
    csv_path.write_text("a-b,c,d\n1,x,2.5\n,y,\n3,z,4\n")
    ps = PAvro.csv_to_avro(str(csv_path), str(tmp_path / "p.avro"))
    js = JAvro.csv_to_avro(str(csv_path), str(tmp_path / "j.avro"))
    assert ps == js
    assert (tmp_path / "p.avro").read_bytes() == \
        (tmp_path / "j.avro").read_bytes()
    assert PAvro.infer_avro_schema(_avro_rows()) == \
        JAvro.infer_avro_schema(_avro_rows())
    kw = dict(columns=["a-b", "d"], batch_records=2)
    got = list(PR.csv_columnar_chunks(str(csv_path), **kw))
    want = list(JR.csv_columnar_chunks(str(csv_path), **kw))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    np.testing.assert_array_equal(PR.columnar_f32([1, None, 2.5]),
                                  JR.columnar_f32([1, None, 2.5]))
