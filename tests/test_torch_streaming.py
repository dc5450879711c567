"""The port's streaming readers (transmogrifai_tpu_torch/readers/
streaming.py), StreamingHistogram (utils/streaming_histogram.py) and the
runner's StreamingScore against the JAX package's, on the CPU.

- the readers: list batches, new files seen once, the lazy iterator
  reader, Avro and CSV file streams: the same batches and records as the
  JAX package's readers on the same files;
- StreamingHistogram: the same bins, totals, quantiles and densities as
  the reference sketch on the same seeded values, after updates and after
  a merge (the reference's cases in test_random_param_histogram_corr.py);
- StreamingScore: a workflow the JAX package trained and saved is scored
  through both packages' OpWorkflowRunner over the same streamed records
  (fixed record tiles and the per-record route): the same number of
  lines in scores.jsonl, every probability within 1e-5 and the same
  predictions; a port-trained workflow's StreamingScore equals its own
  per-record scorer within 1e-5, and a second run appends.
"""
import json

import numpy as np
import pytest

from transmogrifai_tpu import readers as JR
from transmogrifai_tpu.utils.streaming_histogram import \
    StreamingHistogram as JHist

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import readers as PR
from transmogrifai_tpu_torch.utils.streaming_histogram import \
    StreamingHistogram as PHist


class TestReaders:
    def test_list_streaming_batches(self):
        rows = [{"i": i} for i in range(25)]
        got = list(PR.ListStreamingReader(rows, batch_size=10).stream())
        assert got == list(JR.ListStreamingReader(rows,
                                                  batch_size=10).stream())
        assert [len(b) for b in got] == [10, 10, 5]

    def test_iter_reader_batches_lazily(self):
        pulled = []

        def factory():
            for i in range(7):
                pulled.append(i)
                yield {"i": i}

        it = PR.IterStreamingReader(factory, batch_records=3).stream()
        assert next(it) == [{"i": 0}, {"i": 1}, {"i": 2}]
        assert pulled == [0, 1, 2]
        assert [len(b) for b in it] == [3, 1]

    def test_file_streaming_sees_new_files_once(self, tmp_path):
        for i in range(2):
            (tmp_path / f"f{i}.csv").write_text("x,y\n1,2\n3,4\n")
        r = PR.CSVStreamingReader(str(tmp_path / "*.csv"))
        jr = JR.CSVStreamingReader(str(tmp_path / "*.csv"))
        first = r.poll()
        assert first == jr.poll()
        assert len(first) == 2 and len(first[0]) == 2
        assert r.poll() == jr.poll() == []
        (tmp_path / "f9.csv").write_text("x,y\n5,6\n")
        again = r.poll()
        assert again == jr.poll()
        assert len(again) == 1 and again[0][0]["x"] == 5

    def test_avro_streaming_reader(self, tmp_path):
        schema = {"type": "record", "name": "R", "fields": [
            {"name": "a", "type": "double"},
            {"name": "b", "type": ["null", "string"]}]}
        for k in range(2):
            PR.write_avro_file(str(tmp_path / f"p{k}.avro"), schema, [
                {"a": float(i + 10 * k), "b": None if i % 2 else f"s{i}"}
                for i in range(5)])
        got = PR.AvroStreamingReader(str(tmp_path / "*.avro")).poll()
        want = JR.AvroStreamingReader(str(tmp_path / "*.avro")).poll()
        assert got == want and [len(b) for b in got] == [5, 5]


def _values(seed, n, loc=0.0):
    return np.random.default_rng(seed).normal(loc, 1.0, size=n)


def _same_hist(a: PHist, b: JHist):
    assert a.bins() == b.bins()
    assert a.total() == b.total()
    for q in (0.1, 0.5, 0.9):
        assert a.quantile(q) == b.quantile(q)
    edges = [-2.0, -1.0, 0.0, 1.0, 2.0]
    assert a.density(edges) == b.density(edges)


class TestStreamingHistogram:
    def test_capacity_and_mass(self):
        vals = _values(0, 5000)
        h = PHist(max_bins=8).update_all(vals)
        _same_hist(h, JHist(max_bins=8).update_all(vals))
        assert len(h.bins()) <= 8
        assert h.total() == pytest.approx(5000)

    def test_quantiles_close_to_exact(self):
        vals = _values(1, 20000)
        h = PHist(max_bins=64).update_all(vals)
        _same_hist(h, JHist(max_bins=64).update_all(vals))
        for q in (0.1, 0.5, 0.9):
            assert abs(h.quantile(q) - np.quantile(vals, q)) < 0.12

    def test_merge_equals_union(self):
        a, b = _values(2, 3000), _values(3, 3000, 3.0)
        hm = PHist(32).update_all(a).merge(PHist(32).update_all(b))
        _same_hist(hm, JHist(32).update_all(a).merge(JHist(32).update_all(b)))
        hu = PHist(32).update_all(np.concatenate([a, b]))
        assert hm.total() == pytest.approx(6000)
        assert abs(hm.quantile(0.5) - hu.quantile(0.5)) < 0.25

    def test_sum_to_monotone_and_repeats(self):
        vals = [1, 2, 2, 3, 5, 8, 13]
        h = PHist(16).update_all(vals).update(2.0, count=3.0)
        j = JHist(16).update_all(vals).update(2.0, count=3.0)
        _same_hist(h, j)
        xs = np.linspace(0, 14, 50)
        sums = [h.sum_to(x) for x in xs]
        assert sums == [j.sum_to(x) for x in xs]
        assert (np.diff(sums) >= -1e-9).all()
        assert sums[-1] == pytest.approx(10)
        with pytest.raises(ValueError):
            PHist(1)


def _rows(n=240, seed=5):
    rng = np.random.default_rng(seed)
    return [{"x": float(x), "y": float(rng.normal()),
             "label": float(x + rng.normal(0, 0.5) > 0)}
            for x in rng.normal(size=n)]


def _flow(FB, U, tm, BCMS, LR, W, kw):
    U.reset_uids()
    fx = FB.Real("x").extract(lambda r: r.get("x")).as_predictor()
    fy = FB.Real("y").extract(lambda r: r.get("y")).as_predictor()
    fl = FB.RealNN("label").extract(lambda r: r.get("label")).as_response()
    pred = BCMS.with_train_validation_split(models_and_parameters=[
        (LR(**kw), [dict(reg_param=0.01)])]).set_input(
            fl, tm([fx, fy])).get_output()
    return W.Workflow(**kw).set_result_features(pred)


def _jax_pkg():
    from transmogrifai_tpu import workflow as JW
    from transmogrifai_tpu.automl.selectors import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu.automl.transmogrifier import transmogrify
    from transmogrifai_tpu.features.builder import FeatureBuilder
    from transmogrifai_tpu.models.glm import OpLogisticRegression
    from transmogrifai_tpu.utils import uid
    return (FeatureBuilder, uid, transmogrify,
            BinaryClassificationModelSelector, OpLogisticRegression, JW), {}


def _port_pkg():
    from transmogrifai_tpu_torch import workflow as PW
    from transmogrifai_tpu_torch.automl.selectors import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.utils import uid
    return (FeatureBuilder, uid, transmogrify,
            BinaryClassificationModelSelector, OpLogisticRegression,
            PW), {"device": "cpu"}


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    """A workflow the JAX package trained, saved once for the module."""
    pkg, kw = _jax_pkg()
    root = tmp_path_factory.mktemp("streaming_score")
    wf = _flow(*pkg, kw).set_reader(JR.ListReader(_rows()))
    wf.train().save(str(root / "model"))
    return root


def _stream_score(pkg, kw, model_dir, out_dir, records, tile_rows,
                  Streaming):
    W = pkg[-1]
    runner = W.OpWorkflowRunner(
        _flow(*pkg, kw), score_reader=Streaming(records, batch_size=13))
    res = runner.run(W.OpWorkflowRunner.STREAMING_SCORE, W.OpParams(
        model_location=str(model_dir), write_location=str(out_dir),
        custom_params={"score_tile_rows": tile_rows}))
    lines = (out_dir / "scores.jsonl").read_text().splitlines()
    return res, [list(json.loads(v).values())[0] for v in lines]


@pytest.mark.parametrize("tile_rows", [32, 0])
def test_streaming_score_matches_the_jax_runner(jax_model_dir, tile_rows):
    records = [{"x": r["x"], "y": r["y"]} for r in _rows(101, seed=9)]
    root = jax_model_dir
    out = {}
    for name, (pkg, kw), Streaming in (
            ("jax", _jax_pkg(), JR.ListStreamingReader),
            ("port", _port_pkg(), PR.ListStreamingReader)):
        d = root / f"{name}-{tile_rows}"
        out[name] = _stream_score(pkg, kw, root / "model", d, records,
                                  tile_rows, Streaming)
    (jres, jscores), (pres, pscores) = out["jax"], out["port"]
    assert pres.run_type == jres.run_type == "StreamingScore"
    assert pres.n_rows == jres.n_rows == len(pscores) == len(jscores) == 101
    for p, j in zip(pscores, jscores):
        assert p["prediction"] == j["prediction"]
        assert abs(p["probability_1"] - j["probability_1"]) <= 1e-5


def test_port_trained_streaming_score_matches_score(tmp_path):
    pkg, kw = _port_pkg()
    W = pkg[-1]
    rows = _rows()
    model = _flow(*pkg, kw).set_reader(PR.ListReader(rows)).train()
    model.save(str(tmp_path / "model"))
    records = [{"x": r["x"], "y": r["y"]} for r in rows[:77]]
    res, scores = _stream_score(pkg, kw, tmp_path / "model",
                                tmp_path / "out", records, 16,
                                PR.ListStreamingReader)
    assert res.n_rows == 77
    fn = model.score_function()
    want = [list(fn(r).values())[0] for r in records]
    assert [s["prediction"] for s in scores] \
        == [w["prediction"] for w in want]
    np.testing.assert_allclose([s["probability_1"] for s in scores],
                               [w["probability_1"] for w in want],
                               atol=1e-5, rtol=0)
    # a second run appends to scores.jsonl
    res2 = W.OpWorkflowRunner(
        _flow(*pkg, kw),
        score_reader=PR.ListStreamingReader(records[:5])).run(
            W.OpWorkflowRunner.STREAMING_SCORE,
            W.OpParams(model_location=str(tmp_path / "model"),
                       write_location=str(tmp_path / "out")))
    assert res2.n_rows == 5
    assert len((tmp_path / "out" / "scores.jsonl").read_text()
               .splitlines()) == 82
