"""The port's OpWorkflowRunner / OpParams / OpApp (workflow/runner.py)
against the JAX package's, on the CPU.

One small flow (two Reals transmogrified, a train/validation selector over
logistic regression) runs Train, Score, Features and Evaluate through both
runners with the same seeded records. Held: the same artifact files in
the metrics, model and write locations; the same winner; evaluation
metrics within 1e-4 (logistic-regression fits agree within 1e-4); the
feature matrix bit-identical; a traced run's span tree has the reference's
run -> Train -> workflow -> layer -> stage hierarchy and passes
`trace_report(check=True)`. StreamingScore without a streaming reader
raises.
"""
import contextlib
import json
import os

import numpy as np
import pytest

from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.evaluators.evaluators import \
    BinaryClassificationEvaluator as JEval
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.utils.metrics import collector as j_collector
from transmogrifai_tpu import workflow as JW

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.evaluators.evaluators import \
    BinaryClassificationEvaluator as PEval
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.utils.metrics import collector
from transmogrifai_tpu_torch.utils.tracing import trace_report
from transmogrifai_tpu_torch import workflow as PW


def _rows(n=300, seed=5):
    rng = np.random.default_rng(seed)
    return [{"x": float(x), "y": float(rng.normal()),
             "label": float(x + rng.normal(0, 0.5) > 0)}
            for x in rng.normal(size=n)]


def _flow(pkg, dev=None):
    FB, U, tm, BCMS, LR, W = pkg
    U.reset_uids()
    kw = {} if dev is None else {"device": dev}
    fx = FB.Real("x").extract(lambda r: r.get("x")).as_predictor()
    fy = FB.Real("y").extract(lambda r: r.get("y")).as_predictor()
    fl = FB.RealNN("label").extract(lambda r: r.get("label")).as_response()
    vec = tm([fx, fy])
    pred = BCMS.with_train_validation_split(models_and_parameters=[
        (LR(**kw), [dict(reg_param=0.01)])]).set_input(fl, vec).get_output()
    return W.Workflow(**kw).set_result_features(pred), vec


JPKG = (JFB, JU, j_tm, JBCMS, JLR, JW)
PPKG = (PFB, PU, p_tm, PBCMS, PLR, PW)


def _run_all(pkg, List, Eval, root, dev=None):
    """Train (traced), Score, Evaluate and Features through one runner."""
    W = pkg[-1]
    rows = _rows()
    wf, vec = _flow(pkg, dev)
    runner = W.OpWorkflowRunner(wf, train_reader=List(rows),
                                score_reader=List(rows), evaluator=Eval(),
                                features_to_compute=[vec])
    seen = []
    runner.add_application_end_handler(lambda r: seen.append(r.run_type))
    params = W.OpParams(model_location=str(root / "model"),
                        write_location=str(root / "scores"),
                        metrics_location=str(root / "metrics"))
    out = {"train": runner.run(W.OpWorkflowRunner.TRAIN, params.with_values(
        collect_stage_metrics=True))}
    trace = json.loads((root / "metrics" / "train_trace.json").read_text())
    out["score"] = runner.run(W.OpWorkflowRunner.SCORE, params)
    out["evaluate"] = runner.run(W.OpWorkflowRunner.EVALUATE, params)
    out["features"] = runner.run(W.OpWorkflowRunner.FEATURES,
                                 params.with_values(
                                     write_location=str(root / "feat")))
    out["seen"] = seen
    out["trace"] = trace
    out["files"] = {d: sorted(os.listdir(root / d))
                    for d in ("metrics", "model", "scores", "feat")}
    return out


@contextlib.contextmanager
def _own_collector(coll):
    """`coll` off and without an event log inside the block, its earlier
    state put back after. Another test file run earlier in the same worker
    process may leave a package's collector on or its event log attached;
    a runner then joins that collection and writes its events into that
    log, not into its own metrics location."""
    with coll._lock:
        enabled, log = coll.enabled, coll._event_log
        coll.enabled, coll._event_log = False, None
    try:
        yield
    finally:
        with coll._lock:
            coll.enabled, coll._event_log = enabled, log


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    (root / "jax").mkdir()
    (root / "port").mkdir()
    with _own_collector(j_collector):
        try:
            j = _run_all(JPKG, JList, JEval, root / "jax")
        finally:
            j_collector.disable()
    with _own_collector(collector):
        p = _run_all(PPKG, PList, PEval, root / "port", dev="cpu")
        port_left_on = collector.enabled or collector.has_event_log
    return dict(jax=j, port=p, root=root, port_left_on=port_left_on)


def test_artifacts_match_jax(runs):
    j, p = runs["jax"], runs["port"]
    # the JAX package's save may also write its drift monitor's reference
    # profile (monitor/, not ported; best-effort, so only where present)
    if "monitor.json" in j["files"]["model"]:
        j["files"]["model"].remove("monitor.json")
    assert p["files"] == j["files"]
    assert {"train_stage_metrics.json", "train_trace.json", "events.jsonl",
            "train_metrics.json", "score_metrics.json"} <= \
        set(p["files"]["metrics"])
    assert p["seen"] == j["seen"] == ["Train", "Score", "Evaluate",
                                      "Features"]
    assert not runs["port_left_on"]


def test_train_and_evaluate_match_jax(runs):
    j, p = runs["jax"], runs["port"]
    assert p["train"].run_type == "Train"
    assert "OpLogisticRegression" in p["train"].model_summary
    for key in ("score", "evaluate"):
        jm, pm = j[key].metrics, p[key].metrics
        assert set(pm) == set(jm)
        for k in ("au_roc", "au_pr", "error"):
            assert abs(pm[k] - jm[k]) <= 1e-4, k
        assert pm["au_roc"] > 0.8
    assert p["score"].n_rows == j["score"].n_rows == 300
    root = runs["root"]
    jl = (root / "jax" / "scores" / "scores.jsonl").read_text().splitlines()
    pl = (root / "port" / "scores" / "scores.jsonl").read_text().splitlines()
    assert len(pl) == len(jl) == 300
    np.testing.assert_allclose(np.array([json.loads(v) for v in pl]),
                               np.array([json.loads(v) for v in jl]),
                               atol=1e-4, rtol=0)
    saved = json.loads((root / "port" / "metrics" / "evaluate_metrics.json")
                       .read_text())
    assert saved["run_type"] == "Evaluate" and "au_roc" in saved["metrics"]


def test_features_match_jax(runs):
    root = runs["root"]
    jz = np.load(root / "jax" / "feat" / "features.npz")
    pz = np.load(root / "port" / "feat" / "features.npz")
    assert sorted(pz.files) == sorted(jz.files)
    for k in jz.files:
        assert np.array_equal(pz[k], jz[k], equal_nan=True), k
    assert runs["port"]["features"].n_rows == 300


def test_trace_hierarchy_matches_jax(runs):
    def tree(doc):
        xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        by = {e["args"]["span_id"]: e for e in xs}
        return xs, by
    for name in ("jax", "port"):
        xs, by = tree(runs[name]["trace"])
        cats = {e["cat"] for e in xs}
        assert {"run", "workflow", "layer", "stage"} <= cats, name
        stage = next(e for e in xs if e["cat"] == "stage")
        chain = []
        e = stage
        while e is not None:
            chain.append(e["cat"])
            e = by.get(e["args"]["parent_id"])
        assert chain[-3:] == ["workflow", "run", "run"], (name, chain)
        assert chain[:2] == ["stage", "layer"]
        assert next(e for e in xs if e["cat"] == "run"
                    and e["args"]["parent_id"] is not None)["name"] == \
            "Train"
    pm = runs["root"] / "port" / "metrics"
    text, ok = trace_report(str(pm), check=True)
    assert ok, text
    events = [json.loads(v)["event"] for v in
              (pm / "events.jsonl").read_text().splitlines()]
    assert events[0] == "run_start" and events[-1] == "run_end"
    assert events.count("run_start") == 4
    doc = json.loads((pm / "train_stage_metrics.json").read_text())
    assert doc["app_name"] == "Workflow" and doc["stage_metrics"]


def test_streaming_score_raises():
    """StreamingScore needs a streaming reader (its run against the JAX
    runner is in test_torch_streaming.py)."""
    wf, _ = _flow(PPKG, "cpu")
    runner = PW.OpWorkflowRunner(wf, score_reader=PList(_rows(5)))
    with pytest.raises(ValueError, match="StreamingReader"):
        runner.run(PW.OpWorkflowRunner.STREAMING_SCORE,
                   PW.OpParams(model_location="/nowhere"))
    with pytest.raises(ValueError, match="Unknown run type"):
        runner.run("Bogus")


def test_params_round_trip_and_stage_overrides(tmp_path):
    p = PW.OpParams(stage_params={"SanityChecker": {"min_variance": 0.01}},
                    reader_params={"train": PW.ReaderParams(path="/data")},
                    model_location="/m", custom_params={"tag": "run1"},
                    debug_nans=True)
    path = str(tmp_path / "params.json")
    p.save(path)
    q = PW.OpParams.from_file(path)
    assert q.to_json() == p.to_json()
    assert JW.OpParams.from_file(path).to_json() == p.to_json()
    assert p.with_values(model_location="/m2").model_location == "/m2"
    assert p.model_location == "/m"
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    fx = PFB.Real("x").as_predictor()
    fl = PFB.RealNN("label").as_response()
    checker = SanityChecker()
    wf = PW.Workflow(device="cpu").set_result_features(
        checker.set_input(fl, p_tm([fx])).get_output())
    PW.apply_stage_params(wf, p)
    assert checker.get_param("min_variance") == 0.01


def test_op_app_main_and_debug_flag(tmp_path):
    rows = _rows(120)

    class App(PW.OpApp):
        def runner(self):
            wf, _ = _flow(PPKG, "cpu")
            return PW.OpWorkflowRunner(wf, train_reader=PList(rows))

    params = tmp_path / "params.json"
    PW.OpParams(debug_nans=True).save(str(params))
    res = App().main(["--run-type", "Train", "--param-location",
                      str(params), "--model-location",
                      str(tmp_path / "m"), "--metrics-location",
                      str(tmp_path / "mm")])
    assert res.run_type == "Train" and res.model_location == str(
        tmp_path / "m")
    assert os.path.exists(tmp_path / "m" / "op-model.json")
    assert (tmp_path / "mm" / "train_metrics.json").exists()
    assert not (tmp_path / "mm" / "train_trace.json").exists()


def test_joined_run_leaves_outer_collection_open(tmp_path):
    wf, _ = _flow(PPKG, "cpu")
    runner = PW.OpWorkflowRunner(wf, train_reader=PList(_rows(80)))
    collector.enable("outer", device="cpu")
    try:
        with collector.trace_span("outer_phase", kind="workflow"):
            runner.run(PW.OpWorkflowRunner.TRAIN, PW.OpParams(
                collect_stage_metrics=True,
                metrics_location=str(tmp_path)))
        assert collector.collecting
        names = [s.name for s in collector.trace.spans]
        assert names[:3] == ["outer", "outer_phase", "Train"]
    finally:
        collector.finish()
        collector.disable()
