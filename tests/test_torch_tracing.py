"""The port's run telemetry (utils/tracing.py, utils/metrics.py), its
sanitizers (utils/sanitizers.py), the GC pause (utils/gcpause.py) and
RandomParamBuilder (automl/random_param.py) against the JAX package's, on
the CPU.

Exact throughout: the same recorded inputs give the same AppMetrics JSON
(the clock pinned), the same latency-histogram JSON, quantiles and merges
bit for bit, the same random grids, the same finiteness reports and
purity failures; the span tree keeps its parent integrity under
exceptions; the Chrome trace and the rotated event log pass
`trace_report(check=True)`, and a corrupted copy fails it. A traced
`train()` on the CPU carries layer, stage, sweep and tree-fit spans, kernel
records with `fused_fit_bytes`, a statistics pass and `sweep_cell_landed`
events; the device-memory attributes are empty on the CPU.
"""
import gc
import json

import numpy as np
import pytest

from transmogrifai_tpu.automl import random_param as JR
from transmogrifai_tpu.data.dataset import Column as JColumn
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.stages.base import Transformer as JTransformer
from transmogrifai_tpu import types as JT
from transmogrifai_tpu.utils import metrics as JMet
from transmogrifai_tpu.utils import sanitizers as JS
from transmogrifai_tpu.utils import tracing as JTr

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl import random_param as PR
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.data.dataset import Column as PColumn
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.stages.base import Transformer as PTransformer
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.utils import gcpause
from transmogrifai_tpu_torch.utils import metrics as PMet
from transmogrifai_tpu_torch.utils import sanitizers as PS
from transmogrifai_tpu_torch.utils import tracing as PTr
from transmogrifai_tpu_torch.utils.metrics import MetricsCollector
from transmogrifai_tpu_torch.workflow import Workflow


# -- the span tree -------------------------------------------------------------

def test_nesting_parent_ids_and_self_time():
    c = MetricsCollector()
    c.enable("nest", device="cpu")
    with c.trace_span("wf", kind="workflow"):
        with c.trace_span("layer_0", kind="layer"):
            with c.span("s1", "u1", "fit", n_rows=5):
                pass
            with c.span("s2", "u2", "transform", n_rows=5):
                pass
    c.finish()
    by = {s.name: s for s in c.trace.spans}
    assert by["nest"].parent_id is None and by["nest"].kind == "run"
    assert by["wf"].parent_id == by["nest"].span_id
    assert by["layer_0"].parent_id == by["wf"].span_id
    assert by["s1"].parent_id == by["s2"].parent_id == by["layer_0"].span_id
    assert by["s1"].attrs == {"uid": "u1", "phase": "fit", "n_rows": 5,
                              "n_stages_fused": 1}
    for sp in c.trace.spans:
        assert sp.t_end is not None and sp.t_end >= sp.t_start
        assert 0.0 <= c.trace.self_seconds(sp) <= sp.duration
    assert [m.stage_name for m in c.current.stage_metrics] == ["s1", "s2"]
    assert PTr.device_memory_attrs("cpu") == {}
    assert not any(k.startswith("hbm") for s in c.trace.spans
                   for k in s.attrs)


def test_exception_integrity_and_double_close():
    c = MetricsCollector()
    c.enable("err", device="cpu")
    with pytest.raises(KeyError):
        with c.trace_span("outer", kind="workflow"):
            inner = c.trace.open("left_open", "layer")
            with c.span("bad", "u", "fit"):
                raise KeyError("x")
    with c.trace_span("after", kind="workflow"):
        pass
    by = {s.name: s for s in c.trace.spans}
    assert by["bad"].error and by["bad"].error_type == "KeyError"
    assert by["outer"].error_type == "KeyError"
    # the child left open by the exception closed with its parent
    assert inner.t_end is not None and inner.t_end <= by["outer"].t_end
    assert by["after"].parent_id == by["err"].span_id
    end = by["after"].t_end
    c.trace.close(by["after"])
    assert by["after"].t_end == end
    m = c.current.stage_metrics[0]
    assert m.error and m.error_type == "KeyError"
    # a nested enable joins the open run
    c.enable("again")
    assert c.trace.spans[0].name == "err"
    c.finish()
    t_end = c.current.end_time
    c.finish()
    assert c.current.end_time == t_end


def test_collector_off_records_nothing(tmp_path):
    c = MetricsCollector()
    log = str(tmp_path / "events.jsonl")
    c.attach_event_log(log)
    c.event("run_start", run_type="Score")
    with c.span("s", "u", "fit"):
        pass
    with c.trace_span("t") as sp:
        assert sp is None
    assert c.kernel("k", 1.0, 10.0) is None
    c.event("run_end", run_type="Score")
    c.detach_event_log()
    assert [r["event"] for r in PTr.iter_events(log)] == ["run_start",
                                                          "run_end"]
    assert c.current.stage_metrics == []


# -- AppMetrics and the latency histogram against the reference ----------------

def _record(M, clock):
    """The same records into a collector of module M, the clock pinned."""
    c = M.MetricsCollector()
    c.enable("golden")
    with c.span("stage_a", "ua", "fit", n_rows=3):
        pass
    with c.span("stage_b", "ub", "fused-transform", n_rows=3,
                n_stages_fused=2):
        pass
    c.kernel("tree_sweep_fold_fused", 0.25, 1.5e9, cold=True)
    c.sweep_convergence("OpLogisticRegression", "rounds", 3, 12, 40, 16, 16,
                        active_per_round=[16, 9, 2],
                        iters_per_round=[4, 4, 4], bucket_sizes=[16, 16, 8])
    c.stats_pass("fused", 1000, 20, 2, 84000.0, 0.01, cold=False)
    for s in (0.001, 0.002, 0.5, 3e-6):
        c.latency("score", s)
    c.finish()
    cur = c.current
    cur.start_time, cur.end_time = clock
    for m in cur.stage_metrics:
        m.wall_seconds = 0.75
    return cur.to_json()


def test_app_metrics_json_matches_jax():
    j = _record(JMet, (100.0, 103.5))
    p = _record(PMet, (100.0, 103.5))
    assert p == j
    assert set(p) == {"app_name", "duration_seconds", "total_stage_seconds",
                      "stage_metrics", "kernel_metrics", "sweep_metrics",
                      "stats_metrics", "latency_metrics"}
    empty_j = JMet.AppMetrics(app_name="g", start_time=1.0,
                              end_time=2.0).to_json()
    empty_p = PMet.AppMetrics(app_name="g", start_time=1.0,
                              end_time=2.0).to_json()
    assert empty_p == empty_j and "kernel_metrics" not in empty_p


def test_latency_histogram_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    a = np.exp(rng.uniform(np.log(1e-7), np.log(2e3), 500))
    b = np.exp(rng.uniform(np.log(1e-5), np.log(1.0), 300))
    hs = {}
    for M in (JMet, PMet):
        h1, h2 = M.LatencyHistogram("x"), M.LatencyHistogram("x")
        for v in a:
            h1.record(v)
        for v in b:
            h2.record(v)
        union = M.LatencyHistogram("x")
        for v in np.concatenate([a, b]):
            union.record(v)
        merged = h1.merge(h2)
        hs[M] = (merged, union)
    (jm, ju), (pm, pu) = hs[JMet], hs[PMet]
    assert pm.to_json() == jm.to_json()
    assert pm._counts == pu._counts
    for q in (0.0, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert pm.quantile(q) == jm.quantile(q) == pu.quantile(q)
    doc = pm.to_json()
    back = PMet.LatencyHistogram.from_json(doc)
    assert back.to_json() == doc
    assert back._counts == JMet.LatencyHistogram.from_json(doc)._counts
    assert PMet.LatencyHistogram("x").merge(back).to_json() == doc
    with pytest.raises(ValueError, match="bucket key"):
        PMet.LatencyHistogram.from_json({"buckets_ms": {"0.7777": 1}})


def test_gauge_ring_is_bounded():
    ring = PMet.GaugeRing(maxlen=3)
    for i in range(5):
        ring.append(depth=i)
    assert len(ring) == 3
    assert [s["depth"] for s in ring.to_json()] == [2, 3, 4]


def test_device_roofs_are_the_cards():
    assert PMet.device_roof("NVIDIA H100 80GB HBM3") == (3.35e12, 67e12)
    assert PMet.hbm_roof_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert PMet.device_roof("cpu") is None
    assert PMet.roofline_fields(0.5, 1e9, None) == \
        JMet.roofline_fields(0.5, 1e9, None)
    assert PMet.roofline_fields(0.5, 1e9, 3350.0)["pct_of_roof"] == 0.06


# -- exports and the report ------------------------------------------------

def _traced_dir(tmp_path):
    c = MetricsCollector()
    c.enable("app", device="cpu")
    log = str(tmp_path / "events.jsonl")
    c.attach_event_log(log)
    with c.trace_span("Train", kind="run"):
        with c.trace_span("Workflow.train", kind="workflow"):
            with c.span("stage", "u", "fit", n_rows=10):
                c.kernel("forest_refit", 0.001, 4096.0, cold=False)
    c.save(str(tmp_path / "train_stage_metrics.json"))
    c.save_chrome_trace(str(tmp_path / "train_trace.json"))
    c.detach_event_log()
    return c


def test_chrome_trace_schema_and_check(tmp_path):
    _traced_dir(tmp_path)
    doc = json.loads((tmp_path / "train_trace.json").read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["cat"] for e in xs} == {"run", "workflow", "stage", "kernel"}
    for e in xs:
        assert {"ts", "dur", "pid", "tid", "name", "args"} <= set(e)
        assert {"span_id", "parent_id", "error"} <= set(e["args"])
    kern = next(e for e in xs if e["cat"] == "kernel")
    assert kern["args"]["bytes_hbm"] == 4096.0
    assert kern["args"]["roof_gbps"] is None
    saved = json.loads((tmp_path / "train_stage_metrics.json").read_text())
    assert saved["spans"][0]["parent_id"] is None
    for fn in (PTr.trace_report, JTr.trace_report):
        text, ok = fn(str(tmp_path), check=True)
        assert ok, text
    text, ok = PTr.trace_report(str(tmp_path))
    assert ok and "Kernel roofline" in text and "forest_refit" in text
    assert PTr.trace_report_rc(str(tmp_path / "nothing"))[1] == 2


def test_trace_report_catches_corruption(tmp_path):
    _traced_dir(tmp_path)
    path = tmp_path / "train_trace.json"
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    xs[-1]["args"]["parent_id"] = 999
    xs[0]["dur"] = "slow"
    path.write_text(json.dumps(doc))
    with open(tmp_path / "events.jsonl", "a") as f:
        f.write('{"seq": 0, "t": -5, "event": "late"}\n{"t": 1}\nnot json\n')
    text, rc = PTr.trace_report_rc(str(tmp_path), check=True)
    assert rc == 1
    assert "unknown parent_id 999" in text and "non-numeric" in text
    assert "invalid JSON" in text and "missing 'event'" in text
    assert JTr.trace_report_rc(str(tmp_path), check=True)[1] == 1


def test_event_log_rotation_keeps_one_monotone_stream(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = PTr.EventLog(path, max_mb=0.002, keep=2)
    for i in range(200):
        log.emit("tick", i=i, pad="x" * 20)
    log.close()
    assert log.rotations >= 3
    segs = PTr.event_log_paths(path)
    assert segs == JTr.event_log_paths(path)
    assert segs[-1] == path and segs[0].endswith(".2") and len(segs) == 3
    recs = list(PTr.iter_events(path))
    seqs = [r["seq"] for r in recs]
    assert seqs == sorted(seqs) and seqs[-1] == 199
    assert len(set(seqs)) == len(seqs) and seqs[0] > 0   # oldest dropped
    n, problems, counts = PTr._check_event_log(segs)
    assert problems == [] and counts == {"tick": n}
    assert JTr._check_event_log(segs)[1] == []


# -- RandomParamBuilder ----------------------------------------------------

def test_random_params_identical_to_jax():
    def build(M, seed):
        return M.RandomParamBuilder(seed).uniform("step_size", 0.01, 0.3) \
            .exponential("reg_param", 1e-6, 1.0) \
            .uniform_int("max_iter", 10, 400) \
            .subset("hidden_layers", [[10], [10, 10], [32, 16]]).build(25)
    for seed in (0, 42):
        assert build(PR, seed) == build(JR, seed)
    with pytest.raises(ValueError):
        PR.RandomParamBuilder().exponential("r", 0.0, 1.0)
    with pytest.raises(ValueError):
        PR.RandomParamBuilder().subset("s", [])


# -- sanitizers ----------------------------------------------------------------

def _mutating(Base):
    class Mutator(Base):
        input_types = (None,)
        output_type = None

        def __init__(self):
            super().__init__("mutate")

        def transform_columns(self, *cols):
            cols[0].data[0] = 99.0
            return cols[0]
    return Mutator()


def test_check_finite_and_purity_report_as_jax():
    vec = np.array([[1.0, np.nan], [np.inf, 2.0], [3.0, 4.0]], np.float32)
    num = np.array([1.0, np.nan, np.inf])
    rep = {}
    for name, (DS, C, S) in {"jax": (JDataset, JColumn, JS),
                             "port": (PDataset, PColumn, PS)}.items():
        ds = DS({"num": C("float", num.copy()), "vec": C("vector", vec),
                 "ok": C("float", np.array([1.0, np.nan, 2.0]))})
        rep[name] = S.check_finite(ds)
    assert rep["port"] == rep["jax"] == {"vec": {"nan": 1, "inf": 1},
                                         "num": {"nan": 0, "inf": 1}}
    errors = {}
    for name, (DS, C, S, T, Base) in {
            "jax": (JDataset, JColumn, JS, JT, JTransformer),
            "port": (PDataset, PColumn, PS, PT, PTransformer)}.items():
        ds = DS({"x": C("float", np.arange(4.0))})
        st = _mutating(Base)
        st._input_features = (type("F", (), {"name": "x"})(),)
        with pytest.raises(AssertionError) as e:
            S.assert_stage_pure(st, ds)
        errors[name] = str(e.value).split("\n")[0]
    assert errors["port"] == errors["jax"] == \
        "Mutator_mutate mutated its input column 'x'"


def _nan_workflow(values, op="log"):
    x = PFB.Real("x").as_predictor()
    out = getattr(x, op)()
    ds = PDataset({"x": PColumn("float", np.asarray(values, np.float64))})
    return Workflow(device="cpu").set_input_dataset(ds) \
        .set_result_features(out), out, ds


def test_debug_nans_names_the_stage():
    wf, out, ds = _nan_workflow([1.0, np.nan, 2.0])
    with PS.debug_nans():
        model = wf.train()          # a missing input stays missing: no raise
        assert np.isnan(model.score(ds).data(out.name)[1])
    wf, out, ds = _nan_workflow([1.0, -1.0, 2.0])
    with PS.debug_nans(), pytest.raises(FloatingPointError,
                                        match=out.origin_stage.stage_name):
        wf.train()
    assert not PS.checking()
    wf, out, ds = _nan_workflow([1.0, 1000.0, 2.0], op="exp")
    assert np.isposinf(wf.train().score(ds).data(out.name)[1])
    with PS.debug_infs(), pytest.raises(FloatingPointError, match="1 Inf"):
        wf.train()


def test_paused_gc_around_train(monkeypatch):
    from transmogrifai_tpu_torch.workflow.fitting import LayerRunner
    seen = []
    wf, out, ds = _nan_workflow([1.0, 2.0, 3.0])
    orig = LayerRunner.apply_layer

    def spy(self, *args, **kw):
        seen.append(gc.isenabled())
        return orig(self, *args, **kw)
    monkeypatch.setattr(LayerRunner, "apply_layer", spy)
    assert gc.isenabled()
    model = wf.train()
    model.score(ds)
    assert seen and not any(seen) and gc.isenabled()
    gc.disable()
    try:
        with gcpause.paused_gc():
            with gcpause.paused_gc():
                assert not gc.isenabled()
        assert not gc.isenabled()
    finally:
        gc.enable()


# -- a traced train() on the CPU -------------------------------------------------

def test_traced_train_records_every_layer(tmp_path):
    rng = np.random.default_rng(3)
    n = 400
    X = rng.normal(size=(n, 3))
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0).astype(float)
    ds = PDataset({f"x{i}": PColumn("float", X[:, i]) for i in range(3)})
    ds = ds.with_column("y", PColumn("float", y))
    label = PFB.RealNN("y").as_response()
    vec = transmogrify([PFB.Real(f"x{i}").as_predictor() for i in range(3)])
    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    checked = SanityChecker().set_input(label, vec).get_output()
    pred = PBCMS.with_train_validation_split(models_and_parameters=[
        (OpLogisticRegression(max_iter=10), [dict(reg_param=0.01)]),
        (OpRandomForestClassifier(num_trees=3, max_depth=3), [dict()])],
    ).set_input(label, checked).get_output()
    wf = Workflow(device="cpu").set_input_dataset(ds) \
        .set_result_features(pred)
    c = PMet.collector
    c.attach_event_log(str(tmp_path / "events.jsonl"))
    c.enable("traced", device="cpu")
    try:
        wf.train()
    finally:
        c.finish()
        c.disable()
        c.detach_event_log()
    kinds = {s.kind for s in c.trace.spans}
    assert {"run", "workflow", "layer", "stage", "sweep_fit",
            "tree_fit", "kernel"} <= kinds
    kern = [k for k in c.current.kernel_metrics
            if not k.kernel.startswith("stats")]
    names = {k.kernel for k in kern}
    assert "forest_sweep_fold_fused" in names
    assert names <= {"forest_sweep_fold_fused", "forest_refit"}
    spans = {s.name: s for s in c.trace.spans if s.kind == "kernel"}
    sweep = spans["forest_sweep_fold_fused"].attrs
    assert sweep["launches"] == dict.fromkeys(TK.KERNELS, 0)   # the CPU
    assert spans["forest_sweep_fold_fused"].attrs["bytes_hbm"] == \
        TK.fused_fit_bytes(sweep["n_rows"], sweep["n_feat"], 1, 3, 3)
    assert [s.driver for s in c.current.stats_metrics] == ["fused"]
    events = [r["event"] for r in PTr.iter_events(
        str(tmp_path / "events.jsonl"))]
    assert events.count("sweep_cell_landed") == 2
    assert "stats_pass" in events and "stage_end" in events
    wf_span = next(s for s in c.trace.spans if s.kind == "workflow")
    assert wf_span.name == "Workflow.train"
    layers = [s for s in c.trace.spans if s.kind == "layer"]
    assert all(s.parent_id == wf_span.span_id for s in layers)
