"""The port's serving engine, manifest, batcher and HTTP frontend (serve/,
workflow/io.py) against the JAX package's, on the CPU.

The model is tests/torch_serving_flow.py's flow, trained in the JAX
package and loaded from one directory into both packages (the port's on
`device="cpu"`). Held: `bucket_ladder` equal over max_batch 1..300 and
several floors; `template_record`, `model_content_hash` and
`manifest_stamp` equal; the serve.json that each package's `run_serve
--prewarm-only` writes equal key for key; the mismatch strings of
`verify_serve_manifest` equal after the artifact changed; `score_batch` at
1, 3, 8, 17, 64 and 100 records within 1e-5 of the JAX engine and of the
port's `score()` (probabilities; identical predictions), with the same
requests, batches, rows, pad_rows and bucket_rows and the same /metrics
keys; the local route within 1e-5 of the bucket route; the MicroBatcher
coalescing, shedding with `Overloaded` at `max_queue`, draining,
withdrawing a timed-out request; the HTTP frontend's status codes (200,
400, 404, 413, 500, 503, 504) equal to the JAX frontend's for the same
requests; the cold-start watch booking an injected build after warmup as
a `serve_recompile` event that `trace-report --check` fails on.
"""
import argparse
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import torch_serving_flow as F
from transmogrifai_tpu.serve import MicroBatcher as JMicroBatcher
from transmogrifai_tpu.serve import Overloaded as JOverloaded
from transmogrifai_tpu.serve import ServeFrontend as JFrontend
from transmogrifai_tpu.serve import ServingEngine as JEngine
from transmogrifai_tpu.serve import bucket_ladder as j_ladder
from transmogrifai_tpu.serve import make_http_server as j_http
from transmogrifai_tpu.serve import template_record as j_template
from transmogrifai_tpu.serve.frontend import run_serve as j_run_serve
from transmogrifai_tpu.utils import tracing as JTr
from transmogrifai_tpu.workflow import io as JIO

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.local.scoring import UnknownFeatureError
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.serve import (MicroBatcher, Overloaded,
                                           ServeFrontend, ServingEngine,
                                           bucket_ladder, make_http_server,
                                           template_record)
from transmogrifai_tpu_torch.serve.batcher import _Pending
from transmogrifai_tpu_torch.serve.frontend import run_serve
from transmogrifai_tpu_torch.utils import tracing as PTr
from transmogrifai_tpu_torch.utils.metrics import collector
from transmogrifai_tpu_torch.workflow import io as PIO

SIZES = (1, 3, 8, 17, 64, 100)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = F.flow_dir(tmp_path_factory)
    j, p = F.load_both(path)
    names = [f.name for f in p.result_features]
    return dict(path=path, jax=j, port=p, names=names,
                records=F.records(120, seed=13))


def _close(a, b, names):
    """Scored row dicts `a` and `b` agree: probabilities within 1e-5, the
    same predictions."""
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for name in names:
            assert ra[name]["prediction"] == rb[name]["prediction"]
            assert abs(ra[name]["probability_1"]
                       - rb[name]["probability_1"]) <= 1e-5


# -- ladder, template, manifest -----------------------------------------------

def test_bucket_ladder_matches_jax():
    for floor in (None, 2, 3, 8, 16, 40):
        for mb in range(1, 301):
            assert bucket_ladder(mb, floor) == j_ladder(mb, floor), (mb,
                                                                     floor)


def test_template_record_matches_jax(both):
    assert template_record(both["port"].raw_features()) == \
        j_template(both["jax"].raw_features())


def test_content_hash_and_stamp_match_jax(both):
    path = both["path"]
    h = PIO.model_content_hash(path)
    assert h == JIO.model_content_hash(path) and len(h) == 16
    assert PIO.manifest_stamp(path) == JIO.manifest_stamp(path)
    assert PIO.model_content_hash(None) is None
    assert both["port"].source_path == path


def _prewarm_args(model_dir, **kw):
    args = dict(model_dir=model_dir, max_batch=16, buckets=None,
                example=None, single_record="bucket", monitor="off",
                metrics_location=None, strict_manifest=False,
                prewarm_only=True)
    args.update(kw)
    return argparse.Namespace(**args)


def test_prewarm_manifest_matches_jax(both, tmp_path_factory, tmp_path,
                                      capsys):
    a = F.copy_flow(tmp_path_factory, tmp_path / "jax")
    b = F.copy_flow(tmp_path_factory, tmp_path / "port")
    assert j_run_serve(_prewarm_args(a)) == 0
    assert run_serve(_prewarm_args(b, device="cpu")) == 0
    printed = [json.loads(line) for line in
               capsys.readouterr().out.strip().splitlines()]
    assert [list(d) for d in printed] == [["prewarm"], ["prewarm"]]
    ja, pb = JIO.load_serve_manifest(a), PIO.load_serve_manifest(b)
    assert pb == ja and pb["buckets"] == [1, 8, 16]
    assert pb["model_hash"] == PIO.model_content_hash(b)
    assert PIO.verify_serve_manifest(b, pb) == []
    # the artifact changes after the prewarm: the same mismatch strings
    for d in (a, b):
        with open(os.path.join(d, "arrays.npz"), "ab") as f:
            f.write(b"re-saved")
        os.remove(os.path.join(d, "monitor.json"))
    got = PIO.verify_serve_manifest(b, pb)
    assert len(got) == 2 and got == JIO.verify_serve_manifest(a, ja)
    # a port engine adopting the stale manifest warns; --strict-manifest
    # refuses to start
    assert ServingEngine(b, device="cpu").manifest_mismatch == got
    assert run_serve(_prewarm_args(b, device="cpu",
                                   strict_manifest=True)) == 2


def test_monitor_is_not_ported(both, tmp_path_factory, tmp_path):
    with pytest.raises(NotImplementedError, match="transmogrifai_tpu/"
                       "monitor/"):
        ServingEngine(both["port"], monitor=object())
    d = F.copy_flow(tmp_path_factory, tmp_path / "m")
    assert run_serve(_prewarm_args(d, device="cpu", monitor="on")) == 2
    # auto on a JAX-saved model with a monitor.json serves unmonitored
    assert run_serve(_prewarm_args(d, device="cpu", monitor="auto")) == 0


def test_buckets_and_options_validated(both):
    p = both["port"]
    eng = ServingEngine(p, buckets=[4, 1, 32])
    assert eng.buckets == (1, 4, 32) and eng.max_batch == 32
    assert eng.device.type == "cpu"
    assert eng.pick_bucket(2) == 4 and eng.pick_bucket(32) == 32
    with pytest.raises(ValueError, match="exceeds max bucket"):
        eng.pick_bucket(33)
    with pytest.raises(ValueError, match="bucket sizes"):
        ServingEngine(p, buckets=[0, 4])
    with pytest.raises(ValueError, match="single_record"):
        ServingEngine(p, single_record="nope")


# -- the engine ---------------------------------------------------------------

def _counters(m):
    return {k: m[k] for k in ("requests", "batches", "rows", "pad_rows",
                              "bucket_rows", "shed", "buckets", "max_batch",
                              "single_record", "warm",
                              "post_warmup_compiles")}


def _drive(engine, Batcher, records):
    """score_batch at every size of SIZES, then five records one at a time
    through a MicroBatcher."""
    out = {n: engine.score_batch(records[:n]) for n in SIZES}
    batcher = Batcher(engine, max_wait_ms=0.0)
    try:
        out["singles"] = [batcher.submit(r, timeout=60)
                          for r in records[:5]]
    finally:
        batcher.shutdown()
    return out


def test_engine_matches_jax_engine_and_score(both):
    j, p, recs, names = (both["jax"], both["port"], both["records"],
                         both["names"])
    je, pe = JEngine(j, max_batch=64), ServingEngine(p, max_batch=64)
    je.prewarm()
    pe.prewarm()
    jo, po = _drive(je, JMicroBatcher, recs), _drive(pe, MicroBatcher, recs)
    scored = p.score(PList(recs).generate_dataset(
        [f for f in p.raw_features() if not f.is_response]))
    for key in SIZES + ("singles",):
        _close(po[key], jo[key], names)
    for name in names:
        want = scored.data(name)[:, -1]
        assert np.abs(F.probs(po[100], name) - want[:100]).max() <= 1e-5
    jm, pm = je.metrics(), pe.metrics()
    assert _counters(pm) == _counters(jm)
    # one batch at each size, two for 100 rows, and one a single record
    assert pm["requests"] == 5 and pm["batches"] == 7 + 5
    assert pm["pad_rows"] == pm["bucket_rows"] - pm["rows"] > 0
    assert set(pm) == set(jm) and set(pm["latency"]) == set(jm["latency"])
    assert set(pm["prewarm"]) == set(jm["prewarm"])
    assert set(pe.gauge_state()) == set(je.gauge_state())


def test_local_route_matches_bucket_route(both):
    p, recs, names = both["port"], both["records"], both["names"]
    bucket = ServingEngine(p, max_batch=8)
    local = ServingEngine(p, max_batch=8, single_record="local")
    bucket.prewarm()
    local.prewarm()
    want = bucket.score_batch(recs[:20])
    got = [local.score_batch([r])[0] for r in recs[:20]]
    _close(got, want, names)
    m = local.metrics()
    assert m["single_record"] == "local" and m["batches"] == 20


def test_score_function_and_serving_engine_hooks(both):
    p, recs = both["port"], both["records"]
    eng = p.serving_engine(max_batch=8)
    assert isinstance(eng, ServingEngine) and eng.buckets == (1, 8)
    assert p.score_function()(recs[0]).keys() == set(both["names"])


# -- the batcher --------------------------------------------------------------

def _engine_stub(both, delay=0.0):
    eng = ServingEngine(both["port"], max_batch=8)
    eng.prewarm()
    calls = []
    real = eng.score_batch

    def spy(records):
        calls.append(len(records))
        if delay:
            time.sleep(delay)
        return real(records)

    eng.score_batch = spy
    return eng, calls


def test_batcher_coalesces_concurrent_submits(both):
    eng, calls = _engine_stub(both, delay=0.05)
    b = MicroBatcher(eng, max_wait_ms=100.0, max_queue=64)
    results = []
    threads = [threading.Thread(target=lambda r=r: results.append(
        b.submit(r))) for r in both["records"][:6]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    b.shutdown()
    assert len(results) == 6 and sum(calls) == 6 and len(calls) < 6


def test_batcher_sheds_with_overloaded(both):
    eng, _ = _engine_stub(both, delay=0.3)
    b = MicroBatcher(eng, max_wait_ms=0.0, max_queue=2)
    rec = both["records"][0]

    def sub():
        try:
            b.submit(rec)
        except Overloaded:
            pass

    threads = [threading.Thread(target=sub) for _ in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.1)  # the dispatcher is busy on its first batch
    with b._cond:
        while len(b._q) < b.max_queue:
            b._q.append(_Pending(rec))
    with pytest.raises(Overloaded, match="queue full"):
        b.submit(rec)
    assert eng.n_shed >= 1
    b.shutdown(drain=True)
    for t in threads:
        t.join(30)


def test_batcher_drains_and_withdraws(both):
    eng, calls = _engine_stub(both, delay=0.05)
    b = MicroBatcher(eng, max_wait_ms=50.0, max_queue=64)
    results, errs = [], []

    def sub(r):
        try:
            results.append(b.submit(r))
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=sub, args=(r,))
               for r in both["records"][:10]]
    for t in threads:
        t.start()
    time.sleep(0.02)
    b.shutdown(drain=True)  # refuse new, score what is queued
    for t in threads:
        t.join(30)
    assert not errs and len(results) == 10 and sum(calls) == 10
    with pytest.raises(RuntimeError, match="shut down"):
        b.submit(both["records"][0])
    # a timed-out submit leaves the queue: neither scored nor counted
    eng, calls = _engine_stub(both, delay=0.4)
    b = MicroBatcher(eng, max_wait_ms=0.0, max_queue=8)
    t1 = threading.Thread(target=lambda: b.submit(both["records"][0]))
    t1.start()
    time.sleep(0.1)
    with pytest.raises(TimeoutError):
        b.submit(both["records"][1], timeout=0.05)
    t1.join(30)
    b.shutdown(drain=True)
    assert sum(calls) == 1 and eng.n_requests == 1
    # validation rejects before admission
    b = MicroBatcher(eng)
    with pytest.raises(UnknownFeatureError):
        b.submit({"a": 1.0, "nope": 1.0})
    b.shutdown()
    assert sum(calls) == 1


# -- the HTTP frontend ---------------------------------------------------------

def _req(port, path, payload=None, raw=None):
    url = f"http://127.0.0.1:{port}{path}"
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(url, data=data,
                                 method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _statuses(engine, Batcher, Frontend, http, overloaded, rec):
    """Status codes of one fixed request sequence, /metrics' keys, and the
    answer to one record."""
    engine.prewarm()
    batcher = Batcher(engine, max_wait_ms=1.0)
    fe = Frontend(engine, batcher, max_bulk=3)
    httpd = http(fe)
    th = threading.Thread(target=httpd.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    port = httpd.server_address[1]
    codes = []
    try:
        for path, body, raw in (
                ("/healthz", None, None), ("/score", rec, None),
                ("/score", [rec, rec], None),
                ("/score", dict(rec, junk=1), None),
                ("/score", dict(rec, a="old"), None), ("/score", 42, None),
                ("/score", None, b"{not json"), ("/score", [rec] * 4, None),
                ("/nope", None, None), ("/drift", None, None),
                ("/drift/window", None, None), ("/requests", None, None),
                ("/metrics/history", None, None), ("/debugz", None, None)):
            codes.append(_req(port, path, body, raw)[0])
        single = _req(port, "/score", rec)[1]
        metrics = _req(port, "/metrics")[1]
        # a shed -> 503, a timeout -> 504, a systemic fault -> 500
        real = batcher.submit
        for exc in (overloaded(3, 3), TimeoutError("slow")):
            def boom(*a, exc=exc, **k):
                raise exc
            batcher.submit = boom
            codes.append(_req(port, "/score", rec)[0])
        batcher.submit = real

        def fault(*a, **k):
            raise RuntimeError("device on fire")
        engine.score_batch = fault
        codes.append(_req(port, "/score", [rec])[0])
        codes.append(_req(port, "/drain")[0])
        codes.append(_req(port, "/healthz")[0])
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.shutdown()
    return codes, metrics, single


def test_http_status_codes_match_jax(both):
    rec = both["records"][0]
    jc, jm, js = _statuses(JEngine(both["jax"], max_batch=8), JMicroBatcher,
                           JFrontend, j_http, JOverloaded, rec)
    pc, pm, ps = _statuses(ServingEngine(both["port"], max_batch=8),
                           MicroBatcher, ServeFrontend, make_http_server,
                           Overloaded, rec)
    assert pc == jc
    assert pc == [200, 200, 200, 400, 400, 400, 400, 413, 404, 404, 404,
                  200, 200, 200, 503, 504, 500, 200, 503]
    assert set(pm) == set(jm) and set(pm["latency"]) == set(jm["latency"])
    assert pm["requests"] == jm["requests"] == 2
    _close([ps], [js], both["names"])


# -- the cold-start watch -----------------------------------------------------

def test_cold_start_watch_with_injected_counts(both, tmp_path):
    recs = both["records"]
    collector.enable("test_serving", device="cpu")
    collector.attach_event_log(str(tmp_path / "events.jsonl"))
    try:
        eng = ServingEngine(both["port"], max_batch=8)
        summary = eng.prewarm()
        assert summary["compiles"] == 0 and summary["cache_hits"] == 0
        assert PTr.tracker.sample_allocator("cpu") == 0
        eng.score_batch(recs[:3])
        # a load of a built library is a cache hit, not a cold start
        PTr.tracker.note_cache_hit("tree_kernels")
        eng.score_batch(recs[:5])
        assert eng.post_warmup_compiles == 0
        assert PTr.tracker.total_cache_hits == 1
        # a build after warmup is one
        PTr.tracker.note_build("tree_kernels", 0.25)
        eng.score_batch(recs[:2])
        assert eng.post_warmup_compiles == 1
        assert PTr.tracker.true_compiles == 1
        assert PTr.tracker.by_program == {"tree_kernels": 2}
        assert eng.metrics()["post_warmup_compiles"] == 1
    finally:
        collector.save(str(tmp_path / "serve_stage_metrics.json"))
        collector.save_chrome_trace(str(tmp_path / "serve_trace.json"))
        collector.detach_event_log()
        collector.disable()
    events = [r for r in PTr.iter_events(str(tmp_path / "events.jsonl"))
              if r["event"] == "serve_recompile"]
    assert [(e["compiles"], e["total_post_warmup"]) for e in events] == \
        [(1, 1)]
    for report_rc in (PTr.trace_report_rc, JTr.trace_report_rc):
        text, rc = report_rc(str(tmp_path), check=True)
        assert rc == 1 and "serve_recompile" in text
    # with the collector off the tracker counts nothing
    PTr.tracker.note_build("tree_kernels", 0.1)
    assert PTr.tracker.true_compiles == 1


def test_prewarm_only_directory_copies_are_independent(both, tmp_path):
    """A copy of a model directory with its serve.json verifies clean: the
    manifest describes the content, not the path."""
    d = str(tmp_path / "m")
    shutil.copytree(both["path"], d)
    eng = ServingEngine(d, device="cpu", max_batch=8)
    eng.prewarm()
    eng.write_manifest()
    d2 = str(tmp_path / "m2")
    shutil.copytree(d, d2)
    assert ServingEngine(d2, device="cpu").manifest_mismatch == []
    assert ServingEngine(d2, device="cpu").buckets == (1, 8)
    assert JEngine(JIO.load_model(d2)).manifest_mismatch == []
    out = JEngine(JIO.load_model(d2)).score_batch(both["records"][:2])
    assert len(out) == 2
