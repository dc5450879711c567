"""The port's request traces (serve/reqtrace.py) and request reports
(utils/tracing.py) against the JAX package's, on the CPU.

Held: the trace header's mint, parse and format identical on well-formed
and malformed values; RequestTrace and BatchTrace records serialize
identically; the TailSampler decides identically, outcome by outcome and
under one seeded `random` stream; ReqTracer payloads (segment histograms,
kept ring, counters) equal for the same finished traces; `requests_report`
gives the same text and exit code on one recorded trace directory (the
port's frontend serving tests/torch_serving_flow.py's model, the JAX
package's flow loaded on the CPU), and both flag the same coverage
problems on crafted records; `follow_events` yields the same records as
the JAX package's across a rotating log; the gauge sampler and thread dump
work.
"""
import json
import random
import threading
import time
import urllib.error
import urllib.request

import pytest

import torch_serving_flow as F
from transmogrifai_tpu.serve import reqtrace as JRQ
from transmogrifai_tpu.utils import tracing as JTr
from transmogrifai_tpu.utils.metrics import LatencyHistogram as JHist

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.serve import (MicroBatcher, ServeFrontend,
                                           ServingEngine, make_http_server)
from transmogrifai_tpu_torch.serve import reqtrace as PRQ
from transmogrifai_tpu_torch.utils import tracing as PTr
from transmogrifai_tpu_torch.utils.metrics import LatencyHistogram as PHist
from transmogrifai_tpu_torch.utils.metrics import collector
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM

HEADERS = [None, "", "abcdef0123456789", "ABCDEF0123456789;replica=r0",
           "abcdef0123456789;replica=champion-1;hop=2", "not hex!", "x" * 64,
           ";replica=r0", " 0123abcd ;a=b;junk", "0" * 32, "0" * 33]


@pytest.mark.parametrize("value", HEADERS)
def test_header_parse_and_format_match_jax(value):
    assert PRQ.parse_trace_header(value) == JRQ.parse_trace_header(value)
    tid, attrs = PRQ.parse_trace_header(value)
    if tid is not None:
        assert PRQ.format_trace_header(tid, **attrs, gone=None) == \
            JRQ.format_trace_header(tid, **attrs, gone=None)
    assert (PRQ.TRACE_HEADER, PRQ.DEBUG_SLEEP_HEADER, PRQ.SEGMENTS) == \
        (JRQ.TRACE_HEADER, JRQ.DEBUG_SLEEP_HEADER, JRQ.SEGMENTS)
    minted = PRQ.mint_trace_id()
    assert len(minted) == 16 and PRQ.parse_trace_header(minted)[0] == minted


def _trace(RQ, i, **kw):
    rt = RQ.RequestTrace(f"{i:016x}", kw.pop("origin", "replica"))
    rt.seg("parse", 0.0002 * i)
    rt.seg("queue", -0.001 if i % 5 == 0 else 0.001 * i)
    rt.seg("device", 0.003)
    rt.seg("device", 0.001)
    rt.wall_s = kw.pop("wall_s", 0.005 * (i + 1))
    rt.status = kw.pop("status", 200)
    for k, v in kw.items():
        setattr(rt, k, v)
    return rt


def _outcomes():
    return [dict(status=500), dict(status=400), dict(error_type="Boom"),
            dict(status=503), dict(shed=True), dict(status=503,
                                                    error_type="X"),
            dict(retries=1), dict(shadow_dropped=True), dict(),
            dict(bucket=8, pad_fraction=0.375, rows=3, replica="r1")]


def test_records_serialize_identically():
    for i, kw in enumerate(_outcomes()):
        assert _trace(PRQ, i, **kw).to_json() == _trace(JRQ, i, **kw) \
            .to_json()
    for RQ in (PRQ, JRQ):
        bt = RQ.BatchTrace()
        bt.add(64, 36, 0.001, 0.004)
        bt.add(64, 64, 0.002, 0.003, monitor_s=0.0005)
        rt = RQ.RequestTrace("ab", "replica")
        bt.stamp(rt)
        doc = (bt.bucket, bt.rows, bt.bucket_rows, bt.batches,
               bt.pad_fraction, rt.to_json())
        if RQ is PRQ:
            port_doc = doc
    assert port_doc == doc


def test_tail_sampler_decides_as_jax():
    for seed in (0, 7):
        decisions = []
        for RQ, Hist in ((PRQ, PHist), (JRQ, JHist)):
            h = Hist("h")
            s = RQ.TailSampler(h, rate=0.3, min_count=50, refresh=1)
            random.seed(seed)
            out = []
            for i in range(120):
                h.record(0.002 + 0.0001 * (i % 7))
                kw = _outcomes()[i % 10] if i % 3 == 0 else {}
                out.append(s.decide(_trace(RQ, i, wall_s=0.0005 * i,
                                           **kw)))
            out.append(s.slow_threshold())
            decisions.append(out)
        assert decisions[0] == decisions[1]
        assert {"slow", "sample", "error", "shed"} <= set(decisions[0])


def test_tracer_payloads_match_jax():
    payloads = []
    for RQ in (PRQ, JRQ):
        tr = RQ.ReqTracer("r0", sample_rate=0.0, keep=4)
        assert RQ.ReqTracer("x", enabled=False).start() is None
        for i, kw in enumerate(_outcomes()):
            rt = tr.start(f"{i:016x};replica=router")
            for name, sec in _trace(RQ, i).segs:
                rt.seg(name, sec)
            for k, v in kw.items():
                setattr(rt, k, v)
            tr.finish(rt, wall_s=0.01 * (i + 1), status=kw.get("status",
                                                              200))
        doc = tr.requests_payload()
        payloads.append(doc)
    assert payloads[0] == payloads[1]
    assert payloads[0]["counters"]["kept"] == 8 and \
        len(payloads[0]["kept"]) == 4


def _req(port, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, headers=headers or {},
        method="GET" if data is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A trace directory the port's frontend recorded: singles, a bulk,
    an unknown key and a debug-slept request, with every trace kept."""
    path = F.flow_dir(tmp_path_factory)
    d = tmp_path_factory.mktemp("reqtrace")
    recs = F.records(40, seed=14)
    collector.enable("serve", device="cpu")
    collector.attach_event_log(str(d / "events.jsonl"))
    try:
        eng = ServingEngine(PWM.load(path, device="cpu"), max_batch=8)
        eng.prewarm()
        batcher = MicroBatcher(eng, max_wait_ms=1.0)
        with pytest.MonkeyPatch.context() as mp:
            # the debug-sleep hook, read when the frontend is built
            mp.setenv("TMOG_DEBUG_SLEEP_MAX_MS", "50")
            fe = ServeFrontend(eng, batcher, tracer=PRQ.ReqTracer(
                "replica-7", sample_rate=1.0))
        gauges = PRQ.GaugeSampler(fe.sample_gauges, ring=fe.gauges).start()
        httpd = make_http_server(fe)
        th = threading.Thread(target=httpd.serve_forever,
                              kwargs={"poll_interval": 0.05}, daemon=True)
        th.start()
        port = httpd.server_address[1]
        answers = [_req(port, "/score", r, {"X-Tmog-Trace":
                                            f"{i:016x}"})
                   for i, r in enumerate(recs[:12])]
        answers.append(_req(port, "/score", recs[12:20]))
        answers.append(_req(port, "/score", dict(recs[0], junk=1)))
        answers.append(_req(port, "/score", recs[1],
                            {"X-Tmog-Debug-Sleep": "20"}))
        payload = _req(port, "/requests")[2]
        history = _req(port, "/metrics/history")[2]
        debugz = _req(port, "/debugz")[2]
        httpd.shutdown()
        httpd.server_close()
        gauges.stop()
        batcher.shutdown()
    finally:
        collector.save(str(d / "serve_stage_metrics.json"))
        collector.save_chrome_trace(str(d / "serve_trace.json"))
        collector.detach_event_log()
        collector.disable()
    return dict(dir=str(d), answers=answers, payload=payload,
                history=history, debugz=debugz)


def test_recorded_server_traces(recorded):
    answers = recorded["answers"]
    assert [a[0] for a in answers] == [200] * 13 + [400, 200]
    assert answers[3][1]["X-Tmog-Trace"] == \
        "0000000000000003;replica=replica-7"
    pay = recorded["payload"]
    assert pay["counters"]["traces"] == 15 and pay["counters"]["kept"] == 15
    assert {"e2e", "parse", "queue", "batch", "device", "respond",
            "validate", "debug_sleep"} <= set(pay["segments"])
    assert pay["kept"][-2]["error_type"] == "UnknownFeatureError"
    assert recorded["history"]["replica"] == "replica-7"
    gauge = recorded["history"]["gauges"][0]
    assert gauge["warm"] is True and "queue_depth" in gauge
    assert recorded["debugz"]["batcher_alive"] is True
    assert any("serve-batcher" in k for k in recorded["debugz"]["threads"])


def test_batcher_hand_offs_are_segments(recorded):
    """Every stretch of a queued request is a segment: validate, queue,
    batch, device, the dispatcher's own time around the engine (dispatch)
    and the handler's wake-up after it (wake); a bulk request's scoring
    call outside the engine's walls is its dispatch."""
    kept = [k for k in recorded["payload"]["kept"] if k["status"] == 200]
    singles = [k for k in kept if k.get("rows", 1) == 1]
    bulks = [k for k in kept if k.get("rows", 1) > 1]
    assert len(singles) == 13 and len(bulks) == 1
    for k in singles:
        assert {"parse", "validate", "queue", "batch", "device", "dispatch",
                "wake", "respond"} <= set(k["segments"]), k
    assert {"validate", "batch", "device", "dispatch"} <= \
        set(bulks[0]["segments"])
    for name in PRQ.PORT_SEGMENTS:
        assert name in recorded["payload"]["segments"]


def test_requests_report_matches_jax(recorded):
    d = recorded["dir"]
    assert PTr.load_request_traces(d) == JTr.load_request_traces(d)
    assert len(PTr.load_request_traces(d)) == 15
    for top in (3, 15):
        assert PTr.requests_report(d, top=top) == \
            JTr.requests_report(d, top=top)
        assert PTr.requests_report_rc(d, top=top) == \
            JTr.requests_report_rc(d, top=top)
    assert PTr.trace_report_rc(d, check=True)[1] == 0
    assert JTr.trace_report_rc(d, check=True)[1] == 0
    empty = str(recorded["dir"]) + "/nothing"
    assert PTr.requests_report_rc(empty) == JTr.requests_report_rc(empty)
    assert PTr.requests_report_rc(empty)[1] == 2


def test_coverage_problems_match_jax():
    recs = [
        {"trace_id": "a", "origin": "replica", "wall_ms": 100.0,
         "segments": {"queue": 10.0, "device": 5.0}},        # undercovered
        {"trace_id": "b", "origin": "replica", "wall_ms": 10.0,
         "segments": {"queue": 60.0}},                      # over its wall
        {"trace_id": "c", "origin": "replica", "wall_ms": 200.0,
         "segments": {"device": 190.0}},
        {"trace_id": "c", "origin": "router", "wall_ms": 100.0,
         "segments": {"route": 95.0}},                       # replica > router
        {"trace_id": "d", "origin": "replica", "wall_ms": "slow"},
    ]
    got = PTr._coverage_problems(recs, 0.25, 25.0)
    assert got == JTr._coverage_problems(recs, 0.25, 25.0)
    assert len(got) == 4


def test_follow_events_matches_jax(tmp_path):
    path = str(tmp_path / "events.jsonl")
    log = PTr.EventLog(path, max_mb=0.001, keep=3)
    for i in range(30):
        log.emit("tick", i=i)
    stops = [threading.Event(), threading.Event()]
    seen = [[], []]

    def follow(k, fn):
        for rec in fn(path, stop=stops[k], poll_s=0.01, from_start=True):
            seen[k].append((rec["seq"], rec["i"]))
    threads = [threading.Thread(target=follow, args=(0, PTr.follow_events)),
               threading.Thread(target=follow, args=(1, JTr.follow_events))]
    for t in threads:
        t.start()
    for i in range(30, 45):
        log.emit("tick", i=i)
        time.sleep(0.005)
    deadline = time.time() + 10
    while time.time() < deadline and min(len(s) for s in seen) < 45:
        time.sleep(0.02)
    for s in stops:
        s.set()
    for t in threads:
        t.join(10)
    log.close()
    assert log.rotations > 0
    assert seen[0] == seen[1]
    assert [i for _, i in seen[0]] == sorted(i for _, i in seen[0])
    assert seen[0][-1][1] == 44


def test_gauge_sampler_and_thread_dump():
    ring_calls = []
    s = PRQ.GaugeSampler(lambda: ring_calls.append(1) or {"q": 1},
                         interval_s=0.05).start()
    bad = PRQ.GaugeSampler(lambda: 1 / 0, interval_s=0.05).start()
    time.sleep(0.2)
    s.stop()
    bad.stop()
    assert len(s.ring) >= 2 and len(bad.ring) == 0
    assert s.ring.to_json()[0]["q"] == 1
    dump = PRQ.thread_dump()
    assert any(k.startswith("MainThread") for k in dump)
    assert PRQ.__all__ == JRQ.__all__
