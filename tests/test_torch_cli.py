"""The port's command line (`python -m transmogrifai_tpu_torch`, cli.py)
against the JAX package's, on the CPU.

Held: `--help` lists the JAX package's subcommands; the subcommands the
port has not (fleet, plan, monitor, retrain-worker, trace-report --pod)
exit 2 naming the JAX package's module; `serve` takes every flag of the
JAX package's `serve` (and `--device`); `gen` writes the same files with
the same feature declarations and selector from one CSV, its app imports
transmogrifai_tpu_torch and nothing of the JAX package, and its workflow
builds on the CPU; `serve --prewarm-only --device cpu` runs in a
subprocess (rc 0, one summary line, serve.json stamped with the model's
content hash); a `serve --port 0` subprocess answers a record, drains on
SIGTERM with rc 0, and its metrics directory passes `trace-report --check`
and `--requests`; `trace-report` exits 2 on a directory with nothing to
read. The model is tests/torch_serving_flow.py's.
"""
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import torch_serving_flow as F
from transmogrifai_tpu import cli as JCLI

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import cli as PCLI
from transmogrifai_tpu_torch.workflow import io as PIO

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv, capsys):
    """(exit code, stdout, stderr) of one in-process CLI call."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _subcommands(text):
    return set(re.search(r"\{([a-z,-]+)\}", text).group(1).split(","))


def _flags(text):
    return set(re.findall(r"(--[a-z][a-z-]*)", text))


def test_help_lists_reference_subcommands(capsys):
    rc, port, _ = _run(PCLI.main, ["--help"], capsys)
    jrc, jax, _ = _run(JCLI.main, ["--help"], capsys)
    assert rc == jrc == 0
    assert _subcommands(port) == _subcommands(jax) == {
        "gen", "trace-report", "serve", "fleet", "plan", "monitor",
        "retrain-worker"}


@pytest.mark.parametrize("command", ["serve", "trace-report", "gen"])
def test_flags_cover_reference(capsys, command):
    _, port, _ = _run(PCLI.main, [command, "--help"], capsys)
    _, jax, _ = _run(JCLI.main, [command, "--help"], capsys)
    assert _flags(jax) <= _flags(port)
    if command == "serve":
        assert _flags(port) - _flags(jax) == {"--device"}


@pytest.mark.parametrize("argv, package", [
    (["fleet", "m", "--replicas", "2"], "transmogrifai_tpu/fleet/"),
    (["plan", "calibrate", "--budget-s", "3"], "transmogrifai_tpu/planner/"),
    (["monitor", "m", "data.csv", "--fail-on-drift"],
     "transmogrifai_tpu/monitor/"),
    (["retrain-worker", "spec.json"], "transmogrifai_tpu/retrain/"),
    (["trace-report", "d", "--pod"],
     "transmogrifai_tpu/parallel/podtrace.py"),
])
def test_unported_commands_exit_2(capsys, argv, package):
    rc, _, err = _run(PCLI.main, argv, capsys)
    assert rc == 2 and package in err and "not ported" in err


@pytest.fixture()
def titanic_csv(tmp_path):
    rng = np.random.default_rng(0)
    path = tmp_path / "titanic.csv"
    lines = ["passengerId,survived,pclass,sex,age,fare"]
    for i in range(120):
        sex = "female" if rng.uniform() < 0.4 else "male"
        age = "" if rng.uniform() < 0.2 else f"{rng.uniform(1, 80):.1f}"
        lines.append(f"{i},{int(rng.uniform() < 0.4)},"
                     f"{rng.integers(1, 4)},{sex},{age},"
                     f"{rng.lognormal(3, 1):.2f}")
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _decls(text):
    return [ln for ln in text.splitlines()
            if "FeatureBuilder." in ln or ln.startswith(("PREDICTORS",
                                                         "RESPONSE"))]


def test_gen_matches_reference_project(titanic_csv, tmp_path, monkeypatch):
    kw = dict(response="survived", id_col="passengerId", name="Titanic")
    pf = PCLI.generate_project(titanic_csv, output=str(tmp_path / "p"),
                               **kw)
    jf = JCLI.generate_project(titanic_csv, output=str(tmp_path / "j"),
                               **kw)
    assert set(pf) == set(jf)
    assert _decls(pf["features.py"]) == _decls(jf["features.py"])
    assert "BinaryClassificationModelSelector" in pf["app.py"]
    assert json.loads(pf["params.json"]) == json.loads(jf["params.json"])
    for name in ("features.py", "app.py", "test_app.py"):
        compile(pf[name], name, "exec")
        imports = re.findall(r"^\s*(?:from|import) (\S+)", pf[name], re.M)
        assert not [m for m in imports if m.split(".")[0]
                    == "transmogrifai_tpu"], name
    # the generated workflow is the port's, on the device it is given
    monkeypatch.syspath_prepend(str(tmp_path / "p"))
    for mod in ("app", "features"):
        sys.modules.pop(mod, None)
    import app
    wf = app.build_workflow(device="cpu")
    assert type(wf).__module__ == "transmogrifai_tpu_torch.workflow.workflow"
    assert wf.device == "cpu"
    (pred,) = wf.result_features
    assert type(pred.origin_stage).__name__ == "ModelSelector"
    assert pred.feature_type.__name__ == "Prediction"
    assert app.Titanic(device="cpu").parse_args(
        ["--run-type", "Train"]).run_type == "Train"
    for mod in ("app", "features"):
        sys.modules.pop(mod, None)


def _cli_env():
    return dict(os.environ, PYTHONPATH=REPO)


def test_serve_prewarm_only_subprocess(tmp_path_factory, tmp_path):
    d = F.copy_flow(tmp_path_factory, tmp_path / "m")
    proc = subprocess.run(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "serve", d,
         "--prewarm-only", "--device", "cpu", "--max-batch", "16"],
        cwd=REPO, env=_cli_env(), capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    summary = json.loads(lines[0])["prewarm"]
    assert summary["buckets"] == [1, 8, 16]
    assert [b["bucket"] for b in summary["per_bucket"]] == [1, 8, 16]
    assert "drift monitoring is not ported" in proc.stderr
    manifest = PIO.load_serve_manifest(d)
    assert manifest["model_hash"] == PIO.model_content_hash(d)
    assert summary["manifest"] == os.path.join(d, "serve.json")


def test_serve_subprocess_answers_and_drains(tmp_path_factory, tmp_path,
                                             capsys):
    d = F.flow_dir(tmp_path_factory)
    metrics = str(tmp_path / "metrics")
    proc = subprocess.Popen(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "serve", d,
         "--device", "cpu", "--port", "0", "--max-batch", "8",
         "--metrics-location", metrics, "--trace-sample", "1.0",
         "--monitor", "off"],
        cwd=REPO, env=_cli_env(), stderr=subprocess.PIPE, text=True)
    # the server's log is read on a thread for the whole run (its pipe
    # never fills); the serving line is awaited with a deadline, so a
    # child that never prints fails the test instead of hanging it
    lines = queue.Queue()

    def read_log():
        for line in proc.stderr:
            lines.put(line)
        lines.put(None)
    threading.Thread(target=read_log, daemon=True).start()
    try:
        port = None
        deadline = time.time() + 120
        while port is None:
            try:
                line = lines.get(timeout=max(deadline - time.time(), 0.0))
            except queue.Empty:
                break
            if line is None:
                break
            m = re.search(r"serving .* on http://[^:]+:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port is not None, "no serving line"
        rec = F.records(3, seed=15)[0]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/score", data=json.dumps(rec).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert set(out) == {f.name for f in
                            F.load_both(d)[1].result_features}
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as r:
            m = json.loads(r.read())
        assert m["requests"] == 1 and m["post_warmup_compiles"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    rc, out, _ = _run(PCLI.main, ["trace-report", metrics, "--check"],
                      capsys)
    assert rc == 0 and "OK" in out
    rc, out, _ = _run(PCLI.main, ["trace-report", metrics, "--requests"],
                      capsys)
    assert rc == 0 and "1 kept trace(s)" in out
    rc, out, _ = _run(PCLI.main, ["trace-report", metrics], capsys)
    assert rc == 0 and "Recompiles per program" in out
    rc, _, _ = _run(PCLI.main, ["trace-report", str(tmp_path / "none")],
                    capsys)
    assert rc == 2
