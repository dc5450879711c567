"""The serving engine on the card. Every test here needs a CUDA device and
skips without one. This file imports neither jax nor the JAX package, so it
also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_gpu.py

A small flow (two Reals, one 10% missing, a PickList, a Text; selectors
over logistic regression and over a random forest) trains on the card and
is saved; the directory loads onto the card and onto the CPU. Held: the
card engine prewarms every bucket; 200 records score within 1e-5 of the
CPU engine (probabilities; identical predictions); after prewarm, 50
batches of mixed sizes from five threads other than the prewarm's add no
cold start (`post_warmup_compiles == 0`: no kernel build, no new
allocator segment on the card); the engine's single-record local route
runs its stages on the CPU while its batch route runs them on the card.
"""
import threading

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as BCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
from transmogrifai_tpu_torch.models import glm as PG
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.readers.readers import ListReader
from transmogrifai_tpu_torch.serve import ServingEngine
from transmogrifai_tpu_torch.utils.metrics import collector
from transmogrifai_tpu_torch.workflow import Workflow, WorkflowModel

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    return torch.device("cuda")


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a, b = float(rng.normal()), float(rng.normal())
        c = str(rng.choice(["x", "y", "z"]))
        out.append({"a": None if rng.uniform() < 0.1 else a, "b": b,
                    "c": c, "t": " ".join(rng.choice(
                        ["alpha", "beta", "gamma", "delta"], 3)),
                    "y": float(a + 0.5 * b + 0.8 * (c == "x") > 0.3)})
    return out


@pytest.fixture(scope="module")
def saved(cuda_device, tmp_path_factory):
    fa = FB.Real("a").extract(lambda r: r.get("a")).as_predictor()
    fb = FB.Real("b").extract(lambda r: r.get("b")).as_predictor()
    fc = FB.PickList("c").extract(lambda r: r.get("c")).as_predictor()
    ft = FB.Text("t").extract(lambda r: r.get("t")).as_predictor()
    fy = FB.RealNN("y").extract(lambda r: r.get("y")).as_response()
    vec = transmogrify([fa, fb, fc, ft])
    lr = BCMS.with_train_validation_split(models_and_parameters=[
        (OpLogisticRegression(max_iter=20), [dict(reg_param=0.01)])],
    ).set_input(fy, vec).get_output()
    rf = BCMS.with_train_validation_split(models_and_parameters=[
        (OpRandomForestClassifier(num_trees=5, max_depth=3), [dict()])],
    ).set_input(fy, vec).get_output()
    path = str(tmp_path_factory.mktemp("serving_gpu") / "model")
    Workflow(device="cuda").set_reader(ListReader(_rows(2000, 1))) \
        .set_result_features(lr, rf).train().save(path)
    recs = [{k: v for k, v in r.items() if k != "y"}
            for r in _rows(200, 2)]
    return path, recs, [lr.name, rf.name]


def test_card_engine_matches_cpu_engine(saved):
    path, recs, names = saved
    card = ServingEngine(WorkflowModel.load(path), max_batch=64)
    assert card.device.type == "cuda"
    summary = card.prewarm()
    assert [b["bucket"] for b in summary["per_bucket"]] == [1, 8, 16, 32,
                                                            64]
    host = ServingEngine(WorkflowModel.load(path, device="cpu"),
                         max_batch=64)
    host.prewarm()
    got, want = card.score_batch(recs), host.score_batch(recs)
    for name in names:
        p = np.array([r[name]["probability_1"] for r in got])
        q = np.array([r[name]["probability_1"] for r in want])
        assert np.abs(p - q).max() <= 1e-5, name
        assert [r[name]["prediction"] for r in got] == \
            [r[name]["prediction"] for r in want]


def test_no_cold_start_after_prewarm(saved):
    path, recs, _ = saved
    collector.enable("serving_gpu")
    try:
        eng = ServingEngine(WorkflowModel.load(path), max_batch=64)
        summary = eng.prewarm()
        assert summary["compiles"] is not None
        sizes = np.random.default_rng(5).integers(1, 65, 50)
        lens = []

        def client(k):
            # batches from threads other than the one that prewarmed
            for n in sizes[k::5]:
                lens.append((len(eng.score_batch(recs[:int(n)])), n))
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        m = eng.metrics()
    finally:
        collector.finish()
        collector.disable()
    assert sorted(a for a, _ in lens) == sorted(int(n) for _, n in lens)
    assert m["batches"] == 50 and m["post_warmup_compiles"] == 0, m


def test_local_route_on_cpu_batch_route_on_card(saved, monkeypatch):
    path, recs, names = saved
    seen = []
    real = PG.resolve_device

    def spy(device=None):
        dev = real(device)
        seen.append((threading.current_thread().name, dev.type))
        return dev

    monkeypatch.setattr(PG, "resolve_device", spy)
    eng = ServingEngine(WorkflowModel.load(path), max_batch=8,
                        single_record="local")
    eng.prewarm()
    del seen[:]
    (one,) = eng.score_batch(recs[:1])
    local = {t for _, t in seen}
    del seen[:]
    batch = eng.score_batch(recs[:3])
    assert local == {"cpu"} and {t for _, t in seen} == {"cuda"}
    for name in names:
        assert abs(one[name]["probability_1"]
                   - batch[0][name]["probability_1"]) <= 1e-5
