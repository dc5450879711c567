"""The MLP, the isotonic calibrator and a traced train() on the card. Every
test here needs a CUDA device and skips without one. This file imports
neither jax nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mlp_gpu.py

Tolerances: the MLP fitted on the card from the same initial weights as
the plain CPU fit, after 50 Adam steps, within 1e-5 (weights, biases and
probabilities; measured up to 4.3e-6 and 2.1e-6) with identical classes.
After 200 steps the fits have parted: Adam steps a weight by the step size
times the sign of its gradient's running mean wherever that gradient is
rounding noise, so the two devices' fits part further with every step
(single probabilities measured up to 0.093 apart). There the mean
|probability difference| is within 0.01, the classes agree on 97% of the
rows and the two accuracies within 0.01 of each other (measured 0.0066,
99.2% and 0.0011 at K = 2; NVIDIA H100 80GB HBM3, 700 W); the
calibrator's card transform equal to its CPU transform (float64
`searchsorted` both) and monotone; a traced train() through the runner
writes the three artifacts, passes `trace_report(check=True)`, and its
kernel records count every launch of the four kernels in train().
"""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.automl.preparators import SanityChecker
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.data.dataset import Column, Dataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as FB
from transmogrifai_tpu_torch.models import mlp as PM
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.utils.metrics import collector
from transmogrifai_tpu_torch.utils.tracing import trace_report_rc
from transmogrifai_tpu_torch.workflow import (OpParams, OpWorkflowRunner,
                                              Workflow)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's card path)")
    return torch.device("cuda")


def _data(n=20_000, d=24, K=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    s = X[:, 0] + 0.7 * X[:, 1] - 0.5 * X[:, 2] + 0.4 * rng.normal(size=n)
    y = np.digitize(s, np.quantile(s, np.arange(1, K) / K))
    return X, y.astype(np.float32), rng.uniform(0.5, 1.5, n).astype(
        np.float32)


@pytest.mark.parametrize("K,steps", [(2, 50), (7, 50), (2, 200), (7, 200)])
def test_mlp_card_matches_cpu(cuda_device, K, steps):
    X, y, w = _data(K=K, seed=K)
    kw = dict(hidden_layers=[16, 10], max_iter=steps, step_size=0.05)
    cpu = PM.OpMultilayerPerceptronClassifier(device="cpu", **kw) \
        .fit_arrays(X, y, w)
    card = PM.OpMultilayerPerceptronClassifier(**kw).fit_arrays(X, y, w)
    pc, pg = cpu.predict_arrays(X), card.predict_arrays(X)
    if steps == 50:
        for a, b in zip(cpu.weights + cpu.biases,
                        card.weights + card.biases):
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        np.testing.assert_allclose(pg[2], pc[2], atol=1e-5, rtol=0)
        assert np.array_equal(pg[0], pc[0])
    else:
        assert np.abs(pg[2] - pc[2]).mean() <= 0.01
        assert (pg[0] == pc[0]).mean() >= 0.97
        acc_g, acc_c = (pg[0] == y).mean(), (pc[0] == y).mean()
        assert abs(acc_g - acc_c) <= 0.01 and acc_g > 0.6


def test_calibrator_card_equals_cpu(cuda_device):
    rng = np.random.default_rng(9)
    n = 200_000
    score = rng.uniform(size=n)
    label = (rng.uniform(size=n) < score ** 2).astype(np.float64)
    model = PM.IsotonicRegressionCalibrator().fit_columns(
        Column("float", label), Column("float", score))
    assert model.device is None       # None: the card
    q = np.concatenate([rng.uniform(-0.2, 1.2, n), [np.nan, np.inf]])
    card = model.apply(q)
    model.device = "cpu"
    assert np.array_equal(card, model.apply(q), equal_nan=True)
    order = np.argsort(q[:n])
    assert (np.diff(card[:n][order]) >= 0).all()


def test_traced_train_writes_artifacts(cuda_device, tmp_path):
    rng = np.random.default_rng(4)
    n = 20_000
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] - X[:, 1] + 0.5 * rng.normal(size=n) > 0).astype(float)
    ds = Dataset({f"x{i}": Column("float", X[:, i]) for i in range(5)})
    ds = ds.with_column("y", Column("float", y))
    label = FB.RealNN("y").as_response()
    vec = transmogrify([FB.Real(f"x{i}").as_predictor() for i in range(5)])
    checked = SanityChecker().set_input(label, vec).get_output()
    pred = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, models_and_parameters=[
            (OpRandomForestClassifier(num_trees=4, max_depth=4), [dict()]),
            (PM.OpMultilayerPerceptronClassifier(max_iter=50), [dict()])],
    ).set_input(label, checked).get_output()
    wf = Workflow().set_input_dataset(ds).set_result_features(pred)
    TK.reset_launches()
    OpWorkflowRunner(wf).run(OpWorkflowRunner.TRAIN, OpParams(
        collect_stage_metrics=True, metrics_location=str(tmp_path)))
    assert {"train_stage_metrics.json", "train_trace.json",
            "events.jsonl"} <= set(os.listdir(tmp_path))
    text, rc = trace_report_rc(str(tmp_path), check=True)
    assert rc == 0, text
    kern = [k for k in collector.trace.spans if k.kind == "kernel"
            and not k.name.startswith("stats_pass")]
    assert kern and all(k.attrs["roof_gbps"] == 3350.0 for k in kern
                        if "H100 80GB HBM3" in torch.cuda.get_device_name())
    counted = {name: sum(k.attrs["launches"][name] for k in kern)
               for name in TK.KERNELS}
    assert counted == dict(TK.launches) and all(counted.values())
    doc = json.loads((tmp_path / "train_stage_metrics.json").read_text())
    assert doc["kernel_metrics"] and doc["stats_metrics"]
    peaks = [s.attrs.get("hbm_peak_bytes") for s in collector.trace.spans
             if s.kind in ("workflow", "layer", "stage")]
    assert all(p is not None and p > 0 for p in peaks)
    root = collector.trace.spans[0]
    assert root.attrs["hbm_peak_bytes"] >= max(peaks)
