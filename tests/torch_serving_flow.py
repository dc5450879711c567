"""The model of the port's serving tests: one small flow trained in the JAX
package, saved, and loaded from that one directory into both packages.

Raw features: two Reals (`a` 10% missing, `b`), a PickList `c` (5%
missing), a Text `t`, and the RealNN label `y`. Two result features share
one transmogrified vector: a train/validation selector over logistic
regression and one over a random forest, so both the GLM and the tree
ensemble score on every path. `flow_dir(tmp_path_factory)` trains and saves
once a test session: the parallel runner's workers share the session's
base temporary directory, and the first worker to take its lock trains
while the others wait and read the same files. A test that writes into the
directory works on a copy (`copy_flow`).
"""
import fcntl
import os
import shutil
import time

import numpy as np

N_ROWS = 300


def rows(n=N_ROWS, seed=11):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "omega"]
    out = []
    for _ in range(n):
        a = float(rng.normal())
        b = float(rng.normal())
        c = str(rng.choice(["x", "y", "z"]))
        out.append({
            "a": None if rng.uniform() < 0.1 else a,
            "b": b,
            "c": None if rng.uniform() < 0.05 else c,
            "t": " ".join(rng.choice(words, 3)),
            "y": float(a + 0.5 * b + 0.8 * (c == "x")
                       + rng.normal(0, 0.3) > 0.3)})
    return out


def records(n=N_ROWS, seed=11):
    """Unlabeled serving records (the label key dropped)."""
    return [{k: v for k, v in r.items() if k != "y"} for r in rows(n, seed)]


def _train(path):
    from transmogrifai_tpu.automl.selectors import \
        BinaryClassificationModelSelector as BCMS
    from transmogrifai_tpu.automl.transmogrifier import transmogrify
    from transmogrifai_tpu.features.builder import FeatureBuilder as FB
    from transmogrifai_tpu.models.glm import OpLogisticRegression
    from transmogrifai_tpu.models.trees import OpRandomForestClassifier
    from transmogrifai_tpu.readers.readers import ListReader
    from transmogrifai_tpu.utils import uid
    from transmogrifai_tpu.workflow import Workflow

    uid.reset_uids()
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
    Workflow().set_reader(ListReader(rows())).set_result_features(lr, rf) \
        .train().save(path)


# Seconds a worker waits for another worker's training of the flow
LOCK_WAIT_S = 300


def _lock(fh, wait_s: float = LOCK_WAIT_S) -> None:
    """An exclusive lock on `fh`, polled, failing after `wait_s` seconds
    rather than blocking a test worker for good."""
    deadline = time.monotonic() + wait_s
    while True:
        try:
            fcntl.flock(fh, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return
        except BlockingIOError:
            if time.monotonic() > deadline:
                raise TimeoutError(f"the serving flow's lock was held for "
                                   f"over {wait_s} s")
            time.sleep(0.05)


def flow_dir(tmp_path_factory):
    """The saved flow's directory, trained by the first caller of the test
    session."""
    base = tmp_path_factory.getbasetemp()
    shared = base.parent if base.name.startswith("popen-gw") else base
    path = shared / "torch_serving_flow" / "model"
    with open(shared / "torch_serving_flow.lock", "w") as lock:
        _lock(lock)
        try:
            if not (path / "arrays.npz").exists():
                tmp = shared / "torch_serving_flow" / f"tmp{os.getpid()}"
                _train(str(tmp))
                os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return str(path)


def copy_flow(tmp_path_factory, dest):
    """A copy of the saved flow at `dest` (a test's own directory)."""
    shutil.copytree(flow_dir(tmp_path_factory), dest)
    return str(dest)


def load_both(path):
    """(JAX-loaded model, port-loaded model on the CPU) of one directory."""
    from transmogrifai_tpu.workflow.workflow import WorkflowModel as JWM
    from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM
    return JWM.load(path), PWM.load(path, device="cpu")


def probs(rows_out, name):
    """probability_1 of the result feature `name` in scored row dicts."""
    return np.array([r[name]["probability_1"] for r in rows_out])
