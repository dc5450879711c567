"""The port's workflow save/load (workflow/io.py) against the JAX package's.

The kitchen-sink DAG of tests/test_kitchen_sink_roundtrip.py (a PickList,
a hashed Text, a Real, a Date, a Geolocation and a RealMap through
transmogrify, SanityChecker and a train/validation selector over logistic
regression and Spark GBT) at n = 500 is built and trained in each package
from the same seeded values, with both uid counters reset. Tolerances
(CPU): a port save loaded in the port scores bit-identically; a save of
either package loaded in the other scores within 1e-5 of the model that
was saved; the op-model.json key sets, stage classes, uids and layers are
the JAX package's. Lambda stages load through `custom_stages`, a newer
format raises, the RawFeatureFilter's blacklist and results survive the
round trip, and `save_args()` of every fitted stage is plain numpy and
JSON.
"""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.models.trees import OpGBTClassifier as JGBT
from transmogrifai_tpu.stages.base import unary_transformer as j_unary
from transmogrifai_tpu import types as JT
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.io import load_model as j_load

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.models.trees import OpGBTClassifier as PGBT
from transmogrifai_tpu_torch.stages.base import unary_transformer as p_unary
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
from transmogrifai_tpu_torch.workflow import io as PIO
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM

N = 500


def kitchen_values(n=N, seed=8):
    """The kitchen-sink columns (tests/test_kitchen_sink_roundtrip.py)."""
    rng = np.random.default_rng(seed)
    cats = rng.choice(["red", "green", "blue", None], n,
                      p=[0.4, 0.3, 0.25, 0.05])
    words = ["alpha beta", "gamma delta words", "omega", None]
    txt = rng.choice(words, n)
    age = rng.uniform(18, 90, n)
    age[rng.uniform(size=n) < 0.1] = np.nan
    ts = (1.6e12 + rng.uniform(0, 1e10, n)).astype(np.int64)
    geo = [[float(rng.uniform(-60, 60)), float(rng.uniform(-120, 120)), 1.0]
           if rng.uniform() > 0.1 else None for _ in range(n)]
    mp = [{"k1": float(rng.normal()), "k2": float(rng.normal())}
          for _ in range(n)]
    score = ((cats == "red").astype(float) + 0.02 * np.nan_to_num(age, nan=45)
             + rng.normal(scale=0.5, size=n))
    y = (score > np.median(score)).astype(float)
    return [
        ("cat", "PickList", [None if c is None else str(c) for c in cats]),
        ("txt", "Text", [None if t is None else str(t) for t in txt]),
        ("age", "Real", [None if np.isnan(v) else float(v) for v in age]),
        ("ts", "Date", ts.tolist()),
        ("geo", "Geolocation", geo),
        ("mp", "RealMap", mp),
        ("label", "RealNN", y.tolist()),
    ]


def kitchen(pkg, values, dev=None):
    """(dataset, prediction feature) of the kitchen-sink DAG in one
    package: pkg = (FeatureBuilder, uid, transmogrify, SanityChecker,
    selector, LR, GBT, Dataset, types)."""
    FB, U, tm, SC, BCMS, LR, GBT, DS, T = pkg
    U.reset_uids()
    kw = {} if dev is None else {"device": dev}
    ds = DS.from_features([(n, getattr(T, t), v) for n, t, v in values])
    feats = [getattr(FB, t)(n).as_predictor() for n, t, _ in values[:-1]]
    fy = FB.RealNN("label").as_response()
    checked = SC().set_input(fy, tm(feats)).get_output()
    pred = BCMS.with_train_validation_split(models_and_parameters=[
        (LR(max_iter=15, **kw), [dict(reg_param=0.01)]),
        (GBT(max_iter=5, max_depth=3, **kw), [dict()]),
    ]).set_input(fy, checked).get_output()
    return ds, pred


JPKG = (JFB, JU, j_tm, JSC, JBCMS, JLR, JGBT, JDataset, JT)
PPKG = (PFB, PU, p_tm, PSC, PBCMS, PLR, PGBT, PDataset, PT)


def _probs(model, ds, pred):
    return np.asarray(model.score(ds).data(pred.name), np.float64)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    values = kitchen_values()
    mp = pytest.MonkeyPatch()
    mp.setenv("TMOG_NO_HOST_TREES", "1")
    try:
        jds, jpred = kitchen(JPKG, values)
        jmodel = JWorkflow().set_input_dataset(jds) \
            .set_result_features(jpred).train()
        pds, ppred = kitchen(PPKG, values, "cpu")
        pmodel = PWorkflow(device="cpu").set_input_dataset(pds) \
            .set_result_features(ppred).train()
    finally:
        mp.undo()
    root = tmp_path_factory.mktemp("models")
    jpath, ppath = str(root / "jax"), str(root / "port")
    jmodel.save(jpath)
    pmodel.save(ppath)
    return dict(jds=jds, jpred=jpred, jmodel=jmodel, pds=pds, ppred=ppred,
                pmodel=pmodel, jpath=jpath, ppath=ppath, root=root)


def test_port_save_loads_bit_identical(trained):
    t = trained
    loaded = PWM.load(t["ppath"], device="cpu")
    a = _probs(t["pmodel"], t["pds"], t["ppred"])
    b = _probs(loaded, t["pds"], t["ppred"])
    assert a.shape == (N, 5)
    assert np.array_equal(a, b)
    assert loaded.selector_summary().to_json() == \
        t["pmodel"].selector_summary().to_json()
    assert loaded.blacklist == t["pmodel"].blacklist


def test_jax_save_loads_in_port(trained):
    t = trained
    loaded = PWorkflow(device="cpu").load_model(t["jpath"])
    ref = np.asarray(t["jmodel"].score(t["jds"]).data(t["jpred"].name),
                     np.float64)
    got = _probs(loaded, t["pds"], t["jpred"])
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_port_save_loads_in_jax(trained):
    t = trained
    loaded = j_load(t["ppath"])
    ref = _probs(t["pmodel"], t["pds"], t["ppred"])
    got = np.asarray(loaded.score(t["jds"]).data(t["ppred"].name),
                     np.float64)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _doc(path):
    with open(os.path.join(path, PIO.MODEL_JSON)) as fh:
        return json.load(fh)


def test_op_model_json_matches_jax(trained):
    j, p = _doc(trained["jpath"]), _doc(trained["ppath"])
    assert set(p) == set(j)
    assert p["format_version"] == j["format_version"] == PIO.FORMAT_VERSION
    assert p["result_feature_uids"] == j["result_feature_uids"]
    assert [(f["uid"], f["name"], f["type"], f["is_response"],
             f["origin_stage_uid"], f["parent_uids"]) for f in p["features"]] \
        == [(f["uid"], f["name"], f["type"], f["is_response"],
             f["origin_stage_uid"], f["parent_uids"]) for f in j["features"]]
    assert [set(f) for f in p["features"]] == [set(f) for f in j["features"]]
    assert [(g["class"], g["args"]["uid"], set(g)) for g in p["generators"]] \
        == [(g["class"], g["args"]["uid"], set(g)) for g in j["generators"]]
    shape = (lambda doc: [[(e["class"], e["uid"], e["input_uids"],
                            e["output_name"], sorted(e))
                           for e in layer] for layer in doc["stage_layers"]])
    assert shape(p) == shape(j)


def test_saved_args_are_plain(trained):
    def walk(obj, where):
        assert not isinstance(obj, torch.Tensor), where
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, f"{where}.{k}")
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(v, f"{where}[{i}]")
    for st in trained["pmodel"].stages:
        args = st.save_args()
        walk(args, type(st).__name__)
        json.dumps(PIO.pack_args(args, {}, st.uid))


def test_default_device_is_cuda(trained):
    loaded = PWM.load(trained["ppath"])
    sel = loaded.selected_model()
    assert sel.device is None and sel.best_model.device is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            loaded.score(trained["pds"])


def test_newer_format_raises(trained, tmp_path):
    import shutil
    path = str(tmp_path / "newer")
    shutil.copytree(trained["ppath"], path)
    doc = _doc(path)
    doc["format_version"] = PIO.FORMAT_VERSION + 1
    with open(os.path.join(path, PIO.MODEL_JSON), "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ValueError, match="newer"):
        PWM.load(path, device="cpu")


def _lambda_flow(FB, U, tm, W, unary, T, dev=None):
    U.reset_uids()
    x = FB.Real("x").as_predictor()
    y = FB.RealNN("y").as_response()
    sq = unary("square", lambda v: None if v.value is None
               else v.value * v.value, T.Real, T.Real).set_input(x)
    vec = tm([x, sq.get_output()])
    kw = {} if dev is None else {"device": dev}
    return W(**kw).set_result_features(vec), sq


@pytest.mark.parametrize("saver", ["port", "jax"])
def test_custom_stages_for_lambda(saver, tmp_path):
    rng = np.random.default_rng(3)
    xs = [None if i % 7 == 0 else float(v)
          for i, v in enumerate(rng.normal(size=200))]
    ys = rng.normal(size=200).tolist()
    values = [("x", "Real", xs), ("y", "RealNN", ys)]
    pds = PDataset.from_features([(n, getattr(PT, t), v)
                                  for n, t, v in values])
    if saver == "jax":
        jds = JDataset.from_features([(n, getattr(JT, t), v)
                                      for n, t, v in values])
        wf, _ = _lambda_flow(JFB, JU, j_tm, JWorkflow, j_unary, JT)
        model = wf.set_input_dataset(jds).train()
    else:
        wf, _ = _lambda_flow(PFB, PU, p_tm, PWorkflow, p_unary, PT, "cpu")
        model = wf.set_input_dataset(pds).train()
    path = str(tmp_path / "lambda")
    model.save(path)
    vec_name = model.result_features[0].name
    ref = np.asarray(model.score(pds if saver == "port" else jds)
                     .data(vec_name))
    with pytest.raises(ValueError, match="custom_stages"):
        PWM.load(path, device="cpu")
    _, sq = _lambda_flow(PFB, PU, p_tm, PWorkflow, p_unary, PT, "cpu")
    loaded = PWM.load(path, custom_stages={sq.uid: sq}, device="cpu")
    assert loaded.dag.stages[0] is sq or sq in loaded.dag.stages
    np.testing.assert_allclose(
        np.asarray(loaded.score(pds).data(vec_name)), ref, atol=1e-6)


def test_blacklist_and_rff_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    n = 400
    a = rng.normal(size=n)
    sparse = [float(v) if i % 500 == 0 else None
              for i, v in enumerate(rng.normal(size=n))]
    y = (a + rng.normal(scale=0.5, size=n) > 0).astype(float)
    values = [("a", "Real", a.tolist()), ("sparse", "Real", sparse),
              ("label", "RealNN", y.tolist())]
    PU.reset_uids()
    ds = PDataset.from_features([(k, getattr(PT, t), v)
                                 for k, t, v in values])
    feats = [PFB.Real("a").as_predictor(), PFB.Real("sparse").as_predictor()]
    fy = PFB.RealNN("label").as_response()
    checked = PSC().set_input(fy, p_tm(feats)).get_output()
    pred = PBCMS.with_train_validation_split(models_and_parameters=[
        (PLR(max_iter=10), [dict(reg_param=0.01)])]) \
        .set_input(fy, checked).get_output()
    model = PWorkflow(device="cpu").set_input_dataset(ds) \
        .set_result_features(pred) \
        .with_raw_feature_filter(PRFF(min_fill_rate=0.05)).train()
    assert model.blacklist == ["sparse"]
    path = str(tmp_path / "rff")
    model.save(path)
    loaded = PWM.load(path, device="cpu")
    assert loaded.blacklist == model.blacklist
    assert loaded.rff_results.to_json() == model.rff_results.to_json()
    jloaded = j_load(path)
    assert jloaded.blacklist == model.blacklist
    assert jloaded.rff_results.to_json() == model.rff_results.to_json()
    assert np.array_equal(_probs(loaded, ds, pred), _probs(model, ds, pred))
