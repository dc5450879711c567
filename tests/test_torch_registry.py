"""A user's stage class through save and load (stages/registry.py's
`register_stage` and `register_module`) against the JAX package.

Each package gets a user stage class of the same name, `ShiftedScale`, over
its own `Transformer` (x -> 2x + `shift`, a declared param that is saved).
A workflow holding it (raw Real -> ShiftedScale -> transmogrify ->
SanityChecker -> logistic regression) is trained in each package on the
same seeded values and saved; the other package loads it once the class
is registered, and scores within 1e-6 of the package that saved it.
Before registration the port raises NotImplementedError naming the class.
`register_module` finds a class in a module the registry did not scan. The
registries' module state is restored after each test.
"""
import sys

import numpy as np
import pytest

from transmogrifai_tpu import types as JT
from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.stages import base as JB
from transmogrifai_tpu.stages import registry as JR
from transmogrifai_tpu.stages.params import Param as JParam
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow
from transmogrifai_tpu.workflow.io import load_model as j_load

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch import types as PT
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.stages import base as PB
from transmogrifai_tpu_torch.stages import registry as PR
from transmogrifai_tpu_torch.stages.params import Param as PParam
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM

N = 300


def _user_stage(base, types, param):
    """The user's class over one package's Transformer."""

    class ShiftedScale(base.Transformer):
        input_types = (types.Real,)
        output_type = types.Real

        @classmethod
        def _declare_params(cls):
            return [param("shift", "added after doubling", 0.5)]

        def __init__(self, shift: float = 0.5, uid=None, **params):
            params.setdefault("shift", float(shift))
            super().__init__(params.pop("operation_name", "shiftedScale"),
                             uid=uid, **params)

        def transform_value(self, v):
            if v.value is None:
                return types.Real(None)
            return types.Real(2.0 * v.value + self.get_param("shift"))

    return ShiftedScale


JShifted = _user_stage(JB, JT, JParam)
PShifted = _user_stage(PB, PT, PParam)


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    """Each test starts from, and leaves, registries without the user's
    classes and modules."""
    for R in (JR, PR):
        monkeypatch.setattr(R, "_EXTRA_STAGES", {})
        monkeypatch.setattr(R, "_STAGE_MODULES", list(R._STAGE_MODULES))
        monkeypatch.setattr(R, "_registry_cache", None)
    yield


def _values(seed=21):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=N)
    b = rng.normal(size=N)
    y = (1.5 * a - b + rng.normal(scale=0.5, size=N) > 0).astype(float)
    return {"a": a.tolist(), "b": b.tolist(), "label": y.tolist()}


def _flow(FB, U, tm, SC, BCMS, LR, DS, T, stage_cls, kw, cols):
    U.reset_uids()
    ds = DS.from_features([("a", T.Real, cols["a"]), ("b", T.Real, cols["b"]),
                           ("label", T.RealNN, cols["label"])])
    fa, fb = FB.Real("a").as_predictor(), FB.Real("b").as_predictor()
    fy = FB.RealNN("label").as_response()
    shifted = stage_cls(shift=0.25).set_input(fa).get_output()
    checked = SC().set_input(fy, tm([shifted, fb])).get_output()
    pred = BCMS.with_train_validation_split(models_and_parameters=[
        (LR(max_iter=15, **kw), [dict(reg_param=0.01)])]) \
        .set_input(fy, checked).get_output()
    return ds, pred


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    cols = _values()
    jds, jpred = _flow(JFB, JU, j_tm, JSC, JBCMS, JLR, JDataset, JT,
                       JShifted, {}, cols)
    jmodel = JWorkflow().set_input_dataset(jds).set_result_features(jpred) \
        .train()
    pds, ppred = _flow(PFB, PU, p_tm, PSC, PBCMS, PLR, PDataset, PT,
                       PShifted, {"device": "cpu"}, cols)
    pmodel = PWorkflow(device="cpu").set_input_dataset(pds) \
        .set_result_features(ppred).train()
    root = tmp_path_factory.mktemp("user_stage")
    jpath, ppath = str(root / "jax"), str(root / "port")
    jmodel.save(jpath)
    pmodel.save(ppath)
    return dict(jds=jds, jpred=jpred, jmodel=jmodel, jpath=jpath, pds=pds,
                ppred=ppred, pmodel=pmodel, ppath=ppath)


def _scores(model, ds, pred):
    return np.asarray(model.score(ds).data(pred.name), np.float64)


def test_unregistered_user_stage_raises_naming_it(saved):
    with pytest.raises(NotImplementedError, match="ShiftedScale") as err:
        PWM.load(saved["jpath"], device="cpu")
    assert "register_stage" in str(err.value)
    with pytest.raises(NotImplementedError, match="NoSuchStage"):
        PR.resolve_stage_class("NoSuchStage")


def test_jax_save_loads_in_port_once_registered(saved):
    assert PR.register_stage(PShifted) is PShifted
    assert PR.resolve_stage_class("ShiftedScale") is PShifted
    loaded = PWM.load(saved["jpath"], device="cpu")
    st = next(s for s in loaded.stages if type(s) is PShifted)
    assert st.get_param("shift") == 0.25
    got = _scores(loaded, saved["pds"], saved["jpred"])
    want = _scores(saved["jmodel"], saved["jds"], saved["jpred"])
    assert got.shape == (N, 5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_port_save_loads_in_jax_once_registered(saved):
    JR.register_stage(JShifted)
    loaded = j_load(saved["ppath"])
    got = _scores(loaded, saved["jds"], saved["ppred"])
    want = _scores(saved["pmodel"], saved["pds"], saved["ppred"])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # and in the port itself
    PR.register_stage(PShifted)
    again = _scores(PWM.load(saved["ppath"], device="cpu"), saved["pds"],
                    saved["ppred"])
    np.testing.assert_array_equal(again, want)


def test_register_module_scans_a_users_module(saved, tmp_path, monkeypatch):
    (tmp_path / "user_stages_mod.py").write_text(
        "import sys\n"
        "ShiftedScale = sys.modules['test_torch_registry'].PShifted\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setitem(sys.modules, "test_torch_registry",
                        sys.modules[__name__])
    with pytest.raises(NotImplementedError):
        PR.resolve_stage_class("ShiftedScale")
    PR.register_module("user_stages_mod")
    PR.register_module("user_stages_mod")   # idempotent
    assert PR._STAGE_MODULES.count("user_stages_mod") == 1
    assert PR.resolve_stage_class("ShiftedScale") is PShifted
    got = _scores(PWM.load(saved["jpath"], device="cpu"), saved["pds"],
                  saved["jpred"])
    np.testing.assert_allclose(
        got, _scores(saved["jmodel"], saved["jds"], saved["jpred"]),
        atol=1e-6, rtol=0)
