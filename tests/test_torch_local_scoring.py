"""The port's row protocol and local scoring (local/scoring.py,
`transform_keyvalue`) against the JAX package's, on the CPU.

The model is tests/torch_serving_flow.py's: a flow trained in the JAX
package (Reals with missing values, a PickList, a Text; one selector over
logistic regression and one over a random forest), saved, and loaded from
that directory into both packages. Tolerances: the two loads' batch scores
within 2.3e-5 (ROADMAP: cross-package loads); `score_function` records
within 1e-5 of the JAX package's and of the port's own `score()`, with the
same predictions; the typed errors (UnknownFeatureError,
MissingFeatureError, InvalidFeatureError) equal in class and message; each
fitted stage's `transform_keyvalue` equal to its column `transform` row by
row (vectors within 1e-6, predictions within 1e-5). The local path replays
on the CPU by name: a model loaded for the card scores records through it
on a machine without one, while its batch path still asks for CUDA.
"""
import numpy as np
import pytest
import torch

import torch_serving_flow as F
from transmogrifai_tpu.features.generator import \
    FeatureGeneratorStage as JGen
from transmogrifai_tpu.local import scoring as JS
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.types import Real as JReal

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.features.generator import \
    FeatureGeneratorStage as PGen
from transmogrifai_tpu_torch.local import scoring as PS
from transmogrifai_tpu_torch.models.prediction import row_prediction
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.types import ColumnKind
from transmogrifai_tpu_torch.types import Real as PReal
from transmogrifai_tpu_torch.workflow.workflow import WorkflowModel as PWM


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    path = F.flow_dir(tmp_path_factory)
    j, p = F.load_both(path)
    return dict(path=path, jax=j, port=p, records=F.records(60, seed=12))


def _batch(model, List, records):
    ds = List(records).generate_dataset(
        [f for f in model.raw_features() if not f.is_response])
    return model.score(ds)


def test_cross_package_loads_agree(both):
    j, p, recs = both["jax"], both["port"], both["records"]
    js, ps = _batch(j, JList, recs), _batch(p, PList, recs)
    for f in j.result_features:
        assert np.abs(np.asarray(js.data(f.name))
                      - ps.data(f.name)).max() <= 2.3e-5, f.name


def test_score_function_matches_jax_and_batch(both):
    j, p, recs = both["jax"], both["port"], both["records"]
    jf, pf = j.score_function(), p.score_function()
    batch = _batch(p, PList, recs)
    names = [f.name for f in p.result_features]
    for i, rec in enumerate(recs):
        jo, po = jf(rec), pf(rec)
        assert set(po) == set(jo) == set(names)
        for name in names:
            jv = jo[name].value if hasattr(jo[name], "value") else jo[name]
            pv = po[name]
            assert set(pv) == set(jv)
            assert pv["prediction"] == jv["prediction"]
            for k in pv:
                assert abs(pv[k] - jv[k]) <= 1e-5, (i, name, k)
            want = row_prediction(batch.column(name), i).value
            assert pv["prediction"] == want["prediction"]
            assert max(abs(pv[k] - want[k]) for k in want) <= 1e-5


def _typed_error(fn, *args):
    try:
        fn(*args)
    except (PS.UnknownFeatureError, PS.MissingFeatureError,
            PS.InvalidFeatureError, JS.UnknownFeatureError,
            JS.MissingFeatureError, JS.InvalidFeatureError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("record", [
    {"a": 1.0, "bogus": 2.0},                       # unknown key
    {"a": "not-a-number", "b": 0.5},                # the type rejects it
    {"b": [1, 2]},                                  # the type rejects it
    [1, 2, 3],                                      # not a record
    {"a": 0.3, "b": None, "c": "x", "t": "alpha"},  # valid: no error
])
def test_typed_errors_match_jax(both, record):
    j, p = both["jax"], both["port"]
    got = _typed_error(PS.record_validator(p), record)
    assert got == _typed_error(JS.record_validator(j), record)
    if isinstance(record, dict) and "bogus" not in record:
        # the per-record replay raises the same typed error, or scores
        assert _typed_error(p.score_function(), record) == \
            _typed_error(j.score_function(), record)


def test_missing_key_error_matches_jax():
    """An extract function that indexes the record names the feature in a
    MissingFeatureError (a KeyError) in both packages."""
    def hard(r):
        return r["a"]
    jg, pg = JGen("a", JReal, hard), PGen("a", PReal, hard)
    got = _typed_error(PS._extract, pg, {"b": 1.0})
    assert got == _typed_error(JS._extract, jg, {"b": 1.0})
    assert got[0] == "MissingFeatureError" and "'a'" in got[1]
    assert issubclass(PS.MissingFeatureError, KeyError)


def _cell(col, i):
    """A column cell as the value a row dict carries."""
    v = col.data[i]
    if col.kind == ColumnKind.VECTOR:
        return np.asarray(v)
    if col.kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
        return None if np.isnan(float(v)) else float(v)
    return v


def test_transform_keyvalue_matches_column_transform(both):
    p, recs = both["port"], both["records"]
    ds = PList(recs).generate_dataset(
        [f for f in p.raw_features() if not f.is_response])
    full = p.transform(ds)
    for st in p.stages:
        out = full.column(st.output_name())
        for i in (0, 3, 17, 41):
            row = {n: _cell(full.column(n), i) for n in st.input_names()
                   if n in full}
            got = st.transform_keyvalue(row)
            if out.kind == ColumnKind.VECTOR and out.metadata is not None \
                    and isinstance(got, dict):
                want = row_prediction(out, i).value
                assert set(got) == set(want)
                assert max(abs(got[k] - want[k]) for k in want) <= 1e-5
            elif out.kind == ColumnKind.VECTOR:
                assert np.abs(np.asarray(got, np.float64)
                              - out.data[i]).max() <= 1e-6, st.stage_name
            else:
                assert got == _cell(out, i), st.stage_name


def test_local_path_replays_on_cpu(both):
    """A model loaded for the card (device None) scores records through
    `score_function` here, where there is no card: the local path replays
    on CPU copies of the fitted stages, by name. The model's own stages
    keep their device, so its batch path still asks for CUDA and raises."""
    p_card = PWM.load(both["path"])
    fn, host = p_card.score_function(), both["port"].score_function()
    for rec in both["records"][:5]:
        a, b = fn(rec), host(rec)
        assert a == b
    stages = [st for layer in p_card.dag.layers for st in layer]
    assert all(st.device is None for st in stages)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _batch(p_card, PList, both["records"][:2])
