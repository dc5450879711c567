"""transmogrify() in the port against the JAX package.

Both packages get the same seeded records and build the same features with
their uid counters reset, so vector and column names agree too. Tolerance:
none — both vectorize on the host in numpy float32, so the transmogrified
matrix is bit-identical and the vector metadata identical, for every
ported type group, with null tracking on and off, on the train path
(fit + columnar transform) and the score path (combiner sinks). Groups the
port has no vectorizer for raise NotImplementedError.
"""
import numpy as np
import pytest

from transmogrifai_tpu.automl.transmogrifier import (
    TransmogrifierDefaults as JDefaults, transmogrify as j_transmogrify)
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from transmogrifai_tpu_torch.automl.transmogrifier import (
    TransmogrifierDefaults as PDefaults, transmogrify as p_transmogrify)
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

GROUPS = {
    "real": [("age", "Real"), ("fare", "Currency"), ("pct", "Percent")],
    "integral": [("sibSp", "Integral"), ("parCh", "Integral")],
    "binary": [("alone", "Binary")],
    "realnn": [("score", "RealNN")],
    "categorical": [("sex", "PickList"), ("port", "PickList"),
                    ("cabin", "ComboBox")],
    "multipicklist": [("tags", "MultiPickList")],
}


def records(n=600, seed=0):
    rng = np.random.default_rng(seed)
    cabins = [f"C{i}" for i in range(40)]
    out = []
    for _ in range(n):
        m = rng.uniform(size=10) < 0.12
        out.append({
            "age": None if m[0] else float(rng.normal(30, 12)),
            "fare": None if m[1] else float(rng.lognormal(3, 1)),
            "pct": None if m[2] else float(rng.uniform()),
            "sibSp": None if m[3] else int(rng.poisson(0.7)),
            "parCh": None if m[4] else int(rng.poisson(0.4)),
            "alone": None if m[5] else bool(rng.uniform() < 0.6),
            "score": float(rng.normal()),
            "sex": None if m[6] else str(rng.choice(["male", "Female",
                                                     "female!"])),
            "port": None if m[7] else str(rng.choice(
                ["S", "C", "Q", "X"], p=[0.6, 0.25, 0.13, 0.02])),
            "cabin": None if m[8] else str(rng.choice(cabins)),
            "tags": None if m[9] else {t for t in ("vip", "crew", "Kid", "x")
                                       if rng.uniform() < 0.35},
        })
    return out


def make_vector(FB, U, transmogrify, Defaults, groups, track_nulls):
    U.reset_uids()
    feats = [getattr(FB, t)(n).as_predictor()
             for g in groups for n, t in GROUPS[g]]
    return transmogrify(feats, defaults=Defaults(track_nulls=track_nulls))


def fit_both(groups, track_nulls, recs=None):
    recs = recs or records()
    jvec = make_vector(JFB, JU, j_transmogrify, JDefaults, groups, track_nulls)
    pvec = make_vector(PFB, PU, p_transmogrify, PDefaults, groups, track_nulls)
    jm = JWorkflow().set_reader(JList(recs)).set_result_features(jvec).train()
    pm = PWorkflow(device="cpu").set_reader(PList(recs)) \
        .set_result_features(pvec).train()
    return jvec, pvec, jm, pm


CASES = [[g] for g in GROUPS] + [list(GROUPS)]


@pytest.mark.parametrize("track_nulls", [True, False])
@pytest.mark.parametrize("groups", CASES, ids=["+".join(c) for c in CASES])
def test_matrix_and_metadata_identical(groups, track_nulls):
    jvec, pvec, jm, pm = fit_both(groups, track_nulls)
    assert jvec.name == pvec.name
    jc, pc = jm._train_data.column(jvec.name), pm._train_data.column(pvec.name)
    assert jc.data.dtype == pc.data.dtype == np.float32
    assert jc.data.shape == pc.data.shape
    assert jc.data.tobytes() == pc.data.tobytes()          # bit-identical
    assert jc.metadata.to_json() == pc.metadata.to_json()
    # the score path (combiner sinks) gives the train path's matrix
    new = records(200, seed=9)
    js = jm.score(JList(new).generate_dataset(jm.raw_features()))
    ps = pm.score(PList(new).generate_dataset(pm.raw_features()))
    assert js.data(jvec.name).tobytes() == ps.data(pvec.name).tobytes()


@pytest.mark.parametrize("group", ["real", "integral", "categorical",
                                   "multipicklist"])
def test_row_level_matches_columnar(group):
    _, pvec, _, pm = fit_both([group], True)
    st = pm.stages[0]
    ds = pm._train_data
    cols = [ds.column(n) for n in st.input_names()]
    block = st.transform_columns(*cols).data
    types = [f.feature_type for f in st.input_features]
    for i in (0, 5, 17):
        vals = [t(c.data[i] if not (isinstance(c.data[i], float)
                                     and np.isnan(c.data[i])) else None)
                for c, t in zip(cols, types)]
        np.testing.assert_array_equal(st.transform_value(*vals).value,
                                      block[i])


def test_vocabulary_order_and_ties():
    """Top-K keeps count-descending, then value-ascending order; min
    support drops rare values; cleaning merges 'Female' and 'female!'."""
    recs = [{"sex": s} for s in ["b"] * 12 + ["a"] * 12 + ["Female"] * 6
            + ["female!"] * 6 + ["rare"] * 3]
    JU.reset_uids()
    jv = j_transmogrify([JFB.PickList("sex").as_predictor()])
    PU.reset_uids()
    pv = p_transmogrify([PFB.PickList("sex").as_predictor()])
    jm = JWorkflow().set_reader(JList(recs)).set_result_features(jv).train()
    pm = PWorkflow(device="cpu").set_reader(PList(recs)) \
        .set_result_features(pv).train()
    assert pm.stages[0].vocabs == jm.stages[0].vocabs == [["a", "b",
                                                           "female"]]


# Text, TextArea and TextList transmogrify since the text slice
# (tests/test_torch_text.py); these groups are still to be ported
@pytest.mark.parametrize("tname", ["Base64", "DateList", "Email", "URL",
                                   "Phone", "Date", "DateTime", "TextMap",
                                   "Geolocation", "RealMap", "PickListMap"])
def test_unported_groups_raise(tname):
    f = getattr(PFB, tname)("x").as_predictor()
    with pytest.raises(NotImplementedError, match=tname):
        p_transmogrify([PFB.Real("age").as_predictor(), f])
