"""The port's SanityChecker against the JAX package's.

Both packages transmogrify the same seeded records and fit the checker
with `remove_bad_features` on. Tolerances: the same kept indices and the
same removal reasons (the reason texts agree with their numbers rounded
to 4 significant digits; the numbers themselves are statistics); the
summary statistics within the stats engine's tolerance, rtol 1e-5 /
atol 1e-6. The data keeps every statistic a decision reads clear of its
threshold, and the test asserts that margin, so the decisions cannot flip
on f32 rounding. The binary label takes the categorical path
(contingency tables, Cramer's V, rule confidences); a continuous label and
Spearman correlations are covered too.
"""
import re

import numpy as np
import pytest

from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.transmogrifier import transmogrify as j_tm
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.readers.readers import ListReader as JList
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify as p_tm
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.readers.readers import ListReader as PList
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

RTOL, ATOL = 1e-5, 1e-6
MARGIN = 0.02
FEATURES = [("signal", "Real"), ("leak", "Real"), ("noise", "Real"),
            ("flat", "Real"), ("count", "Integral"), ("flag", "Binary"),
            ("echo", "PickList"), ("color", "PickList"),
            ("tags", "MultiPickList")]


def records(n=4000, seed=0, continuous=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.normal()
        y = s + rng.normal() if continuous else \
            float(rng.uniform() < 1 / (1 + np.exp(-1.5 * s)))
        m = rng.uniform(size=4) < 0.1
        out.append({
            "label": float(y),
            "signal": None if m[0] else s,
            "leak": float(y) + 0.01 * rng.normal(),
            "noise": None if m[1] else float(rng.normal()),
            "flat": 3.0,
            "count": None if m[2] else int(rng.poisson(2.0)),
            "flag": bool(rng.uniform() < 0.4),
            "echo": ("yes" if y > 0.5 else "no") if not continuous
            else str(rng.choice(["p", "q"])),
            "color": None if m[3] else str(rng.choice(["red", "green",
                                                       "blue"])),
            "tags": {t for t in ("a", "b", "c") if rng.uniform() < 0.4},
        })
    return out


def fit(FB, U, tm, SC, Workflow, list_reader, recs, **params):
    U.reset_uids()
    label = FB.RealNN("label").as_response()
    feats = [getattr(FB, t)(n).as_predictor() for n, t in FEATURES]
    checked = SC(remove_bad_features=True, **params) \
        .set_input(label, tm(feats)).get_output()
    wf = Workflow() if Workflow is JWorkflow else Workflow(device="cpu")
    model = wf.set_reader(list_reader(recs)).set_result_features(checked) \
        .train()
    return model.stages[-1], model.sanity_checker_summary()


def both(continuous=False, **params):
    recs = records(continuous=continuous)
    return (fit(JFB, JU, j_tm, JSC, JWorkflow, JList, recs, **params),
            fit(PFB, PU, p_tm, PSC, PWorkflow, PList, recs, **params))


def _round(text):
    return re.sub(r"-?\d+\.\d+(e-?\d+)?",
                  lambda m: f"{float(m.group()):.4g}", text)


def assert_margins(summary, continuous):
    """Every statistic a decision reads is clear of its threshold."""
    for st in summary.column_stats[1:]:
        assert abs(st["variance"] - 1e-5) > 1e-6 or st["variance"] == 0.0
        c = st["corr_label"]
        if c is not None:
            assert abs(abs(c) - 0.95) > MARGIN, st
        for key in ("cramers_v", "parent_cramers_v"):
            if st[key] is not None:
                assert abs(st[key] - 0.95) > MARGIN, st
        if st["parent_corr"] is not None:
            assert abs(st["parent_corr"] - 0.95) > MARGIN, st
    for g in summary.categorical_stats:
        for conf in g["max_rule_confidences"]:
            assert conf < 1.0 - 1e-3 or conf == 1.0


@pytest.mark.parametrize("continuous,corr_type", [
    (False, "pearson"), (True, "pearson"), (False, "spearman")])
def test_same_columns_kept_for_the_same_reasons(continuous, corr_type):
    (jm, js), (pm, ps) = both(continuous, correlation_type=corr_type)
    assert_margins(js, continuous)
    assert pm.indices_to_keep == jm.indices_to_keep
    assert 0 < len(pm.indices_to_keep) < len(js.names)
    assert ps.names == js.names and ps.dropped == js.dropped
    assert ps.dropped_parents == js.dropped_parents
    assert sorted(ps.drop_reasons) == sorted(js.drop_reasons)
    for name, reasons in js.drop_reasons.items():
        assert [_round(r) for r in ps.drop_reasons[name]] == \
            [_round(r) for r in reasons]
    assert pm.metadata.to_json() == jm.metadata.to_json()
    # the leak and the constant column go, the signal stays
    assert any(n.startswith("leak") for n in ps.dropped)
    assert any(n.startswith("flat") for n in ps.dropped)
    assert not any(n.startswith("signal") and "Null" not in n
                   for n in ps.dropped)


@pytest.mark.parametrize("continuous", [False, True])
def test_summary_statistics_within_tolerance(continuous):
    (_, js), (_, ps) = both(continuous)
    assert ps.sample_fraction == js.sample_fraction
    assert ps.label_distribution == js.label_distribution
    for a, b in zip(js.column_stats, ps.column_stats):
        assert a["name"] == b["name"]
        for k in ("count", "mean", "min", "max", "variance", "corr_label",
                  "cramers_v", "parent_corr", "parent_cramers_v"):
            if a[k] is None:
                assert b[k] is None, (a["name"], k)
            else:
                np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{a['name']} {k}")
    if not continuous:
        np.testing.assert_allclose(ps.correlations_matrix,
                                   js.correlations_matrix,
                                   rtol=RTOL, atol=ATOL)


def test_categorical_label_contingency():
    (_, js), (_, ps) = both()
    assert js.categorical_stats and \
        len(ps.categorical_stats) == len(js.categorical_stats)
    for a, b in zip(js.categorical_stats, ps.categorical_stats):
        assert a["group"] == b["group"]
        assert a["categorical_features"] == b["categorical_features"]
        np.testing.assert_array_equal(b["contingency_matrix"],
                                      a["contingency_matrix"])
        for k in ("cramers_v", "chi2", "mutual_info"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-9)
        np.testing.assert_allclose(b["max_rule_confidences"],
                                   a["max_rule_confidences"], rtol=1e-9)
    echo = next(g for g in ps.categorical_stats if g["group"] == "echo_echo")
    assert echo["cramers_v"] > 0.95 + MARGIN


def test_sampling_draw_matches():
    """check_sample below 1 draws the same rows in both packages."""
    (jm, js), (pm, ps) = both(check_sample=0.5, sample_lower_limit=100)
    assert ps.sample_fraction == js.sample_fraction == 0.5
    assert [s["count"] for s in ps.column_stats] == \
        [s["count"] for s in js.column_stats]
    assert pm.indices_to_keep == jm.indices_to_keep


def test_model_row_level_matches_columnar():
    (_, _), (pm, _) = both()
    vec = np.random.default_rng(1).normal(
        size=(5, len(pm.summary.names))).astype(np.float32)
    from transmogrifai_tpu_torch.data.dataset import Column
    from transmogrifai_tpu_torch.types import OPVector, RealNN
    cols = [Column("float", np.zeros(5)), Column("vector", vec)]
    got = pm.transform_columns(*cols).data
    np.testing.assert_array_equal(got, vec[:, pm.indices_to_keep])
    for i in range(5):
        row = pm.transform_value(RealNN(0.0), OPVector(vec[i])).value
        np.testing.assert_array_equal(row, got[i])
