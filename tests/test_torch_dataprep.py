"""The data-prep flows of the port against the JAX package.

- Both example flows (JoinsAndAggregates and ConditionalAggregation: the
  JAX package's examples/op_dataprep.py and the port's
  transmogrifai_tpu_torch/examples/op_dataprep.py) on seeded CSVs written
  to tmp_path, with events on the cutoff and on the window edges: the
  scored datasets identical (keys, row order, values, nulls).
- The events flow (chip_smoke.events_workflow: an event log through the
  aggregate and joined readers, RawFeatureFilter with a score reader,
  transmogrify, a SanityChecker that removes what it flags, and a
  logistic-regression selector) at 1 500 users: the same blacklist and
  filter results, the matrix and its metadata bit-identical, the nulled
  features' columns removed as constants, the same winner, CV cells within
  5e-3, scores of the score snapshot within 1e-5; the JAX-fitted workflow
  carried across (`convert.workflow_model_from_jax`, with its blacklist
  and filter results) scores within 1e-5 too. Removing the ~520 flagged
  columns (mostly empty hash bins) keeps the JAX package's logistic
  regression small: over all 595 columns its CPU fit slows some 40-fold
  when other processes hold the cores.
"""
import csv
import os
import sys
from datetime import datetime, timedelta, timezone

import numpy as np
import pytest

from torch_threads import one_torch_thread  # noqa: F401
import chip_smoke as CS

from transmogrifai_tpu import readers as JR
from transmogrifai_tpu.automl.preparators import SanityChecker as JSC
from transmogrifai_tpu.automl.selectors import \
    BinaryClassificationModelSelector as JBCMS
from transmogrifai_tpu.automl.transmogrifier import (
    TransmogrifierDefaults as JDefaults, transmogrify as j_tm)
from transmogrifai_tpu.features.builder import FeatureBuilder as JFB
from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
from transmogrifai_tpu.utils import uid as JU
from transmogrifai_tpu.workflow import Workflow as JWorkflow

from transmogrifai_tpu_torch import convert
from transmogrifai_tpu_torch import readers as PR
from transmogrifai_tpu_torch.automl.preparators import SanityChecker as PSC
from transmogrifai_tpu_torch.automl.selectors import \
    BinaryClassificationModelSelector as PBCMS
from transmogrifai_tpu_torch.automl.transmogrifier import (
    TransmogrifierDefaults as PDefaults, transmogrify as p_tm)
from transmogrifai_tpu_torch.examples import op_dataprep as P_EX
from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
from transmogrifai_tpu_torch.filters import RawFeatureFilter as PRFF
from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
from transmogrifai_tpu_torch.utils import uid as PU
from transmogrifai_tpu_torch.workflow import Workflow as PWorkflow

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "examples"))
import op_dataprep as J_EX  # noqa: E402

CUTOFF = datetime(2017, 9, 4, tzinfo=timezone.utc)


def _ts(dt):
    return dt.strftime("%Y-%m-%d::%H:%M:%S")


def _write(path, rows):
    with open(path, "w", newline="") as fh:
        csv.writer(fh).writerows(rows)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """Seeded Clicks, Sends and WebVisits files (headerless, the reference
    layouts); a fifth of the times sit exactly on the cutoff or on a 1- or
    7-day edge."""
    d = tmp_path_factory.mktemp("dataprep")
    rng = np.random.default_rng(17)
    edges = [timedelta(0), timedelta(days=-1), timedelta(days=1),
             timedelta(days=-7), timedelta(days=7)]

    def when(i):
        if i % 5 == 0:
            return CUTOFF + edges[(i // 5) % len(edges)]
        return CUTOFF + timedelta(minutes=int(rng.integers(-12000, 4000)))

    users = [str(100 + k) for k in range(30)]
    clicks = [[i, str(rng.choice(users[:24])), int(rng.integers(1, 9)),
               _ts(when(i))] for i in range(300)]
    sends = [[i, str(rng.choice(users[4:])), int(rng.integers(1, 9)),
              _ts(when(i))] for i in range(400)]
    emails = [f"u{k}@example.com" for k in range(25)]
    visits = []
    for i in range(500):
        url = ("http://www.amazon.com/SaveBig" if rng.uniform() < 0.1
               else f"http://www.amazon.com/p{int(rng.integers(0, 9))}")
        bought = rng.uniform() < 0.3
        visits.append([str(rng.choice(emails)), url,
                       f"P{int(rng.integers(0, 50))}" if bought else "",
                       f"{rng.uniform(5, 90):.2f}" if bought else "",
                       _ts(when(i))])
    paths = {name: str(d / f"{name}.csv") for name in
             ("clicks", "sends", "visits")}
    _write(paths["clicks"], clicks)
    _write(paths["sends"], sends)
    _write(paths["visits"], visits)
    return paths


def _rows(ds):
    keys = list(ds.column("key").data)
    names = [n for n in ds.column_names() if n != "key"]
    out = {}
    for i, k in enumerate(keys):
        out[k] = {n: (None if isinstance(v, float) and np.isnan(v) else v)
                  for n in names for v in [ds.column(n).data[i]]}
    return keys, out


def test_joins_and_aggregates_matches_jax(csvs):
    JU.reset_uids()
    PU.reset_uids()
    j = J_EX.joins_and_aggregates(csvs["clicks"], csvs["sends"])
    p = P_EX.joins_and_aggregates(csvs["clicks"], csvs["sends"],
                                  device="cpu")
    assert p.column_names() == j.column_names()
    assert _rows(p) == _rows(j)
    assert len(_rows(p)[0]) == 26       # every sender, in first-seen order


def test_conditional_aggregation_matches_jax(csvs):
    JU.reset_uids()
    PU.reset_uids()
    j = J_EX.conditional_aggregation(csvs["visits"])
    p = P_EX.conditional_aggregation(csvs["visits"], device="cpu")
    assert p.column_names() == j.column_names()
    assert _rows(p) == _rows(j)
    assert 0 < len(_rows(p)[0]) < 25    # keys without the landing page go


JAX = dict(FB=JFB, R=JR, transmogrify=j_tm, Defaults=JDefaults,
           SC=lambda: JSC(remove_bad_features=True), RFF=JRFF,
           Workflow=JWorkflow, BCMS=JBCMS, LR=JLR, U=JU)
PORT = dict(FB=PFB, R=PR, transmogrify=p_tm, Defaults=PDefaults,
            SC=lambda: PSC(remove_bad_features=True), RFF=PRFF,
            Workflow=PWorkflow, BCMS=PBCMS, LR=PLR, U=PU)
LR_GRID = [{"reg_param": 0.001, "elastic_net_param": 0.5},
           {"reg_param": 0.01, "elastic_net_param": 0.1}]


def _build(pkg, log, device):
    pkg["U"].reset_uids()
    selector = pkg["BCMS"].with_cross_validation(
        num_folds=3, seed=42, models_and_parameters=[
            (pkg["LR"](), [dict(g) for g in LR_GRID])])
    return CS.events_workflow(pkg, log, selector, device)


@pytest.fixture(scope="module")
def events():
    log = CS.event_log(1_500, 7)
    out = {}
    for name, pkg, dev in (("jax", JAX, False), ("port", PORT, "cpu")):
        wf, pred, score = _build(pkg, log, dev)
        model = wf.train()
        score_ds = score.generate_dataset(model.raw_features())
        out[name] = dict(model=model, pred=pred, score_ds=score_ds,
                         scored=model.score(score_ds).data(pred.name))
    out["log"] = log
    return out


def test_events_blacklist_and_filter_results(events):
    j, p = events["jax"]["model"], events["port"]["model"]
    assert p.blacklist == j.blacklist
    assert sorted(p.blacklist) == sorted(CS.EVENTS_DROPS)
    pj, jj = p.rff_results.to_json(), j.rff_results.to_json()
    assert pj["dropped_features"] == jj["dropped_features"]
    assert pj["dropped_map_keys"] == jj["dropped_map_keys"]
    for a, b in zip(pj["exclusion_reasons"], jj["exclusion_reasons"]):
        assert {k: v for k, v in a.items() if k != "js_divergence"} == \
            {k: v for k, v in b.items() if k != "js_divergence"}
        assert a["js_divergence"] == pytest.approx(b["js_divergence"],
                                                   rel=1e-5, abs=1e-12)
    assert p.summary()["blacklisted_features"] == p.blacklist
    assert "RawFeatureFilter excluded" in p.summary_pretty()


def test_events_matrix_winner_and_scores(events):
    j, p = events["jax"], events["port"]
    vec, _ = CS.vector_names(p["model"])
    a = j["model"]._train_data.column(vec)
    b = p["model"]._train_data.column(vec)
    assert b.data.shape == a.data.shape and b.data.shape[1] > 500
    assert b.data.tobytes() == a.data.tobytes()
    assert b.metadata.to_json() == a.metadata.to_json()
    jsc = j["model"].sanity_checker_summary()
    psc = p["model"].sanity_checker_summary()
    assert psc.dropped == jsc.dropped
    assert set(CS.EVENTS_DROPS) <= set(psc.dropped)     # nulled: constant
    js, ps = j["model"].selector_summary(), p["model"].selector_summary()
    assert (ps.best_model_name, ps.best_grid) == (js.best_model_name,
                                                  js.best_grid)
    for x, y in zip(js.validation_results, ps.validation_results):
        assert abs(x["mean_metric"] - y["mean_metric"]) < 5e-3
    assert p["scored"].shape == j["scored"].shape == (1_500, 5)
    np.testing.assert_allclose(p["scored"], j["scored"], rtol=0, atol=1e-5)


def test_events_jax_fitted_workflow_carried_across(events):
    j = events["jax"]
    _, pred, _ = _build(PORT, events["log"], "cpu")
    carried = convert.workflow_model_from_jax(
        [pred], [convert.stage_state(st) for st in j["model"].stages],
        device="cpu", blacklist=j["model"].blacklist,
        rff_results=j["model"].rff_results.to_json())
    assert carried.blacklist == j["model"].blacklist
    assert carried.rff_results.to_json()["dropped_features"] == \
        j["model"].rff_results.dropped_features
    scored = carried.score(events["port"]["score_ds"]).data(pred.name)
    np.testing.assert_allclose(scored, j["scored"], rtol=0, atol=1e-5)
