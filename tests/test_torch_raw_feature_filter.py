"""The port's RawFeatureFilter, its sketches and histograms against the JAX
package.

Same seeded datasets in both packages (the port on the CPU). Tolerances:
histograms, counts, nulls, ranges, fill rates, exclusion flags, drops and
dropped map keys identical; the summaries' sums and the JS divergences
within rtol 1e-5 (the port's statistics engine merges in float64, the JAX
package's in float32). `histogram_batched` and the engine's in-pass
histograms (fused and streamed routes) give identical bins at bin edges,
on a constant column, an all-NaN column and +/-inf.
"""
import json

import numpy as np
import pytest
import torch

import transmogrifai_tpu.types as JT
from transmogrifai_tpu.data.dataset import Dataset as JDataset
from transmogrifai_tpu.filters import RawFeatureFilter as JRFF
from transmogrifai_tpu.filters import compute_distributions as j_dists
from transmogrifai_tpu.ops import stats_engine as JSE
from transmogrifai_tpu.ops.stats import histogram_batched as j_hist

import transmogrifai_tpu_torch.types as PT
from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.data.dataset import Dataset as PDataset
from transmogrifai_tpu_torch.filters import (RawFeatureFilter as PRFF,
                                             RawFeatureFilterResults)
from transmogrifai_tpu_torch.filters import compute_distributions as p_dists
from transmogrifai_tpu_torch.ops import stats_engine as PSE
from transmogrifai_tpu_torch.ops.stats import histogram_batched as p_hist


class _F:
    """Raw-feature stand-in (name + is_response)."""

    def __init__(self, name, is_response=False):
        self.name = name
        self.is_response = is_response


def _datasets(spec):
    """spec: {name: (type name, values)} -> (port, JAX) datasets."""
    return tuple(D.from_features([(n, getattr(T, t), v)
                                  for n, (t, v) in spec.items()])
                 for D, T in ((PDataset, PT), (JDataset, JT)))


def _mixed(n, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(shift, 1, n)
    lo, hi = -2.0, 2.0
    x[:20] = lo + (hi - lo) * np.arange(20) / 20     # bin edges of 20 bins
    x[20:25] = np.nan
    inf = rng.normal(size=n)
    inf[:3] = [np.inf, -np.inf, np.inf]
    label = (rng.uniform(size=n) < 0.4).astype(float)
    cat = rng.choice(["a", "b", "c", "d"], size=n)
    return {
        "x": ("Real", [None if np.isnan(v) else float(v) for v in x]),
        "withInf": ("Real", [float(v) for v in inf]),
        "const": ("Real", [2.5] * n),
        "allNaN": ("Real", [None] * n),
        "cnt": ("Integral", [int(v) for v in rng.integers(0, 9, n)]),
        "flag": ("Binary", [bool(v) for v in rng.uniform(size=n) < 0.3]),
        "cat": ("PickList", [None if i % 11 == 0 else str(c)
                             for i, c in enumerate(cat)]),
        "txt": ("Text", [f"w{int(v)} z" for v in rng.integers(0, 50, n)]),
        "tags": ("MultiPickList", [set(rng.choice(list("pqr"),
                                                  size=i % 3))
                                   for i in range(n)]),
        "words": ("TextList", [["a", str(i % 5)] for i in range(n)]),
        "tm": ("TextMap", [{"k1": "v", "k2": str(i % 3)} if i % 4
                           else {"k3": "rare"} if i < 8 else {}
                           for i in range(n)]),
        "rm": ("RealMap", [{"a": float(i % 7), "b": 0.5} if i % 2 else {}
                           for i in range(n)]),
        "geo": ("Geolocation", [[1.0, float(i % 9), 1.0] if i % 3 else None
                                for i in range(n)]),
        "label": ("RealNN", [float(v) for v in label]),
    }


def _close(a, b, rtol=1e-5):
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return a == b or abs(a - b) <= rtol * max(abs(a), abs(b))


def assert_same_distributions(pd, jd):
    assert [(d.name, d.key) for d in pd] == [(d.name, d.key) for d in jd]
    for p, j in zip(pd, jd):
        assert (p.count, p.nulls) == (j.count, j.nulls), p.name
        assert p.distribution == j.distribution, p.name
        assert len(p.summary) == len(j.summary) == 4
        assert [p.summary[i] for i in (0, 1, 3)] == \
            [j.summary[i] for i in (0, 1, 3)], p.name
        assert _close(p.summary[2], j.summary[2]), (p.name, p.summary,
                                                    j.summary)


def assert_same_results(pr, jr):
    """Two RawFeatureFilterResults (or their JSON): identical but for the
    sums and JS divergences, held to rtol 1e-5."""
    p = pr if isinstance(pr, dict) else pr.to_json()
    j = jr if isinstance(jr, dict) else jr.to_json()
    assert p["config"] == j["config"]
    assert p["dropped_features"] == j["dropped_features"]
    assert p["dropped_map_keys"] == j["dropped_map_keys"]
    for side in ("train_distributions", "score_distributions"):
        assert len(p[side]) == len(j[side])
        for a, b in zip(p[side], j[side]):
            assert {k: v for k, v in a.items() if k != "summary"} == \
                {k: v for k, v in b.items() if k != "summary"}
            assert [a["summary"][i] for i in (0, 1, 3)] == \
                [b["summary"][i] for i in (0, 1, 3)]
            assert _close(a["summary"][2], b["summary"][2])
    assert len(p["exclusion_reasons"]) == len(j["exclusion_reasons"])
    for a, b in zip(p["exclusion_reasons"], j["exclusion_reasons"]):
        assert a.keys() == b.keys()
        for k in a:
            if k == "js_divergence":
                assert _close(a[k], b[k]), (a["name"], a[k], b[k])
            else:
                assert a[k] == b[k], (a["name"], k, a[k], b[k])


@pytest.mark.parametrize("pinned", [False, True])
def test_distributions_match_jax(pinned):
    pds, jds = _datasets(_mixed(600, 0))
    names = [n for n in pds.column_names() if n != "label"]
    ranges = None
    if pinned:    # the score side: ranges from a train-side summary
        train = p_dists(pds, names, 20, device="cpu")
        ranges = {d.name: (d.summary[0], d.summary[1]) for d in train
                  if d.key is None and d.summary[3] > 0}
    pd = p_dists(pds, names, 20, ranges=ranges, device="cpu")
    jd = j_dists(jds, names, 20, ranges=ranges)
    assert_same_distributions(pd, jd)
    assert {d.name for d in pd if d.key is not None} == {"tm", "rm"}


def _apply_both(train_spec, score_spec, feats, **kw):
    p_train, j_train = _datasets(train_spec)
    p_score, j_score = _datasets(score_spec) if score_spec else (None, None)
    p = PRFF(device="cpu", **kw).apply(p_train, feats, score_ds=p_score)
    j = JRFF(**kw).apply(j_train, feats, score_ds=j_score)
    assert_same_results(p.results, j.results)
    assert p.dropped == j.dropped
    assert p.dropped_map_keys == j.dropped_map_keys
    for name in p.cleaned.column_names():
        a, b = p.cleaned.data(name), j.cleaned.data(name)
        assert p.cleaned.column(name).kind == j.cleaned.column(name).kind
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b)
        else:
            assert list(a) == list(b), name
    return p


def test_every_exclusion_reason_matches_jax():
    """Low fill rate, fill-rate difference, fill-ratio difference, JS
    divergence, null-label leakage and dropped map keys, on one train and
    score pair; a protected feature stays."""
    n = 800
    rng = np.random.default_rng(7)
    label = (rng.uniform(size=n) < 0.5).astype(float)
    train = _mixed(n, 1)
    score = _mixed(n, 2)
    train.pop("label")
    score.pop("label")
    train.update(
        sparse=("Real", [1.0] * 3 + [None] * (n - 3)),
        flaky=("Real", [1.0] * n),
        ratio=("Real", [1.0 if i % 10 == 0 else None for i in range(n)]),
        drifted=("Real", [float(v) for v in rng.normal(0, 1, n)]),
        leaky=("Real", [None if v > 0 else 1.0 for v in label]),
        protected=("Real", [1.0] + [None] * (n - 1)),
        label=("RealNN", [float(v) for v in label]))
    score.update(
        sparse=("Real", [1.0] * 3 + [None] * (n - 3)),
        flaky=("Real", [1.0] * 10 + [None] * (n - 10)),
        ratio=("Real", [1.0 if i % 400 == 0 else None for i in range(n)]),
        drifted=("Real", [float(v) for v in rng.normal(30, 1, n)]),
        leaky=("Real", [1.0] * n), protected=("Real", [None] * n))
    feats = [_F(k) for k in train if k != "label"] + [_F("label", True)]
    res = _apply_both(train, score, feats, min_fill_rate=0.01,
                      max_fill_difference=0.5, max_fill_ratio_diff=5.0,
                      max_js_divergence=0.5, max_correlation=0.9,
                      protected_features=["protected"])
    reasons = {r.name: r for r in res.results.exclusion_reasons
               if r.key is None}
    assert reasons["sparse"].low_fill_rate
    assert reasons["flaky"].high_fill_rate_diff
    assert reasons["ratio"].high_fill_ratio_diff
    assert reasons["drifted"].high_js_divergence
    assert reasons["leaky"].null_leakage
    assert reasons["protected"].excluded
    for name in ("sparse", "flaky", "ratio", "drifted", "leaky", "allNaN"):
        assert name in res.dropped
    assert "protected" not in res.dropped and "x" not in res.dropped
    assert res.dropped_map_keys == {"tm": ["k3"]}
    assert np.isnan(res.cleaned.data("drifted")).all()
    assert all("k3" not in v for v in res.cleaned.data("tm") if v)


def test_train_only_and_results_json_round_trip():
    spec = _mixed(300, 4)
    feats = [_F(k) for k in spec if k != "label"] + [_F("label", True)]
    res = _apply_both(spec, None, feats, bins=16)
    j = json.loads(json.dumps(res.results.to_json()))
    back = RawFeatureFilterResults.from_json(j)
    assert json.dumps(back.to_json()) == json.dumps(res.results.to_json())
    assert_same_results(back, res.results)


def _edge_matrix():
    """[n, 6] f32: values on every bin edge of [-1, 1] in 10 bins, a
    constant column (span 0), an all-NaN column, +/-inf, and NaNs."""
    edges = (-1.0 + 2.0 * np.arange(11) / 10).astype(np.float32)
    n = 64
    rng = np.random.default_rng(11)
    V = rng.uniform(-1.5, 1.5, size=(n, 6)).astype(np.float32)
    V[:11, 0] = edges
    V[:11, 1] = np.nextafter(edges, np.float32(2))
    V[:, 2] = 0.25
    V[:, 3] = np.nan
    V[:4, 4] = [np.inf, -np.inf, np.nan, 1.0]
    V[5:9, 5] = np.nan
    lo = np.array([-1, -1, 0.25, 0, -1, -1], np.float32)
    hi = np.array([1, 1, 0.25, 1, 1, 0.5], np.float32)
    return V, lo, hi


def test_histogram_batched_bin_edges_and_inf():
    V, lo, hi = _edge_matrix()
    for bins in (10, 7):
        got = p_hist(torch.from_numpy(V), torch.from_numpy(lo),
                     torch.from_numpy(hi), bins)
        want = np.asarray(j_hist(V, lo, hi, bins), np.float64)
        np.testing.assert_array_equal(got.numpy(), want)
        w = np.linspace(0.5, 2.0, len(V)).astype(np.float32)
        got_w = p_hist(torch.from_numpy(V), torch.from_numpy(lo),
                       torch.from_numpy(hi), bins, w=torch.from_numpy(w))
        want_w = np.asarray(j_hist(V, lo, hi, bins, w=w), np.float64)
        np.testing.assert_allclose(got_w.numpy(), want_w, rtol=1e-6)
    got = p_hist(torch.from_numpy(V), torch.from_numpy(lo),
                 torch.from_numpy(hi), 10).numpy()
    assert got[4, 9] >= 1 and got[4, 0] >= 1      # +inf top, -inf bottom
    assert got[3, 10] == len(V)                   # all NaN: missing
    assert got[2, 0] == len(V)                    # span 0: the first bin


@pytest.mark.parametrize("driver", ["fused", "streamed"])
def test_engine_in_pass_histograms(driver):
    """run_stats' in-pass histograms treat non-finite as missing; the
    streamed route merges per-tile histograms."""
    V, lo, hi = _edge_matrix()
    y = np.zeros(len(V), np.float32)
    st = PSE.run_stats(V, y, lo=lo, hi=hi, bins=10, driver=driver,
                       tile_rows=16 if driver == "streamed" else None,
                       device="cpu")
    want = JSE.run_stats(V, y, lo=lo, hi=hi, bins=10).hist
    np.testing.assert_array_equal(st.hist, want)
    assert st.hist.shape == (6, 11)
    assert st.hist[4, 10] == 3                     # inf, -inf, NaN missing
    with pytest.raises(ValueError, match="bins>0"):
        PSE.run_stats(V, y, lo=lo, hi=hi, device="cpu")
