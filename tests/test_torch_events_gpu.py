"""RawFeatureFilter's histograms and the events flow (chip_smoke.
events_workflow: an event log through the aggregate and joined readers,
RawFeatureFilter, transmogrify, SanityChecker and the selector) on the
card. Every test here needs a CUDA device and skips without one. This file
imports neither jax nor the JAX package, so it also runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_events_gpu.py

Tolerances: histograms, counts, ranges and bin ids on the card identical
to the CPU's (`torch.bincount` of the same f32 bin ids); sums within rtol
1e-5. The events flow at 5 000 users (`chip_smoke.events_leg_run`, the
cut selector) on the card against the CPU: the readers' datasets,
RawFeatureFilter's drops and exclusion reasons, the matrix and the winner
identical, scores within 1e-5 a row or a tie at the first node the refits
split apart (`chip_smoke.runs_agree`).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch import types as T
from transmogrifai_tpu_torch.data.dataset import Dataset
from transmogrifai_tpu_torch.filters import compute_distributions
from transmogrifai_tpu_torch.ops import stats_engine as SE
from transmogrifai_tpu_torch.ops.stats import histogram_batched

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _matrix(n=200_003, k=7, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(n, k)).astype(np.float32)
    V[rng.uniform(size=(n, k)) < 0.1] = np.nan
    V[:3, 1] = [np.inf, -np.inf, np.nan]
    V[:, 2] = 1.5                                    # span 0
    V[:, 3] = np.nan                                 # all missing
    edges = (-2.0 + 4.0 * np.arange(101) / 100).astype(np.float32)
    V[:101, 4] = edges                               # every bin edge
    lo = np.array([-2, -2, 1.5, 0, -2, -1, -np.inf], np.float32)
    hi = np.array([2, 2, 1.5, 1, 2, 1, np.inf], np.float32)
    return V, lo, hi


@pytest.mark.parametrize("bins", [100, 33])
def test_histogram_batched_card_equals_cpu(bins):
    V, lo, hi = _matrix()
    cpu = histogram_batched(torch.from_numpy(V), torch.from_numpy(lo),
                            torch.from_numpy(hi), bins)
    card = histogram_batched(torch.from_numpy(V).cuda(),
                             torch.from_numpy(lo), torch.from_numpy(hi),
                             bins)
    assert torch.equal(card.cpu(), cpu)
    assert float(cpu.sum()) == V.size


@pytest.mark.parametrize("driver", ["fused", "streamed"])
def test_engine_in_pass_histograms_card_equals_cpu(driver):
    V, lo, hi = _matrix()
    y = np.zeros(len(V), np.float32)
    kw = dict(lo=lo, hi=hi, bins=100, driver=driver,
              tile_rows=65_536 if driver == "streamed" else None)
    cpu = SE.run_stats(V, y, device="cpu", **kw)
    card = SE.run_stats(V, y, device="cuda", **kw)
    np.testing.assert_array_equal(card.hist, cpu.hist)
    np.testing.assert_array_equal(card.count, cpu.count)
    np.testing.assert_array_equal(card.min, cpu.min)
    np.testing.assert_array_equal(card.max, cpu.max)


def test_distributions_card_equal_cpu():
    V, _, _ = _matrix(n=50_000)
    ds = Dataset.from_features(
        [(f"c{k}", T.Real, [None if np.isnan(v) else float(v)
                            for v in V[:, k]]) for k in range(V.shape[1])])
    names = ds.column_names()
    for ranges in (None, {"c0": (-1.0, 1.0), "c4": (0.0, 3.0)}):
        cpu = compute_distributions(ds, names, 100, ranges, device="cpu")
        card = compute_distributions(ds, names, 100, ranges, device="cuda")
        for a, b in zip(cpu, card):
            assert (a.name, a.count, a.nulls, a.distribution) == \
                (b.name, b.count, b.nulls, b.distribution)
            assert a.summary[:2] == b.summary[:2]
            np.testing.assert_allclose(b.summary[2:], a.summary[2:],
                                       rtol=1e-5)


@pytest.fixture(scope="module")
def legs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    log = chip_smoke.event_log(chip_smoke.EVENTS_LEG_USERS, 31)
    return {dev: chip_smoke.events_leg_run(log, None if dev == "cuda"
                                           else dev)
            for dev in ("cpu", "cuda")}


def test_events_flow_card_against_cpu(legs):
    cpu, card = legs["cpu"], legs["cuda"]
    assert cpu["digests"] == card["digests"]
    assert cpu["blacklist"] == card["blacklist"]
    assert sorted(card["blacklist"]) == sorted(chip_smoke.EVENTS_DROPS)
    assert cpu["reasons"] == card["reasons"]
    cmp = chip_smoke.compare_runs(cpu, card)
    assert chip_smoke.runs_agree(cmp), cmp
    assert np.isfinite(card["scored"]).all()
