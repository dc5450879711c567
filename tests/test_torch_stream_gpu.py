"""The streamed data plane on the card (parallel/tileplane.py on CUDA):
tiles land on the device through the pinned ring and the copy stream, the
ring is allocated once a pass and reused without a copy overtaking its
buffer, threaded passes at depths 1 and 2 give the same bits as the
TMOG_TILEPLANE=0 pass, a producer's error raises on the caller's thread,
and the consumers (statistics, GLM rounds, streamed binning) agree with
their CPU passes. Every test needs a CUDA device and skips without one.
This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_stream_gpu.py

Tolerances: sums of one tile on the card against the CPU within rtol
1e-5 (f32 reductions in another order); bins exact; GLM coefficients
within 1e-4 of the CPU's (f32 Newton solves summed in another order).
"""
import threading

import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.ops import glm_sweep as GS
from transmogrifai_tpu_torch.ops import stats_engine as SE
from transmogrifai_tpu_torch.ops import trees as T
from transmogrifai_tpu_torch.parallel import tileplane as TP

pytestmark = pytest.mark.gpu


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card's run of the program)")


def _data(n=20000, d=8, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] += 1e3
    X[rng.uniform(size=X.shape) < 0.05] = np.nan
    y = (rng.uniform(size=n) < 0.4).astype(np.float32)
    return X, y


def test_tiles_land_on_the_card_through_the_pinned_ring():
    _need_cuda()
    n, c = 50_000, 1000
    X = np.arange(n * 2, dtype=np.float32).reshape(n, 2) % 977
    seen = []

    def step(carry, xt):
        seen.append((xt.device.type, xt.shape))
        # one sum a tile: a copy that overtook its buffer would change it
        return torch.cat([carry, xt.sum(0, keepdim=True)])

    for depth in (1, 2):
        seen.clear()
        carry, stats = TP.run_tileplane(
            TP.ArraySource(X, chunk_rows=777), step,
            torch.zeros((0, 2), device="cuda"), tile_rows=c,
            prefetch=depth)
        assert {s for s in seen} == {("cuda", torch.Size([c, 2]))}
        assert stats.tiles == n // c and stats.pinned_slots == depth + 1
        want = X.reshape(-1, c, 2).sum(1)
        np.testing.assert_allclose(carry.cpu().numpy(), want, rtol=1e-5)


def test_lander_ring_is_pinned_and_allocated_once():
    _need_cuda()
    lander = TP._TileLander(torch.device("cuda"), 3,
                            torch.cuda.Stream())
    out = []
    for k in range(10):
        (slot,) = lander.alloc(((64, 4),))
        slot[...] = k
        dev, ev = lander.land((slot,))
        torch.cuda.current_stream().wait_event(ev)
        out.append(dev[0].clone())
    assert lander.pinned_allocs == 3
    assert all(buf.is_pinned() for slot in lander._ring for buf in slot)
    for k, o in enumerate(out):
        assert float(o.min()) == float(o.max()) == float(k)
    # a tile that was not assembled in the slot alloc() handed out
    with pytest.raises(RuntimeError, match="assembled in the slot"):
        lander.land((np.zeros((64, 4), np.float32),))
    lander.alloc(((64, 4),))
    with pytest.raises(RuntimeError, match="assembled in the slot"):
        lander.land((np.zeros((64, 4), np.float32),))


@pytest.mark.parametrize("corr_matrix", [False, True])
def test_stats_threaded_and_kill_switch_bit_identical(monkeypatch,
                                                      corr_matrix):
    _need_cuda()
    X, y = _data()
    src = TP.ArraySource(X, y, np.ones(len(y), np.float32),
                         chunk_rows=3333)
    runs = []
    for tileplane, depth in (("1", 1), ("1", 2), ("0", 1)):
        monkeypatch.setenv("TMOG_TILEPLANE", tileplane)
        runs.append(SE.stream_stats(src, tile_rows=4096, prefetch=depth,
                                    corr_matrix=corr_matrix))
    for st, shift in runs[1:]:
        np.testing.assert_array_equal(shift, runs[0][1])
        for a, b in zip(st, runs[0][0]):
            if a is not None:
                np.testing.assert_array_equal(a, b)
    cpu = SE.run_stats(X, y, driver="streamed", tile_rows=4096,
                       corr_matrix=corr_matrix, device="cpu")
    card = SE._finalize(*runs[0])
    for k in ("count", "mean", "variance", "corr_label", "min", "max"):
        np.testing.assert_allclose(getattr(card, k), getattr(cpu, k),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("tileplane", ["1", "0"])
def test_producer_error_raises_on_the_card(monkeypatch, tileplane):
    _need_cuda()
    monkeypatch.setenv("TMOG_TILEPLANE", tileplane)

    def factory():
        yield (np.ones((10, 2), np.float32),)
        raise RuntimeError("reader died")

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="reader died"):
        TP.run_tileplane(TP.IterSource(factory),
                         lambda c, xt: c + xt.sum(),
                         torch.zeros((), device="cuda"), tile_rows=8)
    assert threading.active_count() == before


def test_stream_bins_and_edges_on_the_card():
    _need_cuda()
    X, _ = _data(n=30000, d=5, seed=3)
    edges = T.quantile_edges(torch.from_numpy(X), 32).numpy()
    src = TP.ArraySource(X, chunk_rows=2500)
    card = T.stream_bin_matrix(src, edges, tile_rows=4096)
    cpu = T.bin_matrix(torch.from_numpy(X), torch.from_numpy(edges)).numpy()
    assert card.dtype == cpu.dtype
    np.testing.assert_array_equal(card, cpu)
    e_card = T.stream_quantile_edges(src, 32, hist_bins=256,
                                     tile_rows=4096)
    e_cpu = T.stream_quantile_edges(src, 32, hist_bins=256, tile_rows=4096,
                                    device="cpu")
    np.testing.assert_array_equal(e_card, e_cpu)


def test_glm_source_rounds_on_the_card():
    _need_cuda()
    rng = np.random.default_rng(11)
    n, d, F = 6000, 6, 3
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) > 0).astype(np.float32)
    w = np.ones(n, np.float32)
    fold = rng.integers(0, F, size=n)
    masks = np.stack([(fold != k) for k in range(F)], 1).astype(np.float32)
    src = TP.ArraySource(X, y, w, masks, chunk_rows=1000)
    kw = dict(loss="logistic", max_iter=15, tol=1e-5, warm_start=True)
    regs = np.asarray([0.01, 0.1], np.float32)
    alphas = np.zeros(2, np.float32)
    B, b0, info = GS.sweep_glm_streamed_rounds(src, None, None, None, regs,
                                               alphas, **kw)
    cB, cb0, cinfo = GS.sweep_glm_streamed_rounds(
        src, None, None, None, regs, alphas, device="cpu", **kw)
    assert info["driver"] == "tileplane"
    np.testing.assert_allclose(B, cB, rtol=0, atol=1e-4)
    np.testing.assert_allclose(b0, cb0, rtol=0, atol=1e-4)
