"""The port's streamed data plane (transmogrifai_tpu_torch/parallel/
tileplane.py and its consumers) against the JAX package's, on the CPU.

Mirrors tests/test_tileplane.py class by class, each case on the same
seeded numpy inputs through both packages:
- pipeline core: fixed tiles, the ragged tail, the <= 2-tile host buffer,
  producer errors raised on the caller's thread, the sink's one-tile lag,
  tile spans and their overlap, the tile and depth knobs;
- statistics: the streamed route (a host matrix or a RowSource) against
  the JAX engine (the reference test's tolerances), and against float64;
  threaded passes at depths 1 and 2 and the TMOG_TILEPLANE=0 pass
  bit-identical; one read of every row even with the Gram;
- GLM rounds over a RowSource held to the JAX package's source arm
  (`glm_rounds` equal unless a lane's delta lay within 1e-7 of tol at a
  round boundary, the repo's telemetry rule, printed; coefficients rtol
  5e-3, atol 5e-4) and to its device arm on coefficients only: the two
  reference arms disagree on rounds at tol 1e-7
  (test_tileplane.py::TestGLMConsumer::test_source_rounds_match_device_rounds);
- trees: streamed bins identical to `bin_matrix` (both packages), streamed
  edges equal to the JAX package's and within one histogram bin width of
  the resident `quantile_edges`, NaN and constant columns;
- scoring: `score_stream` against the per-record scorer and against the
  JAX package's `score_stream` within 1e-5;
- the file reader's size-stability deferral; an Avro file served fit with
  X never materialized.
Every pass waits on its producer with a deadline (the pipeline's join).
"""
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.ops import glm_sweep as JGS
from transmogrifai_tpu.ops import stats_engine as JSE
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.parallel import tileplane as JTP

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.ops import glm_sweep as PGS
from transmogrifai_tpu_torch.ops import stats_engine as PSE
from transmogrifai_tpu_torch.ops import trees as PT
from transmogrifai_tpu_torch.parallel import tileplane as PTP
from transmogrifai_tpu_torch.utils.metrics import collector

CPU = "cpu"


@pytest.fixture
def traced():
    collector.enable("test_torch_tileplane", device=CPU)
    try:
        yield collector
    finally:
        collector.finish()
        collector.disable()


def _counting_source(X, y, w, chunk_rows):
    """An ArraySource counting every pass and row it hands out."""

    class Counting(PTP.ArraySource):
        rows_yielded = 0
        passes = 0

        def chunks(self):
            Counting.passes += 1
            for chunk in super().chunks():
                Counting.rows_yielded += chunk[0].shape[0]
                yield chunk

    return Counting(X, y, w, chunk_rows=chunk_rows)


class TestPipelineCore:
    def test_sum_parity_and_ragged_tail(self):
        rng = np.random.default_rng(0)
        X = rng.normal(size=(1013, 3)).astype(np.float32)
        w = rng.uniform(0.5, 1.5, size=1013).astype(np.float32)

        carry, stats = PTP.run_tileplane(
            PTP.ArraySource(X, w, chunk_rows=97),
            lambda c, xt, wt: c + (xt * wt[:, None]).sum(0),
            torch.zeros(3), tile_rows=128, label="core", device=CPU)
        jcarry, jstats = JTP.run_tileplane(
            JTP.ArraySource(X, w, chunk_rows=97),
            jax.jit(lambda c, xt, wt: c + (xt * wt[:, None]).sum(0)),
            jnp.zeros(3, jnp.float32), tile_rows=128, label="core")
        np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry),
                                   rtol=1e-5)
        np.testing.assert_allclose(carry.numpy(), (X * w[:, None]).sum(0),
                                   rtol=1e-5)
        assert (stats.tiles, stats.rows) == (jstats.tiles, jstats.rows) \
            == (-(-1013 // 128), 1013)
        assert stats.copy_bytes == stats.tiles * 128 * 4 * 4

    def test_peak_host_buffer_under_two_tiles(self):
        X = np.ones((5000, 4), np.float32)
        _, stats = PTP.run_tileplane(
            PTP.ArraySource(X, chunk_rows=256), lambda c, xt: c + xt.sum(),
            torch.zeros(()), tile_rows=512, label="peak", device=CPU)
        _, jstats = JTP.run_tileplane(
            JTP.ArraySource(X, chunk_rows=256),
            jax.jit(lambda c, xt: c + xt.sum()), jnp.zeros((), jnp.float32),
            tile_rows=512, label="peak")
        assert stats.peak_host_rows == jstats.peak_host_rows <= 2 * 512

    @pytest.mark.parametrize("tileplane", ["1", "0"])
    def test_producer_error_propagates(self, monkeypatch, tileplane):
        monkeypatch.setenv("TMOG_TILEPLANE", tileplane)

        def factory():
            yield (np.ones((10, 2), np.float32),)
            raise RuntimeError("reader died")

        before = threading.active_count()
        with pytest.raises(RuntimeError, match="reader died"):
            PTP.run_tileplane(PTP.IterSource(factory),
                              lambda c, xt: c + xt.sum(), torch.zeros(()),
                              tile_rows=8, label="err", device=CPU)
        with pytest.raises(RuntimeError, match="reader died"):
            JTP.run_tileplane(JTP.IterSource(factory),
                              jax.jit(lambda c, xt: c + xt.sum()),
                              jnp.zeros((), jnp.float32), tile_rows=8,
                              label="err")
        assert threading.active_count() == before

    def test_step_error_stops_the_producer(self):
        X = np.ones((4000, 2), np.float32)

        def step(c, xt):
            raise ValueError("step failed")

        before = threading.active_count()
        with pytest.raises(ValueError, match="step failed"):
            PTP.run_tileplane(PTP.ArraySource(X, chunk_rows=100), step,
                              torch.zeros(()), tile_rows=64, device=CPU)
        assert threading.active_count() == before

    def test_sink_order_and_valid_rows(self):
        X = np.arange(130, dtype=np.float32).reshape(-1, 1)
        got, jgot = [], []
        PTP.run_tileplane(PTP.ArraySource(X, chunk_rows=40),
                          lambda c, xt: (c, xt * 2.0), torch.zeros(()),
                          tile_rows=32, label="sink", device=CPU,
                          sink=lambda t, n: got.append(t[:n].copy()))
        JTP.run_tileplane(JTP.ArraySource(X, chunk_rows=40),
                          jax.jit(lambda c, xt: (c, xt * 2.0)),
                          jnp.zeros((), jnp.float32), tile_rows=32,
                          label="sink", sink=lambda t, n: jgot.append(t[:n]))
        assert [len(g) for g in got] == [len(g) for g in jgot]
        np.testing.assert_array_equal(np.concatenate(got),
                                      np.concatenate(jgot))
        np.testing.assert_array_equal(np.concatenate(got), X * 2.0)

    def test_first_tile_runs_once_before_its_step(self):
        X = np.arange(40, dtype=np.float32).reshape(-1, 1)
        seen = []

        def first(c, xt):
            seen.append(("first", float(xt[0, 0])))
            return c + 1000.0

        def step(c, xt):
            seen.append(("step", float(xt[0, 0])))
            return c + xt.sum()

        carry, _ = PTP.run_tileplane(PTP.ArraySource(X, chunk_rows=7), step,
                                     torch.zeros(()), tile_rows=16,
                                     first_tile=first, device=CPU)
        assert seen[:2] == [("first", 0.0), ("step", 0.0)]
        assert [k for k, _ in seen].count("first") == 1
        assert float(carry) == 1000.0 + X.sum()

    def test_tile_spans_and_overlap(self, traced):
        X = np.random.default_rng(1).normal(
            size=(16000, 96)).astype(np.float32)

        def step(carry, xt):
            g = xt.T @ xt
            return carry + g @ g

        with collector.trace_span("pass", kind="span"):
            _, stats = PTP.run_tileplane(
                PTP.ArraySource(X, chunk_rows=2000), step,
                torch.zeros((96, 96)), tile_rows=2000, label="spans",
                device=CPU)
        copies = [s for s in collector.trace.spans if s.name == "tile_copy"]
        computes = [s for s in collector.trace.spans
                    if s.name == "tile_compute"]
        assert len(copies) == len(computes) == stats.tiles == 8
        assert {s.kind for s in copies + computes} == {"tile"}
        assert all(s.attrs["label"] == "spans" and s.attrs["rows"] == 2000
                   for s in copies + computes)
        # double buffering: some tile k+1 copy window meets an earlier
        # tile's compute window
        assert any(c.attrs["tile"] > m.attrs["tile"]
                   and c.t_start <= m.t_end and m.t_start <= c.t_end
                   for c in copies for m in computes), \
            "producer copies never overlapped compute"
        assert stats.wall_seconds > 0 and stats.compute_seconds > 0

    def test_tile_rows_for_env(self, monkeypatch):
        monkeypatch.setenv("TMOG_TILE_MB", "1")
        for args, kw in (((1024,), {}), ((4,), {"multiple": 3}),
                         ((64, 1000), {}), ((4,), {})):
            assert PTP.tile_rows_for(*args, **kw) \
                == JTP.tile_rows_for(*args, **kw)
        assert PTP.tile_rows_for(1024) == (1 << 20) // 1024

    def test_knobs_match_the_reference(self, monkeypatch):
        for v in ("0", "false", "off", "1", "yes"):
            monkeypatch.setenv("TMOG_TILEPLANE", v)
            assert PTP.tileplane_enabled() == JTP.tileplane_enabled()
        for v in ("3", "0", "garbage"):
            monkeypatch.setenv("TMOG_TILE_PREFETCH", v)
            assert PTP.tile_prefetch_depth() == JTP.tile_prefetch_depth()

    def test_pipelined_propagates_and_orders(self):
        assert list(PTP.pipelined(iter(range(5)), label="t")) \
            == list(JTP.pipelined(iter(range(5)), label="t")) \
            == list(range(5))

        def bad():
            yield 1
            raise ValueError("boom")

        with pytest.raises(ValueError, match="boom"):
            list(PTP.pipelined(bad(), label="t"))

    def test_padded_source_and_mesh_lane(self):
        X = np.ones((10, 2), np.float32)
        src = PTP.PaddedSource(PTP.ArraySource(X, chunk_rows=4), 16)
        jsrc = JTP.PaddedSource(JTP.ArraySource(X, chunk_rows=4), 16)
        got = np.concatenate([c[0] for c in src.chunks()])
        np.testing.assert_array_equal(
            got, np.concatenate([c[0] for c in jsrc.chunks()]))
        assert got.shape == (16, 2) and got[10:].sum() == 0
        with pytest.raises(NotImplementedError, match="A14"):
            PTP.run_tileplane(src, lambda c, x: c, None, tile_rows=4,
                              shardings=[None], device=CPU)


class TestStatsConsumer:
    def _data(self, n=3000, d=6, seed=0):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, d)).astype(np.float32) + 50.0
        X[rng.uniform(size=X.shape) < 0.08] = np.nan
        y = rng.integers(0, 2, size=n).astype(np.float32)
        return X, y

    def test_streamed_matches_the_jax_engine(self):
        X, y = self._data()
        lo = np.nanmin(X, 0).astype(np.float32)
        hi = np.nanmax(X, 0).astype(np.float32)
        kw = dict(corr_matrix=True, lo=lo, hi=hi, bins=12,
                  distinct=np.asarray([0.0, 1.0], np.float32))
        want = JSE.run_stats(X, y, driver="streamed", tile_rows=400, **kw)
        fused = JSE.run_stats(X, y, **kw)
        got = PSE.run_stats(X, y, driver="streamed", tile_rows=400,
                            device=CPU, **kw)
        assert PSE.last_pass["tiles"] == -(-3000 // 400)
        for ref in (want, fused):
            for f in ("count", "mean", "variance", "min", "max",
                      "fill_rate", "corr_label", "num_non_zeros"):
                np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                           rtol=2e-4, atol=2e-5, err_msg=f)
            np.testing.assert_allclose(got.corr_matrix, ref.corr_matrix,
                                       rtol=2e-3, atol=2e-4)
            np.testing.assert_allclose(got.hist, ref.hist, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(got.contingency, ref.contingency,
                                       rtol=2e-4, atol=1e-4)
        # the moments against the JAX engine within rtol 1e-5 (atol 1e-6
        # for correlations near 0, as tests/test_torch_stats.py)
        for f in ("count", "mean", "variance", "corr_label"):
            np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                       rtol=1e-5, atol=1e-6, err_msg=f)

    def test_streamed_moments_within_1e7_of_float64(self):
        X, y = self._data(n=4000, d=4, seed=11)
        X[:, 1] = 1e4 + X[:, 1] - 50.0
        got = PSE.run_stats(PTP.ArraySource(X, y, np.ones(4000, np.float32),
                                            chunk_rows=333),
                            tile_rows=512, device=CPU)
        X8, y8 = X.astype(np.float64), y.astype(np.float64)
        for j in range(X.shape[1]):
            ok = np.isfinite(X8[:, j])
            col = X8[ok, j]
            assert abs(got.mean[j] - col.mean()) <= 1e-7 * abs(col.mean())
            var = col.var(ddof=1)
            assert abs(got.variance[j] - var) <= 1e-5 * var
            corr = np.corrcoef(col, y8[ok])[0, 1]
            assert abs(got.corr_label[j] - corr) < 1e-7

    @pytest.mark.parametrize("extras", [{}, {"corr_matrix": True}])
    def test_depth_and_kill_switch_bit_identical(self, monkeypatch, extras):
        X, y = self._data(seed=3)
        src = PTP.ArraySource(X, y, np.ones(len(y), np.float32),
                              chunk_rows=350)
        runs = []
        for tileplane, depth in (("1", 1), ("1", 2), ("0", 1)):
            monkeypatch.setenv("TMOG_TILEPLANE", tileplane)
            st, shift = PSE.stream_stats(src, tile_rows=500, prefetch=depth,
                                         device=CPU, **extras)
            runs.append((st, shift))
            assert PSE._last_stream_stats.prefetch_depth == depth
        for st, shift in runs[1:]:
            np.testing.assert_array_equal(shift, runs[0][1])
            for a, b in zip(st, runs[0][0]):
                if a is not None:
                    np.testing.assert_array_equal(a, b)
        fused = JSE.run_stats(X, y, **extras)
        legacy = PSE._finalize(*runs[2])
        np.testing.assert_allclose(legacy.mean, fused.mean, rtol=2e-4,
                                   atol=2e-5)
        if extras:
            np.testing.assert_allclose(legacy.corr_matrix,
                                       fused.corr_matrix, rtol=2e-3,
                                       atol=2e-4)

    @pytest.mark.parametrize("tileplane", ["1", "0"])
    def test_single_read_even_with_corr_matrix(self, monkeypatch,
                                               tileplane):
        monkeypatch.setenv("TMOG_TILEPLANE", tileplane)
        X, y = self._data(n=2000, seed=5)
        src = _counting_source(X, y, np.ones(2000, np.float32),
                               chunk_rows=250)
        res = PSE.run_stats(src, corr_matrix=True, tile_rows=500,
                            device=CPU)
        # one data pass + the cached one-chunk width probe
        assert type(src).passes <= 2
        assert type(src).rows_yielded <= 2000 + 250
        assert PSE._last_stream_stats.rows == 2000
        fused = JSE.run_stats(X, y, corr_matrix=True)
        np.testing.assert_allclose(res.corr_matrix, fused.corr_matrix,
                                   rtol=2e-3, atol=2e-4)

    def test_source_pass_is_recorded(self, traced):
        X, y = self._data(n=1200, d=3, seed=7)
        PSE.run_stats(PTP.ArraySource(X, y, np.ones(1200, np.float32)),
                      tile_rows=256, label="probe", device=CPU)
        [rec] = traced.current.stats_metrics
        assert (rec.driver, rec.rows, rec.cols, rec.tiles, rec.label) \
            == ("streamed", 1200, 3, 5, "probe")

    def test_mesh_and_stray_args_raise(self):
        X, y = self._data(n=100, d=2)
        src = PTP.ArraySource(X, y, np.ones(100, np.float32))
        with pytest.raises(NotImplementedError, match="A14"):
            PSE.run_stats(X, y, driver="streamed", mesh=object(),
                          device=CPU)
        with pytest.raises(ValueError, match="inside the RowSource"):
            PSE.stream_stats(src, y, device=CPU)


def _glm_problem(n=1600, d=5, F=3, seed=11):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[:, 1] += 30.0
    beta = rng.normal(size=d)
    y = (X @ beta + 0.2 * rng.normal(size=n)
         > np.median(X @ beta)).astype(np.float32)
    w = np.ones(n, np.float32)
    fold = rng.integers(0, F, size=n)
    masks = np.stack([(fold != k).astype(np.float32) for k in range(F)])
    return X, y, w, masks


def _near_tol_rule(ji, pi, deltas, tol):
    """glm_rounds equal, unless some lane's delta at a round boundary lay
    within 1e-7 of tol in either package (printed)."""
    if ji["glm_rounds"] != pi["glm_rounds"]:
        near = sorted({float(v) for dl in deltas for v in dl
                       if abs(float(v) - tol) < 1e-7})
        print(f"glm_rounds {ji['glm_rounds']} (JAX source arm) vs "
              f"{pi['glm_rounds']}; lane deltas within 1e-7 of tol "
              f"{tol}: {near}")
        assert near


class TestGLMConsumer:
    @pytest.mark.parametrize("tol", [1e-7, 1e-6])
    def test_source_rounds_match_the_reference_source_arm(self, monkeypatch,
                                                          tol):
        for mod in (JTP, PTP):   # force a multi-tile pass
            monkeypatch.setattr(mod, "tile_rows_for", lambda *a, **k: 400)
        X, y, w, masks = _glm_problem()
        regs = np.asarray([0.02, 0.2], np.float32)
        alphas = np.asarray([0.0, 0.5], np.float32)
        kw = dict(loss="logistic", max_iter=25, tol=tol, warm_start=False)
        deltas = []
        rec = lambda st: deltas.append(st["delta"].copy())   # noqa: E731
        B_src, b0_src, info_src = JGS.sweep_glm_streamed_rounds(
            JTP.ArraySource(X, y, w, masks.T.copy(), chunk_rows=300),
            None, None, None, regs, alphas, on_round=rec, **kw)
        B_dev, b0_dev, _ = JGS.sweep_glm_streamed_rounds(
            jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
            jnp.asarray(masks), regs, alphas, **kw)
        B, b0, info = PGS.sweep_glm_streamed_rounds(
            PTP.ArraySource(X, y, w, masks.T.copy(), chunk_rows=300),
            None, None, None, regs, alphas, on_round=rec, device=CPU, **kw)
        assert info["driver"] == info_src["driver"] == "tileplane"
        _near_tol_rule(info_src, info, deltas, tol)
        for ref_B, ref_b0 in ((B_src, b0_src), (B_dev, b0_dev)):
            np.testing.assert_allclose(B, ref_B, rtol=5e-3, atol=5e-4)
            np.testing.assert_allclose(b0, ref_b0, rtol=5e-3, atol=5e-4)

    def test_source_warm_start_and_retirement(self):
        X, y, w, masks = _glm_problem(seed=13)
        regs = np.asarray([0.01, 0.1, 0.5], np.float32)
        alphas = np.zeros(3, np.float32)
        kw = dict(loss="logistic", max_iter=30, tol=1e-6, warm_start=True)
        B, b0, info = PGS.sweep_glm_streamed_rounds(
            PTP.ArraySource(X, y, w, masks.T.copy()), None, None, None,
            regs, alphas, device=CPU, **kw)
        assert info["warm_start"]
        assert info["lanes_retired"] == info["lanes_total"]
        jB, jb0, jinfo = JGS.sweep_glm_streamed_rounds(
            JTP.ArraySource(X, y, w, masks.T.copy()), None, None, None,
            regs, alphas, **kw)
        assert info["glm_rounds"] == jinfo["glm_rounds"]
        assert info["data_passes"] == jinfo["data_passes"]
        np.testing.assert_allclose(B, jB, rtol=5e-3, atol=7e-4)
        # the resident round driver of the port on the same problem
        rB, _, _ = PGS.sweep_glm_streamed_rounds(
            torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(w),
            torch.from_numpy(masks), regs, alphas, **kw)
        np.testing.assert_allclose(B, rB, rtol=5e-3, atol=7e-4)

    def test_source_kill_switch_and_depth_bit_identical(self, monkeypatch):
        monkeypatch.setattr(PTP, "tile_rows_for", lambda *a, **k: 400)
        X, y, w, masks = _glm_problem(seed=47)
        regs = np.asarray([0.05, 0.3], np.float32)
        alphas = np.asarray([0.0, 0.5], np.float32)
        src = PTP.ArraySource(X, y, w, masks.T.copy(), chunk_rows=300)
        kw = dict(loss="logistic", max_iter=15, tol=1e-6, warm_start=True,
                  device=CPU)
        runs = []
        for tileplane, depth in (("0", "1"), ("1", "1"), ("1", "2")):
            monkeypatch.setenv("TMOG_TILEPLANE", tileplane)
            monkeypatch.setenv("TMOG_TILE_PREFETCH", depth)
            runs.append(PGS.sweep_glm_streamed_rounds(
                src, None, None, None, regs, alphas, **kw))
        for B, b0, info in runs[1:]:
            np.testing.assert_array_equal(B, runs[0][0])
            np.testing.assert_array_equal(b0, runs[0][1])
            assert info == runs[0][2]

    def test_source_rejects_mesh_warm_seed_and_stray_args(self):
        src = PTP.ArraySource(np.ones((8, 2), np.float32),
                              np.ones(8, np.float32),
                              np.ones(8, np.float32),
                              np.ones((8, 2), np.float32))
        args = (np.asarray([0.1], np.float32), np.zeros(1, np.float32))
        with pytest.raises(ValueError, match="ride the source"):
            PGS.sweep_glm_streamed_rounds(src, np.ones(8), None, None,
                                          *args, loss="logistic",
                                          device=CPU)
        with pytest.raises(NotImplementedError, match="mesh"):
            PGS.sweep_glm_streamed_rounds(src, None, None, None, *args,
                                          loss="logistic", mesh=object())
        with pytest.raises(NotImplementedError, match="warm_seed"):
            PGS.sweep_glm_streamed_rounds(src, None, None, None, *args,
                                          loss="logistic",
                                          warm_seed=(np.ones(2), 0.0))


class TestTreesConsumer:
    def _X(self, n=4000, d=4, seed=19):
        rng = np.random.default_rng(seed)
        X = rng.normal(size=(n, d)).astype(np.float32)
        X[:, 1] *= 40.0
        X[rng.uniform(size=X.shape) < 0.05] = np.nan
        return X

    @pytest.mark.parametrize("tileplane", ["1", "0"])
    def test_stream_bin_matrix_exact_parity(self, monkeypatch, tileplane):
        monkeypatch.setenv("TMOG_TILEPLANE", tileplane)
        X = self._X()
        edges = np.asarray(JT.quantile_edges(jnp.asarray(X), 16))
        jres = np.asarray(JT.bin_matrix(jnp.asarray(X), jnp.asarray(edges)))
        resident = PT.bin_matrix(torch.from_numpy(X),
                                 torch.tensor(edges)).numpy()
        streamed = PT.stream_bin_matrix(PTP.ArraySource(X, chunk_rows=600),
                                        edges, tile_rows=640, device=CPU)
        assert streamed.dtype == resident.dtype == jres.dtype
        np.testing.assert_array_equal(streamed, resident)
        np.testing.assert_array_equal(streamed, jres)

    def test_unknown_length_and_sink(self):
        X = self._X(n=900, seed=23)
        edges = np.asarray(PT.quantile_edges(torch.from_numpy(X), 8))
        resident = PT.bin_matrix(torch.from_numpy(X),
                                 torch.tensor(edges)).numpy()
        src = PTP.IterSource(lambda: ((X[s:s + 200],)
                                      for s in range(0, 900, 200)))
        got = PT.stream_bin_matrix(src, edges, tile_rows=256, device=CPU)
        np.testing.assert_array_equal(got, resident)
        parts = []
        assert PT.stream_bin_matrix(
            src, edges, tile_rows=256, device=CPU,
            sink=lambda t, n: parts.append(t)) is None
        np.testing.assert_array_equal(np.concatenate(parts), resident)

    def test_stream_quantile_edges_quality(self):
        X = self._X(n=6000, d=3, seed=29)
        X[:, 2] = 5.0  # constant column
        edges = PT.stream_quantile_edges(PTP.ArraySource(X, chunk_rows=700),
                                         16, hist_bins=512, device=CPU)
        jedges = JT.stream_quantile_edges(JTP.ArraySource(X, chunk_rows=700),
                                          16, hist_bins=512)
        assert edges.shape == (3, 15) and edges.dtype == np.float32
        np.testing.assert_allclose(edges, jedges, rtol=1e-6, atol=1e-6)
        resident = PT.quantile_edges(torch.from_numpy(X), 16).numpy()
        for j in range(2):
            col = X[:, j]
            fin = np.isfinite(col)
            bw = (col[fin].max() - col[fin].min()) / 512
            assert np.abs(edges[j] - resident[j]).max() <= bw
            assert np.all(np.diff(edges[j]) >= 0)
        assert np.all(edges[2] == 5.0)
        np.testing.assert_array_equal(resident[2], edges[2])

    def test_stream_quantile_edges_all_nan_column(self):
        X = self._X(n=800, d=2, seed=31)
        X[:, 1] = np.nan
        src = PTP.ArraySource(X, chunk_rows=200)
        edges = PT.stream_quantile_edges(src, 8, hist_bins=64, device=CPU)
        assert np.all(np.isnan(edges[1]))
        binned = PT.stream_bin_matrix(src, edges, device=CPU)
        assert set(np.unique(binned[:, 1])) <= {0}
        np.testing.assert_array_equal(
            binned, np.asarray(JT.bin_matrix(jnp.asarray(X),
                                             jnp.asarray(edges))))


def _scoring_models():
    """One flow trained by each package on the same records."""
    from transmogrifai_tpu import FeatureBuilder as JFB
    from transmogrifai_tpu.automl import \
        BinaryClassificationModelSelector as JBCMS
    from transmogrifai_tpu.automl.transmogrifier import transmogrify as jtm
    from transmogrifai_tpu.models.glm import OpLogisticRegression as JLR
    from transmogrifai_tpu.readers.readers import ListReader as JList
    from transmogrifai_tpu.workflow import Workflow as JW

    from transmogrifai_tpu_torch.automl.selectors import \
        BinaryClassificationModelSelector as PBCMS
    from transmogrifai_tpu_torch.automl.transmogrifier import \
        transmogrify as ptm
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder as PFB
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression as PLR
    from transmogrifai_tpu_torch.readers.readers import ListReader as PList
    from transmogrifai_tpu_torch.workflow import Workflow as PW

    rng = np.random.default_rng(41)
    rows = [{"a": float(rng.normal()), "b": float(rng.normal()),
             "label": 0.0} for _ in range(250)]
    for r in rows:
        r["label"] = float(r["a"] + 0.5 * r["b"] > 0)
    models = []
    for FB, tm, BCMS, LR, List, W, kw in (
            (JFB, jtm, JBCMS, JLR, JList, JW, {}),
            (PFB, ptm, PBCMS, PLR, PList, PW, {"device": CPU})):
        fa = FB.Real("a").extract(lambda r: r.get("a")).as_predictor()
        fb = FB.Real("b").extract(lambda r: r.get("b")).as_predictor()
        fy = FB.RealNN("label").extract(
            lambda r: r.get("label")).as_response()
        pred = BCMS.with_train_validation_split(models_and_parameters=[
            (LR(**kw), [dict(reg_param=0.01)])]).set_input(
                fy, tm([fa, fb])).get_output()
        models.append(W(**kw).set_reader(List(rows))
                      .set_result_features(pred).train())
    return models[0], models[1], rows


@pytest.fixture(scope="module")
def scoring():
    return _scoring_models()


def _prob(score):
    return list(score.values())[0]


class TestScoringConsumer:
    def test_tileplane_scores_match_per_record_and_jax(self, scoring):
        from transmogrifai_tpu.readers import ListStreamingReader as JLSR
        from transmogrifai_tpu.readers import score_stream as j_score_stream

        from transmogrifai_tpu_torch.readers import (ListStreamingReader,
                                                     score_stream)
        jmodel, model, rows = scoring
        unlabeled = [{"a": r["a"], "b": r["b"]} for r in rows[:53]]
        tiled = [s for b in score_stream(
            model, ListStreamingReader(unlabeled, batch_size=9),
            tile_rows=16) for s in b]
        jtiled = [s for b in j_score_stream(
            jmodel, JLSR(unlabeled, batch_size=9), tile_rows=16) for s in b]
        fn = model.score_function()
        legacy = [fn(r) for r in unlabeled]
        assert len(tiled) == len(legacy) == len(jtiled) == 53
        for got, want, jwant in zip(tiled, legacy, jtiled):
            g, w, j = _prob(got), _prob(want), _prob(jwant)
            assert g["prediction"] == w["prediction"] == j["prediction"]
            assert g["probability_1"] == pytest.approx(w["probability_1"],
                                                       abs=1e-5)
            assert g["probability_1"] == pytest.approx(j["probability_1"],
                                                       abs=1e-5)

    def test_kill_switch_restores_per_record_batches(self, scoring,
                                                     monkeypatch):
        from transmogrifai_tpu_torch.readers import (ListStreamingReader,
                                                     score_stream)
        monkeypatch.setenv("TMOG_TILEPLANE", "0")
        _, model, rows = scoring
        unlabeled = [{"a": r["a"], "b": r["b"]} for r in rows[:20]]
        batches = list(score_stream(
            model, ListStreamingReader(unlabeled, batch_size=7)))
        assert [len(b) for b in batches] == [7, 7, 6]
        monkeypatch.setenv("TMOG_TILEPLANE", "1")
        assert [len(b) for b in score_stream(
            model, ListStreamingReader(unlabeled, batch_size=7),
            tile_rows=0)] == [7, 7, 6]

    def test_scoring_tile_spans(self, scoring, traced):
        from transmogrifai_tpu_torch.readers import (ListStreamingReader,
                                                     score_stream)
        _, model, rows = scoring
        unlabeled = [{"a": r["a"], "b": r["b"]} for r in rows[:40]]
        list(score_stream(model, ListStreamingReader(unlabeled,
                                                     batch_size=10),
                          tile_rows=16))
        names = [s.name for s in collector.trace.spans]
        assert names.count("tile_copy") == 3
        assert names.count("tile_compute") == 3


class TestReaderStability:
    def test_midwrite_file_deferred_until_stable(self, tmp_path):
        from transmogrifai_tpu_torch.readers import CSVStreamingReader
        (tmp_path / "done.csv").write_text("x\n1\n2\n")
        partial = tmp_path / "partial.csv"
        partial.write_text("x\n3\n")
        r = CSVStreamingReader(str(tmp_path / "*.csv"))
        sizes = {str(partial): iter([10, 14, 18, 22])}
        real_size = type(r)._size

        def fake_size(self, p):
            it = sizes.get(p)
            return next(it) if it is not None else real_size(self, p)

        r._size = fake_size.__get__(r)
        first = r.poll()
        assert len(first) == 1 and first[0][0]["x"] == 1  # done.csv only
        assert str(partial) in r._pending
        del sizes[str(partial)]
        partial.write_text("x\n3\n4\n")
        r._pending[str(partial)] = os.path.getsize(str(partial))
        again = r.poll()
        assert len(again) == 1 and [row["x"] for row in again[0]] == [3, 4]
        assert r.poll() == []

    def test_stable_files_yield_first_poll(self, tmp_path):
        from transmogrifai_tpu_torch.readers import CSVStreamingReader
        for i in range(2):
            (tmp_path / f"f{i}.csv").write_text("x\n1\n")
        r = CSVStreamingReader(str(tmp_path / "*.csv"))
        assert len(r.poll()) == 2

    def test_vanished_file_skipped(self, tmp_path):
        from transmogrifai_tpu_torch.readers import CSVStreamingReader
        (tmp_path / "a.csv").write_text("x\n1\n")
        r = CSVStreamingReader(str(tmp_path / "*.csv"))
        r._size = (lambda self, p: -1).__get__(r)
        assert r.poll() == []


class TestAvroEndToEnd:
    """A fit on data served from disk, X never materialized as one
    array, in both packages."""

    def test_avro_fit_never_materializes_x(self, tmp_path):
        from transmogrifai_tpu.readers.avro import \
            read_avro_file as j_read_avro
        from transmogrifai_tpu_torch.readers.avro import (read_avro_file,
                                                          write_avro_file)
        n, d, F = 1800, 4, 2
        rng = np.random.default_rng(43)
        X = rng.normal(size=(n, d)).astype(np.float32)
        y = (X @ rng.normal(size=d) > 0).astype(np.float32)
        schema = {"type": "record", "name": "Row", "fields": (
            [{"name": f"x{j}", "type": "float"} for j in range(d)]
            + [{"name": "y", "type": "float"},
               {"name": "id", "type": "long"}])}
        path = str(tmp_path / "rows.avro")
        write_avro_file(path, schema, [
            {**{f"x{j}": float(X[i, j]) for j in range(d)},
             "y": float(y[i]), "id": i} for i in range(n)])

        def stats_row(r):
            return ([r[f"x{j}"] for j in range(d)], r["y"], 1.0)

        def glm_row(r):
            m = [1.0] * F
            m[r["id"] % F] = 0.0
            return ([r[f"x{j}"] for j in range(d)], r["y"], 1.0, m)

        def sources(TP, read):
            # the row count sizes the GLM's tiles (else one tile of 2^20
            # rows, all but 1 800 of them zero padding)
            return (TP.reader_row_source(lambda: read(path), fn,
                                         batch_records=256, n_rows=n)
                    for fn in (stats_row, glm_row))

        stats_src, glm_src = sources(PTP, read_avro_file)
        j_stats_src, j_glm_src = sources(JTP, j_read_avro)
        res = PSE.run_stats(stats_src, corr_matrix=True, tile_rows=256,
                            device=CPU)
        want = JSE.run_stats(j_stats_src, corr_matrix=True, tile_rows=256)
        np.testing.assert_allclose(res.mean, want.mean, rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(res.corr_matrix, want.corr_matrix,
                                   rtol=2e-3, atol=2e-4)
        ps = PSE._last_stream_stats
        assert ps.peak_host_rows <= 2 * ps.tile_rows
        assert ps.rows == n

        regs = np.asarray([0.05, 0.2], np.float32)
        alphas = np.zeros(2, np.float32)
        kw = dict(loss="logistic", max_iter=20, tol=1e-6, warm_start=False)
        B, b0, info = PGS.sweep_glm_streamed_rounds(
            glm_src, None, None, None, regs, alphas, device=CPU, **kw)
        jB, jb0, jinfo = JGS.sweep_glm_streamed_rounds(
            j_glm_src, None, None, None, regs, alphas, **kw)
        assert info["driver"] == "tileplane"
        assert info["glm_rounds"] == jinfo["glm_rounds"]
        np.testing.assert_allclose(B, jB, rtol=5e-3, atol=7e-4)
        np.testing.assert_allclose(b0, jb0, rtol=5e-3, atol=7e-4)
