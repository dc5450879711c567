"""The port's sharded ingest (transmogrifai_tpu_torch/parallel/ingest.py and
the columnar readers) against the JAX package's, on the CPU.

Mirrors tests/test_ingest.py: the columnar decoders against the JAX
package's (the same float32 cells, NaNs in the same rows), ShardedSource
reassembly (the parallel chunk stream bit-identical to the serial one at
any worker count; a worker's exception raised again at its shard, every
pool thread joined; an abandoned pass unblocks its workers), the prefetch
ring's knob, the end-to-end matrix (statistics, GLM fit, streamed edges
and bins over three CSV shards bit-identical across workers {1, 2, 4} x
prefetch {1, 3}, and the serial fingerprint held to the JAX package's:
edges and bins identical, moments within 1e-5, coefficients within 5e-3),
the ingest_pass / tile_parse telemetry, and FileStreamingReader's
deterministic shard order. The planner case of the reference is not
mirrored: the planner is not ported.
"""
import glob
import os
import threading

import numpy as np
import pytest

from transmogrifai_tpu.ops import glm_sweep as JGS
from transmogrifai_tpu.ops import stats_engine as JSE
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu.parallel import ingest as JING
from transmogrifai_tpu.readers.avro import read_avro_columns as j_avro_cols
from transmogrifai_tpu.readers.readers import \
    csv_columnar_chunks as j_csv_chunks

from torch_threads import one_torch_thread  # noqa: F401
from transmogrifai_tpu_torch.ops import glm_sweep as PGS
from transmogrifai_tpu_torch.ops import stats_engine as PSE
from transmogrifai_tpu_torch.ops import trees as PT
from transmogrifai_tpu_torch.parallel import ingest as ING
from transmogrifai_tpu_torch.parallel import tileplane as TP
from transmogrifai_tpu_torch.readers.avro import (read_avro_columns,
                                                  write_avro_columns,
                                                  write_avro_file)
from transmogrifai_tpu_torch.readers.readers import (CSVReader,
                                                     csv_columnar_chunks)
from transmogrifai_tpu_torch.readers.streaming import FileStreamingReader
from transmogrifai_tpu_torch.utils.metrics import collector

CPU = "cpu"
DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for k in ("TMOG_INGEST_WORKERS", "TMOG_TILE_PREFETCH",
              "TMOG_TILEPLANE"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def traced():
    collector.enable("test_torch_ingest", device=CPU)
    try:
        yield collector
    finally:
        collector.finish()
        collector.disable()


def _write_csv_shards(dirpath, n_shards=3, rows=(400, 257, 311), d=4,
                      seed=0):
    """Uneven CSV shards with x0..x{d-1}, y, w, fold columns and some
    string nulls, deterministic content."""
    rng = np.random.default_rng(seed)
    paths = []
    os.makedirs(dirpath, exist_ok=True)
    for s in range(n_shards):
        p = os.path.join(str(dirpath), f"part-{s:03d}.csv")
        with open(p, "w") as fh:
            fh.write(",".join([f"x{j}" for j in range(d)]
                              + ["y", "w", "fold"]) + "\n")
            for i in range(rows[s % len(rows)]):
                cells = [f"{rng.normal():.6f}" for _ in range(d)]
                if i % 37 == 0:
                    cells[1] = "NA"
                fh.write(",".join(
                    cells + [str(int(rng.integers(0, 2))), "1.0",
                             str(i % 2)]) + "\n")
        paths.append(p)
    return paths


def _join_all(threads_before: int) -> bool:
    """True once the pass's threads are gone (waits up to DEADLINE_S)."""
    import time
    t_end = time.monotonic() + DEADLINE_S
    while threading.active_count() > threads_before:
        if time.monotonic() > t_end:
            return False
        time.sleep(0.01)
    return True


class TestColumnarReaders:
    def test_csv_columnar_matches_the_jax_decoder(self, tmp_path):
        [p] = _write_csv_shards(tmp_path, n_shards=1, rows=(403,))
        got = list(csv_columnar_chunks(p, batch_records=100))
        want = list(j_csv_chunks(p, batch_records=100))
        assert len(got) == len(want) == -(-403 // 100)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in g:
                assert g[k].dtype == np.float32
                np.testing.assert_array_equal(g[k], w[k])
        recs = CSVReader(p).read()
        assert len(recs) == 403 and np.isnan(
            np.concatenate([c["x1"] for c in got])[0])

    def test_avro_columnar_matches_the_jax_decoder(self, tmp_path):
        p = str(tmp_path / "rows.avro")
        schema = {"type": "record", "name": "r", "fields": [
            {"name": "x", "type": "double"},
            {"name": "y", "type": ["null", "double"]},
            {"name": "tag", "type": "string"}]}
        write_avro_file(p, schema, [
            {"x": i / 7.0, "y": None if i % 5 == 0 else float(i),
             "tag": f"t{i}"} for i in range(300)])
        got = list(read_avro_columns(p, batch_records=128))
        assert got == list(j_avro_cols(p, batch_records=128))
        assert [len(c["x"]) for c in got] == [128, 128, 44]
        # not fixed-width: arrays=True decodes the same lists
        assert list(read_avro_columns(p, batch_records=128, arrays=True)) \
            == got

    @pytest.mark.parametrize("codec", ["null", "deflate"])
    def test_fixed_width_avro_block_decode(self, tmp_path, codec):
        schema = {"type": "record", "name": "r", "fields": [
            {"name": "x", "type": "float"}, {"name": "y", "type": "double"},
            {"name": "b", "type": "boolean"}]}
        rng = np.random.default_rng(3)
        n = 1000
        cols = {"x": rng.normal(size=n).astype(np.float32),
                "y": rng.normal(size=n), "b": rng.uniform(size=n) < 0.5}
        recs = [{"x": float(cols["x"][i]), "y": float(cols["y"][i]),
                 "b": bool(cols["b"][i])} for i in range(n)]
        one, blocks = str(tmp_path / "one.avro"), str(tmp_path / "b.avro")
        write_avro_file(str(tmp_path / "rec.avro"), schema, recs,
                        codec=codec)
        assert write_avro_columns(one, schema, cols, codec=codec) == n
        assert (tmp_path / "one.avro").read_bytes() \
            == (tmp_path / "rec.avro").read_bytes()
        write_avro_columns(blocks, schema, cols, codec=codec,
                           block_records=300)
        for path in (one, blocks):
            want = list(j_avro_cols(path, batch_records=128))
            got = list(read_avro_columns(path, batch_records=128,
                                         arrays=True))
            assert [len(c["x"]) for c in got] \
                == [len(c["x"]) for c in want]
            for g, w in zip(got, want):
                assert g["x"].dtype == np.float32 and g["b"].dtype == bool
                for k in ("x", "y", "b"):
                    assert g[k].tolist() == w[k]
        with pytest.raises(ValueError, match="int and long fields only"):
            write_avro_columns(one, {"type": "record", "name": "r",
                                     "fields": [{"name": "s",
                                                 "type": "string"}]},
                               {"s": ["a"]})

    @pytest.mark.parametrize("ids", ["counting", "runs", "random"])
    @pytest.mark.parametrize("codec", ["null", "deflate"])
    def test_varint_avro_block_decode(self, tmp_path, codec, ids):
        """Records with int / long fields (bench.py's streaming record:
        floats, then a long id): the block decoder's runs of one layout,
        its one-by-one walk and its gathered records give the JAX
        package's per-value decode, and the column writer
        write_avro_file's bytes."""
        schema = {"type": "record", "name": "r", "fields": [
            {"name": "x", "type": "float"}, {"name": "i", "type": "int"},
            {"name": "b", "type": "boolean"},
            {"name": "id", "type": "long"}]}
        rng = np.random.default_rng(11)
        n = 6000
        id_col = {
            "counting": np.arange(-3000, n - 3000, dtype=np.int64) * 5,
            "runs": np.repeat(rng.integers(-2**62, 2**62, size=n // 200),
                              200),
            "random": rng.integers(-2**63, 2**63 - 1, size=n,
                                   dtype=np.int64)}[ids]
        # a one-byte int where the ids come in runs, any int otherwise
        small = ids != "random"
        cols = {"x": rng.normal(size=n).astype(np.float32),
                "i": rng.integers(-60 if small else -2**31,
                                  60 if small else 2**31 - 1, size=n
                                  ).astype(np.int32),
                "b": rng.uniform(size=n) < 0.5, "id": id_col}
        recs = [{k: v[r].item() for k, v in cols.items()}
                for r in range(n)]
        rec, one = str(tmp_path / "rec.avro"), str(tmp_path / "one.avro")
        write_avro_file(rec, schema, recs, codec=codec)
        assert write_avro_columns(one, schema, cols, codec=codec) == n
        assert (tmp_path / "one.avro").read_bytes() \
            == (tmp_path / "rec.avro").read_bytes()
        blocks = str(tmp_path / "blocks.avro")
        write_avro_columns(blocks, schema, cols, codec=codec,
                           block_records=2500)
        for path in (one, blocks):
            want = list(j_avro_cols(path, batch_records=1024))
            got = list(read_avro_columns(path, batch_records=1024,
                                         arrays=True))
            assert [len(c["x"]) for c in got] \
                == [len(c["x"]) for c in want]
            for g, w in zip(got, want):
                assert g["i"].dtype == np.int32 \
                    and g["id"].dtype == np.int64
                for k in ("x", "i", "b", "id"):
                    assert g[k].tolist() == w[k]
        sub = list(read_avro_columns(blocks, fields=["id"],
                                     batch_records=4096, arrays=True))
        assert [list(c) for c in sub] == [["id"], ["id"]]
        np.testing.assert_array_equal(
            np.concatenate([c["id"] for c in sub]), id_col)

    def test_malformed_varint_blocks_raise(self, tmp_path):
        """A block whose varints run past 10 bytes or past its end, or
        that holds bytes beyond its records, raises AvroDecodeError."""
        from transmogrifai_tpu_torch.readers.avro import (
            AvroDecodeError, _flat_block, _segments)
        segs = _segments([("x", "float"), ("id", "long")])
        good = np.float32(1.5).tobytes() + bytes([0x02])
        assert _flat_block(good * 3, 3, segs, ["x", "id"])["id"].tolist() \
            == [1, 1, 1]
        for buf, count in ((good * 2 + b"\x00", 2),           # extra
                           (good * 2 + good[:4], 3),            # cut
                           (good + good[:4] + b"\xff" * 11, 2)):  # > 10
            with pytest.raises(AvroDecodeError):
                _flat_block(buf, count, segs, ["x", "id"])


def _chunk_factories(n_shards=3, chunk_rows=64, seed=0):
    rng = np.random.default_rng(seed)
    shards = [rng.normal(size=(n, 3)).astype(np.float32)
              for n in (400, 257, 311, 123)[:n_shards]]

    def factory_for(X):
        def factory():
            for s in range(0, X.shape[0], chunk_rows):
                yield (X[s:s + chunk_rows],)
        return factory

    return [factory_for(X) for X in shards], shards


class TestShardedSource:
    @pytest.mark.parametrize("workers", [2, 4])
    def test_parallel_stream_bitwise_equals_serial(self, workers):
        factories, _ = _chunk_factories()
        serial = list(ING.ShardedSource(factories, workers=1).chunks())
        par = list(ING.ShardedSource(factories, workers=workers).chunks())
        ref = list(JING.ShardedSource(factories, workers=workers).chunks())
        assert len(par) == len(serial) == len(ref)
        for (a,), (b,), (c,) in zip(serial, par, ref):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(b, c)

    def test_more_workers_than_cores_under_fast_switching(self):
        """A stress pass: 24 shards, 16 parse workers (more than this
        machine's cores), the interpreter switching threads every 10 us:
        the reassembled stream is still the serial one, chunk for chunk,
        and every worker has exited."""
        import sys
        rng = np.random.default_rng(7)
        shards = [rng.normal(size=(int(n), 2)).astype(np.float32)
                  for n in rng.integers(1, 200, size=24)]

        def factory_for(X):
            def factory():
                for s in range(0, X.shape[0], 17):
                    yield (X[s:s + 17],)
            return factory

        factories = [factory_for(X) for X in shards]
        serial = [c[0] for c in ING.ShardedSource(factories,
                                                  workers=1).chunks()]
        before = threading.active_count()
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for _ in range(3):
                par = [c[0] for c in ING.ShardedSource(
                    factories, workers=16, ahead=1).chunks()]
                assert len(par) == len(serial)
                for a, b in zip(serial, par):
                    np.testing.assert_array_equal(a, b)
        finally:
            sys.setswitchinterval(old)
        assert _join_all(before)

    def test_reiterable_fresh_pass(self):
        factories, _ = _chunk_factories()
        src = ING.ShardedSource(factories, workers=2)
        assert [c[0].sum() for c in src.chunks()] \
            == [c[0].sum() for c in src.chunks()]

    def test_worker_exception_is_failed_pass_not_hang(self):
        def bad():
            yield (np.ones((4, 2), np.float32),)
            raise RuntimeError("shard decode blew up")

        def good():
            for _ in range(5):
                yield (np.ones((4, 2), np.float32),)

        before = threading.active_count()
        src = ING.ShardedSource([good, bad, good], workers=2)
        with pytest.raises(RuntimeError, match="blew up"):
            list(src.chunks())
        assert _join_all(before)
        # the same crash through a tileplane pass, raised on its caller
        with pytest.raises(RuntimeError, match="blew up"):
            TP.run_tileplane(src, lambda c, x: c, None, tile_rows=8,
                             device=CPU)
        assert _join_all(before)

    def test_consumer_abandon_unblocks_workers(self):
        def big():
            for _ in range(50):
                yield (np.ones((8, 2), np.float32),)

        before = threading.active_count()
        it = ING.ShardedSource([big, big], workers=2, ahead=1).chunks()
        next(it)
        it.close()
        assert _join_all(before)

    def test_single_shard_degrades_to_serial(self):
        factories, _ = _chunk_factories(n_shards=1)
        src = ING.ShardedSource(factories, workers=8)
        assert src.effective_workers() == 1
        assert len(list(src.chunks())) == -(-400 // 64)

    def test_env_knob_and_explicit_workers_precedence(self, monkeypatch):
        factories, _ = _chunk_factories()
        monkeypatch.setenv("TMOG_INGEST_WORKERS", "2")
        assert ING.ShardedSource(factories).effective_workers() == 2
        assert ING.ShardedSource(factories,
                                 workers=1).effective_workers() == 1
        monkeypatch.setenv("TMOG_INGEST_WORKERS", "not-a-number")
        assert ING.ShardedSource(factories).effective_workers() == 1
        assert ING.ingest_workers() == 1

    def test_peek_does_not_spin_up_pool_or_consume(self):
        factories, shards = _chunk_factories()
        src = ING.ShardedSource(factories, workers=4)
        before = threading.active_count()
        first = src.peek()
        assert threading.active_count() == before
        np.testing.assert_array_equal(first[0], shards[0][:64])
        assert len(list(src.chunks())) == sum(
            -(-X.shape[0] // 64) for X in shards)

    def test_ingest_pass_record_and_per_worker_spans(self, traced,
                                                     tmp_path):
        import json
        log = tmp_path / "events.jsonl"
        traced.attach_event_log(str(log))
        try:
            factories, _ = _chunk_factories()
            list(ING.ShardedSource(factories, workers=2, label="t").chunks())
        finally:
            traced.detach_event_log()
        [rec] = traced.current.ingest_metrics
        assert rec.workers == 2 and rec.shards == 3
        assert rec.rows == 400 + 257 + 311
        assert traced.current.to_json()["ingest_metrics"][0]["rows"] \
            == rec.rows
        evs = [json.loads(v) for v in log.read_text().splitlines()]
        [ev] = [e for e in evs if e["event"] == "ingest_pass"]
        assert ev["workers"] == 2 and ev["rows"] == rec.rows
        spans = [s for s in traced.trace.spans if s.name == "tile_parse"]
        assert spans and all(s.kind == "tile" for s in spans)
        assert {s.attrs["worker"] for s in spans} == {0, 1}
        assert {s.attrs["lane"] for s in spans} == {"ingest-w0",
                                                    "ingest-w1"}

    def test_serial_pass_emits_same_telemetry_schema(self, traced):
        factories, _ = _chunk_factories(n_shards=1)
        list(ING.ShardedSource(factories, label="t1").chunks())
        [rec] = traced.current.ingest_metrics
        assert rec.workers == 1
        assert all(s.attrs["lane"] == "ingest-w0"
                   for s in traced.trace.spans if s.name == "tile_parse")

    def test_striping_raises(self, tmp_path):
        [p] = _write_csv_shards(tmp_path, n_shards=1, rows=(10,))
        with pytest.raises(NotImplementedError, match="A14"):
            ING.sharded_reader_source([p], lambda c: (c["y"],), stripe=True)
        with pytest.raises(NotImplementedError, match="A14"):
            FileStreamingReader(str(tmp_path / "*.csv"),
                                lambda q: CSVReader(q), stripe=True)


class TestPrefetchRing:
    def test_env_knob_precedence(self, monkeypatch):
        assert TP.tile_prefetch_depth() == 1
        monkeypatch.setenv("TMOG_TILE_PREFETCH", "3")
        assert TP.tile_prefetch_depth() == 3
        monkeypatch.setenv("TMOG_TILE_PREFETCH", "garbage")
        assert TP.tile_prefetch_depth() == 1

    def test_tileplane_pass_event_carries_depth(self, traced, tmp_path):
        import json
        import torch
        log = tmp_path / "events.jsonl"
        traced.attach_event_log(str(log))
        try:
            _, stats = TP.run_tileplane(
                TP.ArraySource(np.ones((500, 2), np.float32),
                               chunk_rows=100),
                lambda c, xt: c + xt.sum(), torch.zeros(()), tile_rows=128,
                label="ev", prefetch=2, device=CPU)
        finally:
            traced.detach_event_log()
        evs = [json.loads(v) for v in log.read_text().splitlines()]
        [ev] = [e for e in evs if e["event"] == "tileplane_pass"]
        assert ev["prefetch_depth"] == stats.prefetch_depth == 2
        assert ev["tiles"] == 4 and ev["rows"] == 500


class TestEndToEndParity:
    """statistics / GLM fit / tree binning over three CSV shards, bit for
    bit across workers {1, 2, 4} x prefetch {1, 3}, the serial pass held
    to the JAX package's."""

    D = 4

    def _sources(self, ING_, dirpath, workers):
        d = self.D

        def stats_cols(c):
            return (np.stack([c[f"x{j}"] for j in range(d)], 1),
                    c["y"], c["w"])

        def glm_cols(c):
            masks = np.stack([(c["fold"] != k).astype(np.float32)
                              for k in range(2)], 1)
            return (np.stack([c[f"x{j}"] for j in range(d)], 1),
                    c["y"], c["w"], masks)

        def tree_cols(c):
            return (np.stack([c[f"x{j}"] for j in range(d)], 1),)

        paths = sorted(glob.glob(os.path.join(str(dirpath), "*.csv")))
        # the row count sizes the tiles (else one tile of 2^20 rows, all
        # but 968 of them zero padding)
        return [ING_.sharded_reader_source(paths, fn, batch_records=256,
                                           workers=workers,
                                           n_rows=400 + 257 + 311)
                for fn in (stats_cols, glm_cols, tree_cols)]

    REGS = np.asarray([0.05, 0.2], np.float32)
    ALPHAS = np.asarray([0.0, 0.5], np.float32)
    GLM_KW = dict(loss="logistic", max_iter=8, tol=1e-6, warm_start=False)

    def _fingerprint(self, dirpath, workers, prefetch, monkeypatch):
        monkeypatch.setenv("TMOG_TILE_PREFETCH", str(prefetch))
        stats_src, glm_src, tree_src = self._sources(ING, dirpath, workers)
        res = PSE.run_stats(stats_src, tile_rows=256, device=CPU)
        B, b0, info = PGS.sweep_glm_streamed_rounds(
            glm_src, None, None, None, self.REGS, self.ALPHAS, device=CPU,
            **self.GLM_KW)
        assert info["driver"] == "tileplane"
        edges = PT.stream_quantile_edges(tree_src, 8, hist_bins=128,
                                         device=CPU)
        binned = PT.stream_bin_matrix(tree_src, edges, tile_rows=256,
                                      device=CPU)
        return (np.asarray(res.mean), np.asarray(res.m2), np.asarray(B),
                np.asarray(b0), np.asarray(edges), np.asarray(binned))

    def test_bit_identical_across_workers_and_prefetch(self, tmp_path,
                                                       monkeypatch):
        _write_csv_shards(tmp_path / "shards", d=self.D)
        ref = self._fingerprint(tmp_path / "shards", 1, 1, monkeypatch)
        for workers, prefetch in [(2, 1), (2, 3), (4, 1), (4, 3), (1, 3)]:
            got = self._fingerprint(tmp_path / "shards", workers, prefetch,
                                    monkeypatch)
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"workers={workers} prefetch={prefetch}")
        # the serial fingerprint against the JAX package's
        stats_src, glm_src, tree_src = self._sources(
            JING, tmp_path / "shards", 1)
        want = JSE.run_stats(stats_src, tile_rows=256)
        np.testing.assert_allclose(ref[0], want.mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ref[1], want.m2, rtol=1e-5, atol=1e-6)
        jB, jb0, _ = JGS.sweep_glm_streamed_rounds(
            glm_src, None, None, None, self.REGS, self.ALPHAS,
            **self.GLM_KW)
        np.testing.assert_allclose(ref[2], jB, rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(ref[3], jb0, rtol=5e-3, atol=5e-4)
        jedges = JT.stream_quantile_edges(tree_src, 8, hist_bins=128)
        np.testing.assert_array_equal(ref[4], jedges)
        np.testing.assert_array_equal(
            ref[5], JT.stream_bin_matrix(tree_src, jedges, tile_rows=256))


def test_sharded_avro_source_matches_the_jax_package(tmp_path):
    """Fixed-width Avro shards: the port decodes a block at a time, the
    JAX package a value at a time; the same chunks and statistics."""
    schema = {"type": "record", "name": "r", "fields": [
        {"name": f"x{j}", "type": "float"} for j in range(3)]
        + [{"name": "y", "type": "float"}]}
    rng = np.random.default_rng(5)
    paths = []
    for k, n in enumerate((700, 333, 512)):
        p = str(tmp_path / f"part-{k}.avro")
        write_avro_columns(p, schema, {
            **{f"x{j}": rng.normal(size=n).astype(np.float32)
               for j in range(3)},
            "y": (rng.uniform(size=n) < 0.3).astype(np.float32)},
            block_records=256)
        paths.append(p)

    def cols(c):
        return (np.stack([c[f"x{j}"] for j in range(3)], 1), c["y"],
                np.ones(len(c["y"]), np.float32))

    src = ING.sharded_reader_source(paths, cols, batch_records=200,
                                    workers=2, n_rows=1545)
    jsrc = JING.sharded_reader_source(paths, cols, batch_records=200,
                                      workers=2, n_rows=1545)
    for a, b in zip(src.chunks(), jsrc.chunks()):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    got = PSE.run_stats(src, corr_matrix=True, device=CPU)
    want = JSE.run_stats(jsrc, corr_matrix=True)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.corr_label, want.corr_label, rtol=1e-5,
                               atol=1e-6)
    assert PSE._last_stream_stats.rows == 1545


class TestShardOrderDeterminism:
    def _mk(self, dirpath, names, mtime=1_700_000_000):
        paths = []
        for n in names:
            p = os.path.join(str(dirpath), n)
            with open(p, "w") as fh:
                fh.write("c\n1\n")
            os.utime(p, (mtime, mtime))
            paths.append(p)
        return paths

    def _reader(self, tmp_path):
        return FileStreamingReader(str(tmp_path / "*.csv"),
                                   lambda p: CSVReader(p))

    def test_equal_mtimes_sort_lexicographic(self, tmp_path):
        self._mk(tmp_path, ["part-002.csv", "part-000.csv",
                            "part-001.csv"])
        got = [os.path.basename(p)
               for p in self._reader(tmp_path).snapshot_paths()]
        assert got == ["part-000.csv", "part-001.csv", "part-002.csv"]

    def test_mtime_order_beats_name_order(self, tmp_path):
        self._mk(tmp_path, ["part-000.csv"], mtime=1_700_000_100)
        self._mk(tmp_path, ["part-001.csv"], mtime=1_700_000_000)
        got = [os.path.basename(p)
               for p in self._reader(tmp_path).snapshot_paths()]
        assert got == ["part-001.csv", "part-000.csv"]

    def test_snapshot_paths_does_not_consume(self, tmp_path):
        self._mk(tmp_path, ["a.csv", "b.csv"])
        r = self._reader(tmp_path)
        assert r.snapshot_paths() == r.snapshot_paths()
        assert len(r.poll()) == 2

    def test_one_stat_pair_per_candidate_per_scan(self, tmp_path,
                                                  monkeypatch):
        self._mk(tmp_path, ["a.csv", "b.csv", "c.csv"])
        r = self._reader(tmp_path)
        calls = []
        real = os.stat

        def counting_stat(p, *a, **k):
            if str(p).endswith(".csv"):
                calls.append(str(p))
            return real(p, *a, **k)

        monkeypatch.setattr(
            "transmogrifai_tpu_torch.readers.streaming.os.stat",
            counting_stat)
        paths = r.snapshot_paths()
        assert len(paths) == 3
        assert sorted(calls) == sorted(paths * 2)
