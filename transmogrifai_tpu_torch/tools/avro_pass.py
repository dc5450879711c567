"""Rows/s of streamed passes over Avro shards, by record layout.

    python -m transmogrifai_tpu_torch.tools.avro_pass [--rows 2000000]
        [--workers 4] [--reps 3] [--device cuda]

Writes the same rows, made from `--seed`, twice as Avro shards of 250 000
rows in blocks of 65 536 records: once as bench.py's streaming record (16
float columns, a float label, a long id; bench.py:1144-1147) and once with
the id as a float, so that every field is fixed-width. For each layout, in
turns (long, float, float, long, ...), it times a parse-only pass (the
chunks of `parallel.ingest.sharded_reader_source` with `--workers` parse
workers, decoded by `read_avro_columns(arrays=True)`) and a statistics pass
(`ops.stats_engine.run_stats` of that source on `--device`). Prints the
card's name and power limit, then one JSON line a pass.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

_SLAB, _BLOCK, _COLS = 250_000, 65_536, 16


def write_shards(root: str, rows: int, seed: int, id_type: str) -> list:
    """The rows as Avro shards with the id as `id_type` ("long" or
    "float"); slab k draws from the (seed, k) stream."""
    import numpy as np
    from ..readers.avro import write_avro_columns
    names = [f"x{j}" for j in range(_COLS)]
    schema = {"type": "record", "name": "Row", "fields": [
        {"name": nm, "type": "float"} for nm in names + ["y"]]
        + [{"name": "id", "type": id_type}]}
    beta = np.random.default_rng(seed).normal(size=_COLS)
    paths = []
    for k, start in enumerate(range(0, rows, _SLAB)):
        n = min(_SLAB, rows - start)
        rng = np.random.default_rng([seed, k])
        X = rng.normal(size=(n, _COLS)).astype(np.float32)
        cols = {nm: X[:, j] for j, nm in enumerate(names)}
        cols["y"] = (X @ beta > 0).astype(np.float32)
        ids = np.arange(start, start + n, dtype=np.int64)
        cols["id"] = ids if id_type == "long" else ids.astype(np.float32)
        p = os.path.join(root, f"{id_type}_{k:04d}.avro")
        write_avro_columns(p, schema, cols, block_records=_BLOCK)
        paths.append(p)
    return paths


def source(paths: list, rows: int, workers: int):
    """(x, y, w) chunks of the shards; the id is decoded and dropped."""
    import numpy as np
    from ..parallel.ingest import sharded_reader_source

    def cols(c):
        return (np.stack([c[f"x{j}"] for j in range(_COLS)], 1), c["y"],
                np.ones(len(c["y"]), np.float32))

    return sharded_reader_source(paths, cols, batch_records=_BLOCK,
                                 workers=workers, n_rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    from ..ops import stats_engine as SE
    if a.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    root = tempfile.mkdtemp(prefix="avro_pass_")
    try:
        shards = {t: write_shards(root, a.rows, a.seed, t)
                  for t in ("long", "float")}
        order = ["long", "float", "float", "long"] * a.reps
        for i, t in enumerate(order[:2 * a.reps]):
            src = source(shards[t], a.rows, a.workers)
            t0 = time.perf_counter()
            n = sum(c[0].shape[0] for c in src.chunks())
            parse_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            SE.run_stats(src, corr_matrix=True, device=a.device)
            stats_s = time.perf_counter() - t0
            print(json.dumps(dict(
                id_type=t, turn=i, rows=n, workers=a.workers,
                parse_s=parse_s, parse_rows_per_s=n / parse_s,
                stats_s=stats_s, stats_rows_per_s=n / stats_s,
                disk_mb=sum(os.path.getsize(p) for p in shards[t]) / 1e6)),
                flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
