"""Wall of the streamed statistics pass over a host matrix.

    python -m transmogrifai_tpu_torch.tools.stats_pass [--rows 10000000]
        [--cols 164] [--reps 3] [--trees DIR ...]

On one CUDA device: a float32 [rows, cols] host matrix of standard normals
and a 0/1 label, made from `--seed` (the default is the size of
workflow-main's transmogrified matrix in chip_smoke.py, over
`ops/stats_engine.STREAM_THRESHOLD_BYTES`, so `run_stats` takes its
streamed route); `run_stats(X, y, distinct=[0, 1], corr_matrix=True)`
once to warm up, then `--reps` times, each wall ending with the result on
the host. With `--trees`, each DIR (a checkout that holds this package,
say an older commit's) runs the same measurement in a process of its
own, in the order given, so that two versions compare within one call.
Prints the card's name and power limit, then one JSON line a run.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def measure(root: str, rows: int, cols: int, reps: int, seed: int) -> dict:
    """The walls of `reps` streamed passes with the package under `root`."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    from transmogrifai_tpu_torch.ops import stats_engine as SE
    rng = np.random.default_rng(seed)
    X = np.empty((rows, cols), np.float32)
    step = 1 << 20
    for s in range(0, rows, step):
        X[s:s + step] = rng.standard_normal((min(step, rows - s), cols),
                                            dtype=np.float32)
    y = (rng.random(rows) < 0.3).astype(np.float32)
    walls, res = [], None
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        res = SE.run_stats(X, y, distinct=np.array([0.0, 1.0]),
                           corr_matrix=True)
        walls.append(time.perf_counter() - t0)
    return dict(root=root, rows=rows, cols=cols,
                driver=SE.last_pass.get("driver"),
                tiles=SE.last_pass.get("tiles"), warmup_s=walls[0],
                walls_s=walls[1:], mean_s=sum(walls[1:]) / reps,
                gb_per_s=X.nbytes / 1e9 / (sum(walls[1:]) / reps),
                mean_sum=float(np.sum(res.mean)),
                corr_label_sum=float(np.nansum(res.corr_label)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--cols", type=int, default=164)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trees", nargs="*", default=None)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.root is not None:
        print(json.dumps(measure(a.root, a.rows, a.cols, a.reps, a.seed)),
              flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rc = 0
    for tree in a.trees or [here]:
        # run as a script, so that only `tree`'s package is imported
        rc |= subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--root", tree,
             "--rows", str(a.rows), "--cols", str(a.cols),
             "--reps", str(a.reps), "--seed", str(a.seed)]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
