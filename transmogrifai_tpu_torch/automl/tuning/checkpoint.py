"""Sweep checkpoint/resume (counterpart of automl/tuning/checkpoint.py).

The reference has no mid-sweep recovery (Spark task retry is its whole
failure story); the model-selection sweep checkpoints so a preempted run
resumes without refitting finished (model x grid) cells — deterministic
replay comes from the seeded fold assignment (Validator._assign_folds)
plus this record.

Format: JSON-lines, one record per validated (model, grid) with its fold
metrics, keyed by a stable hash of (model class, grid, folds, seed,
stratify, metric). Atomic append (write + flush) keeps partial lines out.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional


def data_fingerprint(X, y) -> str:
    """Cheap, stable fingerprint of the sweep's training data: shape plus a
    hash of the label vector and a strided feature sample. Folded into
    sweep_key so a checkpoint file reused after the data changes invalidates
    instead of silently replaying stale fold metrics. X and y may be numpy
    arrays or tensors on any device: only the sampled rows are copied to
    the host (a bf16 sweep matrix's as f32: numpy has no bf16; the sweep's
    path tag keeps the dtypes' cells apart)."""
    import numpy as np

    def host(a):
        if not hasattr(a, "cpu"):
            return np.asarray(a)
        a = a.cpu()
        return (a.float() if str(a.dtype) == "torch.bfloat16" else a).numpy()

    h = hashlib.sha256()
    h.update(str(tuple(X.shape)).encode())
    h.update(np.ascontiguousarray(host(y[:65536])).tobytes())
    stride = max(1, X.shape[0] // 1024)
    h.update(np.ascontiguousarray(host(X[::stride][:1024])).tobytes())
    return h.hexdigest()[:16]


def sweep_key(model_class: str, grid: Dict[str, Any], n_folds: int,
              seed: int, stratify: bool, metric: str,
              data_fp: str = "", base_params: Optional[Dict[str, Any]] = None,
              path: str = "") -> str:
    payload = json.dumps(
        {"model": model_class, "grid": {k: grid[k] for k in sorted(grid)},
         "folds": n_folds, "seed": seed, "stratify": stratify,
         "metric": metric, "data": data_fp,
         # compute path + its statistically relevant knobs (e.g.
         # "mask_folds" vs "sequential" tree fits, sweep dtype) — metrics
         # from different paths are not interchangeable
         "path": path,
         "base": {k: base_params[k] for k in sorted(base_params)}
         if base_params else {}},
        sort_keys=True, default=str)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


class RoundCheckpoint:
    """Round-granular state of a convergence-aware streamed GLM sweep
    (ops/glm_sweep.sweep_glm_streamed_rounds): retired-lane coefficients +
    active-lane state persisted after EVERY retirement boundary, so a
    preempted streamed sweep resumes at the last finished round instead of
    restarting the whole family. Finer-grained than SweepCheckpoint's
    (model x grid) cells — those only land once every fold metric of a
    cell exists, which for the streamed route means the entire fit.

    One .npz per sweep path (atomic tmp+replace), keyed by the sweep's
    cell keys + solver knobs: a mismatched key is IGNORED (fresh start),
    never replayed — the key already folds in the data fingerprint, fold
    masks, estimator base params and compute path via sweep_key."""

    _META_SCALARS = ("rounds", "data_passes", "lane_passes",
                     "padded_lane_passes", "warmed")
    _META_LISTS = ("active_per_round", "iters_per_round", "bucket_sizes")
    _ARRAYS = ("B", "b0", "delta", "iters", "retired")

    def __init__(self, path: str):
        self.path = path

    def load(self, key: str) -> Optional[Dict[str, Any]]:
        import numpy as np

        if not os.path.exists(self.path):
            return None
        try:
            with np.load(self.path, allow_pickle=False) as z:
                if str(z["key"]) != key:
                    return None
                state: Dict[str, Any] = {k: z[k].copy()
                                         for k in self._ARRAYS}
                meta = json.loads(str(z["meta"]))
            for k in self._META_SCALARS:
                state[k] = meta[k]
            for k in self._META_LISTS:
                state[k] = list(meta[k])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            return None  # torn/foreign/schema-drifted file — refit
            # rather than trust it (a matching key from an older code
            # revision can still lack current meta fields)
        return state

    def save(self, key: str, state: Dict[str, Any]) -> None:
        import numpy as np

        meta = {k: state[k] for k in self._META_SCALARS}
        meta.update({k: [int(v) for v in state[k]]
                     for k in self._META_LISTS})
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, key=np.str_(key), meta=np.str_(json.dumps(meta)),
                     **{k: np.asarray(state[k]) for k in self._ARRAYS})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def clear(self) -> None:
        """Remove the state file once the sweep completed (its results now
        live in the cell-level SweepCheckpoint records)."""
        try:
            os.remove(self.path)
        except OSError:
            pass


class SweepCheckpoint:
    """Append-only record of finished sweep cells."""

    def __init__(self, path: str):
        self.path = path
        self._done: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                        self._done[rec["key"]] = rec
                    except (json.JSONDecodeError, KeyError):
                        continue  # torn tail line from a crash — ignore

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        return self._done.get(key)

    def record(self, key: str, model_name: str, grid: Dict[str, Any],
               fold_metrics: List[float], metric_name: str) -> None:
        rec = {"key": key, "model_name": model_name, "grid": grid,
               "fold_metrics": fold_metrics, "metric_name": metric_name}
        self._done[key] = rec
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def __len__(self) -> int:
        return len(self._done)
