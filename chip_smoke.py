#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (transmogrifai_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full check, as run on an H100
    python3 chip_smoke.py --rows 2000000 --configs 4   # a shorter run

Phases, each of which fails the run on error:

1. device  — a CUDA device must be present; prints the card's name and
             power limit as nvidia-smi reports them;
2. build   — compiles csrc/tree_kernels.cu with nvcc (seconds), prints
             ptxas's registers and spills and, from cuobjdump's SASS, the
             shared-memory atomics of each kernel;
3. kernels — each of the four kernels at every shape the main path gives
             it (hist_folds at the root, with uniform and skewed bins, and
             at the rank-metric shape; route_hist at S = 1..16; route at 8
             and 32 nodes, and at 32 with one split table shared by the
             lanes; table_lookup at 16 and 64 leaves; route and
             table_lookup at 2M and 10M rows) against its plain PyTorch
             version on the same inputs (stated tolerance), with its time
             (CUDA events, warm, median), the kernel's rows path (the
             row-mapped kernels) timed in turns beside the chosen path
             (old, new, new, old), the plain version's time, one library
             call's time where one computes the same function, its bound
             on this card and, for the histograms, the shared-memory floor
             (one read and one write per add, 32 lanes a clock per SM), for
             route and table_lookup the time of a device copy of the lane
             plane they read and write (the card's streaming floor);
4. small   — a small CV sweep on the CPU (plain versions) and on the GPU
             (kernels): same winner, per-cell AuPR within 5e-3;
5. main    — the model selector's tree sweep at full width: 5-fold
             CrossValidation over the 16-config XGBoost grid (depth {4, 6}
             x eta {.05, .1, .2, .3} x lambda {1, 5}, 10 rounds, 32 bins)
             on `--rows` x 64 features, then the refit of the winner and
             its scoring. Launch counters (per kernel and per kernel
             shape) are reset just before and read just after; every
             kernel must have launched, route and table_lookup at the
             shapes of every depth swept;
6. profile — the winner's 5-fold cell under torch.profiler: device time by
             kernel (and of each of the port's kernels) and the device's
             busy share; it must see device time.

The last three lines of standard output are {"kernels": [...]}, the
card's name and power limit, and {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when CUDA is unavailable or the package is
not beside this script.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
FP32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
SOURCE = "transmogrifai_tpu_torch/csrc/tree_kernels.cu"
KERNEL_ROWS = 2_000_000       # rows of the per-kernel checks and timings
LANE_ROWS = 10_000_000        # route and table_lookup also at the main
#                               path's rows
SEED = 0
REPLACES = {   # the Pallas kernel body each CUDA kernel replaces
    "hist_folds": "transmogrifai_tpu/ops/pallas_hist.py:395",
    "route_hist": "transmogrifai_tpu/ops/pallas_hist.py:713",
    "route": "transmogrifai_tpu/ops/pallas_hist.py:598",
    "table_lookup": "transmogrifai_tpu/ops/pallas_hist.py:866",
}
XGB_GRID = [dict(num_round=10, max_depth=d, eta=e, reg_lambda=lam,
                 max_bins=32)
            for d in (4, 6) for e in (0.05, 0.1, 0.2, 0.3) for lam in (1.0, 5.0)]


def log(msg: str) -> None:
    print(msg, flush=True)


def bound(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smem_floor_ms(n_adds: float) -> float:
    """The least time a shared-memory histogram needs for n_adds adds: one
    read and one write of a 4-byte cell each, 32 lanes a clock on each SM
    at the card's maximum SM clock (nvidia-smi)."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * n_adds / (n_sm * 32 * mhz * 1e6) * 1e3


def kernel_phase(seed: int):
    """Each kernel against its plain version at every shape the main path
    gives it, on `HP.kernel_inputs` at N = 2M rows (every shape) and 10M
    (route and table_lookup, as the main path runs them): F = 64, B = 33
    (32 bins + missing), Fo = 5 fold lanes; hist_folds at the tree root
    (uniform and skewed bins) and at the rank-metric shape (F = 1, 4096
    buckets, the 5 lanes in the slot axis), route_hist at S = 1, 2, 4, 8,
    16, route at the last level (8 and 32 nodes, and 32 with one split
    table shared by the lanes) and the 16- and 64-leaf lookups. Every
    kernel is timed in turns against its rows path (the row-mapped
    kernels: old, new, new, old)."""
    from transmogrifai_tpu_torch.tools import hist_paths as HP
    import torch

    d = HP.kernel_inputs(KERNEL_ROWS, seed)
    out = kernel_rows(d, HP.hist_shapes(d) + HP.lane_shapes(d))
    del d
    torch.cuda.empty_cache()
    d = HP.kernel_inputs(LANE_ROWS, seed, hist=False)
    out += kernel_rows(d, HP.lane_shapes(d))
    del d
    torch.cuda.empty_cache()
    return out


def kernel_rows(d: dict, shapes: list) -> list:
    """One result row per shape of `shapes` on the inputs `d`."""
    import torch
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    from transmogrifai_tpu_torch.tools import hist_paths as HP

    N, F, B, Fo = d["N"], d["F"], d["B"], d["Fo"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count

    def nz(t):   # data-dependent work: nonzero payload entries
        return float((t != 0).sum())

    # library yardsticks, built when timed (their ids/weights take GBs)
    library = {
        "tree root": lambda a: _bincount_hist(a[0], a[1], F, B, Fo, 1,
                                              derive_count=True),
        "rank metric": lambda a: _bincount_hist(a[0], a[1], 1, d["RB"], 1,
                                                d["L"], slot=a[2]),
        "leaves": lambda a: lambda: torch.where(
            (a[1] >= 0) & (a[1] < a[0].shape[1]),
            torch.gather(a[0], 1, a[1].long().clamp(0, a[0].shape[1] - 1)),
            0.0),
    }
    rows_out = []
    for label, name, S, args, kw in shapes:
        n_adds = moved = None
        if name == "route_hist":    # rows a level histograms: left rows
            left = (HP.plain("route", (d["Xb"], *args[2:]), {})
                    == 2 * args[2]).float()
            n_bytes = TK.kernel_bytes("route_hist", F, N, Fo,
                                      out_cells=Fo * S * 3 * F * B)
            n_adds = F * (nz(d["g"] * left) + 2 * nz(d["h"] * left))
            n_ops = n_adds + 4 * Fo * N
            del left
        elif label.startswith("rank"):
            n_bytes = TK.kernel_bytes("hist_folds", 1, d["L"] * N, 1,
                                      xb_itemsize=4,
                                      out_cells=d["L"] * 2 * d["RB"])
            n_ops = n_adds = nz(d["rpay"])
        elif name == "hist_folds":
            n_bytes = TK.kernel_bytes("hist_folds", F, N, Fo,
                                      out_cells=Fo * 3 * F * B)
            n_ops = n_adds = F * (nz(d["g"]) + 2 * nz(d["h"]))
        elif name == "route":       # compares, select, multiply-add a lane
            n_bytes = TK.kernel_bytes(
                "route", F, N, Fo, bins_read=HP.route_bins_read(args[1],
                                                                args[2]))
            n_ops = 4 * Fo * N
            # what the staged path moves: the node planes and a row of bins
            # of every feature some lane's table splits on
            moved = TK.kernel_bytes("route", F, N, Fo, bins_read=N * int(
                torch.unique(args[2]).numel()))
        else:                       # a compare and a select a lane
            n_bytes = TK.kernel_bytes("table_lookup", 1, N, Fo)
            n_ops = 2 * Fo * N
        dispatch = getattr(TK, name)
        got = dispatch(*args, **kw)
        torch.cuda.synchronize()
        want = HP.plain(name, args, kw)
        err = HP.max_abs_err(got, want)
        ok = HP.agrees(name, got, want, args, kw)
        if name in ("route", "table_lookup"):
            tol = "exact"
        elif "rank" in label:     # 0/1 weights: integer sums are exact
            tol = "exact (integer payloads)"
        else:
            # both sides sum up to ~N/B f32 terms per cell in different
            # orders: hold each cell to 1e-4 of its sum of |terms| (about
            # 7 sqrt(n) ulps at n = 60K terms); the derived count channel
            # and the node ids are exact
            tol = ("g/h cells within 1e-4 of the cell's sum of |terms| "
                   "(f32 sums in another order); counts exact"
                   + ("; node ids exact" if name == "route_hist" else ""))
        del got, want
        torch.cuda.empty_cache()
        path = HP.planner(name, S, args, kw, n_sm)[0]().path
        turns = {}
        for p in ("rows", None, None, "rows"):
            turns.setdefault(p, []).append(HP.cuda_ms(
                lambda: dispatch(*args, **kw, path=p), reps=7))
        ms = statistics.mean(turns[None])
        earlier_ms = statistics.mean(turns["rows"])
        plain_ms = HP.cuda_ms(lambda: HP.plain(name, args, kw), reps=3)
        make_lib = library.get(label.split(":")[0].split(",")[0])
        library_ms = None
        if make_lib is not None:
            library_ms = HP.cuda_ms(make_lib(args), reps=5)
        # the streaming floor of route and table_lookup on this card: a
        # device-to-device copy of the lane plane they read and write
        copy_ms = (HP.cuda_ms(args[1].clone, reps=7)
                   if name in ("route", "table_lookup") else None)
        b_ms, b_by = bound(n_bytes, n_ops)
        key_f = 1 if name == "table_lookup" else args[0].shape[0]
        row = dict(name=name, shape=f"{label} N={args[1].shape[1]}",
                   route="cuda", source=SOURCE, replaces=REPLACES[name],
                   launches=None, max_abs_err=err, tolerance=tol, ok=ok,
                   ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=library_ms, path=path, earlier_ms=earlier_ms,
                   smem_floor_ms=n_adds and smem_floor_ms(n_adds),
                   copy_ms=copy_ms, moved_bytes=moved,
                   key=f"{name} F={key_f} S={S}")
        log(f"kernel {name} [{row['shape']}]: err={err:.3g} ok={ok} "
            f"ms={ms:.4f} earlier_ms={earlier_ms:.4f} ({path} vs rows) "
            f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
            f"smem_floor_ms={row['smem_floor_ms']} copy_ms={copy_ms} "
            f"library_ms={library_ms}")
        rows_out.append(row)
        torch.cuda.empty_cache()
    return rows_out


def _bincount_hist(Xb_t, pay, F, B, lanes, n_slots, slot=None,
                   derive_count=False):
    """One torch.bincount per (lane, channel) over precomputed (slot,
    feature, bin) ids — the library yardstick for the histogram kernel
    (the ids and weights are built outside the timed call)."""
    import torch
    N = Xb_t.shape[1]
    C = pay.shape[0] // lanes
    base = torch.arange(F, device=Xb_t.device)[:, None] * B + Xb_t.long()
    if slot is not None:
        base = base + slot.long() * (F * B)
    ids = base.reshape(-1)
    chans = [pay[k * C + c] for k in range(lanes) for c in range(C)]
    if derive_count:
        chans += [(pay[k * C + C - 1] > 0).float() for k in range(lanes)]
    weights = [c.expand(F, N).reshape(-1) for c in chans]
    size = n_slots * F * B

    def run():
        return [torch.bincount(ids, weights=w, minlength=size)
                for w in weights]
    return run


def make_data(rows: int, seed: int, n_feat: int = 64, dev: str = "cuda"):
    """Seeded binary data on the device: a nonlinear label, random missing
    values in a few columns and values missing when large in one (so the
    missing bin and the learned missing direction carry signal)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((rows, n_feat), generator=gen, device=dev)
    beta = torch.randn((8,), generator=gen, device=dev)
    logit = (X[:, :8] @ beta * 0.6 + 0.8 * X[:, 8] * X[:, 9]
             + torch.sin(2.0 * X[:, 10]) + 1.2 * (X[:, 12] > 1.0).float()
             - 1.0)
    y = (torch.rand((rows,), generator=gen, device=dev)
         < torch.sigmoid(logit)).float()
    for j in range(4):
        X[torch.rand((rows,), generator=gen, device=dev) < 0.05, j] = \
            float("nan")
    X[X[:, 12] > 1.5, 12] = float("nan")
    return X, y


def small_phase(seed: int):
    """The same sweep on a small input, CPU plain versions vs GPU kernels."""
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

    X, y = make_data(20_000, seed + 1, n_feat=16)
    grids = [dict(g, num_round=4) for g in XGB_GRID[::4]]
    out = {}
    for dev in ("cpu", "cuda"):
        cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                             num_folds=3, device=dev)
        best = cv.validate([(OpXGBoostClassifier(device=dev), grids)],
                           X.to(dev), y.to(dev))
        out[dev] = best
    torch.cuda.synchronize()
    diffs = [abs(a.mean_metric - b.mean_metric)
             for a, b in zip(out["cpu"].validated, out["cuda"].validated)]
    same = out["cpu"].best_grid == out["cuda"].best_grid
    log(f"small: winner cpu={out['cpu'].best_grid} cuda={out['cuda'].best_grid}"
        f" max |dAuPR|={max(diffs):.3g}")
    return same and max(diffs) < 5e-3, max(diffs)


def main_phase(rows: int, n_configs: int, seed: int, dev=None):
    import torch
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    from transmogrifai_tpu_torch.ops import metrics_ops as M
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    t0 = time.perf_counter()
    X, y = make_data(rows, seed, dev=dev or "cuda")
    torch.cuda.synchronize()
    prevalence = float(y.mean())
    log(f"main: data {rows} x {X.shape[1]} made in "
        f"{time.perf_counter() - t0:.2f}s, prevalence {prevalence:.4f}")
    grids = XGB_GRID[:n_configs]
    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5, device=dev)
    torch.cuda.reset_peak_memory_stats()
    TK.reset_launches()
    t0 = time.perf_counter()
    best = cv.validate([(OpXGBoostClassifier(device=dev), grids)], X, y)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = best.estimator.fit_arrays(X, y)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pred, raw, prob = model.predict_arrays(X)
    score_s = time.perf_counter() - t0
    launches = dict(TK.launches)
    shape_launches = dict(TK.shape_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    train_aupr = float(M.au_pr(torch.as_tensor(prob[:, 1], device=y.device),
                               y))
    res = dict(rows=rows, features=int(X.shape[1]), folds=5,
               configs=len(grids), sweep_s=sweep_s, refit_s=refit_s,
               score_s=score_s, winner=best.best_grid,
               winner_cv_aupr=best.best_metric, refit_train_aupr=train_aupr,
               prevalence=prevalence, peak_mem_gb=peak_gb,
               launches=launches, shape_launches=shape_launches,
               cells={json.dumps(v.grid, sort_keys=True): v.mean_metric
                      for v in best.validated})
    log("main: " + json.dumps(res))
    # the last level's route and the leaf lookup of every depth swept
    depths = {g["max_depth"] for g in grids}
    shapes = ([f"route F={X.shape[1]} S={1 << (dp - 1)}" for dp in depths]
              + [f"table_lookup F=1 S={1 << dp}" for dp in depths])
    ok = (all(n > 0 for n in launches.values())
          and all(shape_launches.get(k, 0) > 0 for k in shapes)
          and prob.shape == (rows, 2) and raw.shape == (rows, 2)
          and pred.shape == (rows,)
          and bool(torch.isfinite(torch.as_tensor(prob)).all())
          and best.best_metric > prevalence + 0.1
          and train_aupr > prevalence + 0.1)
    return ok, launches, shape_launches, (X, y, best.best_grid)


def profile_phase(X, y, grid) -> bool:
    """Where one sweep cell's time goes: the winner's 5-fold cell (fit of
    all folds + fold metrics) once unprofiled and warm, then under
    torch.profiler: device time by kernel and the device's busy share of
    the cell's wall (the profiler's host overhead lowers that share).
    False when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from transmogrifai_tpu_torch.automl.tuning.validators import \
        CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)

    def cell():
        cv.validate([(OpXGBoostClassifier(), [dict(grid)])], X, y)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    cell()
    warm_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cell()
        prof_s = time.perf_counter() - t0
    per = {}
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total", 0) or 0
        if dt > 0:
            per[ev.key] = (dt / 1e3, ev.count)
    busy = sum(ms for ms, _ in per.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    ours = sorted((kv for kv in per.items()
                   if re.search(r"(hist|route|lookup)\w*_kernel", kv[0])),
                  key=lambda kv: -kv[1][0])
    fit_bytes = TK.fused_fit_bytes(X.shape[0], X.shape[1], 5,
                                   grid["max_depth"], grid["num_round"])
    log("profile: " + json.dumps(dict(
        cell=grid, warm_wall_s=warm_s, profiled_wall_s=prof_s,
        device_busy_ms=busy, busy_share=busy / (prof_s * 1e3),
        fit_bytes=fit_bytes, fit_bound_ms=bound(fit_bytes, 0)[0],
        top=[dict(kernel=k[:80], ms=ms, calls=n, share=ms / busy)
             for k, (ms, n) in top],
        port_kernels=[dict(kernel=k[:80], ms=ms, calls=n, share=ms / busy)
                      for k, (ms, n) in ours])))
    return busy > 0


def sass_phase(lib_path: str) -> None:
    """Shared-memory atomics in the built kernels, from the SASS: how many
    ATOMS instructions of each kind each kernel holds (a CAS loop shows as
    ATOMS.CAST.SPIN / ATOMS.CAS, a native add as ATOMS.ADD)."""
    from transmogrifai_tpu_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        log("sass: not measured (no cuobjdump beside nvcc)")
        return
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : \S*?(\w+_kernel)(\w*)", line)
        if m:
            fn = m.group(1) + m.group(2)[:12]
            counts[fn] = {}
            continue
        m = re.search(r"\b(ATOMS\.[A-Z0-9.]+)", line)
        if m and fn:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    log("sass: " + json.dumps(counts, sort_keys=True))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000,
                    help="rows of the main-path sweep (>= 2M keeps the "
                    "binned rank-metric kernel on the path)")
    ap.add_argument("--configs", type=int, default=16,
                    help="XGBoost grid points swept (of 16)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from transmogrifai_tpu_torch.device import resolve_device
    from transmogrifai_tpu_torch.ops import _build
    from transmogrifai_tpu_torch.tools import hist_paths as HP

    resolve_device()
    t_start = time.perf_counter()
    card = HP.card_line()
    log(f"device: {card} ({torch.cuda.get_device_name(0)}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    lib = _build.library()
    log(f"build: {time.perf_counter() - t0:.2f}s")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    sass_phase(lib._name)

    failures = []
    rows = kernel_phase(SEED)
    failures += [f"kernel {r['name']} ({r['shape']})" for r in rows
                 if not r.pop("ok")]
    small_ok, _ = small_phase(SEED)
    if not small_ok:
        failures.append("small CPU/GPU sweep disagreement")
    main_ok, launches, shape_launches, (X, y, winner) = main_phase(
        args.rows, args.configs, SEED)
    if not main_ok:
        failures.append("main path")
    if not profile_phase(X, y, winner):
        failures.append("profile: no device time")
    del X, y
    for r in rows:
        r["launches"] = shape_launches.get(r.pop("key"), 0)
    log(f"total: {time.perf_counter() - t_start:.1f}s")
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
