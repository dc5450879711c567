"""Device memory of the config-fused boosted fit against its model.

    python -m transmogrifai_tpu_torch.tools.fit_memory [--rows 10000000]
        [--configs 8 2] [--depth 4 6] [--sites]

On one CUDA device, chip_smoke's tree-sweep data (N rows x 64 features,
32 bins + missing, 5 folds) goes through the estimator's grid-fused path
(`OpXGBoostClassifier.mask_fit_scores_grid`, 10 rounds) with the lane
planner pinned to each `--configs` chunk (8 configs = 40 lanes, 2 = 10).
For each fit: the bytes allocated at its start, its own peak above them
(`torch.cuda.reset_peak_memory_stats` at the start,
`max_memory_allocated` at the end), the part of it that is the fit's own
[F, N] copy of the bins, and `TK.fused_fit_resident_bytes` for the same
shape; for the group, the peak above the bytes allocated when the planner
was asked, against `TK.grid_fused_resident_bytes`. The caller's X and
binned matrix are reported apart. With `--sites`, the allocations alive at
each fit's peak are grouped by the line of the port that made them
(`torch.cuda.memory._record_memory_history`). Prints the card's name and
power limit, then one JSON line per (depth, chunk).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
from typing import Callable, Dict, List

_PKG = "transmogrifai_tpu_torch"


@contextlib.contextmanager
def measured_fits(store: List[dict]):
    """Inside the block, each `ops/trees.fit_gbt_folds` call and each
    answer of the lane planner is measured: a plan appends {"plan": ...,
    "allocated": bytes}, a fit {"lanes", "depth", "start", "peak"} with
    `peak` the fit's own peak above `start`, and each plan's entry gains
    `group_peak`, the peak above the bytes allocated at the plan, once its
    fits have run."""
    import torch
    from ..ops import tree_kernels as TK
    from ..ops import trees as T

    fit, plan = T.fit_gbt_folds, TK.plan_lane_chunk

    def planning(n_feat, n_bins, n_folds, n_configs, depth, n_rows, **kw):
        chunk = plan(n_feat, n_bins, n_folds, n_configs, depth, n_rows, **kw)
        torch.cuda.synchronize()
        store.append(dict(plan=dict(n_feat=n_feat, n_bins=n_bins,
                                    n_folds=n_folds, n_configs=n_configs,
                                    depth=depth, n_rows=n_rows, chunk=chunk),
                          allocated=torch.cuda.memory_allocated(),
                          group_peak=0))
        torch.cuda.reset_peak_memory_stats()
        return chunk

    def fitting(Xb, y, W, **kw):
        torch.cuda.synchronize()
        group_peak = torch.cuda.max_memory_allocated()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fit(Xb, y, W, **kw)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        store.append(dict(lanes=int(W.shape[0]), depth=int(kw["depth"]),
                          rows=int(W.shape[1]), n_feat=int(Xb.shape[1]),
                          n_bins=int(kw["n_bins"]) + 1,
                          xb_itemsize=Xb.element_size(),
                          start=start, peak=peak - start))
        plans = [e for e in store if "plan" in e]
        if plans:
            p = plans[-1]
            p["group_peak"] = max(p["group_peak"], group_peak - p["allocated"],
                                  peak - p["allocated"])
        torch.cuda.reset_peak_memory_stats()
        return out

    T.fit_gbt_folds, TK.plan_lane_chunk = fitting, planning
    try:
        yield store
    finally:
        T.fit_gbt_folds, TK.plan_lane_chunk = fit, plan


def n_sm() -> int:
    """Streaming multiprocessors of the current CUDA device."""
    import torch
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def modelled(entry: dict) -> int:
    """`fused_fit_resident_bytes` of a measured fit's shape on this card."""
    from ..ops import tree_kernels as TK
    return TK.fused_fit_resident_bytes(
        entry["rows"], entry["n_feat"], entry["lanes"], entry["depth"],
        entry["n_bins"], xb_itemsize=entry["xb_itemsize"], n_sm=n_sm())


def peak_sites(run: Callable[[], None], top: int = 12) -> Dict[str, list]:
    """Run `run` with the allocator's history on; replay its allocations
    and frees, and group the blocks alive at the highest point by the
    first line of this package in their stack (the tool's own frames
    skipped): {"peak": bytes above the start, "sites": [[site, bytes,
    blocks], ...]}, largest first."""
    import torch
    mem = torch.cuda.memory
    mem._record_memory_history(max_entries=1_000_000)
    try:
        run()
        torch.cuda.synchronize()
        snap = mem._snapshot()
    finally:
        mem._record_memory_history(enabled=None)
    trace = snap["device_traces"][torch.cuda.current_device()]
    frees = {"free_requested"} if any(
        e["action"] == "free_requested" for e in trace) else \
        {"free_completed"}
    live: Dict[int, int] = {}
    cur = peak = 0
    at = -1
    for i, e in enumerate(trace):
        if e["action"] == "alloc":
            live[e["addr"]] = i
            cur += e["size"]
            if cur > peak:
                peak, at = cur, i
        elif e["action"] in frees and e["addr"] in live:
            del live[e["addr"]]
            cur -= e["size"]
    alive: Dict[int, int] = {}
    for i, e in enumerate(trace[:at + 1]):
        if e["action"] == "alloc":
            alive[e["addr"]] = i
        elif e["action"] in frees:
            alive.pop(e["addr"], None)
    sites = collections.defaultdict(lambda: [0, 0])
    for i in alive.values():
        e = trace[i]
        frame = next((f for f in e.get("frames", ())
                      if _PKG in f["filename"]
                      and "fit_memory" not in f["filename"]), None)
        site = ("?" if frame is None else
                f"{frame['filename'].split(_PKG + '/')[-1]}:"
                f"{frame['line']} {frame['name']}")
        sites[site][0] += e["size"]
        sites[site][1] += 1
    ranked = sorted(([k, v[0], v[1]] for k, v in sites.items()),
                    key=lambda r: -r[1])
    return {"peak": peak, "sites": ranked[:top]}


def sweep_inputs(rows: int, seed: int):
    """chip_smoke's tree-sweep data on the card: (ctx, y, w, masks)."""
    import numpy as np
    import torch
    from ..automl.tuning.validators import CrossValidation
    from ..evaluators.evaluators import Evaluators
    from ..models.trees import OpXGBoostClassifier

    gen = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn((rows, 64), generator=gen, device="cuda")
    y = (torch.rand((rows,), generator=gen, device="cuda")
         < torch.sigmoid(X[:, :8].sum(dim=1) * 0.3)).float()
    for j in range(4):
        X[torch.rand((rows,), generator=gen, device="cuda") < 0.05, j] = \
            float("nan")
    ctx = OpXGBoostClassifier(max_bins=32).mask_sweep_context(X)
    x_bytes = X.numel() * X.element_size()
    del X
    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(),
                         num_folds=5)
    masks = torch.as_tensor(cv.fold_masks(y.cpu().numpy().astype(np.float64)),
                            device="cuda")
    return ctx, y, torch.ones_like(y), masks, x_bytes


def grid(depth: int) -> list:
    """The 8 configs of one depth of chip_smoke's XGBoost grid."""
    return [dict(num_round=10, max_depth=depth, eta=e, reg_lambda=lam,
                 max_bins=32)
            for e in (0.05, 0.1, 0.2, 0.3) for lam in (1.0, 5.0)]


def measure(ctx, y, w, masks, depth: int, chunk: int,
            sites: bool = False) -> dict:
    """One group of 8 configs at `depth` through the grid-fused path with
    the planner pinned to `chunk` configs a fit."""
    import torch
    from ..models.trees import OpXGBoostClassifier
    from ..ops import tree_kernels as TK

    store: List[dict] = []
    plan = TK.plan_lane_chunk
    TK.plan_lane_chunk = lambda *a, **k: chunk
    try:
        def run():
            with measured_fits(store):
                OpXGBoostClassifier().mask_fit_scores_grid(
                    ctx, y, w, masks, grid(depth))
        attributed = peak_sites(run) if sites else None
        if not sites:
            run()
    finally:
        TK.plan_lane_chunk = plan
    torch.cuda.empty_cache()
    fits = [e for e in store if "lanes" in e]
    group = next(e for e in store if "plan" in e)
    p = group["plan"]
    n_folds = int(masks.shape[0])
    out = dict(depth=depth, chunk=chunk, lanes=chunk * n_folds,
               rows=fits[0]["rows"], fits=len(fits),
               start_gb=[f["start"] / 1e9 for f in fits],
               fit_peak_gb=max(f["peak"] for f in fits) / 1e9,
               model_gb=modelled(fits[0]) / 1e9,
               bins_copy_gb=fits[0]["rows"] * fits[0]["n_feat"]
               * fits[0]["xb_itemsize"] / 1e9,
               group_peak_gb=group["group_peak"] / 1e9,
               group_model_gb=TK.grid_fused_resident_bytes(
                   p["n_rows"], p["n_feat"], chunk, n_folds, p["n_configs"],
                   depth, p["n_bins"], xb_itemsize=fits[0]["xb_itemsize"],
                   n_sm=n_sm()) / 1e9)
    out["model_over_fit_peak"] = out["model_gb"] / out["fit_peak_gb"]
    out["group_model_over_group_peak"] = (out["group_model_gb"]
                                          / out["group_peak_gb"])
    if attributed is not None:
        out["history_peak_gb"] = attributed["peak"] / 1e9
        out["sites"] = [[s, b / 1e9, n] for s, b, n in attributed["sites"]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--configs", type=int, nargs="+", default=[8, 2])
    ap.add_argument("--depth", type=int, nargs="+", default=[4, 6])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sites", action="store_true",
                    help="group the blocks alive at each peak by the line "
                    "that made them")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("fit_memory: CUDA is not available", file=sys.stderr)
        return 2
    from . import hist_paths as HP
    print(HP.card_line(), flush=True)
    ctx, y, w, masks, x_bytes = sweep_inputs(args.rows, args.seed)
    xb = ctx[0]
    print(json.dumps(dict(x_gb=x_bytes / 1e9,
                          binned_gb=xb.numel() * xb.element_size() / 1e9)),
          flush=True)
    for depth in args.depth:
        for chunk in args.configs:
            print(json.dumps(measure(ctx, y, w, masks, depth, chunk,
                                     sites=args.sites)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
