"""Time every path of the tree kernels at the sweep's shapes.

    python -m transmogrifai_tpu_torch.tools.hist_paths [--rows 2000000]
        [--bins 33] [--kernels all|hist|lanes]

On one CUDA device, at N rows, F = 64 features, B = 33 bins (32 + missing),
5 fold lanes and int8 bins (the main path's shapes; --bins 257 gives the
estimator's default of 256 bins, int32): `hist_folds` at the
tree root (uniform and skewed bins) and at the rank-metric shape (F = 1,
4096 buckets, 5 lanes in the slot axis), `route_hist` at S = 1, 2, 4, 8,
16, `route` at 8 and 32 nodes (and 32 with one split table shared by the
lanes), `table_lookup` at 16 and 64 leaves. Each path that fits the shape
(`TK.PATHS`, `TK.ROUTE_PATHS` or `TK.LOOKUP_PATHS`) is checked once
against the plain version and timed in turns, forward then backward
(CUDA events, median of 5 after a warm-up, each turn). Prints the card's
name and power limit, then one JSON line per shape; with --out, writes the
lines to that file too. `chip_smoke.py` uses the same inputs.
"""
from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, warm: int = 1) -> float:
    """Median wall of `fn` on the device, CUDA events around each run."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_inputs(rows: int, seed: int, dev: str = "cuda",
                  n_bins: int = 33, hist: bool = True) -> dict:
    """Seeded inputs at the main path's shapes: bins [64, N] (int8 for the
    default 33 bins, uint8 up to 256, int32 beyond, as the binning
    chooses) with 5% in the missing bin 0, node planes and split tables
    for S = 1..32 nodes (each lane's table drawn apart, and at 32 nodes
    also one table shared by every lane), and 16- and 64-leaf tables with
    their ids; with `hist`, also the same bins with 90% of every feature's
    rows in bin 0 (skewed), g/h payloads of 5 lanes (20% held-out rows with
    g = 0, the hessian clamped above 0), root slots and the rank-metric
    counts' inputs."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, F, B, Fo = rows, 64, n_bins, 5
    dtype = (torch.int8 if B <= 128 else
             torch.uint8 if B <= 256 else torch.int32)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def tables(lanes, S):
        return [torch.randint(0, hi, (lanes, S), generator=gen, device=dev,
                              dtype=torch.int32) for hi in (F, B, 2)]

    Xb = torch.randint(1, B, (F, N), generator=gen, device=dev, dtype=dtype)
    Xb[rand(F, N) < 0.05] = 0
    out = dict(N=N, F=F, B=B, Fo=Fo, Xb=Xb)
    for S in (1, 2, 4, 8, 16, 32):
        out[f"node{S}"] = torch.randint(0, S, (Fo, N), generator=gen,
                                        device=dev).float()
        out[f"tables{S}"] = tables(Fo, S)
    out["tables32_shared"] = [t.expand(Fo, 32).contiguous()
                              for t in tables(1, 32)]
    for M in (16, 64):
        out[f"leaf{M}"] = torch.randn((Fo, M), generator=gen, device=dev)
        out[f"leaf_idx{M}"] = torch.randint(0, M, (Fo, N), generator=gen,
                                            device=dev).float()
    if not hist:
        return out
    Xskew = Xb.clone()
    Xskew[rand(F, N) < 0.9] = 0
    keep = (rand(Fo, N) >= 0.2).float()
    g = (rand(Fo, N) - 0.5) * keep
    h = torch.clamp(rand(Fo, N) * 0.25, min=1e-12)
    out.update(Xskew=Xskew, g=g, h=h,
               pay=torch.stack([g, h], 1).reshape(2 * Fo, N).contiguous(),
               slot0=torch.zeros((Fo, N), device=dev))
    L, RB = 5, 4096
    lab = (rand(1, L * N) < 0.3).float()
    held = (rand(1, L * N) < 0.2).float()
    out.update(
        L=L, RB=RB,
        ridx=torch.randint(0, RB, (1, L * N), generator=gen, device=dev,
                           dtype=torch.int32),
        rpay=torch.cat([held * lab, held * (1 - lab)]).contiguous(),
        rlane=torch.arange(L, device=dev, dtype=torch.float32)
        .repeat_interleave(N)[None, :].contiguous())
    return out


def hist_shapes(d: dict) -> list:
    """(label, kernel, S, args, kwargs) of each histogram shape of the
    main path, on the inputs of `kernel_inputs`."""
    B = d["B"]
    shapes = [
        (f"tree root: F=64 B={B} Fo=5 S=1", "hist_folds", 1,
         (d["Xb"], d["pay"], d["slot0"]),
         dict(n_slots=1, n_bins=B, derive_count=True)),
        (f"tree root, skewed bins: F=64 B={B} Fo=5 S=1", "hist_folds", 1,
         (d["Xskew"], d["pay"], d["slot0"]),
         dict(n_slots=1, n_bins=B, derive_count=True)),
        ("rank metric: F=1 B=4096 S=5 lanes", "hist_folds", d["L"],
         (d["ridx"], d["rpay"], d["rlane"]),
         dict(n_slots=d["L"], n_bins=d["RB"])),
    ]
    for S in (1, 2, 4, 8, 16):
        shapes.append((f"level S={S}: F=64 B={B} Fo=5", "route_hist", S,
                       (d["Xb"], d["pay"], d[f"node{S}"], *d[f"tables{S}"]),
                       dict(n_nodes=S, n_bins=B, derive_count=True)))
    return shapes


def lane_shapes(d: dict) -> list:
    """(label, kernel, S, args, kwargs) of each route and table_lookup
    shape of the main path: the last level's routing at 8 nodes (depth-4
    trees) and 32 (depth 6), with each lane's split table drawn apart and,
    at 32 nodes, one table shared by every lane (as sibling folds mostly
    split alike), and the leaf lookups of 16 and 64 leaves."""
    F, Fo = d["F"], d["Fo"]
    shapes = []
    for S, tables in ((8, "tables8"), (32, "tables32"),
                      (32, "tables32_shared")):
        shared = ", shared tables" if tables.endswith("shared") else ""
        shapes.append((f"last level {S} nodes{shared}: F={F} Fo={Fo}",
                       "route", S, (d["Xb"], d[f"node{S}"], *d[tables]),
                       dict(n_nodes=S)))
    for M in (16, 64):
        shapes.append((f"leaves: Fo={Fo} M={M}", "table_lookup", M,
                       (d[f"leaf{M}"], d[f"leaf_idx{M}"]), {}))
    return shapes


def planner(name: str, S: int, args, kw, n_sm: int):
    """(plan, paths) of one shape: its kernel's launch planner as a function
    of the forced path (None: the planner's choice), and the kernel's
    paths."""
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    if name == "route":
        F, N = args[0].shape
        return functools.partial(
            TK.plan_route, F, S, args[1].shape[0], N, n_sm,
            itemsize=args[0].element_size()), TK.ROUTE_PATHS
    if name == "table_lookup":
        return functools.partial(TK.plan_lookup, S, args[1].shape[0],
                                 args[1].shape[1], n_sm), TK.LOOKUP_PATHS
    F, N = args[0].shape
    return functools.partial(
        TK.plan_hist, F, S, 2 + int(kw.get("derive_count", False)),
        kw["n_bins"], args[2].shape[0], N, n_sm,
        itemsize=args[0].element_size(),
        route=name == "route_hist"), TK.PATHS


def plain(name: str, args, kw):
    """The kernel's plain version on the same inputs."""
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    if name in ("route", "table_lookup"):
        kw = {}
    return TK.PLAIN[name](*args, **_plain_kw(kw))


def route_bins_read(node, f_lvl) -> int:
    """Distinct (feature, row) bins a route reads: each row's split features
    over the lanes, counted once each."""
    import torch
    f = torch.gather(f_lvl, 1, node.long()).sort(dim=0).values
    return int(f.shape[1] + (f[1:] != f[:-1]).sum())


def agrees(name: str, got, want, args, kw) -> bool:
    """g/h cells within 1e-4 of the cell's sum of |terms| (f32 sums in
    another order); the derived counts, integer payloads, node ids and
    looked-up values exact."""
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    if name in ("route", "table_lookup"):
        return torch_equal(got, want)
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    if not kw.get("derive_count"):       # 0/1 weights: integer sums
        return bool(torch_equal(got_t[0], want_t[0]))
    abs_args = (args[0], args[1].abs(), *args[2:])
    scale = TK.PLAIN[name](*abs_args, **_plain_kw(kw))
    scale = scale[0] if isinstance(scale, tuple) else scale
    ok = bool(((got_t[0] - want_t[0]).abs() <= 1e-4 * scale + 1e-6).all())
    cnt = [t.reshape(-1, 3, t.shape[-1])[:, 2] for t in (got_t[0], want_t[0])]
    ok = ok and torch_equal(*cnt)
    if name == "route_hist":
        ok = ok and torch_equal(got_t[1], want_t[1])
    return ok


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))


def _plain_kw(kw: dict) -> dict:
    return {k: v for k, v in kw.items() if k != "path"}


def max_abs_err(got, want) -> float:
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    return max(float((a - b).abs().max()) for a, b in zip(got_t, want_t))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bins", type=int, default=33,
                    help="histogram bins B (max_bins + 1)")
    ap.add_argument("--kernels", choices=("all", "hist", "lanes"),
                    default="all", help="the histogram kernels, route and "
                    "table_lookup (lanes), or both")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hist_paths: CUDA is not available", file=sys.stderr)
        return 2
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    card = card_line()
    print(card, flush=True)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    d = kernel_inputs(args.rows, args.seed, n_bins=args.bins,
                      hist=args.kernels != "lanes")
    shapes = ((hist_shapes(d) if args.kernels != "lanes" else [])
              + (lane_shapes(d) if args.kernels != "hist" else []))
    lines, ok_all = [], True
    for label, name, S, a, kw in shapes:
        fn = getattr(TK, name)
        plan, paths = planner(name, S, a, kw, n_sm)
        tilings = {}
        for path in paths:
            try:
                tilings[path] = plan(path=path)
            except ValueError:    # the path does not fit this shape
                continue
        default = plan().path
        want = plain(name, a, kw)
        res = {}
        for path, tl in tilings.items():
            got = fn(*a, **kw, path=path)
            torch.cuda.synchronize()
            res[path] = dict(ok=agrees(name, got, want, a, kw),
                             max_abs_err=max_abs_err(got, want),
                             tiling=tl.__dict__, ms=[])
            del got
        del want
        torch.cuda.empty_cache()
        order = list(tilings)
        for turn in order + order[::-1]:
            res[turn]["ms"].append(
                cuda_ms(lambda: fn(*a, **kw, path=turn)))
        ok_all = ok_all and all(r["ok"] for r in res.values())
        line = json.dumps(dict(shape=f"{label} N={a[1].shape[1]}",
                               kernel=name, default=default, card=card,
                               paths=res))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
