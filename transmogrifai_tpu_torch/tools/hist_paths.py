"""Time every path of the tree kernels at the sweep's shapes.

    python -m transmogrifai_tpu_torch.tools.hist_paths [--rows 2000000]
        [--bins 33] [--kernels all|hist|lanes|deep|roots]

On one CUDA device, at N rows, F = 64 features, B = 33 bins (32 + missing),
5 fold lanes and int8 bins (the main path's shapes; --bins 257 gives the
estimator's default of 256 bins, int32): `hist_folds` at the
tree root (uniform and skewed bins) and at the rank-metric shape (F = 1,
4096 buckets, 5 lanes in the slot axis), `route_hist` at S = 1, 2, 4, 8,
16, `route` at 8 and 32 nodes (and 32 with one split table shared by the
lanes), `table_lookup` at 16 and 64 leaves; `--kernels deep` takes the
shapes of a depth-12 tree instead (`deep_shapes`, a forest's and a boosted
fit's), `--kernels roots` the one-slot histograms (`root_shapes`: both
kernels at S = 1 over F = 64, 164, 512, B = 33, 65 and 2 or 3 payload
channels + the count), `--kernels levels` route_hist below the root at
the workflows' widths (`level_shapes`: F = 164, 650, 48 at 257 bins, and
op_iris's 8), `--kernels small` route_hist at 135 to 262 144 rows
(`small_shapes`: where the sorted path starts to pay). Each path that
fits the shape
(`TK.PATHS`, `TK.ROUTE_PATHS` or `TK.LOOKUP_PATHS`) is checked once
against the plain version (`accuracy`) and timed in turns, forward
then backward (CUDA events, median of 5 after a warm-up, each turn).
Prints the card's name and power limit, then one JSON line per shape;
with --out, writes the lines to that file too. `chip_smoke.py` uses the
same inputs.
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
    out.update(rank_inputs(gen, N, 5, dev))
    return out


def rank_inputs(gen, rows: int, lanes: int, dev: str = "cuda") -> dict:
    """The rank-metric counts' inputs of `lanes` lanes over `rows` rows,
    drawn from `gen`: bucket ids in [0, 4096), 0/1 positive and negative
    weights (30% positives, 20% held out) and each entry's lane; the tree
    sweep scores 5 fold lanes at once, the GLM sweep a grid chunk of 8."""
    import torch
    L, RB, N = lanes, 4096, rows
    lab = (torch.rand((1, L * N), generator=gen, device=dev) < 0.3).float()
    held = (torch.rand((1, L * N), generator=gen, device=dev) < 0.2).float()
    return dict(
        L=L, RB=RB,
        ridx=torch.randint(0, RB, (1, L * N), generator=gen, device=dev,
                           dtype=torch.int32),
        rpay=torch.cat([held * lab, held * (1 - lab)]).contiguous(),
        rlane=torch.arange(L, device=dev, dtype=torch.float32)
        .repeat_interleave(N)[None, :].contiguous())


DEEP_FEATURES = 164      # the Workflow entry's vector in the workflow phase
DEEP_NODES = (32, 256, 1024)
ROOT_FEATURES = (64, 164, 512)
ROOT_BINS = (33, 65)


def root_shapes(rows: int, seed: int, dev: str = "cuda") -> list:
    """(label, kernel, S, args, kwargs) of the one-slot histograms: the
    root (`hist_folds`) and the first route_hist (S = 1) of a tree at
    every F of ROOT_FEATURES and B of ROOT_BINS, with a forest's payload
    (3 channels a lane) and a boosted fit's (2), on `deep_inputs`-style
    seeded inputs: 5 lanes, int8 bins with 5% missing."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, Fo, F_max = rows, 5, max(ROOT_FEATURES)
    y = (torch.rand((N,), generator=gen, device=dev) < 0.3).float()
    w = torch.poisson(torch.ones((Fo, N), device=dev), generator=gen)
    p = torch.rand((Fo, N), generator=gen, device=dev)
    pays = {3: torch.stack([w * (1 - y), w * y, w], 1),
            2: torch.stack([p - y, p * (1 - p)], 1)}
    pays = {C: t.reshape(C * Fo, N).contiguous() for C, t in pays.items()}
    node = torch.zeros((Fo, N), device=dev)
    shapes = []
    for B in ROOT_BINS:
        Xb = torch.randint(1, B, (F_max, N), generator=gen, device=dev,
                           dtype=torch.int8)
        Xb[torch.rand((F_max, N), generator=gen, device=dev) < 0.05] = 0
        for F in ROOT_FEATURES:
            tables = [torch.randint(0, hi, (Fo, 1), generator=gen,
                                    device=dev, dtype=torch.int32)
                      for hi in (F, B, 2)]
            for C, pay in pays.items():
                hkw = dict(n_bins=B, derive_count=True)
                tag = f"F={F} B={B} Fo={Fo} C={C}+1"
                shapes.append((f"root: {tag} S=1", "hist_folds", 1,
                               (Xb[:F], pay, node), dict(hkw, n_slots=1)))
                shapes.append((f"level S=1: {tag}", "route_hist", 1,
                               (Xb[:F], pay, node, *tables),
                               dict(hkw, n_nodes=1)))
    return shapes


LEVEL_SHAPES = (   # (F, B, lanes, payload channels, S...) of route_hist
    (164, 33, 5, 3, (2, 8, 32, 128, 512, 1024)),   # workflow-main's forest
    (164, 33, 5, 2, (2, 32, 1024)),                # and boosted levels
    (650, 33, 3, 3, (2, 4, 16)),                   # workflow-wide's
    (48, 257, 21, 2, (2, 4)),                      # multiclass XGBoost
    (8, 33, 6, 3, (64, 1024)),                     # op_iris (a lane: 2)
)


def level_shapes(rows: int, seed: int, dev: str = "cuda") -> list:
    """(label, kernel, S, args, kwargs) of route_hist below the root at the
    workflows' widths (LEVEL_SHAPES; op_iris's at 135 rows, whatever
    `rows`): seeded bins (int8 up to 128 bins, int32 beyond, 5% missing),
    payloads as `deep_inputs` draws them, node ids uniform over the level,
    and the bins row-major (`xb_rows`) as a fit passes them."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = []
    for F, B, Fo, C, levels in LEVEL_SHAPES:
        N = 135 if F == 8 else rows
        Xb = torch.randint(1, B, (F, N), generator=gen, device=dev,
                           dtype=torch.int8 if B <= 128 else torch.int32)
        Xb[torch.rand((F, N), generator=gen, device=dev) < 0.05] = 0
        w = torch.poisson(torch.ones((Fo, N), device=dev), generator=gen)
        y = (torch.rand((N,), generator=gen, device=dev) < 0.3).float()
        p = torch.rand((Fo, N), generator=gen, device=dev)
        pay = (torch.stack([w * (1 - y), w * y, w], 1) if C == 3 else
               torch.stack([p - y, p * (1 - p)], 1)).reshape(C * Fo, N)
        rows_t = Xb.T.contiguous()
        for S in levels:
            node = torch.randint(0, S, (Fo, N), generator=gen,
                                 device=dev).float()
            tables = [torch.randint(0, hi, (Fo, S), generator=gen,
                                    device=dev, dtype=torch.int32)
                      for hi in (F, B, 2)]
            shapes.append((f"level S={S}: F={F} B={B} Fo={Fo} C={C}+1",
                           "route_hist", S,
                           (Xb, pay.contiguous(), node, *tables),
                           dict(n_nodes=S, n_bins=B, derive_count=True,
                                xb_rows=rows_t)))
    return shapes


SMALL_ROWS = (135, 1_000, 4_000, 16_000, 64_000, 262_144)


def small_shapes(seed: int, dev: str = "cuda") -> list:
    """(label, kernel, S, args, kwargs) of route_hist where few rows make
    each launch short: F = 8 and 164, S = 8 and 256, at each of SMALL_ROWS
    rows (3 lanes, 3 payload channels + the count, 33 bins, int8), seeded
    as `level_shapes`, with the row-major bins (`xb_rows`)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = []
    Fo, B = 3, 33
    for F in (8, 164):
        for N in SMALL_ROWS:
            Xb = torch.randint(0, B, (F, N), generator=gen, device=dev,
                               dtype=torch.int8)
            pay = torch.rand((3 * Fo, N), generator=gen, device=dev)
            for S in (8, 256):
                node = torch.randint(0, S, (Fo, N), generator=gen,
                                     device=dev).float()
                tables = [torch.randint(0, hi, (Fo, S), generator=gen,
                                        device=dev, dtype=torch.int32)
                          for hi in (F, B, 2)]
                shapes.append((f"level S={S}: F={F} B={B} Fo={Fo} C=3+1",
                               "route_hist", S, (Xb, pay, node, *tables),
                               dict(n_nodes=S, n_bins=B, derive_count=True,
                                    xb_rows=Xb.T.contiguous())))
    return shapes


def deep_inputs(rows: int, seed: int, dev: str = "cuda") -> dict:
    """Seeded inputs at the shapes of a depth-12 forest tree of the
    selector's default grids (F = 164, B = 33, 5 fold lanes, int8 bins with
    5% missing): a binary forest's payload of 3 channels a lane (the two
    class sums and the weight: Poisson(1) bootstrap weights times the fold
    mask, 20% held out), a boosted fit's of 2 (`gpay`: the logistic
    gradient and hessian at random margins, the hessian of held-out rows
    clamped to 1e-12 as fit_gbt_folds clamps it) and, for route_hist at S = 32, 256 and 1024 slots,
    route at 2048 nodes and table_lookup over 4096 leaves, node planes
    drawn uniformly over the level's nodes with each lane's split tables
    drawn apart; `Xrows` holds the bins row-major, as a fit passes them to
    route_hist (`xb_rows`)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    N, F, B, Fo = rows, DEEP_FEATURES, 33, 5

    def tables(S):
        return [torch.randint(0, hi, (Fo, S), generator=gen, device=dev,
                              dtype=torch.int32) for hi in (F, B, 2)]

    Xb = torch.randint(1, B, (F, N), generator=gen, device=dev,
                       dtype=torch.int8)
    Xb[torch.rand((F, N), generator=gen, device=dev) < 0.05] = 0
    y = (torch.rand((N,), generator=gen, device=dev) < 0.3).float()
    w = torch.poisson(torch.ones((Fo, N), device=dev), generator=gen) * (
        torch.rand((Fo, N), generator=gen, device=dev) >= 0.2).float()
    pay = torch.stack([w * (1 - y), w * y, w], 1).reshape(3 * Fo, N)
    mask = (w > 0).float()
    p = torch.rand((Fo, N), generator=gen, device=dev)
    gpay = torch.stack([mask * (p - y), torch.clamp(mask * p * (1 - p),
                                                    min=1e-12)], 1)
    out = dict(N=N, F=F, B=B, Fo=Fo, Xb=Xb, Xrows=Xb.T.contiguous(),
               pay=pay.contiguous(),
               gpay=gpay.reshape(2 * Fo, N).contiguous(),
               slot0=torch.zeros((Fo, N), device=dev))
    for S in (*DEEP_NODES, 2048):
        out[f"node{S}"] = torch.randint(0, S, (Fo, N), generator=gen,
                                        device=dev).float()
        out[f"tables{S}"] = tables(S)
    out["leaf4096"] = torch.rand((Fo, 4096), generator=gen, device=dev)
    out["leaf_idx4096"] = torch.randint(0, 4096, (Fo, N), generator=gen,
                                        device=dev).float()
    return out


def deep_shapes(d: dict, boosted: bool = False) -> list:
    """(label, kernel, S, args, kwargs) of the depth-12 forest shapes on the
    inputs of `deep_inputs`: the root histogram, route_hist at each of
    DEEP_NODES, the last level's route and the leaf lookup. With `boosted`,
    the histograms of a boosted fit instead (2 payload channels + the
    count: the root and route_hist at DEEP_NODES)."""
    F, B, Fo = d["F"], d["B"], d["Fo"]
    hkw = dict(n_bins=B, derive_count=True)
    fit, pay, C = ("boosted", d["gpay"], 2) if boosted \
        else ("forest", d["pay"], 3)
    shapes = [(f"{fit} root: F={F} B={B} Fo={Fo} C={C}+1 S=1", "hist_folds",
               1, (d["Xb"], pay, d["slot0"]), dict(hkw, n_slots=1))]
    for S in DEEP_NODES:
        shapes.append((f"{fit} level S={S}: F={F} B={B} Fo={Fo} C={C}+1",
                       "route_hist", S,
                       (d["Xb"], pay, d[f"node{S}"], *d[f"tables{S}"]),
                       dict(hkw, n_nodes=S, xb_rows=d["Xrows"])))
    if boosted:
        return shapes
    shapes.append((f"forest last level 2048 nodes: F={F} Fo={Fo}", "route",
                   2048, (d["Xb"], d["node2048"], *d["tables2048"]),
                   dict(n_nodes=2048)))
    shapes.append((f"forest leaves: Fo={Fo} M=4096", "table_lookup", 4096,
                   (d["leaf4096"], d["leaf_idx4096"]), {}))
    return shapes


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
        rank_shape(d),
    ]
    for S in (1, 2, 4, 8, 16):
        shapes.append((f"level S={S}: F=64 B={B} Fo=5", "route_hist", S,
                       (d["Xb"], d["pay"], d[f"node{S}"], *d[f"tables{S}"]),
                       dict(n_nodes=S, n_bins=B, derive_count=True)))
    return shapes


def rank_shape(d: dict, label: str = "rank metric") -> tuple:
    """(label, kernel, S, args, kwargs) of the rank-metric counts on the
    inputs of `rank_inputs` (in `d`)."""
    return (f"{label}: F=1 B={d['RB']} S={d['L']} lanes", "hist_folds",
            d["L"], (d["ridx"], d["rpay"], d["rlane"]),
            dict(n_slots=d["L"], n_bins=d["RB"]))


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
        TK.plan_hist, F, S, hist_channels(args, kw),
        kw["n_bins"], args[2].shape[0], N, n_sm,
        itemsize=args[0].element_size(),
        route=name == "route_hist"), TK.PATHS


def hist_channels(args, kw) -> int:
    """Channels Co of a histogram launch's cells: the payload channels a
    lane (pay_t rows over the lanes of the slot or node plane) plus the
    derived count."""
    return args[1].shape[0] // args[2].shape[0] + int(
        kw.get("derive_count", False))


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


def reference(name: str, args, kw):
    """The float64 sums that the histogram kernels' f32 cells are held to:
    the plain version on the float64 payload (route_hist: with the plain
    route's node ids). Route and table_lookup are exact already: their
    plain version."""
    if name in ("hist_folds", "route_hist"):
        args = (args[0], args[1].double()) + tuple(args[2:])
    return plain(name, args, kw)


def accuracy(name: str, got, want, args, kw) -> dict:
    """A kernel's result `got` against its plain version `want` (float32,
    on the same inputs). Route, table_lookup and the integer-payload
    counts (the rank metric) must equal it. For the g/h histograms, both
    are held to the float64 sums (`reference`): each cell's error over the
    cell's sum of |terms| — `rel_err` for the kernel, `plain_rel_err` for
    the plain version — and the kernel's may not exceed 1e-4 or the plain
    version's own, whichever is larger: a cell of many near-equal terms
    (the first tree's root) loses digits to f32 in either; the derived
    counts and node ids are exact. Returns {"ok", "max_abs_err" (against
    `want`), "rel_err", "plain_rel_err"}."""
    import torch
    out = dict(max_abs_err=max_abs_err(got, want), rel_err=None,
               plain_rel_err=None)
    if name in ("route", "table_lookup"):
        return dict(out, ok=torch_equal(got, want))
    got_t = got if isinstance(got, tuple) else (got,)
    want_t = want if isinstance(want, tuple) else (want,)
    if not kw.get("derive_count"):       # 0/1 weights: integer sums
        return dict(out, ok=torch_equal(got_t[0], want_t[0]))
    exact = reference(name, args, kw)
    exact = exact[0] if isinstance(exact, tuple) else exact
    scale = reference(name, (args[0], args[1].abs(), *args[2:]), kw)
    scale = scale[0] if isinstance(scale, tuple) else scale

    def rel(h):
        err = (h.double() - exact).abs()
        r = torch.where(scale > 0, err / scale.clamp(min=1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
        return float(r.max())
    out.update(rel_err=rel(got_t[0]), plain_rel_err=rel(want_t[0]))
    Co = hist_channels(args, kw)
    cnt = [t.reshape(-1, Co, t.shape[-1])[:, Co - 1]
           for t in (got_t[0], want_t[0])]
    ok = (out["rel_err"] <= max(1e-4, out["plain_rel_err"])
          and torch_equal(*cnt))
    if name == "route_hist":
        ok = ok and torch_equal(got_t[1], want_t[1])
    return dict(out, ok=ok)


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
    ap.add_argument("--kernels",
                    choices=("all", "hist", "lanes", "deep", "roots",
                             "levels", "small"),
                    default="all", help="the histogram kernels, route and "
                    "table_lookup (lanes), both, the depth-12 shapes (deep: "
                    "F = 164, 3 or 4 channels, S up to 1024), the "
                    "one-slot histograms (roots), route_hist below the "
                    "root at the workflows' widths (levels) or at 135 to "
                    "262 144 rows (small; --rows is ignored)")
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
    if args.kernels == "deep":
        d = deep_inputs(args.rows, args.seed)
        shapes = deep_shapes(d) + deep_shapes(d, boosted=True)
    elif args.kernels == "roots":
        shapes = root_shapes(args.rows, args.seed)
    elif args.kernels == "levels":
        shapes = level_shapes(args.rows, args.seed)
    elif args.kernels == "small":
        shapes = small_shapes(args.seed)
    else:
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
            res[path] = dict(accuracy(name, got, want, a, kw),
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
