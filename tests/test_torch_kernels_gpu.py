"""The port's CUDA tree kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode). This file imports neither jax nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.ops import tree_kernels as TK

N, F, B, LANES, NODES = 5000, 7, 33, 3, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dtype):
    rng = np.random.default_rng(5)
    Xb_t = rng.integers(0, B, size=(F, N)).astype(dtype)
    pay = rng.normal(size=(2 * LANES, N)).astype(np.float32)
    pay[1::2] = np.where(rng.uniform(size=(LANES, N)) < 0.2, 0.0,
                         np.abs(pay[1::2]) + 0.1)      # hessian channel
    slot = rng.integers(0, NODES + 2, size=(LANES, N)).astype(np.float32)
    node = rng.integers(0, NODES, size=(LANES, N)).astype(np.float32)
    tables = [rng.integers(0, hi, size=(LANES, NODES)).astype(np.int32)
              for hi in (F, B, 2)]
    tbl = rng.normal(size=(LANES, 16)).astype(np.float32)
    idx = rng.integers(-2, 19, size=(LANES, N)).astype(np.float32)
    return {"hist_folds": ((Xb_t, pay, slot),
                           dict(n_slots=NODES, n_bins=B, derive_count=True)),
            "route_hist": ((Xb_t, pay, node, *tables),
                           dict(n_nodes=NODES, n_bins=B, derive_count=True)),
            "route": ((Xb_t, node, *tables), dict(n_nodes=NODES)),
            "table_lookup": ((tbl, idx), {})}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32])
@pytest.mark.parametrize("name", TK.KERNELS)
def test_cuda_kernel_matches_plain(cuda_device, name, dtype):
    args, kw = _inputs(dtype)[name]
    plain_kw = kw if name in ("hist_folds", "route_hist") else {}
    cpu = TK.PLAIN[name](*[torch.from_numpy(a) for a in args], **plain_kw)
    before = TK.launches[name]
    got = getattr(TK, name)(*[torch.from_numpy(a).to(cuda_device)
                              for a in args], **kw)
    torch.cuda.synchronize()
    assert TK.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    for g, c in zip(got, cpu):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-4)


def _hist_case(name, F, S, Fo, N, dtype, B=33, skew=False, seed=7):
    """Seeded inputs for one histogram launch: bins partly outside [0, B),
    slots partly outside [0, S) (hist_folds), 20% zero hessians, and with
    `skew` every row of feature 0 in one bin."""
    rng = np.random.default_rng(seed)
    lo = 0 if dtype == np.uint8 else -3
    Xb_t = rng.integers(lo, B + 3, size=(F, N)).astype(dtype)
    if skew:
        Xb_t[0] = 5
    pay = rng.normal(size=(2 * Fo, N)).astype(np.float32)
    pay[1::2] = np.where(rng.uniform(size=(Fo, N)) < 0.2, 0.0,
                         np.abs(pay[1::2]) + 0.1)      # hessian channel
    kw = dict(n_bins=B, derive_count=True)
    if name == "hist_folds":
        slot = rng.integers(-1, S + 2, size=(Fo, N)).astype(np.float32)
        return (Xb_t, pay, slot), dict(kw, n_slots=S)
    node = rng.integers(0, S, size=(Fo, N)).astype(np.float32)
    tables = [rng.integers(0, hi, size=(Fo, S)).astype(np.int32)
              for hi in (F, B, 2)]
    return (Xb_t, pay, node, *tables), dict(kw, n_nodes=S)


# (kernel, F, S, Fo, N, bin dtype, path the planner must choose, skew):
# N = 3001 leaves int8/uint8 rows unaligned to 4 bytes, N = 5000 does not;
# neither is a multiple of a staged row tile.
HIST_CASES = [
    ("hist_folds", 64, 1, 5, 5000, np.int8, "private", False),
    ("hist_folds", 64, 1, 1, 3001, np.uint8, "private", False),
    ("hist_folds", 64, 1, 5, 5000, np.int8, "private", True),
    ("hist_folds", 64, 2, 5, 3001, np.int32, "owned", False),
    ("hist_folds", 65, 8, 1, 5000, np.uint8, "owned", False),
    ("hist_folds", 9, 16, 5, 3001, np.int8, "owned", False),
    ("hist_folds", 7, 4, 5, 5000, np.int32, "rows", False),
    ("route_hist", 64, 1, 5, 5000, np.int8, "private", False),
    ("route_hist", 64, 2, 1, 3001, np.uint8, "owned", False),
    ("route_hist", 65, 8, 5, 5000, np.int32, "owned", False),
    ("route_hist", 64, 16, 5, 3001, np.int8, "owned", True),
    ("route_hist", 9, 16, 1, 5000, np.uint8, "owned", False),
    ("route_hist", 7, 2, 5, 3001, np.int8, "rows", False),
]
FORCED = [("hist_folds", 64, 2, 5, 5000, np.uint8, "private", False),
          ("route_hist", 64, 2, 5, 5000, np.int8, "private", False),
          ("route_hist", 64, 4, 1, 3001, np.int32, "private", False),
          ("hist_folds", 64, 1, 5, 3001, np.int8, "owned", True),
          ("route_hist", 64, 16, 5, 5000, np.int8, "rows", False)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", [c + (False,) for c in HIST_CASES] + [c + (True,) for c in FORCED]
    + [("rank", 1, 5, 1, 20_000, np.int32, "rows", False, False),
       ("wide", 64, 1, 5, 5000, np.int32, "owned", True, False)],
    ids=lambda c: f"{c[0]}-F{c[1]}-S{c[2]}-Fo{c[3]}-N{c[4]}-"
                  f"{np.dtype(c[5]).name}-{c[6]}{'-skew' if c[7] else ''}"
                  f"{'-forced' if c[8] else ''}")
def test_cuda_histogram_paths_match_plain(cuda_device, case):
    """Every path of the two histogram kernels against the plain version:
    g/h within rtol 1e-5 / atol 1e-4 (f32 sums in another order), the
    derived counts and new node ids exact."""
    name, F, S, Fo, N, dtype, path, skew, forced = case
    if name == "rank":   # the lane-binned AuPR counts: F = 1, 4096 buckets
        rng = np.random.default_rng(3)
        args = (rng.integers(0, 4096, size=(1, N)).astype(np.int32),
                rng.integers(0, 2, size=(2, N)).astype(np.float32),
                np.repeat(np.arange(S, dtype=np.float32), N // S)[None, :])
        kw, name = dict(n_slots=S, n_bins=4096), "hist_folds"
    elif name == "wide":   # the estimator's default 256 bins, int32
        args, kw = _hist_case("hist_folds", F, S, Fo, N, dtype, B=257,
                              skew=skew)
        name = "hist_folds"
    else:
        args, kw = _hist_case(name, F, S, Fo, N, dtype, skew=skew)
    Co = 3 if kw.get("derive_count") else 2
    tl = TK.plan_hist(F, S, Co, kw["n_bins"], Fo, N, n_sm=132,
                      itemsize=np.dtype(dtype).itemsize,
                      route=name == "route_hist")
    if not forced:
        assert tl.path == path
    cpu = TK.PLAIN[name](*[torch.from_numpy(a) for a in args], **kw)
    before = TK.launches[name]
    got = getattr(TK, name)(*[torch.from_numpy(a).to(cuda_device)
                              for a in args], **kw,
                            path=path if forced else None)
    torch.cuda.synchronize()
    assert TK.launches[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    hist, want = got[0].cpu().numpy(), cpu[0].numpy()
    np.testing.assert_allclose(hist, want, rtol=1e-5, atol=1e-4)
    if Co == 3:
        np.testing.assert_array_equal(hist.reshape(-1, 3, hist.shape[1])[:, 2],
                                      want.reshape(-1, 3, want.shape[1])[:, 2])
    else:
        np.testing.assert_array_equal(hist, want)
    if name == "route_hist":
        np.testing.assert_array_equal(got[1].cpu().numpy(), cpu[1].numpy())


def _on_card(a, device, offset):
    """A numpy array on the card; with `offset`, as a contiguous view that
    starts `offset` elements into a larger buffer (not 16-byte aligned)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return t.to(device)
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype, device=device)
    buf[offset:].copy_(t.reshape(-1).to(device))
    return buf[offset:].view(t.shape)


def _lane_case(name, Fo, S, N, dtype, seed=11):
    """Seeded inputs of one route or table_lookup launch. route: bins with
    0 = missing, valid node ids, split tables; table_lookup: a [Fo, S]
    table and ids below 0, at S, above S, fractional and NaN."""
    rng = np.random.default_rng(seed)
    if name == "route":
        F = 64
        Xb_t = rng.integers(0, 33, size=(F, N)).astype(dtype)
        node = rng.integers(0, S, size=(Fo, N)).astype(np.float32)
        tables = [rng.integers(0, hi, size=(Fo, S)).astype(np.int32)
                  for hi in (F, 33, 2)]
        return (Xb_t, node, *tables), dict(n_nodes=S)
    tbl = rng.normal(size=(Fo, S)).astype(np.float32)
    idx = rng.integers(-2, S + 3, size=(Fo, N)).astype(np.float32)
    idx[:, :4] = [-1.0, S, S + 1, np.nan]
    idx[:, 4:6] = [-0.5, S - 0.5]
    return (tbl, idx), {}


# (kernel, Fo, S, N, bin dtype, offset, forced path): S = nodes or leaves;
# N = 20 000 is a multiple of 4, N = 3001 is not, N = 100 is smaller than
# one tile; offset 1 starts the first two inputs (route's bins and node
# plane, the lookup's table and ids) one element into their buffers (not
# 16-byte aligned); S = 8192 nodes (5 lanes) and 70 000 leaves are tables
# too large for shared memory. The planner takes route's staged path for
# 1-byte bins at 5 lanes, the rows path for int32 bins at 5 lanes and for
# 8192 nodes.
LANE_CASES = [
    ("route", 5, 32, 20_000, np.int8, 0, None),
    ("route", 5, 32, 20_000, np.int8, 0, "staged"),
    ("route", 5, 32, 20_000, np.int8, 0, "rows"),
    ("route", 5, 8, 20_000, np.uint8, 1, None),
    ("route", 5, 8, 3001, np.int32, 0, None),
    ("route", 5, 32, 3001, np.int32, 1, None),
    ("route", 5, 8, 20_000, np.int32, 0, "staged"),
    ("route", 5, 32, 20_000, np.int32, 1, "staged"),
    ("route", 1, 8, 3001, np.uint8, 0, "staged"),
    ("route", 1, 32, 3001, np.int8, 1, "staged"),
    ("route", 5, 32, 3001, np.int8, 1, "staged"),
    ("route", 5, 1, 100, np.int8, 0, None),
    ("route", 1, 1, 100, np.int32, 1, "staged"),
    ("route", 5, 8192, 3001, np.int8, 0, None),
    ("route", 1, 32, 20_000, np.uint8, 0, "rows"),
    ("table_lookup", 5, 64, 20_000, None, 0, None),
    ("table_lookup", 5, 16, 20_000, None, 0, "rows"),
    ("table_lookup", 1, 16, 3001, None, 0, None),
    ("table_lookup", 5, 64, 3001, None, 1, None),
    ("table_lookup", 5, 16, 20_000, None, 1, "rows"),
    ("table_lookup", 1, 64, 100, None, 0, None),
    ("table_lookup", 5, 64, 100, None, 1, "rows"),
    ("table_lookup", 1, 70_000, 3001, None, 0, None),
    ("table_lookup", 2, 70_000, 20_000, None, 1, "rows"),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", LANE_CASES,
    ids=lambda c: f"{c[0]}-Fo{c[1]}-S{c[2]}-N{c[3]}"
                  f"{'-' + np.dtype(c[4]).name if c[4] else ''}"
                  f"{'-offset' if c[5] else ''}-{c[6] or 'planned'}")
def test_cuda_lane_kernels_match_plain(cuda_device, case):
    """route and table_lookup on every path, forced and planned, exact
    against the plain version; each call launches its kernel once."""
    name, Fo, S, N, dtype, offset, path = case
    args, kw = _lane_case(name, Fo, S, N, dtype)
    cpu = TK.PLAIN[name](*[torch.from_numpy(a) for a in args])
    # route's bins and node plane, the lookup's table and id plane at the
    # offset
    card = [_on_card(a, cuda_device, offset if j < 2 else 0)
            for j, a in enumerate(args)]
    key = f"{name} F={64 if name == 'route' else 1} S={S}"
    before, before_shape = TK.launches[name], TK.shape_launches[key]
    got = getattr(TK, name)(*card, **kw, path=path)
    torch.cuda.synchronize()
    assert TK.launches[name] == before + 1
    assert TK.shape_launches[key] == before_shape + 1
    np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())


def _route_reference(Xb_t, node, tf, tt, tm):
    """route's whole contract in numpy: node ids outside [0, n_nodes) (NaN
    too) route as feature 0, threshold 0, missing direction 0; a split
    feature outside [0, F) reads feature 0."""
    F, N = Xb_t.shape
    inside = (node >= 0) & (node < tf.shape[1])
    nd = np.where(inside, node, 0).astype(np.int64)
    f, t, m = (np.where(inside, np.take_along_axis(tb, nd, 1), 0)
               for tb in (tf, tt, tm))
    f = np.where((f < 0) | (f >= F), 0, f)
    x = Xb_t[f, np.arange(N)[None, :]].astype(np.int64)
    return node * 2 + ((x > t) | ((x == 0) & (m > 0)))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [20_000, 3001, 100])
@pytest.mark.parametrize("path", [None, "staged", "rows"])
def test_cuda_route_out_of_range_ids_and_features(cuda_device, path, N):
    """Node ids below 0, at and above n_nodes and NaN, and split features
    outside [0, F), on every route path, against the numpy contract."""
    (Xb_t, node, tf, tt, tm), kw = _lane_case("route", 5, 32, N, np.int8,
                                              seed=13)
    node[:, :5] = [-1.0, 32.0, 40.0, np.nan, -0.5]
    tf[:, :3] = [-3, 64, 70]
    want = _route_reference(Xb_t, node, tf, tt, tm)
    before = TK.launches["route"]
    got = TK.route(*[torch.from_numpy(a).to(cuda_device)
                     for a in (Xb_t, node, tf, tt, tm)], **kw, path=path)
    torch.cuda.synchronize()
    assert TK.launches["route"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def _sorted_case(F, S, Fo, N, dtype, B, C, variant, seed=17):
    """Seeded inputs of one route_hist launch for the sorted path: bins
    partly outside [0, B), C payload channels a lane (the last a hessian,
    20% zero), node ids over the S slots, split features partly outside
    [0, F). `variant`: "one_slot" (every row in slot S - 1), "empty" (only
    every fourth slot holds rows), "odd_ids" (node ids -1, S, S + 3, NaN,
    -0.5 and S - 0.5 in the first six rows) or None."""
    rng = np.random.default_rng(seed)
    lo = 0 if dtype == np.uint8 else -3
    Xb_t = rng.integers(lo, B + 3, size=(F, N)).astype(dtype)
    pay = rng.normal(size=(Fo * C, N)).astype(np.float32)
    last = pay.reshape(Fo, C, N)[:, C - 1]
    last[:] = np.where(rng.uniform(size=(Fo, N)) < 0.2, 0.0,
                       np.abs(last) + 0.1)
    node = rng.integers(0, S, size=(Fo, N)).astype(np.float32)
    if variant == "one_slot":
        node[:] = S - 1
    elif variant == "empty":
        node = np.floor(node / 4) * 4
    elif variant == "odd_ids":
        node[:, :6] = [-1.0, S, S + 3, np.nan, -0.5, S - 0.5]
    tables = [rng.integers(-2, F + 2, size=(Fo, S)).astype(np.int32),
              rng.integers(0, B, size=(Fo, S)).astype(np.int32),
              rng.integers(0, 2, size=(Fo, S)).astype(np.int32)]
    return Xb_t, pay, node, tables


def _route_hist_reference(Xb_t, pay, node, tables, S, B):
    """The route_hist contract in numpy and the plain histogram: new node
    ids (node ids outside [0, S) or NaN route on feature 0, threshold 0,
    missing direction 0; split features outside [0, F) on feature 0), and
    the slots whose rows the histogram counts (S: not counted)."""
    tf, tt, tm = tables
    Fo, N = node.shape
    inside = (node >= 0) & (node < S)
    nid = np.where(inside, node, 0).astype(np.int64)
    f = np.where(inside, np.take_along_axis(tf, nid, 1), 0)
    f = np.where((f < 0) | (f >= Xb_t.shape[0]), 0, f)
    t = np.where(inside, np.take_along_axis(tt, nid, 1), 0)
    m = np.where(inside, np.take_along_axis(tm, nid, 1), 0)
    x = Xb_t[f, np.arange(N)[None, :]].astype(np.int64)
    right = (x > t) | ((x == 0) & (m > 0))
    new = (node * 2 + right).astype(np.float32)
    slots = np.where(inside & ~right, node, S).astype(np.float32)
    return new, slots


# (F, S, Fo, N, bin dtype, B, payload channels a lane, variant, forced):
# forced runs path="sorted" where the planner takes another (F = 7 and 9,
# the owned path's F = 64 at S = 4, 257 bins, fewer than 32 768 rows); the
# others must be planned "sorted". N is no multiple of 4 but once.
SORTED_CASES = [
    (7, 2, 3, 40_003, np.int8, 33, 2, None, True),
    (9, 16, 1, 40_003, np.uint8, 33, 3, "odd_ids", True),
    (64, 4, 5, 40_000, np.int8, 33, 2, "one_slot", True),
    (65, 8, 5, 70_003, np.uint8, 65, 2, None, False),
    (164, 2, 5, 100_003, np.int8, 33, 3, "one_slot", False),
    (164, 32, 5, 100_003, np.int8, 33, 3, "odd_ids", False),
    (164, 256, 5, 70_001, np.int32, 33, 2, None, False),
    (164, 1024, 5, 100_003, np.int8, 33, 3, "empty", False),
    (650, 4, 3, 70_001, np.int8, 33, 3, None, False),
    (650, 16, 3, 30_001, np.uint8, 33, 2, "odd_ids", True),
    (48, 2, 7, 30_001, np.int32, 257, 2, None, True),
    (48, 4, 3, 20_001, np.int32, 257, 9, "empty", True),
    (64, 32, 3, 70_001, np.int8, 65, 4, "odd_ids", False),
    (164, 64, 2, 20_001, np.uint8, 33, 9, None, True),
]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "case", SORTED_CASES,
    ids=lambda c: f"F{c[0]}-S{c[1]}-Fo{c[2]}-N{c[3]}-"
                  f"{np.dtype(c[4]).name}-B{c[5]}-C{c[6]}+1"
                  f"{'-' + c[7] if c[7] else ''}{'-forced' if c[8] else ''}")
def test_cuda_sorted_path_matches_plain(cuda_device, case):
    """route_hist's sorted path against the plain histogram on the same
    inputs: node ids exact (the numpy contract, out-of-range ids and
    features included), counts exact, g/h cells held to the float64 sums
    within 1e-4 of a cell's sum of |terms| or the plain f32 version's own
    error (as `hist_paths.accuracy`); and the sort's lists, read back from
    its workspace, equal to `slot_order_plain`."""
    F, S, Fo, N, dtype, B, C, variant, forced = case
    Xb_t, pay, node, tables = _sorted_case(F, S, Fo, N, dtype, B, C,
                                           variant)
    new_want, slots = _route_hist_reference(Xb_t, pay, node, tables, S, B)
    Co = C + 1
    tl = TK.plan_hist(F, S, Co, B, Fo, N, n_sm=132,
                      itemsize=np.dtype(dtype).itemsize, route=True)
    assert (tl.path != "sorted") if forced else (tl.path == "sorted")
    dev = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
           for a in (Xb_t, pay, node, *tables)]
    xb_rows = dev[0].T.contiguous()
    kw = dict(n_nodes=S, n_bins=B, derive_count=True)
    before = TK.launches["route_hist"]
    hist, new_node = TK.route_hist(*dev, **kw, xb_rows=xb_rows,
                                   path="sorted" if forced else None)
    torch.cuda.synchronize()
    assert TK.launches["route_hist"] == before + 1
    np.testing.assert_array_equal(new_node.cpu().numpy(), new_want)
    cpu = [torch.from_numpy(a) for a in (Xb_t, pay, slots)]
    hkw = dict(n_slots=S, n_bins=B, derive_count=True)
    exact = TK.hist_folds_plain(cpu[0], cpu[1].double(), cpu[2], **hkw)
    scale = TK.hist_folds_plain(cpu[0], cpu[1].double().abs(), cpu[2],
                                **hkw)
    plain = TK.hist_folds_plain(*cpu, **hkw)

    def rel(h):
        err = (h.double() - exact).abs()
        return float(torch.where(scale > 0, err / scale.clamp(min=1e-300),
                                 torch.where(err > 0, float("inf"),
                                             0.0)).max())
    got = hist.cpu()
    assert got.shape == plain.shape
    assert rel(got) <= max(1e-4, rel(plain)), (rel(got), rel(plain))
    cnt = [h.reshape(-1, Co, h.shape[1])[:, C] for h in (got, plain)]
    assert torch.equal(*cnt)
    # the sort alone: its lists and slot starts, read from its workspace
    new_sort, order, start = TK.route_hist_sort(*dev, **kw, xb_rows=xb_rows)
    torch.cuda.synchronize()
    want_order, want_start = TK.slot_order_plain(
        torch.from_numpy(node), torch.from_numpy(new_want), S)
    np.testing.assert_array_equal(new_sort.cpu().numpy(), new_want)
    assert torch.equal(start.cpu().long(), want_start)
    for k in range(Fo):
        n = int(want_start[k, -1])
        assert torch.equal(order[k, :n].cpu().long(), want_order[k, :n])
