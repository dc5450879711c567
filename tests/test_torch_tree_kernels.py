"""Port tree kernels (transmogrifai_tpu_torch/ops/tree_kernels.py) against the
JAX package's Pallas kernels, run in interpret mode, and their jnp twins.

The same seeded numpy inputs go through both packages. Counts and integer
payloads must match exactly (f32 sums of small integers are exact in any
order); float payload sums within rtol 1e-6 / atol 1e-5, because the
summation order differs. Routing and lookups are exact.

On this CPU-only machine the dispatchers run their plain PyTorch versions;
the CUDA kernels are held against those same plain versions on the card by
tests/test_torch_kernels_gpu.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from transmogrifai_tpu.ops import pallas_hist as PH
from transmogrifai_tpu_torch.ops import _build
from transmogrifai_tpu_torch.ops import tree_kernels as TK

RTOL, ATOL = 1e-6, 1e-5


def _hist_inputs(n, f, b, folds, n_slots, C, seed, int_payload=False,
                 dtype=np.int8):
    rng = np.random.default_rng(seed)
    Xb_t = rng.integers(0, b, size=(f, n)).astype(dtype)
    if int_payload:
        pay = rng.integers(-3, 4, size=(folds * C, n)).astype(np.float32)
    else:
        pay = rng.normal(size=(folds * C, n)).astype(np.float32)
    # the last channel is the hessian: zero on some rows so derive_count
    # drops them, like rows outside a fold after subsampling
    last = pay.reshape(folds, C, n)[:, C - 1]
    last[:] = np.where(rng.uniform(size=last.shape) < 0.2, 0.0,
                       np.abs(last) + (1.0 if int_payload else 0.1))
    # slot == n_slots (and beyond) drops the row
    slot = rng.integers(0, n_slots + 2, size=(folds, n)).astype(np.float32)
    return Xb_t, pay, slot


def _port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _check_hist(got, want, exact):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,f,b,folds,n_slots,C,derive,int_payload", [
    (1000, 5, 9, 1, 1, 2, True, False),     # root shape, ragged N
    (777, 6, 9, 3, 4, 2, True, False),      # Fo > 1, dropped slots
    (2100, 4, 17, 5, 8, 2, False, True),    # integer payloads: exact
    (640, 3, 7, 2, 2, 3, True, True),       # derive_count on 3 channels
])
def test_hist_folds_matches_pallas_and_twin(n, f, b, folds, n_slots, C,
                                            derive, int_payload):
    Xb_t, pay, slot = _hist_inputs(n, f, b, folds, n_slots, C, seed=n,
                                   int_payload=int_payload)
    got = TK.hist_folds(*_port(Xb_t, pay, slot), n_slots=n_slots, n_bins=b,
                        derive_count=derive)
    kw = dict(n_slots=n_slots, n_bins=b, derive_count=derive)
    pallas = PH.hist_pallas(jnp.asarray(Xb_t), jnp.asarray(pay),
                            jnp.asarray(slot), interpret=True, **kw)
    twin = PH.hist_folds(jnp.asarray(Xb_t), jnp.asarray(pay),
                         jnp.asarray(slot), **kw)
    assert got.shape == (folds * n_slots * (C + derive), f * b)
    _check_hist(got, pallas, exact=int_payload)
    _check_hist(got, twin, exact=int_payload)
    if derive:   # the count channel is exact whatever the payload
        Co = C + 1
        cnt = got.numpy().reshape(folds, n_slots, Co, -1)[:, :, C]
        np.testing.assert_array_equal(
            cnt, np.asarray(pallas).reshape(folds, n_slots, Co, -1)[:, :, C])


def test_hist_folds_rank_metric_shape():
    """The in-sweep AuPR call: F = 1, 4096 score buckets (int32 bins), the
    lanes in the slot axis, positive/negative weights as two channels."""
    L, n, bins = 5, 300, 4096
    rng = np.random.default_rng(11)
    idx = rng.integers(0, bins, size=(1, L * n)).astype(np.int32)
    pay = rng.integers(0, 2, size=(2, L * n)).astype(np.float32)
    lane = np.repeat(np.arange(L, dtype=np.float32), n)[None, :]
    got = TK.hist_folds(*_port(idx, pay, lane), n_slots=L, n_bins=bins)
    want = PH.hist_pallas(jnp.asarray(idx), jnp.asarray(pay),
                          jnp.asarray(lane), n_slots=L, n_bins=bins,
                          interpret=True)
    _check_hist(got, want, exact=True)


def _route_inputs(n, f, b, folds, n_nodes, seed, dtype=np.int8):
    rng = np.random.default_rng(seed)
    Xb_t = rng.integers(0, b, size=(f, n)).astype(dtype)   # 0 = missing
    node = rng.integers(0, n_nodes, size=(folds, n)).astype(np.float32)
    f_lvl = rng.integers(0, f, size=(folds, n_nodes)).astype(np.int32)
    t_lvl = rng.integers(0, b, size=(folds, n_nodes)).astype(np.int32)
    m_lvl = rng.integers(0, 2, size=(folds, n_nodes)).astype(np.int32)
    return Xb_t, node, f_lvl, t_lvl, m_lvl


@pytest.mark.parametrize("n,f,b,folds,n_nodes,dtype", [
    (514, 6, 8, 3, 4, np.int8),
    (1000, 4, 40, 1, 8, np.uint8),
    (333, 5, 9, 5, 1, np.int32),
])
def test_route_matches_pallas_and_twin(n, f, b, folds, n_nodes, dtype):
    Xb_t, node, f_lvl, t_lvl, m_lvl = _route_inputs(n, f, b, folds, n_nodes,
                                                    seed=n, dtype=dtype)
    got = TK.route(*_port(Xb_t, node, f_lvl, t_lvl, m_lvl),
                   n_nodes=n_nodes).numpy()
    args = [jnp.asarray(a) for a in (Xb_t, node, f_lvl, t_lvl, m_lvl)]
    pallas = PH.route_pallas(*args, n_nodes=n_nodes, interpret=True)
    twin = PH.route(*args, n_nodes=n_nodes)
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(twin))


@pytest.mark.parametrize("n,f,b,folds,n_nodes,int_payload", [
    (901, 6, 9, 3, 4, False),
    (1200, 4, 33, 5, 2, True),
    (500, 3, 7, 1, 8, False),
])
def test_route_hist_matches_pallas_and_twin(n, f, b, folds, n_nodes,
                                            int_payload):
    Xb_t, node, f_lvl, t_lvl, m_lvl = _route_inputs(n, f, b, folds, n_nodes,
                                                    seed=n + 1)
    _, pay, _ = _hist_inputs(n, f, b, folds, n_nodes, 2, seed=n + 2,
                             int_payload=int_payload)
    hist, new_node = TK.route_hist(
        *_port(Xb_t, pay, node, f_lvl, t_lvl, m_lvl), n_nodes=n_nodes,
        n_bins=b, derive_count=True)
    args = [jnp.asarray(a) for a in (Xb_t, pay, node, f_lvl, t_lvl, m_lvl)]
    kw = dict(n_nodes=n_nodes, n_bins=b, derive_count=True)
    for want_hist, want_node in (PH.route_hist(*args, interpret=True, **kw),
                                 PH.route_hist(*args, **kw)):
        np.testing.assert_array_equal(new_node.numpy(), np.asarray(want_node))
        _check_hist(hist, want_hist, exact=int_payload)


@pytest.mark.parametrize("folds,M,n", [(4, 16, 517), (1, 64, 2000),
                                       (5, 32, 100)])
def test_table_lookup_matches_pallas_and_twin(folds, M, n):
    rng = np.random.default_rng(M + n)
    tbl = rng.normal(size=(folds, M)).astype(np.float32)
    # ids beyond both ends of the table read 0
    idx = rng.integers(-2, M + 3, size=(folds, n)).astype(np.float32)
    got = TK.table_lookup(*_port(tbl, idx)).numpy()
    pallas = PH.table_lookup_pallas(jnp.asarray(tbl), jnp.asarray(idx),
                                    interpret=True)
    twin = PH.table_lookup(jnp.asarray(tbl), jnp.asarray(idx))
    np.testing.assert_array_equal(got, np.asarray(pallas))
    np.testing.assert_array_equal(got, np.asarray(twin))
    assert (got[(idx < 0) | (idx >= M)] == 0).all()


# -- the CUDA path raises here instead of falling back -------------------------

def _meta(*shapes_dtypes):
    return [torch.empty(s, dtype=d, device="meta") for s, d in shapes_dtypes]


@pytest.mark.parametrize("name", TK.KERNELS)
def test_dispatchers_refuse_non_cpu_tensors(name):
    """Inputs that are not on the CPU never take the plain version: on a
    device other than CUDA the dispatcher raises, and launches stay 0."""
    n, f, lanes, nodes = 64, 3, 2, 2
    xb, pay, node = _meta(((f, n), torch.int8), ((2 * lanes, n),
                                                 torch.float32),
                          ((lanes, n), torch.float32))
    tables = _meta(*[((lanes, nodes), torch.int32)] * 3)
    calls = {
        "hist_folds": lambda: TK.hist_folds(xb, pay, node, n_slots=1,
                                            n_bins=4, derive_count=True),
        "route_hist": lambda: TK.route_hist(xb, pay, node, *tables,
                                            n_nodes=nodes, n_bins=4),
        "route": lambda: TK.route(xb, node, *tables, n_nodes=nodes),
        "table_lookup": lambda: TK.table_lookup(
            *_meta(((lanes, 8), torch.float32), ((lanes, n),
                                                 torch.float32))),
    }
    TK.reset_launches()
    with pytest.raises(ValueError, match="all-CPU or all-CUDA"):
        calls[name]()
    assert TK.launches[name] == 0


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """The CUDA path needs nvcc; without it the build raises (and the
    dispatchers with it) rather than running anything on the CPU."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    from transmogrifai_tpu_torch.device import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def _tile_cover(tl, F, S, lanes):
    """How often the launch's blocks take each (lane, slot, feature), with
    the kernels' decode of the block index."""
    n_ft, n_st = -(-F // tl.f_tile), -(-S // tl.s_tile)
    seen = {}
    for o in range(lanes * n_ft * n_st):
        if tl.path == "rows":   # grid (row ranges, tiles, lanes)
            k, ft, st = o // (n_ft * n_st), o % n_ft, (o % (n_ft * n_st)) // n_ft
        else:                   # blockIdx.x % (lanes x tiles)
            ft, st, k = o % n_ft, (o // n_ft) % n_st, o // (n_ft * n_st)
        f0, s0 = ft * tl.f_tile, st * tl.s_tile
        for s in range(s0, min(S, s0 + tl.s_tile)):
            for f in range(f0, min(F, f0 + tl.f_tile)):
                seen[k, s, f] = seen.get((k, s, f), 0) + 1
    return seen


@pytest.mark.parametrize("F,S,Co,B,lanes,N,itemsize,route,path", [
    (64, 1, 3, 33, 5, 10_000_000, 1, False, "private"),  # sweep root
    (64, 1, 3, 33, 1, 10_000_000, 1, False, "private"),  # refit root
    (64, 1, 3, 33, 5, 10_000_000, 1, True, "private"),   # route_hist levels
    (64, 2, 3, 33, 5, 10_000_000, 1, True, "owned"),
    (64, 4, 3, 33, 5, 10_000_000, 1, True, "owned"),
    (64, 8, 3, 33, 5, 10_000_000, 1, True, "owned"),
    (64, 16, 3, 33, 5, 10_000_000, 1, True, "owned"),   # deepest level
    (64, 16, 3, 33, 1, 10_000_000, 1, True, "owned"),
    (1, 5, 2, 4096, 1, 50_000_000, 4, False, "rows"),    # rank-metric counts
    (65, 16, 3, 257, 5, 1_000, 4, True, "rows"),        # 256 bins, int32
    (64, 2, 3, 257, 5, 10_000_000, 4, True, "rows"),
    (64, 1, 3, 257, 5, 10_000_000, 4, False, "owned"),
    (9, 16, 3, 33, 1, 5_000, 1, True, "owned"),
    (9, 4, 3, 33, 3, 5_000, 1, False, "owned"),
    (3, 2, 3, 9, 2, 100, 1, False, "rows"),              # tiny
    (7, 2, 3, 9, 2, 100, 1, True, "rows"),
])
def test_hist_tiling_fits_shared_memory(F, S, Co, B, lanes, N, itemsize,
                                        route, path):
    tl = TK.plan_hist(F, S, Co, B, lanes, N, n_sm=132, itemsize=itemsize,
                      route=route)
    assert tl.path == path
    assert tl.smem_bytes <= TK._SMEM_BLOCK_MAX
    assert set(_tile_cover(tl, F, S, lanes).values()) == {1}
    assert len(_tile_cover(tl, F, S, lanes)) == lanes * S * F
    if path == "rows":
        assert tl.smem_bytes <= TK._SMEM_BUDGET
        assert tl.blocks * tl.rows_per_block >= N
        assert (tl.blocks - 1) * tl.rows_per_block < N
    else:
        others = lanes * -(-F // tl.f_tile) * -(-S // tl.s_tile)
        chunks, rem = divmod(tl.blocks, others)
        assert rem == 0 and 1 <= chunks <= -(-N // tl.rows_per_block)
        assert tl.blocks <= max(132, others)     # one block per SM
        assert tl.rows_per_block == TK._FM_TILE_BYTES // itemsize
        assert tl.f_tile <= TK._FM_MAX_FTILE
        assert tl.smem_bytes == TK.fm_smem_bytes(
            itemsize, tl.f_tile, tl.s_tile, Co, B, tl.copies,
            path == "private", S if route else 0)
        assert tl.copies == TK._FM_WARPS if path == "private" else \
            TK._FM_WARPS % tl.copies == 0


@pytest.mark.parametrize("path,F,S,B,itemsize", [
    ("private", 1, 5, 4096, 4),    # 8 copies of 4096 bins x 32 lanes
    ("owned", 64, 1, 4096, 4),
    ("columns", 64, 1, 33, 1),
])
def test_hist_tiling_refuses_a_path_that_does_not_fit(path, F, S, B,
                                                      itemsize):
    with pytest.raises(ValueError, match="does not fit|unknown histogram path"):
        TK.plan_hist(F, S, 3, B, 1, 1000, n_sm=132, itemsize=itemsize,
                     path=path)


@pytest.mark.parametrize("n_bins", [33, 257])
def test_kernel_timing_inputs_cover_the_main_path_shapes(n_bins):
    """The inputs chip_smoke.py and tools/hist_paths.py time the kernels on:
    every histogram, route and leaf-lookup shape of the sweep (route at 8
    and 32 nodes, and at 32 with one split table shared by every lane),
    bins of the binning's dtype, and an agreement check that holds a result
    to itself and rejects a change."""
    from transmogrifai_tpu_torch.tools import hist_paths as HP
    d = HP.kernel_inputs(300, 0, dev="cpu", n_bins=n_bins)
    assert d["Xb"].dtype == (torch.int8 if n_bins == 33 else torch.int32)
    shapes = HP.hist_shapes(d)
    assert [(name, S) for _, name, S, _, _ in shapes] == [
        ("hist_folds", 1), ("hist_folds", 1), ("hist_folds", 5)] + [
        ("route_hist", S) for S in (1, 2, 4, 8, 16)]
    lanes = HP.lane_shapes(d)
    assert [(name, S) for _, name, S, _, _ in lanes] == [
        ("route", 8), ("route", 32), ("route", 32), ("table_lookup", 16),
        ("table_lookup", 64)]
    shared, apart = lanes[2][3][2:], lanes[1][3][2:]
    assert all(bool((t == t[:1]).all()) for t in shared)
    assert not bool((apart[0] == apart[0][:1]).all())
    for label, name, S, args, kw in (shapes[0], shapes[2], shapes[4],
                                     lanes[0], lanes[2], lanes[4]):
        got = getattr(TK, name)(*args, **kw)
        assert HP.agrees(name, got, HP.plain(name, args, kw), args, kw)
        bad = tuple(t.clone() for t in (got if isinstance(got, tuple)
                                        else (got,)))
        bad[0][0] += 1.0
        assert not HP.agrees(name, bad if name == "route_hist" else bad[0],
                             got, args, kw)
        if name == "route":
            n_read = HP.route_bins_read(args[1], args[2])
            assert d["N"] <= n_read <= d["Fo"] * d["N"]
    lean = HP.kernel_inputs(300, 0, dev="cpu", n_bins=n_bins, hist=False)
    assert "pay" not in lean and [s[:3] for s in HP.lane_shapes(lean)] == [
        s[:3] for s in lanes]


def test_route_bins_read_counts_each_rows_distinct_features():
    from transmogrifai_tpu_torch.tools import hist_paths as HP
    node = torch.tensor([[0., 1., 1.], [1., 1., 0.], [0., 0., 0.]])
    f_lvl = torch.tensor([[3, 7], [3, 7], [3, 3]], dtype=torch.int32)
    # row 0: features 3, 7, 3; row 1: 7, 7, 3; row 2: 7, 3, 3
    assert HP.route_bins_read(node, f_lvl) == 6
    assert TK.kernel_bytes("route", 64, 3, 3, bins_read=6) == 6 + 3 * 2 * 12
    assert TK.kernel_bytes("route", 64, 3, 3) == 9 + 3 * 2 * 12


# (kernel, F, S, lanes, N, bin itemsize, path the planner must choose): the
# main path's shapes at 10M rows (the sweep's 5 lanes and the refit's 1;
# route at 8 and 32 nodes, the 16- and 64-leaf lookups), then shapes off
# it: int32 bins (at 8 nodes the staged copy reads 40 features x 4 B a row,
# as many bytes as 5 lanes' gathered sectors, not fewer), one lane under 8
# and 32 nodes (8 and 32 bytes a row against one 32-byte sector), a row
# count that is no multiple of 4, and tables too large for a block's
# shared memory
LANE_PLANS = [
    ("route", 64, 8, 5, 10_000_000, 1, "staged"),
    ("route", 64, 32, 5, 10_000_000, 1, "staged"),
    ("route", 64, 8, 1, 10_000_000, 1, "staged"),
    ("route", 64, 32, 1, 10_000_000, 1, "rows"),
    ("table_lookup", 1, 16, 5, 10_000_000, 4, "rows"),
    ("table_lookup", 1, 64, 5, 10_000_000, 4, "rows"),
    ("table_lookup", 1, 16, 1, 10_000_000, 4, "rows"),
    ("table_lookup", 1, 64, 1, 10_000_000, 4, "rows"),
    ("route", 64, 8, 5, 10_000_000, 4, "rows"),
    ("route", 64, 32, 5, 10_000_000, 4, "rows"),
    ("route", 64, 64, 5, 10_000_000, 1, "staged"),
    ("route", 64, 32, 5, 3001, 1, "staged"),
    ("route", 64, 8192, 5, 3008, 1, "rows"),
    ("table_lookup", 1, 70_000, 1, 3001, 4, "rows"),
]


def _lane_plan(name, F, S, lanes, N, itemsize, path=None):
    if name == "route":
        return TK.plan_route(F, S, lanes, N, n_sm=132, itemsize=itemsize,
                             path=path)
    return TK.plan_lookup(S, lanes, N, n_sm=132, path=path)


def _staged_smem(F, S, lanes, itemsize):
    """The staged route's block: packed tables, feature map and list, and a
    512-row tile (16 bytes more a row) of the bins of min(F, lanes x S)
    features."""
    return (-(-8 * lanes * (S + 1) // 16) * 16 + 8 * F
            + min(F, lanes * S) * (512 * itemsize + 16))


def _check_grid(tl, F, S, lanes, N, itemsize):
    """The rows path: 512 threads, a row each, at most 8 blocks an SM of
    132 SMs; the staged path: a persistent grid that stays resident (6
    blocks an SM, fewer where 228 KiB of shared memory run out), no more
    blocks than 512-row tiles, and shared memory that fits a block
    (232 448 B)."""
    if tl.path == "rows":
        assert (tl.threads, tl.smem_bytes) == (512, 0)
        assert tl.blocks == min(-(-N // 512), 8 * 132)
        return
    assert tl.threads == 128
    assert tl.smem_bytes == _staged_smem(F, S, lanes, itemsize) <= 232_448
    per_sm = min(6, 233_472 // (tl.smem_bytes + 1024))
    assert 1 <= tl.blocks == min(-(-N // 512), per_sm * 132)


@pytest.mark.parametrize("case", LANE_PLANS,
                         ids=lambda c: f"{c[0]}-S{c[2]}-Fo{c[3]}-N{c[4]}"
                                       f"-{c[5]}B")
def test_lane_kernel_plan_fits_the_card(case):
    """The planner of route and table_lookup at the main path's shapes and
    off it: its path, and a grid and shared memory that fit the card."""
    name, F, S, lanes, N, itemsize, path = case
    tl = _lane_plan(name, F, S, lanes, N, itemsize)
    assert tl.path == path
    _check_grid(tl, F, S, lanes, N, itemsize)


@pytest.mark.parametrize("name,F,S,lanes,itemsize,path", [
    ("route", 64, 32, 5, 4, "staged"),
    ("route", 64, 8, 1, 4, "staged"),
    ("route", 64, 32, 5, 1, "rows"),
    ("table_lookup", 1, 64, 5, 4, "rows"),
])
def test_forced_lane_paths(name, F, S, lanes, itemsize, path):
    """A forced path keeps its own block and shared memory, where the
    planner would choose the other one too."""
    tl = _lane_plan(name, F, S, lanes, 10_000_000, itemsize, path)
    assert tl.path == path
    _check_grid(tl, F, S, lanes, 10_000_000, itemsize)


@pytest.mark.parametrize("name,F,S,itemsize,path", [
    ("route", 64, 8192, 1, "staged"),     # tables beside the tile: too big
    ("route", 200, 32, 4, "staged"),      # 160 x 512 int32 bins: too big
    ("route", 64, 8, 1, "lanes"),
    ("table_lookup", 1, 64, 4, "staged"),
])
def test_lane_plan_refuses_a_path_that_does_not_fit(name, F, S, itemsize,
                                                    path):
    with pytest.raises(ValueError, match="do not fit|unknown"):
        _lane_plan(name, F, S, 5, 10_000, itemsize, path)
