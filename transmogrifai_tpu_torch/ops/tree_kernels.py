"""The four tree kernels of the sweep: dispatchers, plain versions, launches.

Counterpart of transmogrifai_tpu/ops/pallas_hist.py. Each dispatcher keeps
the JAX signature and output layout (binned matrix [F, N], lane planes
[Fo, N] f32, histograms [Fo * S * Co, F * B] f32):

- `hist_folds`   (B1, Pallas `_kernel`): multi-lane gradient histograms;
- `route_hist`   (B2, `_route_hist_kernel`): route one level and histogram
  the next level's left children in one pass;
- `route`        (B3, `_route_kernel`): one level of routing;
- `table_lookup` (B4, `_lookup_kernel`): per-lane small-table lookup.

`plan_hist` picks the launch shape of the first two, `plan_route` and
`plan_lookup` that of the last two; each dispatcher takes `path=` to force
one (measurement and tests).

A dispatcher runs its plain PyTorch version when its inputs lie on the CPU
and launches the hand-written CUDA kernel (csrc/tree_kernels.cu) when they
lie on a CUDA device; any other device raises. There is no fallback from
the kernel to the plain version. `launches` counts kernel launches, one per
dispatcher call that reached its kernel; `shape_launches` counts the same
launches by (kernel, F, S), S being the slot or node count (the table
width for `table_lookup`, whose F is 1).

The port accumulates f32 payloads only: its histograms follow the JAX
package's TMOG_HIST_BF16=0 mode. It pads no rows: the 4096-row blocks of the
Pallas kernels are a TPU artifact.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import torch

from . import _build

KERNELS = ("hist_folds", "route_hist", "route", "table_lookup")
launches = dict.fromkeys(KERNELS, 0)
shape_launches: Counter = Counter()


def reset_launches() -> None:
    for name in KERNELS:
        launches[name] = 0
    shape_launches.clear()


def _count_launch(name: str, n_feat: int, n_slots: int) -> None:
    launches[name] += 1
    shape_launches[f"{name} F={n_feat} S={n_slots}"] += 1


_BIN_KINDS = {torch.int8: 0, torch.uint8: 1, torch.int32: 2}
_MAX_CHANNELS = 4            # payload channels + derived count (kMaxChannels)
_SMEM_BLOCK_MAX = 232_448    # dynamic shared memory one block may use (H100)
_SMEM_BUDGET = _SMEM_BLOCK_MAX // 2   # rows path: two blocks per SM
_THREADS = 512               # rows paths (kRowThreads, route/lookup rows)
# features path (hist_fm_kernel): kWarps, kTileBytes, kXsStride, kMaxFTile
_FM_WARPS = 8
_FM_TILE_BYTES = 256
_FM_XS_STRIDE = _FM_TILE_BYTES // 4 + 1
_FM_MAX_FTILE = 64
_FM_MIN_FEATURES = 8         # narrower F takes the rows path
PATHS = ("rows", "private", "owned")
_PATH_CODES = {p: i for i, p in enumerate(PATHS)}
# route's staged path: kStagedThreads, kStagedRows, the blocks an SM its
# __launch_bounds__ keep resident
ROUTE_PATHS = ("rows", "staged")
LOOKUP_PATHS = ("rows",)
_ROUTE_PATH_CODES = {p: i for i, p in enumerate(ROUTE_PATHS)}
_STAGED_THREADS = 128
_STAGED_ROWS = 4 * _STAGED_THREADS
_STAGED_RESIDENT = 6
_SECTOR = 32                 # bytes of an L2 sector: a gathered bin's cost
_SMEM_SM = 233_472           # shared memory of one SM (228 KiB)
_SMEM_BLOCK_RESERVED = 1024  # the runtime's shared memory of each block


# -- analytic HBM traffic (copied from the JAX package's byte model) --------

def sweep_level_bytes(n_rows: int, n_feat: int, lanes: int, *,
                      channels: int = 2, xb_itemsize: int = 1,
                      fused=True) -> int:
    """Analytic HBM bytes moved for ONE mid-sweep tree level.

    fused='per_fold' (or False): every lane re-streams the binned matrix for
    its histogram pass and again for its routing pass, plus per-lane
    payload, the slot plane and the node read+write. fused='r5': the fold
    axis fused, the count channel its own plane and routing a separate
    pass. fused='fused' (or True): the route+hist kernel — one read of the
    binned matrix serves every lane, the count channel is derived from the
    hessian, and routing rides the same pass (node read + new-node write
    per lane)."""
    mode = {True: "fused", False: "per_fold"}.get(fused, fused)
    xb = n_rows * n_feat * xb_itemsize
    pay = channels * 4 * n_rows            # g/h f32 planes per lane
    node = 4 * n_rows                      # f32 slot/node plane
    if mode == "per_fold":
        per_lane = 2 * xb + pay + 2 * node + 2 * node
        return lanes * per_lane
    if mode == "r5":
        return 2 * xb + lanes * (pay + 2 * node + 2 * node)
    if mode != "fused":
        raise ValueError(f"unknown traffic mode {fused!r}")
    return xb + lanes * (pay + 2 * node)   # node read + new-node write


def fused_fit_bytes(n_rows: int, n_feat: int, lanes: int, depth: int,
                    n_rounds: int, *, xb_itemsize: int = 1) -> int:
    """Analytic HBM bytes for one whole fold-fused GBT fit (all rounds):
    per round the root histogram pass (Xb + per-lane payload + slot),
    depth-1 route+hist passes, the final route (Xb + node read/write per
    lane) and the leaf lookup + margin update (3 lane planes)."""
    xb = n_rows * n_feat * xb_itemsize
    plane = 4 * n_rows
    level0 = xb + lanes * (2 * plane + plane)      # g/h + slot ids
    mid = max(depth - 1, 0) * sweep_level_bytes(
        n_rows, n_feat, lanes, xb_itemsize=xb_itemsize, fused=True)
    final_route = (xb + lanes * 2 * plane) if depth >= 1 else 0
    leaf_margin = lanes * 3 * plane
    return n_rounds * (level0 + mid + final_route + leaf_margin)


# -- tiling of the shared-memory histogram kernels ---------------------------

@dataclass(frozen=True)
class HistTiling:
    """Launch shape of the histogram kernels.

    path "rows" (hist_kernel / route_hist_kernel): one block per (row range
    of `rows_per_block` rows, feature tile x slot tile, lane), `blocks` row
    ranges. Paths "private" (a histogram copy per warp) and "owned"
    (`copies` histograms, each shared by warps that own its slots) of
    hist_fm_kernel: a persistent grid of `blocks` blocks, a multiple of
    lanes x feature tiles x slot tiles, striding over staged row tiles of
    `rows_per_block` rows."""

    path: str
    f_tile: int
    s_tile: int
    copies: int
    blocks: int
    rows_per_block: int
    smem_bytes: int


def fm_smem_bytes(itemsize: int, f_tile: int, s_tile: int, channels: int,
                  n_bins: int, copies: int, private: bool,
                  n_tables: int) -> int:
    """Shared memory of one hist_fm_kernel block (fm_smem_bytes in the
    source): `copies` [s_tile, feature groups of 32, B, Co, 32] f32
    histograms, the staged tile's payload (16 B a row), its row slots
    (private) or _FM_WARPS row lists and counts (owned), its bins in rows
    of _FM_XS_STRIDE words, and 3 split tables."""
    groups = -(-f_tile // 32)
    rows = _FM_TILE_BYTES // itemsize
    lists = 4 * rows if private else 4 * _FM_WARPS * rows + 4 * _FM_WARPS
    return (4 * copies * s_tile * groups * n_bins * channels * 32
            + 16 * rows + lists + 4 * _FM_XS_STRIDE * f_tile + 12 * n_tables)


def _fm_tiles(n_feat, n_slots, channels, n_bins, itemsize, private,
              n_tables):
    """(slot tiles, feature tiles, copies) of the features path: fewest
    (slot tile, feature tile) pairs first (each stages every row and its
    route), then fewest feature tiles (wider tiles share a row's list entry
    and payload among more features), then most histogram copies (rows
    spread over more warps); None when not even one slot fits."""
    best = None
    for groups in range(1, _FM_MAX_FTILE // 32 + 1):
        if 32 * (groups - 1) >= n_feat:
            break
        for copies in (_FM_WARPS,) if private else (4, 2, 1):
            def smem(s):
                return fm_smem_bytes(itemsize, 32 * groups, s, channels,
                                     n_bins, copies, private, n_tables)
            s_fit = min(n_slots, (_SMEM_BLOCK_MAX - smem(0))
                        // (smem(1) - smem(0)))
            if s_fit < 1:
                continue
            n_st, n_ft = -(-n_slots // s_fit), -(-n_feat // (32 * groups))
            key = (n_st * n_ft, n_ft, -copies, n_st)
            best = key if best is None or key < best else best
    return None if best is None else (best[3], best[1], -best[2])


def _plan_rows(n_feat, n_slots, channels, n_bins, lanes, n_rows, n_sm,
               extra_smem):
    """Rows path: tile the [s_tile, Co, f_tile, B] f32 histogram into half
    of a block's shared memory (two blocks per SM), balancing the tiles, and
    cut the rows so about four blocks per SM are launched."""
    cell = channels * n_bins * 4                      # one (slot, feature)
    budget = _SMEM_BUDGET - extra_smem
    if cell > budget:
        raise ValueError(f"a histogram of {n_bins} bins x {channels} channels "
                         f"does not fit a block's shared memory")
    s_tile = max(1, min(n_slots, budget // cell))
    s_tile = -(-n_slots // -(-n_slots // s_tile))
    f_tile = max(1, min(n_feat, budget // (s_tile * cell)))
    f_tile = -(-n_feat // -(-n_feat // f_tile))
    others = -(-n_feat // f_tile) * -(-n_slots // s_tile) * lanes
    row_blocks = max(1, min(-(-4 * n_sm // others), -(-n_rows // _THREADS)))
    rows_per_block = -(-n_rows // row_blocks)
    row_blocks = -(-n_rows // rows_per_block)
    return HistTiling("rows", f_tile, s_tile, 1, row_blocks, rows_per_block,
                      s_tile * cell * f_tile + extra_smem)


def plan_hist(n_feat: int, n_slots: int, channels: int, n_bins: int,
              lanes: int, n_rows: int, n_sm: int, *, itemsize: int = 1,
              route: bool = False, path: str | None = None) -> HistTiling:
    """Choose the path and tiling of a histogram launch (`route`: the
    route_hist kernel, whose split tables take shared memory too).

    Without `path`, from _FM_MIN_FEATURES features: "private" when eight
    warp copies fit with the tiles the owned path needs (the root of a tree
    at F = 64, B = 33); else "owned" when one (slot tile, feature tile)
    pair covers the histogram, or two do and every warp owns a slot
    (copies x s_tile >= _FM_WARPS); otherwise "rows" (narrow F, or wide
    histograms split into slot tiles: at B = 257 each slot tile re-reads
    every row while most of its warps own no slot). A given `path` is
    forced (measurement and tests), and raises where it does not fit."""
    n_tables = n_slots if route else 0
    fit = {p: _fm_tiles(n_feat, n_slots, channels, n_bins, itemsize,
                        p == "private", n_tables) for p in PATHS[1:]}
    if path is None:
        path, owned, private = "rows", fit["owned"], fit["private"]
        if n_feat >= _FM_MIN_FEATURES and owned is not None:
            n_st, n_ft, copies = owned
            if private is not None and private[:2] == owned[:2]:
                path = "private"
            elif n_st * n_ft == 1 or (
                    n_st * n_ft == 2
                    and copies * -(-n_slots // n_st) >= _FM_WARPS):
                path = "owned"
    if path == "rows":
        return _plan_rows(n_feat, n_slots, channels, n_bins, lanes, n_rows,
                          n_sm, 3 * 4 * n_tables)
    if path not in PATHS:
        raise ValueError(f"unknown histogram path {path!r}; one of {PATHS}")
    if fit[path] is None:
        raise ValueError(f"path {path!r}: a histogram of {n_bins} bins x "
                         f"{channels} channels does not fit a block's shared "
                         f"memory")
    n_st, n_ft, copies = fit[path]
    s_tile = -(-n_slots // n_st)
    f_tile = -(-n_feat // n_ft)
    smem = fm_smem_bytes(itemsize, f_tile, s_tile, channels, n_bins, copies,
                         path == "private", n_tables)
    rows = _FM_TILE_BYTES // itemsize
    # one block per SM (its threads hold 160+ registers each), every block
    # resident at once, each striding over row tiles
    others = lanes * n_ft * n_st
    chunks = max(1, min(-(-n_rows // rows), n_sm // others))
    return HistTiling(path, f_tile, s_tile, copies, others * chunks, rows,
                      smem)


# -- launch shape of route and table_lookup ----------------------------------

@dataclass(frozen=True)
class LaneTiling:
    """Launch shape of route and table_lookup.

    path "rows" (route_kernel / lookup_kernel, the row-mapped kernels): a
    grid of `blocks` x lanes blocks of `threads`, one row a thread. Route's
    path "staged" (route_staged_kernel): a persistent grid of `blocks`
    blocks of `threads` striding over tiles of 4 x `threads` rows of every
    lane, with `smem_bytes` of dynamic shared memory a block."""

    path: str
    blocks: int
    threads: int
    smem_bytes: int


def route_table_bytes(lanes: int, n_nodes: int) -> int:
    """Shared memory of route's packed split tables (route_table_bytes in
    the source): lanes x (n_nodes + 1) int2, rounded up to 16 bytes."""
    return -(-8 * lanes * (n_nodes + 1) // 16) * 16


def route_staged_bytes(n_feat: int, lanes: int, n_nodes: int,
                       itemsize: int) -> int:
    """Shared memory of one route_staged_kernel block (route_staged_bytes
    in the source): the packed tables, a feature map and list (n_feat
    ints each, rounded up to 16 bytes), and a 512-row tile of the bins of
    at most min(n_feat, lanes x n_nodes) features, 16 bytes more a feature
    (staged_row_bytes: a feature's row need not start on 16 bytes)."""
    return (route_table_bytes(lanes, n_nodes) + -(-8 * n_feat // 16) * 16
            + min(n_feat, lanes * n_nodes) * (_STAGED_ROWS * itemsize + 16))


def _rows_grid(n_rows: int, n_sm: int) -> LaneTiling:
    return LaneTiling("rows", max(1, min(-(-n_rows // _THREADS), 8 * n_sm)),
                      _THREADS, 0)


def plan_route(n_feat: int, n_nodes: int, lanes: int, n_rows: int,
               n_sm: int, *, itemsize: int = 1,
               path: str | None = None) -> LaneTiling:
    """Choose the path and grid of a `route` launch. Without `path`:
    "staged" where its tile fits a block's shared memory and its copy reads
    fewer bytes a row (one bin of each feature the tables may split on,
    min(n_feat, lanes x n_nodes)) than the row-mapped kernel's gathers
    touch (a 32-byte sector a lane), else "rows". The sweep's 5 lanes of
    1-byte bins take the staged path at 8 and 32 nodes; int32 bins (the
    estimator's default of 256 bins) at F = 64, one lane under 32 nodes
    or more, and tables too large for shared memory take the rows path.
    A given `path` is forced (measurement and tests), and raises where it
    does not fit."""
    smem = route_staged_bytes(n_feat, lanes, n_nodes, itemsize)
    if path is None:
        path = ("staged" if smem <= _SMEM_BLOCK_MAX and min(
            n_feat, lanes * n_nodes) * itemsize < _SECTOR * lanes
                else "rows")
    if path not in ROUTE_PATHS:
        raise ValueError(f"unknown route path {path!r}; one of {ROUTE_PATHS}")
    if path == "rows":
        return _rows_grid(n_rows, n_sm)
    if smem > _SMEM_BLOCK_MAX:
        raise ValueError(f"path {path!r}: {smem} B of tables and staged "
                         f"bins do not fit a block's shared memory")
    # as many blocks as stay resident on every SM at once (fewer where
    # shared memory runs out), at most one a tile
    per_sm = min(_STAGED_RESIDENT, _SMEM_SM // (smem + _SMEM_BLOCK_RESERVED))
    return LaneTiling(path, max(1, min(-(-n_rows // _STAGED_ROWS),
                                       per_sm * n_sm)),
                      _STAGED_THREADS, smem)


def plan_lookup(n_leaves: int, lanes: int, n_rows: int, n_sm: int, *,
                path: str | None = None) -> LaneTiling:
    """The grid of a `table_lookup` launch. It has the one path "rows": the
    redesigns measured against it (PERF.md) were no faster. `path` is taken
    as the other dispatchers take it, and raises unless "rows"."""
    if path not in (None, *LOOKUP_PATHS):
        raise ValueError(f"unknown lookup path {path!r}; one of "
                         f"{LOOKUP_PATHS}")
    return _rows_grid(n_rows, n_sm)


# -- checks shared by the CUDA wrappers --------------------------------------

def _is_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU inputs (plain version); False for all-CUDA inputs
    (kernel). Mixed devices or any other device raise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tree kernels take all-CPU or all-CUDA inputs on one "
                     f"device, got {sorted(str(t.device) for t in tensors)}")


def _need(t: torch.Tensor, name: str, dtypes, ndim: int = 2) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_tables(f_lvl, t_lvl, m_lvl, lanes: int, n_nodes: int) -> None:
    for name, t in (("f_lvl", f_lvl), ("t_lvl", t_lvl), ("m_lvl", m_lvl)):
        _need(t, name, (torch.int32,))
        if tuple(t.shape) != (lanes, n_nodes):
            raise ValueError(f"{name}: expected shape {(lanes, n_nodes)}, "
                             f"got {tuple(t.shape)}")


def _lane_channels(pay_t: torch.Tensor, lanes: int, derive_count: bool) -> int:
    if pay_t.shape[0] % lanes:
        raise ValueError(f"pay_t channels {pay_t.shape[0]} not a multiple of "
                         f"{lanes} lanes")
    C = pay_t.shape[0] // lanes
    if C < 1 or C + int(derive_count) > _MAX_CHANNELS:
        raise ValueError(f"{C} payload channels per lane: the kernels take "
                         f"1..{_MAX_CHANNELS - int(derive_count)}")
    return C


# -- B1: multi-lane gradient histograms --------------------------------------

def hist_folds_plain(Xb_t, pay_t, slot_t, *, n_slots: int, n_bins: int,
                     derive_count: bool = False) -> torch.Tensor:
    """Plain version of hist_folds: one scatter-add per (lane, channel) over
    (slot, feature, bin) ids, with a spill segment for dropped rows (slot
    outside [0, n_slots), bin outside [0, n_bins)) — the JAX package's
    `_hist_segment_jnp`."""
    F, N = Xb_t.shape
    Fo = slot_t.shape[0]
    C = pay_t.shape[0] // Fo
    B = n_bins
    seg = n_slots * F * B
    bins = Xb_t.long()
    fb = torch.arange(F, device=Xb_t.device)[:, None] * B + bins   # [F, N]
    bad_bin = (bins < 0) | (bins >= B)
    out = []
    for k in range(Fo):
        pay_k = pay_t[k * C:(k + 1) * C]
        if derive_count:
            pay_k = torch.cat([pay_k, (pay_k[C - 1:C] > 0).float()])
        slot_k = slot_t[k]
        slot_i = slot_k.long()
        drop = (slot_k < 0) | (slot_i >= n_slots)
        ids = torch.where(drop[None, :] | bad_bin, seg,
                          slot_i[None, :] * (F * B) + fb).reshape(-1)
        hist = torch.stack([
            torch.zeros(seg + 1, dtype=torch.float32, device=Xb_t.device)
            .index_add_(0, ids, pay_c.expand(F, N).reshape(-1))[:seg]
            for pay_c in pay_k])                                     # [Co, seg]
        out.append(hist.reshape(-1, n_slots, F * B).transpose(0, 1)
                   .reshape(-1, F * B))
    return torch.cat(out)


def hist_folds(Xb_t: torch.Tensor, pay_t: torch.Tensor, slot_t: torch.Tensor,
               *, n_slots: int, n_bins: int, derive_count: bool = False,
               path: str | None = None) -> torch.Tensor:
    """Gradient histograms [Fo * n_slots * Co, F * n_bins] f32.

    Xb_t [F, N] int bins (int8 / uint8 / int32); pay_t [Fo * C, N] f32
    payload channels, lane-major; slot_t [Fo, N] f32 slot ids (ids outside
    [0, n_slots) drop the row). derive_count appends a unit-count channel
    (last channel > 0), so Co = C + 1. `path` forces the kernel's path
    (`plan_hist`: measurement and tests); the CPU ignores it."""
    _need(Xb_t, "Xb_t", _BIN_KINDS)
    _need(pay_t, "pay_t", (torch.float32,))
    _need(slot_t, "slot_t", (torch.float32,))
    F, N = Xb_t.shape
    Fo = slot_t.shape[0]
    if pay_t.shape[1] != N or slot_t.shape[1] != N:
        raise ValueError("Xb_t, pay_t and slot_t must share the row axis")
    C = _lane_channels(pay_t, Fo, derive_count)
    if _is_cpu(Xb_t, pay_t, slot_t):
        return hist_folds_plain(Xb_t, pay_t, slot_t, n_slots=n_slots,
                                n_bins=n_bins, derive_count=derive_count)
    lib = _build.library()
    Co = C + int(derive_count)
    out = torch.zeros((Fo * n_slots * Co, F * n_bins), dtype=torch.float32,
                      device=Xb_t.device)
    if N == 0:
        return out
    tl = plan_hist(F, n_slots, Co, n_bins, Fo, N, _n_sm(Xb_t.device),
                   itemsize=Xb_t.element_size(), path=path)
    _build.check(lib, lib.tk_hist(
        Xb_t.data_ptr(), _BIN_KINDS[Xb_t.dtype], pay_t.data_ptr(),
        slot_t.data_ptr(), out.data_ptr(), F, N, Fo, C, int(derive_count),
        n_slots, n_bins, _PATH_CODES[tl.path], tl.f_tile, tl.s_tile,
        tl.copies, tl.blocks, tl.rows_per_block, tl.smem_bytes, _stream()),
        "hist_folds")
    _count_launch("hist_folds", F, n_slots)
    return out


# -- B3: level routing --------------------------------------------------------

def route_plain(Xb_t, node_t, f_lvl, t_lvl, m_lvl) -> torch.Tensor:
    """Plain version of route: gather each row's split from its node, then
    its bin of the split feature (the JAX package's `_route_level_jnp`).
    Node ids must lie in [0, n_nodes)."""
    node_i = node_t.long()
    f = torch.gather(f_lvl, 1, node_i).long()
    t = torch.gather(t_lvl, 1, node_i)
    mdir = torch.gather(m_lvl, 1, node_i)
    xsel = torch.gather(Xb_t, 0, f).int()
    right = (xsel > t) | ((xsel == 0) & (mdir > 0))
    return node_t * 2.0 + right.float()


def route(Xb_t: torch.Tensor, node_t: torch.Tensor, f_lvl: torch.Tensor,
          t_lvl: torch.Tensor, m_lvl: torch.Tensor, *,
          n_nodes: int, path: str | None = None) -> torch.Tensor:
    """Next level's node ids [Fo, N] f32 = 2 * node + right, right = bin >
    thresh, or bin 0 (missing) with the node's learned missing direction.
    Xb_t [F, N] int bins; node_t [Fo, N] f32; f/t/m_lvl [Fo, n_nodes]
    int32 split tables. `path` forces the kernel's path (`plan_route`:
    measurement and tests); the CPU ignores it."""
    _need(Xb_t, "Xb_t", _BIN_KINDS)
    _need(node_t, "node_t", (torch.float32,))
    F, N = Xb_t.shape
    Fo = node_t.shape[0]
    if node_t.shape[1] != N:
        raise ValueError("Xb_t and node_t must share the row axis")
    _check_tables(f_lvl, t_lvl, m_lvl, Fo, n_nodes)
    if _is_cpu(Xb_t, node_t, f_lvl, t_lvl, m_lvl):
        return route_plain(Xb_t, node_t, f_lvl, t_lvl, m_lvl)
    lib = _build.library()
    out = torch.empty_like(node_t)
    if out.numel() == 0:
        return out
    tl = plan_route(F, n_nodes, Fo, N, _n_sm(Xb_t.device),
                    itemsize=Xb_t.element_size(), path=path)
    _build.check(lib, lib.tk_route(
        Xb_t.data_ptr(), _BIN_KINDS[Xb_t.dtype], node_t.data_ptr(),
        f_lvl.data_ptr(), t_lvl.data_ptr(), m_lvl.data_ptr(), out.data_ptr(),
        F, N, Fo, n_nodes, _ROUTE_PATH_CODES[tl.path], tl.blocks, tl.threads,
        tl.smem_bytes, _stream()), "route")
    _count_launch("route", F, n_nodes)
    return out


# -- B2: fused route + next-level histogram -----------------------------------

def route_hist_plain(Xb_t, pay_t, node_t, f_lvl, t_lvl, m_lvl, *,
                     n_nodes: int, n_bins: int, derive_count: bool = False):
    """Plain version of route_hist: the plain route, then the plain
    histogram with right rows moved past the slot range."""
    new_node = route_plain(Xb_t, node_t, f_lvl, t_lvl, m_lvl)
    right = new_node - 2.0 * node_t
    slots = node_t + float(n_nodes) * right
    hist = hist_folds_plain(Xb_t, pay_t, slots, n_slots=n_nodes,
                            n_bins=n_bins, derive_count=derive_count)
    return hist, new_node


def route_hist(Xb_t: torch.Tensor, pay_t: torch.Tensor, node_t: torch.Tensor,
               f_lvl: torch.Tensor, t_lvl: torch.Tensor, m_lvl: torch.Tensor,
               *, n_nodes: int, n_bins: int, derive_count: bool = False,
               path: str | None = None):
    """Route one level AND histogram the next level's left children in one
    pass over the binned matrix, for every lane. Returns (hist [Fo *
    n_nodes * Co, F * n_bins], new_node [Fo, N]); a left row's slot is its
    old node id, right rows are dropped (their histograms come from sibling
    subtraction), and new_node is exactly what `route` returns. `path` as
    in `hist_folds`."""
    _need(Xb_t, "Xb_t", _BIN_KINDS)
    _need(pay_t, "pay_t", (torch.float32,))
    _need(node_t, "node_t", (torch.float32,))
    F, N = Xb_t.shape
    Fo = node_t.shape[0]
    if pay_t.shape[1] != N or node_t.shape[1] != N:
        raise ValueError("Xb_t, pay_t and node_t must share the row axis")
    C = _lane_channels(pay_t, Fo, derive_count)
    _check_tables(f_lvl, t_lvl, m_lvl, Fo, n_nodes)
    if _is_cpu(Xb_t, pay_t, node_t, f_lvl, t_lvl, m_lvl):
        return route_hist_plain(Xb_t, pay_t, node_t, f_lvl, t_lvl, m_lvl,
                                n_nodes=n_nodes, n_bins=n_bins,
                                derive_count=derive_count)
    lib = _build.library()
    Co = C + int(derive_count)
    hist = torch.zeros((Fo * n_nodes * Co, F * n_bins), dtype=torch.float32,
                       device=Xb_t.device)
    new_node = torch.empty_like(node_t)
    if N == 0:
        return hist, new_node
    tl = plan_hist(F, n_nodes, Co, n_bins, Fo, N, _n_sm(Xb_t.device),
                   itemsize=Xb_t.element_size(), route=True, path=path)
    _build.check(lib, lib.tk_route_hist(
        Xb_t.data_ptr(), _BIN_KINDS[Xb_t.dtype], pay_t.data_ptr(),
        node_t.data_ptr(), f_lvl.data_ptr(), t_lvl.data_ptr(),
        m_lvl.data_ptr(), hist.data_ptr(), new_node.data_ptr(), F, N, Fo, C,
        int(derive_count), n_nodes, n_bins, _PATH_CODES[tl.path], tl.f_tile,
        tl.s_tile, tl.copies, tl.blocks, tl.rows_per_block, tl.smem_bytes,
        _stream()),
        "route_hist")
    _count_launch("route_hist", F, n_nodes)
    return hist, new_node


# -- B4: per-lane table lookup ------------------------------------------------

def table_lookup_plain(tbl, idx_t) -> torch.Tensor:
    """Plain version of table_lookup: a gather, 0 for ids outside [0, M)."""
    M = tbl.shape[1]
    valid = (idx_t >= 0) & (idx_t < M)
    vals = torch.gather(tbl, 1, idx_t.long().clamp(0, M - 1))
    return torch.where(valid, vals, 0.0)


def table_lookup(tbl: torch.Tensor, idx_t: torch.Tensor, *,
                 path: str | None = None) -> torch.Tensor:
    """out[k, i] = tbl[k, idx_t[k, i]]; ids outside [0, M) (and NaN) give
    0. tbl [Fo, M] f32 (e.g. leaf payloads); idx_t [Fo, N] f32 ids. `path`
    as `plan_lookup` takes it; the CPU ignores it."""
    _need(tbl, "tbl", (torch.float32,))
    _need(idx_t, "idx_t", (torch.float32,))
    Fo, M = tbl.shape
    if idx_t.shape[0] != Fo:
        raise ValueError("tbl and idx_t must share the lane axis")
    if _is_cpu(tbl, idx_t):
        return table_lookup_plain(tbl, idx_t)
    lib = _build.library()
    N = idx_t.shape[1]
    out = torch.empty_like(idx_t)
    if out.numel() == 0:
        return out
    tl = plan_lookup(M, Fo, N, _n_sm(tbl.device), path=path)
    _build.check(lib, lib.tk_lookup(
        tbl.data_ptr(), idx_t.data_ptr(), out.data_ptr(), M, N, Fo,
        tl.blocks, tl.threads, _stream()), "table_lookup")
    _count_launch("table_lookup", 1, M)
    return out


PLAIN = {"hist_folds": hist_folds_plain, "route_hist": route_hist_plain,
         "route": route_plain, "table_lookup": table_lookup_plain}


def kernel_bytes(name: str, F: int, N: int, lanes: int, *, channels: int = 2,
                 xb_itemsize: int = 1, out_cells: int = 0,
                 bins_read: int | None = None) -> int:
    """Bytes a kernel must move at least: each input read once, each output
    written once. `out_cells` counts the histogram outputs (f32);
    `bins_read` the distinct (feature, row) bins a route reads on its data
    (at most min(F, lanes) a row, the count without it)."""
    plane = 4 * N
    if name == "hist_folds":       # Xb + payload + slot planes + histogram
        return (F * N * xb_itemsize + lanes * (channels + 1) * plane
                + 4 * out_cells)
    if name == "route_hist":       # one Xb pass + g/h, node in/out per lane
        return sweep_level_bytes(N, F, lanes, channels=channels,
                                 xb_itemsize=xb_itemsize) + 4 * out_cells
    if name == "route":            # selected bins, node in/out per lane
        bins = min(F, lanes) * N if bins_read is None else bins_read
        return bins * xb_itemsize + lanes * 2 * plane
    if name == "table_lookup":     # ids in, values out
        return lanes * 2 * plane
    raise ValueError(f"unknown kernel {name!r}")

