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
one (measurement and tests). route_hist's "sorted" path lists each lane's
left rows by slot before it counts them; its sort runs alone through
`route_hist_sort`, and `slot_order_plain`, `sorted_pieces` and
`sorted_piece_hist_plain` are the plain versions of its sort and of its
histogram's pieces.

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

A histogram lane may carry any number of channels (a K-class forest's K
class sums, the weight and the count: K + 2). The kernels take at most
_GROUP_CHANNELS a lane, so a wider lane is launched as `channel_groups`
kernel lanes: its derived count becomes a real channel, its channels are
split into groups of equal width (zero-padded), and every group is a lane
of the same launch with the lane's slot or node plane and split tables.
route_hist then routes each row once per group, all alike, and returns
the node ids of each lane's first group.
"""
from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from typing import Optional, Tuple

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
_GROUP_CHANNELS = 4          # channels of one kernel lane (kMaxChannels)
_SMEM_BLOCK_MAX = 232_448    # dynamic shared memory one block may use (H100)
_SMEM_BUDGET = _SMEM_BLOCK_MAX // 2   # rows path: two blocks per SM
_THREADS = 512               # rows paths (kRowThreads, route/lookup rows)
# features path (hist_fm_kernel): kWarps, kTileBytes, kXsStride, kMaxFTile
_FM_WARPS = 8
_FM_TILE_BYTES = 256
_FM_XS_STRIDE = _FM_TILE_BYTES // 4 + 1
_FM_MAX_FTILE = 64
_FM_MIN_FEATURES = 8         # narrower F takes the rows path
# one-slot histograms at equal SM fill: the private path's time over the
# owned path's (hist_folds at F = 64 and 164, B = 33, 3 payload channels +
# count, 5 lanes: 0.87-0.88 on an H100, `tools/hist_paths --kernels roots`)
_PRIVATE_GAIN = 0.88
PATHS = ("rows", "private", "owned", "sorted")
_PATH_CODES = {p: i for i, p in enumerate(PATHS[:3])}   # tk_hist's codes
# route_hist's sorted path (sort_*_kernel, sorted_hist_kernel): the slots
# its sort takes (kMaxSortSlots); the rows of a count unit (at least 4096,
# and 16 a slot, so that the [slot, unit] counts stay a small share of the
# rows); the list entries of a histogram block, at most 64 a bin (rounded
# up to 256: a split slot's flush of B x Co cells a thread stays small
# beside the piece's counting), fewer where that fills the resident blocks
# twice over; the planner takes the path from 32 features (a warp's worth),
# 32 768 rows and 4 resident warps an SM. Below those the rows path or the
# features path was faster on an H100 (`tools/hist_paths --kernels small`
# and `levels`, PERF.md §6: at F = 164 rows wins below 16 000 rows and the
# sorted path from 64 000; at F = 8 rows or owned up to 64 000; at 257
# bins, whose warp histogram of 98.7 KB leaves 2 warps an SM, 17.1-17.2 ms
# against the rows path's 10.5-11.0 at 1M rows)
_SORT_MAX_SLOTS = 4096
_SORT_UNIT_ROWS = 4096
_SORT_UNIT_PER_SLOT = 16
_SORT_PIECE_PER_BIN = 64
_SORTED_MAX_WARPS = 16       # sorted_hist_kernel's block (kSortedMaxThreads)
_SORTED_MIN_FEATURES = 32
_SORTED_MIN_ROWS = 1 << 15
_SORTED_MIN_SM_WARPS = 4
# from this many kernel lanes (a config-fused sweep: configs x folds)
# route_hist takes the sorted path over the owned path too, under the
# gates above: at 40 lanes x 10M rows, F = 64, B = 33, 2 payload channels
# + count, the owned path took 1.5-2.7x the sorted path's time at S =
# 2-16 on an H100 (`tools/hist_paths --kernels fused`, PERF.md §6); the
# private path keeps a tree's first level, where a fit's own one-slot rows
# were not timed on both paths in one call (PERF.md §7)
_SORTED_MIN_LANES = 16
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


# -- the config-fused sweep's lane planner -----------------------------------

# Lanes of one config-fused fit at most (the reference's hand default of
# TMOG_GRID_FUSE_HBM_LANES, which overrides it here too)
GRID_FUSE_LANES = 64
# Share of the device's free bytes one fused fit may hold resident
GRID_FUSE_MEMORY_SHARE = 0.75
# Copies of a lane's deepest full level histogram alive at once in the
# split algebra: the routed half, the parent level, the full level, the
# cumulative G / H / count sums and the two directions' gains
_LEVEL_HIST_COPIES = 8


def _sorted_unit_rows(n_slots: int) -> int:
    return max(_SORT_UNIT_ROWS, _SORT_UNIT_PER_SLOT * n_slots)


# f32 planes a lane holds in a boosted fit's two heaviest phases beyond
# its P = channels - 1 gradient planes (measured on an H100 with
# torch.cuda.memory's history, tools/fit_memory.py): the gradient step
# holds the last round's g and h, the margin, the last round's leaf rows
# and _logistic_grad's five transients (P + 7); a route_hist level holds g
# and h, the payload built of them, the node ids in and out, the margin and
# the leaf rows (2 P + 4), and on the sorted path its workspace
_GRAD_PLANES = 7
_LEVEL_PLANES = 4


def _sorted_level(n_feat: int, n_bins: int, lanes: int, depth: int,
                  n_rows: int, channels: int, itemsize: int,
                  n_sm: Optional[int]) -> Optional[Tuple[int, int]]:
    """(slots, sort rows) of the deepest route_hist level of a depth-`depth`
    fit that takes the sorted path (`plan_hist` with `n_sm` SMs; without
    `n_sm`, every routed level counts as sorted), or None."""
    for d in reversed(range(depth - 1)):
        S = 1 << d
        if n_sm is None:
            return S, _sorted_unit_rows(S)
        try:
            tl = plan_hist(n_feat, S, channels, n_bins, lanes, n_rows, n_sm,
                           itemsize=itemsize, route=True)
        except ValueError:
            continue
        if tl.path == "sorted":
            return S, tl.sort_rows
    return None


def fused_fit_resident_bytes(n_rows: int, n_feat: int, lanes: int,
                             depth: int, n_bins: int, *, channels: int = 3,
                             xb_itemsize: int = 1,
                             n_sm: Optional[int] = None) -> int:
    """Device bytes one fold-fused boosted fit (ops/trees.fit_gbt_folds)
    of `lanes` lanes allocates at its peak above what is allocated at its
    start: its own [F, N] copy of the bins; per lane the larger of the
    gradient step's and a route_hist level's f32 planes (_GRAD_PLANES,
    _LEVEL_PLANES), the level's with the sorted path's workspace
    (`sorted_work_words`) at the deepest level `plan_hist` sends there on
    a card of `n_sm` SMs (every routed level where `n_sm` is None: an upper
    bound); and the split algebra's copies of the deepest full level
    histogram ([2^(depth-1), channels, F, n_bins]). The logistic gradient's
    transients are counted for the squared loss too, which has fewer.
    `fused_fit_bytes` counts the same fit's traffic, not its residency."""
    plane = 4 * n_rows
    pay = channels - 1
    level = (2 * pay + _LEVEL_PLANES) * plane
    sorted_at = _sorted_level(n_feat, n_bins, lanes, depth, n_rows,
                              channels, xb_itemsize, n_sm)
    if sorted_at is not None:
        level += 4 * sorted_work_words(1, n_rows, *sorted_at)
    grad = (pay + _GRAD_PLANES) * plane
    hist = (_LEVEL_HIST_COPIES * 4 * (1 << max(depth - 1, 0)) * channels
            * n_feat * n_bins)
    return n_rows * n_feat * xb_itemsize + lanes * (max(grad, level) + hist)


def grid_fused_resident_bytes(n_rows: int, n_feat: int, chunk: int,
                              n_folds: int, n_configs: int, depth: int,
                              n_bins: int, *, channels: int = 3,
                              xb_itemsize: int = 1,
                              n_sm: Optional[int] = None) -> int:
    """Device bytes a group of `n_configs` same-signature configs holds at
    its peak when it fits `chunk` configs at a time
    (models/trees.mask_fit_scores_grid), above what is allocated when the
    planner is asked: the fit's own (`fused_fit_resident_bytes`) and the
    caller's f32 planes, the configs' weights [chunk, N], the lanes'
    weights [lanes, N] and the margins of the group's earlier fits."""
    lanes = chunk * n_folds
    earlier = max(n_configs - chunk, 0) * n_folds
    return (4 * n_rows * (chunk + lanes + earlier)
            + fused_fit_resident_bytes(n_rows, n_feat, lanes, depth, n_bins,
                                       channels=channels,
                                       xb_itemsize=xb_itemsize, n_sm=n_sm))


def grid_fuse_lane_cap() -> int:
    """Lanes of one fused fit at most: TMOG_GRID_FUSE_HBM_LANES, else
    GRID_FUSE_LANES."""
    return int(os.environ.get("TMOG_GRID_FUSE_HBM_LANES",
                              str(GRID_FUSE_LANES)))


def _kernel_paths_fit(n_feat: int, n_bins: int, lanes: int, depth: int,
                      n_rows: int, channels: int, itemsize: int,
                      n_sm: int) -> bool:
    """Do the launch planners find a path for every launch of a depth-
    `depth` fit at `lanes` lanes: the root histogram, route_hist at 1 ...
    2^(depth-2) slots, the last level's route and the leaf lookup?"""
    try:
        plan_hist(n_feat, 1, channels, n_bins, lanes, n_rows, n_sm,
                  itemsize=itemsize)
        for d in range(depth - 1):
            plan_hist(n_feat, 1 << d, channels, n_bins, lanes, n_rows, n_sm,
                      itemsize=itemsize, route=True)
        plan_route(n_feat, 1 << (depth - 1), lanes, n_rows, n_sm,
                   itemsize=itemsize)
        plan_lookup(1 << depth, lanes, n_rows, n_sm)
    except ValueError:
        return False
    return True


def plan_lane_chunk(n_feat: int, n_bins: int, n_folds: int, n_configs: int,
                    depth: int, n_rows: int, *, channels: int = 3,
                    device=None, xb_itemsize: int = 1) -> int:
    """Configs a config-fused fit takes at once (lanes = chunk x folds):
    the largest chunk, halving from `n_configs` as the reference's
    planner does, whose lanes pass every check; 0 where one config's fold
    lanes already fail (the caller then fits config by config).

    Checks: lanes <= `grid_fuse_lane_cap()`; on a CUDA `device`, also the
    group's resident bytes at that chunk (`grid_fused_resident_bytes`)
    within GRID_FUSE_MEMORY_SHARE of the bytes free to the allocator (the
    device's free bytes plus the allocator's cached, unused ones), and a
    launch path from `plan_hist`, `plan_route` and `plan_lookup` for every
    level. On the CPU the lane cap alone decides. The reference's v5e
    VMEM and out-block caps guard Mosaic compiles and have no counterpart
    here. `n_bins` counts the missing bin (max_bins + 1)."""
    cap = grid_fuse_lane_cap()
    dev = None if device is None else torch.device(device)
    cuda = dev is not None and dev.type == "cuda"
    if cuda:
        free, _ = torch.cuda.mem_get_info(dev)
        free += torch.cuda.memory_reserved(dev) - \
            torch.cuda.memory_allocated(dev)
        budget = GRID_FUSE_MEMORY_SHARE * free
        n_sm = _n_sm(dev)

    def ok(chunk: int) -> bool:
        lanes = chunk * n_folds
        if lanes > cap:
            return False
        if not cuda:
            return True
        return (grid_fused_resident_bytes(
            n_rows, n_feat, chunk, n_folds, n_configs, depth, n_bins,
            channels=channels, xb_itemsize=xb_itemsize, n_sm=n_sm) <= budget
            and _kernel_paths_fit(n_feat, n_bins, lanes, depth, n_rows,
                                  channels, xb_itemsize, n_sm))

    chunk = max(n_configs, 1)
    while chunk > 1 and not ok(chunk):
        chunk = (chunk + 1) // 2
    return chunk if ok(chunk) else 0


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
    `rows_per_block` rows. Path "sorted" (route_hist only): a sort of each
    lane's left rows by slot in units of `sort_rows` rows, then one block
    per (piece of `rows_per_block` list entries, lane x feature tile),
    `blocks` pieces a lane (as many as N rows could fill), a warp per 32
    of the tile's `f_tile` features; `s_tile` is every slot."""

    path: str
    f_tile: int
    s_tile: int
    copies: int
    blocks: int
    rows_per_block: int
    smem_bytes: int
    sort_rows: int = 0


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


def sorted_smem_bytes(f_tile: int, n_bins: int, channels: int) -> int:
    """Shared memory of one sorted_hist_kernel block (sorted_smem_bytes in
    the source): a [B, Co, 32] f32 histogram for each warp of 32 features."""
    return 4 * f_tile * n_bins * channels


def sorted_work_words(lanes: int, n_rows: int, n_slots: int,
                      sort_rows: int) -> int:
    """Words of the sorted path's workspace (sorted_work_words in the
    source): per lane a float4 payload, a row id and a slot for each row
    the list may hold, the [S, units] counts and the S + 1 slot starts."""
    return lanes * (6 * n_rows + n_slots * -(-n_rows // sort_rows)
                    + n_slots + 1)


def _sorted_sm_blocks(smem: int) -> int:
    """sorted_hist_kernel blocks of `smem` bytes resident on one SM."""
    return _SMEM_SM // (smem + _SMEM_BLOCK_RESERVED)


def _plan_sorted(n_feat, n_slots, channels, n_bins, lanes, n_rows, n_sm):
    """Sorted path: as many warps (32 features each) a block as keep two
    blocks resident on an SM (at least one), in feature tiles of equal
    width; pieces of at most 64 list entries a bin, fewer where the lanes'
    lists (about half the rows each) would not fill the resident blocks
    twice; None where one warp's histogram does not fit a block or the
    slots do not fit the sort's shared memory."""
    per_warp = sorted_smem_bytes(32, n_bins, channels)
    if per_warp > _SMEM_BLOCK_MAX or n_slots > _SORT_MAX_SLOTS:
        return None
    groups = -(-n_feat // 32)
    two = (_SMEM_SM // 2 - _SMEM_BLOCK_RESERVED) // per_warp
    warps = max(1, min(groups, two, _SORTED_MAX_WARPS))
    n_ft = -(-groups // warps)
    warps = -(-groups // n_ft)
    smem = sorted_smem_bytes(32 * warps, n_bins, channels)
    fill = -(-2 * n_sm * _sorted_sm_blocks(smem) // (lanes * n_ft))
    piece = min(-(-_SORT_PIECE_PER_BIN * n_bins // 256),
                max(1, -(-n_rows // (2 * 256 * fill)))) * 256
    return HistTiling("sorted", 32 * warps, n_slots, 1,
                      -(-n_rows // piece), piece, smem,
                      max(_SORT_UNIT_ROWS, _SORT_UNIT_PER_SLOT * n_slots))


def channel_groups(channels: int) -> tuple:
    """(groups, channels a group) of a lane of `channels` cells: one group
    up to _GROUP_CHANNELS, else the fewest groups of at most that many,
    all of one width (the last zero-padded)."""
    groups = -(-channels // _GROUP_CHANNELS)
    return groups, -(-channels // groups)


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
    at F = 64, B = 33). At one slot where they fit with more feature
    tiles, "private" unless its grid fills the SMs' waves so much worse
    than the owned path's that its copies' gain (_PRIVATE_GAIN) is lost (a
    forest root at F = 164 with 4 channels: private, under half the rows
    path's time; at F = 512 its 16 feature tiles x 5 lanes leave 52 of 132
    SMs idle: owned). Otherwise "owned"
    when one (slot tile, feature tile) pair covers the histogram, or two
    do and every warp owns
    a slot (copies x s_tile >= _FM_WARPS); otherwise "rows" (narrow F, or
    wide histograms split into slot tiles: at B = 257 each slot tile
    re-reads every row while most of its warps own no slot). Where that
    leaves route_hist on "rows", "sorted" from _SORTED_MIN_FEATURES
    features and _SORTED_MIN_ROWS rows where it keeps
    _SORTED_MIN_SM_WARPS warps resident an SM: its lists read only each
    slot's own rows, once (every deeper level of a wide tree, B = 65
    included; 257 bins keep the rows path). From _SORTED_MIN_LANES
    kernel lanes (a config-fused sweep's 40) route_hist takes "sorted"
    under the same gates where the others leave it on "owned" too. A
    given `path` is forced (measurement and tests), and raises where it
    does not fit. `channels` and `lanes` are the histogram's own: a lane of more
    than _GROUP_CHANNELS channels is planned as the launch takes it,
    `channel_groups` lanes of fewer."""
    if channels > _GROUP_CHANNELS:
        groups, channels = channel_groups(channels)
        lanes *= groups
    n_tables = n_slots if route else 0
    fit = {p: _fm_tiles(n_feat, n_slots, channels, n_bins, itemsize,
                        p == "private", n_tables) for p in ("private",
                                                            "owned")}
    fit["sorted"] = _plan_sorted(n_feat, n_slots, channels, n_bins, lanes,
                                 n_rows, n_sm) if route else None
    if path is None:
        path, owned, private = "rows", fit["owned"], fit["private"]
        if n_feat >= _FM_MIN_FEATURES and owned is not None:
            n_st, n_ft, copies = owned
            def fill(p):   # blocks over the SM slots of their waves
                b = plan_hist(n_feat, n_slots, channels, n_bins, lanes,
                              n_rows, n_sm, itemsize=itemsize, route=route,
                              path=p).blocks
                return b / (n_sm * -(-b // n_sm))
            if private is not None and private[:2] == owned[:2]:
                path = "private"
            elif private is not None and n_slots == 1:
                path = "private" if (fill("private")
                                     >= _PRIVATE_GAIN * fill("owned")) \
                    else "owned"
            elif n_st * n_ft == 1 or (
                    n_st * n_ft == 2
                    and copies * -(-n_slots // n_st) >= _FM_WARPS):
                path = "owned"
        tl = fit["sorted"]
        if ((path == "rows"
             or (path == "owned" and lanes >= _SORTED_MIN_LANES))
                and tl is not None
                and n_feat >= _SORTED_MIN_FEATURES
                and n_rows >= _SORTED_MIN_ROWS
                and _sorted_sm_blocks(tl.smem_bytes) * tl.f_tile // 32
                >= _SORTED_MIN_SM_WARPS):
            path = "sorted"
    if path == "rows":
        return _plan_rows(n_feat, n_slots, channels, n_bins, lanes, n_rows,
                          n_sm, 3 * 4 * n_tables)
    if path not in PATHS:
        raise ValueError(f"unknown histogram path {path!r}; one of {PATHS}")
    if path == "sorted" and not route:
        raise ValueError("path 'sorted' is route_hist's alone: hist_folds "
                         "has no routing to sort its rows")
    if fit[path] is None:
        raise ValueError(f"path {path!r}: a histogram of {n_bins} bins x "
                         f"{channels} channels at {n_slots} slots does not "
                         f"fit a block's shared memory")
    if path == "sorted":
        return fit[path]
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
    if lanes < 1 or pay_t.shape[0] % lanes:
        raise ValueError(f"pay_t channels {pay_t.shape[0]} not a multiple of "
                         f"{lanes} lanes")
    C = pay_t.shape[0] // lanes
    if C < 1:
        raise ValueError("a lane needs at least one payload channel")
    return C


def _grouped(pay_t, plane, lanes: int, C: int, derive_count: bool):
    """The launch inputs of lanes wider than _GROUP_CHANNELS: (payload
    [lanes * groups * width, N], plane [lanes * groups, N], groups, width);
    the count channel made real, each group a lane of its own."""
    N = pay_t.shape[1]
    p = pay_t.reshape(lanes, C, N)
    if derive_count:
        p = torch.cat([p, (p[:, C - 1:C] > 0).to(p.dtype)], dim=1)
    Co = p.shape[1]
    groups, width = channel_groups(Co)
    if groups * width > Co:
        p = torch.cat([p, p.new_zeros(lanes, groups * width - Co, N)], dim=1)
    return (p.reshape(-1, N), plane.repeat_interleave(groups, dim=0),
            groups, width)


def _ungrouped(hist, lanes: int, groups: int, width: int, n_slots: int,
               Co: int) -> torch.Tensor:
    """A grouped launch's histograms back in the lane's layout [lanes *
    n_slots * Co, F * B]."""
    FB = hist.shape[1]
    return (hist.reshape(lanes, groups, n_slots, width, FB).transpose(1, 2)
            .reshape(lanes, n_slots, groups * width, FB)[:, :, :Co]
            .reshape(lanes * n_slots * Co, FB))


# -- B1: multi-lane gradient histograms --------------------------------------

def hist_folds_plain(Xb_t, pay_t, slot_t, *, n_slots: int, n_bins: int,
                     derive_count: bool = False) -> torch.Tensor:
    """Plain version of hist_folds: one scatter-add per (lane, channel) over
    (slot, feature, bin) ids of the entries a histogram keeps — the JAX
    package's `_hist_segment_jnp` without its spill segment: a dropped row
    (slot outside [0, n_slots)) or a bin outside [0, n_bins) adds nothing.
    The kept entries add in the same order, so the sums are the same. It
    sums in the payload's dtype (float64 payloads give the float64 sums the
    kernels' cells are checked against)."""
    F, N = Xb_t.shape
    Fo = slot_t.shape[0]
    C = pay_t.shape[0] // Fo
    B = n_bins
    seg = n_slots * F * B
    bins = Xb_t.long()
    fb = torch.arange(F, device=Xb_t.device)[:, None] * B + bins   # [F, N]
    good = (bins >= 0) & (bins < B)
    bad_bins = not bool(good.all())
    out = []
    for k in range(Fo):
        pay_k = pay_t[k * C:(k + 1) * C]
        if derive_count:
            pay_k = torch.cat([pay_k, (pay_k[C - 1:C] > 0).to(pay_k.dtype)])
        slot_i = slot_t[k].long()
        rows = ((slot_t[k] >= 0) & (slot_i < n_slots)).nonzero()[:, 0]
        keep = good[:, rows]

        def kept(t):   # [F, rows] -> its kept entries, row-major
            return t[keep] if bad_bins else t.reshape(-1)
        ids = kept(slot_i[rows][None, :] * (F * B) + fb[:, rows])
        hist = torch.stack([
            torch.zeros(seg, dtype=pay_t.dtype, device=Xb_t.device)
            .index_add_(0, ids, kept(p[rows].expand(F, -1)))
            for p in pay_k])                                         # [Co, seg]
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
    if N == 0:
        return torch.zeros((Fo * n_slots * Co, F * n_bins),
                           dtype=torch.float32, device=Xb_t.device)
    tl = plan_hist(F, n_slots, Co, n_bins, Fo, N, _n_sm(Xb_t.device),
                   itemsize=Xb_t.element_size(), path=path)
    groups, lanes, derive = 1, Fo, int(derive_count)
    if Co > _GROUP_CHANNELS:
        pay_t, slot_t, groups, C = _grouped(pay_t, slot_t, Fo, C,
                                            derive_count)
        lanes, derive = Fo * groups, 0
    out = torch.zeros((lanes * n_slots * (C + derive), F * n_bins),
                      dtype=torch.float32, device=Xb_t.device)
    _build.check(lib, lib.tk_hist(
        Xb_t.data_ptr(), _BIN_KINDS[Xb_t.dtype], pay_t.data_ptr(),
        slot_t.data_ptr(), out.data_ptr(), F, N, lanes, C, derive,
        n_slots, n_bins, _PATH_CODES[tl.path], tl.f_tile, tl.s_tile,
        tl.copies, tl.blocks, tl.rows_per_block, tl.smem_bytes, _stream()),
        "hist_folds")
    _count_launch("hist_folds", F, n_slots)
    return out if groups == 1 else _ungrouped(out, Fo, groups, C, n_slots,
                                              Co)


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
                     n_nodes: int, n_bins: int, derive_count: bool = False,
                     xb_rows=None):
    """Plain version of route_hist: the plain route, then the plain
    histogram with right rows moved past the slot range. `xb_rows` (the
    row-major bins of the sorted path) is ignored."""
    new_node = route_plain(Xb_t, node_t, f_lvl, t_lvl, m_lvl)
    right = new_node - 2.0 * node_t
    slots = node_t + float(n_nodes) * right
    hist = hist_folds_plain(Xb_t, pay_t, slots, n_slots=n_nodes,
                            n_bins=n_bins, derive_count=derive_count)
    return hist, new_node


def _route_hist_args(Xb_t, pay_t, node_t, f_lvl, t_lvl, m_lvl, n_nodes,
                     derive_count, xb_rows):
    """Check route_hist's inputs; (F, N, lanes, payload channels a lane,
    on the CPU)."""
    _need(Xb_t, "Xb_t", _BIN_KINDS)
    _need(pay_t, "pay_t", (torch.float32,))
    _need(node_t, "node_t", (torch.float32,))
    F, N = Xb_t.shape
    Fo = node_t.shape[0]
    if pay_t.shape[1] != N or node_t.shape[1] != N:
        raise ValueError("Xb_t, pay_t and node_t must share the row axis")
    C = _lane_channels(pay_t, Fo, derive_count)
    _check_tables(f_lvl, t_lvl, m_lvl, Fo, n_nodes)
    tensors = [Xb_t, pay_t, node_t, f_lvl, t_lvl, m_lvl]
    if xb_rows is not None:
        _need(xb_rows, "xb_rows", (Xb_t.dtype,))
        if tuple(xb_rows.shape) != (N, F):
            raise ValueError(f"xb_rows: expected the bins row-major, shape "
                             f"{(N, F)}, got {tuple(xb_rows.shape)}")
        tensors.append(xb_rows)
    return F, N, Fo, C, _is_cpu(*tensors)


def _kernel_lanes(pay_t, node_t, tables, Fo: int, C: int,
                  derive_count: bool):
    """route_hist's launch lanes: (payload, node plane, split tables,
    groups, kernel lanes, channels and derive of a kernel lane); a lane of
    more than _GROUP_CHANNELS channels as `channel_groups` kernel lanes
    that share its node plane and tables."""
    if C + int(derive_count) <= _GROUP_CHANNELS:
        return pay_t, node_t, tables, 1, Fo, C, int(derive_count)
    pay_t, node_t, groups, C = _grouped(pay_t, node_t, Fo, C, derive_count)
    return (pay_t, node_t,
            tuple(t.repeat_interleave(groups, dim=0) for t in tables),
            groups, Fo * groups, C, 0)


def _launch_sorted(lib, tl, Xb_t, xb_rows, pay_t, node_t, f_lvl, t_lvl,
                   m_lvl, lanes, C, derive, n_nodes, n_bins, hist=True):
    """The sorted path on kernel lanes (channel groups made already):
    (hist [lanes * n_nodes * (C + derive), F * n_bins] or None without
    `hist`, new_node [lanes, N], the workspace of int32 words). Without
    `xb_rows` the launch makes its own row-major copy of the bins."""
    F, N = Xb_t.shape
    if xb_rows is None:
        xb_rows = Xb_t.T.contiguous()
    work = torch.empty(sorted_work_words(lanes, N, n_nodes, tl.sort_rows),
                       dtype=torch.int32, device=Xb_t.device)
    out = torch.zeros((lanes * n_nodes * (C + derive), F * n_bins),
                      dtype=torch.float32, device=Xb_t.device) \
        if hist else None
    new_node = torch.empty_like(node_t)
    _build.check(lib, lib.tk_route_hist_sorted(
        Xb_t.data_ptr(), xb_rows.data_ptr(), _BIN_KINDS[Xb_t.dtype],
        pay_t.data_ptr(), node_t.data_ptr(), f_lvl.data_ptr(),
        t_lvl.data_ptr(), m_lvl.data_ptr(),
        out.data_ptr() if hist else None, new_node.data_ptr(),
        work.data_ptr(), F, N, lanes, C, derive, n_nodes, n_bins, tl.f_tile,
        tl.sort_rows, tl.rows_per_block, int(hist), tl.smem_bytes,
        _stream()), "route_hist")
    return out, new_node, work


def route_hist(Xb_t: torch.Tensor, pay_t: torch.Tensor, node_t: torch.Tensor,
               f_lvl: torch.Tensor, t_lvl: torch.Tensor, m_lvl: torch.Tensor,
               *, n_nodes: int, n_bins: int, derive_count: bool = False,
               path: str | None = None, xb_rows: torch.Tensor | None = None):
    """Route one level AND histogram the next level's left children in one
    pass over the binned matrix, for every lane. Returns (hist [Fo *
    n_nodes * Co, F * n_bins], new_node [Fo, N]); a left row's slot is its
    old node id, right rows are dropped (their histograms come from sibling
    subtraction), and new_node is exactly what `route` returns. `path` as
    in `hist_folds`. `xb_rows` [N, F], the same bins row-major, is what
    the sorted path reads a listed row's bins from (a fit makes it once);
    without it that path copies the bins itself, and every other path and
    the CPU ignore it."""
    F, N, Fo, C, cpu = _route_hist_args(Xb_t, pay_t, node_t, f_lvl, t_lvl,
                                        m_lvl, n_nodes, derive_count,
                                        xb_rows)
    if cpu:
        return route_hist_plain(Xb_t, pay_t, node_t, f_lvl, t_lvl, m_lvl,
                                n_nodes=n_nodes, n_bins=n_bins,
                                derive_count=derive_count)
    lib = _build.library()
    Co = C + int(derive_count)
    if N == 0:
        return (torch.zeros((Fo * n_nodes * Co, F * n_bins),
                            dtype=torch.float32, device=Xb_t.device),
                torch.empty_like(node_t))
    tl = plan_hist(F, n_nodes, Co, n_bins, Fo, N, _n_sm(Xb_t.device),
                   itemsize=Xb_t.element_size(), route=True, path=path)
    pay_t, node_t, (f_lvl, t_lvl, m_lvl), groups, lanes, C, derive = \
        _kernel_lanes(pay_t, node_t, (f_lvl, t_lvl, m_lvl), Fo, C,
                      derive_count)
    if tl.path == "sorted":
        hist, new_node, _ = _launch_sorted(
            lib, tl, Xb_t, xb_rows, pay_t, node_t, f_lvl, t_lvl, m_lvl,
            lanes, C, derive, n_nodes, n_bins)
    else:
        hist = torch.zeros((lanes * n_nodes * (C + derive), F * n_bins),
                           dtype=torch.float32, device=Xb_t.device)
        new_node = torch.empty_like(node_t)
        _build.check(lib, lib.tk_route_hist(
            Xb_t.data_ptr(), _BIN_KINDS[Xb_t.dtype], pay_t.data_ptr(),
            node_t.data_ptr(), f_lvl.data_ptr(), t_lvl.data_ptr(),
            m_lvl.data_ptr(), hist.data_ptr(), new_node.data_ptr(), F, N,
            lanes, C, derive, n_nodes, n_bins, _PATH_CODES[tl.path],
            tl.f_tile, tl.s_tile, tl.copies, tl.blocks, tl.rows_per_block,
            tl.smem_bytes, _stream()),
            "route_hist")
    _count_launch("route_hist", F, n_nodes)
    if groups == 1:
        return hist, new_node
    return (_ungrouped(hist, Fo, groups, C, n_nodes, Co),
            new_node[::groups].contiguous())


def route_hist_sort(Xb_t: torch.Tensor, pay_t: torch.Tensor,
                    node_t: torch.Tensor, f_lvl: torch.Tensor,
                    t_lvl: torch.Tensor, m_lvl: torch.Tensor, *,
                    n_nodes: int, n_bins: int, derive_count: bool = False,
                    xb_rows: torch.Tensor | None = None):
    """The sorted path's sort alone, on the card, as route_hist would
    launch it (its first three kernels): (new_node [Fo, N], order [Fo, N]
    int32 row ids, start [Fo, n_nodes + 1] int32) of each lane, its list as
    sorted_hist_kernel reads it (entries past start[:, -1] are unset).
    For the card tests, against `slot_order_plain`, and for timing the
    sort's share of a launch; it counts no launch."""
    F, N, Fo, C, cpu = _route_hist_args(Xb_t, pay_t, node_t, f_lvl, t_lvl,
                                        m_lvl, n_nodes, derive_count,
                                        xb_rows)
    if cpu:
        raise ValueError("route_hist_sort runs the sorted path's sort on a "
                         "CUDA device; its plain version is "
                         "slot_order_plain")
    if N == 0:
        return (torch.empty_like(node_t),
                torch.empty((Fo, 0), dtype=torch.int32, device=node_t.device),
                torch.zeros((Fo, n_nodes + 1), dtype=torch.int32,
                            device=node_t.device))
    Co = C + int(derive_count)
    tl = plan_hist(F, n_nodes, Co, n_bins, Fo, N, _n_sm(Xb_t.device),
                   itemsize=Xb_t.element_size(), route=True, path="sorted")
    pay_t, node_t, (f_lvl, t_lvl, m_lvl), groups, lanes, C, derive = \
        _kernel_lanes(pay_t, node_t, (f_lvl, t_lvl, m_lvl), Fo, C,
                      derive_count)
    _, new_node, work = _launch_sorted(
        _build.library(), tl, Xb_t, xb_rows, pay_t, node_t, f_lvl, t_lvl,
        m_lvl, lanes, C, derive, n_nodes, n_bins, hist=False)
    LN = lanes * N
    order = work[4 * LN:5 * LN].view(lanes, N)[::groups]
    start = work[-lanes * (n_nodes + 1):].view(lanes, n_nodes + 1)[::groups]
    return new_node[::groups], order, start


def slot_order_plain(node_t: torch.Tensor, new_node: torch.Tensor,
                     n_nodes: int):
    """Plain version of the sorted path's sort: each lane's list of the
    rows its histogram counts (node id in [0, n_nodes) and routed left:
    new id = 2 x node), ordered by slot (the node id, truncated), rows
    ascending inside a slot. Returns (order [Fo, N] int64 row ids, -1 past
    each lane's count; start [Fo, n_nodes + 1] int64: slot s's first
    entry, and the lane's count last)."""
    Fo, N = node_t.shape
    left = (node_t >= 0) & (node_t < n_nodes) & (new_node == 2.0 * node_t)
    slot = torch.where(left, node_t, float(n_nodes)).long()
    order = torch.sort(slot, dim=1, stable=True).indices
    counts = torch.zeros((Fo, n_nodes + 1), dtype=torch.long,
                         device=node_t.device).scatter_add_(
        1, slot, torch.ones_like(slot))[:, :n_nodes]
    start = torch.cat([counts.new_zeros((Fo, 1)), counts.cumsum(1)], 1)
    listed = torch.arange(N, device=node_t.device)[None, :] < start[:, -1:]
    return torch.where(listed, order, -1), start


def sorted_pieces(start: torch.Tensor, piece_rows: int) -> list:
    """The sorted path's pieces [(lane, p0, p1)]: each lane's list cut into
    runs of `piece_rows` entries, one sorted_hist_kernel block each (for
    every feature tile)."""
    return [(k, p0, min(n, p0 + piece_rows))
            for k, n in enumerate(start[:, -1].tolist())
            for p0 in range(0, n, piece_rows)]


def sorted_piece_hist_plain(Xb_t, pay_t, order, start, piece, *,
                            n_nodes: int, n_bins: int,
                            derive_count: bool = False) -> torch.Tensor:
    """Plain version of one sorted_hist_kernel piece (lane, p0, p1): the
    histogram [n_nodes * Co, F * n_bins] that lane's listed rows order[lane,
    p0:p1] add, each into the slot whose run of the list holds its entry.
    The pieces' histograms of a lane sum to its histogram."""
    k, p0, p1 = piece
    rows = order[k, p0:p1]
    slot = torch.searchsorted(start[k, 1:].contiguous(),
                              torch.arange(p0, p1, device=order.device),
                              right=True)
    C = pay_t.shape[0] // order.shape[0]
    return hist_folds_plain(Xb_t[:, rows], pay_t[k * C:(k + 1) * C][:, rows],
                            slot.float()[None], n_slots=n_nodes,
                            n_bins=n_bins, derive_count=derive_count)


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

