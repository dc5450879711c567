"""Histogram trees in PyTorch (counterpart of ops/trees.py).

Quantile binning with a dedicated missing bin (resident: `quantile_edges`,
`bin_matrix`; streamed from a tileplane RowSource larger than the device's
memory: `stream_quantile_edges`, `stream_bin_matrix`, the same binning
rule `_bin_block`), and one level-wise grower,
`_grow_tree_folds`, which grows one tree per lane over ONE binned matrix;
every tree family is a caller of it: the fold-fused boosted fit
`fit_gbt_folds` (XGBoost, Spark GBT; `fit_gbt` is its one-lane form), the
softmax boosted fit `fit_gbt_softmax_folds` (multiclass XGBoost: each
round's class trees are lanes of one growth), the random forest
`fit_forest_folds` (`fit_forest`, decision trees; a K-class forest's lanes
carry K + 2 histogram channels), and the single tree `grow_tree`. Each level is one pass of a kernel in
ops/tree_kernels.py: the root histogram (`hist_folds`), a fused route +
next-level histogram (`route_hist`) for every mid level, the final `route`
and the leaf `table_lookup`. The split algebra between passes (cumulative
sums over the bin axis, sparsity-aware gains, argmax, Newton or mean
leaves) is tensor code on [Fo, nodes, K + 2, F, B] sums.

Trees are complete binary trees of static depth in heap layout (`Tree`).
Bins are shifted: 0 is the missing bin, present values occupy [1, n_bins],
and each node learns the direction of missing rows (`miss`). A node that
does not split is encoded as (feat 0, thresh n_bins, miss 0): every row
goes left.

Node ids are f32 [Fo, N], as in the JAX package, so the kernels and the
reference exchange like with like. Random draws come from explicit torch
Generators: a forest's from a draws object (`ForestDraws`: row_weights(t),
node_masks(t)); they are not the JAX package's threefry bits, so the tests
feed the reference's draws in through a stand-in of that object.
The refit of a single model is the same fit with one lane.

The boosted fit's split and leaf scalars (`LANE_KEYS`: learning rate, L2,
minimum child weight, gamma) may be one float for every lane or a [lanes]
tensor, one value a lane: the config-fused sweep fits the lanes of several
grid points, (config, fold) pairs, in one growth.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import tree_kernels as TK

EPS = 1e-12
# fit_gbt_folds' scalars that may vary a lane (the config-fused sweep's
# per-lane algebra); every other argument is shared by the lanes
LANE_KEYS = ("learning_rate", "reg_lambda", "min_child_weight", "gamma")
LaneScalar = Union[float, torch.Tensor]
_QUANTILE_SAMPLE = 131_072
_BIN_CHUNK = 1 << 20      # rows per binning chunk (bounds the temporaries)


class Tree(NamedTuple):
    """Complete binary trees in heap layout; leading axes batch trees."""
    feat: torch.Tensor    # int32 [..., 2^depth - 1] split feature id
    thresh: torch.Tensor  # int32 [..., 2^depth - 1] go right iff bin > thresh
    leaf: torch.Tensor    # f32   [..., 2^depth, K] leaf payload
    miss: torch.Tensor    # int32 [..., 2^depth - 1] 1 = missing goes right


# -- binning ------------------------------------------------------------------

def quantile_edges(X: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature quantile bin edges over PRESENT values: X [n, d] ->
    edges [d, n_bins - 1] f32.

    Above 131,072 rows a strided sample is taken (the XGBoost `hist`
    sketch). The linear interpolation of the JAX package's nanquantile is
    written out here, so both packages give the same edges: sort
    with NaN last, position q * (count - 1), low/high neighbours weighted
    (1 - frac, frac). An all-NaN feature yields NaN edges."""
    n = X.shape[0]
    if n > _QUANTILE_SAMPLE:
        X = X[::-(-n // _QUANTILE_SAMPLE)]
    X = X.to(torch.float32)
    qs = torch.arange(1, n_bins, dtype=torch.float32, device=X.device) / n_bins
    srt = torch.sort(X, dim=0).values                         # NaN sorts last
    counts = (~torch.isnan(X)).sum(0).to(torch.float32)       # [d]
    pos = qs[:, None] * (counts[None, :] - 1.0)               # [q, d]
    low = torch.floor(pos)
    high = torch.ceil(pos)
    hi_w = pos - low
    lo_w = 1.0 - hi_w
    top = counts[None, :] - 1.0
    low = torch.clamp(torch.minimum(low, top), min=0.0).long()
    high = torch.clamp(torch.minimum(high, top), min=0.0).long()
    # round(lo * lo_w) + hi * hi_w with the second product unrounded: the
    # reference's compiler fuses it into a multiply-add, and f64 holds an
    # f32 x f32 product exactly, so the edges agree bit for bit
    lo_part = torch.gather(srt, 0, low) * lo_w
    edges = (torch.gather(srt, 0, high).double() * hi_w.double()
             + lo_part.double()).to(torch.float32)
    return edges.T.contiguous()


def bin_dtype(n_bins: int) -> torch.dtype:
    """Narrowest integer dtype holding shifted bins [0, n_bins]: int8 up to
    127 quantile bins, uint8 up to 255, int32 beyond."""
    if n_bins <= 127:
        return torch.int8
    return torch.uint8 if n_bins <= 255 else torch.int32


def bin_matrix(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Digitize with a dedicated missing bin: NaN -> 0, present values ->
    1 + #edges <= x (right-side search). X [n, d], edges [d, n_bins - 1] ->
    bin_dtype [n, d] in [0, n_bins].

    The search is the JAX package's binary search step for step (go left
    while x < edge; a NaN edge sorts last), so both packages bin every
    value alike even where edges repeat."""
    N, d = X.shape
    out = torch.empty((N, d), dtype=bin_dtype(edges.shape[1] + 1),
                      device=X.device)
    edges_t = edges.T.contiguous()                            # [E, d]
    for r0 in range(0, N, _BIN_CHUNK):
        out[r0:r0 + _BIN_CHUNK] = _bin_block(X[r0:r0 + _BIN_CHUNK],
                                             edges_t)
    return out


def _bin_block(xb: torch.Tensor, edges_t: torch.Tensor) -> torch.Tensor:
    """THE binning rule for one row block ([c, d] against edges_t [E, d]):
    the resident `bin_matrix` and the streamed `stream_bin_matrix` share
    it, so the two cannot drift. Returns int64 bins in [0, E + 1]."""
    E = edges_t.shape[0]
    levels = math.ceil(math.log2(E + 1))
    nan_edge = torch.isnan(edges_t)
    x = xb.to(torch.float32)
    missing = torch.isnan(x)
    x = torch.where(missing, -math.inf, x)
    low = torch.zeros(x.shape, dtype=torch.long, device=x.device)
    high = torch.full(x.shape, E, dtype=torch.long, device=x.device)
    for _ in range(levels):
        mid = torch.clamp((low + high) // 2, max=E - 1)
        left = (x < torch.gather(edges_t, 0, mid)) \
            | torch.gather(nan_edge, 0, mid)
        low = torch.where(left, low, mid)
        high = torch.where(left, mid, high)
    return torch.where(missing, 0, high + 1)


# -- streamed binning (tileplane) --------------------------------------------

def _x_source_with_dummies(source):
    """An x-only RowSource as the (x, y, w) chunks the statistics engine's
    streamed driver reads (zero labels, unit weights)."""
    from ..parallel.tileplane import IterSource

    def factory():
        for chunk in source.chunks():
            x = np.asarray(chunk[0], np.float32)
            n = x.shape[0]
            yield (x, np.zeros(n, np.float32), np.ones(n, np.float32))

    return IterSource(factory, n_rows=source.n_rows)


def stream_quantile_edges(source, n_bins: int, *, hist_bins: int = 1024,
                          tile_rows: Optional[int] = None,
                          prefetch: Optional[int] = None,
                          device=None) -> np.ndarray:
    """Per-feature quantile bin edges from a STREAMED source (chunks
    whose first array is x [c, d]): the counterpart of `quantile_edges`
    for data larger than the device's memory.

    Two statistics-engine passes over the source through the tileplane
    onto `device` (None: CUDA): per-column min / max, then fixed-range
    `hist_bins` histograms between them; the edges are the inverse CDF of
    each column's histogram, linear inside the crossing bin. An edge is
    off by at most one histogram bin width. NaN rows are left out as in
    the resident route; an all-NaN column gets NaN edges (every present
    value bins to 1, and the column never wins a split), a constant
    column repeated edges. Returns [d, n_bins - 1] float32."""
    from . import stats_engine as SE

    st, _ = SE.stream_stats(_x_source_with_dummies(source),
                            tile_rows=tile_rows, prefetch=prefetch,
                            device=device)
    f8 = np.float64
    cnt = np.asarray(st.cnt, f8)
    lo = np.asarray(st.minv, f8)
    hi = np.asarray(st.maxv, f8)
    d = cnt.shape[0]
    ok = cnt > 0
    lo_r = np.where(ok, lo, 0.0).astype(np.float32)
    hi_r = np.where(ok, hi, 1.0).astype(np.float32)
    st2, _ = SE.stream_stats(_x_source_with_dummies(source),
                             tile_rows=tile_rows, lo=lo_r, hi=hi_r,
                             bins=int(hist_bins), prefetch=prefetch,
                             device=device)
    hist = np.asarray(st2.hist, f8).reshape(d, hist_bins + 1)[:, :hist_bins]

    edges = np.full((d, n_bins - 1), np.nan, np.float32)
    qs = np.arange(1, n_bins, dtype=f8) / n_bins
    for j in range(d):
        total = hist[j].sum()
        if not ok[j] or total <= 0:
            continue  # all-NaN column: NaN edges, like nanquantile
        if hi[j] <= lo[j]:
            edges[j] = lo[j]  # constant feature: repeated edges
            continue
        bounds = lo[j] + (hi[j] - lo[j]) \
            * np.arange(1, hist_bins + 1, dtype=f8) / hist_bins
        cum = np.cumsum(hist[j])
        edges[j] = np.interp(qs * total,
                             np.concatenate(([0.0], cum)),
                             np.concatenate(([lo[j]], bounds))
                             ).astype(np.float32)
    return edges


def stream_bin_matrix(source, edges, *, tile_rows: Optional[int] = None,
                      sink=None, prefetch: Optional[int] = None,
                      device=None):
    """The binned matrix of a streamed source, tile by tile.

    Each fixed tile runs `_bin_block`, the resident `bin_matrix` rule
    (the same bins by construction), on `device` (None: CUDA) under the
    double-buffered tileplane; the `bin_dtype` output tiles come back to
    the host one tile late (the copy of tile k overlaps tile k+1's
    binning) and go to `sink(np_tile, n_valid)` — or, without a sink,
    into the [n, d] host matrix, written in place into one preallocated
    array when the source knows its row count (at n * d bytes the one
    artifact of the flow small enough to keep). Returns that matrix, or
    None with a sink."""
    from ..device import resolve_device
    from ..parallel import tileplane as TP

    dev = resolve_device(device)
    edges_t = torch.tensor(np.asarray(edges, np.float32),
                           device=dev).T.contiguous()
    d = int(edges_t.shape[1])
    c = int(tile_rows) if tile_rows else TP.tile_rows_for(4 * d,
                                                          source.n_rows)
    t_dtype = bin_dtype(int(edges_t.shape[0]) + 1)
    out_dtype = torch.empty((), dtype=t_dtype).numpy().dtype
    parts: list = []
    full = None
    cursor = 0
    if sink is not None:
        out_sink = sink
    elif source.n_rows is not None:
        # known row count: tiles go straight into the final [n, d] matrix
        # (collecting then concatenating would double the peak)
        full = np.empty((int(source.n_rows), d), out_dtype)

        def out_sink(tile, n_valid):
            nonlocal cursor
            full[cursor:cursor + n_valid] = tile
            cursor += n_valid
    else:
        def out_sink(tile, n_valid):  # unknown length: concat at the end
            parts.append(tile)

    def step(carry, xt):
        return carry, _bin_block(xt, edges_t).to(t_dtype)

    TP.run_tileplane(source, step, None, tile_rows=c, label="tree_bin",
                     sink=out_sink, prefetch=prefetch, device=dev)
    if sink is not None:
        return None
    if full is not None:
        return full[:cursor]
    return np.concatenate(parts, axis=0) if parts else \
        np.zeros((0, d), out_dtype)


def thresholds_to_values(feat: torch.Tensor, thresh: torch.Tensor,
                         edges: torch.Tensor) -> torch.Tensor:
    """Bin thresholds -> raw-value thresholds for serving on unbinned X:
    present values go right iff x >= value. thresh 0 sends every present
    value right (-inf); dead nodes (thresh == n_bins) become +inf."""
    n_bins = edges.shape[1] + 1
    ti = torch.clamp(thresh.long() - 1, 0, n_bins - 2)
    tv = edges[feat.long(), ti]
    tv = torch.where(thresh <= 0, -math.inf, tv)
    return torch.where(thresh >= n_bins, math.inf, tv)


# -- split algebra ------------------------------------------------------------

def _lane(v: LaneScalar, like: torch.Tensor) -> LaneScalar:
    """A lane scalar broadcast against `like` [lanes, ...]: a float as it
    is, a [lanes] tensor with like's trailing axes as ones."""
    if isinstance(v, torch.Tensor):
        return v.reshape(-1, *([1] * (like.dim() - 1)))
    return v


def _soft_l1(G, alpha: float):
    """XGBoost's L1 soft-threshold on leaf gradient sums (alpha 0: identity)."""
    if alpha == 0.0:
        return G
    return torch.sign(G) * torch.clamp(torch.abs(G) - alpha, min=0.0)


def _split_scores(GL, HL, CL, Gt, Ht, Ct, Gm, Hm, Cm, reg_lambda,
                  min_child_weight, min_instances, min_info_gain, gamma,
                  alpha, normalize_gain=False):
    """Gain + validity for every (node, feature, bin, missing-direction)
    split candidate — XGBoost's sparsity-aware split search, batched over
    any leading axes (the lane axis of the fold-fused fit).

    GL/HL/CL: cumulative left sums [..., n, F, B(, K)] over the shifted bin
    axis (the missing bin is inside every prefix); Gt/Ht/Ct the node
    totals [..., n(, K)]; Gm/Hm/Cm the missing-bin mass [..., n, F(, K)].
    Direction 0 keeps missing left, direction 1 moves it right.
    reg_lambda, min_child_weight and gamma are floats or [lanes] tensors
    over the leading lane axis. Returns gain [..., n, F, B, 2], -inf at
    invalid candidates."""
    def score(G, H):
        Ga = _soft_l1(G, alpha)
        return (Ga * Ga).sum(-1) / (H + _lane(reg_lambda, H) + EPS)

    parent = score(Gt, Ht)[..., None, None]
    norm = torch.clamp(Ht, min=1.0)[..., None, None] if normalize_gain \
        else 1.0

    def one_direction(GLd, HLd, CLd):
        GR = Gt[..., None, None, :] - GLd
        HR = Ht[..., None, None] - HLd
        CR = Ct[..., None, None] - CLd
        gain = score(GLd, HLd) + score(GR, HR) - parent
        mcw = _lane(min_child_weight, HLd)
        ok = ((HLd >= mcw) & (HR >= mcw)
              & (CLd >= min_instances) & (CR >= min_instances)
              & (gain / norm > min_info_gain)
              & (gain > 2.0 * _lane(gamma, gain)))
        return torch.where(ok, gain, -math.inf)

    g_left = one_direction(GL, HL, CL)
    g_right = one_direction(GL - Gm[..., None, :], HL - Hm[..., None],
                            CL - Cm[..., None])
    return torch.stack([g_left, g_right], dim=-1)


def _feature_mask(gen: torch.Generator, n_nodes: int, n_feat: int,
                  feature_frac: float) -> torch.Tensor:
    """Per-node random feature subset [n_nodes, F] (colsample_bytree)."""
    k = max(1, int(round(feature_frac * n_feat)))
    if k >= n_feat:
        return torch.ones((n_nodes, n_feat), dtype=torch.bool,
                          device=gen.device)
    scores = torch.rand((n_nodes, n_feat), generator=gen, device=gen.device)
    kth = torch.sort(scores, dim=1).values[:, k - 1:k]
    return scores <= kth


def _level_feature_mask(gen: torch.Generator, n_feat: int, frac: float,
                        within: Optional[torch.Tensor],
                        within_count: Optional[int] = None) -> torch.Tensor:
    """[F] bool level subset (colsample_bylevel), drawn from the bytree
    subset `within` when one is active (xgboost nests the two draws);
    `within_count` is that subset's size."""
    pool = within_count if within_count is not None else n_feat
    k = max(1, int(round(frac * pool)))
    if k >= n_feat and within is None:
        return torch.ones((n_feat,), dtype=torch.bool, device=gen.device)
    scores = torch.rand((1, n_feat), generator=gen, device=gen.device)
    if within is not None:
        scores = torch.where(within[None, :], scores, -math.inf)
    kth = torch.sort(scores, dim=1, descending=True).values[:, k - 1:k]
    return (scores >= kth)[0] & torch.isfinite(scores[0])


def _mask_gain(gain, mask):
    """`gain` [Fo, n, F, B, 2], -inf where a feature mask is False: `mask`
    [F] holds for every node of every lane (colsample_bytree, the level's
    colsample_bylevel), [n, F] per node for every lane (Spark's per-node
    featureSubsetStrategy) and [Fo, n, F] per lane and node."""
    if mask.dim() == 1:
        m = mask[None, None, :, None, None]
    elif mask.dim() == 2:
        m = mask[None, :, :, None, None]
    else:
        m = mask[:, :, :, None, None]
    return torch.where(m, gain, -math.inf)


def _level_gains(full, split_kw, feature_mask, level_mask):
    """(gain [Fo, n, F, B, 2], sums) of one level's split candidates from
    its full histograms [Fo, n, K + 2, F, B] (K gradient channels, the
    hessian or weight, the count): cumulative sums over the shifted bin
    axis, then the gains (`split_kw`: _split_scores' scalars and
    normalize_gain), -inf outside the feature masks (`_mask_gain`).
    `sums` = (GL, HL, CL, Gt, Ht, Ct, Gm, Hm, Cm); the G sums carry a
    trailing K axis."""
    K = full.shape[2] - 2
    hg = full[:, :, :K].permute(0, 1, 3, 4, 2)            # [Fo, n, F, B, K]
    hh = full[:, :, K]
    hc = full[:, :, K + 1]
    GL = torch.cumsum(hg, dim=3)
    HL = torch.cumsum(hh, dim=3)
    CL = torch.cumsum(hc, dim=3)
    Gt, Ht, Ct = GL[:, :, 0, -1, :], HL[:, :, 0, -1], CL[:, :, 0, -1]
    Gm, Hm, Cm = hg[:, :, :, 0, :], hh[:, :, :, 0], hc[:, :, :, 0]
    sums = (GL, HL, CL, Gt, Ht, Ct, Gm, Hm, Cm)
    gain = _split_scores(*sums, **split_kw)
    for mask in (feature_mask, level_mask):
        if mask is not None:
            gain = _mask_gain(gain, mask)
    return gain, sums


def _level_split(full, B, split_kw, feature_mask, level_mask):
    """Split tables of one level from its full histograms [Fo, n, K + 2, F,
    B] (`_level_gains`), first-maximum argmax. Nodes without a valid split
    get the dead all-left encoding (feat 0, thresh B - 1, miss 0)."""
    gain, sums = _level_gains(full, split_kw, feature_mask, level_mask)
    Fo, n = gain.shape[:2]
    flat = gain.reshape(Fo, n, -1)
    best = torch.argmax(flat, dim=2)                      # first maximum
    ok = torch.isfinite(torch.gather(flat, 2, best[..., None])[..., 0])
    f_lvl = torch.where(ok, best // (B * 2), 0).to(torch.int32)
    t_lvl = torch.where(ok, (best // 2) % B, B - 1).to(torch.int32)
    m_lvl = torch.where(ok, best % 2, 0).to(torch.int32)
    last = (*sums, f_lvl, t_lvl, m_lvl)
    return f_lvl, t_lvl, m_lvl, last


def _leaf_payload(Gl, Hl, Cl, reg_lambda, alpha, max_delta_step,
                  learning_rate, leaf_mode="newton"):
    """Leaves from leaf sufficient statistics [Fo, L(, K)]: Newton steps, or
    the weighted mean payload (`leaf_mode` "mean": class distributions,
    regression values). A leaf no training row reached predicts 0.
    reg_lambda and learning_rate are floats or [lanes] tensors."""
    if leaf_mode == "newton":
        leaf = -_soft_l1(Gl, alpha) / (
            Hl + _lane(reg_lambda, Hl) + EPS)[..., None]
        if max_delta_step > 0.0:   # cap the raw newton step
            leaf = torch.clamp(leaf, -max_delta_step, max_delta_step)
    elif leaf_mode == "mean":
        leaf = Gl / (Hl + EPS)[..., None]
    else:
        raise ValueError(f"unknown leaf_mode {leaf_mode!r}")
    leaf = torch.where(Cl[..., None] >= 0.5, leaf, 0.0)
    return _lane(learning_rate, leaf) * leaf


def _fold_leaves(last, *, n_leaves, reg_lambda, alpha, max_delta_step,
                 learning_rate, leaf_mode="newton"):
    """Leaf payloads [Fo, n_leaves, K] read off the LAST level's cumulative
    histograms: each node's chosen split gives its left child's sums, the
    right child is total minus left."""
    GL, HL, CL, Gt, Ht, Ct, Gm, Hm, Cm, f_lvl, t_lvl, m_lvl = last
    Fo, n_half = f_lvl.shape
    k = torch.arange(Fo, device=f_lvl.device)[:, None]
    nid = torch.arange(n_half, device=f_lvl.device)[None, :]
    f, t = f_lvl.long(), t_lvl.long()
    mr = m_lvl.to(torch.float32)
    Gleft = GL[k, nid, f, t, :] - mr[..., None] * Gm[k, nid, f, :]
    Hleft = HL[k, nid, f, t] - mr * Hm[k, nid, f]
    Cleft = CL[k, nid, f, t] - mr * Cm[k, nid, f]
    Gl = torch.stack([Gleft, Gt - Gleft], dim=2).reshape(Fo, n_leaves, -1)
    Hl = torch.stack([Hleft, Ht - Hleft], dim=2).reshape(Fo, n_leaves)
    Cl = torch.stack([Cleft, Ct - Cleft], dim=2).reshape(Fo, n_leaves)
    return _leaf_payload(Gl, Hl, Cl, reg_lambda, alpha, max_delta_step,
                         learning_rate, leaf_mode)


# -- level-wise growth, one tree per lane -------------------------------------

def _grow_tree_folds(Xb_t, G, H, *, depth, n_bins, reg_lambda,
                     min_child_weight, min_instances, min_info_gain, gamma,
                     learning_rate, feature_mask, alpha=0.0,
                     max_delta_step=0.0, level_feature_frac=1.0,
                     generator=None, feature_mask_count=None,
                     leaf_mode="newton", normalize_gain=False,
                     node_masks=None, leaf_rows=True, Xb_rows=None):
    """Grow one tree PER LANE, level by level, in shared kernel passes: the
    grower of every tree family (boosted rounds, forest trees, single
    trees), the counterpart of the reference's grow_tree vmapped over lanes.

    Xb_t [F, N] bins; G [Fo, N] (one gradient channel) or [Fo, K, N]
    per-lane payloads, H [Fo, N] hessians or weights (a row outside a
    lane's fit enters with H = 0 and G = 0; the count channel is derived
    in the kernels as H > 0). Level 0 is one `hist_folds` pass; each later
    level's LEFT-child histograms come from the previous level's
    `route_hist` pass and the right children by subtraction from the
    parent; the last level routes with `route`, and `table_lookup` reads
    each row's leaf. The split algebra runs on [Fo, nodes, K + 2, F, B]
    sums: gains normalized by the node weight or not (`normalize_gain`),
    Newton or mean leaves (`leaf_mode`). reg_lambda, min_child_weight,
    gamma and learning_rate are floats or [Fo] tensors on Xb_t's device.

    Feature masks: `feature_mask` [F] for the whole tree (colsample_bytree);
    a colsample_bylevel subset per level drawn from `generator`; and per
    node `node_masks`, a callable level d -> mask [2^d, F] or [Fo, 2^d, F]
    (Spark's featureSubsetStrategy; `ForestDraws.node_masks`).

    `Xb_rows` [N, F], the same bins row-major (the fit's own binned
    matrix), is what route_hist's sorted path reads a row's bins from.

    Returns (Tree with a leading [Fo] axis, leaf_rows): the learning-rate-
    scaled leaf payloads of every row, [Fo, N] for a 2-D G and [Fo, K, N]
    otherwise; with `leaf_rows` False the last level is not routed and
    leaf_rows is None.
    """
    F, N = Xb_t.shape
    one_channel = G.dim() == 2
    G3 = G[:, None] if one_channel else G
    Fo, K = G3.shape[:2]
    C = K + 2                                             # + hessian, count
    B = n_bins + 1
    split_kw = dict(reg_lambda=reg_lambda, min_child_weight=min_child_weight,
                    min_instances=min_instances, min_info_gain=min_info_gain,
                    gamma=gamma, alpha=alpha, normalize_gain=normalize_gain)
    node = torch.zeros((Fo, N), dtype=torch.float32, device=Xb_t.device)
    pay = torch.cat([G3, H[:, None]], dim=1).reshape((K + 1) * Fo, N)
    feats, threshs, misses = [], [], []
    hist = TK.hist_folds(Xb_t, pay, node, n_slots=1, n_bins=B,
                         derive_count=True)
    prev = None
    for d in range(depth):
        n_nodes = 1 << d
        hist = hist.reshape(Fo, max(n_nodes // 2, 1), C, F, B)
        # sibling subtraction: slot 2p = left child, 2p + 1 = parent - left
        full = hist if d == 0 else torch.stack(
            [hist, prev - hist], dim=2).reshape(Fo, n_nodes, C, F, B)
        prev = full
        level_mask = None
        if level_feature_frac < 1.0 and generator is not None:
            level_mask = _level_feature_mask(generator, F, level_feature_frac,
                                             feature_mask, feature_mask_count)
        node_mask = node_masks(d) if node_masks is not None else None
        if node_mask is not None:
            node_mask = node_mask.to(Xb_t.device)
            level_mask = node_mask if level_mask is None \
                else node_mask & level_mask
        f_lvl, t_lvl, m_lvl, last = _level_split(full, B, split_kw,
                                                 feature_mask, level_mask)
        feats.append(f_lvl)
        threshs.append(t_lvl)
        misses.append(m_lvl)
        if d < depth - 1:
            hist, node = TK.route_hist(Xb_t, pay, node, f_lvl, t_lvl, m_lvl,
                                       n_nodes=n_nodes, n_bins=B,
                                       derive_count=True, xb_rows=Xb_rows)
        elif leaf_rows:
            node = TK.route(Xb_t, node, f_lvl, t_lvl, m_lvl, n_nodes=n_nodes)
    del prev, full, hist
    n_leaves = 1 << depth
    leaf = _fold_leaves(last, n_leaves=n_leaves, reg_lambda=reg_lambda,
                        alpha=alpha, max_delta_step=max_delta_step,
                        learning_rate=learning_rate, leaf_mode=leaf_mode)
    tree = Tree(torch.cat(feats, dim=1), torch.cat(threshs, dim=1), leaf,
                torch.cat(misses, dim=1))
    if not leaf_rows:
        return tree, None
    if one_channel:
        return tree, TK.table_lookup(leaf[:, :, 0].contiguous(), node)
    # the K channels of a lane as K lanes of one lookup
    tbl = leaf.permute(0, 2, 1).reshape(Fo * K, n_leaves).contiguous()
    rows = TK.table_lookup(tbl, node.repeat_interleave(K, dim=0))
    return tree, rows.reshape(Fo, K, N)


def grow_tree(Xb: torch.Tensor, G: torch.Tensor, H: torch.Tensor, *,
              depth: int, n_bins: int, reg_lambda: float = 0.0,
              min_child_weight: float = 0.0, min_instances: float = 1.0,
              min_info_gain: float = 0.0, gamma: float = 0.0,
              leaf_mode: str = "newton",
              learning_rate: float = 1.0, normalize_gain: bool = True,
              feature_mask: Optional[torch.Tensor] = None,
              alpha: float = 0.0, max_delta_step: float = 0.0,
              level_feature_frac: float = 1.0,
              feature_mask_count: Optional[int] = None,
              node_masks=None,
              generator: Optional[torch.Generator] = None) -> Tree:
    """Grow one depth-`depth` tree level-wise on binned features (the
    reference's grow_tree): one lane of `_grow_tree_folds`.

    Xb [N, F] bins (bin_matrix); G [N, K] per-row gradient payload
    (weights folded in); H [N] per-row hessian or weight, 0 = row excluded
    (how bootstrap and fold masks enter). The reference's `feature_frac`
    and key come in as `node_masks`, a callable level d -> [2^d, F] mask of
    each node's feature subset (`ForestDraws.node_masks`); `feature_mask`
    [F] fixes one subset for the whole tree; a colsample_bylevel subset
    (`level_feature_frac` < 1) is drawn from `generator`. Tree fields carry
    no lane axis: leaf [2^depth, K]."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if generator is None and level_feature_frac < 1.0:
        raise ValueError("level feature sampling needs a torch.Generator")
    tree, _ = _grow_tree_folds(
        Xb.T.contiguous(), G.T.contiguous()[None], H[None].contiguous(),
        depth=depth, n_bins=n_bins, reg_lambda=reg_lambda,
        min_child_weight=min_child_weight, min_instances=min_instances,
        min_info_gain=min_info_gain, gamma=gamma,
        learning_rate=learning_rate, feature_mask=feature_mask, alpha=alpha,
        max_delta_step=max_delta_step, level_feature_frac=level_feature_frac,
        generator=generator, feature_mask_count=feature_mask_count,
        leaf_mode=leaf_mode, normalize_gain=normalize_gain,
        node_masks=node_masks, leaf_rows=False, Xb_rows=Xb.contiguous())
    return Tree(*(t[0] for t in tree))


# -- traversal on binned rows -------------------------------------------------

def predict_bins(tree: Tree, Xb: torch.Tensor, depth: int) -> torch.Tensor:
    """Traverse one tree on binned rows: Xb [N, F] -> leaf payload [N, K]."""
    N = Xb.shape[0]
    rows = torch.arange(N, device=Xb.device)
    rel = torch.zeros(N, dtype=torch.long, device=Xb.device)
    for d in range(depth):
        idx = (1 << d) - 1 + rel
        xb = Xb[rows, tree.feat[idx].long()].int()
        right = (xb > tree.thresh[idx]) | ((xb == 0) & (tree.miss[idx] > 0))
        rel = 2 * rel + right.long()
    return tree.leaf[rel]


def predict_forest_bins(trees: Tree, Xb: torch.Tensor,
                        depth: int) -> torch.Tensor:
    """Sum of payloads over a stacked batch of trees [T, ...]: [N, K],
    added tree by tree in order."""
    out = torch.zeros((Xb.shape[0], trees.leaf.shape[-1]),
                      dtype=trees.leaf.dtype, device=Xb.device)
    for t in range(trees.feat.shape[0]):
        out = out + predict_bins(Tree(*(f[t] for f in trees)), Xb, depth)
    return out


# -- random forest ------------------------------------------------------------

class ForestDraws:
    """A forest's random draws, tree by tree: tree t's bootstrap row
    weights [N] (Poisson(`subsample`) with `bootstrap`, else Bernoulli) and
    its level-d node feature masks [2^d, F] (`_feature_mask` at
    `feature_frac`; None when every feature is kept).

    Each tree draws from CPU torch.Generators seeded from (seed, tree), so
    the draws are the same whatever device the forest grows on, and level
    d's masks do not depend on the depth grown (as the reference's
    per-level key splits do not). They are drawn once and kept on
    `device`: the grid points of a sweep that share a seed share the draws,
    as the reference's share one key."""

    def __init__(self, seed: int, n_rows: int, n_feat: int, *,
                 subsample: float, feature_frac: float, bootstrap: bool,
                 device):
        self.key = (int(seed), int(n_rows), int(n_feat), float(subsample),
                    float(feature_frac), bool(bootstrap))
        self.device = torch.device(device)
        self._rows: dict = {}
        self._masks: dict = {}

    def _generator(self, tree: int, stream: int) -> torch.Generator:
        seq = np.random.SeedSequence([self.key[0] & 0xFFFFFFFF, tree, stream])
        return torch.Generator().manual_seed(
            int(seq.generate_state(1, np.uint64)[0]) >> 1)

    def row_weights(self, tree: int) -> torch.Tensor:
        if tree not in self._rows:
            _, N, _, rate, _, bootstrap = self.key
            if bootstrap:
                rw = torch.poisson(torch.full((N,), rate),
                                   generator=self._generator(tree, 0))
            elif rate < 1.0:
                rw = (torch.rand((N,), generator=self._generator(tree, 0))
                      < rate).to(torch.float32)
            else:
                rw = torch.ones((N,))
            self._rows[tree] = rw.to(self.device)
        return self._rows[tree]

    def node_masks(self, tree: int):
        """Level d -> tree's [2^d, F] mask (None: every feature kept)."""
        _, _, F, _, frac, _ = self.key
        if max(1, int(round(frac * F))) >= F:
            return None
        gen, masks = self._masks.setdefault(
            tree, (self._generator(tree, 1), []))

        def level(d: int) -> torch.Tensor:
            while len(masks) <= d:
                masks.append(_feature_mask(gen, 1 << len(masks), F, frac)
                             .to(self.device))
            return masks[d]
        return level


def fit_forest_folds(Xb: torch.Tensor, G: torch.Tensor, H: torch.Tensor, *,
                     n_trees: int, depth: int, n_bins: int,
                     subsample: float = 1.0, feature_frac: float = 1.0,
                     reg_lambda: float = 0.0, min_instances: float = 1.0,
                     min_info_gain: float = 0.0, leaf_mode: str = "mean",
                     bootstrap: bool = True, seed: int = 0,
                     draws: Optional[ForestDraws] = None,
                     predict: bool = True):
    """Random forest for every lane (CV fold) over one binned matrix: each
    tree with bootstrap row weights and per-node feature subsets, gains
    normalized by the node weight, `leaf_mode` leaves (the reference's
    fit_forest, its trees in sequence).

    Xb [N, F] bins; G [Fo, K, N] per-lane payload (row weights folded in),
    H [Fo, N] per-lane weights, 0 = row outside the lane's fit. The lanes
    share every draw, as the reference's folds share one key: tree t's row
    weights multiply every lane's G and H, its node masks restrict every
    lane, and each level of the tree is one kernel pass for all lanes.
    Draws: `draws` (any object with ForestDraws' row_weights(t) and
    node_masks(t)), else a new ForestDraws from `seed`. Returns (trees [n_trees, Fo, ...], agg [Fo,
    K, N]): agg sums every tree's leaf payload of every row, None without
    `predict`."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    N, F = Xb.shape
    if draws is None:
        draws = ForestDraws(seed, N, F, subsample=subsample,
                            feature_frac=feature_frac, bootstrap=bootstrap,
                            device=Xb.device)
    Xb_t, Xb_rows = Xb.T.contiguous(), Xb.contiguous()
    trees, agg = [], None
    for t in range(n_trees):
        rw = draws.row_weights(t).to(Xb.device)
        tree, rows = _grow_tree_folds(
            Xb_t, (G * rw).contiguous(), (H * rw).contiguous(), depth=depth,
            n_bins=n_bins, reg_lambda=reg_lambda, min_child_weight=0.0,
            min_instances=min_instances, min_info_gain=min_info_gain,
            gamma=0.0, learning_rate=1.0, feature_mask=None,
            leaf_mode=leaf_mode, normalize_gain=True,
            node_masks=draws.node_masks(t), leaf_rows=predict,
            Xb_rows=Xb_rows)
        trees.append(tree)
        if predict:
            agg = rows if agg is None else agg + rows
    return Tree(*(torch.stack(parts) for parts in zip(*trees))), agg


def fit_forest(Xb: torch.Tensor, G: torch.Tensor, H: torch.Tensor, *,
               n_trees: int, depth: int, n_bins: int, subsample: float = 1.0,
               feature_frac: float = 1.0, reg_lambda: float = 0.0,
               min_instances: float = 1.0, min_info_gain: float = 0.0,
               leaf_mode: str = "mean", bootstrap: bool = True,
               seed: int = 0, draws: Optional[ForestDraws] = None) -> Tree:
    """Random forest of `n_trees` trees on one fit (the reference's
    fit_forest): Xb [N, F], G [N, K], H [N]; one lane of
    `fit_forest_folds`. Returns stacked trees [n_trees, ...]; the ensemble
    prediction is the payload mean."""
    trees, _ = fit_forest_folds(
        Xb, G.T.contiguous()[None], H[None].contiguous(), n_trees=n_trees,
        depth=depth, n_bins=n_bins, subsample=subsample,
        feature_frac=feature_frac, reg_lambda=reg_lambda,
        min_instances=min_instances, min_info_gain=min_info_gain,
        leaf_mode=leaf_mode, bootstrap=bootstrap, seed=seed,
        draws=draws, predict=False)
    return Tree(*(t[:, 0] for t in trees))


# -- boosting -----------------------------------------------------------------

def _logistic_grad(margin, y, w):
    p = torch.sigmoid(margin)
    return w * (p - y), torch.clamp(w * p * (1.0 - p), min=EPS)


def _squared_grad(pred, y, w):
    return w * (pred - y), w


def _lane_scalars(kw: dict, lanes: int, device) -> dict:
    """The LANE_KEYS of `kw`: floats as they are, tensors checked to one
    value a lane and placed as f32 on the fit's device."""
    out = {}
    for key in LANE_KEYS:
        v = kw[key]
        if isinstance(v, torch.Tensor):
            if tuple(v.shape) != (lanes,):
                raise ValueError(f"{key}: a lane tensor must have shape "
                                 f"({lanes},), got {tuple(v.shape)}")
            v = v.to(device=device, dtype=torch.float32)
        else:
            v = float(v)
        out[key] = v
    return out


def fit_gbt_folds(Xb: torch.Tensor, y: torch.Tensor, W: torch.Tensor, *,
                  n_rounds: int, depth: int, n_bins: int,
                  learning_rate: LaneScalar = 0.1,
                  reg_lambda: LaneScalar = 1.0,
                  min_child_weight: LaneScalar = 0.0,
                  min_instances: float = 1.0,
                  min_info_gain: float = 0.0, gamma: LaneScalar = 0.0,
                  subsample: float = 1.0, feature_frac: float = 1.0,
                  loss: str = "logistic", alpha: float = 0.0,
                  max_delta_step: float = 0.0, colsample_bylevel: float = 1.0,
                  base_score: Optional[float] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Tree, torch.Tensor, torch.Tensor]:
    """Boosted trees for every lane (CV fold) over one binned matrix.

    Xb [N, F] binned (bin_matrix); y [N]; W [Fo, N] per-lane row weights
    (0 = row outside that lane's fit). Per-lane quantities follow the
    reference's fit_gbt: the base score is the lane's weighted label prior
    (or the pinned `base_score`), the logistic hessian is clamped to EPS
    (rows outside the fit still count toward min_instances), and the row
    subsample and column samples are one draw per round shared by all
    lanes, from `generator`. learning_rate, reg_lambda, min_child_weight
    and gamma (LANE_KEYS) are floats or [Fo] tensors, one value a lane
    (the reference's `_LANE_KEYS`). Returns (trees [rounds, Fo, ...],
    base [Fo], margins [Fo, N]): margins are the fitted scores of ALL
    rows, held-out rows included."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    if loss not in ("logistic", "squared"):
        raise ValueError(f"unknown loss {loss!r}")
    sampled = subsample < 1.0 or feature_frac < 1.0 or colsample_bylevel < 1.0
    if sampled and generator is None:
        raise ValueError("row or column subsampling needs a torch.Generator")
    grad_fn = _logistic_grad if loss == "logistic" else _squared_grad
    Fo, N = W.shape
    F = Xb.shape[1]
    dev = Xb.device
    lane_kw = _lane_scalars(dict(
        learning_rate=learning_rate, reg_lambda=reg_lambda,
        min_child_weight=min_child_weight, gamma=gamma), Fo, dev)
    y = y.to(torch.float32)
    W = W.to(torch.float32)
    wsum = W.sum(dim=1) + EPS
    wy = (W * y[None, :]).sum(dim=1)
    if base_score is not None:
        if loss == "logistic":
            p0 = min(max(float(base_score), 1e-6), 1 - 1e-6)
            base = torch.full((Fo,), math.log(p0 / (1 - p0)),
                              dtype=torch.float32, device=dev)
        else:
            base = torch.full((Fo,), float(base_score), dtype=torch.float32,
                              device=dev)
    elif loss == "logistic":
        p0 = torch.clamp(wy / wsum, 1e-6, 1 - 1e-6)
        base = torch.log(p0 / (1 - p0))
    else:
        base = wy / wsum
    Xb_t, Xb_rows = Xb.T.contiguous(), Xb.contiguous()
    fm_count = max(1, int(round(feature_frac * F))) \
        if feature_frac < 1.0 else None
    margin = base[:, None].expand(Fo, N).clone()
    rounds = []
    for _ in range(n_rounds):
        g, h = grad_fn(margin, y[None, :], W)
        if subsample < 1.0:
            rw = (torch.rand((N,), generator=generator, device=dev)
                  < subsample).to(torch.float32)[None, :]
            g, h = g * rw, h * rw
        fm = _feature_mask(generator, 1, F, feature_frac)[0] \
            if feature_frac < 1.0 else None
        tree, leaf_rows = _grow_tree_folds(
            Xb_t, g.contiguous(), h.contiguous(), depth=depth, n_bins=n_bins,
            min_instances=min_instances, min_info_gain=min_info_gain,
            feature_mask=fm, alpha=alpha, max_delta_step=max_delta_step,
            level_feature_frac=colsample_bylevel, generator=generator,
            feature_mask_count=fm_count, Xb_rows=Xb_rows, **lane_kw)
        margin = margin + leaf_rows
        rounds.append(tree)
    trees = Tree(*(torch.stack(parts) for parts in zip(*rounds)))
    return trees, base, margin


def fit_gbt(Xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
            n_rounds: int, depth: int, n_bins: int,
            generator: Optional[torch.Generator] = None,
            **kw) -> Tuple[Tree, torch.Tensor]:
    """Second-order boosted trees on one fit (the reference's fit_gbt: the
    Spark GBT and XGBoost estimators' refit): one lane of `fit_gbt_folds`,
    which takes the same keywords. Returns (trees [rounds, ...], base
    score); the prediction is base + the sum of the trees' payloads."""
    trees, base, _ = fit_gbt_folds(Xb, y, w[None, :], n_rounds=n_rounds,
                                   depth=depth, n_bins=n_bins,
                                   generator=generator, **kw)
    return Tree(*(t[:, 0] for t in trees)), base[0]


def _class_level_masks(generator: torch.Generator, lanes: int,
                       n_classes: int, n_feat: int, frac: float,
                       within: Optional[torch.Tensor],
                       within_count: Optional[int]):
    """Level d -> [lanes * n_classes, 2^d, F] colsample_bylevel masks, one
    draw a class (each class tree draws its own, as the reference's
    per-class keys), shared by the lanes (folds) of that class."""
    def level(d: int) -> torch.Tensor:
        per_class = torch.stack([
            _level_feature_mask(generator, n_feat, frac, within,
                                within_count) for _ in range(n_classes)])
        return per_class[None, :, None, :].expand(
            lanes, n_classes, 1 << d, n_feat).reshape(
            lanes * n_classes, 1 << d, n_feat)
    return level


def fit_gbt_softmax_folds(Xb: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
                          *, n_rounds: int, depth: int, n_bins: int,
                          n_classes: int, learning_rate: float = 0.1,
                          reg_lambda: float = 1.0,
                          min_child_weight: float = 0.0, gamma: float = 0.0,
                          subsample: float = 1.0, feature_frac: float = 1.0,
                          alpha: float = 0.0, max_delta_step: float = 0.0,
                          colsample_bylevel: float = 1.0,
                          generator: Optional[torch.Generator] = None
                          ) -> Tuple[Tree, torch.Tensor]:
    """Multiclass softmax boosting (XGBoost multi:softprob) for every lane
    (CV fold) over one binned matrix: the reference's fit_gbt_softmax,
    whose per-round class trees grow under a vmap, here as lanes. Each
    round's gradients g = w (p - onehot) and hessians max(w p (1 - p), EPS)
    of the softmax of the margins (which start at 0) feed ONE
    `_grow_tree_folds` call of Fo x K one-channel lanes (lane f * K + c is
    fold f's class-c tree), so every level launches each kernel once for
    every fold and class. The row subsample and the colsample_bytree mask
    are one draw per round shared by all lanes; a colsample_bylevel mask
    is drawn per class and level. Returns (trees [rounds, Fo, K, ...],
    margins [Fo, N, K] of all rows, held-out rows included)."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    sampled = subsample < 1.0 or feature_frac < 1.0 or colsample_bylevel < 1.0
    if sampled and generator is None:
        raise ValueError("row or column subsampling needs a torch.Generator")
    Fo, N = W.shape
    K = int(n_classes)
    F = Xb.shape[1]
    dev = Xb.device
    W = W.to(torch.float32)[:, None, :]                        # [Fo, 1, N]
    Y = torch.nn.functional.one_hot(y.long(), K).T.to(torch.float32)[None]
    Xb_t, Xb_rows = Xb.T.contiguous(), Xb.contiguous()
    fm_count = max(1, int(round(feature_frac * F))) \
        if feature_frac < 1.0 else None
    margin = torch.zeros((Fo, K, N), dtype=torch.float32, device=dev)
    rounds = []
    for _ in range(n_rounds):
        p = torch.softmax(margin, dim=1)
        g = W * (p - Y)
        h = torch.clamp(W * p * (1.0 - p), min=EPS)
        if subsample < 1.0:
            rw = (torch.rand((N,), generator=generator, device=dev)
                  < subsample).to(torch.float32)
            g, h = g * rw, h * rw
        fm = _feature_mask(generator, 1, F, feature_frac)[0] \
            if feature_frac < 1.0 else None
        node_masks = _class_level_masks(
            generator, Fo, K, F, colsample_bylevel, fm, fm_count) \
            if colsample_bylevel < 1.0 else None
        tree, leaf_rows = _grow_tree_folds(
            Xb_t, g.reshape(Fo * K, N).contiguous(),
            h.reshape(Fo * K, N).contiguous(), depth=depth, n_bins=n_bins,
            reg_lambda=reg_lambda, min_child_weight=min_child_weight,
            min_instances=1.0, min_info_gain=0.0, gamma=gamma,
            learning_rate=learning_rate, feature_mask=fm, alpha=alpha,
            max_delta_step=max_delta_step, node_masks=node_masks,
            Xb_rows=Xb_rows)
        margin = margin + leaf_rows.reshape(Fo, K, N)
        rounds.append(Tree(*(t.reshape(Fo, K, *t.shape[1:]) for t in tree)))
    trees = Tree(*(torch.stack(parts) for parts in zip(*rounds)))
    return trees, margin.transpose(1, 2)


def fit_gbt_softmax(Xb: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
                    n_rounds: int, depth: int, n_bins: int, n_classes: int,
                    generator: Optional[torch.Generator] = None,
                    **kw) -> Tree:
    """Softmax boosting on one fit (the reference's fit_gbt_softmax, the
    multiclass XGBoost refit): one lane of `fit_gbt_softmax_folds`, which
    takes the same keywords. Returns trees with leading [rounds, K] axes;
    class c's margin is the sum of its trees' payloads."""
    trees, _ = fit_gbt_softmax_folds(
        Xb, y, w[None, :], n_rounds=n_rounds, depth=depth, n_bins=n_bins,
        n_classes=n_classes, generator=generator, **kw)
    return Tree(*(t[:, 0] for t in trees))


# -- traversal on raw feature values -----------------------------------------

def predict_ensemble(feat: torch.Tensor, thresh_val: torch.Tensor,
                     leaf: torch.Tensor, X: torch.Tensor, depth: int,
                     miss: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-tree payload sum [N, K] of an ensemble on RAW feature values —
    the counterpart of np_predict_ensemble, on any device.

    feat/thresh_val/miss [T, 2^depth - 1] (present values go right iff
    x >= thresh; +inf = all-left, -inf = all-present-right; NaN rows follow
    miss, None = all left); leaf [T, 2^depth, K]; X [N, F]."""
    T, n_int = feat.shape
    L, K = leaf.shape[1:]
    dev = X.device
    feat_f = feat.reshape(-1).long()
    tv_f = thresh_val.reshape(-1)
    miss_f = None if miss is None else miss.reshape(-1)
    leaf_f = leaf.reshape(T * L, K)
    t_int = torch.arange(T, device=dev)[None, :] * n_int
    t_leaf = torch.arange(T, device=dev)[None, :] * L
    out = torch.empty((X.shape[0], K), dtype=leaf.dtype, device=dev)
    for r0 in range(0, X.shape[0], _BIN_CHUNK):
        x = X[r0:r0 + _BIN_CHUNK]
        rel = torch.zeros((x.shape[0], T), dtype=torch.long, device=dev)
        for d in range(depth):
            gi = t_int + (1 << d) - 1 + rel                      # [n, T]
            xv = torch.gather(x, 1, feat_f[gi])
            nan = torch.isnan(xv)
            right = ~nan & (xv >= tv_f[gi])                      # NaN: False
            if miss_f is not None:
                right |= nan & (miss_f[gi] > 0)
            rel = 2 * rel + right.long()
        out[r0:r0 + _BIN_CHUNK] = leaf_f[t_leaf + rel].sum(dim=1)
    return out
