"""The port's level-wise grower, random forest and binned traversal
(transmogrifai_tpu_torch/ops/trees.py) against the JAX package's.

Both packages run on the same seeded numpy inputs; the JAX package takes its
device route (TMOG_NO_HOST_TREES=1), where `grow_tree` sums every level's
full histograms with segment sums and the fold-fused fit uses its jnp
twins. The port's random draws are fed the reference's through a stand-in
of its draws object (`_FedDraws`): the bootstrap weights and per-level node
masks follow the reference's key schedule (split(key, n_trees); per tree
kb, kf = split(k), poisson(kb); per level key, sub = split(key),
_feature_mask(sub, 2^d, F, frac)).

Tolerances: decisions (feat, thresh, miss) identical wherever the two
candidates' gains are separated; a node whose ancestors agree but whose
split differs must be a tie in the sense of chip_smoke.split_witness (the
node's counts equal, the float64 gains of both candidates, from either
package's f32 histograms, apart by no more than the first-order f32 noise
of the two histograms). Leaves on identical paths within 1e-5, or within
the f32 error of sibling subtraction where a leaf's weight is small: the
port builds right children as parent - left (its kernels histogram left
children only), the reference's CPU route sums them directly, so a leaf's
sums carry up to ~depth ulps of the root's weight W, and a mean or Newton
leaf of weight h up to 2 * depth * eps * W / h (`_leaf_atol`).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_threads import one_torch_thread  # noqa: F401
import chip_smoke
from transmogrifai_tpu.ops import trees as JT
from transmogrifai_tpu_torch.ops import trees as PT

LEAF_ATOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def device_route(monkeypatch):
    monkeypatch.setenv("TMOG_NO_HOST_TREES", "1")


def _data(n, n_bins, seed, n_feat=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n_feat)).astype(np.float32)
    X[rng.uniform(size=n) < 0.12, 0] = np.nan              # missing values
    X[:, 3] = rng.integers(0, 5, size=n)                    # ties
    X[:, 4] = np.round(X[:, 4] * 2) / 3                     # repeated values
    logit = 1.8 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - 0.4 * X[:, 3]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    yr = (logit + rng.normal(size=n)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    edges = JT.quantile_edges(jnp.asarray(X), n_bins)
    Xb = np.array(JT.bin_matrix(jnp.asarray(X), edges))
    return Xb, y, yr, w


def _payload(kind, y, yr, w):
    """(G [N, K], H [N]) of a classification (K = 2) or regression fit."""
    if kind == "class":
        return np.eye(2, dtype=np.float32)[y.astype(int)] * w[:, None], w
    return (yr * w)[:, None], w


def _ref_node_masks(key, depth, n_feat, frac):
    """grow_tree's per-level node masks from `key` (the reference's
    schedule), as torch bool [2^d, F]."""
    out = []
    for d in range(depth):
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.array(
            JT._feature_mask(sub, 1 << d, n_feat, frac))))
    return out


class _FedDraws:
    """ForestDraws' interface over given draws: row weights [n_trees, N]
    and, per tree, a list of level masks [2^d, F] (or None)."""

    def __init__(self, row_weights, masks):
        self.rw, self.masks = row_weights, masks

    def row_weights(self, t):
        return self.rw[t]

    def node_masks(self, t):
        return None if self.masks[t] is None else self.masks[t].__getitem__


def _ref_forest_draws(key, n_trees, n_rows, n_feat, depth, subsample, frac,
                      bootstrap=True):
    """fit_forest's bootstrap weights [n_trees, N] and node masks per tree
    and level, drawn as the reference draws them."""
    rws, masks = [], []
    for k in jax.random.split(key, n_trees):
        kb, kf = jax.random.split(k)
        if bootstrap:
            rw = jax.random.poisson(kb, subsample, (n_rows,))
        else:
            rw = jax.random.uniform(kb, (n_rows,)) < subsample
        rws.append(np.asarray(rw, np.float32))
        masks.append(_ref_node_masks(kf, depth, n_feat, frac)
                     if frac < 1.0 else None)
    return torch.from_numpy(np.stack(rws)), masks


# -- per-node comparison with the tie witness ---------------------------------

def _port_recorder(monkeypatch):
    """Every `_level_split` call of the port: (full, split_kw, masks,
    split tables), in call order."""
    store = []
    original = PT._level_split

    def run(full, B, split_kw, feature_mask, level_mask):
        out = original(full, B, split_kw, feature_mask, level_mask)
        store.append((full.clone(), dict(split_kw),
                      (feature_mask, level_mask),
                      [t.clone() for t in out[:3]]))
        return out
    monkeypatch.setattr(PT, "_level_split", run)
    return store


def _lane(store, k):
    """One lane's records in split_witness's form."""
    def lane_mask(m):
        return m[k:k + 1] if m is not None and m.dim() == 3 else m
    return [dict(full=full[k:k + 1], split_kw=kw,
                 masks=tuple(lane_mask(m) for m in masks),
                 split=[t[k] for t in split])
            for full, kw, masks, split in store]


def _ref_levels(tree_feat, tree_thresh, tree_miss, Xb, G, H, depth, B,
                split_kw, node_masks=None):
    """The reference's level records of one tree: its node ids at every
    level (its own splits), the level histograms summed at those node ids
    in f32, row by row, as its CPU route sums them (segment sums of full
    histograms, no sibling subtraction), and its splits."""
    N, F = Xb.shape
    rows = np.arange(N)
    rel = np.zeros(N, np.int64)
    out = []
    pay = np.concatenate([G, H[:, None], (H > 0)[:, None]], axis=1) \
        .astype(np.float32)                               # [N, K + 2]
    for d in range(depth):
        n = 1 << d
        full = np.zeros((n, pay.shape[1], F, B), np.float32)
        for f in range(F):
            np.add.at(full, (rel, slice(None), f, Xb[:, f].astype(np.int64)),
                      pay)
        lo = n - 1
        split = [torch.from_numpy(np.array(a[lo:lo + n], np.int32))
                 for a in (tree_feat, tree_thresh, tree_miss)]
        out.append(dict(full=torch.from_numpy(full)[None],
                        split_kw=split_kw,
                        masks=(None, None if node_masks is None
                               else node_masks[d]),
                        split=split))
        f, t, m = (np.asarray(a)[lo + rel] for a in
                   (tree_feat, tree_thresh, tree_miss))
        xb = Xb[rows, f].astype(np.int64)
        rel = 2 * rel + ((xb > t) | ((xb == 0) & (m > 0)))
    return out


def _leaf_atol(feat, thresh, miss, Xb, H, depth):
    """[2^depth, 1] leaf tolerance: 1e-5, or the f32 error that sibling
    subtraction leaves in a leaf of small weight (module docstring)."""
    rel = np.zeros(Xb.shape[0], np.int64)
    rows = np.arange(Xb.shape[0])
    for d in range(depth):
        i = (1 << d) - 1 + rel
        xb = Xb[rows, np.asarray(feat)[i]].astype(np.int64)
        rel = 2 * rel + ((xb > np.asarray(thresh)[i])
                         | ((xb == 0) & (np.asarray(miss)[i] > 0)))
    h = np.bincount(rel, weights=H, minlength=1 << depth)
    noise = 2 * depth * EPS32 * H.sum() / np.maximum(h, 1e-30)
    return np.maximum(LEAF_ATOL, noise)[:, None]


def _assert_leaves(port_leaf, ref_leaf, leaf_ok, atol):
    err = np.abs(port_leaf - ref_leaf)[leaf_ok]
    assert (err <= np.broadcast_to(atol, port_leaf.shape)[leaf_ok]).all(), \
        float(err.max())


def _one_node(rec, node):
    masks = tuple(m if m is None or m.dim() == 1 else
                  (m[node:node + 1] if m.dim() == 2
                   else m[:, node:node + 1]) for m in rec["masks"])
    return dict(full=rec["full"][:, node:node + 1], split_kw=rec["split_kw"],
                masks=masks, split=[t[node:node + 1] for t in rec["split"]])


def _compare(port, ref, depth, n_feat, rounds=1):
    """Node by node, round by round, for one lane: every node whose
    ancestors split alike in both packages must split alike too, or be a
    tie (split_witness). Rounds after the first one with a differing node
    are not compared (their gradients differ). Returns (counts, leaf_ok
    [2^depth] bool of the last compared round: leaves on identical paths,
    last compared round)."""
    names = [f"x{j}" for j in range(n_feat)]
    counts = dict(nodes=0, identical=0, ties=0, witnesses=[])
    for r in range(rounds):
        agree = np.ones(1, bool)
        differed = False
        for d in range(depth):
            i = r * depth + d
            a, b = port[i], ref[i]
            same = np.ones(1 << d, bool)
            for s in range(3):
                same &= (a["split"][s] == b["split"][s]).numpy()
            for node in np.flatnonzero(agree):
                counts["nodes"] += 1
                if same[node]:
                    counts["identical"] += 1
                    continue
                w = chip_smoke.split_witness(
                    [_one_node(a, node)], [_one_node(b, node)], 0, 0, depth,
                    names)
                assert w["tie"], (r, d, int(node), w)
                counts["ties"] += 1
                counts["witnesses"].append(w)
                differed = True
            agree = np.repeat(agree & same, 2)
        if differed:
            return counts, agree, r
    return counts, agree, rounds - 1


def _tree_levels(tree, k=None):
    pick = (lambda a: np.asarray(a)) if k is None else \
        (lambda a: np.asarray(a)[k])
    return pick(tree.feat), pick(tree.thresh), pick(tree.miss)


# -- grow_tree --------------------------------------------------------------

@pytest.mark.parametrize("kind,leaf_mode,normalize_gain,frac", [
    ("class", "mean", True, 1.0),      # a forest tree: K = 2, mean leaves
    ("class", "mean", True, 0.5),      # with per-node feature subsets
    ("class", "newton", False, 1.0),
    ("reg", "mean", True, 0.5),
    ("reg", "newton", False, 1.0),     # a boosting step: K = 1
    ("reg", "newton", True, 0.7),
])
def test_grow_tree_matches_jax(monkeypatch, kind, leaf_mode, normalize_gain,
                               frac):
    depth, n_bins = 3, 16
    Xb, y, yr, w = _data(2500, n_bins, seed=11)
    G, H = _payload(kind, y, yr, w)
    key = jax.random.PRNGKey(5)
    kw = dict(depth=depth, n_bins=n_bins, leaf_mode=leaf_mode,
              normalize_gain=normalize_gain, feature_frac=frac,
              min_instances=3.0, reg_lambda=0.5, min_info_gain=1e-4)
    tj = JT.grow_tree(jnp.asarray(Xb), jnp.asarray(G), jnp.asarray(H), key,
                      **kw)
    masks = _ref_node_masks(key, depth, Xb.shape[1], frac) \
        if frac < 1.0 else None
    store = _port_recorder(monkeypatch)
    pkw = {k: v for k, v in kw.items() if k != "feature_frac"}
    tp = PT.grow_tree(torch.from_numpy(Xb), torch.from_numpy(G),
                      torch.from_numpy(H), **pkw,
                      node_masks=None if masks is None else masks.__getitem__)
    assert tp.leaf.shape == (1 << depth, G.shape[1])
    split_kw = store[0][1]
    ref = _ref_levels(*_tree_levels(tj), Xb, G, H, depth, n_bins + 1,
                      split_kw, masks)
    counts, leaf_ok, _ = _compare(_lane(store, 0), ref, depth, Xb.shape[1])
    assert counts["identical"] == counts["nodes"] == 7, counts
    _assert_leaves(tp.leaf.numpy(), np.asarray(tj.leaf), leaf_ok,
                   _leaf_atol(*_tree_levels(tj), Xb, H, depth))


def test_grow_tree_needs_draws_or_a_generator():
    """Per-node subsets come from a draws object's node masks, and every
    split keeps to its node's subset; a per-level subset needs a
    torch.Generator."""
    Xb, y, yr, w = _data(200, 8, seed=1)
    G, H = _payload("class", y, yr, w)
    N, F = Xb.shape
    args = (torch.from_numpy(Xb), torch.from_numpy(G), torch.from_numpy(H))
    with pytest.raises(ValueError, match="Generator"):
        PT.grow_tree(*args, depth=2, n_bins=8, level_feature_frac=0.5)

    def masks():
        return PT.ForestDraws(0, N, F, subsample=1.0, feature_frac=0.5,
                              bootstrap=False, device="cpu").node_masks(0)
    a = PT.grow_tree(*args, depth=2, n_bins=8, node_masks=masks())
    b = PT.grow_tree(*args, depth=2, n_bins=8, node_masks=masks())
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    level = masks()
    for d in range(2):
        lo = (1 << d) - 1
        feat = a.feat[lo:lo + (1 << d)].long()
        assert level(d)[torch.arange(1 << d), feat].all()


# -- fit_forest ---------------------------------------------------------------

@pytest.mark.parametrize("kind,bootstrap,subsample,frac", [
    ("class", True, 1.0, 0.5),
    ("class", False, 0.8, 1.0),
    ("reg", True, 0.7, 1 / 3),
])
def test_fit_forest_matches_jax(monkeypatch, kind, bootstrap, subsample,
                                frac):
    n_trees, depth, n_bins = 4, 3, 16
    Xb, y, yr, w = _data(2000, n_bins, seed=23)
    N, F = Xb.shape
    G, H = _payload(kind, y, yr, w)
    key = jax.random.PRNGKey(9)
    kw = dict(n_trees=n_trees, depth=depth, n_bins=n_bins,
              subsample=subsample, feature_frac=frac, min_instances=2.0,
              min_info_gain=1e-4, leaf_mode="mean", bootstrap=bootstrap)
    tj = JT.fit_forest(jnp.asarray(Xb), jnp.asarray(G), jnp.asarray(H), key,
                       **kw)
    rw, masks = _ref_forest_draws(key, n_trees, N, F, depth, subsample, frac,
                                  bootstrap)
    store = _port_recorder(monkeypatch)
    tp = PT.fit_forest(torch.from_numpy(Xb), torch.from_numpy(G),
                       torch.from_numpy(H), draws=_FedDraws(rw, masks), **kw)
    assert tp.feat.shape == (n_trees, (1 << depth) - 1)
    port = _lane(store, 0)
    for t in range(n_trees):
        wt = rw[t].numpy()
        ref = _ref_levels(*_tree_levels(tj, t), Xb, G * wt[:, None], H * wt,
                          depth, n_bins + 1, store[0][1], masks[t])
        counts, leaf_ok, _ = _compare(port[t * depth:(t + 1) * depth], ref,
                                      depth, F)
        assert counts["identical"] == counts["nodes"] == 7, (t, counts)
        _assert_leaves(tp.leaf[t].numpy(), np.asarray(tj.leaf[t]), leaf_ok,
                       _leaf_atol(*_tree_levels(tj, t), Xb, H * wt, depth))


def test_forest_lanes_share_draws_and_are_independent():
    """The fold lanes of a forest fit share its draws and do not depend on
    each other: a 3-lane fit equals three 1-lane fits, and the summed leaf
    rows are the binned traversal of the trees."""
    n_trees, depth, n_bins = 3, 3, 16
    Xb, y, yr, w = _data(1200, n_bins, seed=31)
    N, F = Xb.shape
    rng = np.random.default_rng(4)
    W = (rng.integers(0, 3, size=N)[None, :] != np.arange(3)[:, None]) \
        * w[None, :]
    W = torch.from_numpy(W.astype(np.float32))
    onehot = torch.from_numpy(np.eye(2, dtype=np.float32)[y.astype(int)].T)
    G = onehot[None] * W[:, None, :]
    Xt = torch.from_numpy(Xb)
    kw = dict(n_trees=n_trees, depth=depth, n_bins=n_bins, feature_frac=0.5,
              min_instances=2.0, seed=7)
    trees, agg = PT.fit_forest_folds(Xt, G, W, **kw)
    assert agg.shape == (3, 2, N)
    for k in range(3):
        t1, a1 = PT.fit_forest_folds(Xt, G[k:k + 1], W[k:k + 1], **kw)
        for f1, f3 in zip(t1, trees):
            assert torch.equal(f1[:, 0], f3[:, k])
        torch.testing.assert_close(a1[0], agg[k], rtol=0, atol=1e-6)
        lane = PT.Tree(*(f[:, k] for f in trees))
        torch.testing.assert_close(
            PT.predict_forest_bins(lane, Xt, depth).T, agg[k], rtol=0,
            atol=1e-5)
    # the draws depend on the seed, not on the device or the depth grown
    d1 = PT.ForestDraws(7, N, F, subsample=1.0, feature_frac=0.5,
                        bootstrap=True, device="cpu")
    d2 = PT.ForestDraws(7, N, F, subsample=1.0, feature_frac=0.5,
                        bootstrap=True, device="cpu")
    m2 = d2.node_masks(1)
    assert torch.equal(d1.node_masks(1)(1), (m2(3), m2(1))[1])
    assert torch.equal(d1.row_weights(2), d2.row_weights(2))
    assert not torch.equal(d1.row_weights(1), d1.row_weights(2))


def test_capture_keys_part_forest_and_boosted_launches(monkeypatch):
    """chip_smoke's capture keys part the launches of one (kernel, F, S) key
    by channels and lanes, so a forest's, a boosted sweep's and a refit's
    launches each keep their first inputs; their counts add up to the
    dispatchers' own. The dispatchers count only where they launch a
    kernel, so here a wrapper counts each CPU call the same way."""
    import collections
    from transmogrifai_tpu_torch.ops import tree_kernels as TK

    def counting(name, fn):
        def run(*a, **kw):
            out = fn(*a, **kw)
            if name == "table_lookup":
                TK._count_launch(name, 1, a[0].shape[1])
            else:
                TK._count_launch(name, a[0].shape[0],
                                 kw.get("n_slots", kw.get("n_nodes")))
            return out
        return run
    for name in TK.KERNELS:
        monkeypatch.setattr(TK, name, counting(name, getattr(TK, name)))
    Xb, y, _, w = _data(600, 16, seed=2)
    N, F = Xb.shape
    Xt, yt, wt = (torch.from_numpy(a) for a in (Xb, y, w))
    W = torch.stack([wt, wt * (torch.arange(N) % 3 != 0)])
    G = torch.nn.functional.one_hot(yt.long(), 2).T.float()[None] * W[:, None]
    TK.reset_launches()
    store, counts = {}, collections.Counter()
    try:
        with chip_smoke.capture_kernel_inputs(store, counts):
            PT.fit_forest_folds(Xt, G, W, n_trees=2, depth=3, n_bins=16)
            PT.fit_gbt_folds(Xt, yt, W, n_rounds=2, depth=3, n_bins=16)
            PT.fit_gbt(Xt, yt, wt, n_rounds=1, depth=3, n_bins=16)
        shape_launches = dict(TK.shape_launches)
    finally:
        TK.reset_launches()
    by_shape = collections.Counter()
    for key, n in counts.items():
        by_shape[chip_smoke.launch_key(key)] += n
    assert dict(by_shape) == shape_launches and set(store) == set(counts)
    root = f"hist_folds F={F} S=1"
    assert {k: n for k, n in counts.items() if k.startswith(root + " ")} \
        == {f"{root} C=4 Fo=2": 2, f"{root} C=3 Fo=2": 2,
            f"{root} C=3 Fo=1": 1}
    assert {k for k in counts if k.startswith("table_lookup F=1 S=8 ")} \
        == {f"table_lookup F=1 S=8 Fo={n}" for n in (4, 2, 1)}
    for key, (name, args, kw) in store.items():
        label, kernel, S, _, _ = chip_smoke.captured_shape(key, name, args,
                                                           kw)
        assert kernel == name and f" S={S} " in key + " ", (key, label)


# -- traversal ----------------------------------------------------------------

def test_predict_bins_and_forest_bins_match_jax():
    rng = np.random.default_rng(3)
    T_, depth, F, K, n_bins = 5, 4, 6, 2, 16
    Xb, *_ = _data(900, n_bins, seed=8, n_feat=F)
    n_int = (1 << depth) - 1
    feat = rng.integers(0, F, size=(T_, n_int)).astype(np.int32)
    thresh = rng.integers(0, n_bins + 1, size=(T_, n_int)).astype(np.int32)
    miss = rng.integers(0, 2, size=(T_, n_int)).astype(np.int32)
    leaf = rng.normal(size=(T_, 1 << depth, K)).astype(np.float32)
    jt = JT.Tree(*(jnp.asarray(a) for a in (feat, thresh, leaf, miss)))
    pt = PT.Tree(*(torch.from_numpy(a) for a in (feat, thresh, leaf, miss)))
    one_j = JT.Tree(*(a[0] for a in jt))
    one_p = PT.Tree(*(a[0] for a in pt))
    np.testing.assert_array_equal(
        PT.predict_bins(one_p, torch.from_numpy(Xb), depth).numpy(),
        np.asarray(JT.predict_bins(one_j, jnp.asarray(Xb), depth)))
    np.testing.assert_allclose(
        PT.predict_forest_bins(pt, torch.from_numpy(Xb), depth).numpy(),
        np.asarray(JT.predict_forest_bins(jt, jnp.asarray(Xb), depth)),
        rtol=0, atol=1e-6)


# -- C2: deep trees -----------------------------------------------------------

def _deep_rows(depth):
    return 2000 if depth <= 6 else 1000


@pytest.mark.parametrize("depth", [6, 12])
@pytest.mark.parametrize("n_bins", [32, 256])
def test_deep_grow_tree_decisions_identical_or_ties(monkeypatch, depth,
                                                   n_bins):
    """grow_tree at the default grids' depths and bins (a forest tree: two
    class channels, mean leaves, normalized gains): every node whose
    ancestors agree splits alike or is a tie, and leaves on identical paths
    agree within 1e-5."""
    Xb, y, yr, w = _data(_deep_rows(depth), n_bins, seed=depth)
    G, H = _payload("class", y, yr, w)
    kw = dict(depth=depth, n_bins=n_bins, leaf_mode="mean",
              normalize_gain=True, min_instances=1.0)
    tj = JT.grow_tree(jnp.asarray(Xb), jnp.asarray(G), jnp.asarray(H),
                      jax.random.PRNGKey(0), **kw)
    store = _port_recorder(monkeypatch)
    tp = PT.grow_tree(torch.from_numpy(Xb), torch.from_numpy(G),
                      torch.from_numpy(H), **kw)
    ref = _ref_levels(*_tree_levels(tj), Xb, G, H, depth, n_bins + 1,
                      store[0][1])
    counts, leaf_ok, _ = _compare(_lane(store, 0), ref, depth, Xb.shape[1])
    print(f"depth {depth} bins {n_bins}: {counts['nodes']} nodes compared, "
          f"{counts['identical']} identical, {counts['ties']} ties")
    assert counts["identical"] >= 0.9 * counts["nodes"], counts
    _assert_leaves(tp.leaf.numpy(), np.asarray(tj.leaf), leaf_ok,
                   _leaf_atol(*_tree_levels(tj), Xb, H, depth))


@pytest.mark.parametrize("depth", [6, 12])
@pytest.mark.parametrize("n_bins", [32, 256])
def test_deep_fold_fused_fit_decisions_identical_or_ties(monkeypatch, depth,
                                                        n_bins):
    """The XGBoost fold-fused fit (2 lanes, 2 rounds) at the default grids'
    depths and bins against the reference's fold-fused fit (its jnp
    twins): node by node within each lane, up to the first round with a
    differing node, every differing node whose ancestors agree is a tie.
    The reference's level histograms are summed again from its own node
    ids and gradients (its margins rebuilt from its trees)."""
    rounds, lanes = 2, 2
    Xb, y, _, _ = _data(_deep_rows(depth), n_bins, seed=depth + 1)
    N, F = Xb.shape
    rng = np.random.default_rng(depth)
    W = (rng.integers(0, lanes, size=N)[None, :]
         != np.arange(lanes)[:, None]).astype(np.float32)
    kw = dict(n_rounds=rounds, depth=depth, n_bins=n_bins, learning_rate=0.3,
              reg_lambda=1.0, min_child_weight=1.0)
    tj, bj, _ = JT.fit_gbt_folds(jnp.asarray(Xb), jnp.asarray(y),
                                 jnp.asarray(W), jax.random.PRNGKey(0), **kw)
    store = _port_recorder(monkeypatch)
    PT.fit_gbt_folds(torch.from_numpy(Xb), torch.from_numpy(y),
                     torch.from_numpy(W), **kw)
    split_kw = store[0][1]
    total = dict(nodes=0, identical=0, ties=0)
    for k in range(lanes):
        margin = jnp.full((N,), bj[k], jnp.float32)
        ref = []
        for r in range(rounds):
            g, h = JT._logistic_grad(margin, jnp.asarray(y), jnp.asarray(W[k]))
            tree = JT.Tree(*(a[r, k] for a in tj))
            ref += _ref_levels(*_tree_levels(tree), Xb, np.asarray(g)[:, None],
                               np.asarray(h), depth, n_bins + 1, split_kw)
            margin = margin + JT.predict_bins(tree, jnp.asarray(Xb),
                                              depth)[:, 0]
        counts, _, _ = _compare(_lane(store, k), ref, depth, F, rounds)
        for key in total:
            total[key] += counts[key]
    print(f"depth {depth} bins {n_bins}: {total}")
    assert total["identical"] >= 0.9 * total["nodes"], total


# -- the kernels' plans at a depth-12 forest tree's shapes --------------------

def test_plans_at_the_depth_12_shapes():
    """Every launch of a depth-12 forest tree at workflow-main's sweep
    shapes (F = 164, B = 33, 5 lanes, 1M rows, 3 payload channels + the
    count; an H100's 132 SMs) has a plan that fits a block's shared memory:
    the root on the private path, route_hist on the rows path with slot
    tiles covering every slot, route at 2048 nodes on the rows path (its
    82 KB of tables fail the staged rule), the 4096-leaf lookup on rows."""
    from transmogrifai_tpu_torch.ops import tree_kernels as TK
    F, B, lanes, N, n_sm = 164, 33, 5, 1_000_000, 132
    root = TK.plan_hist(F, 1, 4, B, lanes, N, n_sm)
    assert root.path == "private" and root.smem_bytes <= TK._SMEM_BLOCK_MAX
    for S in (2, 32, 256, 1024):
        tl = TK.plan_hist(F, S, 4, B, lanes, N, n_sm, route=True)
        assert tl.path == "rows"
        assert tl.s_tile * -(-S // tl.s_tile) >= S
        assert tl.f_tile * -(-F // tl.f_tile) >= F
        assert tl.smem_bytes <= TK._SMEM_BUDGET
    assert TK.route_table_bytes(lanes, 2048) > 80_000
    assert TK.plan_route(F, 2048, lanes, N, n_sm).path == "rows"
    assert TK.plan_lookup(4096, lanes, N, n_sm).path == "rows"
