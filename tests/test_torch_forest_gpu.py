"""The forest slice on the card: the four kernels at the shapes of a depth-12
forest tree, and forest and Spark GBT fits on the card against the same
fits on the CPU (the kernels' plain versions). Every test needs a CUDA
device and skips without one. This file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_forest_gpu.py

Tolerances: route and table_lookup exact, histogram counts exact, g/h
cells held to the float64 sums within 1e-4 of a cell's sum of |terms| or
the plain version's own error (`hist_paths.accuracy`); the refits' split
decisions identical, or the first node where they differ a tie within the
f32 noise of the two devices' histograms (chip_smoke.split_witness), and
where the decisions are identical the leaves within the f32 error that
sibling subtraction leaves in them (2 x depth ulps of the root's mass over
the leaf's weight; at least 1e-5) and the probabilities within 1e-5 plus
what those leaf bounds allow. Both devices subtract siblings, but sum the
parents in another order: a small leaf under a large root carries the
root's rounding.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from transmogrifai_tpu_torch.models.trees import (OpGBTClassifier,
                                                  OpRandomForestClassifier)
from transmogrifai_tpu_torch.ops import tree_kernels as TK
from transmogrifai_tpu_torch.tools import hist_paths as HP

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def deep():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return HP.deep_inputs(20_011, seed=3)


@pytest.mark.parametrize("boosted,index",
                         [(False, i) for i in range(6)]
                         + [(True, i) for i in range(4)])
def test_kernels_at_depth_12_shapes(deep, boosted, index):
    """hist_folds at the root with 3 payload channels + the count (a
    forest) or 2 + the count (a boosted fit), route_hist at S = 32, 256,
    1024 with either payload, route at 2048 nodes, table_lookup over 4096
    leaves (F = 164, 5 lanes), each against its plain version."""
    label, name, S, args, kw = HP.deep_shapes(deep, boosted)[index]
    got = getattr(TK, name)(*args, **kw)
    torch.cuda.synchronize()
    want = HP.plain(name, args, kw)
    acc = HP.accuracy(name, got, want, args, kw)
    assert acc["ok"], (label, acc)
    if name in ("hist_folds", "route_hist"):
        Co = HP.hist_channels(args, kw)
        assert Co == (3 if boosted else 4)
        hist = got[0] if isinstance(got, tuple) else got
        assert hist.shape == (deep["Fo"] * S * Co, deep["F"] * deep["B"])


def _data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 12)).astype(np.float32)
    X[rng.uniform(size=n) < 0.1, 0] = np.nan
    X[:, 5] = rng.integers(0, 4, size=n)
    logit = 1.5 * X[:, 1] + np.nan_to_num(X[:, 0]) * X[:, 2] - X[:, 5] / 2
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return X, y


def _leaf_bound(levels, depth, lr):
    """[trees, leaves] bound on a leaf's difference between two devices
    whose trees decide alike: the f32 error sibling subtraction leaves in
    a leaf's sums, up to 2 * depth ulps of the root's total mass W = count
    + weight (|g| <= w a row), over the leaf's weight plus lambda, scaled
    by (1 + |raw leaf|) for the weight's own error; from the CPU's
    recorded histograms (its first and last level of each tree)."""
    from transmogrifai_tpu_torch.ops import trees as T
    eps = float(np.finfo(np.float32).eps)
    out = []
    for r in range(len(levels) // depth):
        root, last = levels[r * depth], levels[r * depth + depth - 1]
        _, rs = T._level_gains(root["full"].double(), root["split_kw"],
                               *root["masks"])
        W = float(rs[5][0, 0] + rs[4][0, 0])            # count + weight
        _, s = T._level_gains(last["full"].double(), last["split_kw"],
                              *last["masks"])
        f, t, m = (x.long() for x in last["split"])
        nid = torch.arange(len(f))
        h_left = s[1][0, nid, f, t] - m * s[7][0, nid, f]
        h = torch.stack([h_left, s[4][0] - h_left], 1).reshape(-1)
        lam = last["split_kw"]["reg_lambda"]
        b = lr * 2 * depth * eps * W / (h + lam).clamp(min=1e-30)
        out.append(torch.where(h > 0, b, float("inf")).numpy())
    return np.stack(out)                  # inf: a leaf no row trained


@pytest.mark.parametrize("make", [
    lambda dev: OpRandomForestClassifier(device=dev, num_trees=4,
                                         max_depth=6, min_instances_per_node=5),
    lambda dev: OpGBTClassifier(device=dev, max_iter=3, max_depth=5),
], ids=["forest", "gbt"])
def test_fit_on_the_card_matches_the_cpu(deep, make):
    """Where the decisions agree, every leaf within its f32 bound
    (`_leaf_bound`; at least 1e-5) and every row's probability within
    1e-5 plus what those leaf bounds allow (a quarter of their sum for
    boosted margins, their mean for averaged distributions); otherwise the
    first node apart must be a tie."""
    X, y = _data(30_000, 7)
    levels, models = {}, {}
    for dev in ("cpu", "cuda"):
        with chip_smoke.record_refit_levels([]) as lv:
            models[dev] = make(dev).fit_arrays(X, y)
        levels[dev] = lv
    est = make("cpu")
    depth = int(est.get_param("max_depth"))
    first = chip_smoke.first_divergence(levels["cpu"], levels["cuda"])
    if first is not None:
        w = chip_smoke.split_witness(levels["cpu"], levels["cuda"], *first,
                                     depth, [f"x{j}" for j in range(12)])
        assert w["tie"], w
        return
    boosted = models["cpu"].mode == "margin"
    lr = float(est.get_param("step_size")) if boosted else 1.0
    leaf = {dev: m.leaf for dev, m in models.items()}   # [trees, leaves, K]
    raw = np.abs(leaf["cpu"]).max(axis=2) / lr
    bound = np.maximum(_leaf_bound(levels["cpu"], depth, lr) * (1 + raw),
                       1e-5)
    diff = np.abs(leaf["cuda"] - leaf["cpu"]).max(axis=2)
    empty = np.isinf(bound)               # counts are exact: 0 on both
    assert (diff[empty] == 0).all() and (diff <= bound).all(), \
        float((diff - bound).max())
    worst = np.where(empty, 0.0, bound).max(axis=1)
    slack = 0.25 * worst.sum() if boosted else worst.mean()
    dprob = np.abs(models["cuda"].predict_arrays(X)[2][:, 1]
                   - models["cpu"].predict_arrays(X)[2][:, 1])
    assert dprob.max() <= 1e-5 + slack, (float(dprob.max()), slack)
