"""Carry fitted parameters across from the JAX package.

Each takes plain numpy arrays or lists — what the JAX package's
`TreeEnsembleModel.save_args()`, `LinearBinaryModel.save_args()` and `Tree`
fields hold — so this module imports nothing of the JAX package. With them
both packages score the same fitted model.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.glm import LinearBinaryModel
from .models.trees import TreeEnsembleModel
from .ops.trees import Tree


def tree_model_from_jax(save_args: Dict[str, Any],
                        device: DeviceLike = None) -> TreeEnsembleModel:
    """A port TreeEnsembleModel from the JAX TreeEnsembleModel's
    save_args(): feat, thresh_val, leaf, miss, depth, mode, base."""
    return TreeEnsembleModel(
        feat=save_args["feat"], thresh_val=save_args["thresh_val"],
        leaf=save_args["leaf"], miss=save_args["miss"],
        depth=int(save_args["depth"]), mode=str(save_args["mode"]),
        base=float(save_args.get("base", 0.0)),
        n_classes=int(save_args.get("n_classes", 2)),
        operation_name=str(save_args.get("operation_name", "treeEnsemble")),
        device=device)


def linear_model_from_jax(save_args: Dict[str, Any],
                          device: DeviceLike = None) -> LinearBinaryModel:
    """A port LinearBinaryModel from the JAX LinearBinaryModel's
    save_args(): beta, intercept, probabilistic."""
    return LinearBinaryModel(
        beta=save_args["beta"], intercept=float(save_args["intercept"]),
        probabilistic=bool(save_args.get("probabilistic", True)),
        operation_name=str(save_args.get("operation_name", "linBin")),
        device=device)


def tree_from_jax(feat, thresh, leaf, miss, device: DeviceLike = None) -> Tree:
    """A port binned `Tree` from the JAX Tree's arrays (any leading axes)."""
    dev = resolve_device(device)

    def t(a, dtype):   # a writable copy of the (read-only) JAX buffer
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return Tree(t(feat, torch.int32), t(thresh, torch.int32),
                t(leaf, torch.float32), t(miss, torch.int32))
