"""Stage class registry + save-arg (de)serialization (counterpart of
stages/registry.py).

Reference: features/.../stages/OpPipelineStageWriter.scala:52 /
OpPipelineStageReader.scala:52 — stages are rebuilt from their class name
and constructor args. Every stage class exposes `save_args()` (plain
numpy and JSON, never a tensor) and the classmethod `from_save_args`; the
registry maps class names to the port's classes, so a stage saved by
either package rebuilds as the port's class of the same name. Saving a
workflow (workflow/io.py) hoists the arrays of save_args into one npz
store with `pack_args`, and loading puts them back with `unpack_args`;
`build_stage` places the rebuilt stage on a device. The same path carries
a fitted JAX workflow across in memory (convert.workflow_model_from_jax).
A user's stage class loads once it is registered (`register_stage`, or its
module through `register_module`), as the reference requires a stage class
to be on the classpath at load time.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, Optional

import numpy as np

from ..device import DeviceLike

# Modules scanned for PipelineStage subclasses; register_module and
# register_stage add a user's.
_STAGE_MODULES = [
    "transmogrifai_tpu_torch.stages.base",
    "transmogrifai_tpu_torch.features.generator",
    "transmogrifai_tpu_torch.automl.vectorizers.numeric",
    "transmogrifai_tpu_torch.automl.vectorizers.categorical",
    "transmogrifai_tpu_torch.automl.vectorizers.combiner",
    "transmogrifai_tpu_torch.automl.vectorizers.text",
    "transmogrifai_tpu_torch.automl.vectorizers.dates",
    "transmogrifai_tpu_torch.automl.vectorizers.geo",
    "transmogrifai_tpu_torch.automl.vectorizers.maps",
    "transmogrifai_tpu_torch.transformers.math",
    "transmogrifai_tpu_torch.transformers.misc",
    "transmogrifai_tpu_torch.transformers.text",
    "transmogrifai_tpu_torch.transformers.topics",
    "transmogrifai_tpu_torch.transformers.ner",
    "transmogrifai_tpu_torch.automl.preparators",
    "transmogrifai_tpu_torch.automl.selector",
    "transmogrifai_tpu_torch.models.glm",
    "transmogrifai_tpu_torch.models.trees",
    "transmogrifai_tpu_torch.models.mlp",
    "transmogrifai_tpu_torch.insights.loco",
    "transmogrifai_tpu_torch.insights.corr",
]

_EXTRA_STAGES: Dict[str, type] = {}
_registry_cache: Optional[Dict[str, type]] = None


def register_stage(cls: type) -> type:
    """Register a user stage class for load-time recovery (usable as a
    decorator); it takes precedence over a scanned class of its name."""
    global _registry_cache
    _EXTRA_STAGES[cls.__name__] = cls
    _registry_cache = None
    return cls


def register_module(module_name: str) -> None:
    """Scan `module_name` for stage classes too (imported at the next
    lookup)."""
    global _registry_cache
    if module_name not in _STAGE_MODULES:
        _STAGE_MODULES.append(module_name)
        _registry_cache = None


def stage_registry() -> Dict[str, type]:
    global _registry_cache
    if _registry_cache is not None:
        return _registry_cache
    from .base import PipelineStage
    reg: Dict[str, type] = {}
    for mod_name in _STAGE_MODULES:
        mod = importlib.import_module(mod_name)
        for obj in vars(mod).values():
            if isinstance(obj, type) and issubclass(obj, PipelineStage):
                reg[obj.__name__] = obj
    reg.update(_EXTRA_STAGES)
    _registry_cache = reg
    return reg


def resolve_stage_class(name: str) -> type:
    reg = stage_registry()
    if name not in reg:
        raise NotImplementedError(
            f"stage class '{name}' is neither ported nor registered: a "
            "user stage loads once its class is registered with "
            "transmogrifai_tpu_torch.stages.registry.register_stage (or its "
            "module with register_module)")
    return reg[name]


# -- array packing ---------------------------------------------------------

def pack_args(obj: Any, store: Dict[str, np.ndarray], prefix: str) -> Any:
    """Recursively replace ndarrays with {"__ndarray__": key} refs, hoisting
    the arrays into `store` (saved as one npz next to the JSON graph)."""
    if isinstance(obj, np.ndarray):
        key = f"{prefix}.{len(store)}"
        store[key] = obj
        return {"__ndarray__": key}
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, dict):
        return {str(k): pack_args(v, store, prefix) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [pack_args(v, store, prefix) for v in obj]
    return obj


def unpack_args(obj: Any, store: Dict[str, np.ndarray]) -> Any:
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__ndarray__"}:
            return store[obj["__ndarray__"]]
        return {k: unpack_args(v, store) for k, v in obj.items()}
    if isinstance(obj, list):
        return [unpack_args(v, store) for v in obj]
    return obj


def build_stage(class_name: str, args: Dict[str, Any],
                device: DeviceLike = None):
    """Instantiate a stage from its class name + save_args, on `device`
    (None: the default, CUDA), with the input contract its estimator
    pinned on it."""
    cls = resolve_stage_class(class_name)
    if class_name == "SelectedModel":
        stage = cls.from_save_args(args, device=device)
    else:
        stage = cls.from_save_args(args)
        stage.device = device
    _apply_pinned_contract(stage, args)
    return stage


def _apply_pinned_contract(stage, args: Dict[str, Any]) -> None:
    """Restore an instance-level contract saved by PipelineStage.save_args
    (Estimator.fit pins fitted models to their estimator's types)."""
    pinned = args.get("pinned_input_types")
    if pinned is None:
        return
    from ..types import FeatureType
    stage.input_types = tuple(
        None if n is None else FeatureType.from_name(n) for n in pinned)
    if "pinned_is_sequence" in args:
        stage.is_sequence = bool(args["pinned_is_sequence"])
    if "pinned_fixed_arity" in args:
        stage.fixed_arity = int(args["pinned_fixed_arity"])


def default_from_save_args(cls: type, args: Dict[str, Any]):
    """Construct cls(**args), dropping keys its __init__ does not accept
    (mirror of PipelineStage.copy's filtering) and the JAX package's
    save/load bookkeeping keys."""
    args = {k: v for k, v in args.items()
            if k != "lambda" and not k.startswith("pinned_")}
    sig = inspect.signature(cls.__init__)
    has_kwargs = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    if not has_kwargs:
        accepted = set(sig.parameters) - {"self"}
        args = {k: v for k, v in args.items() if k in accepted}
    return cls(**args)
