"""Stage class registry (counterpart of stages/registry.py).

Reference: features/.../stages/OpPipelineStageReader.scala:52 — stages are
rebuilt from their class name and constructor args. The port uses the
registry to rebuild a fitted workflow from another package's stage state
(convert.workflow_model_from_jax): each stage's class name and
`save_args()` select and build the port's class of the same name. Saving
and loading a workflow to disk (workflow/io.py of the JAX package) is not
ported yet, so the registry holds no array packing.
"""
from __future__ import annotations

import importlib
import inspect
from typing import Any, Dict, Optional

# Modules scanned for PipelineStage subclasses.
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
    "transmogrifai_tpu_torch.automl.preparators",
    "transmogrifai_tpu_torch.automl.selector",
    "transmogrifai_tpu_torch.models.glm",
    "transmogrifai_tpu_torch.models.trees",
]

_registry_cache: Optional[Dict[str, type]] = None


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
    _registry_cache = reg
    return reg


def resolve_stage_class(name: str) -> type:
    reg = stage_registry()
    if name not in reg:
        raise NotImplementedError(
            f"stage class '{name}' is not ported yet")
    return reg[name]


def build_stage(class_name: str, args: Dict[str, Any]):
    """Instantiate a stage from its class name + save_args."""
    return resolve_stage_class(class_name).from_save_args(args)


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
