"""Pipeline stage base classes (counterpart of stages/base.py).

Reference: features/.../stages/OpPipelineStages.scala (OpPipelineStageBase:56,
OpPipelineStage1..2N:219-504, OpTransformer:527) and the lambda-style bases
under features/.../stages/base/.

The protocol is columnar, as in the JAX package: ``transform_columns`` maps
whole input columns to an output column. Where the JAX package's stages
expose a traceable ``get_jax_fn``, the port's expose ``get_torch_fn``: a
pure function of tensors, batched over rows, with the same meaning. The
workflow's layer runner runs every such function of a DAG layer on device
tensors in one pass (workflow/fitting.py). A per-row path
(``transform_value``, and ``transform_keyvalue`` over a record dict)
remains for local scoring and contract tests.

Every stage carries a `device` (None = unset): the workflow's layer runner
fills it from `Workflow(device=...)` for each stage that has none, and a
stage given its own device keeps it. Tensor code resolves it through
`device.resolve_device`, so None means CUDA.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np
import torch

from ..data.dataset import Column, Dataset, column_from_values
from ..data.vector import VectorMetadata
from ..device import resolve_device
from ..features.feature import Feature
from ..types import ColumnKind, FeatureType
from ..utils.uid import make_uid
from .params import HasParams

# column kinds a torch function reads as one float tensor
TENSOR_KINDS = (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL,
                ColumnKind.VECTOR)


class PipelineStage(HasParams):
    """Base of every stage: typed inputs, a single typed output feature."""

    # expected FeatureType classes of inputs. None entries = any type.
    # For sequence stages, checked against every sequence input.
    input_types: Tuple[Optional[Type[FeatureType]], ...] = ()
    output_type: Type[FeatureType] = FeatureType
    # sequence stages accept a variable number of trailing inputs
    is_sequence: bool = False
    # number of fixed (non-sequence) leading inputs for sequence stages
    fixed_arity: int = 0

    def __init__(self, operation_name: str, uid: Optional[str] = None,
                 **params: Any):
        self.operation_name = operation_name
        self.uid = uid or make_uid(type(self))
        self._init_params(**params)
        self._input_features: Tuple[Feature, ...] = ()
        self._output_name_override: Optional[str] = None
        if not hasattr(self, "device"):
            self.device = None

    # -- identity ----------------------------------------------------------
    @property
    def stage_name(self) -> str:
        return f"{type(self).__name__}_{self.operation_name}"

    def __repr__(self) -> str:
        ins = ", ".join(f.name for f in self._input_features)
        return (f"{type(self).__name__}(op={self.operation_name}, "
                f"in=[{ins}], uid={self.uid})")

    # -- wiring ------------------------------------------------------------
    def check_input_types(self, features: Sequence[Feature]) -> None:
        if self.is_sequence:
            fixed = features[:self.fixed_arity]
            seq = features[self.fixed_arity:]
            expected_fixed = self.input_types[:self.fixed_arity]
            seq_type = self.input_types[self.fixed_arity] if len(
                self.input_types) > self.fixed_arity else None
            for i, (f, t) in enumerate(zip(fixed, expected_fixed)):
                if t is not None and not issubclass(f.feature_type, t):
                    raise TypeError(
                        f"{self.stage_name} input {i} must be {t.__name__}, "
                        f"got {f.type_name} ({f.name})")
            for f in seq:
                if seq_type is not None and \
                        not issubclass(f.feature_type, seq_type):
                    raise TypeError(
                        f"{self.stage_name} sequence inputs must be "
                        f"{seq_type.__name__}, got {f.type_name} ({f.name})")
        else:
            if self.input_types and len(features) != len(self.input_types):
                raise TypeError(
                    f"{self.stage_name} expects {len(self.input_types)} "
                    f"inputs, got {len(features)}")
            for i, (f, t) in enumerate(zip(features, self.input_types)):
                if t is not None and not issubclass(f.feature_type, t):
                    raise TypeError(
                        f"{self.stage_name} input {i} must be {t.__name__}, "
                        f"got {f.type_name} ({f.name})")

    def set_input(self, *features: Feature) -> "PipelineStage":
        self.check_input_types(features)
        self._input_features = tuple(features)
        return self

    @property
    def input_features(self) -> Tuple[Feature, ...]:
        return self._input_features

    def input_names(self) -> List[str]:
        return [f.name for f in self._input_features]

    # -- output ------------------------------------------------------------
    def set_output_name(self, name: str) -> "PipelineStage":
        self._output_name_override = name
        return self

    def output_name(self) -> str:
        if self._output_name_override:
            return self._output_name_override
        base = "-".join(f.name for f in self._input_features) or "out"
        suffix = self.uid.rsplit("_", 1)[-1]
        return f"{base}_{self.operation_name}_{suffix}"

    def output_is_response(self) -> bool:
        """Output is a response iff any input is (reference
        OpPipelineStage.outputIsResponse)."""
        return any(f.is_response for f in self._input_features)

    def get_output(self) -> Feature:
        if not self._input_features:
            raise ValueError(f"{self.stage_name}: set_input before get_output")
        return Feature(
            name=self.output_name(),
            feature_type=self.output_type,
            is_response=self.output_is_response(),
            origin_stage=self,
            parents=self._input_features,
        )

    # -- construction args -------------------------------------------------
    def save_args(self) -> Dict[str, Any]:
        """Constructor args that rebuild this stage, declared param values
        included (reference OpPipelineStageWriter ctor-arg capture)."""
        d = {"operation_name": self.operation_name, "uid": self.uid}
        d.update(self.param_values())
        # a contract pinned on the instance (Estimator.fit narrowing the
        # fitted model to its estimator's types) survives save and load
        if "input_types" in self.__dict__:
            d["pinned_input_types"] = [
                None if t is None else t.type_name()
                for t in self.input_types]
            d["pinned_is_sequence"] = bool(self.is_sequence)
            d["pinned_fixed_arity"] = int(self.fixed_arity)
        return d

    @classmethod
    def from_save_args(cls, args: Dict[str, Any]) -> "PipelineStage":
        """Rebuild from save_args (reference OpPipelineStageReader.scala:52):
        cls(**args) filtered through the ctor signature; stages whose state
        is not plain ctor kwargs override this."""
        from .registry import default_from_save_args
        return default_from_save_args(cls, args)

    def copy(self, **param_overrides: Any) -> "PipelineStage":
        """Fresh instance with same ctor args (new uid, same device) and
        current+overridden params — used by the model selector to expand
        grids."""
        import inspect
        args = self.save_args()
        args.pop("uid", None)
        sig = inspect.signature(type(self).__init__)
        accepted = set(sig.parameters) - {"self"}
        has_kwargs = any(p.kind is inspect.Parameter.VAR_KEYWORD
                         for p in sig.parameters.values())
        if not has_kwargs:
            args = {k: v for k, v in args.items() if k in accepted}
        else:
            # kwargs catch-all is the declared-params channel; drop ctor args
            # the subclass sets itself (e.g. hardcoded operation_name)
            args = {k: v for k, v in args.items()
                    if k in accepted or self.has_param(k)}
        clone = type(self)(**args)
        clone.device = self.device
        for k, v in self.param_values().items():
            clone.set_param(k, v)
        for k, v in param_overrides.items():
            clone.set_param(k, v)
        if self._input_features:
            clone.set_input(*self._input_features)
        return clone


def to_host(out) -> np.ndarray:
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out)


class Transformer(PipelineStage):
    """A stage that maps input columns to an output column with no fitting.

    Implement ONE of:
      * ``transform_value(*vals)``   — per-row (always works; slow path)
      * ``transform_columns(*cols)`` — columnar override (fast path)
      * ``get_torch_fn() -> fn``     — pure tensor math, batched over rows;
                                       the layer runner runs it on the
                                       stage's device with the layer's
                                       other tensor stages.
    """

    def get_torch_fn(self) -> Optional[Callable]:
        """Pure fn tensors->tensor (batched over rows), or None."""
        return None

    def transform_value(self, *vals: FeatureType) -> FeatureType:
        fn = self.get_torch_fn()
        if fn is not None:
            dev = resolve_device(self.device)
            args = [torch.as_tensor(np.asarray(
                np.nan if v.value is None else
                (v.value if isinstance(v.value, np.ndarray)
                 else float(v.value)), np.float32), device=dev)
                for v in vals]
            # torch fns are batched over rows: add/strip a singleton batch
            # dim
            out = to_host(fn(*[a[None] for a in args]))[0]
            if self.output_type.column_kind != ColumnKind.VECTOR and \
                    out.ndim == 0:
                out = out.item()
                if isinstance(out, float) and np.isnan(out):
                    out = None
            return self.output_type(out)
        raise NotImplementedError(
            f"{self.stage_name} implements neither transform_value nor a "
            "torch fn")

    def transform_columns(self, *cols: Column) -> Column:
        fn = self.get_torch_fn()
        if fn is not None and all(c.kind in TENSOR_KINDS for c in cols):
            dev = resolve_device(self.device)
            out = to_host(fn(*[torch.as_tensor(
                np.asarray(c.data, np.float32), device=dev) for c in cols]))
            return self.column_from_tensor_output(out)
        return self._transform_columns_rowwise(*cols)

    def column_from_tensor_output(self, out: np.ndarray) -> Column:
        """The output column of this stage from its torch fn's result."""
        kind = self.output_type.column_kind
        if kind == ColumnKind.VECTOR:
            if out.ndim == 1:
                out = out[:, None]
            return Column(kind=kind, data=out.astype(np.float32, copy=False),
                          metadata=self.output_metadata())
        return Column(kind=kind, data=out.astype(np.float64))

    def _transform_columns_rowwise(self, *cols: Column) -> Column:
        in_types = [f.feature_type for f in self._input_features] or \
            [t or FeatureType for t in self.input_types]
        n = len(cols[0]) if cols else 0
        out_vals = []
        for i in range(n):
            vals = []
            for c, t in zip(cols, in_types):
                vals.append(self._value_from_column(c, t, i))
            out_vals.append(self.transform_value(*vals))
        return self._column_from_outputs(out_vals)

    @staticmethod
    def _value_from_column(col: Column, t: Type[FeatureType],
                           i: int) -> FeatureType:
        v = col.data[i]
        if col.kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
            v = None if (isinstance(v, float) and np.isnan(v)) else v
        return t(v)

    def _column_from_outputs(self, out_vals: List[FeatureType]) -> Column:
        col = column_from_values(self.output_type, out_vals)
        if col.kind == ColumnKind.VECTOR:
            col.metadata = self.output_metadata()
        return col

    def output_metadata(self) -> Optional[VectorMetadata]:
        """VectorMetadata for vector-producing transformers (override)."""
        return None

    def transform(self, ds: Dataset) -> Dataset:
        """Append this stage's output column to the dataset."""
        cols = [ds.column(n) for n in self.input_names()]
        out = self.transform_columns(*cols)
        return ds.with_column(self.output_name(), out)

    def transform_keyvalue(self, row: Dict[str, Any]) -> Any:
        """Row-level scoring protocol (reference OpTransformer
        .transformKeyValue:551) of the local scorer: dict in, raw output
        value out. Serving records carry no labels: a missing response value
        becomes a placeholder (fitted transformers never read responses) so
        non-nullable response types (RealNN) do not reject None."""
        vals = []
        for f in self._input_features:
            t = f.feature_type
            v = row.get(f.name)
            if v is None and f.is_response:
                try:
                    vals.append(t(None))
                except Exception:
                    vals.append(t(0.0))
            else:
                vals.append(t(v))
        return self.transform_value(*vals).value


class Estimator(PipelineStage):
    """A stage that must be fit: produces a fitted Transformer (its model).

    Two-phase contract (reference estimator/model split): ``fit_columns``
    runs statistics and returns a fitted Transformer whose shapes are fully
    concrete."""

    def fit_columns(self, *cols: Column) -> Transformer:
        raise NotImplementedError

    def fit(self, ds: Dataset) -> Transformer:
        cols = [ds.column(n) for n in self.input_names()]
        model = self.fit_columns(*cols)
        # pin the fitted instance to this estimator's contract: model
        # classes that declare a broad element type (e.g. OneHotModel's
        # (None,)) enforce, per instance, exactly what their estimator
        # accepted
        model.input_types = tuple(self.input_types)
        model.is_sequence = self.is_sequence
        model.fixed_arity = self.fixed_arity
        model.set_input(*self._input_features)
        model.set_output_name(self.output_name())
        # model replaces the estimator as origin of the output feature
        model.uid = self.uid
        if model.device is None:
            model.device = self.device
        return model


# -- lambda-style concrete bases ------------------------------------------
# (reference stages/base/{unary,binary,ternary,quaternary}/: the arity is
# len(input_types); these keep user code as terse as the Scala lambda
# bases)

class LambdaTransformer(Transformer):
    """Transformer from a row-level python function."""

    def __init__(self, operation_name: str,
                 transform_fn: Callable[..., FeatureType],
                 input_types: Sequence[Optional[Type[FeatureType]]],
                 output_type: Type[FeatureType],
                 uid: Optional[str] = None, **params: Any):
        self.input_types = tuple(input_types)
        self.output_type = output_type
        self._fn = transform_fn
        super().__init__(operation_name, uid=uid, **params)

    def transform_value(self, *vals: FeatureType) -> FeatureType:
        out = self._fn(*vals)
        if not isinstance(out, FeatureType):
            out = self.output_type(out)
        return out

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        d["lambda"] = True  # the function itself does not travel
        return d


def unary_transformer(operation_name: str, fn: Callable, in_type, out_type,
                      **params) -> LambdaTransformer:
    return LambdaTransformer(operation_name, fn, (in_type,), out_type,
                             **params)


def binary_transformer(operation_name: str, fn: Callable, in1, in2,
                       out_type, **params) -> LambdaTransformer:
    return LambdaTransformer(operation_name, fn, (in1, in2), out_type,
                             **params)


class TorchTransformer(Transformer):
    """Transformer defined purely by tensor math (counterpart of
    JaxTransformer). Pass the batched tensors->tensor fn to the ctor (or
    override ``get_torch_fn`` in a subclass)."""

    def __init__(self, operation_name: str,
                 fn: Optional[Callable] = None,
                 input_types: Sequence[Optional[Type[FeatureType]]] = (),
                 output_type: Type[FeatureType] = FeatureType,
                 uid: Optional[str] = None, **params: Any):
        self._fn = fn
        if input_types:
            self.input_types = tuple(input_types)
        if output_type is not FeatureType:
            self.output_type = output_type
        super().__init__(operation_name, uid=uid, **params)

    def get_torch_fn(self) -> Optional[Callable]:
        return self._fn

    def save_args(self) -> Dict[str, Any]:
        d = super().save_args()
        if self._fn is not None:
            # a function passed to the constructor does not travel: load
            # needs the stage in custom_stages (subclasses that build their
            # function from params do not set this)
            d["lambda"] = True
        return d
