"""Arithmetic feature transformers (counterpart of transformers/math.py).

Reference: core/.../impl/feature/MathTransformers.scala and the
RichNumericFeature dsl operators. Every op is a TorchTransformer: tensor
math over whole columns, which the workflow's layer runner runs in one f32
pass on the stage's device (workflow/fitting.py). Empties are NaN and
propagate as the reference's None-propagating semantics.

A division by a constant is a product with the constant's f32 reciprocal:
the JAX package's jitted layer program divides that way (XLA's algebraic
simplifier rewrites x / c into x * (1 / c)), so the two packages give the
same f32 bits, on the CPU and on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..stages.base import Estimator, TorchTransformer
from ..stages.params import Param
from ..types import OPNumeric, Real, RealNN

_EPS = 1e-12


def reciprocal32(c: float) -> float:
    """1 / c rounded to f32, as a python float (exact in f32)."""
    return float(np.float32(1.0) / np.float32(c))


class _BinaryMath(TorchTransformer):
    # any numeric subtype is accepted, as in RichNumericFeature's implicits
    input_types = (OPNumeric, OPNumeric)
    output_type = Real

    def __init__(self, uid: Optional[str] = None, **params):
        params.pop("operation_name", None)
        super().__init__(self._op_name, uid=uid, **params)


class AddTransformer(_BinaryMath):
    """x + y (reference BinaryOperationTransformer '+')."""
    _op_name = "plus"

    def get_torch_fn(self):
        return lambda a, b: a + b


class SubtractTransformer(_BinaryMath):
    _op_name = "minus"

    def get_torch_fn(self):
        return lambda a, b: a - b


class MultiplyTransformer(_BinaryMath):
    _op_name = "multiply"

    def get_torch_fn(self):
        return lambda a, b: a * b


class DivideTransformer(_BinaryMath):
    """x / y; division by ~0 yields empty (reference divide semantics)."""
    _op_name = "divide"

    def get_torch_fn(self):
        def fn(a, b):
            tiny = b.abs() < _EPS
            out = a / torch.where(tiny, torch.ones_like(b), b)
            return torch.where(tiny, torch.full_like(out, float("nan")), out)
        return fn


class _ScalarMath(TorchTransformer):
    input_types = (OPNumeric,)
    output_type = Real

    @classmethod
    def _declare_params(cls):
        return [Param("scalar", "scalar operand", 0.0)]

    def __init__(self, scalar: float = 0.0, uid: Optional[str] = None,
                 **params):
        params.setdefault("scalar", scalar)
        params.pop("operation_name", None)
        super().__init__(self._op_name, uid=uid, **params)


class ScalarAddTransformer(_ScalarMath):
    _op_name = "plusS"

    def get_torch_fn(self):
        s = float(self.get_param("scalar"))
        return lambda a: a + s


class ScalarSubtractTransformer(_ScalarMath):
    _op_name = "minusS"

    def get_torch_fn(self):
        s = float(self.get_param("scalar"))
        return lambda a: a - s


class ScalarMultiplyTransformer(_ScalarMath):
    _op_name = "multiplyS"

    def get_torch_fn(self):
        s = float(self.get_param("scalar"))
        return lambda a: a * s


class ScalarDivideTransformer(_ScalarMath):
    _op_name = "divideS"

    def get_torch_fn(self):
        s = float(self.get_param("scalar"))
        if abs(s) <= _EPS:
            return lambda a: torch.full_like(a, float("nan"))
        r = reciprocal32(s)
        return lambda a: a * r


class _UnaryMath(TorchTransformer):
    input_types = (OPNumeric,)
    output_type = Real

    def __init__(self, uid: Optional[str] = None, **params):
        params.pop("operation_name", None)
        super().__init__(self._op_name, uid=uid, **params)


class AbsTransformer(_UnaryMath):
    _op_name = "abs"

    def get_torch_fn(self):
        return torch.abs


class CeilTransformer(_UnaryMath):
    _op_name = "ceil"

    def get_torch_fn(self):
        return torch.ceil


class FloorTransformer(_UnaryMath):
    _op_name = "floor"

    def get_torch_fn(self):
        return torch.floor


class RoundTransformer(_UnaryMath):
    """Round half away from zero (reference RoundTransformer)."""
    _op_name = "round"

    def get_torch_fn(self):
        return lambda a: torch.sign(a) * torch.floor(a.abs() + 0.5)


class ExpTransformer(_UnaryMath):
    _op_name = "exp"

    def get_torch_fn(self):
        return torch.exp


class SqrtTransformer(_UnaryMath):
    """sqrt; negative input yields empty."""
    _op_name = "sqrt"

    def get_torch_fn(self):
        return lambda a: torch.where(a < 0, torch.full_like(a, float("nan")),
                                     torch.sqrt(a.clamp(min=0)))


class LogTransformer(_UnaryMath):
    """log base b; non-positive input yields empty (reference
    LogTransformer)."""
    _op_name = "log"

    @classmethod
    def _declare_params(cls):
        return [Param("base", "logarithm base", float(np.e))]

    def __init__(self, base: float = float(np.e), uid: Optional[str] = None,
                 **params):
        params.setdefault("base", base)
        super().__init__(uid=uid, **params)

    def get_torch_fn(self):
        r = reciprocal32(float(np.log(self.get_param("base"))))
        return lambda a: torch.where(
            a > 0, torch.log(a.clamp(min=_EPS)) * r,
            torch.full_like(a, float("nan")))


class PowerTransformer(_UnaryMath):
    _op_name = "power"

    @classmethod
    def _declare_params(cls):
        return [Param("exponent", "power", 1.0)]

    def __init__(self, exponent: float = 1.0, uid: Optional[str] = None,
                 **params):
        params.setdefault("exponent", exponent)
        super().__init__(uid=uid, **params)

    def get_torch_fn(self):
        p = float(self.get_param("exponent"))
        return lambda a: torch.pow(a, p)


class ZNormalizeEstimator(Estimator):
    """Real -> RealNN z-score (reference RichNumericFeature.zNormalize via
    OpScalarStandardScaler): fit mean and std over the present values in
    float64, transform to (x - mean) / std with NaN -> 0 after scaling
    (the centered empty value)."""

    input_types = (Real,)
    output_type = RealNN

    def __init__(self, uid: Optional[str] = None, **params):
        super().__init__(params.pop("operation_name", "zNormalize"),
                         uid=uid, **params)

    def fit_columns(self, *cols):
        x = np.asarray(cols[0].data, np.float64)
        ok = np.isfinite(x)
        mean = float(x[ok].mean()) if ok.any() else 0.0
        # sample std (ddof=1), Spark StandardScaler's estimator; a single
        # present value has no spread -> unit scale
        std = float(x[ok].std(ddof=1)) if ok.sum() > 1 else 1.0
        return ZNormalizeModel(mean=mean, std=max(std, _EPS),
                               operation_name=self.operation_name)


class ZNormalizeModel(TorchTransformer):
    input_types = (Real,)
    output_type = RealNN

    def __init__(self, mean: float = 0.0, std: float = 1.0,
                 operation_name: str = "zNormalize",
                 uid: Optional[str] = None, **params):
        self.mean = float(mean)
        self.std = float(std)
        super().__init__(operation_name, uid=uid, **params)

    def get_torch_fn(self):
        m, r = self.mean, reciprocal32(self.std)
        return lambda a: torch.nan_to_num((a - m) * r, nan=0.0)

    def save_args(self):
        d = super().save_args()
        d.update(mean=self.mean, std=self.std)
        return d
