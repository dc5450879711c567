"""Random hyperparameter search builder (counterpart of
automl/random_param.py).

Reference: core/.../impl/selector/RandomParamBuilder.scala (196 LoC) —
random grids over uniform / log-uniform (exponential) / subset domains,
passed to a ModelSelector instead of the exhaustive default grids. The
draws come from numpy's `default_rng(seed)` in declaration order, so a
seed gives the JAX package's grids exactly.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from ..stages.params import ParamMap


class RandomParamBuilder:
    """``RandomParamBuilder(seed).uniform("step_size", 0.01, 0.3)
    .exponential("reg_param", 1e-6, 1.0).subset("max_depth", [3, 6, 12])
    .build(10)``"""

    def __init__(self, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._draws: List[tuple] = []

    def uniform(self, name: str, lo: float, hi: float) -> "RandomParamBuilder":
        if hi < lo:
            raise ValueError(f"{name}: hi < lo")
        self._draws.append(("uniform", name, float(lo), float(hi)))
        return self

    def exponential(self, name: str, lo: float, hi: float
                    ) -> "RandomParamBuilder":
        """Log-uniform (reference exponential): both bounds must be > 0."""
        if lo <= 0 or hi < lo:
            raise ValueError(f"{name}: need 0 < lo <= hi")
        self._draws.append(("exponential", name, float(lo), float(hi)))
        return self

    def uniform_int(self, name: str, lo: int, hi: int) -> "RandomParamBuilder":
        if hi < lo:
            raise ValueError(f"{name}: hi < lo")
        self._draws.append(("uniform_int", name, int(lo), int(hi)))
        return self

    def subset(self, name: str, choices: Sequence[Any]
               ) -> "RandomParamBuilder":
        if not choices:
            raise ValueError(f"{name}: empty choices")
        self._draws.append(("subset", name, list(choices), None))
        return self

    def build(self, n: int) -> List[ParamMap]:
        out: List[ParamMap] = []
        for _ in range(n):
            g: Dict[str, Any] = {}
            for kind, name, a, b in self._draws:
                if kind == "uniform":
                    g[name] = float(self._rng.uniform(a, b))
                elif kind == "exponential":
                    g[name] = float(np.exp(self._rng.uniform(np.log(a),
                                                             np.log(b))))
                elif kind == "uniform_int":
                    g[name] = int(self._rng.integers(a, b + 1))
                else:
                    g[name] = a[int(self._rng.integers(0, len(a)))]
            out.append(g)
        return out
