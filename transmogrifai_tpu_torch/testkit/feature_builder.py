"""TestFeatureBuilder: (Dataset, Feature...) from in-memory typed values
(counterpart of testkit/feature_builder.py).

Reference: testkit/.../test/TestFeatureBuilder.scala:50,265,298 — builds a
DataFrame plus matching raw Features from literal typed values, arities 1-5,
variadic, and `random`. Here it returns a columnar Dataset whose columns line
up with FeatureGeneratorStage-origin Features, ready for Workflow or direct
stage fitting.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Type

from ..data.dataset import Dataset, column_from_values
from ..features.builder import FeatureBuilder
from ..features.feature import Feature
from ..types import FeatureType
from .random_data import RandomData

DEFAULT_NAMES = ("f1", "f2", "f3", "f4", "f5")


def _make_feature(name: str, type_cls: Type[FeatureType],
                  is_response: bool = False) -> Feature:
    builder = FeatureBuilder.of(name, type_cls).extract(
        lambda r, _n=name: r.get(_n))
    return builder.as_response() if is_response else builder.as_predictor()


def _infer_type(values: Sequence[Any]) -> Type[FeatureType]:
    for v in values:
        if isinstance(v, FeatureType):
            return type(v)
    raise ValueError("Pass FeatureType instances or use the (name, type, "
                     "values) form to build test features")


class TestFeatureBuilder:
    """``ds, (f1, f2) = TestFeatureBuilder.build(("age", Real, [...]), ...)``"""

    @staticmethod
    def build(*specs: Tuple, response_index: Optional[int] = None
              ) -> Tuple[Dataset, Tuple[Feature, ...]]:
        """Each spec: (name, FeatureTypeClass, values) or (name, values) with
        values as FeatureType instances. `response_index` marks one feature
        as the response."""
        cols = {}
        feats: List[Feature] = []
        for i, spec in enumerate(specs):
            if len(spec) == 3:
                name, tcls, values = spec
            else:
                name, values = spec
                tcls = _infer_type(values)
            raw = [v.value if isinstance(v, FeatureType) else v
                   for v in values]
            cols[name] = column_from_values(tcls, raw)
            feats.append(_make_feature(name, tcls,
                                       is_response=(i == response_index)))
        return Dataset(cols), tuple(feats)

    @staticmethod
    def random(n: int, **generators: RandomData
               ) -> Tuple[Dataset, Tuple[Feature, ...]]:
        """``ds, (age, name) = TestFeatureBuilder.random(100, age=RandomReal
        .normal(), name=RandomText.names())`` (reference TestFeatureBuilder
        .random:298)."""
        specs = []
        for name, gen in generators.items():
            vals = gen.take(n)
            specs.append((name, gen.type_cls, [v.value for v in vals]))
        return TestFeatureBuilder.build(*specs)
