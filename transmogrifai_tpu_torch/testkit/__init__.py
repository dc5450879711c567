"""Test scaffolding (counterpart of testkit/; reference testkit module,
2,769 LoC): random typed data generators, TestFeatureBuilder, and feature
asserts. Host Python and numpy: a generator draws the same values as the
JAX package's from the same seed."""
from .asserts import assert_feature, assert_transforms
from .feature_builder import TestFeatureBuilder
from .random_data import (
    RandomBinary, RandomData, RandomGeolocation, RandomIntegral, RandomList,
    RandomMap, RandomReal, RandomSet, RandomText, RandomVector,
)

__all__ = [
    "assert_feature", "assert_transforms",
    "RandomBinary", "RandomData", "RandomGeolocation", "RandomIntegral",
    "RandomList", "RandomMap", "RandomReal", "RandomSet", "RandomText",
    "RandomVector", "TestFeatureBuilder",
]
