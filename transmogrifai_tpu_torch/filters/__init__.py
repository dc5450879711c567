"""Raw-feature filtering (reference core/.../filters/): exclude unreliable
raw features before training — see `raw_feature_filter`."""
from .raw_feature_filter import (
    ExclusionReasons, FeatureDistribution, RawFeatureFilter,
    RawFeatureFilterResults, RffResult, compute_distributions,
)

__all__ = [
    "ExclusionReasons", "FeatureDistribution", "RawFeatureFilter",
    "RawFeatureFilterResults", "RffResult", "compute_distributions",
]
