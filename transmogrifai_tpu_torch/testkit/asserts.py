"""Feature assertion helpers for user test suites (counterpart of
testkit/asserts.py).

Reference: testkit/src/main/scala/com/salesforce/op/test/FeatureAsserts
.scala:63 (`assertFeature` — name/response/rawness/type/extractor checks on
a declared feature) and FeatureTestBase.scala. Downstream stage authors use
these the way the reference's ScalaTest traits are used; only the
feature-level asserts live here.
"""
from __future__ import annotations

from typing import Any, Optional, Type

from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..types import FeatureType


def assert_feature(f: Feature, *, in_row: Any, out: Any, name: str,
                   is_response: bool = False,
                   feature_type: Optional[Type[FeatureType]] = None,
                   window_ms: Optional[int] = None) -> None:
    """Assert a RAW feature's declaration end to end (reference
    assertFeature): naming, response flag, type, origin generator stage,
    and that the extractor maps ``in_row`` to ``out``."""
    assert f.name == name, f"name: {f.name!r} != {name!r}"
    assert f.is_response == is_response, \
        f"is_response: {f.is_response} != {is_response}"
    assert not f.parents, f"raw feature must have no parents, got {f.parents}"
    if feature_type is not None:
        assert f.feature_type is feature_type, \
            f"type: {f.feature_type.__name__} != {feature_type.__name__}"
    st = f.origin_stage
    assert isinstance(st, FeatureGeneratorStage), \
        f"origin must be a FeatureGeneratorStage, got {type(st).__name__}"
    assert st.uid.startswith("FeatureGeneratorStage_"), st.uid
    assert st.feature_name == name
    if window_ms is not None:
        got_w = getattr(st.aggregator, "window_ms", None)
        assert got_w == window_ms, f"window: {got_w} != {window_ms}"
    got = st.extract(in_row)
    got_v = got.value if isinstance(got, FeatureType) else got
    want_v = out.value if isinstance(out, FeatureType) else out
    assert got_v == want_v, f"extract({in_row!r}) = {got_v!r} != {want_v!r}"


def assert_transforms(stage, input_values, expected) -> None:
    """Assert a transformer's per-row outputs over typed input tuples
    (reference OpTransformerSpec's expected-outputs check, row level)."""
    assert len(input_values) == len(expected), \
        f"{len(input_values)} inputs vs {len(expected)} expected outputs"
    for vals, want in zip(input_values, expected):
        if not isinstance(vals, tuple):
            vals = (vals,)
        got = stage.transform_value(*vals)
        got_v = got.value if isinstance(got, FeatureType) else got
        want_v = want.value if isinstance(want, FeatureType) else want
        assert got_v == want_v, \
            f"{stage.stage_name}({vals!r}) = {got_v!r} != {want_v!r}"
