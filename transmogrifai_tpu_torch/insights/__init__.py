"""Model explainability (counterpart of insights/; reference
ModelInsights.scala:72 and impl/insights/RecordInsightsLOCO.scala:62)."""
from .corr import RecordInsightsCorr
from .loco import RecordInsightsLOCO
from .model_insights import (
    DerivedFeatureInsights, FeatureInsights, ModelInsights,
    extract_insights, model_contributions,
)

__all__ = [
    "DerivedFeatureInsights", "FeatureInsights", "ModelInsights",
    "RecordInsightsCorr", "RecordInsightsLOCO", "extract_insights", "model_contributions",
]
