"""Workflow engine: DAG assembly, layered fit/transform, scoring (reference
core/.../OpWorkflow.scala, OpWorkflowModel.scala,
utils/stages/FitStagesUtil.scala)."""
from .dag import (StagesDAG, collect_features, collect_raw_features,
                  compute_dag, validate_stages)
from .fitting import LayerRunner
from .workflow import Workflow, WorkflowModel

__all__ = ["StagesDAG", "collect_features", "collect_raw_features",
           "compute_dag", "validate_stages", "LayerRunner", "Workflow",
           "WorkflowModel"]
