"""Workflow engine: DAG assembly, layered fit/transform, scoring (reference
core/.../OpWorkflow.scala, OpWorkflowModel.scala,
utils/stages/FitStagesUtil.scala)."""
from .dag import (CutDAG, StagesDAG, collect_features, collect_raw_features,
                  compute_dag, cut_dag, validate_stages)
from .fitting import LayerRunner
from .workflow import Workflow, WorkflowModel

__all__ = ["CutDAG", "StagesDAG", "collect_features", "collect_raw_features",
           "compute_dag", "cut_dag", "validate_stages", "LayerRunner",
           "Workflow", "WorkflowModel"]
