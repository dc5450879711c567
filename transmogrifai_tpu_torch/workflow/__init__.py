"""Workflow engine: DAG assembly, layered fit/transform, scoring and the
runner (reference core/.../OpWorkflow.scala, OpWorkflowModel.scala,
utils/stages/FitStagesUtil.scala, OpWorkflowRunner.scala, OpApp.scala)."""
from .dag import (CutDAG, StagesDAG, collect_features, collect_raw_features,
                  compute_dag, cut_dag, validate_stages)
from .fitting import LayerRunner
from .runner import (EvaluateResult, FeaturesResult, OpApp, OpParams,
                     OpWorkflowRunner, ReaderParams, RunResult, ScoreResult,
                     TrainResult, apply_stage_params)
from .workflow import Workflow, WorkflowModel

__all__ = ["CutDAG", "StagesDAG", "collect_features", "collect_raw_features",
           "compute_dag", "cut_dag", "validate_stages", "LayerRunner",
           "Workflow", "WorkflowModel", "EvaluateResult", "FeaturesResult",
           "OpApp", "OpParams", "OpWorkflowRunner", "ReaderParams",
           "RunResult", "ScoreResult", "TrainResult", "apply_stage_params"]
