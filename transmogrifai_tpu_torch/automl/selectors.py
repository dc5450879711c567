"""Binary, multiclass and regression model-selector presets + default
hyperparameter grids (counterpart of automl/selectors.py).

Reference: core/.../impl/classification/BinaryClassificationModelSelector.scala
(:59-61 default model types, :67-110 grids),
MultiClassificationModelSelector.scala,
regression/RegressionModelSelector.scala,
selector/DefaultSelectorParams.scala:35-56.

The port has every model type of the JAX package: OpLogisticRegression
(binary and softmax), OpLinearSVC, OpNaiveBayes, OpLinearRegression,
OpGeneralizedLinearRegression, OpMultilayerPerceptronClassifier (binary
and multiclass, the sequential route) and the eight tree families (random
forest, decision tree, Spark GBT and XGBoost, each a classifier and a
regressor). Asking for a type it does not know raises
NotImplementedError naming it: a type is never dropped in silence, which
would run a smaller sweep than the reference.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..device import DeviceLike
from ..evaluators.evaluators import Evaluator, Evaluators
from ..models.base import PredictorEstimator
from ..stages.params import ParamMap, param_grid
from .selector import ModelSelector
from .tuning.splitters import DataBalancer, DataCutter, DataSplitter, Splitter
from .tuning.validators import CrossValidation, TrainValidationSplit, Validator


class DefaultSelectorParams:
    """Reference DefaultSelectorParams.scala:35-56."""

    MAX_DEPTH = [3, 6, 12]
    MAX_BIN = [32]
    MIN_INSTANCES_PER_NODE = [10, 100]
    MIN_INFO_GAIN = [0.001, 0.01, 0.1]
    REGULARIZATION = [0.001, 0.01, 0.1, 0.2]
    MAX_ITER_LIN = [50]
    MAX_ITER_TREE = [20]
    SUBSAMPLE_RATE = [1.0]
    STEP_SIZE = [0.1]
    ELASTIC_NET = [0.1, 0.5]
    MAX_TREES = [50]
    STANDARDIZED = [True]
    TOL = [1e-6]
    FIT_INTERCEPT = [True]
    NB_SMOOTHING = [1.0]
    DIST_FAMILY = ["gaussian", "poisson"]
    NUM_ROUND_XGB = [100]
    ETA_XGB = [0.1, 0.3]
    MIN_CHILD_WEIGHT_XGB = [1.0, 5.0, 10.0]


D = DefaultSelectorParams


def _models_by_name() -> Dict[str, type]:
    """The model types the port has, by the reference's names."""
    from ..models import glm, mlp, trees
    return {"OpLogisticRegression": glm.OpLogisticRegression,
            "OpLinearSVC": glm.OpLinearSVC,
            "OpNaiveBayes": glm.OpNaiveBayes,
            "OpLinearRegression": glm.OpLinearRegression,
            "OpGeneralizedLinearRegression":
                glm.OpGeneralizedLinearRegression,
            "OpRandomForestClassifier": trees.OpRandomForestClassifier,
            "OpRandomForestRegressor": trees.OpRandomForestRegressor,
            "OpGBTClassifier": trees.OpGBTClassifier,
            "OpGBTRegressor": trees.OpGBTRegressor,
            "OpDecisionTreeClassifier": trees.OpDecisionTreeClassifier,
            "OpDecisionTreeRegressor": trees.OpDecisionTreeRegressor,
            "OpXGBoostClassifier": trees.OpXGBoostClassifier,
            "OpXGBoostRegressor": trees.OpXGBoostRegressor,
            "OpMultilayerPerceptronClassifier":
                mlp.OpMultilayerPerceptronClassifier}


def default_grid_for(name: str) -> List[ParamMap]:
    """Default sweep grid of a ported model type (reference grids
    :67-110)."""
    if name == "OpLogisticRegression":
        return param_grid(reg_param=D.REGULARIZATION,
                          elastic_net_param=D.ELASTIC_NET,
                          max_iter=D.MAX_ITER_LIN)
    if name == "OpLinearSVC":
        return param_grid(reg_param=D.REGULARIZATION,
                          max_iter=D.MAX_ITER_LIN)
    if name == "OpNaiveBayes":
        return param_grid(smoothing=D.NB_SMOOTHING)
    if name == "OpLinearRegression":
        return param_grid(reg_param=D.REGULARIZATION,
                          elastic_net_param=D.ELASTIC_NET,
                          max_iter=D.MAX_ITER_LIN)
    if name == "OpGeneralizedLinearRegression":
        return param_grid(family=D.DIST_FAMILY, reg_param=D.REGULARIZATION)
    if name in ("OpRandomForestClassifier", "OpRandomForestRegressor"):
        return param_grid(max_depth=D.MAX_DEPTH,
                          min_instances_per_node=D.MIN_INSTANCES_PER_NODE,
                          min_info_gain=D.MIN_INFO_GAIN,
                          num_trees=D.MAX_TREES)
    if name in ("OpGBTClassifier", "OpGBTRegressor"):
        return param_grid(max_depth=D.MAX_DEPTH,
                          min_instances_per_node=D.MIN_INSTANCES_PER_NODE,
                          min_info_gain=D.MIN_INFO_GAIN,
                          max_iter=D.MAX_ITER_TREE, step_size=D.STEP_SIZE)
    if name in ("OpDecisionTreeClassifier", "OpDecisionTreeRegressor"):
        return param_grid(max_depth=D.MAX_DEPTH,
                          min_instances_per_node=D.MIN_INSTANCES_PER_NODE,
                          min_info_gain=D.MIN_INFO_GAIN)
    if name in ("OpXGBoostClassifier", "OpXGBoostRegressor"):
        return param_grid(max_depth=D.MAX_DEPTH, eta=D.ETA_XGB,
                          min_child_weight=D.MIN_CHILD_WEIGHT_XGB,
                          num_round=D.NUM_ROUND_XGB)
    return [dict()]


def _resolve_models(model_types: Sequence[str], problem_type: str,
                    models_and_params: Optional[Sequence[
                        Tuple[PredictorEstimator, List[ParamMap]]]],
                    seed: int, device: DeviceLike
                    ) -> List[Tuple[PredictorEstimator, List[ParamMap]]]:
    if models_and_params is not None:
        return list(models_and_params)
    registry = _models_by_name()
    missing = [name for name in model_types if name not in registry]
    if missing:
        raise NotImplementedError(
            f"model types {missing} are not ported yet (the port has "
            f"{sorted(registry)}); pass model_types or "
            "models_and_parameters restricted to those")
    out: List[Tuple[PredictorEstimator, List[ParamMap]]] = []
    for name in model_types:
        est = registry[name](device=device)
        if problem_type not in est.problem_types:
            raise ValueError(f"{name} does not support {problem_type}")
        if est.has_param("seed"):
            est.set_param("seed", seed)
        out.append((est, default_grid_for(name)))
    if not out:
        raise ValueError("No models to select among")
    return out


class _SelectorFactory:
    """The presets' shared constructors. `device` (None = CUDA) is where
    the selector's sweep, refit and evaluation run; a Workflow's device
    fills it when it is None. The reference's `parallelism` (the thread
    count of its sequential validation route, which the port runs one fit
    at a time) is not taken."""

    problem_type = "binary"
    default_model_types: Tuple[str, ...] = ()
    default_evaluator = staticmethod(Evaluators.BinaryClassification.au_pr)
    default_splitter = staticmethod(lambda seed: DataBalancer(seed=seed))

    @classmethod
    def with_cross_validation(cls, splitter: Optional[Splitter] = None,
                              evaluator: Optional[Evaluator] = None,
                              num_folds: int = 3, seed: int = 42,
                              stratify: bool = False,
                              model_types: Optional[Sequence[str]] = None,
                              models_and_parameters=None,
                              device: DeviceLike = None) -> ModelSelector:
        ev = evaluator or cls.default_evaluator()
        validator = CrossValidation(ev, num_folds=num_folds, seed=seed,
                                    stratify=stratify)
        return cls._build(validator, splitter, seed, model_types,
                          models_and_parameters, device)

    @classmethod
    def with_train_validation_split(cls, splitter: Optional[Splitter] = None,
                                    evaluator: Optional[Evaluator] = None,
                                    train_ratio: float = 0.75, seed: int = 42,
                                    stratify: bool = False,
                                    model_types: Optional[Sequence[str]] = None,
                                    models_and_parameters=None,
                                    device: DeviceLike = None
                                    ) -> ModelSelector:
        ev = evaluator or cls.default_evaluator()
        validator = TrainValidationSplit(ev, train_ratio=train_ratio,
                                         seed=seed, stratify=stratify)
        return cls._build(validator, splitter, seed, model_types,
                          models_and_parameters, device)

    @classmethod
    def _build(cls, validator: Validator, splitter: Optional[Splitter],
               seed: int, model_types, models_and_parameters,
               device: DeviceLike) -> ModelSelector:
        split = splitter if splitter is not None \
            else cls.default_splitter(seed)
        models = _resolve_models(
            model_types if model_types is not None else cls.default_model_types,
            cls.problem_type, models_and_parameters, seed, device)
        sel = ModelSelector(validator, split, models,
                            operation_name=f"{cls.problem_type}ModelSelector",
                            device=device)
        sel.problem_type = cls.problem_type
        return sel


class BinaryClassificationModelSelector(_SelectorFactory):
    """Reference BinaryClassificationModelSelector.scala (defaults :59-61:
    LR/RF/GBT/SVC on; NB/DT/XGB off)."""

    problem_type = "binary"
    default_model_types = ("OpLogisticRegression", "OpRandomForestClassifier",
                           "OpGBTClassifier", "OpLinearSVC")


class RegressionModelSelector(_SelectorFactory):
    """Reference RegressionModelSelector.scala (defaults: LinReg/RF/GBT on;
    the metric RMSE; a DataSplitter's 10% holdout)."""

    problem_type = "regression"
    default_model_types = ("OpLinearRegression", "OpRandomForestRegressor",
                           "OpGBTRegressor")
    default_evaluator = staticmethod(Evaluators.Regression.rmse)
    default_splitter = staticmethod(lambda seed: DataSplitter(seed=seed))


class MultiClassificationModelSelector(_SelectorFactory):
    """Reference MultiClassificationModelSelector.scala (defaults: LR and RF
    on; the metric the multiclass error; a DataCutter's label cutting and
    10% holdout)."""

    problem_type = "multiclass"
    default_model_types = ("OpLogisticRegression", "OpRandomForestClassifier")
    default_evaluator = staticmethod(Evaluators.MultiClassification.error)
    default_splitter = staticmethod(lambda seed: DataCutter(seed=seed))
