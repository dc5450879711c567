"""Carry fitted parameters across from the JAX package.

Each takes plain numpy arrays, lists and dicts — what the JAX package's
`TreeEnsembleModel.save_args()`, `SoftmaxEnsembleModel.save_args()`,
`LinearBinaryModel.save_args()`, `SoftmaxModel.save_args()`,
`NaiveBayesModel.save_args()`, `LinearRegressionModel.save_args()`,
`MLPModel.save_args()`, `IsotonicRegressionModel.save_args()`, `Tree`
fields, a `PerceptronNerTagger`'s fields and fitted workflow stages hold — so this module imports nothing of the JAX package. With them
both packages score the same fitted model or the same fitted workflow
(`workflow_model_from_jax`). A fitted stage is rebuilt as a saved one is
loaded (stages/registry.build_stage), so whatever a saved model may hold
carries across.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .data.vector import VectorMetadata
from .device import DeviceLike, resolve_device
from .features.feature import Feature
from .models.glm import LinearBinaryModel, NaiveBayesModel, SoftmaxModel
from .models.mlp import IsotonicRegressionModel, MLPModel
from .models.trees import SoftmaxEnsembleModel, TreeEnsembleModel
from .ops.trees import Tree


def tree_model_from_jax(save_args: Dict[str, Any],
                        device: DeviceLike = None) -> TreeEnsembleModel:
    """A port TreeEnsembleModel from the JAX TreeEnsembleModel's
    save_args(): feat, thresh_val, leaf, miss, depth, mode, base."""
    return TreeEnsembleModel(
        feat=save_args["feat"], thresh_val=save_args["thresh_val"],
        leaf=save_args["leaf"], miss=save_args["miss"],
        depth=int(save_args["depth"]), mode=str(save_args["mode"]),
        base=float(save_args.get("base", 0.0)),
        n_classes=int(save_args.get("n_classes", 2)),
        operation_name=str(save_args.get("operation_name", "treeEnsemble")),
        device=device)


def linear_model_from_jax(save_args: Dict[str, Any],
                          device: DeviceLike = None) -> LinearBinaryModel:
    """A port LinearBinaryModel from the JAX LinearBinaryModel's
    save_args(): beta, intercept, probabilistic."""
    return LinearBinaryModel(
        beta=save_args["beta"], intercept=float(save_args["intercept"]),
        probabilistic=bool(save_args.get("probabilistic", True)),
        operation_name=str(save_args.get("operation_name", "linBin")),
        device=device)


def softmax_ensemble_from_jax(save_args: Dict[str, Any],
                              device: DeviceLike = None
                              ) -> SoftmaxEnsembleModel:
    """A port SoftmaxEnsembleModel from the JAX SoftmaxEnsembleModel's
    save_args(): feat, thresh_val, leaf, miss [rounds * classes, ...],
    depth, n_classes."""
    return SoftmaxEnsembleModel(
        feat=save_args["feat"], thresh_val=save_args["thresh_val"],
        leaf=save_args["leaf"], miss=save_args["miss"],
        depth=int(save_args["depth"]),
        n_classes=int(save_args["n_classes"]),
        operation_name=str(save_args.get("operation_name", "xgbSoftmax")),
        device=device)


def softmax_model_from_jax(save_args: Dict[str, Any],
                           device: DeviceLike = None) -> SoftmaxModel:
    """A port SoftmaxModel from the JAX SoftmaxModel's save_args(): B
    [d, c], b0 [c]."""
    return SoftmaxModel(
        B=np.asarray(save_args["B"], np.float32),
        b0=np.asarray(save_args["b0"], np.float32),
        operation_name=str(save_args.get("operation_name", "softmax")),
        device=device)


def naive_bayes_model_from_jax(save_args: Dict[str, Any],
                               device: DeviceLike = None) -> NaiveBayesModel:
    """A port NaiveBayesModel from the JAX NaiveBayesModel's save_args():
    log_prob [c, d], log_prior [c]."""
    return NaiveBayesModel(
        log_prob=np.asarray(save_args["log_prob"], np.float32),
        log_prior=np.asarray(save_args["log_prior"], np.float32),
        operation_name=str(save_args.get("operation_name", "nb")),
        device=device)


def mlp_model_from_jax(save_args: Dict[str, Any],
                       device: DeviceLike = None) -> MLPModel:
    """A port MLPModel from the JAX MLPModel's save_args(): weights
    [fan_in, fan_out] and biases of each layer."""
    return MLPModel(
        weights=[np.asarray(w, np.float32) for w in save_args["weights"]],
        biases=[np.asarray(b, np.float32) for b in save_args["biases"]],
        operation_name=str(save_args.get("operation_name", "mlp")),
        device=device)


def isotonic_model_from_jax(save_args: Dict[str, Any],
                            device: DeviceLike = None
                            ) -> IsotonicRegressionModel:
    """A port IsotonicRegressionModel from the JAX one's save_args():
    boundaries, values (float64) and increasing."""
    return IsotonicRegressionModel(
        boundaries=np.asarray(save_args["boundaries"], np.float64),
        values=np.asarray(save_args["values"], np.float64),
        increasing=bool(save_args.get("increasing", True)),
        operation_name=str(save_args.get("operation_name", "isoCalibrator")),
        device=device)


def ner_tagger_from_jax(weights: Dict[str, Dict[str, float]],
                        classes: Sequence[str],
                        gazetteer: Dict[str, Any]):
    """A port PerceptronNerTagger from the JAX one's `weights` (feature ->
    class -> averaged weight), `classes` and `gazetteer` (entity -> words);
    the text stages' fitted state (LDA's beta and alpha, word2vec's
    embeddings and seed, the vocabularies, idf and labels) rides their
    save_args."""
    from .transformers.ner_model import PerceptronNerTagger
    return PerceptronNerTagger(
        weights={f: dict(w) for f, w in weights.items()},
        classes=list(classes),
        gazetteer={k: sorted(v) for k, v in gazetteer.items()})


def tree_from_jax(feat, thresh, leaf, miss, device: DeviceLike = None) -> Tree:
    """A port binned `Tree` from the JAX Tree's arrays (any leading axes)."""
    dev = resolve_device(device)

    def t(a, dtype):   # a writable copy of the (read-only) JAX buffer
        return torch.as_tensor(np.array(a), dtype=dtype, device=dev)

    return Tree(t(feat, torch.int32), t(thresh, torch.int32),
                t(leaf, torch.float32), t(miss, torch.int32))


def stage_state(stage) -> Dict[str, Any]:
    """The plain state of one fitted workflow stage of either package: its
    class name, `save_args()` and, for a vector-producing stage, its output
    metadata as JSON."""
    md = stage.output_metadata() if hasattr(stage, "output_metadata") \
        else None
    return {"class": type(stage).__name__, "args": stage.save_args(),
            "metadata": None if md is None else md.to_json()}


def _fitted_stage(state: Dict[str, Any], device: DeviceLike):
    from .stages.registry import build_stage
    stage = build_stage(state["class"], dict(state["args"]), device=device)
    if state.get("metadata") is not None and hasattr(stage, "set_metadata"):
        stage.set_metadata(VectorMetadata.from_json(state["metadata"]))
    return stage


def workflow_model_from_jax(result_features: Sequence[Feature],
                            stage_states: List[Dict[str, Any]],
                            device: DeviceLike = None,
                            blacklist: Sequence[str] = (),
                            rff_results: Optional[Dict[str, Any]] = None):
    """A fitted port WorkflowModel from the fitted JAX workflow's stage
    state.

    `result_features` are the port's result features of the same workflow
    (built the same way in the port, unfitted); `stage_states` holds
    `stage_state(st)` of every stage of the JAX WorkflowModel, in the order
    of its `stages`. The two DAGs are matched stage by stage in layer order
    (the class names must agree): each port estimator is replaced by the
    port's fitted counterpart of the JAX stage — vectorizer fills and
    vocabularies with their metadata, the SanityChecker's kept indices, the
    selector's best model (SelectedModel.from_save_args) — wired to the
    port's features, on `device`. `blacklist` and
    `rff_results` (the JAX WorkflowModel's `blacklist` and its
    `rff_results.to_json()`) carry a RawFeatureFilter's outcome across."""
    from .filters.raw_feature_filter import RawFeatureFilterResults
    from .stages.base import Estimator
    from .workflow.dag import StagesDAG, compute_dag
    from .workflow.fitting import LayerRunner
    from .workflow.workflow import WorkflowModel

    dag = compute_dag(tuple(result_features))
    if len(dag.stages) != len(stage_states):
        raise ValueError(f"the port's workflow has {len(dag.stages)} stages, "
                         f"the fitted one {len(stage_states)}")
    states = iter(stage_states)
    layers = []
    for layer in dag.layers:
        row = []
        for st in layer:
            state = next(states)
            if not isinstance(st, Estimator):
                if type(st).__name__ != state["class"]:
                    raise ValueError(f"stage {st.stage_name} does not match "
                                     f"the fitted {state['class']}")
                row.append(st)
                continue
            model = _fitted_stage(state, device)
            model.input_types = tuple(st.input_types)
            model.is_sequence = st.is_sequence
            model.fixed_arity = st.fixed_arity
            model.set_input(*st.input_features)
            model.set_output_name(st.output_name())
            model.uid = st.uid
            row.append(model)
        layers.append(row)
    return WorkflowModel(
        tuple(result_features), StagesDAG(layers), LayerRunner(device),
        blacklist=blacklist,
        rff_results=None if rff_results is None
        else RawFeatureFilterResults.from_json(rff_results))
