"""Row-level scoring: ``Map[String,Any] -> Map[String,Any]`` (counterpart of
local/scoring.py).

Reference: local/.../OpWorkflowModelLocal.scala:93,141,154 — the fitted
workflow replayed per input map, each stage through ``transformKeyValue``.
Here every fitted stage scores one record through the same
``transform_keyvalue`` protocol, so one saved model serves both the batch
path and this local path. The JAX package's local path replays on the host
(tree ensembles traverse their thresholds in numpy, GLMs are a dot
product); the port's replays on the CPU by name: `score_function` scores
through shallow copies of the fitted stages whose device is "cpu", their
plain PyTorch versions, while the model's own stages, and so its batch
path, stay on their device.

Serving error contract: a bad record fails with a TYPED error naming the
offending key BEFORE it reaches a stage — the serving frontend maps
:class:`UnknownFeatureError` / :class:`MissingFeatureError` /
:class:`InvalidFeatureError` to HTTP 400, where an opaque ``KeyError`` or
``TypeError`` escaping a stage deep in the DAG would surface as a 500.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, TYPE_CHECKING

from ..stages.base import PipelineStage

if TYPE_CHECKING:  # pragma: no cover
    from ..workflow.workflow import WorkflowModel

ScoreFunction = Callable[[Dict[str, Any]], Dict[str, Any]]


class UnknownFeatureError(ValueError):
    """Record carries a key that matches no raw feature of the workflow."""

    def __init__(self, key: str, known=()):
        self.key = key
        hint = f" (known features: {sorted(known)})" if known else ""
        super().__init__(f"unknown record key {key!r}{hint}")


class MissingFeatureError(KeyError):
    """A raw feature's extract function needs a key the record lacks.

    Subclasses KeyError so callers catching the plain KeyError keep
    working, with a message that names the feature."""

    def __init__(self, feature: str, key: Any = None):
        self.feature = feature
        self.key = key
        detail = f" (record key {key!r})" if key is not None else ""
        super().__init__(f"record is missing data for raw feature "
                         f"{feature!r}{detail}")

    def __str__(self) -> str:  # KeyError.__str__ repr()s the arg
        return self.args[0]


class InvalidFeatureError(ValueError):
    """A record value failed its feature type's coercion."""

    def __init__(self, feature: str, value: Any, cause: Exception):
        self.feature = feature
        self.value = value
        super().__init__(f"invalid value for raw feature {feature!r}: "
                         f"{value!r} ({type(cause).__name__}: {cause})")


def _extract(gen, record: Dict[str, Any]):
    """One generator's extract with the typed-error boundary applied."""
    try:
        return gen.extract(record)
    except KeyError as e:
        raise MissingFeatureError(gen.feature_name,
                                  key=e.args[0] if e.args else None) from e
    except (TypeError, ValueError, AttributeError) as e:
        raise InvalidFeatureError(
            gen.feature_name,
            record.get(gen.feature_name) if isinstance(record, dict)
            else record, e) from e


def record_validator(model: "WorkflowModel", strict_keys: bool = True
                     ) -> Callable[[Dict[str, Any]], None]:
    """Up-front record validation for the serving path.

    Returns validate(record) raising :class:`UnknownFeatureError` for a
    key naming no raw feature (strict_keys=False skips that check: batch
    readers carry extra columns such as row ids),
    :class:`MissingFeatureError` / :class:`InvalidFeatureError` when a
    predictor's extract cannot produce a value. Response features are
    exempt: serving records are unlabeled.

    The extraction runs again at batch assembly, on purpose: it is a few
    dict lookups and coercions a record, and paying it at submit time lets
    the batcher reject a bad record before it joins a batch that other
    requests share.
    """
    raw = model.raw_features()
    known = {f.name for f in raw}
    generators = [f.origin_stage for f in raw if not f.is_response]

    def validate(record: Dict[str, Any]) -> None:
        if not isinstance(record, dict):
            raise InvalidFeatureError(
                "<record>", record, TypeError("record must be a dict"))
        if strict_keys:
            for k in record:
                if k not in known:
                    raise UnknownFeatureError(k, known)
        for gen in generators:
            _extract(gen, record)

    return validate


def _on_cpu(stage: PipelineStage) -> PipelineStage:
    """A shallow copy of a fitted stage that scores on the CPU, and of
    each stage it wraps (a selected model's winner). Fitted parameters are
    numpy arrays, so the copies share them with the original."""
    st = copy.copy(stage)
    st.device = "cpu"
    for k, v in vars(st).items():
        if isinstance(v, PipelineStage):
            setattr(st, k, _on_cpu(v))
    return st


def score_function(model: "WorkflowModel") -> ScoreFunction:
    """The per-record scorer of a fitted workflow.

    The returned function takes a raw record dict (the keys the reader's
    extract functions expect), replays raw-feature extraction and every
    fitted stage in DAG order on the CPU, and returns
    {result_feature_name: value}. Mirrors OpWorkflowModelLocal.scoreFunction
    (stage replay in DAG order, local/.../OpWorkflowModelLocal.scala:93).
    Extraction failures raise the typed errors above (never a bare KeyError
    from inside a stage); key-set strictness is the caller's choice via
    `record_validator`.
    """
    raw_feats = model.raw_features()
    # responses are not extracted at serving time (records are unlabeled);
    # downstream stages read them as None
    generators = [f.origin_stage for f in raw_feats if not f.is_response]
    response_names = [f.name for f in raw_feats if f.is_response]
    layers = [[_on_cpu(st) for st in layer] for layer in model.dag.layers]
    result_names = [f.name for f in model.result_features]

    def score(record: Dict[str, Any]) -> Dict[str, Any]:
        row: Dict[str, Any] = {n: None for n in response_names}
        for gen in generators:
            row[gen.feature_name] = _extract(gen, record)
        for layer in layers:
            for st in layer:
                row[st.output_name()] = st.transform_keyvalue(row)
        return {n: row[n] for n in result_names}

    return score
