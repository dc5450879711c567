"""PyTorch and CUDA port of transmogrifai_tpu, for one NVIDIA H100.

A user drives the port as the JAX package, through the Workflow entry:
typed features (`features.builder.FeatureBuilder`), `transmogrify()`
(automl/transmogrifier.py), the `SanityChecker` (automl/preparators.py,
its statistics one pass of ops/stats_engine.py on the device) and
`BinaryClassificationModelSelector` (automl/selectors.py) inside
`Workflow(...).train()` and `score()` (workflow/). The selector's sweep
is `CrossValidation` over `OpXGBoostClassifier`, `OpLogisticRegression`
and `OpLinearSVC` grids with folds as weight masks. Trees take the
fold-fused boosted-tree fit on four hand-written CUDA kernels
(ops/tree_kernels.py, csrc/tree_kernels.cu); logistic regression and the
linear SVC take the streamed route with per-lane retirement
(ops/glm_sweep.py) on large data and the lane-batched solver (ops/glm.py)
below it. Module names mirror the JAX package. Importing the package
installs the feature dsl (dsl.py): `fare + age`, `age.z_normalize()`,
`sex.pivot()`, `name.tokenize()` and the rest of the JAX package's names.
The package exports the JAX package's top-level names (the feature types,
`FeatureBuilder`, `Feature`, the stage base classes, `Dataset`, `Column`)
and `Workflow`. Event logs come in through the aggregate, conditional and
joined readers (readers/), and `Workflow.with_raw_feature_filter` drops
unreliable raw features before `transmogrify()` (filters/).
`RegressionModelSelector` sweeps linear regression (its Gram route on large
data), generalized linear regression, random forests and boosted trees on
regression labels (examples/op_boston.py); `Workflow.with_workflow_cv()`
refits the stages that feed the selector inside each fold; and
`WorkflowModel.save(path)` / `WorkflowModel.load(path, device=...)` write
and read the JAX package's model format (workflow/io.py).
`MultiClassificationModelSelector` cuts the labels with `DataCutter` and
sweeps softmax logistic regression, random forests (K + 2 histogram
channels a lane), softmax XGBoost (each round's class trees as lanes of
one growth) and naive Bayes on the multiclass error (examples/op_iris.py).

The package imports torch and numpy only, never jax or transmogrifai_tpu.
Entry points run on the GPU unless the caller asks for the CPU
(`Workflow(device="cpu")`, or `device="cpu"` on a stage); on a machine
without CUDA they raise instead of running on the CPU.

    from transmogrifai_tpu_torch.automl.preparators import SanityChecker
    from transmogrifai_tpu_torch.automl.selectors import (
        BinaryClassificationModelSelector)
    from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.features.builder import FeatureBuilder
    from transmogrifai_tpu_torch.readers import ListReader
    from transmogrifai_tpu_torch.workflow import Workflow

    label = FeatureBuilder.RealNN("survived").as_response()
    vec = transmogrify([FeatureBuilder.PickList("sex").as_predictor(),
                        FeatureBuilder.Real("age").as_predictor()])
    checked = SanityChecker().set_input(label, vec).get_output()
    pred = BinaryClassificationModelSelector.with_cross_validation(
        model_types=["OpLogisticRegression", "OpXGBoostClassifier"]
    ).set_input(label, checked).get_output()
    model = Workflow().set_reader(ListReader(rows)) \\
        .set_result_features(pred).train()
    scores = model.score()
"""

__version__ = "0.4.0"

from . import types  # noqa: E402
from .types import *  # noqa: E402,F401,F403 — feature type hierarchy
from .features.feature import Feature, FeatureHandle, FeatureHistory  # noqa
from .features.builder import FeatureBuilder, infer_feature_type  # noqa
from .features.generator import FeatureGeneratorStage  # noqa: E402
from .stages.base import (  # noqa: E402
    Estimator, LambdaTransformer, PipelineStage, TorchTransformer,
    Transformer, binary_transformer, unary_transformer,
)
from .stages.params import Param, ParamMap, param_grid  # noqa: E402
from .data.dataset import Column, Dataset, column_from_values  # noqa
from .data.vector import VectorColumnMetadata, VectorMetadata  # noqa
from .workflow import Workflow, WorkflowModel  # noqa: E402
from . import dsl  # noqa: E402,F401 — installs the rich feature syntax

__all__ = [n for n in dir() if not n.startswith("_")]
