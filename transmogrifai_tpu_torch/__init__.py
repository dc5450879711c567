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

from . import dsl  # noqa: E402,F401 — installs the rich feature syntax
