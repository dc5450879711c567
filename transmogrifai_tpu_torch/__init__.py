"""PyTorch and CUDA port of transmogrifai_tpu, for one NVIDIA H100.

The port so far holds the binary model selector's sweep: `CrossValidation`
over `OpXGBoostClassifier`, `OpLogisticRegression` and `OpLinearSVC` grids
with folds as weight masks. Trees take the fold-fused boosted-tree fit on
four hand-written CUDA kernels (ops/tree_kernels.py, csrc/tree_kernels.cu);
logistic regression and the linear SVC take the streamed route with
per-lane retirement (ops/glm_sweep.py) on large data and the lane-batched
solver (ops/glm.py) below it. The in-sweep rank metrics, the refit of the
winner and its scoring come with them. Module names mirror the JAX package.

The package imports torch and numpy only, never jax or transmogrifai_tpu.
Entry points run on the GPU unless the caller passes device="cpu"; on a
machine without CUDA they raise instead of running on the CPU.

    from transmogrifai_tpu_torch.automl.tuning.validators import CrossValidation
    from transmogrifai_tpu_torch.evaluators.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.glm import OpLogisticRegression
    from transmogrifai_tpu_torch.models.trees import OpXGBoostClassifier

    cv = CrossValidation(Evaluators.BinaryClassification.au_pr(), num_folds=5)
    best = cv.validate([(OpLogisticRegression(), lr_grids),
                        (OpXGBoostClassifier(), xgb_grids)], X, y)
    model = best.estimator.fit_arrays(X, y)
    pred, raw, prob = model.predict_arrays(X)
"""
