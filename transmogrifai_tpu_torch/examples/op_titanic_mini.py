"""OpTitanicMini on the port: the fully automatic flow, features inferred
from the rows (counterpart of examples/op_titanic_mini.py).

Reference: helloworld/src/main/scala/com/salesforce/hw/OpTitanicMini.scala:
no hand-declared features; `FeatureBuilder.from_rows` infers a typed
feature a column, everything transmogrifies, the SanityChecker cleans and
the selector sweeps logistic regression. Runs on op_titanic_simple's
synthetic passengers. The workflow runs on the GPU unless the CPU is asked
for:

    python -m transmogrifai_tpu_torch.examples.op_titanic_mini --device cpu
"""
from __future__ import annotations

import argparse
import sys

from ..automl.preparators import SanityChecker
from ..automl.selectors import BinaryClassificationModelSelector
from ..automl.transmogrifier import transmogrify
from ..device import DeviceLike
from ..features.builder import FeatureBuilder
from ..readers.readers import ListReader
from ..workflow import Workflow
from .op_titanic_simple import synthetic_passengers


def build_workflow(rows, device: DeviceLike = None):
    """The reference flow (OpTitanicMini.scala): one call declares every
    feature (FeatureBuilder.fromDataFrame[RealNN](df, response =
    "survived")). Returns (workflow, prediction feature)."""
    survived, predictors = FeatureBuilder.from_rows(rows, response="survived")
    features = transmogrify(predictors)
    checked = SanityChecker(check_sample=1.0).set_input(
        survived, features).get_output()
    prediction = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, model_types=["OpLogisticRegression"],
    ).set_input(survived, checked).get_output()
    return Workflow(device=device).set_result_features(prediction), \
        prediction


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    rows = synthetic_passengers()
    wf, _ = build_workflow(rows, device=args.device)
    model = wf.set_reader(ListReader(rows)).train()
    print("Model summary:\n")
    print(model.summary_pretty())
    return model


if __name__ == "__main__":
    main()
