"""OpIris on the port: multiclass model selection (counterpart of
examples/op_iris.py).

Reference: helloworld/src/main/scala/com/salesforce/hw/OpIris.scala
(MultiClassificationModelSelector at :66). The iris measurements are drawn
from per-species Gaussians fit to the well-known summary statistics (no
data file copied), or read from the UCI iris.data file when its path is
given. The workflow runs on the GPU unless the CPU is asked for:

    python -m transmogrifai_tpu_torch.examples.op_iris [iris.data]
    python -m transmogrifai_tpu_torch.examples.op_iris --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..automl.preparators import SanityChecker
from ..automl.selectors import MultiClassificationModelSelector
from ..automl.transmogrifier import transmogrify
from ..automl.tuning.splitters import DataCutter
from ..device import DeviceLike
from ..features.builder import FeatureBuilder
from ..readers.readers import ListReader
from ..workflow import Workflow

# per-species (mean, std) of sepal_l, sepal_w, petal_l, petal_w
_SPECIES = {
    "setosa": [(5.01, 0.35), (3.43, 0.38), (1.46, 0.17), (0.25, 0.11)],
    "versicolor": [(5.94, 0.52), (2.77, 0.31), (4.26, 0.47), (1.33, 0.20)],
    "virginica": [(6.59, 0.64), (2.97, 0.32), (5.55, 0.55), (2.03, 0.27)],
}
MEASUREMENTS = ("sepalLength", "sepalWidth", "petalLength", "petalWidth")


def synthetic_iris(n_per_class: int = 50, seed: int = 7):
    """Iris-shaped records, `n_per_class` a species, shuffled (the JAX
    package's draws, record by record)."""
    rng = np.random.default_rng(seed)
    rows = []
    for label, (cls, stats) in enumerate(_SPECIES.items()):
        for _ in range(n_per_class):
            vals = [float(rng.normal(m, s)) for m, s in stats]
            rows.append({"sepalLength": vals[0], "sepalWidth": vals[1],
                         "petalLength": vals[2], "petalWidth": vals[3],
                         "irisClass": float(label), "species": cls})
    rng.shuffle(rows)
    return rows


def load_iris(path: str):
    """The UCI iris.data file (reference
    helloworld/src/main/resources/IrisDataset): 4 measurements and an
    ``Iris-<species>`` label a line; the species index-encoded in order of
    appearance, as the reference's ``irisClass.indexed()``
    (OpIris.scala:58)."""
    rows = []
    classes: dict = {}
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split(",")
            if len(parts) != 5:
                continue
            cls = parts[4]
            label = classes.setdefault(cls, len(classes))
            rows.append({"sepalLength": float(parts[0]),
                         "sepalWidth": float(parts[1]),
                         "petalLength": float(parts[2]),
                         "petalWidth": float(parts[3]),
                         "irisClass": float(label), "species": cls})
    return rows


def build_workflow(splitter=None, device: DeviceLike = None):
    """The reference flow (OpIris.scala): the four measurements
    transmogrified and sanity-checked, then a
    MultiClassificationModelSelector (3-fold CV over logistic regression
    and the random forest; `splitter` None: DataCutter's defaults).
    `device` is the Workflow's (None: the GPU). Returns (workflow,
    prediction feature)."""
    label = FeatureBuilder.RealNN("irisClass").extract(
        lambda r: r.get("irisClass")).as_response()
    feats = [FeatureBuilder.Real(n).extract(
        lambda r, _n=n: r.get(_n)).as_predictor() for n in MEASUREMENTS]
    vec = transmogrify(feats)
    checked = SanityChecker().set_input(label, vec).get_output()
    pred = MultiClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=42, splitter=splitter,
        model_types=["OpLogisticRegression", "OpRandomForestClassifier"],
    ).set_input(label, checked).get_output()
    return Workflow(device=device).set_result_features(pred), pred


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data", nargs="?", help="the UCI iris.data file")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.data:
        # the reference holds out 20% through DataCutter (OpIris.scala:64)
        reader = ListReader(load_iris(args.data))
        splitter = DataCutter(seed=42, reserve_test_fraction=0.2)
    else:
        reader, splitter = ListReader(synthetic_iris()), None
    wf, _ = build_workflow(splitter, device=args.device)
    model = wf.set_reader(reader).train()
    print(model.summary_pretty())
    return model


if __name__ == "__main__":
    main()
