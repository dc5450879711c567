"""OpBoston on the port: regression model selection (counterpart of
examples/op_boston.py).

Reference: helloworld/src/main/scala/com/salesforce/hw/OpBoston.scala
(RegressionModelSelector at :86). Runs on housing-shaped synthetic records,
or on the UCI housing.data file (14 whitespace-separated columns a line,
no header) when its path is given. The workflow runs on the GPU unless the
CPU is asked for:

    python -m transmogrifai_tpu_torch.examples.op_boston [housing.data]
    python -m transmogrifai_tpu_torch.examples.op_boston --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..automl.preparators import SanityChecker
from ..automl.selectors import RegressionModelSelector
from ..automl.transmogrifier import transmogrify
from ..device import DeviceLike
from ..features.builder import FeatureBuilder
from ..readers.readers import ListReader
from ..workflow import Workflow


def synthetic_housing(n: int = 506, seed: int = 1978):
    """Housing-shaped records: the median value depends on rooms, status,
    crime and the pupil-teacher ratio (the JAX package's draws, record by
    record)."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        crim = float(rng.lognormal(-1.5, 1.8))
        rm = float(np.clip(rng.normal(6.3, 0.7), 3.5, 8.8))
        age = float(rng.uniform(2, 100))
        dis = float(rng.lognormal(1.2, 0.5))
        tax = float(rng.uniform(187, 711))
        ptratio = float(rng.uniform(12.6, 22.0))
        lstat = float(np.clip(rng.lognormal(2.4, 0.5), 1.7, 38))
        medv = float(np.clip(
            22.5 + 5.0 * (rm - 6.3) - 0.6 * lstat / 3.0
            - 1.2 * np.log1p(crim) - 0.3 * (ptratio - 18)
            + rng.normal(0, 2.5), 5, 50))
        rows.append({"crim": crim, "rm": rm, "age": age, "dis": dis,
                     "tax": tax, "ptratio": ptratio, "lstat": lstat,
                     "medv": medv})
    return rows


#: UCI housing.data column order (reference BostonHouse.scala case class)
HOUSING_COLUMNS = ["crim", "zn", "indus", "chas", "nox", "rm", "age", "dis",
                   "rad", "tax", "ptratio", "b", "lstat", "medv"]


def load_housing(path: str):
    """The classic UCI housing.data file (reference
    helloworld/src/main/resources/BostonDataset): 14 whitespace-separated
    columns per line, no header."""
    rows = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            parts = line.split()
            if len(parts) != len(HOUSING_COLUMNS):
                continue
            row = {k: float(v) for k, v in zip(HOUSING_COLUMNS, parts)}
            row["rowId"] = i
            rows.append(row)
    return rows


def housing_features(names=None):
    """(medv response, predictors) as OpBoston declares them
    (BostonFeatures.scala:37-51): chas a PickList, rad an Integral, the
    other predictors Reals."""
    medv = FeatureBuilder.RealNN("medv").extract(
        lambda r: r.get("medv")).as_response()
    names = names or ["crim", "rm", "age", "dis", "tax", "ptratio", "lstat"]
    feats = []
    for n in names:
        if n == "chas":
            feats.append(FeatureBuilder.PickList(n).extract(
                lambda r: None if r.get("chas") is None
                else str(int(r["chas"]))).as_predictor())
        elif n == "rad":
            feats.append(FeatureBuilder.Integral(n).extract(
                lambda r: None if r.get("rad") is None
                else int(r["rad"])).as_predictor())
        else:
            feats.append(FeatureBuilder.Real(n).extract(
                lambda r, _n=n: r.get(_n)).as_predictor())
    return medv, feats


def build_workflow(names=None, model_types=None, selector=None,
                   device: DeviceLike = None):
    """The reference flow (OpBoston.scala): transmogrify, sanity check and
    a RegressionModelSelector (default: a 75/25 train/validation split over
    linear regression and GBT; the full file's run takes GBT and RF, :89).
    `selector` replaces it; `device` is the Workflow's (None: the GPU).
    Returns (workflow, prediction feature)."""
    medv, feats = housing_features(names)
    vec = transmogrify(feats)
    checked = SanityChecker().set_input(medv, vec).get_output()
    if selector is None:
        selector = RegressionModelSelector.with_train_validation_split(
            train_ratio=0.75, seed=42,
            model_types=model_types or ["OpLinearRegression",
                                        "OpGBTRegressor"])
    pred = selector.set_input(medv, checked).get_output()
    return Workflow(device=device).set_result_features(pred), pred


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("data", nargs="?", help="the UCI housing.data file")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.data:
        reader = ListReader(load_housing(args.data))
        wf, _ = build_workflow(
            names=[c for c in HOUSING_COLUMNS if c != "medv"],
            model_types=["OpGBTRegressor", "OpRandomForestRegressor"],
            device=args.device)
    else:
        reader = ListReader(synthetic_housing())
        wf, _ = build_workflow(device=args.device)
    model = wf.set_reader(reader).train()
    print(model.summary_pretty())
    return model


if __name__ == "__main__":
    main()
