"""OpTitanicSimple on the port: the canonical binary-classification flow
(counterpart of examples/op_titanic_simple.py).

Reference: helloworld/src/main/scala/com/salesforce/hw/OpTitanicSimple.scala
(features :94-105, transmogrify/sanityCheck/selector :110-135, README
summary table). Runs on bundled synthetic Titanic-shaped records, or on a
CSV with the real Kaggle columns. The workflow runs on the GPU unless the
CPU is asked for:

    python -m transmogrifai_tpu_torch.examples.op_titanic_simple [titanic.csv]
    python -m transmogrifai_tpu_torch.examples.op_titanic_simple --device cpu
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from ..automl.preparators import SanityChecker
from ..automl.selectors import BinaryClassificationModelSelector
from ..automl.transmogrifier import transmogrify
from ..automl.tuning.splitters import DataSplitter
from ..device import DeviceLike
from ..features.builder import FeatureBuilder
from ..readers.readers import CSVReader, ListReader
from ..types import PickList
from ..workflow import Workflow


def synthetic_passengers(n: int = 891, seed: int = 1912):
    """Titanic-shaped records: survival depends on sex, class, age, fare."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        sex = "female" if rng.uniform() < 0.35 else "male"
        pclass = int(rng.choice([1, 2, 3], p=[0.24, 0.21, 0.55]))
        age = float(np.clip(rng.normal(29, 14), 0.4, 80)) \
            if rng.uniform() > 0.2 else None
        sibsp = int(rng.poisson(0.5))
        parch = int(rng.poisson(0.4))
        fare = float(np.clip(rng.lognormal(
            3.6 - 0.5 * (pclass - 1), 0.6), 4, 512))
        embarked = str(rng.choice(["S", "C", "Q"], p=[0.72, 0.19, 0.09]))
        logit = (2.5 * (sex == "female") - 0.9 * (pclass - 2)
                 - 0.02 * ((age or 29) - 29) + 0.004 * fare
                 - 0.3 * (sibsp + parch > 3) - 0.7)
        survived = float(rng.uniform() < 1 / (1 + np.exp(-logit)))
        rows.append({
            "survived": survived, "pClass": str(pclass), "sex": sex,
            "age": age, "sibSp": sibsp, "parCh": parch,
            "fare": fare, "embarked": embarked,
        })
    return rows


#: the reference data file carries no header row (csvCase reads the schema
#: from the Passenger case class, OpTitanicSimple.scala:59-73)
PASSENGER_COLUMNS = ["id", "survived", "pClass", "name", "sex", "age",
                     "sibSp", "parCh", "ticket", "fare", "cabin", "embarked"]


def build_workflow(selector=None, device: DeviceLike = None):
    """The reference flow end to end (OpTitanicSimple.scala:94-137): raw
    features, the hand-engineered derived features (familySize,
    estimatedCostOfTickets, pivotedSex, normedAge, ageGroup), transmogrify,
    sanity check, and a model selector (default: an LR-only
    train/validation-split selector; `reference_selector()` gives the
    README sweep shape). `device` is the Workflow's: None runs on the GPU.
    Returns (workflow, prediction feature)."""
    survived = FeatureBuilder.RealNN("survived").extract(
        lambda r: r.get("survived")).as_response()
    p_class = FeatureBuilder.PickList("pClass").extract(
        lambda r: None if r.get("pClass") is None
        else str(r.get("pClass"))).as_predictor()
    name = FeatureBuilder.Text("name").extract(
        lambda r: r.get("name")).as_predictor()
    sex = FeatureBuilder.PickList("sex").extract(
        lambda r: r.get("sex")).as_predictor()
    age = FeatureBuilder.Real("age").extract(
        lambda r: r.get("age")).as_predictor()
    sib_sp = FeatureBuilder.Integral("sibSp").extract(
        lambda r: r.get("sibSp")).as_predictor()
    par_ch = FeatureBuilder.Integral("parCh").extract(
        lambda r: r.get("parCh")).as_predictor()
    ticket = FeatureBuilder.PickList("ticket").extract(
        lambda r: None if r.get("ticket") is None
        else str(r.get("ticket"))).as_predictor()
    fare = FeatureBuilder.Real("fare").extract(
        lambda r: r.get("fare")).as_predictor()
    cabin = FeatureBuilder.PickList("cabin").extract(
        lambda r: None if r.get("cabin") is None
        else str(r.get("cabin"))).as_predictor()
    embarked = FeatureBuilder.PickList("embarked").extract(
        lambda r: r.get("embarked")).as_predictor()

    # hand-engineered features (reference :118-122)
    family_size = (sib_sp + par_ch) + 1.0
    estimated_cost = family_size * fare
    pivoted_sex = sex.pivot()
    normed_age = age.fill_missing_with_mean().z_normalize()
    age_group = age.map(
        lambda v: None if v.value is None
        else ("adult" if v.value > 18 else "child"),
        output_type=PickList, operation_name="ageGroup")

    features = transmogrify(
        [p_class, name, age, sib_sp, par_ch, ticket, cabin, embarked,
         family_size, estimated_cost, pivoted_sex, age_group, normed_age])
    checked = SanityChecker(check_sample=1.0, remove_bad_features=True) \
        .set_input(survived, features).get_output()
    if selector is None:
        selector = BinaryClassificationModelSelector \
            .with_train_validation_split(
                seed=42, model_types=["OpLogisticRegression"])
    prediction = selector.set_input(survived, checked).get_output()
    return Workflow(device=device).set_result_features(prediction), \
        prediction


def reference_selector(seed: int = 42, models_and_parameters=None):
    """The README sweep shape (reference README.md:62-64): LR + RF grids,
    3-fold CV on AuPR, with a reserved 10% holdout. `models_and_parameters`
    replaces the default LR and RF grids (a shorter sweep of the same
    shape)."""
    kw = ({"models_and_parameters": models_and_parameters}
          if models_and_parameters is not None else
          {"model_types": ["OpLogisticRegression",
                           "OpRandomForestClassifier"]})
    return BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, seed=seed,
        splitter=DataSplitter(seed=seed, reserve_test_fraction=0.1), **kw)


#: Kaggle train.csv header names -> the reference case-class field names
_KAGGLE_RENAME = {"PassengerId": "id", "Survived": "survived",
                  "Pclass": "pClass", "Name": "name", "Sex": "sex",
                  "Age": "age", "SibSp": "sibSp", "Parch": "parCh",
                  "Ticket": "ticket", "Fare": "fare", "Cabin": "cabin",
                  "Embarked": "embarked"}


def passenger_reader(path: str):
    """Reader for either Titanic file layout: the reference's headerless
    TitanicPassengersTrainData.csv, or a Kaggle train.csv with a header row
    (sniffed from the first line)."""
    with open(path) as fh:
        first = fh.readline()
    if "Survived" in first or "survived" in first:
        rows = [{_KAGGLE_RENAME.get(k, k): v for k, v in r.items()}
                for r in CSVReader(path).read()]
        return ListReader(rows)
    return CSVReader(path, columns=PASSENGER_COLUMNS)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("csv", nargs="?", help="a Titanic CSV (the reference's "
                    "headerless file or Kaggle's train.csv)")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.csv:
        # real data: the full README sweep shape
        reader = passenger_reader(args.csv)
        wf, prediction = build_workflow(reference_selector(),
                                        device=args.device)
    else:
        reader = ListReader(synthetic_passengers())
        wf, prediction = build_workflow(device=args.device)
    model = wf.set_reader(reader).train()
    print("Model summary:\n")
    print(model.summary_pretty())
    scores = model.score()
    print(f"\nScored {scores.n_rows} rows; "
          f"prediction column: {prediction.name[:60]}...")
    return model


if __name__ == "__main__":
    main()
