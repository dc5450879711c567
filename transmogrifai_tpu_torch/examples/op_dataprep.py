"""Data-prep flows on the port: joined and conditional aggregate readers
(counterpart of examples/op_dataprep.py).

- ``JoinsAndAggregates`` (helloworld/.../dataprep/JoinsAndAggregates.scala)
  — "Email Sends" left-outer-joined with "Email Clicks", each an aggregate
  reader keyed by user with cutoff 2017-09-04, predictors windowed 1 day /
  7 days, response windowed 1 day, plus a derived CTR feature.
- ``ConditionalAggregation``
  (helloworld/.../dataprep/ConditionalAggregation.scala) — web-visit
  events conditionally aggregated around each user's first visit to the
  SaveBig landing page.

The workflows run on the GPU unless the CPU is asked for:

    python -m transmogrifai_tpu_torch.examples.op_dataprep \\
        Clicks.csv Sends.csv WebVisits.csv [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from datetime import datetime, timezone

from ..device import DeviceLike
from ..features.builder import FeatureBuilder
from ..readers.readers import (AggregateReader, ConditionalReader, CSVReader,
                               KEY_COLUMN)
from ..workflow import Workflow

DAY_MS = 24 * 3600 * 1000


def parse_ts(s: str) -> int:
    """'yyyy-MM-dd::HH:mm:ss' -> epoch millis (the example's formatter)."""
    dt = datetime.strptime(s, "%Y-%m-%d::%H:%M:%S")
    return int(dt.replace(tzinfo=timezone.utc).timestamp() * 1000)


#: CutOffTime.DDMMYYYY("04092017") — midnight 2017-09-04
CUTOFF_MS = parse_ts("2017-09-04::00:00:00")


def _sum0(a, b):
    """Sum monoid with zero 0.0 (reference SumReal with explicit zero —
    the published example table shows 0.0, not null, for keys present in
    a table with no in-window events)."""
    return (0.0 if a is None else a) + (0.0 if b is None else b)


def joins_and_aggregates(clicks_path: str, sends_path: str,
                         device: DeviceLike = None):
    """JoinsAndAggregates.scala:66-135 — returns the scored Dataset."""
    num_clicks_yday = FeatureBuilder.Real("numClicksYday").extract(
        lambda r: 1.0).aggregate(_sum0, zero=lambda: 0.0) \
        .window(DAY_MS).as_predictor()
    num_sends_last_week = FeatureBuilder.Real("numSendsLastWeek").extract(
        lambda r: 1.0).aggregate(_sum0, zero=lambda: 0.0) \
        .window(7 * DAY_MS).as_predictor()
    num_clicks_tomorrow = FeatureBuilder.Real("numClicksTomorrow").extract(
        lambda r: 1.0).aggregate(_sum0, zero=lambda: 0.0) \
        .window(DAY_MS).as_response()

    ctr = (num_clicks_yday / (num_sends_last_week + 1.0)).alias("ctr")

    clicks_reader = AggregateReader(
        CSVReader(clicks_path,
                  columns=["clickId", "userId", "emailId", "timeStamp"]),
        key_fn=lambda r: str(r["userId"]),
        cutoff_time=CUTOFF_MS,
        event_time_fn=lambda r: parse_ts(r["timeStamp"]))
    sends_reader = AggregateReader(
        CSVReader(sends_path,
                  columns=["sendId", "userId", "emailId", "timeStamp"]),
        key_fn=lambda r: str(r["userId"]),
        cutoff_time=CUTOFF_MS,
        event_time_fn=lambda r: parse_ts(r["timeStamp"]))

    reader = sends_reader.left_outer_join(
        clicks_reader,
        left_features=["numSendsLastWeek"],
        right_features=["numClicksYday", "numClicksTomorrow"])

    model = Workflow(device=device).set_reader(reader).set_result_features(
        num_clicks_yday, num_clicks_tomorrow, num_sends_last_week,
        ctr).train()
    return model.score()


def conditional_aggregation(visits_path: str, device: DeviceLike = None):
    """ConditionalAggregation.scala:61-115 — returns the scored Dataset."""
    num_visits_week_prior = FeatureBuilder.RealNN("numVisitsWeekPrior") \
        .extract(lambda r: 1.0).aggregate(_sum0, zero=lambda: 0.0) \
        .window(7 * DAY_MS).as_predictor()
    num_purchases_next_day = FeatureBuilder.RealNN("numPurchasesNextDay") \
        .extract(lambda r: 1.0 if r.get("productId") is not None else 0.0) \
        .aggregate(_sum0, zero=lambda: 0.0).window(DAY_MS).as_response()

    reader = ConditionalReader(
        CSVReader(visits_path,
                  columns=["userId", "url", "productId", "price",
                           "timestamp"]),
        key_fn=lambda r: r["userId"],
        condition_fn=lambda r: r["url"] == "http://www.amazon.com/SaveBig",
        event_time_fn=lambda r: parse_ts(r["timestamp"]),
        drop_if_no_condition=True)

    model = Workflow(device=device).set_reader(reader).set_result_features(
        num_visits_week_prior, num_purchases_next_day).train()
    return model.score()


def _print_rows(title: str, ds) -> None:
    print(f"{title}:")
    for i, k in enumerate(ds.column(KEY_COLUMN).data):
        row = {n: ds.column(n).data[i] for n in ds.column_names()
               if n != KEY_COLUMN}
        print(f"  {k}: {row}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("clicks")
    ap.add_argument("sends")
    ap.add_argument("visits")
    ap.add_argument("--device", default=None,
                    help="'cpu' or 'cuda' (default: cuda)")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    _print_rows("JoinsAndAggregates", joins_and_aggregates(
        args.clicks, args.sends, device=args.device))
    _print_rows("ConditionalAggregation", conditional_aggregation(
        args.visits, device=args.device))


if __name__ == "__main__":
    main()
