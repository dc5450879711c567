"""Command line of the port: ``python -m transmogrifai_tpu_torch <command>``
(counterpart of cli.py, the same subcommands).

- ``gen``: a ready-to-run project from a data schema (reference cli module:
  ``op gen --input data.csv --id id --response label --schema schema.avsc``).
  A SchemaSource parses an Avro schema (.avsc: field types drive feature
  types and the problem kind; union[null, T] = nullable T, logical
  date/timestamp types map to Date/DateTime) or infers types from CSV or
  Avro data. The project (features.py, app.py, params.json, test_app.py,
  README.md) imports transmogrifai_tpu_torch and runs on the GPU unless
  given ``--device cpu``.
- ``trace-report DIR`` (``--check``, ``--requests``): a traced run
  directory's report or validation (utils/tracing.py).
- ``serve MODEL_DIR``: the serving engine behind an HTTP/JSON frontend
  (serve/); on the GPU unless given ``--device cpu``.
- ``fleet``, ``plan``, ``monitor``, ``retrain-worker`` and ``trace-report
  --pod`` exit 2 naming the JAX package's module that the port has not
  ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Avro primitive -> FeatureType (reference AvroField.AvroTypes: AInt,
# ABoolean, ALong, AFloat, ADouble, AString, AEnum)
_AVRO_TYPE_MAP = {
    "boolean": "Binary",
    "int": "Integral",
    "long": "Integral",
    "float": "Real",
    "double": "Real",
    "string": "Text",
    "enum": "PickList",
}
_AVRO_LOGICAL_MAP = {
    "date": "Date",
    "timestamp-millis": "DateTime",
    "timestamp-micros": "DateTime",
    "time-millis": "Integral",
}


@dataclass
class SchemaField:
    """One typed column (reference AvroField)."""

    name: str
    feature_type: str
    avro_type: Optional[str] = None  # primitive name when schema-driven
    nullable: bool = True


@dataclass
class SchemaSource:
    """Typed column list + where it came from (reference
    SchemaSource.scala: AvroSchemaFromFile | AutomaticSchema)."""

    fields: List[SchemaField]
    origin: str  # "avro-schema" | "data-inference"
    record_name: Optional[str] = None
    rows: List[Dict[str, Any]] = field(default_factory=list)

    def field_named(self, name: str) -> Optional[SchemaField]:
        return next((f for f in self.fields if f.name == name), None)

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_avro_schema(path: str) -> "SchemaSource":
        """Parse a .avsc record schema — no data scan needed (reference
        AvroSchemaFromFile)."""
        with open(path) as f:
            doc = json.load(f)
        if doc.get("type") != "record" or "fields" not in doc:
            raise ValueError(f"{path} is not an Avro record schema")
        fields: List[SchemaField] = []
        for fd in doc["fields"]:
            parsed = _parse_avro_field(fd)
            if parsed is not None:
                fields.append(parsed)
        if not fields:
            raise ValueError(f"No usable fields in Avro schema {path}")
        return SchemaSource(fields=fields, origin="avro-schema",
                            record_name=doc.get("name"))

    @staticmethod
    def from_data(path: str, limit: int = 1000) -> "SchemaSource":
        """Infer types by scanning data rows (reference AutomaticSchema)."""
        from .features.builder import infer_feature_type

        rows = _load_rows(path, limit)
        if not rows:
            raise ValueError(f"No rows read from {path}")
        keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        fields = [
            SchemaField(name=k,
                        feature_type=infer_feature_type(
                            [r.get(k) for r in rows]).__name__)
            for k in keys
        ]
        return SchemaSource(fields=fields, origin="data-inference",
                            rows=rows)


def _parse_avro_field(fd: Dict[str, Any]) -> Optional[SchemaField]:
    """Schema.Field -> SchemaField (reference AvroField.from:166 —
    union [null, T] makes T nullable; unsupported complex types are
    skipped rather than failing the whole schema)."""
    t = fd.get("type")
    nullable = False
    if isinstance(t, list):  # union
        non_null = [x for x in t if x != "null"]
        if len(non_null) != 1:
            return None
        nullable = len(non_null) != len(t)
        t = non_null[0]
    logical = None
    if isinstance(t, dict):
        logical = t.get("logicalType")
        t = t.get("type")
    if not isinstance(t, str):
        return None
    if logical and logical in _AVRO_LOGICAL_MAP:
        ftype = _AVRO_LOGICAL_MAP[logical]
    elif t in _AVRO_TYPE_MAP:
        ftype = _AVRO_TYPE_MAP[t]
    else:
        return None  # records/maps/arrays: not feature columns
    return SchemaField(name=fd["name"], feature_type=ftype,
                       avro_type=t, nullable=nullable)


def _load_rows(path: str, limit: int = 1000) -> List[Dict[str, Any]]:
    if path.endswith(".avro"):
        from .readers.avro import read_avro_file
        out = []
        for i, r in enumerate(read_avro_file(path)):
            if i >= limit:
                break
            out.append(r)
        return out
    from .readers.readers import CSVReader
    return CSVReader(path).read()[:limit]


def detect_problem_kind(values: Sequence[Any]) -> str:
    """Data-driven kind: binary / multiclass / regression."""
    vals = [v for v in values if v is not None]
    distinct = set(vals)
    if len(distinct) <= 2:
        return "binary"
    if all(isinstance(v, (int, bool)) or
           (isinstance(v, float) and float(v).is_integer())
           for v in vals) and len(distinct) <= 30:
        return "multiclass"
    return "regression"


def detect_problem_kind_from_schema(f: SchemaField) -> Optional[str]:
    """Schema-driven kind (reference ProblemKind.from): a boolean
    response is binary, floating point is regression, enum is
    multiclass; int/long/string are ambiguous (reference prompts the
    user — here the caller passes --kind or provides data to refine)."""
    if f.avro_type == "boolean":
        return "binary"
    if f.avro_type in ("float", "double"):
        return "regression"
    if f.avro_type == "enum":
        return "multiclass"
    return None


_SELECTOR_BY_KIND = {
    "binary": "BinaryClassificationModelSelector",
    "multiclass": "MultiClassificationModelSelector",
    "regression": "RegressionModelSelector",
}

#: subcommands of the JAX package's command line that the port lacks, and
#: the package each would need
UNPORTED_COMMANDS = {
    "fleet": "transmogrifai_tpu/fleet/",
    "plan": "transmogrifai_tpu/planner/",
    "monitor": "transmogrifai_tpu/monitor/",
    "retrain-worker": "transmogrifai_tpu/retrain/",
}
UNPORTED_POD_REPORT = "transmogrifai_tpu/parallel/podtrace.py"

_FEATURES_TEMPLATE = '''"""{name} feature declarations (generated).

Edit types and extractions here; app.py imports PREDICTORS and RESPONSE.
Schema origin: {origin}.
"""
from transmogrifai_tpu_torch.features.builder import FeatureBuilder

{feature_decls}

PREDICTORS = [{predictor_names}]
RESPONSE = {response_var}
'''

_APP_TEMPLATE = '''"""{name}: generated by `python -m transmogrifai_tpu_torch gen`.

Problem kind: {kind}. The workflow wires transmogrify -> SanityChecker
-> {selector}; tune grids or stages here. It trains on the GPU; pass
`--device cpu` to run on the CPU.

    python app.py --run-type Train --model-location ./model [--device cpu]
"""
import argparse

from transmogrifai_tpu_torch.automl.preparators import SanityChecker
from transmogrifai_tpu_torch.automl.selectors import {selector}
from transmogrifai_tpu_torch.automl.transmogrifier import transmogrify
from transmogrifai_tpu_torch.readers.readers import CSVReader
from transmogrifai_tpu_torch.workflow import (OpApp, OpWorkflowRunner,
                                              Workflow)

from features import PREDICTORS, RESPONSE

DATA = {data_path!r}{data_note}


def build_workflow(device=None) -> Workflow:
    vectorized = transmogrify(PREDICTORS)
    checked = SanityChecker().set_input(RESPONSE, vectorized) \\
        .get_output()
    prediction = {selector}.with_cross_validation(
        num_folds=3, seed=42,
    ).set_input(RESPONSE, checked).get_output()
    return Workflow(device=device).set_result_features(prediction)


class {app_class}(OpApp):
    def __init__(self, device=None):
        self.device = device

    def runner(self) -> OpWorkflowRunner:
        return OpWorkflowRunner(build_workflow(self.device),
                                train_reader=CSVReader(DATA),
                                score_reader=CSVReader(DATA))


if __name__ == "__main__":
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default=None,
                     help="cpu, or a CUDA device (default: the GPU)")
    known, rest = pre.parse_known_args()
    {app_class}(device=known.device).main(rest)
'''

_TEST_TEMPLATE = '''"""Smoke test of the generated {name} project (on the CPU)."""
import os
import subprocess
import sys

import pytest


def test_train_runs(tmp_path):
    import app
    proj = os.path.dirname(os.path.abspath(__file__))
    # resolve DATA as the subprocess will (cwd = the project directory)
    data = app.DATA if os.path.isabs(app.DATA) \\
        else os.path.join(proj, app.DATA)
    if not os.path.exists(data):
        pytest.skip(f"edit DATA in app.py first (placeholder: "
                    f"{{app.DATA!r}} does not exist)")
    proc = subprocess.run(
        [sys.executable, "app.py", "--run-type", "Train", "--device", "cpu",
         "--model-location", str(tmp_path / "model")],
        cwd=proj, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "model").is_dir()
'''


def _pyname(col: str) -> str:
    return col.replace("-", "_").replace(" ", "_")


def _feature_decl(col: str, type_name: str, response: str) -> str:
    var = _pyname(col)
    role = "as_response" if col == response else "as_predictor"
    return (f'{var} = FeatureBuilder.{type_name}({col!r}).extract(\n'
            f'    lambda r: r.get({col!r})).{role}()')


def generate_project(input_path: Optional[str] = None,
                     response: str = "", output: str = ".",
                     id_col: Optional[str] = None,
                     name: Optional[str] = None,
                     schema_path: Optional[str] = None,
                     kind: Optional[str] = None) -> Dict[str, str]:
    """Build the project files; returns {filename: content}.

    Sources, in the reference's order (SchemaSource.scala): an explicit
    Avro schema wins (types and problem kind from the schema, the data a
    refinement for ambiguous int/long responses); otherwise the data file
    is scanned and types inferred."""
    if schema_path:
        src = SchemaSource.from_avro_schema(schema_path)
        if input_path:
            src.rows = _load_rows(input_path)
    elif input_path:
        src = SchemaSource.from_data(input_path)
    else:
        raise ValueError("need --input data and/or --schema avsc")

    rf = src.field_named(response)
    if rf is None:
        raise ValueError(f"Response column {response!r} not in schema "
                         f"(columns: {[f.name for f in src.fields]})")

    if src.rows and all(r.get(response) is None for r in src.rows):
        raise ValueError(
            f"Response column {response!r} has no values in the data file "
            f"(its columns: {sorted(src.rows[0])})")
    if kind is None:
        kind = detect_problem_kind_from_schema(rf) \
            if src.origin == "avro-schema" else None
        if kind is None and src.rows:
            kind = detect_problem_kind([r.get(response) for r in src.rows])
        if kind is None:
            raise ValueError(
                f"Problem kind is ambiguous from the schema alone for "
                f"{response!r} ({rf.avro_type}); pass --kind "
                f"binary|multiclass|regression or --input data")
    if kind not in _SELECTOR_BY_KIND:
        raise ValueError(f"Unknown problem kind {kind!r}")

    feats: List[Tuple[str, str]] = [
        (f.name, "RealNN" if f.name == response else f.feature_type)
        for f in src.fields if f.name != id_col]

    base = schema_path or input_path
    name = name or (src.record_name
                    or os.path.splitext(os.path.basename(base))[0].title())
    app_class = "".join(c for c in name.title() if c.isalnum()) or "App"

    decls = "\n".join(_feature_decl(c, t, response) for c, t in feats)
    predictors = ", ".join(_pyname(c) for c, _ in feats if c != response)
    features_py = _FEATURES_TEMPLATE.format(
        name=name, origin=src.origin, feature_decls=decls,
        predictor_names=predictors, response_var=_pyname(response))
    app_py = _APP_TEMPLATE.format(
        name=name, kind=kind, selector=_SELECTOR_BY_KIND[kind],
        data_path=os.path.abspath(input_path) if input_path else "data.csv",
        data_note=("" if input_path
                   else "  # PLACEHOLDER: point at your dataset"),
        app_class=app_class)
    test_py = _TEST_TEMPLATE.format(name=name)

    params = {"stage_params": {}, "model_location": "./model",
              "write_location": "./scores", "metrics_location": "./metrics"}
    data_hint = ("" if input_path else
                 "\n> **Before running:** `DATA` in `app.py` is a "
                 "placeholder (`data.csv`): point it at your dataset.\n")
    readme = (f"# {name}\n\nGenerated by transmogrifai_tpu_torch "
              f"(problem kind: **{kind}**, schema: {src.origin}, "
              f"{len(feats)} features).\n{data_hint}\n"
              f"- `features.py`: typed feature declarations\n"
              f"- `app.py`: workflow + Train/Score/Evaluate entry\n"
              f"- `params.json`: run configuration (OpParams)\n"
              f"- `test_app.py`: smoke test (`pytest test_app.py`)\n\n"
              f"The app runs on the GPU; add `--device cpu` to run on the "
              f"CPU.\n\n"
              f"```bash\npython app.py --run-type Train "
              f"--param-location params.json\n"
              f"python app.py --run-type Score --param-location params.json\n"
              f"```\n")

    os.makedirs(output, exist_ok=True)
    files = {"features.py": features_py,
             "app.py": app_py,
             "params.json": json.dumps(params, indent=2),
             "test_app.py": test_py,
             "README.md": readme}
    for fname, content in files.items():
        with open(os.path.join(output, fname), "w") as f:
            f.write(content)
    return files


def _unported(what: str, package: str) -> int:
    print(f"transmogrifai_tpu_torch: {what} is not ported "
          f"({package} of the JAX package)", file=sys.stderr)
    return 2


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="transmogrifai_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    gen = sub.add_parser("gen", help="generate a project from a dataset")
    gen.add_argument("--input", default=None, help="CSV or Avro data file")
    gen.add_argument("--schema", default=None,
                     help="Avro record schema (.avsc)")
    gen.add_argument("--response", required=True, help="label column")
    gen.add_argument("--id", default=None, help="id column to exclude")
    gen.add_argument("--kind", default=None,
                     choices=sorted(_SELECTOR_BY_KIND),
                     help="problem kind override")
    gen.add_argument("--output", default=".", help="project directory")
    gen.add_argument("--name", default=None, help="project name")
    tr = sub.add_parser(
        "trace-report",
        help="summarize a traced run dir (top spans by self time, cold "
             "starts per program, kernel roofline, event-log counts); "
             "--check validates the Chrome-trace and event-log schemas")
    tr.add_argument("dir", help="metrics dir written by a traced run "
                                "(metrics_location)")
    tr.add_argument("--check", action="store_true",
                    help="schema validation only; exit 1 on any problem")
    tr.add_argument("--requests", action="store_true",
                    help="request-tracing report: the slowest tail-kept "
                         "traces with their segment breakdown; exit 1 when "
                         "a request's segments do not cover its e2e wall "
                         "within tolerance")
    tr.add_argument("--pod", action="store_true",
                    help=f"pod flight-recorder report (not ported: "
                         f"{UNPORTED_POD_REPORT})")
    tr.add_argument("--top", type=int, default=15,
                    help="rows in the self-time table (default 15)")
    sv = sub.add_parser(
        "serve",
        help="serving engine over a saved model: prewarmed power-of-two "
             "batch buckets, async micro-batching, HTTP/JSON frontend")
    sv.add_argument("model_dir", help="saved WorkflowModel directory")
    sv.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the GPU)")
    sv.add_argument("--host", default="127.0.0.1")
    sv.add_argument("--port", type=int, default=8765,
                    help="HTTP port (0 = ephemeral; default 8765)")
    sv.add_argument("--max-batch", type=int, default=64,
                    help="top bucket of the power-of-two ladder")
    sv.add_argument("--buckets", default=None,
                    help="explicit comma-separated bucket ladder "
                         "(overrides --max-batch)")
    sv.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="micro-batch fill window")
    sv.add_argument("--max-queue", type=int, default=1024,
                    help="admission queue bound (full -> 503 shed)")
    sv.add_argument("--single-record", choices=["bucket", "local"],
                    default="bucket",
                    help="batch-of-one route: the bucket-1 batch on the "
                         "device or the per-record replay on the CPU")
    sv.add_argument("--example", default=None,
                    help="JSON file with one sample record for prewarm "
                         "batches (default: synthesized from feature "
                         "types)")
    sv.add_argument("--prewarm-only", action="store_true",
                    help="prewarm every bucket, write the serve.json "
                         "manifest beside the model and exit")
    sv.add_argument("--strict-manifest", action="store_true",
                    help="refuse to start (rc 2) when the serve.json "
                         "manifest's model hash / monitor stamp / bucket "
                         "ladder disagrees with the artifact; default is a "
                         "startup warning")
    sv.add_argument("--metrics-location", default=None,
                    help="dir for events.jsonl + trace artifacts "
                         "(enables span collection + the cold-start "
                         "watch; validate with trace-report --check)")
    sv.add_argument("--monitor", choices=["auto", "on", "off"],
                    default="auto",
                    help="drift monitoring against a monitor.json profile "
                         "(not ported: auto serves unmonitored, on exits "
                         "2)")
    sv.add_argument("--monitor-window-rows", type=int, default=4096,
                    help="tumbling drift window size in rows (no effect: "
                         "monitoring is not ported)")
    sv.add_argument("--monitor-window-seconds", type=float, default=60.0,
                    help="drift window time bound (no effect)")
    sv.add_argument("--monitor-health-gate", action="store_true",
                    help="drift health gate (no effect)")
    sv.add_argument("--replica-id", default=None,
                    help="identity echoed in the X-Tmog-Trace reply "
                         "header and stamped on kept request traces "
                         "(default pid<N>)")
    sv.add_argument("--request-trace", choices=["on", "off"],
                    default="on",
                    help="per-request tracing: segment histograms, "
                         "tail-kept traces under GET /requests, "
                         "request_trace events (TMOG_REQTRACE=0 also "
                         "disables)")
    sv.add_argument("--trace-sample", type=float, default=None,
                    help="probabilistic keep rate for unremarkable "
                         "requests (errors/sheds/retries/slow are "
                         "always kept; default TMOG_TRACE_SAMPLE or "
                         "0.01)")
    for cmd, package in UNPORTED_COMMANDS.items():
        up = sub.add_parser(cmd, help=f"not ported ({package})")
        up.add_argument("args", nargs=argparse.REMAINDER,
                        help="the JAX package's arguments")
    a = p.parse_args(argv)
    if a.command == "gen":
        files = generate_project(a.input, a.response, a.output,
                                 id_col=a.id, name=a.name,
                                 schema_path=a.schema, kind=a.kind)
        print(f"Generated {', '.join(files)} in {a.output}")
        return 0
    if a.command == "trace-report":
        # exit codes: 0 clean, 1 problems, 2 usage error (not a traced
        # run dir, or a report the port has not)
        if a.pod:
            return _unported("trace-report --pod", UNPORTED_POD_REPORT)
        if a.requests:
            from .utils.tracing import requests_report_rc
            text, rc = requests_report_rc(a.dir, top=a.top)
            print(text)
            return rc
        from .utils.tracing import trace_report_rc
        text, rc = trace_report_rc(a.dir, check=a.check, top=a.top)
        print(text)
        return rc
    if a.command == "serve":
        from .serve.frontend import run_serve
        return run_serve(a)
    if a.command in UNPORTED_COMMANDS:
        return _unported(a.command, UNPORTED_COMMANDS[a.command])
    return 1


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
