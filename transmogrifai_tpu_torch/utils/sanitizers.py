"""Numeric + purity sanitizers for the feature pipeline (counterpart of
utils/sanitizers.py).

* `debug_nans()` / `debug_infs()` — contexts in which the layer runner
  (workflow/fitting.py) checks every tensor column a stage outputs with
  `torch.isfinite` and raises `FloatingPointError` naming the stage. The
  JAX package flips jax's trap-on-NaN/Inf modes instead; PyTorch has no
  such mode, so the check is on the stages' outputs. A NaN in a float,
  integer or boolean column encodes a missing value, so there a NaN counts
  only in a row where every input of the stage was finite; in a vector
  column (the feature matrix, a prediction) every NaN counts.
* `check_finite(ds)` — one pass over a Dataset's numeric and vector
  columns reporting NaN/Inf counts per column.
* `assert_stage_pure(stage, ds)` — fits/transforms twice and verifies the
  input columns were not mutated and the repeated transforms are
  bit-identical.

All opt-in; nothing here runs unless asked.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from ..data.dataset import Column, Dataset
from ..types import ColumnKind

_NUMERIC = (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL)

# the checks the layer runner makes on each stage's output
_checks = {"nan": False, "inf": False}


@contextlib.contextmanager
def _checking(kind: str, enable: bool) -> Iterator[None]:
    prev = _checks[kind]
    _checks[kind] = bool(enable)
    try:
        yield
    finally:
        _checks[kind] = prev


def debug_nans(enable: bool = True):
    """Raise on a NaN that any stage of a fit or score in this block
    produces."""
    return _checking("nan", enable)


def debug_infs(enable: bool = True):
    """Raise on an Inf that any stage of a fit or score in this block
    produces."""
    return _checking("inf", enable)


def checking() -> bool:
    """True inside debug_nans() or debug_infs()."""
    return _checks["nan"] or _checks["inf"]


def check_stage_output(stage, out: Column,
                       inputs: Sequence[Column] = ()) -> None:
    """Raise FloatingPointError naming `stage` when its output column `out`
    holds a NaN (under debug_nans) or an Inf (under debug_infs) that it
    produced. `inputs` are the stage's input columns: a NaN row of a
    numeric output is its own only where every input is a finite number."""
    if not checking() or (out.kind not in _NUMERIC
                          and out.kind != ColumnKind.VECTOR):
        return
    t = torch.as_tensor(np.asarray(out.data, np.float64))
    if t.ndim == 1:
        t = t[:, None]
    finite = torch.isfinite(t)
    if bool(finite.all()):
        return
    found = []
    if _checks["inf"]:
        n_inf = int(torch.isinf(t).sum())
        if n_inf:
            found.append(f"{n_inf} Inf")
    if _checks["nan"]:
        nan_rows = torch.isnan(t).any(dim=1)
        if out.kind in _NUMERIC:
            if all(c.kind in _NUMERIC or c.kind == ColumnKind.VECTOR
                   for c in inputs):
                for c in inputs:
                    ci = torch.as_tensor(np.asarray(c.data, np.float64))
                    if ci.ndim == 1:
                        ci = ci[:, None]
                    nan_rows &= torch.isfinite(ci).all(dim=1)
            else:   # a host input (text, map): its missing rows unknown
                nan_rows = torch.zeros_like(nan_rows)
        n_nan = int(nan_rows.sum())
        if n_nan:
            found.append(f"{n_nan} NaN row(s)")
    if found:
        raise FloatingPointError(
            f"{stage.stage_name} ({stage.uid}) produced "
            f"{' and '.join(found)} in {stage.output_name()}")


def check_finite(ds: Dataset, columns: Optional[list] = None
                 ) -> Dict[str, Dict[str, int]]:
    """Per-column NaN/Inf counts over numeric and vector columns.

    NaN in a FLOAT/INT/BOOL column is the encoding of missing and is NOT
    reported; NaN or Inf inside a VECTOR column — the post-vectorizer
    matrix — is always a defect and is."""
    report: Dict[str, Dict[str, int]] = {}
    names = columns if columns is not None else ds.column_names()
    for name in names:
        col = ds.column(name)
        if col.kind == ColumnKind.VECTOR:
            data = np.asarray(col.data)
            nan = int(np.isnan(data).sum())
            inf = int(np.isinf(data).sum())
            if nan or inf:
                report[name] = {"nan": nan, "inf": inf}
        elif col.kind in _NUMERIC:
            data = np.asarray(col.data, np.float64)
            inf = int(np.isinf(data).sum())
            if inf:
                report[name] = {"nan": 0, "inf": inf}
    return report


def _snapshot(col: Column) -> Any:
    data = col.data
    if isinstance(data, np.ndarray) and data.dtype != object:
        return data.copy()
    return [v.copy() if isinstance(v, (dict, list, set, np.ndarray)) else v
            for v in data]


def _rows_equal(a: Any, b: Any) -> bool:
    """Structural row equality that treats NaN == NaN and handles
    ndarray/dict/list rows."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (np.isnan(a) and np.isnan(b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        try:
            return np.array_equal(np.asarray(a), np.asarray(b),
                                  equal_nan=True)
        except TypeError:  # non-numeric arrays: elementwise
            return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return set(a) == set(b) and all(_rows_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_rows_equal(x, y)
                                        for x, y in zip(a, b))
    return a == b


def _unchanged(before: Any, col: Column) -> bool:
    data = col.data
    if isinstance(before, np.ndarray):
        return np.array_equal(before, np.asarray(data), equal_nan=True)
    return all(_rows_equal(a, b) for a, b in zip(before, data))


def _columns_equal(a: Column, b: Column) -> bool:
    da, db = a.data, b.data
    if isinstance(da, np.ndarray) and da.dtype != object:
        return np.array_equal(da, np.asarray(db), equal_nan=True)
    return len(da) == len(db) and all(_rows_equal(x, y)
                                      for x, y in zip(da, db))


def assert_stage_pure(stage, ds: Dataset) -> None:
    """Purity laws for a stage against a dataset:

    1. transform/fit must not mutate its input columns;
    2. transforming twice must be bit-identical.

    Raises AssertionError with the offending column/stage names."""
    from ..stages.base import Estimator

    in_names = stage.input_names()
    before = {n: _snapshot(ds.column(n)) for n in in_names}
    model = stage.fit(ds) if isinstance(stage, Estimator) else stage
    out1 = model.transform(ds).column(model.output_name())
    for n in in_names:
        assert _unchanged(before[n], ds.column(n)), \
            f"{stage.stage_name} mutated its input column '{n}'"
    out2 = model.transform(ds).column(model.output_name())
    assert _columns_equal(out1, out2), \
        f"{stage.stage_name}: repeated transform is not deterministic"
