"""Columnar host-side dataset.

Replaces the reference's Spark DataFrame as the carrier of feature columns
(reference readers generate a schema'd DataFrame: readers/.../DataReader.scala:173).

TPU-first layout: numeric columns are dense numpy float64 with NaN-as-missing
so they lower straight to f32 device arrays; string/list/map columns are
host-only object arrays consumed by (two-phase) vectorizers which emit dense
VECTOR columns; VECTOR columns are 2-D float32 blocks with a VectorMetadata
sidecar — those blocks are what gets `device_put` onto the chip, sharded on
the batch mesh axis.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Type

import numpy as np

from ..types import ColumnKind, FeatureType
from .vector import VectorMetadata


@dataclass
class Column:
    """One named column: kind + backing array (+ vector metadata if dense)."""

    kind: str
    data: Any  # np.ndarray (1-D object/float64, or 2-D float32 for VECTOR)
    metadata: Optional[VectorMetadata] = None

    def __len__(self) -> int:
        return len(self.data)

    @property
    def width(self) -> int:
        if self.kind == ColumnKind.VECTOR:
            return self.data.shape[1]
        return 1


def column_from_values(type_cls: Type[FeatureType], values: Iterable[Any],
                       coerced: bool = False) -> Column:
    """Build a Column from raw per-row python values, coercing through the
    feature type (the columnar analogue of FeatureTypeSparkConverter).
    `coerced`: the values are stored values of `type_cls` already (what a
    raw feature's extract returns), which coerce to themselves."""
    kind = type_cls.column_kind
    coerce = type_cls.coercer()
    vals = list(values) if coerced else [
        v.value if isinstance(v, FeatureType) else coerce(v)
        for v in values]
    if kind in (ColumnKind.FLOAT, ColumnKind.INT, ColumnKind.BOOL):
        arr = np.array(
            [np.nan if v is None else (1.0 if v is True else (0.0 if v is False else float(v)))
             for v in vals], dtype=np.float64)
        return Column(kind=kind, data=arr)
    if kind == ColumnKind.VECTOR:
        widths = {len(v) for v in vals}
        if len(widths) > 1:
            raise ValueError(f"Ragged vector column: widths {sorted(widths)}")
        mat = np.stack([np.asarray(v, dtype=np.float32) for v in vals]) if vals else \
            np.zeros((0, 0), dtype=np.float32)
        return Column(kind=kind, data=mat)
    # host-only object columns (string / lists / sets / maps / geo)
    arr = np.empty(len(vals), dtype=object)
    for i, v in enumerate(vals):
        arr[i] = v
    return Column(kind=kind, data=arr)


class Dataset:
    """Ordered dict of named columns with uniform row count."""

    def __init__(self, columns: Optional[Dict[str, Column]] = None,
                 n_rows: Optional[int] = None):
        self._columns: Dict[str, Column] = dict(columns or {})
        lengths = {len(c) for c in self._columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"Column length mismatch: {lengths}")
        self._n_rows = n_rows if n_rows is not None else (lengths.pop() if lengths else 0)

    # -- construction ------------------------------------------------------
    @staticmethod
    def from_features(pairs: Sequence[Tuple[str, Type[FeatureType], Iterable[Any]]]
                      ) -> "Dataset":
        cols = {name: column_from_values(tcls, vals) for name, tcls, vals in pairs}
        return Dataset(cols)

    @staticmethod
    def from_dicts(rows: Sequence[Dict[str, Any]],
                   schema: Dict[str, Type[FeatureType]]) -> "Dataset":
        cols = {}
        for name, tcls in schema.items():
            cols[name] = column_from_values(tcls, [r.get(name) for r in rows])
        return Dataset(cols)

    # -- access ------------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self._n_rows

    def __len__(self) -> int:
        return self._n_rows

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    def column(self, name: str) -> Column:
        return self._columns[name]

    def __getitem__(self, name: str) -> Column:
        return self._columns[name]

    def data(self, name: str):
        return self._columns[name].data

    def with_column(self, name: str, col: Column) -> "Dataset":
        if self._columns and len(col) != self._n_rows:
            raise ValueError(
                f"Column '{name}' has {len(col)} rows, dataset has {self._n_rows}")
        cols = dict(self._columns)
        cols[name] = col
        return Dataset(cols, n_rows=len(col) if not self._columns else self._n_rows)

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({n: self._columns[n] for n in names}, n_rows=self._n_rows)

    def drop(self, names: Sequence[str]) -> "Dataset":
        drop = set(names)
        return Dataset({n: c for n, c in self._columns.items() if n not in drop},
                       n_rows=self._n_rows)

    def take(self, idx: np.ndarray) -> "Dataset":
        """Row subset/gather (used by splitters for the test holdout)."""
        cols = {}
        for n, c in self._columns.items():
            cols[n] = Column(kind=c.kind, data=c.data[idx], metadata=c.metadata)
        return Dataset(cols, n_rows=int(len(idx)))

    def head(self, k: int = 5) -> List[Dict[str, Any]]:
        out = []
        for i in range(min(k, self._n_rows)):
            row = {}
            for n, c in self._columns.items():
                v = c.data[i]
                row[n] = v.tolist() if isinstance(v, np.ndarray) else v
            out.append(row)
        return out

    def __repr__(self) -> str:
        cols = ", ".join(f"{n}:{c.kind}" for n, c in self._columns.items())
        return f"Dataset(rows={self._n_rows}, columns=[{cols}])"
