"""Data readers: records in, the raw-feature dataset out (counterpart of
readers/readers.py).

Reference: readers/ module — Reader.scala:96, DataReader.scala:57-252,
DataReaders factory. Ingestion is a host-side columnar pipeline: records
-> extract per raw feature -> typed Column arrays, which the workflow's
stages read. This slice ports the base `Reader`, `ListReader` (in-memory
records) and `CSVReader` (the python csv module); the aggregate, joined,
conditional, Avro, Parquet and streaming readers are not ported yet.
"""
from __future__ import annotations

import csv as _csv
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.dataset import Column, Dataset, column_from_values
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..types import ColumnKind

Record = Any  # dict-like or object; feature extract fns know how to read it

KEY_COLUMN = "key"


class Reader:
    """Base reader: produce records, then materialize the raw-feature dataset
    (reference Reader.generateDataFrame, DataReader.scala:173)."""

    def __init__(self, key_fn: Optional[Callable[[Record], str]] = None):
        self.key_fn = key_fn

    def read(self) -> List[Record]:
        raise NotImplementedError

    def _generator_of(self, f: Feature) -> FeatureGeneratorStage:
        st = f.origin_stage
        if not isinstance(st, FeatureGeneratorStage):
            raise ValueError(f"Feature '{f.name}' is not a raw feature")
        return st

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        records = self.read()
        gens = [self._generator_of(f) for f in raw_features]
        cols = {}
        for f, g in zip(raw_features, gens):
            vals = [g.extract(r) for r in records]
            cols[f.name] = column_from_values(f.feature_type, vals)
        ds = Dataset(cols)
        if self.key_fn is not None:
            keys = np.empty(len(records), dtype=object)
            for i, r in enumerate(records):
                keys[i] = str(self.key_fn(r))
            ds = ds.with_column(KEY_COLUMN,
                                Column(kind=ColumnKind.STRING, data=keys))
        return ds


class ListReader(Reader):
    """Reader over in-memory records (dicts or objects)."""

    def __init__(self, records: Sequence[Record],
                 key_fn: Optional[Callable[[Record], str]] = None):
        super().__init__(key_fn)
        self._records = list(records)

    def read(self) -> List[Record]:
        return self._records


class CSVReader(Reader):
    """CSV reader with light type coercion (reference CSVReaders.scala /
    CSVAutoReaders.scala — schema'd and auto-inferring variants)."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Record], str]] = None,
                 schema: Optional[Dict[str, Callable[[str], Any]]] = None,
                 null_values: Sequence[str] = ("", "NA", "null", "NULL",
                                               "None"),
                 columns: Optional[Sequence[str]] = None):
        """``columns`` names the fields of a HEADERLESS file (reference
        ``DataReaders.Simple.csvCase`` reads schema from the case class, so
        its files carry no header row)."""
        super().__init__(key_fn)
        self.path = path
        self.schema = schema
        self.null_values = set(null_values)
        self.columns = list(columns) if columns is not None else None

    def _coerce(self, name: str, v: str) -> Any:
        if v is None or v in self.null_values:
            return None
        if self.schema and name in self.schema:
            try:
                return self.schema[name](v)
            except (ValueError, TypeError):
                return None
        try:
            f = float(v)
            if f.is_integer() and "." not in v and "e" not in v.lower():
                return int(v)
            return f
        except ValueError:
            return v

    def read(self) -> List[Record]:
        out: List[Record] = []
        with open(self.path, newline="") as fh:
            if self.columns is not None:
                for i, raw in enumerate(_csv.reader(fh)):
                    if any(f != "" for f in raw):
                        out.append({k: self._coerce(k, v) for k, v
                                    in zip(self.columns,
                                           self._checked(raw, i))})
            else:
                for row in _csv.DictReader(fh):
                    out.append({k: self._coerce(k, v)
                                for k, v in row.items()})
        return out

    def _checked(self, row: Sequence[str], i: int) -> Sequence[str]:
        """In explicit-columns mode a field-count mismatch is malformed input
        — zip() would silently null or drop trailing fields otherwise."""
        if self.columns is not None and len(row) != len(self.columns):
            raise ValueError(
                f"{self.path}: row {i + 1} has {len(row)} fields, expected "
                f"{len(self.columns)} ({', '.join(self.columns[:4])}...)")
        return row
