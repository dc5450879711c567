"""Data readers: ingestion and temporal aggregation (counterpart of
readers/readers.py).

Reference: readers/ module — Reader.scala:96, DataReader.scala:57-252,
JoinedDataReader.scala, DataReaders factory. Ingestion is a host-side
columnar pipeline: records -> extract per raw feature -> typed Column
arrays, which the workflow's stages read. reduceByKey becomes an in-memory
group-by with the monoid aggregators of features/aggregators.py, applied
with the JAX package's cutoff-time semantics.

The aggregate readers group a reader's records once and extract each
feature from each record once (the JAX package calls the event-time
function once per feature and record, and groups per feature); the joins
number the keys with a dict instead of sorting the key strings. The
datasets are the same: keys in first-seen order, the same rows, values and
nulls. The streaming micro-batch readers are in readers/streaming.py.
"""
from __future__ import annotations

import csv as _csv
import json
from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from ..data.dataset import Column, Dataset, column_from_values
from ..features.feature import Feature
from ..features.generator import FeatureGeneratorStage
from ..types import ColumnKind

Record = Any  # dict-like or object; feature extract fns know how to read it

KEY_COLUMN = "key"


def _key_column(keys: Sequence[str]) -> Column:
    data = np.empty(len(keys), dtype=object)
    for i, k in enumerate(keys):
        data[i] = k
    return Column(kind=ColumnKind.STRING, data=data)


class Reader:
    """Base reader: produce records, then materialize the raw-feature dataset
    (reference Reader.generateDataFrame, DataReader.scala:173)."""

    def __init__(self, key_fn: Optional[Callable[[Record], str]] = None):
        self.key_fn = key_fn

    def read(self) -> List[Record]:
        raise NotImplementedError

    # -- joins (reference Reader.scala:112-134) ----------------------------
    def outer_join(self, other: "Reader", **kw) -> "JoinedReader":
        return JoinedReader(self, other, join_type="outer", **kw)

    def left_outer_join(self, other: "Reader", **kw) -> "JoinedReader":
        return JoinedReader(self, other, join_type="left", **kw)

    def inner_join(self, other: "Reader", **kw) -> "JoinedReader":
        return JoinedReader(self, other, join_type="inner", **kw)

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
            cols[f.name] = column_from_values(
                f.feature_type, g.extract_all(records), coerced=True)
        ds = Dataset(cols)
        if self.key_fn is not None:
            ds = ds.with_column(KEY_COLUMN, _key_column(
                [str(self.key_fn(r)) for r in records]))
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
        return list(self.iter_records())

    def iter_records(self) -> Iterable[Record]:
        """Stream records one at a time off the file handle."""
        with open(self.path, newline="") as fh:
            if self.columns is not None:
                for i, raw in enumerate(_csv.reader(fh)):
                    if any(f != "" for f in raw):
                        yield {k: self._coerce(k, v) for k, v
                               in zip(self.columns, self._checked(raw, i))}
            else:
                for row in _csv.DictReader(fh):
                    yield {k: self._coerce(k, v) for k, v in row.items()}

    def _checked(self, row: Sequence[str], i: int) -> Sequence[str]:
        """In explicit-columns mode a field-count mismatch is malformed input
        — zip() would silently null or drop trailing fields otherwise."""
        if self.columns is not None and len(row) != len(self.columns):
            raise ValueError(
                f"{self.path}: row {i + 1} has {len(row)} fields, expected "
                f"{len(self.columns)} ({', '.join(self.columns[:4])}...)")
        return row


# -- columnar decode ----------------------------------------------------------

_F32_NULL_VALUES = ("", "NA", "null", "NULL", "None")


def columnar_f32(values: Sequence[Any],
                 null_values: Sequence[str] = _F32_NULL_VALUES
                 ) -> np.ndarray:
    """ONE vectorized float32 conversion for a whole column chunk (the
    columnar replacement for the per-cell CSVReader._coerce walk).

    String columns map the null spellings to NaN in one `np.isin` pass,
    then parse with a single `astype`; numeric/bool columns are one
    `astype`; object columns (Avro nullable unions) map None -> NaN in
    one array build."""
    arr = np.asarray(values)
    if arr.dtype.kind in "fiub":
        return arr.astype(np.float32, copy=False)
    if arr.dtype.kind in "US":
        if null_values:
            mask = np.isin(arr, np.asarray(list(null_values)))
            if mask.any():
                arr = np.where(mask, "nan", arr)
        return arr.astype(np.float32)
    return np.array([np.nan if v is None else v for v in values],
                    dtype=np.float32)


def csv_columnar_chunks(path: str, *,
                        columns: Optional[Sequence[str]] = None,
                        fields: Optional[Sequence[str]] = None,
                        batch_records: int = 8192,
                        null_values: Sequence[str] = _F32_NULL_VALUES
                        ) -> Iterable[Dict[str, np.ndarray]]:
    """Stream a CSV file as `{column -> float32 array}` chunks of up to
    `batch_records` rows: rows buffer raw, transpose once per chunk, and
    each kept column converts with ONE columnar_f32 call.

    `fields` names the columns of a HEADERLESS file (same contract as
    CSVReader(columns=...)); otherwise the first row is the header.
    `columns` restricts output to the named subset. Blank rows are skipped
    and a field-count mismatch raises, as in CSVReader._checked."""
    with open(path, newline="") as fh:
        reader = _csv.reader(fh)
        if fields is not None:
            names = [str(c) for c in fields]
        else:
            try:
                names = next(reader)
            except StopIteration:
                return
        keep = [(nm, j) for j, nm in enumerate(names)
                if columns is None or nm in set(columns)]
        n_fields = len(names)
        buf: List[Sequence[str]] = []

        def flush() -> Dict[str, np.ndarray]:
            cols = list(zip(*buf))
            return {nm: columnar_f32(cols[j], null_values)
                    for nm, j in keep}

        for i, raw in enumerate(reader):
            if not any(f != "" for f in raw):
                continue
            if len(raw) != n_fields:
                raise ValueError(
                    f"{path}: row {i + 1} has {len(raw)} fields, "
                    f"expected {n_fields}")
            buf.append(raw)
            if len(buf) >= batch_records:
                yield flush()
                buf = []
        if buf:
            yield flush()


class JSONLinesReader(Reader):
    """One JSON object a line."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Record], str]] = None):
        super().__init__(key_fn)
        self.path = path

    def read(self) -> List[Record]:
        with open(self.path) as fh:
            return [json.loads(line) for line in fh if line.strip()]


class ParquetReader(Reader):
    """Parquet via pyarrow if available (reference ParquetProductReader)."""

    def __init__(self, path: str,
                 key_fn: Optional[Callable[[Record], str]] = None):
        super().__init__(key_fn)
        self.path = path

    def read(self) -> List[Record]:
        try:
            import pyarrow.parquet as pq  # optional dependency
        except ImportError as e:
            raise ImportError(
                "ParquetReader requires pyarrow; not available in this "
                "environment — use CSVReader/JSONLinesReader") from e
        return pq.read_table(self.path).to_pylist()


def _group_by_key(keys: Sequence[str]) -> Tuple[List[str], List[List[int]]]:
    """(keys in first-seen order, each key's record indices in order)."""
    groups: Dict[str, List[int]] = {}
    for i, k in enumerate(keys):
        rows = groups.get(k)
        if rows is None:
            groups[k] = [i]
        else:
            rows.append(i)
    return list(groups), list(groups.values())


class AggregateReader(Reader):
    """Groups event records by key and aggregates each feature with its monoid
    aggregator relative to a cutoff time — one output row per key (reference
    AggregatedReader.generateDataFrame, DataReader.scala:206-252)."""

    def __init__(self, base: Reader, key_fn: Callable[[Record], str],
                 cutoff_time: Optional[int] = None,
                 event_time_fn: Optional[Callable[[Record],
                                                  Optional[int]]] = None):
        super().__init__(key_fn)
        self.base = base
        self.cutoff_time = cutoff_time
        self.event_time_fn = event_time_fn

    def read(self) -> List[Record]:
        return self.base.read()

    def _aggregate(self, raw_features, records, order, members, times_of,
                   cutoff_of) -> Dataset:
        """One row per key of `order` (its records `members`): each feature
        folds its (value, time) events through FeatureAggregator.extract
        around the key's cutoff."""
        cols: Dict[str, Any] = {}
        for f in raw_features:
            g = self._generator_of(f)
            ext = g.extract_all(records)
            times = times_of(g)
            agg = g.aggregator
            vals = [agg.extract([(ext[i], times[i]) for i in rows],
                                cutoff_time=cutoff_of(k),
                                is_response=f.is_response)
                    for k, rows in zip(order, members)]
            cols[f.name] = column_from_values(f.feature_type, vals)
        return Dataset(cols).with_column(KEY_COLUMN, _key_column(order))

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        records = self.read()
        order, members = _group_by_key([str(self.key_fn(r))
                                        for r in records])
        by_fn: Dict[int, List[Optional[int]]] = {}

        def times_of(g):
            """Event times of the records under the feature's own time
            function, else the reader's: computed once per function."""
            fn = g.event_time_fn or self.event_time_fn
            if fn is None:
                return [None] * len(records)
            if id(fn) not in by_fn:
                by_fn[id(fn)] = [fn(r) for r in records]
            return by_fn[id(fn)]
        return self._aggregate(raw_features, records, order, members,
                               times_of, lambda k: self.cutoff_time)


class ConditionalReader(AggregateReader):
    """Two-pass temporal reader (reference ConditionalDataReader): pass 1
    finds each key's target time via a condition; pass 2 aggregates
    predictors before and responses after that per-key time."""

    def __init__(self, base: Reader, key_fn: Callable[[Record], str],
                 condition_fn: Callable[[Record], bool],
                 event_time_fn: Callable[[Record], Optional[int]],
                 drop_if_no_condition: bool = True):
        super().__init__(base, key_fn, cutoff_time=None,
                         event_time_fn=event_time_fn)
        self.condition_fn = condition_fn
        self.drop_if_no_condition = drop_if_no_condition

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        records = self.read()
        order, members = _group_by_key([str(self.key_fn(r))
                                        for r in records])
        times = [self.event_time_fn(r) for r in records]
        # pass 1: per-key target time = earliest event satisfying condition
        target: Dict[str, Optional[int]] = {}
        for k, rows in zip(order, members):
            ts = [times[i] for i in rows if self.condition_fn(records[i])]
            ts = [t for t in ts if t is not None]
            target[k] = min(ts) if ts else None
        keep = [j for j, k in enumerate(order)
                if target[k] is not None or not self.drop_if_no_condition]
        return self._aggregate(
            raw_features, records, [order[j] for j in keep],
            [members[j] for j in keep], lambda g: times, target.get)


def _key_codes(*sides: np.ndarray) -> List[np.ndarray]:
    """Integer codes of the keys of each side, equal codes for equal keys
    (one dict over both sides)."""
    code: Dict[Any, int] = {}
    return [np.fromiter((code.setdefault(k, len(code)) for k in keys),
                        dtype=np.int64, count=len(keys)) for keys in sides]


def _merge_join_indices(lkeys: np.ndarray, rkeys: np.ndarray,
                        join_type: str):
    """Columnar one-to-many join plan: (l_idx, r_idx) row-index arrays into
    the two sides (-1 = no match on that side). Sorted merge via
    argsort/searchsorted over the keys' integer codes: the plan depends on
    key equality only, so it is the JAX package's plan over the strings."""
    L = len(lkeys)
    if len(rkeys) == 0:
        if join_type in ("left", "outer"):
            return np.arange(L, dtype=np.int64), np.full(L, -1, np.int64)
        return np.empty(0, np.int64), np.empty(0, np.int64)
    lkeys, rkeys = _key_codes(lkeys, rkeys)
    r_order = np.argsort(rkeys, kind="stable")
    rsorted = rkeys[r_order]
    lo = np.searchsorted(rsorted, lkeys, "left")
    hi = np.searchsorted(rsorted, lkeys, "right")
    m = hi - lo
    n_per = np.where(m > 0, m, 1 if join_type in ("left", "outer") else 0)
    total = int(n_per.sum())
    l_idx = np.repeat(np.arange(L), n_per)
    starts = np.cumsum(n_per) - n_per
    off = np.arange(total) - np.repeat(starts, n_per)
    has = np.repeat(m > 0, n_per)
    r_pos = np.repeat(lo, n_per) + off
    r_idx = np.where(has, r_order[np.where(has, r_pos, 0)], -1)
    if join_type == "outer":
        # append right rows whose key never appears on the left
        if L:
            lsorted = np.sort(lkeys)
            pos = np.clip(np.searchsorted(lsorted, rkeys), 0, L - 1)
            matched = lsorted[pos] == rkeys
        else:
            matched = np.zeros(len(rkeys), bool)
        extra = np.flatnonzero(~matched)
        l_idx = np.concatenate([l_idx, np.full(len(extra), -1)])
        r_idx = np.concatenate([r_idx, extra])
    return l_idx.astype(np.int64), r_idx.astype(np.int64)


def _gather_column(col: Column, idx: np.ndarray) -> Column:
    """Columnar take with -1 -> missing, preserving the column's storage
    (NaN for float kinds, None for object kinds)."""
    miss = idx < 0
    safe = np.where(miss, 0, idx)
    data = col.data
    if not isinstance(data, np.ndarray):
        data = np.asarray(data, dtype=object)
    if len(data) == 0:   # gathering from an empty side: all-missing rows
        if col.kind == ColumnKind.VECTOR:
            out = np.full((len(idx), 0), np.nan, np.float32)
        elif data.dtype.kind == "f":
            out = np.full(len(idx), np.nan)
        else:
            out = np.full(len(idx), None, dtype=object)
        return Column(kind=col.kind, data=out, metadata=col.metadata)
    out = data[safe]
    if miss.any():
        out = out.copy()
        if data.dtype.kind == "f":
            out[miss] = np.nan
        else:
            out = out.astype(object)
            out[miss] = None
    return Column(kind=col.kind, data=out, metadata=col.metadata)


class JoinedReader(Reader):
    """Key-joins two readers' generated datasets (reference
    JoinedDataReader.scala:83). Columnar sorted merge, one-to-many aware:
    joining a parent reader to an event-level child reader emits one row
    per (parent, child event) pair — feed that to
    ``with_secondary_aggregation`` to re-aggregate per key afterwards
    (reference JoinedAggregateDataReader)."""

    def __init__(self, left: Reader, right: Reader, join_type: str = "outer",
                 left_features: Optional[Sequence[str]] = None,
                 right_features: Optional[Sequence[str]] = None):
        super().__init__(None)
        self.left = left
        self.right = right
        if join_type not in ("outer", "inner", "left"):
            raise ValueError(f"Unsupported join type: {join_type}")
        self.join_type = join_type
        self.left_features = set(left_features) if left_features else None
        self.right_features = set(right_features) if right_features else None

    def with_secondary_aggregation(
            self, time_filter: "TimeBasedFilter",
            combined: bool = False) -> "JoinedAggregateReader":
        """Re-aggregate joined child rows per key with a time-based filter
        (reference JoinedDataReader.withSecondaryAggregation:232)."""
        return JoinedAggregateReader(
            self.left, self.right, time_filter, join_type=self.join_type,
            left_features=self.left_features,
            right_features=self.right_features, combined=combined)

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        left_feats, right_feats = [], []
        for f in raw_features:
            side = self._side_of(f)
            (left_feats if side == "left" else right_feats).append(f)
        lds = self.left.generate_dataset(left_feats)
        rds = self.right.generate_dataset(right_feats)
        if KEY_COLUMN not in lds or KEY_COLUMN not in rds:
            raise ValueError("JoinedReader requires key_fn on both readers")
        lkeys = np.asarray(lds.data(KEY_COLUMN), dtype=object)
        rkeys = np.asarray(rds.data(KEY_COLUMN), dtype=object)
        l_idx, r_idx = _merge_join_indices(lkeys, rkeys, self.join_type)
        cols: Dict[str, Any] = {}
        for f in left_feats:
            cols[f.name] = _gather_column(lds.column(f.name), l_idx)
        for f in right_feats:
            cols[f.name] = _gather_column(rds.column(f.name), r_idx)
        keys = np.empty(len(l_idx), dtype=object)
        lm = l_idx >= 0
        keys[lm] = lkeys[l_idx[lm]]
        keys[~lm] = rkeys[r_idx[~lm]]
        return Dataset(cols).with_column(
            KEY_COLUMN, Column(kind=ColumnKind.STRING, data=keys))

    def _side_of(self, f: Feature) -> str:
        """Route a feature to the reader whose records it extracts from:
        by explicit left_features/right_features name sets, else by the
        generator's reader_hint. Ambiguity is an error, not a guess."""
        if self.left_features is not None and f.name in self.left_features:
            return "left"
        if self.right_features is not None and f.name in self.right_features:
            return "right"
        hint = getattr(f.origin_stage, "reader_hint", None)
        if hint is self.left or hint == id(self.left):
            return "left"
        if hint is self.right or hint == id(self.right):
            return "right"
        raise ValueError(
            f"JoinedReader cannot route feature '{f.name}': pass "
            "left_features/right_features name lists or set the generator's "
            "reader_hint")


@dataclass
class TimeColumn:
    """Time column for post-join aggregation (reference TimeColumn,
    JoinedDataReader.scala:54): ``keep=False`` drops it from the result."""

    name: str
    keep: bool = True


@dataclass
class TimeBasedFilter:
    """Window filter for post-join conditional aggregation (reference
    TimeBasedFilter, JoinedDataReader.scala:69). ``time_window`` is in the
    same units as the two time columns (reference uses millis)."""

    condition: TimeColumn
    primary: TimeColumn
    time_window: int


def _as_values(data: np.ndarray, rows: np.ndarray) -> List[Any]:
    """Python values of `data` at `rows`, NaN -> None for float storage."""
    vals = data[rows].tolist()
    if data.dtype.kind == "f":
        vals = [None if v != v else v for v in vals]
    return vals


class JoinedAggregateReader(JoinedReader):
    """Join then RE-AGGREGATE per key with a time-based filter (reference
    JoinedAggregateDataReader, JoinedDataReader.scala:250-345).

    The join emits one row per (parent, child event) pair; this reader then
    groups by key and folds each feature with its generator's monoid, but
    only over rows inside the feature's time window relative to the row's
    condition time (JoinedConditionalAggregator:430-441):

    - predictors: ``cutoff - window < t < cutoff``
    - responses:  ``cutoff <= t < cutoff + window``

    Parent-side features keep one copy per key (DummyJoinedAggregator)
    unless ``combined=True`` (reference isCombinedJoin), in which case they
    are window-filtered too. The per-feature window defaults to the
    filter's but is overridden by the feature generator's own
    ``aggregator.window_ms`` (reference getConditionalAggregators:337).
    """

    def __init__(self, left: Reader, right: Reader,
                 time_filter: TimeBasedFilter, join_type: str = "outer",
                 left_features: Optional[Sequence[str]] = None,
                 right_features: Optional[Sequence[str]] = None,
                 combined: bool = False):
        super().__init__(left, right, join_type=join_type,
                         left_features=left_features,
                         right_features=right_features)
        self.time_filter = time_filter
        self.combined = combined

    def _time_values(self, ds: Dataset, name: str) -> np.ndarray:
        """Column -> float64 time array; missing -> 0 (reference
        JoinedConditionalAggregator.update: getOrElse(0L))."""
        if name not in ds:
            raise ValueError(
                f"time filter column '{name}' is not in the joined data — "
                "include its feature in raw_features")
        arr = ds.column(name).data
        if isinstance(arr, np.ndarray) and arr.dtype.kind == "f":
            return np.nan_to_num(arr, nan=0.0)
        return np.array([0.0 if v is None else float(v) for v in arr])

    def generate_dataset(self, raw_features: Sequence[Feature]) -> Dataset:
        joined = super().generate_dataset(raw_features)
        keys = joined.data(KEY_COLUMN)
        # group numbers in first-seen key order, rows of a group in order
        (group_of_row,) = _key_codes(keys)
        n_groups = int(group_of_row.max()) + 1 if len(keys) else 0
        ordered_keys = np.empty(n_groups, dtype=object)
        ordered_keys[group_of_row] = keys
        row_order = np.argsort(group_of_row, kind="stable")
        bounds = np.searchsorted(group_of_row[row_order],
                                 np.arange(n_groups + 1))
        t = self._time_values(joined, self.time_filter.primary.name)
        cutoff = self._time_values(joined, self.time_filter.condition.name)

        left_names = {f.name for f in raw_features
                      if self._side_of(f) == "left"}
        drop = {c.name for c in (self.time_filter.condition,
                                 self.time_filter.primary) if not c.keep}
        cols: Dict[str, Any] = {}
        for f in raw_features:
            if f.name in drop:
                continue
            g = self._generator_of(f)
            data = joined.column(f.name).data
            if not isinstance(data, np.ndarray):
                data = np.asarray(data, dtype=object)
            if f.name in left_names and not self.combined:
                # one copy per key (the merge keeps the later value)
                vals = _as_values(data, row_order[bounds[1:] - 1])
            else:
                w = g.aggregator.window_ms
                w = self.time_filter.time_window if w is None else w
                if f.is_response:
                    ok = (t >= cutoff) & (t < cutoff + w)
                else:
                    ok = (t < cutoff) & (t > cutoff - w)
                sel = row_order[ok[row_order]]
                b = np.searchsorted(group_of_row[sel],
                                    np.arange(n_groups + 1)).tolist()
                ev = _as_values(data, sel)
                ts = t[sel].tolist()
                reduce = g.aggregator.aggregator.reduce
                vals = [reduce(ev[b[i]:b[i + 1]], ts[b[i]:b[i + 1]])
                        for i in range(n_groups)]
            cols[f.name] = column_from_values(f.feature_type, vals)
        return Dataset(cols).with_column(
            KEY_COLUMN, Column(kind=ColumnKind.STRING, data=ordered_keys))


class DataReaders:
    """Factory namespace (reference DataReaders.scala:44-198)."""

    class Simple:
        csv = CSVReader
        json_lines = JSONLinesReader
        parquet = ParquetReader
        records = ListReader

    class Aggregate:
        @staticmethod
        def csv(path: str, key_fn, cutoff_time=None, event_time_fn=None,
                **kw):
            return AggregateReader(CSVReader(path, **kw), key_fn,
                                   cutoff_time, event_time_fn)

        @staticmethod
        def records(records, key_fn, cutoff_time=None, event_time_fn=None):
            return AggregateReader(ListReader(records), key_fn,
                                   cutoff_time, event_time_fn)

    class Conditional:
        @staticmethod
        def records(records, key_fn, condition_fn, event_time_fn, **kw):
            return ConditionalReader(ListReader(records), key_fn,
                                     condition_fn, event_time_fn, **kw)
