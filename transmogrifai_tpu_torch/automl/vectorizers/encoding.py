"""Vectorized host-side encoding primitives shared by the vectorizers
(counterpart of automl/vectorizers/encoding.py).

Host transforms are O(n) passes at C speed or one dict hit per row, never
per-row Python work beyond that: factorize once, apply the Python-level
work (cleaning, vocabulary lookup) to the UNIQUE values only (usually
<< n), then scatter indicators with numpy fancy indexing. The JAX package
runs the same passes through its C extension when built; the port keeps
to numpy and the standard library. Callers never rely on the ORDER of the
uniques — codes are remapped through vocabulary lookups — so the matrices
are the same bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np


def null_mask(data: Sequence[Any]) -> np.ndarray:
    """[n] bool: value is None (missing)."""
    return np.fromiter((v is None for v in data), np.bool_, len(data))


def _as_str(v: Any) -> str:
    return "" if v is None else (v if type(v) is str else str(v))


def factorize(data: Sequence[Any]) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    """(uniques, inverse, null_mask) for a column of scalar-ish values.

    None becomes "" in the unique table (masked separately); non-strings
    stringify. One dict pass over the rows: a column of strings hits the
    interpreter's cached string hashes. Values that are equal but print
    differently (1, 1.0 and True hash alike) are told apart by type, and
    unhashable values take the stringified pass."""
    n = len(data)
    index: Dict[Any, int] = {}
    try:
        inv = np.fromiter((index.setdefault(v, len(index)) for v in data),
                          np.int64, n)
        keys = list(index)
        if any(k is not None and type(k) is not str for k in keys):
            index = {}
            inv = np.fromiter(
                (index.setdefault((v.__class__, v), len(index))
                 for v in data), np.int64, n)
            keys = [k[1] for k in index]
    except TypeError:
        index = {}
        inv = np.fromiter((index.setdefault(_as_str(v), len(index))
                           for v in data), np.int64, n)
        keys = list(index)
    uniq = np.empty(len(keys), dtype=object)
    uniq[:] = [_as_str(k) for k in keys]
    none_codes = [i for i, k in enumerate(keys) if k is None]
    nm = (inv == none_codes[0]) if none_codes else np.zeros(n, np.bool_)
    return uniq, inv, nm


def pivot_codes(uniq: np.ndarray, vocab_index: Dict[str, int], other_code: int,
                clean_fn) -> np.ndarray:
    """Map each UNIQUE raw value to its indicator column (vocab index or
    OTHER). Cleaning and dict lookups run once per unique value."""
    out = np.empty(len(uniq), np.int64)
    for i, u in enumerate(uniq):
        out[i] = vocab_index.get(clean_fn(u), other_code)
    return out


def pivot_block_single(data: Sequence[Any], vocab: Sequence[str],
                       track_nulls: bool, clean_fn,
                       out: Optional[np.ndarray] = None) -> np.ndarray:
    """One-hot pivot of a scalar categorical column: [n, K+1(+1)] with
    topK indicators, OTHER, and optionally a null column. `out`
    (pre-zeroed, may be a strided view of the combined matrix) receives the
    block in place."""
    n = len(data)
    k = len(vocab)
    width = k + 1 + (1 if track_nulls else 0)
    block = np.zeros((n, width), dtype=np.float32) if out is None else out
    if n == 0:
        return block
    uniq, inv, nm = factorize(data)
    index = {v: i for i, v in enumerate(vocab)}
    codes = pivot_codes(uniq, index, k, clean_fn)[inv]
    codes[nm] = k + 1 if track_nulls else -1
    keep = codes >= 0
    block[np.arange(n)[keep], codes[keep]] = 1.0
    return block


def _flat_items(data: Sequence[Any], lengths: np.ndarray) -> np.ndarray:
    return np.fromiter(
        (it if type(it) is str else str(it)
         for v in data if v for it in v),
        dtype=object, count=int(lengths.sum()))


def pivot_block_multi(data: Sequence[Any], vocab: Sequence[str],
                      track_nulls: bool, clean_fn,
                      out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pivot of a multi-valued (set/list) categorical column. Rows with
    multiple items set multiple indicators; empty rows hit the null col.
    `out`: pre-zeroed in-place destination, like pivot_block_single."""
    n = len(data)
    k = len(vocab)
    width = k + 1 + (1 if track_nulls else 0)
    block = np.zeros((n, width), dtype=np.float32) if out is None else out
    if n == 0:
        return block
    lengths = np.fromiter((len(v) if v else 0 for v in data), np.int64, n)
    if lengths.sum():
        row_ids = np.repeat(np.arange(n), lengths)
        uniq, inv = np.unique(_flat_items(data, lengths), return_inverse=True)
        index = {v: i for i, v in enumerate(vocab)}
        codes = pivot_codes(uniq, index, k, clean_fn)[inv]
        block[row_ids, codes] = 1.0
    if track_nulls:
        block[lengths == 0, k + 1] = 1.0
    return block


def category_counts(data: Sequence[Any], clean_fn,
                    multiset: bool = False) -> Tuple[Dict[str, int], int]:
    """(cleaned-value -> count, n_present_rows), computed from uniques:
    counts of raw values, then cleaning collapses raw uniques into cleaned
    buckets."""
    n = len(data)
    if multiset:
        lengths = np.fromiter((len(v) if v else 0 for v in data), np.int64, n)
        # present = non-None row (an EMPTY collection still counts: it feeds
        # the cardinality-ratio guard's denominator like any observed row)
        n_present = int((~null_mask(data)).sum())
        if not lengths.sum():
            return {}, n_present
        uniq, counts = np.unique(_flat_items(data, lengths),
                                 return_counts=True)
    else:
        uniq, inv, nm = factorize(data)
        n_present = int((~nm).sum())
        if n_present == 0:
            return {}, 0
        counts = np.bincount(inv[~nm], minlength=len(uniq))
        keep = counts > 0
        uniq, counts = uniq[keep], counts[keep]
    out: Dict[str, int] = {}
    for u, c in zip(uniq, counts):
        cv = clean_fn(u)
        out[cv] = out.get(cv, 0) + int(c)
    return out, n_present


def empty_mask(data: Sequence[Any]) -> np.ndarray:
    """[n] bool: value is falsy (None or an empty collection or string)."""
    return np.fromiter((not v for v in data), np.bool_, len(data))


def float_column(vals: Sequence[Any], fill: float) -> np.ndarray:
    """[n] float64 with None -> fill."""
    return np.fromiter(
        (fill if v is None else float(v) for v in vals),
        np.float64, len(vals))


def triple_block(data: Sequence[Any], fill: Sequence[float]) -> np.ndarray:
    """[n, 3] from (lat, lon, acc) triples with falsy -> fill."""
    n = len(data)
    f0, f1, f2 = (float(fill[0]), float(fill[1]),
                  float(fill[2])) if len(fill) >= 3 else (0.0, 0.0, 0.0)
    return np.fromiter(
        ((v[0], v[1], v[2]) if v else (f0, f1, f2) for v in data),
        dtype=np.dtype((np.float64, 3)), count=n)


def extract_key_columns(data: Sequence[Any], keys: Sequence[str],
                        clean_fn=None) -> Dict[str, List[Any]]:
    """Explode a column of dict rows into per-key value lists in ONE pass
    over the entries. `clean_fn` normalizes raw keys before matching (None
    = exact match)."""
    n = len(data)
    cols: Dict[str, List[Any]] = {k: [None] * n for k in keys}
    if clean_fn is None:
        for i, m in enumerate(data):
            if m:
                for k, v in m.items():
                    c = cols.get(k)
                    if c is not None:
                        c[i] = v
    else:
        # first-wins on cleaned-key collisions ({'First.Name', 'FirstName'}
        # both cleaning to 'firstname'), as a first-match scan would
        for i, m in enumerate(data):
            if m:
                for k, v in m.items():
                    c = cols.get(clean_fn(str(k)))
                    if c is not None and c[i] is None:
                        c[i] = v
    return cols


def list_reduce(data: Sequence[Any], mode: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row max/min of variable-length numeric lists: (reduced [n]
    float64 with 0.0 for empty, empty_mask [n] bool), through
    np.maximum/minimum.reduceat over the flattened values."""
    n = len(data)
    lengths = np.fromiter((len(v) if v else 0 for v in data), np.int64, n)
    empty = lengths == 0
    out = np.zeros(n, np.float64)
    total = int(lengths.sum())
    if total:
        flat = np.fromiter(
            (float(x) for v in data if v for x in v), np.float64, total)
        nz = np.nonzero(~empty)[0]
        starts = np.zeros(len(nz), np.int64)
        np.cumsum(lengths[nz][:-1], out=starts[1:])
        ufunc = np.maximum if mode == "max" else np.minimum
        out[nz] = ufunc.reduceat(flat, starts)
    return out, empty
