"""Avro Object Container File reader and writer, pure Python (counterpart
of readers/avro.py).

Reference: readers/.../AvroReaders.scala + utils/.../io/AvroInOut.scala —
Avro is the reference's native event format. A self-contained OCF codec:
magic/metadata/sync framing, the null and deflate codecs, and the standard
binary encoding for records of null/boolean/int/long/float/double/bytes/
string/enum/fixed/array/map/union; `infer_avro_schema` and `csv_to_avro`
convert CSV files (reference utils/io/CSVToAvro).
"""
from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np
from typing import (Any, Callable, Dict, Iterator, List, Optional,
                    Sequence, Tuple)

_MAGIC = b"Obj\x01"


class AvroDecodeError(ValueError):
    pass


class _Bin:
    """Avro binary decoder over a byte buffer."""

    def __init__(self, data: bytes):
        self.buf = data
        self.pos = 0

    def read(self, n: int) -> bytes:
        if n < 0:  # negative decoded length would rewind the cursor
            raise AvroDecodeError("negative length in avro data")
        if self.pos + n > len(self.buf):
            raise AvroDecodeError("truncated avro data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    # zig-zag varint
    def long(self) -> int:
        shift = 0
        acc = 0
        while True:
            if self.pos >= len(self.buf):
                raise AvroDecodeError("truncated avro data")
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
            if shift > 63:
                raise AvroDecodeError("malformed varint (shift > 63)")
        return (acc >> 1) ^ -(acc & 1)

    def float_(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def bytes_(self) -> bytes:
        return self.read(self.long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def boolean(self) -> bool:
        return self.read(1) != b"\x00"


def _resolve(schema: Any, named: Dict[str, Any]) -> Any:
    if isinstance(schema, str) and schema in named:
        return named[schema]
    return schema


def _collect_named(schema: Any, named: Dict[str, Any]) -> None:
    if isinstance(schema, dict):
        t = schema.get("type")
        if t in ("record", "enum", "fixed") and "name" in schema:
            named[schema["name"]] = schema
            ns = schema.get("namespace")
            if ns:
                named[f"{ns}.{schema['name']}"] = schema
        for key in ("fields", "items", "values"):
            v = schema.get(key)
            if isinstance(v, list):
                for f in v:
                    _collect_named(f.get("type") if isinstance(f, dict)
                                   else f, named)
            elif v is not None:
                _collect_named(v, named)
    elif isinstance(schema, list):
        for s in schema:
            _collect_named(s, named)


def _decode(schema: Any, d: _Bin, named: Dict[str, Any]) -> Any:
    schema = _resolve(schema, named)
    if isinstance(schema, list):                     # union
        idx = d.long()
        if idx < 0 or idx >= len(schema):
            raise AvroDecodeError(f"bad union index {idx}")
        return _decode(schema[idx], d, named)
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {f["name"]: _decode(f["type"], d, named)
                    for f in schema["fields"]}
        if t == "enum":
            return schema["symbols"][d.long()]
        if t == "fixed":
            return d.read(int(schema["size"]))
        if t == "array":
            out: List[Any] = []
            while True:
                n = d.long()
                if n == 0:
                    break
                if n < 0:
                    d.long()  # block byte size, unused
                    n = -n
                for _ in range(n):
                    out.append(_decode(schema["items"], d, named))
            return out
        if t == "map":
            m: Dict[str, Any] = {}
            while True:
                n = d.long()
                if n == 0:
                    break
                if n < 0:
                    d.long()
                    n = -n
                for _ in range(n):
                    k = d.string()
                    m[k] = _decode(schema["values"], d, named)
            return m
        # logical types ride on a primitive "type"
        return _decode(t, d, named)
    # primitive
    if schema == "null":
        return None
    if schema == "boolean":
        return d.boolean()
    if schema in ("int", "long"):
        return d.long()
    if schema == "float":
        return d.float_()
    if schema == "double":
        return d.double()
    if schema == "bytes":
        return d.bytes_()
    if schema == "string":
        return d.string()
    raise AvroDecodeError(f"unsupported schema: {schema!r}")


def _open_ocf(path: str) -> Tuple[_Bin, Any, str, bytes, Dict[str, Any]]:
    """Parse one OCF header: returns the decoder positioned at the first
    data block plus (schema, codec, sync, named-type registry). Shared
    by the record iterator and the columnar block reader so both see
    the identical framing/codec contract."""
    with open(path, "rb") as f:
        data = f.read()
    d = _Bin(data)
    if d.read(4) != _MAGIC:
        raise AvroDecodeError(f"{path}: not an Avro object container file")
    meta: Dict[str, bytes] = {}
    while True:
        n = d.long()
        if n == 0:
            break
        if n < 0:
            d.long()
            n = -n
        for _ in range(n):
            k = d.string()
            meta[k] = d.bytes_()
    sync = d.read(16)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode()
    named: Dict[str, Any] = {}
    _collect_named(schema, named)
    return d, schema, codec, sync, named


def _iter_ocf_blocks(d: _Bin, codec: str, sync: bytes
                     ) -> Iterator[Tuple[int, _Bin]]:
    """Yield (record_count, block decoder) per data block."""
    while not d.at_end():
        count = d.long()
        size = d.long()
        block = d.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise AvroDecodeError(f"unsupported codec {codec!r}")
        yield count, _Bin(block)
        if d.read(16) != sync:
            raise AvroDecodeError("sync marker mismatch")


def read_avro_file(path: str) -> Iterator[Dict[str, Any]]:
    """Iterate records of one OCF file."""
    d, schema, codec, sync, named = _open_ocf(path)
    for count, bd in _iter_ocf_blocks(d, codec, sync):
        for _ in range(count):
            yield _decode(schema, bd, named)


# Avro primitives a block of records decodes at once into numpy columns:
# the fixed-width ones, and int / long (zig-zag varints of up to 10 bytes)
_FLAT_DTYPES = {"float": "<f4", "double": "<f8", "boolean": "u1",
                "int": "<i4", "long": "<i8"}
_VARINTS = ("int", "long")
_VARINT_MAX = 10
# record starts: the shortest run of one layout worth a vector step, and
# the records a Python walk takes where runs are shorter
_RUN_MIN, _WALK = 32, 1024


def _flat_record_fields(schema: Any, named: Dict[str, Any]
                        ) -> Optional[List[Tuple[str, str]]]:
    """[(name, type)] of a record schema whose every field is a float,
    double, boolean, int or long, else None."""
    schema = _resolve(schema, named)
    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        return None
    out = []
    for f in schema["fields"]:
        t = _resolve(f["type"], named)
        if isinstance(t, dict):
            t = t.get("type") if not t.get("logicalType") else None
        if not isinstance(t, str) or t not in _FLAT_DTYPES:
            return None
        out.append((f["name"], t))
    return out


def _segments(fields: List[Tuple[str, str]]) -> List[Any]:
    """A flat record's wire layout: each run of fixed-width fields as one
    packed numpy dtype, each int / long as its (name, type)."""
    segs: List[Any] = []
    run: List[Tuple[str, str]] = []
    for nm, t in fields:
        if t in _VARINTS:
            if run:
                segs.append(np.dtype(run))
                run = []
            segs.append((nm, t))
        else:
            run.append((nm, _FLAT_DTYPES[t]))
    if run:
        segs.append(np.dtype(run))
    return segs


def _walk(buf: bytes, pos: int, m: int, widths: List[int]
          ) -> Tuple[List[int], List[Tuple[int, ...]], int]:
    """The next `m` records from `pos`, one by one (a width of 0 is a
    varint): their starts, each one's layout (its varints' byte counts)
    and the end of the last."""
    starts, layouts = [], []
    try:
        for _ in range(m):
            starts.append(pos)
            layout = []
            for w in widths:
                if w:
                    pos += w
                    continue
                end = pos
                while buf[end] & 0x80:
                    end += 1
                if end - pos >= _VARINT_MAX:
                    raise AvroDecodeError("malformed varint (over 10 "
                                          "bytes)")
                layout.append(end + 1 - pos)
                pos = end + 1
            layouts.append(tuple(layout))
    except IndexError:
        raise AvroDecodeError("truncated avro data") from None
    return starts, layouts, pos


def _run_holds(b: np.ndarray, segs: List[Any], layout: Tuple[int, ...],
               pos: int, length: int, m: int) -> np.ndarray:
    """Whether each of the `m` records that would start at pos, pos +
    length, ... has the varint byte counts `layout` (continuation bits on
    all bytes of a varint but its last), read through strided views."""
    ok = np.ones(m, bool)
    off, widths = pos, iter(layout)
    for s in segs:
        if isinstance(s, np.dtype):
            off += s.itemsize
            continue
        w = next(widths)
        for j in range(w):
            col = b[off + j::length][:m]
            ok[:len(col)] &= (col >= 0x80) if j < w - 1 else (col < 0x80)
            ok[len(col):] = False
        off += w
    return ok


def _record_starts(buf: bytes, b: np.ndarray, segs: List[Any], count: int
                   ) -> Tuple[np.ndarray, np.ndarray,
                              List[Tuple[int, int, Tuple[int, ...]]]]:
    """(each record's first byte in a block of `count` flat records, each
    record's layout [count, varints], the runs of at least _RUN_MIN
    records of one layout as (first record, records, layout)). A long's
    varint grows with its value, so records of one layout come in runs:
    each step takes the first record's layout for the records ahead,
    checks them all at once and keeps them up to the first record of
    another layout (each kept start is exact: the one before it is, and
    has the guessed length). Where runs are short, a Python walk takes
    the next records one by one."""
    widths = [s.itemsize if isinstance(s, np.dtype) else 0 for s in segs]
    starts = np.empty(count, np.int64)
    layouts = np.empty((count, widths.count(0)), np.int64)
    runs: List[Tuple[int, int, Tuple[int, ...]]] = []
    i = pos = 0
    window = count
    while i < count:
        if window < _RUN_MIN:
            m = min(_WALK, count - i)
            st, lay, pos = _walk(buf, pos, m, widths)
            starts[i:i + m], layouts[i:i + m] = st, lay
            i += m
            window = _WALK
            continue
        m = min(window, count - i)
        _, (layout,), end = _walk(buf, pos, 1, widths)
        length = end - pos
        bad = np.flatnonzero(~_run_holds(b, segs, layout, pos, length, m))
        k = int(bad[0]) if bad.size else m
        starts[i:i + k] = pos + length * np.arange(k, dtype=np.int64)
        layouts[i:i + k] = layout
        if k >= _RUN_MIN:
            runs.append((i, k, layout))
        i += k
        pos += k * length
        window = 2 * m if k == m else k
    return starts, layouts, runs


def _column(col: np.ndarray) -> np.ndarray:
    """A decoded field as a native-order numpy column (booleans as bool)."""
    return col.astype(bool) if col.dtype == np.uint8 \
        else col.astype(col.dtype.newbyteorder("="))


def _varint_values(raw: np.ndarray, n: Optional[np.ndarray], t: str
                   ) -> np.ndarray:
    """Zig-zag varints from their bytes ([records, width] uint8; `n` each
    one's byte count where it is shorter than `width`)."""
    acc = np.uint32 if raw.shape[1] <= 4 else np.uint64   # 7 bits a byte
    u = np.zeros(len(raw), acc)
    for j in range(raw.shape[1]):
        g = (raw[:, j] & 0x7F).astype(acc)
        if n is not None:
            g[n <= j] = 0
        u |= g << acc(7 * j)
    v = (u >> acc(1)).astype(np.int64) ^ -(u & acc(1)).astype(np.int64)
    return v.astype(np.int32) if t == "int" else v


def _run_dtype(segs: List[Any], layout: Tuple[int, ...]) -> np.dtype:
    """The record dtype of a run of one layout: fixed fields at their
    offsets, each varint as its bytes."""
    names, formats, offsets, off = [], [], [], 0
    widths = iter(layout)
    for s in segs:
        if isinstance(s, np.dtype):
            for nm in s.names:
                fmt, at = s.fields[nm][:2]
                names.append(nm)
                formats.append(fmt)
                offsets.append(off + at)
            off += s.itemsize
        else:
            w = next(widths)
            names.append(s[0])
            formats.append((np.uint8, (w,)))
            offsets.append(off)
            off += w
    return np.dtype(dict(names=names, formats=formats, offsets=offsets,
                         itemsize=off))


def _flat_block(buf: bytes, count: int, segs: List[Any],
                names: List[str]) -> Dict[str, np.ndarray]:
    """The fields `names` of one block of `count` flat records as numpy
    columns: float32, float64, bool, int32 (int) and int64 (long). A run
    of one layout is one structured array over the block's bytes; the
    records outside runs are gathered from their starts."""
    if len(segs) == 1 and isinstance(segs[0], np.dtype):
        dtype = segs[0]              # fixed width: one structured array
        if len(buf) != count * dtype.itemsize:
            raise AvroDecodeError(
                f"block of {count} records holds {len(buf)} bytes, "
                f"not {count} x {dtype.itemsize}")
        rows = np.frombuffer(buf, dtype=dtype, count=count)
        return {nm: _column(rows[nm]) for nm in names}
    b = np.frombuffer(buf, np.uint8)
    starts, layouts, runs = _record_starts(buf, b, segs, count)
    fixed = sum(s.itemsize for s in segs if isinstance(s, np.dtype))
    if (count and starts[-1] + fixed + layouts[-1].sum() != len(b)) \
            or (not count and len(b)):
        raise AvroDecodeError(
            f"block of {count} records does not end at its {len(b)} bytes")
    types = {}
    for s in segs:
        types.update({nm: s.fields[nm][0] for nm in s.names}
                     if isinstance(s, np.dtype) else {s[0]: s[1]})
    out = {nm: np.empty(count, np.int32 if types[nm] == "int"
                        else np.int64 if types[nm] == "long"
                        else bool if types[nm] == np.uint8
                        else types[nm].newbyteorder("="))
           for nm in names}
    rest = np.ones(count, bool)
    for i, k, layout in runs:
        rows = np.frombuffer(buf, _run_dtype(segs, layout), count=k,
                             offset=int(starts[i]))
        for nm in names:            # assignment casts to the column
            out[nm][i:i + k] = rows[nm] if not isinstance(types[nm], str) \
                else _varint_values(rows[nm], None, types[nm])
        rest[i:i + k] = False
    rest = np.flatnonzero(rest)
    if not rest.size:
        return out
    off, keep, v = starts[rest], set(names), 0
    for s in segs:
        if isinstance(s, np.dtype):
            if keep.intersection(s.names):
                rows = np.lib.stride_tricks.sliding_window_view(
                    b, s.itemsize)[off].view(s)[:, 0]
                for nm in s.names:
                    if nm in keep:
                        out[nm][rest] = rows[nm]
            off = off + s.itemsize
            continue
        n = layouts[rest, v]
        v += 1
        if s[0] in keep:
            at = np.minimum(off[:, None] + np.arange(_VARINT_MAX),
                            len(b) - 1)
            out[s[0]][rest] = _varint_values(b[at], n, s[1])
        off = off + n
    return out


def read_avro_columns(path: str, *,
                      fields: Optional[Sequence[str]] = None,
                      batch_records: int = 8192, arrays: bool = False
                      ) -> Iterator[Dict[str, Any]]:
    """Stream one OCF file as `{field -> value list}` COLUMN chunks of
    up to `batch_records` records: block decode appends each field value
    straight into its column list — the per-record dict the row readers
    build (and the per-cell walk consuming it) never exists; feed each
    list to ONE vectorized conversion (readers.columnar_f32).

    The top-level schema must be a record (what write_avro_file and
    every reference DataReaders.Simple.avro flow produce). `fields`
    restricts OUTPUT to the named subset — the wire format is
    positional, so skipped fields still decode, they just never
    allocate per-record containers.

    `arrays=True`: where every field of the record is a float, double,
    boolean, int or long, each block decodes at once into numpy and the
    chunks hold numpy arrays (float32 / float64 / bool / int32 / int64)
    instead of lists; any other schema decodes as above."""
    d, schema, codec, sync, named = _open_ocf(path)
    flat = _flat_record_fields(schema, named) if arrays else None
    if flat is not None:
        yield from _flat_columns(d, codec, sync, flat, fields,
                                 batch_records)
        return
    schema = _resolve(schema, named)
    if not (isinstance(schema, dict) and schema.get("type") == "record"):
        raise AvroDecodeError(
            f"{path}: columnar decode needs a top-level record schema, "
            f"got {schema!r}")
    fspecs = [(f["name"], f["type"]) for f in schema["fields"]]
    keep = set(fields) if fields is not None else None
    out_names = [nm for nm, _ in fspecs if keep is None or nm in keep]
    cols: Dict[str, List[Any]] = {nm: [] for nm in out_names}
    n_buf = 0
    for count, bd in _iter_ocf_blocks(d, codec, sync):
        for _ in range(count):
            for nm, ftype in fspecs:
                v = _decode(ftype, bd, named)
                if keep is None or nm in keep:
                    cols[nm].append(v)
            n_buf += 1
            if n_buf >= batch_records:
                yield cols
                cols = {nm: [] for nm in out_names}
                n_buf = 0
    if n_buf:
        yield cols


def _flat_columns(d: _Bin, codec: str, sync: bytes,
                  flat: List[Tuple[str, str]],
                  fields: Optional[Sequence[str]], batch_records: int
                  ) -> Iterator[Dict[str, np.ndarray]]:
    """`read_avro_columns(arrays=True)` over flat records: each block
    decodes into numpy columns (`_flat_block`), and chunks of
    `batch_records` rows are sliced off them (blocks are joined where a
    chunk spans two)."""
    segs = _segments(flat)
    names = [nm for nm, _ in flat if fields is None or nm in fields]
    pend: List[Dict[str, np.ndarray]] = []
    n_pend = 0

    def joined() -> Dict[str, np.ndarray]:
        return pend[0] if len(pend) == 1 else {
            nm: np.concatenate([p[nm] for p in pend]) for nm in names}

    for count, bd in _iter_ocf_blocks(d, codec, sync):
        pend.append(_flat_block(bd.buf, count, segs, names))
        n_pend += count
        while n_pend >= batch_records:
            cols = joined()
            yield {nm: c[:batch_records] for nm, c in cols.items()}
            n_pend -= batch_records
            pend = [{nm: c[batch_records:] for nm, c in cols.items()}] \
                if n_pend else []
    if n_pend:
        yield joined()


from .readers import Reader


class AvroReader(Reader):
    """Reader over one or more Avro container files (reference
    DataReaders.Simple.avro, AvroReaders.scala)."""

    def __init__(self, paths, key_fn: Optional[Callable[[Any], str]] = None):
        super().__init__(key_fn)
        self.paths = [paths] if isinstance(paths, str) else list(paths)

    def read(self) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for p in self.paths:
            out.extend(read_avro_file(p))
        return out


# -- writer (for test fixtures + score export) ------------------------------

def _zigzag(n: int) -> bytes:
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    return bytes(out)


def _encode(schema: Any, v: Any, out: bytearray) -> None:
    if isinstance(schema, list):  # union: null | T
        if v is None:
            out += _zigzag(schema.index("null"))
            return
        idx = next(i for i, s in enumerate(schema) if s != "null")
        out += _zigzag(idx)
        _encode(schema[idx], v, out)
        return
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                _encode(f["type"], v.get(f["name"]), out)
            return
        if t == "array":
            if v:
                out += _zigzag(len(v))
                for item in v:
                    _encode(schema["items"], item, out)
            out += _zigzag(0)
            return
        if t == "map":
            if v:
                out += _zigzag(len(v))
                for k, item in v.items():
                    _encode("string", k, out)
                    _encode(schema["values"], item, out)
            out += _zigzag(0)
            return
        _encode(t, v, out)
        return
    if schema == "null":
        return
    if schema == "boolean":
        out += b"\x01" if v else b"\x00"
    elif schema in ("int", "long"):
        out += _zigzag(int(v))
    elif schema == "float":
        out += struct.pack("<f", float(v))
    elif schema == "double":
        out += struct.pack("<d", float(v))
    elif schema == "string":
        b = str(v).encode("utf-8")
        out += _zigzag(len(b)) + b
    elif schema == "bytes":
        out += _zigzag(len(v)) + bytes(v)
    else:
        raise AvroDecodeError(f"unsupported write schema {schema!r}")


def _write_ocf(path: str, schema: Dict[str, Any], codec: str,
               blocks: Sequence[Tuple[int, bytes]]) -> None:
    """One OCF file: the header, then each (record count, encoded
    records) block under `codec`."""
    if codec not in ("null", "deflate"):
        # an unknown codec would be STAMPED into the container header
        # over an uncompressed payload — unreadable far from the cause
        raise ValueError(f"unsupported Avro codec {codec!r} "
                         f"(null | deflate)")
    sync = b"\x00\x01\x02\x03\x04\x05\x06\x07\x08\x09\x0a\x0b\x0c\x0d\x0e\x0f"
    out = bytearray()
    out += _MAGIC
    meta = {"avro.schema": json.dumps(schema).encode(),
            "avro.codec": codec.encode()}
    out += _zigzag(len(meta))
    for k, v in meta.items():
        kb = k.encode()
        out += _zigzag(len(kb)) + kb + _zigzag(len(v)) + v
    out += _zigzag(0)
    out += sync
    for count, payload in blocks:
        if codec == "deflate":
            comp = zlib.compressobj(wbits=-15)
            payload = comp.compress(payload) + comp.flush()
        out += _zigzag(count) + _zigzag(len(payload)) + payload + sync
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_avro_file(path: str, schema: Dict[str, Any],
                    records: List[Dict[str, Any]],
                    codec: str = "null") -> None:
    block = bytearray()
    for r in records:
        _encode(schema, r, block)
    _write_ocf(path, schema, codec, [(len(records), bytes(block))])


def _encode_flat_block(columns: Dict[str, Any], segs: List[Any],
                       lo: int, hi: int) -> bytes:
    """Records [lo, hi) of flat columns in Avro's binary encoding."""
    n = hi - lo
    parts, lens = [], np.zeros(n, np.int64)
    for s in segs:
        if isinstance(s, np.dtype):
            rows = np.empty(n, s)
            for nm in s.names:
                rows[nm] = np.asarray(columns[nm])[lo:hi]
            if len(segs) == 1:
                return rows.tobytes()
            parts.append((rows.view(np.uint8).reshape(n, s.itemsize), None))
            lens += s.itemsize
            continue
        v = np.asarray(columns[s[0]])[lo:hi].astype(np.int64)
        u = ((v << 1) ^ (v >> 63)).view(np.uint64)
        high = np.stack([u >> np.uint64(7 * j)
                         for j in range(_VARINT_MAX)], 1)
        k = 1 + (high[:, 1:] != 0).sum(1)       # 7-bit groups a value
        groups = (high & np.uint64(0x7F)).astype(np.uint8)
        groups[np.arange(_VARINT_MAX) < k[:, None] - 1] |= 0x80
        parts.append((groups, k))
        lens += k
    out = np.empty(int(lens.sum()), np.uint8)
    off = np.cumsum(lens) - lens
    for mat, k in parts:
        for j in range(mat.shape[1]):
            sel = slice(None) if k is None else k > j
            out[off[sel] + j] = mat[sel, j]
        off = off + (mat.shape[1] if k is None else k)
    return out.tobytes()


def write_avro_columns(path: str, schema: Dict[str, Any],
                       columns: Dict[str, Any], codec: str = "null",
                       block_records: Optional[int] = None) -> int:
    """Write a record schema whose every field is a float, double,
    boolean, int or long from whole columns (`columns[name]`: one array a
    field, equal lengths) without a per-record encode: each block is
    encoded at once in numpy. The bytes equal `write_avro_file`'s for the
    same rows when one block holds them all (`block_records` None).
    Returns the record count."""
    named: Dict[str, Any] = {}
    _collect_named(schema, named)
    flat = _flat_record_fields(schema, named)
    if flat is None:
        raise ValueError("write_avro_columns takes a record schema of "
                         "float, double, boolean, int and long fields "
                         "only")
    segs = _segments(flat)
    n = len(next(iter(columns.values()))) if columns else 0
    step = int(block_records) if block_records else max(n, 1)
    blocks = [(min(step, n - s), _encode_flat_block(columns, segs, s,
                                                    min(s + step, n)))
              for s in range(0, n, step)] if n else [(0, b"")]
    _write_ocf(path, schema, codec, blocks)
    return n


def infer_avro_schema(rows: List[Dict[str, Any]],
                      name: str = "Record") -> Dict[str, Any]:
    """Infer a nullable Avro record schema from python rows (reference
    utils/io/CSVToAvro + CSVAutoReaders schema inference): bool -> boolean,
    64-bit int -> long, float -> double, everything else -> string
    (including out-of-range ints, which a "long" varint would silently
    wrap); a column with any missing value becomes a [null, T] union.
    Names are sanitized to the Avro name grammar
    ([A-Za-z_][A-Za-z0-9_]*) so spec-compliant readers accept the file;
    the original column names stay as the field order's source keys via
    csv_to_avro's mapping."""
    keys: List[str] = []
    for r in rows:
        for k in r:
            if k not in keys:
                keys.append(k)
    lo, hi = -(1 << 63), (1 << 63) - 1
    fields = []
    used = set()
    for k in keys:
        vals = [r.get(k) for r in rows]
        present = [v for v in vals if v is not None]
        nullable = len(present) < len(vals)
        if present and all(isinstance(v, bool) for v in present):
            t = "boolean"
        elif present and all(
                isinstance(v, bool)
                or (isinstance(v, int) and lo <= v <= hi)
                for v in present):
            t = "long"
        elif present and all(isinstance(v, (bool, float))
                             or (isinstance(v, int) and lo <= v <= hi)
                             for v in present):
            t = "double"
        else:
            t = "string"
        fields.append({"name": _dedup_name(avro_name(k), used),
                       "type": ["null", t] if nullable or not present
                       else t})
    return {"type": "record", "name": avro_name(name), "fields": fields}


def _dedup_name(base: str, used: set) -> str:
    """Distinct sanitized names: 'a-b' and 'a_b' both map to 'a_b', which
    would be a spec-invalid duplicate field AND silently collapse a
    column — suffix collisions instead."""
    out = base
    i = 2
    while out in used:
        out = f"{base}_{i}"
        i += 1
    used.add(out)
    return out


def avro_name(raw: str) -> str:
    """Sanitize to the Avro name grammar [A-Za-z_][A-Za-z0-9_]*
    (ASCII only — unicode alphanumerics are rejected by spec readers)."""
    out = "".join(c if ("a" <= c <= "z" or "A" <= c <= "Z"
                        or "0" <= c <= "9" or c == "_") else "_"
                  for c in raw)
    if not out or "0" <= out[0] <= "9":
        out = "_" + out
    return out


def csv_to_avro(csv_path: str, avro_path: str,
                schema: Optional[Dict[str, Any]] = None,
                codec: str = "null") -> Dict[str, Any]:
    """Convert a CSV file to Avro (reference utils/io/CSVToAvro): read
    with the CSV reader's type coercion, infer a nullable record schema
    unless one is given, write with the container codec. Returns the
    schema used."""
    from .readers import CSVReader

    rows = CSVReader(csv_path).read()
    headers: List[str] = []
    if rows:
        for r in rows:
            for k in r:
                if k not in headers:
                    headers.append(k)
    else:
        # header-only CSV: the header still declares the columns
        # (reference CSVToAvro derives the schema from the header)
        import csv as _csv
        with open(csv_path, newline="") as f:
            first = next(_csv.reader(f), [])
        headers = [h for h in first if h]
    if schema is None:
        base = os.path.splitext(os.path.basename(csv_path))[0]
        if rows:
            schema = infer_avro_schema(rows, name=base.title())
        else:
            used: set = set()
            schema = {"type": "record", "name": avro_name(base.title()),
                      "fields": [{"name": _dedup_name(avro_name(h), used),
                                  "type": ["null", "string"]}
                                 for h in headers]}
    # Avro field name -> original CSV column. Resolve by NAME (direct
    # header match, then unique sanitized match); fall back to position
    # only for the leftovers — a caller-supplied schema may order fields
    # differently from the CSV, where a pure positional zip would swap
    # columns.
    by_sanitized: Dict[str, List[str]] = {}
    for h in headers:
        by_sanitized.setdefault(avro_name(h), []).append(h)
    key_of: Dict[str, str] = {}
    unresolved = []
    taken = set()
    for f in schema["fields"]:
        fn = f["name"]
        if fn in headers:
            key_of[fn] = fn
            taken.add(fn)
        elif len(by_sanitized.get(fn, [])) == 1:
            key_of[fn] = by_sanitized[fn][0]
            taken.add(key_of[fn])
        else:
            unresolved.append(fn)
    leftovers = [h for h in headers if h not in taken]
    for fn, h in zip(unresolved, leftovers):
        key_of[fn] = h
    types = {f["name"]: f["type"] for f in schema["fields"]}

    def norm(fname, v):
        t = types.get(fname)
        t = [x for x in t if x != "null"][0] if isinstance(t, list) else t
        if v is None:
            return None
        if t == "string" and not isinstance(v, str):
            return str(v)
        if t == "double" and isinstance(v, (int, bool)):
            return float(v)
        if t == "long" and isinstance(v, float) and float(v).is_integer():
            return int(v)
        return v

    records = [{fn: norm(fn, r.get(key_of.get(fn, fn))) for fn in types}
               for r in rows]
    write_avro_file(avro_path, schema, records, codec=codec)
    return schema
