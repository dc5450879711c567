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


def read_avro_columns(path: str, *,
                      fields: Optional[Sequence[str]] = None,
                      batch_records: int = 8192
                      ) -> Iterator[Dict[str, List[Any]]]:
    """Stream one OCF file as `{field -> value list}` COLUMN chunks of
    up to `batch_records` records: block decode appends each field value
    straight into its column list — the per-record dict the row readers
    build (and the per-cell walk consuming it) never exists; feed each
    list to ONE vectorized conversion (readers.columnar_f32).

    The top-level schema must be a record (what write_avro_file and
    every reference DataReaders.Simple.avro flow produce). `fields`
    restricts OUTPUT to the named subset — the wire format is
    positional, so skipped fields still decode, they just never
    allocate per-record containers."""
    d, schema, codec, sync, named = _open_ocf(path)
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


def write_avro_file(path: str, schema: Dict[str, Any],
                    records: List[Dict[str, Any]],
                    codec: str = "null") -> None:
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
    block = bytearray()
    for r in records:
        _encode(schema, r, block)
    payload = bytes(block)
    if codec == "deflate":
        comp = zlib.compressobj(wbits=-15)
        payload = comp.compress(payload) + comp.flush()
    out += _zigzag(len(records)) + _zigzag(len(payload)) + payload + sync
    with open(path, "wb") as f:
        f.write(bytes(out))


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
