"""Row codec — a copy of ``nebula_tpu/codec/rows.py:23-245``: the
varints, ``RowWriter`` / ``encode_row`` and ``RowReader`` (schema
version resolution through a callback, defaults for the fields a row
written under an older schema version lacks), byte for byte.

    row   := uvarint(schema_ver) | field*      (fields in schema order)
    field := BOOL: 1 byte | INT/VID/TIMESTAMP: zigzag varint
           | FLOAT: 4B LE | DOUBLE: 8B LE | STRING: uvarint len + utf8
"""
from __future__ import annotations

import struct
from typing import Callable, Dict, List, Optional, Tuple

from ..interface.common import ColumnDef, PropValue, Schema, SupportedType

_F32 = struct.Struct("<f")
_F64 = struct.Struct("<d")


# ---------------------------------------------------------------- varints
def write_uvarint(buf: bytearray, v: int) -> None:
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def read_uvarint(data: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        b = data[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _zigzag(v: int) -> int:
    return ((v << 1) ^ (v >> 63)) & 0xFFFFFFFFFFFFFFFF


def _unzigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _default_for(col: ColumnDef) -> PropValue:
    if col.default is not None:
        return col.default
    t = col.type
    if t == SupportedType.BOOL:
        return False
    if t == SupportedType.STRING:
        return ""
    if t in (SupportedType.FLOAT, SupportedType.DOUBLE):
        return 0.0
    return 0


# ---------------------------------------------------------------- writer
class RowWriter:
    """Encode one row against a Schema (reference RowWriter.h:23-60).

    Values may be set by name in any order; encode() walks schema order and
    fills unset fields with column defaults.
    """

    def __init__(self, schema: Schema):
        self.schema = schema
        self._values: Dict[str, PropValue] = {}

    def set(self, name: str, value: PropValue) -> "RowWriter":
        if self.schema.field_index(name) < 0:
            raise KeyError(f"unknown field {name!r}")
        self._values[name] = value
        return self

    def encode(self) -> bytes:
        return encode_row(self.schema, self._values)


def encode_row(schema: Schema, values: Dict[str, PropValue]) -> bytes:
    buf = bytearray()
    write_uvarint(buf, schema.version)
    for col in schema.columns:
        v = values.get(col.name)
        if v is None:
            v = _default_for(col)
        t = col.type
        if t == SupportedType.BOOL:
            buf.append(1 if v else 0)
        elif t in (SupportedType.INT, SupportedType.VID, SupportedType.TIMESTAMP):
            iv = int(v)
            if not -(1 << 63) <= iv < (1 << 63):
                raise OverflowError(f"{col.name}={iv} out of int64 range")
            write_uvarint(buf, _zigzag(iv))
        elif t == SupportedType.FLOAT:
            buf += _F32.pack(float(v))
        elif t == SupportedType.DOUBLE:
            buf += _F64.pack(float(v))
        elif t == SupportedType.STRING:
            if isinstance(v, str):
                raw = v.encode()
            elif isinstance(v, (bytes, bytearray)):
                raw = bytes(v)
            else:
                raise TypeError(f"{col.name}: STRING column got {type(v).__name__}")
            write_uvarint(buf, len(raw))
            buf += raw
        else:
            raise TypeError(f"unsupported type {t}")
    return bytes(buf)


# ---------------------------------------------------------------- reader
class RowReader:
    """Lazy field-offset-indexed decoder (reference RowReader.h:24-151).

    ``schema`` must be the schema version the row was written with (resolve
    via ``RowReader.from_resolver`` when multiple versions exist). Offsets
    are discovered incrementally and memoized, so reading only the first
    field of a wide row does not decode the rest.
    """

    def __init__(self, data: bytes, schema: Schema):
        self.data = data
        self.schema = schema
        ver, pos = read_uvarint(data, 0)
        self.row_version = ver
        self._offsets: List[int] = [pos]  # offset where field i starts

    @staticmethod
    def schema_version_of(data: bytes) -> int:
        ver, _ = read_uvarint(data, 0)
        return ver

    @classmethod
    def from_resolver(cls, data: bytes,
                      resolve: Callable[[int], Optional[Schema]]) -> "RowReader":
        """Resolve the row's embedded schema version via a callback
        (mirrors RowReader::getTagPropReader + SchemaManager)."""
        ver = cls.schema_version_of(data)
        schema = resolve(ver)
        if schema is None:
            raise KeyError(f"no schema for version {ver}")
        return cls(data, schema)

    # -- internal: advance the offset index up to field i -------------
    # Returns -1 when the row (written with an older schema version) ends
    # before field i — ALTER ADD appends columns, so older rows are strict
    # prefixes and missing fields read as column defaults.
    def _skip_to(self, i: int) -> int:
        data = self.data
        end = len(data)
        while len(self._offsets) <= i:
            if self._offsets[-1] >= end:
                return -1
            j = len(self._offsets) - 1
            pos = self._offsets[j]
            t = self.schema.field_type(j)
            if t == SupportedType.BOOL:
                pos += 1
            elif t in (SupportedType.INT, SupportedType.VID, SupportedType.TIMESTAMP):
                _, pos = read_uvarint(data, pos)
            elif t == SupportedType.FLOAT:
                pos += 4
            elif t == SupportedType.DOUBLE:
                pos += 8
            elif t == SupportedType.STRING:
                n, pos = read_uvarint(data, pos)
                pos += n
            else:
                raise TypeError(f"unsupported type {t}")
            self._offsets.append(pos)
        return self._offsets[i]

    def get_by_index(self, i: int) -> PropValue:
        if not 0 <= i < self.schema.num_fields():
            raise IndexError(i)
        pos = self._skip_to(i)
        if pos < 0 or pos >= len(self.data):
            # field added after this row was written
            return _default_for(self.schema.columns[i])
        data = self.data
        t = self.schema.field_type(i)
        if t == SupportedType.BOOL:
            return data[pos] != 0
        if t in (SupportedType.INT, SupportedType.VID, SupportedType.TIMESTAMP):
            v, _ = read_uvarint(data, pos)
            return _unzigzag(v)
        if t == SupportedType.FLOAT:
            return _F32.unpack_from(data, pos)[0]
        if t == SupportedType.DOUBLE:
            return _F64.unpack_from(data, pos)[0]
        if t == SupportedType.STRING:
            n, pos = read_uvarint(data, pos)
            return data[pos:pos + n].decode()
        raise TypeError(f"unsupported type {t}")

    def get(self, name: str, default: Optional[PropValue] = None) -> PropValue:
        i = self.schema.field_index(name)
        if i < 0:
            if default is not None:
                return default
            raise KeyError(name)
        return self.get_by_index(i)

    def to_dict(self) -> Dict[str, PropValue]:
        return {self.schema.field_name(i): self.get_by_index(i)
                for i in range(self.schema.num_fields())}

    def size(self) -> int:
        """Encoded byte length of this row (header + all fields)."""
        n = self.schema.num_fields()
        if not n:
            return self._offsets[0]
        pos = self._skip_to(n)
        return pos if pos >= 0 else len(self.data)


def decode_row(data: bytes, schema: Schema) -> Dict[str, PropValue]:
    return RowReader(data, schema).to_dict()
