"""Log record encoding of KV ops — a copy of
``nebula_tpu/kvstore/log_encoder.py:7-112``: each committed write is a
self-describing op (``LogOp``) that ``Part`` applies to its engine and
hands, decoded, to its committed-batch listeners.  The membership ops
keep their codes and decode, though the single-replica port never
writes them.
"""
from __future__ import annotations

import enum
from typing import List, Tuple

from ..codec.rows import read_uvarint, write_uvarint

KV = Tuple[bytes, bytes]


class LogOp(enum.IntEnum):
    OP_PUT = 1
    OP_MULTI_PUT = 2
    OP_REMOVE = 3
    OP_MULTI_REMOVE = 4
    OP_REMOVE_PREFIX = 5
    OP_REMOVE_RANGE = 6
    OP_ADD_LEARNER = 7
    OP_TRANS_LEADER = 8
    OP_ADD_PEER = 9
    OP_REMOVE_PEER = 10
    OP_MERGE = 11


def _write_blob(buf: bytearray, b: bytes) -> None:
    write_uvarint(buf, len(b))
    buf += b


def _read_blob(data: bytes, pos: int) -> Tuple[bytes, int]:
    n, pos = read_uvarint(data, pos)
    return data[pos:pos + n], pos + n


def encode_single(op: LogOp, key: bytes, value: bytes = b"") -> bytes:
    buf = bytearray([op])
    _write_blob(buf, key)
    if op in (LogOp.OP_PUT, LogOp.OP_MERGE):
        _write_blob(buf, value)
    return bytes(buf)


def encode_multi(op: LogOp, items) -> bytes:
    """items: List[KV] for OP_MULTI_PUT, List[bytes] for OP_MULTI_REMOVE,
    (start, end) for OP_REMOVE_RANGE."""
    buf = bytearray([op])
    if op == LogOp.OP_MULTI_PUT:
        write_uvarint(buf, len(items))
        for k, v in items:
            _write_blob(buf, k)
            _write_blob(buf, v)
    elif op == LogOp.OP_MULTI_REMOVE:
        write_uvarint(buf, len(items))
        for k in items:
            _write_blob(buf, k)
    elif op == LogOp.OP_REMOVE_RANGE:
        start, end = items
        _write_blob(buf, start)
        _write_blob(buf, end)
    else:
        raise ValueError(op)
    return bytes(buf)


def decode(data: bytes):
    """-> (LogOp, payload) where payload matches the encoder's shape."""
    op = LogOp(data[0])
    pos = 1
    if op in (LogOp.OP_PUT, LogOp.OP_MERGE):
        key, pos = _read_blob(data, pos)
        value, pos = _read_blob(data, pos)
        return op, (key, value)
    if op in (LogOp.OP_REMOVE, LogOp.OP_REMOVE_PREFIX):
        key, pos = _read_blob(data, pos)
        return op, key
    if op == LogOp.OP_MULTI_PUT:
        n, pos = read_uvarint(data, pos)
        kvs: List[KV] = []
        for _ in range(n):
            k, pos = _read_blob(data, pos)
            v, pos = _read_blob(data, pos)
            kvs.append((k, v))
        return op, kvs
    if op == LogOp.OP_MULTI_REMOVE:
        n, pos = read_uvarint(data, pos)
        keys = []
        for _ in range(n):
            k, pos = _read_blob(data, pos)
            keys.append(k)
        return op, keys
    if op == LogOp.OP_REMOVE_RANGE:
        start, pos = _read_blob(data, pos)
        end, pos = _read_blob(data, pos)
        return op, (start, end)
    if op in (LogOp.OP_ADD_LEARNER, LogOp.OP_TRANS_LEADER, LogOp.OP_ADD_PEER,
              LogOp.OP_REMOVE_PEER):
        host, pos = _read_blob(data, pos)
        return op, host.decode()
    raise ValueError(f"bad log record op {op}")
