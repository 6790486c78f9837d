"""The msgpack subset that encoded expression trees use, read and
written without the ``msgpack`` package.

``to_wire`` trees hold lists, None, bools, ints, floats and strings.
``packb`` writes them byte for byte as ``msgpack.packb(obj,
use_bin_type=True)`` does: the smallest int form (positive values in
the unsigned forms), float64 for every float, str8/16/32 by length,
fixarray/array16/array32.  ``unpackb`` reads those forms and also
maps, bins and float32, as ``msgpack.unpackb(data, raw=False)`` would
return them; any other type byte, a truncated buffer, bytes left over
or invalid UTF-8 raise ``ValueError``.
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple


def packb(obj: Any) -> bytes:
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(int(obj)))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(bytes((0xA0 | n,)))
        elif n < 0x100:
            out.append(b"\xd9" + bytes((n,)))
        elif n < 0x10000:
            out.append(b"\xda" + struct.pack(">H", n))
        elif n < 0x100000000:
            out.append(b"\xdb" + struct.pack(">I", n))
        else:
            raise ValueError("string too large")
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes((0x90 | n,)))
        elif n < 0x10000:
            out.append(b"\xdc" + struct.pack(">H", n))
        elif n < 0x100000000:
            out.append(b"\xdd" + struct.pack(">I", n))
        else:
            raise ValueError("list too large")
        for item in obj:
            _pack(item, out)
    else:
        raise TypeError(f"cannot serialize {obj!r}")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -0x20 <= v < 0:
        return struct.pack("b", v)
    if 0x80 <= v <= 0xFF:
        return b"\xcc" + struct.pack(">B", v)
    if -0x80 <= v < 0:
        return b"\xd0" + struct.pack(">b", v)
    if 0xFF < v <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", v)
    if -0x8000 <= v < -0x80:
        return b"\xd1" + struct.pack(">h", v)
    if 0xFFFF < v <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", v)
    if -0x80000000 <= v < -0x8000:
        return b"\xd2" + struct.pack(">i", v)
    if 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", v)
    if -0x8000000000000000 <= v < -0x80000000:
        return b"\xd3" + struct.pack(">q", v)
    raise OverflowError("Integer value out of range")


# fixed-width forms: type byte -> struct format
_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}


def unpackb(data: bytes) -> Any:
    data = bytes(data)
    obj, pos = _unpack(data, 0, 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} extra bytes after the object")
    return obj


def _take(data: bytes, pos: int, n: int) -> Tuple[bytes, int]:
    if pos + n > len(data):
        raise ValueError("incomplete input")
    return data[pos:pos + n], pos + n


def _unpack(data: bytes, pos: int, depth: int) -> Tuple[Any, int]:
    if depth > 512:
        raise ValueError("nesting too deep")
    head, pos = _take(data, pos, 1)
    b = head[0]
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        return _str(data, pos, b & 0x1F)
    if 0x90 <= b <= 0x9F:
        return _array(data, pos, b & 0x0F, depth)
    if 0x80 <= b <= 0x8F:
        return _map(data, pos, b & 0x0F, depth)
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b in _FIXED:
        fmt = _FIXED[b]
        raw, pos = _take(data, pos, struct.calcsize(fmt))
        return struct.unpack(fmt, raw)[0], pos
    if b in (0xD9, 0xDA, 0xDB, 0xC4, 0xC5, 0xC6, 0xDC, 0xDD, 0xDE, 0xDF):
        fmt = {0xD9: ">B", 0xC4: ">B", 0xDA: ">H", 0xC5: ">H", 0xDC: ">H",
               0xDE: ">H"}.get(b, ">I")
        raw, pos = _take(data, pos, struct.calcsize(fmt))
        n = struct.unpack(fmt, raw)[0]
        if b in (0xD9, 0xDA, 0xDB):
            return _str(data, pos, n)
        if b in (0xC4, 0xC5, 0xC6):
            return _take(data, pos, n)
        if b in (0xDC, 0xDD):
            return _array(data, pos, n, depth)
        return _map(data, pos, n, depth)
    raise ValueError(f"unsupported type byte 0x{b:02x}")


def _str(data: bytes, pos: int, n: int) -> Tuple[str, int]:
    raw, pos = _take(data, pos, n)
    return raw.decode("utf-8"), pos


def _array(data: bytes, pos: int, n: int, depth: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, pos = _unpack(data, pos, depth + 1)
        out.append(item)
    return out, pos


def _map(data: bytes, pos: int, n: int, depth: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(data, pos, depth + 1)
        v, pos = _unpack(data, pos, depth + 1)
        out[k] = v
    return out, pos
