"""``SupportedType`` — a copy of ``nebula_tpu/interface/common.py:32-50``,
the subset the property columns need (common.thrift:22-43)."""
from __future__ import annotations

import enum


class SupportedType(enum.IntEnum):
    """common.thrift:22-43 (subset actually used by the reference)."""
    UNKNOWN = 0
    BOOL = 1
    INT = 2
    VID = 3
    FLOAT = 4
    DOUBLE = 5
    STRING = 6
    TIMESTAMP = 21

    def to_dtype(self) -> str:
        """Device column dtype for the prop store (strings dict-encoded)."""
        return {
            SupportedType.BOOL: "bool",
            SupportedType.INT: "int64",
            SupportedType.VID: "int64",
            SupportedType.TIMESTAMP: "int64",
            SupportedType.FLOAT: "float32",
            SupportedType.DOUBLE: "float32",
            SupportedType.STRING: "int32",  # dictionary code
        }[self]
