"""Shared schema types — a copy of ``nebula_tpu/interface/common.py``
``:22-106``: the id typedefs, ``SupportedType`` (the property columns'
types), and ``ColumnDef`` / ``SchemaProp`` / ``Schema`` (a versioned
tag or edge schema with its TTL, which the row codec and the mirror
fold read)."""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

GraphSpaceID = int
PartitionID = int
SchemaVer = int


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


PropValue = Union[bool, int, float, str]


@dataclass
class ColumnDef:
    name: str
    type: SupportedType
    default: Optional[PropValue] = None


@dataclass
class SchemaProp:
    """TTL properties (common.thrift:59-66)."""
    ttl_duration: Optional[int] = None
    ttl_col: Optional[str] = None


@dataclass
class Schema:
    """A versioned tag/edge schema (common.thrift:68-72), with field
    lookup by name and index for the row codec."""
    columns: List[ColumnDef] = field(default_factory=list)
    schema_prop: SchemaProp = field(default_factory=SchemaProp)
    version: SchemaVer = 0

    def __post_init__(self):
        self._index: Dict[str, int] = {c.name: i
                                       for i, c in enumerate(self.columns)}

    def num_fields(self) -> int:
        return len(self.columns)

    def field_index(self, name: str) -> int:
        return self._index.get(name, -1)

    def field_name(self, i: int) -> str:
        return self.columns[i].name

    def field_type(self, i: int) -> SupportedType:
        return self.columns[i].type

    def get_field(self, name: str) -> Optional[ColumnDef]:
        i = self.field_index(name)
        return self.columns[i] if i >= 0 else None

    def names(self) -> List[str]:
        return [c.name for c in self.columns]
