"""Schema resolution — ``SchemaManager`` and ``AdHocSchemaManager``
from ``nebula_tpu/meta/schema_manager.py:16-43, :77-140``.

The manager is the port's one registry of a space's tags and edges:
versioned schemas for the row codec and the mirror fold, and the names
the expression compiler resolves.  ``meta/schema.SchemaView`` is an
``AdHocSchemaManager`` that a caller fills with names alone, for a
space whose mirror it hands over ready-made (``load_space``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..common.status import ErrorCode, Status, StatusOr
from ..interface.common import Schema


class SchemaManager:
    """Interface."""

    def get_tag_schema(self, space_id: int, tag_id: int,
                       ver: int = -1) -> Optional[Schema]:
        raise NotImplementedError

    def get_edge_schema(self, space_id: int, etype: int,
                        ver: int = -1) -> Optional[Schema]:
        raise NotImplementedError

    def to_tag_id(self, space_id: int, name: str) -> StatusOr[int]:
        raise NotImplementedError

    def to_edge_type(self, space_id: int, name: str) -> StatusOr[int]:
        raise NotImplementedError

    def tag_name(self, space_id: int, tag_id: int) -> Optional[str]:
        raise NotImplementedError

    def edge_name(self, space_id: int, etype: int) -> Optional[str]:
        raise NotImplementedError

    def all_edge_types(self, space_id: int) -> List[int]:
        raise NotImplementedError

    def all_tag_ids(self, space_id: int) -> List[int]:
        raise NotImplementedError


class AdHocSchemaManager(SchemaManager):
    """Schemas injected directly (no meta service)."""

    def __init__(self):
        self.tags: Dict[Tuple[int, int, int], Schema] = {}
        self.edges: Dict[Tuple[int, int, int], Schema] = {}
        self.tag_names: Dict[Tuple[int, str], int] = {}
        self.edge_names: Dict[Tuple[int, str], int] = {}
        self.newest_tag: Dict[Tuple[int, int], int] = {}
        self.newest_edge: Dict[Tuple[int, int], int] = {}

    def add_tag_schema(self, space_id: int, tag_id: int, name: str,
                       schema: Schema) -> None:
        self.tags[(space_id, tag_id, schema.version)] = schema
        self.tag_names[(space_id, name)] = tag_id
        cur = self.newest_tag.get((space_id, tag_id), -1)
        self.newest_tag[(space_id, tag_id)] = max(cur, schema.version)

    def add_edge_schema(self, space_id: int, etype: int, name: str,
                        schema: Schema) -> None:
        self.edges[(space_id, etype, schema.version)] = schema
        self.edge_names[(space_id, name)] = etype
        cur = self.newest_edge.get((space_id, etype), -1)
        self.newest_edge[(space_id, etype)] = max(cur, schema.version)

    def get_tag_schema(self, space_id, tag_id, ver=-1):
        if ver < 0:
            ver = self.newest_tag.get((space_id, tag_id), -1)
        return self.tags.get((space_id, tag_id, ver))

    def get_edge_schema(self, space_id, etype, ver=-1):
        if ver < 0:
            ver = self.newest_edge.get((space_id, etype), -1)
        return self.edges.get((space_id, etype, ver))

    def to_tag_id(self, space_id, name):
        tid = self.tag_names.get((space_id, name))
        if tid is None:
            return StatusOr.error(Status(ErrorCode.E_SCHEMA_NOT_FOUND,
                                         f"tag {name}"))
        return StatusOr.of(tid)

    def to_edge_type(self, space_id, name):
        et = self.edge_names.get((space_id, name))
        if et is None:
            return StatusOr.error(Status(ErrorCode.E_SCHEMA_NOT_FOUND,
                                         f"edge {name}"))
        return StatusOr.of(et)

    def tag_name(self, space_id, tag_id):
        for (sid, name), tid in self.tag_names.items():
            if sid == space_id and tid == tag_id:
                return name
        return None

    def edge_name(self, space_id, etype):
        for (sid, name), et in self.edge_names.items():
            if sid == space_id and et == etype:
                return name
        return None

    def all_edge_types(self, space_id):
        return sorted({et for (sid, _n), et in self.edge_names.items()
                       if sid == space_id})

    def all_tag_ids(self, space_id):
        return sorted({t for (sid, _n), t in self.tag_names.items()
                       if sid == space_id})
