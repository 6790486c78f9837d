"""Per-space schema names — the part of ``nebula_tpu/meta/schema_manager.py``
that the expression compiler and the GO planner read.

The port has no meta service yet: ``SchemaView`` holds each space's tag
and edge names as a caller hands them over (the tests carry them from
the JAX cluster's schema manager, ``chip_smoke.py`` names its own).  Its
lookups answer as the reference's ``SchemaManager`` does, with a
StatusOr-shaped result (``ok()`` / ``value()``).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional


class Lookup:
    """The reference's ``StatusOr`` for a name lookup: ``ok()`` and
    ``value()``, and the error text when not ok."""

    __slots__ = ("_value", "error")

    def __init__(self, value: Optional[int], error: str = ""):
        self._value = value
        self.error = error

    def ok(self) -> bool:
        return self._value is not None

    def value(self) -> int:
        if self._value is None:
            raise ValueError(self.error)
        return self._value


class SchemaView:
    """Tag and edge names per space.  ``add_space(space_id, tags,
    edges)`` takes ``{name: id}`` maps (edge types positive)."""

    def __init__(self):
        self._tags: Dict[int, Dict[str, int]] = {}
        self._edges: Dict[int, Dict[str, int]] = {}

    def add_space(self, space_id: int, tags: Mapping[str, int],
                  edges: Mapping[str, int]) -> "SchemaView":
        self._tags[space_id] = {str(k): int(v) for k, v in tags.items()}
        self._edges[space_id] = {str(k): int(v) for k, v in edges.items()}
        return self

    def to_tag_id(self, space_id: int, name: str) -> Lookup:
        tid = self._tags.get(space_id, {}).get(name)
        return Lookup(tid, f"tag {name}")

    def to_edge_type(self, space_id: int, name: str) -> Lookup:
        et = self._edges.get(space_id, {}).get(name)
        return Lookup(et, f"edge {name}")

    def edge_name(self, space_id: int, etype: int) -> Optional[str]:
        for name, et in self._edges.get(space_id, {}).items():
            if et == etype:
                return name
        return None

    def all_edge_types(self, space_id: int) -> List[int]:
        return sorted(set(self._edges.get(space_id, {}).values()))
