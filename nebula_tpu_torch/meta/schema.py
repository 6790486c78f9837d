"""``SchemaView`` — a space's tag and edge names for a mirror handed over
ready-made (``TorchQueryRuntime.load_space``).

It is an ``AdHocSchemaManager`` (``meta/schema_manager.py``) filled with
names and no versioned schemas, so the port keeps one registry type:
a store-backed runtime resolves names through its schema manager, a
loaded space through its ``SchemaView``, and both answer the same
lookups (``to_tag_id`` / ``to_edge_type`` with a ``StatusOr``,
``edge_name``, ``all_edge_types``).
"""
from __future__ import annotations

from typing import Mapping

from .schema_manager import AdHocSchemaManager


class SchemaView(AdHocSchemaManager):
    """Tag and edge names per space.  ``add_space(space_id, tags,
    edges)`` takes ``{name: id}`` maps (edge types positive)."""

    def add_space(self, space_id: int, tags: Mapping[str, int],
                  edges: Mapping[str, int]) -> "SchemaView":
        for name, tid in tags.items():
            self.tag_names[(space_id, str(name))] = int(tid)
        for name, et in edges.items():
            self.edge_names[(space_id, str(name))] = int(et)
        return self
