"""The write processors of ``nebula_tpu/storage/processors.py:747-823``:
``AddVerticesProcessor``, ``AddEdgesProcessor`` and
``DeleteProcessor.delete_edges`` over the port's store, taking the same
request dicts.

A write stamps every key of one request with one inverted version
(``common/clock.inverted_version``), so a newer write of an identity
sorts before the older versions it supersedes; a delete removes every
version of each named edge by its identity prefix.  As with the
reference, a caller that wants ``GO ... REVERSELY`` to see an edge
sends both directions (the reverse row under ``-etype``), the way the
insert and delete executors do (``graph/executors/mutate.py:111``,
``:247``, ``:335``).  The read processors are not ported.
"""
from __future__ import annotations

from ..common.clock import inverted_version
from ..common.keys import KeyUtils
from ..common.status import Status
from ..kvstore.store import NebulaStore
from ..meta.schema_manager import SchemaManager


class StorageWriteError(Exception):
    """A store write failed (the reference raises its RpcError)."""

    def __init__(self, status: Status):
        super().__init__(status.to_string())
        self.status = status


class _Processor:
    def __init__(self, kv: NebulaStore, schema_man: SchemaManager):
        self.kv = kv
        self.schema_man = schema_man

    def _put(self, space_id: int, part: int, batch) -> None:
        if batch:
            st = self.kv.multi_put(space_id, part, batch)
            if not st.ok():
                raise StorageWriteError(st)


class AddVerticesProcessor(_Processor):
    """req: {space_id, parts: {part: [{id, tags: [[tag_id, row_bytes]]}]}}"""

    def process(self, req: dict) -> dict:
        space_id = int(req["space_id"])
        version = inverted_version()
        for part_s, vertices in req["parts"].items():
            part = int(part_s)
            self._put(space_id, part, [
                (KeyUtils.vertex_key(part, int(v["id"]), int(tag_id),
                                     version), row)
                for v in vertices for tag_id, row in v["tags"]])
        return {}


class AddEdgesProcessor(_Processor):
    """req: {space_id, parts: {part: [{src, etype, rank, dst, props}]}}"""

    def process(self, req: dict) -> dict:
        space_id = int(req["space_id"])
        version = inverted_version()
        for part_s, edges in req["parts"].items():
            part = int(part_s)
            self._put(space_id, part, [
                (KeyUtils.edge_key(part, int(e["src"]), int(e["etype"]),
                                   int(e.get("rank", 0)), int(e["dst"]),
                                   version), e["props"])
                for e in edges])
        return {}


class DeleteProcessor(_Processor):
    """deleteEdges: every version of each named edge."""

    def delete_edges(self, req: dict) -> dict:
        """req: {space_id, parts: {part: [[src, etype, rank, dst]]}}"""
        space_id = int(req["space_id"])
        for part_s, keys in req["parts"].items():
            part = int(part_s)
            for src, etype, rank, dst in keys:
                prefix = KeyUtils.edge_prefix(part, int(src), int(etype),
                                              int(rank), int(dst))
                st = self.kv.remove_prefix(space_id, part, prefix)
                if not st.ok():
                    raise StorageWriteError(st)
        return {}
