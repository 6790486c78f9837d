"""``NebulaStore`` — space -> partitions -> engine, the part of
``nebula_tpu/kvstore/store.py:33-200, :213-415`` the write path needs:
single-replica parts over one ``MemEngine`` per space, reads routed by
(space, part), writes through ``Part``, and the per-space committed
mutation version and typed delta log the mirror absorbs from.

Each part's committed-batch listener (``add_part``) bumps the space's
``mutation_version`` and appends the batch's events to the delta log:
``("put", key, value)`` edge inserts and in-place updates,
``("vput", key, value)`` vertex-row writes, ``("del", identity32)``
whole-edge deletes, or None for a batch the stream cannot describe
(which forces a rebuild).  The log keeps ``store_delta_log_cap``
entries; a cursor older than that reads as truncated.

Not ported (``ROADMAP.md``): raft replication, the WAL, the disk
engine, snapshot flush and ingest, compaction filters, and the part
manager's placement callbacks.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterator, List, Optional, Tuple

from ..common.flags import flags
from ..common.keys import KeyUtils
from ..common.status import ErrorCode, Status
from ..interface.common import GraphSpaceID, PartitionID
from .engine import KVEngine, MemEngine
from .log_encoder import LogOp
from .part import Part

KV = Tuple[bytes, bytes]


class SpaceData:
    def __init__(self):
        self.engines: List[KVEngine] = []
        self.parts: Dict[PartitionID, Part] = {}


class NebulaStore:
    def __init__(self):
        self.spaces: Dict[GraphSpaceID, SpaceData] = {}
        # per-space committed-write counter, bumped by each part's
        # committed-batch listener (after the batch hit the engine)
        self.mutation_versions: Dict[GraphSpaceID, int] = {}
        # per-space delta log: one entry per version bump, a list of
        # typed events or None (opaque); bounded, trimming moves the base
        self.delta_logs: Dict[GraphSpaceID, List] = {}
        self.delta_bases: Dict[GraphSpaceID, int] = {}
        self.delta_cap = int(flags.get("store_delta_log_cap") or 4096)
        self._version_lock = threading.Lock()

    def _bump(self, space_id: GraphSpaceID, delta=None) -> None:
        with self._version_lock:
            self.mutation_versions[space_id] = \
                self.mutation_versions.get(space_id, 0) + 1
            log = self.delta_logs.setdefault(space_id, [])
            log.append(delta)
            if len(log) > self.delta_cap:
                drop = len(log) - self.delta_cap
                del log[:drop]
                self.delta_bases[space_id] = \
                    self.delta_bases.get(space_id, 0) + drop

    def mutation_version(self, space_id: GraphSpaceID) -> int:
        with self._version_lock:
            return self.mutation_versions.get(space_id, 0)

    def delta_since(self, space_id: GraphSpaceID, from_version: int):
        """Typed events of every mutation after ``from_version``, or None
        when that range is trimmed or holds an opaque entry."""
        events, _reason, _ver = self.delta_window(space_id, from_version)
        return events

    def delta_window(self, space_id: GraphSpaceID, from_version: int,
                     upto: Optional[int] = None):
        """``(events | None, reason, version)`` for versions in
        ``(from_version, upto]``; reason is ``ok``, ``truncated`` (the
        log trimmed past the cursor), ``opaque`` (an entry the stream
        cannot describe) or ``ahead`` (a cursor past this store's
        version).  One lock acquisition samples all three."""
        with self._version_lock:
            cur = self.mutation_versions.get(space_id, 0)
            end = cur if upto is None else min(int(upto), cur)
            if from_version > cur:
                return None, "ahead", cur
            base = self.delta_bases.get(space_id, 0)
            log = self.delta_logs.get(space_id, [])
            if from_version < base:
                return None, "truncated", end
            out = []
            for entry in log[from_version - base:end - base]:
                if entry is None:
                    return None, "opaque", end
                out.extend(entry)
            return out, "ok", end

    # a remove_prefix whose prefix is a FULL edge identity
    # (part+src+etype+rank+dst, no version) deletes all versions of one
    # edge — DeleteProcessor.delete_edges' shape
    _EDGE_IDENT_LEN = 32

    @staticmethod
    def _classify_commit(decoded):
        """Committed batch -> typed events, or None (opaque)."""
        if decoded is None:
            return None
        events: List = []
        for op, payload in decoded:
            if op in (LogOp.OP_PUT, LogOp.OP_MULTI_PUT):
                items = [payload] if op == LogOp.OP_PUT else payload
                for key, value in items:
                    if key.startswith(b"__system"):
                        continue
                    if KeyUtils.is_edge(key):
                        events.append(("put", key, value))
                    elif KeyUtils.is_vertex(key):
                        events.append(("vput", key, value))
                    else:
                        return None    # unknown key shape: opaque
            elif op == LogOp.OP_REMOVE_PREFIX:
                if len(payload) != NebulaStore._EDGE_IDENT_LEN:
                    return None    # vertex-level / partial: opaque
                events.append(("del", payload))
            elif op in (LogOp.OP_ADD_LEARNER, LogOp.OP_TRANS_LEADER,
                        LogOp.OP_ADD_PEER, LogOp.OP_REMOVE_PEER):
                continue           # membership: no data change
            else:
                return None        # point and range removes: opaque
        return events

    # ---- placement ---------------------------------------------------
    def add_space(self, space_id: GraphSpaceID) -> None:
        if space_id in self.spaces:
            return
        sd = SpaceData()
        sd.engines.append(MemEngine())
        self.spaces[space_id] = sd

    def add_part(self, space_id: GraphSpaceID,
                 part_id: PartitionID) -> None:
        self.add_space(space_id)
        sd = self.spaces[space_id]
        if part_id in sd.parts:
            return
        engine = sd.engines[len(sd.parts) % len(sd.engines)]
        part = Part(space_id, part_id, engine)
        # committed-batch listener: advance the space's version only
        # once the batch hit the engine, recording its typed events
        part.listeners.append(
            lambda _p, decoded, _sid=space_id: self._bump(
                _sid, self._classify_commit(decoded)))
        sd.parts[part_id] = part

    # ---- lookup ------------------------------------------------------
    def part(self, space_id: GraphSpaceID,
             part_id: PartitionID) -> Optional[Part]:
        sd = self.spaces.get(space_id)
        return sd.parts.get(part_id) if sd else None

    def _check(self, space_id, part_id) -> Tuple[Optional[Part], Status]:
        sd = self.spaces.get(space_id)
        if sd is None:
            return None, Status.SpaceNotFound(f"space {space_id}")
        p = sd.parts.get(part_id)
        if p is None:
            return None, Status.Error(f"part {part_id} not here",
                                      ErrorCode.E_PART_NOT_FOUND)
        return p, Status.OK()

    def part_ids(self, space_id: GraphSpaceID) -> List[PartitionID]:
        sd = self.spaces.get(space_id)
        return sorted(sd.parts) if sd else []

    # ---- reads -------------------------------------------------------
    def get(self, space_id, part_id, key: bytes):
        p, st = self._check(space_id, part_id)
        if not st.ok():
            return None, st
        return p.engine.get(key), Status.OK()

    def prefix(self, space_id, part_id, prefix: bytes) -> Iterator[KV]:
        p, st = self._check(space_id, part_id)
        if not st.ok():
            return iter(())
        return p.engine.prefix(prefix)

    def range(self, space_id, part_id, start: bytes,
              end: bytes) -> Iterator[KV]:
        p, st = self._check(space_id, part_id)
        if not st.ok():
            return iter(())
        return p.engine.range(start, end)

    # ---- writes (through Part) ---------------------------------------
    def multi_put(self, space_id, part_id, kvs: List[KV]) -> Status:
        p, st = self._check(space_id, part_id)
        return p.multi_put(kvs) if st.ok() else st

    def put(self, space_id, part_id, key: bytes, value: bytes) -> Status:
        p, st = self._check(space_id, part_id)
        return p.put(key, value) if st.ok() else st

    def remove(self, space_id, part_id, key: bytes) -> Status:
        p, st = self._check(space_id, part_id)
        return p.remove(key) if st.ok() else st

    def multi_remove(self, space_id, part_id, keys: List[bytes]) -> Status:
        p, st = self._check(space_id, part_id)
        return p.multi_remove(keys) if st.ok() else st

    def remove_prefix(self, space_id, part_id, prefix: bytes) -> Status:
        p, st = self._check(space_id, part_id)
        return p.remove_prefix(prefix) if st.ok() else st

    def remove_range(self, space_id, part_id, start: bytes,
                     end: bytes) -> Status:
        p, st = self._check(space_id, part_id)
        return p.remove_range(start, end) if st.ok() else st
