"""The byte-ordered storage engine — ``KVEngine`` and ``MemEngine`` from
``nebula_tpu/kvstore/engine.py:34-140`` (point and batched writes,
prefix and range scans, range deletes), without the snapshot files:
the port's store is in memory and single-replica.

Keys are order-preserving bytes (``common/keys.py``), so a prefix scan
of a part walks its edges in CSR order.  The sorted table is the
port's own (``kvstore/_sorted.py``).
"""
from __future__ import annotations

import threading
from typing import Iterator, List, Optional, Tuple

from ..common.status import Status
from ._sorted import SortedDict

KV = Tuple[bytes, bytes]


class KVEngine:
    """Abstract engine interface."""

    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def multi_get(self, keys: List[bytes]) -> List[Optional[bytes]]:
        return [self.get(k) for k in keys]

    def put(self, key: bytes, value: bytes) -> Status:
        raise NotImplementedError

    def multi_put(self, kvs: List[KV]) -> Status:
        raise NotImplementedError

    def remove(self, key: bytes) -> Status:
        raise NotImplementedError

    def multi_remove(self, keys: List[bytes]) -> Status:
        raise NotImplementedError

    def remove_prefix(self, prefix: bytes) -> Status:
        raise NotImplementedError

    def remove_range(self, start: bytes, end: bytes) -> Status:
        raise NotImplementedError

    def prefix(self, prefix: bytes) -> Iterator[KV]:
        raise NotImplementedError

    def range(self, start: bytes, end: bytes) -> Iterator[KV]:
        raise NotImplementedError

    def total_keys(self) -> int:
        raise NotImplementedError


class MemEngine(KVEngine):
    """Sorted in-memory engine.  Writes take a lock (the parts of a
    space share one engine, and the sorted table's insert is several
    steps); scans walk a snapshot of the key order and need none."""

    def __init__(self):
        self._table = SortedDict()
        self._lock = threading.Lock()

    # ---- reads ------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        return self._table.get(key)

    def prefix(self, prefix: bytes) -> Iterator[KV]:
        table = self._table
        for key in table.irange(minimum=prefix):
            if not key.startswith(prefix):
                break
            yield key, table[key]

    def range(self, start: bytes, end: bytes) -> Iterator[KV]:
        table = self._table
        for key in table.irange(minimum=start, maximum=end,
                                inclusive=(True, False)):
            yield key, table[key]

    def total_keys(self) -> int:
        return len(self._table)

    # ---- writes -----------------------------------------------------
    def put(self, key: bytes, value: bytes) -> Status:
        with self._lock:
            self._table[key] = value
        return Status.OK()

    def multi_put(self, kvs: List[KV]) -> Status:
        with self._lock:
            self._table.update(kvs)
        return Status.OK()

    def remove(self, key: bytes) -> Status:
        with self._lock:
            self._table.pop(key, None)
        return Status.OK()

    def multi_remove(self, keys: List[bytes]) -> Status:
        with self._lock:
            for k in keys:
                self._table.pop(k, None)
        return Status.OK()

    def remove_prefix(self, prefix: bytes) -> Status:
        doomed = [k for k, _ in self.prefix(prefix)]
        return self.multi_remove(doomed)

    def remove_range(self, start: bytes, end: bytes) -> Status:
        doomed = [k for k, _ in self.range(start, end)]
        return self.multi_remove(doomed)
