"""One partition's state machine over the engine — the single-replica
``Part`` of ``nebula_tpu/kvstore/part.py:31-246``.

Each write is encoded as a log record (``log_encoder``), applied to the
engine in log order (consecutive puts and removes coalesce into engine
batches; an order-sensitive boundary flushes first), and then handed,
decoded, to the committed-batch ``listeners`` — the seam the store's
mutation version and delta log hang on, so the mirror only ever sees
writes that reached the engine.  No raft, no WAL, no snapshot transfer
and no commit watermark yet (``ROADMAP.md``); a lock serializes the
part's writes, so its listeners see them in the order the engine
applied them.
"""
from __future__ import annotations

import threading
from typing import Callable, List, Tuple

from ..common.status import Status
from .engine import KVEngine
from .log_encoder import LogOp, decode, encode_multi, encode_single

KV = Tuple[bytes, bytes]


class Part:
    def __init__(self, space_id: int, part_id: int, engine: KVEngine):
        self.space_id = space_id
        self.part_id = part_id
        self.engine = engine
        # committed-batch listeners: fn(part, [(LogOp, payload)])
        self.listeners: List[Callable] = []
        self._lock = threading.Lock()

    # ---- write api (the storage processors call these) ---------------
    def put(self, key: bytes, value: bytes) -> Status:
        return self._submit(encode_single(LogOp.OP_PUT, key, value))

    def multi_put(self, kvs: List[KV]) -> Status:
        return self._submit(encode_multi(LogOp.OP_MULTI_PUT, kvs))

    def remove(self, key: bytes) -> Status:
        return self._submit(encode_single(LogOp.OP_REMOVE, key))

    def multi_remove(self, keys: List[bytes]) -> Status:
        return self._submit(encode_multi(LogOp.OP_MULTI_REMOVE, keys))

    def remove_prefix(self, prefix: bytes) -> Status:
        return self._submit(encode_single(LogOp.OP_REMOVE_PREFIX, prefix))

    def remove_range(self, start: bytes, end: bytes) -> Status:
        return self._submit(encode_multi(LogOp.OP_REMOVE_RANGE,
                                         (start, end)))

    def _submit(self, log: bytes) -> Status:
        with self._lock:
            return self._apply([log])

    def is_leader(self) -> bool:
        return True

    # ---- log application ---------------------------------------------
    def _apply(self, logs: List[bytes]) -> Status:
        """Apply log records in order; on success tell the listeners."""
        decoded = []
        batch_put: List[KV] = []
        batch_del: List[bytes] = []
        failed: List[Status] = []

        def check(st: Status) -> None:
            if not st.ok():
                failed.append(st)

        def flush():
            if batch_del:
                check(self.engine.multi_remove(batch_del))
                batch_del.clear()
            if batch_put:
                check(self.engine.multi_put(batch_put))
                batch_put.clear()

        for msg in logs:
            op, payload = decode(msg)
            decoded.append((op, payload))
            if op == LogOp.OP_PUT:
                if batch_del:
                    flush()
                batch_put.append(payload)
            elif op == LogOp.OP_MULTI_PUT:
                if batch_del:
                    flush()
                batch_put.extend(payload)
            elif op == LogOp.OP_REMOVE:
                if batch_put:
                    flush()
                batch_del.append(payload)
            elif op == LogOp.OP_MULTI_REMOVE:
                if batch_put:
                    flush()
                batch_del.extend(payload)
            elif op == LogOp.OP_REMOVE_PREFIX:
                flush()
                check(self.engine.remove_prefix(payload))
            elif op == LogOp.OP_REMOVE_RANGE:
                flush()
                check(self.engine.remove_range(*payload))
        flush()
        if failed:
            return failed[0]
        for listener in self.listeners:
            listener(self, decoded)
        return Status.OK()
