"""Absorb outcome reasons — ``nebula_tpu/common/protocol.py:28-38``,
the same strings.  ``TorchQueryRuntime._absorb_once`` returns one of
them with every absorption attempt; the declines are counted
(``mirror_absorb_failed``, and ``mirror_delta_overflow`` for
``ABSORB_DELTA_OVERFLOW``) and kept as the runtime's
``last_absorb_reason``.
"""
from __future__ import annotations

# Why an absorption declined and the mirror is rebuilt from the store.
ABSORB_PART_MOVED = "part-moved"
ABSORB_PEER_SET_CHANGED = "peer-set-changed"
ABSORB_DELTA_OVERFLOW = "delta-overflow"
ABSORB_VERTEX_UNABSORBABLE = "vertex-write-unabsorbable"
ABSORB_OVERLAY_UNBUILDABLE = "overlay-unbuildable"
ABSORB_VERTEX_PLAN_CHANGE = "vertex-plan-change"
ABSORB_SLOT_OVERFLOW = "slot-overflow"
ABSORB_OPAQUE_EVENTS = "opaque-events"
# outcomes that are not declines
ABSORB_VERTEX_IN_PLACE = "vertex-in-place"
ABSORB_NO_OP = "no-op"
ABSORBED = "absorbed"
