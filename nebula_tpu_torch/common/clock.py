"""Wall-clock helpers — the part of ``nebula_tpu/common/clock.py`` the
write path reads (``:35-48``): ``now_s`` for TTL expiry and
``inverted_version`` for the version field of a storage key (the latest
write of an identity sorts first).
"""
from __future__ import annotations

import time

INT64_MAX = (1 << 63) - 1


def now_s() -> float:
    return time.time()


def now_micros() -> int:
    """Wall clock in microseconds."""
    return time.time_ns() // 1000


def inverted_version(micros: int | None = None) -> int:
    """int64max - now_us: the latest version sorts first.  ``micros``
    pins the clock (a test writing byte-equal keys on two stores)."""
    return INT64_MAX - (now_micros() if micros is None else micros)
