"""Typed outcomes of the device path — copies of
``nebula_tpu/storage/device.py:39,67`` with the same names.

Every request the port's runtime does not serve raises ``TpuDecline``;
nothing falls through to another path in silence."""
from __future__ import annotations


class TpuDecline(Exception):
    """The device path cannot serve this query (the caller's CPU
    executor answers it).  ``degraded=True`` marks declines caused by
    a device runtime failure rather than a can't-serve; ``retriable``
    marks declines another replica might serve."""

    def __init__(self, msg: str = "", degraded: bool = False,
                 retriable: bool = False):
        super().__init__(msg)
        self.degraded = degraded
        self.host = None
        self.retriable = retriable


class DeviceExecError(Exception):
    """A real query error on the device path (maps to an error
    response, not to a CPU fallback)."""
