"""Status / StatusOr / ErrorCode — the subset of
``nebula_tpu/common/status.py`` the port's store, parts and schema
lookups return, with the reference's names and code values.
"""
from __future__ import annotations

import enum
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class ErrorCode(enum.IntEnum):
    """The reference's unified error space, the codes the port returns."""

    SUCCEEDED = 0
    E_INTERNAL_ERROR = -10
    E_PART_NOT_FOUND = -101
    E_SPACE_NOT_FOUND = -102
    E_SCHEMA_NOT_FOUND = -207


class Status:
    """Cheap ok/error value. ``Status.OK()`` is a shared singleton."""

    __slots__ = ("code", "msg")

    _OK: Optional["Status"] = None

    def __init__(self, code: ErrorCode = ErrorCode.SUCCEEDED, msg: str = ""):
        self.code = code
        self.msg = msg

    @classmethod
    def OK(cls) -> "Status":
        if cls._OK is None:
            cls._OK = cls()
        return cls._OK

    @classmethod
    def Error(cls, msg: str,
              code: ErrorCode = ErrorCode.E_INTERNAL_ERROR) -> "Status":
        return cls(code, msg)

    @classmethod
    def SpaceNotFound(cls, msg: str = "space not found") -> "Status":
        return cls(ErrorCode.E_SPACE_NOT_FOUND, msg)

    def ok(self) -> bool:
        return self.code == ErrorCode.SUCCEEDED

    def __bool__(self) -> bool:
        return self.ok()

    def __repr__(self) -> str:
        if self.ok():
            return "Status::OK"
        return f"Status({self.code.name}: {self.msg})"

    def to_string(self) -> str:
        return "OK" if self.ok() else f"{self.code.name}: {self.msg}"


class StatusOr(Generic[T]):
    """Either a value or an error Status."""

    __slots__ = ("_status", "_value")

    @classmethod
    def of(cls, value: T) -> "StatusOr[T]":
        s = cls.__new__(cls)
        s._status = Status.OK()
        s._value = value
        return s

    @classmethod
    def error(cls, status: Status) -> "StatusOr[T]":
        s = cls.__new__(cls)
        s._status = status
        s._value = None
        return s

    def ok(self) -> bool:
        return self._status.ok()

    @property
    def status(self) -> Status:
        return self._status

    def value(self) -> T:
        if not self._status.ok():
            raise RuntimeError(f"value() on error StatusOr: {self._status}")
        return self._value
