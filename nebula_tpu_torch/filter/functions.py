"""FunctionManager — built-in scalar functions, a copy of
``nebula_tpu/filter/functions.py``.

Capability parity with Nebula's common/filter/FunctionManager.cpp:
abs/floor/ceil/round/sqrt/cbrt/hypot/pow/exp/exp2/log/log10/log2, trig
(sin/asin/cos/acos/tan/atan), rand32/rand64, now, hash, strcasecmp.
Arity-checked at prepare time like the reference (min/max args).
"""
from __future__ import annotations

import math
import random
import time
from typing import Callable, Dict, List, Tuple


def _hash(v) -> int:
    """Deterministic 64-bit hash (MurmurHash-like finalizer over the
    string form — stable across processes, unlike Python's hash())."""
    if isinstance(v, bool):
        data = b"\x01" if v else b"\x00"
    elif isinstance(v, (int, float)):
        data = repr(v).encode()
    else:
        data = str(v).encode()
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    # signed int64
    return h - (1 << 64) if h >= (1 << 63) else h


_FUNCS: Dict[str, Tuple[int, int, Callable]] = {
    # name: (min_arity, max_arity, fn)
    "abs": (1, 1, lambda a: abs(a)),
    "floor": (1, 1, lambda a: math.floor(a)),
    "ceil": (1, 1, lambda a: math.ceil(a)),
    "round": (1, 1, lambda a: float(round(a))),
    "sqrt": (1, 1, lambda a: math.sqrt(a)),
    "cbrt": (1, 1, lambda a: math.copysign(abs(a) ** (1.0 / 3.0), a)),
    "hypot": (2, 2, lambda a, b: math.hypot(a, b)),
    "pow": (2, 2, lambda a, b: a ** b),
    "exp": (1, 1, lambda a: math.exp(a)),
    "exp2": (1, 1, lambda a: 2.0 ** a),
    "log": (1, 1, lambda a: math.log(a)),
    "log2": (1, 1, lambda a: math.log2(a)),
    "log10": (1, 1, lambda a: math.log10(a)),
    "sin": (1, 1, lambda a: math.sin(a)),
    "asin": (1, 1, lambda a: math.asin(a)),
    "cos": (1, 1, lambda a: math.cos(a)),
    "acos": (1, 1, lambda a: math.acos(a)),
    "tan": (1, 1, lambda a: math.tan(a)),
    "atan": (1, 1, lambda a: math.atan(a)),
    "rand32": (0, 2, lambda *a: _rand32(*a)),
    "rand64": (0, 2, lambda *a: _rand64(*a)),
    "now": (0, 0, lambda: int(time.time())),
    "hash": (1, 1, _hash),
    "strcasecmp": (2, 2, lambda a, b: _strcasecmp(a, b)),
    "length": (1, 1, lambda a: len(a)),
    "lower": (1, 1, lambda a: str(a).lower()),
    "upper": (1, 1, lambda a: str(a).upper()),
}


def _rand32(*args) -> int:
    if len(args) == 0:
        return random.randint(-(1 << 31), (1 << 31) - 1)
    if len(args) == 1:
        return random.randrange(args[0])
    return random.randrange(args[0], args[1])


def _rand64(*args) -> int:
    if len(args) == 0:
        return random.randint(-(1 << 63), (1 << 63) - 1)
    return _rand32(*args)


def _strcasecmp(a, b) -> int:
    x, y = str(a).lower(), str(b).lower()
    return 0 if x == y else (-1 if x < y else 1)


class FunctionManager:
    @staticmethod
    def get(name: str, arity: int) -> Callable:
        """Resolve + arity-check (raises ExprError on failure)."""
        from .expressions import ExprError
        rec = _FUNCS.get(name.lower())
        if rec is None:
            raise ExprError(f"unknown function {name}()")
        lo, hi, fn = rec
        if not lo <= arity <= hi:
            raise ExprError(f"{name}() expects {lo}..{hi} args, got {arity}")
        return fn

    @staticmethod
    def exists(name: str) -> bool:
        return name.lower() in _FUNCS

    @staticmethod
    def names() -> List[str]:
        return sorted(_FUNCS)
