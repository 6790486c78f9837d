"""The device form of a compiled WHERE: ``ExprProgram``, a straight-line
program over typed registers that ``csrc/expr_filter.cu`` (the kernel)
and ``run_program`` (its plain PyTorch version) both execute, one edge
per thread / per tensor lane.

The reference evaluates the compiled ``CVal`` closures with ``jax.numpy``
inside a jitted XLA program (``runtime.py:2750-2790``).  The port runs
the SAME closures (``expr_compile.py``) over symbolic arrays (``Sym``)
and a symbolic array module (``SymXP``) that follow jax.numpy's rules,
recording every operation as a typed node.  What is implicit there is
explicit here:

- **Types.**  Device values are bool, int32 or float32.  A Python
  literal stays a Python value (arithmetic between literals runs in
  Python, as the reference's closures run it) until it meets an array;
  then it becomes a constant of the promoted type (bool < int32 <
  float32, jax's weak typing with 64-bit off).  A Python int outside
  int32 raises ``CompileError``, where jax raises ``OverflowError``.
- **jnp's expansions.**  ``//``, ``%``, ``fmod``, ``hypot`` and integer
  ``power`` expand into the lax operations jax emits (``floor_divide``'s
  sign/remainder select, ``remainder``'s sign fix, ``_pow_int_int``'s
  six unrolled rounds, ``integer_pow``'s squaring chain); ``floor``,
  ``ceil`` and ``round`` of an int are the int itself.
- **XLA's rewrites that change a float result.**  Constant subgraphs
  fold at lowering time (XLA's constant folding); ``A - C`` becomes
  ``A + (-C)``; constants move right in ``+`` and ``*``; ``(A + C1) +
  C2`` and ``(A * C1) * C2`` fold their constants; ``(C1 - A) + C2``
  becomes ``(C1 + C2) - A``; ``A / C`` becomes ``A * (1 / C)``;
  ``(A / B) / (C / D)``, ``(A / B) / C`` and ``A / (B / C)`` become
  ``(A * D) / (B * C)``, ``A / (B * C)`` and ``(A * C) / B``;
  ``A / sqrt(B)``, ``A / exp(B)`` and ``A / pow(B, C)`` become
  ``A * rsqrt(B)``, ``A * exp(-B)`` and ``A * pow(B, -C)``.  Identical subgraphs merge
  (XLA's CSE).  Then a float multiply used once by an add or subtract
  contracts into a fused multiply-add, the left operand first, as
  XLA's CPU code generator contracts it.
- **Denormals.**  XLA on the CPU flushes float32 denormals to zero on
  every operation's inputs and outputs; both executors do the same.
  XLA's constant folder does not flush, gives INT32_MIN for a float to
  int32 conversion out of range or of NaN, and +0 for the sign of a
  zero; the lowering folds constants the same way.
- **Integer edge cases** follow XLA: ``x / 0 = -1``, ``x % 0 = x``,
  ``INT32_MIN / -1 = INT32_MIN``, wrapping ``+ - * neg abs``; a float
  to int32 conversion truncates, saturates and maps NaN to 0.

Transcendental functions (exp, log, trig, pow, cbrt, rsqrt, and the
``atan2`` / ``exp2`` family) are the one place the two executors and
XLA may differ, by a few ULP: each uses its platform's function.

The program ends in one bool register: the WHERE mask (non-zero is
true for a numeric WHERE), ANDed with ``!guard`` for every div guard
and, in pushed mode, with each used column's validity.  Registers are
reused after their last read; a program needing more than
``MAX_REGS`` registers, ``MAX_INS`` instructions or ``MAX_SLOTS`` input
columns raises ``CompileError`` (the query then declines).
"""
from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .expr_compile import CompileError, Env

# ------------------------------------------------------------ encoding
B, I, F = 0, 1, 2                      # register types
DTYPES = {B: torch.bool, I: torch.int32, F: torch.float32}
TYPE_NAMES = {B: "bool", I: "int32", F: "float32"}
EDGE, VSRC, VDST = 0, 1, 2             # slot kinds: read at e, src[e], dst[e]
MAX_REGS = 32                          # csrc kMaxRegs
MAX_INS = 256                          # csrc kMaxIns
MAX_SLOTS = 16                         # csrc kMaxSlots
INT32_MIN, INT32_MAX = -2**31, 2**31 - 1
FLT_MIN = float(np.finfo(np.float32).tiny)

# opcode -> (result type, operand types); the order is the kernel's enum
_OPS = [
    ("LOAD", None, ()), ("CONST", None, ()),
    ("CVT_BI", I, (B,)), ("CVT_BF", F, (B,)), ("CVT_IF", F, (I,)),
    ("CVT_FI", I, (F,)),
    ("NEG_I", I, (I,)), ("ABS_I", I, (I,)), ("SIGN_I", I, (I,)),
    ("ADD_I", I, (I, I)), ("SUB_I", I, (I, I)), ("MUL_I", I, (I, I)),
    ("DIV_I", I, (I, I)), ("REM_I", I, (I, I)), ("MAX_I", I, (I, I)),
    ("XOR_I", I, (I, I)), ("AND_I", I, (I, I)), ("SHRL_I", I, (I, I)),
    ("NEG_F", F, (F,)), ("ABS_F", F, (F,)), ("SIGN_F", F, (F,)),
    ("ADD_F", F, (F, F)), ("SUB_F", F, (F, F)), ("MUL_F", F, (F, F)),
    ("DIV_F", F, (F, F)), ("REM_F", F, (F, F)), ("MAX_F", F, (F, F)),
    ("MIN_F", F, (F, F)),
    ("FMA", F, (F, F, F)), ("FMA_NP", F, (F, F, F)),
    ("FMA_NC", F, (F, F, F)), ("FMA_NPC", F, (F, F, F)),
    ("FLOOR", F, (F,)), ("CEIL", F, (F,)), ("RINT", F, (F,)),
    ("ROUND", F, (F,)), ("SQRT", F, (F,)), ("RSQRT", F, (F,)),
    ("CBRT", F, (F,)), ("EXP", F, (F,)), ("EXP2", F, (F,)),
    ("LOG", F, (F,)), ("SIN", F, (F,)), ("COS", F, (F,)),
    ("TAN", F, (F,)), ("ASIN", F, (F,)), ("ACOS", F, (F,)),
    ("ATAN", F, (F,)), ("POW", F, (F, F)), ("ATAN2", F, (F, F)),
    ("EQ_B", B, (B, B)), ("NE_B", B, (B, B)),
    ("LT_I", B, (I, I)), ("LE_I", B, (I, I)), ("GT_I", B, (I, I)),
    ("GE_I", B, (I, I)), ("EQ_I", B, (I, I)), ("NE_I", B, (I, I)),
    ("LT_F", B, (F, F)), ("LE_F", B, (F, F)), ("GT_F", B, (F, F)),
    ("GE_F", B, (F, F)), ("EQ_F", B, (F, F)), ("NE_F", B, (F, F)),
    ("NOT", B, (B,)), ("AND", B, (B, B)), ("OR", B, (B, B)),
    ("SEL_I", I, (B, I, I)), ("SEL_F", F, (B, F, F)),
]
OPCODE = {name: i for i, (name, _t, _a) in enumerate(_OPS)}
RESULT = {name: t for name, t, _a in _OPS}
ARGS = {name: a for name, _t, a in _OPS}
TRANSCENDENTAL = frozenset(("RSQRT", "CBRT", "EXP", "EXP2", "LOG", "SIN",
                            "COS", "TAN", "ASIN", "ACOS", "ATAN", "POW",
                            "ATAN2"))
_CMP = ("LT", "LE", "GT", "GE", "EQ", "NE")
_SUFFIX = {B: "B", I: "I", F: "F"}


def _bits(dtype: int, value) -> int:
    """A constant's 32-bit pattern as a signed int32."""
    if dtype == F:
        return struct.unpack("<i", struct.pack("<f", value))[0]
    if dtype == B:
        return int(bool(value))
    return int(value)


def _from_bits(dtype: int, bits: int):
    if dtype == F:
        return struct.unpack("<f", struct.pack("<i", bits))[0]
    if dtype == B:
        return bool(bits)
    return int(bits)


# ===================================================== plain executor
def _daz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 denormals to signed zero (XLA's CPU DAZ/FTZ)."""
    return torch.where(x.abs() < FLT_MIN, x * 0, x)


def _keep(x: torch.Tensor) -> torch.Tensor:
    return x


def _fma(flush, a, b, c, negp=False, negc=False):
    """round32(±a*b ± c) with one rounding: the product is exact in
    float64; where the float64 sum lies exactly halfway between two
    float32 values, the sign of its rounding error (TwoSum) picks the
    side the exact sum lies on."""
    a, b, c = flush(a), flush(b), flush(c)
    p = a.double() * b.double()
    if negp:
        p = -p
    cd = -c.double() if negc else c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    rd = r.double()
    inf = torch.full_like(r, math.inf)
    other = torch.nextafter(r, torch.where(rd < s, inf, -inf))
    tie = (rd + other.double()) * 0.5 == s
    fix = tie & (((err > 0) & (rd < s)) | ((err < 0) & (rd > s)))
    r = torch.where(fix & torch.isfinite(s), other, r)
    return flush(r)


def _i64(x):
    return x.to(torch.int64)


def _wrap(x64: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 keeping the low 32 bits (two's complement wrap)."""
    x64 = x64 & 0xFFFFFFFF
    return torch.where(x64 >= 2**31, x64 - 2**32, x64).to(torch.int32)


def _div_i(a, b):
    safe = torch.where(b == 0, torch.ones_like(b), b)
    q = torch.div(_i64(a), _i64(safe), rounding_mode="trunc")
    q = torch.where(b == 0, torch.full_like(q, -1), q)
    return _wrap(q)


def _rem_i(a, b):
    safe = torch.where(b == 0, torch.ones_like(b), b)
    r = torch.fmod(_i64(a), _i64(safe))
    return _wrap(torch.where(b == 0, _i64(a), r))


def _shrl(a, b):
    u = _i64(a) & 0xFFFFFFFF
    ok = (b >= 0) & (b < 32)
    sh = torch.where(ok, b, torch.zeros_like(b))
    return _wrap(torch.where(ok, u >> _i64(sh), torch.zeros_like(u)))


def _cvt_fi(a):
    """XLA's run-time float32 -> int32: truncate, saturate, NaN -> 0."""
    a = _daz(a).double()
    a = torch.where(torch.isnan(a), torch.zeros_like(a), a)
    return a.clamp(INT32_MIN, INT32_MAX).trunc().to(torch.int32)


def _cvt_fi_fold(a):
    """XLA's constant folder (the host's cvttss2si): NaN and values out
    of int32 give INT32_MIN."""
    d = a.double()
    bad = torch.isnan(d) | (d >= 2.0**31) | (d < -2.0**31)
    d = torch.where(bad, torch.full_like(d, INT32_MIN), d.trunc())
    return d.to(torch.int32)


def _sign_f(flush):
    def sign(a):
        a = flush(a)
        keep = torch.isnan(a) | (a == 0)
        return torch.where(keep, a, torch.copysign(torch.ones_like(a), a))
    return sign


def _sign_f_fold(a):
    """The constant folder's sign: NaN stays, a zero of either sign is
    +0."""
    keep = torch.isnan(a)
    return torch.where(keep, a, torch.sign(a) + 0.0)


def _minmax(pick):
    def mm(a, b):
        nan = torch.isnan(a) | torch.isnan(b)
        return torch.where(nan, torch.full_like(a, math.nan),
                           torch.where(pick(a, b), a, b))
    return mm


def _round_away(a):
    t = torch.trunc(a)
    return torch.where((a - t).abs() >= 0.5, t + torch.sign(a), t)


def _cbrt(a):
    d = a.double()
    return (torch.sign(d) * d.abs().pow(1.0 / 3.0)).float()


def _build_exec(flush) -> Dict[str, object]:
    """The operations on tensors.  ``flush`` is ``_daz`` for the run-time
    semantics (XLA's CPU flushes denormals on every float operation's
    inputs and outputs) and ``_keep`` for the constant folder's."""
    def f1(fn):
        return lambda a: flush(fn(flush(a)))

    def f2(fn):
        return lambda a, b: flush(fn(flush(a), flush(b)))

    def cmp(fn):
        return lambda a, b: fn(flush(a), flush(b))

    ex = {
        "CVT_BI": lambda a: a.to(torch.int32),
        "CVT_BF": lambda a: a.to(torch.float32),
        "CVT_IF": lambda a: a.to(torch.float32),
        "CVT_FI": _cvt_fi,
        "NEG_I": lambda a: _wrap(-_i64(a)),
        "ABS_I": lambda a: _wrap(_i64(a).abs()),
        "SIGN_I": torch.sign,
        "ADD_I": lambda a, b: _wrap(_i64(a) + _i64(b)),
        "SUB_I": lambda a, b: _wrap(_i64(a) - _i64(b)),
        "MUL_I": lambda a, b: _wrap(_i64(a) * _i64(b)),
        "DIV_I": _div_i, "REM_I": _rem_i,
        "MAX_I": torch.maximum,
        "XOR_I": torch.bitwise_xor, "AND_I": torch.bitwise_and,
        "SHRL_I": _shrl,
        "NEG_F": lambda a: -a, "ABS_F": torch.abs,
        "SIGN_F": _sign_f(flush),
        "ADD_F": f2(torch.add), "SUB_F": f2(torch.sub),
        "MUL_F": f2(torch.mul), "DIV_F": f2(torch.div),
        "REM_F": f2(torch.fmod),
        "MAX_F": f2(_minmax(torch.gt)), "MIN_F": f2(_minmax(torch.lt)),
        "FMA": lambda a, b, c: _fma(flush, a, b, c),
        "FMA_NP": lambda a, b, c: _fma(flush, a, b, c, negp=True),
        "FMA_NC": lambda a, b, c: _fma(flush, a, b, c, negc=True),
        "FMA_NPC": lambda a, b, c: _fma(flush, a, b, c, negp=True,
                                        negc=True),
        "FLOOR": f1(torch.floor), "CEIL": f1(torch.ceil),
        "RINT": f1(torch.round), "ROUND": f1(_round_away),
        "SQRT": f1(torch.sqrt), "RSQRT": f1(torch.rsqrt),
        "CBRT": f1(_cbrt), "EXP": f1(torch.exp), "EXP2": f1(torch.exp2),
        "LOG": f1(torch.log), "SIN": f1(torch.sin), "COS": f1(torch.cos),
        "TAN": f1(torch.tan), "ASIN": f1(torch.asin),
        "ACOS": f1(torch.acos), "ATAN": f1(torch.atan),
        "POW": f2(torch.pow), "ATAN2": f2(torch.atan2),
        "NOT": torch.logical_not, "AND": torch.logical_and,
        "OR": torch.logical_or, "SEL_I": torch.where, "SEL_F": torch.where,
        "EQ_B": torch.eq, "NE_B": torch.ne,
    }
    for t in (I, F):
        for c, fn in zip(_CMP, (torch.lt, torch.le, torch.gt, torch.ge,
                                torch.eq, torch.ne)):
            ex[f"{c}_{_SUFFIX[t]}"] = cmp(fn) if t == F else fn
    assert set(ex) | {"LOAD", "CONST"} == set(OPCODE)
    return ex


_EXEC = _build_exec(_daz)
_FOLD = _build_exec(_keep)
_FOLD.update({"CVT_FI": _cvt_fi_fold, "SIGN_F": _sign_f_fold})


def exec_op(name: str, *args: torch.Tensor) -> torch.Tensor:
    """One operation of the program on tensors (the plain semantics
    the kernel reproduces)."""
    return _EXEC[name](*args)


# ============================================================ the DAG
class _Node:
    __slots__ = ("op", "dtype", "args", "imm")

    def __init__(self, op: str, dtype: int, args: Tuple[int, ...], imm):
        self.op = op
        self.dtype = dtype
        self.args = args
        self.imm = imm          # CONST: the value; LOAD: the slot index


class _Graph:
    """Hash-consed typed DAG: identical nodes merge (XLA's CSE), all-
    constant nodes fold, and the value-changing rewrites of XLA's
    algebraic simplifier apply as nodes are made (post-order)."""

    def __init__(self):
        self.nodes: List[_Node] = []
        self._index: Dict[tuple, int] = {}

    # ---- construction
    def _intern(self, op: str, dtype: int, args: Tuple[int, ...], imm
                ) -> int:
        key = (op, dtype, args,
               _bits(dtype, imm) if op == "CONST" else imm)
        got = self._index.get(key)
        if got is None:
            got = self._index[key] = len(self.nodes)
            self.nodes.append(_Node(op, dtype, args, imm))
        return got

    def const(self, dtype: int, value) -> int:
        if dtype == F:
            value = float(np.float32(value))
        elif dtype == I:
            value = int(value)
            if not INT32_MIN <= value <= INT32_MAX:
                raise CompileError(f"integer constant {value} does not "
                                   f"fit int32")
        else:
            value = bool(value)
        return self._intern("CONST", dtype, (), value)

    def load(self, slot: int, dtype: int) -> int:
        return self._intern("LOAD", dtype, (), slot)

    def is_const(self, i: int) -> bool:
        return self.nodes[i].op == "CONST"

    def cval(self, i: int):
        return self.nodes[i].imm

    def op(self, name: str, *args: int) -> int:
        want = ARGS[name]
        for a, t in zip(args, want):
            if self.nodes[a].dtype != t:
                raise AssertionError(f"{name}: operand {TYPE_NAMES[self.nodes[a].dtype]}, "
                                     f"expected {TYPE_NAMES[t]}")
        dtype = RESULT[name]
        if all(self.is_const(a) for a in args):
            ts = [torch.tensor([self.cval(a)], dtype=DTYPES[self.nodes[a].dtype])
                  for a in args]
            out = _FOLD[name](*ts)
            return self.const(dtype, out.item())
        got = self._rewrite(name, args)
        if got is not None:
            return got
        return self._intern(name, dtype, tuple(args), None)

    def _rewrite(self, name: str, args: Tuple[int, ...]) -> Optional[int]:
        n = self.nodes
        if name in ("ADD_F", "MUL_F", "ADD_I", "MUL_I") \
                and self.is_const(args[0]) and not self.is_const(args[1]):
            return self.op(name, args[1], args[0])        # constant right
        if name == "SUB_F" and self.is_const(args[1]):
            return self.op("ADD_F", args[0],
                           self.const(F, -self.cval(args[1])))
        if name == "ADD_F" and self.is_const(args[1]):
            a = n[args[0]]
            if a.op == "ADD_F" and self.is_const(a.args[1]):
                return self.op("ADD_F", a.args[0],
                               self.op("ADD_F", a.args[1], args[1]))
            if a.op == "SUB_F" and self.is_const(a.args[0]):
                return self.op("SUB_F",
                               self.op("ADD_F", a.args[0], args[1]),
                               a.args[1])
        if name == "MUL_F" and self.is_const(args[1]):
            a = n[args[0]]
            if a.op == "MUL_F" and self.is_const(a.args[1]):
                return self.op("MUL_F", a.args[0],
                               self.op("MUL_F", a.args[1], args[1]))
        if name == "DIV_F":
            a, b = n[args[0]], n[args[1]]
            if b.op == "EXP":
                return self.op("MUL_F", args[0], self.op(
                    "EXP", self.op("NEG_F", b.args[0])))
            if b.op == "POW":
                return self.op("MUL_F", args[0], self.op(
                    "POW", b.args[0], self.op("NEG_F", b.args[1])))
            if b.op == "SQRT":
                return self.op("MUL_F", args[0],
                               self.op("RSQRT", b.args[0]))
            if self.is_const(args[1]):
                return self.op("MUL_F", args[0],
                               self.op("DIV_F", self.const(F, 1.0),
                                       args[1]))
            if a.op == "DIV_F" and b.op == "DIV_F":
                return self.op("DIV_F",
                               self.op("MUL_F", a.args[0], b.args[1]),
                               self.op("MUL_F", a.args[1], b.args[0]))
            if a.op == "DIV_F":
                return self.op("DIV_F", a.args[0],
                               self.op("MUL_F", a.args[1], args[1]))
            if b.op == "DIV_F":
                return self.op("DIV_F",
                               self.op("MUL_F", args[0], b.args[1]),
                               b.args[0])
        return None


# ==================================================== symbolic arrays
class Sym:
    """A traced device value: a node of the graph with its dtype."""

    __slots__ = ("g", "i")

    def __init__(self, g: _Graph, i: int):
        self.g = g
        self.i = i

    @property
    def t(self) -> int:
        return self.g.nodes[self.i].dtype

    def __bool__(self):
        raise CompileError("a data-dependent Python branch")

    __hash__ = object.__hash__

    def astype(self, dtype) -> "Sym":
        return _convert(self, _type_of_name(dtype))

    # arithmetic (jnp's dunder methods)
    def __add__(self, o): return _arith("ADD", self, o)
    def __radd__(self, o): return _arith("ADD", o, self)
    def __sub__(self, o): return _arith("SUB", self, o)
    def __rsub__(self, o): return _arith("SUB", o, self)
    def __mul__(self, o): return _arith("MUL", self, o)
    def __rmul__(self, o): return _arith("MUL", o, self)
    def __truediv__(self, o): return _truediv(self, o)
    def __rtruediv__(self, o): return _truediv(o, self)
    def __floordiv__(self, o): return _floordiv(self, o)
    def __rfloordiv__(self, o): return _floordiv(o, self)
    def __mod__(self, o): return _remainder(self, o)
    def __rmod__(self, o): return _remainder(o, self)
    def __xor__(self, o): return _xor(self, o)
    def __rxor__(self, o): return _xor(o, self)
    def __neg__(self): return _neg(self)
    def __abs__(self): return _abs(self)

    # comparisons
    def __lt__(self, o): return _compare("LT", self, o)
    def __le__(self, o): return _compare("LE", self, o)
    def __gt__(self, o): return _compare("GT", self, o)
    def __ge__(self, o): return _compare("GE", self, o)
    def __eq__(self, o): return _compare("EQ", self, o)
    def __ne__(self, o): return _compare("NE", self, o)


def _type_of_name(dtype) -> int:
    name = np.dtype(dtype).name
    if name == "bool":
        return B
    if name == "int32":
        return I
    if name == "float32":
        return F
    raise CompileError(f"no device type {name}")


def _op(name: str, *args: Sym) -> Sym:
    g = args[0].g
    return Sym(g, g.op(name, *[a.i for a in args]))


def _py_type(v) -> int:
    if isinstance(v, (bool, np.bool_)):
        return B
    if isinstance(v, (int, np.integer)):
        return I
    if isinstance(v, (float, np.floating)):
        return F
    raise CompileError(f"value {v!r} has no device type")


def _graph_of(*vals) -> _Graph:
    for v in vals:
        if isinstance(v, Sym):
            return v.g
    raise AssertionError("no symbolic operand")


def _lift(g: _Graph, v, dtype: Optional[int] = None) -> Sym:
    """A Python scalar as a constant (jax's weak-typed conversion): an
    int must fit int32 whatever it meets; then it takes ``dtype``."""
    if isinstance(v, Sym):
        return v if dtype is None else _convert(v, dtype)
    pt = _py_type(v)
    if pt == I and not INT32_MIN <= int(v) <= INT32_MAX:
        raise CompileError(f"Python int {int(v)} does not fit int32 "
                           f"(jax raises OverflowError)")
    base = Sym(g, g.const(pt, v))
    return base if dtype is None else _convert(base, dtype)


def _convert(s: Sym, dtype: int) -> Sym:
    if s.t == dtype:
        return s
    name = {(B, I): "CVT_BI", (B, F): "CVT_BF", (I, F): "CVT_IF",
            (F, I): "CVT_FI"}.get((s.t, dtype))
    if name is None:
        raise CompileError(f"no conversion of {TYPE_NAMES[s.t]} to "
                           f"{TYPE_NAMES[dtype]}")
    return _op(name, s)


def _promote(*vals, floor: int = B) -> Tuple[List[Sym], int]:
    g = _graph_of(*vals)
    t = floor
    for v in vals:
        t = max(t, v.t if isinstance(v, Sym) else _py_type(v))
    return [_lift(g, v, t) for v in vals], t


def _arith(kind: str, a, b) -> Sym:
    (x, y), t = _promote(a, b)
    if t == B:
        raise CompileError(f"{kind} on bools")
    return _op(f"{kind}_{_SUFFIX[t]}", x, y)


def _truediv(a, b) -> Sym:
    (x, y), _t = _promote(a, b, floor=F)
    return _op("DIV_F", x, y)


def _floordiv(a, b) -> Sym:
    """jnp.floor_divide: the int select of a truncating quotient, or
    the float divmod of CPython's floatobject.c."""
    (x, y), t = _promote(a, b, floor=I)
    if t == I:
        q = _op("DIV_I", x, y)
        sel = _op("AND", _op("NE_I", _op("SIGN_I", x), _op("SIGN_I", y)),
                  _op("NE_I", _op("REM_I", x, y), _lift(x.g, 0, I)))
        return _op("SEL_I", sel, _arith("SUB", q, 1), q)
    return _float_divmod(x, y)[0]


def _float_divmod(x: Sym, y: Sym) -> Tuple[Sym, Sym]:
    g = x.g
    mod = _op("REM_F", x, y)
    div = _op("DIV_F", _op("SUB_F", x, mod), y)
    zero = _lift(g, 0.0, F)
    ind = _op("AND", _op("NE_F", mod, zero),
              _op("NE_F", _op("SIGN_F", y), _op("SIGN_F", mod)))
    mod = _op("SEL_F", ind, _op("ADD_F", mod, y), mod)
    div = _op("SEL_F", ind, _op("SUB_F", div, _lift(g, 1.0, F)), div)
    return _op("ROUND", div), mod


def _remainder(a, b) -> Sym:
    """jnp.remainder: the sign of the divisor."""
    (x, y), t = _promote(a, b, floor=I)
    g = x.g
    sfx = _SUFFIX[t]
    zero = _lift(g, 0, t)
    if t == I:
        y = _op("SEL_I", _op("EQ_I", y, zero), _lift(g, 1, I), y)
    trunc = _op(f"REM_{sfx}", x, y)
    nz = _op(f"NE_{sfx}", trunc, zero)
    plus = _op("AND", _op("NE_B", _op(f"LT_{sfx}", trunc, zero),
                          _op(f"LT_{sfx}", y, zero)), nz)
    return _op(f"SEL_{sfx}", plus, _op(f"ADD_{sfx}", trunc, y), trunc)


def _xor(a, b) -> Sym:
    """``^``: the compiler admits it between int kinds only."""
    (x, y), t = _promote(a, b)
    if t != I:
        raise CompileError(f"^ on {TYPE_NAMES[t]} values (jax raises "
                           f"TypeError on floats)")
    return _op("XOR_I", x, y)


def _neg(s: Sym) -> Sym:
    if s.t == B:
        raise CompileError("negation of a bool")
    return _op(f"NEG_{_SUFFIX[s.t]}", s)


def _abs(s: Sym) -> Sym:
    if s.t == B:
        return s
    return _op(f"ABS_{_SUFFIX[s.t]}", s)


def _compare(kind: str, a, b) -> Sym:
    (x, y), t = _promote(a, b)
    if t == B and kind not in ("EQ", "NE"):
        raise CompileError("ordering on bools")
    return _op(f"{kind}_{_SUFFIX[t]}", x, y)


class SymXP:
    """The part of jax.numpy the compiled closures call, on ``Sym``
    values and Python scalars."""

    def __init__(self, g: _Graph):
        self.g = g

    def asarray(self, v) -> Sym:
        return _lift(self.g, v)

    def _inexact(self, v) -> Sym:
        s = _lift(self.g, v)
        return _convert(s, F)

    def logical_not(self, v) -> Sym:
        return _op("NOT", self._bool(v))

    def logical_and(self, a, b) -> Sym:
        return _op("AND", self._bool(a), self._bool(b))

    def logical_or(self, a, b) -> Sym:
        return _op("OR", self._bool(a), self._bool(b))

    def _bool(self, v) -> Sym:
        s = _lift(self.g, v)
        return s if s.t == B else _compare("NE", s, 0)

    def sign(self, v) -> Sym:
        s = _lift(self.g, v)
        if s.t == B:
            raise CompileError("sign of a bool")
        return _op(f"SIGN_{_SUFFIX[s.t]}", s)

    def maximum(self, a, b) -> Sym:
        (x, y), t = _promote(_lift(self.g, a), b)
        if t == B:
            raise CompileError("maximum of bools")
        return _op(f"MAX_{_SUFFIX[t]}", x, y)

    def fmod(self, a, b) -> Sym:
        (x, y), t = _promote(_lift(self.g, a), b, floor=I)
        if t == I:
            y = _op("SEL_I", _op("EQ_I", y, _lift(self.g, 0, I)),
                    _lift(self.g, 1, I), y)
        return _op(f"REM_{_SUFFIX[t]}", x, y)

    def abs(self, v) -> Sym:
        return _abs(_lift(self.g, v))

    def _keep_int(self, v, op: str) -> Sym:
        s = _lift(self.g, v)
        if s.t != F:
            return s                     # no-op on integer types
        return _op(op, s)

    def floor(self, v): return self._keep_int(v, "FLOOR")
    def ceil(self, v): return self._keep_int(v, "CEIL")
    def round(self, v): return self._keep_int(v, "RINT")

    def sqrt(self, v): return _op("SQRT", self._inexact(v))
    def cbrt(self, v): return _op("CBRT", self._inexact(v))
    def exp(self, v): return _op("EXP", self._inexact(v))
    def exp2(self, v): return _op("EXP2", self._inexact(v))
    def log(self, v): return _op("LOG", self._inexact(v))
    def sin(self, v): return _op("SIN", self._inexact(v))
    def cos(self, v): return _op("COS", self._inexact(v))
    def tan(self, v): return _op("TAN", self._inexact(v))
    def arcsin(self, v): return _op("ASIN", self._inexact(v))
    def arccos(self, v): return _op("ACOS", self._inexact(v))
    def arctan(self, v): return _op("ATAN", self._inexact(v))

    def log2(self, v):
        x = self._inexact(v)
        return _op("DIV_F", _op("LOG", x),
                   _op("LOG", _lift(self.g, 2.0, F)))

    def log10(self, v):
        x = self._inexact(v)
        return _op("MUL_F", _op("LOG", x),
                   _lift(self.g, 0.4342944819032518, F))

    def arctan2(self, a, b):
        return _op("ATAN2", self._inexact(a), self._inexact(b))

    def hypot(self, a, b):
        """jnp.hypot's scaled form, as its lax operations."""
        g = self.g
        x1 = _op("ABS_F", self._inexact(a))
        x2 = _op("ABS_F", self._inexact(b))
        inf = _lift(g, math.inf, F)
        idx_inf = _op("OR", _op("EQ_F", x1, inf), _op("EQ_F", x2, inf))
        x1, x2 = _op("MAX_F", x1, x2), _op("MIN_F", x1, x2)
        zero, one = _lift(g, 0.0, F), _lift(g, 1.0, F)
        is0 = _op("EQ_F", x1, zero)
        r = _op("DIV_F", x2, _op("SEL_F", is0, one, x1))
        x = _op("SEL_F", is0, x1,
                _op("MUL_F", x1, _op("SQRT", _op("ADD_F", one,
                                                  _op("MUL_F", r, r)))))
        return _op("SEL_F", idx_inf, inf, x)

    def power(self, a, b):
        g = self.g
        if not isinstance(b, Sym) and isinstance(b, (bool, int,
                                                     np.integer)):
            return self._integer_pow(_lift(g, a), int(b))
        x1, x2 = _lift(g, a), _lift(g, b)
        (p1, p2), t = _promote(x1, x2)
        if t != F:
            return self._pow_int_int(p1, p2)
        if x1.t == F and x2.t != F:
            return _op("POW", x1, _convert(x2, F))
        return self._pow_f(p1, p2)

    def _pow_f(self, x: Sym, y: Sym) -> Sym:
        """lax.pow, with XLA's rewrites of small constant exponents."""
        g = self.g
        if g.is_const(y.i):
            c = g.cval(y.i)
            if c == 0.0:
                return _lift(g, 1.0, F)
            if c == 1.0:
                return x
            if c == 2.0:
                return _op("MUL_F", x, x)
            if c == -1.0:
                return _op("DIV_F", _lift(g, 1.0, F), x)
        return _op("POW", x, y)

    def _integer_pow(self, x: Sym, y: int) -> Sym:
        """lax.integer_pow's squaring chain."""
        g = self.g
        if y == 0:
            return _lift(g, 1, x.t) if x.t != B else _lift(g, True)
        if y < 0 and x.t != F:
            raise CompileError("integers to a negative power (jax "
                               "raises TypeError)")
        recip = y < 0
        y = -y if recip else y
        mul = "MUL_F" if x.t == F else "MUL_I"
        if x.t == B:
            raise CompileError("power of a bool")
        acc = None
        while y > 0:
            if y & 1:
                acc = x if acc is None else _op(mul, acc, x)
            y >>= 1
            if y > 0:
                x = _op(mul, x, x)
        return _op("DIV_F", _lift(g, 1.0, F), acc) if recip else acc

    def _pow_int_int(self, x1: Sym, x2: Sym) -> Sym:
        """jnp's _pow_int_int: six rounds of binary exponentiation."""
        g = self.g
        if x1.t == B:
            raise CompileError("power of a bool")
        zero, one = _lift(g, 0, I), _lift(g, 1, I)
        acc = _op("SEL_I", _op("AND", _op("EQ_I", x1, zero),
                               _op("NE_I", x2, zero)), zero, one)
        for _ in range(6):
            bit = _op("NE_I", _op("AND_I", x2, one), zero)
            acc = _op("SEL_I", bit, _op("MUL_I", acc, x1), acc)
            x1 = _op("MUL_I", x1, x1)
            x2 = _op("SHRL_I", x2, one)
        return acc


# ============================================================ program
class ExprProgram:
    """A compiled WHERE in the kernel's form.

    ``ins`` int32 [n, 5]: (opcode, dst register, operand registers a, b,
    c); a CONST carries its 32-bit pattern in ``a``, a LOAD its slot in
    ``a``.  ``slots``: (env key, kind, type) per input column, kind
    EDGE (read at e), VSRC (at src[e]) or VDST (at dst[e]).  The last
    instruction writes ``out``, a bool register.  ``ops`` lists the
    opcode names (for reading), ``n_guards`` the div guards folded in,
    ``transcendental`` whether any platform function is used."""

    __slots__ = ("ins", "slots", "out", "n_regs", "ops", "n_guards",
                 "pushed", "transcendental", "_dev")

    def __init__(self, ins: np.ndarray, slots, out: int, n_regs: int,
                 ops: List[str], n_guards: int, pushed: bool):
        self.ins = ins
        self.slots = slots
        self.out = out
        self.n_regs = n_regs
        self.ops = ops
        self.n_guards = n_guards
        self.pushed = pushed
        self.transcendental = any(o in TRANSCENDENTAL for o in ops)
        self._dev: Dict[str, torch.Tensor] = {}

    def device_ins(self, device: torch.device) -> torch.Tensor:
        """The instructions on ``device`` (uploaded once per device, after
        a check that every register they name lies below ``n_regs``: the
        kernels' register file holds that many a thread)."""
        key = str(device)
        t = self._dev.get(key)
        if t is None:
            ins = self.ins.reshape(-1, 5)
            regs = np.where(ins[:, :1] >= OPCODE["CVT_BI"], ins[:, 1:],
                            ins[:, 1:2])
            if not (0 <= self.out < self.n_regs <= MAX_REGS) or (
                    len(ins) and not ((regs >= 0) & (regs < self.n_regs)
                                      ).all()):
                raise ValueError("program names a register outside its "
                                 f"{self.n_regs}")
            t = self._dev[key] = torch.from_numpy(self.ins.copy()).to(device)
        return t

    def __len__(self) -> int:
        return len(self.ins)


def _slot_kind(desc: Tuple) -> int:
    if desc[0] == "vertex":
        return VSRC if desc[3] == "src" else VDST
    return EDGE


def trace_filter(cval, used: Dict[str, Tuple], guards: Sequence,
                 pushed: bool, col_types: Dict[str, int],
                 root: str = "mask") -> ExprProgram:
    """Lower a compiled WHERE: run ``cval`` and each div guard over
    symbolic columns, build the reference ``filter_fn``'s mask
    (numeric WHERE: != 0; AND !guard; pushed: AND each used edge or
    vertex column's validity), then contract, order and allocate.
    ``col_types`` gives each used key's device type (B, I or F).
    ``root="value"`` ends the program at the WHERE's own value instead
    (a test hook for the value tolerance of transcendentals)."""
    g = _Graph()
    slots: List[Tuple[str, int, int]] = []
    cols: Dict[str, Sym] = {}
    for key, desc in used.items():
        slots.append((key, _slot_kind(desc), col_types[key]))
        cols[key] = Sym(g, g.load(len(slots) - 1, col_types[key]))
    xp = SymXP(g)
    env = Env(xp, cols)
    value = _lift(g, cval.fn(env))
    if root == "value":
        mask = value
    else:
        mask = value if value.t == B else _compare("NE", value, 0)
        for guard in guards:
            mask = _op("AND", mask, xp.logical_not(guard(env)))
        if pushed:
            for key, desc in used.items():
                if desc[0] not in ("edge", "vertex"):
                    continue
                slots.append(("valid:" + key, _slot_kind(desc), B))
                mask = _op("AND", mask,
                           Sym(g, g.load(len(slots) - 1, B)))
    if len(slots) > MAX_SLOTS:
        raise CompileError(f"{len(slots)} input columns; the kernel "
                           f"reads at most {MAX_SLOTS}")
    return _emit(g, mask.i, slots, len(guards), pushed)


def _emit(g: _Graph, root: int, slots, n_guards: int, pushed: bool
          ) -> ExprProgram:
    nodes = g.nodes
    live = _reachable(nodes, root)
    uses = {i: 0 for i in live}
    for i in live:
        for a in nodes[i].args:
            uses[a] += 1
    uses[root] += 1
    fused = _contract(nodes, live, uses)
    # post-order over the contracted graph
    order: List[int] = []
    seen = set()

    def args_of(i):
        return fused[i][1] if i in fused else nodes[i].args

    stack = [(root, False)]
    while stack:
        i, done = stack.pop()
        if done:
            order.append(i)
            continue
        if i in seen:
            continue
        seen.add(i)
        stack.append((i, True))
        for a in reversed(args_of(i)):
            if a not in seen:
                stack.append((a, False))
    last = {}
    for pos, i in enumerate(order):
        for a in args_of(i):
            last[a] = pos
    reg: Dict[int, int] = {}
    free: List[int] = []
    n_regs = 0
    rows, ops = [], []
    for pos, i in enumerate(order):
        nd = nodes[i]
        name = fused[i][0] if i in fused else nd.op
        srcs = [reg[a] for a in args_of(i)]
        for a in set(args_of(i)):
            if last[a] == pos:
                free.append(reg[a])
        if free:
            r = free.pop()
        else:
            r = n_regs
            n_regs += 1
        reg[i] = r
        row = [OPCODE[name], r, 0, 0, 0]
        if name == "CONST":
            row[2] = _bits(nd.dtype, nd.imm)
            row[3] = nd.dtype
        elif name == "LOAD":
            row[2] = nd.imm
            row[3] = nd.dtype
        else:
            row[2:2 + len(srcs)] = srcs
        rows.append(row)
        ops.append(name)
    if n_regs > MAX_REGS:
        raise CompileError(f"program needs {n_regs} registers; the "
                           f"kernel holds {MAX_REGS}")
    if len(rows) > MAX_INS:
        raise CompileError(f"program of {len(rows)} instructions; the "
                           f"kernel runs at most {MAX_INS}")
    return ExprProgram(np.asarray(rows, np.int32).reshape(-1, 5), slots,
                       reg[root], n_regs, ops, n_guards, pushed)


def _reachable(nodes: List[_Node], root: int) -> List[int]:
    out, stack, seen = [], [root], {root}
    while stack:
        i = stack.pop()
        out.append(i)
        for a in nodes[i].args:
            if a not in seen:
                seen.add(a)
                stack.append(a)
    return out


def _contract(nodes: List[_Node], live: List[int], uses: Dict[int, int]
              ) -> Dict[int, Tuple[str, Tuple[int, ...]]]:
    """Fused multiply-adds: an ADD_F / SUB_F whose left (else right)
    operand is a MUL_F read only there, or the negation of one, becomes
    one FMA with a single rounding."""
    def product(i):
        nd = nodes[i]
        if nd.op == "MUL_F" and uses[i] == 1:
            return nd.args, False
        if nd.op == "NEG_F" and uses[i] == 1:
            inner = nodes[nd.args[0]]
            if inner.op == "MUL_F" and uses[nd.args[0]] == 1:
                return inner.args, True
        return None

    fused = {}
    for i in sorted(live):
        nd = nodes[i]
        if nd.op not in ("ADD_F", "SUB_F"):
            continue
        left, right = nd.args
        pl, pr = product(left), product(right)
        if pl is not None:
            (a, b), negp = pl
            negc = nd.op == "SUB_F"
            fused[i] = (_fma_name(negp, negc), (a, b, right))
        elif pr is not None:
            (a, b), negp = pr
            if nd.op == "SUB_F":
                negp = not negp
            fused[i] = (_fma_name(negp, False), (a, b, left))
    return fused


def _fma_name(negp: bool, negc: bool) -> str:
    return {(False, False): "FMA", (True, False): "FMA_NP",
            (False, True): "FMA_NC", (True, True): "FMA_NPC"}[(negp, negc)]


# ====================================================== plain executor
def run_program(prog: ExprProgram, slot_tensors: Sequence[torch.Tensor],
                edge_src: torch.Tensor, edge_dst: torch.Tensor
                ) -> torch.Tensor:
    """Execute ``prog`` for every edge with torch ops: the plain version
    of the expr_filter kernel.  ``slot_tensors[k]`` is slot k's column
    (edge-aligned [m], or vertex-aligned [n] for VSRC / VDST).  Returns
    the out register broadcast to [m] (bool for a mask program)."""
    m = int(edge_src.shape[0])
    src = edge_src.long()
    dst = edge_dst.long()
    regs: List[Optional[torch.Tensor]] = [None] * max(prog.n_regs, 1)
    dev = edge_src.device
    for row, name in zip(prog.ins.tolist(), prog.ops):
        _op_, d, a, b, c = row
        if name == "CONST":
            regs[d] = torch.full((m,), _from_bits(b, a), dtype=DTYPES[b],
                                 device=dev)
        elif name == "LOAD":
            _key, kind, t = prog.slots[a]
            col = slot_tensors[a]
            if t == B:
                col = col.bool()
            regs[d] = col if kind == EDGE else col[src if kind == VSRC
                                                   else dst]
        else:
            n_args = len(ARGS[name])
            regs[d] = exec_op(name, *[regs[r] for r in (a, b, c)[:n_args]])
    return regs[prog.out]
