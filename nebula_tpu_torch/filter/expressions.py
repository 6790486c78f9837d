"""Expression engine — typed AST with eval, encode/decode, and pushdown;
a copy of ``nebula_tpu/filter/expressions.py``.

Capability parity with Nebula's common/filter/Expressions.h:
  * the full node tree (property refs $^ $$ $- $var edge.prop, pseudo-props
    _type/_src/_dst/_rank, literals, function calls, unary, type casting,
    arithmetic, relational, logical — Expressions.h:284-812);
  * ExprContext with pluggable getters — the one mechanism powering both
    graphd-side eval and storaged-side pushdown eval (Expressions.h:24-115);
  * binary encode/decode so filters travel inside GetNeighbors requests
    (Expressions.h:117-235) — a msgpack'd prefix tree, written and read
    here by ``wire.py`` (no msgpack package), byte for byte as the
    reference's ``packb(..., use_bin_type=True)``;
  * prepare() semantic checks (aliases known, functions exist, arity).

TPU-first extra: the AST is deliberately data-only (node = op tag +
children), so tpu/expr_compile.py can lower the same tree to a vectorized
mask program over CSR property columns — one expression, three
backends (python eval, pushdown eval, the device program).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

from . import wire
from .functions import FunctionManager

Value = Union[bool, int, float, str]


class ExprError(Exception):
    """Semantic/eval error (becomes Status at service boundaries)."""


class ExprContext:
    """Pluggable getters (reference ExpressionContext).

    Executors/processors install only the getters valid in their position;
    a missing getter raises ExprError at eval (like the reference's
    prepare-time rejection of out-of-position refs).
    """

    __slots__ = ("get_src_tag_prop", "get_dst_tag_prop", "get_alias_prop",
                 "get_input_prop", "get_variable_prop", "get_edge_type",
                 "get_edge_rank", "get_edge_src_id", "get_edge_dst_id",
                 "aliases")

    def __init__(self):
        self.get_src_tag_prop: Optional[Callable[[str, str], Value]] = None
        self.get_dst_tag_prop: Optional[Callable[[str, str], Value]] = None
        self.get_alias_prop: Optional[Callable[[str, str], Value]] = None
        self.get_input_prop: Optional[Callable[[str], Value]] = None
        self.get_variable_prop: Optional[Callable[[str, str], Value]] = None
        self.get_edge_type: Optional[Callable[[str], Value]] = None
        self.get_edge_rank: Optional[Callable[[str], Value]] = None
        self.get_edge_src_id: Optional[Callable[[str], Value]] = None
        self.get_edge_dst_id: Optional[Callable[[str], Value]] = None
        self.aliases: Dict[str, bool] = {}  # known edge aliases


def _require(getter, kind: str):
    if getter is None:
        raise ExprError(f"{kind} reference not allowed here")
    return getter


# ---------------------------------------------------------------- nodes
class Expression:
    KIND = "base"
    __slots__ = ()

    def eval(self, ctx: ExprContext) -> Value:
        raise NotImplementedError

    def prepare(self, ctx: ExprContext) -> None:
        """Static checks; default recurses children."""
        for c in self.children():
            c.prepare(ctx)

    def children(self) -> List["Expression"]:
        return []

    def to_wire(self) -> list:
        raise NotImplementedError

    def __str__(self) -> str:
        return self.KIND

    def __eq__(self, other):
        return (isinstance(other, Expression) and
                self.to_wire() == other.to_wire())

    def __hash__(self):
        return hash(str(self.to_wire()))


class PrimaryExpr(Expression):
    KIND = "lit"
    __slots__ = ("value",)

    def __init__(self, value: Value):
        self.value = value

    def eval(self, ctx):
        return self.value

    def to_wire(self):
        return [self.KIND, self.value]

    def __str__(self):
        return repr(self.value)


class SourcePropExpr(Expression):
    KIND = "src"  # $^.tag.prop
    __slots__ = ("tag", "prop")

    def __init__(self, tag: str, prop: str):
        self.tag, self.prop = tag, prop

    def eval(self, ctx):
        return _require(ctx.get_src_tag_prop, "$^ source")(self.tag, self.prop)

    def to_wire(self):
        return [self.KIND, self.tag, self.prop]

    def __str__(self):
        return f"$^.{self.tag}.{self.prop}"


class DestPropExpr(Expression):
    KIND = "dst"  # $$.tag.prop
    __slots__ = ("tag", "prop")

    def __init__(self, tag: str, prop: str):
        self.tag, self.prop = tag, prop

    def eval(self, ctx):
        return _require(ctx.get_dst_tag_prop, "$$ dest")(self.tag, self.prop)

    def to_wire(self):
        return [self.KIND, self.tag, self.prop]

    def __str__(self):
        return f"$$.{self.tag}.{self.prop}"


class AliasPropExpr(Expression):
    KIND = "edge"  # edge.prop
    __slots__ = ("alias", "prop")

    def __init__(self, alias: str, prop: str):
        self.alias, self.prop = alias, prop

    def eval(self, ctx):
        return _require(ctx.get_alias_prop, "edge prop")(self.alias, self.prop)

    def prepare(self, ctx):
        if ctx.aliases and self.alias not in ctx.aliases:
            raise ExprError(f"unknown edge alias `{self.alias}'")

    def to_wire(self):
        return [self.KIND, self.alias, self.prop]

    def __str__(self):
        return f"{self.alias}.{self.prop}"


class InputPropExpr(Expression):
    KIND = "input"  # $-.prop
    __slots__ = ("prop",)

    def __init__(self, prop: str):
        self.prop = prop

    def eval(self, ctx):
        return _require(ctx.get_input_prop, "$- input")(self.prop)

    def to_wire(self):
        return [self.KIND, self.prop]

    def __str__(self):
        return f"$-.{self.prop}"


class VariablePropExpr(Expression):
    KIND = "var"  # $var.prop
    __slots__ = ("var", "prop")

    def __init__(self, var: str, prop: str):
        self.var, self.prop = var, prop

    def eval(self, ctx):
        return _require(ctx.get_variable_prop, "$var")(self.var, self.prop)

    def to_wire(self):
        return [self.KIND, self.var, self.prop]

    def __str__(self):
        return f"${self.var}.{self.prop}"


class _EdgePseudoExpr(Expression):
    __slots__ = ("alias",)
    GETTER = ""

    def __init__(self, alias: str = ""):
        self.alias = alias

    def eval(self, ctx):
        return _require(getattr(ctx, self.GETTER), self.KIND)(self.alias)

    def to_wire(self):
        return [self.KIND, self.alias]

    def __str__(self):
        return f"{self.alias or ''}._{self.KIND.split('_')[-1]}"


class EdgeTypeExpr(_EdgePseudoExpr):
    KIND = "e_type"
    GETTER = "get_edge_type"


class EdgeSrcIdExpr(_EdgePseudoExpr):
    KIND = "e_src"
    GETTER = "get_edge_src_id"


class EdgeDstIdExpr(_EdgePseudoExpr):
    KIND = "e_dst"
    GETTER = "get_edge_dst_id"


class EdgeRankExpr(_EdgePseudoExpr):
    KIND = "e_rank"
    GETTER = "get_edge_rank"


class FunctionCallExpr(Expression):
    KIND = "fn"
    __slots__ = ("name", "args")

    def __init__(self, name: str, args: List[Expression]):
        self.name = name
        self.args = args

    def children(self):
        return self.args

    def prepare(self, ctx):
        FunctionManager.get(self.name, len(self.args))  # raises if bad
        super().prepare(ctx)

    def eval(self, ctx):
        fn = FunctionManager.get(self.name, len(self.args))
        return fn(*[a.eval(ctx) for a in self.args])

    def to_wire(self):
        return [self.KIND, self.name, [a.to_wire() for a in self.args]]

    def __str__(self):
        return f"{self.name}({', '.join(map(str, self.args))})"


class UnaryExpr(Expression):
    KIND = "unary"
    __slots__ = ("op", "operand")
    OPS = ("+", "-", "!")

    def __init__(self, op: str, operand: Expression):
        if op not in self.OPS:
            raise ExprError(f"bad unary op {op}")
        self.op, self.operand = op, operand

    def children(self):
        return [self.operand]

    def eval(self, ctx):
        v = self.operand.eval(ctx)
        if self.op == "!":
            return not _as_bool(v)
        _check_numeric(v, self.op)
        return v if self.op == "+" else -v

    def to_wire(self):
        return [self.KIND, self.op, self.operand.to_wire()]

    def __str__(self):
        return f"{self.op}({self.operand})"


class TypeCastingExpr(Expression):
    KIND = "cast"
    __slots__ = ("type_name", "operand")
    TYPES = ("int", "double", "string", "bool")

    def __init__(self, type_name: str, operand: Expression):
        if type_name not in self.TYPES:
            raise ExprError(f"bad cast type {type_name}")
        self.type_name, self.operand = type_name, operand

    def children(self):
        return [self.operand]

    def eval(self, ctx):
        v = self.operand.eval(ctx)
        try:
            if self.type_name == "int":
                return int(v)
            if self.type_name == "double":
                return float(v)
            if self.type_name == "string":
                return _to_string(v)
            return _as_bool(v)
        except (TypeError, ValueError) as e:
            raise ExprError(f"cannot cast {v!r} to {self.type_name}") from e

    def to_wire(self):
        return [self.KIND, self.type_name, self.operand.to_wire()]

    def __str__(self):
        return f"({self.type_name}){self.operand}"


class ArithmeticExpr(Expression):
    KIND = "arith"
    __slots__ = ("op", "left", "right")
    OPS = ("+", "-", "*", "/", "%", "^")

    def __init__(self, op: str, left: Expression, right: Expression):
        if op not in self.OPS:
            raise ExprError(f"bad arithmetic op {op}")
        self.op, self.left, self.right = op, left, right

    def children(self):
        return [self.left, self.right]

    def eval(self, ctx):
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        op = self.op
        if op == "+":
            if isinstance(a, str) or isinstance(b, str):
                return _to_string(a) + _to_string(b)
            _check_numeric(a, op), _check_numeric(b, op)
            return a + b
        _check_numeric(a, op), _check_numeric(b, op)
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if b == 0:
                raise ExprError("division by zero")
            if isinstance(a, int) and isinstance(b, int):
                q = abs(a) // abs(b)  # C-style truncation toward zero
                return q if (a >= 0) == (b >= 0) else -q
            return a / b
        if op == "%":
            if b == 0:
                raise ExprError("division by zero")
            if isinstance(a, int) and isinstance(b, int):
                r = abs(a) % abs(b)
                return r if a >= 0 else -r
            return math_fmod(a, b)
        # ^ — XOR on ints (reference uses bit_xor for ^)
        if not isinstance(a, int) or not isinstance(b, int):
            raise ExprError("^ requires integers")
        return a ^ b

    def to_wire(self):
        return [self.KIND, self.op, self.left.to_wire(), self.right.to_wire()]

    def __str__(self):
        return f"({self.left}{self.op}{self.right})"


class RelationalExpr(Expression):
    KIND = "rel"
    __slots__ = ("op", "left", "right")
    OPS = ("<", "<=", ">", ">=", "==", "!=")

    def __init__(self, op: str, left: Expression, right: Expression):
        if op not in self.OPS:
            raise ExprError(f"bad relational op {op}")
        self.op, self.left, self.right = op, left, right

    def children(self):
        return [self.left, self.right]

    def eval(self, ctx):
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        # mixed numeric compares fine; string vs number is an error except ==/!=
        num_a = isinstance(a, (int, float)) and not isinstance(a, bool)
        num_b = isinstance(b, (int, float)) and not isinstance(b, bool)
        if num_a != num_b or (isinstance(a, bool) != isinstance(b, bool)):
            if self.op == "==":
                return False
            if self.op == "!=":
                return True
            raise ExprError(f"type mismatch in {a!r} {self.op} {b!r}")
        if self.op == "<":
            return a < b
        if self.op == "<=":
            return a <= b
        if self.op == ">":
            return a > b
        if self.op == ">=":
            return a >= b
        if self.op == "==":
            return a == b
        return a != b

    def to_wire(self):
        return [self.KIND, self.op, self.left.to_wire(), self.right.to_wire()]

    def __str__(self):
        return f"({self.left}{self.op}{self.right})"


class LogicalExpr(Expression):
    KIND = "logic"
    __slots__ = ("op", "left", "right")
    OPS = ("&&", "||")

    def __init__(self, op: str, left: Expression, right: Expression):
        if op not in self.OPS:
            raise ExprError(f"bad logical op {op}")
        self.op, self.left, self.right = op, left, right

    def children(self):
        return [self.left, self.right]

    def eval(self, ctx):
        a = _as_bool(self.left.eval(ctx))
        if self.op == "&&":
            return a and _as_bool(self.right.eval(ctx))
        return a or _as_bool(self.right.eval(ctx))

    def to_wire(self):
        return [self.KIND, self.op, self.left.to_wire(), self.right.to_wire()]

    def __str__(self):
        return f"({self.left} {self.op} {self.right})"


# ---------------------------------------------------------------- helpers
def math_fmod(a, b):
    import math
    return math.fmod(a, b)


def _as_bool(v: Value) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    raise ExprError(f"cannot use {v!r} as a boolean")


def _to_string(v: Value) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        return f"{v:.6f}".rstrip("0").rstrip(".") if "." in f"{v:.6f}" else str(v)
    return str(v)


def _check_numeric(v, op):
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ExprError(f"non-numeric operand {v!r} for {op}")


# ---------------------------------------------------------------- codec
_KIND_MAP: Dict[str, Any] = {}


def _register_kinds():
    for cls in (PrimaryExpr, SourcePropExpr, DestPropExpr, AliasPropExpr,
                InputPropExpr, VariablePropExpr, EdgeTypeExpr, EdgeSrcIdExpr,
                EdgeDstIdExpr, EdgeRankExpr, FunctionCallExpr, UnaryExpr,
                TypeCastingExpr, ArithmeticExpr, RelationalExpr, LogicalExpr):
        _KIND_MAP[cls.KIND] = cls


_register_kinds()


def _from_wire(w: list) -> Expression:
    kind = w[0]
    cls = _KIND_MAP.get(kind)
    if cls is None:
        raise ExprError(f"bad encoded expression kind {kind!r}")
    if cls is PrimaryExpr:
        return PrimaryExpr(w[1])
    if cls in (SourcePropExpr, DestPropExpr, AliasPropExpr, VariablePropExpr):
        return cls(w[1], w[2])
    if cls is InputPropExpr:
        return InputPropExpr(w[1])
    if cls in (EdgeTypeExpr, EdgeSrcIdExpr, EdgeDstIdExpr, EdgeRankExpr):
        return cls(w[1])
    if cls is FunctionCallExpr:
        return FunctionCallExpr(w[1], [_from_wire(a) for a in w[2]])
    if cls in (UnaryExpr, TypeCastingExpr):
        return cls(w[1], _from_wire(w[2]))
    # binary
    return cls(w[1], _from_wire(w[2]), _from_wire(w[3]))


def encode_expr(expr: Expression) -> bytes:
    """Binary form for filter pushdown (reference Expression::encode)."""
    return wire.packb(expr.to_wire())


def decode_expr(data: bytes) -> Expression:
    try:
        return _from_wire(wire.unpackb(data))
    except (ValueError, IndexError, TypeError) as e:
        raise ExprError(f"corrupt encoded expression: {e}") from e
