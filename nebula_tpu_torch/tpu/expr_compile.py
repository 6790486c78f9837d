"""Compile nGQL Expression trees into vectorized columnar ops — a copy
of ``nebula_tpu/tpu/expr_compile.py:1-465``.

The reference evaluates pushed filters per edge row inside the storaged
scan loop (QueryBaseProcessor.inl:369-396) and remnant WHERE + YIELD per
row on graphd (GoExecutor.cpp:700-752).  Here the SAME expression tree
(filter/expressions.py) compiles once into a function over the CSR
mirror's columns and evaluates for every candidate edge at once — on
the host (numpy) for YIELD materialization, and, lowered by
``expr_program.trace_filter`` into an ``ExprProgram``, on the card for
the filter mask the GO program fuses (``csrc/expr_filter.cu``).  The
closures are the reference's, unchanged: the lowering runs them over
symbolic arrays that follow jax.numpy's dtype rules.

Literal translation keeps everything in int32/float32 device space:
vertex-id literals become dense ranks (csr.vids is sorted), string
literals become dictionary ranks (dictionaries are sorted) — both
order-preserving, so every relational op compiles, even when the literal
itself is absent from the data.

Unsupported constructs raise CompileError; the runtime then declines the
query (TpuDecline) and graphd's CPU path runs it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..filter.expressions import (AliasPropExpr, ArithmeticExpr, DestPropExpr,
                                  EdgeDstIdExpr, EdgeRankExpr, EdgeSrcIdExpr,
                                  EdgeTypeExpr, Expression, FunctionCallExpr,
                                  InputPropExpr, LogicalExpr, PrimaryExpr,
                                  RelationalExpr, SourcePropExpr,
                                  TypeCastingExpr, UnaryExpr,
                                  VariablePropExpr)
from ..interface.common import SupportedType
from .csr import Column, CsrMirror


class CompileError(Exception):
    """Expression not device-compilable → CPU fallback."""


# value kinds flowing through the compiled graph
K_INT, K_FLOAT, K_BOOL, K_STR, K_VIDRANK, K_STRCODE = range(6)
_NUMERIC = (K_INT, K_FLOAT)


class CVal:
    """A compiled sub-expression: lazily evaluated columnar value.

    ``fn(env) -> array`` where env carries the backend module (np/jnp) and
    the gathered column arrays.  ``kind`` drives type checking at compile
    time (schemas make value types static — unlike the reference's per-row
    dynamic checks, mismatches surface before the query runs).
    """

    __slots__ = ("kind", "fn", "dictionary", "const")

    def __init__(self, kind, fn, dictionary=None, const=None):
        self.kind = kind
        self.fn = fn
        self.dictionary = dictionary  # sorted strings, for K_STRCODE
        self.const = const            # python literal when constant


class Env:
    """Evaluation environment handed to compiled fns.

    cols: name -> array (backend-native) for every column the compiler
    registered during compilation; xp: numpy (host), or the symbolic
    module of expr_program.py (the device lowering).
    """

    __slots__ = ("xp", "cols")

    def __init__(self, xp, cols: Dict[str, object]):
        self.xp = xp
        self.cols = cols


class ExprCompiler:
    """Compiles expressions against one CsrMirror + alias/tag bindings.

    Column accesses are recorded in ``self.used`` so the runtime knows
    exactly which device arrays each compiled filter needs:
      ("edge", etype, prop) / ("vertex", tag_id, prop, which="src"|"dst") /
      ("rank",) / ("etype",) / ("src_idx",) / ("dst_idx",)
    """

    def __init__(self, mirror: CsrMirror, space_id: int, schema_man,
                 alias_to_etype: Dict[str, int]):
        self.mirror = mirror
        self.sm = schema_man
        self.space_id = space_id
        self.alias_to_etype = alias_to_etype
        # sorted alias dictionary for _type (per-row alias string — the
        # CPU _RowCtx yields the ROW's etype alias, not the expr's)
        self.alias_dict = np.asarray(sorted(alias_to_etype.keys()))
        self.used: Dict[str, Tuple] = {}   # env key -> descriptor
        # denominators of every compiled '/' and '%': fn(env) -> bool
        # (zero) mask. The CPU evaluator raises ExprError on x/0 — pushed
        # filters then DROP the row, graphd-side eval errors the query —
        # so the runtime must consult these to reproduce either behavior.
        self.div_guards: List = []

    # ---- column registration ----------------------------------------
    def _edge_col(self, alias: str, prop: str) -> Tuple[str, Column]:
        et = self.alias_to_etype.get(alias)
        if et is None:
            raise CompileError(f"unknown edge alias `{alias}'")
        col = self.mirror.edge_cols.get((et, prop))
        if col is None:
            # edge type exists but column doesn't -> always-missing prop:
            # the CPU path errors per-row; decline so it handles it.
            raise CompileError(f"no column {alias}.{prop}")
        if not col.device_ok:
            raise CompileError(f"column {alias}.{prop} not device-representable")
        key = f"e:{et}:{prop}"
        self.used[key] = ("edge", et, prop)
        return key, col

    def _vertex_col(self, which: str, tag: str, prop: str) -> Tuple[str, Column]:
        r = self.sm.to_tag_id(self.space_id, tag)
        if not r.ok():
            raise CompileError(f"unknown tag `{tag}'")
        tag_id = r.value()
        col = self.mirror.vertex_cols.get((tag_id, prop))
        if col is None:
            raise CompileError(f"no column {tag}.{prop}")
        if not col.device_ok:
            raise CompileError(f"column {tag}.{prop} not device-representable")
        key = f"v:{which}:{tag_id}:{prop}"
        self.used[key] = ("vertex", tag_id, prop, which)
        return key, col

    @staticmethod
    def _kind_of(col: Column) -> int:
        if col.stype == SupportedType.STRING:
            return K_STRCODE
        if col.stype in (SupportedType.FLOAT, SupportedType.DOUBLE):
            return K_FLOAT
        if col.stype == SupportedType.BOOL:
            return K_BOOL
        return K_INT

    # ---- main entry ---------------------------------------------------
    def compile(self, expr: Expression) -> CVal:
        if isinstance(expr, PrimaryExpr):
            v = expr.value
            if isinstance(v, bool):
                return CVal(K_BOOL, lambda env, _v=v: _v, const=v)
            if isinstance(v, int):
                return CVal(K_INT, lambda env, _v=v: _v, const=v)
            if isinstance(v, float):
                return CVal(K_FLOAT, lambda env, _v=v: _v, const=v)
            if isinstance(v, str):
                return CVal(K_STR, lambda env, _v=v: _v, const=v)
            raise CompileError(f"literal {v!r}")

        if isinstance(expr, AliasPropExpr):
            key, col = self._edge_col(expr.alias, expr.prop)
            return CVal(self._kind_of(col),
                        lambda env, _k=key: env.cols[_k],
                        dictionary=col.dictionary)

        if isinstance(expr, SourcePropExpr):
            key, col = self._vertex_col("src", expr.tag, expr.prop)
            return CVal(self._kind_of(col),
                        lambda env, _k=key: env.cols[_k],
                        dictionary=col.dictionary)

        if isinstance(expr, DestPropExpr):
            key, col = self._vertex_col("dst", expr.tag, expr.prop)
            return CVal(self._kind_of(col),
                        lambda env, _k=key: env.cols[_k],
                        dictionary=col.dictionary)

        if isinstance(expr, EdgeDstIdExpr):
            self.used["dst_idx"] = ("dst_idx",)
            return CVal(K_VIDRANK, lambda env: env.cols["dst_idx"])
        if isinstance(expr, EdgeSrcIdExpr):
            self.used["src_idx"] = ("src_idx",)
            return CVal(K_VIDRANK, lambda env: env.cols["src_idx"])
        if isinstance(expr, EdgeRankExpr):
            self.used["rank"] = ("rank",)
            return CVal(K_INT, lambda env: env.cols["rank"])
        if isinstance(expr, EdgeTypeExpr):
            # per-row alias string, dictionary-encoded over the OVER set
            self.used["etype_alias"] = ("etype_alias",)
            return CVal(K_STRCODE, lambda env: env.cols["etype_alias"],
                        dictionary=self.alias_dict)

        if isinstance(expr, (InputPropExpr, VariablePropExpr)):
            raise CompileError("$-/$var props are per-root, not columnar")

        if isinstance(expr, UnaryExpr):
            return self._unary(expr)
        if isinstance(expr, TypeCastingExpr):
            return self._cast(expr)
        if isinstance(expr, ArithmeticExpr):
            return self._arith(expr)
        if isinstance(expr, RelationalExpr):
            return self._rel(expr)
        if isinstance(expr, LogicalExpr):
            return self._logical(expr)
        if isinstance(expr, FunctionCallExpr):
            return self._call(expr)
        raise CompileError(f"unsupported expression {type(expr).__name__}")

    # ---- operators ----------------------------------------------------
    def _unary(self, expr: UnaryExpr) -> CVal:
        o = self.compile(expr.operand)
        if expr.op == "!":
            b = _to_bool(o)
            return CVal(K_BOOL, lambda env: env.xp.logical_not(b.fn(env)))
        if expr.op == "-":
            if o.kind not in _NUMERIC:
                raise CompileError("unary - on non-number")
            return CVal(o.kind, lambda env: -o.fn(env))
        if expr.op == "+":
            if o.kind not in _NUMERIC:
                raise CompileError("unary + on non-number")
            return o
        raise CompileError(f"unary {expr.op}")

    def _cast(self, expr: TypeCastingExpr) -> CVal:
        o = self.compile(expr.operand)
        t = expr.type_name.lower()
        if t in ("int", "int64"):
            if o.kind == K_BOOL:
                return CVal(K_INT, lambda env: o.fn(env).astype("int32")
                            if hasattr(o.fn(env), "astype") else int(o.fn(env)))
            if o.kind in _NUMERIC:
                return CVal(K_INT, lambda env: env.xp.asarray(
                    o.fn(env)).astype("int32"))
            raise CompileError("cast to int")
        if t in ("double", "float"):
            if o.kind in _NUMERIC or o.kind == K_BOOL:
                return CVal(K_FLOAT, lambda env: env.xp.asarray(
                    o.fn(env)).astype("float32"))
            raise CompileError("cast to double")
        raise CompileError(f"cast to {t}")

    def _arith(self, expr: ArithmeticExpr) -> CVal:
        a, b = self.compile(expr.left), self.compile(expr.right)
        op = expr.op
        if a.kind not in _NUMERIC or b.kind not in _NUMERIC:
            raise CompileError(f"arith {op} on non-numbers")
        kind = K_FLOAT if K_FLOAT in (a.kind, b.kind) else K_INT
        if op == "+":
            return CVal(kind, lambda env: a.fn(env) + b.fn(env))
        if op == "-":
            return CVal(kind, lambda env: a.fn(env) - b.fn(env))
        if op == "*":
            return CVal(kind, lambda env: a.fn(env) * b.fn(env))
        if op == "/":
            self._guard_zero(b)
            if kind == K_INT:
                # C-style truncation toward zero (expressions.py eval);
                # clamp |y| to 1 so guarded-out lanes don't fault
                def idiv(env):
                    x, y = a.fn(env), b.fn(env)
                    return env.xp.asarray(
                        env.xp.sign(x) * env.xp.sign(y) *
                        (abs(x) // env.xp.maximum(abs(y), 1))
                    ).astype("int32")
                return CVal(K_INT, idiv)
            return CVal(K_FLOAT, lambda env: a.fn(env) / b.fn(env))
        if op == "%":
            self._guard_zero(b)
            if kind != K_INT:
                return CVal(K_FLOAT, lambda env: env.xp.fmod(
                    a.fn(env), b.fn(env)))

            def imod(env):
                x, y = a.fn(env), b.fn(env)
                return env.xp.asarray(
                    env.xp.sign(x) *
                    (abs(x) % env.xp.maximum(abs(y), 1))).astype("int32")
            return CVal(K_INT, imod)
        if op == "^":
            if a.kind != K_INT or b.kind != K_INT:
                raise CompileError("^ requires integers")
            return CVal(K_INT, lambda env: a.fn(env) ^ b.fn(env))
        raise CompileError(f"arith {op}")

    def _guard_zero(self, denom: CVal) -> None:
        if denom.const is not None and denom.const != 0:
            return     # provably non-zero literal
        self.div_guards.append(lambda env: denom.fn(env) == 0)

    def _rel(self, expr: RelationalExpr) -> CVal:
        a, b = self.compile(expr.left), self.compile(expr.right)
        op = expr.op

        # vid-rank vs vid-rank: dense indices are order-preserving
        if a.kind == K_VIDRANK and b.kind == K_VIDRANK:
            return CVal(K_BOOL, _cmp_fn(a, b, op))
        # vid-rank vs int literal: translate literal via searchsorted
        for x, y, flip in ((a, b, False), (b, a, True)):
            if x.kind == K_VIDRANK:
                if y.kind == K_INT and y.const is not None:
                    lit = y.const
                    return self._rank_cmp(x, lit, op, flip)
                raise CompileError("vid compare needs int literal")

        # string-code vs string literal: translate via dictionary rank
        for x, y, flip in ((a, b, False), (b, a, True)):
            if x.kind == K_STRCODE and y.kind == K_STR:
                if y.const is None:
                    raise CompileError("string compare needs literal")
                return self._dict_cmp(x, y.const, op, flip)
        if a.kind == K_STRCODE and b.kind == K_STRCODE:
            if a.dictionary is not None and b.dictionary is not None and \
                    a.dictionary is b.dictionary:
                return CVal(K_BOOL, _cmp_fn(a, b, op))
            raise CompileError("string col compare across dictionaries")
        if a.kind == K_STR and b.kind == K_STR:
            r = _py_cmp(a.const, b.const, op)
            return CVal(K_BOOL, lambda env, _r=r: _r, const=r)

        # bool/number mismatch semantics (expressions.py RelationalExpr)
        num_a, num_b = a.kind in _NUMERIC, b.kind in _NUMERIC
        if a.kind == K_BOOL or b.kind == K_BOOL:
            if a.kind == K_BOOL and b.kind == K_BOOL:
                if op in ("==", "!="):
                    return CVal(K_BOOL, _cmp_fn(a, b, op))
                raise CompileError("ordering on bools")
            if op == "==":
                return CVal(K_BOOL, lambda env: False, const=False)
            if op == "!=":
                return CVal(K_BOOL, lambda env: True, const=True)
            raise CompileError("type mismatch in comparison")
        if num_a != num_b:
            if op == "==":
                return CVal(K_BOOL, lambda env: False, const=False)
            if op == "!=":
                return CVal(K_BOOL, lambda env: True, const=True)
            raise CompileError("type mismatch in comparison")
        if num_a and num_b:
            return CVal(K_BOOL, _cmp_fn(a, b, op))
        raise CompileError(f"compare {a.kind} {op} {b.kind}")

    def _rank_cmp(self, x: CVal, lit: int, op: str, flip: bool) -> CVal:
        """dense-idx column vs vid literal, via order-preserving rank."""
        mirror = self.mirror
        pos = mirror.vid_rank(lit)
        present = mirror.has_vid(lit)
        if flip:
            op = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(op, op)
        if op == "==":
            if not present:
                return CVal(K_BOOL, lambda env: False, const=False)
            return CVal(K_BOOL, lambda env: x.fn(env) == pos)
        if op == "!=":
            if not present:
                return CVal(K_BOOL, lambda env: True, const=True)
            return CVal(K_BOOL, lambda env: x.fn(env) != pos)
        # ordering: vids[idx] < lit  ⇔  idx < searchsorted_left(lit)
        if op == "<":
            return CVal(K_BOOL, lambda env: x.fn(env) < pos)
        if op == ">=":
            return CVal(K_BOOL, lambda env: x.fn(env) >= pos)
        # vids[idx] <= lit ⇔ idx < pos + present
        hi = pos + (1 if present else 0)
        if op == "<=":
            return CVal(K_BOOL, lambda env: x.fn(env) < hi)
        if op == ">":
            return CVal(K_BOOL, lambda env: x.fn(env) >= hi)
        raise CompileError(f"vid compare {op}")

    def _dict_cmp(self, x: CVal, lit: str, op: str, flip: bool) -> CVal:
        d = x.dictionary
        if d is None:
            raise CompileError("string column without dictionary")
        pos = int(np.searchsorted(d, lit))
        present = pos < len(d) and d[pos] == lit
        if flip:
            op = {"<": ">", ">": "<", "<=": ">=", ">=": "<="}.get(op, op)
        if op == "==":
            if not present:
                return CVal(K_BOOL, lambda env: False, const=False)
            return CVal(K_BOOL, lambda env: x.fn(env) == pos)
        if op == "!=":
            if not present:
                return CVal(K_BOOL, lambda env: True, const=True)
            return CVal(K_BOOL, lambda env: x.fn(env) != pos)
        if op == "<":
            return CVal(K_BOOL, lambda env: x.fn(env) < pos)
        if op == ">=":
            return CVal(K_BOOL, lambda env: x.fn(env) >= pos)
        hi = pos + (1 if present else 0)
        if op == "<=":
            return CVal(K_BOOL, lambda env: x.fn(env) < hi)
        if op == ">":
            return CVal(K_BOOL, lambda env: x.fn(env) >= hi)
        raise CompileError(f"string compare {op}")

    def _logical(self, expr: LogicalExpr) -> CVal:
        a = _to_bool(self.compile(expr.left))
        b = _to_bool(self.compile(expr.right))
        if expr.op == "&&":
            return CVal(K_BOOL,
                        lambda env: env.xp.logical_and(a.fn(env), b.fn(env)))
        return CVal(K_BOOL,
                    lambda env: env.xp.logical_or(a.fn(env), b.fn(env)))

    _FN1 = {"abs": "abs", "floor": "floor", "ceil": "ceil",
            "round": "round", "sqrt": "sqrt", "cbrt": "cbrt",
            "exp": "exp", "exp2": "exp2", "log": "log", "log2": "log2",
            "log10": "log10", "sin": "sin", "cos": "cos", "tan": "tan",
            "asin": "arcsin", "acos": "arccos", "atan": "arctan"}
    _INT_RESULT = {"abs"}

    def _call(self, expr: FunctionCallExpr) -> CVal:
        name = expr.name.lower()
        if name in self._FN1 and len(expr.args) == 1:
            a = self.compile(expr.args[0])
            if a.kind not in _NUMERIC:
                raise CompileError(f"{name} on non-number")
            attr = self._FN1[name]
            kind = a.kind if name in self._INT_RESULT else K_FLOAT
            return CVal(kind,
                        lambda env: getattr(env.xp, attr)(a.fn(env)))
        if name in ("pow", "hypot", "atan2") and len(expr.args) == 2:
            a, b = self.compile(expr.args[0]), self.compile(expr.args[1])
            if a.kind not in _NUMERIC or b.kind not in _NUMERIC:
                raise CompileError(f"{name} on non-numbers")
            attr = {"pow": "power", "hypot": "hypot",
                    "atan2": "arctan2"}[name]
            return CVal(K_FLOAT,
                        lambda env: getattr(env.xp, attr)(a.fn(env), b.fn(env)))
        raise CompileError(f"function {name} not device-compilable")


def _to_bool(v: CVal) -> CVal:
    if v.kind == K_BOOL:
        return v
    if v.kind in _NUMERIC:
        return CVal(K_BOOL, lambda env: v.fn(env) != 0)
    raise CompileError("cannot use value as a boolean")


def _cmp_fn(a: CVal, b: CVal, op: str):
    if op == "<":
        return lambda env: a.fn(env) < b.fn(env)
    if op == "<=":
        return lambda env: a.fn(env) <= b.fn(env)
    if op == ">":
        return lambda env: a.fn(env) > b.fn(env)
    if op == ">=":
        return lambda env: a.fn(env) >= b.fn(env)
    if op == "==":
        return lambda env: a.fn(env) == b.fn(env)
    return lambda env: a.fn(env) != b.fn(env)


def _py_cmp(a, b, op: str) -> bool:
    return {"<": a < b, "<=": a <= b, ">": a > b, ">=": a >= b,
            "==": a == b, "!=": a != b}[op]
