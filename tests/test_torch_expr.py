"""The port's expressions (nebula_tpu_torch/filter, tpu/expr_compile.py,
tpu/expr_program.py) against the JAX package's.

- The wire codec: the port writes every tree byte for byte as the
  reference's msgpack encoding, reads the reference's bytes back to the
  same tree, and refuses corrupt bytes with ExprError as the reference
  does.
- The compiler: over seeded WHERE trees on int, float, bool and string
  edge columns, src/dst vertex columns, rank, ``_dst`` / ``_src`` and
  ``_type``, the port and the reference raise CompileError on the same
  trees, record the same columns and div guards, and their masks are
  equal: the port's plain ``expr_filter_ref`` running the lowered
  ExprProgram against the reference's fused filter as
  ``TpuQueryRuntime._run_go_kernel`` builds it (jitted, CPU jax),
  exactly; the numpy closures the host YIELD path runs, exactly.
- The trouble spots: integer ``/`` and ``%`` at INT32_MIN, -1 and 0,
  float-to-int casts of NaN, infinities and out-of-range values,
  int literals beyond int32 (jax raises, the port declines), numeric
  and constant WHERE, a denormal column value (XLA on the CPU flushes
  it), fused multiply-adds and division by constants as XLA rewrites
  them.
- Transcendental functions: the WHERE's values agree within 4 ulp (the
  platforms' functions differ), and the masks exactly on data kept
  away from the threshold.

Inputs are seeded numpy arrays at a small size; the reference mirror is
built directly from them and carried into the port with
``mirror_from_reference``.
"""
import re

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from nebula_tpu.common.status import ErrorCode, Status, StatusOr
from nebula_tpu.filter import expressions as rex
from nebula_tpu.interface.common import SupportedType as RT
from nebula_tpu.tpu import csr as rcsr
from nebula_tpu.tpu import expr_compile as rec
from nebula_tpu.tpu.runtime import TpuQueryRuntime, _GoPlan
from nebula_tpu_torch.filter import expressions as pex
from nebula_tpu_torch.filter import wire
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.tpu import edge_ops
from nebula_tpu_torch.tpu import expr_compile as pec
from nebula_tpu_torch.tpu import expr_program as ep
from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

SPACE, TAG, N, M = 1, 7, 48, 360
ALIAS = {"e": 1, "f": 2}
OVER = (-2, -1, 1, 2)


# ============================================================ codec
def _lit(rng):
    c = int(rng.integers(0, 9))
    if c == 0:
        return bool(rng.random() < 0.5)
    if c == 1:
        return int(rng.choice([0, 1, 31, 127, 128, 255, 256, 65535,
                               65536, 2**32 - 1, 2**32, 2**63 - 1,
                               2**64 - 1]))
    if c == 2:
        return -int(rng.choice([1, 32, 33, 128, 129, 32768, 32769,
                                2**31, 2**31 + 1, 2**63]))
    if c == 3:
        return float(rng.standard_normal() * 10 ** int(rng.integers(-5,
                                                                    6)))
    if c == 4:
        return float(rng.choice([0.0, -0.0, 1e300, float("inf")]))
    if c == 5:
        return "x" * int(rng.choice([0, 1, 31, 32, 255, 256, 70000]))
    if c == 6:
        return "é名" * int(rng.integers(1, 20))
    return int(rng.integers(-2**31, 2**31))


def _wire_tree(rng, depth=3):
    """A to_wire list of a random tree over every KIND."""
    kinds = ["lit", "src", "dst", "edge", "input", "var", "e_type",
             "e_src", "e_dst", "e_rank", "fn", "unary", "cast", "arith",
             "rel", "logic"]
    k = kinds[int(rng.integers(0, len(kinds) if depth > 0 else 10))]
    if k == "lit":
        return ["lit", _lit(rng)]
    if k in ("src", "dst", "var"):
        return [k, f"t{int(rng.integers(0, 3))}", "p" * int(rng.integers(1, 40))]
    if k == "edge":
        return ["edge", "e", f"q{int(rng.integers(0, 99))}"]
    if k == "input":
        return ["input", "col"]
    if k in ("e_type", "e_src", "e_dst", "e_rank"):
        return [k, str(rng.choice(["", "e", "follow"]))]
    if k == "fn":
        n_args = int(rng.choice([0, 1, 2, 16, 17]))
        return ["fn", str(rng.choice(["abs", "pow", "hash"])),
                [_wire_tree(rng, 0) for _ in range(n_args)]]
    if k == "unary":
        return ["unary", str(rng.choice(["+", "-", "!"])),
                _wire_tree(rng, depth - 1)]
    if k == "cast":
        return ["cast", str(rng.choice(["int", "double", "string",
                                        "bool"])),
                _wire_tree(rng, depth - 1)]
    op = {"arith": ["+", "-", "*", "/", "%", "^"],
          "rel": ["<", "<=", ">", ">=", "==", "!="],
          "logic": ["&&", "||"]}[k]
    return [k, str(rng.choice(op)), _wire_tree(rng, depth - 1),
            _wire_tree(rng, depth - 1)]


@pytest.mark.parametrize("seed", range(6))
def test_codec_byte_equal_to_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        w = _wire_tree(rng)
        rtree = rex._from_wire(w)
        ptree = pex._from_wire(w)
        try:
            want = rex.encode_expr(rtree)
        except OverflowError:
            with pytest.raises(OverflowError):
                pex.encode_expr(ptree)
            continue
        assert want == msgpack.packb(rtree.to_wire(), use_bin_type=True)
        got = pex.encode_expr(ptree)
        assert got == want, str(rtree)
        back = pex.decode_expr(want)
        assert str(back) == str(rtree)
        assert pex.encode_expr(back) == want
        assert wire.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_every_kind_round_trips():
    trees = [["lit", 5], ["lit", -40], ["lit", 2.5], ["lit", True],
             ["lit", "s"], ["src", "t", "p"], ["dst", "t", "p"],
             ["edge", "e", "w"], ["input", "c"], ["var", "v", "p"],
             ["e_type", "e"], ["e_src", "e"], ["e_dst", "e"],
             ["e_rank", "e"], ["fn", "abs", [["lit", -1]]],
             ["unary", "!", ["lit", False]],
             ["cast", "double", ["lit", 3]],
             ["arith", "%", ["lit", 7], ["lit", 2]],
             ["rel", "<", ["lit", 1], ["lit", 2]],
             ["logic", "||", ["lit", True], ["lit", False]]]
    for w in trees:
        want = rex.encode_expr(rex._from_wire(w))
        got = pex.encode_expr(pex._from_wire(w))
        assert got == want
        assert pex.decode_expr(want).to_wire() == w


@pytest.mark.parametrize("blob", [
    b"", b"\xc1", b"\x92\xa3lit", b"\x92\xa3lit\x05\x05",
    b"\x92\xa4nope\x05", b"\x05", b"\x93\xa4edge\xa1e",
    b"\xd9\x05ab", b"\x92\xa3lit\xd9\x02\xff\xfe", b"\xc4\x03abc"])
def test_codec_corrupt_bytes_raise_on_both(blob):
    with pytest.raises(rex.ExprError):
        rex.decode_expr(blob)
    with pytest.raises(pex.ExprError):
        pex.decode_expr(blob)


# ====================================================== shared state
class _RefNames:
    """The reference schema manager's tag lookup, as ExprCompiler
    reads it."""

    def to_tag_id(self, space_id, name):
        if name == "person":
            return StatusOr.of(TAG)
        return StatusOr.error(Status(ErrorCode.E_SCHEMA_NOT_FOUND, name))


def _col(name, stype, vals, valid=None):
    c = rcsr.Column(name, stype, len(vals))
    if stype == RT.STRING:
        c.raw = [str(v) for v in vals]
    else:
        c.values[:] = vals
    c.valid[:] = True if valid is None else valid
    c.finalize()
    return c


def _state(seed=0):
    """(reference mirror, port mirror): a seeded graph with int, float,
    bool and string edge columns on etypes +-1 and +-2 (edge and
    reverse rows), a tag on 7/8 of the vertices, trouble-spot values
    in the first rows."""
    rng = np.random.default_rng(seed)
    m = rcsr.CsrMirror(SPACE)
    m.vids = np.sort(rng.choice(10_000, N, replace=False)).astype(np.int64)
    m.n, m.m = N, M
    m.edge_src = np.sort(rng.integers(0, N, M)).astype(np.int32)
    m.edge_dst = rng.integers(0, N, M).astype(np.int32)
    m.edge_etype = rng.choice([-2, -1, 1, 2], M).astype(np.int32)
    m.edge_rank = rng.integers(-9, 9, M).astype(np.int64)
    m.row_ptr = np.concatenate([[0], np.cumsum(np.bincount(
        m.edge_src, minlength=N))]).astype(np.int32)
    iv = rng.integers(-1000, 1000, M)
    iv[:8] = [0, -1, 2**31 - 1, -2**31 + 1, 7, -7, 1, 3]
    fv = (rng.standard_normal(M) * rng.choice([1e-3, 1.0, 1e3], M))
    fv[:8] = [0.0, -0.0, 1e-40, 3.0, -2.5, 0.5, 1e30, -1e30]
    fv = fv.astype(np.float32).astype(np.float64)    # float32-exact
    bv = rng.random(M) < 0.5
    sv = rng.choice(["a", "b", "c", "dd", "z"], M)
    for et in OVER:
        m.edge_cols[(et, "i")] = _col("i", RT.INT, iv)
        m.edge_cols[(et, "f")] = _col("f", RT.DOUBLE, fv)
        m.edge_cols[(et, "b")] = _col("b", RT.BOOL, bv)
        m.edge_cols[(et, "s")] = _col("s", RT.STRING, sv)
    has = rng.random(N) < 7 / 8
    m.vertex_cols[(TAG, "age")] = _col("age", RT.INT,
                                       rng.integers(0, 100, N), has)
    m.vertex_cols[(TAG, "h")] = _col(
        "h", RT.DOUBLE,
        (rng.random(N) * 2.0).astype(np.float32).astype(np.float64), has)
    m.has_tag[TAG] = has
    pm = mirror_from_reference(
        {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=SPACE,
        edge_cols=m.edge_cols, vertex_cols=m.vertex_cols,
        has_tag=m.has_tag)
    return m, pm


@pytest.fixture(scope="module")
def state():
    m, pm = _state()
    ref_rt = TpuQueryRuntime([], _RefNames())
    port_rt = TorchQueryRuntime(device="cpu")
    port_rt.load_space(SPACE, pm, SchemaView().add_space(
        SPACE, {"person": TAG}, {"e": 1, "f": 2}))
    yield m, pm, ref_rt, port_rt
    port_rt.close()


def _ref_mask(ref_rt, m, tree, pushed):
    """The reference's fused WHERE mask: ``_run_go_kernel``'s jitted
    program at one step from every vertex over every etype present, so
    the final edge mask is the filter mask itself."""
    comp = rec.ExprCompiler(m, SPACE, _RefNames(), ALIAS)
    cval = comp.compile(tree)
    plan = _GoPlan(m, ALIAS, cval, dict(comp.used), pushed, comp,
                   str(tree) + str(pushed), False)
    start = np.arange(N, dtype=np.int32)
    final, _frontier = ref_rt._run_go_kernel(m, SPACE, 1, OVER, plan, start)
    return np.asarray(final), comp


def _port_program(pm, tree, pushed, root="mask"):
    comp = pec.ExprCompiler(pm, SPACE, SchemaView().add_space(
        SPACE, {"person": TAG}, {"e": 1, "f": 2}), ALIAS)
    cval = comp.compile(tree)
    types = {k: {np.dtype(bool): ep.B, np.dtype(np.int32): ep.I,
                 np.dtype(np.float32): ep.F}[np.dtype(
                     TorchQueryRuntime._col_dtype(pm, d))]
             for k, d in comp.used.items()}
    prog = ep.trace_filter(cval, comp.used, comp.div_guards, pushed, types,
                           root=root)
    return prog, comp


def _port_run(port_rt, pm, prog, comp, pushed, root="mask"):
    env = port_rt._env_cols(pm, ALIAS, comp.used, with_valid=pushed)
    slots = [env[k] for k, _kind, _t in prog.slots]
    src = torch.from_numpy(pm.edge_src)
    dst = torch.from_numpy(pm.edge_dst)
    if root == "value":
        return ep.run_program(prog, slots, src, dst).numpy()
    out = torch.empty(pm.m, dtype=torch.bool)
    return edge_ops.expr_filter(prog, slots, src, dst, out).numpy()


# ==================================================== tree generator
def _num(rng, d):
    if d <= 0 or rng.random() < 0.3:
        c = int(rng.integers(0, 9))
        return [["edge", "e", "i"], ["edge", "e", "f"],
                ["dst", "person", "age"], ["src", "person", "h"],
                ["e_rank", "e"],
                ["lit", int(rng.choice([0, 1, 2, 3, 7, -5, 1000,
                                        2**31 - 1]))],
                ["lit", float(rng.choice([0.5, 2.0, 3.0, -1.5, 0.1, 1e-3,
                                          1e30]))],
                ["cast", "int", ["edge", "e", "b"]],
                ["edge", "f", "i"]][c]
    c = int(rng.integers(0, 10))
    if c < 5:
        op = str(rng.choice(["+", "-", "*", "/", "%", "^"],
                            p=[.22, .22, .22, .16, .14, .04]))
        return ["arith", op, _num(rng, d - 1), _num(rng, d - 1)]
    if c == 5:
        return ["unary", "-", _num(rng, d - 1)]
    if c == 6:
        return ["cast", str(rng.choice(["int", "double"])),
                _num(rng, d - 1)]
    if c == 7:
        return ["fn", str(rng.choice(["abs", "floor", "ceil", "round",
                                      "sqrt"])), [_num(rng, d - 1)]]
    if c == 8:
        return ["fn", "hypot", [_num(rng, d - 1), _num(rng, d - 1)]]
    return ["fn", "pow", [_num(rng, d - 1),
                          ["lit", int(rng.integers(0, 4))]]]


def _pred(rng, d):
    c = int(rng.integers(0, 10))
    if d <= 0 or c < 4:
        return ["rel", str(rng.choice(["<", "<=", ">", ">=", "==", "!="])),
                _num(rng, 2), _num(rng, 2)]
    if c == 4:
        return ["logic", str(rng.choice(["&&", "||"])), _pred(rng, d - 1),
                _pred(rng, d - 1)]
    if c == 5:
        return ["unary", "!", _pred(rng, d - 1)]
    if c == 6:
        return ["rel", str(rng.choice(["<", "==", "!=", ">="])),
                ["edge", "e", "s"],
                ["lit", str(rng.choice(["a", "b", "c", "zz", ""]))]]
    if c == 7:
        x = ["e_dst", "e"] if rng.random() < 0.5 else ["e_src", "e"]
        return ["rel", str(rng.choice(["<", "<=", "==", "!=", ">"])), x,
                ["lit", int(rng.choice([5, 100, 4999, 9999, 20000]))]]
    if c == 8:
        return ["rel", str(rng.choice(["==", "!="])), ["e_type", "e"],
                ["lit", str(rng.choice(["e", "f", "g"]))]]
    return ["logic", "&&", ["edge", "e", "b"], _pred(rng, d - 1)]


def _check_tree(state, w, pushed):
    """Compile both sides; equal CompileError outcome, used columns and
    guard count; equal masks.  Returns True when it compiled."""
    m, pm, ref_rt, port_rt = state
    rtree, ptree = rex._from_wire(w), pex._from_wire(w)
    try:
        want, rcomp = _ref_mask(ref_rt, m, rtree, pushed)
    except (rec.CompileError, OverflowError):
        # an uncompilable tree, or jax's OverflowError on a Python int
        # beyond int32: the port raises CompileError (and declines)
        with pytest.raises(pec.CompileError):
            _port_program(pm, ptree, pushed)
        return False
    prog, pcomp = _port_program(pm, ptree, pushed)
    assert pcomp.used == rcomp.used, str(rtree)
    assert len(pcomp.div_guards) == len(rcomp.div_guards)
    got = _port_run(port_rt, pm, prog, pcomp, pushed)
    assert np.array_equal(got, want), (str(rtree), prog.ops)
    return True


@pytest.mark.parametrize("seed", range(10))
def test_compiled_where_masks_equal_reference(state, seed):
    rng = np.random.default_rng(100 + seed)
    compiled = 0
    for i in range(24):
        compiled += _check_tree(state, _pred(rng, 2), pushed=i % 3 != 2)
    assert compiled >= 6


@pytest.mark.parametrize("seed", range(4))
def test_host_closures_equal_reference(state, seed):
    """The numpy closures the YIELD path evaluates: int64 / float64
    columns gathered as ``_gather_cols`` gathers them."""
    m, pm, ref_rt, port_rt = state
    rng = np.random.default_rng(200 + seed)
    idx = np.arange(M)
    for _ in range(30):
        w = _num(rng, 2) if rng.random() < 0.6 else _pred(rng, 1)
        try:
            rcomp = rec.ExprCompiler(m, SPACE, _RefNames(), ALIAS)
            rcv = rcomp.compile(rex._from_wire(w))
        except rec.CompileError:
            continue
        pcomp = pec.ExprCompiler(pm, SPACE, port_rt._schema(SPACE), ALIAS)
        pcv = pcomp.compile(pex._from_wire(w))
        assert pcv.kind == rcv.kind
        with np.errstate(all="ignore"):
            want = _outcome(lambda: rcv.fn(rec.Env(np, ref_rt._gather_cols(
                m, ALIAS, rcomp.used, idx))))
            got = _outcome(lambda: pcv.fn(pec.Env(np, port_rt._gather_cols(
                pm, ALIAS, pcomp.used, idx))))
        if isinstance(want, str):
            assert got == want, w
            continue
        assert got.dtype == want.dtype, w
        assert np.array_equal(got, want,
                              equal_nan=want.dtype.kind == "f"), w


def _outcome(fn):
    """The array ``fn`` returns, or the name of what it raised."""
    try:
        return np.asarray(fn())
    except Exception as e:      # noqa: BLE001 — compared by type
        return type(e).__name__


# ================================================== trouble spots
def _int_cols(**cols):
    """A state whose edges carry int columns ``name -> values`` (values
    repeated to M rows) on every etype."""
    m, pm = _state(1)
    for name, vals in cols.items():
        v = np.resize(np.asarray(vals, np.int64), M)
        for et in OVER:
            m.edge_cols[(et, name)] = _col(name, RT.INT, v)
    pm = mirror_from_reference(
        {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=SPACE,
        edge_cols=m.edge_cols, vertex_cols=m.vertex_cols,
        has_tag=m.has_tag)
    return m, pm


@pytest.mark.parametrize("op", ["/", "%"])
def test_integer_division_edge_cases(op):
    """sign(x)*sign(y)*(|x| // max(|y|, 1)) in int32 at INT32_MIN, -1, 0
    and mixed signs.  An int32 column stops above INT32_MIN (the
    reference's device representability), so the dividend is ``a - k``
    with k = 1 where a = -2**31 + 1: INT32_MIN, by int32 wraparound."""
    specials = [-2**31 + 1, -7, -1, 0, 1, 7, 2**31 - 1]
    xs, ys = np.meshgrid(specials, specials)
    a, b = xs.ravel(), ys.ravel()
    k = (a == -2**31 + 1).astype(np.int64)
    k[::3] = 0                            # both INT32_MIN + 1 and MIN
    m, pm = _int_cols(a=a, b=b, k=k)
    ref_rt = TpuQueryRuntime([], _RefNames())
    port_rt = TorchQueryRuntime(device="cpu")
    port_rt.load_space(SPACE, pm)
    x = ["arith", "-", ["edge", "e", "a"], ["edge", "e", "k"]]
    try:
        for cmp_lit in (-2**31 + 1, -1, 0, 1, 3):
            for y in (["edge", "e", "b"], ["lit", -1], ["lit", 7]):
                w = ["rel", ">=", ["arith", op, x, y], ["lit", cmp_lit]]
                st = (m, pm, ref_rt, port_rt)
                assert _check_tree(st, w, True)
                if y[0] == "lit":         # no div guard: graphd mode too
                    assert _check_tree(st, w, False)
    finally:
        port_rt.close()


def test_float_to_int_casts_of_specials(state):
    """NaN, +-inf and out-of-range floats cast to int32: XLA's run-time
    conversion saturates and maps NaN to 0; a constant cast folds to
    INT32_MIN, as XLA's constant folder gives it."""
    m, pm, ref_rt, port_rt = state
    for lit in (2**31 - 1, -2**31 + 1, 0, 3):
        for x in (["arith", "*", ["edge", "e", "f"], ["lit", 1e30]],
                  ["arith", "/", ["edge", "e", "f"], ["lit", 0.0]],
                  ["arith", "-", ["edge", "e", "f"], ["edge", "e", "f"]],
                  ["lit", 1e30], ["lit", float("nan")]):
            w = ["rel", "<", ["cast", "int", x], ["lit", lit]]
            assert _check_tree(state, w, True)


def test_int_literal_beyond_int32_declines(state):
    """jax raises OverflowError on a Python int outside int32 meeting an
    array; the port's lowering raises CompileError and serve_go
    declines."""
    m, pm, ref_rt, port_rt = state
    w = ["rel", ">", ["edge", "e", "i"], ["lit", 2**31]]
    with pytest.raises(OverflowError):
        _ref_mask(ref_rt, m, rex._from_wire(w), True)
    with pytest.raises(pec.CompileError):
        _port_program(pm, pex._from_wire(w), True)
    blob = pex.encode_expr(pex._from_wire(w))
    ydst = [(pex.encode_expr(pex._from_wire(["e_dst", "e"])), None)]
    from nebula_tpu_torch.storage.device import TpuDecline
    with pytest.raises(TpuDecline):
        port_rt.serve_go(SPACE, [int(pm.vids[0])], [1], 1, {1: "e"},
                         where_blob=blob, yield_specs=ydst)
    # the same literal in Python arithmetic that comes back into range
    w = ["rel", ">", ["edge", "e", "i"],
         ["arith", "-", ["lit", 2**31], ["lit", 5]]]
    assert _check_tree(state, w, True)


@pytest.mark.parametrize("w", [
    ["edge", "e", "i"],                                   # numeric WHERE
    ["edge", "e", "f"],
    ["arith", "%", ["edge", "e", "i"], ["lit", 2]],
    ["lit", True], ["lit", 0], ["lit", 2.5],              # constants
    ["rel", "<", ["lit", 1], ["lit", 2]],
    ["rel", ">", ["edge", "e", "f"], ["lit", 0.0]],       # 1e-40 flushes
    ["rel", "==", ["edge", "e", "f"], ["lit", 0.0]],
    ["rel", "<", ["arith", "*", ["edge", "e", "f"], ["lit", 1e30]],
     ["lit", 1e-9]],
])
def test_numeric_constant_and_denormal_where(state, w):
    assert _check_tree(state, w, True)
    assert _check_tree(state, w, False)


@pytest.mark.parametrize("w", [
    # a*b + c contracts into one fused multiply-add (XLA's CPU code)
    ["rel", ">", ["arith", "+", ["arith", "*", ["edge", "e", "f"],
                                 ["src", "person", "h"]],
                  ["edge", "f", "f"]], ["lit", 0.25]],
    ["rel", "<", ["arith", "-", ["lit", 0.3],
                  ["arith", "*", ["edge", "e", "f"], ["lit", 3.0]]],
     ["src", "person", "h"]],
    # A / C is A * (1 / C); (A / B) / C is A / (B * C)
    ["rel", ">=", ["arith", "/", ["edge", "e", "f"], ["lit", 3.0]],
     ["arith", "/", ["arith", "/", ["edge", "e", "i"],
                     ["src", "person", "h"]], ["edge", "f", "f"]]],
    # constants fold through (A + C1) + C2 and (A * C1) * C2
    ["rel", "==", ["arith", "+", ["arith", "+", ["edge", "e", "f"],
                                  ["lit", 0.1]], ["lit", 0.7]],
     ["arith", "*", ["arith", "*", ["edge", "e", "f"], ["lit", 3.0]],
      ["lit", 0.1]]],
])
def test_xla_float_rewrites(state, w):
    assert _check_tree(state, w, True)


_TRANS = ["exp", "log", "log2", "log10", "sin", "cos", "tan", "asin",
          "acos", "atan", "cbrt", "exp2"]


def _ulp_close(a, b, ulps=4):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(2**31) - ia, ia)
    ib = np.where(ib < 0, -(2**31) - ib, ib)
    return same | (np.abs(ia - ib) <= ulps)


@pytest.mark.parametrize("fn", _TRANS + ["pow", "atan2", "rsqrt"])
def test_transcendental_values_within_4_ulp(state, fn):
    """The WHERE's value through the port's program against the
    reference closures under jit: within 4 ulp; and the mask of a
    compare, exactly, where the value is 1e-3 or more from the
    threshold."""
    m, pm, ref_rt, port_rt = state
    x = ["src", "person", "h"]            # values in [0, 2)
    if fn == "pow":
        v = ["fn", "pow", [x, ["lit", 1.7]]]
    elif fn == "atan2":
        v = ["fn", "atan2", [x, ["arith", "-", x, ["lit", 1.0]]]]
    elif fn == "rsqrt":                  # A / sqrt(B) -> A * rsqrt(B)
        v = ["arith", "/", ["edge", "e", "f"], ["fn", "sqrt",
                                                [["arith", "+", x,
                                                  ["lit", 0.5]]]]]
    elif fn in ("asin", "acos"):
        v = ["fn", fn, [["arith", "-", x, ["lit", 1.0]]]]
    else:
        v = ["fn", fn, [["arith", "+", x, ["lit", 0.25]]]]
    rtree = rex._from_wire(v)
    rcomp = rec.ExprCompiler(m, SPACE, _RefNames(), ALIAS)
    rcv = rcomp.compile(rtree)
    cols = {}
    for k, d in rcomp.used.items():
        col = m.edge_cols[(d[1], d[2])] if d[0] == "edge" \
            else m.vertex_cols[(d[1], d[2])]
        arr = jnp.asarray(col.device_values())
        cols[k] = arr if d[0] == "edge" else \
            arr[jnp.asarray(m.edge_src if d[3] == "src" else m.edge_dst)]
    want = np.asarray(jax.jit(lambda c: rcv.fn(rec.Env(jnp, c)))(cols))
    prog, pcomp = _port_program(pm, pex._from_wire(v), False, root="value")
    assert prog.transcendental
    got = _port_run(port_rt, pm, prog, pcomp, False, root="value")
    assert _ulp_close(got, want).all(), fn
    thr = float(np.float32(np.nanmedian(want)))
    far = np.abs(want - thr) >= 1e-3
    w = ["rel", ">", v, ["lit", thr]]
    rmask, _ = _ref_mask(ref_rt, m, rex._from_wire(w), False)
    prog, pcomp = _port_program(pm, pex._from_wire(w), False)
    pmask = _port_run(port_rt, pm, prog, pcomp, False)
    assert far.sum() > M // 2
    assert np.array_equal(pmask[far], rmask[far])


def test_program_limits_decline():
    """A WHERE needing more registers than the kernel holds raises
    CompileError at lowering (the query declines)."""
    m, pm = _state(2)
    w = ["edge", "e", "i"]
    for k in range(40):                  # a left-deep chain of sums
        w = ["arith", "+", w, ["arith", "*", ["edge", "e", "i"],
                               ["lit", k + 2]]]
    w = ["rel", ">", w, ["lit", 0]]
    rec.ExprCompiler(m, SPACE, _RefNames(), ALIAS).compile(
        rex._from_wire(w))
    prog, _ = _port_program(pm, pex._from_wire(w), True)
    assert prog.n_regs <= ep.MAX_REGS
    wide = ["lit", True]
    for k in range(70):                  # 70 live compares, then ANDs
        wide = ["logic", "&&", ["rel", ">", ["arith", "*", ["edge", "e",
                                                             "f"],
                                             ["lit", float(k) + 0.5]],
                                ["edge", "f", "f"]], wide]
    with pytest.raises(pec.CompileError):
        _port_program(pm, pex._from_wire(wide), True)


def test_kernel_opcodes_match_the_program():
    """The interpreter's opcode enum (csrc/expr_core.cuh, which both
    expr_filter.cu and edge_go.cu's fused final pass include) lists
    expr_program's opcodes in the same order (the kernel cannot be run
    here)."""
    import os
    src = open(os.path.join(os.path.dirname(ep.__file__), "csrc",
                            "expr_core.cuh")).read()
    enum = dict((name, int(v)) for name, v in
                re.findall(r"OP_([A-Z0-9_]+) = (\d+)", src))
    assert enum == ep.OPCODE
    for name in ep.OPCODE:
        assert f"case OP_{name}:" in src, name
    assert f"kMaxRegs = {ep.MAX_REGS};" in src
    assert f"kMaxIns = {ep.MAX_INS};" in src
    assert f"kMaxSlots = {ep.MAX_SLOTS};" in src
