"""The dispatcher's host WHERE filter and grouped YIELD materialization
(``TorchQueryRuntime._host_filter``, ``_assemble_group``,
``_materialize_group``, ``_assemble_results``; reference
``nebula_tpu/tpu/runtime.py:2431-2722``, ``:2923-3000``) against the
reference ``TpuQueryRuntime`` of a JAX ``LocalCluster`` on the same
state.

The space has ``person(age int, name string)`` on most vertices and
edges ``e(w int, score double, kind string)``, ``f(w int)`` and
``g(w int)``, with a few ``w = 0`` where a WHERE divides.  The cluster's
mirror, its columns and the tag and edge names are carried into the
port.  For a seeded mix of the shapes the dispatcher serves — WHERE with
UPTO in both pushed modes, every WHERE of the family under
``tpu_filter_mode=host``, YIELD props and meta columns with no WHERE,
DISTINCT, meta-only ``| LIMIT n`` and ``| YIELD COUNT(*)``, ``OVER e,
f``, ``OVER *`` and ``REVERSELY`` — in continuous, windowed-sparse and
windowed-dense mode, the port's ``serve_go`` gives the reference's
columns and rows in the same order, or the same ``TpuDecline`` or
``DeviceExecError``.  Both sides run the plain kernel versions on the
CPU (the port) and CPU jax (the reference).
"""
from types import SimpleNamespace

import numpy as np
import pytest

from nebula_tpu.cluster import LocalCluster
from nebula_tpu.common.flags import flags as ref_flags
from nebula_tpu.filter import expressions as rex
from nebula_tpu.storage.device import DeviceExecError as RefExecError
from nebula_tpu.tpu.runtime import _GoQuery as RefQuery
from nebula_tpu_torch.common.flags import flags
from nebula_tpu_torch.filter.expressions import decode_expr
from nebula_tpu_torch.graph.interim import ColumnarRows, ConstCol, DictCol
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.storage.device import DeviceExecError, TpuDecline
from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
from nebula_tpu_torch.tpu.runtime import (TorchQueryRuntime, _GoQuery,
                                          _YieldCol)

N_VERTICES = 60
BASE = {"tpu_ell_cap": 8, "tpu_filter_mode": "auto",
        "go_dispatch_mode": "continuous", "tpu_sparse_go": True,
        "tpu_adaptive_single": True}
MODES = {
    "continuous": {"go_dispatch_mode": "continuous"},
    "sparse": {"go_dispatch_mode": "windowed"},
    "dense": {"go_dispatch_mode": "windowed", "tpu_sparse_go": False,
              "tpu_adaptive_single": False},
}


def _set_flags(registry, values):
    """Set ``values`` on a flag registry; returns the old values."""
    old = {k: registry.get(k) for k in values}
    for k, v in values.items():
        assert registry.set(k, v), k
    return old


def _edges(seed=41, n=N_VERTICES, k=420):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, k)
    dst = rng.integers(1, n + 1, k)
    src[:30] = 1                         # a hub past cap 8
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.integers(0, 40, len(src))
    w[::11] = 0                          # zero divisors
    score = rng.integers(0, 48, len(src)) / 8.0
    kind = rng.integers(0, 4, len(src))
    return src, dst, w, score, kind


def _people(seed=7, n=N_VERTICES):
    """(vids, ages, names) of the vertices that carry the tag."""
    rng = np.random.default_rng(seed)
    vids = np.asarray([v for v in range(1, n + 1) if v % 6], np.int64)
    return vids, rng.integers(0, 90, len(vids)), [f"n{v % 7}" for v in vids]


def _carry(m, space, names, tag):
    """A port runtime holding the reference mirror ``m`` with its
    columns and names."""
    port = TorchQueryRuntime(device="cpu")
    port.load_space(space, mirror_from_reference(
        {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=space,
        edge_cols=m.edge_cols, vertex_cols=m.vertex_cols,
        has_tag=m.has_tag, build_version=m.build_version),
        SchemaView().add_space(space, {"person": tag}, names))
    return port


@pytest.fixture(scope="module")
def cluster():
    """(ok, reference runtime, port runtime, space, {alias: etype},
    the reference mirror, the tag id of person)."""
    c = LocalCluster(num_storage=1, tpu_backend=True)
    port = None
    # after the cluster's start, which resets the reference's flags
    old_ref = _set_flags(ref_flags, BASE)
    old = _set_flags(flags, BASE)
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok.cluster = c
        ok("CREATE SPACE h(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE h")
        ok("CREATE TAG person(age int, name string)")
        ok("CREATE EDGE e(w int, score double, kind string)")
        ok("CREATE EDGE f(w int)")
        ok("CREATE EDGE g(w int)")
        c.refresh_all()
        vids, ages, names = _people()
        ok("INSERT VERTEX person(age, name) VALUES " + ", ".join(
            f'{v}:({a}, "{nm}")' for v, a, nm in zip(vids, ages, names)))
        src, dst, w, score, kind = _edges()
        ok("INSERT EDGE e(w, score, kind) VALUES " + ", ".join(
            f'{a} -> {b}:({x}, {s}, "k{t}")'
            for a, b, x, s, t in zip(src, dst, w, score, kind)))
        ok("INSERT EDGE f(w) VALUES " + ", ".join(
            f"{a} -> {b}:({a % 3})" for a, b in zip(dst[:90], src[:90])))
        ok("INSERT EDGE g(w) VALUES " + ", ".join(
            f"{a} -> {b}:({b % 5})" for a, b in zip(src[90:120],
                                                     dst[100:130])
            if a != b))
        ok("GO 2 STEPS FROM 1 OVER e WHERE e.w > 3 YIELD e._dst")
        rt = c.tpu_runtime
        space = next(iter(rt.mirrors))
        m = rt.mirror(space)
        ets = {a: rt.sm.to_edge_type(space, a).value()
               for a in ("e", "f", "g")}
        tag = rt.sm.to_tag_id(space, "person").value()
        port = _carry(m, space, ets, tag)
        yield ok, rt, port, space, ets, m, tag
    finally:
        if port is not None:
            port.close()
        c.stop()
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


@pytest.fixture
def both():
    """Set flags on both registries for one test; yields the setter."""
    saved = []

    def use(values):
        saved.append((_set_flags(ref_flags, values),
                      _set_flags(flags, values)))
    yield use
    for old_ref, old in reversed(saved):
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


E = ["edge", "e"]
WHERES = [
    ["rel", ">", E + ["w"], ["lit", 3]],
    ["logic", "&&", ["rel", "<=", E + ["score"], ["lit", 2.5]],
     ["rel", "==", E + ["kind"], ["lit", "k1"]]],
    ["rel", "==", ["arith", "%", E + ["w"], ["lit", 3]], ["lit", 1]],
    ["rel", ">", ["dst", "person", "age"], ["lit", 30]],
    ["logic", "||", ["rel", "<", ["src", "person", "age"], ["lit", 50]],
     ["rel", ">", E + ["w"], ["lit", 30]]],
    ["rel", ">", ["arith", "/", ["lit", 100], E + ["w"]], ["lit", 20]],
    ["logic", "&&", ["rel", ">", ["e_dst", "e"], ["lit", 10]],
     ["rel", "!=", E + ["kind"], ["lit", "k0"]]],
    ["rel", ">", ["arith", "+", ["arith", "*", E + ["score"], ["lit", 2]],
                  E + ["w"]], ["lit", 6.5]],
    ["unary", "!", ["rel", ">=", E + ["w"], ["lit", 5]]],
    ["rel", "==", ["e_type", "e"], ["lit", "e"]],
    ["rel", ">", E + ["kind"], ["lit", "k1"]],
    ["arith", "-", E + ["w"], ["lit", 4]],           # numeric: nonzero keeps
]
YIELDS = [
    (["e_dst", "e"], None), (E + ["w"], None), (E + ["score"], None),
    (E + ["kind"], "k"), (["dst", "person", "age"], None),
    (["src", "person", "name"], None), (["e_src", "e"], None),
    (["e_rank", "e"], None), (["e_type", "e"], "t"),
    (["arith", "+", ["arith", "*", E + ["w"], ["lit", 2]], ["lit", 1]],
     "w2"),
    (["lit", "x"], None), (["rel", ">", E + ["w"], ["lit", 9]], None),
    (["arith", "/", ["lit", 60], E + ["w"]], "q"),
]
META = [(["e_src", "e"], None), (["e_dst", "e"], None),
        (["e_rank", "e"], None), (["e_type", "e"], None)]
OVERS = [("e",), ("e", "f"), ("e", "f", "g")]      # OVER e / e, f / *
SHAPES = ("where_upto", "host", "props", "distinct", "limit", "count")


def _blob(w):
    return rex.encode_expr(rex._from_wire(w))


def _outcome(fn, limit=None):
    try:
        cols, rows = fn()
        rows = [list(r) for r in rows]
        return ("ok", list(cols), rows if limit is None else rows[:limit])
    except Exception as e:       # noqa: BLE001 — compared by type
        return ("raised", type(e).__name__)


def _over(ets, aliases, reverse):
    sign = -1 if reverse else 1
    e2a = {sign * ets[a]: a for a in aliases}
    return list(e2a), e2a


def _query(rng, shape):
    """One request of ``shape``: starts, steps, OVER aliases, REVERSELY,
    WHERE, YIELD, DISTINCT, UPTO, reduction, LIMIT and whether it runs
    under tpu_filter_mode=host."""
    starts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                           int(rng.integers(1, 4)))]
    if rng.random() < 0.1:
        starts.append(10 ** 6)           # an absent vid drops
    q = dict(starts=starts, steps=int(rng.integers(1, 4)),
             over=OVERS[int(rng.integers(0, len(OVERS)))],
             reverse=bool(rng.random() < 0.3), where=None, distinct=False,
             upto=False, reduce=None, limit=None, host=False)
    picks = rng.choice(len(YIELDS), int(rng.integers(1, 4)), replace=False)
    q["yields"] = [(_blob(YIELDS[i][0]), YIELDS[i][1]) for i in picks]
    if shape in ("where_upto", "host"):
        q["where"] = _blob(WHERES[int(rng.integers(0, len(WHERES)))])
        q["distinct"] = bool(rng.random() < 0.25)
    if shape == "where_upto":
        q["upto"], q["steps"] = True, int(rng.integers(2, 4))
    elif shape == "host":
        q["host"] = True
        q["upto"] = bool(rng.random() < 0.3)
    elif shape == "props":
        q["upto"] = bool(rng.random() < 0.25)
    elif shape == "distinct":
        q["distinct"] = True
    else:
        picks = rng.choice(len(META), int(rng.integers(1, 3)),
                           replace=False)
        q["yields"] = [(_blob(META[i][0]), META[i][1]) for i in picks]
        if shape == "limit":
            q["limit"] = int(rng.integers(1, 8))
        else:
            q["reduce"] = ("count",)
    return q


def _both(cluster, q, pushed, both):
    """(the reference's outcome, the port's) for one request."""
    _ok, rt, port, space, ets = cluster[:5]
    etypes, e2a = _over(ets, q["over"], q["reverse"])
    red = ("limit", q["limit"]) if q["limit"] is not None else q["reduce"]
    if q["host"]:
        both({"tpu_filter_mode": "host"})
    want = _outcome(lambda: rt.serve_go(
        space, q["starts"], etypes, q["steps"], e2a, q["yields"],
        q["distinct"], q["where"], pushed, upto=q["upto"], reduce=red),
        q["limit"])
    got = _outcome(lambda: port.serve_go(
        space, q["starts"], etypes, q["steps"], e2a, upto=q["upto"],
        reduce=q["reduce"], limit=q["limit"], where_blob=q["where"],
        yield_specs=q["yields"], distinct=q["distinct"],
        pushed_mode=pushed))
    if q["host"]:
        both({"tpu_filter_mode": "auto"})
    return want, got


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("pushed", [True, False])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_mix_matches_reference(cluster, both, mode, pushed, seed):
    """(1) A seeded mix of every served shape, in one dispatch mode and
    pushed mode: the same columns and rows in order, or the same
    decline or error, as the reference's ``serve_go``."""
    both(MODES[mode])
    port = cluster[2]
    rng = np.random.default_rng(100 * seed + 10 * pushed
                                + sorted(MODES).index(mode))
    kinds = {}
    fused0 = port.stats["go_fused"]
    for i in range(18):
        shape = SHAPES[i % len(SHAPES)]
        q = _query(rng, shape)
        want, got = _both(cluster, q, pushed, both)
        assert got == want, q
        kind = "rows" if want[0] == "ok" and want[2] else want[-1] \
            if want[0] == "raised" else "empty"
        kinds.setdefault(kind, []).append(shape)
    print(mode, pushed, seed, {k: len(v) for k, v in kinds.items()})
    assert len(kinds.get("rows", ())) >= 6, kinds
    assert port.stats["go_fused"] == fused0    # nothing here fuses


@pytest.mark.parametrize("shape", SHAPES)
def test_each_shape_is_served(cluster, both, shape):
    """Every shape of the mix is answered, not declined, on a request
    that reads only valid props; the UPTO and multi-alias ones ride the
    continuous stream in continuous mode."""
    _ok, _rt, port, space, ets = cluster[:5]
    both(MODES["continuous"])
    rng = np.random.default_rng(7)
    served = 0
    for over in OVERS:
        q = _query(rng, shape)
        q.update(over=over, starts=[1, 2], steps=2, reverse=False)
        if shape in ("where_upto", "host"):
            q["where"] = _blob(WHERES[0] if over == ("e",) else WHERES[9])
        if shape not in ("limit", "count"):
            # columns every row of the OVER set holds
            q["yields"] = [(_blob(["e_dst", "e"]), None),
                           (_blob(["e_type", "e"]), None)] + (
                [(_blob(E + ["w"]), None)] if over == ("e",) else [])
        leaves0 = sum(st.stats["leaves"] for st in port.continuous.streams())
        want, got = _both(cluster, q, True, both)
        assert got == want and got[0] == "ok", (q, got)
        assert got[2], q
        leaves = sum(st.stats["leaves"] for st in port.continuous.streams())
        assert leaves > leaves0, q           # rode the stream
        served += 1
    assert served == len(OVERS)


def _mask(fn):
    try:
        return fn()
    except Exception as e:       # noqa: BLE001 — compared by type
        return ("raised", type(e).__name__)


def _plans(cluster, where, pushed, alias_to_etype):
    _ok, rt, port, space = cluster[:4]
    ref = rt._plan_go(space, alias_to_etype, rex.decode_expr(where), pushed)
    got = port._plan_go(space, alias_to_etype, decode_expr(where), pushed)
    return ref, got


@pytest.mark.parametrize("pushed", [True, False])
def test_host_filter_mask_matches_reference(cluster, pushed):
    """(2) ``_host_filter``'s mask for each WHERE of the family on the
    same mirror and candidates (every ``e`` edge, every edge of the
    space, a seeded sample), or the same decline."""
    _ok, rt, port, space, ets, m = cluster[:6]
    pm = port.mirror(space)
    rng = np.random.default_rng(3 + pushed)
    cands = [np.nonzero(m.edge_etype == ets["e"])[0],
             np.arange(m.m, dtype=np.int64),
             np.sort(rng.choice(m.m, 80, replace=False)),
             np.zeros(0, np.int64)]
    a2e = {"e": ets["e"], "f": ets["f"]}
    checked = 0
    for w in WHERES:
        ref_plan, plan = _plans(cluster, _blob(w), pushed, a2e)
        assert (ref_plan is None) == (plan is None), w
        if plan is None:
            continue
        for cand in cands:
            want = _mask(lambda: rt._host_filter(m, ref_plan, cand))
            got = _mask(lambda: port._host_filter(pm, plan, cand))
            if isinstance(want, np.ndarray):
                assert isinstance(got, np.ndarray), (w, got)
                assert got.dtype == np.bool_ and got.shape == cand.shape
                assert np.array_equal(want, got), w
                checked += 1
            else:
                assert got == want, w
    assert checked >= 20


def _ref_query(cluster, starts, where, ycols, pushed, e2a, distinct=False):
    rt, space = cluster[1], cluster[3]
    a2e = {a: et for et, a in e2a.items()}
    wexpr = rex.decode_expr(where) if where else None
    plan = rt._plan_go(space, a2e, wexpr, pushed)
    return RefQuery(starts, plan, [SimpleNamespace(
        expr=rex.decode_expr(b), alias=a) for b, a in ycols], distinct,
        wexpr, e2a, RefExecError)


def _port_query(port, space, starts, where, ycols, pushed, e2a,
                distinct=False):
    a2e = {a: et for et, a in e2a.items()}
    wexpr = decode_expr(where) if where else None
    plan = port._plan_go(space, a2e, wexpr, pushed)
    return _GoQuery(starts, plan, [_YieldCol(decode_expr(b), a)
                                   for b, a in ycols], distinct, wexpr,
                    e2a)


def _batch(rt, space, queries, et_tuple, steps, upto=False, reduce=None):
    pending = rt.go_batch_execute(space, queries, et_tuple, steps, upto,
                                  reduce)
    results, _m = pending.finish()
    out = []
    for r in results:
        if isinstance(r, Exception):
            out.append(("raised", type(r).__name__))
        else:
            out.append(("ok", list(r[0]), [list(x) for x in r[1]]))
    return out


@pytest.mark.parametrize("pushed", [True, False])
def test_one_declining_query_declines_alone(cluster, both, pushed):
    """(3) One ``go_batch_execute`` batch: in pushed mode a ``||`` over
    the partially valid ``$^.person.age`` (vertex 6 has no person tag),
    in graphd mode ``$$.person.age`` read on an untagged destination.
    Only the query that reads it declines, on both sides; its
    neighbours keep their rows."""
    _ok, rt, port, space, ets = cluster[:5]
    both(MODES["dense"])
    et = ets["e"]
    e2a = {et: "e"}
    where = _blob(WHERES[4] if pushed else WHERES[3])
    ycols = [(_blob(["e_dst", "e"]), None), (_blob(E + ["w"]), None)]
    pm = port.mirror(space)
    # graphd mode: a start whose out-edges reach an untagged vertex, and
    # starts whose out-edges reach tagged ones only
    tagged = set(int(v) for v in _people()[0])
    out = {}
    for e_i in np.nonzero(pm.edge_etype == et)[0]:
        out.setdefault(int(pm.vids[pm.edge_src[e_i]]), set()).add(
            int(pm.vids[pm.edge_dst[e_i]]))
    clean = [v for v in sorted(out) if v in tagged and out[v] <= tagged]
    dirty = [v for v in sorted(out) if not out[v] <= tagged] if not pushed \
        else [v for v in sorted(out) if v not in tagged]
    starts = [[clean[0]], [dirty[0]], [clean[1]], [clean[2], clean[3]]]
    want = _batch(rt, space, [_ref_query(cluster, s, where, ycols, pushed,
                                         e2a) for s in starts], (et,), 1)
    got = _batch(port, space, [_port_query(port, space, s, where, ycols,
                                           pushed, e2a) for s in starts],
                 (et,), 1)
    assert got == want
    assert got[1] == ("raised", "TpuDecline")
    assert all(r[0] == "ok" for i, r in enumerate(got) if i != 1)
    assert any(r[2] for r in got if r[0] == "ok")


def test_plan_from_an_older_generation(cluster, both):
    """(4) A plan compiled on generation g runs on g + 1: the WHERE is
    recompiled against the dispatch's mirror (a new string shifts the
    dictionary codes a compiled string compare holds), equal to the
    reference's ``go_batch_execute`` of the same stale plan."""
    ok, rt, _port, _space, _ets, _m, tag = cluster
    both(MODES["dense"])
    ok("CREATE SPACE gen(partition_num=2, replica_factor=1)")
    ok.cluster.refresh_all()
    ok("USE gen")
    ok("CREATE EDGE e(w int, score double, kind string)")
    ok.cluster.refresh_all()
    ok("INSERT EDGE e(w, score, kind) VALUES " + ", ".join(
        f'{a} -> {b}:({a + b}, 0.5, "{"c" if (a + b) % 2 else "a"}")'
        for a in range(1, 9) for b in range(1, 9) if a != b))
    ok("GO FROM 1 OVER e YIELD e._dst")
    rt_space = max(rt.mirrors)
    et = rt.sm.to_edge_type(rt_space, "e").value()
    m0 = rt.mirror(rt_space)
    names = {"e": et}
    port0 = _carry(m0, rt_space, names, tag)
    e2a = {et: "e"}
    where = _blob(["rel", "==", E + ["kind"], ["lit", "c"]])
    ycols = [(_blob(["e_dst", "e"]), None), (_blob(E + ["kind"]), None)]
    starts = [[1], [2, 3], [4]]
    ref_qs = [_ref_query((None, rt, None, rt_space), s, where, ycols, True,
                         e2a) for s in starts]
    port_qs = [_port_query(port0, rt_space, s, where, ycols, True, e2a)
               for s in starts]
    ok("INSERT EDGE e(w, score, kind) VALUES " + ", ".join(
        f'{a} -> {a + 10}:(1, 0.5, "b")' for a in range(1, 5)))
    m1 = rt.mirror(rt_space)
    assert m1 is not m0
    port1 = _carry(m1, rt_space, names, tag)
    try:
        assert port_qs[0].plan.mirror is not port1.mirror(rt_space)
        want = _batch(rt, rt_space, ref_qs, (et,), 1)
        got = _batch(port1, rt_space, port_qs, (et,), 1)
        assert got == want
        assert all(r[0] == "ok" and r[2] for r in got)
        assert all(row[1] == "c" for r in got for row in r[2])
    finally:
        ok("USE h")
        port0.close()
        port1.close()


def test_dst_group_rows_are_the_candidates_dst(cluster):
    """(5) A group whose YIELD is one ``<alias>._dst`` over one alias,
    with no WHERE and no DISTINCT (the GO of the ``_dst``-only phases),
    goes through ``_materialize_group`` like any other group; each
    query's rows are its candidates' dst vids in candidate order, the
    saturated single frontier included."""
    _ok, _rt, port, space, ets = cluster[:5]
    m = port.mirror(space)
    et = ets["e"]
    e2a = {et: "e"}
    ydst = [(_blob(["e_dst", "e"]), "d")]
    rng = np.random.default_rng(9)
    batches = [[np.sort(rng.choice(m.n, 5, replace=False)),
                np.zeros(0, np.int64), np.arange(3)],
               [np.arange(m.n)]]            # saturated: nq 1, every row
    calls = []
    real = port._materialize_group

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    for vs_lists in batches:
        qs = [_port_query(port, space, [], None, ydst, True, e2a)
              for _ in vs_lists]
        port._materialize_group = spy
        try:
            got = port._assemble_results(space, m, qs, vs_lists, (et,))
        finally:
            del port._materialize_group
        assert len(calls) == 1
        calls.clear()
        cand, _qseg, qb = port._frontier_edges_multi(m, vs_lists, (et,))
        dst = m.vids[m.edge_dst[cand]].tolist()
        for g, (cols, rows) in enumerate(got):
            assert cols == ["d"]
            assert [list(r) for r in rows] == \
                [[v] for v in dst[qb[g]:qb[g + 1]]]
        assert any(rows for _c, rows in got)


def test_columnar_rows():
    """(6) ``ColumnarRows``: length, truth, iteration, indexing,
    slicing, ``+`` on both sides and ``==`` over numpy, ConstCol and
    DictCol columns."""
    cols = [np.asarray([3, 1, 2], np.int64), ConstCol("x", 3),
            DictCol(np.asarray([1, 0, 1]), ["a", "b"])]
    rows = [[3, "x", "b"], [1, "x", "a"], [2, "x", "b"]]
    r = ColumnarRows(cols, 3)
    assert len(r) == 3 and bool(r) and repr(r) == "ColumnarRows(3 rows)"
    assert list(r) == rows
    assert r[1] == rows[1] and r[-1] == rows[-1]
    assert r[:2] == rows[:2] and r[1:] == rows[1:] and r[:0] == []
    assert r + [[0, "y", "c"]] == rows + [[0, "y", "c"]]
    assert [[9]] + r == [[9]] + rows
    assert r == rows and r == ColumnarRows(
        [c[0:3] for c in cols], 3) and not (r == rows[:2])
    one = ColumnarRows([np.asarray([1.5, 2.0])], 2)
    assert list(one) == [[1.5], [2.0]]
    empty = ColumnarRows([np.zeros(0, np.int64)], 0)
    assert len(empty) == 0 and not empty and list(empty) == []


@pytest.mark.parametrize("mesh_mode", ["dense", "sparse"])
def test_yield_props_on_the_mesh(cluster, both, mesh_mode):
    """(7) YIELD props and meta columns with no WHERE, a WHERE under
    ``tpu_filter_mode=host`` and DISTINCT on the 4-shard CPU mesh, in
    both mesh modes, equal the reference's (its mesh on 4 of the
    conftest's virtual CPU devices); UPTO declines on both sides."""
    _ok, _rt, port, space, ets = cluster[:5]
    both(dict(MODES["sparse"], tpu_mesh_devices=4,
              tpu_mesh_mode=mesh_mode))
    before = dict(port.stats)
    rng = np.random.default_rng(21)
    seen = set()
    for i in range(12):
        q = _query(rng, ("props", "distinct", "host", "limit",
                         "count")[i % 5])
        q["upto"] = False
        want, got = _both(cluster, q, True, both)
        assert got == want, q
        seen.add(got[0])
    assert "ok" in seen
    q = _query(rng, "props")
    q.update(upto=True, steps=2)
    want, got = _both(cluster, q, True, both)
    assert got == want == ("raised", "TpuDecline")
    ran = port.stats["go_mesh"] + port.stats["go_mesh_sparse"] \
        - before["go_mesh"] - before["go_mesh_sparse"]
    assert ran > 0
