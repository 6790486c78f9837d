"""The slice as a whole: ``GO ... WHERE ... YIELD ... [DISTINCT]`` served
by the port's fused route (``TorchQueryRuntime.serve_go`` with
``where_blob`` / ``yield_specs`` / ``pushed_mode``, CPU torch, plain
kernel versions) against the reference ``TpuQueryRuntime.serve_go`` of a
JAX ``LocalCluster`` on the same blobs.

The space has ``person(age int, name string)`` on most vertices (some
lack the tag) and ``e(w int, score double, kind string)`` with a few
``w = 0`` where a WHERE divides.  The cluster's mirror, every property
column and the tag and edge names are carried into the port, so both
answer from identical state.  For a seeded mix of WHERE / YIELD /
DISTINCT / 1-3 steps / REVERSELY in both pushed modes, the two return
the same columns and the same rows in the same order (ascending edge
index), or both decline (``TpuDecline``) or both raise a query error
(``DeviceExecError``).  A few statements also run as nGQL through the
cluster's graphd.  The shapes the dispatcher's host filter serves are
held to the reference in tests/test_torch_host_filter.py.
"""
import numpy as np
import pytest

from nebula_tpu.cluster import LocalCluster
from nebula_tpu.common.flags import flags as ref_flags
from nebula_tpu.filter import expressions as rex
from nebula_tpu_torch.common.flags import flags
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.storage.device import TpuDecline
from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

N_VERTICES = 60


def _edges(seed=31, n=N_VERTICES, k=420):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, k)
    dst = rng.integers(1, n + 1, k)
    src[:30] = 1                         # a hub
    keep = src != dst
    src, dst = src[keep], dst[keep]
    w = rng.integers(0, 40, len(src))
    w[::11] = 0                          # zero divisors
    score = rng.integers(0, 48, len(src)) / 8.0
    kind = rng.integers(0, 4, len(src))
    return src, dst, w, score, kind


def _people(seed=5, n=N_VERTICES):
    """(vids, ages, names) of the vertices that carry the tag."""
    rng = np.random.default_rng(seed)
    vids = np.asarray([v for v in range(1, n + 1) if v % 6], np.int64)
    return vids, rng.integers(0, 90, len(vids)), [f"n{v % 7}" for v in vids]


@pytest.fixture(scope="module")
def fused():
    """(ok, reference runtime, port runtime, space, etype of e, of f,
    the reference mirror, the tag id of person)."""
    c = LocalCluster(num_storage=1, tpu_backend=True)
    port = None
    # both runtimes route a WHERE by their own tpu_filter_mode: pin the
    # reference's to the port's default, whatever an earlier test in
    # this process left it at
    ref_mode = ref_flags.get("tpu_filter_mode")
    ref_flags.set("tpu_filter_mode", flags.get("tpu_filter_mode"))
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok("CREATE SPACE s(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE s")
        ok("CREATE TAG person(age int, name string)")
        ok("CREATE EDGE e(w int, score double, kind string)")
        ok("CREATE EDGE f(w int)")
        c.refresh_all()
        vids, ages, names = _people()
        ok("INSERT VERTEX person(age, name) VALUES " + ", ".join(
            f'{v}:({a}, "{nm}")' for v, a, nm in zip(vids, ages, names)))
        src, dst, w, score, kind = _edges()
        ok("INSERT EDGE e(w, score, kind) VALUES " + ", ".join(
            f'{a} -> {b}:({x}, {s}, "k{t}")'
            for a, b, x, s, t in zip(src, dst, w, score, kind)))
        ok("INSERT EDGE f(w) VALUES " + ", ".join(
            f"{a} -> {b}:({a % 3})" for a, b in zip(src[:40], dst[:40])))
        ok("GO 2 STEPS FROM 1 OVER e WHERE e.w > 3 YIELD e._dst")
        rt = c.tpu_runtime
        space = next(iter(rt.mirrors))
        m = rt.mirror(space)
        et_e = rt.sm.to_edge_type(space, "e").value()
        et_f = rt.sm.to_edge_type(space, "f").value()
        tag = rt.sm.to_tag_id(space, "person").value()
        port = TorchQueryRuntime(device="cpu")
        port.load_space(space, mirror_from_reference(
            {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=space,
            edge_cols=m.edge_cols, vertex_cols=m.vertex_cols,
            has_tag=m.has_tag, build_version=m.build_version),
            SchemaView().add_space(space, {"person": tag},
                                   {"e": et_e, "f": et_f}))
        yield ok, rt, port, space, et_e, et_f, m, tag
    finally:
        ref_flags.set("tpu_filter_mode", ref_mode)
        if port is not None:
            port.close()
        c.stop()


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
    ["rel", "==", ["cast", "int", E + ["score"]],
     ["arith", "%", E + ["w"], ["lit", 4]]],
    ["unary", "!", ["rel", ">=", E + ["w"], ["lit", 5]]],
    ["rel", "==", ["e_type", "e"], ["lit", "e"]],
    ["rel", ">", E + ["kind"], ["lit", "k1"]],
    ["logic", "&&", ["rel", ">", ["dst", "person", "age"],
                     ["src", "person", "age"]],
     ["rel", "<", E + ["w"], ["lit", 25]]],
]
YIELDS = [
    (["e_dst", "e"], None), (E + ["w"], None), (E + ["score"], None),
    (E + ["kind"], "k"), (["dst", "person", "age"], None),
    (["src", "person", "name"], None), (["e_src", "e"], None),
    (["e_rank", "e"], None), (["e_type", "e"], "t"),
    (["arith", "+", ["arith", "*", E + ["w"], ["lit", 2]], ["lit", 1]],
     "w2"),
    (["lit", "x"], None), (["rel", ">", E + ["w"], ["lit", 9]], None),
]


def _blob(w):
    return rex.encode_expr(rex._from_wire(w))


def _outcome(fn):
    try:
        cols, rows = fn()
        return ("ok", list(cols), [list(r) for r in rows])
    except Exception as e:       # noqa: BLE001 — compared by type
        return ("raised", type(e).__name__)


def _mix(rng, n):
    out = []
    for _ in range(n):
        where = WHERES[int(rng.integers(0, len(WHERES)))]
        picks = rng.choice(len(YIELDS), int(rng.integers(1, 4)),
                           replace=False)
        yields = [(_blob(YIELDS[i][0]), YIELDS[i][1]) for i in picks]
        starts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                               int(rng.integers(1, 4)))]
        if rng.random() < 0.1:
            starts.append(10 ** 6)         # an absent vid drops
        out.append(dict(where=_blob(where), yields=yields,
                        distinct=bool(rng.random() < 0.25),
                        steps=int(rng.integers(1, 4)),
                        reverse=bool(rng.random() < 0.3), starts=starts))
    return out


@pytest.mark.parametrize("pushed", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_mix_matches_reference(fused, pushed, seed):
    _ok, rt, port, space, et, _et_f = fused[:6]
    rng = np.random.default_rng(seed * 2 + pushed)
    kinds = set()
    for q in _mix(rng, 12):
        e = -et if q["reverse"] else et
        want = _outcome(lambda: rt.serve_go(
            space, q["starts"], [e], q["steps"], {e: "e"}, q["yields"],
            q["distinct"], q["where"], pushed))
        got = _outcome(lambda: port.serve_go(
            space, q["starts"], [e], q["steps"], {e: "e"},
            where_blob=q["where"], yield_specs=q["yields"],
            distinct=q["distinct"], pushed_mode=pushed))
        assert got == want, q
        kinds.add(want[0] if want[0] == "ok" else want[1])
    assert "ok" in kinds


def test_declines_match_reference(fused):
    """The reference declines these too: ``||`` over a partially valid
    column (pushed mode), a WHERE reading a prop invalid on a candidate
    (graphd mode), a div guard in graphd mode."""
    _ok, rt, port, space, et, _et_f = fused[:6]
    ydst = [(_blob(["e_dst", "e"]), None)]
    cases = [(WHERES[4], True), (WHERES[3], False), (WHERES[5], False)]
    for where, pushed in cases:
        want = _outcome(lambda: rt.serve_go(
            space, [1, 2, 3], [et], 2, {et: "e"}, ydst, False,
            _blob(where), pushed))
        got = _outcome(lambda: port.serve_go(
            space, [1, 2, 3], [et], 2, {et: "e"}, where_blob=_blob(where),
            yield_specs=ydst, pushed_mode=pushed))
        assert want == ("raised", "TpuDecline"), where
        assert got == want, where


@pytest.mark.parametrize("stmt,where,yields", [
    ("GO 2 STEPS FROM 1 OVER e WHERE e.w > 3 YIELD e._dst, e.w",
     WHERES[0], [(["e_dst", "e"], None), (E + ["w"], None)]),
    ("GO FROM 1, 2 OVER e WHERE e.score <= 2.5 && e.kind == \"k1\" "
     "YIELD e._dst, e.score, e.kind",
     WHERES[1], [(["e_dst", "e"], None), (E + ["score"], None),
                 (E + ["kind"], None)]),
    ("GO 3 STEPS FROM 5 OVER e REVERSELY WHERE e.w % 3 == 1 "
     "YIELD e._dst, e.w",
     WHERES[2], [(["e_dst", "e"], None), (E + ["w"], None)]),
])
def test_ngql_rows_match(fused, stmt, where, yields):
    ok, _rt, port, space, et, _et_f = fused[:6]
    steps = 3 if "3 STEPS" in stmt else (2 if "2 STEPS" in stmt else 1)
    starts = [5] if "FROM 5" in stmt else ([1, 2] if "1, 2" in stmt
                                           else [1])
    e = -et if "REVERSELY" in stmt else et
    want = ok(stmt).rows
    cols, rows = port.serve_go(space, starts, [e], steps, {e: "e"},
                               where_blob=_blob(where),
                               yield_specs=[(_blob(x), a)
                                            for x, a in yields],
                               pushed_mode=True)
    assert len(cols) == len(yields)
    assert sorted(map(tuple, rows)) == sorted(map(tuple, want))
    assert rows


def test_unported_shapes_decline(fused):
    """The declines that stay: a WHERE under a pipe reduction (COUNT or
    LIMIT; the reference's front end never pushes those down, and its
    ``go_batch_execute`` would reduce an unfiltered frontier), an
    undecodable tree, the blob and name forms mixed, an unknown prop.
    The shapes the dispatcher's host filter serves are parity cases in
    tests/test_torch_host_filter.py."""
    _ok, _rt, port, space, et, _et_f = fused[:6]
    where = _blob(WHERES[0])
    ydst = [(_blob(["e_dst", "e"]), None)]
    base = dict(space_id=space, start_vids=[1], etypes=[et], steps=2,
                etype_to_alias={et: "e"})
    cases = [
        dict(where_blob=where, yield_specs=ydst, reduce=("count",)),
        dict(where_blob=where, yield_specs=ydst, limit=3),
        dict(where_blob=b"\xc1", yield_specs=ydst),
        dict(where_blob=where, yield_cols=["e._dst"]),
        dict(where_blob=_blob(["rel", ">", E + ["nope"], ["lit", 1]]),
             yield_specs=ydst),
    ]
    for extra in cases:
        kw = dict(base)
        kw.update(extra)
        with pytest.raises(TpuDecline):
            port.serve_go(**kw)
    # tpu_filter_mode=device fuses as auto does
    old = flags.get("tpu_filter_mode")
    fused0 = port.stats["go_fused"]
    flags.set("tpu_filter_mode", "device")
    try:
        cols, rows = port.serve_go(**base, where_blob=where,
                                   yield_specs=ydst)
        assert cols == ["e._dst"] and rows
    finally:
        flags.set("tpu_filter_mode", old)
    assert port.stats["go_fused"] == fused0 + 1


def test_dst_yield_without_where_rides_the_dispatcher(fused):
    """A YIELD of only ``e._dst`` with no WHERE is the slices 1-3 GO:
    served by the dispatcher, under the YIELD's own column name."""
    ok, _rt, port, space, et, _et_f = fused[:6]
    old = flags.get("go_dispatch_mode")
    ref_old = ref_flags.get("go_dispatch_mode")
    try:
        cols, rows = port.serve_go(space, [1], [et], 2, {et: "e"},
                                   yield_specs=[(_blob(["e_dst", "e"]),
                                                 "d")])
    finally:
        flags.set("go_dispatch_mode", old)
        ref_flags.set("go_dispatch_mode", ref_old)
    assert cols == ["d"]
    want = ok("GO 2 STEPS FROM 1 OVER e YIELD e._dst AS d").rows
    assert sorted(map(tuple, rows)) == sorted(map(tuple, want))


def test_programs_compile_once_per_where(fused):
    """The compiled program is cached per (space, mirror, mode, OVER
    aliases, WHERE): repeated queries of one WHERE at other shapes
    reuse it."""
    _ok, _rt, port, space, et, _et_f = fused[:6][:6]
    where = _blob(WHERES[2])
    ydst = [(_blob(["e_dst", "e"]), None)]
    before = len(port._programs)
    for steps, starts in ((1, [1]), (2, [1, 2, 3]), (3, [4, 5])):
        port.serve_go(space, starts, [et], steps, {et: "e"},
                      where_blob=where, yield_specs=ydst)
    assert len(port._programs) - before <= 1
    assert port.stats["go_fused"] >= 3


def test_mirror_from_edges_matches_the_clusters_mirror(fused):
    """``mirror_from_edges`` with property columns (what chip_smoke.py
    builds its graph with) folds the inserted edges and tags as the
    reference's ``build_mirror`` folds them from the store: the same
    edge arrays, and every column's valid rows, values and strings."""
    from nebula_tpu.interface.common import SupportedType as RT
    from nebula_tpu_torch.interface.common import SupportedType as T
    from nebula_tpu_torch.tpu.csr import mirror_from_edges
    _ok, _rt, _port, space, et, et_f, m, tag = fused
    src, dst, w, score, kind = _edges()
    kinds = np.asarray([f"k{t}" for t in range(4)])
    vids, ages, names = _people()
    name_dict, name_codes = np.unique(names, return_inverse=True)
    k = len(src)
    got = mirror_from_edges(
        np.concatenate([src, src[:40]]), np.concatenate([dst, dst[:40]]),
        np.concatenate([np.full(k, et), np.full(40, et_f)]),
        space_id=space,
        edge_props={et: {"w": (T.INT, np.concatenate([w, np.zeros(40)])),
                         "score": (T.DOUBLE, np.concatenate(
                             [score, np.zeros(40)])),
                         "kind": (T.STRING, np.concatenate(
                             [kind, np.zeros(40, int)]), kinds)},
                    et_f: {"w": (T.INT, np.concatenate(
                        [np.zeros(k), src[:40] % 3]))}},
        vertex_props={tag: (vids, {"age": (T.INT, ages),
                                   "name": (T.STRING, name_codes,
                                            name_dict)})})
    for f in ("vids", "edge_src", "edge_dst", "edge_etype", "edge_rank",
              "row_ptr"):
        assert np.array_equal(getattr(got, f), getattr(m, f)), f
    for table, want in ((got.edge_cols, m.edge_cols),
                        (got.vertex_cols, m.vertex_cols)):
        assert set(table) == set(want)
        for key, c in want.items():
            g = table[key]
            assert int(g.stype) == int(c.stype), key
            assert np.array_equal(g.valid, c.valid), key
            v = g.valid
            if c.stype == RT.STRING:
                assert [g.host_value(i) for i in np.nonzero(v)[0]] == \
                    [c.host_value(i) for i in np.nonzero(v)[0]], key
                assert list(g.dictionary) == list(c.dictionary), key
            else:
                assert np.array_equal(g.values[v], c.values[v]), key
                assert np.array_equal(g.device_values()[v],
                                      c.device_values()[v]), key
    assert np.array_equal(got.has_tag[tag], m.has_tag[tag])
