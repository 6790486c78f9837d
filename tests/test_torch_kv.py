"""The port's store and mirror fold against the JAX package's: storage
keys and ``id_hash`` (``common/keys.py``), the row codec
(``codec/rows.py``), the log encoder (``kvstore/log_encoder.py``), the
write processors over ``NebulaStore`` (``storage/processors.py``,
``kvstore/store.py``: engine contents, ``delta_since`` and
``_classify_commit``), and the per-row ``build_mirror``
(``tpu/csr.py``).

Inputs are made from seeds with numpy; both sides get the same
requests.  Storage keys carry a clock-derived version, so the tests pin
``inverted_version`` in both processor modules to one counter.
Everything is compared exactly: keys and rows as bytes, mirror arrays
and columns element for element.
"""
import itertools

import numpy as np
import pytest

from nebula_tpu.codec import rows as rrows
from nebula_tpu.common import keys as rkeys
from nebula_tpu.common.flags import flags as rflags
from nebula_tpu.interface import common as rcommon
from nebula_tpu.kvstore import log_encoder as rlog
from nebula_tpu.kvstore.store import KVOptions, NebulaStore as RStore
from nebula_tpu.meta.schema_manager import AdHocSchemaManager as RSM
from nebula_tpu.storage import processors as rproc
from nebula_tpu.tpu import csr as rcsr
from nebula_tpu_torch.codec import rows as prows
from nebula_tpu_torch.common import clock as pclock
from nebula_tpu_torch.common import keys as pkeys
from nebula_tpu_torch.common.flags import flags as pflags
from nebula_tpu_torch.interface import common as pcommon
from nebula_tpu_torch.kvstore import log_encoder as plog
from nebula_tpu_torch.kvstore.store import NebulaStore as PStore
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.meta.schema_manager import AdHocSchemaManager as PSM
from nebula_tpu_torch.storage import processors as pproc
from nebula_tpu_torch.tpu import csr as pcsr

SPACE = 3
PARTS = 4
TYPES = [t for t in pcommon.SupportedType if t != pcommon.SupportedType.UNKNOWN]


# ================================================================ keys
@pytest.mark.parametrize("seed", range(3))
def test_keys_and_prefixes_are_byte_equal(seed):
    rng = np.random.default_rng(seed)
    big = np.iinfo(np.int64)
    for _ in range(200):
        part = int(rng.integers(1, 1000))
        vid, dst = (int(v) for v in rng.integers(big.min, big.max, 2))
        tag, et = int(rng.integers(1, 1 << 20)), int(rng.integers(-500, 500))
        rank, ver = (int(v) for v in rng.integers(big.min, big.max, 2))
        R, P = rkeys.KeyUtils, pkeys.KeyUtils
        pairs = [
            (R.vertex_key(part, vid, tag, ver),
             P.vertex_key(part, vid, tag, ver)),
            (R.edge_key(part, vid, et, rank, dst, ver),
             P.edge_key(part, vid, et, rank, dst, ver)),
            (R.part_prefix(part), P.part_prefix(part)),
            (R.vertex_prefix(part, vid), P.vertex_prefix(part, vid)),
            (R.vertex_prefix(part, vid, tag), P.vertex_prefix(part, vid, tag)),
            (R.edge_prefix(part, vid), P.edge_prefix(part, vid)),
            (R.edge_prefix(part, vid, et), P.edge_prefix(part, vid, et)),
            (R.edge_prefix(part, vid, et, rank),
             P.edge_prefix(part, vid, et, rank)),
            (R.edge_prefix(part, vid, et, rank, dst),
             P.edge_prefix(part, vid, et, rank, dst)),
        ]
        for a, b in pairs:
            assert a == b
        ek, vk = pairs[1][1], pairs[0][1]
        assert P.parse_edge(ek) == R.parse_edge(ek) == \
            (part, vid, et, rank, dst, ver)
        assert P.parse_vertex(vk) == R.parse_vertex(vk) == \
            (part, vid, tag, ver)
        assert P.is_edge(ek) and not P.is_vertex(ek)
        assert P.is_vertex(vk) and not P.is_edge(vk)
        assert P.get_part(ek) == part
        n = int(rng.integers(1, 100))
        assert pkeys.id_hash(vid, n) == rkeys.id_hash(vid, n)


def test_key_order_is_logical_order():
    P = pkeys.KeyUtils
    vals = [-(1 << 63), -5, -1, 0, 1, 7, (1 << 63) - 1]
    keys = [P.edge_key(1, 0, 1, r, 0, 0) for r in vals]
    assert keys == sorted(keys)
    with pytest.raises(ValueError):
        P.edge_prefix(1, 2, None, 3)


def test_clock_versions_sort_latest_first():
    assert pclock.inverted_version(5) == pclock.INT64_MAX - 5
    a = pclock.inverted_version(1000)
    b = pclock.inverted_version(2000)
    assert b < a                        # the later write sorts first


# ============================================================ row codec
def _schemas(mod, seed):
    """Two versions of a schema over every type; v1 appends columns
    (two with defaults)."""
    rng = np.random.default_rng(seed)
    order = [TYPES[i] for i in rng.permutation(len(TYPES))]
    cols0 = [mod.ColumnDef(f"c{i}", mod.SupportedType(int(t)))
             for i, t in enumerate(order)]
    extra = [mod.ColumnDef("d_int", mod.SupportedType.INT, 42),
             mod.ColumnDef("d_str", mod.SupportedType.STRING, "dflt"),
             mod.ColumnDef("d_bool", mod.SupportedType.BOOL)]
    return (mod.Schema(list(cols0), version=0),
            mod.Schema(list(cols0) + extra, version=1))


def _value(rng, t):
    T = pcommon.SupportedType
    t = T(int(t))
    if t == T.BOOL:
        return bool(rng.integers(0, 2))
    if t in (T.INT, T.VID, T.TIMESTAMP):
        return int(rng.integers(-(1 << 62), 1 << 62))
    if t == T.FLOAT:
        return float(np.float32(rng.normal() * 100))
    if t == T.DOUBLE:
        return float(rng.normal() * 1e6)
    return "".join(chr(int(c)) for c in rng.integers(32, 0x2FF,
                                                     rng.integers(0, 12)))


@pytest.mark.parametrize("seed", range(4))
def test_rows_are_byte_equal_and_round_trip(seed):
    rng = np.random.default_rng(seed)
    r0, r1 = _schemas(rcommon, seed)
    p0, p1 = _schemas(pcommon, seed)
    for _ in range(50):
        vals = {c.name: _value(rng, c.type) for c in p1.columns
                if rng.random() < 0.8}
        for rs, ps in ((r0, p0), (r1, p1)):
            sub = {k: v for k, v in vals.items() if ps.field_index(k) >= 0}
            want = rrows.encode_row(rs, sub)
            w = prows.RowWriter(ps)
            for k, v in sub.items():
                w.set(k, v)
            got = w.encode()
            assert got == want
            assert prows.RowReader(got, ps).to_dict() == \
                rrows.RowReader(want, rs).to_dict()
        # a v0 row read through the resolver with the newest schema's
        # columns: the appended fields take their defaults
        row0 = prows.encode_row(p0, {k: v for k, v in vals.items()
                                     if p0.field_index(k) >= 0})
        pr = prows.RowReader.from_resolver(row0, {0: p0, 1: p1}.get)
        rr = rrows.RowReader.from_resolver(row0, {0: r0, 1: r1}.get)
        assert pr.schema.version == 0
        assert pr.to_dict() == rr.to_dict()
        # truncated: a v0 row decoded under the v1 schema
        t = prows.RowReader(row0, p1)
        tr = rrows.RowReader(row0, r1)
        for name in ("d_int", "d_str", "d_bool"):
            assert t.get(name) == tr.get(name)
        assert (t.get("d_int"), t.get("d_str"), t.get("d_bool")) == \
            (42, "dflt", False)
        assert t.size() == tr.size()


def test_row_codec_refusals_match():
    ps = pcommon.Schema([pcommon.ColumnDef("i", pcommon.SupportedType.INT),
                         pcommon.ColumnDef("s",
                                           pcommon.SupportedType.STRING)])
    with pytest.raises(KeyError):
        prows.RowWriter(ps).set("nope", 1)
    with pytest.raises(OverflowError):
        prows.encode_row(ps, {"i": 1 << 63})
    with pytest.raises(TypeError):
        prows.encode_row(ps, {"s": 5})
    with pytest.raises(KeyError):
        prows.RowReader.from_resolver(prows.encode_row(ps, {}),
                                      lambda v: None)
    assert prows.RowReader(prows.encode_row(ps, {}), ps).get("x", 9) == 9


# ========================================================== log encoder
def _log_cases(rng):
    kv = [(bytes(rng.integers(0, 256, int(rng.integers(1, 50)),
                             dtype=np.uint8)),
           bytes(rng.integers(0, 256, int(rng.integers(0, 300)),
                             dtype=np.uint8))) for _ in range(20)]
    return [("single", "OP_PUT", kv[0]), ("single", "OP_REMOVE", kv[1][:1]),
            ("single", "OP_REMOVE_PREFIX", kv[2][:1]),
            ("single", "OP_MERGE", kv[3]),
            ("multi", "OP_MULTI_PUT", kv), ("multi", "OP_MULTI_PUT", []),
            ("multi", "OP_MULTI_REMOVE", [k for k, _ in kv]),
            ("multi", "OP_REMOVE_RANGE", (kv[4][0], kv[5][0]))]


@pytest.mark.parametrize("case", range(8))
def test_log_records_are_byte_equal_and_decode(case):
    kind, op, arg = _log_cases(np.random.default_rng(case))[case]
    if kind == "single":
        want = rlog.encode_single(getattr(rlog.LogOp, op), *arg)
        got = plog.encode_single(getattr(plog.LogOp, op), *arg)
    else:
        want = rlog.encode_multi(getattr(rlog.LogOp, op), arg)
        got = plog.encode_multi(getattr(plog.LogOp, op), arg)
    assert got == want
    pop, payload = plog.decode(got)
    rop, rpayload = rlog.decode(want)
    assert int(pop) == int(rop) and payload == rpayload


def test_log_membership_records_decode():
    msg = rlog.encode_host(rlog.LogOp.OP_ADD_PEER, "h:1")
    assert plog.decode(msg) == (plog.LogOp.OP_ADD_PEER, "h:1")
    with pytest.raises(ValueError):
        plog.encode_multi(plog.LogOp.OP_PUT, [])


# ====================================================== store + writes
class Stack:
    """One side's store, schema manager and processors, with the
    schemas of the test space: tag person(age int, name string) in two
    versions, edge e(w int, score double) and edge t(w int, ts int)
    with a TTL on ts."""

    def __init__(self, port: bool, ttl_s: int = 1000):
        c = pcommon if port else rcommon
        self.port = port
        self.kv = PStore() if port else RStore(KVOptions())
        self.sm = PSM() if port else RSM()
        self.kv.add_space(SPACE)
        for p in range(1, PARTS + 1):
            self.kv.add_part(SPACE, p)
        T = c.SupportedType
        self.person = [c.Schema([c.ColumnDef("age", T.INT)], version=0),
                       c.Schema([c.ColumnDef("age", T.INT),
                                 c.ColumnDef("name", T.STRING, "anon")],
                                version=1)]
        for s in self.person:
            self.sm.add_tag_schema(SPACE, 7, "person", s)
        self.e = c.Schema([c.ColumnDef("w", T.INT),
                           c.ColumnDef("score", T.DOUBLE)])
        self.t = c.Schema([c.ColumnDef("w", T.INT),
                           c.ColumnDef("ts", T.INT)],
                          schema_prop=c.SchemaProp(ttl_s, "ts"))
        self.sm.add_edge_schema(SPACE, 1, "e", self.e)
        self.sm.add_edge_schema(SPACE, 2, "t", self.t)
        proc = pproc if port else rproc
        self.add_v = proc.AddVerticesProcessor(self.kv, self.sm)
        self.add_e = proc.AddEdgesProcessor(self.kv, self.sm)
        self.dele = proc.DeleteProcessor(self.kv, self.sm)
        self.codec = prows if port else rrows

    def contents(self):
        out = []
        for p in self.kv.part_ids(SPACE):
            out += [(k, v) for k, v in self.kv.prefix(
                SPACE, p, pkeys.KeyUtils.part_prefix(p))]
        return out


class Clock:
    """A pinned write clock: ``bump()`` moves it one tick, ``reset()``
    restarts it, so both sides' requests get the same versions."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._tick = itertools.count(1_700_000_000_000_000, 1000)
        self.bump()

    def bump(self):
        self.v = pclock.INT64_MAX - next(self._tick)

    def __call__(self):
        return self.v


@pytest.fixture
def pinned(monkeypatch):
    """The processors of both packages read one pinned clock."""
    clock = Clock()
    monkeypatch.setattr(pproc, "inverted_version", clock)
    monkeypatch.setattr(rproc, "inverted_version", clock)
    return clock


def _requests(rng, stack, n_vertices=40, n_edges=150, now_s=1_700_000_000):
    """Seeded write requests in the executors' shapes: vertices (v0 and
    v1 rows, some empty), edges of e and t in both directions, then
    in-place updates and deletes."""
    reqs = []
    vids = [int(v) for v in rng.choice(np.arange(1, 10 * n_vertices),
                                       n_vertices, replace=False)]
    parts = {}
    for v in vids:
        ver = int(rng.integers(0, 2))
        vals = {"age": int(rng.integers(0, 90))}
        if ver:
            vals["name"] = f"n{int(rng.integers(0, 5))}"
        row = b"" if rng.random() < 0.1 else \
            stack.codec.encode_row(stack.person[ver], vals)
        parts.setdefault(pkeys.id_hash(v, PARTS), []).append(
            {"id": v, "tags": [[7, row]]})
    reqs.append(("v", {"space_id": SPACE, "parts": parts}))
    edges = []
    for i in range(n_edges):
        s, d = (int(x) for x in rng.choice(vids, 2))
        et = 1 if rng.random() < 0.7 else 2
        rank = int(rng.integers(0, 3))
        if et == 1:
            row = stack.codec.encode_row(stack.e, {
                "w": int(rng.integers(-50, 50)),
                "score": float(rng.normal())})
        else:       # expired, live, and far-future TTL anchors
            ts = now_s + int(rng.choice([-10 ** 6, 10 ** 6, 10 ** 9]))
            row = stack.codec.encode_row(stack.t, {
                "w": int(rng.integers(0, 9)), "ts": ts})
        edges.append((s, et, rank, d, row))
    for lo in range(0, len(edges), 50):
        parts = {}
        for s, et, rank, d, row in edges[lo:lo + 50]:
            for a, sgn, b in ((s, 1, d), (d, -1, s)):
                parts.setdefault(pkeys.id_hash(a, PARTS), []).append(
                    {"src": a, "etype": sgn * et, "rank": rank, "dst": b,
                     "props": row})
        reqs.append(("e", {"space_id": SPACE, "parts": parts}))
    for s, et, rank, d, _row in edges[:20]:       # in-place updates
        row = stack.codec.encode_row(stack.e, {"w": 99, "score": 0.5}) \
            if et == 1 else stack.codec.encode_row(stack.t, {
                "w": 1, "ts": now_s + 10 ** 9})
        reqs.append(("e", {"space_id": SPACE, "parts": {
            pkeys.id_hash(s, PARTS): [{"src": s, "etype": et, "rank": rank,
                                       "dst": d, "props": row}]}}))
    for s, et, rank, d, _row in edges[20:30]:     # deletes
        reqs.append(("d", {"space_id": SPACE, "parts": {
            pkeys.id_hash(s, PARTS): [[s, et, rank, d]],
            pkeys.id_hash(d, PARTS): [[d, -et, rank, s]]}}))
    return reqs


def _apply(stack, reqs, clock):
    clock.reset()
    for kind, req in reqs:
        clock.bump()
        if kind == "v":
            stack.add_v.process(req)
        elif kind == "e":
            stack.add_e.process(req)
        else:
            stack.dele.delete_edges(req)


def _pair(pinned, seed, **kw):
    ref, port = Stack(False, **kw), Stack(True, **kw)
    for st in (ref, port):
        _apply(st, _requests(np.random.default_rng(seed), st), pinned)
    return ref, port


@pytest.mark.parametrize("seed", range(3))
def test_processor_writes_give_byte_equal_engines(pinned, seed):
    ref, port = _pair(pinned, seed)
    got, want = port.contents(), ref.contents()
    assert got == want and len(got) > 100
    assert port.kv.mutation_version(SPACE) == \
        ref.kv.mutation_version(SPACE)
    for p in port.kv.part_ids(SPACE):
        k = pkeys.KeyUtils.part_prefix(p)
        assert [kv for kv in port.kv.range(SPACE, p, k, k + b"\xff")] == \
            [kv for kv in ref.kv.range(SPACE, p, k, k + b"\xff")]


@pytest.mark.parametrize("seed", range(3))
def test_delta_events_match(pinned, seed):
    ref, port = _pair(pinned, seed)
    v = port.kv.mutation_version(SPACE)
    for since in (0, 1, v // 2, v - 1, v):
        assert port.kv.delta_since(SPACE, since) == \
            ref.kv.delta_since(SPACE, since)
        assert port.kv.delta_window(SPACE, since) == \
            ref.kv.delta_window(SPACE, since)
        assert port.kv.delta_window(SPACE, since, since + 2) == \
            ref.kv.delta_window(SPACE, since, since + 2)
    assert port.kv.delta_window(SPACE, v + 5) == (None, "ahead", v)
    kinds = {e[0] for e in port.kv.delta_since(SPACE, 0)}
    assert kinds == {"put", "vput", "del"}


def test_opaque_and_truncated_windows_match(pinned):
    saved = (pflags.get("store_delta_log_cap"),
             rflags.get("store_delta_log_cap"))
    pflags.set("store_delta_log_cap", 16)
    rflags.set("store_delta_log_cap", 16)
    try:
        ref, port = _pair(pinned, 5)
    finally:
        pflags.set("store_delta_log_cap", saved[0])
        rflags.set("store_delta_log_cap", saved[1])
    v = port.kv.mutation_version(SPACE)
    for since in (0, v - 17, v - 16, v - 3):
        assert port.kv.delta_window(SPACE, since) == \
            ref.kv.delta_window(SPACE, since)
    assert port.kv.delta_window(SPACE, 0)[1] == "truncated"
    # a point remove is opaque to the event stream
    for st in (ref, port):
        k = next(iter(st.contents()))[0]
        st.kv.remove(SPACE, pkeys.KeyUtils.get_part(k), k)
    v2 = port.kv.mutation_version(SPACE)
    assert port.kv.delta_window(SPACE, v2 - 2) == \
        ref.kv.delta_window(SPACE, v2 - 2)
    assert port.kv.delta_window(SPACE, v2 - 1)[:2] == (None, "opaque")


def test_classify_commit_matches():
    R, P = rlog.LogOp, plog.LogOp
    ek = pkeys.KeyUtils.edge_key(1, 2, 3, 0, 4, 5)
    vk = pkeys.KeyUtils.vertex_key(1, 2, 3, 5)
    cases = [
        [(P.OP_PUT, (ek, b"x"))], [(P.OP_MULTI_PUT, [(ek, b"x"), (vk, b"")])],
        [(P.OP_MULTI_PUT, [(b"__system_commit_msg_1", b"")])],
        [(P.OP_MULTI_PUT, [(b"odd", b"")])],
        [(P.OP_REMOVE_PREFIX, ek[:32])], [(P.OP_REMOVE_PREFIX, ek[:12])],
        [(P.OP_REMOVE, ek)], [(P.OP_REMOVE_RANGE, (ek, vk))],
        [(P.OP_ADD_PEER, "h:1"), (P.OP_PUT, (vk, b"y"))], None,
    ]
    for dec in cases:
        rdec = None if dec is None else [(R(int(op)), pl) for op, pl in dec]
        assert PStore._classify_commit(dec) == \
            RStore._classify_commit(rdec), dec


def test_store_reads_and_refusals():
    st = PStore()
    st.add_part(1, 1)
    assert st.multi_put(9, 1, []).code == pcommon_code("E_SPACE_NOT_FOUND")
    assert st.put(1, 2, b"k", b"v").code == pcommon_code("E_PART_NOT_FOUND")
    assert st.put(1, 1, b"k", b"v").ok()
    assert st.get(1, 1, b"k")[0] == b"v"
    assert list(st.prefix(1, 5, b"")) == []
    assert st.remove_range(1, 1, b"a", b"z").ok()
    assert st.get(1, 1, b"k")[0] is None
    assert st.delta_since(1, 0) is None      # the range remove is opaque


def pcommon_code(name):
    from nebula_tpu_torch.common.status import ErrorCode
    return getattr(ErrorCode, name)


# ========================================================= mirror fold
def _col_state(c):
    raw = None if c.raw is None else [str(x) for x in c.raw]
    return (c.name, int(c.stype), c.valid.tolist(),
            None if c.values is None else np.asarray(c.values).tolist(),
            None if c.dictionary is None else
            [str(x) for x in c.dictionary], raw, bool(c.device_ok))


def assert_mirrors_equal(pm, rm):
    for f in pcsr.MIRROR_FIELDS:
        a, b = getattr(pm, f), getattr(rm, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pm.n, pm.m) == (rm.n, rm.m)
    assert sorted(pm.edge_cols) == sorted(rm.edge_cols)
    for k in pm.edge_cols:
        assert _col_state(pm.edge_cols[k]) == _col_state(rm.edge_cols[k]), k
    assert sorted(pm.vertex_cols) == sorted(rm.vertex_cols)
    for k in pm.vertex_cols:
        assert _col_state(pm.vertex_cols[k]) == \
            _col_state(rm.vertex_cols[k]), k
    assert sorted(pm.has_tag) == sorted(rm.has_tag)
    for t in pm.has_tag:
        assert np.array_equal(pm.has_tag[t], rm.has_tag[t])
    assert pm.expires_at_s == rm.expires_at_s


@pytest.mark.parametrize("seed", range(3))
def test_build_mirror_matches_reference(pinned, seed):
    ref, port = _pair(pinned, seed)
    pm = pcsr.build_mirror(SPACE, [port.kv], port.sm)
    rm = rcsr._build_mirror_slow(SPACE, [ref.kv], ref.sm)
    assert_mirrors_equal(pm, rm)
    assert pm.m > 100 and (2, "ts") in pm.edge_cols
    assert pm.expires_at_s is not None       # the live TTL rows
    assert not pm.expired_now()
    assert_mirrors_equal(pm, rcsr.build_mirror(SPACE, [ref.kv], ref.sm))


def test_build_mirror_drops_expired_rows(pinned):
    ref, port = _pair(pinned, 1, ttl_s=10)
    pm = pcsr.build_mirror(SPACE, [port.kv], port.sm)
    rm = rcsr._build_mirror_slow(SPACE, [ref.kv], ref.sm)
    assert_mirrors_equal(pm, rm)
    # every t row carries ts = now +- 10^6 or now + 10^9 with a 10 s
    # TTL: the past ones are gone
    ts = pm.edge_cols[(2, "ts")]
    assert (ts.values[ts.valid] > 1_700_000_000).all()


def test_build_mirror_of_an_empty_space():
    st = PStore()
    st.add_part(SPACE, 1)
    m = pcsr.build_mirror(SPACE, [st], PSM())
    assert (m.n, m.m) == (0, 0) and m.row_ptr.tolist() == [0]


def test_schema_view_is_the_managers_registry():
    sv = SchemaView().add_space(1, {"person": 7}, {"e": 1, "f": 4})
    assert sv.to_tag_id(1, "person").value() == 7
    assert not sv.to_tag_id(1, "x").ok()
    assert sv.to_edge_type(1, "f").value() == 4
    assert sv.edge_name(1, 4) == "f" and sv.tag_name(1, 7) == "person"
    assert sv.all_edge_types(1) == [1, 4] and sv.all_tag_ids(1) == [7]
    assert sv.get_edge_schema(1, 1) is None     # names only
    sm = PSM()
    sm.add_edge_schema(1, 2, "e", pcommon.Schema(version=0))
    sm.add_edge_schema(1, 2, "e", pcommon.Schema(version=3))
    assert sm.get_edge_schema(1, 2).version == 3
    assert sm.get_edge_schema(1, 2, 0).version == 0
    rsm = RSM()
    rsm.add_edge_schema(1, 2, "e", rcommon.Schema(version=3))
    assert sm.all_edge_types(1) == rsm.all_edge_types(1)
