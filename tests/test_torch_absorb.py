"""The write path of the port against the JAX package's
(``tests/test_absorb.py``'s single-chip packed differential): one
seeded write stream goes to a reference stack (``NebulaStore`` +
``AdHocSchemaManager`` + ``TpuQueryRuntime`` on CPU jax) and to the
port's (its own store, schema manager and ``TorchQueryRuntime`` on CPU
torch, where ``ell_absorb`` takes its plain route).

The stream mixes inserts, in-place updates, deletes, vertex-only
updates, an edge to a new vertex, a growth-spare claim and a window
past ``mirror_delta_max``.  After every window both sides answer the
same queries (plain, UPTO and COUNT GO, FIND SHORTEST PATH, fused
WHEREs on an edge prop and on both endpoints' tag prop), and hold equal
generation numbers, write-path counters, decline reasons, next
generation ELL tables and CSR arrays and columns.  Then the generation
semantics: the published generation is untouched by an absorb, an
absorbed generation's device tables are ``ell_absorb``'s output, the
continuous tier drains and re-anchors, cached vertex columns follow a
vertex-only write, and a publish drops the space's compiled WHEREs.
Finally the plain ``ell_absorb`` against ``make_ell_absorb_kernel`` on
identical ``absorb_update_arrays`` inputs.  Every comparison is exact.
"""
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.common.flags import flags as rflags
from nebula_tpu.filter import expressions as rex
from nebula_tpu.interface import common as rcommon
from nebula_tpu.kvstore.store import KVOptions, NebulaStore as RStore
from nebula_tpu.meta.schema_manager import AdHocSchemaManager as RSM
from nebula_tpu.storage import processors as rproc
from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu.runtime import TpuQueryRuntime
from nebula_tpu_torch.codec.rows import encode_row
from nebula_tpu_torch.common import protocol
from nebula_tpu_torch.common.flags import flags as pflags
from nebula_tpu_torch.common.keys import id_hash
from nebula_tpu_torch.interface import common as pcommon
from nebula_tpu_torch.kvstore.store import NebulaStore as PStore
from nebula_tpu_torch.meta.schema_manager import AdHocSchemaManager as PSM
from nebula_tpu_torch.storage import processors as pproc
from nebula_tpu_torch.tpu import ell as pell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import ELL_FIELDS, ell_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

from test_torch_kv import assert_mirrors_equal

SPACE = 5
PARTS = 3
ET = 1
TAG = 2
N = 48
CPU = torch.device("cpu")
COUNTERS = ("mirror_builds", "mirror_absorbs", "mirror_deltas",
            "mirror_absorb_failed", "mirror_delta_overflow",
            "mirror_slot_grows")
FLAGS = {"tpu_ell_cap": 8, "tpu_ell_growth_slack": 8,
         "mirror_delta_max": 64, "go_batch_window_ms": 0}


def _blob(w):
    return rex.encode_expr(rex._from_wire(w))


E_ = ["edge", "e"]
YDST = [(_blob(["e_dst", "e"]), None)]
YW = [(_blob(["e_dst", "e"]), None), (_blob(E_ + ["w"]), None)]
WHERE_W = _blob(["rel", ">", E_ + ["w"], ["lit", 40]])
WHERE_AGE = _blob(["logic", "&&",
                   ["rel", ">", ["dst", "person", "age"], ["lit", 30]],
                   ["rel", "<", ["src", "person", "age"], ["lit", 60]]])
WHERE_PAGE = _blob(["rel", ">", ["dst", "person", "age"], ["lit", 30]])


class Side:
    """One package's stack: store, schema manager, processors and the
    device runtime over them."""

    def __init__(self, port: bool):
        c = pcommon if port else rcommon
        self.port = port
        self.kv = PStore() if port else RStore(KVOptions())
        self.sm = PSM() if port else RSM()
        self.kv.add_space(SPACE)
        for p in range(1, PARTS + 1):
            self.kv.add_part(SPACE, p)
        T = c.SupportedType
        self.e = c.Schema([c.ColumnDef("w", T.INT)])
        self.person = c.Schema([c.ColumnDef("age", T.INT)])
        self.sm.add_edge_schema(SPACE, ET, "e", self.e)
        self.sm.add_tag_schema(SPACE, TAG, "person", self.person)
        proc = pproc if port else rproc
        self.add_v = proc.AddVerticesProcessor(self.kv, self.sm)
        self.add_e = proc.AddEdgesProcessor(self.kv, self.sm)
        self.dele = proc.DeleteProcessor(self.kv, self.sm)
        self.reasons = []
        if port:
            self.rt = TorchQueryRuntime(stores=[self.kv], schema_man=self.sm,
                                        device="cpu")
        else:
            self.rt = TpuQueryRuntime([types.SimpleNamespace(kv=self.kv)],
                                      self.sm)
            note = self.rt._note_absorb_failure

            def record(space_id, reason, n_events):
                self.reasons.append(reason)
                note(space_id, reason, n_events)
            self.rt._note_absorb_failure = record

    # ---- writes, in the insert and delete executors' shapes ----------
    def edges(self, edges):
        parts = {}
        for s, d, rank, w in edges:
            row = encode_row(self.e, {"w": w})
            for a, sgn, b in ((s, 1, d), (d, -1, s)):
                parts.setdefault(id_hash(a, PARTS), []).append(
                    {"src": a, "etype": sgn * ET, "rank": rank, "dst": b,
                     "props": row})
        self.add_e.process({"space_id": SPACE, "parts": parts})

    def delete(self, edges):
        parts = {}
        for s, d, rank in edges:
            for a, sgn, b in ((s, 1, d), (d, -1, s)):
                parts.setdefault(id_hash(a, PARTS), []).append(
                    [a, sgn * ET, rank, b])
        self.dele.delete_edges({"space_id": SPACE, "parts": parts})

    def vertices(self, ages):
        parts = {}
        for v, age in ages:
            parts.setdefault(id_hash(v, PARTS), []).append(
                {"id": v, "tags": [[TAG, encode_row(self.person,
                                                    {"age": age})]]})
        self.add_v.process({"space_id": SPACE, "parts": parts})

    # ---- reads -------------------------------------------------------
    def go(self, starts, steps, et=ET, **kw):
        args = dict(kw)
        if self.port:
            return self.rt.serve_go(SPACE, starts, [et], steps, {et: "e"},
                                    yield_specs=args.pop("yields", YDST),
                                    **args)
        return self.rt.serve_go(
            SPACE, starts, [et], steps, {et: "e"},
            args.pop("yields", YDST), args.pop("distinct", False),
            args.pop("where_blob", None), args.pop("pushed_mode", True),
            **args)

    def path(self, src, dst, steps=5):
        return self.rt.serve_find_path(SPACE, [src], [dst], [ET], steps,
                                       True, {ET: "e"})

    def close(self):
        if self.port:
            self.rt.close()
        else:
            self.rt.shutdown()


def _answers(side, rng_seed):
    """The query set of one check, as (kind, result) pairs."""
    rng = np.random.default_rng(rng_seed)
    out = []
    for i in range(6):
        starts = [int(v) for v in rng.integers(1, N + 1, 2)]
        steps = 1 + i % 3
        out.append(("go", sorted(map(tuple, side.go(starts, steps)[1]))))
        out.append(("rev", sorted(map(tuple, side.go(starts, steps,
                                                     et=-ET)[1]))))
    for steps in (2, 3):
        s = [int(rng.integers(1, N + 1))]
        out.append(("upto", sorted(map(tuple, side.go(s, steps,
                                                      upto=True)[1]))))
        out.append(("count", side.go(s, steps, reduce=("count",))[1]))
    for where in (WHERE_W, WHERE_AGE, WHERE_PAGE):
        s = [int(v) for v in rng.integers(1, N + 1, 3)]
        out.append(("fused", sorted(map(tuple, side.go(
            s, 2, where_blob=where, yields=YW)[1]))))
    for _ in range(2):
        a, b = (int(v) for v in rng.integers(1, N + 1, 2))
        out.append(("path", side.path(a, b)[1]))
    return out


def _state(side):
    m = side.rt.mirror(SPACE)
    return m, side.rt.ell(m), {k: side.rt.stats[k] for k in COUNTERS}


def _check(ref, port, seed):
    assert _answers(port, seed) == _answers(ref, seed)
    rm, rix, rst = _state(ref)
    pm, pix, pst = _state(port)
    assert pst == rst
    assert pm.generation == rm.generation
    assert_mirrors_equal(pm, rm)
    for f in ("bucket_nbr", "bucket_et"):
        for a, b in zip(getattr(pix, f), getattr(rix, f)):
            assert np.array_equal(a, b), f
    assert np.array_equal(pix.extra_owner, rix.extra_owner)
    assert (pix.n, pix.m, pix.n_rows) == (rix.n, rix.m, rix.n_rows)
    tables = pm._tables_cache.get(str(CPU)) \
        if getattr(pm, "_tables_cache", None) else None
    if tables is not None:      # the device tables are the host ELL's
        want = pix.device_tables(CPU)
        assert torch.equal(tables.nbr, want.nbr)
        assert torch.equal(tables.et, want.et)


@pytest.fixture
def stacks():
    saved = {k: (pflags.get(k), rflags.get(k)) for k in FLAGS}
    for k, v in FLAGS.items():
        pflags.set(k, v)
        rflags.set(k, v)
    ref, port = Side(False), Side(True)
    rng = np.random.default_rng(7)
    base = []
    for v in range(1, N + 1):        # a ring, then random chords
        base.append((v, v % N + 1, 0, int(rng.integers(0, 100))))
    for _ in range(60):
        s, d = (int(x) for x in rng.integers(1, N + 1, 2))
        base.append((s, d, int(rng.integers(0, 3)),
                     int(rng.integers(0, 100))))
    for _ in range(20):              # a hub past cap 8
        base.append((3, int(rng.integers(1, N + 1)),
                     int(rng.integers(3, 9)), int(rng.integers(0, 100))))
    ages = [(v, int(rng.integers(10, 80))) for v in range(1, N + 1)]
    for side in (ref, port):
        side.edges(base)
        side.vertices(ages)
    try:
        yield ref, port, base
    finally:
        ref.close()
        port.close()
        for k, (p, r) in saved.items():
            pflags.set(k, p)
            rflags.set(k, r)


def _window(ref, port, fn):
    for side in (ref, port):
        fn(side)


def test_write_stream_matches_reference(stacks):
    ref, port, base = stacks
    rng = np.random.default_rng(3)
    _check(ref, port, 0)
    assert port.rt.stats["mirror_builds"] == 1
    live = {(s, d, r): w for s, d, r, w in base}
    windows = []

    def inserts(k):
        out = []
        for _ in range(k):
            s, d = (int(x) for x in rng.integers(1, N + 1, 2))
            out.append((s, d, int(rng.integers(10, 20)),
                        int(rng.integers(0, 100))))
        return out

    # 1-3: inserts, in-place updates, deletes
    windows.append(("insert", lambda side, e=inserts(6): side.edges(e)))
    upd = [(s, d, r, 500 + i) for i, (s, d, r) in
           enumerate(sorted(live)[5:11])]
    windows.append(("update", lambda side: side.edges(upd)))
    dels = [k for k in sorted(live)[20:24]]
    windows.append(("delete", lambda side: side.delete(dels)))
    # 4: vertex-only
    windows.append(("vertex", lambda side: side.vertices(
        [(v, 90 - v) for v in range(1, 9)])))
    # 5: a mix of everything
    mix_ins = inserts(4)
    mix_del = [k for k in sorted(live)[40:42]]

    def mixed(side):
        side.edges(mix_ins)
        side.edges([(s, d, r, 7) for s, d, r in sorted(live)[30:33]])
        side.delete(mix_del)
        side.vertices([(11, 3), (12, 99)])
    windows.append(("mixed", mixed))
    # 6: an edge to a vertex the mirror does not know
    windows.append(("new-vertex", lambda side: side.edges(
        [(4, 1000, 0, 1)])))
    # 7: a non-hub vertex grows past its width (a growth-spare claim)
    windows.append(("grow", lambda side: side.edges(
        [(v, 17, 30, v) for v in range(20, 32)])))
    # 8: past mirror_delta_max edge events
    windows.append(("overflow", lambda side, e=inserts(40): side.edges(e)))
    # 9: after the overflow rebuild, absorbing again
    windows.append(("after", lambda side, e=inserts(3): side.edges(e)))

    seen = {}
    for i, (name, fn) in enumerate(windows):
        _window(ref, port, fn)
        n_declined = len(ref.reasons)
        _check(ref, port, i + 1)
        declined = len(ref.reasons) > n_declined
        assert (port.rt.last_absorb_reason == ref.reasons[-1]) \
            if declined else \
            port.rt.last_absorb_reason in (protocol.ABSORBED,
                                           protocol.ABSORB_VERTEX_IN_PLACE)
        seen[name] = port.rt.last_absorb_reason
    assert seen["insert"] == seen["update"] == seen["delete"] == "absorbed"
    assert seen["vertex"] == protocol.ABSORB_VERTEX_IN_PLACE
    assert seen["new-vertex"] == protocol.ABSORB_VERTEX_PLAN_CHANGE
    assert seen["grow"] == "absorbed"
    assert seen["overflow"] == protocol.ABSORB_DELTA_OVERFLOW
    st = port.rt.stats
    assert st["mirror_slot_grows"] >= 1
    assert st["mirror_delta_overflow"] == 1
    assert st["mirror_builds"] == 3      # first fold, new vertex, overflow
    assert len(port.rt.absorb_wall_s) == st["mirror_deltas"]
    # the rebuild oracle: a fresh fold serves the same rows
    before = _answers(port, 99)
    with port.rt._lock:
        port.rt.mirrors.clear()
    assert _answers(port, 99) == before == _answers(ref, 99)


def test_published_generation_is_untouched_and_tables_come_from_kernel(
        stacks, monkeypatch):
    ref, port, base = stacks
    rt = port.rt
    port.go([1], 2)
    m0 = rt.mirror(SPACE)
    ix0 = rt.ell(m0)
    t0 = rt._device_tables(m0, ix0)
    snap = {f: getattr(m0, f).copy() for f in ("edge_src", "edge_dst",
                                               "edge_etype", "row_ptr")}
    ell_snap = [a.copy() for a in ix0.bucket_nbr + ix0.bucket_et]
    tabs = (t0.nbr.clone(), t0.et.clone())
    outs, uploads = [], []
    real_absorb = ell_ops.ell_absorb
    real_upload = pell.EllIndex.device_tables

    def absorb(*a, **kw):
        outs.append(real_absorb(*a, **kw))
        return outs[-1]

    def upload(self, device):
        uploads.append(self)
        return real_upload(self, device)
    monkeypatch.setattr(ell_ops, "ell_absorb", absorb)
    monkeypatch.setattr(pell.EllIndex, "device_tables", upload)
    w0 = {k: ref.rt.stats[k] for k in COUNTERS}
    port.edges([(5, 6, 40, 1), (7, 8, 41, 2)])
    port.delete([(s, d, r) for s, d, r, _w in base[:2]])
    port.go([1], 2)
    m1 = rt.mirror(SPACE)
    assert m1 is not m0 and m1.generation == m0.generation + 1
    assert len(outs) == 1 and not uploads
    assert m1._tables_cache[str(CPU)] is outs[0]
    assert outs[0].nbr is not t0.nbr
    # generation g is exactly as it was published
    for f, a in snap.items():
        assert np.array_equal(getattr(m0, f), a)
    assert all(np.array_equal(a, b) for a, b in
               zip(ix0.bucket_nbr + ix0.bucket_et, ell_snap))
    assert torch.equal(t0.nbr, tabs[0]) and torch.equal(t0.et, tabs[1])
    assert not torch.equal(outs[0].nbr, t0.nbr)
    assert {k: ref.rt.stats[k] for k in COUNTERS} == w0


def test_continuous_tier_drains_and_reanchors(stacks):
    _ref, port, _base = stacks
    rt = port.rt
    # a vertex whose 3-step answer the write below changes
    port.go([1], 3)
    st = rt.continuous.streams()[0]
    old = sorted(map(tuple, port.go([1], 3)[1]))
    anchors0 = st.stats["anchors"]
    st.tick_delay_s = 0.15
    box = {}

    def rider():
        box["a"] = sorted(map(tuple, port.go([1], 3)[1]))
    th = threading.Thread(target=rider)
    th.start()
    t_end = time.time() + 10
    while not st.seated and time.time() < t_end:
        time.sleep(0.005)
    assert st.seated, "the rider never seated"
    port.edges([(1, 40, 77, 5), (40, 41, 77, 5), (41, 42, 77, 5)])
    after = sorted(map(tuple, port.go([1], 3)[1]))
    th.join(timeout=30)
    st.tick_delay_s = 0.0
    assert box["a"] == old               # finished on its generation
    assert after != old and (42,) in after
    assert st.stats["drains"] >= 1
    assert st.stats["anchors"] == anchors0 + 1


def test_vertex_write_reaches_cached_columns(stacks):
    ref, port, _base = stacks
    starts = list(range(1, 9))
    for where in (WHERE_AGE, WHERE_PAGE):   # uploads and caches the ages
        assert sorted(map(tuple, port.go(starts, 1, where_blob=where,
                                         yields=YW)[1])) == \
            sorted(map(tuple, ref.go(starts, 1, where_blob=where,
                                     yields=YW)[1]))
    m0 = port.rt.mirror(SPACE)
    flip = [(v, 100 - a) for v, a in
            zip(range(1, N + 1), np.random.default_rng(1).integers(
                5, 95, N).tolist())]
    _window(ref, port, lambda side: side.vertices(flip))
    for where in (WHERE_AGE, WHERE_PAGE):
        want = sorted(map(tuple, ref.go(starts, 1, where_blob=where,
                                        yields=YW)[1]))
        got = sorted(map(tuple, port.go(starts, 1, where_blob=where,
                                        yields=YW)[1]))
        assert got == want
    assert port.rt.mirror(SPACE) is m0       # committed in place
    assert port.rt.last_absorb_reason == protocol.ABSORB_VERTEX_IN_PLACE


def test_publish_drops_the_spaces_compiled_wheres(stacks):
    _ref, port, _base = stacks
    rt = port.rt
    port.go([1, 2], 2, where_blob=WHERE_W, yields=YW)
    assert any(k[0] == SPACE for k in rt._programs)
    rt._programs[(SPACE + 1, 0)] = "other space"
    port.edges([(9, 10, 50, 1)])
    rt.mirror(SPACE)
    assert not any(k[0] == SPACE for k in rt._programs)
    assert rt._programs[(SPACE + 1, 0)] == "other space"


def test_absorb_off_and_a_truncated_log_rebuild(stacks):
    ref, port, _base = stacks
    rt = port.rt
    port.go([1], 2)
    saved = pflags.get("mirror_absorb")
    pflags.set("mirror_absorb", False)
    try:
        port.edges([(2, 3, 60, 1)])
        port.go([1], 2)
    finally:
        pflags.set("mirror_absorb", saved)
    assert rt.stats["mirror_builds"] == 2 and rt.stats["mirror_absorbs"] == 0
    # a point remove: the event stream cannot describe it
    k = next(iter(port.kv.prefix(SPACE, 1, b"")))[0]
    port.kv.remove(SPACE, 1, k)
    port.go([1], 2)
    assert rt.last_absorb_reason == protocol.ABSORB_OPAQUE_EVENTS
    assert rt.stats["mirror_builds"] == 3
    assert pflags.set("mirror_refresh_mode", "async") is False


# ============================================ the kernel's plain version
def _ell_pair(seed=5, n=300, m=1500):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    dst[:80] = 9                        # a hub past cap 32
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([np.ones(m), -np.ones(m)]).astype(np.int32)
    jix = jell.EllIndex.build(es, ed, ee, n, cap=32, use_native=False,
                              growth_slack=8)
    assert len(jix.bucket_nbr) >= 3     # buckets of width 8, 16 and 32
    return jix, ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})


def _manual_plan(ix, rng, per_bucket):
    """Replacement rows per bucket: the bucket's last row and random
    others, never its first row (so a pad entry that leaked into the
    next bucket's first row would show), with random content."""
    plan = {}
    for b, nbr in enumerate(ix.bucket_nbr):
        rows_b, D = nbr.shape
        k = min(per_bucket, rows_b - 1)
        rows = np.unique(np.concatenate([[rows_b - 1], 1 + rng.choice(
            rows_b - 1, k, replace=False)])).astype(np.int32)
        nn = rng.integers(0, ix.n_rows + 1, (len(rows), D)).astype(np.int32)
        ne = rng.integers(-2, 3, (len(rows), D)).astype(np.int32)
        plan[b] = (rows, nn, ne)
    return plan


@pytest.mark.parametrize("per_bucket", [1, 5, 40])
def test_plain_absorb_matches_jax_kernel(per_bucket):
    jix, tix = _ell_pair()
    rng = np.random.default_rng(per_bucket)
    plan = _manual_plan(tix, rng, per_bucket)
    counts, upd = pell.absorb_update_arrays(tix, plan)
    rcounts, rupd = jell.absorb_update_arrays(jix, plan)
    assert counts == rcounts
    for a, b in zip(upd, rupd):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    kp = counts[0]
    assert all(len(u[0]) == kp for u in upd) and kp >= 8
    # the pad entries carry each bucket's row count
    pads = 0
    for b, ((rows, _nn, _ne), nbr) in enumerate(zip(upd, tix.bucket_nbr)):
        k = len(plan[b][0])
        assert (rows[k:] == nbr.shape[0]).all()
        pads += kp - k
    assert pads > 0
    nb = len(jix.bucket_nbr)
    kern = jell.make_ell_absorb_kernel(jix, counts)
    outs = kern(*[jnp.asarray(u[0]) for u in upd],
                *[jnp.asarray(u[1]) for u in upd],
                *[jnp.asarray(u[2]) for u in upd],
                *[jnp.asarray(a) for a in jix.bucket_nbr],
                *[jnp.asarray(a) for a in jix.bucket_et])
    tables = tix.device_tables(CPU)
    before = (tables.nbr.clone(), tables.et.clone())
    got = ell_ops.ell_absorb(tables, [torch.from_numpy(u[0]) for u in upd],
                             [torch.from_numpy(u[1]) for u in upd],
                             [torch.from_numpy(u[2]) for u in upd])
    want_nbr = np.concatenate([np.asarray(o).reshape(-1)
                               for o in outs[:nb]])
    want_et = np.concatenate([np.asarray(o).reshape(-1)
                              for o in outs[nb:]])
    assert np.array_equal(got.nbr.numpy(), want_nbr)
    assert np.array_equal(got.et.numpy(), want_et)
    # the resident tables are not donated
    assert torch.equal(tables.nbr, before[0])
    assert torch.equal(tables.et, before[1])
    assert got.slot0 == tables.slot0 and got.D == tables.D
    # each bucket's planned rows hold the plan, and its first row (never
    # planned) is the resident one
    for b in range(nb):
        nbr_b, _ = got.bucket(b)
        rows, nn, _ne = plan[b]
        assert np.array_equal(nbr_b.numpy()[rows], nn)
        assert np.array_equal(nbr_b.numpy()[0], tix.bucket_nbr[b][0])


@pytest.mark.parametrize("seed", range(3))
def test_absorb_plan_matches_reference(seed):
    jix, tix = _ell_pair(seed)
    rng = np.random.default_rng(seed)
    k = 30
    ins_d, ins_s = rng.integers(0, tix.n, k), rng.integers(0, tix.n, k)
    ins_d[:10] = 4                          # a vertex that grows
    ins_e = rng.choice([1, -1], k).astype(np.int32)
    # deletes of edges the tables hold: read them off random rows
    dd, ds, de = [], [], []
    for v in rng.choice(tix.n, 10, replace=False):
        r = tix.perm[v]
        b = int(np.searchsorted(np.cumsum([a.shape[0] for a in
                                           tix.bucket_nbr]), r, "right"))
        lo = sum(a.shape[0] for a in tix.bucket_nbr[:b])
        row_n, row_e = tix.bucket_nbr[b][r - lo], tix.bucket_et[b][r - lo]
        if row_n[0] != tix.n_rows:
            dd.append(v)
            ds.append(int(tix.inv[row_n[0]]))
            de.append(int(row_e[0]))
    args = (ins_d, ins_s, ins_e, np.asarray(dd, np.int64),
            np.asarray(ds, np.int64), np.asarray(de, np.int32))
    pc, rc = [], []
    p = pell.plan_ell_absorb(tix, *args, claims_out=pc)
    r = jell.plan_ell_absorb(jix, *args, claims_out=rc)
    assert (p is None) == (r is None) and pc == rc
    if p is None:
        return
    assert sorted(p) == sorted(r)
    for b in p:
        assert all(np.array_equal(x, y) for x, y in zip(p[b], r[b]))
    px = pell.apply_ell_absorb_host(tix, p, tix.m + 2 * k, claims=pc)
    rx = jell.apply_ell_absorb_host(jix, r, jix.m + 2 * k, claims=rc)
    for f in ("bucket_nbr", "bucket_et"):
        assert all(np.array_equal(a, b) for a, b in
                   zip(getattr(px, f), getattr(rx, f)))
    assert np.array_equal(px.extra_owner, rx.extra_owner)
    # copy-on-write: the old index is untouched where the plan wrote
    assert px.bucket_nbr[list(p)[0]] is not tix.bucket_nbr[list(p)[0]]


def test_absorb_wrapper_refuses_bad_arguments():
    _jix, tix = _ell_pair()
    tables = tix.device_tables(CPU)
    nb = len(tables.D)
    rows = [torch.zeros(8, dtype=torch.int32) for _ in range(nb)]
    nn = [torch.zeros((8, d), dtype=torch.int32) for d in tables.D]
    with pytest.raises(ValueError):
        ell_ops.ell_absorb(tables, rows[:-1], nn, nn)
    with pytest.raises(TypeError):
        ell_ops.ell_absorb(tables, [r.long() for r in rows], nn, nn)
    with pytest.raises(ValueError):
        ell_ops.ell_absorb(tables, rows, [n[:, :1] for n in nn], nn)
