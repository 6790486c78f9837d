"""The slice as a whole: continuous multi-hop GO served by the port
(``TorchQueryRuntime`` on CPU torch, plain kernel versions) against the
same nGQL on a JAX cluster in continuous mode.

The JAX cluster's mirror is carried into the port, so both answer from
identical state.  A seeded mix (2-4 steps, 1-3 start vids, exact depth,
UPTO, ``| YIELD COUNT(*)``, forward and REVERSELY) runs from several
threads with a slowed tick so arrivals join mid-flight; every query's
sorted rows must equal the cluster's.  The numpy oracle that
``chip_smoke.py`` checks the card against is held to the same rows.
"""
import threading

import numpy as np
import pytest

import chip_smoke
from nebula_tpu.cluster import LocalCluster
from nebula_tpu.common.flags import flags as ref_flags
from nebula_tpu_torch.common.flags import flags
from nebula_tpu_torch.storage.device import TpuDecline
from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

N_VERTICES = 90


def _edges(seed=17, n=N_VERTICES, m=520):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, m)
    dst = rng.integers(1, n + 1, m)
    src[:45] = 1                         # out-hub: spills past cap 8
    dst[45:80] = 2                       # in-hub
    keep = src != dst
    return src[keep], dst[keep]


@pytest.fixture(scope="module")
def served():
    """(ok, port runtime, space id, etype, src, dst): one JAX cluster and
    one port runtime over the cluster's mirror."""
    ref_flags.set("go_dispatch_mode", "continuous")
    old_cap = flags.get("tpu_ell_cap")
    flags.set("tpu_ell_cap", 8)          # hubs and growth spares exist
    c = LocalCluster(num_storage=1, tpu_backend=True)
    rt = None
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok("CREATE SPACE s(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE s")
        ok("CREATE EDGE e(w int)")
        c.refresh_all()
        src, dst = _edges()
        vals = ", ".join(f"{a} -> {b}:({(a * 31 + b) % 97})"
                         for a, b in zip(src, dst))
        ok(f"INSERT EDGE e(w) VALUES {vals}")
        ok("GO 2 STEPS FROM 1 OVER e")
        space = next(iter(c.tpu_runtime.mirrors))
        m = c.tpu_runtime.mirror(space)
        et = int(np.abs(m.edge_etype).max())
        rt = TorchQueryRuntime(device="cpu")
        rt.load_space(space, mirror_from_reference(
            {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=space))
        yield ok, rt, space, et, src, dst
    finally:
        if rt is not None:
            rt.close()
        c.stop()
        flags.set("tpu_ell_cap", old_cap)


def _mix(rng, n_queries=40):
    """(ngql, starts, steps, upto, count, reverse) tuples."""
    out = []
    for i in range(n_queries):
        starts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                               int(rng.integers(1, 4)))]
        if i % 13 == 5:
            starts.append(10 ** 6)       # an absent vid drops
        steps = int(rng.integers(2, 5))
        upto = bool(rng.random() < 0.35)
        count = bool(rng.random() < 0.35)
        reverse = bool(rng.random() < 0.2)
        q = (f"GO {'UPTO ' if upto else ''}{steps} STEPS FROM "
             f"{','.join(map(str, starts))} OVER e"
             f"{' REVERSELY' if reverse else ''} YIELD e._dst"
             f"{' | YIELD COUNT(*)' if count else ''}")
        out.append((q, starts, steps, upto, count, reverse))
    return out


def _port(rt, space, et, spec):
    _q, starts, steps, upto, count, reverse = spec
    e = -et if reverse else et
    return rt.serve_go(space, starts, [e], steps, {e: "e"}, upto=upto,
                       reduce=("count",) if count else None)


def test_concurrent_mix_matches_cluster(served):
    ok, rt, space, et, _src, _dst = served
    mix = _mix(np.random.default_rng(3))
    want = [sorted(map(tuple, ok(spec[0]).rows)) for spec in mix]
    _port(rt, space, et, mix[0])         # the forward stream exists
    streams = rt.continuous.streams()
    for st in streams:
        st.tick_delay_s = 0.01           # arrivals land mid-flight
    got = [None] * len(mix)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                next_i[0] += 1
            if i >= len(mix):
                return
            try:
                cols, rows = _port(rt, space, et, mix[i])
                got[i] = (cols, sorted(map(tuple, rows)))
            except Exception as ex:     # noqa: BLE001 — asserted below
                errors.append((mix[i][0], ex))

    pool = [threading.Thread(target=worker) for _ in range(8)]
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        for st in streams:
            st.tick_delay_s = 0.0
    assert not any(t.is_alive() for t in pool)
    assert not errors, errors
    for spec, w, (cols, rows) in zip(mix, want, got):
        assert cols == (["__count__"] if spec[4] else ["e._dst"]), spec[0]
        assert rows == w, spec[0]
    fwd = [st for st in rt.continuous.streams() if st.et_tuple == (et,)][0]
    with fwd.cond:
        stats = dict(fwd.stats)
    assert stats["midflight_joins"] > 0, stats
    assert stats["lane_reuses"] > 0, stats
    assert stats["joins"] == stats["leaves"], stats
    assert rt.continuous.seat_counts() == (0, 0)
    assert fwd.ledger.seated_count() == 0


def test_sequential_answers_match_cluster(served):
    """The same mix one query at a time (each cohort flushes alone)."""
    ok, rt, space, et, _src, _dst = served
    for spec in _mix(np.random.default_rng(8), n_queries=16):
        cols, rows = _port(rt, space, et, spec)
        assert sorted(map(tuple, rows)) == \
            sorted(map(tuple, ok(spec[0]).rows)), spec[0]


def test_smoke_oracle_matches_cluster(served):
    """chip_smoke.GoOracle, the card's yardstick, gives the cluster's
    rows for single-start forward GO, exact and UPTO."""
    ok, _rt, _space, _et, src, dst = served
    oracle = chip_smoke.GoOracle(src, dst)
    rng = np.random.default_rng(4)
    for _ in range(12):
        v = int(rng.integers(1, N_VERTICES + 1))
        steps = int(rng.integers(2, 5))
        for upto in (False, True):
            q = (f"GO {'UPTO ' if upto else ''}{steps} STEPS FROM {v} "
                 f"OVER e YIELD e._dst")
            want = sorted(r[0] for r in map(tuple, ok(q).rows))
            got, traversed = oracle.go([v], steps, upto)
            assert got.tolist() == want, q
            assert traversed >= len(want)


def test_unsupported_requests_decline(served):
    _ok, rt, space, et, _src, _dst = served
    alias = {et: "e"}
    cases = [
        dict(steps=1),
        dict(where="e.w > 3"),
        dict(limit=3),
        dict(reduce=("limit", 3)),
        dict(yield_cols=["e._dst", "e.w"]),
        dict(yield_cols=["e._src"]),
        dict(space_id=space + 99),
        dict(etypes=[et, et + 1], etype_to_alias={et: "e", et + 1: "f"}),
        dict(etypes=[]),
    ]
    for extra in cases:
        kw = dict(space_id=space, start_vids=[1], etypes=[et], steps=2,
                  etype_to_alias=alias)
        kw.update(extra)
        with pytest.raises(TpuDecline):
            rt.serve_go(**kw)
    # the default YIELD spelled out is served
    cols, _rows = rt.serve_go(space, [1], [et], 2, alias,
                              yield_cols=["e._dst"])
    assert cols == ["e._dst"]


def test_space_loads_once(served):
    _ok, rt, space, _et, _src, _dst = served
    with pytest.raises(ValueError):
        rt.load_space(space, rt.mirror(space))
