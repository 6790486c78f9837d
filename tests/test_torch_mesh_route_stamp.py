"""The frontier-sharded mesh's X1 (``mesh_route_card``) on the lists it
reads to the count K5 left, and X3 (``mesh_bfs_stamp_card``) one call a
card group, on the CPU.

X1: on a list whose live pairs come first (as K5 writes it), the
counted call with ``ctl[CTL_CNT]`` 0, the live count, c and past c (an
overflowed K5), with X3's in-place pads inside the prefix and with
blocks filled past their cap, equals ``mesh_route_ref`` shard by shard
on the prefix, and — where the prefix holds every live pair — the same
call reading the whole list; a start list with pads between its live
pairs, read whole through the public wrapper, equals the per-shard plain
version on its live pairs alone.  X3: the card-level plain wrapper
against ``mesh_bfs_stamp_ref`` shard by shard, at init and at a level,
on one card group and on two pretended ones.  The BFS composed of the
card stages against the reference's
``make_frontier_sharded_sparse_bfs_kernel`` at k = 2 and 4, with hub
rows, ``stop_when_found`` both ways, every list K5 and X3 leave holding
its live places below min(ctl[CTL_CNT], c) and X3 called once a card
group at init and a level.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (build_sharded_ell, sharded_tables,
                                      sparse_caps)
from nebula_tpu_torch.tpu.mesh import PartsMesh

from test_torch_mesh_sparse import (_bfs_inputs, _jbfs, _pairs, _placed, _t,
                                    ells)  # noqa: F401 -- the fixture

CPU = torch.device("cpu")
OVER = (1, 2)
CNT = ell_ops.CTL_CNT
INF = 0x7FFF


def _st(tix, k, cards=False):
    """k CPU shards, on one card group or split over two pretended
    cards."""
    st = sharded_tables(build_sharded_ell(tix, k), PartsMesh([CPU] * k))
    if cards:
        half = (k + 1) // 2
        st.mesh.groups = ((CPU, tuple(range(half))),
                          (CPU, tuple(range(half, k))))
    return st


def _k5_lists(st, rng, c, live, qmax=8):
    """int32 [k, c] lists as K5 writes them: on each shard up to ``live``
    distinct (q, row) pairs of its own rows in (q, row) order first, the
    pads (n_rows, BIG_Q) after them."""
    k, chunk, n_rows = st.k, st.chunk, st.n_rows
    ids = np.full((k, c), n_rows, np.int32)
    qid = np.full((k, c), ell_ops.BIG_Q, np.int32)
    for s in range(k):
        lo, hi = s * chunk, min((s + 1) * chunk, n_rows)
        key = np.unique(rng.integers(0, qmax, 3 * live) * chunk
                        + rng.integers(lo, hi, 3 * live) - lo)[:live]
        ids[s, :len(key)] = key % chunk + lo
        qid[s, :len(key)] = key // chunk
    return _t(ids), _t(qid)


def _count(ids, st, case):
    """ctl[:, CTL_CNT] for a case: the K5 count the prefix is read to."""
    live = (ids != st.n_rows).sum(1)
    c = ids.shape[1]
    return {"zero": torch.zeros_like(live), "live": live,
            "c": torch.full_like(live, c), "past": live + c,
            "pads": live, "tight": live}[case]


def _blocks(st, recv, send):
    """{(s, d): the block shard s sent owner d}, wherever it sits."""
    out = {}
    for gi, (_dev, members) in enumerate(st.mesh.groups):
        for y, s in enumerate(members):
            for d in range(st.k):
                out[s, d] = ell_ops._block_of(st, members, recv[gi],
                                              send[gi], y, d)
    return out


def _route(st, hub, ids, qid, ctl, cap, counted, hub_recv=None):
    """X1 on every card group of ``st``: each shard's blocks and ctl."""
    k = st.k
    recv, send, ctls = [], [], []
    for g in st.mesh.groups:
        members = list(g[1])
        kg = len(members)
        r = torch.zeros((kg, k, 1 + cap), dtype=torch.int64)
        sd = torch.zeros_like(r) if kg < k else None
        c = ctl[members].clone()
        hr = None if hub_recv is None else hub_recv[members].contiguous()
        ell_ops.mesh_route_card(hub, ids[members].contiguous(),
                                qid[members].contiguous(), st, g, OVER, r,
                                sd, c, hr, counted)
        recv.append(r)
        send.append(sd)
        ctls.append(c)
    rows = [None] * k
    for (_d, members), c in zip(st.mesh.groups, ctls):
        for y, s in enumerate(members):
            rows[s] = c[y]
    return _blocks(st, recv, send), rows


def _route_shard(st, hub, ids, qid, ctl, cap, n, hub_recv=None):
    """``mesh_route_ref`` on each shard's first n[s] places alone."""
    out, rows = {}, []
    for s in range(st.k):
        own = torch.zeros((st.k, 1 + cap), dtype=torch.int64)
        c = ctl[s].clone()
        ell_ops.mesh_route_ref(hub, ids[s, :n[s]], qid[s, :n[s]],
                               None if hub_recv is None else hub_recv[s], st,
                               s, OVER, own, c, ids.shape[1])
        for d in range(st.k):
            out[s, d] = own[d]
        rows.append(c)
    return out, rows


def _same(a, b):
    assert a[0].keys() == b[0].keys()
    for key in a[0]:
        assert torch.equal(a[0][key], b[0][key]), key
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


# =============================================================== X1
@pytest.mark.parametrize("mode", ["cand", "recv", "hub"])
@pytest.mark.parametrize("case", ["zero", "live", "c", "past", "pads",
                                  "tight"])
@pytest.mark.parametrize("k", [2, 4])
def test_route_reads_the_counted_prefix(ells, k, case, mode):
    """A counted X1 call over a K5-shaped list reads min(ctl[CTL_CNT], c)
    places of each member: equal to ``mesh_route_ref`` on that prefix,
    shard by shard, and, where the prefix holds every live pair (the
    count, c, past c, X3's pads inside it), to the call reading the
    whole list; at a cap the blocks fill past (``tight``) the counts and
    the overflow still agree."""
    _jix, tix = ells
    rng = np.random.default_rng(11 * k + len(case) + len(mode))
    for cards in (False, True):
        st = _st(tix, k, cards)
        ids, qid = _k5_lists(st, rng, 96, 40)
        ctl = torch.zeros((k, ell_ops.CTL_SIZE), dtype=torch.int64)
        ctl[:, CNT] = _count(ids, st, case)
        if case == "pads":                     # X3's pads in the prefix
            hole = torch.from_numpy(rng.random(ids.shape) < 0.3)
            ids[hole], qid[hole] = st.n_rows, ell_ops.BIG_Q
        n = ctl[:, CNT].clamp(0, ids.shape[1]).tolist()
        cap = 4 if case == "tight" else 2048
        hub_recv = None
        if mode == "recv":
            hub_recv = torch.zeros((k, k, 1 + 16), dtype=torch.int64)
            for s in range(k):
                lo = s * st.chunk
                for d in range(k):
                    m = int(rng.integers(0, 24))
                    rows = rng.integers(lo, min(lo + st.chunk, st.n_rows),
                                        min(m, 16))
                    hub_recv[s, d, 0] = m
                    hub_recv[s, d, 1:1 + len(rows)] = _t(
                        (rng.integers(0, 8, len(rows)) << 32) | rows)
        hub = mode == "hub"
        got = _route(st, hub, ids, qid, ctl, cap, True, hub_recv)
        _same(got, _route_shard(st, hub, ids, qid, ctl, cap, n, hub_recv))
        if case == "tight":
            assert any(bool(r[ell_ops.CTL_OVF]) for r in got[1]) or hub
        if case != "zero":
            _same(got, _route(st, hub, ids, qid, ctl, cap, False, hub_recv))
        else:
            assert all(int(b[0]) == 0 for b in got[0].values()) or \
                mode == "recv"


@pytest.mark.parametrize("hub", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_route_reads_a_start_list_whole(ells, k, hub):
    """Through the public wrapper a start list with pads between its
    live pairs is read whole: equal to ``mesh_route_ref`` on each
    shard's live pairs alone (the hub budget the list's width)."""
    _jix, tix = ells
    st = _st(tix, k)
    rows, qs = _pairs(tix, 12, 3, seed=k, hubs=4)
    placed = _placed(build_sharded_ell(tix, k), rows, qs, 64)
    rng = np.random.default_rng(k)
    ids = np.full((k, 64), st.n_rows, np.int32)
    qid = np.zeros((k, 64), np.int32)
    live = []
    for s in range(k):
        m = int((placed[0][s] != st.n_rows).sum())
        at = np.sort(rng.choice(64, m, replace=False))
        ids[s, at], qid[s, at] = placed[0][s, :m], placed[1][s, :m]
        live.append(m)
        assert m and (m == 64 or at[-1] >= m)   # pads between the pairs
    ids, qid = _t(ids), _t(qid)
    ctl = torch.zeros((k, ell_ops.CTL_SIZE), dtype=torch.int64)
    got = _route(st, hub, ids, qid, ctl, 512, False)
    comp_i = torch.full_like(ids, st.n_rows)
    comp_q = torch.zeros_like(qid)
    for s in range(k):
        keep = ids[s] != st.n_rows
        comp_i[s, :live[s]], comp_q[s, :live[s]] = ids[s, keep], qid[s, keep]
    _same(got, _route_shard(st, hub, comp_i, comp_q, ctl, 512, live))
    assert sum(int(b[0]) for b in got[0].values()) > 0


# =============================================================== X3
@pytest.mark.parametrize("init", [True, False])
@pytest.mark.parametrize("case", ["whole", "live", "past", "pads", "zero"])
@pytest.mark.parametrize("k", [2, 4])
def test_stamp_card_matches_per_shard_plain(ells, k, init, case):
    """``mesh_bfs_stamp_card`` (its plain version on the CPU) equals
    ``mesh_bfs_stamp_ref`` shard by shard: at init (starts, then
    targets) and at a level, on one card group and two pretended ones,
    reading a list whole or to the count K5 left (the live count, past
    c, X3's pads inside the prefix: the same as the whole list; 0: an
    empty list); the scratch words stay zero."""
    _jix, tix = ells
    rng = np.random.default_rng(7 * k + len(case) + init)
    qmax = 8
    for cards in (False, True):
        st = _st(tix, k, cards)
        chunk, W = st.chunk, ell_ops._words(st.chunk)
        ids, qid = _k5_lists(st, rng, 64, 30, qmax)
        ctl = _t(rng.integers(0, 50, (k, ell_ops.CTL_SIZE)))
        ctl[:, CNT] = _count(ids, st, "zero" if case == "zero" else "live")
        if case == "past":
            ctl[:, CNT] += 64
        if case == "pads":
            hole = torch.from_numpy(rng.random(ids.shape) < 0.3)
            ids[hole], qid[hole] = st.n_rows, ell_ops.BIG_Q
        tids, tqid = _k5_lists(st, rng, 64, 20, qmax)
        depth = torch.full((k, chunk, qmax), INF, dtype=torch.int16)
        depth[torch.from_numpy(rng.random(depth.shape) < 0.05)] = 1
        tbits = _t(rng.integers(-2**31, 2**31 - 1, (k, qmax * W))
                   .astype(np.int32))
        counted = case != "whole"
        want = [x.clone() for x in (ids, qid, depth, tbits, ctl)]
        n = 0 if case == "zero" else 64
        for s in range(k):
            ell_ops.mesh_bfs_stamp_ref(
                init, want[0][s, :n], want[1][s, :n], want[2][s],
                want[3][s], W, s * chunk, st.n_rows, 3, want[4][s],
                tids[s] if init else None, tqid[s] if init else None)
        for g in st.mesh.groups:
            m = list(g[1])
            a = [x[m].contiguous() for x in (ids, qid, depth, tbits, ctl)]
            tick = torch.zeros((len(m), 2), dtype=torch.int64)
            ell_ops.mesh_bfs_stamp_card(
                init, *a[:4], st, g, 3, a[4],
                tids[m].contiguous() if init else None,
                tqid[m].contiguous() if init else None, counted, tick)
            for x, y in zip(a, want):
                assert torch.equal(x, y[m])
            assert not tick.any()
        if not init and case != "zero":
            assert (want[4][:, ell_ops.CTL_LIVE] > 0).any()


# ============================================================== BFS
def _checked(st, route, dedup, stamp, calls):
    """The card stages wrapped: before each counted X1 and after each
    X2 + K5 and X3 level, every member's places from min(ctl[CTL_CNT],
    c) on are pads; X3's calls are counted."""
    def tail_clear(ids, ctl):
        for y in range(ids.shape[0]):
            n = ell_ops._counted(ids, ctl, y, True)
            assert bool((ids[y, n:] == st.n_rows).all())

    def r(*a):
        if a[10]:
            tail_clear(a[1], a[8])
        return route(*a)

    def d(*a):
        out = dedup(*a)
        tail_clear(a[5], a[7])
        return out

    def s(*a):
        calls.append(bool(a[0]))
        out = stamp(*a)
        if not a[0]:
            tail_clear(a[1], a[8])
        return out
    return r, d, s


@pytest.mark.parametrize("cards", [False, True])
@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("k", [2, 4])
def test_bfs_card_stages_match_reference(ells, k, stop, cards):
    """``mesh_sparse_bfs`` and its card-stage composition (X1 counted
    after the first level, X2 + K5, X3 one call a card group) against
    the reference's frontier-sharded BFS: every shard's depth block, the
    overflow and the levels; the lists keep their live places in the
    counted prefix; X3 runs once a card group at init and each level."""
    jix, tix = ells
    over, cap, B, max_steps = (1,), 512, 32, 4
    cap_x, cap_e = max(256, cap // max(k // 2, 1)), max(64, cap // 8)
    sh = build_sharded_ell(tix, k)
    ps, pt = _bfs_inputs(tix, sh, B, cap, seed=20 + k + stop)
    want, wovf = _jbfs(jix, k, max_steps, over, cap, cap_x, cap_e, stop, B,
                       ps, pt)
    assert not wovf.any()
    st = _st(tix, k, cards)
    args = tuple(st.mesh.split(_t(a)) for a in (*ps, *pt))
    dep, ovf, levels = ell_ops.mesh_sparse_bfs(*args, st, over, max_steps,
                                               cap, cap_x, cap_e, B, stop)
    calls = []
    dep2, ovf2, levels2, _x, _b = ell_ops._mesh_bfs_steps(
        *args, st, over, max_steps, cap, cap_x, cap_e, B, stop,
        *_checked(st, ell_ops.mesh_route_card, ell_ops.mesh_dedup,
                  ell_ops.mesh_bfs_stamp_card, calls))
    assert not ovf and not ovf2 and levels == levels2 >= 2
    groups = len(st.mesh.groups)
    assert calls == [True] * groups + [False] * groups * levels2
    for s in range(k):
        assert np.array_equal(dep[s].numpy(), want[s]), s
        assert np.array_equal(dep2[s].numpy(), want[s]), s


@pytest.mark.parametrize("k", [2, 4])
def test_go_card_stages_keep_live_places_in_the_prefix(ells, k):
    """The GO's card stages on the CPU: after every X2 + K5 each
    member's places past min(ctl[CTL_CNT], c) are pads, so X1's counted
    calls from the second hop read every live pair; the output equals
    the plain program's."""
    _jix, tix = ells
    st = _st(tix, k)
    rows, qs = _pairs(tix, 12, 3, seed=30 + k, hubs=3)
    placed = _placed(build_sharded_ell(tix, k), rows, qs, 64)
    caps = sparse_caps(64, max(tix.bucket_D), 4, 1 << 12, growth=8)
    ids, qid = st.mesh.split(_t(placed[0])), st.mesh.split(_t(placed[1]))
    route, dedup, _s = _checked(st, ell_ops.mesh_route_card,
                                ell_ops.mesh_dedup, None, [])
    got, _x, _c = ell_ops._mesh_go_steps(
        ids, qid, st, OVER, 4, caps, 4096, 256, 16, route, dedup,
        (ell_ops.mesh_agree, ell_ops.or_many), ell_ops.mesh_emit)
    want = ell_ops.mesh_sparse_go_ref(ids, qid, st, OVER, 4, caps, 4096,
                                      256, 16)
    assert not st.mesh.stacked(want)[:, 1].any()
    assert torch.equal(st.mesh.stacked(got), st.mesh.stacked(want))
