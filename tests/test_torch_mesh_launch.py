"""The two mesh programs' card stages — each stage one call and one
launch a kernel over every shard that shares a card — against the
per-shard plain versions they replace, on the CPU.

Frontier-sharded mesh (``tpu_mesh_mode=sparse``): ``mesh_route_card``
(X1) against ``mesh_route_ref`` shard by shard, each shard's block for
owner d found where the stage puts it (the owner's receive row on the
card, the shard's send row for an owner on another card, moved by
``mesh.all_to_all``); ``mesh_dedup`` (X2 + K5) against
``mesh_mark_ref`` and ``pair_compact_ref`` with the shard's row base,
the consumed exchange blocks cleared and the bytes that reached other
shards counted; ``mesh_agree`` against the OR of the flags;
``mesh_emit`` against ``pair_reduce_ref``'s emit.  Replicated-frontier
mesh (``tpu_mesh_mode=dense``): ``mesh_hop``'s three stages against
``shard_hop_ref``, ``copy_rows_ref`` and ``hop_merge_ref`` per shard,
the whole hop against the single-card ``go_hop_ref``.  Then the four
programs with the shards split over two pretended cards equal the
one-card run: which blocks and rows cross by ``copy_`` and which by a
stage call is counted.  Seeded random inputs at k = 2, 3 and 4 shards,
on tables with hub extra rows and without, and a cap tight enough that
the agreed overflow is raised.  Every comparison is exact.
"""
import numpy as np
import pytest
import torch

from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu import mesh as pmesh
from nebula_tpu_torch.tpu.ell import (EllIndex, build_sharded_ell,
                                      mesh_tables, pack_lanes_host,
                                      sharded_tables, sparse_caps,
                                      split_start_pairs_by_owner)
from nebula_tpu_torch.tpu.mesh import PartsMesh

from test_torch_unpacked import _graph

CPU = torch.device("cpu")
KS = [2, 3, 4]
OVER = (1, -2)


@pytest.fixture(scope="module")
def ells():
    """{hubs: the ELL}: cap 16 gives hub extra rows, cap 4096 none."""
    es, ed, ee, n = _graph()
    out = {}
    for hubs, cap in ((True, 16), (False, 4096)):
        ix = EllIndex.build(es, ed, ee, n, cap=cap, min_d=4)
        assert (len(ix.extra_owner) > 0) == hubs
        out[hubs] = ix
    return out


def _two_cards(k):
    """The k CPU shards split over two pretended cards."""
    half = (k + 1) // 2
    return ((CPU, tuple(range(half))), (CPU, tuple(range(half, k))))


def _st(ix, k, cards=None):
    mesh = PartsMesh([CPU] * k)
    if cards is not None:
        mesh.groups = cards
    return sharded_tables(build_sharded_ell(ix, k), mesh)


def _starts(ix, st, nq, per, seed, c0):
    """[k, c0] start slabs: ``nq`` queries of ``per`` random starts, a
    hub owner among the first queries' starts."""
    rng = np.random.default_rng(seed)
    rows = ix.perm[rng.integers(0, ix.n, nq * per)]
    owners = np.unique(ix.extra_owner[ix.extra_owner < ix.n])
    if len(owners):
        rows[:len(owners)] = owners[:nq * per]
    qs = np.arange(nq * per) // per
    placed = split_start_pairs_by_owner(st, rows.astype(np.int32),
                                        qs.astype(np.int32), c0)
    assert placed is not None
    return tuple(torch.from_numpy(a) for a in placed)


def _keys(blk):
    """A block's count and its kept keys as a sorted list."""
    cap = blk.shape[0] - 1
    c = int(blk[0])
    return c, sorted(blk[1:1 + min(c, cap)].tolist())


def _route_both(st, ids, qid, cap, hub, hub_recv=None):
    """X1 over every card of ``st``'s mesh, then the cross-card blocks
    moved: (receive rows per shard, ctl rows per shard, the copies
    made)."""
    mesh, k = st.mesh, st.k
    recv = mesh.slabs((k, 1 + cap), torch.int64, zero=True)
    send = mesh.slabs((k, 1 + cap), torch.int64, zero=True)
    ctl = mesh.slabs((ell_ops.CTL_SIZE,), torch.int64, zero=True)
    for i, g in enumerate(mesh.groups):
        m = list(g[1])
        h = None if hub_recv is None else torch.stack([hub_recv[s]
                                                       for s in m])
        ell_ops.mesh_route_card(hub, ids[m], qid[m], st, g, OVER, recv[i],
                                send[i] if len(m) < k else None, ctl[i], h)
    copies, _b = pmesh.all_to_all(mesh.rows(send), mesh.rows(recv),
                                  mesh.groups)
    return mesh.rows(recv), mesh.rows(ctl), copies


@pytest.mark.parametrize("hubs", [True, False])
@pytest.mark.parametrize("k", KS)
def test_route_card_puts_each_block_where_its_owner_reads_it(ells, k, hubs):
    """Every shard's block for owner d, as ``mesh_route_ref`` routes it
    on that shard alone, is the block d reads from that shard — on one
    card and over two pretended ones, where the k^2 - sum(members^2)
    cross-card blocks are the only copies — in hub mode and in candidate
    mode with the hub pairs received; the flags and hub totals equal."""
    ix = ells[hubs]
    for cards in (None, _two_cards(k)):
        st = _st(ix, k, cards)
        ids, qid = _starts(ix, st, 12, 3, seed=k, c0=64)
        hub_recv = None
        for hub in ((True, False) if hubs else (False,)):
            cap = 32 if hub else 256
            recv, ctl, copies = _route_both(st, ids, qid, cap, hub,
                                            hub_recv)
            cross = k * k - sum(len(m) ** 2 for _d, m in st.mesh.groups)
            assert copies == cross
            for s in range(k):
                own = torch.zeros((k, 1 + cap), dtype=torch.int64)
                c = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
                ell_ops.mesh_route_ref(
                    hub, ids[s], qid[s],
                    None if hub_recv is None else hub_recv[s], st, s, OVER,
                    own, c)
                for d in range(k):
                    assert _keys(recv[d][s]) == _keys(own[d]), (s, d)
                assert torch.equal(ctl[s], c)
            assert sum(_keys(r[t])[0] for r in recv for t in range(k)) > 0
            hub_recv = recv if hub else None


@pytest.mark.parametrize("hubs", [True, False])
@pytest.mark.parametrize("k", KS)
def test_dedup_clears_what_its_hop_consumed(ells, k, hubs):
    """X2 + K5 over the card equal ``mesh_mark_ref`` and
    ``pair_compact_ref`` (the shard's row base) shard by shard, at a
    loose cap and at one the frontier passes; afterwards every consumed
    block's count is 0, the marks are clear, the hub total is 0 and
    CTL_XBYTES holds 8 bytes for each count and kept key from another
    shard."""
    ix = ells[hubs]
    st = _st(ix, k)
    g = st.mesh.groups[0]
    ids, qid = _starts(ix, st, 12, 3, seed=10 + k, c0=64)
    qmax, W = 12, ell_ops._words(st.chunk)
    for c_out in (1024, 8):
        er = None
        if hubs:
            er = torch.zeros((k, k, 33), dtype=torch.int64)
            ctl = torch.zeros((k, ell_ops.CTL_SIZE), dtype=torch.int64)
            ell_ops.mesh_route_card(True, ids, qid, st, g, OVER, er, None,
                                    ctl)
        else:
            ctl = torch.zeros((k, ell_ops.CTL_SIZE), dtype=torch.int64)
        xr = torch.zeros((k, k, 257), dtype=torch.int64)
        ell_ops.mesh_route_card(False, ids, qid, st, g, OVER, xr, None, ctl,
                                er)
        want_ctl = ctl.clone()
        marks = torch.zeros((k, qmax * W), dtype=torch.int32)
        want = []
        for s in range(k):
            m = marks[s].clone()
            i_, q_ = (torch.empty(c_out, dtype=torch.int32) for _ in "iq")
            ell_ops.mesh_mark_ref(xr[s], s * st.chunk, st.chunk, m, W)
            ell_ops.pair_compact_ref(m, W, c_out, i_, q_, want_ctl[s], -1,
                                     st.n_rows, None, None, True,
                                     s * st.chunk)
            want.append((i_, q_))
            xbytes = 0
            for slab in (xr, er):
                if slab is not None:
                    cnt = slab[s, :, 0].clamp(max=slab.shape[2] - 1)
                    xbytes += int((8 * (1 + cnt)).sum()) \
                        - 8 * (1 + int(cnt[s]))
            want_ctl[s, ell_ops.CTL_XBYTES] += xbytes
            want_ctl[s, ell_ops.CTL_HUB_TOTAL] = 0
        ids_o = torch.empty((k, c_out), dtype=torch.int32)
        qid_o = torch.empty_like(ids_o)
        ell_ops.mesh_dedup(xr, st, g, marks, c_out, ids_o, qid_o, ctl, er)
        for s, (i_, q_) in enumerate(want):
            assert torch.equal(ids_o[s], i_) and torch.equal(qid_o[s], q_)
        assert torch.equal(ctl, want_ctl)
        assert bool(ctl[:, ell_ops.CTL_OVF].any()) == (c_out == 8)
        assert not marks.any() and not xr[:, :, 0].any()
        assert er is None or not er[:, :, 0].any()


@pytest.mark.parametrize("k", KS)
def test_agree_and_emit_equal_the_per_shard_versions(ells, k):
    rng = np.random.default_rng(k)
    for flags in ([0] * k, [0] * (k - 1) + [1], [1] * k):
        ctl = torch.from_numpy(rng.integers(0, 9, (k, ell_ops.CTL_SIZE)))
        ctl[:, ell_ops.CTL_OVF] = torch.tensor(flags)
        want = ctl.clone()
        want[:, ell_ops.CTL_OVF] = int(any(flags))
        assert torch.equal(ell_ops.mesh_agree(ctl), want)
    st = _st(ells[True], k)
    c = 40
    ids = torch.from_numpy(rng.integers(0, st.n_rows + 1, (k, c))
                           .astype(np.int32))
    qid = torch.from_numpy(rng.integers(0, 5, (k, c)).astype(np.int32))
    qid[ids == st.n_rows] = ell_ops.BIG_Q
    out = torch.full((k, 2 + 2 * c), 7, dtype=torch.int32)
    ell_ops.mesh_emit(ids, qid, ctl, out, st.n_rows)
    for s in range(k):
        one = torch.empty(2 + 2 * c, dtype=torch.int32)
        ell_ops.pair_reduce_ref(ell_ops.REDUCE_EMIT, ids[s], qid[s], None,
                                one, False, st.n_rows + 1, st.n_rows, 1, 1,
                                0, 0, ctl[s])
        assert torch.equal(out[s], one)


def _lanes(ix, B, seed):
    rng = np.random.default_rng(seed)
    f = np.zeros((ix.n_rows + 1, B), bool)
    for q in range(B):
        f[ix.perm[rng.integers(0, ix.n, 2)], q] = True
    return torch.from_numpy(pack_lanes_host(f))


@pytest.mark.parametrize("hubs", [True, False])
@pytest.mark.parametrize("k", KS)
def test_mesh_hop_stages_equal_the_per_shard_versions(ells, k, hubs):
    """``mesh_hop``'s gather, copy and merge stages, alone and together,
    equal ``shard_hop_ref`` / ``copy_rows_ref`` / ``hop_merge_ref`` per
    shard; the whole hop on every replica equals ``go_hop_ref``."""
    ix = ells[hubs]
    mt = mesh_tables(ix, PartsMesh([CPU] * k))
    g = mt.mesh.groups[0]
    es, hr = (torch.from_numpy(a) for a in ix.hub_merge())
    f0 = _lanes(ix, 64, seed=k)
    cur = mt.mesh.replicas(f0)[0]
    rng = np.random.default_rng(k)
    before = torch.from_numpy(rng.integers(0, 256, tuple(cur.shape),
                                           dtype=np.uint8))
    t = mt.shards[0]
    for stages in (1, 2, 4, 3, 7):
        got, want = before.clone(), before.clone()
        ell_ops.mesh_hop(cur, got, mt, g, es, hr, OVER, stages)
        if stages & ell_ops.HOP_GATHER:
            for s in range(k):
                ell_ops.shard_hop_ref(cur[s], want[s], mt, s, OVER)
        if stages & ell_ops.HOP_COPY:
            for s in range(k):
                ell_ops.copy_rows_ref(want[s], [want[d] for d in range(k)
                                                if d != s], mt.owned(s))
        if stages & ell_ops.HOP_MERGE:
            for s in range(k):
                ell_ops.hop_merge_ref(want[s], es, hr, t.n, t.n_rows)
        assert torch.equal(got, want), stages
    single = ell_ops.go_hop_ref(f0, None, torch.empty_like(f0),
                                ix.device_tables(CPU), es, hr, OVER)[0]
    for s in range(k):
        assert torch.equal(got[s], single)


@pytest.mark.parametrize("k", [3, 4])
def test_programs_over_two_pretended_cards_equal_one_card(ells, k,
                                                          monkeypatch):
    """The four programs with their shards split over two pretended
    cards: each stage one call a card (the hop: a gather and a merge
    call a card and a copy call a card of two or more shards, the owned
    rows crossing by ``copy_``), the exchange's
    cross-card blocks by ``all_to_all`` and the overflow agreed by
    ``psum_or`` — equal to the one-card run, the overflow flags also
    where a tight cap raises them."""
    ix = ells[True]
    cards = _two_cards(k)
    es, hr = (torch.from_numpy(a) for a in ix.hub_merge())
    copies = []
    real_a2a = pmesh.all_to_all

    def a2a(send, recv, groups):
        n = real_a2a(send, recv, groups)
        copies.append(n[0])
        return n
    monkeypatch.setattr(pmesh, "all_to_all", a2a)
    calls = []
    real_hop = ell_ops.mesh_hop

    def hop(cur, nxt, mt, group, *rest):
        calls.append((group[1], rest[-1]))
        return real_hop(cur, nxt, mt, group, *rest)

    # ---- the frontier-sharded GO and BFS
    one, two = _st(ix, k), _st(ix, k, cards)
    ids, qid = _starts(ix, one, 16, 2, seed=k, c0=64)
    caps = sparse_caps(64, max(ix.bucket_D), 3, 1 << 12, growth=8)
    for cap_x in (4096, 4):                 # 4: the overflow, agreed
        run = [ell_ops._mesh_go_steps(
            st.mesh.split(ids), st.mesh.split(qid), st, OVER, 3, caps,
            cap_x, 256, 16, ell_ops.mesh_route_card, ell_ops.mesh_dedup,
            (ell_ops.mesh_agree, ell_ops.or_many), ell_ops.mesh_emit)
            for st in (one, two)]
        assert [len(r[0]) for r in run] == [1, 2]   # a slab a card
        a, b = (st.mesh.stacked(r[0]) for st, r in zip((one, two), run))
        assert a[:, 1].tolist() == b[:, 1].tolist() == [int(cap_x == 4)] * k
        if cap_x == 4096:
            assert torch.equal(a, b)
            assert ell_ops.exchanged_bytes(run[0][2]) \
                == ell_ops.exchanged_bytes(run[1][2]) > 0
    cross = k * k - sum(len(m) ** 2 for _d, m in cards)
    assert copies and set(copies) == {cross}
    args = (ids, qid, ids.roll(1, 1), qid)
    for st in (one, two):
        dep, ovf, levels, _x, xb = ell_ops._mesh_bfs_steps(
            *map(st.mesh.split, args), st, OVER, 4, 4096, 4096, 256, 16,
            False,
            ell_ops.mesh_route_card, ell_ops.mesh_dedup,
            ell_ops.mesh_bfs_stamp_card)
        assert not ovf and levels == 4 and xb > 0
        if st is one:
            want = dep
        else:
            assert all(torch.equal(x, y) for x, y in zip(dep, want))

    # ---- the replicated-frontier GO and BFS
    f0, t0 = _lanes(ix, 64, seed=1), _lanes(ix, 64, seed=2)
    mt1 = mesh_tables(ix, PartsMesh([CPU] * k))
    mesh2 = PartsMesh([CPU] * k)
    mesh2.groups = cards
    mt2 = mesh_tables(ix, mesh2)
    want = ell_ops._go_sharded_loop(f0, mt1, [es] * k, [hr] * k, OVER, 3,
                                    ell_ops.mesh_hop)
    got = ell_ops._go_sharded_loop(f0, mt2, [es] * k, [hr] * k, OVER, 3,
                                   hop)
    assert len(got) == k and all(torch.equal(x, y)
                                 for x, y in zip(got, want))
    H = ell_ops
    per_hop = [(m, st_) for st_ in (H.HOP_GATHER, H.HOP_COPY, H.HOP_MERGE)
               for _d, m in cards if st_ != H.HOP_COPY or len(m) > 1]
    assert calls == per_hop * 2
    d1, l1 = ell_ops._bfs_sharded_loop(f0, t0, mt1, [es] * k, [hr] * k,
                                       OVER, 5, False, ell_ops.mesh_hop)
    d2, l2 = ell_ops._bfs_sharded_loop(f0, t0, mt2, [es] * k, [hr] * k,
                                       OVER, 5, False, hop)
    assert l1 == l2 > 1 and torch.equal(d1, d2)


@pytest.mark.parametrize("qmax", [1, 3])
def test_one_query_on_odd_bitmap_rows(ells, qmax):
    """A single query (or three) whose mark bitmap rows are an odd
    number of 32-bit words: the program's slabs stay contiguous and it
    equals its plain version."""
    ix = ells[False]
    st = _st(ix, 3)
    assert (qmax * ell_ops._words(st.chunk)) % 2 == 1
    ids, qid = _starts(ix, st, qmax, 1, seed=qmax, c0=8)
    caps = sparse_caps(8, max(ix.bucket_D), 2, 1 << 12, growth=8)
    ids, qid = st.mesh.split(ids), st.mesh.split(qid)
    (got,), _x, _c = ell_ops._mesh_go_steps(
        ids, qid, st, OVER, 2, caps, 4096, 256, qmax,
        ell_ops.mesh_route_card, ell_ops.mesh_dedup,
        (ell_ops.mesh_agree, ell_ops.or_many), ell_ops.mesh_emit)
    (want,) = ell_ops.mesh_sparse_go_ref(ids, qid, st, OVER, 2, caps, 4096,
                                         256, qmax)
    assert torch.equal(got, want) and not want[:, 1].any()


# ============================================= launches a call, counted
def test_split_calls_cuts_the_trace_where_the_card_idles():
    """The trace's device events fall into calls at idle gaps longer
    than the gap given, in start order, each event's milliseconds kept;
    an overlap within a call never starts a new one."""
    from nebula_tpu_torch.tools.cardtime import split_calls
    events = [("b", 6.0, 9.0), ("a", 0.0, 5.0), ("c", 102.0, 110.0),
              ("a", 100.0, 105.0), ("x", 1.0, 30.0), ("b", 200.0, 201.0)]
    got = split_calls(events, 20.0)
    assert [[n for n, _ms in c] for c in got] == [["a", "x", "b"],
                                                   ["a", "c"], ["b"]]
    assert got[1] == [("a", 0.005), ("c", 0.008)]
    assert split_calls([], 20.0) == []


@pytest.mark.parametrize("case", ["agree", "lost", "more", "c_calls",
                                  "split", "replay", "merged",
                                  "merged_too_many"])
def test_launches_a_call_counts_the_capture_checks_the_trace(monkeypatch,
                                                             case):
    """``launches_a_call`` gives the captured graph's count (a replay's
    plus its host reads for a call that waits on the card) and holds the
    profiler's trace to it: a traced call may show fewer launches (the
    tracer loses some) but never more, nor other C calls, and the trace
    may not split into more calls than were made.  A call showing a
    whole multiple of the count passes only as that many merged calls,
    no more in all than were made."""
    from nebula_tpu_torch.tools import cardtime
    one = [("k1", 0.01), ("k2", 0.02), ("Memset (Device)", 0.001)]
    traced = {"lost": [one[:1], one], "more": [one, one + one[:1]],
              "split": [one] * 4, "merged": [one + one, one],
              "merged_too_many": [one + one, one, one]
              }.get(case, [one] * 3)
    c_calls = [2, 3, 2] if case == "c_calls" else [2, 2, 2]
    captured = []

    def graph(torch_, ell_ops_, fn):
        captured.append(fn)
        return dict(launches_a_call=3, c_calls_a_call=2,
                    launch_kinds={"kernel": 2, "memset": 1})
    monkeypatch.setattr(cardtime, "graph_launches", graph)
    traces = []

    def profiled(*a, **k):
        traces.append(1)
        return traced, c_calls
    monkeypatch.setattr(cardtime, "profiled_calls", profiled)

    def run():
        return None

    def replay():
        return None
    if case in ("more", "c_calls", "split", "merged_too_many"):
        with pytest.raises(AssertionError, match="but traced"):
            cardtime.launches_a_call(torch, ell_ops, run)
        assert len(traces) == 1
        return
    if case == "replay":
        got = cardtime.launches_a_call(torch, ell_ops, run, replay=replay,
                                       reads=4)
        assert captured == [replay] and got["launches_a_call"] == 7
        assert got["launch_kinds"]["memcpy"] == 4 and got["host_reads"] == 4
        return
    got = cardtime.launches_a_call(torch, ell_ops, run)
    assert captured == [run] and len(traces) == 1
    assert got["launches_a_call"] == 3 and got["c_calls_a_call"] == 2
    assert got["launches_traced"] == [len(c) for c in traced]


@pytest.mark.parametrize("case", ["whole", "first_lost"])
def test_profiled_calls_splits_the_trace_into_calls(monkeypatch, case):
    """``profiled_calls`` splits the trace at the idle gaps between calls
    (a call whose events the tracer lost leaves no cluster), each call's
    C calls beside."""
    from types import SimpleNamespace

    import torch.profiler
    from nebula_tpu_torch.tools import cardtime

    def ev(name, t0, t1):
        return SimpleNamespace(name=name, device_type=SimpleNamespace(
            name="CUDA"), time_range=SimpleNamespace(start=t0, end=t1))
    trace = []
    for i in range(3):
        if i == 0 and case == "first_lost":
            continue
        t = 100000 * (i + 1)           # the calls 0.1 s apart
        trace += [ev("k1", t, t + 5), ev("k2", t + 6, t + 9)]

    class Prof:
        def __init__(self, activities):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return trace
    monkeypatch.setattr(torch.profiler, "profile", Prof)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(cardtime.time, "sleep", lambda s: None)
    got, c_calls = cardtime.profiled_calls(torch, ell_ops, lambda: None, 3)
    assert [[n for n, _ms in c] for c in got] \
        == [["k1", "k2"]] * (2 if case == "first_lost" else 3)
    assert c_calls == [0, 0, 0]


@pytest.mark.parametrize("k", KS)
def test_split_and_stacked_keep_shard_order(k):
    """``mesh.split`` cuts a [k, ...] tensor into the card groups' slabs
    (row y of group g: shard g's y-th member) and ``mesh.stacked`` puts
    them back in shard order, on one card and over two pretended ones
    whose members interleave."""
    t = torch.arange(k * 3).reshape(k, 3)
    odd_even = ((CPU, tuple(range(0, k, 2))), (CPU, tuple(range(1, k, 2))))
    for cards in (None, _two_cards(k), odd_even):
        mesh = PartsMesh([CPU] * k)
        if cards is not None:
            mesh.groups = cards
        slabs = mesh.split(t)
        assert len(slabs) == len(mesh.groups)
        for (_d, members), slab in zip(mesh.groups, slabs):
            assert torch.equal(slab, t[list(members)])
        assert torch.equal(mesh.stacked(slabs), t)
        assert all(torch.equal(r, t[s])
                   for s, r in enumerate(mesh.rows(slabs)))
