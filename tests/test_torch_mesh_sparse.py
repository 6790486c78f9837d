"""The frontier-sharded mesh of the port (``tpu_mesh_mode=sparse``)
against the reference's.

Kernel level: the reference's ``build_sharded_ell`` (``ell.py:1871``),
``split_start_pairs_by_owner`` (``:1934``),
``make_frontier_sharded_sparse_go_kernel`` (``:2052``) and
``make_frontier_sharded_sparse_bfs_kernel`` (``:2179``) run on a
``Mesh`` of the conftest's virtual CPU devices; the port's plain
versions, and its programs composed of the card stages (X1, X2 + K5,
the agreement, K6, X3) on their plain versions, run on a
``PartsMesh`` of k CPU shards.  The same seeded numpy
inputs go to both; every shard's output array, depth block and
overflow flag is compared for exact equality.  The ELL is the
reference's own numpy build at cap 16 (three buckets, hub extra rows,
growth spares, one of them claimed), carried into the port.

Runtime level: a reference ``LocalCluster`` and a port runtime over its
mirror, both with ``tpu_mesh_devices=k`` and the default
``tpu_mesh_mode=sparse``: GO and FIND PATH rows equal the cluster's,
through ``mesh_sparse_go`` / ``mesh_sparse_bfs`` and, on overflow or a
placement past the cap, the dense mesh; a store-backed pair reads a
write back from the new generation's sharded tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, build_sharded_ell,
                                      ell_from_reference, sharded_sparse_pairs,
                                      sharded_tables, sparse_caps,
                                      split_start_pairs_by_owner)
from nebula_tpu_torch.tpu.mesh import PartsMesh, all_to_all

from test_torch_unpacked import _claim_a_spare, _graph, _set_flags

CPU = torch.device("cpu")
KS = [2, 4, 8]
SH_FIELDS = ("k", "chunk", "bstarts", "mx", "D", "starts_s", "ecnt_s",
             "e0_s", "n", "n_rows", "n_extras")


def _jmesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("parts",))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    base = jell.EllIndex.build(es, ed, ee, n, cap=16, min_d=4,
                               use_native=False, growth_slack=8)
    jix = _claim_a_spare(base, n, ed)
    assert len(jix.bucket_D) == 3 and len(jix.extra_owner)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    return jix, tix


def _pairs(tix, B, per_query, seed, hubs=0):
    """(new rows, qids) of B queries with ``per_query`` random starts
    each, the first ``hubs`` queries starting at hub owners."""
    rng = np.random.default_rng(seed)
    rows, qs = [], []
    owners = np.unique(tix.extra_owner[tix.extra_owner < tix.n])
    for q in range(B):
        r = tix.perm[rng.integers(0, tix.n, per_query)]
        if q < hubs:
            r = np.concatenate([r, owners[q % len(owners):][:1]])
        rows.append(r)
        qs.append(np.full(len(r), q))
    return (np.concatenate(rows).astype(np.int32),
            np.concatenate(qs).astype(np.int32))


def _placed(sh, rows, qs, c0):
    placed = split_start_pairs_by_owner(sh, rows, qs, c0)
    assert placed is not None
    return placed


# ==================================================== the sharded view
@pytest.mark.parametrize("k", KS)
def test_build_sharded_ell_and_placement_match_reference(ells, k):
    jix, tix = ells
    want = jell.build_sharded_ell(jix, k)
    got = build_sharded_ell(tix, k)
    for f in SH_FIELDS:
        assert np.array_equal(np.asarray(getattr(got, f)),
                              np.asarray(getattr(want, f))), f
    for b in range(len(jix.bucket_nbr)):
        assert np.array_equal(got.nbr_s[b], want.nbr_s[b])
        assert np.array_equal(got.et_s[b], want.et_s[b])
    # the device form holds the same blocks
    st = sharded_tables(got, PartsMesh([CPU] * k))
    hn, he, hc, hz = st.host_shards()
    for s in range(k):
        assert np.array_equal(hc[s], want.ecnt_s[s])
        assert np.array_equal(hz[s], want.e0_s[s])
        for b in range(len(jix.bucket_nbr)):
            assert np.array_equal(hn[s][b], want.nbr_s[b][s])
            assert np.array_equal(he[s][b], want.et_s[b][s])
    rows, qs = _pairs(tix, 24, 3, seed=k)
    for c0 in (64, 8):
        a = split_start_pairs_by_owner(got, rows, qs, c0)
        b = jell.split_start_pairs_by_owner(want, rows, qs, c0)
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    # a shard's share past the cap: None on both sides
    one = np.full(9, tix.perm[0], np.int32)
    assert split_start_pairs_by_owner(got, one, np.arange(9), 8) is None
    assert jell.split_start_pairs_by_owner(want, one, np.arange(9),
                                           8) is None


@pytest.mark.parametrize("k", [2, 3])
def test_all_to_all_matches_jax_blocks(k):
    """Shard s's block d lands at shard d's block s, as
    ``jax.lax.all_to_all(x, axis, 0, 0, tiled=False)`` puts it: with
    every shard on a card of its own (pretended), ``all_to_all`` copies
    the k(k - 1) blocks that cross cards, and the block a shard keeps is
    the one its router wrote in place."""
    from jax.sharding import PartitionSpec as P
    from nebula_tpu.tpu.compat import shard_map
    x = np.arange(k * k * 5, dtype=np.int32).reshape(k, k, 5) * 3 + 1
    fn = shard_map(lambda a: jax.lax.all_to_all(a[0], "parts", 0, 0,
                                                tiled=False)[None],
                   mesh=_jmesh(k), in_specs=P("parts"),
                   out_specs=P("parts"), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    send = [_t(x[s]) for s in range(k)]
    recv = [torch.zeros_like(a) for a in send]
    for s in range(k):
        recv[s][s].copy_(send[s][s])          # the router's own block
    cards = tuple((CPU, (s,)) for s in range(k))
    copies, moved = all_to_all(send, recv, cards)
    for d in range(k):
        assert np.array_equal(recv[d].numpy(), want[d])
    assert copies == k * (k - 1) and moved == k * (k - 1) * 5 * 4
    # shards of one card exchange nothing here
    assert all_to_all(send, recv, ((CPU, tuple(range(k))),)) == (0, 0)


# ================================================================ GO
def _jgo(jix, k, steps, over, caps, cap_x, cap_e, placed):
    mesh = _jmesh(k)
    sh = jell.build_sharded_ell(jix, k)
    kern = jell.make_frontier_sharded_sparse_go_kernel(
        mesh, "parts", sh, steps, over, caps, cap_x=cap_x, cap_e=cap_e)
    a = jell.sharded_device_args(mesh, "parts", sh)
    return np.asarray(kern(jnp.asarray(placed[0]), jnp.asarray(placed[1]),
                           a[0], a[1], a[2], *a[3], *a[4]))


def _port_go(tix, k, steps, over, caps, cap_x, cap_e, placed, qmax):
    """(the plain program's outputs, the card-stage composition's) on
    k CPU shards."""
    st = sharded_tables(build_sharded_ell(tix, k), PartsMesh([CPU] * k))
    ids, qid = (st.mesh.split(_t(a)) for a in placed)
    plain = ell_ops.mesh_sparse_go(ids, qid, st, over, steps, caps, cap_x,
                                   cap_e, qmax)
    routed = []

    def route(*args, **kw):
        # the bytes that reached other shards: each block from another
        # shard, 8 bytes for its count and for each key it kept
        ell_ops.mesh_route_card(*args, **kw)
        recv = args[6]
        cap = recv.shape[2] - 1
        for y in range(k):
            other = torch.arange(k) != y
            routed.append(int((8 * (1 + recv[y, other, 0].clamp(max=cap)))
                              .sum()))
    steps_out, exchanges, ctl = ell_ops._mesh_go_steps(
        ids, qid, st, over, steps, caps, cap_x, cap_e, qmax, route,
        ell_ops.mesh_dedup, (ell_ops.mesh_agree, ell_ops.or_many),
        ell_ops.mesh_emit)
    hubs = st.n_extras > 0     # one exchange a hop, and its hub pairs'
    assert exchanges == (steps - 1) * (2 if hubs else 1) == len(routed) // k
    assert ell_ops.exchanged_bytes(ctl) == sum(routed) > 0
    # the starts are only read
    assert np.array_equal(st.mesh.stacked(ids).numpy(), placed[0])
    return (st.mesh.stacked(plain).numpy(),
            st.mesh.stacked(steps_out).numpy())


@pytest.mark.parametrize("k,steps", [(2, 2), (2, 3), (4, 3), (4, 4),
                                     (8, 2), (8, 4)])
def test_mesh_sparse_go_matches_reference(ells, k, steps):
    jix, tix = ells
    over = (1,) if steps % 2 else (-1, 2)
    c0 = 64
    d_max = max(tix.bucket_D)
    caps = sparse_caps(c0, d_max, steps, 1 << 14, growth=8)
    cap_x, cap_e = max(256, caps[-1] // max(k // 2, 1)), max(64, c0)
    rows, qs = _pairs(tix, 8, 3, seed=10 * k + steps, hubs=3)
    sh = build_sharded_ell(tix, k)
    placed = _placed(sh, rows, qs, c0)
    want = _jgo(jix, k, steps, over, caps, cap_x, cap_e, placed)
    plain, composed = _port_go(tix, k, steps, over, caps, cap_x, cap_e,
                               placed, 16)
    assert not want[:, 1].any()
    assert np.array_equal(plain, want)
    assert np.array_equal(composed, want)
    # the decoded pairs: every query's frontier after steps - 1 hops
    ovf, q, u = sharded_sparse_pairs(want)
    assert not ovf and len(q) == want[:, 0].sum() > 0


TIGHT = {   # each sets one overflow source of the program
    "cap_x": dict(cap_x=8),
    "dedup_cap": dict(final=12),
    "hub_budget": dict(c0=8, hubs=8, per_query=0),
    "cap_e": dict(cap_e=2),
}


@pytest.mark.parametrize("case", sorted(TIGHT))
def test_mesh_sparse_go_tight_caps_flag_overflow(ells, case):
    jix, tix = ells
    t = TIGHT[case]
    k, steps, over = 4, 3, (1, 2)
    c0 = t.get("c0", 64)
    d_max = max(tix.bucket_D)
    caps = sparse_caps(c0, d_max, steps, 1 << 12, growth=8)
    if "final" in t:
        caps = caps[:-1] + (t["final"],)
    cap_x = t.get("cap_x", max(256, caps[-1] // 2))
    cap_e = t.get("cap_e", max(64, c0))
    rows, qs = _pairs(tix, t.get("hubs", 12), t.get("per_query", 2),
                      seed=3, hubs=t.get("hubs", 3))
    sh = build_sharded_ell(tix, k)
    placed = split_start_pairs_by_owner(sh, rows, qs, c0)
    if placed is None:            # a hub-heavy batch on one shard
        placed = split_start_pairs_by_owner(sh, rows[:c0], qs[:c0], c0)
    want = _jgo(jix, k, steps, over, caps, cap_x, cap_e, placed)
    plain, composed = _port_go(tix, k, steps, over, caps, cap_x, cap_e,
                               placed, 16)
    assert want[:, 1].all()
    assert np.array_equal(plain[:, 1], want[:, 1])
    assert np.array_equal(composed[:, 1], want[:, 1])


# =============================================================== BFS
def _bfs_inputs(tix, sh, B, cap, seed):
    s_rows, s_q = _pairs(tix, B, 1, seed=seed, hubs=2)
    t_rows, t_q = _pairs(tix, B, 2, seed=seed + 100)
    return _placed(sh, s_rows, s_q, cap), _placed(sh, t_rows, t_q, cap)


def _jbfs(jix, k, max_steps, over, cap, cap_x, cap_e, stop, qmax, ps, pt):
    mesh = _jmesh(k)
    sh = jell.build_sharded_ell(jix, k)
    build = jell.make_frontier_sharded_sparse_bfs_kernel(
        mesh, "parts", sh, max_steps, over, cap, cap_x, cap_e,
        stop_when_found=stop)
    a = jell.sharded_device_args(mesh, "parts", sh)
    dep, ovf = build(qmax)(jnp.asarray(ps[0]), jnp.asarray(ps[1]),
                           jnp.asarray(pt[0]), jnp.asarray(pt[1]), a[0],
                           a[1], a[2], *a[3], *a[4])
    return np.asarray(dep).reshape(k, sh.chunk, qmax), np.asarray(ovf)


@pytest.mark.parametrize("k,max_steps,stop", [
    (2, 0, True), (2, 3, False), (2, 4, True), (4, 5, True),
    (4, 2, False), (8, 5, False), (8, 1, True)])
def test_mesh_sparse_bfs_matches_reference(ells, k, max_steps, stop):
    jix, tix = ells
    over, cap, B = (1,), 512, 32
    cap_x, cap_e = max(256, cap // max(k // 2, 1)), max(64, cap // 8)
    sh = build_sharded_ell(tix, k)
    ps, pt = _bfs_inputs(tix, sh, B, cap, seed=k + max_steps)
    want, wovf = _jbfs(jix, k, max_steps, over, cap, cap_x, cap_e, stop,
                       B, ps, pt)
    assert not wovf.any()
    st = sharded_tables(sh, PartsMesh([CPU] * k))
    args = tuple(st.mesh.split(_t(a)) for a in (*ps, *pt))
    dep, ovf, levels = ell_ops.mesh_sparse_bfs(*args, st, over, max_steps,
                                               cap, cap_x, cap_e, B, stop)
    seen = []

    def record(ctl):
        seen.append(ell_ops._read_ctl(ctl))
        return seen[-1]
    kern = (ell_ops.mesh_route_card, ell_ops.mesh_dedup,
            ell_ops.mesh_bfs_stamp_card)
    dep2, ovf2, levels2, _x, _b = ell_ops._mesh_bfs_steps(
        *args, st, over, max_steps, cap, cap_x, cap_e, B, stop, *kern,
        read=record)
    assert not ovf and not ovf2 and levels == levels2 <= max_steps
    assert len(seen) == levels2 + 1          # the starts', then a level's
    replay = iter(seen)                      # the flags given back
    dep3, ovf3, levels3, _x, _b = ell_ops._mesh_bfs_steps(
        *args, st, over, max_steps, cap, cap_x, cap_e, B, stop, *kern,
        read=lambda _ctl: next(replay))
    assert not ovf3 and levels3 == levels2
    for s in range(k):
        assert np.array_equal(dep[s].numpy(), want[s]), s
        assert np.array_equal(dep2[s].numpy(), want[s]), s
        assert np.array_equal(dep3[s].numpy(), want[s]), s


def test_mesh_sparse_bfs_tight_cap_overflows(ells):
    jix, tix = ells
    k, over, cap, B = 4, (1, 2), 64, 16
    cap_x, cap_e = 256, 64
    sh = build_sharded_ell(tix, k)
    ps, pt = _bfs_inputs(tix, sh, B, cap, seed=5)
    _want, wovf = _jbfs(jix, k, 5, over, cap, cap_x, cap_e, True, B, ps,
                        pt)
    st = sharded_tables(sh, PartsMesh([CPU] * k))
    args = tuple(st.mesh.split(_t(a)) for a in (*ps, *pt))
    _d, ovf, levels = ell_ops.mesh_sparse_bfs(*args, st, over, 5, cap,
                                              cap_x, cap_e, B, True)
    _d2, ovf2, levels2, _x, _b = ell_ops._mesh_bfs_steps(
        *args, st, over, 5, cap, cap_x, cap_e, B, True,
        ell_ops.mesh_route_card, ell_ops.mesh_dedup,
        ell_ops.mesh_bfs_stamp_card)
    assert wovf.all() and ovf and ovf2 and levels == levels2 < 5


# ========================================================== runtime
from test_torch_mesh import (N_VERTICES, _check_go, _go_mix,  # noqa: E402
                             modes, served)

SPARSE = {"tpu_mesh_mode": "sparse"}


def _sharded_ran(ref_rt, space, k):
    """The reference's own frontier-sharded view was built at k."""
    cached = getattr(ref_rt.mirror(space), "_sharded_ell_cache", None)
    return cached is not None and cached[0] == k


@pytest.mark.parametrize("k", [2, 4])
def test_sparse_mesh_go_matches_cluster(served, modes, k):
    """Windowed GO on a k-shard mesh in the default sparse mode, one
    request at a time: exact depth, REVERSELY, COUNT(*) and LIMIT rows
    equal the cluster's in order, through ``mesh_sparse_go`` alone, and
    the cluster's own frontier-sharded mesh ran."""
    ok, rt_, space, et, ref_rt = served
    modes(dict(SPARSE, tpu_mesh_devices=k))
    before = dict(rt_.stats)
    for spec in _go_mix(np.random.default_rng(60 + k), 16):
        _check_go(ok, rt_, space, et, spec)
    moved = {x: rt_.stats[x] - before[x] for x in before}
    assert moved["go_mesh_sparse"] > 0
    assert moved["go_mesh"] == moved["sparse_overflows"] == 0
    assert moved["go_sparse"] == moved["go_adaptive"] == 0
    assert _sharded_ran(ref_rt, space, k)
    st = rt_.mirror(space)._sharded_ell_cache[1]
    assert st.k == k and st.mesh.devices == (CPU,) * k
    assert getattr(rt_.mirror(space), "_mesh_tables_cache", None) is None \
        or moved["go_mesh"] == 0


def test_sparse_mesh_go_batch_matches_reference(served, modes):
    """Multi-start batches through ``go_batch`` (one launch each)."""
    _ok, rt_, space, et, ref_rt = served
    modes(dict(SPARSE, tpu_mesh_devices=4))
    rng = np.random.default_rng(6)
    batch = [[int(v) for v in rng.integers(1, N_VERTICES + 1,
                                           int(rng.integers(1, 6)))]
             for _ in range(12)]
    for steps in (2, 3):
        want = ref_rt.go_batch(space, batch, [et], steps)
        before = rt_.stats["go_mesh_sparse"]
        got = rt_.go_batch(space, batch, [et], steps)
        assert np.array_equal(got, want)
        assert rt_.stats["go_mesh_sparse"] == before + 1


@pytest.mark.parametrize("shortest", [True, False])
def test_sparse_mesh_find_path_matches_cluster(served, modes, shortest):
    ok, rt_, space, et, ref_rt = served
    k = 4
    # a 2048-pair cap a shard holds this graph's frontiers and keeps the
    # reference's per-level sorts small
    modes(dict(SPARSE, tpu_mesh_devices=k, tpu_sparse_cap=2048))
    rng = np.random.default_rng(13 + shortest)
    kind = "SHORTEST" if shortest else "ALL"
    before = dict(rt_.stats)
    found = 0
    for _ in range(5):
        srcs = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                             int(rng.integers(1, 3)))]
        dsts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                             int(rng.integers(1, 3)))]
        steps = 4 if shortest else 3
        q = (f"FIND {kind} PATH FROM {','.join(map(str, srcs))} TO "
             f"{','.join(map(str, dsts))} OVER e UPTO {steps} STEPS")
        cols, rows = rt_.serve_find_path(space, srcs, dsts, [et], steps,
                                         shortest, {et: "e"})
        want = sorted(map(tuple, ok(q).rows))
        assert cols == ["path"] and sorted(map(tuple, rows)) == want, q
        found += len(want)
    assert found > 0
    assert rt_.stats["bfs_mesh_sparse"] == before["bfs_mesh_sparse"] + 5
    assert rt_.stats["path_mesh"] == before["path_mesh"]
    assert _sharded_ran(ref_rt, space, k)


def test_sparse_mesh_overflows_rerun_dense(served, modes):
    """A small ``tpu_sparse_cap``: GO batches and FIND PATH overflow the
    frontier-sharded programs and rerun on the dense mesh (counted in
    ``sparse_overflows``); a FIND PATH whose sources outgrow a shard's
    share is placed on the dense mesh directly.  Rows equal the
    cluster's throughout."""
    ok, rt_, space, et, _ref_rt = served
    modes(dict(SPARSE, tpu_mesh_devices=2, tpu_sparse_cap=16))
    before = dict(rt_.stats)
    for spec in _go_mix(np.random.default_rng(71), 12):
        _check_go(ok, rt_, space, et, spec)
    moved = {x: rt_.stats[x] - before[x] for x in before}
    assert moved["go_mesh_sparse"] > 0 and moved["sparse_overflows"] > 0
    assert moved["go_mesh"] == moved["sparse_overflows"]
    # FIND PATH: an overflow, then a placement past the cap
    for srcs, dsts in (([1, 3], [2, 5]), (list(range(1, 41)), [2])):
        before = dict(rt_.stats)
        cols, rows = rt_.serve_find_path(space, srcs, dsts, [et], 4, True,
                                         {et: "e"})
        q = (f"FIND SHORTEST PATH FROM {','.join(map(str, srcs))} TO "
             f"{','.join(map(str, dsts))} OVER e UPTO 4 STEPS")
        assert sorted(map(tuple, rows)) == sorted(map(tuple, ok(q).rows))
        moved = {x: rt_.stats[x] - before[x] for x in before}
        assert moved["path_mesh"] == 1 and moved["bfs_mesh_sparse"] == 0
        assert moved["sparse_overflows"] == (len(srcs) <= 16)


def test_sparse_mesh_reads_a_write_back():
    """A store-backed pair on a 2-shard mesh in sparse mode: after a
    write window the new generation builds its own frontier-sharded
    view on first use (the published one's is never carried), and GO
    and FIND PATH read the write back, equal to the reference's."""
    import nebula_tpu.graph.batch_dispatch  # noqa: F401 — its flags
    from nebula_tpu.common.flags import flags as rflags
    from nebula_tpu_torch.common.flags import flags as pflags
    from test_torch_absorb import FLAGS, N, Side
    k = 2
    values = dict(FLAGS, tpu_mesh_devices=k, tpu_mesh_mode="sparse",
                  go_dispatch_mode="windowed")
    old_r, old_p = _set_flags(rflags, values), _set_flags(pflags, values)
    ref, port = Side(False), Side(True)
    try:
        rng = np.random.default_rng(19)
        base = [(v, v % N + 1, 0, 1) for v in range(1, N + 1)]
        base += [(int(a), int(b), 0, 2) for a, b in
                 rng.integers(1, N + 1, (60, 2)) if a != b]
        for side in (ref, port):
            side.edges(base)

        def ask(side):
            return ([sorted(map(tuple, side.go([s], 3)[1]))
                     for s in (1, 5, 9)],
                    sorted(map(tuple, side.path(7, 41)[1])))
        assert ask(port) == ask(ref)
        m0 = port.rt.mirror(5)
        st0 = m0._sharded_ell_cache[1]
        sparse0 = port.rt.stats["go_mesh_sparse"]
        for side in (ref, port):
            side.edges([(7, 30, 5, 3), (30, 41, 5, 3), (12, 2, 5, 3)])
        got = ask(port)
        assert got == ask(ref)
        assert (30,) in map(tuple, port.go([7], 1)[1])
        assert any("30" in str(r) for r in got[1])   # 7 -> 30 -> 41
        m1 = port.rt.mirror(5)
        assert m1 is not m0 and port.rt.stats["mirror_absorbs"] == 1
        k1, st1 = m1._sharded_ell_cache
        assert k1 == k and st1 is not st0
        assert port.rt.stats["go_mesh_sparse"] > sparse0
        assert port.rt.stats["bfs_mesh_sparse"] >= 2
        # the new view is the new host ELL's, cut fresh
        want = build_sharded_ell(port.rt.ell(m1), k)
        hn, he, hc, hz = st1.host_shards()
        for s in range(k):
            assert np.array_equal(hc[s], want.ecnt_s[s])
            for b in range(len(want.nbr_s)):
                assert np.array_equal(hn[s][b], want.nbr_s[b][s])
                assert np.array_equal(he[s][b], want.et_s[b][s])
    finally:
        ref.close()
        port.close()
        _set_flags(rflags, old_r)
        _set_flags(pflags, old_p)
