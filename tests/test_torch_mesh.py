"""The replicated-frontier mesh of the port (``tpu_mesh_mode=dense``)
against the reference's mesh kernels and runtime.

Kernel level: the reference's ``shard_ell`` (``ell.py:1688``),
``make_sharded_batched_go_kernel`` (``:1712``),
``make_sharded_batched_bfs_kernel`` (``:1799``),
``make_sharded_ell_absorb_kernel`` (``:1036``) and
``kernels.make_sharded_go_kernel`` (``kernels.py:364``) run on a
``Mesh`` of the conftest's virtual CPU devices; the port's plain
versions run on a ``PartsMesh`` of k CPU shards.  The same seeded numpy
inputs go to both, and every shard, frontier row, depth and table slot
is compared for exact equality.  The ELL is the reference's own numpy
build at cap 16 (three buckets, hub extra rows, growth spares, one of
them claimed), carried into the port.

Runtime level: a reference ``LocalCluster`` and a port runtime over its
mirror, both with ``tpu_mesh_devices=k`` and ``tpu_mesh_mode=dense``:
GO and FIND PATH rows equal the cluster's; a store-backed pair absorbs
a write into the sharded tables; the continuous tier refuses the
stream under a mesh.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu import kernels as jkernels
from nebula_tpu_torch.tpu import edge_ops, ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, ell_from_reference,
                                      mesh_tables, pack_lanes_host,
                                      shard_ell)
from nebula_tpu_torch.tpu.mesh import PartsMesh, psum_or, replicate_rows

from test_torch_unpacked import _claim_a_spare, _graph, _set_flags

CPU = torch.device("cpu")
KS = [2, 4, 8]


def _jmesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("parts",))


def _pmesh(k):
    return PartsMesh([CPU] * k)


def _shards(arr):
    """A row-sharded jax array's per-device blocks, in shard order."""
    blocks = sorted(arr.addressable_shards,
                    key=lambda sh: sh.index[0].start or 0)
    return [np.asarray(sh.data) for sh in blocks]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    base = jell.EllIndex.build(es, ed, ee, n, cap=16, min_d=4,
                               use_native=False, growth_slack=8)
    jix = _claim_a_spare(base, n, ed)
    assert len(jix.bucket_D) == 3
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    es_, hr = tix.hub_merge()
    return jix, tix, _t(es_), _t(hr), (es, ed, ee, n)


def _lanes(tix, B, seed, per_query=2):
    rng = np.random.default_rng(seed)
    f = np.zeros((tix.n_rows + 1, B), bool)
    for q in range(B):
        f[tix.perm[rng.integers(0, tix.n, per_query)], q] = True
    return pack_lanes_host(f)


# ========================================================== shard_ell
@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_shard_ell_matches_reference(ells, k):
    jix, tix, *_ = ells
    jn, je, jr = jell.shard_ell(_jmesh(k), "parts", jix)
    pn, pe, pr = shard_ell(tix, k)
    assert pr == list(jr)
    for b in range(len(jix.bucket_nbr)):
        for s, (a, c) in enumerate(zip(_shards(jn[b]), _shards(je[b]))):
            assert np.array_equal(pn[s][b], a), (b, s)
            assert np.array_equal(pe[s][b], c), (b, s)
    # the device layout holds the same blocks, at the right rows
    mt = mesh_tables(tix, _pmesh(k))
    hn, he = mt.host_shards()
    for s in range(k):
        for b in range(len(pr)):
            assert np.array_equal(hn[s][b], pn[s][b])
            assert np.array_equal(he[s][b], pe[s][b])
    owned = sorted(r for s in range(k) for lo, hi in mt.owned(s)
                   for r in range(lo, hi))
    assert owned == list(range(tix.n_rows))     # every row, once


# ============================================================== GO
@pytest.mark.parametrize("k,steps", [(2, 1), (2, 2), (2, 4), (4, 3),
                                     (8, 3)])
def test_ell_go_sharded_matches_reference(ells, k, steps):
    jix, tix, eslot, hrows, _g = ells
    over = (-1, 1) if k == 4 else (1,)
    f0 = _lanes(tix, 128, seed=k + steps)
    nbrs, ets, reals = jell.shard_ell(_jmesh(k), "parts", jix)
    go = jell.make_sharded_batched_go_kernel(_jmesh(k), "parts", jix, steps,
                                             over, nbrs, ets, reals)
    je, jh = jix.hub_merge()
    want = np.asarray(go(jnp.asarray(f0), jnp.asarray(je), jnp.asarray(jh),
                         *nbrs, *ets))
    mt = mesh_tables(tix, _pmesh(k))
    f0t = _t(f0)
    for fn in (ell_ops.ell_go_sharded_ref, ell_ops.ell_go_sharded):
        got = fn(f0t, mt, [eslot] * k, [hrows] * k, over, steps)
        assert len(got) == k
        for rep in got:
            assert np.array_equal(rep.numpy(), want)
    assert np.array_equal(f0t.numpy(), f0)          # read only
    # and the single-card program gives the same frontier
    single = ell_ops.ell_go(f0t.clone(), tix.device_tables(CPU), eslot,
                            hrows, over, steps)
    assert np.array_equal(single.numpy(), want)


def test_shard_hop_writes_only_its_rows(ells):
    """M1 (``mesh_hop``'s gather stage over every shard of the card)
    writes each shard's frontier rows and the pad row of its replica and
    leaves every other row as it was."""
    _jix, tix, *_ = ells
    k = 4
    mt = mesh_tables(tix, _pmesh(k))
    f0 = _t(_lanes(tix, 64, seed=3))
    full = ell_ops.go_hop_ref(f0, None, torch.empty_like(f0),
                              tix.device_tables(CPU),
                              torch.zeros(0, dtype=torch.int32),
                              torch.zeros(0, dtype=torch.int32), (1,))[0]
    cur = mt.mesh.replicas(f0)[0]
    out = torch.full_like(cur, 0xA5)
    es, hr = tix.hub_merge()
    ell_ops.mesh_hop(cur, out, mt, mt.mesh.groups[0], _t(es), _t(hr), (1,),
                     ell_ops.HOP_GATHER)
    for s in range(k):
        mine = np.zeros(tix.n_rows + 1, bool)
        for lo, hi in mt.owned(s):
            mine[lo:hi] = True
        assert torch.equal(out[s][mine], full[:-1][mine[:-1]])
        assert not out[s][-1].any()
        assert (out[s][:-1][~mine[:-1]] == 0xA5).all()


def test_mesh_collectives():
    mesh = _pmesh(3)
    bufs = [torch.full((9, 4), s, dtype=torch.uint8) for s in range(3)]
    blocks = [[(0, 2), (6, 7)], [(2, 4)], [(4, 6), (7, 9)]]
    calls = []

    def near(members):          # the copy stage of one card: every source
        calls.append(members)
        for t in members:
            ell_ops.copy_rows_ref(bufs[t], [bufs[s] for s in members
                                            if s != t], blocks[t])
    moved = replicate_rows(bufs, blocks, near, mesh.groups)
    want = torch.tensor([0, 0, 1, 1, 2, 2, 0, 2, 2], dtype=torch.uint8)
    for b in bufs:
        assert torch.equal(b[:, 0], want)
    assert moved == 2 * 9 * 4 and calls == [(0, 1, 2)]
    parts = [torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.bool),
             torch.tensor([0, 0, 1, 0, 0, 0, 0, 0], dtype=torch.bool),
             torch.tensor([0, 0, 0, 0, 0, 0, 0, 1], dtype=torch.bool)]
    outs = [torch.zeros(8, dtype=torch.bool) for _ in range(3)]
    recv = [torch.zeros((2, 8), dtype=torch.bool) for _ in range(3)]
    psum_or(parts, outs, recv, ell_ops.or_many)
    for o in outs:
        assert o.nonzero().flatten().tolist() == [0, 2, 7]
    assert mesh.k == 3 and mesh == _pmesh(3)
    assert mesh.groups == ((CPU, (0, 1, 2)),)
    with pytest.raises(ValueError):
        PartsMesh([CPU])
    with pytest.raises(ValueError):
        ell_ops.or_into(torch.zeros(6, dtype=torch.uint8),
                        torch.zeros(6, dtype=torch.uint8))


# ============================================================= BFS
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("max_steps,stop", [(5, True), (130, False)])
def test_ell_bfs_sharded_matches_reference(ells, k, max_steps, stop):
    jix, tix, eslot, hrows, _g = ells
    f0 = _lanes(tix, 64, seed=k, per_query=1)
    t0 = _lanes(tix, 64, seed=k + 50, per_query=1)
    nbrs, ets, reals = jell.shard_ell(_jmesh(k), "parts", jix)
    bfs = jell.make_sharded_batched_bfs_kernel(
        _jmesh(k), "parts", jix, max_steps, (1,), nbrs, ets, reals,
        stop_when_found=stop)
    je, jh = jix.hub_merge()
    want = np.asarray(bfs(jnp.asarray(f0), jnp.asarray(t0), jnp.asarray(je),
                          jnp.asarray(jh), *nbrs, *ets))
    assert want.dtype == (np.int8 if max_steps <= 120 else np.int16)
    mt = mesh_tables(tix, _pmesh(k))
    got, levels = ell_ops.ell_bfs_sharded(_t(f0), _t(t0), mt, [eslot] * k,
                                          [hrows] * k, (1,), max_steps,
                                          stop_when_found=stop)
    assert got.dtype == (torch.int8 if max_steps <= 120 else torch.int16)
    assert np.array_equal(got.numpy(), want)
    one, one_levels = ell_ops.ell_bfs(_t(f0), _t(t0), tix.device_tables(CPU),
                                      eslot, hrows, (1,), max_steps,
                                      stop_when_found=stop)
    assert torch.equal(one, got) and one_levels == levels
    if max_steps > 120:          # the chain runs past 120 levels
        assert levels > 120


# ========================================================== absorb
def _shard_plan(ix, k, rng):
    """Replacement rows per bucket at every shard's first and last chunk
    row (below the bucket's real rows) and a few random ones, with
    random content; the pad entries of ``absorb_update_arrays`` then
    land in the last shard's padded tail wherever a bucket pads."""
    plan = {}
    for b, nbr in enumerate(ix.bucket_nbr):
        rows_b, D = nbr.shape
        chunk = -(-rows_b // k)
        ends = [r for s in range(k) for r in (s * chunk,
                                              min((s + 1) * chunk, rows_b)
                                              - 1) if 0 <= r < rows_b]
        rows = np.unique(np.concatenate(
            [ends, rng.choice(rows_b, min(3, rows_b),
                              replace=False)])).astype(np.int32)
        nn = rng.integers(0, ix.n_rows + 1, (len(rows), D)).astype(np.int32)
        ne = rng.integers(-2, 3, (len(rows), D)).astype(np.int32)
        plan[b] = (rows, nn, ne)
    return plan


def _claim_plan(jix, n, ed):
    """A plan_ell_absorb plan in which a non-hub vertex claims growth
    spares (the claimed rows sit in the cap bucket's tail)."""
    owners = set(jix.extra_owner.tolist())
    deg = np.bincount(ed, minlength=n)
    for v in range(n):
        if jix.perm[v] in owners or deg[v] == 0:
            continue
        cnt = 16 - int(deg[v]) + 3
        src = np.random.default_rng(v).integers(0, n, cnt)
        none = np.zeros(0, np.int64)
        claims = []
        plan = jell.plan_ell_absorb(
            jix, np.full(cnt, v), src, np.ones(cnt, np.int32), none, none,
            np.zeros(0, np.int32), claims_out=claims)
        if claims:
            return plan
    raise AssertionError("no vertex could claim a growth spare")


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", ["shard_ends", "growth_claim"])
def test_ell_absorb_sharded_matches_reference(ells, k, kind):
    jix, tix, _es, _hr, (_s, ed, _e, n) = ells
    rng = np.random.default_rng(k)
    plan = _shard_plan(tix, k, rng) if kind == "shard_ends" \
        else _claim_plan(jix, n, ed)
    counts, upd = jell.absorb_update_arrays(jix, plan)
    nb = len(jix.bucket_nbr)
    mesh = _jmesh(k)
    nbrs, ets, _reals = jell.shard_ell(mesh, "parts", jix)
    padded = [int(a.shape[0]) for a in nbrs]
    if kind == "shard_ends":
        assert any(p != len(r) for p, r in zip(padded, jix.bucket_nbr))
    kern = jell.make_sharded_ell_absorb_kernel(mesh, "parts", jix, padded,
                                               counts)
    outs = kern(*[jnp.asarray(u[0]) for u in upd],
                *[jnp.asarray(u[1]) for u in upd],
                *[jnp.asarray(u[2]) for u in upd], *nbrs, *ets)
    mt = mesh_tables(tix, _pmesh(k))
    before = [(t.nbr.clone(), t.et.clone()) for t in mt.shards]
    args = ([_t(u[0]) for u in upd], [_t(u[1]) for u in upd],
            [_t(u[2]) for u in upd])
    for fn in (ell_ops.ell_absorb_sharded_ref, ell_ops.ell_absorb_sharded):
        got = fn(mt, *args)
        gn, ge = got.host_shards()
        for b in range(nb):
            for s, (a, c) in enumerate(zip(_shards(outs[b]),
                                           _shards(outs[nb + b]))):
                assert np.array_equal(gn[s][b], a), (kind, b, s)
                assert np.array_equal(ge[s][b], c), (kind, b, s)
    for t, (n0, e0) in zip(mt.shards, before):      # inputs only read
        assert torch.equal(t.nbr, n0) and torch.equal(t.et, e0)
    # the gathered shards are the single-card absorb's tables
    host = jell.apply_ell_absorb_host(jix, plan, jix.m)
    hn, he, _ = shard_ell(ell_from_reference(
        {f: getattr(host, f) for f in ELL_FIELDS}), k)
    for s in range(k):
        for b in range(nb):
            assert np.array_equal(gn[s][b], hn[s][b])
            assert np.array_equal(ge[s][b], he[s][b])


# ======================================================= sharded_go
@pytest.mark.parametrize("k", KS)
def test_sharded_go_matches_reference(k):
    rng = np.random.RandomState(7 + k)
    n, m = 64, 402                   # m divides by no k: the pad runs
    es = rng.randint(0, n, m).astype(np.int32)
    ed = rng.randint(0, n, m).astype(np.int32)
    ee = rng.choice([1, 2, -1], m).astype(np.int32)
    start = np.array([3, 11, -1, -1], dtype=np.int32)
    mesh = _jmesh(k)
    kern = jkernels.make_sharded_go_kernel(mesh, "parts", n, 3, (1,))
    s_es, s_ed, s_ee, padded = jkernels.shard_edges(mesh, "parts", es, ed,
                                                    ee)
    f0 = jkernels.bitmap_from_idx(jnp.asarray(start), n)
    mask, front = kern(s_es, s_ed, s_ee, f0)
    pm = _pmesh(k)
    src, dst, et, size = edge_ops.shard_edges(pm, es, ed, ee)
    assert size == padded
    for fn in (edge_ops.sharded_go_ref, edge_ops.sharded_go):
        finals, fronts = fn(src, dst, et, _t(np.asarray(f0)), n, 3, (1,),
                            pm)
        assert np.array_equal(torch.cat(finals).numpy(), np.asarray(mask))
        for f in fronts:
            assert np.array_equal(f.numpy(), np.asarray(front))
    # and the single-card program, on the same edges sorted by source
    # (the CSR its hop walks): its mask in that order
    order = np.argsort(es, kind="stable")
    rp = np.concatenate([[0], np.cumsum(np.bincount(es, minlength=n))])
    gm, gf = edge_ops.go(_t(es[order]), _t(ed[order]), _t(ee[order]),
                         _t(rp.astype(np.int32)), _t(start), n, 3, (1,))
    assert np.array_equal(gm.numpy(), np.asarray(mask)[:m][order])
    assert np.array_equal(gf.numpy(), np.asarray(front))


# ========================================================== runtime
N_VERTICES = 90
MESH_BASE = {"tpu_ell_cap": 8, "tpu_mesh_mode": "dense",
             "go_dispatch_mode": "windowed"}


@pytest.fixture(scope="module")
def served():
    """(ok, port runtime, space, etype, cluster runtime): a JAX cluster
    and a port runtime (CPU shards) over the cluster's mirror, with the
    same ELL cap (hub extra rows at cap 8)."""
    from nebula_tpu.cluster import LocalCluster
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    c = LocalCluster(num_storage=1, tpu_backend=True)
    old_ref = _set_flags(ref_flags, MESH_BASE)
    old = _set_flags(flags, MESH_BASE)
    rt_ = None
    try:
        g = c.client()

        def ok(stmt):
            r = g.execute(stmt)
            assert r.ok(), f"{stmt}: {r.error_msg}"
            return r

        ok("CREATE SPACE u(partition_num=3, replica_factor=1)")
        c.refresh_all()
        ok("USE u")
        ok("CREATE EDGE e(w int)")
        c.refresh_all()
        rng = np.random.default_rng(29)
        src = rng.integers(1, N_VERTICES + 1, 400)
        dst = rng.integers(1, N_VERTICES + 1, 400)
        src[:40] = 1                     # out-hub: spills past cap 8
        dst[40:75] = 2                   # in-hub
        keep = src != dst
        ok("INSERT EDGE e(w) VALUES " + ", ".join(
            f"{a} -> {b}:({(a + b) % 7})"
            for a, b in zip(src[keep], dst[keep])))
        ok("GO 2 STEPS FROM 1 OVER e")
        space = next(iter(c.tpu_runtime.mirrors))
        m = c.tpu_runtime.mirror(space)
        et = int(np.abs(m.edge_etype).max())
        rt_ = TorchQueryRuntime(device="cpu")
        rt_.load_space(space, mirror_from_reference(
            {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=space))
        yield ok, rt_, space, et, c.tpu_runtime
    finally:
        if rt_ is not None:
            rt_.close()
        c.stop()
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


@pytest.fixture
def modes(served):
    """Set flags on both registries for a test; yields the setter."""
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    saved = []

    def use(values):
        saved.append((_set_flags(ref_flags, values),
                      _set_flags(flags, values)))
    yield use
    for old_ref, old in reversed(saved):
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


def _go_mix(rng, n_queries):
    """(ngql, starts, steps, count, reverse, limit): 1-4 steps, 1-4
    start vids, COUNT(*), REVERSELY, ``| LIMIT n`` on a third of the
    plain ones; no UPTO (a mesh declines it)."""
    out = []
    for i in range(n_queries):
        starts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                               int(rng.integers(1, 5)))]
        steps = 1 + i % 4
        count = i % 5 == 2
        reverse = i % 4 == 1
        limit = int(rng.integers(1, 7)) if not count and i % 3 == 0 \
            else None
        q = (f"GO {steps} STEPS FROM {','.join(map(str, starts))} OVER e"
             f"{' REVERSELY' if reverse else ''} YIELD e._dst"
             f"{' | YIELD COUNT(*)' if count else ''}"
             f"{f' | LIMIT {limit}' if limit is not None else ''}")
        out.append((q, starts, steps, count, reverse, limit))
    return out


def _check_go(ok, rt_, space, et, spec):
    q, starts, steps, count, reverse, limit = spec
    e = -et if reverse else et
    cols, rows = rt_.serve_go(space, starts, [e], steps, {e: "e"},
                              reduce=("count",) if count else None,
                              limit=limit)
    want = ok(q).rows
    assert cols == (["__count__"] if count else ["e._dst"]), q
    if count and not want:
        assert rows == [[0]], q
    else:
        assert rows == want, q


def _mesh_ran(ref_rt, space, k):
    cached = getattr(ref_rt.mirror(space), "_mesh_tables_cache", None)
    return cached is not None and cached[0] == k \
        and cached[1] is not None


@pytest.mark.parametrize("k", [2, 8])
def test_dense_mesh_go_matches_cluster(served, modes, k):
    """Windowed GO on a k-shard mesh, one request at a time: exact
    depth, REVERSELY, COUNT(*) (folded on the host) and LIMIT rows equal
    the cluster's in order, and the cluster's own mesh ran too."""
    ok, rt_, space, et, ref_rt = served
    modes({"tpu_mesh_devices": k})
    before = dict(rt_.stats)
    for spec in _go_mix(np.random.default_rng(40 + k), 16):
        _check_go(ok, rt_, space, et, spec)
    assert rt_.stats["go_mesh"] > before["go_mesh"]
    assert rt_.stats["go_sparse"] == before["go_sparse"]
    assert rt_.stats["go_adaptive"] == before["go_adaptive"]
    assert _mesh_ran(ref_rt, space, k)
    mt = rt_.mirror(space)._mesh_tables_cache[1]
    assert mt.k == k and mt.mesh.devices == (CPU,) * k


def test_dense_mesh_batches_and_packing_off(served, modes):
    """Multi-start batches through ``go_batch`` (one launch each) equal
    the reference's; with packing off the mesh still runs packed."""
    _ok, rt_, space, et, ref_rt = served
    modes({"tpu_mesh_devices": 2})
    rng = np.random.default_rng(5)
    batch = [[int(v) for v in rng.integers(1, N_VERTICES + 1,
                                           int(rng.integers(1, 6)))]
             for _ in range(12)]
    for steps in (2, 3):
        want = ref_rt.go_batch(space, batch, [et], steps)
        before = rt_.stats["go_mesh"]
        got = rt_.go_batch(space, batch, [et], steps)
        assert np.array_equal(got, want)
        assert rt_.stats["go_mesh"] == before + 1
    modes({"tpu_packed_frontier": False})
    for spec in _go_mix(np.random.default_rng(8), 8):
        _check_go(_ok, rt_, space, et, spec)
    assert rt_.stats["go_mesh"] > before + 1


@pytest.mark.parametrize("k", [2, 8])
@pytest.mark.parametrize("shortest", [True, False])
def test_dense_mesh_find_path_matches_cluster(served, modes, k, shortest):
    ok, rt_, space, et, _ref_rt = served
    modes({"tpu_mesh_devices": k})
    rng = np.random.default_rng(3 + shortest + k)
    kind = "SHORTEST" if shortest else "ALL"
    before = rt_.stats["path_mesh"]
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
    assert rt_.stats["path_mesh"] == before + 5


def test_sparse_mode_and_upto_decline_naming_the_kernel(served, modes):
    """``tpu_mesh_mode=sparse`` now serves GO and FIND PATH on the
    frontier-sharded programs (rows equal the cluster's); UPTO on a mesh
    still declines, in either mode."""
    from nebula_tpu_torch.storage.device import TpuDecline
    ok, rt_, space, et, _ref_rt = served
    modes({"tpu_mesh_devices": 2, "tpu_mesh_mode": "sparse"})
    before = dict(rt_.stats)
    cols, rows = rt_.serve_go(space, [1], [et], 3, {et: "e"})
    assert cols == ["e._dst"]
    assert rows == ok("GO 3 STEPS FROM 1 OVER e YIELD e._dst").rows
    cols, rows = rt_.serve_find_path(space, [1], [2], [et], 3, True,
                                     {et: "e"})
    assert sorted(map(tuple, rows)) == sorted(map(tuple, ok(
        "FIND SHORTEST PATH FROM 1 TO 2 OVER e UPTO 3 STEPS").rows))
    assert rt_.stats["go_mesh_sparse"] == before["go_mesh_sparse"] + 1
    assert rt_.stats["bfs_mesh_sparse"] == before["bfs_mesh_sparse"] + 1
    for mode in ("sparse", "dense"):
        modes({"tpu_mesh_mode": mode})
        with pytest.raises(TpuDecline, match="UPTO"):
            rt_.serve_go(space, [1], [et], 3, {et: "e"}, upto=True)


def test_continuous_mode_refuses_the_stream_under_a_mesh(served, modes):
    """The repaired gate (runtime.py:1531-1534): with a mesh configured
    ``continuous_session`` returns None from the flag alone, and GO in
    continuous mode serves windowed through the mesh."""
    ok, rt_, space, et, _ref_rt = served
    modes({"go_dispatch_mode": "continuous", "tpu_mesh_devices": 4})
    streams = len(rt_.continuous.streams())
    assert rt_.continuous_session(space, (et,)) is None
    before = rt_.stats["go_mesh"]
    for spec in _go_mix(np.random.default_rng(17), 8):
        _check_go(ok, rt_, space, et, spec)
    assert len(rt_.continuous.streams()) == streams
    assert rt_.stats["go_mesh"] > before
    modes({"tpu_mesh_devices": 0})
    assert rt_.continuous_session(space, (et,)) is not None


def test_too_few_cards_warns_and_runs_single_device(capsys):
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    rt_ = TorchQueryRuntime(device="cpu", mesh_devices=[CPU, CPU])
    old = _set_flags(flags, {"tpu_mesh_devices": 3})
    try:
        assert rt_._mesh_only() is None
        assert rt_._mesh_only() is None
        err = capsys.readouterr().err
        assert err.count("tpu_mesh_devices=3 but only 2 devices") == 1
        flags.set("tpu_mesh_devices", 2)
        assert rt_._mesh_only() == PartsMesh([CPU, CPU])
    finally:
        _set_flags(flags, old)
        rt_.close()


# ======================================================= absorbed write
def test_absorbed_write_updates_the_sharded_tables():
    """A store-backed pair on a 2-shard mesh: a write window absorbs
    into the resident sharded tables (``ell_absorb_sharded``, never a
    re-shard); the new tables equal a fresh ``shard_ell`` of the new
    host ELL and the reference's absorbed shards, and the answers equal
    the reference's."""
    import nebula_tpu.graph.batch_dispatch  # noqa: F401 — its flags
    from nebula_tpu.common.flags import flags as rflags
    from nebula_tpu_torch.common.flags import flags as pflags
    from test_torch_absorb import FLAGS, N, Side
    k = 2
    values = dict(FLAGS, tpu_mesh_devices=k, tpu_mesh_mode="dense",
                  go_dispatch_mode="windowed")
    old_r, old_p = _set_flags(rflags, values), _set_flags(pflags, values)
    ref, port = Side(False), Side(True)
    try:
        rng = np.random.default_rng(9)
        base = [(v, v % N + 1, 0, 1) for v in range(1, N + 1)]
        base += [(int(a), int(b), 0, 2) for a, b in
                 rng.integers(1, N + 1, (60, 2)) if a != b]
        for side in (ref, port):
            side.edges(base)
        ask = lambda side: [sorted(map(tuple, side.go([s], 3)[1]))  # noqa
                            for s in (1, 5, 9)]
        assert ask(port) == ask(ref)
        m0 = port.rt.mirror(5)
        mt0 = m0._mesh_tables_cache[1]
        calls = []
        real = ell_ops.ell_absorb_sharded

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)
        ell_ops.ell_absorb_sharded = spy
        try:
            new = [(7, 30, 5, 3), (30, 41, 5, 3), (12, 2, 5, 3)]
            for side in (ref, port):
                side.edges(new)
            assert ask(port) == ask(ref)
        finally:
            ell_ops.ell_absorb_sharded = real
        m1 = port.rt.mirror(5)
        assert m1 is not m0 and calls == [1]
        assert port.rt.stats["mirror_absorbs"] == 1
        assert port.rt.stats["mesh_absorbs"] == 1
        k1, mt1 = m1._mesh_tables_cache
        assert k1 == k and mt1.mesh == mt0.mesh
        gn, ge = mt1.host_shards()
        hn, he, _ = shard_ell(port.rt.ell(m1), k)
        rn, re_, _ = ref.rt.mirror(5)._mesh_tables_cache[1][1:]
        for s in range(k):
            for b in range(len(hn[s])):
                assert np.array_equal(gn[s][b], hn[s][b])
                assert np.array_equal(ge[s][b], he[s][b])
                assert np.array_equal(gn[s][b], _shards(rn[b])[s])
                assert np.array_equal(ge[s][b], _shards(re_[b])[s])
        # the published generation's tables are untouched
        h0n, h0e, _ = shard_ell(port.rt.ell(m0), k)
        on, oe = mt0.host_shards()
        assert all(np.array_equal(on[s][b], h0n[s][b])
                   and np.array_equal(oe[s][b], h0e[s][b])
                   for s in range(k) for b in range(len(h0n[s])))
        assert (30,) in map(tuple, port.go([7], 1)[1])
    finally:
        ref.close()
        port.close()
        _set_flags(rflags, old_r)
        _set_flags(pflags, old_p)
