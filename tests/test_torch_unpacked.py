"""The packing-off route (``tpu_packed_frontier=false``) of the port
against the JAX functions it replaces: the int8 start upload
(``TpuQueryRuntime._upload_frontier``, runtime.py:3228), the int8 dense
GO (``make_batched_go_kernel``, ell.py:1140) with its row pack
(``pack_bits``, ell.py:439) and the int8 batched BFS
(``make_batched_bfs_kernel``, ell.py:1616); then GO and FIND PATH served
end to end with packing off on a JAX cluster and on the port.

The same seeded numpy inputs go through the JAX function on CPU jax and
the port's wrapper on CPU torch (the plain route).  Frontiers, packed
bits and depths are compared for exact equality over every one of the
``n_rows + 1`` rows.  The ELL is the JAX package's own numpy build at
cap 16 (three buckets, hub extra rows), with 8 growth spares of which
one is claimed through ``plan_ell_absorb`` (its owner's extra row sits
apart from the other hubs'), carried into the port.  Besides 0/1 lanes
the hop takes an arbitrary int8 input, negative values and values > 1
included: the reference's max is exact there and an OR is not.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu.runtime import TpuQueryRuntime
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import ELL_FIELDS, ell_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

CPU = torch.device("cpu")
CHAIN = 160                 # a path longer than 120 levels
OVER_SETS = [(1,), (-1, 1, 2), (1, 7)]      # 7: an etype no edge has


def _graph(seed=11, n=300, m=1400):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2):
    a random graph with an out-hub and an in-hub past cap 16, and a
    chain of CHAIN vertices after it."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:60] = 5
    dst[60:110] = 9
    et = rng.integers(1, 3, m)
    chain = np.arange(n, n + CHAIN - 1)
    src = np.concatenate([src, chain])
    dst = np.concatenate([dst, chain + 1])
    et = np.concatenate([et, np.ones(CHAIN - 1, np.int64)])
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([et, -et]).astype(np.int32)
    return es, ed, ee, n + CHAIN


def _claim_a_spare(jix, n, ed):
    """The next generation of ``jix`` after a non-hub vertex outgrows
    its row: ``plan_ell_absorb`` claims a growth spare for it."""
    owners = set(jix.extra_owner.tolist())
    deg = np.bincount(ed, minlength=n)
    for v in range(n):
        if jix.perm[v] in owners or deg[v] == 0:
            continue
        k = 16 - int(deg[v]) + 3
        src = np.random.default_rng(v).integers(0, n, k)
        none = np.zeros(0, np.int64)
        claims = []
        plan = jell.plan_ell_absorb(
            jix, np.full(k, v), src, np.ones(k, np.int32), none, none,
            np.zeros(0, np.int32), claims_out=claims)
        if claims:
            return jell.apply_ell_absorb_host(jix, plan, jix.m + k,
                                              claims=claims)
    raise AssertionError("no vertex could claim a growth spare")


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    base = jell.EllIndex.build(es, ed, ee, n, cap=16, min_d=4,
                               use_native=False, growth_slack=8)
    jix = _claim_a_spare(base, n, ed)
    spare = jix.spare_sentinel()
    claimed = jix.extra_owner[(base.extra_owner == spare)
                              & (jix.extra_owner != spare)]
    assert len(jix.bucket_D) == 3 and len(claimed) == 1
    assert (jix.extra_owner == spare).sum() > 0      # unclaimed spares
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    es_, hr = tix.hub_merge()
    port = dict(tables=tix.device_tables(CPU), eslot=_t(es_), hrows=_t(hr))
    return jix, tix, port, jix.kernel_args()


@pytest.fixture(scope="module")
def rt():
    return TorchQueryRuntime(device="cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _starts(rng, tix, nq, per_query=3, dup=True):
    """Flat (new-id row, query col) start coordinates, with repeated
    pairs when ``dup``."""
    rows = tix.perm[rng.integers(0, tix.n, nq * per_query)]
    cols = np.repeat(np.arange(nq, dtype=np.int32), per_query)
    if dup:
        rows = np.concatenate([rows, rows[:5]])
        cols = np.concatenate([cols, cols[:5]])
    return rows.astype(np.int32), cols.astype(np.int32)


def _upload(jix, rows, cols, B):
    return np.asarray(TpuQueryRuntime._upload_frontier(jix, rows, cols, B))


# ================================================== frontier upload
@pytest.mark.parametrize("B", [8, 12, 128])
@pytest.mark.parametrize("case", ["pairs", "duplicates", "empty"])
def test_upload_frontier_matches_jax(ells, rt, B, case):
    jix, tix, _port, _ref = ells
    rng = np.random.default_rng(B)
    if case == "empty":
        rows = np.zeros(0, np.int32)
        cols = np.zeros(0, np.int32)
    else:
        rows, cols = _starts(rng, tix, B, dup=case == "duplicates")
        cols = (cols * 5) % B
    want = _upload(jix, rows, cols, B)
    got = rt._upload_frontier(tix, rows, cols, B)
    assert got.dtype == torch.int8 and got.shape == (tix.n_rows + 1, B)
    assert np.array_equal(want, got.numpy())
    assert not got[-1].any()            # the pad row ends zero
    assert bool(got.any()) == (case != "empty")


# =============================================================== hop
def _frontier(jix, tix, B, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "arbitrary":              # negative values and values > 1
        return rng.integers(-128, 128, (tix.n_rows + 1, B), dtype=np.int8)
    rows, cols = _starts(rng, tix, B, per_query=4)
    return _upload(jix, rows, cols % B, B)


@pytest.mark.parametrize("B", [8, 12, 128])
@pytest.mark.parametrize("over", OVER_SETS)
def test_go_hop_i8_matches_one_jax_advance(ells, B, over):
    jix, tix, port, ref = ells
    for kind in ("lanes", "arbitrary"):
        f0 = _frontier(jix, tix, B, kind, B + len(over))
        kern = jell.make_batched_go_kernel(jix, 2, over, pack=False)
        want = np.asarray(kern(jnp.asarray(f0), *ref))
        out = torch.empty_like(_t(f0))
        got, acc = ell_ops.go_hop_i8(_t(f0), None, out, over=over, **port)
        assert acc is None and got is out
        assert np.array_equal(want, got.numpy()), kind
        assert not got[-1].any()
        if kind == "arbitrary":
            assert (f0 < 0).any() and (f0 > 1).any()
            assert (want > 1).any()          # values, not bits, moved


def test_go_hop_i8_merges_every_extra_row_into_its_owner(ells):
    """The hub pass: each extra row's value reaches its owner, the
    claimed spare's too, and the pad row stays zero."""
    jix, tix, port, ref = ells
    B = 8
    f0 = np.zeros((tix.n_rows + 1, B), np.int8)
    f0[:tix.n] = 3                       # every real row live
    out = torch.empty_like(_t(f0))
    ell_ops.go_hop_i8(_t(f0), None, out, over=(-2, -1, 1, 2), **port)
    got = out.numpy()
    want = np.asarray(jell.make_batched_go_kernel(
        jix, 2, (-2, -1, 1, 2))(jnp.asarray(f0), *ref))
    assert np.array_equal(want, got) and not got[-1].any()
    spare = jix.spare_sentinel()
    for e, owner in enumerate(jix.extra_owner):
        if owner < spare and got[tix.n + e].any():
            assert (got[owner] >= got[tix.n + e]).all()


# ============================================================ ell_go
@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("upto", [False, True])
@pytest.mark.parametrize("pack", [False, True])
def test_ell_go_i8_matches_jax(ells, steps, upto, pack):
    jix, tix, port, ref = ells
    B = 12 if steps % 2 else 128
    over = OVER_SETS[steps % len(OVER_SETS)]
    f0 = _frontier(jix, tix, B, "lanes", 10 * steps + upto)
    kern = jell.make_batched_go_kernel(jix, steps, over, pack=pack,
                                       upto=upto)
    want = np.asarray(kern(jnp.asarray(f0), *ref))
    got = ell_ops.ell_go_i8(_t(f0), over=over, steps=steps, upto=upto,
                            pack=pack, **port)
    R1 = tix.n_rows + 1
    if pack:
        assert got.dtype == torch.uint8 and got.shape == (-(-R1 // 8), B)
    else:
        assert got.dtype == torch.int8 and got.shape == (R1, B)
    assert np.array_equal(want, got.numpy())


@pytest.mark.parametrize("R1,B", [(29, 5), (29, 8), (64, 12), (3, 4)])
def test_pack_rows_matches_pack_bits(R1, B):
    x = np.random.default_rng(R1 * B).integers(-128, 128, (R1, B),
                                               dtype=np.int8)
    want = np.asarray(jell.pack_bits(jnp, jnp.asarray(x)))
    out = torch.empty((-(-R1 // 8), B), dtype=torch.uint8)
    got = ell_ops.pack_rows(_t(x), out)
    assert np.array_equal(want, got.numpy())
    # the host half inverts it
    from nebula_tpu_torch.tpu.ell import unpack_bits
    assert np.array_equal(unpack_bits(got.numpy(), R1), x > 0)


# =========================================================== ell_bfs
@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("max_steps", [5, 130])
def test_ell_bfs_i8_matches_jax(ells, stop, max_steps):
    """Starts include the chain's head, so at 130 levels depths pass 120
    and ride int16; the levels run equal the packed route's."""
    jix, tix, port, ref = ells
    B = 128
    rng = np.random.default_rng(max_steps + 3 * stop)
    nq = 24
    rows, cols = _starts(rng, tix, nq, per_query=1, dup=False)
    rows[0] = tix.perm[tix.n - CHAIN]            # lane 0: the chain head
    trows, tcols = _starts(rng, tix, nq, per_query=2, dup=False)
    trows[0] = tix.perm[tix.n - 1]               # ... aimed at its tail
    f0 = _upload(jix, rows, cols, B)
    t0 = _upload(jix, trows, tcols, B)
    kern = jell.make_batched_bfs_kernel(jix, max_steps, OVER_SETS[1],
                                        stop_when_found=stop)
    want = np.asarray(kern(jnp.asarray(f0), jnp.asarray(t0), *ref))
    got, levels = ell_ops.ell_bfs_i8(_t(f0), _t(t0), over=OVER_SETS[1],
                                     max_steps=max_steps,
                                     stop_when_found=stop, **port)
    small = max_steps <= 120
    assert got.dtype == (torch.int8 if small else torch.int16)
    assert got.shape == (tix.n_rows + 1, B)
    assert np.array_equal(want, got.numpy())
    if not small:
        reached = want[want != np.iinfo(np.int16).max]
        assert reached.max() == max_steps        # the chain, past 120
    fp = np.packbits(f0 > 0, axis=1, bitorder="little")
    tp = np.packbits(t0 > 0, axis=1, bitorder="little")
    packed, packed_levels = ell_ops.ell_bfs(
        _t(fp), _t(tp), over=OVER_SETS[1], max_steps=max_steps,
        stop_when_found=stop, **port)
    assert np.array_equal(packed.numpy(), got.numpy())
    assert levels == packed_levels and 1 <= levels <= max_steps


def test_ell_bfs_i8_reads_the_start_frontier_as_values(ells):
    """The first hop reads f0 itself: a negative start is not a start,
    a start of 7 is, and the targets count where t0 > 0."""
    jix, tix, port, ref = ells
    B = 8
    rng = np.random.default_rng(3)
    f0 = rng.integers(-3, 8, (tix.n_rows + 1, B), dtype=np.int8)
    f0[rng.random(f0.shape) < 0.95] = 0
    f0[-1] = 0
    t0 = rng.integers(-2, 3, f0.shape, dtype=np.int8)
    kern = jell.make_batched_bfs_kernel(jix, 4, (1,), stop_when_found=True)
    want = np.asarray(kern(jnp.asarray(f0), jnp.asarray(t0), *ref))
    got, _levels = ell_ops.ell_bfs_i8(_t(f0), _t(t0), over=(1,),
                                      max_steps=4, **port)
    assert np.array_equal(want, got.numpy())


def test_int8_wrappers_refuse_what_the_kernels_cannot_take(ells):
    _jix, tix, port, _ref = ells
    R1 = tix.n_rows + 1
    f = torch.zeros((R1, 8), dtype=torch.int8)
    with pytest.raises(TypeError):       # the carrier is int8
        ell_ops.go_hop_i8(f.to(torch.uint8), None, f, over=(1,), **port)
    with pytest.raises(ValueError):      # out must not alias f
        ell_ops.go_hop_i8(f, None, f, over=(1,), **port)
    with pytest.raises(ValueError):      # wrong row count
        ell_ops.go_hop_i8(f[:-1].contiguous(), None, f[:-1].clone(),
                          over=(1,), **port)
    with pytest.raises(ValueError):      # S past the list
        ell_ops.frontier_upload_i8(f, torch.zeros(8, dtype=torch.int32),
                                   torch.zeros(8, dtype=torch.int32), 9)
    with pytest.raises(ValueError):      # pack output has ceil(R1/8) rows
        ell_ops.pack_rows(f, torch.zeros((R1, 8), dtype=torch.uint8))
    bits = torch.zeros((R1, 1), dtype=torch.uint8)     # ceil(8 / 8)
    flags = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):      # d is [R1, B]
        ell_ops.bfs_level_i8(f, bits, bits.clone(),
                             torch.zeros((R1, 64), dtype=torch.int16),
                             flags, 0)
    with pytest.raises(ValueError):      # seen is a lane bitmap [R1, B/8]
        ell_ops.bfs_level_i8(f, bits, torch.zeros((R1, 8), dtype=torch.uint8),
                             torch.zeros((R1, 8), dtype=torch.int8), flags, 0)
    with pytest.raises(ValueError):      # an int8 depth stops below 127
        ell_ops.bfs_level_i8(f, bits, bits.clone(),
                             torch.zeros((R1, 8), dtype=torch.int8), flags,
                             126)
    with pytest.raises(ValueError):      # only the first pass packs t8
        ell_ops.bfs_level_i8(f, bits, bits.clone(),
                             torch.zeros((R1, 8), dtype=torch.int8), flags,
                             0, t8=f)
    with pytest.raises(ValueError):      # depths must fit int16
        ell_ops.ell_bfs_i8(f, f.clone(), over=(1,), max_steps=1 << 15,
                           **port)


# ============================================ served end to end
N_VERTICES = 90
UNPACKED = {"tpu_packed_frontier": False, "tpu_ell_cap": 8}
DENSE = {"go_dispatch_mode": "windowed", "tpu_sparse_go": False,
         "tpu_adaptive_single": False}


def _set_flags(registry, values):
    """Set ``values`` on a flag registry; returns the old values."""
    old = {k: registry.get(k) for k in values}
    for k, v in values.items():
        assert registry.set(k, v), k
    return old


@pytest.fixture(scope="module")
def served():
    """(ok, port runtime, space, etype, cluster runtime): a JAX cluster
    and a port runtime over the cluster's mirror, both with packing off
    and the same ELL cap (hub extra rows at cap 8)."""
    from nebula_tpu.cluster import LocalCluster
    from nebula_tpu.common.flags import flags as ref_flags
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
    c = LocalCluster(num_storage=1, tpu_backend=True)
    old_ref = _set_flags(ref_flags, UNPACKED)
    old = _set_flags(flags, UNPACKED)
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
        rng = np.random.default_rng(23)
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
        assert np.array_equal(c.tpu_runtime.ell(m).perm,
                              rt_.ell(rt_.mirror(space)).perm)
        yield ok, rt_, space, et, c.tpu_runtime
    finally:
        if rt_ is not None:
            rt_.close()
        c.stop()
        _set_flags(ref_flags, old_ref)
        _set_flags(flags, old)


@pytest.fixture
def modes(served):
    """Set one flag mode on both sides for a test; yields the setter."""
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
    """(ngql, starts, steps, upto, count, reverse, limit) tuples: 1-4
    steps, 1-4 start vids, UPTO, COUNT(*), REVERSELY, and ``| LIMIT n``
    on a third of the plain exact-depth requests."""
    out = []
    for i in range(n_queries):
        starts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                               int(rng.integers(1, 5)))]
        if i % 11 == 3:
            starts.append(10 ** 6)       # an absent vid drops
        steps = int(rng.integers(1, 5))
        upto = bool(rng.random() < 0.35) and steps > 1
        count = bool(rng.random() < 0.35)
        reverse = bool(rng.random() < 0.25)
        limit = None
        if not (upto or count) and i % 3 == 0:
            limit = int(rng.integers(1, 7))
        q = (f"GO {'UPTO ' if upto else ''}{steps} STEPS FROM "
             f"{','.join(map(str, starts))} OVER e"
             f"{' REVERSELY' if reverse else ''} YIELD e._dst"
             f"{' | YIELD COUNT(*)' if count else ''}"
             f"{f' | LIMIT {limit}' if limit is not None else ''}")
        out.append((q, starts, steps, upto, count, reverse, limit))
    return out


def _serve(rt_, space, et, spec):
    _q, starts, steps, upto, count, reverse, limit = spec
    e = -et if reverse else et
    return rt_.serve_go(space, starts, [e], steps, {e: "e"}, upto=upto,
                        reduce=("count",) if count else None, limit=limit)


def _check_rows(ok, rt_, space, et, spec, in_order: bool):
    cols, rows = _serve(rt_, space, et, spec)
    want = ok(spec[0]).rows
    assert cols == (["__count__"] if spec[4] else ["e._dst"]), spec[0]
    if spec[4] and not want:             # COUNT over no rows: no row
        assert rows == [[0]], spec[0]
    elif in_order:
        assert rows == want, spec[0]
    else:
        assert sorted(map(tuple, rows)) == sorted(map(tuple, want)), spec[0]


def test_windowed_dense_go_matches_cluster(served, modes):
    """The unpacked ``ell_go`` route one request at a time: exact, UPTO,
    REVERSELY, COUNT(*) (counted on the host) and LIMIT rows equal the
    cluster's in order (both sides cut the same dense rows)."""
    ok, rt_, space, et, ref_rt = served
    modes(DENSE)
    before = dict(rt_.stats)
    ref_dense = ref_rt.stats.get("go_dense", 0)
    mix = _go_mix(np.random.default_rng(31), 40)
    assert sum(s[6] is not None for s in mix) >= 5
    assert sum(s[4] for s in mix) >= 5
    for spec in mix:
        _check_rows(ok, rt_, space, et, spec, in_order=True)
    assert rt_.stats["go_dense"] > before["go_dense"]
    assert ref_rt.stats.get("go_dense", 0) > ref_dense
    assert rt_.stats["go_reduced"] > before["go_reduced"]
    assert rt_.continuous.streams() == []


def test_sparse_overflow_reruns_on_the_unpacked_kernel(served, modes):
    """Windowed at default routes with a tight sparse cap: batches
    overflow and rerun on the unpacked dense route (COUNT(*) as vertex
    lists); every answer equals the cluster's."""
    ok, rt_, space, et, _ref_rt = served
    modes({"go_dispatch_mode": "windowed", "tpu_sparse_go": True,
           "tpu_adaptive_single": True, "tpu_sparse_c0s": "8,64",
           "tpu_sparse_cap": 8})
    before = dict(rt_.stats)
    mix = [s for s in _go_mix(np.random.default_rng(59), 36)
           if s[2] >= 3]
    assert any(s[4] for s in mix)
    for spec in mix:
        _check_rows(ok, rt_, space, et, spec, in_order=True)
    assert rt_.stats["sparse_overflows"] > before["sparse_overflows"]
    assert rt_.stats["go_dense"] > before["go_dense"]


def test_continuous_mode_takes_the_windowed_pipeline(served, modes):
    """go_dispatch_mode=continuous with packing off: no stream anchors
    (the session refuses, as the reference's does), and every GO's rows
    equal the cluster's."""
    ok, rt_, space, et, _ref_rt = served
    modes({"go_dispatch_mode": "continuous", "tpu_sparse_go": False,
           "tpu_adaptive_single": False})
    assert rt_.continuous_session(space, (et,)) is None
    before = dict(rt_.stats)
    mix = [s for s in _go_mix(np.random.default_rng(41), 30) if s[2] > 1]
    for spec in mix:
        _check_rows(ok, rt_, space, et, spec, in_order=False)
    assert rt_.continuous.streams() == []
    assert rt_.stats["go_dense"] > before["go_dense"]


@pytest.mark.parametrize("shortest", [True, False])
def test_find_path_matches_cluster(served, shortest):
    ok, rt_, space, et, _ref_rt = served
    rng = np.random.default_rng(3 + shortest)
    kind = "SHORTEST" if shortest else "ALL"
    before = rt_.stats["bfs_dispatches"]
    found = 0
    for i in range(12):
        srcs = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                             int(rng.integers(1, 3)))]
        dsts = [int(v) for v in rng.integers(1, N_VERTICES + 1,
                                             int(rng.integers(1, 3)))]
        steps = int(rng.integers(2, 5 if shortest else 4))
        q = (f"FIND {kind} PATH FROM {','.join(map(str, srcs))} TO "
             f"{','.join(map(str, dsts))} OVER e UPTO {steps} STEPS")
        cols, rows = rt_.serve_find_path(space, srcs, dsts, [et], steps,
                                         shortest, {et: "e"})
        want = sorted(map(tuple, ok(q).rows))
        assert cols == ["path"] and sorted(map(tuple, rows)) == want, q
        found += len(want)
    assert found > 0
    assert rt_.stats["bfs_dispatches"] > before


@pytest.mark.parametrize("max_steps", [3, 121])
def test_bfs_batch_matches_jax_runtime(served, max_steps):
    _ok, rt_, space, et, jrt = served
    rng = np.random.default_rng(max_steps)
    starts = [[int(v) for v in rng.integers(1, N_VERTICES + 1, 2)]
              for _ in range(10)]
    targets = [[int(v) for v in rng.integers(1, N_VERTICES + 1, 2)]
               for _ in range(10)]
    want = jrt.bfs_batch(space, starts, targets, [et], max_steps)
    got = rt_.bfs_batch(space, starts, targets, [et], max_steps)
    assert got.dtype == np.int16 and np.array_equal(got, want)
