"""The packed hop's launch plan and fused union, and the mesh's
multi-source OR (``or_many``) under ``psum_or``'s receive slabs
(nebula_tpu_torch/tpu/ell_ops.py, tpu/mesh.py) against the JAX
functions they replace (nebula_tpu/tpu/ell.py:665
``make_continuous_hop_kernel``, nebula_tpu/tpu/kernels.py:364
``make_sharded_go_kernel`` with its ``jax.lax.psum``).

On the CPU every wrapper takes its plain version; the launch plan is
host arithmetic, held here to the block-to-bucket lookup the kernel
makes (``ell_lanes.cu`` ``hop_gather_kernel``).  Frontiers and bitmaps
are bits, so every comparison is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu import kernels as jkernels
from nebula_tpu_torch.tpu import edge_ops, ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, EllIndex,
                                      ell_from_reference, shard_ell)
from nebula_tpu_torch.tpu.mesh import PartsMesh, psum_or

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _graph(seed=5, n=360, m=2400):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2)
    with an out-hub and an in-hub past the caps used here."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:150] = 4
    dst[150:260] = 9
    et = rng.integers(1, 3, m)
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([et, -et]).astype(np.int32)
    return es, ed, ee, n


# ====================================================== launch plan
def _blocks(rows, D, W, wide):
    """(bucket, local rows) of every block, by the kernel's lookup:
    bucket = the last b with blk0[b] <= block, rows (block - blk0[b]) *
    (HOP_THREADS / G) onward, those below rows[b] live."""
    lgc, lg, blk0, blocks = ell_ops.hop_plan(rows, D, W,
                                             16 if wide else 4)
    out = []
    for blk in range(blocks):
        b = 0
        for k in range(1, len(rows)):
            if blk0[k] <= blk:
                b = k
        per = ell_ops.HOP_THREADS >> lg[b]
        lo = (blk - blk0[b]) * per
        out.append((b, lo, lo + per))
    return lgc, lg, blk0, blocks, out


def _check_plan(rows, D, W, wide):
    lgc, lg, blk0, blocks, spans = _blocks(rows, D, W, wide)
    C = W // 16 if wide else W // 4
    cg = min(32, 1 << max(0, C - 1).bit_length())
    assert 1 << lgc == cg          # a row's columns over Cg lanes
    seen = [np.zeros(r, np.int64) for r in rows]
    for b, lo, hi in spans:
        assert lo < rows[b], "a block with no live row"
        seen[b][lo:min(hi, rows[b])] += 1
    for b, r in enumerate(rows):
        assert (seen[b] == 1).all(), f"bucket {b}: rows covered unevenly"
        G = 1 << lg[b]
        assert cg <= G <= 32
        per = ell_ops.HOP_THREADS // G
        nxt = blk0[b + 1] if b + 1 < len(rows) else blocks
        # the bucket's blocks are exactly its own: none spans two
        assert nxt - blk0[b] == -(-r // per)
        # about HOP_CHUNK slots a lane, unless G is at its 32-lane cap
        P = G // cg
        assert -(-D[b] // P) <= ell_ops.HOP_CHUNK or G == 32
    assert blocks == sum(-(-r // (ell_ops.HOP_THREADS >> g))
                         for r, g in zip(rows, lg))
    return lg


# the serve tables' ladder (D = 8 ... 512), the hub extras in the cap
# bucket, one empty bucket, and a bucket of one row
SERVE_ROWS = [310_000, 118_000, 52_000, 25_000, 0, 1, 4_100, 1_600 + 491]
SERVE_D = [8, 16, 32, 64, 96, 128, 256, 512]


@pytest.mark.parametrize("W,wide", [(16, True), (128, True), (4, False),
                                    (12, False), (16, False), (48, True),
                                    (160, False), (1024, True)])
def test_hop_plan_covers_every_row_once_on_the_serve_ladder(W, wide):
    lg = _check_plan(SERVE_ROWS, SERVE_D, W, wide)
    if W == 16 and wide:         # one 16-byte column: G = P
        assert [1 << g for g in lg] == [1, 2, 4, 8, 16, 16, 32, 32]
    if W == 128 and wide:        # eight columns, at most four parts
        assert [1 << g for g in lg] == [8, 16, 32, 32, 32, 32, 32, 32]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("W", [16, 128])
def test_hop_plan_on_shard_ell_tables(k, W):
    es, ed, ee, n = _graph()
    ix = EllIndex.build(es, ed, ee, n, cap=32, min_d=8, growth_slack=5)
    nbrs, _ets, reals = shard_ell(ix, k)
    assert len(ix.extra_owner) > 5
    for s in range(k):
        rows = [int(x.shape[0]) for x in nbrs[s]]
        D = [int(x.shape[1]) for x in nbrs[s]]
        assert sum(rows) * k >= sum(reals)
        _check_plan(rows, D, W, True)


def test_hop_plan_is_made_once_per_geometry():
    es, ed, ee, n = _graph()
    ix = EllIndex.build(es, ed, ee, n, cap=16, min_d=8)
    t = ix.device_tables(CPU)
    a = ell_ops._hop_desc(t.row0, t.slot0, t.rows, t.D, 16, 16)
    b = ell_ops._hop_desc(t.row0, t.slot0, t.rows, t.D, 16, 16)
    assert a is b
    lgc, lg, blk0, blocks = ell_ops.hop_plan(t.rows, t.D, 16, 16)
    want = [v for i in range(len(t.D))
            for v in (t.row0[i], t.slot0[i], t.rows[i], t.D[i], lg[i],
                      blk0[i])]
    assert list(a[0]) == want and a[1:] == (blocks, lgc)
    # no row at all: still one block, which zeroes the pad row
    assert ell_ops._hop_desc((0,), (0,), (0,), (8,), 16, 16)[1] == 1
    assert ell_ops._over_check([2, 1, 2]) == (1, 2)
    assert ell_ops._over_check([1, 2]) is ell_ops._over_check((1, 2))
    assert ell_ops._bucket_desc(t) is ell_ops._bucket_desc(
        ix.device_tables(CPU))
    with pytest.raises(ValueError):
        ell_ops._over_check(())


# ========================================= the hop with its fused union
def _frontier(rng, R1, W, density=0.08):
    f = rng.integers(0, 256, (R1, W), dtype=np.uint8)
    f &= (rng.random((R1, 1)) < density).astype(np.uint8) * 255
    f[-1] = 0
    return f


@pytest.mark.parametrize("cap,W", [(12, 4), (12, 48), (32, 12),
                                   (32, 160)])
def test_go_hop_with_accumulator_and_hubs_matches_jax(cap, W):
    """``accp`` and hub owners, several hops, off the W = 16 / 128
    ladder and at a cap that is not a power of two: the union the
    kernel fuses into its gather and merge is the reference's
    ``accp | hop(fp)``."""
    es, ed, ee, n = _graph()
    jix = jell.EllIndex.build(es, ed, ee, n, cap=cap, min_d=4,
                              use_native=False, growth_slack=4)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    assert len(jix.extra_owner) > 4
    rng = np.random.default_rng(cap + W)
    R1 = tix.n_rows + 1
    fp = _frontier(rng, R1, W)
    accp = fp | _frontier(rng, R1, W, 0.05)
    es_, hr = jix.hub_merge()
    over = (-1, 1)
    hop = jell.make_continuous_hop_kernel(jix, over, donate=False)
    tables = tix.device_tables(CPU)
    te, th = (_t(a) for a in tix.hub_merge())
    jf, ja = jnp.asarray(fp), jnp.asarray(accp)
    tf, ta = _t(fp), _t(accp)
    spare = torch.full(fp.shape, 0xA5, dtype=torch.uint8)
    for _ in range(3):
        jf, ja = hop(jf, ja, jnp.asarray(es_), jnp.asarray(hr),
                     *jix.kernel_args()[1:])
        out, acc = ell_ops.go_hop(tf, ta, spare, tables, te, th, over)
        assert acc is ta
        spare, tf = tf, out
        assert np.array_equal(np.asarray(jf), tf.numpy())
        assert np.array_equal(np.asarray(ja), ta.numpy())
    assert tf.numpy()[:-1].any() and not tf.numpy()[-1].any()


# ============================================================ or_many
@settings(max_examples=40, deadline=None)
@given(m=st.integers(1, 7), nbytes=st.sampled_from([4, 8, 12, 1 << 19]),
       seed=st.integers(0, 2 ** 16),
       dtype=st.sampled_from(["uint8", "bool"]))
def test_or_many_matches_chained_or(m, nbytes, seed, dtype):
    rng = np.random.default_rng(seed)
    src_h = rng.integers(0, 256, (m, nbytes), dtype=np.uint8)
    dst_h = rng.integers(0, 256, nbytes, dtype=np.uint8)
    if dtype == "bool":
        src_h, dst_h = src_h < 20, dst_h < 20
    want = dst_h.copy()
    for i in range(m):
        want = want | src_h[i]
    srcs = _t(src_h)
    for fn in (ell_ops.or_many_ref, ell_ops.or_many):
        dst = _t(dst_h)
        assert fn(srcs, dst) is dst
        assert np.array_equal(dst.numpy(), want)
    assert np.array_equal(srcs.numpy(), src_h)   # sources only read


def test_or_many_rejects_bad_operands():
    dst = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError):          # not whole 32-bit words
        ell_ops.or_many(torch.zeros((2, 6), dtype=torch.uint8),
                        torch.zeros(6, dtype=torch.uint8))
    with pytest.raises(ValueError):          # no source
        ell_ops.or_many(torch.zeros((0, 8), dtype=torch.uint8), dst)
    with pytest.raises(ValueError):          # more than the kernel takes
        ell_ops.or_many(torch.zeros((ell_ops.MAX_OR_SOURCES + 1, 8),
                                    dtype=torch.uint8), dst)
    with pytest.raises(ValueError):          # a slab of another width
        ell_ops.or_many(torch.zeros((2, 12), dtype=torch.uint8), dst)
    with pytest.raises(TypeError):           # another dtype
        ell_ops.or_many(torch.zeros((1, 8), dtype=torch.bool), dst)
    with pytest.raises(TypeError):
        ell_ops.or_many(dst[None], torch.zeros(2, dtype=torch.int32))
    with pytest.raises(TypeError):           # a list, not a slab
        ell_ops.or_many([dst], dst)


# ===================================================== psum_or's slab
def _jmesh(k):
    return Mesh(np.array(jax.devices()[:k]), ("parts",))


@pytest.mark.parametrize("k", [2, 3, 4, 8])
def test_psum_or_slab_matches_reference_sharded_go(k):
    """``sharded_go`` combines each hop's partial bitmaps by
    ``psum_or``, now a receive slab and one ``or_many`` a shard: the
    result is the reference's ``jax.lax.psum`` on k CPU devices."""
    rng = np.random.RandomState(31 + k)
    n, m = 96, 611
    es = rng.randint(0, n, m).astype(np.int32)
    ed = rng.randint(0, n, m).astype(np.int32)
    ee = rng.choice([1, 2, -1], m).astype(np.int32)
    start = np.array([5, 17, 40, -1], dtype=np.int32)
    mesh = _jmesh(k)
    for steps in (2, 4):
        kern = jkernels.make_sharded_go_kernel(mesh, "parts", n, steps,
                                               (1, -1))
        s_es, s_ed, s_ee, padded = jkernels.shard_edges(mesh, "parts", es,
                                                        ed, ee)
        f0 = jkernels.bitmap_from_idx(jnp.asarray(start), n)
        mask, front = kern(s_es, s_ed, s_ee, f0)
        pm = PartsMesh([CPU] * k)
        src, dst, et, size = edge_ops.shard_edges(pm, es, ed, ee)
        assert size == padded
        for fn in (edge_ops.sharded_go_ref, edge_ops.sharded_go):
            finals, fronts = fn(src, dst, et, _t(np.asarray(f0)), n, steps,
                                (1, -1), pm)
            assert np.array_equal(torch.cat(finals).numpy(),
                                  np.asarray(mask))
            for f in fronts:
                assert np.array_equal(f.numpy(), np.asarray(front))


@pytest.mark.parametrize("k", [2, 3, 4, 8])
@pytest.mark.parametrize("nbytes", [8, 1 << 12])
def test_psum_or_equals_the_pairwise_composition(k, nbytes):
    rng = np.random.default_rng(k * nbytes)
    parts = [_t(rng.integers(0, 256, nbytes, dtype=np.uint8)
                & (rng.random(nbytes) < 0.1).astype(np.uint8) * 255)
             for _ in range(k)]
    before = [p.clone() for p in parts]
    outs = [torch.full((nbytes,), 0xA5, dtype=torch.uint8)
            for _ in range(k)]
    slabs = [torch.empty((k - 1, nbytes), dtype=torch.uint8)
             for _ in range(k)]
    calls = []

    def counting(slab, dst):
        calls.append(slab.shape[0])
        return ell_ops.or_many(slab, dst)
    psum_or(parts, outs, slabs, counting)
    want = before[0].clone()
    for p in before[1:]:       # the pairwise composition psum_or replaced
        ell_ops.or_into_ref(p, want)
    for s in range(k):
        assert torch.equal(outs[s], want)
        assert torch.equal(parts[s], before[s])     # partials only read
        got = sorted(tuple(r.tolist()) for r in slabs[s])
        assert got == sorted(tuple(p.tolist()) for t, p in
                             enumerate(before) if t != s)
    assert calls == [k - 1] * k                     # one OR a shard
    with pytest.raises(ValueError):                 # a slab too short
        psum_or(parts, outs, [x[:-1] for x in slabs], ell_ops.or_many)
