"""K3, the packed BFS's level pass (``ell_ops.bfs_level``: a packed
reached bitmap ``seen`` and the depth matrix in the result's own form),
and the BFS result's int8 form (``ell_ops.bfs_depth_i8``) against the
JAX functions they replace.

Seeded numpy inputs go through the reference on CPU jax and through the
port on CPU torch (the plain route), compared exactly:
``ell_bfs`` / ``ell_bfs_ref`` against ``make_batched_bfs_lanes_kernel``
(nebula_tpu/tpu/ell.py:1080) and ``ell_bfs_sharded`` against
``make_sharded_batched_bfs_kernel`` (:1799), depths and levels run, at
``max_steps`` 1-5, 120 (int8) and 121 (int16), stopping when the
targets are found and not, on a graph with hub rows, a chain deeper
than 121 levels and isolated vertices, with starts on the pad row,
targets already among the starts, a lane whose start reaches nothing
and a lane with no start; ``bfs_level_ref`` level after level against
the reference's level body (:1110-1115) and loop reductions
(:1103-1108) in both depth forms; ``bfs_depth_i8_ref`` against
:1119-1121's cast at lengths that are no multiple of 8 or 16; and the
wrappers' refusal of a reached bitmap or depth matrix the kernels cannot
take.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, INT16_INF,
                                      ell_from_reference, mesh_tables,
                                      pack_lanes_host)
from nebula_tpu_torch.tpu.mesh import PartsMesh

CPU = torch.device("cpu")
OVER = (-1, 1, 2)
B = 64
CHAIN = 130                  # a path deeper than the int8 form's 120
ISOLATED = 4                 # vertices without an edge
STEPS = [1, 2, 3, 4, 5, 120, 121]
INF = int(INT16_INF)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _graph(seed=23, n=300, m=1400):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2): a
    random graph with an out-hub and an in-hub past cap 8, a chain of
    CHAIN vertices after it and ISOLATED vertices without an edge."""
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
    return es, ed, ee, n + CHAIN + ISOLATED


@functools.lru_cache(maxsize=None)
def _jix():
    es, ed, ee, n = _graph()
    return jell.EllIndex.build(es, ed, ee, n, cap=8, use_native=False,
                               growth_slack=8)


@pytest.fixture(scope="module")
def ells():
    jix = _jix()
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    assert tix.n_rows > tix.n            # hub extra rows
    es_, hr = jix.hub_merge()
    return jix, tix, _t(es_), _t(hr)


def _lanes(seed):
    """Packed start and target lanes: random starts and targets, plus
    the lanes the edge cases need (the chain's head; the pad row; an
    isolated vertex, which reaches nothing; a target that is a start; a
    lane with no start; a hub)."""
    jix = _jix()
    n, R1 = jix.n, jix.n_rows + 1
    rng = np.random.default_rng(seed)
    f = np.zeros((R1, B), bool)
    t = np.zeros((R1, B), bool)
    for q in range(B):
        for _ in range(1 + q % 2):
            f[jix.perm[rng.integers(0, n)], q] = True
        t[jix.perm[rng.integers(0, n)], q] = True
    head = jix.perm[n - CHAIN - ISOLATED]
    tail = jix.perm[n - ISOLATED - 1]
    lone = jix.perm[n - 1]
    f[:, :6] = False
    t[:, :6] = False
    f[head, 0], t[tail, 0] = True, True            # 129 levels down
    f[R1 - 1, 1], t[jix.perm[3], 1] = True, True   # a start on the pad row
    f[lone, 2], t[jix.perm[7], 2] = True, True     # reaches nothing
    f[jix.perm[11], 3] = t[jix.perm[11], 3] = True  # target among starts
    t[jix.perm[13], 4] = True                      # no start at all
    f[jix.perm[5], 5], t[head, 5] = True, True     # from the out-hub
    return pack_lanes_host(f), pack_lanes_host(t)


def _want_levels(depth, t0, max_steps, stop):
    """The levels the reference's loop ran (ell.py:1103-1108), read off
    its depths: level k runs while k < max_steps, some lane sits at
    depth k (the frontier) and, with ``stop``, some target lane is still
    unreached after k levels."""
    d = depth.astype(np.int64)
    unreached = -1 if depth.dtype == np.int8 else INF
    d[depth == unreached] = 1 << 30
    tb = np.unpackbits(t0, axis=1, bitorder="little").astype(bool)
    k = 0
    while k < max_steps and (d == k).any() and (
            not stop or (tb & (d > k)).any()):
        k += 1
    return k


def _reference_bfs(max_steps, stop, f0, t0):
    jix = _jix()
    es_, hr = jix.hub_merge()
    kern = jell.make_batched_bfs_lanes_kernel(jix, max_steps, OVER,
                                              stop_when_found=stop)
    return np.asarray(kern(jnp.asarray(f0), jnp.asarray(t0),
                           jnp.asarray(es_), jnp.asarray(hr),
                           *jix.kernel_args()[1:]))


@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("max_steps", STEPS)
def test_ell_bfs_matches_jax(ells, stop, max_steps):
    """``ell_bfs`` and its plain version equal the reference's depths,
    dtype and levels; the edge-case lanes hold what they must."""
    _jix_, tix, eslot, hrows = ells
    f0, t0 = _lanes(max_steps)
    want = _reference_bfs(max_steps, stop, f0, t0)
    small = max_steps <= 120
    assert want.dtype == (np.int8 if small else np.int16)
    tables = tix.device_tables(CPU)
    got, levels = ell_ops.ell_bfs(_t(f0), _t(t0), tables, eslot, hrows,
                                  OVER, max_steps, stop_when_found=stop)
    ref, ref_levels = ell_ops.ell_bfs_ref(_t(f0), _t(t0), tables, eslot,
                                          hrows, OVER, max_steps,
                                          stop_when_found=stop)
    assert got.dtype == ell_ops.depth_dtype(max_steps)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(ref, got)
    assert levels == ref_levels == _want_levels(want, t0, max_steps, stop)
    unreached = -1 if small else INF
    jix = _jix()
    lone = jix.perm[jix.n - 1]
    assert want[lone, 2] == 0 and (want[:, 2] != unreached).sum() == 1
    assert (want[:, 4] == unreached).all()
    assert want[jix.perm[11], 3] == 0
    if not stop and max_steps == 121:
        lane0 = want[:, 0]
        assert int(lane0[lane0 != INF].max()) == 121  # past the int8 range


@functools.lru_cache(maxsize=None)
def _jax_sharded(k, max_steps, stop):
    jix = _jix()
    f0, t0 = _lanes(k + max_steps)
    jmesh = Mesh(np.array(jax.devices()[:k]), ("parts",))
    nbrs, ets, reals = jell.shard_ell(jmesh, "parts", jix)
    bfs = jell.make_sharded_batched_bfs_kernel(
        jmesh, "parts", jix, max_steps, OVER, nbrs, ets, reals,
        stop_when_found=stop)
    je, jh = jix.hub_merge()
    return np.asarray(bfs(jnp.asarray(f0), jnp.asarray(t0),
                          jnp.asarray(je), jnp.asarray(jh), *nbrs, *ets))


@pytest.mark.parametrize("k,cards,max_steps,stop", [
    (k, cards, max_steps, stop) for k in (2, 4) for cards in ("one", "two")
    for max_steps, stop in ((3, True), (5, False))] + [
    (2, "two", 120, False), (4, "one", 121, True)])
def test_ell_bfs_sharded_matches_jax(ells, k, cards, max_steps, stop):
    """The mesh BFS (one reached bitmap and depth matrix a card group)
    and its per-replica plain program equal the reference's sharded
    kernel on one card group and on two pretended cards."""
    _jix_, tix, eslot, hrows = ells
    f0, t0 = _lanes(k + max_steps)
    want = _jax_sharded(k, max_steps, stop)
    mesh = PartsMesh([CPU] * k)
    if cards == "two":
        half = k // 2
        mesh.groups = ((CPU, tuple(range(half))),
                       (CPU, tuple(range(half, k))))
    mt = mesh_tables(tix, mesh)
    got, levels = ell_ops.ell_bfs_sharded(_t(f0), _t(t0), mt, [eslot] * k,
                                          [hrows] * k, OVER, max_steps,
                                          stop_when_found=stop)
    per, per_levels = ell_ops.ell_bfs_sharded_ref(
        _t(f0), _t(t0), mt, [eslot] * k, [hrows] * k, OVER, max_steps,
        stop_when_found=stop)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(per, got)
    assert levels == per_levels == _want_levels(want, t0, max_steps, stop)


def _reference_level(jd, nxt, step):
    """The reference's level body (ell.py:1110-1115) on an int16 d."""
    newly = (jell._unpack_lanes(jnp, nxt) > 0) & (jd == INT16_INF)
    jd = jnp.where(newly, jnp.int16(step + 1), jd)
    return jd, jell._pack_lanes(jnp, newly)


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16])
@pytest.mark.parametrize("stop", [True, False])
def test_bfs_level_ref_follows_the_reference_level_by_level(dtype, stop):
    """Level after level on random frontiers (empty, sparse, dense, all
    ones), the plain level with ``seen`` gives the reference's depths (in
    the chosen form), its new frontier, and its loop reductions:
    ``(fp != 0).any()`` and ``(tb & (d == INF)).any()``."""
    R1, W = 37, 8
    rng = np.random.default_rng(5 + int(stop) + 2 * (dtype == torch.int8))
    f0 = np.where(rng.random((R1, W)) < 0.1,
                  rng.integers(0, 256, (R1, W)), 0).astype(np.uint8)
    t0 = np.where(rng.random((R1, W)) < 0.3,
                  rng.integers(0, 256, (R1, W)), 0).astype(np.uint8)
    tb = jell._unpack_lanes(jnp, jnp.asarray(t0)) > 0
    jd = jnp.where(jell._unpack_lanes(jnp, jnp.asarray(f0)) > 0,
                   jnp.int16(0), INT16_INF)
    seen = torch.empty((R1, W), dtype=torch.uint8)
    d = torch.empty((R1, 8 * W), dtype=dtype)
    flags = torch.zeros((7, 2), dtype=torch.int32)
    nxt = _t(f0)
    ell_ops.bfs_level_ref(nxt, _t(t0), seen, d, flags[0], 0, True, stop)
    assert torch.equal(nxt, _t(f0))

    def same(step):
        want = np.asarray(jd)
        if dtype == torch.int8:
            want = np.where(want == INF, -1, want).astype(np.int8)
        assert np.array_equal(d.numpy(), want), step
        assert np.array_equal(
            seen.numpy(), np.packbits(np.asarray(jd) != INF, axis=1,
                                      bitorder="little")), step
        assert int(flags[step][1]) == (int(bool(
            (tb & (jd == INT16_INF)).any())) if stop else 0), step
    assert int(flags[0][0]) == int(bool(f0.any()))
    same(0)
    for step, p in enumerate([0.05, 0.6, 0.0, 1.0, 0.2, 0.9]):
        raw = np.where(rng.random((R1, W)) < p,
                       rng.integers(0, 256, (R1, W)), 0).astype(np.uint8)
        if p == 1.0:
            raw[:] = 0xFF
        jd, jfp = _reference_level(jd, jnp.asarray(raw), step)
        nxt = _t(raw)
        ell_ops.bfs_level_ref(nxt, _t(t0), seen, d, flags[step + 1], step,
                              False, stop)
        assert np.array_equal(nxt.numpy(), np.asarray(jfp))
        assert int(flags[step + 1][0]) == int(bool((jfp != 0).any()))
        same(step + 1)


@pytest.mark.parametrize("length", [1, 7, 9, 15, 17, 1000, 1023])
def test_bfs_depth_i8_ref_matches_the_reference_cast(length):
    rng = np.random.default_rng(length)
    d = rng.choice(np.array([0, 1, 5, 119, 120, INF], np.int16),
                   size=(3, length))
    want = np.asarray(jnp.where(jnp.asarray(d) == INT16_INF, -1,
                                jnp.asarray(d)).astype(jnp.int8))
    out = torch.full((3, length), 7, dtype=torch.int8)
    ell_ops.bfs_depth_i8_ref(_t(d), out)
    assert np.array_equal(out.numpy(), want)
    out2 = torch.empty_like(out)
    ell_ops.bfs_depth_i8(_t(d), out2)            # the CPU route
    assert torch.equal(out, out2)


def _misaligned(shape, dtype, by):
    """A contiguous tensor of ``shape`` starting ``by`` bytes past a
    16-byte aligned buffer."""
    n = int(np.prod(shape)) * torch.tensor([], dtype=dtype).element_size()
    raw = torch.zeros(n + 64, dtype=torch.uint8)
    at = (-raw.data_ptr()) % 16 + by
    return raw[at:at + n].view(dtype).view(shape)


BAD = ["seen_shape", "seen_dtype", "d_dtype", "d_shape", "d_int8_step",
       "d_int16_step", "d_misaligned", "seen_misaligned",
       "mesh_seen_shape", "mesh_d_dtype", "mesh_d_misaligned"]


@pytest.mark.parametrize("bad", BAD)
def test_level_wrappers_refuse_bad_state(ells, monkeypatch, bad):
    """``bfs_level`` and ``mesh_hop``'s level stage refuse a reached
    bitmap or depth matrix of the wrong shape or dtype, a level past the
    depth's range, and (on the kernel route, before the library is
    reached) operands the kernels cannot address."""
    _jix_, tix, eslot, hrows = ells
    R1, W = tix.n_rows + 1, 8
    nxt = torch.zeros((R1, W), dtype=torch.uint8)
    tp = torch.zeros_like(nxt)
    seen = torch.zeros_like(nxt)
    d = torch.zeros((R1, 8 * W), dtype=torch.int8)
    flags = torch.zeros(2, dtype=torch.int32)
    step = 0
    kernel_route = bad.endswith("misaligned")
    if bad.endswith("seen_shape"):
        seen = torch.zeros((R1, W + 4), dtype=torch.uint8)
    elif bad == "seen_dtype":
        seen = torch.zeros((R1, W), dtype=torch.int8)
    elif bad.endswith("d_dtype"):
        d = torch.zeros((R1, 8 * W), dtype=torch.int32)
    elif bad == "d_shape":
        d = torch.zeros((R1, W), dtype=torch.int8)
    elif bad == "d_int8_step":
        step = 126
    elif bad == "d_int16_step":
        d = torch.zeros((R1, 8 * W), dtype=torch.int16)
        step = INF - 1
    elif bad.endswith("d_misaligned"):
        d = _misaligned((R1, 8 * W), torch.int8, 4)
    elif bad == "seen_misaligned":
        seen = _misaligned((R1, W), torch.uint8, 1)
    if kernel_route:
        def no_lib():
            raise AssertionError("the library was reached")
        monkeypatch.setattr(ell_ops, "_route", lambda dev: True)
        monkeypatch.setattr(ell_ops, "_lib", no_lib)
    before = dict(ell_ops.LAUNCHES)
    with pytest.raises((ValueError, TypeError)):
        if bad.startswith("mesh_"):
            mt = mesh_tables(tix, PartsMesh([CPU] * 2))
            cur = mt.mesh.replicas(nxt)[0]
            ell_ops.mesh_hop(torch.empty_like(cur), cur, mt,
                             mt.mesh.groups[0], eslot, hrows, OVER,
                             ell_ops.HOP_LEVEL,
                             ell_ops.MeshLevel(tp, seen, d, flags, step,
                                               True, True))
        else:
            ell_ops.bfs_level(nxt, tp, seen, d, flags, step, True)
    assert ell_ops.LAUNCHES == before


def test_the_depth_range_holds_the_last_level():
    """An int8 depth takes level 125 (depth 126); one more does not
    fit."""
    R1, W = 3, 4
    nxt = torch.zeros((R1, W), dtype=torch.uint8)
    nxt[0, 0] = 1
    seen = torch.zeros_like(nxt)
    d = torch.full((R1, 8 * W), -1, dtype=torch.int8)
    flags = torch.zeros(2, dtype=torch.int32)
    ell_ops.bfs_level(nxt, nxt.clone(), seen, d, flags, 125)
    assert int(d[0, 0]) == 126 and int(flags[0]) == 1
    with pytest.raises(ValueError):
        ell_ops.bfs_level(nxt, nxt.clone(), seen, d, flags, 126)
