"""The sparse pair-list GO and the adaptive single-query GO
(nebula_tpu_torch/tpu/ell_ops.py: ``sparse_go``, ``adaptive_go`` and
the kernels K4-K7 they run) against the JAX functions they replace:
``make_batched_sparse_go_kernel`` (nebula_tpu/tpu/ell.py:1222, with its
UPTO, COUNT and LIMIT variants) and ``make_adaptive_go_kernel``
(ell.py:1493).

The same seeded numpy inputs go through the JAX function on CPU jax and
through the port on CPU torch twice: the plain version (a transcription
of the JAX function) and the kernels' own sequence with each kernel's
plain version in its place (``_sparse_go_steps``, ``_adaptive_steps``),
which is the order of launches the card runs.  The whole int32 output
is compared exactly when the JAX kernel reports no overflow; the
overflow flag is compared in every case.  Adaptive bitmaps are compared
over the real rows and the pad row (hub extra rows may hold junk).  The
ELL tables are the JAX package's own numpy build at cap 8 with growth
slack 8 (hub extra rows and unclaimed growth spares present).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, ell_from_reference,
                                      sparse_caps, sparse_go_pairs,
                                      sparse_limit_cap, sparse_pack32,
                                      unpack_bits)

CPU = torch.device("cpu")
OVER_SETS = [(1,), (-1,), (-1, 1, 2)]
PACK32_QMAX = 1024          # go_batch_max's default: one-word keys
TWO_ARRAY_QMAX = 1 << 23    # past 2^31 / (n_rows + 1): two arrays


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _graph(seed=11, n=300, m=1400):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2),
    with two hubs past cap 8 (tests/test_torch_windowed.py:_graph)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:60] = 5                        # hub by out-degree
    dst[60:110] = 9                     # hub by in-degree
    et = rng.integers(1, 3, m)
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([et, -et]).astype(np.int32)
    return es, ed, ee, n


def _pair(jix):
    """(JAX index, port index, port tables) over the same build."""
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    return tix, tix.device_tables(CPU)


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    jix = jell.EllIndex.build(es, ed, ee, n, cap=8, use_native=False,
                              growth_slack=8)
    assert len(jix.extra_owner) > 8     # hubs beyond the spares
    tix, tables = _pair(jix)
    return jix, tix, tables


def _starts(rng, tix, c0, S, nq):
    """The runtime's start layout: S (new id, query) pairs sorted per
    query by new id, padded to c0 with the sentinel row."""
    ids = np.full(c0, tix.n_rows, np.int32)
    qid = np.zeros(c0, np.int32)
    q = rng.integers(0, nq, S)
    v = tix.perm[rng.integers(0, tix.n, S)]
    o = np.lexsort((v, q))
    ids[:S], qid[:S] = v[o], q[o]
    return ids, qid


def _run_sparse(jix, tix, tables, ids, qid, deg, over, steps, caps, qmax,
                nq, upto=False, limit=None, count=False):
    """(JAX output, plain output, kernel-sequence output)."""
    kern = jell.make_batched_sparse_go_kernel(jix, steps, over, caps,
                                              qmax=qmax, upto=upto,
                                              limit=limit, count=count)
    ecnt, e0 = jix.hub_expansion()
    args = [jnp.asarray(ids), jnp.asarray(qid), jnp.asarray(ecnt),
            jnp.asarray(e0)]
    if count or limit is not None:
        args.append(jnp.asarray(deg))
    want = np.asarray(kern(*args, *jix.kernel_args()[1:]))
    tecnt, te0 = tix.hub_expansion()
    common = (_t(ids), _t(qid), _t(tecnt), _t(te0), _t(deg), tables, over,
              steps, caps, qmax)
    plain = ell_ops.sparse_go(*common, nq, upto=upto, limit=limit,
                              count=count).numpy()
    seq = ell_ops._sparse_go_steps(
        *common, nq, upto, limit, count, ell_ops.sparse_expand,
        ell_ops.pair_compact, ell_ops.pair_reduce).numpy()
    return want, plain, seq


def _same(want, got):
    """Flags equal always; the whole array when nothing overflowed."""
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got[1] == want[1]
    if not want[1]:
        assert np.array_equal(got, want)


# (steps, c0, starts, cap, qmax): a tight case that overflows and a
# roomy one that does not, per (mode, OVER set); steps 2-4, c0 64 and
# 256, both output layouts
CASES = {
    "tight": (3, 64, 48, 64, PACK32_QMAX),
    "roomy": (None, 256, 24, 1 << 12, TWO_ARRAY_QMAX),
}


@pytest.mark.parametrize("case", ["tight", "roomy"])
@pytest.mark.parametrize("mode", ["plain", "upto", "count", "limit"])
@pytest.mark.parametrize("over", OVER_SETS)
def test_sparse_go_matches_jax(ells, case, mode, over):
    jix, tix, tables = ells
    steps, c0, S, cap, qmax = CASES[case]
    if steps is None:                    # the roomy case walks 2, 4, 3
        steps = 2 + (OVER_SETS.index(over) * 2) % 3
    if mode == "count":                  # no pair layout: a short tail
        qmax = PACK32_QMAX
    rng = np.random.default_rng(7 * len(over) + steps + len(mode))
    nq = 7
    ids, qid = _starts(rng, tix, c0, S, nq)
    deg = rng.integers(0, 9, tix.n_rows + 1).astype(np.int32)
    deg[tix.n:] = 0                     # extras and the pad row count 0
    deg[rng.random(tix.n_rows + 1) < 0.2] = 0
    caps = sparse_caps(c0, max(jix.bucket_D), steps, cap)
    want, plain, seq = _run_sparse(
        jix, tix, tables, ids, qid, deg, over, steps, caps, qmax, nq,
        upto=mode == "upto", limit=3 if mode == "limit" else None,
        count=mode == "count")
    _same(want, plain)
    _same(want, seq)
    assert bool(want[1]) == (case == "tight")
    if mode == "count":
        assert want.shape == (2 + qmax,)
    else:
        width = sparse_limit_cap(caps, c0, 3) if mode == "limit" \
            else caps[-1]
        pack32 = sparse_pack32(qmax, tix.n_rows)
        assert pack32 == (qmax == PACK32_QMAX)
        assert want.shape == (2 + (1 if pack32 else 2) * width,)
        if not want[1]:
            cnt, _ovf, qids, _vids = sparse_go_pairs(want, pack32,
                                                     tix.n_rows + 1)
            assert len(qids) > 0
            assert mode == "limit" or len(qids) == cnt


@pytest.mark.parametrize("steps", [3, 4])
def test_sparse_hub_push_exact(steps):
    """tests/test_ell.py:487 as a parity case: a chain into a hub whose
    slots spill at cap 16; the hub is in the final set (3 steps) and a
    push source (4 steps) and must not overflow."""
    n = 200
    es = np.asarray([0, 1] + [2] * 147, np.int32)
    ed = np.asarray([1, 2] + list(range(3, 150)), np.int32)
    ee = np.ones(len(es), np.int32)
    jix = jell.EllIndex.build(np.concatenate([es, ed]),
                              np.concatenate([ed, es]),
                              np.concatenate([ee, -ee]), n, cap=16,
                              min_d=4, use_native=False)
    assert len(jix.extra_owner) > 0
    tix, tables = _pair(jix)
    caps = sparse_caps(64, max(jix.bucket_D), steps, 1 << 12)
    ids = np.full(caps[0], jix.n_rows, np.int32)
    qid = np.zeros(caps[0], np.int32)
    ids[0] = jix.perm[0]
    deg = np.zeros(jix.n_rows + 1, np.int32)
    want, plain, seq = _run_sparse(jix, tix, tables, ids, qid, deg, (1,),
                                   steps, caps, PACK32_QMAX, 1)
    assert want[1] == 0, "a hub push must not overflow"
    _same(want, plain)
    _same(want, seq)
    _cnt, _ovf, _q, vids = sparse_go_pairs(plain, True, jix.n_rows + 1)
    reached = set(tix.inv[vids].tolist())
    assert reached == ({2} if steps == 3 else set(range(3, 150)))


def test_sparse_hub_expansion_overflow_reported():
    """tests/test_ell.py:523 as a parity case: a start on a hub with
    more extra rows than the hop's budget (EX = c0 = 4) overflows."""
    n = 40
    es = np.arange(1, 33, dtype=np.int32)
    ed = np.zeros(32, np.int32)
    ee = np.ones(32, np.int32)
    jix = jell.EllIndex.build(np.concatenate([es, ed]),
                              np.concatenate([ed, es]),
                              np.concatenate([ee, -ee]), n, cap=4,
                              min_d=4, use_native=False)
    assert len(jix.extra_owner) >= 4
    tix, tables = _pair(jix)
    caps = (4, 1 << 10)
    ids = np.full(caps[0], jix.n_rows, np.int32)
    qid = np.zeros(caps[0], np.int32)
    ids[0] = jix.perm[0]
    deg = np.zeros(jix.n_rows + 1, np.int32)
    want, plain, seq = _run_sparse(jix, tix, tables, ids, qid, deg, (1,),
                                   2, caps, PACK32_QMAX, 1)
    assert want[1] == 1 and plain[1] == 1 and seq[1] == 1


def test_limit_keeps_each_querys_degree_prefix(ells):
    """The LIMIT cut by hand: per query, ascending new ids, zero-degree
    vertices dropped, kept while the degree before the vertex is below
    the limit."""
    jix, tix, tables = ells
    rng = np.random.default_rng(3)
    ids, qid = _starts(rng, tix, 256, 30, 5)
    deg = rng.integers(0, 4, tix.n_rows + 1).astype(np.int32)
    deg[tix.n:] = 0
    caps = sparse_caps(256, max(jix.bucket_D), 3, 1 << 12)
    common = (_t(ids), _t(qid), *map(_t, tix.hub_expansion()), _t(deg),
              tables, (1,), 3, caps, PACK32_QMAX, 5)
    full = ell_ops.sparse_go(*common).numpy()
    cut = ell_ops.sparse_go(*common, limit=5).numpy()
    assert full[1] == 0 and cut[1] == 0
    _c, _o, fq, fv = sparse_go_pairs(full, True, tix.n_rows + 1)
    _c, _o, cq, cv = sparse_go_pairs(cut, True, tix.n_rows + 1)
    want_q, want_v = [], []
    for q in range(5):
        run = 0
        for v in fv[fq == q]:
            if deg[v] > 0 and run < 5:
                want_q.append(q)
                want_v.append(v)
            run += int(deg[v])
    assert cq.tolist() == want_q and cv.tolist() == want_v
    assert cut[0] == len(want_v)


def test_sparse_go_rejects_bad_operands(ells):
    _jix, tix, tables = ells
    ids = torch.full((8,), tix.n_rows, dtype=torch.int32)
    qid = torch.zeros(8, dtype=torch.int32)
    ecnt, e0 = map(_t, tix.hub_expansion())
    deg = torch.zeros(tix.n_rows + 1, dtype=torch.int32)
    base = (ids, qid, ecnt, e0, deg, tables, (1,))
    with pytest.raises(ValueError):          # no hop to run
        ell_ops.sparse_go(*base, 1, (8,), 1024, 1)
    with pytest.raises(ValueError):          # caps per step
        ell_ops.sparse_go(*base, 3, (8, 64), 1024, 1)
    with pytest.raises(ValueError):          # COUNT and LIMIT
        ell_ops.sparse_go(*base, 2, (8, 64), 1024, 1, count=True, limit=3)
    with pytest.raises(ValueError):          # UPTO needs room for starts
        ell_ops.sparse_go(*base, 2, (8, 4), 1024, 1, upto=True)
    with pytest.raises(ValueError):          # nq past qmax
        ell_ops.sparse_go(*base, 2, (8, 64), 4, 5)
    with pytest.raises(TypeError):           # qid must be int32
        ell_ops.sparse_go(ids, qid.long(), ecnt, e0, deg, tables, (1,), 2,
                          (8, 64), 1024, 1)
    with pytest.raises(ValueError):          # deg for COUNT
        ell_ops.sparse_go(ids, qid, ecnt, e0, None, tables, (1,), 2,
                          (8, 64), 1024, 1, count=True)


# ================================================= adaptive single GO
def _bitmap_rows(packed, tix):
    """The adaptive output's real rows and pad row as bools."""
    b = unpack_bits(np.asarray(packed)[:, None], tix.n_rows + 1)[:, 0]
    return np.concatenate([b[:tix.n], b[-1:]])


@pytest.mark.parametrize("K", [2048, 4])
@pytest.mark.parametrize("starts", ["plain", "hub"])
@pytest.mark.parametrize("over", OVER_SETS)
def test_adaptive_go_matches_jax(ells, K, starts, over):
    """Default K, a K small enough to force the dense switch, and a hub
    in the start set (the first hop pulls dense)."""
    jix, tix, tables = ells
    eslot, hrows = jix.hub_merge()
    hub = jix.hub_table()
    assert (tix.hub_table() == hub).all() and hub[[5, 9]].all()
    olds = [0, 17, 44] if starts == "plain" else [9, 120]
    s_new = jix.perm[np.asarray(olds)].astype(np.int32)
    switched = False
    for steps in (2, 3, 4):
        kern = jell.make_adaptive_go_kernel(jix, steps, over, K=K)
        want = np.asarray(kern(s_new, jnp.asarray(hub),
                               *jix.kernel_args()))
        args = (_t(s_new), _t(hub.astype(np.uint8)), tables, _t(eslot),
                _t(hrows), over, steps, K)
        plain = ell_ops.adaptive_go(*args).numpy()
        seq = ell_ops._adaptive_steps(
            *args, ell_ops.sparse_expand, ell_ops.pair_compact,
            ell_ops.adaptive_switch, ell_ops.bitmap_lanes,
            ell_ops.go_hop).numpy()
        assert plain.dtype == np.uint8 and plain.shape == want.shape
        assert np.array_equal(_bitmap_rows(plain, tix),
                              _bitmap_rows(want, tix))
        assert np.array_equal(_bitmap_rows(seq, tix),
                              _bitmap_rows(want, tix))
        assert not _bitmap_rows(want, tix)[-1]     # the pad row
        # the dense arm ran when a hop's candidates passed K
        switched |= int(_bitmap_rows(want, tix).sum()) > K
    assert switched == (K == 4)


def test_adaptive_go_without_starts_is_empty(ells):
    """A lone query none of whose start vids exists takes the adaptive
    route at default flags: no starts, an empty bitmap."""
    jix, tix, tables = ells
    eslot, hrows = jix.hub_merge()
    hub = jix.hub_table()
    kern = jell.make_adaptive_go_kernel(jix, 3, (1,))
    want = np.asarray(kern(np.zeros(0, np.int32), jnp.asarray(hub),
                           *jix.kernel_args()))
    got = ell_ops.adaptive_go(torch.zeros(0, dtype=torch.int32),
                              _t(hub.astype(np.uint8)), tables, _t(eslot),
                              _t(hrows), (1,), 3)
    assert np.array_equal(got.numpy(), want) and not want.any()


def test_adaptive_switch_sticks_to_the_dense_arm(ells):
    """K7: an overflowing sparse hop or a hub in the list ends the
    sparse mode, and it never comes back."""
    _jix, tix, _tables = ells
    table = tix.hub_table()
    hub = _t(table.astype(np.uint8))
    fr = torch.full((4,), tix.n_rows, dtype=torch.int32)
    fr[0] = int(tix.perm[np.nonzero(~table[:tix.n])[0][0]])
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ctl[ell_ops.CTL_SPARSE] = 1
    ell_ops.adaptive_switch(fr, hub, tix.n, tix.n_rows, ctl)
    assert int(ctl[ell_ops.CTL_MODE]) == ell_ops.MODE_SPARSE
    ctl[ell_ops.CTL_CNT] = 5                 # the hop found 5 > K ids
    ell_ops.adaptive_switch(fr, hub, tix.n, tix.n_rows, ctl)
    assert int(ctl[ell_ops.CTL_MODE]) == ell_ops.MODE_DENSE
    ctl[ell_ops.CTL_CNT] = 0
    ell_ops.adaptive_switch(fr, hub, tix.n, tix.n_rows, ctl)
    assert int(ctl[ell_ops.CTL_MODE]) == ell_ops.MODE_DENSE
    fresh = torch.zeros_like(ctl)
    fresh[ell_ops.CTL_SPARSE] = 1
    fr[1] = int(tix.perm[5])                 # a hub enters the list
    ell_ops.adaptive_switch(fr, hub, tix.n, tix.n_rows, fresh)
    assert int(fresh[ell_ops.CTL_MODE]) == ell_ops.MODE_DENSE


def test_bitmap_lanes_round_trip(ells):
    _jix, tix, _tables = ells
    R1 = tix.n_rows + 1
    rng = np.random.default_rng(4)
    bits = rng.random(R1) < 0.3
    words = torch.from_numpy(np.packbits(
        np.concatenate([bits, np.zeros(-R1 % 32, bool)]),
        bitorder="little").view(np.int32).copy())
    lanes = torch.full((R1, 4), 0xFF, dtype=torch.uint8)
    ell_ops.bitmap_lanes(True, words, lanes, R1)
    assert np.array_equal(lanes[:, 0].numpy(), bits.astype(np.uint8))
    assert not lanes[:, 1:].any()
    back = torch.zeros_like(words)
    ell_ops.bitmap_lanes(False, back, lanes, R1)
    assert torch.equal(back, words)
