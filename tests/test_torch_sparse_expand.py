"""K4 ``sparse_expand`` and the continuous session's ``lane_extract``
(nebula_tpu_torch/tpu/ell_ops.py) against the JAX package.

K4 has no JAX function of its own: it is the candidate half of one hop
of ``make_batched_sparse_go_kernel`` (nebula_tpu/tpu/ell.py:1315, with
the hub expansion ``_segmented_hub_iota`` :402).  So the bits K4 marks
from a pair list, read back in (query, vertex) order, are held to the
pairs of a one-hop JAX program run from the same list with a cap no
hop reaches; the hub budget K4 adds up is held to the JAX hop's
overflow flag through the check K5 makes of it.  The list is laid out
as the card's programs give it to K4: a live prefix, then pads — the
sentinel, or (from the second hop, where K4 reads the count K5 left in
``ctl``) stale pairs past the count that K4 must not read.  The ELL is
the JAX package's own numpy build at ``min_d`` 1 and cap 64 (buckets
of D = 1 to 64, hubs past 64 with extra-row runs).  The extract is
held to ``make_lane_extract_kernel`` at W = 4, 16 and 128 and P = 8,
16 and 2W, with repeated words and mixed sel.  The same seeded numpy
inputs go to both sides; every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, DeviceTables,
                                      ell_from_reference)

CPU = torch.device("cpu")
BIG_CAP = 1 << 14            # a hop cap no case reaches
QMAX = 1024


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _graph(seed=5, n=1500, m=3000):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2):
    a spread of degrees from 1 up, and two hubs past cap 64."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = (src + rng.geometric(0.02, m)) % n
    src[:300] = 7                       # hub by out-degree
    dst[300:420] = 11                   # hub by in-degree
    et = rng.integers(1, 3, m)
    es = np.concatenate([src, dst]).astype(np.int32)
    ed = np.concatenate([dst, src]).astype(np.int32)
    ee = np.concatenate([et, -et]).astype(np.int32)
    return es, ed, ee, n


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    jix = jell.EllIndex.build(es, ed, ee, n, cap=64, min_d=1,
                              use_native=False)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    tables = tix.device_tables(CPU)
    assert tables.D[0] == 1 and max(tables.D) > 32
    assert len(jix.extra_owner) > 2     # hub extra-row runs
    return jix, tix, tables


def _list(rng, tix, c_in, live, nq, pad):
    """A K4 pair list of c_in entries: ``live`` (new id, query) pairs
    sorted by (query, id), then pads: the sentinel (``pad="sentinel"``),
    or real stale pairs (``pad="stale"``) that only the count cuts
    off."""
    ids = np.full(c_in, tix.n_rows, np.int32)
    qid = np.full(c_in, ell_ops.BIG_Q, np.int32)
    v = tix.perm[rng.integers(0, tix.n, live)]
    q = rng.integers(0, nq, live).astype(np.int32)
    o = np.lexsort((v, q))
    ids[:live], qid[:live] = v[o], q[o]
    if pad == "stale":
        k = c_in - live
        ids[live:] = tix.perm[rng.integers(0, tix.n, k)]
        qid[live:] = rng.integers(0, nq, k)
    return ids, qid


def _marked(mark, R1w):
    """The set bits of a [nq * R1w] int32 bitmap as (q, v) in order."""
    bits = ell_ops._bits_of(mark).numpy()
    idx = np.nonzero(bits)[0]
    return idx // (R1w * 32), idx % (R1w * 32)


def _jax_hop(jix, ids, qid, over, c0):
    """One JAX hop from the list (sentinel-padded to c0): its [count,
    overflow, pairs] with the pairs as (q, v) arrays."""
    kern = jell.make_batched_sparse_go_kernel(jix, 2, over, (c0, BIG_CAP),
                                              qmax=QMAX)
    ecnt, e0 = jix.hub_expansion()
    out = np.asarray(kern(jnp.asarray(ids), jnp.asarray(qid),
                          jnp.asarray(ecnt), jnp.asarray(e0),
                          *jix.kernel_args()[1:]))
    keys = out[2:]
    keys = keys[keys != 2**31 - 1].astype(np.int64)
    R1 = jix.n_rows + 1
    return out[0], out[1], keys // R1, keys % R1


@pytest.mark.parametrize("over", [(1,), (-1,), (-1, 1, 2)])
@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("layout", [("sentinel", False),
                                    ("stale", True)])
def test_expand_marks_match_a_jax_hop(ells, over, nq, layout):
    """Live prefix shorter than the list: 40 live pairs of 256, padded by
    sentinels (the first hop's list) or by stale pairs past K5's count
    (a later hop's, ``counted``)."""
    jix, tix, tables = ells
    pad, counted = layout
    rng = np.random.default_rng(len(over) * 10 + nq)
    c_in, live = 256, 40
    ids, qid = _list(rng, tix, c_in, live, nq, pad)
    R1w = ell_ops._words(tix.n_rows + 1)
    mark = torch.zeros(nq * R1w, dtype=torch.int32)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ctl[ell_ops.CTL_CNT] = live
    tecnt, te0 = tix.hub_expansion()
    pl = ell_ops._sparse_plan(c_in, (c_in, BIG_CAP), QMAX, nq, tix.n,
                              tix.n_rows, False, None, False)
    _c_out, ex, c_lim = pl.hops[0]
    ell_ops.sparse_expand(_t(ids), _t(qid) if nq > 1 else None,
                          _t(tecnt), _t(te0), tables, over, mark, R1w, ctl,
                          c_lim, False, counted)
    jids, jqid = ids.copy(), qid.copy()
    jids[live:], jqid[live:] = tix.n_rows, 0
    if nq == 1:
        jqid[:live] = 0
    cnt, ovf, jq, jv = _jax_hop(jix, jids, jqid, over, c_in)
    q, v = _marked(mark, R1w)
    # K5's check of this hop: the count, the hub budget, the clamp
    k5_ovf = (len(v) > BIG_CAP or int(ctl[ell_ops.CTL_HUB_TOTAL]) > ex
              or int(ctl[ell_ops.CTL_HUB_BIG]) != 0)
    assert bool(ovf) == k5_ovf
    assert cnt == len(v)
    if not ovf:
        assert np.array_equal(q, jq) and np.array_equal(v, jv)


def test_expand_walks_every_bucket_width(ells):
    """One live pair from each bucket (D = 1 .. 64) and every hub: the
    bits equal the JAX hop's."""
    jix, tix, tables = ells
    rows = [r0 for r0, nb in zip(tables.row0, tables.rows) if nb] \
        + [int(tix.perm[7]), int(tix.perm[11])]
    rows = [r for r in rows if r < tix.n]
    ids = np.asarray(sorted(set(rows)), np.int32)
    qid = np.zeros(len(ids), np.int32)
    R1w = ell_ops._words(tix.n_rows + 1)
    mark = torch.zeros(R1w, dtype=torch.int32)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    tecnt, te0 = tix.hub_expansion()
    ell_ops.sparse_expand(_t(ids), None, _t(tecnt), _t(te0), tables, (1,),
                          mark, R1w, ctl, 1 << 20)
    cnt, ovf, jq, jv = _jax_hop(jix, ids, qid, (1,), len(ids))
    q, v = _marked(mark, R1w)
    assert not ovf and cnt == len(v)
    assert np.array_equal(v, jv) and not q.any()
    assert int(ctl[ell_ops.CTL_HUB_TOTAL]) == int(tecnt[ids.clip(
        max=tix.n)].sum()) > 0


@pytest.mark.parametrize("c_lim", [1, 3])
def test_expand_hub_runs_past_the_clamp(ells, c_lim):
    """A hub whose extra-row run is longer than the per-pair clamp: its
    whole run is still pushed (the bits equal the JAX hop's, which
    clamps nothing at this list size), the budget adds the whole count,
    and ``CTL_HUB_BIG`` is raised, the reference's clamp rule (any
    count past c_lim)."""
    jix, tix, tables = ells
    tecnt, te0 = tix.hub_expansion()
    hub = int(tix.perm[7])
    assert int(tecnt[hub]) > c_lim
    ids = np.full(64, tix.n_rows, np.int32)    # room for the hub's rows
    ids[:2] = sorted({hub, int(tix.perm[3])})
    qid = np.ones(64, np.int32)
    R1w = ell_ops._words(tix.n_rows + 1)
    mark = torch.zeros(2 * R1w, dtype=torch.int32)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ell_ops.sparse_expand(_t(ids), _t(qid), _t(tecnt), _t(te0), tables,
                          (1,), mark, R1w, ctl, c_lim)
    cnt, ovf, jq, jv = _jax_hop(jix, ids, qid, (1,), len(ids))
    q, v = _marked(mark, R1w)
    assert not ovf and np.array_equal(v, jv) and np.array_equal(q, jq)
    counts = tecnt[ids[:2]]
    assert int(ctl[ell_ops.CTL_HUB_TOTAL]) == int(counts.sum())
    assert int(ctl[ell_ops.CTL_HUB_BIG]) == 1
    ctl.zero_()
    ell_ops.sparse_expand(_t(ids), _t(qid), _t(tecnt), _t(te0), tables,
                          (1,), mark, R1w, ctl, int(counts.max()))
    assert int(ctl[ell_ops.CTL_HUB_BIG]) == 0


@pytest.mark.parametrize("nq", [1, 4])
@pytest.mark.parametrize("counted", [False, True])
def test_expand_self_mode_marks_the_live_pairs(ells, nq, counted):
    """Self mode sets bit (q, v) of every live pair (the UPTO union's
    and the adaptive state's start), sentinels and pairs past the count
    left out, nothing pushed, no budget added."""
    jix, tix, tables = ells
    rng = np.random.default_rng(nq)
    ids, qid = _list(rng, tix, 64, 20, nq, "stale" if counted else
                     "sentinel")
    R1w = ell_ops._words(tix.n_rows + 1)
    mark = torch.zeros(nq * R1w, dtype=torch.int32)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ctl[ell_ops.CTL_CNT] = 20
    tecnt, te0 = tix.hub_expansion()
    ell_ops.sparse_expand(_t(ids), _t(qid) if nq > 1 else None,
                          _t(tecnt), _t(te0), tables, (1,), mark, R1w, ctl,
                          1, True, counted)
    q, v = _marked(mark, R1w)
    live = slice(0, 20 if counted else 64)
    keep = ids[live] != tix.n_rows
    want = np.unique((qid[live][keep] if nq > 1 else 0) * (R1w * 32)
                     + ids[live][keep])
    assert np.array_equal(q * (R1w * 32) + v, want)
    assert int(ctl[ell_ops.CTL_HUB_TOTAL]) == 0


@pytest.mark.parametrize("mode", [1, 2])
def test_gated_expand_runs_only_in_its_mode(ells, mode):
    """``gate``: the adaptive program's mode word; K4 pushes only when it
    holds ``want`` (MODE_SPARSE), as ``ad_program``'s gated K4."""
    jix, tix, tables = ells
    ids = tix.perm[np.arange(0, 60, 3)].astype(np.int32)
    R1w = ell_ops._words(tix.n_rows + 1)
    mark = torch.zeros(R1w, dtype=torch.int32)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ctl[ell_ops.CTL_MODE] = mode
    ell_ops.sparse_expand(_t(ids), None, None, None, tables, (1,), mark,
                          R1w, ctl, 0, gate=ctl[ell_ops.CTL_MODE:
                                                ell_ops.CTL_MODE + 1],
                          want=ell_ops.MODE_SPARSE)
    assert bool(mark.any()) == (mode == ell_ops.MODE_SPARSE)


def test_expand_refuses_decreasing_bucket_rows(ells):
    """K4 takes a row's bucket as a count of the row0 at or below it,
    right only while row0 is in order: the wrapper refuses tables whose
    row0 decreases."""
    jix, tix, tables = ells
    bad = DeviceTables(tables.nbr, tables.et, tables.row0[::-1],
                       tables.rows[::-1], tables.D[::-1],
                       tables.slot0[::-1], tables.n, tables.n_rows)
    R1w = ell_ops._words(tix.n_rows + 1)
    with pytest.raises(ValueError, match="row0"):
        ell_ops.sparse_expand(_t(np.zeros(1, np.int32)), None, None, None,
                              bad, (1,), torch.zeros(R1w,
                                                     dtype=torch.int32),
                              R1w, torch.zeros(ell_ops.CTL_SIZE,
                                               dtype=torch.int64), 0)


def _frontier(rng, R1, W, density=0.08):
    f = rng.integers(0, 256, (R1, W), dtype=np.uint8)
    f &= (rng.random((R1, 1)) < density).astype(np.uint8) * 255
    f[-1] = 0
    return f


@pytest.mark.parametrize("W", [4, 16, 128])
@pytest.mark.parametrize("P", ["8", "16", "2W"])
@pytest.mark.parametrize("words", ["distinct", "repeated", "cohort"])
def test_lane_extract_matches_jax(ells, W, P, words):
    """Random distinct words (with repeats once P passes W), a few words
    repeated over all P columns, and the smallest leave cohort (one
    word, exact and UPTO, then pads at word 0); sel mixed."""
    jix, tix, tables = ells
    P = 2 * W if P == "2W" else int(P)
    rng = np.random.default_rng(W * 100 + P)
    R1 = tix.n_rows + 1
    fp = _frontier(rng, R1, W)
    accp = fp | _frontier(rng, R1, W)
    if words == "distinct":
        w = np.concatenate([rng.permutation(W)] * (P // W + 1))[:P]
    elif words == "repeated":
        w = rng.choice(rng.integers(0, W, 3), P)
    else:
        w = np.zeros(P, np.int64)
        w[:2] = rng.integers(0, W)
    sel = (rng.random(P) < 0.5).astype(np.uint8)
    sel[0], sel[1] = 0, 1
    w = w.astype(np.int32)
    want = jell.make_lane_extract_kernel()(jnp.asarray(fp),
                                           jnp.asarray(accp), w, sel)
    out = torch.empty((R1, P), dtype=torch.uint8)
    ell_ops.lane_extract(_t(fp), _t(accp), _t(w), _t(sel), out)
    assert np.array_equal(np.asarray(want), out.numpy())
