"""The int8 hop's live arrays, the hop's launch plan at B-byte rows and
on a shard's rows, and the mesh's row replication (M3), against the
JAX functions they serve (nebula_tpu/tpu/ell.py:1140
``make_batched_go_kernel``, whose body ``_hop_body`` is one advance;
:1616 ``make_batched_bfs_kernel``; :1688 ``shard_ell``).

On the CPU ``go_hop_i8`` runs its plain version, which applies the
kernel's skip rule as the kernel does: a source row whose ``live_in``
bit is 0 is not gathered (the live arrays are row bitmaps,
``ell_ops.live_bitmap`` / ``live_rows``).  That is exact while ``live_in`` is a
superset of the rows holding a byte > 0, so random supersets must give
the reference's advance, and ``live_out`` must be exactly the rows of
the result with a byte > 0.  Frontiers are int8 lanes and bits, so
every comparison is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, ell_from_reference,
                                      mesh_tables)
from nebula_tpu_torch.tpu.mesh import PartsMesh, replicate_rows

from test_torch_hop import SERVE_D, SERVE_ROWS
from test_torch_unpacked import OVER_SETS, _claim_a_spare, _graph

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    base = jell.EllIndex.build(es, ed, ee, n, cap=16, min_d=4,
                               use_native=False, growth_slack=8)
    jix = _claim_a_spare(base, n, ed)
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    es_, hr = tix.hub_merge()
    port = dict(tables=tix.device_tables(CPU), eslot=_t(es_), hrows=_t(hr))
    return jix, tix, port, jix.kernel_args(), {}


def _advance(ells, f0, over, upto):
    """One reference advance (``_hop_body``; with ``upto`` the running
    max from ``f0``), its kernel made once per (OVER, UPTO)."""
    jix, _tix, _port, ref, kerns = ells
    key = (over, upto)
    if key not in kerns:
        kerns[key] = jell.make_batched_go_kernel(jix, 2, over, pack=False,
                                                 upto=upto)
    return np.asarray(kerns[key](jnp.asarray(f0), *ref))


def _positive_rows(x):
    return (np.asarray(x) > 0).any(axis=1)


# ====================================================== the skip rule
@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2 ** 16), B=st.sampled_from([4, 8, 12]),
       over=st.sampled_from(OVER_SETS), upto=st.booleans(),
       live_p=st.sampled_from([0.02, 0.3, 1.0]),
       extra_p=st.sampled_from([0.0, 0.1, 1.0]))
def test_live_superset_gives_one_jax_advance(ells, seed, B, over, upto,
                                             live_p, extra_p):
    """Arbitrary int8 frontiers (negative bytes, rows of bytes <= 0,
    values > 1), hub owners and the claimed spare in the tables: with
    any superset ``live_in`` the hop is the reference's advance, and
    ``live_out`` is the row-any of ``out > 0`` after the hub merge."""
    _jix, tix, port, _ref, _k = ells
    rng = np.random.default_rng(seed)
    R1 = tix.n_rows + 1
    f0 = rng.integers(-128, 128, (R1, B), dtype=np.int8)
    f0[rng.random(R1) >= live_p] = 0
    neg = rng.random(R1) < 0.2                 # rows of bytes <= 0 only
    f0[neg] = -np.abs(f0[neg]).astype(np.int8)
    f0[-1] = 0
    want = _advance(ells, f0, over, upto)
    pos = _positive_rows(f0)
    live_in = pos | (rng.random(R1) < extra_p)
    assert live_in[pos].all()
    out = torch.full((R1, B), 0x55, dtype=torch.int8)
    acc = _t(f0) if upto else None
    live_out = torch.full((ell_ops.live_words(R1),), 7, dtype=torch.int32)
    got, acc_out = ell_ops.go_hop_i8(_t(f0), acc, out, over=over,
                                     live_in=ell_ops.live_bitmap(_t(live_in)),
                                     live_out=live_out, **port)
    assert np.array_equal((acc_out if upto else got).numpy(), want)
    if upto:           # the advance itself, without the running max
        assert np.array_equal(got.numpy(), _advance(ells, f0, over, False))
    rows = ell_ops.live_rows(live_out, R1).numpy()
    assert np.array_equal(rows, _positive_rows(got.numpy()))
    assert not rows[-1] and not got[-1].any()
    # the words past the last row are zero
    assert torch.equal(live_out, ell_ops.live_bitmap(_t(rows)))


def test_skip_rule_is_applied_where_live_in_drops_a_row(ells):
    """The plain version gathers nothing from a row marked dead: a
    live_in that misses a positive row changes the answer (the rule is
    really applied, so the superset tests above test it)."""
    _jix, tix, port, _ref, _k = ells
    R1, B = tix.n_rows + 1, 8
    f0 = np.zeros((R1, B), np.int8)
    f0[:tix.n] = 1
    full = torch.empty((R1, B), dtype=torch.int8)
    ell_ops.go_hop_i8(_t(f0), None, full, over=(1,), **port)
    none_live = torch.zeros(ell_ops.live_words(R1), dtype=torch.int32)
    empty = torch.empty((R1, B), dtype=torch.int8)
    ell_ops.go_hop_i8(_t(f0), None, empty, over=(1,), live_in=none_live,
                      **port)
    assert full.any() and not empty.any()


def test_row_live_pass_marks_positive_rows_only(ells):
    _jix, tix, _port, _ref, _k = ells
    R1 = tix.n_rows + 1
    f = np.zeros((R1, 12), np.int8)
    f[3, 5] = 1
    f[4] = -5                               # negative only: not live
    f[6, 0], f[6, 11] = -1, 2
    f[-1] = 9                               # the pad row's entry is 0
    live = ell_ops.row_live_i8_ref(_t(f))
    assert live.dtype == torch.int32 and live.shape == (-(-R1 // 32),)
    assert np.nonzero(ell_ops.live_rows(live, R1).numpy())[0].tolist() \
        == [3, 6]


# ================================================= stale live arrays
@pytest.mark.parametrize("B", [8, 12])
@pytest.mark.parametrize("over", [(-1, 1, 2), (-2, -1, 1, 2)])
def test_stale_live_array_stays_a_superset_after_the_level_pass(ells, B,
                                                                over):
    """K15 lowers ``nxt`` to the newly reached lanes (both directions:
    the starts are reached again and dropped); the hop's ``live_out``
    made before it still covers every positive row, and the next hop
    fed the stale array equals the reference's advance."""
    _jix, tix, port, _ref, _k = ells
    rng = np.random.default_rng(B + len(over))
    R1 = tix.n_rows + 1
    f0 = np.zeros((R1, B), np.int8)
    rows = tix.perm[rng.integers(0, tix.n, 3 * B)]
    f0[rows, np.arange(3 * B) % B] = 1
    t0 = np.zeros_like(f0)
    t0[tix.perm[rng.integers(0, tix.n, B)], np.arange(B)] = 1
    d = torch.empty((R1, B), dtype=torch.int8)
    seen = torch.empty((R1, -(-B // 8)), dtype=torch.uint8)
    tp = torch.empty_like(seen)
    flags = torch.zeros((4, 2), dtype=torch.int32)
    f = _t(f0)
    ell_ops.bfs_level_i8_ref(f, tp, seen, d, flags[0], 0, True, True, _t(t0))
    live = torch.empty(ell_ops.live_words(R1), dtype=torch.int32)
    nxt = torch.empty_like(f)
    for step in range(2):       # the second hop reaches the starts again
        ell_ops.go_hop_i8_ref(f, None, nxt, over=over, live_out=live,
                              **port)
        before = nxt.clone()
        ell_ops.bfs_level_i8_ref(nxt, tp, seen, d, flags[step + 1], step,
                                 False, False)
        f, nxt = nxt, f
    nxt = f
    assert not torch.equal(before, nxt)          # the pass lowered lanes
    pos = _positive_rows(nxt.numpy())
    stale = ell_ops.live_rows(live, R1).numpy()
    assert (stale | ~pos).all() and (stale & ~pos).any()
    again = torch.empty_like(nxt)
    ell_ops.go_hop_i8(nxt, None, again, over=over, live_in=live, **port)
    assert np.array_equal(again.numpy(),
                          _advance(ells, nxt.numpy(), over, False))


def test_programs_pass_each_hop_its_predecessors_live_out(ells):
    """``ell_go_i8`` and ``ell_bfs_i8`` chain the arrays: the first hop
    gets none (the pass), every later hop the previous hop's
    ``live_out``, and no hop writes the array it reads."""
    _jix, tix, port, _ref, _k = ells
    R1, B = tix.n_rows + 1, 8
    calls = []

    def hop(f, acc, out, tables, eslot, hrows, over, live_in, live_out):
        calls.append((live_in, live_out))
        return ell_ops.go_hop_i8_ref(f, acc, out, tables, eslot, hrows,
                                     over, live_in, live_out)
    chained = ell_ops._live_chain(hop, R1, CPU)
    f = torch.zeros((R1, B), dtype=torch.int8)
    f[tix.perm[:B], torch.arange(B)] = 1
    buf = torch.empty_like(f)
    for _ in range(4):
        chained(f, None, buf, over=(1,), **port)
        f, buf = buf, f
    assert calls[0][0] is None
    for (_a, prev_out), (nxt_in, nxt_out) in zip(calls, calls[1:]):
        assert nxt_in is prev_out and nxt_out is not nxt_in


# =============================================== the plan, B-byte rows
def _covered(rows, D, W, unit, cols=1):
    """Each bucket's rows covered by the plan's blocks (the kernel's
    block-to-bucket lookup), as counts."""
    lgc, lg, blk0, blocks = ell_ops.hop_plan(rows, D, W, unit, cols)
    C = -(-(W // unit) // cols)
    assert 1 << lgc == min(32, 1 << max(0, C - 1).bit_length())
    seen = [np.zeros(r, np.int64) for r in rows]
    for blk in range(blocks):
        b = max(k for k in range(len(rows)) if blk0[k] <= blk)
        per = ell_ops.HOP_THREADS >> lg[b]
        lo = (blk - blk0[b]) * per
        assert lo < rows[b], "a block with no live row"
        seen[b][lo:min(lo + per, rows[b])] += 1
    return seen


@pytest.mark.parametrize("B,unit", [(4, 4), (12, 4), (128, 16), (1024, 16),
                                    (128, 4), (1024, 4), (10, 1), (3, 1),
                                    (48, 16), (256, 16)])
def test_hop_plan_covers_every_row_once_at_b_byte_rows(B, unit):
    """B-byte rows on each column path, with the columns a lane that
    K13 gives the plan (``i8_hop_cols``: four or two 16-byte columns a
    lane; B = 48 has three, fewer than a lane takes)."""
    cols = ell_ops.i8_hop_cols(B, unit)
    assert cols == (1 if unit != 16 else 4 if B <= 256 else 2)
    for b, seen in enumerate(_covered(SERVE_ROWS, SERVE_D, B, unit, cols)):
        assert (seen == 1).all(), f"bucket {b}: rows covered unevenly"
    # the lanes a row at B = 128 and 1024: 8 columns on 2 lanes, 64 on 32
    if (B, unit) in ((128, 16), (1024, 16)):
        lgc = ell_ops.hop_plan(SERVE_ROWS, SERVE_D, B, unit, cols)[0]
        assert 1 << lgc == {128: 2, 1024: 32}[B]


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("W", [16, 128, 4])
def test_shard_plan_covers_exactly_the_owned_rows(ells, k, W):
    """M1's plan for shard s (per bucket: the chunk's first frontier
    row, its rows below the bucket's real count) covers exactly
    ``mt.owned(s)``, each row once."""
    _jix, tix, _port, _ref, _k = ells
    mt = mesh_tables(tix, PartsMesh([CPU] * k))
    every = []
    for s in range(k):
        t = mt.shards[s]
        live = ell_ops._shard_live(mt, s)
        for b, n in enumerate(live):         # the chunk below real_rows
            lo = s * t.rows[b]
            assert n == max(0, min(t.rows[b], mt.real_rows[b] - lo))
        seen = _covered(live, t.D, W, 16 if W % 16 == 0 else 4)
        rows = [t.row0[b] + i for b, cnt in enumerate(seen)
                for i in np.nonzero(cnt)[0]]
        assert all((cnt == 1).all() for cnt in seen)
        owned = [r for lo, hi in mt.owned(s) for r in range(lo, hi)]
        assert sorted(rows) == owned
        every += owned
    assert sorted(every) == list(range(tix.n_rows))


# =============================================== the row replication
def _copy_loop(bufs, blocks):
    """The per-block ``copy_`` loop M3 replaced."""
    for t, rows in enumerate(blocks):
        for lo, hi in rows:
            if hi > lo:
                for s, dst in enumerate(bufs):
                    if s != t:
                        dst[lo:hi].copy_(bufs[t][lo:hi])


def _near_ref(bufs, blocks, calls):
    """``replicate_rows``' copy stage of one card on the per-source
    plain version, recording the card's members."""
    def near(members):
        calls.append(members)
        for t in members:
            ell_ops.copy_rows_ref(bufs[t], [bufs[s] for s in members
                                            if s != t], blocks[t])
    return near


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("copy", ["copy_rows_ref", "copy_rows"])
def test_replicate_rows_equals_the_per_block_copies(ells, k, copy):
    """On the mesh's own owned blocks (empty buckets left out by
    ``owned``) and on blocks with empty and one-row ranges and a shard
    that owns nothing.  ``copy_rows_ref``: the card's copy stage on the
    per-source plain version; ``copy_rows``: on the mesh's own blocks
    M3 itself (``mesh_hop``'s copy stage over the card's replica slab),
    on the hand blocks every shard on a card of its own (pretended), so
    every range goes by ``copy_``."""
    _jix, tix, _port, _ref, _k = ells
    mt = mesh_tables(tix, PartsMesh([CPU] * k))
    rng = np.random.default_rng(k)
    R1 = tix.n_rows + 1
    cases = [[mt.owned(s) for s in range(k)]]
    hand = [[(0, 3), (5, 5), (9, 10)], [], [(3, 5), (20, 20)],
            [(10, 20), (30, 31)]]
    cases.append(hand[:k - 1] + [[(r, r + 1) for r in (40, 50)]])
    es, hr = (torch.from_numpy(a) for a in tix.hub_merge())
    for i, blocks in enumerate(cases):
        init = torch.from_numpy(rng.integers(0, 256, (k, R1, 16),
                                             dtype=np.uint8))
        slab = init.clone()
        got = list(slab.unbind(0))
        want = [b.clone() for b in init]
        calls = []
        groups = mt.mesh.groups
        if copy == "copy_rows_ref":
            near = _near_ref(got, blocks, calls)
        elif i == 0:
            def near(members):
                calls.append(members)
                ell_ops.mesh_hop(init.clone(), slab, mt, groups[0], es, hr,
                                 (1,), ell_ops.HOP_COPY)
        else:
            groups = tuple((CPU, (s,)) for s in range(k))
            near = _near_ref(got, blocks, calls)
        moved = replicate_rows(got, blocks, near, groups)
        _copy_loop(want, blocks)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        nrows = sum(hi - lo for rows in blocks for lo, hi in rows
                    if hi > lo)
        assert moved == nrows * 16 * (k - 1)
        # one call a card with two or more members
        assert calls == [m for _d, m in groups if len(m) > 1]


class _OnDevice:
    """A CPU buffer that says it lies on ``device``: what
    ``replicate_rows`` reads of a shard's buffer (its device, rows,
    element size) without a second card."""

    def __init__(self, t, device):
        self.t, self.device = t, torch.device(device)

    def __getitem__(self, i):
        return self.t[i]

    def element_size(self):
        return self.t.element_size()


def test_replicate_rows_sends_to_other_cards_by_copy():
    """Shards 0, 1 on one card and 2, 3 on another: each card's rows
    reach its other member through one copy-stage call a card and the
    two shards on the other card by ``copy_`` per range; the result
    equals the per-block ``copy_`` loop."""
    rng = np.random.default_rng(7)
    init = [_t(rng.integers(0, 256, (40, 8), dtype=np.uint8))
            for _ in range(4)]
    blocks = [[(0, 3), (9, 10)], [(3, 9), (12, 12)], [], [(20, 40)]]
    want = [b.clone() for b in init]
    _copy_loop(want, blocks)
    bufs = [_OnDevice(b.clone(), f"cuda:{s // 2}")
            for s, b in enumerate(init)]
    cards = ((torch.device("cuda", 0), (0, 1)),
             (torch.device("cuda", 1), (2, 3)))
    calls = []
    moved = replicate_rows(bufs, blocks,
                           _near_ref([b.t for b in bufs], blocks, calls),
                           cards)
    for b, w in zip(bufs, want):
        assert torch.equal(b.t, w)
    assert moved == (4 + 6 + 20) * 8 * 3
    assert calls == [(0, 1), (2, 3)]


def test_copy_rows_refuses_what_the_kernel_cannot_take(ells):
    """``mesh_hop`` (whose copy stage is M3) refuses what its kernels
    cannot take, then copies the owned rows of every member."""
    _jix, tix, _port, _ref, _k = ells
    k = 2
    mt = mesh_tables(tix, PartsMesh([CPU] * k))
    g = mt.mesh.groups[0]
    R1 = tix.n_rows + 1
    es, hr = (torch.from_numpy(a) for a in tix.hub_merge())
    a = torch.zeros((k, R1, 8), dtype=torch.uint8)
    b = torch.zeros((k, R1, 8), dtype=torch.uint8)
    hop = ell_ops.mesh_hop
    with pytest.raises(ValueError):          # nxt aliasing cur
        hop(a, a, mt, g, es, hr, (1,), ell_ops.HOP_COPY)
    with pytest.raises(ValueError):          # one replica short
        hop(a, b[:1], mt, g, es, hr, (1,), ell_ops.HOP_COPY)
    with pytest.raises(ValueError):          # a shard the mesh lacks
        hop(a, b, mt, (CPU, (0, 2)), es, hr, (1,), ell_ops.HOP_COPY)
    with pytest.raises(ValueError):          # no stage
        hop(a, b, mt, g, es, hr, (1,), 0)
    with pytest.raises(TypeError):           # another dtype
        hop(a, b.to(torch.int8), mt, g, es, hr, (1,), ell_ops.HOP_COPY)
    with pytest.raises(ValueError):          # rows of 6 bytes: no words
        hop(a[:, :, :6].contiguous(), b[:, :, :6].contiguous(), mt, g, es,
            hr, (1,), ell_ops.HOP_COPY)
    b[0] = 3
    hop(a, b, mt, g, es, hr, (1,), ell_ops.HOP_COPY)
    own = np.zeros(R1, bool)
    for lo, hi in mt.owned(0):
        own[lo:hi] = True
    assert b[1][own].eq(3).all() and not b[1][~own].any()
    assert b[0][own].eq(3).all() and not b[0][:-1][~own[:-1]].any()


def test_go_hop_i8_refuses_bad_live_bitmaps(ells):
    _jix, tix, port, _ref, _k = ells
    R1 = tix.n_rows + 1
    f = torch.zeros((R1, 8), dtype=torch.int8)
    out = torch.empty_like(f)
    words = ell_ops.live_words(R1)
    with pytest.raises(TypeError):       # bitmaps are int32 words
        ell_ops.go_hop_i8(f, None, out, over=(1,),
                          live_in=torch.zeros(words, dtype=torch.uint8),
                          **port)
    with pytest.raises(ValueError):      # one bit a row, no more
        ell_ops.go_hop_i8(f, None, out, over=(1,),
                          live_out=torch.zeros(R1, dtype=torch.int32),
                          **port)
    same = torch.zeros(words, dtype=torch.int32)
    with pytest.raises(ValueError):      # live_out must not be live_in
        ell_ops.go_hop_i8(f, None, out, over=(1,), live_in=same,
                          live_out=same, **port)
