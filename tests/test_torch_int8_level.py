"""The int8 route's BFS level pass on lane bitmaps (K15, ``bfs_level_i8``)
and the row pack fused into ``ell_go_i8``'s last advance, against the
JAX functions they serve: ``make_batched_bfs_kernel`` (nebula_tpu/tpu/
ell.py:1616) and ``make_batched_go_kernel(pack=True)`` (ell.py:1140,
``pack_bits`` at :439).

On the CPU the wrappers run their plain versions, which follow the
kernels' structure: the BFS keeps ``seen`` and the targets as lane
bitmaps (uint8 [n_rows + 1, ceil(B / 8)], bit j of byte w lane 8w + j)
and ``d`` in the result's form from the first pass, and a row-packed
GO's last advance ORs the gathered rows' bits, then each extra row's
bits into its owner's.  Inputs are made with numpy from a seed; every
comparison is exact.  The ELL is the JAX package's own numpy build at
cap 16 with a claimed growth spare (``test_torch_unpacked._graph``):
its buckets start at rows 171 and 298, inside 8-row groups, the hub
owners 298-302 share the group that holds the second start, and
n_rows + 1 = 477 is no multiple of 8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu.tpu.runtime import TpuQueryRuntime
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import ELL_FIELDS, ell_from_reference

from test_torch_unpacked import CHAIN, OVER_SETS, _claim_a_spare, _graph

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
    return jix, tix, port, jix.kernel_args()


def test_the_graph_splits_8_row_groups(ells):
    """The shapes the fused pack must get right are in this graph."""
    jix, tix, port, _ref = ells
    row0 = port["tables"].row0
    assert any(r % 8 for r in row0[1:])               # starts mid-group
    owners = {int(o) for o in jix.extra_owner if o < tix.n_rows}
    starts = {r // 8 for r in row0[1:] if r % 8}
    assert {o // 8 for o in owners} & starts          # owners share one
    assert (tix.n_rows + 1) % 8


def _lanes(rng, tix, B, per_lane, values):
    """An int8 carrier with ``per_lane`` random rows a lane holding the
    given values (bytes above 1 and below 0 included)."""
    f = np.zeros((tix.n_rows + 1, B), np.int8)
    rows = tix.perm[rng.integers(0, tix.n, per_lane * B)]
    f[rows, np.arange(per_lane * B) % B] = rng.choice(values, per_lane * B)
    return f


def _bfs_inputs(tix, B, seed):
    """Starts with values 1..9 and a few negative or zero bytes beside
    (a negative start is no start), lane 0 at the chain's head; targets
    a lane, some at the lane's own starts, lane 0 at the chain's tail."""
    rng = np.random.default_rng(seed)
    f0 = _lanes(rng, tix, B, 2, [1, 1, 2, 7, 9])
    f0 += _lanes(rng, tix, B, 1, [-1, -5, -128, 0])
    f0[tix.perm[tix.n - CHAIN], 0] = 3
    f0[-1] = 0
    t0 = _lanes(rng, tix, B, 2, [1, 2, -3])
    at = np.nonzero(f0[:, 1:] > 0)
    t0[at[0][:B // 2], at[1][:B // 2] + 1] = 1       # targets at starts
    t0[tix.perm[tix.n - 1], 0] = 1
    return f0, t0


def _jax_bfs(jix, ref, f0, t0, max_steps, stop, over):
    kern = jell.make_batched_bfs_kernel(jix, max_steps, over,
                                        stop_when_found=stop)
    return np.asarray(kern(jnp.asarray(f0), jnp.asarray(t0), *ref))


# ============================================================ the BFS
@pytest.mark.parametrize("max_steps", [1, 2, 3, 5, 130])
@pytest.mark.parametrize("stop", [True, False])
def test_ell_bfs_i8_matches_jax_at_each_depth(ells, max_steps, stop):
    """int8 depths up to 120 levels, int16 past (the chain reaches 130);
    the levels run equal the packed route's on the same lanes."""
    jix, tix, port, ref = ells
    B = 128
    f0, t0 = _bfs_inputs(tix, B, max_steps + 7 * stop)
    want = _jax_bfs(jix, ref, f0, t0, max_steps, stop, OVER_SETS[1])
    got, levels = ell_ops.ell_bfs_i8(_t(f0), _t(t0), over=OVER_SETS[1],
                                     max_steps=max_steps,
                                     stop_when_found=stop, **port)
    assert got.dtype == ell_ops.depth_dtype(max_steps)
    assert np.array_equal(want, got.numpy())
    if max_steps == 130 and not stop:
        assert want[want != np.iinfo(np.int16).max].max() > 120
    fp = np.packbits(f0 > 0, axis=1, bitorder="little")
    tp = np.packbits(t0 > 0, axis=1, bitorder="little")
    _d, packed_levels = ell_ops.ell_bfs(_t(fp), _t(tp), over=OVER_SETS[1],
                                        max_steps=max_steps,
                                        stop_when_found=stop, **port)
    assert levels == packed_levels


@pytest.mark.parametrize("B", [8, 10, 12, 128])
@pytest.mark.parametrize("stop", [True, False])
@pytest.mark.parametrize("max_steps", [3, 130])
def test_ell_bfs_i8_matches_jax_at_each_width(ells, B, stop, max_steps):
    """Widths with no 16-lane unit (8), a byte tail (10: 2 lanes in the
    second seen byte) and 4-byte words only (12); the targets given as
    an int8 carrier (the first pass packs them) and as the lane bitmap
    K1 uploads give the same depths, and the bitmaps' tail bits past B
    stay 0."""
    jix, tix, port, ref = ells
    f0, t0 = _bfs_inputs(tix, B, 3 * B + stop)
    assert (f0 > 1).any() and (f0 < 0).any()
    want = _jax_bfs(jix, ref, f0, t0, max_steps, stop, OVER_SETS[0])
    got, levels = ell_ops.ell_bfs_i8(_t(f0), _t(t0), over=OVER_SETS[0],
                                     max_steps=max_steps,
                                     stop_when_found=stop, **port)
    assert np.array_equal(want, got.numpy())
    tbits = np.packbits(t0 > 0, axis=1, bitorder="little")
    got_b, levels_b = ell_ops.ell_bfs_i8(_t(f0), _t(tbits),
                                         over=OVER_SETS[0],
                                         max_steps=max_steps,
                                         stop_when_found=stop, **port)
    assert np.array_equal(want, got_b.numpy()) and levels_b == levels


@pytest.mark.parametrize("B", [8, 10, 12, 128])
def test_level_pass_keeps_the_reference_state(ells, B):
    """Pass by pass, ``seen`` is the reference's d != INF as lane bits
    (no bit past B), ``d`` is its depth in the result's form, ``nxt``
    its 0/1 frontier, and the flags its loop condition's two terms."""
    jix, tix, port, ref = ells
    R1 = tix.n_rows + 1
    f0, t0 = _bfs_inputs(tix, B, B)
    Wb = -(-B // 8)
    seen = torch.empty((R1, Wb), dtype=torch.uint8)
    tp = torch.empty_like(seen)
    d = torch.empty((R1, B), dtype=torch.int8)
    flags = torch.zeros((5, 2), dtype=torch.int32)
    cur = _t(f0)
    ell_ops.bfs_level_i8(cur, tp, seen, d, flags[0], 0, True, True, _t(t0))
    assert torch.equal(cur, _t(f0))                 # the start stays
    assert np.array_equal(tp.numpy(), np.packbits(t0 > 0, axis=1,
                                                  bitorder="little"))
    d_ref = np.where(f0 > 0, 0, -1)
    f_ref = f0.copy()
    hop = ell_ops._live_chain(ell_ops.go_hop_i8, R1, CPU)
    for step in range(4):
        reached = d_ref >= 0
        assert np.array_equal(seen.numpy(), np.packbits(
            reached, axis=1, bitorder="little"))
        assert np.array_equal(d.numpy(), d_ref)
        assert flags[step].tolist() == [int((f_ref > 0).any()),
                                        int(((t0 > 0) & ~reached).any())]
        nxt = torch.empty_like(cur)
        hop(cur, None, nxt, over=OVER_SETS[1], **port)
        want_nxt = np.asarray(jell.make_batched_go_kernel(
            jix, 2, OVER_SETS[1])(jnp.asarray(f_ref), *ref))
        assert np.array_equal(nxt.numpy(), want_nxt)
        newly = (want_nxt > 0) & ~reached
        d_ref = np.where(newly, step + 1, d_ref)
        f_ref = newly.astype(np.int8)
        ell_ops.bfs_level_i8(nxt, tp, seen, d, flags[step + 1], step)
        assert np.array_equal(nxt.numpy(), f_ref)
        cur = nxt
    if B % 8:
        tail = np.uint8(0xFF << (B % 8) & 0xFF)
        assert not (seen.numpy()[:, -1] & tail).any()


def test_ell_bfs_i8_runs_no_depth_pass(ells, monkeypatch):
    """``d`` is kept in the result's form: no program calls
    ``bfs_depth_i8``."""
    _jix, tix, port, _ref = ells
    f0, t0 = _bfs_inputs(tix, 16, 1)

    def refuse(*_a):
        raise AssertionError("bfs_depth_i8 ran")
    monkeypatch.setattr(ell_ops, "bfs_depth_i8", refuse)
    monkeypatch.setattr(ell_ops, "bfs_depth_i8_ref", refuse)
    for fn in (ell_ops.ell_bfs_i8, ell_ops.ell_bfs_i8_ref):
        d, _levels = fn(_t(f0), _t(t0), over=(1,), max_steps=5, **port)
        assert d.dtype == torch.int8


# ============================================ the fused row pack
@pytest.mark.parametrize("steps", [2, 3, 4])
@pytest.mark.parametrize("upto", [False, True])
@pytest.mark.parametrize("B", [8, 10, 128])
def test_ell_go_i8_packed_matches_jax(ells, steps, upto, B):
    """The last advance writes the row-packed result itself: equal to
    the reference's ``pack_bits`` of its frontier (UPTO: of the running
    max), from starts with bytes above 1 and below 0."""
    jix, tix, port, ref = ells
    over = OVER_SETS[(steps + B) % len(OVER_SETS)]
    rng = np.random.default_rng(steps * 31 + B + upto)
    f0 = _lanes(rng, tix, B, 3, [1, 2, 5, -1, -7])
    f0[-1] = 0
    kern = jell.make_batched_go_kernel(jix, steps, over, pack=True,
                                       upto=upto)
    want = np.asarray(kern(jnp.asarray(f0), *ref))
    got = ell_ops.ell_go_i8(_t(f0), over=over, steps=steps, upto=upto,
                            pack=True, **port)
    R1 = tix.n_rows + 1
    assert got.dtype == torch.uint8 and got.shape == (-(-R1 // 8), B)
    assert np.array_equal(want, got.numpy())
    # the pad row's bit and the bits past R1 are zero
    assert not (got[-1].numpy() >> (tix.n_rows % 8)).any()


def test_fused_pack_merges_hubs_into_groups_they_share(ells):
    """Every real row live, every etype: each hub owner's bit carries its
    extra rows' lanes, the extra rows keep their own bits (with UPTO,
    also the accumulator's), and ``pack_rows`` of the unpacked program
    gives the same bits; K14 runs only where there is no advance."""
    jix, tix, port, ref = ells
    B = 12
    over = (-2, -1, 1, 2)
    f0 = np.zeros((tix.n_rows + 1, B), np.int8)
    f0[:tix.n] = np.random.default_rng(5).integers(-2, 3, (tix.n, B))
    f0[tix.n:tix.n + 3] = 4              # extra rows in the accumulator
    for upto in (False, True):
        want = np.asarray(jell.make_batched_go_kernel(
            jix, 2, over, pack=True, upto=upto)(jnp.asarray(f0), *ref))
        got = ell_ops.ell_go_i8(_t(f0), over=over, steps=2, upto=upto,
                                pack=True, **port)
        assert np.array_equal(want, got.numpy())
        flat = ell_ops.ell_go_i8(_t(f0), over=over, steps=2, upto=upto,
                                 **port)
        out = ell_ops.packed_rows(tix.n_rows + 1, B, CPU)
        assert torch.equal(ell_ops.pack_rows(flat, out), got)
    calls = []
    real = ell_ops.pack_rows

    def counting(x, out):
        calls.append(x.shape)
        return real(x, out)
    try:
        ell_ops.pack_rows = counting
        for steps in (1, 2, 3):
            ell_ops.ell_go_i8(_t(f0), over=over, steps=steps, pack=True,
                              **port)
    finally:
        ell_ops.pack_rows = real
    assert len(calls) == 1               # steps = 1 alone


def test_fused_advance_writes_the_extra_rows_alone(ells):
    """``go_hop_i8(..., pack=)``: ``out`` gets the extra rows as gathered
    (the hub pass reads them), ``acc`` is left as it was, and the packed
    result is returned."""
    _jix, tix, port, _ref = ells
    B = 8
    R1, n = tix.n_rows + 1, tix.n
    f = np.zeros((R1, B), np.int8)
    f[:n] = 1
    acc = _t(np.full((R1, B), -3, np.int8))
    out = torch.full((R1, B), 77, dtype=torch.int8)
    pk = ell_ops.packed_rows(R1, B, CPU)
    got, acc_back = ell_ops.go_hop_i8(_t(f), acc, out, over=(-1, 1),
                                      pack=pk, **port)
    assert got is pk and acc_back is acc and (acc == -3).all()
    full = torch.empty_like(out)
    ell_ops.go_hop_i8(_t(f), None, full, over=(-1, 1), **port)
    assert torch.equal(out[n:R1 - 1], ell_ops._gather_i8_ref(
        _t(f), torch.empty_like(out), port["tables"], (-1, 1),
        None)[n:R1 - 1])
    assert (out[:n] == 77).all()
    assert torch.equal(pk, ell_ops.pack_rows(full, ell_ops.packed_rows(
        R1, B, CPU)))
    with pytest.raises(ValueError):      # no live_out on a packed advance
        ell_ops.go_hop_i8(_t(f), None, out, over=(1,), pack=pk,
                          live_out=torch.empty(ell_ops.live_words(R1),
                                               dtype=torch.int32), **port)
    with pytest.raises(ValueError):      # pack is [ceil(R1 / 8), B]
        ell_ops.go_hop_i8(_t(f), None, out, over=(1,),
                          pack=torch.empty((R1, B), dtype=torch.uint8),
                          **port)


@pytest.mark.parametrize("B,unit,cols", [(128, 16, 4), (1024, 16, 2),
                                         (12, 4, 1), (10, 1, 1)])
def test_packed_plan_starts_blocks_at_8_row_groups(ells, B, unit, cols):
    """The fused advance's plan (``lead`` = row0 % 8): each bucket's
    blocks start at the group holding its first row, every row is a
    live place of exactly one block, and no block's group runs into the
    next block's."""
    _jix, _tix, port, _ref = ells
    t = port["tables"]
    lead = tuple(r % 8 for r in t.row0)
    lgc, lg, blk0, blocks = ell_ops.hop_plan(t.rows, t.D, B, unit, cols,
                                             lead)
    cover = np.zeros(t.n_rows, np.int64)
    for blk in range(blocks):
        b = max(k for k in range(len(t.D)) if blk0[k] <= blk)
        per = ell_ops.HOP_THREADS >> lg[b]
        first = t.row0[b] - lead[b] + (blk - blk0[b]) * per
        assert first % 8 == 0 and per % 8 == 0
        lo = max(first, t.row0[b])
        hi = min(first + per, t.row0[b] + t.rows[b])
        assert lo < hi, "a block with no live row"
        cover[lo:hi] += 1
    assert (cover == 1).all()


def test_runtime_uploads_the_int8_routes_targets_as_lane_bits(ells):
    """``_bfs_depths`` on the int8 route: the starts by K12, the targets
    by K1 where a bitmap row is whole 4-byte words (B = 128), which the
    BFS reads as they are."""
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    jix, tix, port, ref = ells
    rt = TorchQueryRuntime(device="cpu")
    try:
        rng = np.random.default_rng(9)
        rows = tix.perm[rng.integers(0, tix.n, 40)].astype(np.int32)
        cols = (np.arange(40) % 128).astype(np.int32)
        bits = rt._upload_frontier_packed(tix, rows, cols, 128)
        carrier = np.asarray(TpuQueryRuntime._upload_frontier(
            jix, rows, cols, 128))
        assert bits.dtype == torch.uint8 and bits.shape[1] == 16
        assert np.array_equal(bits.numpy(), np.packbits(
            carrier > 0, axis=1, bitorder="little"))
    finally:
        rt.close()
