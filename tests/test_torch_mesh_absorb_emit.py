"""The replicated-frontier mesh's absorb (``ell_absorb_sharded``, one
``mesh_absorb`` a card group, M2 ``shard_absorb`` its one-member call)
and the contract K6's emit reads by, on the CPU.

Absorb: the reference's ``make_sharded_ell_absorb_kernel``
(``ell.py:1036``) runs on a ``Mesh`` of the conftest's virtual CPU
devices, the port's plain routes on k CPU shards, on one card and split
over two pretended ones (the second card group then takes one copy of
the update set, ``updates_to``), for a plan at every shard's chunk ends,
a growth-spare claim and a plan whose pad entries outnumber its real
rows; the update set is the runtime's form (per-bucket views of one
flat buffer), walked whole and to the plan's real rows
(``ell.absorb_live``).  Every table slot is compared exactly, the input
tables stay as they were, and the gathered shards are the single-card
``ell_absorb_ref``'s tables.

Emit: the lists the frontier-sharded programs hand to K6 are K5's
(``pair_compact_ref``, and the mesh dedup's plain version inside
``_mesh_go_steps``, overflowed lists included): every place at or past
min(count, c) is a pad, and ``pair_reduce_ref``'s emit of such a list
equals the emit of its counted prefix followed by pad places, which is
what the card's emit computes without reading the tail.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.ell import (EllIndex, absorb_live,
                                      absorb_update_arrays, mesh_tables,
                                      sparse_caps)
from nebula_tpu_torch.tpu.mesh import PartsMesh

from test_torch_mesh import (_claim_plan, _jmesh, _shard_plan, _shards,
                             ells)  # noqa: F401  (the module's fixture)
from test_torch_mesh_launch import OVER, _st, _starts
from test_torch_unpacked import _graph

CPU = torch.device("cpu")
KS = [2, 4, 8]


def _cards(k, split):
    """A PartsMesh of k CPU shards, split over two pretended cards."""
    mesh = PartsMesh([CPU] * k)
    if split:
        half = (k + 1) // 2
        mesh.groups = ((CPU, tuple(range(half))), (CPU, tuple(range(half,
                                                                    k))))
    return mesh


def _padded_plan(ix, rng):
    """Few real rows against a wide pad: one row in bucket 0, nine in
    bucket 1 (kp 16), none in the rest."""
    plan = {}
    for b, cnt in ((0, 1), (1, 9)):
        rows_b, D = ix.bucket_nbr[b].shape
        rows = np.sort(rng.choice(rows_b, min(cnt, rows_b),
                                  replace=False)).astype(np.int32)
        plan[b] = (rows,
                   rng.integers(0, ix.n_rows + 1, (len(rows), D))
                   .astype(np.int32),
                   rng.integers(-2, 3, (len(rows), D)).astype(np.int32))
    return plan


def _flat_args(upd):
    """The runtime's form (``_absorb_args``): per-bucket views of one
    flat buffer."""
    parts = [a.reshape(-1) for trip in upd for a in trip]
    flat = torch.from_numpy(np.concatenate(parts).astype(np.int32))
    views, off = [], 0
    for a in parts:
        views.append(flat[off:off + a.size])
        off += a.size
    return (views[0::3],
            [v.view(u[1].shape) for v, u in zip(views[1::3], upd)],
            [v.view(u[2].shape) for v, u in zip(views[2::3], upd)]), flat


def _plan(kind, jix, tix, k, n, ed):
    rng = np.random.default_rng(k)
    if kind == "shard_ends":
        return _shard_plan(tix, k, rng)
    if kind == "growth_claim":
        return _claim_plan(jix, n, ed)
    return _padded_plan(tix, rng)


# ============================================================ absorb
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("kind", ["shard_ends", "growth_claim", "padded"])
@pytest.mark.parametrize("k", KS)
def test_absorb_matches_reference(ells, k, kind, split):  # noqa: F811
    jix, tix, _es, _hr, (_s, ed, _e, n) = ells
    plan = _plan(kind, jix, tix, k, n, ed)
    counts, upd = jell.absorb_update_arrays(jix, plan)
    nb = len(jix.bucket_nbr)
    live = absorb_live(tix, plan)
    kp = counts[0]
    if kind == "padded":
        assert sum(live) < nb * kp - sum(live)       # pads outnumber
    mesh = _jmesh(k)
    nbrs, ets, _reals = jell.shard_ell(mesh, "parts", jix)
    padded = [int(a.shape[0]) for a in nbrs]
    kern = jell.make_sharded_ell_absorb_kernel(mesh, "parts", jix, padded,
                                               counts)
    outs = kern(*[jnp.asarray(u[0]) for u in upd],
                *[jnp.asarray(u[1]) for u in upd],
                *[jnp.asarray(u[2]) for u in upd], *nbrs, *ets)
    want = [[(a, c) for a, c in zip(_shards(outs[b]), _shards(outs[nb + b]))]
            for b in range(nb)]
    mt = mesh_tables(tix, _cards(k, split))
    before = [(t.nbr.clone(), t.et.clone()) for t in mt.shards]
    args, _flat = _flat_args(upd)

    def check(got_shards, what):
        for s, t in enumerate(got_shards):
            for b in range(nb):
                gn, ge = t.bucket(b)
                assert np.array_equal(gn.numpy(), want[b][s][0]), \
                    (what, b, s)
                assert np.array_equal(ge.numpy(), want[b][s][1]), \
                    (what, b, s)

    for lv in (None, live):
        for fn in (ell_ops.ell_absorb_sharded_ref,
                   ell_ops.ell_absorb_sharded):
            check(fn(mt, *args, lv).shards, (fn.__name__, lv))
        check([ell_ops.shard_absorb(mt, s, *args, lv) for s in range(k)],
              ("shard_absorb", lv))
        for _d, members in mt.mesh.groups:
            got = ell_ops.mesh_absorb(mt, (CPU, members), *args, lv)
            assert len(got) == len(members)
            check([got[members.index(s)] if s in members else
                   ell_ops.shard_absorb_ref(mt, s, *args, lv)
                   for s in range(k)], ("mesh_absorb", members, lv))
    for t, (n0, e0) in zip(mt.shards, before):      # inputs only read
        assert torch.equal(t.nbr, n0) and torch.equal(t.et, e0)
    # the gathered shards are the single-card absorb's tables
    one = ell_ops.ell_absorb_ref(tix.device_tables(CPU), *args)
    got = ell_ops.ell_absorb_sharded(mt, *args, live)
    for b in range(nb):
        for col in (0, 1):
            gathered = torch.cat([t.bucket(b)[col] for t in got.shards])
            assert torch.equal(gathered[:mt.real_rows[b]],
                               one.bucket(b)[col]), (b, col)


@pytest.mark.parametrize("k", KS)
def test_second_card_group_takes_one_copy(ells, k, monkeypatch):  # noqa: F811
    """On one card every group reads the update set in place; split
    over two pretended cards, the group on the set's card reads it in
    place and the other takes one copy: all its views lie in one buffer
    of the flat buffer's size, at the same offsets."""
    _jix, tix, *_rest = ells
    plan = _shard_plan(tix, k, np.random.default_rng(k))
    _c, upd = absorb_update_arrays(tix, plan)
    args, flat = _flat_args(upd)
    seen = []
    real = ell_ops.mesh_absorb

    def spy(mt, group, rows, nn, ne, live):
        seen.append((group[1], rows, nn, ne))
        return real(mt, group, rows, nn, ne, live)
    monkeypatch.setattr(ell_ops, "mesh_absorb", spy)
    for split in (False, True):
        seen.clear()
        mt = mesh_tables(tix, _cards(k, split))
        ell_ops.ell_absorb_sharded(mt, *args)
        assert [m for m, *_x in seen] == [m for _d, m in mt.mesh.groups]
        home = seen[0][1:]
        for mine, orig in zip(home, args):
            assert all(a is b for a, b in zip(mine, orig))
        for _m, *far in seen[1:]:
            views = [x for xs in far for x in xs]
            base = views[0]._base
            assert base is not None and base.numel() == flat.numel()
            assert base.data_ptr() != flat.data_ptr()
            for v, o in zip(views, [x for xs in args for x in xs]):
                assert v._base is base and torch.equal(v, o)
                assert v.storage_offset() == o.storage_offset()


def test_updates_to_copies_views_of_no_common_buffer(ells):  # noqa: F811
    """An update set of separate tensors is laid end to end in one
    copy, re-viewed in its shapes."""
    _jix, tix, *_rest = ells
    _c, upd = absorb_update_arrays(
        tix, _padded_plan(tix, np.random.default_rng(3)))
    rows = [torch.from_numpy(u[0].copy()) for u in upd]
    nn = [torch.from_numpy(u[1].copy()) for u in upd]
    ne = [torch.from_numpy(u[2].copy()) for u in upd]
    r2, n2, e2 = ell_ops.updates_to(rows, nn, ne, CPU)
    base = r2[0]._base
    assert base.numel() == sum(x.numel() for x in rows + nn + ne)
    for a, b in zip(r2 + n2 + e2, rows + nn + ne):
        assert a._base is base and a.shape == b.shape and torch.equal(a, b)


def test_absorb_live_rows(ells):  # noqa: F811
    """``absorb_live`` counts the plan's real rows a bucket; walking
    fewer leaves the rest unwritten in the plain route too; a count
    past kp or of the wrong length is refused."""
    _jix, tix, *_rest = ells
    plan = _padded_plan(tix, np.random.default_rng(5))
    counts, upd = absorb_update_arrays(tix, plan)
    live = absorb_live(tix, plan)
    assert live == (1, min(9, tix.bucket_nbr[1].shape[0])) \
        + (0,) * (len(upd) - 2)
    mt = mesh_tables(tix, _cards(2, False))
    args, _flat = _flat_args(upd)
    none = ell_ops.ell_absorb_sharded(mt, *args, (0,) * len(upd))
    for t, u in zip(none.shards, mt.shards):
        assert torch.equal(t.nbr, u.nbr) and torch.equal(t.et, u.et)
    for bad in (live[:-1], (counts[0] + 1,) + live[1:]):
        with pytest.raises(ValueError):
            ell_ops.ell_absorb_sharded(mt, *args, bad)


# ============================================================== emit
def _pads_past_count(ids, qid, ctl, n_rows):
    c = ids.shape[0]
    n = min(int(ctl[ell_ops.CTL_CNT]), c)
    assert (ids[n:] == n_rows).all() and (qid[n:] == ell_ops.BIG_Q).all()
    assert (qid[:n] != ell_ops.BIG_Q).all()
    return n


def _emit_equals_prefix_emit(ids, qid, ctl, n_rows, n):
    """The emit of the list equals the emit of its first n places
    followed by pad places, in both layouts."""
    c = ids.shape[0]
    ids2 = torch.full_like(ids, n_rows)
    qid2 = torch.full_like(qid, ell_ops.BIG_Q)
    ids2[:n], qid2[:n] = ids[:n], qid[:n]
    R1 = n_rows + 1
    for pack32 in (False, True):
        outs = []
        for i, q in ((ids, qid), (ids2, qid2)):
            out = torch.zeros(2 + (1 if pack32 else 2) * c,
                              dtype=torch.int32)
            ell_ops.pair_reduce_ref(ell_ops.REDUCE_EMIT, i, q, None, out,
                                    pack32, R1, n_rows, 4, 4, 0, 0, ctl)
            outs.append(out)
        assert torch.equal(*outs)


@pytest.mark.parametrize("c", [1, 5, 64, 131])
def test_k5_lists_are_pads_past_their_count(c):
    """K5's lists at count 0, one, a mid count, c and past c (the
    overflowed list keeps its first c places)."""
    rng = np.random.default_rng(c)
    n_rows, nq = 997, 3
    R1w = (n_rows + 1 + 31) // 32
    valid = np.array([q * R1w * 32 + v for q in range(nq)
                      for v in range(n_rows + 1)])
    for bits in sorted({0, 1, c // 2, c, c + 7}):
        mark = torch.zeros(nq * R1w, dtype=torch.int32)
        words = mark.numpy().view(np.uint32)
        for x in rng.choice(valid, bits, replace=False):
            words[x // 32] |= np.uint32(1 << int(x % 32))
        ids = torch.full((c,), -5, dtype=torch.int32)
        qid = torch.full((c,), -5, dtype=torch.int32)
        ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
        ell_ops.pair_compact_ref(mark, R1w, c, ids, qid, ctl, -1, n_rows)
        assert int(ctl[ell_ops.CTL_CNT]) == bits
        assert int(ctl[ell_ops.CTL_OVF]) == (bits > c)
        n = _pads_past_count(ids, qid, ctl, n_rows)
        assert n == min(bits, c)
        _emit_equals_prefix_emit(ids, qid, ctl, n_rows, n)


@pytest.mark.parametrize("caps_last", [4096, 4])
@pytest.mark.parametrize("k", [2, 4])
def test_mesh_dedup_lists_are_pads_past_their_count(k, caps_last):
    """Every list ``_mesh_go_steps`` hands to its emit (the mesh dedup's
    plain version; a last cap of 4 overflows it) is pads past min(count,
    c), and the emit of its prefix is the program's output."""
    es, ed, ee, n = _graph()
    ix = EllIndex.build(es, ed, ee, n, cap=16, min_d=4)
    st = _st(ix, k)
    ids, qid = _starts(ix, st, 12, 3, seed=k, c0=64)
    caps = sparse_caps(64, max(ix.bucket_D), 3, 1 << 12, growth=8)
    caps = tuple(caps[:-1]) + (min(caps[-1], caps_last),)
    seen = []

    def emit(ids_, qid_, ctl, out, n_rows):
        for y in range(ids_.shape[0]):
            m = _pads_past_count(ids_[y], qid_[y], ctl[y], n_rows)
            _emit_equals_prefix_emit(ids_[y], qid_[y], ctl[y], n_rows, m)
            seen.append((int(ctl[y][ell_ops.CTL_CNT]), ids_.shape[1]))
        return ell_ops.mesh_emit(ids_, qid_, ctl, out, n_rows)
    got, _x, _c = ell_ops._mesh_go_steps(
        st.mesh.split(ids), st.mesh.split(qid), st, OVER, 3, caps, 4096,
        256, 12, ell_ops.mesh_route_card, ell_ops.mesh_dedup,
        (ell_ops.mesh_agree, ell_ops.or_many), emit)
    assert len(seen) == k
    over = any(cnt > c for cnt, c in seen)
    assert over == (caps_last == 4)
    assert bool(got[0][:, 1].any()) == over
    if not over:
        want = ell_ops.mesh_sparse_go_ref(
            st.mesh.split(ids), st.mesh.split(qid), st, OVER, 3, caps,
            4096, 256, 12)
        assert torch.equal(got[0], want[0])
