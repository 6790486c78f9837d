"""The sparse pair-list programs' launch path (nebula_tpu_torch/tpu/
ell_ops.py): ``sparse_go`` in its emit, COUNT, LIMIT and UPTO forms and
``adaptive_go``, each of which the card runs as one checked C call
(``sg_program``, ``ad_program`` in csrc/sparse_go.cu) on a workspace of
its own, laid out by ``_sparse_plan`` / ``_adaptive_plan`` and driven in
the same order by ``_sparse_go_steps`` / ``_adaptive_steps`` with the
kernels' plain versions on the CPU.

Seeded numpy inputs go through the JAX functions the programs replace
(``make_batched_sparse_go_kernel``, nebula_tpu/tpu/ell.py:1222, and
``make_adaptive_go_kernel``, :1493) on CPU jax and through the port's
step sequences on CPU torch; outputs are compared exactly (the whole array when
the JAX kernel reports no overflow, the flag always).  The workspace
layouts are held to the checks the C entries make before they launch,
the sequences run on workspaces whose memory holds garbage before the
call (nothing may be read that the call did not write or clear), two
threads call the same tables at once, and the adaptive program's mode
turns dense at each hop it can, the layout change running exactly once.
"""
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nebula_tpu.tpu import ell as jell
from nebula_tpu_torch.tpu import ell_ops
from nebula_tpu_torch.tpu.csr import mirror_from_edges
from nebula_tpu_torch.tpu.ell import (ELL_FIELDS, ell_from_reference,
                                      sparse_caps, unpack_bits)
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime

PACK32_QMAX = 1024          # go_batch_max's default: one-word keys
TWO_ARRAY_QMAX = 1 << 23    # past 2^31 / (n_rows + 1): two arrays
FORMS = {"emit": {}, "upto": dict(upto=True), "count": dict(count=True),
         "count_upto": dict(count=True, upto=True),
         "limit": dict(limit=3)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _graph(seed=11, n=300, m=1400):
    """Mirror-shaped arrays (both directions, signed etypes 1 and 2)
    with two hubs past cap 8."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    src[:60] = 5                        # hub by out-degree
    dst[60:110] = 9                     # hub by in-degree
    et = rng.integers(1, 3, m)
    return (np.concatenate([src, dst]).astype(np.int32),
            np.concatenate([dst, src]).astype(np.int32),
            np.concatenate([et, -et]).astype(np.int32), n)


@pytest.fixture(scope="module")
def ells():
    es, ed, ee, n = _graph()
    jix = jell.EllIndex.build(es, ed, ee, n, cap=8, use_native=False,
                              growth_slack=8)
    assert len(jix.extra_owner) > 8     # hubs beyond the spares
    tix = ell_from_reference({f: getattr(jix, f) for f in ELL_FIELDS})
    return jix, tix, tix.device_tables(torch.device("cpu"))


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


def _deg(rng, tix):
    deg = rng.integers(0, 9, tix.n_rows + 1).astype(np.int32)
    deg[tix.n:] = 0                     # extras and the pad row count 0
    deg[rng.random(tix.n_rows + 1) < 0.2] = 0
    return deg


def _jax_sparse(jix, ids, qid, deg, over, steps, caps, qmax, upto=False,
                limit=None, count=False):
    kern = jell.make_batched_sparse_go_kernel(jix, steps, over, caps,
                                              qmax=qmax, upto=upto,
                                              limit=limit, count=count)
    ecnt, e0 = jix.hub_expansion()
    args = [jnp.asarray(ids), jnp.asarray(qid), jnp.asarray(ecnt),
            jnp.asarray(e0)]
    if count or limit is not None:
        args.append(jnp.asarray(deg))
    return np.asarray(kern(*args, *jix.kernel_args()[1:]))


def _steps(tix, tables, ids, qid, deg, over, steps, caps, qmax, nq,
            upto=False, limit=None, count=False):
    """The program as its step sequence, each kernel's plain version in its
    place (the wrappers on CPU tensors)."""
    ecnt, e0 = tix.hub_expansion()
    return ell_ops._sparse_go_steps(
        _t(ids), _t(qid), _t(ecnt), _t(e0), _t(deg), tables, over, steps,
        caps, qmax, nq, upto, limit, count, ell_ops.sparse_expand,
        ell_ops.pair_compact, ell_ops.pair_reduce).numpy()


def _same(want, got):
    """Flags equal always; the whole array when nothing overflowed."""
    assert got.dtype == np.int32 and got.shape == want.shape
    assert got[1] == want[1]
    if not want[1]:
        assert np.array_equal(got, want)


@pytest.fixture
def noisy_empty(monkeypatch):
    """``torch.empty`` handing out memory full of 0xA5 bytes, so that a
    sequence reading what its call neither wrote nor cleared is caught."""
    real = torch.empty

    def empty(*args, **kw):
        t = real(*args, **kw)
        if t.numel() and t.dtype in (torch.int32, torch.int64, torch.uint8,
                                     torch.bool):
            t.view(torch.uint8).fill_(0xA5)
        return t
    monkeypatch.setattr(torch, "empty", empty)


# ============================================================ the plan
def _plan_ok(pl, S, nq, R1w, n_rows):
    """The checks sg_program makes of a plan before it launches
    (csrc/sparse_go.cu), written out: the regions lie inside the
    workspace, do not overlap, and the cleared prefix holds ctl, the
    mark bitmap, the UPTO union and K5's look-back state (a head and a
    descriptor a chunk, int64 words)."""
    words = nq * R1w
    state = 2 * (ell_ops.COMPACT_HEAD + -(-words // ell_ops.COMPACT_CHUNK))
    assert state == 2 * ell_ops.compact_state_words(words)
    regions = [(0, ell_ops.CTL_WORDS), (pl.mark, words), (pl.scan, state)]
    if pl.upto:
        regions.append((pl.uni, words))
    assert pl.zero >= ell_ops.CTL_WORDS + words * (2 if pl.upto else 1) \
        + state
    assert all(a >= ell_ops.CTL_WORDS and a + n <= pl.zero
               for a, n in regions[1:])
    tail = [(pl.bufs, 4 * pl.cmax)]
    if pl.op == ell_ops.REDUCE_LIMIT:
        tail.append((pl.scratch, 2 * nq))
    assert pl.scan % 2 == 0 and pl.scratch % 2 == 0
    assert all(a >= pl.zero and a + n <= pl.words for a, n in tail)
    spans = sorted(regions + tail)
    assert all(a + n <= b for (a, n), (b, _m) in zip(spans, spans[1:]))
    assert len(pl.hops) >= 1 and pl.nq == nq
    assert all(1 <= c <= pl.cmax for c, _ex, _cl in pl.hops)
    assert not pl.upto or pl.c_fin <= pl.cmax
    c_in = S
    for c_out, ex, c_lim in pl.hops:           # the sequence's hop words
        assert c_lim == max(1, (2**31 - 1) // c_in)
        c_in = c_out
    width = {ell_ops.REDUCE_EMIT: pl.c_fin, ell_ops.REDUCE_COUNT: pl.qmax,
             ell_ops.REDUCE_LIMIT: pl.c_red}[pl.op]
    assert pl.out_words == 2 + (1 if pl.op == ell_ops.REDUCE_COUNT
                                or pl.pack32 else 2) * width
    arr = list(pl.arr)
    assert arr[:17] == [len(pl.hops), nq, pl.qmax, int(pl.upto), pl.op,
                        pl.limit, pl.c_fin, pl.c_red, int(pl.pack32),
                        pl.cmax, pl.mark, pl.uni, pl.scan, pl.scratch,
                        pl.bufs, pl.zero, pl.words]
    assert arr[17:] == [v for hp in pl.hops for v in hp]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("shape", [(64, 2, 1, PACK32_QMAX),
                                   (256, 4, 7, TWO_ARRAY_QMAX),
                                   (2048, 3, 1024, PACK32_QMAX)])
def test_sparse_plan_passes_the_c_entrys_checks(ells, form, shape):
    _jix, tix, _tables = ells
    c0, steps, nq, qmax = shape
    caps = sparse_caps(c0, 8, steps, 1 << 12)
    kw = FORMS[form]
    pl = ell_ops._sparse_plan(c0, tuple(caps), qmax, nq, tix.n, tix.n_rows,
                              kw.get("upto", False), kw.get("limit"),
                              kw.get("count", False))
    _plan_ok(pl, c0, nq, (tix.n_rows + 32) // 32, tix.n_rows)
    n_extras = tix.n_rows - tix.n
    assert n_extras and all(ex == min(c_in, 1 << max(
        n_extras * qmax - 1, 1).bit_length())
        for (_c, ex, _l), c_in in zip(pl.hops, (c0,) + tuple(caps[1:])))


@pytest.mark.parametrize("K", [1, 8, 2048])
@pytest.mark.parametrize("steps", [1, 3, 4])
def test_adaptive_plan_passes_the_c_entrys_checks(ells, K, steps):
    _jix, tix, _tables = ells
    R1 = tix.n_rows + 1
    R1w = (R1 + 31) // 32
    pl = ell_ops._adaptive_plan(R1, K, steps - 1)
    state = 2 * (ell_ops.COMPACT_HEAD + -(-R1w // ell_ops.COMPACT_CHUNK))
    spans = [(0, ell_ops.CTL_WORDS), (pl.state, R1w), (pl.cand, R1w),
             (pl.scan, state), (pl.fr, K), (pl.lanes, 2 * R1)]
    assert pl.state == ell_ops.CTL_WORDS and pl.scan % 2 == 0
    assert pl.scan + state == pl.zero == pl.fr    # the look-back state
    assert all(a + n <= b for (a, n), (b, _m) in zip(spans, spans[1:]))
    assert pl.lanes + 2 * R1 == pl.words
    assert list(pl.arr) == [steps - 1, K, pl.state, pl.cand, pl.scan,
                            pl.fr, pl.lanes, pl.zero, pl.words]


# ======================================================= the programs
# (c0, starts, nq, cap, steps, qmax): a roomy batch, one whose caps
# overflow, one whose starts sit on the hubs (their extra rows pushed)
BATCHES = {
    "roomy": (256, 24, 7, 1 << 12, 3, TWO_ARRAY_QMAX),
    "tight": (64, 48, 7, 64, 3, PACK32_QMAX),
    "hubs": (64, 0, 3, 1 << 12, 4, PACK32_QMAX),
}


def _batch(rng, tix, name):
    c0, S, nq, cap, steps, qmax = BATCHES[name]
    if name == "hubs":
        ids = np.full(c0, tix.n_rows, np.int32)
        qid = np.zeros(c0, np.int32)
        hubs = np.sort(tix.perm[[5, 9]])
        ids[:3], qid[:3] = [hubs[0], hubs[1], hubs[0]], [0, 1, 2]
        o = np.lexsort((ids[:3], qid[:3]))
        ids[:3], qid[:3] = ids[:3][o], qid[:3][o]
    else:
        ids, qid = _starts(rng, tix, c0, S, nq)
    caps = sparse_caps(c0, 8, steps, cap)
    return ids, qid, nq, caps, steps, qmax


@pytest.mark.parametrize("batch", list(BATCHES))
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("over", [(1,), (-1, 1, 2)])
def test_sparse_program_steps_match_jax(ells, batch, form, over):
    jix, tix, tables = ells
    rng = np.random.default_rng(len(batch) * 5 + len(form) + len(over))
    ids, qid, nq, caps, steps, qmax = _batch(rng, tix, batch)
    deg = _deg(rng, tix)
    kw = dict(FORMS[form])
    if kw.get("count"):
        qmax = PACK32_QMAX              # no pair layout: a short tail
    want = _jax_sparse(jix, ids, qid, deg, over, steps, caps, qmax, **kw)
    got = _steps(tix, tables, ids, qid, deg, over, steps, caps, qmax, nq,
                  **kw)
    _same(want, got)
    assert bool(want[1]) == (batch == "tight")
    ecnt, e0 = tix.hub_expansion()
    plain = ell_ops.sparse_go(_t(ids), _t(qid), _t(ecnt), _t(e0), _t(deg),
                              tables, over, steps, caps, qmax, nq,
                              **kw).numpy()
    _same(want, plain)


@pytest.mark.parametrize("form", list(FORMS))
def test_two_calls_in_a_row_leak_nothing(ells, form, noisy_empty):
    """A wide overflowing UPTO batch first, then the batch under test, on
    workspaces handed out full of garbage: the second call equals the
    JAX kernel, so it read only what it wrote or cleared."""
    jix, tix, tables = ells
    rng = np.random.default_rng(41)
    deg = _deg(rng, tix)
    ids0, qid0, nq0, caps0, steps0, _q = _batch(rng, tix, "tight")
    _steps(tix, tables, ids0, qid0, deg, (-1, 1, 2), steps0, caps0,
            PACK32_QMAX, nq0, upto=True)
    ids, qid, nq, caps, steps, qmax = _batch(rng, tix, "roomy")
    kw = dict(FORMS[form])
    if kw.get("count"):
        qmax = PACK32_QMAX
    want = _jax_sparse(jix, ids, qid, deg, (1,), steps, caps, qmax, **kw)
    for _ in range(2):
        got = _steps(tix, tables, ids, qid, deg, (1,), steps, caps, qmax,
                      nq, **kw)
        _same(want, got)
        assert not want[1]


def test_two_threads_on_the_same_tables_get_their_own_answers(ells):
    """Two threads call ``sparse_go`` and its step sequence at once on the same
    tables and descriptor-cached OVER set, each its own batches."""
    jix, tix, tables = ells
    rng = np.random.default_rng(43)
    deg = _deg(rng, tix)
    jobs = []
    for k in range(2):
        ids, qid, nq, caps, steps, qmax = _batch(rng, tix, "roomy")
        kw = dict(FORMS[("limit", "count")[k]])
        qmax = PACK32_QMAX
        want = _jax_sparse(jix, ids, qid, deg, (1,), steps, caps, qmax,
                           **kw)
        jobs.append((ids, qid, nq, caps, steps, qmax, kw, want))
    ecnt, e0 = tix.hub_expansion()
    got = [[], []]
    errors = []
    start = threading.Barrier(2)

    def work(k):
        ids, qid, nq, caps, steps, qmax, kw, _w = jobs[k]
        try:
            start.wait()
            for _ in range(4):
                got[k].append(_steps(tix, tables, ids, qid, deg, (1,),
                                      steps, caps, qmax, nq, **kw))
                got[k].append(ell_ops.sparse_go(
                    _t(ids), _t(qid), _t(ecnt), _t(e0), _t(deg), tables,
                    (1,), steps, caps, qmax, nq, **kw).numpy())
        except Exception as ex:         # noqa: BLE001 — raised below
            errors.append(ex)
    pool = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    assert not errors, errors
    for k in range(2):
        assert len(got[k]) == 8
        for g in got[k]:
            _same(jobs[k][-1], g)


def test_the_runtime_uploads_the_starts_once(ells):
    """``_launch_sparse`` sends a batch's ids and qids as one [2, c0]
    upload (the tables, hub expansion and degrees are cached per
    mirror), and its answer is the dense route's."""
    es, ed, ee, n = _graph(seed=5)
    keep = ee > 0
    m = mirror_from_edges(es[keep], ed[keep], 1, space_id=1)
    rt = TorchQueryRuntime(device="cpu")
    try:
        ix = TorchQueryRuntime.ell(m)
        d_all = np.asarray([3, 17, 17, 40, 41], np.int64)
        q_all = np.asarray([0, 0, 1, 1, 2], np.int32)
        args = (m, ix, d_all, q_all, 3, (1,), 3)
        want, _m = rt._launch_dense(*args)()
        rt._launch_sparse(*args, 64)()         # warm the cached uploads
        calls = []
        real = rt._up

        def up(a):
            calls.append(np.asarray(a).shape)
            return real(a)
        rt._up = up
        got, _m = rt._launch_sparse(*args, 64)()
        assert calls == [(2, 64)]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert np.array_equal(np.sort(g), np.sort(w))
    finally:
        rt.close()


# ====================================================== adaptive_go
def _jax_adaptive(jix, starts, over, steps, K):
    kern = jell.make_adaptive_go_kernel(jix, steps, over, K=K)
    return np.asarray(kern(starts, jnp.asarray(jix.hub_table()),
                           *jix.kernel_args()))


def _rows(packed, tix):
    """The adaptive output's real rows and pad row as bools."""
    b = unpack_bits(np.asarray(packed)[:, None], tix.n_rows + 1)[:, 0]
    return np.concatenate([b[:tix.n], b[-1:]])


def _traced_adaptive(tix, tables, jix, starts, over, steps, K):
    """The step sequence with recording wrappers: (output, the hop at which the
    mode first turned dense or None, the layout changes made as
    (to_lanes, hop), the hops the dense arm ran)."""
    eslot, hrows = jix.hub_merge()
    hub = _t(jix.hub_table().astype(np.uint8))
    seen = dict(hop=-1, first=None, lanes=[], dense=[])

    def switch(fr, hub_, n, n_rows, ctl):
        seen["hop"] += 1
        out = ell_ops.adaptive_switch(fr, hub_, n, n_rows, ctl)
        if seen["first"] is None and \
                int(ctl[ell_ops.CTL_MODE]) == ell_ops.MODE_DENSE:
            seen["first"] = seen["hop"]
        return out

    def lanes(to, bits, lanes_, R1):
        seen["lanes"].append((bool(to), seen["hop"]))
        return ell_ops.bitmap_lanes(to, bits, lanes_, R1)

    def hop(*a):
        seen["dense"].append(seen["hop"])
        return ell_ops.go_hop(*a)
    out = ell_ops._adaptive_steps(
        _t(starts), hub, tables, _t(eslot), _t(hrows), over, steps, K,
        ell_ops.sparse_expand, ell_ops.pair_compact, switch, lanes, hop)
    return out.numpy(), seen


# (old start ids, K), over OVER (1,) at 4 steps: a hub start (9) and a
# start whose list passes K = 1 at once turn dense at the first hop;
# starts whose first hop passes K at the second; 56 at the third (a hub
# enters its list); 17 stays sparse throughout
ADAPTIVE = [("hub", [9], 2048), ("k1", [0], 1), ("k2", [44], 2),
            ("k8", [120, 3], 8), ("late", [56], 8), ("sparse", [17], 8),
            ("wide", [17], 2048)]


@pytest.mark.parametrize("case", ADAPTIVE, ids=[c[0] for c in ADAPTIVE])
@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("over", [(1,), (-1, 1, 2)])
def test_adaptive_steps_match_jax(ells, case, steps, over):
    """Every hop of both arms in ``ad_program``'s order: the output is
    the reference's; the layout change to lanes runs once, at the hop
    where the mode first turns dense, the dense arm on that hop and every
    later one, and the change back once, last."""
    jix, tix, tables = ells
    _name, olds, K = case
    starts = jix.perm[np.asarray(olds)].astype(np.int32)
    want = _jax_adaptive(jix, starts, over, steps, K)
    got, seen = _traced_adaptive(tix, tables, jix, starts, over, steps, K)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(_rows(got, tix), _rows(want, tix))
    first = seen["first"]
    if first is None:
        assert seen["lanes"] == [] and seen["dense"] == []
    else:
        assert seen["lanes"] == [(True, first), (False, steps - 2)]
        assert seen["dense"] == list(range(first, steps - 1))
    eslot, hrows = jix.hub_merge()
    plain = ell_ops.adaptive_go(_t(starts),
                                _t(jix.hub_table().astype(np.uint8)),
                                tables, _t(eslot), _t(hrows), over, steps,
                                K).numpy()
    assert np.array_equal(_rows(plain, tix), _rows(want, tix))


def test_adaptive_mode_turns_dense_at_every_hop(ells):
    """The cases above reach the dense arm at the first, second and third
    hop, and one stays sparse throughout (4 steps, OVER 1)."""
    jix, tix, tables = ells
    firsts = set()
    for _name, olds, K in ADAPTIVE:
        starts = jix.perm[np.asarray(olds)].astype(np.int32)
        _got, seen = _traced_adaptive(tix, tables, jix, starts, (1,), 4, K)
        firsts.add(seen["first"])
    assert firsts == {0, 1, 2, None}


@pytest.mark.parametrize("case", ADAPTIVE, ids=[c[0] for c in ADAPTIVE])
@pytest.mark.parametrize("steps", [1, 2, 4])
def test_adaptive_go_tallies_the_calls_that_turn_dense(ells, case, steps):
    """``adaptive_dense_tally`` gains one for a call that runs a dense
    hop, at whichever hop it turns dense, and nothing for one that stays
    sparse (or runs no hop)."""
    jix, tix, tables = ells
    _name, olds, K = case
    starts = jix.perm[np.asarray(olds)].astype(np.int32)
    _got, seen = _traced_adaptive(tix, tables, jix, starts, (1,), steps, K)
    eslot, hrows = jix.hub_merge()
    tally = ell_ops.adaptive_dense_tally(torch.device("cpu"))
    tally.zero_()
    for _ in range(2):
        ell_ops.adaptive_go(_t(starts), _t(jix.hub_table().astype(np.uint8)),
                            tables, _t(eslot), _t(hrows), (1,), steps, K)
    assert int(tally[0]) == (0 if seen["first"] is None else 2)


def test_adaptive_steps_read_no_stale_workspace(ells, noisy_empty):
    """Two adaptive calls in a row on garbage-filled workspaces, the
    first turning dense, the second staying sparse: both the
    reference's."""
    jix, tix, tables = ells
    for olds, K in (([0], 1), ([17], 2048)):
        starts = jix.perm[np.asarray(olds)].astype(np.int32)
        want = _jax_adaptive(jix, starts, (1,), 4, K)
        got, _seen = _traced_adaptive(tix, tables, jix, starts, (1,), 4, K)
        assert np.array_equal(_rows(got, tix), _rows(want, tix))


def test_switch_marks_the_first_dense_hop_only(ells):
    """K7's CTL_CONV: 1 at the hop where the mode first turns dense (from
    the start or from a sparse hop), 0 on every other."""
    _jix, tix, _tables = ells
    table = tix.hub_table()
    hub = _t(table.astype(np.uint8))
    fr = torch.full((4,), tix.n_rows, dtype=torch.int32)
    fr[0] = int(tix.perm[np.nonzero(~table[:tix.n])[0][0]])
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ctl[ell_ops.CTL_SPARSE] = 1
    conv = []
    for cnt in (0, 5, 0, 9):                # sparse, dense, dense, dense
        ctl[ell_ops.CTL_CNT] = cnt
        ell_ops.adaptive_switch(fr, hub, tix.n, tix.n_rows, ctl)
        conv.append(int(ctl[ell_ops.CTL_CONV]))
    assert conv == [0, 1, 0, 0]
    fresh = torch.zeros_like(ctl)
    fresh[ell_ops.CTL_SPARSE] = 1
    fr[1] = int(tix.perm[5])                 # a hub at the first hop
    ell_ops.adaptive_switch(fr, hub, tix.n, tix.n_rows, fresh)
    assert int(fresh[ell_ops.CTL_CONV]) == 1


# ================================================= K5's look-back state
def _spy_compact(seen):
    """``pair_compact`` that records the look-back state each call was
    given, as it was before the call."""
    def compact(*args):
        scan = args[12]
        seen.append((scan.data_ptr(), scan.numel(), scan.clone()))
        return ell_ops.pair_compact(*args)
    return compact


@pytest.mark.parametrize("form", list(FORMS))
def test_every_k5_call_of_a_program_shares_its_cleared_state(ells, form,
                                                             noisy_empty):
    """On a workspace handed out full of garbage, every K5 call of the
    sparse program gets the same look-back state, the one of the plan
    (inside the cleared prefix, a descriptor a chunk of the largest
    bitmap), all zero at the first call; the output is the reference's."""
    jix, tix, tables = ells
    rng = np.random.default_rng(47)
    deg = _deg(rng, tix)
    ids, qid, nq, caps, steps, qmax = _batch(rng, tix, "roomy")
    kw = dict(FORMS[form])
    if kw.get("count"):
        qmax = PACK32_QMAX
    seen = []
    ecnt, e0 = tix.hub_expansion()
    got = ell_ops._sparse_go_steps(
        _t(ids), _t(qid), _t(ecnt), _t(e0), _t(deg), tables, (1,), steps,
        caps, qmax, nq, kw.get("upto", False), kw.get("limit"),
        kw.get("count", False), ell_ops.sparse_expand, _spy_compact(seen),
        ell_ops.pair_reduce).numpy()
    _same(_jax_sparse(jix, ids, qid, deg, (1,), steps, caps, qmax, **kw),
          got)
    words = nq * ((tix.n_rows + 32) // 32)
    assert len(seen) == steps - 1 + (1 if kw.get("upto") else 0)
    assert len({p for p, _n, _s in seen}) == 1
    assert {n for _p, n, _s in seen} == {ell_ops.compact_state_words(words)}
    assert not bool(seen[0][2].any())


@pytest.mark.parametrize("case", ADAPTIVE, ids=[c[0] for c in ADAPTIVE])
def test_every_adaptive_k5_call_shares_its_cleared_state(ells, case,
                                                         noisy_empty):
    """The adaptive program's sparse hops hand K5 one look-back state,
    all zero at the first, on a workspace full of garbage."""
    jix, tix, tables = ells
    _name, olds, K = case
    starts = jix.perm[np.asarray(olds)].astype(np.int32)
    eslot, hrows = jix.hub_merge()
    seen = []
    got = ell_ops._adaptive_steps(
        _t(starts), _t(jix.hub_table().astype(np.uint8)), tables, _t(eslot),
        _t(hrows), (1,), 4, K, ell_ops.sparse_expand, _spy_compact(seen),
        ell_ops.adaptive_switch, ell_ops.bitmap_lanes, ell_ops.go_hop)
    want = _jax_adaptive(jix, starts, (1,), 4, K)
    assert np.array_equal(_rows(got.numpy(), tix), _rows(want, tix))
    R1w = (tix.n_rows + 32) // 32
    assert len({p for p, _n, _s in seen}) <= 1
    assert all(n == ell_ops.compact_state_words(R1w) for _p, n, _s in seen)
    assert not seen or not bool(seen[0][2].any())


@pytest.mark.parametrize("words", [1, 2047, 2048, 2049, 1 << 20,
                                   (1 << 20) + 5])
def test_compact_state_has_a_descriptor_a_chunk(words):
    """K5's state: the head, then a descriptor for each chunk of
    COMPACT_CHUNK words, which also covers the doubled chunks the kernel
    takes on a bitmap of 2^20 words or more."""
    n = ell_ops.compact_state_words(words)
    assert n == ell_ops.COMPACT_HEAD + -(-words // ell_ops.COMPACT_CHUNK)
    chunk = ell_ops.compact_chunk(words)
    assert chunk == ell_ops.COMPACT_CHUNK * (2 if words >= 1 << 20 else 1)
    assert n - ell_ops.COMPACT_HEAD >= -(-words // chunk)


@pytest.mark.parametrize("mode", [ell_ops.MODE_SPARSE, ell_ops.MODE_DENSE])
def test_gated_compact_runs_only_in_its_mode(mode):
    """K5 with the adaptive program's gate: the mode word holding the
    sparse mode, it is the ungated K5; else it touches nothing."""
    rng = np.random.default_rng(mode)
    R1w, K = 9, 16
    bits = torch.from_numpy(rng.integers(0, 2**31, R1w, dtype=np.int64)
                            .astype(np.int32) & 0x01010101)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64)
    ctl[ell_ops.CTL_MODE] = mode
    gate = ctl[ell_ops.CTL_MODE:ell_ops.CTL_MODE + 1]
    outs = []
    for g in (gate, None):
        mark, state = bits.clone(), torch.full((R1w,), 7, dtype=torch.int32)
        fr = torch.full((K,), -3, dtype=torch.int32)
        c = ctl.clone()
        ell_ops.pair_compact(mark, R1w, K, fr, None, c, -1, 999, None, state,
                             True, 0, None,
                             None if g is None else c[ell_ops.CTL_MODE:
                                                      ell_ops.CTL_MODE + 1],
                             ell_ops.MODE_SPARSE)
        outs.append((mark, state, fr, c))
    gated, plain = outs
    if mode == ell_ops.MODE_SPARSE:
        assert all(torch.equal(a, b) for a, b in zip(gated, plain))
        assert int(plain[3][ell_ops.CTL_CNT]) > 0
    else:
        assert torch.equal(gated[0], bits) and bool((gated[1] == 7).all())
        assert bool((gated[2] == -3).all()) and torch.equal(gated[3], ctl)


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_dedup_takes_k5_state_from_the_zeroed_card_work(ells, k):
    """The frontier-sharded GO hands every hop's ``mesh_dedup`` its card
    group's look-back state, one slab of the group's zeroed working
    buffer ([members, compact_state_words(words)], zero at the first
    hop); the result equals the plain program's."""
    from nebula_tpu_torch.tpu.ell import (build_sharded_ell, sharded_tables,
                                          split_start_pairs_by_owner)
    from nebula_tpu_torch.tpu.mesh import PartsMesh
    _jix, tix, _tables = ells
    st = sharded_tables(build_sharded_ell(tix, k),
                        PartsMesh([torch.device("cpu")] * k))
    rng = np.random.default_rng(k)
    nq = 5
    rows = tix.perm[rng.integers(0, tix.n, nq)].astype(np.int32)
    placed = split_start_pairs_by_owner(st, rows, np.arange(nq,
                                                            dtype=np.int32),
                                        64)
    ids, qid = (st.mesh.split(torch.from_numpy(a)) for a in placed[:2])
    caps = sparse_caps(64, 8, 3, 1 << 12)
    seen = []

    def dedup(*args):
        scan = args[11]
        seen.append((scan.data_ptr(), tuple(scan.shape), scan.clone()))
        return ell_ops.mesh_dedup(*args)
    (got,), _x, _c = ell_ops._mesh_go_steps(
        ids, qid, st, (1,), 3, caps, 4096, 256, nq, ell_ops.mesh_route_card,
        dedup, (ell_ops.mesh_agree, ell_ops.or_many), ell_ops.mesh_emit)
    (want,) = ell_ops.mesh_sparse_go_ref(ids, qid, st, (1,), 3, caps, 4096,
                                         256, nq)
    assert torch.equal(got, want)
    words = nq * ((st.chunk + 31) // 32)
    assert len(seen) == 2 and len({p for p, _s, _c in seen}) == 1
    assert seen[0][1] == (k, ell_ops.compact_state_words(words))
    assert not bool(seen[0][2].any())
