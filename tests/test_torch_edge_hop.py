"""K8 ``edge_hop`` as a walk over the mirror's CSR rows
(nebula_tpu_torch/tpu/edge_ops.py) against the JAX hop it replaces,
``_go_body``'s scatter-max over every edge (nebula_tpu/tpu/kernels.py
:264-281), through ``make_go_kernel`` (``:284``),
``make_go_filtered_kernel`` (``:296``) and ``make_bfs_kernel``
(``:315``) on CPU jax; the port on CPU torch (the plain route, the
CSR walk).

Seeded mirror-shaped graphs (both directions, signed etypes 1 and 2,
rows sorted by source with their ``row_ptr``), one with a hub whose row
is longer than a tile of the kernel's sources: frontiers empty, sparse,
every vertex and the hub alone; start lists with -1 padding, ids out of
range and repeated ids (the first hop of a program reads the list
itself); forward and REVERSELY, one and two OVER etypes; a mirror after
an absorbed write window.  Every comparison is exact.  Then the plain
hop's refusal of an edge list that ``row_ptr`` does not index, the
mirrors' CSR invariant, and the blob path's COUNT with a LIMIT, which
declines.
"""
import numpy as np
import pytest
import torch

from nebula_tpu.filter import expressions as rex
from nebula_tpu.interface.common import SupportedType as RT
from nebula_tpu.tpu import csr as rcsr
from nebula_tpu.tpu import expr_compile as rec
from nebula_tpu.tpu import kernels as jk
from nebula_tpu.tpu.runtime import TpuQueryRuntime, _GoPlan
from nebula_tpu_torch.common.flags import flags as pflags
from nebula_tpu_torch.filter import expressions as pex
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.storage.device import TpuDecline
from nebula_tpu_torch.tpu import csr as pcsr
from nebula_tpu_torch.tpu import edge_ops
from nebula_tpu_torch.tpu import expr_compile as pec
from nebula_tpu_torch.tpu import expr_program as ep
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime, _pad_pow2

from test_torch_absorb import FLAGS, SPACE, Side

N = 260
HUB, HUB_EDGES = 7, 2600         # a row longer than a 1024-source tile
OVER_SETS = [(1,), (-1,), (1, 2), (-2, -1)]
INF = 2**31 - 1


def _row_ptr(es, n):
    return np.concatenate([[0], np.cumsum(np.bincount(
        es, minlength=n))]).astype(np.int32)


def _graph(seed=11, n=N, k=1400):
    """Sorted mirror edge arrays (src, dst, etype) in both directions and
    their row_ptr: vertex HUB has HUB_EDGES forward edges, vertex 9 is
    an in-hub, vertices 250.. have no edges."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 250, k)
    dst = rng.integers(0, 250, k)
    src = np.concatenate([src, np.full(HUB_EDGES, HUB)])
    dst = np.concatenate([dst, rng.integers(0, 250, HUB_EDGES)])
    dst[100:160] = 9
    keep = src != dst
    src, dst = src[keep], dst[keep]
    et = rng.integers(1, 3, len(src))
    es = np.concatenate([src, dst])
    ed = np.concatenate([dst, src])
    ee = np.concatenate([et, -et])
    order = np.lexsort((ed, ee, es))
    es, ed, ee = (a[order].astype(np.int32) for a in (es, ed, ee))
    return es, ed, ee, _row_ptr(es, n)


@pytest.fixture(scope="module")
def graph():
    arrays = _graph()
    return arrays, [torch.from_numpy(a.copy()) for a in arrays]


def _jax_hop(arrays, idx, over, n=N):
    """The reference's hop from ``bitmap_from_idx(idx)``: the frontier
    of its 2-step GO."""
    es, ed, ee, _rp = arrays
    return np.asarray(jk.make_go_kernel(n, 2, over)(es, ed, ee, idx)[1])


def _frontier(case, rng):
    f = np.zeros(N, bool)
    if case == "sparse":
        f[rng.integers(0, N, 12)] = True
    elif case == "all":
        f[:] = True
    elif case == "hub":
        f[HUB] = True
    return f


@pytest.mark.parametrize("over", OVER_SETS)
@pytest.mark.parametrize("case", ["empty", "sparse", "all", "hub"])
def test_hop_from_a_frontier_matches_jax(graph, case, over):
    arrays, (ts, td, te, trp) = graph
    f = _frontier(case, np.random.default_rng(len(over)))
    want = _jax_hop(arrays, _pad_pow2(np.nonzero(f)[0].astype(np.int32)),
                    over)
    out = torch.ones(N, dtype=torch.bool)
    got = edge_ops.edge_hop(torch.from_numpy(f), out, ts, td, te, trp, over)
    assert got is out
    assert np.array_equal(out.numpy(), want)
    if case == "empty":
        assert not out.any()


STARTS = {
    "padded": [3, 40, -1, -1, -1, -1, -1, -1],
    "out_of_range": [N, N + 5, -7, 12, 2**31 - 1, -1, -1, -1],
    "repeated": [HUB, HUB, 12, 12, HUB, 30, 30, -1],
    "all_padding": [-1] * 8,
    "hub_and_idle": [HUB, 255, 259, -1],
}


@pytest.mark.parametrize("over", OVER_SETS)
@pytest.mark.parametrize("case", sorted(STARTS))
def test_hop_from_a_start_list_matches_jax(graph, case, over):
    """A program's first hop reads the -1-padded start list itself:
    ids outside [0, n) are dropped and a repeated id changes nothing,
    as ``bitmap_from_idx`` makes the reference's start frontier."""
    arrays, (ts, td, te, trp) = graph
    idx = np.asarray(STARTS[case], np.int32)
    want = _jax_hop(arrays, idx, over)
    out = torch.empty(N, dtype=torch.bool)
    edge_ops.edge_hop(torch.from_numpy(idx), out, ts, td, te, trp, over)
    assert np.array_equal(out.numpy(), want)
    seeded = edge_ops.edge_seed(torch.empty(N, dtype=torch.bool),
                                torch.from_numpy(idx))
    assert np.array_equal(seeded.numpy(), np.asarray(
        jk.bitmap_from_idx(idx, N)))


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("over", OVER_SETS)
def test_go_from_the_hub_matches_jax(graph, steps, over):
    arrays, (ts, td, te, trp) = graph
    es, ed, ee, _rp = arrays
    idx = np.asarray(STARTS["repeated"], np.int32)
    want_f, want_fr = jk.make_go_kernel(N, steps, over)(es, ed, ee, idx)
    got_f, got_fr = edge_ops.go(ts, td, te, trp, torch.from_numpy(idx), N,
                                steps, over)
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_fr.numpy(), np.asarray(want_fr))


@pytest.mark.parametrize("over", OVER_SETS)
@pytest.mark.parametrize("stop", [True, False])
def test_bfs_from_the_hub_matches_jax(graph, over, stop):
    arrays, (ts, td, te, trp) = graph
    es, ed, ee, _rp = arrays
    start = np.asarray([HUB, N + 1, -1, -1], np.int32)
    for target in ([9, -1, -1, -1], [255, 30, -1, -1], [-1] * 4):
        target = np.asarray(target, np.int32)
        want = jk.make_bfs_kernel(N, 5, over, stop)(es, ed, ee, start,
                                                    target)
        got, levels = edge_ops.bfs(ts, td, te, trp, torch.from_numpy(start),
                                   torch.from_numpy(target), N, 5, over,
                                   stop_when_found=stop)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert 0 <= levels <= 5


class _Names:
    def to_tag_id(self, space_id, name):
        from nebula_tpu.common.status import StatusOr
        return StatusOr.of(7)


WHERE = ["logic", "&&", ["rel", ">", ["edge", "e", "w"], ["lit", 20]],
         ["rel", "<", ["dst", "person", "age"], ["lit", 60]]]


@pytest.mark.parametrize("steps", [2, 3])
@pytest.mark.parametrize("reverse", [False, True])
def test_go_filtered_from_the_hub_matches_jax(graph, steps, reverse):
    """The reference's fused program (``_run_go_kernel`` around
    ``make_go_filtered_kernel``) against ``go_filtered`` through the
    port runtime's own ``_run_go_kernel`` (its uploaded row_ptr)."""
    arrays, _t = graph
    es, ed, ee, rp = arrays
    rng = np.random.default_rng(5)
    m = rcsr.CsrMirror(1)
    m.vids = np.arange(N, dtype=np.int64) * 3 + 1
    m.n, m.m = N, len(es)
    m.edge_src, m.edge_dst, m.edge_etype = es, ed, ee
    m.edge_rank = np.zeros(m.m, np.int64)
    m.row_ptr = rp
    for et in (-2, -1, 1, 2):
        c = rcsr.Column("w", RT.INT, m.m)
        c.values[:] = rng.integers(0, 50, m.m)
        c.valid[:] = rng.random(m.m) < 0.9
        c.finalize()
        m.edge_cols[(et, "w")] = c
    c = rcsr.Column("age", RT.INT, N)
    c.values[:] = rng.integers(0, 90, N)
    c.valid[:] = True
    c.finalize()
    m.vertex_cols[(7, "age")] = c
    pm = pcsr.mirror_from_reference(
        {f: getattr(m, f) for f in pcsr.MIRROR_FIELDS}, space_id=1,
        edge_cols=m.edge_cols, vertex_cols=m.vertex_cols)
    et = -1 if reverse else 1
    alias = {"e": et}
    rcomp = rec.ExprCompiler(m, 1, _Names(), alias)
    rcv = rcomp.compile(rex._from_wire(WHERE))
    plan = _GoPlan(m, alias, rcv, dict(rcomp.used), True, rcomp,
                   f"{WHERE}{reverse}", False)
    start = np.asarray(STARTS["repeated"], np.int32)
    want_f, want_fr = TpuQueryRuntime([], _Names())._run_go_kernel(
        m, 1, steps, (et,), plan, start)

    rt = TorchQueryRuntime(device="cpu")
    try:
        rt.load_space(1, pm, SchemaView().add_space(1, {"person": 7},
                                                    {"e": 1}))
        pplan = rt._plan_go(1, alias, pex._from_wire(WHERE), True)
        got_f, got_fr = rt._run_go_kernel(pm, 1, steps, (et,), pplan, start)
    finally:
        rt.close()
    assert np.array_equal(got_fr.numpy(), np.asarray(want_fr))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f.any()


def test_hop_on_an_absorbed_mirror_matches_jax():
    """A mirror after a write window folded in by ``absorb_overlay``
    keeps its rows sorted with a matching row_ptr, and the walk over it
    equals the reference's hop on its arrays."""
    saved = {k: pflags.get(k) for k in FLAGS}
    for k, v in FLAGS.items():
        pflags.set(k, v)
    side = Side(True)
    try:
        rng = np.random.default_rng(2)
        side.edges([(v, v % 48 + 1, 0, 5) for v in range(1, 49)]
                   + [(3, int(d), 1, 7) for d in rng.integers(1, 49, 20)])
        side.go([1], 2)                     # the first fold
        side.edges([(int(s), int(d), 9, 1)
                    for s, d in rng.integers(1, 49, (6, 2))])
        side.delete([(5, 6, 0), (3, 4, 0)])
        side.go([1], 2)                     # absorbs the window
        assert side.rt.stats["mirror_absorbs"] >= 1
        m = side.rt.mirror(SPACE)
        pcsr.check_rows(m)
        arrays = (m.edge_src, m.edge_dst, m.edge_etype, m.row_ptr)
        tensors = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                   for a in arrays]
        for over in ((1,), (-1,), (1, -1)):
            for idx in ([0, 2, -1, -1], list(range(m.n)) + [-1]):
                idx = np.asarray(idx, np.int32)
                out = torch.empty(m.n, dtype=torch.bool)
                edge_ops.edge_hop(torch.from_numpy(idx), out, *tensors, over)
                assert np.array_equal(out.numpy(),
                                      _jax_hop(arrays, idx, over, m.n))
    finally:
        side.close()
        for k, v in saved.items():
            pflags.set(k, v)


def test_plain_hop_refuses_an_edge_list_row_ptr_does_not_index(graph):
    arrays, (ts, td, te, trp) = graph
    f = torch.zeros(N, dtype=torch.bool)
    f[HUB] = True
    out = torch.empty(N, dtype=torch.bool)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(len(ts)))
    with pytest.raises(ValueError, match="sorted"):
        edge_ops.edge_hop(f, out, ts[perm], td[perm], te[perm], trp, (1,))
    bad = trp.clone()
    bad[5] += 1                         # rows 4 and 5 disagree with src
    with pytest.raises(ValueError, match="sorted"):
        edge_ops.edge_hop(f, out, ts, td, te, bad, (1,))
    bad = trp.clone()
    bad[-1] -= 1                        # does not end at m
    with pytest.raises(ValueError, match="row index"):
        edge_ops.edge_hop(f, out, ts, td, te, bad, (1,))
    bad = trp.clone()
    bad[3], bad[4] = trp[4], trp[3] - 1  # falls
    with pytest.raises(ValueError):
        edge_ops.edge_hop(f, out, ts, td, te, bad, (1,))
    with pytest.raises(ValueError):       # row_ptr of another length
        edge_ops.edge_hop(f, out, ts, td, te, trp[:-1], (1,))
    with pytest.raises(ValueError):       # a 2-D source list
        edge_ops.edge_hop(torch.zeros((2, 4), dtype=torch.int32), out, ts,
                          td, te, trp, (1,))
    with pytest.raises(ValueError):
        edge_ops.go(ts[perm], td[perm], te[perm], trp,
                    torch.tensor([HUB, -1], dtype=torch.int32), N, 2, (1,))


def test_mirrors_keep_rows_sorted_with_row_ptr(graph):
    """``mirror_from_edges`` (what ``build_mirror`` folds) keeps the CSR
    invariant; ``mirror_from_reference`` refuses arrays that break it."""
    rng = np.random.default_rng(4)
    src, dst = rng.integers(1, 90, 400), rng.integers(1, 90, 400)
    m = pcsr.mirror_from_edges(src, dst, 2, rank=rng.integers(0, 3, 400))
    pcsr.check_rows(m)
    arrays, _t = graph
    es, ed, ee, rp = arrays
    fields = {"vids": np.arange(N, dtype=np.int64), "edge_src": es,
              "edge_dst": ed, "edge_etype": ee,
              "edge_rank": np.zeros(len(es), np.int64), "row_ptr": rp}
    pcsr.check_rows(pcsr.mirror_from_reference(fields, space_id=1))
    swapped = dict(fields, edge_src=es[::-1].copy())
    with pytest.raises(ValueError, match="sorted"):
        pcsr.mirror_from_reference(swapped, space_id=1)
    with pytest.raises(ValueError, match="row index"):
        pcsr.mirror_from_reference(dict(fields, row_ptr=rp * 0), space_id=1)


def test_blob_path_declines_count_with_limit():
    """``serve_go``'s blob branch declines a COUNT that comes with a
    LIMIT, as the plain branch does (the reference's pushed LIMIT is a
    reduction of its own, never beside a COUNT)."""
    m = pcsr.mirror_from_edges(np.arange(1, 31), np.arange(2, 32), 1,
                               space_id=3)
    rt = TorchQueryRuntime(device="cpu")
    try:
        rt.load_space(3, m, SchemaView().add_space(3, {}, {"e": 1}))
        base = dict(space_id=3, start_vids=[1], etypes=[1], steps=2,
                    etype_to_alias={1: "e"}, reduce=("count",), limit=3)
        ydst = [(pex.encode_expr(pex._from_wire(["e_dst", "e"])), None)]
        where = pex.encode_expr(pex._from_wire(
            ["rel", ">", ["e_dst", "e"], ["lit", 0]]))
        for extra in ({}, {"yield_specs": ydst},
                      {"yield_specs": ydst, "where_blob": where}):
            with pytest.raises(TpuDecline, match="LIMIT"):
                rt.serve_go(**base, **extra)
    finally:
        rt.close()
