"""The edge-list programs (nebula_tpu_torch/tpu/edge_ops.py) against the
JAX kernel factories they replace: ``make_go_kernel``
(nebula_tpu/tpu/kernels.py:284), ``make_go_filtered_kernel`` (``:296``)
and ``make_bfs_kernel`` (``:315``, both ``stop_when_found`` modes).

Seeded mirror-shaped graphs (both directions, signed etypes 1 and 2,
hubs, self-loops removed) go through the JAX function on CPU jax and
the port's wrapper on CPU torch (the plain route): 1-4 steps, empty
and -1-padded start lists, forward and REVERSELY, one and two OVER
etypes.  The final edge mask, the frontier and the depths are compared
for exact equality.  ``go_filtered`` fuses a compiled WHERE: the
reference's ``filter_fn`` as ``TpuQueryRuntime._run_go_kernel`` builds
it, the port's lowered ExprProgram.
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
from nebula_tpu_torch.filter import expressions as pex
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.tpu import edge_ops
from nebula_tpu_torch.tpu import expr_compile as pec
from nebula_tpu_torch.tpu import expr_program as ep
from nebula_tpu_torch.tpu.csr import MIRROR_FIELDS, mirror_from_reference
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime, _pad_pow2

N = 220
OVER_SETS = [(1,), (-1,), (1, 2), (-2, -1)]
INF = 2**31 - 1


def _graph(seed=5, n=N, k=700):
    """Sorted mirror edge arrays (src, dst, etype, rank) in both
    directions; vertex 3 is an out-hub, 4 an in-hub, the graph is
    sparse enough that BFS runs several levels."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, k)
    dst = rng.integers(0, n, k)
    src[:80] = 3
    dst[80:140] = 4
    keep = src != dst
    src, dst = src[keep], dst[keep]
    et = rng.integers(1, 3, len(src))
    es = np.concatenate([src, dst])
    ed = np.concatenate([dst, src])
    ee = np.concatenate([et, -et])
    order = np.lexsort((ed, ee, es))
    return (es[order].astype(np.int32), ed[order].astype(np.int32),
            ee[order].astype(np.int32))


def _row_ptr(es, n=N):
    return np.concatenate([[0], np.cumsum(np.bincount(
        es, minlength=n))]).astype(np.int32)


@pytest.fixture(scope="module")
def graph():
    """(src, dst, etype numpy, their tensors and the CSR row index)."""
    es, ed, ee = _graph()
    return es, ed, ee, [torch.from_numpy(a.copy())
                        for a in (es, ed, ee, _row_ptr(es))]


def _starts(rng, case):
    if case == "empty":
        return _pad_pow2(np.zeros(0, np.int32))
    if case == "hub":
        return _pad_pow2(np.asarray([3], np.int32))
    k = int(rng.integers(1, 12))
    return _pad_pow2(rng.integers(0, N, k).astype(np.int32))


@pytest.mark.parametrize("steps", [1, 2, 3, 4])
@pytest.mark.parametrize("over", OVER_SETS)
@pytest.mark.parametrize("case", ["empty", "hub", "some"])
def test_go_matches_jax(graph, steps, over, case):
    es, ed, ee, (ts, td, te, trp) = graph
    start = _starts(np.random.default_rng(steps * 7 + len(over)), case)
    want_f, want_fr = jk.make_go_kernel(N, steps, over)(es, ed, ee, start)
    got_f, got_fr = edge_ops.go(ts, td, te, trp, torch.from_numpy(start), N,
                                steps, over)
    assert got_f.dtype == torch.bool and got_fr.shape == (N,)
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_fr.numpy(), np.asarray(want_fr))
    if case == "empty":
        assert not got_f.any()


def _mirrors(graph, seed=9):
    """A reference CsrMirror over the graph with int and float edge
    columns (some rows invalid) and a tag, and its port copy."""
    es, ed, ee, _ = graph
    rng = np.random.default_rng(seed)
    m = rcsr.CsrMirror(1)
    m.vids = (np.arange(N, dtype=np.int64) * 5 + 2)
    m.n, m.m = N, len(es)
    m.edge_src, m.edge_dst, m.edge_etype = es, ed, ee
    m.edge_rank = np.zeros(m.m, np.int64)
    m.row_ptr = _row_ptr(es)
    w = rng.integers(0, 50, m.m)
    w[::17] = 0
    score = (rng.integers(0, 64, m.m) / 8.0)
    for et in (-2, -1, 1, 2):
        for name, st, vals in (("w", RT.INT, w), ("score", RT.DOUBLE,
                                                   score)):
            c = rcsr.Column(name, st, m.m)
            c.values[:] = vals
            c.valid[:] = rng.random(m.m) < 0.95
            c.finalize()
            m.edge_cols[(et, name)] = c
    c = rcsr.Column("age", RT.INT, N)
    c.values[:] = rng.integers(0, 90, N)
    c.valid[:] = rng.random(N) < 0.9
    c.finalize()
    m.vertex_cols[(7, "age")] = c
    pm = mirror_from_reference(
        {f: getattr(m, f) for f in MIRROR_FIELDS}, space_id=1,
        edge_cols=m.edge_cols, vertex_cols=m.vertex_cols)
    return m, pm


class _Names:
    def to_tag_id(self, space_id, name):
        from nebula_tpu.common.status import StatusOr
        return StatusOr.of(7)


WHERES = [
    ["rel", ">", ["edge", "e", "w"], ["lit", 20]],
    ["logic", "&&", ["rel", "<=", ["edge", "e", "score"], ["lit", 4.5]],
     ["rel", "!=", ["arith", "%", ["edge", "e", "w"], ["lit", 7]],
      ["lit", 0]]],
    ["rel", ">=", ["arith", "/", ["lit", 100], ["edge", "e", "w"]],
     ["lit", 5]],                                     # a live div guard
    ["rel", "<", ["dst", "person", "age"], ["src", "person", "age"]],
    ["rel", ">", ["e_dst", "e"], ["lit", 500]],
]


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("wi", range(len(WHERES)))
@pytest.mark.parametrize("reverse", [False, True])
def test_go_filtered_matches_jax(graph, steps, wi, reverse):
    """The reference's fused program (``_run_go_kernel``, which builds
    ``make_go_filtered_kernel`` around its filter_fn) against
    ``go_filtered`` on the port's program, in pushed mode."""
    m, pm = _mirrors(graph)
    et = -1 if reverse else 1
    alias = {"e": et}
    tree = WHERES[wi]
    rcomp = rec.ExprCompiler(m, 1, _Names(), alias)
    rcv = rcomp.compile(rex._from_wire(tree))
    plan = _GoPlan(m, alias, rcv, dict(rcomp.used), True, rcomp,
                   f"{tree}{reverse}", False)
    start = _starts(np.random.default_rng(wi + steps), "some")
    ref_rt = TpuQueryRuntime([], _Names())
    want_f, want_fr = ref_rt._run_go_kernel(m, 1, steps, (et,), plan, start)

    port_rt = TorchQueryRuntime(device="cpu")
    port_rt.load_space(1, pm, SchemaView().add_space(1, {"person": 7},
                                                     {"e": 1}))
    pcomp = pec.ExprCompiler(pm, 1, port_rt._schema(1), alias)
    pcv = pcomp.compile(pex._from_wire(tree))
    types = {k: {np.dtype(np.int32): ep.I, np.dtype(np.float32): ep.F,
                 np.dtype(bool): ep.B}[np.dtype(
                     TorchQueryRuntime._col_dtype(pm, d))]
             for k, d in pcomp.used.items()}
    prog = ep.trace_filter(pcv, pcomp.used, pcomp.div_guards, True, types)
    env = port_rt._env_cols(pm, alias, pcomp.used, with_valid=True)
    dev = port_rt._device_csr(pm)
    got_f, got_fr = edge_ops.go_filtered(
        dev["edge_src"], dev["edge_dst"], dev["edge_etype"], dev["row_ptr"],
        torch.from_numpy(start), N, steps, (et,), prog,
        [env[k] for k, _kind, _t in prog.slots])
    port_rt.close()
    assert np.array_equal(got_fr.numpy(), np.asarray(want_fr))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert got_f.any()


@pytest.mark.parametrize("max_steps", [1, 3, 6])
@pytest.mark.parametrize("over", OVER_SETS)
@pytest.mark.parametrize("stop", [True, False])
def test_bfs_matches_jax(graph, max_steps, over, stop):
    es, ed, ee, (ts, td, te, trp) = graph
    rng = np.random.default_rng(max_steps * 3 + len(over))
    start = _pad_pow2(rng.integers(0, N, 2).astype(np.int32))
    for target in (_pad_pow2(rng.integers(0, N, 3).astype(np.int32)),
                   _pad_pow2(np.asarray([4], np.int32)),
                   _pad_pow2(np.zeros(0, np.int32))):
        want = jk.make_bfs_kernel(N, max_steps, over, stop)(
            es, ed, ee, start, target)
        got, levels = edge_ops.bfs(ts, td, te, trp, torch.from_numpy(start),
                                   torch.from_numpy(target), N, max_steps,
                                   over, stop_when_found=stop)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert 0 <= levels <= max_steps
        reached = got.numpy() < INF
        assert reached[start[start >= 0]].all()


def test_bfs_unreachable_pair_stops_when_the_frontier_empties():
    """A start whose component is a single edge: the levels stop when
    nothing new is reached, and the target stays INF."""
    es = np.asarray([0, 1], np.int32)
    ed = np.asarray([1, 0], np.int32)
    ee = np.asarray([1, -1], np.int32)
    start = _pad_pow2(np.asarray([0], np.int32))
    target = _pad_pow2(np.asarray([5], np.int32))
    want = jk.make_bfs_kernel(8, 5, (1, -1), True)(es, ed, ee, start,
                                                   target)
    got, levels = edge_ops.bfs(*(torch.from_numpy(a) for a in (
                                   es, ed, ee, _row_ptr(es, 8))),
                               torch.from_numpy(start),
                               torch.from_numpy(target), 8, 5, (1, -1))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert levels == 2 and got[5] == INF


def test_kernel_wrappers_check_their_operands(graph):
    _es, _ed, _ee, (ts, td, te, trp) = graph
    f = torch.zeros(N, dtype=torch.bool)
    with pytest.raises(ValueError):
        edge_ops.edge_hop(f, f, ts, td, te, trp, (1,))  # in place
    with pytest.raises(TypeError):
        edge_ops.edge_hop(f.to(torch.uint8), torch.zeros_like(f), ts, td,
                          te, trp, (1,))
    with pytest.raises(ValueError):
        edge_ops.edge_final(f, ts, te, (1,), None,
                            torch.zeros(3, dtype=torch.bool))
    with pytest.raises(ValueError):
        edge_ops.edge_hop(f, torch.zeros_like(f), ts, td, te, trp, ())
    with pytest.raises(ValueError):
        edge_ops.edge_bfs_level(f, torch.zeros(N, dtype=torch.int32), None,
                                torch.zeros(2, dtype=torch.int32), 0)
    with pytest.raises(ValueError):
        edge_ops.go(ts, td, te, trp, torch.zeros(8, dtype=torch.int32), N,
                    2, tuple(range(1, 40)))


def test_cpu_route_counts_no_launch(graph):
    """The plain route of every wrapper adds nothing to LAUNCHES (a
    launch is counted only where a kernel is launched)."""
    _es, _ed, _ee, (ts, td, te, trp) = graph
    edge_ops.reset_launches()
    start = torch.from_numpy(_pad_pow2(np.asarray([3], np.int32)))
    edge_ops.go(ts, td, te, trp, start, N, 3, (1,))
    edge_ops.bfs(ts, td, te, trp, start, start, N, 3, (1,))
    assert all(v == 0 for v in edge_ops.LAUNCHES.values())
