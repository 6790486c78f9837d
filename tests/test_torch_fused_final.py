"""``go_filtered``'s fused final pass (nebula_tpu_torch/tpu/edge_ops.py
``edge_final_where``, csrc/edge_go.cu): K9's edge test with the compiled
WHERE evaluated inside it, on the edges that pass the test only, against
the reference's program, which evaluates the WHERE on every edge and
ANDs the mask in (``make_go_filtered_kernel``, nebula_tpu/tpu/
kernels.py:296, built by ``TpuQueryRuntime._run_go_kernel``).

A seeded mirror with int and float edge columns (some rows invalid) and
a tag goes through the JAX program on CPU jax and the port's
``go_filtered`` on CPU torch, for every WHERE of
tests/test_torch_edge_go.py's ``WHERES`` and four more (a mod by zero
guarded, a WHERE that holds nowhere, one that holds on every valid row,
a constant), in pushed and graphd mode, at 1-3 steps, from some starts,
a hub and none (an empty frontier).  The final mask and the frontier
are compared exactly, and the pass itself against ``edge_final_ref``
over ``expr_filter_ref``'s whole mask; the plain pass is shown to run
the program on the kept edges alone.
"""
import numpy as np
import pytest
import torch

from nebula_tpu.filter import expressions as rex
from nebula_tpu.tpu import expr_compile as rec
from nebula_tpu.tpu.runtime import TpuQueryRuntime, _GoPlan
from nebula_tpu_torch.filter import expressions as pex
from nebula_tpu_torch.meta.schema import SchemaView
from nebula_tpu_torch.tpu import edge_ops
from nebula_tpu_torch.tpu import expr_compile as pec
from nebula_tpu_torch.tpu import expr_program as ep
from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime, _pad_pow2
from test_torch_edge_go import N, WHERES, _graph, _mirrors, _Names

W = ["edge", "e", "w"]
CASES = WHERES + [
    ["rel", "==", ["arith", "%", ["lit", 100], W], ["lit", 0]],  # w == 0
    ["rel", "<", W, ["lit", 0]],                        # holds nowhere
    ["rel", ">=", W, ["lit", 0]],                       # every valid row
    ["rel", "==", ["lit", 1], ["lit", 1]],              # a constant
]
NOWHERE, EVERYWHERE, CONSTANT = len(WHERES) + 1, len(WHERES) + 2, \
    len(WHERES) + 3


@pytest.fixture(scope="module")
def world():
    es, ed, ee = _graph()
    graph = (es, ed, ee, None)
    m, pm = _mirrors(graph)
    port_rt = TorchQueryRuntime(device="cpu")
    port_rt.load_space(1, pm, SchemaView().add_space(1, {"person": 7},
                                                     {"e": 1}))
    yield m, pm, port_rt, TpuQueryRuntime([], _Names())
    port_rt.close()


def _starts(case, steps, wi):
    if case == "empty":
        return _pad_pow2(np.zeros(0, np.int32))
    if case == "hub":
        return _pad_pow2(np.asarray([3], np.int32))
    rng = np.random.default_rng(wi * 5 + steps)
    return _pad_pow2(rng.integers(0, N, 5).astype(np.int32))


def _rp(world):
    """The port mirror's CSR row index on the CPU."""
    _m, pm, port_rt, _ref_rt = world
    return port_rt._device_csr(pm)["row_ptr"]


def _programs(world, tree, et, pushed, steps, start):
    """(the reference's (final, frontier), the port's program, its slot
    tensors, the port's edge arrays)."""
    m, pm, port_rt, ref_rt = world
    alias = {"e": et}
    rcomp = rec.ExprCompiler(m, 1, _Names(), alias)
    rcv = rcomp.compile(rex._from_wire(tree))
    plan = _GoPlan(m, alias, rcv, dict(rcomp.used), pushed, rcomp,
                   f"{tree}{et}{pushed}", False)
    want = ref_rt._run_go_kernel(m, 1, steps, (et,), plan, start)
    pcomp = pec.ExprCompiler(pm, 1, port_rt._schema(1), alias)
    pcv = pcomp.compile(pex._from_wire(tree))
    types = {k: {np.dtype(np.int32): ep.I, np.dtype(np.float32): ep.F,
                 np.dtype(bool): ep.B}[np.dtype(
                     TorchQueryRuntime._col_dtype(pm, d))]
             for k, d in pcomp.used.items()}
    prog = ep.trace_filter(pcv, pcomp.used, pcomp.div_guards, pushed, types)
    env = port_rt._env_cols(pm, alias, pcomp.used, with_valid=pushed)
    slots = [env[k] for k, _kind, _t in prog.slots]
    dev = port_rt._device_csr(pm)
    return want, prog, slots, (dev["edge_src"], dev["edge_dst"],
                               dev["edge_etype"])


@pytest.mark.parametrize("start_case", ["some", "hub", "empty"])
@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("pushed", [True, False])
@pytest.mark.parametrize("wi", range(len(CASES)))
def test_fused_final_pass_matches_jax(world, wi, pushed, steps, start_case):
    et = -1 if wi % 2 else 1
    start = _starts(start_case, steps, wi)
    (want_f, want_fr), prog, slots, (src, dst, ety) = _programs(
        world, CASES[wi], et, pushed, steps, start)
    got_f, got_fr = edge_ops.go_filtered(src, dst, ety, _rp(world),
                                         torch.from_numpy(start), N, steps,
                                         (et,), prog, slots)
    assert got_f.dtype == torch.bool and got_f.shape == src.shape
    assert np.array_equal(got_fr.numpy(), np.asarray(want_fr))
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    # the pass alone against K9 over K10's whole mask, on this frontier
    fmask = torch.empty_like(got_f)
    edge_ops.expr_filter_ref(prog, slots, src, dst, fmask)
    whole = edge_ops.edge_final_ref(got_fr, src, ety, (et,), fmask,
                                    torch.empty_like(got_f))
    fused = edge_ops.edge_final_where(got_fr, src, dst, ety, (et,), prog,
                                      slots, torch.empty_like(got_f))
    assert torch.equal(fused, whole)
    keep = edge_ops.edge_final_ref(got_fr, src, ety, (et,), None,
                                   torch.empty_like(got_f))
    if start_case == "empty":
        assert not got_fr.any() and not got_f.any()
    elif wi == NOWHERE:
        assert keep.any() and not got_f.any()
    elif wi in (EVERYWHERE, CONSTANT) and not pushed:
        assert torch.equal(got_f, keep)
    if wi == CONSTANT:
        assert len(prog) == 1 and prog.ops == ["CONST"]


def test_plain_pass_runs_the_program_on_the_kept_edges_only(world,
                                                            monkeypatch):
    """The plain version of the pass hands the interpreter the edges
    that pass K9's test and no other."""
    start = _starts("some", 2, 3)
    (_want, _fr), prog, slots, (src, dst, ety) = _programs(
        world, CASES[1], 1, True, 2, start)
    _f, frontier = edge_ops.go(src, dst, ety, _rp(world),
                               torch.from_numpy(start), N, 2, (1,))
    keep = edge_ops.edge_final_ref(frontier, src, ety, (1,), None,
                                   torch.empty(src.shape, dtype=torch.bool))
    sizes = []
    real = edge_ops.run_program

    def recording(prog_, cols, s, d):
        sizes.append(int(s.shape[0]))
        return real(prog_, cols, s, d)
    monkeypatch.setattr(edge_ops, "run_program", recording)
    edge_ops.edge_final_where(frontier, src, dst, ety, (1,), prog, slots,
                              torch.empty(src.shape, dtype=torch.bool))
    assert sizes == [int(keep.sum())] and 0 < sizes[0] < int(src.shape[0])


def test_pass_checks_its_operands(world):
    start = _starts("some", 1, 0)
    _want, prog, slots, (src, dst, ety) = _programs(world, CASES[0], 1,
                                                    True, 1, start)
    f = torch.zeros(N, dtype=torch.bool)
    out = torch.empty(src.shape, dtype=torch.bool)
    with pytest.raises(ValueError):          # out of the wrong length
        edge_ops.edge_final_where(f, src, dst, ety, (1,), prog, slots,
                                  out[:-1])
    with pytest.raises(TypeError):           # a frontier not bool
        edge_ops.edge_final_where(f.to(torch.uint8), src, dst, ety, (1,),
                                  prog, slots, out)
    with pytest.raises(ValueError):          # a slot tensor missing
        edge_ops.edge_final_where(f, src, dst, ety, (1,), prog, slots[:-1],
                                  out)
    with pytest.raises(ValueError):          # no OVER etype
        edge_ops.edge_final_where(f, src, dst, ety, (), prog, slots, out)


def test_device_program_names_only_its_registers(world):
    """The card's register file holds a program's ``n_regs`` registers a
    thread: an instruction naming another is refused before upload."""
    start = _starts("some", 1, 0)
    _want, prog, _slots, _edges = _programs(world, CASES[1], 1, True, 1,
                                            start)
    assert prog.device_ins(torch.device("cpu")).shape == (len(prog), 5)
    bad_ins = prog.ins.copy().reshape(-1, 5)
    row = int(np.nonzero(bad_ins[:, 0] >= ep.OPCODE["CVT_BI"])[0][0])
    bad_ins[row, 2] = prog.n_regs
    bad = ep.ExprProgram(bad_ins, prog.slots, prog.out, prog.n_regs,
                         list(prog.ops), prog.n_guards, prog.pushed)
    with pytest.raises(ValueError):
        bad.device_ins(torch.device("cpu"))


def test_cpu_route_counts_no_launch(world):
    """go_filtered's plain route adds nothing to LAUNCHES."""
    start = _starts("hub", 3, 0)
    _want, prog, slots, (src, dst, ety) = _programs(world, CASES[0], 1,
                                                    True, 3, start)
    edge_ops.reset_launches()
    edge_ops.go_filtered(src, dst, ety, _rp(world), torch.from_numpy(start),
                         N, 3, (1,), prog, slots)
    assert all(v == 0 for v in edge_ops.LAUNCHES.values())
