"""The edge-list device programs — the counterparts of
``nebula_tpu/tpu/kernels.py``'s ``make_go_kernel`` (``:284``),
``make_go_filtered_kernel`` (``:296``) and ``make_bfs_kernel``
(``:315``), and of the compiled WHERE that ``go_filtered`` fuses
(``expr_compile.py``'s CVal closures, registered as ``expr_filter``).

Layout: the mirror's edge arrays ``edge_src`` / ``edge_dst`` /
``edge_etype`` int32 [m], sorted by source, and ``row_ptr`` int32
[n + 1], their CSR row index (the edges of source v are
``[row_ptr[v], row_ptr[v + 1])``); a frontier is bool [n] (one byte a
vertex); start and target lists are int32 dense ids with -1 padding,
as ``bitmap_from_idx`` takes them.  The OVER set is a short tuple of
signed etypes.

Each wrapper takes tensors on one device.  On the CPU it runs its plain
PyTorch version (``*_ref``); on a CUDA device it launches its
hand-written kernel from ``csrc/edge_go.cu`` or ``csrc/expr_filter.cu``
and adds one to its entry in ``LAUNCHES``, or raises — there is no
fallback from one to the other.  The programs:

- ``go`` = ``edge_seed`` + ``edge_final`` at one step; from two,
  ``edge_hop`` from the start list itself, ``edge_hop`` × (steps - 2)
  from the frontier, then ``edge_final``
- ``go_filtered`` = the same with ``edge_final_where``: ``edge_final``'s
  test with the compiled WHERE evaluated inside it, only on the edges
  that pass the test (every operation of the WHERE is total, so that
  gives the reference's mask, ``expr_filter``'s ANDed into
  ``edge_final``'s, without the [m] mask)
- ``bfs`` = ``edge_seed`` × 2 + ``edge_bfs_level`` (first) + per level
  ``edge_hop`` + ``edge_bfs_level``, the host reading the level's two
  flags before it launches the next (one 8-byte read a level).
- ``sharded_go`` = per hop ``edge_scan_hop`` on every shard's edge slice
  (a slice of the padded list is no CSR of its own), then
  ``mesh.psum_or`` (``ell_ops.or_many``), then ``edge_final`` on every
  slice (kernels.py:364).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .csr import check_row_index
from .ell_ops import (_check, _lib, _ok, _over_check, _route, _stream)
from .expr_program import (B, EDGE, F, I, MAX_INS, MAX_REGS, MAX_SLOTS,
                           ExprProgram, run_program)

INT32_INF = 2**31 - 1          # kernels.py INT32_INF: unreached depth

LAUNCHES: Dict[str, int] = {"edge_seed": 0, "edge_hop": 0,
                            "edge_scan_hop": 0, "edge_final": 0,
                            "edge_final_where": 0, "expr_filter": 0,
                            "edge_bfs_level": 0, "go": 0,
                            "go_filtered": 0, "bfs": 0, "sharded_go": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _over(over: Sequence[int]):
    """The OVER set as the (int32 array, count) pair the kernels take."""
    over = _over_check(over)
    return (ctypes.c_int32 * len(over))(*over), len(over)


def _edges(edge_src: torch.Tensor, edge_dst: Optional[torch.Tensor],
           edge_etype: Optional[torch.Tensor]) -> Tuple[int, torch.device]:
    if not isinstance(edge_src, torch.Tensor) or edge_src.dim() != 1:
        raise ValueError("edge_src must be an int32 [m] tensor")
    m, dev = int(edge_src.shape[0]), edge_src.device
    _check(edge_src, "edge_src", torch.int32, (m,), dev)
    if edge_dst is not None:
        _check(edge_dst, "edge_dst", torch.int32, (m,), dev)
    if edge_etype is not None:
        _check(edge_etype, "edge_etype", torch.int32, (m,), dev)
    return m, dev


def _etype_ok(edge_etype: torch.Tensor, over: Sequence[int]
              ) -> torch.Tensor:
    ok = torch.zeros(edge_etype.shape, dtype=torch.bool,
                     device=edge_etype.device)
    for e in _over_check(over):
        ok |= edge_etype == e
    return ok


# =========================================================== edge_seed
def edge_seed_ref(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of ``edge_seed`` (kernels.py ``bitmap_from_idx``)."""
    f.zero_()
    keep = (idx >= 0) & (idx < f.shape[0])
    f[idx[keep].long()] = True
    return f


def edge_seed(f: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The frontier bitmap of a -1-padded dense-id list: ``f`` bool [n]
    is 1 at every id in range and 0 elsewhere, each byte written once
    (one launch)."""
    if f.dim() != 1:
        raise ValueError("f must be a bool [n] tensor")
    n, dev = int(f.shape[0]), f.device
    _check(f, "f", torch.bool, (n,), dev)
    if idx.dim() != 1:
        raise ValueError("idx must be an int32 [S] tensor")
    _check(idx, "idx", torch.int32, (int(idx.shape[0]),), dev)
    if not _route(dev):
        return edge_seed_ref(f, idx)
    rc = _lib().edge_seed(f.data_ptr(), idx.data_ptr(), int(idx.shape[0]),
                          n, _stream(dev))
    _ok(rc, "edge_seed")
    LAUNCHES["edge_seed"] += 1
    return f


# ============================================================ edge_hop
def live_sources(f: torch.Tensor, n: int) -> torch.Tensor:
    """The live sources of a hop: the set bytes of a bool [n] frontier,
    or the ids of an int32 start list that lie in [0, n)."""
    if f.dtype == torch.bool:
        return torch.nonzero(f).reshape(-1)
    return f[(f >= 0) & (f < n)].long()


def row_edges(row_ptr: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The edge ids of the rows of sources ``v``, row after row."""
    begin = row_ptr.long()[v]
    lens = row_ptr.long()[v + 1] - begin
    first = torch.cumsum(lens, 0) - lens
    return torch.repeat_interleave(begin - first, lens) \
        + torch.arange(int(lens.sum()), device=row_ptr.device)


def edge_hop_ref(f: torch.Tensor, out: torch.Tensor,
                 edge_src: torch.Tensor, edge_dst: torch.Tensor,
                 edge_etype: torch.Tensor, row_ptr: torch.Tensor,
                 over: Sequence[int]) -> torch.Tensor:
    """Plain version of ``edge_hop``: the walk over the CSR rows of the
    live sources, ``zeros(n).at[dst].max(ok)`` over their edges
    (kernels.py ``_go_body``'s hop, which reads every edge); refuses an
    edge list that ``row_ptr`` does not index (``csr.check_row_index``)."""
    check_row_index(edge_src.cpu().numpy(), row_ptr.cpu().numpy())
    e = row_edges(row_ptr, live_sources(f, out.shape[0]))
    out.zero_()
    out[edge_dst[e][_etype_ok(edge_etype[e], over)].long()] = True
    return out


def edge_hop(f: torch.Tensor, out: torch.Tensor, edge_src: torch.Tensor,
             edge_dst: torch.Tensor, edge_etype: torch.Tensor,
             row_ptr: torch.Tensor, over: Sequence[int]) -> torch.Tensor:
    """K8, one hop over the CSR rows: ``out`` bool [n] becomes the
    destinations of the edges whose etype is in ``over`` and whose
    source is live: set in the frontier ``f`` bool [n] (a separate
    buffer from ``out``), or, for ``f`` an int32 [S] start list (-1
    padded; ids outside [0, n) dropped), one of its ids.  The kernel
    reads ``row_ptr`` and the live rows' ``edge_dst`` / ``edge_etype``,
    not ``edge_src``: the edges must be sorted by source with
    ``row_ptr`` their row index, as the mirror keeps them."""
    _m, dev = _edges(edge_src, edge_dst, edge_etype)
    if out.dim() != 1:
        raise ValueError("out must be a bool [n] tensor")
    n = int(out.shape[0])
    _check(out, "out", torch.bool, (n,), dev)
    _check(row_ptr, "row_ptr", torch.int32, (n + 1,), dev)
    if f.dtype == torch.bool:
        _check(f, "f", torch.bool, (n,), dev)
        if f.data_ptr() == out.data_ptr():
            raise ValueError("edge_hop writes a separate buffer")
    elif f.dim() == 1:
        _check(f, "f", torch.int32, (int(f.shape[0]),), dev)
    else:
        raise ValueError("f must be a bool [n] frontier or an int32 [S] "
                         "start list")
    if not _route(dev):
        return edge_hop_ref(f, out, edge_src, edge_dst, edge_etype, row_ptr,
                            over)
    front = f.dtype == torch.bool
    rc = _lib().edge_hop(f.data_ptr() if front else None,
                         None if front else f.data_ptr(),
                         0 if front else int(f.shape[0]), out.data_ptr(),
                         row_ptr.data_ptr(), edge_dst.data_ptr(),
                         edge_etype.data_ptr(), n, *_over(over),
                         _stream(dev))
    _ok(rc, "edge_hop")
    LAUNCHES["edge_hop"] += 1
    return out


def edge_scan_hop_ref(f: torch.Tensor, out: torch.Tensor,
                      edge_src: torch.Tensor, edge_dst: torch.Tensor,
                      edge_etype: torch.Tensor, over: Sequence[int]
                      ) -> torch.Tensor:
    """Plain version of ``edge_scan_hop`` (kernels.py ``_go_body``'s
    hop): ``zeros(n).at[dst].max(f[src] & ok)``."""
    active = f[edge_src.long()] & _etype_ok(edge_etype, over)
    out.zero_()
    out[edge_dst[active].long()] = True
    return out


def edge_scan_hop(f: torch.Tensor, out: torch.Tensor,
                  edge_src: torch.Tensor, edge_dst: torch.Tensor,
                  edge_etype: torch.Tensor, over: Sequence[int]
                  ) -> torch.Tensor:
    """The hop as the reference writes it, a scan over every edge in any
    order: ``out`` bool [n] (a separate buffer from ``f``) becomes the
    destinations of the edges whose source is in ``f`` and whose etype
    is in ``over``.  ``sharded_go``'s hop, whose slices of the padded
    edge list have no row index of their own."""
    m, dev = _edges(edge_src, edge_dst, edge_etype)
    n = int(f.shape[0])
    _check(f, "f", torch.bool, (n,), dev)
    _check(out, "out", torch.bool, (n,), dev)
    if f.data_ptr() == out.data_ptr():
        raise ValueError("edge_scan_hop writes a separate buffer")
    if not _route(dev):
        return edge_scan_hop_ref(f, out, edge_src, edge_dst, edge_etype,
                                 over)
    rc = _lib().edge_scan_hop(f.data_ptr(), out.data_ptr(),
                              edge_src.data_ptr(), edge_dst.data_ptr(),
                              edge_etype.data_ptr(), m, n, *_over(over),
                              _stream(dev))
    _ok(rc, "edge_scan_hop")
    LAUNCHES["edge_scan_hop"] += 1
    return out


# ========================================================== edge_final
def edge_final_ref(f: torch.Tensor, edge_src: torch.Tensor,
                   edge_etype: torch.Tensor, over: Sequence[int],
                   fmask: Optional[torch.Tensor], out: torch.Tensor
                   ) -> torch.Tensor:
    """Plain version of ``edge_final``: ``f[src] & ok (& fmask)``."""
    final = f[edge_src.long()] & _etype_ok(edge_etype, over)
    if fmask is not None:
        final &= fmask
    out.copy_(final)
    return out


def edge_final(f: torch.Tensor, edge_src: torch.Tensor,
               edge_etype: torch.Tensor, over: Sequence[int],
               fmask: Optional[torch.Tensor], out: torch.Tensor
               ) -> torch.Tensor:
    """The final hop's edge mask: ``out`` bool [m] is ``f[src[e]]`` and
    etype in ``over`` and, when given, ``fmask[e]`` (the fused WHERE)."""
    m, dev = _edges(edge_src, None, edge_etype)
    n = int(f.shape[0])
    _check(f, "f", torch.bool, (n,), dev)
    _check(out, "out", torch.bool, (m,), dev)
    if fmask is not None:
        _check(fmask, "fmask", torch.bool, (m,), dev)
    if not _route(dev):
        return edge_final_ref(f, edge_src, edge_etype, over, fmask, out)
    rc = _lib().edge_final(f.data_ptr(), edge_src.data_ptr(),
                           edge_etype.data_ptr(),
                           None if fmask is None else fmask.data_ptr(),
                           out.data_ptr(), m, *_over(over), _stream(dev))
    _ok(rc, "edge_final")
    LAUNCHES["edge_final"] += 1
    return out


# ========================================================= expr_filter
class _Slots(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p * MAX_SLOTS),
                ("kind", ctypes.c_int * MAX_SLOTS),
                ("type", ctypes.c_int * MAX_SLOTS), ("n", ctypes.c_int)]


_SLOT_DTYPE = {B: torch.bool, I: torch.int32, F: torch.float32}


def _slot_check(prog: ExprProgram, slots: Sequence[torch.Tensor], m: int,
                dev: torch.device) -> None:
    if len(slots) != len(prog.slots):
        raise ValueError(f"{len(slots)} slot tensors for "
                         f"{len(prog.slots)} slots")
    for t, (key, kind, typ) in zip(slots, prog.slots):
        if t.dim() != 1:
            raise ValueError(f"slot {key} must be 1-D")
        _check(t, f"slot {key}", _SLOT_DTYPE[typ], (int(t.shape[0]),), dev)
        if kind == EDGE and t.shape[0] != m:
            raise ValueError(f"edge slot {key} has {t.shape[0]} rows, "
                             f"not {m}")


def expr_filter_ref(prog: ExprProgram, slots: Sequence[torch.Tensor],
                    edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``expr_filter``: the program run with torch ops
    over every edge at once (expr_program.run_program)."""
    out.copy_(run_program(prog, slots, edge_src, edge_dst))
    return out


def _program_args(prog: ExprProgram, slots: Sequence[torch.Tensor],
                  dev: torch.device) -> tuple:
    """(instructions on the card, their count, registers, out register,
    slot table) as the interpreter's entries take them."""
    if len(prog) > MAX_INS or prog.n_regs > MAX_REGS \
            or len(slots) > MAX_SLOTS:
        raise ValueError("program exceeds the kernel's limits")
    st = _Slots()
    for k, (t, (_key, kind, typ)) in enumerate(zip(slots, prog.slots)):
        st.ptr[k] = t.data_ptr()
        st.kind[k] = kind
        st.type[k] = typ
    st.n = len(slots)
    return (prog.device_ins(dev).data_ptr(), len(prog), prog.n_regs,
            prog.out, st)


def expr_filter(prog: ExprProgram, slots: Sequence[torch.Tensor],
                edge_src: torch.Tensor, edge_dst: torch.Tensor,
                out: torch.Tensor) -> torch.Tensor:
    """The compiled WHERE as a bool [m] edge mask: ``prog`` (an
    ExprProgram) over its slot tensors, edge-aligned [m] or
    vertex-aligned [n] (read at src[e] / dst[e]).  The registry family's
    counterpart; no runtime path launches it (``go_filtered`` runs the
    same interpreter inside ``edge_final_where``)."""
    m, dev = _edges(edge_src, edge_dst, None)
    _check(out, "out", torch.bool, (m,), dev)
    _slot_check(prog, slots, m, dev)
    if not _route(dev):
        return expr_filter_ref(prog, slots, edge_src, edge_dst, out)
    rc = _lib().expr_filter(*_program_args(prog, slots, dev),
                            edge_src.data_ptr(), edge_dst.data_ptr(), m,
                            out.data_ptr(), _stream(dev))
    _ok(rc, "expr_filter")
    LAUNCHES["expr_filter"] += 1
    return out


# ==================================================== edge_final_where
def edge_final_where_ref(f: torch.Tensor, edge_src: torch.Tensor,
                         edge_dst: torch.Tensor, edge_etype: torch.Tensor,
                         over: Sequence[int], prog: ExprProgram,
                         slots: Sequence[torch.Tensor], out: torch.Tensor
                         ) -> torch.Tensor:
    """Plain version of ``edge_final_where``: ``edge_final_ref``'s test,
    then ``expr_filter_ref``'s program run on the edges that pass it
    only (their rows of the edge-aligned columns, their src / dst)."""
    keep = f[edge_src.long()] & _etype_ok(edge_etype, over)
    idx = torch.nonzero(keep).reshape(-1)
    sub = [t[idx] if kind == EDGE else t
           for t, (_key, kind, _typ) in zip(slots, prog.slots)]
    out.zero_()
    out[idx] = run_program(prog, sub, edge_src[idx], edge_dst[idx]).bool()
    return out


def edge_final_where(f: torch.Tensor, edge_src: torch.Tensor,
                     edge_dst: torch.Tensor, edge_etype: torch.Tensor,
                     over: Sequence[int], prog: ExprProgram,
                     slots: Sequence[torch.Tensor], out: torch.Tensor
                     ) -> torch.Tensor:
    """``go_filtered``'s final pass: ``out`` bool [m] is ``f[src[e]]``
    and etype in ``over`` and the WHERE ``prog`` at e, the WHERE
    evaluated only on the edges where the first two hold (on the card a
    warp queues them and interprets 32 at a time), so its columns are
    read for those edges alone and no [m] mask is made."""
    m, dev = _edges(edge_src, edge_dst, edge_etype)
    n = int(f.shape[0])
    _check(f, "f", torch.bool, (n,), dev)
    _check(out, "out", torch.bool, (m,), dev)
    _slot_check(prog, slots, m, dev)
    if not _route(dev):
        return edge_final_where_ref(f, edge_src, edge_dst, edge_etype, over,
                                    prog, slots, out)
    rc = _lib().edge_final_where(
        f.data_ptr(), edge_src.data_ptr(), edge_dst.data_ptr(),
        edge_etype.data_ptr(), *_over(over), *_program_args(prog, slots, dev),
        m, out.data_ptr(), _stream(dev))
    _ok(rc, "edge_final_where")
    LAUNCHES["edge_final_where"] += 1
    return out


# ====================================================== edge_bfs_level
def edge_bfs_level_ref(reached: torch.Tensor, d: torch.Tensor,
                       targets: Optional[torch.Tensor],
                       flags: torch.Tensor, step: int, first: bool,
                       stop: bool) -> None:
    """Plain version of ``edge_bfs_level`` (kernels.py:336-347)."""
    if first:
        d.copy_(torch.where(reached, 0, INT32_INF).to(torch.int32))
        newly = reached
    else:
        newly = reached & (d == INT32_INF)
        d.masked_fill_(newly, step + 1)
        reached.copy_(newly)
    flags[0] |= newly.any().to(torch.int32)
    if stop:
        flags[1] |= (targets & (d == INT32_INF)).any().to(torch.int32)


def edge_bfs_level(reached: torch.Tensor, d: torch.Tensor,
                   targets: Optional[torch.Tensor], flags: torch.Tensor,
                   step: int, first: bool = False,
                   stop: bool = True) -> None:
    """One BFS level after ``edge_hop`` wrote ``reached`` bool [n]:
    ``newly = reached & (d == INF)``, ``d = step + 1`` there, and
    ``reached`` becomes ``newly`` in place (the next frontier).
    ``flags`` int32 [2] (zero before) gets 1 in slot 0 when any vertex
    was newly reached and, with ``stop``, 1 in slot 1 when a target is
    still INF.  With ``first``, ``reached`` is the start frontier and
    ``d`` int32 [n] is written whole: 0 on it, INF elsewhere."""
    if reached.dim() != 1:
        raise ValueError("reached must be a bool [n] tensor")
    n, dev = int(reached.shape[0]), reached.device
    _check(reached, "reached", torch.bool, (n,), dev)
    _check(d, "d", torch.int32, (n,), dev)
    _check(flags, "flags", torch.int32, (2,), dev)
    if stop:
        if targets is None:
            raise ValueError("stop needs the target bitmap")
        _check(targets, "targets", torch.bool, (n,), dev)
    if not 0 <= step < INT32_INF - 1:
        raise ValueError(f"level {step} does not fit an int32 depth")
    if not _route(dev):
        return edge_bfs_level_ref(reached, d, targets, flags, step, first,
                                  stop)
    rc = _lib().edge_bfs_level(
        reached.data_ptr(), d.data_ptr(),
        None if targets is None else targets.data_ptr(), flags.data_ptr(),
        step, int(first), int(stop), n, _stream(dev))
    _ok(rc, "edge_bfs_level")
    LAUNCHES["edge_bfs_level"] += 1


# ============================================================ programs
def _frontier0(start_idx: torch.Tensor, n: int, seed) -> torch.Tensor:
    f = torch.empty(n, dtype=torch.bool, device=start_idx.device)
    return seed(f, start_idx)


def _go_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx, n, steps,
             over, seed, hop, final):
    """The GO programs: at one step the start bitmap; from two, the
    first hop from the start list itself and ``steps - 2`` more from
    the frontier (no start bitmap); then ``final(f, out)`` into a fresh
    bool [m]."""
    if steps > 1:
        bufs = [torch.empty(n, dtype=torch.bool, device=edge_src.device)
                for _ in range(min(steps - 1, 2))]
        f = start_idx
        for h in range(steps - 1):
            f = hop(f, bufs[h % 2], edge_src, edge_dst, edge_etype, row_ptr,
                    over)
    else:
        f = _frontier0(start_idx, n, seed)
    out = torch.empty(edge_src.shape, dtype=torch.bool,
                      device=edge_src.device)
    return final(f, out), f


def go_ref(edge_src: torch.Tensor, edge_dst: torch.Tensor,
           edge_etype: torch.Tensor, row_ptr: torch.Tensor,
           start_idx: torch.Tensor, n: int, steps: int, over: Sequence[int]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``go``."""
    return _go_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx, n,
                    steps, over, edge_seed_ref, edge_hop_ref,
                    lambda f, out: edge_final_ref(f, edge_src, edge_etype,
                                                  over, None, out))


def go(edge_src: torch.Tensor, edge_dst: torch.Tensor,
       edge_etype: torch.Tensor, row_ptr: torch.Tensor,
       start_idx: torch.Tensor, n: int, steps: int, over: Sequence[int]
       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-list GO (kernels.py:284 make_go_kernel) over the mirror's
    edges and their row index ``row_ptr``: from ``start_idx`` (int32,
    -1 padded), ``steps - 1`` hops, then the final edge mask.  Returns
    (final bool [m], frontier bool [n])."""
    _edges(edge_src, edge_dst, edge_etype)
    out = _go_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx, n,
                   steps, over, edge_seed, edge_hop,
                   lambda f, out: edge_final(f, edge_src, edge_etype, over,
                                             None, out))
    if _route(edge_src.device):
        LAUNCHES["go"] += 1
    return out


def go_filtered_ref(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    edge_etype: torch.Tensor, row_ptr: torch.Tensor,
                    start_idx: torch.Tensor, n: int, steps: int,
                    over: Sequence[int], prog: ExprProgram,
                    slots: Sequence[torch.Tensor]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``go_filtered``: the reference's order
    (kernels.py:296), the WHERE over every edge into a mask that ANDs
    into the final test."""
    fmask = torch.empty(edge_src.shape, dtype=torch.bool,
                        device=edge_src.device)
    expr_filter_ref(prog, slots, edge_src, edge_dst, fmask)
    return _go_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx, n,
                    steps, over, edge_seed_ref, edge_hop_ref,
                    lambda f, out: edge_final_ref(f, edge_src, edge_etype,
                                                  over, fmask, out))


def go_filtered(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_etype: torch.Tensor, row_ptr: torch.Tensor,
                start_idx: torch.Tensor, n: int, steps: int,
                over: Sequence[int], prog: ExprProgram,
                slots: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GO with the WHERE fused (kernels.py:296 make_go_filtered_kernel):
    the final pass ``edge_final_where`` evaluates the WHERE inside the
    final hop's edge test, on the edges that pass it only.  Returns
    (final bool [m], frontier bool [n]), the reference's exactly."""
    _edges(edge_src, edge_dst, edge_etype)
    out = _go_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx, n,
                   steps, over, edge_seed, edge_hop,
                   lambda f, out: edge_final_where(f, edge_src, edge_dst,
                                                   edge_etype, over, prog,
                                                   slots, out))
    if _route(edge_src.device):
        LAUNCHES["go_filtered"] += 1
    return out


def _bfs_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx,
              target_idx, n, max_steps, over, stop, seed, hop, level):
    dev = edge_src.device
    f = _frontier0(start_idx, n, seed)
    targets = _frontier0(target_idx, n, seed) if stop else None
    d = torch.empty(n, dtype=torch.int32, device=dev)
    flags = torch.zeros((max_steps + 1, 2), dtype=torch.int32, device=dev)
    level(f, d, targets, flags[0], 0, True, stop)
    buf = torch.empty_like(f)
    step = 0
    # the while_loop condition of kernels.py:330-335, read once a level
    while step < max_steps:
        f_any, t_any = flags[step].tolist()
        if not f_any or (stop and not t_any):
            break
        hop(f, buf, edge_src, edge_dst, edge_etype, row_ptr, over)
        level(buf, d, targets, flags[step + 1], step, False, stop)
        f, buf = buf, f
        step += 1
    return d, step


def bfs_ref(edge_src: torch.Tensor, edge_dst: torch.Tensor,
            edge_etype: torch.Tensor, row_ptr: torch.Tensor,
            start_idx: torch.Tensor, target_idx: torch.Tensor, n: int,
            max_steps: int, over: Sequence[int],
            stop_when_found: bool = True) -> Tuple[torch.Tensor, int]:
    """Plain version of ``bfs``."""
    return _bfs_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx,
                     target_idx, n, max_steps, over, stop_when_found,
                     edge_seed_ref, edge_hop_ref, edge_bfs_level_ref)


def bfs(edge_src: torch.Tensor, edge_dst: torch.Tensor,
        edge_etype: torch.Tensor, row_ptr: torch.Tensor,
        start_idx: torch.Tensor, target_idx: torch.Tensor, n: int,
        max_steps: int, over: Sequence[int], stop_when_found: bool = True
        ) -> Tuple[torch.Tensor, int]:
    """Level-synchronous BFS depths (kernels.py:315 make_bfs_kernel) over
    the mirror's edges and their row index ``row_ptr``: int32 [n] with
    INT32_INF for unreached within ``max_steps``; with
    ``stop_when_found`` the levels stop once every target is reached.
    Returns (depths, levels run)."""
    _edges(edge_src, edge_dst, edge_etype)
    if max_steps < 0:
        raise ValueError("max_steps must be >= 0")
    out = _bfs_loop(edge_src, edge_dst, edge_etype, row_ptr, start_idx,
                    target_idx, n, max_steps, over, stop_when_found,
                    edge_seed, edge_hop, edge_bfs_level)
    if _route(edge_src.device):
        LAUNCHES["bfs"] += 1
    return out


# =========================================================== sharded_go
def shard_edges(mesh, edge_src, edge_dst, edge_etype):
    """kernels.py:484 ``shard_edges``: the edge arrays (numpy) padded to
    a multiple of the mesh's k with zeros (etype 0 is never a real
    etype, so a pad edge never passes the OVER test) and cut into k
    equal slices, slice s on shard s's device.  Returns (src slices,
    dst slices, etype slices, padded size)."""
    k = mesh.k
    m = len(edge_src)
    size = ((m + k - 1) // k) * k if m else k
    cols = []
    for a in (edge_src, edge_dst, edge_etype):
        p = np.zeros(size, np.int32)
        p[:m] = a
        chunk = size // k
        cols.append([torch.from_numpy(p[s * chunk:(s + 1) * chunk].copy())
                     .to(d) for s, d in enumerate(mesh.devices)])
    return cols[0], cols[1], cols[2], size


def _sharded_go_loop(src_sh, dst_sh, et_sh, f0, n, steps, over, mesh, hop,
                     final, or_many):
    from .mesh import on, psum_or
    k = mesh.k
    if not (len(src_sh) == len(dst_sh) == len(et_sh) == k):
        raise ValueError(f"edge slices for {len(src_sh)} shards, mesh of "
                         f"{k}")
    for s in range(k):
        m_s, dev = _edges(src_sh[s], dst_sh[s], et_sh[s])
        if dev != mesh.devices[s] or m_s != int(src_sh[0].shape[0]):
            raise ValueError(f"edge slice {s}: {m_s} edges on {dev}")
    _check(f0, "f0", torch.bool, (n,), f0.device)
    over = _over_check(over)
    n4 = max(4, -(-n // 4) * 4)     # or_many works on whole 32-bit words

    def words(*lead):
        return [torch.zeros((*lead, n4), dtype=torch.bool, device=d)
                for d in mesh.devices]
    f = words()
    for s in range(k):
        f[s][:n].copy_(f0)
    if steps > 1:
        partial, recv = words(), words(k - 1)
        for _ in range(steps - 1):
            for s in range(k):
                with on(mesh.devices[s]):
                    hop(f[s][:n], partial[s][:n], src_sh[s], dst_sh[s],
                        et_sh[s], over)
            psum_or(partial, f, recv, or_many)
    finals = []
    for s in range(k):
        with on(mesh.devices[s]):
            finals.append(final(f[s][:n], src_sh[s], et_sh[s], over, None,
                                torch.empty(src_sh[s].shape,
                                            dtype=torch.bool,
                                            device=mesh.devices[s])))
    return finals, [x[:n] for x in f]


def sharded_go_ref(src_sh, dst_sh, et_sh, f0: torch.Tensor, n: int,
                   steps: int, over: Sequence[int], mesh):
    """Plain version of ``sharded_go``."""
    from .ell_ops import or_many_ref
    return _sharded_go_loop(src_sh, dst_sh, et_sh, f0, n, steps, over,
                            mesh, edge_scan_hop_ref, edge_final_ref,
                            or_many_ref)


def sharded_go(src_sh, dst_sh, et_sh, f0: torch.Tensor, n: int,
               steps: int, over: Sequence[int], mesh):
    """Edge-sharded GO (kernels.py:364 make_sharded_go_kernel): the edge
    slices of ``shard_edges`` on the mesh's shards, the frontier bool
    [n] replicated (``f0`` is copied to every shard).  Each hop, every
    shard runs ``edge_scan_hop`` over its slice into a partial bitmap, and
    ``mesh.psum_or`` gives every shard the OR of the partials; then
    ``edge_final`` on each shard's slice.  Returns (the per-shard final
    edge masks, bool [m / k] each — concatenated in shard order they
    are the reference's sharded [m] mask — and the k replicas of the
    frontier)."""
    from .ell_ops import or_many
    out = _sharded_go_loop(src_sh, dst_sh, et_sh, f0, n, steps, over,
                           mesh, edge_scan_hop, edge_final, or_many)
    if _route(mesh.devices[0]):
        LAUNCHES["sharded_go"] += 1
    return out
