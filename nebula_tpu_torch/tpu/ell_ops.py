"""The port's device programs: the continuous session's four
(``nebula_tpu/tpu/ell.py:665-743``: ``ell_go_hop``, ``ell_lane_join``,
``ell_lane_extract``, ``ell_lane_clear``) and the windowed path's
packed frontier upload (``tpu/runtime.py:3251``), batched dense GO and
its COUNT(*) fold (``ell.py:572``) and batched BFS (``ell.py:1080``).

Each wrapper takes tensors on one device.  On the CPU it runs its plain
PyTorch version (``*_ref``, a transcription of the JAX function on the
same layout); on a CUDA device it launches its hand-written kernel from
``csrc/ell_lanes.cu`` and adds one to its entry in ``LAUNCHES``, or
raises — there is no fallback from one to the other.  Any other device
raises.

The reference's kernels are pure and donate the pair; the port updates
in place where it can and says so per function: join, clear and the
hop's ``accp`` union write the carriers in place, the hop's new
frontier goes to a separate ``out`` buffer (its gathers read the
previous generation), and extract writes a fresh ``[n_rows + 1, P]``
buffer.  ``ell_go`` and ``ell_bfs`` consume their start frontier (it
becomes one of their two ping-pong buffers).  Lane layout at every
function here: bit k of word j is lane 8j + k (``ell.pack_lanes_host``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from .ell import INT16_INF, DeviceTables

LAUNCHES: Dict[str, int] = {"go_hop": 0, "lane_join": 0,
                            "lane_extract": 0, "lane_clear": 0,
                            "frontier_upload": 0, "ell_go": 0,
                            "go_count": 0, "bfs_level": 0,
                            "bfs_depth_i8": 0}
MAX_OVER = 32        # csrc kMaxOver
MAX_BUCKETS = 32     # csrc kMaxBuckets
MAX_COUNT_W = 1024   # csrc ell_go_count: W / 4 <= kThreads


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ------------------------------------------------------------- checks
def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _frontier(fp: torch.Tensor, name: str = "fp") -> Tuple[int, int]:
    if not isinstance(fp, torch.Tensor) or fp.dim() != 2:
        raise ValueError(f"{name} must be a [n_rows + 1, W] tensor")
    R1, W = fp.shape
    if W % 4:
        raise ValueError(f"lane words W={W} must be a multiple of 4 "
                         f"(the kernels work on 32-bit words)")
    _check(fp, name, torch.uint8, (R1, W), fp.device)
    return R1, W


def _pair(fp: torch.Tensor, accp: torch.Tensor) -> Tuple[int, int]:
    R1, W = _frontier(fp)
    _check(accp, "accp", torch.uint8, (R1, W), fp.device)
    return R1, W


def _route(device: torch.device) -> bool:
    """True: launch the CUDA kernel; False: run the plain version (CPU
    tensors only).  Anything else raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no kernel and no plain route for device {device}")


def _aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 4:
            raise ValueError("kernel operands must be 4-byte aligned "
                             "(the kernels work on 32-bit words)")


def _lib():
    from . import _build
    return _build.load()


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cuda error {rc}")


# ================================================================ hop
def _scatter_or_rows_ref(nxt: torch.Tensor, vals: torch.Tensor,
                         slot: torch.Tensor, rows: torch.Tensor) -> None:
    """In place: OR packed rows ``vals`` [k, W] into ``nxt`` at rows
    ``rows[slot[i]]`` — ell.py:519 transcribed: a bit-plane max into a
    compact [n_slots, 8, W] accumulator (duplicate slots OR correctly
    because per-plane values are 0/1), then one gather-OR-set at the
    unique target rows.  Rows >= nxt.shape[0] are dropped.  The plane
    max is taken as an int32 count of set bits tested > 0 (torch has no
    scatter-max on uint8 outside the beta ``index_reduce_``)."""
    n_slots = rows.shape[0]
    if n_slots == 0:
        return
    W = vals.shape[1]
    shifts = torch.arange(8, dtype=torch.uint8, device=nxt.device)
    planes = (vals[:, None, :] >> shifts[None, :, None]) & 1
    cnt = torch.zeros((n_slots, 8, W), dtype=torch.int32,
                      device=nxt.device)
    cnt.index_add_(0, slot.long(), planes.to(torch.int32))
    acc = (cnt > 0).to(torch.uint8)
    merged = (acc << shifts[None, :, None]).sum(dim=1, dtype=torch.uint8)
    live = rows < nxt.shape[0]
    safe = rows.clamp(max=nxt.shape[0] - 1).long()
    upd = nxt[safe] | merged
    nxt[rows[live].long()] = upd[live]


def go_hop_ref(fp: torch.Tensor, accp: Optional[torch.Tensor],
               out: torch.Tensor, tables: DeviceTables,
               eslot: torch.Tensor, hrows: torch.Tensor,
               over: Sequence[int]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of ``go_hop`` (ell.py:556 _hop_body_packed and
    :541 _bucket_expand_packed): per bucket, OR over the D in-slot word
    gathers masked by the OVER etype set; buckets concatenate; extra
    rows OR-merge into their owners; the pad row is zero; accp |= out
    when an accumulator is given."""
    W = fp.shape[1]
    over_t = torch.tensor(sorted(set(int(e) for e in over)),
                          dtype=torch.int32, device=fp.device)
    for b in range(len(tables.D)):
        nbr, et = tables.bucket(b)
        ok = torch.isin(et, over_t).to(torch.uint8)
        acc = torch.zeros((nbr.shape[0], W), dtype=torch.uint8,
                          device=fp.device)
        for j in range(nbr.shape[1]):
            acc |= fp[nbr[:, j].long()] * ok[:, j, None]
        r0 = tables.row0[b]
        out[r0:r0 + nbr.shape[0]] = acc
    n, n_rows = tables.n, tables.n_rows
    out[n_rows] = 0
    if n_rows > n:
        body = out[:n_rows]
        _scatter_or_rows_ref(body, body[n:].clone(), eslot, hrows)
    if accp is not None:
        accp |= out
    return out, accp


def go_hop(fp: torch.Tensor, accp: Optional[torch.Tensor],
           out: torch.Tensor, tables: DeviceTables, eslot: torch.Tensor,
           hrows: torch.Tensor, over: Sequence[int]
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One packed frontier advance of every lane: ``out`` gets the next
    frontier (all of it, pad row zero), ``accp`` is OR-ed with it in
    place (``accp=None``: no union, as exact-depth GO and BFS need).
    ``out`` must not alias ``fp``.  Returns (out, accp)."""
    R1, W = _frontier(fp) if accp is None else _pair(fp, accp)
    dev = fp.device
    _check(out, "out", torch.uint8, (R1, W), dev)
    if out.data_ptr() == fp.data_ptr():
        raise ValueError("out must be a separate buffer from fp")
    if R1 != tables.n_rows + 1:
        raise ValueError(f"pair has {R1} rows, tables {tables.n_rows + 1}")
    n_extras = tables.n_rows - tables.n
    _check(eslot, "eslot", torch.int32, (n_extras,), dev)
    if hrows.dim() != 1:
        raise ValueError("hrows must be 1-D")
    _check(hrows, "hrows", torch.int32, tuple(hrows.shape), dev)
    _check(tables.nbr, "tables.nbr", torch.int32,
           tuple(tables.nbr.shape), dev)
    _check(tables.et, "tables.et", torch.int32, tuple(tables.nbr.shape),
           dev)
    over = tuple(sorted(set(int(e) for e in over)))
    if not 0 < len(over) <= MAX_OVER:
        raise ValueError(f"OVER set of {len(over)} etypes (1..{MAX_OVER})")
    if not 0 < len(tables.D) <= MAX_BUCKETS:
        raise ValueError(f"{len(tables.D)} buckets (1..{MAX_BUCKETS})")
    if not _route(dev):
        return go_hop_ref(fp, accp, out, tables, eslot, hrows, over)
    _aligned(fp, out, *(() if accp is None else (accp,)))
    desc = (ctypes.c_int64 * (3 * len(tables.D)))(
        *[v for b in range(len(tables.D))
          for v in (tables.row0[b], tables.slot0[b], tables.D[b])])
    ov = (ctypes.c_int32 * len(over))(*over)
    rc = _lib().ell_go_hop(
        fp.data_ptr(), None if accp is None else accp.data_ptr(),
        out.data_ptr(),
        tables.nbr.data_ptr(), tables.et.data_ptr(), desc,
        len(tables.D), eslot.data_ptr(), hrows.data_ptr(), n_extras, ov,
        len(over), tables.n, tables.n_rows, W, _stream(dev))
    _ok(rc, "ell_go_hop")
    LAUNCHES["go_hop"] += 1
    return out, accp


# =============================================================== join
def lane_join_ref(fp: torch.Tensor, accp: torch.Tensor,
                  rows: torch.Tensor, words: torch.Tensor,
                  vals: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``lane_join`` (ell.py:703): scatter-add of the
    lane bits, then the pad row re-zeroed, in both carriers."""
    idx = (rows.long(), words.long())
    pad = fp.shape[0] - 1
    fp.index_put_(idx, vals, accumulate=True)
    fp[pad] = 0
    accp.index_put_(idx, vals, accumulate=True)
    accp[pad] = 0
    return fp, accp


def lane_join(fp: torch.Tensor, accp: torch.Tensor, rows: torch.Tensor,
              words: torch.Tensor, vals: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In place: set single lane bits ``vals[i]`` at (rows[i], words[i])
    in both carriers and zero the pad row.  Contract (the session's):
    rows in [0, n_rows] (n_rows = the pad row, used by padding entries
    with val 0), words in [0, W), each (row, lane) once, and every bit
    set here zero before (a freed lane is cleared first) — then add and
    or agree."""
    R1, W = _pair(fp, accp)
    dev = fp.device
    if rows.dim() != 1:
        raise ValueError("rows must be 1-D")
    S = rows.shape[0]
    _check(rows, "rows", torch.int32, (S,), dev)
    _check(words, "words", torch.int32, (S,), dev)
    _check(vals, "vals", torch.uint8, (S,), dev)
    if not _route(dev):
        return lane_join_ref(fp, accp, rows, words, vals)
    _aligned(fp, accp)
    rc = _lib().ell_lane_join(fp.data_ptr(), accp.data_ptr(),
                              rows.data_ptr(), words.data_ptr(),
                              vals.data_ptr(), S, R1 - 1, W, _stream(dev))
    _ok(rc, "ell_lane_join")
    LAUNCHES["lane_join"] += 1
    return fp, accp


# ============================================================ extract
def lane_extract_ref(fp: torch.Tensor, accp: torch.Tensor,
                     words: torch.Tensor, sel: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``lane_extract`` (ell.py:738)."""
    w = words.long()
    fg = fp.index_select(1, w)
    ag = accp.index_select(1, w)
    out.copy_(torch.where(sel[None, :] != 0, ag, fg))
    return out


def lane_extract(fp: torch.Tensor, accp: torch.Tensor, words: torch.Tensor,
                 sel: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``out[:, j] = accp[:, words[j]] if sel[j] else fp[:, words[j]]``
    into the fresh uint8 ``out`` [n_rows + 1, P]; the carriers are only
    read.  words in [0, W)."""
    R1, W = _pair(fp, accp)
    dev = fp.device
    if words.dim() != 1:
        raise ValueError("words must be 1-D")
    P = words.shape[0]
    _check(words, "words", torch.int32, (P,), dev)
    _check(sel, "sel", torch.uint8, (P,), dev)
    _check(out, "out", torch.uint8, (R1, P), dev)
    if not _route(dev):
        return lane_extract_ref(fp, accp, words, sel, out)
    rc = _lib().ell_lane_extract(fp.data_ptr(), accp.data_ptr(),
                                 words.data_ptr(), sel.data_ptr(),
                                 out.data_ptr(), P, R1, W, _stream(dev))
    _ok(rc, "ell_lane_extract")
    LAUNCHES["lane_extract"] += 1
    return out


# ============================================================== clear
def lane_clear_ref(fp: torch.Tensor, accp: torch.Tensor,
                   keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``lane_clear`` (ell.py:720)."""
    fp &= keep[None, :]
    accp &= keep[None, :]
    return fp, accp


def lane_clear(fp: torch.Tensor, accp: torch.Tensor, keep: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """In place: AND both carriers with the per-word mask ``keep``
    uint8 [W] (the leavers' lane bits low)."""
    R1, W = _pair(fp, accp)
    dev = fp.device
    _check(keep, "keep", torch.uint8, (W,), dev)
    if not _route(dev):
        return lane_clear_ref(fp, accp, keep)
    _aligned(fp, accp, keep)
    rc = _lib().ell_lane_clear(fp.data_ptr(), accp.data_ptr(),
                               keep.data_ptr(), R1, W, _stream(dev))
    _ok(rc, "ell_lane_clear")
    LAUNCHES["lane_clear"] += 1
    return fp, accp


# ==================================================== frontier upload
def frontier_upload_ref(out: torch.Tensor, rows: torch.Tensor,
                        words: torch.Tensor, vals: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of ``frontier_upload`` (runtime.py:3279-3283):
    zeros, a scatter-add of the lane bits, the pad row re-zeroed."""
    out.zero_()
    out.index_put_((rows.long(), words.long()), vals, accumulate=True)
    out[out.shape[0] - 1] = 0
    return out


def frontier_upload(out: torch.Tensor, rows: torch.Tensor,
                    words: torch.Tensor, vals: torch.Tensor
                    ) -> torch.Tensor:
    """Overwrite ``out`` uint8 [n_rows + 1, W] with a fresh packed start
    frontier: lane bits ``vals[i]`` at (rows[i], words[i]).  Contract
    (runtime._upload_frontier_packed's): (row, lane) pairs deduped on
    the host, so add and or agree; padding entries aim at the pad row
    n_rows with val 0; the pad row ends zero."""
    R1, W = _frontier(out, "out")
    dev = out.device
    if rows.dim() != 1:
        raise ValueError("rows must be 1-D")
    S = rows.shape[0]
    _check(rows, "rows", torch.int32, (S,), dev)
    _check(words, "words", torch.int32, (S,), dev)
    _check(vals, "vals", torch.uint8, (S,), dev)
    if not _route(dev):
        return frontier_upload_ref(out, rows, words, vals)
    _aligned(out)
    rc = _lib().ell_frontier_upload(out.data_ptr(), rows.data_ptr(),
                                    words.data_ptr(), vals.data_ptr(), S,
                                    R1 - 1, W, _stream(dev))
    _ok(rc, "ell_frontier_upload")
    LAUNCHES["frontier_upload"] += 1
    return out


# ============================================================ ell_go
def _go_loop(f0p, tables, eslot, hrows, over, steps, upto, hop):
    if steps <= 1:
        return f0p
    acc = f0p.clone() if upto else None
    cur, buf = f0p, torch.empty_like(f0p)
    for _ in range(steps - 1):
        hop(cur, acc, buf, tables, eslot, hrows, over)
        cur, buf = buf, cur
    return acc if upto else cur


def ell_go_ref(f0p: torch.Tensor, tables: DeviceTables,
               eslot: torch.Tensor, hrows: torch.Tensor,
               over: Sequence[int], steps: int, upto: bool = False
               ) -> torch.Tensor:
    """Plain version of ``ell_go``: the same loop over ``go_hop_ref``."""
    return _go_loop(f0p, tables, eslot, hrows, over, steps, upto,
                    go_hop_ref)


def ell_go(f0p: torch.Tensor, tables: DeviceTables, eslot: torch.Tensor,
           hrows: torch.Tensor, over: Sequence[int], steps: int,
           upto: bool = False) -> torch.Tensor:
    """Batched dense GO (ell.py:572 make_batched_go_lanes_kernel, packed,
    ``count=False``): ``steps - 1`` packed hops of the start frontier
    ``f0p`` uint8 [n_rows + 1, W]; with ``upto`` the union of depths
    0 .. steps-1 (the accumulator starts as a copy of ``f0p``, the
    reference's ``fori_loop(..., (f0p, f0p))``).  The hops ping-pong
    between ``f0p`` and one spare buffer, so ``f0p`` is consumed; the
    exact-depth hops take no accumulator.  Returns the frontier."""
    _frontier(f0p, "f0p")
    out = _go_loop(f0p, tables, eslot, hrows, over, steps, upto, go_hop)
    if steps > 1 and _route(f0p.device):
        LAUNCHES["ell_go"] += 1
    return out


# ========================================================== go count
def _unpack_ref(fp: torch.Tensor) -> torch.Tensor:
    """uint8 [R, W] -> uint8 0/1 [R, 8W] (lane 8j + k = bit k of j)."""
    shifts = torch.arange(8, dtype=torch.uint8, device=fp.device)
    return ((fp[:, :, None] >> shifts) & 1).reshape(fp.shape[0], -1)


def _pack_ref(bits: torch.Tensor) -> torch.Tensor:
    """truthy [R, 8W] -> uint8 [R, W], the inverse of _unpack_ref."""
    R = bits.shape[0]
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    b8 = (bits != 0).to(torch.uint8).reshape(R, -1, 8)
    return (b8 << shifts).sum(dim=2, dtype=torch.uint8)


def go_count_ref(out: torch.Tensor, deg: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """Plain version of ``go_count`` (ell.py:612-616 ``deg @ bits``),
    one bit plane at a time: lane 8j + k of plane k sums deg over the
    rows whose byte j has bit k.  int32 with wrap-around."""
    W = out.shape[1]
    planes = counts.view(W, 8)
    d = deg.to(torch.int32)[:, None]
    for k in range(8):
        bit = ((out >> k) & 1).to(torch.int32)
        planes[:, k] = (bit * d).sum(dim=0, dtype=torch.int32)
    return counts


def go_count(out: torch.Tensor, deg: torch.Tensor, counts: torch.Tensor
             ) -> torch.Tensor:
    """Per-lane COUNT(*) of a packed frontier ``out`` uint8
    [n_rows + 1, W]: ``counts[l] = sum_r deg[r] * bit(out[r], l)`` into
    ``counts`` int32 [8W], overwritten.  ``deg`` int32 [n_rows + 1] is
    zero at extra rows and the pad row (runtime._deg_dev)."""
    R1, W = _frontier(out, "out")
    dev = out.device
    _check(deg, "deg", torch.int32, (R1,), dev)
    _check(counts, "counts", torch.int32, (8 * W,), dev)
    if W > MAX_COUNT_W:
        raise ValueError(f"W={W} lane words exceed the count kernel's "
                         f"{MAX_COUNT_W}")
    if not _route(dev):
        return go_count_ref(out, deg, counts)
    _aligned(out, deg, counts)
    rc = _lib().ell_go_count(out.data_ptr(), deg.data_ptr(),
                             counts.data_ptr(), R1, W, _stream(dev))
    _ok(rc, "ell_go_count")
    LAUNCHES["go_count"] += 1
    return counts


def ell_go_count(f0p: torch.Tensor, deg: torch.Tensor,
                 tables: DeviceTables, eslot: torch.Tensor,
                 hrows: torch.Tensor, over: Sequence[int], steps: int,
                 upto: bool = False) -> torch.Tensor:
    """ell.py:572 with ``count=True``: ``ell_go`` then ``go_count``;
    returns int32 [8W] per-lane candidate-edge counts."""
    out = ell_go(f0p, tables, eslot, hrows, over, steps, upto)
    counts = torch.empty(8 * out.shape[1], dtype=torch.int32,
                         device=out.device)
    return go_count(out, deg, counts)


# ========================================================= bfs level
def bfs_level_ref(nxt: torch.Tensor, tp: torch.Tensor, d: torch.Tensor,
                  flags: torch.Tensor, step: int, first: bool,
                  stop: bool) -> None:
    """Plain version of ``bfs_level`` (ell.py:1096-1116): the level
    body and the reductions of the loop condition."""
    bits = _unpack_ref(nxt).bool()
    inf = int(INT16_INF)
    if first:
        d.copy_(torch.where(bits, 0, inf).to(torch.int16))
        newly = bits
    else:
        newly = bits & (d == inf)
        d.masked_fill_(newly, step + 1)
        nxt.copy_(_pack_ref(newly))
    flags[0] |= newly.any().to(torch.int32)
    if stop:
        rem = _unpack_ref(tp).bool() & (d == inf)
        flags[1] |= rem.any().to(torch.int32)


def bfs_level(nxt: torch.Tensor, tp: torch.Tensor, d: torch.Tensor,
              flags: torch.Tensor, step: int, first: bool = False,
              stop: bool = True) -> None:
    """One BFS level after the hop wrote ``nxt`` uint8 [n_rows + 1, W]:
    ``newly = bit(nxt) & (d == INF)``, ``d = step + 1`` there, ``nxt``
    becomes ``pack(newly)`` in place, and ``flags`` int32 [2] (zero
    before) gets 1 in slot 0 when any lane was newly reached and, with
    ``stop``, 1 in slot 1 when any target bit of ``tp`` is still INF.
    With ``first``, ``nxt`` is the start frontier and ``d`` int16
    [n_rows + 1, 8W] is written whole: 0 on its bits, INF elsewhere."""
    R1, W = _frontier(nxt, "nxt")
    dev = nxt.device
    _check(tp, "tp", torch.uint8, (R1, W), dev)
    _check(d, "d", torch.int16, (R1, 8 * W), dev)
    _check(flags, "flags", torch.int32, (2,), dev)
    if not 0 <= step < int(INT16_INF) - 1:
        raise ValueError(f"level {step} does not fit an int16 depth")
    if not _route(dev):
        return bfs_level_ref(nxt, tp, d, flags, step, first, stop)
    _aligned(nxt, tp, flags)
    if d.data_ptr() % 16:
        raise ValueError("d must be 16-byte aligned")
    rc = _lib().ell_bfs_level(nxt.data_ptr(), tp.data_ptr(), d.data_ptr(),
                              flags.data_ptr(), step, int(first),
                              int(stop), R1, W, _stream(dev))
    _ok(rc, "ell_bfs_level")
    LAUNCHES["bfs_level"] += 1


def bfs_depth_i8_ref(d: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bfs_depth_i8`` (ell.py:1121)."""
    out.copy_(torch.where(d == int(INT16_INF), -1, d).to(torch.int8))
    return out


def bfs_depth_i8(d: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The BFS result's small form: int16 depths -> ``out`` int8 of the
    same shape, -1 where INF."""
    if d.dim() != 2:
        raise ValueError("d must be 2-D")
    dev = d.device
    _check(d, "d", torch.int16, tuple(d.shape), dev)
    _check(out, "out", torch.int8, tuple(d.shape), dev)
    if not _route(dev):
        return bfs_depth_i8_ref(d, out)
    rc = _lib().ell_bfs_depth_i8(d.data_ptr(), out.data_ptr(), d.numel(),
                                 _stream(dev))
    _ok(rc, "ell_bfs_depth_i8")
    LAUNCHES["bfs_depth_i8"] += 1
    return out


def _bfs_loop(f0p, t0p, tables, eslot, hrows, over, max_steps, stop,
              hop, level, final):
    R1, W = _frontier(f0p, "f0p")
    _check(t0p, "t0p", torch.uint8, (R1, W), f0p.device)
    if not 0 <= max_steps < int(INT16_INF) - 1:
        raise ValueError(f"max_steps={max_steps} does not fit int16")
    dev = f0p.device
    d = torch.empty((R1, 8 * W), dtype=torch.int16, device=dev)
    flags = torch.zeros((max_steps + 1, 2), dtype=torch.int32, device=dev)
    fp, buf = f0p, torch.empty_like(f0p)
    level(fp, t0p, d, flags[0], 0, True, stop)
    step = 0
    # the loop condition of ell.py:1103-1108, read back once a level
    while step < max_steps:
        f_any, t_any = flags[step].tolist()
        if not f_any or (stop and not t_any):
            break
        hop(fp, None, buf, tables, eslot, hrows, over)
        level(buf, t0p, d, flags[step + 1], step, False, stop)
        fp, buf = buf, fp
        step += 1
    if max_steps <= 120:
        d = final(d, torch.empty(d.shape, dtype=torch.int8, device=dev))
    return d, step


def ell_bfs_ref(f0p: torch.Tensor, t0p: torch.Tensor,
                tables: DeviceTables, eslot: torch.Tensor,
                hrows: torch.Tensor, over: Sequence[int], max_steps: int,
                stop_when_found: bool = True) -> Tuple[torch.Tensor, int]:
    """Plain version of ``ell_bfs``: the same loop over the plain
    versions of the hop, the level pass and the int8 form."""
    return _bfs_loop(f0p, t0p, tables, eslot, hrows, over, max_steps,
                     stop_when_found, go_hop_ref, bfs_level_ref,
                     bfs_depth_i8_ref)


def ell_bfs(f0p: torch.Tensor, t0p: torch.Tensor, tables: DeviceTables,
            eslot: torch.Tensor, hrows: torch.Tensor, over: Sequence[int],
            max_steps: int, stop_when_found: bool = True
            ) -> Tuple[torch.Tensor, int]:
    """Batched BFS depths (ell.py:1080 make_batched_bfs_lanes_kernel):
    ``f0p``/``t0p`` uint8 [n_rows + 1, W] packed start and target
    lanes (``f0p`` is consumed).  Returns (depth, levels run): depth is
    [n_rows + 1, 8W] over every row, int8 with -1 for unreached when
    ``max_steps <= 120``, else int16 with INT16_INF.  The level loop
    runs on the host and reads this level's two flags back before
    launching the next (one sync a level), so it stops exactly where
    ``jax.lax.while_loop``'s condition does."""
    return _bfs_loop(f0p, t0p, tables, eslot, hrows, over, max_steps,
                     stop_when_found, go_hop, bfs_level, bfs_depth_i8)
