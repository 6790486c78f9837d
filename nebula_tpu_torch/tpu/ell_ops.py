"""The continuous session's four device programs — the counterparts of
``nebula_tpu/tpu/ell.py:665-743`` (``ell_go_hop``, ``ell_lane_join``,
``ell_lane_extract``, ``ell_lane_clear``).

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
buffer.  Lane layout at every function here: bit k of word j is lane
8j + k (``ell.pack_lanes_host``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .ell import DeviceTables

LAUNCHES: Dict[str, int] = {"go_hop": 0, "lane_join": 0,
                            "lane_extract": 0, "lane_clear": 0}
MAX_OVER = 32        # csrc kMaxOver
MAX_BUCKETS = 32     # csrc kMaxBuckets


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


def _pair(fp: torch.Tensor, accp: torch.Tensor) -> Tuple[int, int]:
    if fp.dim() != 2:
        raise ValueError(f"fp must be [n_rows + 1, W], got {fp.shape}")
    R1, W = fp.shape
    if W % 4:
        raise ValueError(f"lane words W={W} must be a multiple of 4 "
                         f"(the kernels work on 32-bit words)")
    _check(fp, "fp", torch.uint8, (R1, W), fp.device)
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


def go_hop_ref(fp: torch.Tensor, accp: torch.Tensor, out: torch.Tensor,
               tables: DeviceTables, eslot: torch.Tensor,
               hrows: torch.Tensor, over: Sequence[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``go_hop`` (ell.py:556 _hop_body_packed and
    :541 _bucket_expand_packed): per bucket, OR over the D in-slot word
    gathers masked by the OVER etype set; buckets concatenate; extra
    rows OR-merge into their owners; the pad row is zero; accp |= out."""
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
    accp |= out
    return out, accp


def go_hop(fp: torch.Tensor, accp: torch.Tensor, out: torch.Tensor,
           tables: DeviceTables, eslot: torch.Tensor, hrows: torch.Tensor,
           over: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One packed frontier advance of every lane: ``out`` gets the next
    frontier (all of it, pad row zero), ``accp`` is OR-ed with it in
    place.  ``out`` must not alias ``fp``.  Returns (out, accp)."""
    R1, W = _pair(fp, accp)
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
    _aligned(fp, accp, out)
    desc = (ctypes.c_int64 * (3 * len(tables.D)))(
        *[v for b in range(len(tables.D))
          for v in (tables.row0[b], tables.slot0[b], tables.D[b])])
    ov = (ctypes.c_int32 * len(over))(*over)
    rc = _lib().ell_go_hop(
        fp.data_ptr(), accp.data_ptr(), out.data_ptr(),
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
