"""The port's device programs: the continuous session's four
(``nebula_tpu/tpu/ell.py:665-743``: ``ell_go_hop``, ``ell_lane_join``,
``ell_lane_extract``, ``ell_lane_clear``) and the windowed path's
packed frontier upload (``tpu/runtime.py:3251``), batched dense GO and
its COUNT(*) fold (``ell.py:572``), batched BFS (``ell.py:1080``), the
sparse pair-list GO with its COUNT(*) and LIMIT variants
(``ell.py:1222``), the adaptive single-query GO (``ell.py:1493``),
the write path's ``ell_absorb`` (``ell.py:1011``), which derives the
next mirror generation's tables from the resident ones, and the
packing-off route's int8 twins (``tpu_packed_frontier=false``): the
int8 start upload (``runtime.py:3228``), dense GO with its row pack
(``ell.py:1140``, ``:439``) and batched BFS (``ell.py:1616``), and the
replicated-frontier mesh's programs over row-sharded tables:
``ell_go_sharded`` (``ell.py:1712``), ``ell_bfs_sharded`` (``:1799``)
and ``ell_absorb_sharded`` (``:1036``), with their hop ``mesh_hop``
(M1, the hop's gather on each shard's chunk, M3, the row replication,
and the hub merge, one call over every shard of a card; for the BFS
also its level pass, once a card), the absorb's ``mesh_absorb`` (M2,
one call a card group; ``shard_absorb`` its one-member call) and
``or_many`` (``or_into`` its one-source call), and
the frontier-sharded mesh's ``mesh_sparse_go`` (``ell.py:2052``) and
``mesh_sparse_bfs`` (``:2179``) with their card stages
``mesh_route_card`` (X1), ``mesh_dedup`` (X2 and K5), ``mesh_agree``,
``mesh_emit`` (K6) and X3 ``mesh_bfs_stamp_card``, each one call over
every shard of a card.

The sparse pair-list GO and the adaptive GO run on the card as one
checked C call each (``sg_program``, ``ad_program``), whose order of
launches ``_sparse_go_steps`` and ``_adaptive_steps`` drive with the
kernels' wrappers or plain versions, on the same workspace layout
(``_sparse_plan``, ``_adaptive_plan``).

Each wrapper takes tensors on one device.  On the CPU it runs its plain
PyTorch version (``*_ref``, a transcription of the JAX function on the
same layout); on a CUDA device it launches its hand-written kernel from
``csrc/ell_lanes.cu``, ``csrc/sparse_go.cu``, ``csrc/ell_absorb.cu``,
``csrc/ell_int8.cu``, ``csrc/ell_mesh.cu`` or ``csrc/mesh_sparse.cu``
and adds one to its entry in ``LAUNCHES``, or raises — there is no
fallback from one to the other.  Any other device raises.

The reference's kernels are pure and donate the pair; the port updates
in place where it can and says so per function: join, clear and the
hop's ``accp`` union write the carriers in place, the hop's new
frontier goes to a separate ``out`` buffer (its gathers read the
previous generation), and extract writes a fresh ``[n_rows + 1, P]``
buffer.  ``ell_go`` and ``ell_bfs`` (and their int8 twins) consume
their start frontier (it becomes one of their two ping-pong buffers).
Lane layout at every packed function here: bit k of word j is lane
8j + k (``ell.pack_lanes_host``); the int8 carrier holds one byte a
lane.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from .mesh import MAX_CARD_SHARDS
from .ell import (INT16_INF, DeviceTables, lanes_width, sparse_limit_cap,
                  sparse_pack32)

LAUNCHES: Dict[str, int] = {"go_hop": 0, "lane_join": 0,
                            "lane_extract": 0, "lane_clear": 0,
                            "frontier_upload": 0, "ell_go": 0,
                            "go_count": 0, "bfs_level": 0,
                            "bfs_depth_i8": 0, "sparse_expand": 0,
                            "pair_compact": 0, "pair_reduce": 0,
                            "adaptive_switch": 0, "bitmap_lanes": 0,
                            "sparse_go": 0, "sparse_go_count": 0,
                            "sparse_go_limit": 0, "adaptive_go": 0,
                            "ell_absorb": 0, "frontier_upload_i8": 0,
                            "go_hop_i8": 0, "pack_rows": 0,
                            "bfs_level_i8": 0, "ell_go_i8": 0,
                            "ell_bfs_i8": 0, "shard_hop": 0,
                            "hop_merge": 0, "replicate_rows": 0,
                            "or_into": 0,
                            "shard_absorb": 0, "ell_go_sharded": 0,
                            "ell_bfs_sharded": 0, "ell_absorb_sharded": 0,
                            "mesh_route": 0, "mesh_mark": 0,
                            "mesh_bfs_stamp": 0, "mesh_sparse_go": 0,
                            "mesh_sparse_bfs": 0, "mesh_hop": 0,
                            "mesh_dedup": 0, "mesh_agree": 0,
                            "mesh_emit": 0, "mesh_level": 0}
MAX_OVER = 32        # csrc kMaxOver
MAX_BUCKETS = 32     # csrc kMaxBuckets
MAX_COUNT_W = 1024   # csrc ell_go_count: W / 4 <= kThreads
COUNT_STATE_WORDS = 16 * 8192 + 1  # csrc kCountReplicas * 8W, the ticket


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
    return _build._lib or _build.load()


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _ok(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cuda error {rc}")


def _bucket_desc(tables: DeviceTables):
    """The buckets' (row0, slot0, D) triples as the host int64 array the
    kernels take by value (made once per bucket geometry)."""
    return _bucket_desc_of(tables.row0, tables.slot0, tables.D)


@functools.lru_cache(maxsize=64)
def _bucket_desc_of(row0, slot0, D):
    return (ctypes.c_int64 * (3 * len(D)))(
        *[v for b in range(len(D)) for v in (row0[b], slot0[b], D[b])])


def _over_check(over: Sequence[int]) -> Tuple[int, ...]:
    """The OVER set sorted and deduplicated (once per set)."""
    return _over_sorted(tuple(over))


@functools.lru_cache(maxsize=256)
def _over_sorted(over: Tuple[int, ...]) -> Tuple[int, ...]:
    over = tuple(sorted(set(int(e) for e in over)))
    if not 0 < len(over) <= MAX_OVER:
        raise ValueError(f"OVER set of {len(over)} etypes (1..{MAX_OVER})")
    return over


@functools.lru_cache(maxsize=256)
def _over_array(over: Tuple[int, ...]):
    """A checked OVER set as the host int32 array the kernels take."""
    return (ctypes.c_int32 * len(over))(*over)


def _tables_check(tables: DeviceTables, dev: torch.device) -> None:
    _check(tables.nbr, "tables.nbr", torch.int32,
           tuple(tables.nbr.shape), dev)
    _check(tables.et, "tables.et", torch.int32, tuple(tables.nbr.shape),
           dev)
    if not 0 < len(tables.D) <= MAX_BUCKETS:
        raise ValueError(f"{len(tables.D)} buckets (1..{MAX_BUCKETS})")


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


HOP_THREADS = 256    # csrc ell_lanes.cu kThreads: a hop block's threads
HOP_CHUNK = 8        # csrc kChunk: the slots a hop lane holds at once


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def hop_plan(rows: Sequence[int], D: Sequence[int], W: int, unit: int,
             cols: int = 1, lead: Sequence[int] = ()
             ) -> Tuple[int, Tuple[int, ...], Tuple[int, ...], int]:
    """The hop kernel's launch plan for buckets of ``rows[b]`` rows of
    ``D[b]`` slots at W frontier bytes a row: ``(lgc, lg, blk0,
    blocks)``.  Cg = 2^lgc lanes split a row's columns; G = 2^lg[b]
    lanes own one row of bucket b; a block takes HOP_THREADS / G
    consecutive rows of ONE bucket; bucket b's blocks are blk0[b] ..
    blk0[b] + ceil(rows[b] * G / HOP_THREADS); ``blocks`` is the grid.
    The kernel runs this plan as given (its entry checks only that it
    is safe to run).

    The rule: a row's C = W / ``unit`` columns (``unit`` bytes each: 16
    on the kernels' 16-byte path, else 4, or 1 on the int8 hop's byte
    path), ``cols`` of them a lane (the int8 hop's 16-byte path takes
    several: one slot scan serves them all), go to Cg = min(32, the
    power of two >= ceil(C / cols)) lanes, and its D slots to P =
    min(32 / Cg, the power of two >= ceil(D / HOP_CHUNK)) parts, so a
    lane holds about HOP_CHUNK slots; G = Cg * P <= 32.  ``lead[b]``
    (default none): places before bucket b's first row that its first
    block leaves idle (the int8 hop's row-packed last advance starts a
    bucket's blocks at the 8-row group holding its first row)."""
    cg = min(32, _pow2_at_least(-(-(W // unit) // cols)))
    lg, blk0, blocks = [], [], 0
    for b, (r, d) in enumerate(zip(rows, D)):
        g = cg * min(32 // cg, _pow2_at_least(-(-int(d) // HOP_CHUNK)))
        lg.append(g.bit_length() - 1)
        blk0.append(blocks)
        places = int(r) + (int(lead[b]) if lead and r else 0)
        blocks += -(-places * g // HOP_THREADS)
    return cg.bit_length() - 1, tuple(lg), tuple(blk0), blocks


@functools.lru_cache(maxsize=64)
def _hop_desc(row0, slot0, rows, D, W: int, unit: int, cols: int = 1,
              packed: bool = False):
    """``hop_plan`` as ``ell_go_hop`` and ``i8_go_hop`` take it: (the
    host int64 array of (row0, slot0, rows, D, lg, blk0) per bucket, the
    grid (at least one block: block 0 zeroes the pad row), lgc), made
    once per geometry, width, column unit and columns a lane; with
    ``packed`` each bucket's blocks start at the 8-row group holding its
    first row (``lead`` = row0 % 8, the int8 hop's row-packed advance)."""
    lgc, lg, blk0, blocks = hop_plan(
        rows, D, W, unit, cols, tuple(r % 8 for r in row0) if packed else ())
    desc = (ctypes.c_int64 * (6 * len(D)))(
        *[v for b in range(len(D))
          for v in (row0[b], slot0[b], rows[b], D[b], lg[b], blk0[b])])
    return desc, max(1, blocks), lgc


def go_hop(fp: torch.Tensor, accp: Optional[torch.Tensor],
           out: torch.Tensor, tables: DeviceTables, eslot: torch.Tensor,
           hrows: torch.Tensor, over: Sequence[int]
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One packed frontier advance of every lane: ``out`` gets the next
    frontier (all of it, pad row zero), ``accp`` is OR-ed with it in
    place (``accp=None``: no union, as exact-depth GO and BFS need).
    ``out`` must not alias ``fp``.  Returns (out, accp).  On the card
    one gather launch (``hop_plan``'s grid; the union fused into it)
    and, with hub extra rows, the merge."""
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
    _tables_check(tables, dev)
    over = _over_check(over)
    if not _route(dev):
        return go_hop_ref(fp, accp, out, tables, eslot, hrows, over)
    fpp, outp = fp.data_ptr(), out.data_ptr()
    accpp = None if accp is None else accp.data_ptr()
    at = fpp | outp | (accpp or 0)
    if at % 4:
        raise ValueError("kernel operands must be 4-byte aligned "
                         "(the kernels work on 32-bit words)")
    wide = W % 16 == 0 and not at % 16
    desc, blocks, lgc = _hop_desc(tables.row0, tables.slot0, tables.rows,
                                  tables.D, W, 16 if wide else 4)
    rc = _lib().ell_go_hop(
        fpp, accpp, outp, tables.nbr.data_ptr(), tables.et.data_ptr(),
        desc, len(tables.D), blocks, lgc, wide, eslot.data_ptr(),
        hrows.data_ptr(), n_extras, _over_array(over), len(over), tables.n,
        tables.n_rows, W, None, 0, _stream(dev))
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
def frontier_upload_ref(out: torch.Tensor, coords: torch.Tensor
                        ) -> torch.Tensor:
    """Plain version of ``frontier_upload`` (runtime.py:3279-3283): a
    zero frontier with each entry's lane bit set, entries off the real
    rows or lanes skipped, a repeated entry set once.  Refuses entries
    out of (row, lane) order, which the kernel's searches assume."""
    R1, W = out.shape
    rows, lanes = coords.long()
    at = rows * (8 * W) + lanes
    if bool((at[1:] < at[:-1]).any()):
        raise ValueError("coords must be sorted by (row, lane)")
    keep = (rows >= 0) & (rows < R1 - 1) & (lanes >= 0) & (lanes < 8 * W)
    key = torch.unique(rows[keep] * (8 * W) + lanes[keep])
    bits = torch.bitwise_left_shift(torch.ones_like(key), key & 7)
    out.zero_()
    out.view(-1).index_put_((key >> 3,), bits.to(torch.uint8),
                            accumulate=True)
    return out


def frontier_upload(out: torch.Tensor, coords: torch.Tensor
                    ) -> torch.Tensor:
    """Overwrite ``out`` uint8 [n_rows + 1, W] with a fresh packed start
    frontier: lane ``coords[1, i]`` of row ``coords[0, i]`` set.
    ``coords`` int32 [2, S] is sorted by (row, lane) (the order
    runtime._upload_frontier_packed's dedup leaves), its lanes in
    [0, 8W); an entry at the pad row n_rows or beyond is skipped, so the
    pad row ends zero.  One launch on the card, which writes every byte
    of ``out`` once and reads none."""
    R1, W = _frontier(out, "out")
    dev = out.device
    if not isinstance(coords, torch.Tensor) or coords.dim() != 2:
        raise ValueError("coords must be an int32 [2, S] tensor")
    S = coords.shape[1]
    _check(coords, "coords", torch.int32, (2, S), dev)
    if not _route(dev):
        return frontier_upload_ref(out, coords)
    if out.data_ptr() % 16:
        raise ValueError("out must be 16-byte aligned")
    _aligned(coords)
    ptr = coords.data_ptr()
    rc = _lib().ell_frontier_upload(out.data_ptr(), ptr, ptr + 4 * S, S,
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


_COUNT_STATE: Dict[str, torch.Tensor] = {}


def count_state(device: torch.device) -> torch.Tensor:
    """The int32 [COUNT_STATE_WORDS] state of ``go_count`` on ``device``
    (csrc ell_go_count: its blocks' replicated lane sums and its ticket):
    zero when made, and each call leaves it zero, so calls in one
    stream's order share it."""
    key = str(torch.device(device))
    t = _COUNT_STATE.get(key)
    if t is None:
        t = _COUNT_STATE.setdefault(key, torch.zeros(
            COUNT_STATE_WORDS, dtype=torch.int32, device=device))
    return t


def go_count(out: torch.Tensor, deg: torch.Tensor, counts: torch.Tensor
             ) -> torch.Tensor:
    """Per-lane COUNT(*) of a packed frontier ``out`` uint8
    [n_rows + 1, W]: ``counts[l] = sum_r deg[r] * bit(out[r], l)`` into
    ``counts`` int32 [8W], overwritten.  ``deg`` int32 [n_rows + 1] is
    zero at extra rows and the pad row (runtime._deg_dev).  One launch
    on the card, on ``count_state(device)``."""
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
                             counts.data_ptr(), count_state(dev).data_ptr(),
                             COUNT_STATE_WORDS, R1, W, _stream(dev))
    _ok(rc, "ell_go_count")
    LAUNCHES["go_count"] += 1
    return counts


def ell_go_count_ref(f0p: torch.Tensor, deg: torch.Tensor,
                     tables: DeviceTables, eslot: torch.Tensor,
                     hrows: torch.Tensor, over: Sequence[int], steps: int,
                     upto: bool = False) -> torch.Tensor:
    """Plain version of ``ell_go_count``: ``ell_go_ref`` then
    ``go_count_ref``."""
    out = ell_go_ref(f0p, tables, eslot, hrows, over, steps, upto)
    counts = torch.empty(8 * out.shape[1], dtype=torch.int32,
                         device=out.device)
    return go_count_ref(out, deg, counts)


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
def depth_dtype(max_steps: int) -> torch.dtype:
    """The BFS result's form, which the packed programs also keep their
    depth matrix in (ell.py:1097, :1119-1121): int8 with -1 for unreached
    when ``max_steps <= 120``, else int16 with INT16_INF."""
    return torch.int8 if max_steps <= 120 else torch.int16


def _unreached(d: torch.Tensor) -> int:
    return -1 if d.dtype == torch.int8 else int(INT16_INF)


def bfs_level_ref(nxt: torch.Tensor, tp: torch.Tensor, seen: torch.Tensor,
                  d: torch.Tensor, flags: torch.Tensor, step: int,
                  first: bool, stop: bool) -> None:
    """Plain version of ``bfs_level``: the reference's level body
    (ell.py:1110-1115) and the reductions of its loop condition
    (:1103-1108) on the packed reached bitmap ``seen`` instead of
    ``d == INF``."""
    if first:
        seen.copy_(nxt)
        d.copy_(torch.where(_unpack_ref(nxt).bool(), 0, _unreached(d))
                .to(d.dtype))
        newly = nxt
    else:
        newly = nxt & ~seen
        seen |= newly
        d.masked_fill_(_unpack_ref(newly).bool(), step + 1)
        nxt.copy_(newly)
    flags[0] |= bool(newly.any())
    if stop:
        flags[1] |= bool((tp & ~seen).any())


def _level_operands(R1: int, W: int, tp, seen, d, flags, step: int,
                    dev: torch.device) -> None:
    _check(tp, "tp", torch.uint8, (R1, W), dev)
    _check(seen, "seen", torch.uint8, (R1, W), dev)
    if not isinstance(d, torch.Tensor) or d.dtype not in (torch.int8,
                                                          torch.int16):
        raise TypeError("d must be an int8 or int16 tensor")
    _check(d, "d", d.dtype, (R1, 8 * W), dev)
    _check(flags, "flags", torch.int32, (2,), dev)
    top = 127 if d.dtype == torch.int8 else int(INT16_INF)
    if not 0 <= step < top - 1:
        raise ValueError(f"level {step} does not fit a {d.dtype} depth")


def _level_aligned(nxt, tp, seen, d, flags) -> None:
    _aligned(nxt, tp, seen, flags)
    if d.data_ptr() % 16:
        raise ValueError("d must be 16-byte aligned")


def bfs_level(nxt: torch.Tensor, tp: torch.Tensor, seen: torch.Tensor,
              d: torch.Tensor, flags: torch.Tensor, step: int,
              first: bool = False, stop: bool = True) -> None:
    """K3, one BFS level after the hop wrote ``nxt`` uint8 [n_rows + 1,
    W]: ``newly = nxt & ~seen``, ``seen |= newly`` (uint8 [n_rows + 1,
    W], the lanes reached so far), ``d = step + 1`` at the newly lanes,
    ``nxt`` becomes ``newly`` in place, and ``flags`` int32 [2] (zero
    before) gets 1 in slot 0 when any lane was newly reached and, with
    ``stop``, 1 in slot 1 when any target bit of ``tp`` is still
    unreached.  With ``first``, ``nxt`` is the start frontier (left as it
    is), ``seen`` becomes it and ``d`` [n_rows + 1, 8W] is written whole:
    0 on its bits, the unreached value elsewhere.  ``d`` is int8 (-1
    unreached) or int16 (INT16_INF); no pass reads it."""
    R1, W = _frontier(nxt, "nxt")
    dev = nxt.device
    _level_operands(R1, W, tp, seen, d, flags, step, dev)
    if not _route(dev):
        return bfs_level_ref(nxt, tp, seen, d, flags, step, first, stop)
    _level_aligned(nxt, tp, seen, d, flags)
    rc = _lib().ell_bfs_level(nxt.data_ptr(), tp.data_ptr(),
                              seen.data_ptr(), d.data_ptr(), d.element_size(),
                              flags.data_ptr(), step, int(first), int(stop),
                              R1, W, _stream(dev))
    _ok(rc, "ell_bfs_level")
    LAUNCHES["bfs_level"] += 1


def bfs_depth_i8_ref(d: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``bfs_depth_i8`` (ell.py:1121)."""
    out.copy_(torch.where(d == int(INT16_INF), -1, d).to(torch.int8))
    return out


def bfs_depth_i8(d: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The BFS result's small form: int16 depths -> ``out`` int8 of the
    same shape, -1 where INF.  No program runs it: every level pass
    keeps ``d`` in the result's form (``depth_dtype``)."""
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


def _bfs_levels(f0, tables, eslot, hrows, over, max_steps, stop, hop,
                level, read=None) -> int:
    """The BFS programs' loop, on either carrier: the first pass, then a
    hop and a level while the loop condition holds; returns the levels
    run.  ``level(nxt, flag, step, first)`` is the carrier's level pass
    bound to its state.  ``read(flag)``: a level's two flags on the host,
    by default one copy, or given back by a caller that knows what a run
    reads (nothing then waits on the card)."""
    if not 0 <= max_steps < int(INT16_INF) - 1:
        raise ValueError(f"max_steps={max_steps} does not fit int16")
    flags = torch.zeros((max_steps + 1, 2), dtype=torch.int32,
                        device=f0.device)
    fp, buf = f0, torch.empty_like(f0)
    level(fp, flags[0], 0, True)
    step = 0
    read = read or (lambda flag: flag.tolist())
    # the loop condition of ell.py:1103-1108 (:1634-1641 on the int8
    # carrier), read back once a level
    while step < max_steps:
        f_any, t_any = read(flags[step])
        if not f_any or (stop and not t_any):
            break
        hop(fp, None, buf, tables, eslot, hrows, over)
        level(buf, flags[step + 1], step, False)
        fp, buf = buf, fp
        step += 1
    return step


def _bfs_loop(f0p, t0p, tables, eslot, hrows, over, max_steps, stop, hop,
              level, read=None):
    """The packed BFS program: ``seen`` and ``d`` (in the result's form,
    ``depth_dtype``) are its state; ``read`` as ``_bfs_levels``'."""
    d = torch.empty((f0p.shape[0], 8 * f0p.shape[1]),
                    dtype=depth_dtype(max_steps), device=f0p.device)
    seen = torch.empty_like(f0p)
    step = _bfs_levels(f0p, tables, eslot, hrows, over, max_steps, stop,
                       hop, lambda nxt, flag, at, first: level(
                           nxt, t0p, seen, d, flag, at, first, stop),
                       read)
    return d, step


def _bfs_pair(f0p: torch.Tensor, t0p: torch.Tensor) -> None:
    """Check the packed start/target pair."""
    R1, W = _frontier(f0p, "f0p")
    _check(t0p, "t0p", torch.uint8, (R1, W), f0p.device)


def ell_bfs_ref(f0p: torch.Tensor, t0p: torch.Tensor,
                tables: DeviceTables, eslot: torch.Tensor,
                hrows: torch.Tensor, over: Sequence[int], max_steps: int,
                stop_when_found: bool = True) -> Tuple[torch.Tensor, int]:
    """Plain version of ``ell_bfs``: the same loop over the plain
    versions of the hop and the level pass."""
    _bfs_pair(f0p, t0p)
    return _bfs_loop(f0p, t0p, tables, eslot, hrows, over, max_steps,
                     stop_when_found, go_hop_ref, bfs_level_ref)


def ell_bfs(f0p: torch.Tensor, t0p: torch.Tensor, tables: DeviceTables,
            eslot: torch.Tensor, hrows: torch.Tensor, over: Sequence[int],
            max_steps: int, stop_when_found: bool = True
            ) -> Tuple[torch.Tensor, int]:
    """Batched BFS depths (ell.py:1080 make_batched_bfs_lanes_kernel):
    ``f0p``/``t0p`` uint8 [n_rows + 1, W] packed start and target
    lanes (``f0p`` is consumed).  Returns (depth, levels run): depth is
    [n_rows + 1, 8W] over every row, int8 with -1 for unreached when
    ``max_steps <= 120``, else int16 with INT16_INF, the form the
    level pass keeps it in (no pass converts it).  The level loop runs
    on the host and reads this level's two flags back before launching
    the next (one sync a level), so it stops exactly where
    ``jax.lax.while_loop``'s condition does."""
    _bfs_pair(f0p, t0p)
    return _bfs_loop(f0p, t0p, tables, eslot, hrows, over, max_steps,
                     stop_when_found, go_hop, bfs_level)


# ====================================================================
# Packing off (``tpu_packed_frontier=false``): the int8 carrier, one
# byte a query lane — int8 [n_rows + 1, B], lane b of row r at r*B + b,
# any B >= 1 — and csrc/ell_int8.cu's K12 upload, K13 hop (with the
# row pack fused into a packed GO's last advance), K14 row pack (a GO
# with no advance) and K15 BFS level pass (on lane bitmaps, as K3).
# The plain versions compute what the reference computes on the whole
# int8 domain (a signed max, live = a signed > 0), not only on 0/1
# lanes.
# ====================================================================
def _carrier(f: torch.Tensor, name: str) -> Tuple[int, int]:
    if not isinstance(f, torch.Tensor) or f.dim() != 2:
        raise ValueError(f"{name} must be a [n_rows + 1, B] tensor")
    R1, B = f.shape
    if R1 < 1 or B < 1:
        raise ValueError(f"{name} has shape {tuple(f.shape)}")
    _check(f, name, torch.int8, (R1, B), f.device)
    return R1, B


def frontier_upload_i8_ref(out: torch.Tensor, rows: torch.Tensor,
                           cols: torch.Tensor, S: int) -> torch.Tensor:
    """Plain version of ``frontier_upload_i8`` (runtime.py:3228-3248):
    zeros, then a scatter-max of 1 at the first ``S`` entries and of 0
    at the rest; entries out of range drop."""
    R1, B = out.shape
    out.zero_()
    vals = torch.zeros(rows.shape[0], dtype=torch.int8, device=out.device)
    vals[:S] = 1
    r, c = rows.long(), cols.long()
    keep = (r >= 0) & (r < R1) & (c >= 0) & (c < B)
    out.view(-1).scatter_reduce_(0, r[keep] * B + c[keep], vals[keep],
                                 "amax")
    return out


def frontier_upload_i8(out: torch.Tensor, rows: torch.Tensor,
                       cols: torch.Tensor, S: int) -> torch.Tensor:
    """K12: overwrite ``out`` int8 [n_rows + 1, B] with a fresh start
    frontier — 1 at (rows[i], cols[i]) for i < S, zero elsewhere.
    ``rows``/``cols`` int32 [Sp] are the reference's padded lists: the
    entries past S are padding aimed at the pad row n_rows with value
    0, so it ends zero.  Duplicates need no dedup (every value is 1)."""
    R1, B = _carrier(out, "out")
    dev = out.device
    Sp = _vec(rows, "rows", torch.int32, dev)
    _vec(cols, "cols", torch.int32, dev, Sp)
    if not 0 <= S <= Sp:
        raise ValueError(f"S={S} live entries of {Sp}")
    if not _route(dev):
        return frontier_upload_i8_ref(out, rows, cols, S)
    rc = _lib().i8_frontier_upload(out.data_ptr(), rows.data_ptr(),
                                   cols.data_ptr(), Sp, S, R1, B,
                                   _stream(dev))
    _ok(rc, "i8_frontier_upload")
    LAUNCHES["frontier_upload_i8"] += 1
    return out


def live_words(R1: int) -> int:
    """int32 words of a live bitmap over R1 carrier rows (bit r % 32 of
    word r // 32 is row r)."""
    return (R1 + 31) // 32


def live_bitmap(rows: torch.Tensor) -> torch.Tensor:
    """A bool [R1] row mask as K13's live bitmap, int32 [live_words(R1)]."""
    R1 = rows.shape[0]
    bits = torch.zeros(32 * live_words(R1), dtype=torch.int64,
                       device=rows.device)
    bits[:R1] = rows.to(torch.int64)
    w = (bits.view(-1, 32) << torch.arange(32, device=rows.device)).sum(1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def live_rows(words: torch.Tensor, R1: int) -> torch.Tensor:
    """The bool [R1] row mask of a live bitmap (``live_bitmap``'s
    inverse)."""
    sh = torch.arange(32, device=words.device)
    return ((words.to(torch.int64)[:, None] >> sh) & 1).view(-1)[:R1] != 0


def row_live_i8_ref(f: torch.Tensor) -> torch.Tensor:
    """Plain version of K13's row-live pass: the live bitmap of the rows
    of ``f`` that hold a byte > 0 (signed); the pad row's bit is 0."""
    rows = (f > 0).any(dim=1)
    rows[-1] = False
    return live_bitmap(rows)


def _gather_i8_ref(f: torch.Tensor, out: torch.Tensor, tables: DeviceTables,
                   over: Sequence[int], live_in: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """K13's gather, plain: per bucket, the max over the D in-slots of
    f[nbr] * ok(et) from 0, into ``out``'s bucket rows; a slot whose
    source row has a 0 bit in ``live_in`` (default: ``row_live_i8_ref(f)``)
    gathers nothing; the pad row zero."""
    R1, B = f.shape
    over_t = torch.tensor(sorted(set(int(e) for e in over)),
                          dtype=torch.int32, device=f.device)
    src_ok = live_rows(row_live_i8_ref(f) if live_in is None else live_in,
                       R1)
    for b in range(len(tables.D)):
        nbr, et = tables.bucket(b)
        ok = (torch.isin(et, over_t) & src_ok[nbr.long()]).to(torch.int8)
        a = torch.zeros((nbr.shape[0], B), dtype=torch.int8,
                        device=f.device)
        for j in range(nbr.shape[1]):
            a = torch.maximum(a, f[nbr[:, j].long()] * ok[:, j, None])
        r0 = tables.row0[b]
        out[r0:r0 + nbr.shape[0]] = a
    out[tables.n_rows] = 0
    return out


def _hub_owners(tables: DeviceTables, eslot: torch.Tensor,
                hrows: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The extra rows' owners (``hrows[eslot]``) and which of them merge:
    owners >= n_rows are unclaimed growth spares, which drop."""
    owner = hrows[eslot.long()].long()
    return owner, (owner >= 0) & (owner < tables.n_rows)


def go_hop_i8_ref(f: torch.Tensor, acc: Optional[torch.Tensor],
                  out: torch.Tensor, tables: DeviceTables,
                  eslot: torch.Tensor, hrows: torch.Tensor,
                  over: Sequence[int], live_in: Optional[torch.Tensor] = None,
                  live_out: Optional[torch.Tensor] = None,
                  pack: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of ``go_hop_i8`` (ell.py:386 _hop_body and :368
    _bucket_expand): per bucket, the max over the D in-slots of
    f[nbr] * ok(et) from 0; buckets concatenate; the extra rows max
    into their owners (owners >= n_rows drop); the pad row is zero;
    acc = max(acc, out) when an accumulator is given.  The kernel's skip
    rule is applied as it is: a slot whose source row has a 0 bit in
    ``live_in`` (default: ``row_live_i8_ref(f)``) gathers nothing, which
    changes nothing while ``live_in`` covers every row with a byte > 0.
    ``live_out`` gets ``row_live_i8_ref(out)``.  With ``pack``, the
    kernel's fused last advance: the gathered rows' bits (with ``acc``
    OR its bits), then each merging extra row's bits ORed into its
    owner's, row-packed into ``pack`` (``pack_rows_ref``); ``out`` gets
    the extra rows alone and ``acc`` is not written."""
    n, n_rows = tables.n, tables.n_rows
    if pack is not None:
        g = _gather_i8_ref(f, torch.empty_like(out), tables, over, live_in)
        bits = (g > 0) if acc is None else (g > 0) | (acc > 0)
        if n_rows > n:
            owner, live = _hub_owners(tables, eslot, hrows)
            hub = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
            hub.index_put_((owner[live],), (g[n:n_rows][live] > 0)
                           .to(torch.int32), accumulate=True)
            bits |= hub > 0
            out[n:n_rows] = g[n:n_rows]
        return pack_rows_ref(bits.to(torch.int8), pack), acc
    _gather_i8_ref(f, out, tables, over, live_in)
    if n_rows > n:
        owner, live = _hub_owners(tables, eslot, hrows)
        body = out[:n_rows]
        ext = body[n:][live]
        body.scatter_reduce_(0, owner[live][:, None].expand(-1, f.shape[1]),
                             ext, "amax")
    if acc is not None:
        torch.maximum(acc, out, out=acc)
    if live_out is not None:
        live_out.copy_(row_live_i8_ref(out))
    return out, acc


def i8_hop_cols(B: int, unit: int) -> int:
    """The columns a lane of K13 takes (``hop_plan``'s ``cols``, which
    the kernel's entry takes as given): on 16-byte columns four up to B
    = 256 (B = 128: a row's 8 columns on 2 lanes) and two above (B =
    1024: 64 columns on 32 lanes), so one slot scan serves several and a
    warp holds more rows; one on the narrower column paths."""
    return 1 if unit != 16 else 4 if B <= 256 else 2


def go_hop_i8(f: torch.Tensor, acc: Optional[torch.Tensor],
              out: torch.Tensor, tables: DeviceTables, eslot: torch.Tensor,
              hrows: torch.Tensor, over: Sequence[int],
              live_in: Optional[torch.Tensor] = None,
              live_out: Optional[torch.Tensor] = None,
              pack: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K13, one int8 frontier advance of every lane: ``out`` gets the
    next frontier (all of it, pad row zero), ``acc`` (None: no UPTO
    union) becomes max(acc, out) in place.  The hub merge takes
    ``go_hop``'s (eslot, hrows).  ``out`` must not alias ``f``; the pad
    row of ``f`` is zero, as everywhere.

    ``pack`` (a row-packed GO's last advance, ``ell.py:439`` fused):
    uint8 [ceil((n_rows + 1) / 8), B] (``pack_rows``' layout, its storage
    holding whole 4-byte words: ``packed_rows``) gets the result — the
    advance's rows > 0, with ``acc`` or its rows > 0 — and is returned
    in ``out``'s place; ``out`` then gets only the extra rows (the hub
    pass reads them), ``acc`` is read and not written, and ``live_out``
    must be None.

    ``live_in`` / ``live_out``: row bitmaps, int32
    [live_words(n_rows + 1)] (``live_bitmap``, ``live_rows``).  Source
    rows whose ``live_in`` bit is 0 are not gathered, which is exact
    while ``live_in`` is a superset of the rows of ``f`` that hold a
    byte > 0 (a row of bytes <= 0 cannot raise a max from 0).  Without
    ``live_in`` one read pass over ``f`` makes it (a program's first
    hop).  ``live_out`` gets exactly the rows of ``out`` with a byte >
    0, the next hop's ``live_in``.  Returns (out, acc).  On the card the
    pass (without ``live_in``), with ``pack`` a memset of the result,
    one gather launch (``hop_plan``'s grid, the UPTO max fused into it)
    and, with hub extra rows, the hub pass: one count under
    ``LAUNCHES["go_hop_i8"]``."""
    R1, B = _carrier(f, "f")
    dev = f.device
    _check(out, "out", torch.int8, (R1, B), dev)
    if acc is not None:
        _check(acc, "acc", torch.int8, (R1, B), dev)
    if out.data_ptr() == f.data_ptr():
        raise ValueError("out must be a separate buffer from f")
    if R1 != tables.n_rows + 1:
        raise ValueError(f"carrier has {R1} rows, tables "
                         f"{tables.n_rows + 1}")
    for name, v in (("live_in", live_in), ("live_out", live_out)):
        if v is not None:
            _check(v, name, torch.int32, (live_words(R1),), dev)
    if live_in is not None and live_out is not None \
            and live_in.data_ptr() == live_out.data_ptr():
        raise ValueError("live_out must be a separate buffer from live_in")
    if pack is not None:
        _check(pack, "pack", torch.uint8, (-(-R1 // 8), B), dev)
        if live_out is not None:
            raise ValueError("a row-packed advance writes no live_out")
    n_extras = tables.n_rows - tables.n
    _check(eslot, "eslot", torch.int32, (n_extras,), dev)
    _vec(hrows, "hrows", torch.int32, dev)
    _tables_check(tables, dev)
    over = _over_check(over)
    if not _route(dev):
        return go_hop_i8_ref(f, acc, out, tables, eslot, hrows, over,
                             live_in, live_out, pack)
    _aligned(f, out, *(() if acc is None else (acc,)))
    if pack is not None:
        _aligned(pack)
        if pack.untyped_storage().nbytes() < pack.storage_offset() \
                + -(-pack.numel() // 4) * 4:
            raise ValueError("pack's storage must hold whole 4-byte words "
                             "(packed_rows)")
    lib, stream = _lib(), _stream(dev)
    if live_in is None:
        live_in = torch.empty(live_words(R1), dtype=torch.int32, device=dev)
        _ok(lib.i8_row_live(f.data_ptr(), live_in.data_ptr(), R1 - 1, B,
                            stream), "i8_row_live")
    at = f.data_ptr() | out.data_ptr() \
        | (0 if acc is None else acc.data_ptr()) \
        | (0 if pack is None else pack.data_ptr())
    unit = 16 if B % 16 == 0 and not at % 16 else 4 if B % 4 == 0 else 1
    cols = i8_hop_cols(B, unit)
    desc, blocks, lgc = _hop_desc(tables.row0, tables.slot0, tables.rows,
                                  tables.D, B, unit, cols, pack is not None)
    rc = lib.i8_go_hop(
        f.data_ptr(), None if acc is None else acc.data_ptr(),
        out.data_ptr(), live_in.data_ptr(),
        None if live_out is None else live_out.data_ptr(),
        None if pack is None else pack.data_ptr(),
        tables.nbr.data_ptr(), tables.et.data_ptr(), desc, len(tables.D),
        blocks, lgc, unit, cols, eslot.data_ptr(), hrows.data_ptr(),
        n_extras, _over_array(over), len(over), tables.n, tables.n_rows, B,
        stream)
    _ok(rc, "i8_go_hop")
    LAUNCHES["go_hop_i8"] += 1
    return (out if pack is None else pack), acc


def _live_chain(hop, R1: int, dev: torch.device):
    """``hop`` (``go_hop_i8`` or its plain version) as a program's hop
    in ``go_hop``'s form: each call passes the previous call's
    ``live_out`` as its ``live_in`` (the first call none, so it runs the
    row-live pass), the two arrays taking turns.  Between two calls the
    program may only lower bytes of the frontier (K15 does: ``nxt``
    becomes ``newly``), so every array passed on stays a superset of
    the rows with a byte > 0.  A call with ``pack`` (the row-packed last
    advance) passes no ``live_out`` and returns the packed result."""
    live = [torch.empty(live_words(R1), dtype=torch.int32, device=dev)
            for _ in range(2)]
    prev: list = [None]

    def step(f, acc, out, tables, eslot, hrows, over, pack=None):
        if pack is not None:
            return hop(f, acc, out, tables, eslot, hrows, over, prev[0],
                       None, pack)
        nxt = live[1] if prev[0] is live[0] else live[0]
        hop(f, acc, out, tables, eslot, hrows, over, prev[0], nxt)
        prev[0] = nxt
        return out, acc
    return step


def packed_rows(R1: int, B: int, device) -> torch.Tensor:
    """A row-packed result's buffer, uint8 [ceil(R1 / 8), B], its storage
    rounded up to whole 4-byte words (the fused pack ORs by words)."""
    G = -(-R1 // 8)
    return torch.empty(-(-G * B // 4) * 4, dtype=torch.uint8,
                       device=device)[:G * B].view(G, B)


def pack_rows_ref(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of ``pack_rows`` (ell.py:439 pack_bits)."""
    R1, B = x.shape
    G = out.shape[0]
    padded = torch.zeros((8 * G, B), dtype=torch.uint8, device=x.device)
    padded[:R1] = (x > 0).to(torch.uint8)
    w = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                     device=x.device)
    out.copy_((padded.view(G, 8, B) * w[None, :, None])
              .sum(dim=1, dtype=torch.uint8))
    return out


def pack_rows(x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K14: bit-pack ``x`` int8 [R1, B] along rows into ``out`` uint8
    [ceil(R1 / 8), B]: bit k of out[g, b] is x[8g + k, b] > 0 (little
    bit order; ``ell.unpack_bits`` inverts it), rows past R1 zero."""
    R1, B = _carrier(x, "x")
    dev = x.device
    _check(out, "out", torch.uint8, (-(-R1 // 8), B), dev)
    if not _route(dev):
        return pack_rows_ref(x, out)
    _aligned(x, out)
    rc = _lib().i8_pack_rows(x.data_ptr(), out.data_ptr(), R1, B,
                             _stream(dev))
    _ok(rc, "i8_pack_rows")
    LAUNCHES["pack_rows"] += 1
    return out


def lane_bits_ref(x: torch.Tensor) -> torch.Tensor:
    """An int8 carrier [R1, B] as a lane bitmap, uint8 [R1, ceil(B / 8)]:
    bit j of byte w set where lane 8w + j is > 0 (signed); the bits past
    B zero."""
    R1, B = x.shape
    pos = torch.zeros((R1, 8 * lanes_width(B)), dtype=torch.uint8,
                      device=x.device)
    pos[:, :B] = x > 0
    return _pack_ref(pos)


def bfs_level_i8_ref(nxt: torch.Tensor, tp: torch.Tensor,
                     seen: torch.Tensor, d: torch.Tensor,
                     flags: torch.Tensor, step: int, first: bool,
                     stop: bool, t8: Optional[torch.Tensor] = None) -> None:
    """Plain version of ``bfs_level_i8`` (ell.py:1634-1656): the level
    body and the loop condition's reductions on the reached lane bitmap
    ``seen`` instead of ``d == INF``."""
    B = nxt.shape[1]
    bits = lane_bits_ref(nxt)
    if first:
        seen.copy_(bits)
        d.copy_(torch.where(_unpack_ref(bits)[:, :B].bool(), 0,
                            _unreached(d)).to(d.dtype))
        newly = bits
        if t8 is not None and stop:
            tp.copy_(lane_bits_ref(t8))
    else:
        newly = bits & ~seen
        seen |= newly
        lanes = _unpack_ref(newly)[:, :B].bool()
        d.masked_fill_(lanes, step + 1)
        nxt.copy_(lanes.to(torch.int8))
    flags[0] |= bool(newly.any())
    if stop:
        flags[1] |= bool((tp & ~seen).any())


def bfs_level_i8(nxt: torch.Tensor, tp: torch.Tensor, seen: torch.Tensor,
                 d: torch.Tensor, flags: torch.Tensor, step: int,
                 first: bool = False, stop: bool = True,
                 t8: Optional[torch.Tensor] = None) -> None:
    """K15, one BFS level after the hop wrote ``nxt`` int8 [n_rows + 1,
    B]: ``newly = (nxt > 0) & ~seen`` (``seen``, uint8 [n_rows + 1,
    ceil(B / 8)]: the lanes reached so far as a lane bitmap, bit j of
    byte w lane 8w + j), ``seen |= newly``, ``d = step + 1`` at the newly
    lanes, ``nxt`` becomes ``newly`` (0/1) in place, and ``flags`` int32
    [2] (zero before) gets 1 in slot 0 when any lane was newly reached
    and, with ``stop``, 1 in slot 1 when any target bit of ``tp`` (a
    lane bitmap like ``seen``) is still unreached.  With ``first``,
    ``nxt`` is the start frontier, read as values (> 0) and left as it
    is, ``seen`` becomes its lanes, ``d`` is written whole (0 on them,
    the unreached value elsewhere) and, given ``t8`` (int8 [n_rows + 1,
    B] targets) and ``stop``, ``tp`` becomes the lane bitmap of ``t8 >
    0``.  ``d`` [n_rows + 1, B] is int8 (-1 unreached) or int16
    (INT16_INF), the BFS result's form (``depth_dtype``); no pass reads
    it."""
    R1, B = _carrier(nxt, "nxt")
    dev = nxt.device
    Wb = lanes_width(B)
    _check(tp, "tp", torch.uint8, (R1, Wb), dev)
    _check(seen, "seen", torch.uint8, (R1, Wb), dev)
    if not isinstance(d, torch.Tensor) or d.dtype not in (torch.int8,
                                                          torch.int16):
        raise TypeError("d must be an int8 or int16 tensor")
    _check(d, "d", d.dtype, (R1, B), dev)
    _check(flags, "flags", torch.int32, (2,), dev)
    if t8 is not None:
        if not first:
            raise ValueError("t8 is the first pass's")
        _check(t8, "t8", torch.int8, (R1, B), dev)
    top = 127 if d.dtype == torch.int8 else int(INT16_INF)
    if not 0 <= step < top - 1:
        raise ValueError(f"level {step} does not fit a {d.dtype} depth")
    if not _route(dev):
        return bfs_level_i8_ref(nxt, tp, seen, d, flags, step, first, stop,
                                t8)
    _aligned(flags)
    rc = _lib().i8_bfs_level(nxt.data_ptr(), tp.data_ptr(), seen.data_ptr(),
                             d.data_ptr(), d.element_size(), flags.data_ptr(),
                             None if t8 is None else t8.data_ptr(), step,
                             int(first), int(stop), R1, B, _stream(dev))
    _ok(rc, "i8_bfs_level")
    LAUNCHES["bfs_level_i8"] += 1


def _go_loop_i8(f0, tables, eslot, hrows, over, steps, upto, pack, hop,
                packer):
    """``steps - 1`` advances; with ``pack`` the last one writes the
    row-packed result itself, and with no advance (``steps <= 1``) the
    start frontier goes through ``packer`` (K14)."""
    R1, B = f0.shape
    if steps <= 1:
        return packer(f0, packed_rows(R1, B, f0.device)) if pack else f0
    acc = f0.clone() if upto else None
    cur, buf = f0, torch.empty_like(f0)
    hop = _live_chain(hop, R1, f0.device)
    for _ in range(steps - 2):
        hop(cur, acc, buf, tables, eslot, hrows, over)
        cur, buf = buf, cur
    if pack:
        return hop(cur, acc, buf, tables, eslot, hrows, over,
                   pack=packed_rows(R1, B, f0.device))[0]
    hop(cur, acc, buf, tables, eslot, hrows, over)
    return acc if upto else buf


def ell_go_i8_ref(f0: torch.Tensor, tables: DeviceTables,
                  eslot: torch.Tensor, hrows: torch.Tensor,
                  over: Sequence[int], steps: int, upto: bool = False,
                  pack: bool = False) -> torch.Tensor:
    """Plain version of ``ell_go_i8``: the same loop over the plain hop
    and row pack."""
    return _go_loop_i8(f0, tables, eslot, hrows, over, steps, upto, pack,
                       go_hop_i8_ref, pack_rows_ref)


def ell_go_i8(f0: torch.Tensor, tables: DeviceTables, eslot: torch.Tensor,
              hrows: torch.Tensor, over: Sequence[int], steps: int,
              upto: bool = False, pack: bool = False) -> torch.Tensor:
    """Batched dense GO over the int8 carrier (ell.py:1140
    make_batched_go_kernel): ``steps - 1`` hops of the start frontier
    ``f0`` int8 [n_rows + 1, B]; with ``upto`` the running max of
    depths 0 .. steps-1 (the accumulator starts as a copy of ``f0``);
    with ``pack`` the result bit-packed along ROWS, uint8
    [ceil((n_rows + 1) / 8), B] — not the packed route's lane-packed
    [n_rows + 1, B / 8] — written by the last advance itself (K14
    ``pack_rows`` only where there is no advance, ``steps <= 1``).  The
    hops ping-pong between ``f0`` and one spare buffer, so ``f0`` is
    consumed."""
    _carrier(f0, "f0")
    out = _go_loop_i8(f0, tables, eslot, hrows, over, steps, upto, pack,
                      go_hop_i8, pack_rows)
    if (steps > 1 or pack) and _route(f0.device):
        LAUNCHES["ell_go_i8"] += 1
    return out


def _bfs_loop_i8(f0, t0, tables, eslot, hrows, over, max_steps, stop,
                 hop, level, read=None):
    """The int8 route's BFS program: ``seen`` (a lane bitmap) and ``d``
    (in the result's form, ``depth_dtype``) are its state, the targets a
    lane bitmap: ``t0`` itself when it is one, else the first pass packs
    the int8 ``t0``; ``read`` as ``_bfs_levels``'."""
    R1, B = f0.shape
    d = torch.empty((R1, B), dtype=depth_dtype(max_steps), device=f0.device)
    seen = torch.empty((R1, lanes_width(B)), dtype=torch.uint8,
                       device=f0.device)
    tp, t8 = (t0, None) if t0.dtype == torch.uint8 else \
        (torch.empty_like(seen), t0)
    step = _bfs_levels(f0, tables, eslot, hrows, over, max_steps, stop,
                       hop, lambda nxt, flag, at, first: level(
                           nxt, tp, seen, d, flag, at, first, stop,
                           t8 if first else None),
                       read)
    return d, step


def _bfs_pair_i8(f0: torch.Tensor, t0: torch.Tensor) -> None:
    """Check the int8 start carrier and its targets: an int8 carrier of
    the same shape, or its lane bitmap."""
    R1, B = _carrier(f0, "f0")
    if isinstance(t0, torch.Tensor) and t0.dtype == torch.uint8:
        _check(t0, "t0", torch.uint8, (R1, lanes_width(B)), f0.device)
    else:
        _check(t0, "t0", torch.int8, (R1, B), f0.device)


def ell_bfs_i8_ref(f0: torch.Tensor, t0: torch.Tensor,
                   tables: DeviceTables, eslot: torch.Tensor,
                   hrows: torch.Tensor, over: Sequence[int], max_steps: int,
                   stop_when_found: bool = True) -> Tuple[torch.Tensor, int]:
    """Plain version of ``ell_bfs_i8``: the same loop over the plain
    versions of the hop and the level pass."""
    _bfs_pair_i8(f0, t0)
    return _bfs_loop_i8(f0, t0, tables, eslot, hrows, over, max_steps,
                        stop_when_found,
                        _live_chain(go_hop_i8_ref, f0.shape[0], f0.device),
                        bfs_level_i8_ref)


def ell_bfs_i8(f0: torch.Tensor, t0: torch.Tensor, tables: DeviceTables,
               eslot: torch.Tensor, hrows: torch.Tensor,
               over: Sequence[int], max_steps: int,
               stop_when_found: bool = True) -> Tuple[torch.Tensor, int]:
    """Batched BFS depths over the int8 carrier (ell.py:1616
    make_batched_bfs_kernel): ``f0`` int8 [n_rows + 1, B] start lanes
    (consumed), ``t0`` the targets, an int8 carrier of the same shape
    (lanes > 0) or its lane bitmap uint8 [n_rows + 1, ceil(B / 8)] (bit j
    of byte w lane 8w + j, as ``frontier_upload`` writes it).  Returns
    (depth, levels run) in ``ell_bfs``'s form: [n_rows + 1, B], int8
    with -1 for unreached when ``max_steps <= 120``, else int16 with
    INT16_INF, the form the level pass keeps it in (no pass converts
    it).  The level loop runs on the host and reads this level's two
    flags back once a level, as ``ell_bfs`` does."""
    _bfs_pair_i8(f0, t0)
    out = _bfs_loop_i8(f0, t0, tables, eslot, hrows, over, max_steps,
                       stop_when_found,
                       _live_chain(go_hop_i8, f0.shape[0], f0.device),
                       bfs_level_i8)
    if _route(f0.device):
        LAUNCHES["ell_bfs_i8"] += 1
    return out


# ====================================================================
# Sparse pair-list GO (ell.py:1222) and adaptive single-query GO
# (ell.py:1493).  The kernels (csrc/sparse_go.cu) carry a hop's
# frontier as bits of a mark bitmap [nq, R1w] (int32 words used as
# uint32, R1w = ceil((n_rows + 1) / 32)); a scan of the bitmap gives
# the reference's sorted, deduped, capped (query, vertex) pair list.
# Device-side scalars ride one int64 ``ctl`` [8] tensor (CTL_*).
# ====================================================================
BIG_Q = 1 << 30                 # ell.py BIG_Q: the qid of an unused pair
I32_MAX = 2**31 - 1             # the pack32 key of an unused pair
CTL_CNT, CTL_OVF, CTL_HUB_TOTAL, CTL_HUB_BIG, CTL_MODE, CTL_SPARSE, \
    CTL_CONV = range(7)
CTL_SIZE = 8
CTL_WORDS = 2 * CTL_SIZE        # ctl's int32 words at a workspace's head
MODE_SPARSE, MODE_DENSE = 1, 2  # the adaptive program's mode word
COMPACT_CHUNK = 2048            # csrc kChunk: bitmap words per K5 chunk
COMPACT_HEAD = 4                # csrc kScanHead: K5's state words a member
COMPACT_WIDE_WORDS = 1 << 20    # csrc kWideWords: doubled chunks from here


def compact_state_words(words: int) -> int:
    """K5's look-back state for a bitmap of ``words`` words: int64 words
    a member (csrc sg_compact_state), the head and a descriptor a
    chunk of COMPACT_CHUNK words (enough for the doubled chunks)."""
    return COMPACT_HEAD + -(-words // COMPACT_CHUNK)


def compact_chunk(words: int) -> int:
    """The words of one K5 chunk on a bitmap of ``words`` words (csrc
    compact_launch): twice COMPACT_CHUNK from COMPACT_WIDE_WORDS on."""
    return COMPACT_CHUNK * (2 if words >= COMPACT_WIDE_WORDS else 1)


def _words(R1: int) -> int:
    return (R1 + 31) // 32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values (or int32 sums) -> the int32 with the
    same low 32 bits (two's complement wrap)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _bits_of(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> bool [numel * 32] (bit k of word w is entry
    32w + k)."""
    sh = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words.reshape(-1, 1) >> sh) & 1).reshape(-1).bool()


def _mark_bits(mark: torch.Tensor, R1w: int, q: torch.Tensor,
               u: torch.Tensor) -> None:
    """In place: set bit (q, u) of the [nq, R1w] bitmap ``mark``."""
    if not len(u):
        return
    flat = torch.unique(q.long() * (R1w * 32) + u.long())
    acc = torch.zeros(mark.numel(), dtype=torch.int64, device=mark.device)
    acc.index_add_(0, flat >> 5, torch.ones_like(flat) << (flat & 31))
    mark |= _to_i32(acc)


def _vec(t: Optional[torch.Tensor], name: str, dtype: torch.dtype,
         dev: torch.device, n: Optional[int] = None) -> int:
    """Check a 1-D contiguous tensor; returns its length."""
    if t is None or t.dim() != 1:
        raise ValueError(f"{name} must be a 1-D tensor")
    _check(t, name, dtype, (t.shape[0] if n is None else n,), dev)
    return t.shape[0]


# ------------------------------------------------------ K4 expand
def _slot_targets(rows: torch.Tensor, rq: torch.Tensor,
                  tables: DeviceTables, etypes: Sequence[int]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, u) for every slot of the given rows whose etype is in
    ``etypes`` (u a real row, never the sentinel)."""
    et_t = torch.tensor(list(etypes), dtype=torch.int32, device=rows.device)
    qs, us = [], []
    for b in range(len(tables.D)):
        r0, nb = tables.row0[b], tables.rows[b]
        sel = (rows >= r0) & (rows < r0 + nb)
        if not bool(sel.any()):
            continue
        nbr, et = tables.bucket(b)
        loc = rows[sel] - r0
        cand = nbr[loc].long()
        ok = torch.isin(et[loc], et_t) & (cand >= 0) \
            & (cand < tables.n_rows)
        qs.append(rq[sel][:, None].expand_as(cand)[ok])
        us.append(cand[ok])
    if not qs:
        z = torch.zeros(0, dtype=torch.int64, device=rows.device)
        return z, z
    return torch.cat(qs), torch.cat(us)


def expand_rows(ids, qid, ecnt, e0, n, n_rows):
    """K4's work list: (rows, their queries, per-pair extra-row counts)
    for the live pairs — each main row, then (given ``ecnt``/``e0``)
    each hub's extra-row run."""
    v = ids.long()
    q = qid.long() if qid is not None else torch.zeros_like(v)
    live = (v >= 0) & (v < n_rows)
    v, q = v[live], q[live]
    rows, rq = [v], [q]
    ce = torch.zeros_like(v)
    if ecnt is not None:
        vi = v.clamp(max=n)
        ce = ecnt.long()[vi]
        tot = int(ce.sum())
        if tot:
            start = torch.cumsum(ce, 0) - ce
            k = torch.arange(tot, device=v.device) \
                - start.repeat_interleave(ce)
            rows.append(e0.long()[vi].repeat_interleave(ce) + k)
            rq.append(q.repeat_interleave(ce))
    r, rq_ = torch.cat(rows), torch.cat(rq)
    ok = (r >= 0) & (r < n_rows)
    return r[ok], rq_[ok], ce


def _expand_live(ids, qid, ctl, counted):
    """K4's list: every pair, or (``counted``) the first
    ``ctl[CTL_CNT]`` of them, the count the previous K5 left."""
    if not counted:
        return ids, qid
    live = min(int(ctl[CTL_CNT]), ids.shape[0])
    return ids[:live], None if qid is None else qid[:live]


def sparse_expand_ref(ids, qid, ecnt, e0, tables, over, mark, R1w, ctl,
                      c_lim, self_mode=False, counted=False, gate=None,
                      want=0):
    """Plain version of ``sparse_expand`` (K4)."""
    if gate is not None and int(gate[0]) != want:
        return mark
    ids, qid = _expand_live(ids, qid, ctl, counted)
    n, n_rows = tables.n, tables.n_rows
    if self_mode:
        v, q, _ce = expand_rows(ids, qid, None, None, n, n_rows)
        _mark_bits(mark, R1w, q, v)
        return mark
    rows, rq, ce = expand_rows(ids, qid, ecnt, e0, n, n_rows)
    ctl[CTL_HUB_TOTAL] += ce.sum()
    if bool((ce > c_lim).any()):
        ctl[CTL_HUB_BIG] = 1
    qs, us = _slot_targets(rows, rq, tables, tuple(-t for t in over))
    _mark_bits(mark, R1w, qs, us)
    return mark


def sparse_expand(ids: torch.Tensor, qid: Optional[torch.Tensor],
                  ecnt: Optional[torch.Tensor], e0: Optional[torch.Tensor],
                  tables: DeviceTables, over: Sequence[int],
                  mark: torch.Tensor, R1w: int, ctl: torch.Tensor,
                  c_lim: int, self_mode: bool = False,
                  counted: bool = False,
                  gate: Optional[torch.Tensor] = None,
                  want: int = 0) -> torch.Tensor:
    """K4: push every live pair (qid[i], ids[i]) (ids == n_rows:
    inactive; ``qid=None``: all query 0) out of its main row and, given
    ``ecnt``/``e0`` (ell.EllIndex.hub_expansion), out of its hub
    extra-row run: bit (q, u) of ``mark`` int32 [nq * R1w] is set for
    every slot u whose etype is in the negated OVER set.  The pairs'
    extra-row counts add to ``ctl[CTL_HUB_TOTAL]``; a count past
    ``c_lim`` sets ``ctl[CTL_HUB_BIG]``.  ``self_mode`` marks (q, v)
    itself instead.  ``counted``: the list is a K5 output, whose count
    ``ctl[CTL_CNT]`` (read on the card) cuts it to its first
    min(count, len(ids)) pairs (K5 pads the rest).  ``gate``: None, or
    an int64 [1] word on the device (the adaptive program's mode word,
    ``ctl[CTL_MODE:CTL_MODE + 1]``); the call then does nothing unless
    it holds ``want``, as ``ad_program``'s gated K4.  One launch.
    Contract: every live qid < nq; the buckets' row0 nondecreasing."""
    dev = ids.device
    c_in = _vec(ids, "ids", torch.int32, dev)
    if qid is not None:
        _vec(qid, "qid", torch.int32, dev, c_in)
    if (ecnt is None) != (e0 is None):
        raise ValueError("ecnt and e0 come together")
    if ecnt is not None:
        _vec(ecnt, "ecnt", torch.int32, dev, tables.n + 1)
        _vec(e0, "e0", torch.int32, dev, tables.n + 1)
    words = _vec(mark, "mark", torch.int32, dev)
    if R1w != _words(tables.n_rows + 1) or words % R1w:
        raise ValueError(f"mark has {words} words, not rows of {R1w}")
    _vec(ctl, "ctl", torch.int64, dev, CTL_SIZE)
    if gate is not None:
        _vec(gate, "gate", torch.int64, dev, 1)
    over = _over_check(over)
    _tables_check(tables, dev)
    _rows_ordered(tables)
    if not _route(dev):
        return sparse_expand_ref(ids, qid, ecnt, e0, tables, over, mark,
                                 R1w, ctl, c_lim, self_mode, counted, gate,
                                 want)
    neg = (ctypes.c_int32 * len(over))(*[-t for t in over])
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = _lib().sg_expand(
        ids.data_ptr(), ptr(qid), c_in,
        ctl.data_ptr() + 8 * CTL_CNT if counted else None, ptr(ecnt),
        ptr(e0), tables.nbr.data_ptr(), tables.et.data_ptr(),
        _bucket_desc(tables), len(tables.D), neg, len(over), tables.n,
        tables.n_rows, R1w, mark.data_ptr(), ctl.data_ptr(), c_lim,
        int(self_mode), ptr(gate), want, _stream(dev))
    _ok(rc, "sg_expand")
    LAUNCHES["sparse_expand"] += 1
    return mark


# ----------------------------------------------------- K5 compact
def pair_compact_ref(mark, R1w, c_out, ids_out, qid_out, ctl, ex,
                     n_rows, uni=None, copy_to=None, zero=True, base=0,
                     scan=None, gate=None, want=0):
    """Plain version of ``pair_compact`` (K5); ``scan`` is not read."""
    if gate is not None and int(gate[0]) != want:
        return ids_out, qid_out
    idx = torch.nonzero(_bits_of(mark)).reshape(-1)
    total = idx.numel()
    ctl[CTL_CNT] = total
    ovf = total > c_out
    if ex >= 0:
        ovf = ovf or int(ctl[CTL_HUB_TOTAL]) > ex \
            or int(ctl[CTL_HUB_BIG]) != 0
        ctl[CTL_HUB_TOTAL] = 0
        ctl[CTL_HUB_BIG] = 0
    if ovf:
        ctl[CTL_OVF] = 1
    k = min(total, c_out)
    row_bits = R1w * 32
    ids_out[:k] = (idx[:k] % row_bits + base).to(torch.int32)
    ids_out[k:c_out] = n_rows
    if qid_out is not None:
        qid_out[:k] = (idx[:k] // row_bits).to(torch.int32)
        qid_out[k:c_out] = BIG_Q
    if uni is not None:
        uni |= mark
    if copy_to is not None:
        copy_to.copy_(mark)
    if zero:
        mark.zero_()
    return ids_out, qid_out


def pair_compact(mark: torch.Tensor, R1w: int, c_out: int,
                 ids_out: torch.Tensor, qid_out: Optional[torch.Tensor],
                 ctl: torch.Tensor, ex: int, n_rows: int,
                 uni: Optional[torch.Tensor] = None,
                 copy_to: Optional[torch.Tensor] = None,
                 zero: bool = True, base: int = 0,
                 scan: Optional[torch.Tensor] = None,
                 gate: Optional[torch.Tensor] = None, want: int = 0):
    """K5: the set bits of ``mark`` [nq * R1w] in (query, vertex) order
    -> the first ``c_out`` as (``ids_out``, ``qid_out``) int32 [>= c_out]
    pairs, the rest of the first c_out places padded (n_rows, BIG_Q);
    ``ctl[CTL_CNT]`` gets the count before the cut and
    ``ctl[CTL_OVF]`` is raised when it passes ``c_out`` or, for
    ``ex >= 0``, when this hop's hub budget (``ctl[CTL_HUB_TOTAL]``
    past ``ex``, or ``ctl[CTL_HUB_BIG]``) overflowed; the budget then
    resets.  The words read are ORed into ``uni``, copied into
    ``copy_to`` and (``zero``) cleared, as asked.  ``base`` is added to
    every emitted vertex (a frontier-sharded shard's first row; 0 on
    one card).  ``scan``: the card's look-back state, int64
    [compact_state_words(nq * R1w)], all zero before its first call and
    reusable by any later call on the same stream (the programs keep it
    in their cleared workspace); None: a zeroed one of the call's own
    (a memset beside the launch).  ``gate``: None, or an int64 [1]
    word on the device (the adaptive program's mode word,
    ``ctl[CTL_MODE:CTL_MODE + 1]``); the call then does nothing unless
    it holds ``want``, as ``ad_program``'s gated K5.  One launch.
    Returns (ids_out, qid_out)."""
    dev = mark.device
    words = _vec(mark, "mark", torch.int32, dev)
    if R1w <= 0 or words % R1w or c_out <= 0:
        raise ValueError(f"mark of {words} words, rows of {R1w}, "
                         f"c_out {c_out}")
    if ids_out.numel() < c_out:
        raise ValueError(f"ids_out holds {ids_out.numel()} < {c_out}")
    _vec(ids_out, "ids_out", torch.int32, dev)
    if qid_out is not None:
        _vec(qid_out, "qid_out", torch.int32, dev, ids_out.shape[0])
    for t, name in ((uni, "uni"), (copy_to, "copy_to")):
        if t is not None:
            _vec(t, name, torch.int32, dev, words)
    _vec(ctl, "ctl", torch.int64, dev, CTL_SIZE)
    if scan is not None:
        _vec(scan, "scan", torch.int64, dev, compact_state_words(words))
    if gate is not None:
        _vec(gate, "gate", torch.int64, dev, 1)
    if not _route(dev):
        return pair_compact_ref(mark, R1w, c_out, ids_out, qid_out, ctl,
                                ex, n_rows, uni, copy_to, zero, base, None,
                                gate, want)
    if scan is None:
        scan = torch.zeros(compact_state_words(words), dtype=torch.int64,
                           device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    rc = _lib().sg_compact(mark.data_ptr(), words, R1w, c_out,
                           ids_out.data_ptr(), ptr(qid_out),
                           scan.data_ptr(), ctl.data_ptr(), ex, ptr(uni),
                           ptr(copy_to), int(zero), n_rows, base,
                           ptr(gate), want, _stream(dev))
    _ok(rc, "sg_compact")
    LAUNCHES["pair_compact"] += 1
    return ids_out, qid_out


# ------------------------------------------------------ K6 reduce
REDUCE_EMIT, REDUCE_COUNT, REDUCE_LIMIT = 0, 1, 2


def _emit_layout(out: torch.Tensor, ids: torch.Tensor, qid: torch.Tensor,
                 pack32: bool, R1: int, n_rows: int) -> None:
    c = ids.shape[0]
    live = qid != BIG_Q
    if pack32:
        key = qid.long() * R1 + ids.long()
        out[2:2 + c] = torch.where(live, key, I32_MAX).to(torch.int32)
    else:
        out[2:2 + c] = torch.where(live, qid, -1)
        out[2 + c:2 + 2 * c] = torch.where(live, ids, n_rows)


def pair_reduce_ref(op, ids, qid, deg, out, pack32, R1, n_rows, nq, qmax,
                    limit, c_red, ctl):
    """Plain version of ``pair_reduce`` (K6)."""
    live = qid != BIG_Q
    if op == REDUCE_EMIT:
        _emit_layout(out, ids, qid, pack32, R1, n_rows)
    elif op == REDUCE_COUNT:
        q = qid.long()
        ok = live & (q >= 0) & (q < qmax)
        acc = torch.zeros(qmax, dtype=torch.int64, device=ids.device)
        acc.index_add_(0, q[ok], deg.long()[ids.long()[ok]])
        out[2:2 + qmax] = _to_i32(out[2:2 + qmax].long() + acc)
    else:
        q = qid.long()
        w = torch.where(live, deg.long()[ids.long().clamp(max=n_rows)], 0)
        # segment-local exclusive degree prefix, exact in int64
        excl = torch.cumsum(w, 0) - w
        first = torch.ones_like(live)
        first[1:] = q[1:] != q[:-1]
        seg = torch.cumsum(first.long(), 0) - 1
        base = excl[first][seg]
        keep = live & (q < nq) & (w > 0) & ((excl - base) < limit)
        kept = torch.nonzero(keep).reshape(-1)
        kcnt = kept.numel()
        ctl[CTL_CNT] = kcnt
        if kcnt > c_red:
            ctl[CTL_OVF] = 1
        k = min(kcnt, c_red)
        sel_i = torch.full((c_red,), n_rows, dtype=torch.int32,
                           device=ids.device)
        sel_q = torch.full((c_red,), BIG_Q, dtype=torch.int32,
                           device=ids.device)
        sel_i[:k] = ids[kept[:k]]
        sel_q[:k] = qid[kept[:k]]
        _emit_layout(out, sel_i, sel_q, pack32, R1, n_rows)
    out[0] = _to_i32(ctl[CTL_CNT:CTL_CNT + 1])[0]
    out[1] = 1 if int(ctl[CTL_OVF]) else 0
    return out


def pair_reduce(op: int, ids: torch.Tensor, qid: torch.Tensor,
                deg: Optional[torch.Tensor], out: torch.Tensor,
                pack32: bool, R1: int, n_rows: int, nq: int, qmax: int,
                limit: int, c_red: int, ctl: torch.Tensor) -> torch.Tensor:
    """K6, the result of a sparse GO from its final pair list (``ids``,
    ``qid`` int32 [c], sorted by (qid, id), pads (n_rows, BIG_Q) last):

    - REDUCE_EMIT: ``out`` int32 [2 + c] (``pack32``: keys q * R1 + id,
      2^31-1 unused) or [2 + 2c] (qids, -1 unused, then ids);
    - REDUCE_COUNT: ``out`` int32 [2 + qmax], zero before: per-query
      int32 (wrapping) sums of ``deg`` over the pairs;
    - REDUCE_LIMIT: ``out`` as EMIT at ``c_red``: per query (< nq) the
      shortest prefix whose exclusive degree sum is < ``limit``,
      zero-degree vertices dropped; ``ctl[CTL_CNT]`` becomes the kept
      count, overflow when it passes ``c_red``.

    ``out[0:2]`` = (ctl count, ctl overflow)."""
    dev = ids.device
    c = _vec(ids, "ids", torch.int32, dev)
    _vec(qid, "qid", torch.int32, dev, c)
    _vec(ctl, "ctl", torch.int64, dev, CTL_SIZE)
    if op not in (REDUCE_EMIT, REDUCE_COUNT, REDUCE_LIMIT) or c == 0:
        raise ValueError(f"reduce op {op} over {c} pairs")
    if op != REDUCE_EMIT:
        _vec(deg, "deg", torch.int32, dev, n_rows + 1)
    width = {REDUCE_EMIT: c, REDUCE_COUNT: qmax,
             REDUCE_LIMIT: c_red}[op]
    if width <= 0 or nq <= 0 or (op == REDUCE_LIMIT and limit < 0):
        raise ValueError(f"reduce op {op}: width {width}, nq {nq}, "
                         f"limit {limit}")
    pairs = op != REDUCE_COUNT and not pack32
    _vec(out, "out", torch.int32, dev, 2 + (2 if pairs else 1) * width)
    if not _route(dev):
        return pair_reduce_ref(op, ids, qid, deg, out, pack32, R1, n_rows,
                               nq, qmax, limit, c_red, ctl)
    scratch = torch.empty(nq if op == REDUCE_LIMIT else 1,
                          dtype=torch.int64, device=dev)
    rc = _lib().sg_reduce(op, ids.data_ptr(), qid.data_ptr(), c,
                          None if deg is None else deg.data_ptr(),
                          out.data_ptr(), int(pack32), R1, n_rows, nq, qmax,
                          limit, c_red, scratch.data_ptr(), ctl.data_ptr(),
                          _stream(dev))
    _ok(rc, "sg_reduce")
    LAUNCHES["pair_reduce"] += 1
    return out


# ------------------------------------------------- sparse GO program
def _rows_ordered(tables: DeviceTables) -> None:
    """K4 takes a row's bucket as the count of the other buckets' row0
    at or below it, which is the row's bucket only while row0 is in
    order."""
    if any(b < a for a, b in zip(tables.row0, tables.row0[1:])):
        raise ValueError(f"bucket row0 {tables.row0} decreases")


def _sparse_tables_check(tables, ecnt, e0, dev) -> None:
    """The checks of what a sparse program's descriptor holds (made once
    a table generation on the card, ``_sparse_desc``)."""
    _tables_check(tables, dev)
    _rows_ordered(tables)
    for t, name in ((ecnt, "ecnt"), (e0, "e0")):
        if t is not None:
            _vec(t, name, torch.int32, dev, tables.n + 1)


def _sparse_args(ids, qid, ecnt, e0, deg, tables, over, steps, caps, qmax,
                 nq, upto, limit, count):
    """The per-call checks of ``sparse_go``: the starts, the shape of the
    program and the degrees; returns the checked OVER set."""
    dev = ids.device
    S = _vec(ids, "ids", torch.int32, dev)
    _vec(qid, "qid", torch.int32, dev, S)
    if ecnt is None or e0 is None:
        raise ValueError("ecnt and e0 are the hub expansion's")
    if count and limit is not None:
        raise ValueError("COUNT and LIMIT do not combine")
    if count or limit is not None:
        _vec(deg, "deg", torch.int32, dev, tables.n_rows + 1)
    if steps < 2 or len(caps) != steps or min(caps) <= 0 or S == 0:
        raise ValueError(f"steps {steps} with caps {caps} over {S} "
                         f"starts (the program runs >= 1 hop)")
    if upto and caps[-1] < S:
        raise ValueError(f"UPTO pads the {S} starts to the final cap "
                         f"{caps[-1]}, which is smaller")
    if limit is not None and limit < 0:
        raise ValueError(f"LIMIT {limit}")
    if not 0 < nq <= qmax:
        raise ValueError(f"nq {nq} outside 1..qmax {qmax}")
    return _over_check(over)


class SparsePlan(NamedTuple):
    """One sparse program's shape as ``_sparse_go_steps`` and the card's
    ``sg_program`` both run it: per hop (c_out, the hub budget ex, the
    per-pair clamp c_lim); K6's op and widths; the int32 workspace's
    layout (ctl in words [0, CTL_WORDS), the mark bitmap, the UPTO
    union, K5's look-back state, LIMIT's scratch, two (ids, qid) pair
    buffers of cmax; [0, zero) is cleared once, which serves every K5
    call of the program); ``arr``: all of it as
    the host int64 array the C entry reads (csrc sparse_go.cu
    SparsePlan)."""
    hops: Tuple[Tuple[int, int, int], ...]
    nq: int
    qmax: int
    upto: bool
    op: int
    limit: int
    c_fin: int
    c_red: int
    pack32: bool
    cmax: int
    mark: int
    uni: int
    scan: int
    scratch: int
    bufs: int
    zero: int
    words: int
    out_words: int
    arr: object


@functools.lru_cache(maxsize=256)
def _sparse_plan(S: int, caps: Tuple[int, ...], qmax: int, nq: int, n: int,
                 n_rows: int, upto: bool, limit: Optional[int],
                 count: bool) -> SparsePlan:
    R1w = _words(n_rows + 1)
    n_extras = n_rows - n
    ex_pow2 = (1 << max(n_extras * max(qmax, 1) - 1, 1).bit_length()
               if n_extras else 0)
    hops, c_in = [], S
    for c_out in caps[1:]:
        hops.append((c_out, min(c_in, ex_pow2) if n_extras else -1,
                     max(1, (2**31 - 1) // max(c_in, 1))))
        c_in = c_out
    op = (REDUCE_COUNT if count else
          REDUCE_LIMIT if limit is not None else REDUCE_EMIT)
    pack32 = sparse_pack32(qmax, n_rows)
    c_fin = caps[-1]
    c_red = sparse_limit_cap(caps, caps[0], limit) if op == REDUCE_LIMIT \
        else 0
    width = {REDUCE_EMIT: c_fin, REDUCE_COUNT: qmax, REDUCE_LIMIT: c_red}[op]
    out_words = 2 + (1 if op == REDUCE_COUNT or pack32 else 2) * width
    cmax = max(caps[1:])
    words = nq * R1w
    mark = CTL_WORDS
    uni = mark + words
    scan = uni + (words if upto else 0)
    scan += scan % 2
    zero = scratch = scan + 2 * compact_state_words(words)
    bufs = scratch + (2 * nq if op == REDUCE_LIMIT else 0)
    total = bufs + 4 * cmax
    head = (len(hops), nq, qmax, int(upto), op, limit or 0, c_fin, c_red,
            int(pack32), cmax, mark, uni, scan, scratch, bufs, zero, total)
    flat = head + tuple(v for hp in hops for v in hp)
    return SparsePlan(tuple(hops), nq, qmax, upto, op, limit or 0, c_fin,
                      c_red, pack32, cmax, mark, uni, scan, scratch, bufs,
                      zero, total, out_words,
                      (ctypes.c_int64 * len(flat))(*flat))


def _sparse_go_steps(ids, qid, ecnt, e0, deg, tables, over, steps, caps,
                     qmax, nq, upto, limit, count, expand, compact, reduce):
    """The sparse GO program as a sequence of K4-K6 calls (``expand``,
    ``compact``, ``reduce`` are the kernels' wrappers or their plain
    versions) on one flat int32 workspace laid out by ``_sparse_plan``,
    its [0, zero) words cleared first: the order, the workspace and the
    arguments of the card's ``sg_program``, which runs the same
    sequence in one C call.  The overflow flag is sticky; once set,
    later hops still run but the output's other entries are not
    defined."""
    dev = ids.device
    n_rows = tables.n_rows
    R1 = n_rows + 1
    R1w = _words(R1)
    pl = _sparse_plan(ids.shape[0], tuple(caps), qmax, nq, tables.n, n_rows,
                      upto, limit, count)
    hubs = n_rows > tables.n
    ws = torch.empty(pl.words, dtype=torch.int32, device=dev)
    ws[:pl.zero].zero_()
    ctl = ws[:CTL_WORDS].view(torch.int64)
    mark = ws[pl.mark:pl.mark + nq * R1w]
    uni = ws[pl.uni:pl.uni + nq * R1w] if upto else None
    scan = ws[pl.scan:pl.zero].view(torch.int64)
    bufs = ws[pl.bufs:pl.bufs + 4 * pl.cmax].view(2, 2, pl.cmax)
    if upto:
        expand(ids, qid, None, None, tables, over, uni, R1w, ctl, 0, True)
    cur_i, cur_q = ids, qid
    for h, (c_out, ex, c_lim) in enumerate(pl.hops):
        # from the second hop the list is K5's: its count in ctl
        expand(cur_i, cur_q, ecnt if hubs else None, e0 if hubs else None,
               tables, over, mark, R1w, ctl, c_lim, False, h > 0)
        nxt_i, nxt_q = bufs[h % 2]
        compact(mark, R1w, c_out, nxt_i, nxt_q, ctl, ex, n_rows, uni, None,
                True, 0, scan)
        cur_i, cur_q = nxt_i[:c_out], nxt_q[:c_out]
    if upto:
        fin_i, fin_q = bufs[len(pl.hops) % 2]
        compact(uni, R1w, pl.c_fin, fin_i, fin_q, ctl, -1, n_rows, None,
                None, False, 0, scan)
        cur_i, cur_q = fin_i[:pl.c_fin], fin_q[:pl.c_fin]
    # COUNT's fold adds into its output: sg_program clears it first too
    out = (torch.zeros if count else torch.empty)(
        pl.out_words, dtype=torch.int32, device=dev)
    return reduce(pl.op, cur_i, cur_q, deg, out, pl.pack32, R1, n_rows, nq,
                  qmax, pl.limit, pl.c_red, ctl)


def _dedup_compact_ref(flat_q, flat_i, c_out, sentinel, R1):
    """ell.py:1372 dedup_compact: sorted unique (q, i) pairs with valid
    ids (!= sentinel), the count before the cut, the first c_out kept
    (pads (sentinel, BIG_Q)).  One int64 key serves both of the
    reference's key layouts: their pair order and count are the same."""
    valid = flat_i != sentinel
    key = torch.where(valid, flat_q.long() * R1 + flat_i.long(),
                      torch.iinfo(torch.int64).max)
    srt, _ = torch.sort(key)
    uniq = (srt != torch.iinfo(torch.int64).max)
    uniq[1:] &= srt[1:] != srt[:-1]
    pref = torch.cumsum(uniq.long(), 0)
    cnt = int(pref[-1]) if len(pref) else 0
    take = uniq & (pref <= c_out)
    kept = srt[take]
    out_i = torch.full((c_out,), sentinel, dtype=torch.int32,
                       device=flat_i.device)
    out_q = torch.full((c_out,), BIG_Q, dtype=torch.int32,
                       device=flat_i.device)
    out_i[:len(kept)] = (kept % R1).to(torch.int32)
    out_q[:len(kept)] = (kept // R1).to(torch.int32)
    return out_i, out_q, cnt


def _hub_iota_ref(cnt_raw, e0_vals, qid, EX, sentinel):
    """ell.py:402 _segmented_hub_iota: up to EX (row, qid) expansion
    pairs over the compacted runs and the wrap-free budget check."""
    c_in = cnt_raw.shape[0]
    c_lim = max(1, (2**31 - 1) // max(c_in, 1))
    over_big = bool((cnt_raw > c_lim).any())
    cnt = cnt_raw.long().clamp(max=c_lim)
    tot = torch.cumsum(cnt, 0)
    total = int(tot[-1]) if len(tot) else 0
    overflow = over_big or total > EX
    s = tot - cnt
    has = cnt > 0
    rank = torch.cumsum(has.long(), 0) - 1
    dev = cnt_raw.device
    pos = torch.where(has, rank, EX)
    inb = pos < EX
    run_e0 = torch.zeros(EX, dtype=torch.int64, device=dev)
    run_q = torch.full((EX,), BIG_Q, dtype=torch.int64, device=dev)
    run_s = torch.full((EX,), 2**30, dtype=torch.int64, device=dev)
    run_e0[pos[inb]] = e0_vals.long()[inb]
    run_q[pos[inb]] = qid.long()[inb]
    run_s[pos[inb]] = s[inb]
    j = torch.arange(EX, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(run_s, j, right=True) - 1
    segc = seg.clamp(0, max(EX - 1, 0))
    live = (j < min(total, EX)) & (seg >= 0)
    rows = torch.where(live, run_e0[segc] + (j - run_s[segc]), sentinel)
    qs = torch.where(live, run_q[segc], BIG_Q)
    return rows, qs, overflow


def sparse_go_ref(ids, qid, ecnt, e0, deg, tables, over, steps, caps,
                  qmax, upto=False, limit=None, count=False):
    """Plain version of ``sparse_go``: ell.py:1222 ``go_impl``
    transcribed (candidate matrix, sort dedup, hub iota, limit cut,
    count) on the port's flat tables.  The one departure: the LIMIT
    cut's per-query prefix is taken segment-locally in int64, where the
    reference takes an int32 global cumsum less a cummax base, which
    agrees while the batch's total final-hop degree stays below 2^31."""
    dev = ids.device
    n, n_rows = tables.n, tables.n_rows
    sentinel, R1 = n_rows, n_rows + 1
    neg = torch.tensor([-t for t in over], dtype=torch.int32, device=dev)
    d_max = max(tables.D)
    n_extras = n_rows - n
    ex_pow2 = (1 << max(n_extras * max(qmax, 1) - 1, 1).bit_length()
               if n_extras else 0)

    def hop(ids_, qid_, c_out):
        c_in = ids_.shape[0]
        gids, gqs, ovf_hub = ids_, qid_, False
        if n_extras:
            vi = ids_.long().clamp(max=n)
            raw = torch.where(ids_ == sentinel, 0, ecnt.long()[vi])
            ext_rows, ext_q, ovf_hub = _hub_iota_ref(
                raw, e0.long()[vi], qid_, min(c_in, ex_pow2), sentinel)
            gids = torch.cat([ids_.long(), ext_rows])
            gqs = torch.cat([qid_.long(), ext_q])
        gids = gids.long()
        cand = torch.full((gids.shape[0], d_max), sentinel,
                          dtype=torch.int64, device=dev)
        for b in range(len(tables.D)):
            r0, nbk, D = tables.row0[b], tables.rows[b], tables.D[b]
            nbr, et = tables.bucket(b)
            loc = gids - r0
            inb = (loc >= 0) & (loc < nbk)
            safe = torch.where(inb, loc, 0)
            rows = nbr[safe].long()
            ok = inb[:, None] & torch.isin(et[safe], neg)
            block = torch.where(ok, rows, sentinel)
            cand[:, :D] = torch.where(inb[:, None], block, cand[:, :D])
        flat_i = cand.reshape(-1)
        flat_q = gqs.repeat_interleave(d_max)
        out_i, out_q, cnt = _dedup_compact_ref(flat_q, flat_i, c_out,
                                               sentinel, R1)
        return out_i, out_q, (cnt > c_out) or ovf_hub, cnt

    cur_i = ids.clone()
    cur_q = torch.where(ids == sentinel, BIG_Q, qid)
    overflow = False
    cnt = int((ids != sentinel).sum())
    c_fin = caps[-1]
    if upto:
        pad = c_fin - cur_i.shape[0]
        acc_i = torch.cat([cur_i, torch.full((pad,), sentinel,
                                             dtype=torch.int32,
                                             device=dev)])
        acc_q = torch.cat([cur_q, torch.full((pad,), BIG_Q,
                                             dtype=torch.int32,
                                             device=dev)])
    for h in range(steps - 1):
        cur_i, cur_q, ovf_h, cnt = hop(cur_i, cur_q, caps[h + 1])
        overflow = overflow or ovf_h
        if upto:
            acc_i, acc_q, cnt = _dedup_compact_ref(
                torch.cat([acc_q, cur_q]), torch.cat([acc_i, cur_i]),
                c_fin, sentinel, R1)
            overflow = overflow or cnt > c_fin
    if upto:
        cur_i, cur_q = acc_i, acc_q
    ctl = torch.zeros(CTL_SIZE, dtype=torch.int64, device=dev)
    ctl[CTL_CNT] = cnt
    ctl[CTL_OVF] = int(overflow)
    pack32 = sparse_pack32(qmax, n_rows)
    nq = int(cur_q[cur_q != BIG_Q].max()) + 1 if bool(
        (cur_q != BIG_Q).any()) else 1
    if count:
        out = torch.zeros(2 + qmax, dtype=torch.int32, device=dev)
        return pair_reduce_ref(REDUCE_COUNT, cur_i, cur_q, deg, out,
                               pack32, R1, n_rows, nq, qmax, 0, 0, ctl)
    if limit is not None:
        c_red = sparse_limit_cap(caps, caps[0], limit)
        out = torch.empty(2 + (1 if pack32 else 2) * c_red,
                          dtype=torch.int32, device=dev)
        return pair_reduce_ref(REDUCE_LIMIT, cur_i, cur_q, deg, out,
                               pack32, R1, n_rows, nq, qmax, limit, c_red,
                               ctl)
    out = torch.empty(2 + (1 if pack32 else 2) * c_fin, dtype=torch.int32,
                      device=dev)
    return pair_reduce_ref(REDUCE_EMIT, cur_i, cur_q, deg, out, pack32,
                           R1, n_rows, nq, qmax, 0, 0, ctl)


class _SparseTables(ctypes.Structure):
    """``SparseTables`` of csrc/sparse_go.cu, passed by value: the slot
    tables, the hub expansion (null without), the bucket triples of
    ``_bucket_desc``, the negated OVER set and the geometry."""
    _fields_ = [("nbr", ctypes.c_void_p), ("et", ctypes.c_void_p),
                ("ecnt", ctypes.c_void_p), ("e0", ctypes.c_void_p),
                ("row0", ctypes.c_longlong * MAX_BUCKETS),
                ("slot0", ctypes.c_longlong * MAX_BUCKETS),
                ("D", ctypes.c_int * MAX_BUCKETS), ("n_buckets", ctypes.c_int),
                ("neg", ctypes.c_int * MAX_OVER), ("n_neg", ctypes.c_int),
                ("n", ctypes.c_longlong), ("n_rows", ctypes.c_longlong),
                ("R1w", ctypes.c_longlong)]


def _sparse_desc(tables: DeviceTables, ecnt, e0, over: Tuple[int, ...]
                 ) -> _SparseTables:
    """The sparse programs' descriptor, made (and its tables checked)
    once a table generation, hub expansion and OVER set (``_card_desc``);
    ``ecnt``/``e0`` None: no hub push (the adaptive program's)."""
    hubs = ecnt is not None and tables.n_rows > tables.n
    tensors = (tables.nbr, tables.et) + ((ecnt, e0) if hubs else ())

    def build():
        _sparse_tables_check(tables, ecnt, e0, tables.nbr.device)
        d = _SparseTables()
        d.nbr, d.et = tables.nbr.data_ptr(), tables.et.data_ptr()
        if hubs:
            d.ecnt, d.e0 = ecnt.data_ptr(), e0.data_ptr()
        for b in range(len(tables.D)):
            d.row0[b], d.slot0[b] = tables.row0[b], tables.slot0[b]
            d.D[b] = tables.D[b]
        d.n_buckets = len(tables.D)
        for k, t in enumerate(over):
            d.neg[k] = -t
        d.n_neg = len(over)
        d.n, d.n_rows = tables.n, tables.n_rows
        d.R1w = _words(tables.n_rows + 1)
        return d
    return _card_desc(tensors, ("sparse", over, hubs), build)


def sparse_go(ids: torch.Tensor, qid: torch.Tensor, ecnt: torch.Tensor,
              e0: torch.Tensor, deg: Optional[torch.Tensor],
              tables: DeviceTables, over: Sequence[int], steps: int,
              caps: Sequence[int], qmax: int, nq: int, upto: bool = False,
              limit: Optional[int] = None, count: bool = False
              ) -> torch.Tensor:
    """Sparse batched GO (ell.py:1222 make_batched_sparse_go_kernel),
    ``steps - 1`` hops of B queries' frontiers as one (query, vertex)
    pair list.  ``ids``/``qid`` int32 [S]: start new ids (n_rows =
    inactive) and their queries (< nq <= qmax); ``ecnt``/``e0``
    (ell.EllIndex.hub_expansion); ``deg`` int32 [n_rows + 1] for COUNT
    and LIMIT; ``caps`` (ell.sparse_caps) the per-hop pair caps.
    Returns the reference's int32 array: [count, overflow, pairs...]
    with the pairs sorted by (qid, id), deduped, cut to the caps —
    packed keys q * (n_rows + 1) + id (2^31-1 unused) when
    ``ell.sparse_pack32(qmax, n_rows)``, else qids (-1 unused) then
    ids; with ``upto`` the union of depths 0..steps-1; with ``count``
    [count, overflow, per-query int32 degree sums [qmax]]; with
    ``limit`` each query's shortest prefix whose exclusive degree sum
    is below ``limit`` (zero-degree vertices dropped), at
    ``ell.sparse_limit_cap``.  Overflow (a hop past its cap, the hub
    budget, the UPTO union past the final cap, the LIMIT cut past its
    cap) is sticky: the caller reruns dense; the other entries are then
    not defined.  On the card one checked C call (``sg_program``) runs
    the whole program on a workspace of its own, taken from torch's
    caching allocator and cleared by one memset inside the call, and
    reports the K4-K6 calls it made (``LAUNCHES``); each call's output
    is its own tensor."""
    over = _sparse_args(ids, qid, ecnt, e0, deg, tables, over, steps, caps,
                        qmax, nq, upto, limit, count)
    caps = tuple(int(c) for c in caps)
    dev = ids.device
    if not _route(dev):
        _sparse_tables_check(tables, ecnt, e0, dev)
        return sparse_go_ref(ids, qid, ecnt, e0, deg, tables, over, steps,
                             caps, qmax, upto, limit, count)
    pl = _sparse_plan(ids.shape[0], caps, qmax, nq, tables.n, tables.n_rows,
                      upto, limit, count)
    desc = _sparse_desc(tables, ecnt, e0, over)
    ws = torch.empty(pl.words, dtype=torch.int32, device=dev)
    out = torch.empty(pl.out_words, dtype=torch.int32, device=dev)
    launched = (ctypes.c_int32 * 3)()
    rc = _lib().sg_program(desc, ids.data_ptr(), qid.data_ptr(),
                           ids.shape[0],
                           None if deg is None else deg.data_ptr(), pl.arr,
                           len(pl.arr), ws.data_ptr(), out.data_ptr(),
                           pl.out_words, _stream(dev), launched)
    _ok(rc, "sg_program")
    LAUNCHES["sparse_go_count" if count else
             "sparse_go_limit" if limit is not None else "sparse_go"] += 1
    # the K4, K5 and K6 calls the C call reports it made
    for name, k in zip(("sparse_expand", "pair_compact", "pair_reduce"),
                       launched):
        LAUNCHES[name] += k
    return out


# ------------------------------------------------ K7 and the lanes
def adaptive_switch_ref(fr, K, hub, n, n_rows, ctl, dense=None):
    """Plain version of ``adaptive_switch`` (K7)."""
    v = fr.long()
    live = v != n_rows
    hit = bool((hub[v.clamp(max=n)].bool() & live).any())
    sparse = int(ctl[CTL_SPARSE]) != 0
    was = int(ctl[CTL_MODE])
    if was == MODE_SPARSE and int(ctl[CTL_CNT]) > K:
        sparse = False
    take = sparse and not hit
    ctl[CTL_MODE] = MODE_SPARSE if take else MODE_DENSE
    ctl[CTL_SPARSE] = 1 if take else 0
    ctl[CTL_CONV] = 1 if not take and was != MODE_DENSE else 0
    if dense is not None and int(ctl[CTL_CONV]):
        dense += 1
    return ctl


def adaptive_switch(fr: torch.Tensor, hub: torch.Tensor, n: int,
                    n_rows: int, ctl: torch.Tensor,
                    dense: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K7, before each adaptive hop: a sparse previous hop whose count
    (``ctl[CTL_CNT]``) passed K = len(fr) ends the sparse mode for good;
    this hop's mode word ``ctl[CTL_MODE]`` is MODE_SPARSE while the
    mode holds and no vertex of the frontier list ``fr`` int32 [K]
    (padded with n_rows) is a hub (``hub`` uint8 [n + 1]), else
    MODE_DENSE (and the sparse mode ends); ``ctl[CTL_CONV]`` is 1 at the
    hop where the mode first turns dense, else 0, and that hop adds one
    to ``dense`` (int64 [1], ``adaptive_dense_tally``; None: no
    tally)."""
    dev = fr.device
    K = _vec(fr, "fr", torch.int32, dev)
    _vec(hub, "hub", torch.uint8, dev, n + 1)
    _vec(ctl, "ctl", torch.int64, dev, CTL_SIZE)
    if dense is not None:
        _vec(dense, "dense", torch.int64, dev, 1)
    if K == 0:
        raise ValueError("empty frontier list")
    if not _route(dev):
        return adaptive_switch_ref(fr, K, hub, n, n_rows, ctl, dense)
    rc = _lib().ad_switch(fr.data_ptr(), K, hub.data_ptr(), n, n_rows,
                          ctl.data_ptr(),
                          None if dense is None else dense.data_ptr(),
                          _stream(dev))
    _ok(rc, "ad_switch")
    LAUNCHES["adaptive_switch"] += 1
    return ctl


def bitmap_lanes_ref(to_lanes, bits, lanes, R1):
    """Plain version of ``bitmap_lanes``."""
    words = lanes.view(torch.int32).reshape(-1)
    if to_lanes:
        words.copy_(_bits_of(bits)[:R1].to(torch.int32))
        return lanes
    b = torch.zeros(bits.numel() * 32, dtype=torch.int64,
                    device=bits.device)
    b[:R1] = (words & 1).long()
    sh = torch.arange(32, dtype=torch.int64, device=bits.device)
    bits.copy_(_to_i32((b.reshape(-1, 32) << sh).sum(dim=1)))
    return bits


def bitmap_lanes(to_lanes: bool, bits: torch.Tensor, lanes: torch.Tensor,
                 R1: int) -> torch.Tensor:
    """The adaptive dense arm's layout change: ``to_lanes`` writes row r
    of ``lanes`` uint8 [R1, 4] as lane 0 = bit r of ``bits`` int32
    [ceil(R1 / 32)] (the other lanes zero); otherwise ``bits`` is
    rebuilt from lane 0 of each row."""
    dev = bits.device
    _vec(bits, "bits", torch.int32, dev, _words(R1))
    _check(lanes, "lanes", torch.uint8, (R1, 4), dev)
    if not _route(dev):
        return bitmap_lanes_ref(to_lanes, bits, lanes, R1)
    _aligned(lanes)
    rc = _lib().ad_bitmap_lanes(int(to_lanes), bits.data_ptr(),
                                lanes.data_ptr(), R1, _stream(dev))
    _ok(rc, "ad_bitmap_lanes")
    LAUNCHES["bitmap_lanes"] += 1
    return lanes if to_lanes else bits


# ------------------------------------------------ adaptive program
_DENSE: Dict[str, torch.Tensor] = {}


def adaptive_dense_tally(device: torch.device) -> torch.Tensor:
    """The int64 [1] tally on ``device`` to which every ``adaptive_go``
    call that runs a dense hop adds one (K7 on the card, at the hop where
    the mode first turns dense): zero it, serve, read it, and the count
    of the calls that went dense comes from the card, with no read a
    call."""
    key = str(torch.device(device))
    t = _DENSE.get(key)
    if t is None:
        t = _DENSE.setdefault(key, torch.zeros(1, dtype=torch.int64,
                                               device=device))
    return t


def _adaptive_args(starts, hub, tables, eslot, hrows, over, steps, K):
    dev = starts.device
    S = _vec(starts, "starts", torch.int32, dev)
    _vec(hub, "hub", torch.uint8, dev, tables.n + 1)
    _vec(eslot, "eslot", torch.int32, dev, tables.n_rows - tables.n)
    _vec(hrows, "hrows", torch.int32, dev)
    if K <= 0 or S > K:
        raise ValueError(f"{S} starts for a K={K} frontier list")
    if steps < 1:
        raise ValueError(f"steps {steps}")
    _tables_check(tables, dev)
    return _over_check(over)


class AdaptivePlan(NamedTuple):
    """The adaptive program's int32 workspace as ``_adaptive_steps`` and
    the card's ``ad_program`` both lay it out: ctl in words [0,
    CTL_WORDS), the state bitmap, the candidate bitmap, K5's look-back
    state ([0, zero) cleared once), the frontier list fr [K], two
    [R1, 4]-byte lane frontiers; ``arr`` the host int64 array the C
    entry reads (csrc sparse_go.cu AdaptivePlan)."""
    hops: int
    K: int
    state: int
    cand: int
    scan: int
    fr: int
    lanes: int
    zero: int
    words: int
    arr: object


@functools.lru_cache(maxsize=64)
def _adaptive_plan(R1: int, K: int, hops: int) -> AdaptivePlan:
    R1w = _words(R1)
    state = CTL_WORDS
    cand = state + R1w
    scan = cand + R1w + (cand + R1w) % 2
    zero = fr = scan + 2 * compact_state_words(R1w)
    lanes = fr + K
    words = lanes + 2 * R1
    flat = (hops, K, state, cand, scan, fr, lanes, zero, words)
    return AdaptivePlan(*flat, (ctypes.c_int64 * len(flat))(*flat))


def _adaptive_steps(starts, hub, tables, eslot, hrows, over, steps, K,
                    expand, compact, switch, lanes, hop):
    """The adaptive program as a sequence of kernel calls on the
    workspace of ``_adaptive_plan``, in the order of the card's
    ``ad_program``, which enqueues every call in one C call and lets
    each kernel read the hop's mode word on the card; here the host
    reads it and skips the calls the card's kernels would return from.
    After the start (the frontier list, the state's self-mark) each hop
    runs K7 (``switch``), then the layout change to lanes (``lanes``;
    only at the hop where the mode first turns dense), then the sparse
    arm, K4 (the push of the list) and K5 (the compaction to K ids, the
    state bitmap replaced by every candidate), or the dense arm,
    ``hop`` on lane 0 from lane frontier h % 2 into (h + 1) % 2; the
    first dense hop ends the sparse mode for good.  Last, when a dense
    hop ran, the lanes come back into the state bitmap.  The state
    bitmap always holds the reference's ``bitmap``."""
    dev = starts.device
    n, n_rows = tables.n, tables.n_rows
    R1 = n_rows + 1
    R1w = _words(R1)
    pl = _adaptive_plan(R1, K, steps - 1)
    ws = torch.empty(pl.words, dtype=torch.int32, device=dev)
    ws[:pl.zero].zero_()
    ctl = ws[:CTL_WORDS].view(torch.int64)
    state = ws[pl.state:pl.state + R1w]
    cand = ws[pl.cand:pl.cand + R1w]
    scan = ws[pl.scan:pl.zero].view(torch.int64)
    fr = ws[pl.fr:pl.fr + K]
    bufs = ws[pl.lanes:pl.lanes + 2 * R1].view(torch.uint8).view(2, R1, 4)
    S = starts.shape[0]
    fr.fill_(n_rows)
    fr[:S] = starts
    ctl[CTL_SPARSE] = 1
    expand(fr[:S], None, None, None, tables, over, state, R1w, ctl, 0, True)
    for h in range(pl.hops):
        switch(fr, hub, n, n_rows, ctl)
        if int(ctl[CTL_CONV]):
            lanes(True, state, bufs[h % 2], R1)
        if int(ctl[CTL_MODE]) == MODE_SPARSE:
            # the first hop's list is the S starts; a later one is K5's,
            # its count in ctl
            expand(fr if h else fr[:S], None, None, None, tables, over,
                   cand, R1w, ctl, 0, False, h > 0)
            compact(cand, R1w, K, fr, None, ctl, -1, n_rows, None, state,
                    True, 0, scan)
        else:
            hop(bufs[h % 2], None, bufs[(h + 1) % 2], tables, eslot, hrows,
                over)
    if int(ctl[CTL_MODE]) == MODE_DENSE:
        lanes(False, state, bufs[pl.hops % 2], R1)
    return state.view(torch.uint8)[:(R1 + 7) // 8]


def adaptive_go_ref(starts, hub, tables, eslot, hrows, over, steps, K):
    """Plain version of ``adaptive_go``: ell.py:1493 transcribed (the
    list push with a sort dedup, the bitmap of the candidates, the dense
    pull through ``go_hop_ref`` on lane 0)."""
    dev = starts.device
    n, n_rows = tables.n, tables.n_rows
    sentinel, R1 = n_rows, n_rows + 1
    neg = tuple(-t for t in over)

    def bitmap_of(v):
        bm = torch.zeros(R1, dtype=torch.bool, device=dev)
        bm[v.long()] = True
        bm[sentinel] = False
        return bm

    fr = torch.full((K,), sentinel, dtype=torch.int32, device=dev)
    fr[:starts.shape[0]] = starts
    bitmap = bitmap_of(fr)
    sparse = True
    for _ in range(steps - 1):
        live = fr != sentinel
        hub_hit = bool((hub[fr.long().clamp(max=n)].bool() & live).any())
        if sparse and not hub_hit:
            _q, cand = _slot_targets(fr.long()[live],
                                     torch.zeros(int(live.sum()),
                                                 dtype=torch.int64,
                                                 device=dev),
                                     tables, neg)
            uniq = torch.unique(cand)             # sorted, sentinel-free
            cnt2 = uniq.numel()
            fr = torch.full((K,), sentinel, dtype=torch.int32, device=dev)
            fr[:min(cnt2, K)] = uniq[:K].to(torch.int32)
            overflow = cnt2 > K
            bitmap = bitmap_of(cand) if overflow else bitmap_of(fr)
            sparse = not overflow
        else:
            f = torch.zeros((R1, 4), dtype=torch.uint8, device=dev)
            f[:, 0] = bitmap.to(torch.uint8)
            out, _ = go_hop_ref(f, None, torch.empty_like(f), tables,
                                eslot, hrows, over)
            bitmap = (out[:, 0] & 1).bool()
            fr = torch.full((K,), sentinel, dtype=torch.int32, device=dev)
            sparse = False
    G = (R1 + 7) // 8
    bits = torch.zeros(G * 8, dtype=torch.uint8, device=dev)
    bits[:R1] = bitmap.to(torch.uint8)
    sh = torch.arange(8, dtype=torch.uint8, device=dev)
    return (bits.reshape(G, 8) << sh).sum(dim=1, dtype=torch.uint8)


def adaptive_go(starts: torch.Tensor, hub: torch.Tensor,
                tables: DeviceTables, eslot: torch.Tensor,
                hrows: torch.Tensor, over: Sequence[int], steps: int,
                K: int = 2048) -> torch.Tensor:
    """Single-query GO (ell.py:1493 make_adaptive_go_kernel): ``steps -
    1`` hops from ``starts`` int32 [<= K] (new ids): a push over the
    frontier list while it fits K ids and holds no hub (``hub`` uint8
    [n + 1], ell.EllIndex.hub_table), else, for good, the dense pull of
    the whole bitmap (``go_hop`` with the hub merge).  Returns uint8
    [ceil((n_rows + 1) / 8)]: the frontier's bitmap, row-major, little
    bit order (ell.unpack_bits inverts it); hub extra rows may hold
    junk, as in the reference.  On the card one checked C call
    (``ad_program``) enqueues every hop of both arms, the mode chosen
    on the card (``_adaptive_steps``' order), with no host read; it
    reports the calls it made, the gated ones included (``LAUNCHES``).
    On the CPU ``_adaptive_steps`` drives the plain versions in that
    order.  A call that runs a dense hop adds one to
    ``adaptive_dense_tally(device)``.  The result is a view of the
    call's own workspace."""
    over = _adaptive_args(starts, hub, tables, eslot, hrows, over, steps,
                          K)
    dev = starts.device
    dense = adaptive_dense_tally(dev)
    if not _route(dev):
        return _adaptive_steps(
            starts, hub, tables, eslot, hrows, over, steps, K,
            sparse_expand, pair_compact,
            functools.partial(adaptive_switch, dense=dense), bitmap_lanes,
            go_hop)
    R1 = tables.n_rows + 1
    pl = _adaptive_plan(R1, K, steps - 1)
    plan, blocks, lgc = _hop_desc(tables.row0, tables.slot0, tables.rows,
                                  tables.D, 4, 4)
    ws = torch.empty(pl.words, dtype=torch.int32, device=dev)
    launched = (ctypes.c_int32 * 5)()
    rc = _lib().ad_program(
        _sparse_desc(tables, None, None, over), starts.data_ptr(),
        starts.shape[0], hub.data_ptr(), pl.arr, plan, blocks, lgc,
        _over_array(over), len(over), eslot.data_ptr(), hrows.data_ptr(),
        dense.data_ptr(), ws.data_ptr(), _stream(dev), launched)
    _ok(rc, "ad_program")
    LAUNCHES["adaptive_go"] += 1
    # the calls the C call reports it made, those its gates skip included
    for name, k in zip(("sparse_expand", "pair_compact", "adaptive_switch",
                        "bitmap_lanes", "go_hop"), launched):
        LAUNCHES[name] += k
    return ws[pl.state:pl.state + _words(R1)].view(torch.uint8)[
        :(R1 + 7) // 8]


# ============================================================= absorb
class _AbsorbBuckets(ctypes.Structure):
    """``AbsorbBuckets`` of csrc/ell_absorb.cu, passed by value."""
    _fields_ = [("rows", ctypes.c_void_p * MAX_BUCKETS),
                ("un", ctypes.c_void_p * MAX_BUCKETS),
                ("ue", ctypes.c_void_p * MAX_BUCKETS),
                ("slot0", ctypes.c_longlong * MAX_BUCKETS),
                ("nrows", ctypes.c_longlong * MAX_BUCKETS),
                ("D", ctypes.c_int * MAX_BUCKETS),
                ("n", ctypes.c_int), ("kp", ctypes.c_int)]


def _absorb_check(tables: DeviceTables, rows, nn, ne) -> int:
    """Validate the reference's per-bucket arguments; returns kp."""
    nb = len(tables.D)
    if not (len(rows) == len(nn) == len(ne) == nb):
        raise ValueError(f"absorb arguments for {len(rows)}, {len(nn)}, "
                         f"{len(ne)} buckets; the tables have {nb}")
    dev = tables.nbr.device
    _tables_check(tables, dev)
    kp = int(rows[0].shape[0]) if nb else 0
    if kp < 1:
        raise ValueError("absorb needs kp >= 1 update rows per bucket")
    for b in range(nb):
        _check(rows[b], f"rows[{b}]", torch.int32, (kp,), dev)
        for t, nm in ((nn[b], "nn"), (ne[b], "ne")):
            _check(t, f"{nm}[{b}]", torch.int32, (kp, tables.D[b]), dev)
    return kp


def ell_absorb_ref(tables: DeviceTables, rows, nn, ne) -> DeviceTables:
    """Plain version of ``ell_absorb`` (ell.py:1011): clone both tables,
    then per bucket set the in-range rows through its [rows_b, D_b]
    view; pad entries (index rows_b) drop."""
    out = tables._replace(nbr=tables.nbr.clone(), et=tables.et.clone())
    for b in range(len(tables.D)):
        r = rows[b].long()
        keep = (r >= 0) & (r < tables.rows[b])
        nbr_b, et_b = out.bucket(b)
        nbr_b[r[keep]] = nn[b][keep]
        et_b[r[keep]] = ne[b][keep]
    return out


def ell_absorb(tables: DeviceTables, rows: Sequence[torch.Tensor],
               nn: Sequence[torch.Tensor], ne: Sequence[torch.Tensor]
               ) -> DeviceTables:
    """The next generation's tables: fresh copies of ``tables.nbr`` and
    ``tables.et`` with, per bucket b, row ``rows[b][i]`` replaced by
    ``nn[b][i]`` / ``ne[b][i]`` (int32 [kp] and [kp, D_b], the
    reference's ``absorb_update_arrays`` form).  Entries whose row is
    not below the bucket's row count are dropped.  The inputs are
    only read (the published generation keeps them); returns a
    DeviceTables of the same geometry over the new tensors."""
    kp = _absorb_check(tables, rows, nn, ne)
    dev = tables.nbr.device
    if not _route(dev):
        return ell_absorb_ref(tables, rows, nn, ne)
    out_nbr = torch.empty_like(tables.nbr)
    out_et = torch.empty_like(tables.et)
    for t in (tables.nbr, tables.et, out_nbr, out_et):
        if t.data_ptr() % 16:
            raise ValueError("ell_absorb's tables must be 16-byte aligned "
                             "(the copy moves int4 words)")
    nb = len(tables.D)
    bk = _AbsorbBuckets()
    for b in range(nb):
        bk.rows[b] = rows[b].data_ptr()
        bk.un[b] = nn[b].data_ptr()
        bk.ue[b] = ne[b].data_ptr()
        bk.slot0[b] = tables.slot0[b]
        bk.nrows[b] = tables.rows[b]
        bk.D[b] = tables.D[b]
    bk.n, bk.kp = nb, kp
    rc = _lib().ell_absorb(tables.nbr.data_ptr(), tables.et.data_ptr(),
                           out_nbr.data_ptr(), out_et.data_ptr(),
                           int(tables.nbr.numel()), bk, _stream(dev))
    _ok(rc, "ell_absorb")
    LAUNCHES["ell_absorb"] += 1
    return tables._replace(nbr=out_nbr, et=out_et)


# ====================================================================
# The replicated-frontier mesh (ell.py:1688-1846, :1036): the tables
# row-sharded over a mesh.PartsMesh (ell.MeshTables), the packed
# frontier replicated, one replica per shard, the replicas of the shards
# that share a card one [members, R1, W] slab.  A hop is one
# ``mesh_hop`` call a card (csrc/ell_mesh.cu ell_mesh_hop): M1, the
# hop's gather on every shard's chunk into its next replica, then M3,
# the owned rows copied to every other replica, then the hub OR-merge
# on every replica — after the replication, never per shard
# (ell.py:1780-1788) — one launch each.  Shards on other cards take the
# owned rows by copy_ (mesh.replicate_rows).  Launches on a card run
# on its current stream.
# ====================================================================
class _MeshAbsorb(ctypes.Structure):
    """``MeshAbsorb`` of csrc/ell_mesh.cu, passed by value: a card
    group's tables, their fresh copies and the update set (``first`` is
    the C entry's own)."""
    _fields_ = [("nbr", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("et", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("out_nbr", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("out_et", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("shard", ctypes.c_longlong * MAX_CARD_SHARDS),
                ("rows", ctypes.c_void_p * MAX_BUCKETS),
                ("un", ctypes.c_void_p * MAX_BUCKETS),
                ("ue", ctypes.c_void_p * MAX_BUCKETS),
                ("slot0", ctypes.c_longlong * MAX_BUCKETS),
                ("chunk", ctypes.c_longlong * MAX_BUCKETS),
                ("real", ctypes.c_longlong * MAX_BUCKETS),
                ("live", ctypes.c_longlong * MAX_BUCKETS),
                ("first", ctypes.c_longlong * MAX_BUCKETS),
                ("D", ctypes.c_int * MAX_BUCKETS),
                ("n_buckets", ctypes.c_int), ("members", ctypes.c_int)]


def _shard_live(mt, s: int) -> Tuple[int, ...]:
    """Per bucket, shard s's chunk rows below the bucket's real rows
    (M1's plan rows)."""
    t = mt.shards[s]
    return _shard_rows(t.rows, t.row0, mt.brow0, mt.real_rows)


@functools.lru_cache(maxsize=256)
def _shard_rows(rows, row0, brow0, real_rows) -> Tuple[int, ...]:
    """``_shard_live`` from a shard's geometry, made once per geometry."""
    return tuple(max(0, min(r, b0 + real - r0))
                 for r, r0, b0, real in zip(rows, row0, brow0, real_rows))


def _on_card(dev: torch.device):
    """A context in which a launch lands on ``dev``: nothing when its
    card is already the current one (entering a device context costs
    more host time than the launches here)."""
    if torch.cuda.current_device() == dev.index:
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def shard_hop_ref(fp: torch.Tensor, out: torch.Tensor, mt, s: int,
                  over: Sequence[int]) -> torch.Tensor:
    """M1's per-shard plain version (``mesh_hop``'s gather stage on
    shard s): _bucket_expand_packed over each of shard s's chunks, the
    rows past the real rows trimmed, the rest written at their frontier
    rows; the pad row zero."""
    t = mt.shards[s]
    W = fp.shape[1]
    over_t = torch.tensor(sorted(set(int(e) for e in over)),
                          dtype=torch.int32, device=fp.device)
    for b, live in enumerate(_shard_live(mt, s)):
        if live <= 0:
            continue
        nbr, et = t.bucket(b)
        nbr, et = nbr[:live], et[:live]
        ok = torch.isin(et, over_t).to(torch.uint8)
        acc = torch.zeros((live, W), dtype=torch.uint8, device=fp.device)
        for j in range(nbr.shape[1]):
            acc |= fp[nbr[:, j].long()] * ok[:, j, None]
        out[t.row0[b]:t.row0[b] + live] = acc
    out[t.n_rows] = 0
    return out


def hop_merge_ref(out: torch.Tensor, eslot: torch.Tensor,
                  hrows: torch.Tensor, n: int, n_rows: int) -> torch.Tensor:
    """The hub merge's plain version on one frontier (``mesh_hop``'s
    merge stage on a replica; ell.py:519 _scatter_or_rows)."""
    if n_rows > n:
        body = out[:n_rows]
        _scatter_or_rows_ref(body, body[n:].clone(), eslot, hrows)
    return out


MAX_OR_SOURCES = 16   # csrc ell_lanes.cu kMaxSrcs


def or_many_ref(srcs: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain version of ``or_many``: each row of the slab OR-ed into
    ``dst`` in turn."""
    for src in srcs:
        dst |= src
    return dst


def or_many(srcs: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst |= srcs[0] | ... | srcs[m - 1]`` in place, one launch:
    ``dst`` a contiguous uint8 or bool tensor a whole number of 32-bit
    words long, ``srcs`` a contiguous slab ``[m, *dst.shape]`` of its
    dtype on its device (a receive slab, checked once for all its
    rows), 1 <= m <= MAX_OR_SOURCES.  The library and the stream are
    taken once, and a device context is entered only when ``dst``'s
    card is not the current one."""
    if not isinstance(dst, torch.Tensor) or dst.dtype not in (
            torch.uint8, torch.bool):
        raise TypeError("or_many takes uint8 or bool tensors")
    dev, shape, nbytes = dst.device, tuple(dst.shape), dst.numel()
    _check(dst, "dst", dst.dtype, shape, dev)
    m = srcs.shape[0] if isinstance(srcs, torch.Tensor) and srcs.dim() \
        else 0
    _check(srcs, "srcs", dst.dtype, (m, *shape), dev)
    if not 0 < m <= MAX_OR_SOURCES:
        raise ValueError(f"{m} sources (1..{MAX_OR_SOURCES})")
    if nbytes % 4:
        raise ValueError(f"or_many works on 32-bit words: {nbytes} bytes")
    if not _route(dev):
        return or_many_ref(srcs, dst)
    dptr, base = dst.data_ptr(), srcs.data_ptr()
    if (dptr | base) % 4:
        raise ValueError("kernel operands must be 4-byte aligned "
                         "(the kernels work on 32-bit words)")
    ptrs = (ctypes.c_void_p * m)(*[base + i * nbytes for i in range(m)])
    lib = _lib()
    if torch.cuda.current_device() == dev.index:
        rc = lib.ell_or_many(dptr, ptrs, m, nbytes, _stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = lib.ell_or_many(dptr, ptrs, m, nbytes, _stream(dev))
    _ok(rc, "ell_or_many")
    LAUNCHES["or_into"] += 1
    return dst


def or_into_ref(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain version of ``or_into``."""
    dst |= src
    return dst


def or_into(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """``dst |= src`` in place, two contiguous uint8 or bool tensors of
    one shape on one device, a whole number of 32-bit words long: the
    one-source call of ``or_many`` (its launches count under
    ``LAUNCHES["or_into"]``, as ``or_many``'s do)."""
    if not isinstance(src, torch.Tensor):
        raise TypeError("or_into takes uint8 or bool tensors")
    return or_many(src.unsqueeze(0), dst)


def copy_rows_ref(src: torch.Tensor, dsts: Sequence[torch.Tensor],
                  ranges: Sequence[Tuple[int, int]]) -> None:
    """M3's per-source plain version (``mesh_hop``'s copy stage from one
    shard): one ``copy_`` per (range, receiver)."""
    for lo, hi in ranges:
        if hi > lo:
            for d in dsts:
                d[lo:hi].copy_(src[lo:hi])


def _mesh_args(mt, eslot, hrows) -> None:
    for name, v in (("eslot", eslot), ("hrows", hrows)):
        if len(v) != mt.k:
            raise ValueError(f"{name}: {len(v)} tensors for {mt.k} shards")
        for s, x in enumerate(v):
            if x.device != mt.shards[s].nbr.device:
                raise ValueError(f"{name}[{s}] is on {x.device}, shard "
                                 f"{s} on {mt.shards[s].nbr.device}")


# mesh_hop's stages: a hop is the first three, a BFS level adds the last
HOP_GATHER, HOP_COPY, HOP_MERGE, HOP_LEVEL = 1, 2, 4, 8
HOP_STAGES = HOP_GATHER | HOP_COPY | HOP_MERGE


class MeshLevel(NamedTuple):
    """The BFS level stage's operands (``mesh_hop`` with HOP_LEVEL) for
    one card group: its targets ``tp`` uint8 [n_rows + 1, W], its one
    reached bitmap ``seen`` uint8 [n_rows + 1, W] and depth matrix ``d``
    int8 or int16 [n_rows + 1, 8W], and this level's flags int32 [2]
    (zero before), all on the group's card; the level ``step``;
    ``first``: the loop's first pass; ``stop``: the targets' flag wanted
    (``bfs_level``'s arguments)."""
    tp: torch.Tensor
    seen: torch.Tensor
    d: torch.Tensor
    flags: torch.Tensor
    step: int
    first: bool
    stop: bool


class _MeshHop(ctypes.Structure):
    """``hop::MeshHop`` of csrc/hop_plan.cuh, passed by value: a card
    group's tables and chunk geometry."""
    _fields_ = [("nbr", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("et", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("shard", ctypes.c_longlong * MAX_CARD_SHARDS),
                ("chunk", ctypes.c_longlong * MAX_BUCKETS),
                ("real", ctypes.c_longlong * MAX_BUCKETS),
                ("n", ctypes.c_int)]


_CARD_DESC: Dict[tuple, tuple] = {}


def _card_desc(tensors: tuple, extra: tuple, build):
    """``build()``, a card's by-value descriptor holding the addresses of
    ``tensors``, made once and kept while every one of them lives (a new
    table generation gets its own)."""
    key = tuple(map(id, tensors)) + extra
    hit = _CARD_DESC.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        return hit[1]
    if len(_CARD_DESC) >= 256:
        for kk, (refs, _v) in list(_CARD_DESC.items()):
            if any(r() is None for r in refs):
                _CARD_DESC.pop(kk, None)
    val = build()
    _CARD_DESC[key] = (tuple(weakref.ref(t) for t in tensors), val)
    return val


def _mesh_hop_desc(mt, members: Tuple[int, ...]) -> _MeshHop:
    tabs = tuple(x for s in members
                 for x in (mt.shards[s].nbr, mt.shards[s].et))

    def build():
        mh = _MeshHop()
        for y, s in enumerate(members):
            mh.nbr[y] = mt.shards[s].nbr.data_ptr()
            mh.et[y] = mt.shards[s].et.data_ptr()
            mh.shard[y] = s
        t = mt.shards[0]
        for b in range(len(t.D)):
            mh.chunk[b] = t.rows[b]
            mh.real[b] = mt.real_rows[b]
        mh.n = len(members)
        return mh
    return _card_desc(tabs, ("hop", members), build)


def _card_check(mt, group) -> Tuple[torch.device, Tuple[int, ...]]:
    dev, members = group
    members = tuple(members)
    if not 0 < len(members) <= MAX_CARD_SHARDS or any(
            not 0 <= s < mt.k or mt.shards[s].nbr.device != dev
            for s in members):
        raise ValueError(f"card group {members} on {dev} of a {mt.k}-shard "
                         f"mesh (at most {MAX_CARD_SHARDS} a card)")
    return dev, members


def _hop_slabs(cur, nxt, mt, members, dev) -> Tuple[int, int]:
    kg, R1 = len(members), mt.shards[0].n_rows + 1
    if not isinstance(cur, torch.Tensor) or cur.dim() != 3:
        raise ValueError("cur must be a [members, n_rows + 1, W] slab")
    W = cur.shape[2]
    if W % 4:
        raise ValueError(f"lane words W={W} must be a multiple of 4 "
                         f"(the kernels work on 32-bit words)")
    _check(cur, "cur", torch.uint8, (kg, R1, W), dev)
    _check(nxt, "nxt", torch.uint8, (kg, R1, W), dev)
    if nxt.data_ptr() == cur.data_ptr():
        raise ValueError("nxt must be a separate slab from cur")
    return R1, W


def mesh_level_ref(nxt: torch.Tensor, level: MeshLevel) -> torch.Tensor:
    """Plain version of ``mesh_hop``'s level stage: ``bfs_level_ref`` on
    the slab's first replica with the group's reached bitmap, depth
    matrix and flags, then the new frontier copied into the other
    replicas."""
    bfs_level_ref(nxt[0], level.tp, level.seen, level.d, level.flags,
                  level.step, level.first, level.stop)
    if not level.first:
        nxt[1:] = nxt[0]
    return nxt


def mesh_hop_ref(cur: torch.Tensor, nxt: torch.Tensor, mt, group,
                 eslot: torch.Tensor, hrows: torch.Tensor,
                 over: Sequence[int], stages: int = HOP_STAGES,
                 level: Optional[MeshLevel] = None) -> torch.Tensor:
    """Plain version of ``mesh_hop``: the per-shard plain versions of
    M1, M3 and the merge, composed over the card's members, then
    ``mesh_level_ref``."""
    members = tuple(group[1])
    t = mt.shards[0]
    if stages & HOP_GATHER:
        for y, s in enumerate(members):
            shard_hop_ref(cur[y], nxt[y], mt, s, over)
    if stages & HOP_COPY:
        for y, s in enumerate(members):
            others = [nxt[z] for z in range(len(members)) if z != y]
            if others:
                copy_rows_ref(nxt[y], others, mt.owned(s))
    if stages & HOP_MERGE:
        for y in range(len(members)):
            hop_merge_ref(nxt[y], eslot, hrows, t.n, t.n_rows)
    if stages & HOP_LEVEL:
        mesh_level_ref(nxt, level)
    return nxt


def _level_check(level: Optional[MeshLevel], stages: int, R1: int, W: int,
                 dev: torch.device) -> None:
    if not stages & HOP_LEVEL:
        if level is not None:
            raise ValueError("level operands without the HOP_LEVEL stage")
        return
    if not isinstance(level, MeshLevel):
        raise ValueError("the HOP_LEVEL stage needs its MeshLevel")
    _level_operands(R1, W, level.tp, level.seen, level.d, level.flags,
                    level.step, dev)


def mesh_hop(cur: torch.Tensor, nxt: torch.Tensor, mt, group,
             eslot: torch.Tensor, hrows: torch.Tensor, over: Sequence[int],
             stages: int = HOP_STAGES, level: Optional[MeshLevel] = None
             ) -> torch.Tensor:
    """One replicated-frontier hop (ell.py:1771-1796) for the members of
    one card group ``group`` = (device, shards) of ``mt.mesh.groups``:
    ``cur`` / ``nxt`` are their replicas, uint8 [members, n_rows + 1,
    W] slabs (row y: shard ``group[1][y]``), ``eslot`` / ``hrows`` the
    hub merge's arrays on the card.  The stages, each one launch over
    every member:

    - HOP_GATHER (M1): each shard's chunk rows of ``nxt[y]`` get, per
      row, the OR over its slots whose etype is in ``over`` of the
      gathered ``cur[y]`` rows; its pad row zero, its other rows left;
    - HOP_COPY (M3): each member's owned rows (``mt.owned(s)``) of
      ``nxt[y]`` copied into every other member's (each owned row reaches
      the members - 1 others: the bytes a mesh of cards moves);
    - HOP_MERGE: the hub OR-merge on every member's replica;
    - HOP_LEVEL: the batched BFS's level pass (``bfs_level`` with
      ``level``'s operands) on the group's replicas, which the hop left
      equal: the first replica read once, the group's one reached
      bitmap, depth matrix and flags updated, the new frontier written
      into every replica where it changed (with ``level.first`` only
      ``level.seen`` and ``level.d`` are written, from the first
      replica).

    Returns ``nxt``.  One checked C call (``ell_mesh_hop``), which
    reports the launches it made: ``LAUNCHES`` counts those of
    ``shard_hop``, ``replicate_rows``, ``hop_merge`` and ``mesh_level``
    from its report.
    The shards of other cards get the owned rows from
    ``mesh.replicate_rows``."""
    dev, members = _card_check(mt, group)
    R1, W = _hop_slabs(cur, nxt, mt, members, dev)
    if not 0 < stages <= HOP_STAGES | HOP_LEVEL:
        raise ValueError(f"stages {stages}")
    _level_check(level, stages, R1, W, dev)
    t = mt.shards[0]
    n_extras = t.n_rows - t.n
    _check(eslot, "eslot", torch.int32, (n_extras,), dev)
    if hrows.dim() != 1:
        raise ValueError("hrows must be 1-D")
    _check(hrows, "hrows", torch.int32, tuple(hrows.shape), dev)
    over = _over_check(over)
    if not _route(dev):
        return mesh_hop_ref(cur, nxt, mt, group, eslot, hrows, over, stages,
                            level)
    fpp, outp = cur.data_ptr(), nxt.data_ptr()
    stride = cur[0].numel()
    if (fpp | outp) % 4:
        raise ValueError("kernel operands must be 4-byte aligned "
                         "(the kernels work on 32-bit words)")
    wide = W % 16 == 0 and not (fpp | outp | stride) % 16
    desc, blocks, lgc = _hop_desc(t.row0, t.slot0, _shard_live(mt, 0), t.D,
                                  W, 16 if wide else 4)
    lv = level or MeshLevel(None, None, None, None, 0, False, False)
    if level is not None:
        _level_aligned(nxt, lv.tp, lv.seen, lv.d, lv.flags)
    ptr = (lambda x: None if x is None else x.data_ptr())
    launched = (ctypes.c_int32 * 4)()
    with _on_card(dev):
        rc = _lib().ell_mesh_hop(
            stages, fpp, outp, stride, _mesh_hop_desc(mt, members), desc,
            len(t.D), blocks, lgc, wide, _over_array(over), len(over),
            eslot.data_ptr(), hrows.data_ptr(), t.n, t.n_rows, W,
            ptr(lv.tp), ptr(lv.seen), ptr(lv.d),
            lv.d.element_size() if level is not None else 0, ptr(lv.flags),
            lv.step, int(lv.first), int(lv.stop), _stream(dev), launched)
    _ok(rc, "ell_mesh_hop")
    LAUNCHES["mesh_hop"] += 1
    # the launches the C call reports it made
    for name, n in zip(("shard_hop", "replicate_rows", "hop_merge",
                        "mesh_level"), launched):
        LAUNCHES[name] += n
    return nxt


def _hop_all(cur, nxt, mt, eslot, hrows, over, blocks, hop,
             level=None) -> None:
    """One replicated-frontier hop of the whole mesh: ``hop`` (``mesh_hop``
    or its plain version) on every card group's slabs ``cur[g]`` ->
    ``nxt[g]``.  One card: one call.  Several: the gather a card, the
    owned rows replicated (``mesh.replicate_rows``: the copy stage a
    card, ``copy_`` across cards; ``blocks[s] = mt.owned(s)``), then the
    merge a card.  ``level``: None, or ``level(g)`` group g's
    ``MeshLevel``, whose level stage then rides the group's last call."""
    from .mesh import replicate_rows
    groups = mt.mesh.groups
    one = lambda g: (mt, groups[g], eslot[groups[g][1][0]],  # noqa: E731
                     hrows[groups[g][1][0]], over)

    def last(g, stages):
        if level is None:
            hop(cur[g], nxt[g], *one(g), stages)
        else:
            hop(cur[g], nxt[g], *one(g), stages | HOP_LEVEL, level(g))
    if len(groups) == 1:
        last(0, HOP_STAGES)
        return
    for g in range(len(groups)):
        hop(cur[g], nxt[g], *one(g), HOP_GATHER)
    card = {members: g for g, (_d, members) in enumerate(groups)}
    replicate_rows(mt.mesh.rows(nxt), blocks,
                   lambda members: hop(cur[card[members]], nxt[card[members]],
                                       *one(card[members]), HOP_COPY),
                   groups)
    for g in range(len(groups)):
        last(g, HOP_MERGE)


def _go_sharded_loop(f0p, mt, eslot, hrows, over, steps, hop):
    _frontier(f0p, "f0p")
    _mesh_args(mt, eslot, hrows)
    over = _over_check(over)
    cur = mt.mesh.replicas(f0p)
    if steps > 1:
        nxt = [torch.empty_like(c) for c in cur]
        blocks = [mt.owned(s) for s in range(mt.k)] \
            if len(mt.mesh.groups) > 1 else None
        for _ in range(steps - 1):
            _hop_all(cur, nxt, mt, eslot, hrows, over, blocks, hop)
            cur, nxt = nxt, cur
    return mt.mesh.rows(cur)


def ell_go_sharded_ref(f0p: torch.Tensor, mt, eslot, hrows,
                       over: Sequence[int], steps: int):
    """Plain version of ``ell_go_sharded``: the same loop over the plain
    version of the hop."""
    return _go_sharded_loop(f0p, mt, eslot, hrows, over, steps,
                            mesh_hop_ref)


def ell_go_sharded(f0p: torch.Tensor, mt, eslot, hrows,
                   over: Sequence[int], steps: int):
    """Batched dense GO on the mesh (ell.py:1712
    make_sharded_batched_go_kernel): the start frontier ``f0p`` uint8
    [n_rows + 1, W] (read only) is copied to every shard (one launch a
    card), then ``steps - 1`` replicated-frontier hops run, each one
    ``mesh_hop`` call a card.  ``eslot``/``hrows`` hold one tensor per
    shard, on its device.  Returns the k replicas of the result (each
    shard's row of its card's slab), equal to ``ell_go``'s exact-depth
    frontier (there is no UPTO form: the mesh declines UPTO)."""
    out = _go_sharded_loop(f0p, mt, eslot, hrows, over, steps, mesh_hop)
    if steps > 1 and _route(f0p.device):
        LAUNCHES["ell_go_sharded"] += 1
    return out


def _bfs_sharded_start(f0p, t0p, mt, eslot, hrows, over, max_steps):
    _bfs_pair(f0p, t0p)
    _mesh_args(mt, eslot, hrows)
    if not 0 <= max_steps < int(INT16_INF) - 1:
        raise ValueError(f"max_steps={max_steps} does not fit int16")
    blocks = [mt.owned(s) for s in range(mt.k)] \
        if len(mt.mesh.groups) > 1 else None
    return _over_check(over), blocks


def _bfs_sharded_loop(f0p, t0p, mt, eslot, hrows, over, max_steps, stop,
                      hop, read=None):
    """The mesh BFS with its level pass a stage of ``hop`` (``mesh_hop``
    or its plain version): one reached bitmap, one depth matrix (in the
    result's form, ``depth_dtype``), one flags slab and the targets once
    a card group (``t0p`` itself on its own card); the first pass is the
    level stage alone, a level the hop with the stage in its group's
    last call.  ``read(flag)``: a level's (frontier, target) flags on
    the host, by default one copy from group 0's card, or given back by
    a caller that knows what a run reads (nothing then waits on the
    card).  Returns (group 0's depth, levels run)."""
    over, blocks = _bfs_sharded_start(f0p, t0p, mt, eslot, hrows, over,
                                      max_steps)
    mesh = mt.mesh
    R1, W = f0p.shape
    fp = mesh.replicas(f0p)
    buf = [torch.empty_like(f) for f in fp]
    tp = [t0p if dev == t0p.device else t0p.to(dev)
          for dev, _m in mesh.groups]
    seen = [torch.empty((R1, W), dtype=torch.uint8, device=dev)
            for dev, _m in mesh.groups]
    d = [torch.empty((R1, 8 * W), dtype=depth_dtype(max_steps), device=dev)
         for dev, _m in mesh.groups]
    flags = [torch.zeros((max_steps + 1, 2), dtype=torch.int32, device=dev)
             for dev, _m in mesh.groups]
    for g in range(len(mesh.groups)):
        hop(buf[g], fp[g], mt, mesh.groups[g], eslot[mesh.groups[g][1][0]],
            hrows[mesh.groups[g][1][0]], over, HOP_LEVEL,
            MeshLevel(tp[g], seen[g], d[g], flags[g][0], 0, True, stop))
    step = 0
    # ell.py:1824-1836's loop condition, read from group 0 (every group
    # holds the same frontier and depths) once a level
    read = read or (lambda flag: flag.tolist())
    while step < max_steps:
        f_any, t_any = read(flags[0][step])
        if not f_any or (stop and not t_any):
            break
        _hop_all(fp, buf, mt, eslot, hrows, over, blocks, hop,
                 lambda g, k=step: MeshLevel(tp[g], seen[g], d[g],
                                             flags[g][k + 1], k, False,
                                             stop))
        fp, buf = buf, fp
        step += 1
    return d[0], step


def _bfs_replica_loop(f0p, t0p, mt, eslot, hrows, over, max_steps, stop,
                      hop, level):
    """The mesh BFS as the plain program runs it: the targets, a reached
    bitmap, a depth matrix and a flags slab on every shard, ``level``
    (``bfs_level``'s plain version) on every replica after each hop, the
    loop condition read from shard 0."""
    from .mesh import on
    over, blocks = _bfs_sharded_start(f0p, t0p, mt, eslot, hrows, over,
                                      max_steps)
    mesh = mt.mesh
    R1, W = f0p.shape
    fp, tp = mesh.replicas(f0p), mesh.rows(mesh.replicas(t0p))
    buf = [torch.empty_like(f) for f in fp]
    seen = mesh.rows(mesh.slabs((R1, W), torch.uint8))
    d = mesh.rows(mesh.slabs((R1, 8 * W), depth_dtype(max_steps)))
    flags = mesh.rows(mesh.slabs((max_steps + 1, 2), torch.int32,
                                 zero=True))
    devs = mesh.devices
    for s, f in enumerate(mesh.rows(fp)):
        with on(devs[s]):
            level(f, tp[s], seen[s], d[s], flags[s][0], 0, True, stop)
    step = 0
    while step < max_steps:
        f_any, t_any = flags[0][step].tolist()
        if not f_any or (stop and not t_any):
            break
        _hop_all(fp, buf, mt, eslot, hrows, over, blocks, hop)
        for s, f in enumerate(mesh.rows(buf)):
            with on(devs[s]):
                level(f, tp[s], seen[s], d[s], flags[s][step + 1], step,
                      False, stop)
        fp, buf = buf, fp
        step += 1
    return d[0], step


def ell_bfs_sharded_ref(f0p: torch.Tensor, t0p: torch.Tensor, mt, eslot,
                        hrows, over: Sequence[int], max_steps: int,
                        stop_when_found: bool = True):
    """Plain version of ``ell_bfs_sharded``: the per-replica program
    (``_bfs_replica_loop``), a reached bitmap and a depth matrix a
    shard, over the plain versions of the hop and the level pass."""
    return _bfs_replica_loop(f0p, t0p, mt, eslot, hrows, over, max_steps,
                             stop_when_found, mesh_hop_ref, bfs_level_ref)


def ell_bfs_sharded(f0p: torch.Tensor, t0p: torch.Tensor, mt, eslot,
                    hrows, over: Sequence[int], max_steps: int,
                    stop_when_found: bool = True):
    """Batched BFS depths on the mesh (ell.py:1799
    make_sharded_batched_bfs_kernel): ``f0p``/``t0p`` packed start and
    target lanes (read only); ``f0p`` is copied to every shard.  The
    first pass is ``mesh_hop``'s level stage alone, each level one
    ``mesh_hop`` call a card with the level stage after the hop: one
    reached bitmap, one depth matrix and one flags pair a card group,
    the targets read from ``t0p`` on its own card.  Returns (the depth,
    levels run), in ``ell_bfs``'s form, which the level stage keeps it
    in: int8 with -1 unreached when ``max_steps <= 120``, else int16
    with INT16_INF.  On the CPU the same loop runs the stages' plain
    versions (``mesh_level_ref``)."""
    out = _bfs_sharded_loop(f0p, t0p, mt, eslot, hrows, over, max_steps,
                            stop_when_found, mesh_hop)
    if _route(f0p.device):
        LAUNCHES["ell_bfs_sharded"] += 1
    return out


def _absorb_live(live, nb: int, kp: int) -> Tuple[int, ...]:
    """The update rows walked a bucket: the first ``live[b]`` of its kp
    (the plan's real rows come first, ``ell.absorb_live``); None: all
    kp, the pads dropped by their row."""
    if live is None:
        return (kp,) * nb
    live = tuple(int(x) for x in live)
    if len(live) != nb or any(not 0 <= x <= kp for x in live):
        raise ValueError(f"live rows {live} for {nb} buckets of {kp}")
    return live


def shard_absorb_ref(mt, s: int, rows, nn, ne, live=None):
    """Plain version of ``shard_absorb`` (ell.py:1061-1073): shard s's
    tables cloned, then each of the first ``live[b]`` update rows that
    shard s owns written in."""
    if not 0 <= s < mt.k:
        raise ValueError(f"shard {s} of a {mt.k}-shard mesh")
    t = mt.shards[s]
    kp = _absorb_check(t, rows, nn, ne)
    live = _absorb_live(live, len(t.D), kp)
    out = t._replace(nbr=t.nbr.clone(), et=t.et.clone())
    for b in range(len(t.D)):
        r = rows[b][:live[b]]
        loc = r.long() - s * t.rows[b]
        keep = (loc >= 0) & (loc < t.rows[b])
        nbr_b, et_b = out.bucket(b)
        nbr_b[loc[keep]] = nn[b][:live[b]][keep]
        et_b[loc[keep]] = ne[b][:live[b]][keep]
    return out


def mesh_absorb(mt, group, rows: Sequence[torch.Tensor],
                nn: Sequence[torch.Tensor], ne: Sequence[torch.Tensor],
                live: Optional[Sequence[int]] = None):
    """M2 for the members of one card group ``group`` = (device,
    shards): each member's next-generation tables, fresh copies of its
    ``nbr`` / ``et`` with every update row it owns written in (row r of
    bucket b is shard ``r // chunk_b``'s chunk row ``r % chunk_b``).
    ``rows`` / ``nn`` / ``ne``: the update set on the card, the
    reference's padded per-bucket arguments (int32 [kp] and [kp, D_b]),
    read in place; ``live``: the rows walked a bucket, its first ones
    (``_absorb_live``).  A pad entry (row past the bucket's real rows)
    is dropped.  The input tables are only read.  On the card one C
    call (``ell_mesh_absorb``): a copy of every member's tables, then
    one walk over the update rows, a launch each.  Returns the members'
    DeviceTables, of their geometry, in the group's order."""
    dev, members = _card_check(mt, group)
    kp = _absorb_check(mt.shards[members[0]], rows, nn, ne)
    nb = len(rows)
    live = _absorb_live(live, nb, kp)
    if not _route(dev):
        return tuple(shard_absorb_ref(mt, s, rows, nn, ne, live)
                     for s in members)
    ma = _MeshAbsorb()
    outs = []
    for y, s in enumerate(members):
        t = mt.shards[s]
        _tables_check(t, dev)
        a, e = torch.empty_like(t.nbr), torch.empty_like(t.et)
        for x in (t.nbr, t.et, a, e):
            if x.data_ptr() % 16:
                raise ValueError("shard_absorb's tables must be 16-byte "
                                 "aligned (the copy moves int4 words)")
        ma.nbr[y], ma.et[y] = t.nbr.data_ptr(), t.et.data_ptr()
        ma.out_nbr[y], ma.out_et[y] = a.data_ptr(), e.data_ptr()
        ma.shard[y] = s
        outs.append(t._replace(nbr=a, et=e))
    t = mt.shards[members[0]]
    for b in range(nb):
        ma.rows[b] = rows[b].data_ptr()
        ma.un[b] = nn[b].data_ptr()
        ma.ue[b] = ne[b].data_ptr()
        ma.slot0[b] = t.slot0[b]
        ma.chunk[b] = t.rows[b]
        ma.real[b] = mt.real_rows[b]
        ma.live[b] = live[b]
        ma.D[b] = t.D[b]
    ma.n_buckets, ma.members = nb, len(members)
    with _on_card(dev):
        rc = _lib().ell_mesh_absorb(ma, int(t.nbr.numel()), _stream(dev))
    _ok(rc, "ell_mesh_absorb")
    LAUNCHES["shard_absorb"] += 1
    return tuple(outs)


def shard_absorb(mt, s: int, rows, nn, ne, live=None):
    """M2 on shard s alone: ``mesh_absorb``'s one-member call (the
    update set on shard s's device).  Returns a DeviceTables of its
    geometry."""
    if not 0 <= s < mt.k:
        raise ValueError(f"shard {s} of a {mt.k}-shard mesh")
    return mesh_absorb(mt, (mt.shards[s].nbr.device, (s,)), rows, nn, ne,
                       live)[0]


def updates_to(rows, nn, ne, dev: torch.device):
    """The update set copied to ``dev`` in one copy: the buffer its
    per-bucket views share (the runtime's one upload), or the views laid
    end to end when they share none, re-viewed in the arguments'
    shapes.  Returns (rows, nn, ne) on ``dev``."""
    parts = [x for trip in zip(rows, nn, ne) for x in trip]
    base = parts[0]._base
    if base is not None and base.is_contiguous() and all(
            x._base is base and x.is_contiguous() for x in parts):
        flat = base.reshape(-1)
        offs = [x.storage_offset() - base.storage_offset() for x in parts]
    else:
        flat = torch.cat([x.reshape(-1) for x in parts])
        offs, at = [], 0
        for x in parts:
            offs.append(at)
            at += x.numel()
    moved = flat.to(dev, copy=True)
    views = [moved[o:o + x.numel()].view(tuple(x.shape))
             for o, x in zip(offs, parts)]
    return views[0::3], views[1::3], views[2::3]


def ell_absorb_sharded_ref(mt, rows, nn, ne, live=None):
    """Plain version of ``ell_absorb_sharded``: ``shard_absorb_ref`` on
    every shard, the update set read on its device."""
    shards = tuple(shard_absorb_ref(
        mt, s, *[[x.to(t.nbr.device) for x in xs] for xs in (rows, nn, ne)],
        live) for s, t in enumerate(mt.shards))
    return mt._replace(shards=shards)


def ell_absorb_sharded(mt, rows: Sequence[torch.Tensor],
                       nn: Sequence[torch.Tensor],
                       ne: Sequence[torch.Tensor],
                       live: Optional[Sequence[int]] = None):
    """The next generation's mesh tables (ell.py:1036
    make_sharded_ell_absorb_kernel): each shard applies the rows of the
    replacement-row set (the reference's ``absorb_update_arrays`` form,
    on any one device; ``live``: ``mesh_absorb``'s) that it owns, one
    ``mesh_absorb`` a card group; the group on the set's card reads it
    in place, another card's group takes one copy; nothing else moves
    between shards.  The inputs are only read.  Returns a MeshTables
    over the new tensors."""
    if not (len(rows) == len(nn) == len(ne)):
        raise ValueError("absorb arguments of unequal bucket counts")
    # the group on the set's device reads it in place (the first, where
    # several pretend to be cards)
    home = next((g for g, (d, _m) in enumerate(mt.mesh.groups)
                 if d == rows[0].device), None)
    shards = [None] * mt.k
    for g, group in enumerate(mt.mesh.groups):
        upd = (rows, nn, ne) if g == home else \
            updates_to(rows, nn, ne, group[0])
        for s, t in zip(group[1], mesh_absorb(mt, group, *upd, live)):
            shards[s] = t
    if _route(mt.shards[0].nbr.device):
        LAUNCHES["ell_absorb_sharded"] += 1
    return mt._replace(shards=tuple(shards))


# ====================================================================
# The frontier-sharded mesh (ell.py:1849-2310): the row space cut into
# k chunks (ell.ShardedTables), each shard holding its chunk's pairs of
# every query's frontier as a (qid, row) list.  A hop is X1
# (``mesh_route``) on every shard — the shard's pairs (and the hub
# extra-row pairs it received) walked in its local blocks, each
# candidate sent to the slot block of the shard owning it — then
# ``mesh.all_to_all``, X2 (``mesh_mark``) at the owner and K5
# (``pair_compact`` with the shard's row base) for the deduped, capped,
# sorted next list; hub pairs travel the same way in X1's hub mode.
# The BFS stamps its depth with X3 (``mesh_bfs_stamp``).  Exchange
# buffers are int64 [k, 1 + cap]: per destination block, its count
# (every pair sent, kept or not) then up to ``cap`` keys q << 32 | row;
# a receiver reads min(count, cap) keys, so nothing is refilled.
# Launches on a shard run on its device's current stream.
# ====================================================================
CTL_LIVE, CTL_UNFOUND = 6, 7    # the BFS stamp's flags (ctl slots)
KEY_SHIFT = 32                  # exchange key: q << 32 | row


def _slot_pairs(buf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q, row) int64 of the live keys of an exchange buffer [blocks,
    1 + cap], in block order."""
    cap = buf.shape[1] - 1
    qs, us = [], []
    for blk in buf:
        c = min(int(blk[0]), cap)
        key = blk[1:1 + c]
        qs.append(key >> KEY_SHIFT)
        us.append(key & 0xFFFFFFFF)
    if not qs:
        z = torch.zeros(0, dtype=torch.int64, device=buf.device)
        return z, z
    return torch.cat(qs), torch.cat(us)


class _MeshTools:
    """ell.py:1954 ``_mesh_sparse_tools`` on per-shard tensors (each on
    its shard's device): the local bucket-block gather, the router, the
    all_to_all, the owner's sort dedup and the local hub expansion."""

    def __init__(self, st, over):
        self.st = st
        self.k, self.chunk, self.sent = st.k, st.chunk, st.n_rows
        self.devs = [t.nbr.device for t in st.shards]
        self.neg = torch.tensor([-t for t in over], dtype=torch.int32)
        self.d_max = max(st.shards[0].D) if st.shards[0].D else 1

    def local_gather(self, s, rows):
        """[g, d_max] candidate rows of each row's out-slots."""
        t, st = self.st.shards[s], self.st
        rows = rows.long()
        cand = torch.full((rows.shape[0], self.d_max), self.sent,
                          dtype=torch.int64, device=rows.device)
        for b in range(len(t.D)):
            nbr, et = t.bucket(b)
            mxb, D = t.rows[b], t.D[b]
            loc = rows - t.row0[b]
            inb = (loc >= 0) & (loc < mxb) & (rows >= st.bstarts[b]) \
                & (rows < st.bucket_end(b))
            safe = torch.where(inb, loc, 0)
            ok = inb[:, None] & torch.isin(et[safe], self.neg.to(et.device))
            block = torch.where(ok, nbr[safe].long(), self.sent)
            cand[:, :D] = torch.where(inb[:, None], block, cand[:, :D])
        return cand

    def route(self, q, u, slot_cap):
        """(q_x [k, slot_cap], u_x [k, slot_cap], overflow, each
        owner's count): the pairs sorted by (owner, q, u), BIG_Q /
        sentinel padding."""
        k, sent = self.k, self.sent
        q, u = q.long(), u.long()
        valid = u != sent
        dest = torch.where(valid, u // self.chunk, k)
        order = torch.argsort(u, stable=True)
        order = order[torch.argsort(q[order], stable=True)]
        order = order[torch.argsort(dest[order], stable=True)]
        sd, sq, su = dest[order], q[order], u[order]
        cnt = torch.bincount(sd, minlength=k + 1)[:k]
        off = torch.cumsum(cnt, 0) - cnt
        q_x = torch.full((k, slot_cap), BIG_Q, dtype=torch.int64,
                         device=u.device)
        u_x = torch.full((k, slot_cap), sent, dtype=torch.int64,
                         device=u.device)
        for d in range(k):
            take = min(int(cnt[d]), slot_cap)
            lo = int(off[d])
            q_x[d, :take] = sq[lo:lo + take]
            u_x[d, :take] = su[lo:lo + take]
        return q_x, u_x, bool((cnt > slot_cap).any()), cnt

    def exchange(self, qs, us, slot_cap):
        """route on every shard + all_to_all -> per shard (flat q, flat
        u, overflow)."""
        routed = [self.route(q, u, slot_cap) for q, u in zip(qs, us)]
        out = []
        for d in range(self.k):
            dev = self.devs[d]
            out.append((torch.cat([routed[s][0][d].to(dev)
                                   for s in range(self.k)]),
                        torch.cat([routed[s][1][d].to(dev)
                                   for s in range(self.k)]),
                        routed[d][2]))
        return out

    def dedup(self, q, u, c_out):
        i, qq, cnt = _dedup_compact_ref(q, u, c_out, self.sent,
                                        self.sent + 1)
        return qq.long(), i.long(), cnt > c_out, cnt

    def hubs(self, s, q, u):
        """expand_local_hubs (EX = the list's length)."""
        base = s * self.chunk
        li = torch.where(u == self.sent, 0, u - base)
        li = li.clamp(0, self.chunk - 1)
        raw = torch.where(u == self.sent, 0,
                          self.st.ecnt[s].long()[li])
        return _hub_iota_ref(raw, self.st.e0[s].long()[li], q,
                             u.shape[0], self.sent)


def _send_ref(T, q: torch.Tensor, u: torch.Tensor, send: torch.Tensor,
              ctl: torch.Tensor) -> None:
    """ell.py:1993 ``route`` into an exchange buffer (``T`` a
    ``_MeshTools``): each owner's count of the valid pairs and its
    first ``cap`` keys in (q, u) order; a count past the cap raises the
    overflow."""
    cap = send.shape[1] - 1
    q_x, u_x, ovf, cnt = T.route(q, u, cap)
    send[:, 0] = cnt
    keys = (q_x << KEY_SHIFT) | u_x
    for d in range(T.k):
        take = min(int(cnt[d]), cap)
        send[d, 1:1 + take] = keys[d, :take]
    if ovf:
        ctl[CTL_OVF] = 1


def _hub_c_lim(c_in: int) -> int:
    """_segmented_hub_iota's per-pair clamp (ell.py:415)."""
    return max(1, (2**31 - 1) // max(c_in, 1))


def mesh_route_ref(hub, ids, qid, recv, st, s, over, send, ctl,
                   c_in=None):
    """X1's per-shard plain version (``mesh_route_card`` on shard s,
    into a [k, 1 + cap] buffer of its own blocks, one an owner, their
    counts reset).  Hub mode's budget is ``c_in`` (default the list's
    length) and it sends every run (the kernel does not stop at the
    budget), so the counts agree on an overflow too."""
    T = _MeshTools(st, over)
    n_rows, chunk, base = st.n_rows, st.chunk, s * st.chunk
    v, q = ids.long(), qid.long()
    live = (v >= 0) & (v < n_rows)
    if hub:
        c_in = v.shape[0] if c_in is None else c_in
        li = (v - base).clamp(0, chunk - 1)
        ce = torch.where(live, st.ecnt[s].long()[li], 0)
        total = int(ce.sum())
        ctl[CTL_HUB_TOTAL] = total
        if total > c_in or bool((ce > _hub_c_lim(c_in)).any()):
            ctl[CTL_OVF] = 1
        first = st.e0[s].long()[li].repeat_interleave(ce)
        start = torch.cumsum(ce, 0) - ce
        j = torch.arange(total, device=v.device) \
            - start.repeat_interleave(ce)
        _send_ref(T, q.repeat_interleave(ce), first + j, send, ctl)
        return send
    rows, rq = v[live], q[live]
    if recv is not None:
        eq, er = _slot_pairs(recv)
        rows, rq = torch.cat([rows, er]), torch.cat([rq, eq])
    cand = T.local_gather(s, rows)
    _send_ref(T, rq.repeat_interleave(cand.shape[1]), cand.reshape(-1),
              send, ctl)
    return send


def mesh_mark_ref(recv, base, chunk, mark, W):
    """X2's per-shard plain version (``mesh_dedup``'s mark on one
    shard's receive row ``recv`` [k, 1 + cap])."""
    q, u = _slot_pairs(recv)
    li = u - base
    ok = (li >= 0) & (li < chunk) & (q >= 0) & (q < mark.numel() // W)
    _mark_bits(mark, W, q[ok], li[ok])
    return mark


def _tbit(tbits: torch.Tensor, W: int, q: torch.Tensor,
          li: torch.Tensor) -> torch.Tensor:
    """Bit (q, li) of a [qrows * W] bitmap, as bool."""
    w = tbits.long()[q * W + (li >> 5)]
    return ((w >> (li & 31)) & 1).bool()


def mesh_bfs_stamp_ref(init, ids, qid, depth, tbits, W, base, n_rows,
                       step, ctl, tids=None, tqid=None):
    """X3's per-shard plain version (``mesh_bfs_stamp_card`` on one
    member: ``depth`` int16 [chunk, qmax], ``tbits`` int32 [qmax * W],
    ``ctl`` int64 [CTL_SIZE], the list ``ids`` / ``qid`` read whole)."""
    chunk, qmax = depth.shape
    flat = depth.view(-1)
    inf = int(INT16_INF)
    if init:
        live = ids.long() != n_rows
        li = (ids.long() - base).clamp(0, chunk - 1)[live]
        q = qid.long().clamp(0, qmax - 1)[live]
        flat[li * qmax + q] = 0
        ctl[CTL_LIVE] = int(live.sum())
        at = torch.nonzero(live)
        ctl[CTL_CNT] = int(at[-1]) + 1 if len(at) else 0
        tl = tids.long() != n_rows
        tli = (tids.long() - base).clamp(0, chunk - 1)[tl]
        tq = tqid.long().clamp(0, qmax - 1)[tl]
        cell = torch.unique(tq * chunk + tli)
        tq, tli = cell // chunk, cell % chunk
        new = ~_tbit(tbits, W, tq, tli)
        _mark_bits(tbits, W, tq, tli)
        ctl[CTL_UNFOUND] += int((new & (flat[tli * qmax + tq] == inf))
                                .sum())
        return depth
    live = ids.long() != n_rows
    li = (ids.long() - base).clamp(0, chunk - 1)
    q = qid.long().clamp(0, qmax - 1)
    fresh = live & (flat[li * qmax + q] == inf)
    flat[(li * qmax + q)[fresh]] = step + 1
    ids[live & ~fresh] = n_rows
    qid[live & ~fresh] = BIG_Q
    ctl[CTL_LIVE] = int(fresh.sum())
    ctl[CTL_UNFOUND] -= int((fresh & _tbit(tbits, W, q, li)).sum())
    return depth


# ----------------------------------- the plain programs (ell.py:1954)
def _start_slabs(st, *lists) -> int:
    """Check start-pair inputs: each a sequence of one int32 [members, c]
    slab a card group of ``st.mesh`` (``mesh.slabs`` / ``mesh.split``),
    on its device, all of one width c; returns c."""
    c = None
    for name, x in lists:
        if len(x) != len(st.mesh.groups):
            raise ValueError(f"{name}: {len(x)} slabs for "
                             f"{len(st.mesh.groups)} card groups")
        for (dev, members), t in zip(st.mesh.groups, x):
            c = _slab(t, name, torch.int32, len(members), dev, c)
    for t in st.shards:
        _tables_check(t, t.nbr.device)
    return c


def _mesh_go_args(ids0, qid0, st, over, steps, caps, cap_x, cap_e, qmax):
    c0 = _start_slabs(st, ("ids0", ids0), ("qid0", qid0))
    if steps < 2 or len(caps) != steps or min(caps) <= 0 or not c0 \
            or caps[0] != c0:
        raise ValueError(f"steps {steps} with caps {caps} over {c0} "
                         f"starts a shard (the program runs >= 1 hop)")
    if cap_x <= 0 or cap_e <= 0 or qmax <= 0:
        raise ValueError(f"cap_x {cap_x}, cap_e {cap_e}, qmax {qmax}")
    return _over_check(over)


def mesh_sparse_go_ref(ids0, qid0, st, over, steps, caps, cap_x, cap_e,
                       qmax):
    """Plain version of ``mesh_sparse_go``: ell.py:2052
    ``make_frontier_sharded_sparse_go_kernel`` transcribed, shard by
    shard."""
    T = _MeshTools(st, over)
    k, sent = T.k, T.sent
    has_hubs = st.n_extras > 0
    ids = [x.long() for x in st.mesh.rows(ids0)]
    qid = [torch.where(x == sent, BIG_Q, y.long())
           for x, y in zip(ids, st.mesh.rows(qid0))]
    overflow = [False] * k
    cnt = [int((x != sent).sum()) for x in ids]
    ext_q = ext_r = None

    def hub_exchange():
        exp = [T.hubs(s, qid[s], ids[s]) for s in range(k)]
        got = T.exchange([e[1] for e in exp], [e[0] for e in exp], cap_e)
        for s in range(k):
            overflow[s] |= exp[s][2] or got[s][2]
        return [g[0] for g in got], [g[1] for g in got]

    if has_hubs:
        ext_q, ext_r = hub_exchange()
    for h in range(steps - 1):
        fq, fu = [], []
        for s in range(k):
            g_rows, g_q = ids[s], qid[s]
            if has_hubs:
                g_rows = torch.cat([g_rows, ext_r[s]])
                g_q = torch.cat([g_q, ext_q[s]])
            cand = T.local_gather(s, g_rows)
            fu.append(cand.reshape(-1))
            fq.append(g_q.repeat_interleave(cand.shape[1]))
        got = T.exchange(fq, fu, cap_x)
        for s in range(k):
            qid[s], ids[s], ovf_c, cnt[s] = T.dedup(got[s][0], got[s][1],
                                                   caps[h + 1])
            overflow[s] |= got[s][2] or ovf_c
        if has_hubs and h < steps - 2:
            ext_q, ext_r = hub_exchange()
    ovf_all = int(any(overflow))
    out = []
    for s in range(k):
        o = torch.cat([torch.tensor([cnt[s], ovf_all], dtype=torch.int64,
                                    device=ids[s].device),
                       torch.where(qid[s] == BIG_Q, -1, qid[s]), ids[s]])
        out.append(o.to(torch.int32))
    return [torch.stack([out[s] for s in members])
            for _d, members in st.mesh.groups]


def _mesh_bfs_args(ids0, qid0, tids, tqid, st, over, max_steps, cap,
                   cap_x, cap_e, qmax):
    if _start_slabs(st, ("ids0", ids0), ("qid0", qid0), ("tids", tids),
                    ("tqid", tqid)) != cap:
        raise ValueError(f"start and target slabs must be [members, "
                         f"{cap}]")
    if not 0 <= max_steps < int(INT16_INF) - 1:
        raise ValueError(f"max_steps={max_steps} does not fit int16")
    if min(cap, cap_x, cap_e, qmax) <= 0:
        raise ValueError(f"cap {cap}, cap_x {cap_x}, cap_e {cap_e}, "
                         f"qmax {qmax}")
    return _over_check(over)


def mesh_sparse_bfs_ref(ids0, qid0, tids, tqid, st, over, max_steps, cap,
                        cap_x, cap_e, qmax, stop_when_found=True):
    """Plain version of ``mesh_sparse_bfs``: ell.py:2179
    ``make_frontier_sharded_sparse_bfs_kernel`` transcribed, the
    ``while_loop`` on the host."""
    T = _MeshTools(st, over)
    k, sent, chunk = T.k, T.sent, T.chunk
    inf = int(INT16_INF)
    has_hubs = st.n_extras > 0
    rows = st.mesh.rows
    ids = [x.long() for x in rows(ids0)]
    qid = [torch.where(x == sent, BIG_Q, y.long())
           for x, y in zip(ids, rows(qid0))]
    tids, tqid = rows(tids), rows(tqid)
    dep, tgt = [], []
    for s in range(k):
        base, dev = s * chunk, T.devs[s]
        d = torch.full((chunk, qmax), inf, dtype=torch.int16, device=dev)
        live = ids[s] != sent
        li = (ids[s] - base).clamp(0, chunk - 1)[live]
        d[li, qid[s].clamp(0, qmax - 1)[live]] = 0
        dep.append(d)
        tg = torch.zeros((chunk, qmax), dtype=torch.bool, device=dev)
        ti, tq = tids[s].long(), tqid[s].long()
        tl = ti != sent
        tg[(ti - base).clamp(0, chunk - 1)[tl], tq.clamp(0, qmax - 1)[tl]] \
            = True
        tgt.append(tg)

    def unfound_any():
        return any(bool((tgt[s] & (dep[s] == inf)).any()) for s in range(k))

    def frontier_any():
        return any(bool((x != sent).any()) for x in ids)

    go = frontier_any() and max_steps > 0
    if stop_when_found:
        go = go and unfound_any()
    step, ovf = 0, False
    while go and not ovf:
        ovf_l = False
        er = [torch.zeros(0, dtype=torch.int64, device=d) for d in T.devs]
        eq = list(er)
        if has_hubs:
            exp = [T.hubs(s, qid[s], ids[s]) for s in range(k)]
            got = T.exchange([e[1] for e in exp], [e[0] for e in exp],
                             cap_e)
            er = [g[1] for g in got]
            eq = [g[0] for g in got]
            ovf_l |= any(e[2] for e in exp) or any(g[2] for g in got)
        fq, fu = [], []
        for s in range(k):
            cand = T.local_gather(s, torch.cat([ids[s], er[s]]))
            fu.append(cand.reshape(-1))
            fq.append(torch.cat([qid[s], eq[s]])
                      .repeat_interleave(cand.shape[1]))
        got = T.exchange(fq, fu, cap_x)
        for s in range(k):
            nq2, nu2, ovf_c, _cnt = T.dedup(got[s][0], got[s][1], cap)
            ovf_l |= got[s][2] or ovf_c
            li = (nu2 - s * chunk).clamp(0, chunk - 1)
            qi = nq2.clamp(0, qmax - 1)
            fresh = (nu2 != sent) & (dep[s][li, qi] == inf)
            dep[s][li[fresh], qi[fresh]] = step + 1
            ids[s] = torch.where(fresh, nu2, sent)
            qid[s] = torch.where(fresh, nq2, BIG_Q)
        ovf = ovf or ovf_l
        step += 1
        go = step < max_steps and frontier_any()
        if stop_when_found:
            go = go and unfound_any()
    return dep, ovf, step


# ------------------------------ the card stages (X1, X2 + K5, agree, K6)
MAX_MESH_SHARDS = 32   # csrc mesh_sparse.cu kMaxShards
CTL_XBYTES = 4         # the mesh's exchanged bytes (csrc kXBytes)


class _MeshCard(ctypes.Structure):
    """``MeshCard`` of csrc/mesh_sparse.cu, passed by value: a card
    group's tables and where each mesh shard sits."""
    _fields_ = [("nbr", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("et", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("ecnt", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("e0", ctypes.c_void_p * MAX_CARD_SHARDS),
                ("shard", ctypes.c_longlong * MAX_CARD_SHARDS),
                ("near", ctypes.c_int * MAX_MESH_SHARDS),
                ("n", ctypes.c_int), ("k", ctypes.c_int)]


def _mesh_card(st, members: Tuple[int, ...]) -> _MeshCard:
    tabs = tuple(x for s in members
                 for x in (st.shards[s].nbr, st.shards[s].et, st.ecnt[s],
                           st.e0[s]))

    def build():
        cd = _MeshCard()
        for d in range(MAX_MESH_SHARDS):
            cd.near[d] = -1
        for y, s in enumerate(members):
            cd.nbr[y] = st.shards[s].nbr.data_ptr()
            cd.et[y] = st.shards[s].et.data_ptr()
            cd.ecnt[y] = st.ecnt[s].data_ptr()
            cd.e0[y] = st.e0[s].data_ptr()
            cd.shard[y] = s
            cd.near[s] = y
        cd.n, cd.k = len(members), st.k
        return cd
    return _card_desc(tabs, ("card", members, st.k), build)


@functools.lru_cache(maxsize=64)
def _mesh_buckets(bstarts, n_rows, mx, slot0, D):
    """The buckets as X1 takes them: host int64 (first global row, one
    past its last, block rows, first slot, D) per bucket (made once per
    geometry)."""
    ends = tuple(bstarts[1:]) + (n_rows,)
    return (ctypes.c_int64 * (5 * len(D)))(
        *[v for b in range(len(D))
          for v in (bstarts[b], ends[b], mx[b], slot0[b], D[b])])


def _card_of(st, group) -> Tuple[torch.device, Tuple[int, ...]]:
    dev, members = group
    members = tuple(members)
    if not 0 < len(members) <= MAX_CARD_SHARDS or st.k > MAX_MESH_SHARDS \
            or any(not 0 <= s < st.k or st.shards[s].nbr.device != dev
                   for s in members):
        raise ValueError(f"card group {members} on {dev} of a {st.k}-shard "
                         f"mesh (at most {MAX_CARD_SHARDS} a card, "
                         f"{MAX_MESH_SHARDS} a mesh)")
    return dev, members


def _slab(t, name: str, dtype, rows: int, dev, width=None) -> int:
    """Check a [rows, width] slab; returns its width."""
    if not isinstance(t, torch.Tensor) or t.dim() != 2:
        raise ValueError(f"{name} must be a [{rows}, ...] slab")
    width = t.shape[1] if width is None else width
    _check(t, name, dtype, (rows, width), dev)
    return width


def _xslab(t, name: str, kg: int, k: int, dev) -> int:
    """Check an exchange slab int64 [members, k, 1 + cap]; returns cap."""
    if not isinstance(t, torch.Tensor) or t.dim() != 3 or t.shape[2] < 2:
        raise ValueError(f"{name} must be an int64 [members, k, 1 + cap] "
                         f"slab")
    _check(t, name, torch.int64, (kg, k, t.shape[2]), dev)
    return t.shape[2] - 1


def _block_of(st, members, recv, send, y: int, d: int) -> torch.Tensor:
    """The block member y's pairs for owner d go to: the owner's receive
    row when it shares the card, else y's send row."""
    if d in members:
        return recv[members.index(d), members[y]]
    return send[y, d]


def _counted(ids: torch.Tensor, ctl: torch.Tensor, y: int,
             counted: bool) -> int:
    """The places member y of a card stage reads: min(ctl[y, CTL_CNT],
    c) of a list K5 built (``counted``), else all c."""
    c = ids.shape[1]
    return max(0, min(int(ctl[y, CTL_CNT]), c)) if counted else c


def mesh_route_card_ref(hub, ids, qid, st, group, over, recv, send, ctl,
                        hub_recv=None, counted=False):
    """Plain version of ``mesh_route_card``: ``mesh_route_ref`` (X1's
    per-shard plain version) on each member's places into a block of
    its own, each owner's block then written where the kernel writes
    it."""
    members = tuple(group[1])
    k, cap = st.k, recv.shape[2] - 1
    for y, s in enumerate(members):
        c = _counted(ids, ctl, y, counted)
        own = torch.zeros((k, 1 + cap), dtype=torch.int64, device=ids.device)
        mesh_route_ref(hub, ids[y, :c], qid[y, :c],
                       None if hub_recv is None else hub_recv[y], st, s,
                       over, own, ctl[y], ids.shape[1])
        for d in range(k):
            _block_of(st, members, recv, send, y, d).copy_(own[d])
    return recv


def mesh_route_card(hub: bool, ids: torch.Tensor, qid: torch.Tensor, st,
                    group, over: Sequence[int], recv: torch.Tensor,
                    send: Optional[torch.Tensor], ctl: torch.Tensor,
                    hub_recv: Optional[torch.Tensor] = None,
                    counted: bool = False) -> torch.Tensor:
    """X1 for the members of one card group ``group`` = (device, shards)
    of ``st.mesh.groups``, one launch: member y's pairs ``ids[y]`` /
    ``qid[y]`` (int32 [members, c] slabs, ids == n_rows inactive) routed
    to their owners; with ``counted`` only the first min(ctl[y, CTL_CNT],
    c) of them (a list whose live pairs all lie below that count:
    ``mesh_dedup``'s, or the BFS starts after ``mesh_bfs_stamp_card``'s
    init; the count read on the card), else all c.  The pairs member y
    (shard s) sends owner d land in the block d receives from s — ``recv[m,
    s]`` when d is member m of this card (the receive slab, int64 [members, k,
    1 + cap]), else ``send[y, d]`` (the send slab of the same shape; None when
    every shard sits on this card), which ``mesh.all_to_all`` copies across.
    The blocks' counts must be 0 before (the slab's memset, or the last hop's
    ``mesh_dedup``).  ``ctl`` int64 [members, CTL_SIZE].

    - candidate mode (ell.py:1970 ``local_gather`` + :1993 ``route``):
      each live pair, and each live key of ``hub_recv[y]`` (the hub
      extra-row pairs the member received, int64 [members, k, 1 +
      cap_e], or None), walks its row in the shard's local blocks; every
      slot whose etype is in the negated OVER set sends (q, u) to owner
      ``u // chunk``.
    - hub mode (``hub``; ell.py:2042 ``expand_local_hubs``): each live
      pair whose row owns an extra-row run (the shard's ``ecnt``/``e0``)
      sends (q, e0 + j) for j < ecnt; the run lengths' total past c
      (the reference's budget EX = c) or one past ``_hub_c_lim(c)``
      raises the overflow, and ``ctl[y, CTL_HUB_TOTAL]`` gets the total.

    Every pair is counted; only the first ``cap`` of a block are kept
    (in any order) and a count past ``cap`` sets ``ctl[y, CTL_OVF]``.
    The hub budget is the list's width c either way."""
    dev, members = _card_of(st, group)
    kg, k = len(members), st.k
    c = _slab(ids, "ids", torch.int32, kg, dev)
    _slab(qid, "qid", torch.int32, kg, dev, c)
    cap = _xslab(recv, "recv", kg, k, dev)
    if send is not None:
        _check(send, "send", torch.int64, tuple(recv.shape), dev)
    elif len(members) < k:
        raise ValueError("owners on another card need a send slab")
    hub_cap = 0
    if hub_recv is not None:
        if hub:
            raise ValueError("hub mode takes no received pairs")
        hub_cap = _xslab(hub_recv, "hub_recv", kg, k, dev)
    _slab(ctl, "ctl", torch.int64, kg, dev, CTL_SIZE)
    over = _over_check(over)
    for s in members:
        _tables_check(st.shards[s], dev)
    if not _route(dev):
        return mesh_route_card_ref(hub, ids, qid, st, group, over, recv,
                                   send, ctl, hub_recv, counted)
    t = st.shards[0]
    neg = (ctypes.c_int32 * len(over))(*[-e for e in over])
    ptr = (lambda x: None if x is None else x.data_ptr())
    with _on_card(dev):
        rc = _lib().mesh_route(
            int(hub), _mesh_card(st, members), ids.data_ptr(),
            qid.data_ptr(), c, int(counted), ptr(hub_recv), hub_cap,
            _mesh_buckets(st.bstarts, st.n_rows, t.rows, t.slot0, t.D),
            len(t.D), neg, len(over), st.chunk, st.n_rows, recv.data_ptr(),
            ptr(send), cap, ctl.data_ptr(), _hub_c_lim(c), _stream(dev))
    _ok(rc, "mesh_route")
    LAUNCHES["mesh_route"] += 1
    return recv


def _clears(recv, hub_recv, send, hub_send):
    """The exchange slabs a hop's K5 clears, each with whether it is a
    receive slab (its blocks from other shards are counted)."""
    return tuple((x, r) for x, r in ((recv, True), (hub_recv, True),
                                     (send, False), (hub_send, False))
                 if x is not None)


def mesh_dedup_ref(recv, st, group, marks, c_out, ids_out, qid_out, ctl,
                   hub_recv=None, send=None, hub_send=None, scan=None):
    """Plain version of ``mesh_dedup``: ``mesh_mark_ref`` (X2) and
    ``pair_compact_ref`` (K5 with the shard's row base) on each member,
    then the exchange blocks cleared as K5's finishing block clears
    them; ``scan`` is not read."""
    members = tuple(group[1])
    chunk, W = st.chunk, _words(st.chunk)
    for y, s in enumerate(members):
        mesh_mark_ref(recv[y], s * chunk, chunk, marks[y], W)
        pair_compact_ref(marks[y], W, c_out, ids_out[y], qid_out[y], ctl[y],
                         -1, st.n_rows, None, None, True, s * chunk)
        ctl[y, CTL_HUB_TOTAL] = 0
        for slab, received in _clears(recv, hub_recv, send, hub_send):
            blk = slab[y]
            if received:
                cnt = blk[:, 0].clamp(max=blk.shape[1] - 1)
                cnt[s] = -1                  # its own block stays home
                ctl[y, CTL_XBYTES] += int((8 * (1 + cnt)).sum())
            blk[:, 0] = 0
    return ids_out, qid_out


def mesh_dedup(recv: torch.Tensor, st, group, marks: torch.Tensor,
               c_out: int, ids_out: torch.Tensor, qid_out: torch.Tensor,
               ctl: torch.Tensor, hub_recv: Optional[torch.Tensor] = None,
               send: Optional[torch.Tensor] = None,
               hub_send: Optional[torch.Tensor] = None,
               scan: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """X2 then K5 for the members of one card group, one call, one launch
    a kernel (X2, then K5's single pass): member y ORs every
    live key of ``recv[y]`` (its receive row, int64 [members, k, 1 +
    cap]) into its mark bitmap ``marks[y]`` (int32 [members, qrows * W],
    W = ceil(chunk / 32), zero before and after), and K5 writes the set
    bits in (query, row) order, the shard's row base added, as the first
    ``c_out`` pairs of ``ids_out[y]`` / ``qid_out[y]`` (int32 [members,
    c_out]; pads (n_rows, BIG_Q)), ``ctl[y, CTL_CNT]`` their count before
    the cut, a count past ``c_out`` raising ``ctl[y, CTL_OVF]``.  Then
    the exchange blocks this hop consumed are made ready for the next
    hop's router: member y's blocks of ``recv``, ``hub_recv`` (the hub
    pairs it received) and the send slabs ``send`` / ``hub_send`` (for
    owners on other cards; each [members, k, 1 + cap] or None) get a
    count of 0, a received block from another shard first adding 8 bytes
    for its count and each key it kept to ``ctl[y, CTL_XBYTES]``; and
    ``ctl[y, CTL_HUB_TOTAL]`` goes to 0.  ``scan``: K5's look-back
    state, int64 [members, compact_state_words(words)], all zero before
    its first call and reusable by later calls on the same stream (the
    programs keep it in their card group's zeroed slabs); None: a
    zeroed one of the call's own (a memset beside the launches).
    Returns (ids_out, qid_out)."""
    dev, members = _card_of(st, group)
    kg, k, chunk = len(members), st.k, st.chunk
    W = _words(chunk)
    cap = _xslab(recv, "recv", kg, k, dev)
    words = _slab(marks, "marks", torch.int32, kg, dev)
    if words % W or c_out <= 0:
        raise ValueError(f"marks of {words} words, rows of {W}, c_out "
                         f"{c_out}")
    _slab(ids_out, "ids_out", torch.int32, kg, dev, c_out)
    _slab(qid_out, "qid_out", torch.int32, kg, dev, c_out)
    _slab(ctl, "ctl", torch.int64, kg, dev, CTL_SIZE)
    for x, name in ((hub_recv, "hub_recv"), (send, "send"),
                    (hub_send, "hub_send")):
        if x is not None:
            _xslab(x, name, kg, k, dev)
    if scan is not None:
        _slab(scan, "scan", torch.int64, kg, dev, compact_state_words(words))
    if not _route(dev):
        return mesh_dedup_ref(recv, st, group, marks, c_out, ids_out,
                              qid_out, ctl, hub_recv, send, hub_send)
    clear = _clears(recv, hub_recv, send, hub_send)
    if scan is None:
        scan = torch.zeros((kg, compact_state_words(words)),
                           dtype=torch.int64, device=dev)
    slabs = (ctypes.c_void_p * 4)(*[x.data_ptr() for x, _r in clear])
    caps = (ctypes.c_int64 * 4)(*[x.shape[2] - 1 for x, _r in clear])
    recvd = (ctypes.c_int32 * 4)(*[int(r) for _x, r in clear])
    with _on_card(dev):
        rc = _lib().mesh_dedup(_mesh_card(st, members), recv.data_ptr(),
                               cap, chunk, marks.data_ptr(), W, words,
                               c_out, ids_out.data_ptr(), qid_out.data_ptr(),
                               c_out, scan.data_ptr(), ctl.data_ptr(),
                               st.n_rows, slabs, caps, recvd, _stream(dev))
    _ok(rc, "mesh_dedup")
    LAUNCHES["mesh_dedup"] += 1
    LAUNCHES["mesh_mark"] += 1
    LAUNCHES["pair_compact"] += 1
    return ids_out, qid_out


def mesh_agree_ref(ctl: torch.Tensor) -> torch.Tensor:
    """Plain version of ``mesh_agree``."""
    ctl[:, CTL_OVF] = (ctl[:, CTL_OVF] != 0).any().to(torch.int64)
    return ctl


def mesh_agree(ctl: torch.Tensor) -> torch.Tensor:
    """The overflow agreed over every shard of a card (the reference's
    psum, ell.py:2148), one launch: every ``ctl[y, CTL_OVF]`` of the
    card's ctl slab (int64 [members, CTL_SIZE]) becomes the OR of them
    all.  Shards on several cards agree by ``mesh.psum_or``."""
    dev = ctl.device
    kg = ctl.shape[0] if ctl.dim() == 2 else 0
    if not 0 < kg <= MAX_CARD_SHARDS:
        raise ValueError(f"a ctl slab of {kg} members")
    _slab(ctl, "ctl", torch.int64, kg, dev, CTL_SIZE)
    if not _route(dev):
        return mesh_agree_ref(ctl)
    with _on_card(dev):
        rc = _lib().mesh_agree(ctl.data_ptr(), kg, _stream(dev))
    _ok(rc, "mesh_agree")
    LAUNCHES["mesh_agree"] += 1
    return ctl


def mesh_bfs_stamp_card_ref(init, ids, qid, depth, tbits, st, group, step,
                            ctl, tids=None, tqid=None, counted=False,
                            tick=None):
    """Plain version of ``mesh_bfs_stamp_card``: ``mesh_bfs_stamp_ref``
    on each member's places (``tick`` is not read)."""
    W = _words(st.chunk)
    for y, s in enumerate(tuple(group[1])):
        c = _counted(ids, ctl, y, counted)
        mesh_bfs_stamp_ref(init, ids[y, :c], qid[y, :c], depth[y],
                           tbits[y, :depth.shape[2] * W], W, s * st.chunk,
                           st.n_rows, step, ctl[y],
                           None if tids is None else tids[y],
                           None if tqid is None else tqid[y])
    return depth


def mesh_bfs_stamp_card(init: bool, ids: torch.Tensor, qid: torch.Tensor,
                        depth: torch.Tensor, tbits: torch.Tensor, st, group,
                        step: int, ctl: torch.Tensor,
                        tids: Optional[torch.Tensor] = None,
                        tqid: Optional[torch.Tensor] = None,
                        counted: bool = False,
                        tick: Optional[torch.Tensor] = None) -> torch.Tensor:
    """X3 for the members of one card group ``group`` of ``st.mesh``,
    one call: ``mesh_bfs_stamp_ref`` on every member y (shard s) at
    once.  Member y's BFS depth is ``depth[y]`` (int16 [members, chunk,
    qmax], INT16_INF unreached; row li is global row s * chunk + li), its
    target bitmap ``tbits[y]`` (int32 [members, words], its first qmax *
    W words a query row of W = ceil(chunk / 32)), its flags ``ctl[y]``
    (int64 [members, CTL_SIZE]), its list ``ids[y]`` / ``qid[y]`` (int32
    [members, c]; with ``counted`` only the first min(ctl[y, CTL_CNT],
    c) places, a list ``mesh_dedup`` built, else all c); (q, row) is
    clipped to the block as the reference clips (ell.py:2230-2241).

    - ``init`` (two launches): depth 0 at every live start pair,
      ``ctl[y, CTL_LIVE]`` = their count, ``ctl[y, CTL_CNT]`` = one past
      the last live start's place (so the first level's X1 reads the
      starts to it, counted); then every live target pair
      (``tids[y]`` / ``tqid[y]``, int32 [members, ct]) sets its bit, and
      each bit newly set whose depth is still unset adds one to
      ``ctl[y, CTL_UNFOUND]``.
    - a level (ell.py:2279-2287; one launch): each live pair (``ids`` ==
      n_rows: a pad) whose depth is unset gets ``step + 1`` and stays in
      the next frontier, ``ctl[y, CTL_LIVE]`` their count and, on a
      target bit, one less in ``ctl[y, CTL_UNFOUND]``; every other live
      place becomes the pad (n_rows, BIG_Q), in place, and a pad is left
      as it is (K5 writes its pads as (n_rows, BIG_Q)).

    ``CTL_UNFOUND`` thus counts the unfound target cells, where the
    reference scans [chunk, qmax] for any each level.  ``tick``: the
    kernels' int64 [members, 2] scratch, zero before and left zero (the
    programs keep it in their card group's zeroed slabs); None: a zeroed
    one of the call's own (a memset beside the launches)."""
    dev, members = _card_of(st, group)
    kg, chunk = len(members), st.chunk
    W = _words(chunk)
    if not isinstance(depth, torch.Tensor) or depth.dim() != 3:
        raise ValueError("depth must be int16 [members, chunk, qmax]")
    qmax = depth.shape[2]
    _check(depth, "depth", torch.int16, (kg, chunk, qmax), dev)
    words = _slab(tbits, "tbits", torch.int32, kg, dev)
    if words < qmax * W:
        raise ValueError(f"tbits of {words} words for {qmax} rows of {W}")
    c = _slab(ids, "ids", torch.int32, kg, dev)
    _slab(qid, "qid", torch.int32, kg, dev, c)
    _slab(ctl, "ctl", torch.int64, kg, dev, CTL_SIZE)
    ct = 0
    if init:
        ct = _slab(tids, "tids", torch.int32, kg, dev)
        _slab(tqid, "tqid", torch.int32, kg, dev, ct)
    if tick is not None:
        _slab(tick, "tick", torch.int64, kg, dev, 2)
    if not 0 <= step < int(INT16_INF) - 1:
        raise ValueError(f"step {step} does not fit int16")
    if not _route(dev):
        return mesh_bfs_stamp_card_ref(init, ids, qid, depth, tbits, st,
                                       group, step, ctl, tids, tqid, counted)
    if tick is None:
        tick = torch.zeros((kg, 2), dtype=torch.int64, device=dev)
    ptr = (lambda t: None if t is None else t.data_ptr())
    with _on_card(dev):
        rc = _lib().mesh_bfs_stamp(
            int(init), _mesh_card(st, members), ids.data_ptr(),
            qid.data_ptr(), c, int(counted), ptr(tids), ptr(tqid), ct,
            depth.data_ptr(), chunk, qmax, tbits.data_ptr(), W, words,
            st.n_rows, step, ctl.data_ptr(), tick.data_ptr(), _stream(dev))
    _ok(rc, "mesh_bfs_stamp")
    LAUNCHES["mesh_bfs_stamp"] += 1
    return depth


def mesh_emit_ref(ids, qid, ctl, out, n_rows):
    """Plain version of ``mesh_emit``: ``pair_reduce_ref``'s emit on
    each member."""
    for y in range(ids.shape[0]):
        pair_reduce_ref(REDUCE_EMIT, ids[y], qid[y], None, out[y], False,
                        n_rows + 1, n_rows, 1, 1, 0, 0, ctl[y])
    return out


def mesh_emit(ids: torch.Tensor, qid: torch.Tensor, ctl: torch.Tensor,
              out: torch.Tensor, n_rows: int) -> torch.Tensor:
    """K6's plain result (``pair_reduce``'s REDUCE_EMIT, the unpacked
    layout) for every member of a card in one launch: member y's pairs
    ``ids[y]`` / ``qid[y]`` (int32 [members, c]) into ``out[y]`` (int32
    [members, 2 + 2c]: its ``ctl[y]`` count and overflow, qids -1
    unused, rows n_rows unused)."""
    dev = ids.device
    kg = ids.shape[0] if ids.dim() == 2 else 0
    if not 0 < kg <= MAX_CARD_SHARDS:
        raise ValueError(f"a pair slab of {kg} members")
    c = _slab(ids, "ids", torch.int32, kg, dev)
    _slab(qid, "qid", torch.int32, kg, dev, c)
    _slab(ctl, "ctl", torch.int64, kg, dev, CTL_SIZE)
    _slab(out, "out", torch.int32, kg, dev, 2 + 2 * c)
    if c == 0:
        raise ValueError("an empty pair slab")
    if not _route(dev):
        return mesh_emit_ref(ids, qid, ctl, out, n_rows)
    with _on_card(dev):
        rc = _lib().sg_emit(ids.data_ptr(), qid.data_ptr(), c,
                            out.data_ptr(), kg, n_rows + 1, n_rows,
                            ctl.data_ptr(), _stream(dev))
    _ok(rc, "sg_emit")
    LAUNCHES["mesh_emit"] += 1
    LAUNCHES["pair_reduce"] += 1
    return out


# --------------------------------------- the programs over the stages
class _CardWork:
    """One card group's working slabs for a frontier-sharded program,
    carved from one zeroed buffer (one memset): ``ctl`` [members,
    CTL_SIZE], the exchange slabs [members, k, 1 + cap] — ``xr`` / ``er``
    receive candidate / hub pairs, ``xs`` / ``es`` send them to owners
    on other cards (None on one card; ``er`` / ``es`` None without hub
    extra rows) — K5's look-back state ``scan`` [members,
    compact_state_words(words)], which every hop's ``mesh_dedup``
    shares, for the BFS X3's scratch ``tick`` [members, 2], and the int32
    bitmaps ``marks`` (and, for the BFS, ``tbits``) [members, words]."""

    def __init__(self, st, group, words: int, cap_x: int, cap_e: int,
                 tbits: bool = False):
        dev, members = group
        kg, k = len(members), st.k
        far = len(members) < k
        hubs = st.n_extras > 0
        half = -(-words // 2)              # int32 words in int64 words
        parts = [("ctl", (kg, CTL_SIZE)), ("xr", (kg, k, 1 + cap_x)),
                 ("scan", (kg, compact_state_words(words)))]
        if hubs:
            parts.append(("er", (kg, k, 1 + cap_e)))
        if tbits:
            parts.append(("tick", (kg, 2)))
        if far:
            parts.append(("xs", (kg, k, 1 + cap_x)))
            if hubs:
                parts.append(("es", (kg, k, 1 + cap_e)))
        sizes = [(n, sh, int(torch.Size(sh).numel())) for n, sh in parts]
        bitmaps = ["marks"] + (["tbits"] if tbits else [])
        total = sum(z for _n, _s, z in sizes) + len(bitmaps) * kg * half
        buf = torch.zeros(total, dtype=torch.int64, device=dev)
        self.er = self.xs = self.es = self.tbits = self.tick = None
        off = 0
        for name, shape, z in sizes:
            setattr(self, name, buf[off:off + z].view(shape))
            off += z
        for name in bitmaps:
            setattr(self, name, buf[off:off + kg * half].view(torch.int32)
                    [:kg * words].view(kg, words))
            off += kg * half


def _agree_overflow(st, ctl, orm) -> None:
    """Every shard's ``ctl[CTL_OVF]`` becomes the OR over the shards
    (the reference's psum, ell.py:2148): on one card ``mesh_agree``, one
    launch; across cards each shard's word is copied aside, then
    ``mesh.psum_or`` with ``orm`` (``or_many``) over the words' bytes.
    ``ctl`` holds the card groups' slabs."""
    from .mesh import psum_or
    if len(ctl) == 1:
        return orm[0](ctl[0])
    rows = st.mesh.rows(ctl)
    snap = [c[CTL_OVF:CTL_OVF + 1].clone() for c in rows]
    recv = [torch.empty((len(rows) - 1, 8), dtype=torch.uint8,
                        device=c.device) for c in rows]
    psum_or([x.view(torch.uint8) for x in snap],
            [c[CTL_OVF:CTL_OVF + 1].view(torch.uint8) for c in rows],
            recv, orm[1])


def exchanged_bytes(ctl) -> int:
    """The bytes a frontier-sharded program's exchanges moved between
    shards (``CTL_XBYTES`` over its card groups' ctl slabs): 8 for each
    block count and each key kept, a shard's own block excepted."""
    return sum(int(c[:, CTL_XBYTES].sum()) for c in ctl)


def _exchange(st, work, send, recv) -> None:
    """The cross-card part of an exchange (nothing on one card)."""
    from .mesh import all_to_all
    if len(work) > 1:
        all_to_all(st.mesh.rows([getattr(w, send) for w in work]),
                   st.mesh.rows([getattr(w, recv) for w in work]),
                   st.mesh.groups)


def _mesh_go_steps(ids0, qid0, st, over, steps, caps, cap_x, cap_e, qmax,
                   route, dedup, agree, emit):
    """The frontier-sharded GO as card stages: per card group, X1
    (``route``), X2 + K5 (``dedup``), the overflow agreement (``agree``:
    (mesh_agree, or_many) or their plain versions) and K6's emit
    (``emit``), one call each a stage, between exchanges that move
    nothing on one card (``route`` writes each pair into its owner's
    receive block) and copy the cross-card blocks otherwise.  X1 reads
    the start lists whole and each later list's counted prefix (the
    count K5 left in ctl).  Returns (the output: a [members, 2 + 2 *
    caps[-1]] slab a card group; the exchanges run; the card groups' ctl
    slabs, whose ``exchanged_bytes`` are the bytes that reached other
    shards)."""
    groups = st.mesh.groups
    chunk, n_rows = st.chunk, st.n_rows
    words = qmax * _words(chunk)
    hubs = st.n_extras > 0
    i32 = torch.int32
    work = [_CardWork(st, g, words, cap_x, cap_e) for g in groups]
    cur = list(zip(ids0, qid0))
    exchanges = 0

    def route_all(hub: bool, counted: bool) -> None:
        nonlocal exchanges
        for g, w, (ids, qid) in zip(groups, work, cur):
            if hub:
                route(True, ids, qid, st, g, over, w.er, w.es, w.ctl, None,
                      counted)
            else:
                route(False, ids, qid, st, g, over, w.xr, w.xs, w.ctl,
                      w.er, counted)
        _exchange(st, work, "es" if hub else "xs", "er" if hub else "xr")
        exchanges += 1

    if hubs:
        route_all(True, False)
    for h in range(steps - 1):
        c_out = caps[h + 1]
        route_all(False, h > 0)
        nxt = []
        for g, w in zip(groups, work):
            ids = torch.empty((len(g[1]), c_out), dtype=i32, device=g[0])
            qid = torch.empty_like(ids)
            dedup(w.xr, st, g, w.marks, c_out, ids, qid, w.ctl, w.er, w.xs,
                  w.es, w.scan)
            nxt.append((ids, qid))
        cur = nxt
        if hubs and h < steps - 2:
            route_all(True, True)
    ctl = [w.ctl for w in work]
    _agree_overflow(st, ctl, agree)
    outs = []
    for g, w, (ids, qid) in zip(groups, work, cur):
        out = torch.empty((len(g[1]), 2 + 2 * caps[-1]), dtype=i32,
                          device=g[0])
        emit(ids, qid, w.ctl, out, n_rows)
        outs.append(out)
    return outs, exchanges, ctl


def mesh_sparse_go(ids0: Sequence[torch.Tensor],
                   qid0: Sequence[torch.Tensor], st, over: Sequence[int],
                   steps: int, caps: Sequence[int], cap_x: int, cap_e: int,
                   qmax: int):
    """Frontier-sharded sparse GO (ell.py:2052
    make_frontier_sharded_sparse_go_kernel) over the chunk-sharded
    tables ``st`` (ell.ShardedTables): ``ids0[s]``/``qid0[s]`` int32
    [caps[0]] are shard s's start pairs (``ell.split_start_pairs_by_
    owner``: rows it owns, n_rows inactive; qids < ``qmax``), given as
    one int32 [members, caps[0]] slab a card group of ``st.mesh``
    (``mesh.split`` of the [k, caps[0]] arrays).  ``steps - 1`` hops:
    each shard routes its candidates to their owners (``cap_x`` a
    source-destination block; hub extra-row pairs in ``cap_e`` blocks)
    and the owner keeps the sorted, deduped pairs up to ``caps[h + 1]``.
    Returns one int32 [members, 2 + 2 * caps[-1]] slab a card group
    (``mesh.stacked`` puts them in shard order), a shard's row the
    reference's: its count, the overflow flag agreed by every shard,
    qids (-1 unused), global rows (n_rows unused).  On overflow the
    other entries are not defined.  On the card each stage is one call
    a card group."""
    over = _mesh_go_args(ids0, qid0, st, over, steps, caps, cap_x, cap_e,
                         qmax)
    caps = tuple(int(c) for c in caps)
    if not _route(st.shards[0].nbr.device):
        return mesh_sparse_go_ref(ids0, qid0, st, over, steps, caps, cap_x,
                                  cap_e, qmax)
    out = _mesh_go_steps(ids0, qid0, st, over, steps, caps, cap_x, cap_e,
                         qmax, mesh_route_card, mesh_dedup,
                         (mesh_agree, or_many), mesh_emit)[0]
    LAUNCHES["mesh_sparse_go"] += 1
    return out


def _read_ctl(ctl) -> torch.Tensor:
    """Every card group's ctl slab on the host, one copy a card, as one
    [k, CTL_SIZE] tensor in group order (one wait for the level)."""
    return torch.cat([c.cpu() for c in ctl])


def _mesh_bfs_steps(ids0, qid0, tids, tqid, st, over, max_steps, cap,
                    cap_x, cap_e, qmax, stop, route, dedup, stamp,
                    read=None):
    """The frontier-sharded BFS as card stages, one call each a card
    group: X1 (``route``; counted: the start lists to the extent X3's
    init left in ctl, a later level's list to K5's count), X2 + K5
    (``dedup``) and X3 (``stamp``; its init, then once a level on the
    counted prefix); the level loop on the host, which reads the card
    groups' ctl slabs once a level with ``read(ctl)`` (default
    ``_read_ctl``; a caller that knows the flags a run reads can give
    them back without waiting on the card) and agrees the flags (any overflow,
    any live pair, any unfound target).  Returns (depth per shard, overflow,
    levels run, the exchanges run, the bytes they moved between shards)."""
    groups, mesh = st.mesh.groups, st.mesh
    chunk = st.chunk
    hubs = st.n_extras > 0
    i32 = torch.int32
    work = [_CardWork(st, g, qmax * _words(chunk), cap_x, cap_e, tbits=True)
            for g in groups]
    ctl = [w.ctl for w in work]
    dslabs = mesh.slabs((chunk, qmax), torch.int16)
    for d in dslabs:
        d.fill_(int(INT16_INF))
    cur = list(zip(ids0, qid0))
    for g, w, d, (ids, qid), ti, tq in zip(groups, work, dslabs, cur, tids,
                                           tqid):
        stamp(True, ids, qid, d, w.tbits, st, g, 0, w.ctl, ti, tq, False,
              w.tick)
    read = read or _read_ctl
    flags = read(ctl)
    go = bool((flags[:, CTL_LIVE] > 0).any()) and max_steps > 0
    if stop:
        go = go and bool((flags[:, CTL_UNFOUND] > 0).any())
    step, ovf, exchanges = 0, False, 0
    while go and not ovf:
        for hub in ((True, False) if hubs else (False,)):
            for g, w, (ids, qid) in zip(groups, work, cur):
                if hub:
                    route(True, ids, qid, st, g, over, w.er, w.es, w.ctl,
                          None, True)
                else:
                    route(False, ids, qid, st, g, over, w.xr, w.xs, w.ctl,
                          w.er, True)
            _exchange(st, work, "es" if hub else "xs", "er" if hub else "xr")
            exchanges += 1
        nxt = []
        for g, w, d in zip(groups, work, dslabs):
            ids = torch.empty((len(g[1]), cap), dtype=i32, device=g[0])
            qid = torch.empty_like(ids)
            dedup(w.xr, st, g, w.marks, cap, ids, qid, w.ctl, w.er, w.xs,
                  w.es, w.scan)
            stamp(False, ids, qid, d, w.tbits, st, g, step, w.ctl, None,
                  None, True, w.tick)
            nxt.append((ids, qid))
        cur = nxt
        step += 1
        flags = read(ctl)
        ovf = bool((flags[:, CTL_OVF] != 0).any())
        go = step < max_steps and bool((flags[:, CTL_LIVE] > 0).any())
        if stop:
            go = go and bool((flags[:, CTL_UNFOUND] > 0).any())
    return (mesh.rows(dslabs), ovf, step, exchanges,
            int(flags[:, CTL_XBYTES].sum()))


def mesh_sparse_bfs(ids0: Sequence[torch.Tensor],
                    qid0: Sequence[torch.Tensor],
                    tids: Sequence[torch.Tensor],
                    tqid: Sequence[torch.Tensor], st, over: Sequence[int],
                    max_steps: int, cap: int, cap_x: int, cap_e: int,
                    qmax: int, stop_when_found: bool = True):
    """Frontier-sharded batched BFS (ell.py:2179
    make_frontier_sharded_sparse_bfs_kernel): the shards' start and
    target pairs ``ids0``/``qid0``, ``tids``/``tqid``
    (``ell.split_start_pairs_by_owner`` at ``cap``), each one int32
    [members, cap] slab a card group, as ``mesh_sparse_go`` takes its
    starts.  Each level routes the frontier's candidates to
    their owners (hub pairs first), dedups them at ``cap`` and stamps
    the ones whose depth is unset.  The loop stops where the reference's
    ``while_loop`` does: ``max_steps`` levels, an empty frontier, with
    ``stop_when_found`` every target found, or an overflow.  Returns
    (depth per shard int16 [chunk, qmax], INT16_INF unreached, row li
    of shard s global row s * chunk + li; overflow; levels run)."""
    over = _mesh_bfs_args(ids0, qid0, tids, tqid, st, over, max_steps, cap,
                          cap_x, cap_e, qmax)
    if not _route(st.shards[0].nbr.device):
        return mesh_sparse_bfs_ref(ids0, qid0, tids, tqid, st, over,
                                   max_steps, cap, cap_x, cap_e, qmax,
                                   stop_when_found)
    depth, ovf, levels, _x, _b = _mesh_bfs_steps(
        ids0, qid0, tids, tqid, st, over, max_steps, cap, cap_x, cap_e,
        qmax, stop_when_found, mesh_route_card, mesh_dedup,
        mesh_bfs_stamp_card)
    LAUNCHES["mesh_sparse_bfs"] += 1
    return depth, ovf, levels
