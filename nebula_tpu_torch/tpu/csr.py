"""Per-space CSR mirror — the counterpart of ``nebula_tpu/tpu/csr.py``.

The reference folds the mirror from the KV store (``build_mirror``).
This slice has no KV layer yet, so ``mirror_from_edges`` builds the
same arrays from an edge list, and ``mirror_from_reference`` takes them
as the reference computed them.  Edge and vertex property columns are
not carried: the slice yields only ``_dst`` and ``COUNT(*)``.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np


class CsrMirror:
    """Per-space CSR over a dense vertex space.

    Edge arrays are sorted by (src_dense, etype, rank, dst) — the KV scan
    order — and carry BOTH directions (the reverse edge is stored under
    -etype), so ``GO ... REVERSELY`` is an etype-sign flip.  Device-side
    caches (the ELL index, its device tables, the hub-merge arrays) hang
    off the mirror as attributes, exactly as the reference caches them.
    """

    def __init__(self, space_id: int):
        self.space_id = space_id
        self.vids = np.zeros(0, dtype=np.int64)       # sorted unique
        self.n = 0
        self.m = 0
        self.edge_src = np.zeros(0, dtype=np.int32)   # dense idx
        self.edge_dst = np.zeros(0, dtype=np.int32)   # dense idx
        self.edge_etype = np.zeros(0, dtype=np.int32)  # signed etype
        self.edge_rank = np.zeros(0, dtype=np.int64)
        self.row_ptr = np.zeros(1, dtype=np.int32)

    # ---- lookups -----------------------------------------------------
    def to_dense(self, vids) -> np.ndarray:
        """vid values -> dense indices (-1 when absent)."""
        a = np.asarray(vids, dtype=np.int64)
        pos = np.searchsorted(self.vids, a)
        pos = np.clip(pos, 0, max(self.n - 1, 0))
        ok = (self.n > 0) & (self.vids[pos] == a) if self.n else \
            np.zeros(len(a), dtype=bool)
        return np.where(ok, pos, -1).astype(np.int32)

    def vid_rank(self, vid: int) -> int:
        """searchsorted position — order-preserving literal translation."""
        return int(np.searchsorted(self.vids, np.int64(vid)))

    def has_vid(self, vid: int) -> bool:
        p = self.vid_rank(vid)
        return p < self.n and int(self.vids[p]) == vid


def _finish(mirror: CsrMirror) -> CsrMirror:
    counts = np.bincount(mirror.edge_src, minlength=mirror.n)
    mirror.row_ptr = np.concatenate([[0], np.cumsum(counts)]) \
        .astype(np.int32)
    return mirror


def _dense_index(vids: np.ndarray, a: np.ndarray) -> np.ndarray:
    """``searchsorted(vids, a)`` for values that all occur in ``vids``:
    a table lookup when the vid range is at most a few times ``a``'s
    length (random searches are what a mirror build waits on), else the
    search."""
    lo, hi = int(vids[0]), int(vids[-1])
    if hi - lo > 4 * len(a) + 1024:
        return np.searchsorted(vids, a)
    lut = np.empty(hi - lo + 1, np.int64)
    lut[vids - lo] = np.arange(len(vids))
    return lut[a - lo]


def _sorted_rows(src_d, e_all, r_all, dst_d, n: int):
    """The rows sorted by (src, etype, rank, dst), a repeated key kept
    once (as the KV key does): one sort of a packed int64 key when every
    rank is 0 and the fields fit in 63 bits (the usual case), else a
    lexsort."""
    vb = max(int(n - 1).bit_length(), 1)
    e_lo = int(e_all.min())
    eb = max((int(e_all.max()) - e_lo).bit_length(), 1)
    if not r_all.any() and 2 * vb + eb <= 63:
        key = np.sort((src_d << (vb + eb)) | ((e_all - e_lo) << vb)
                      | dst_d)
        keep = np.ones(len(key), dtype=bool)
        keep[1:] = key[1:] != key[:-1]
        key = key[keep]
        return (key >> (vb + eb), ((key >> vb) & ((1 << eb) - 1)) + e_lo,
                np.zeros(len(key), np.int64), key & ((1 << vb) - 1))
    order = np.lexsort((dst_d, r_all, e_all, src_d))
    src_d, dst_d = src_d[order], dst_d[order]
    e_all, r_all = e_all[order], r_all[order]
    keep = np.ones(len(order), dtype=bool)
    keep[1:] = ((src_d[1:] != src_d[:-1]) | (e_all[1:] != e_all[:-1])
                | (r_all[1:] != r_all[:-1]) | (dst_d[1:] != dst_d[:-1]))
    return src_d[keep], e_all[keep], r_all[keep], dst_d[keep]


def mirror_from_edges(src_vids, dst_vids, etype, rank=None,
                      space_id: int = 0) -> CsrMirror:
    """What ``build_mirror`` folds from KV for an edge-only space.

    ``src_vids``/``dst_vids`` are vid values, ``etype`` the (positive)
    edge type per edge or one int for all, ``rank`` per edge (default
    0).  Both directions are stored (the reverse under ``-etype``), a
    repeated (src, etype, rank, dst) keeps one row as the KV key does,
    rows sort by (src_dense, etype, rank, dst), and ``vids`` is the
    sorted unique set of endpoints."""
    src = np.asarray(src_vids, np.int64).reshape(-1)
    dst = np.asarray(dst_vids, np.int64).reshape(-1)
    k = len(src)
    if len(dst) != k:
        raise ValueError("src_vids and dst_vids differ in length")
    et = np.broadcast_to(np.asarray(etype, np.int64), (k,))
    if k and (et <= 0).any():
        raise ValueError("edge types are positive; the reverse rows "
                         "carry -etype")
    rk = np.zeros(k, np.int64) if rank is None else \
        np.broadcast_to(np.asarray(rank, np.int64), (k,))
    m = CsrMirror(space_id)
    m.vids = np.unique(np.concatenate([src, dst]))
    m.n = len(m.vids)
    if k == 0:
        return _finish(m)
    s_all = np.concatenate([src, dst])
    d_all = np.concatenate([dst, src])
    e_all = np.concatenate([et, -et])
    r_all = np.concatenate([rk, rk])
    src_d = _dense_index(m.vids, s_all)
    dst_d = _dense_index(m.vids, d_all)
    src_d, e_all, r_all, dst_d = _sorted_rows(src_d, e_all, r_all, dst_d,
                                              m.n)
    m.edge_src = src_d.astype(np.int32)
    m.edge_dst = dst_d.astype(np.int32)
    m.edge_etype = e_all.astype(np.int32)
    m.edge_rank = r_all.astype(np.int64)
    m.m = len(m.edge_src)
    return _finish(m)


MIRROR_FIELDS = ("vids", "edge_src", "edge_dst", "edge_etype",
                 "edge_rank", "row_ptr")


def mirror_from_reference(arrays: Mapping[str, np.ndarray],
                          space_id: Optional[int] = None) -> CsrMirror:
    """A CsrMirror carrying the reference's arrays as they are: the
    ``MIRROR_FIELDS`` of a ``nebula_tpu`` CsrMirror, as numpy arrays
    (``space_id`` from the mapping when not given).  Both packages then
    compute on identical state."""
    m = CsrMirror(int(arrays.get("space_id", 0)) if space_id is None
                  else space_id)
    m.vids = np.asarray(arrays["vids"], np.int64).copy()
    m.edge_src = np.asarray(arrays["edge_src"], np.int32).copy()
    m.edge_dst = np.asarray(arrays["edge_dst"], np.int32).copy()
    m.edge_etype = np.asarray(arrays["edge_etype"], np.int32).copy()
    m.edge_rank = np.asarray(arrays["edge_rank"], np.int64).copy()
    m.row_ptr = np.asarray(arrays["row_ptr"], np.int32).copy()
    m.n = len(m.vids)
    m.m = len(m.edge_src)
    if len(m.row_ptr) != m.n + 1 or any(
            len(a) != m.m for a in (m.edge_dst, m.edge_etype,
                                    m.edge_rank)):
        raise ValueError("reference mirror arrays disagree in length")
    return m
