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
    src_d = np.searchsorted(m.vids, s_all)
    dst_d = np.searchsorted(m.vids, d_all)
    order = np.lexsort((dst_d, r_all, e_all, src_d))
    src_d, dst_d = src_d[order], dst_d[order]
    e_all, r_all = e_all[order], r_all[order]
    # drop repeats of one key (sorted, so repeats are adjacent)
    keep = np.ones(len(order), dtype=bool)
    keep[1:] = ((src_d[1:] != src_d[:-1]) | (e_all[1:] != e_all[:-1])
                | (r_all[1:] != r_all[:-1]) | (dst_d[1:] != dst_d[:-1]))
    m.edge_src = src_d[keep].astype(np.int32)
    m.edge_dst = dst_d[keep].astype(np.int32)
    m.edge_etype = e_all[keep].astype(np.int32)
    m.edge_rank = r_all[keep].astype(np.int64)
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
