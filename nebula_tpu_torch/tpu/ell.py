"""Degree-bucketed ELL tables — the host half of ``nebula_tpu/tpu/ell.py``
(``:54-359``, ``:483-500``, ``:780-808``, ``:1127``).

A hop pulls ``next[v, :] = OR_j f[nbr[v, j], :] & [et[v, j] in OVER]``
over packed lane words.  Vertices are relabeled so that one degree
bucket's rows are contiguous (new id = rank in (bucket_D, old_id)
order); per bucket ``nbr[rows, D]`` holds the new ids of the row's
in-slot neighbours over both stored directions, padded with the
sentinel row ``n_rows`` whose frontier word is pinned to zero, and
``et[rows, D]`` the signed etype of each slot (0 for padding, never a
real etype).  Hubs (degree > cap) own extra rows after every real
vertex; a hop OR-merges them into their owner row.

The numpy ``build`` is the reference's numpy path verbatim (the native
C++ build path waits for a later slice).  ``device_tables`` lays the
buckets out flat on a torch device for the kernels in ``ell_ops.py``.
"""
from __future__ import annotations

from typing import List, Mapping, NamedTuple, Tuple

import numpy as np
import torch


def _next_pow2(x: np.ndarray) -> np.ndarray:
    x = np.maximum(x.astype(np.int64), 1)
    return (1 << np.ceil(np.log2(x)).astype(np.int64)).astype(np.int64)


class DeviceTables(NamedTuple):
    """The ELL buckets laid out for the hop kernel.

    ``nbr``/``et`` are the buckets' ``[rows_b, D_b]`` tables flattened
    and concatenated (int32, on the device); bucket b's rows are
    ``row0[b] .. row0[b] + rows[b]`` of the frontier and its slots
    start at ``slot0[b]`` of the flat tables.  ``n`` is the count of
    real vertices (extra row i is frontier row ``n + i``), ``n_rows``
    the pad row."""
    nbr: torch.Tensor
    et: torch.Tensor
    row0: Tuple[int, ...]
    rows: Tuple[int, ...]
    D: Tuple[int, ...]
    slot0: Tuple[int, ...]
    n: int
    n_rows: int

    def bucket(self, b: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Bucket b's ``(nbr, et)`` as ``[rows_b, D_b]`` views."""
        lo, k = self.slot0[b], self.rows[b] * self.D[b]
        shape = (self.rows[b], self.D[b])
        return (self.nbr[lo:lo + k].view(shape),
                self.et[lo:lo + k].view(shape))


class EllIndex:
    """Degree-bucketed in-slot table over relabeled dense vertex ids."""

    __slots__ = ("n", "m", "perm", "inv", "bucket_D", "bucket_nbr",
                 "bucket_et", "extra_owner", "n_rows", "_n_hubs")

    def __init__(self):
        self.n = 0                     # real vertices
        self.m = 0                     # slots filled (edge rows, both dirs)
        self.perm = np.zeros(0, np.int32)   # old dense id -> new id
        self.inv = np.zeros(0, np.int32)    # new id -> old dense id
        self.bucket_D: List[int] = []       # slot width per bucket (asc)
        self.bucket_nbr: List[np.ndarray] = []  # [rows_b, D_b] new ids
        self.bucket_et: List[np.ndarray] = []   # [rows_b, D_b] signed etype
        self.extra_owner = np.zeros(0, np.int32)  # hub extra row -> new id
        self.n_rows = 0                # n + len(extra_owner)
        self._n_hubs = None            # lazy count of distinct hub owners

    # -------------------------------------------------------------- build
    @staticmethod
    def build(edge_src: np.ndarray, edge_dst: np.ndarray,
              edge_etype: np.ndarray, n: int, cap: int = 512,
              min_d: int = 8, growth_slack: int = 0) -> "EllIndex":
        """Group the mirror's edge rows by dst into bucketed slot tables.

        ``edge_*`` are the CsrMirror arrays (dense ids, signed etypes,
        both directions present).  ``cap`` bounds slot width; vertices
        with more slots get extra rows merged by the hop's fix-up.
        ``min_d`` floors the bucket width.  ``growth_slack`` appends that
        many spare all-sentinel rows to the widest bucket (owner = the
        spare sentinel, so a hop merges them nowhere)."""
        ell = EllIndex()
        ell.n = n
        m = len(edge_src)
        ell.m = m
        if n == 0:
            ell.n_rows = 0
            return ell

        # rows are grouped by DST (slots = in-edges): a hop pulls
        # next[v] = max over in-slots of f[src], so ``deg`` here is the
        # in-degree over both stored directions.
        order = np.argsort(edge_dst, kind="stable")
        es = np.asarray(edge_dst, np.int64)[order]   # row owner (dst)
        ed = np.asarray(edge_src, np.int64)[order]   # slot neighbor (src)
        ee = np.asarray(edge_etype, np.int32)[order]
        deg = np.bincount(es, minlength=n).astype(np.int64)

        cap = max(cap, min_d)
        per_row = np.minimum(deg, cap)
        D_v = np.clip(_next_pow2(per_row), min_d, cap)
        vorder = np.lexsort((np.arange(n), D_v))         # stable by bucket
        perm = np.empty(n, np.int32)
        perm[vorder] = np.arange(n, dtype=np.int32)
        ell.perm = perm
        ell.inv = np.asarray(vorder, np.int32)

        # hub extra rows (degree > cap), appended after all real vertices
        hub_vs = np.nonzero(deg > cap)[0]
        n_extra_v = np.zeros(n, dtype=np.int64)          # extra rows per v
        n_extra_v[hub_vs] = np.ceil(deg[hub_vs] / cap).astype(np.int64) - 1
        first_extra = np.zeros(n, dtype=np.int64)        # v -> its 1st extra
        first_extra[1:] = np.cumsum(n_extra_v)[:-1]
        first_extra += n
        n_extras = int(n_extra_v.sum())
        ell.extra_owner = perm[np.repeat(np.arange(n), n_extra_v)] \
            .astype(np.int32)
        ell.n_rows = n + n_extras

        # per-edge (row, col) destination slot
        row_start = np.concatenate([[0], np.cumsum(deg)])
        off = np.arange(m, dtype=np.int64) - row_start[es]
        k_of = off // cap
        col = np.where(k_of == 0, off, off % cap).astype(np.int64)
        row = np.where(k_of == 0, perm[es].astype(np.int64),
                       first_extra[es] + k_of - 1)

        # bucket layout: new ids are contiguous per D (vorder sorted by D_v)
        Ds = sorted(set(D_v.tolist()))
        sentinel = np.int32(ell.n_rows)  # frontier row pinned to 0
        D_new = D_v[vorder]              # slot width per new id
        bstart = 0
        for D in Ds:
            nb = int(np.count_nonzero(D_new == D))
            if D == cap:
                nb += n_extras           # extras live in the cap bucket
            nbr = np.full((nb, D), sentinel, dtype=np.int32)
            et = np.zeros((nb, D), dtype=np.int32)
            # buckets are contiguous in new-id order, and extra rows
            # (>= n) all belong to the last (cap) bucket
            sel = np.nonzero((row >= bstart) & (row < bstart + nb))[0]
            if len(sel):
                flat = (row[sel] - bstart) * D + col[sel]
                nbr.reshape(-1)[flat] = perm[ed[sel]]
                et.reshape(-1)[flat] = ee[sel]
            ell.bucket_D.append(int(D))
            ell.bucket_nbr.append(nbr)
            ell.bucket_et.append(et)
            bstart += nb
        return _append_growth_spares(ell, growth_slack)

    def spare_sentinel(self) -> int:
        """The extra_owner value marking an UNCLAIMED growth-spare row
        (== n_rows, the pad row: the hub merge skips owners past the
        table, so an unclaimed spare merges nowhere)."""
        return self.n_rows

    # -------------------------------------------------------------- shape
    def shape_sig(self) -> Tuple:
        """Static shape signature (table shapes only, never contents)."""
        return (self.n, self.n_rows, len(self.extra_owner), self.n_hubs,
                tuple((nbr.shape[0], nbr.shape[1])
                      for nbr in self.bucket_nbr))

    @property
    def n_hubs(self) -> int:
        """Distinct hub owners (the spare sentinel counts as one when
        spares exist, as in the reference)."""
        if self._n_hubs is None:
            self._n_hubs = (int(len(np.unique(self.extra_owner)))
                            if len(self.extra_owner) else 0)
        return self._n_hubs

    def hub_merge(self) -> Tuple[np.ndarray, np.ndarray]:
        """(extra_slot int32[n_extras], hub_rows int32[n_hubs]): each
        extra row's index into the compact hub-owner list, and that
        list itself — the hop's OR-merge targets (``hub_rows`` entries
        >= n_rows are the spare sentinel and merge nowhere)."""
        if not len(self.extra_owner):
            return (np.zeros(0, np.int32), np.zeros(0, np.int32))
        owners, slot = np.unique(self.extra_owner, return_inverse=True)
        return slot.astype(np.int32), owners.astype(np.int32)

    # ------------------------------------------------------------- device
    def device_tables(self, device: torch.device) -> DeviceTables:
        """The buckets flattened onto ``device`` (a fresh upload; the
        runtime caches it on the mirror, the way the reference caches
        ``_hub_merge_cache``)."""
        row0, rows, Ds, slot0 = [], [], [], []
        r = s = 0
        for nbr in self.bucket_nbr:
            row0.append(r)
            rows.append(int(nbr.shape[0]))
            Ds.append(int(nbr.shape[1]))
            slot0.append(s)
            r += int(nbr.shape[0])
            s += int(nbr.size)
        if r != self.n_rows:
            raise ValueError(f"buckets cover {r} rows, table has "
                             f"{self.n_rows}")

        def flat(parts: List[np.ndarray]) -> torch.Tensor:
            a = (np.concatenate([p.reshape(-1) for p in parts])
                 if parts else np.zeros(0, np.int32))
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
                .to(device)

        return DeviceTables(flat(self.bucket_nbr), flat(self.bucket_et),
                            tuple(row0), tuple(rows), tuple(Ds),
                            tuple(slot0), int(self.n), int(self.n_rows))


ELL_FIELDS = ("n", "m", "perm", "inv", "bucket_D", "bucket_nbr",
              "bucket_et", "extra_owner", "n_rows")


def ell_from_reference(arrays: Mapping[str, object]) -> EllIndex:
    """An EllIndex carrying a reference ``nebula_tpu`` EllIndex's
    ``ELL_FIELDS`` (numpy arrays, lists of arrays, ints) as they are."""
    ell = EllIndex()
    ell.n = int(arrays["n"])
    ell.m = int(arrays["m"])
    ell.n_rows = int(arrays["n_rows"])
    ell.perm = np.asarray(arrays["perm"], np.int32).copy()
    ell.inv = np.asarray(arrays["inv"], np.int32).copy()
    ell.bucket_D = [int(d) for d in arrays["bucket_D"]]
    ell.bucket_nbr = [np.asarray(a, np.int32).copy()
                      for a in arrays["bucket_nbr"]]
    ell.bucket_et = [np.asarray(a, np.int32).copy()
                     for a in arrays["bucket_et"]]
    ell.extra_owner = np.asarray(arrays["extra_owner"], np.int32).copy()
    if ell.n_rows != ell.n + len(ell.extra_owner):
        raise ValueError("reference EllIndex rows disagree")
    return ell


def _append_growth_spares(ell: EllIndex, slack: int) -> EllIndex:
    """Provision ``slack`` spare all-sentinel rows in the widest bucket
    (owner = the spare sentinel).  Every pre-spare sentinel slot is
    re-pointed at the NEW pad row (the slot sentinel is n_rows by
    contract, and n_rows just grew); the tables are freshly built and
    unshared, so the rewrite is safe in place."""
    if slack <= 0 or ell.n == 0 or not ell.bucket_nbr:
        return ell
    old_sent = np.int32(ell.n_rows)
    new_sent = np.int32(ell.n_rows + int(slack))
    for b in range(len(ell.bucket_nbr)):
        nbr = ell.bucket_nbr[b]
        nbr[nbr == old_sent] = new_sent
    D = int(ell.bucket_nbr[-1].shape[1])
    ell.bucket_nbr[-1] = np.vstack(
        [ell.bucket_nbr[-1],
         np.full((int(slack), D), new_sent, np.int32)])
    ell.bucket_et[-1] = np.vstack(
        [ell.bucket_et[-1], np.zeros((int(slack), D), np.int32)])
    ell.extra_owner = np.concatenate(
        [ell.extra_owner,
         np.full(int(slack), new_sent, np.int32)]).astype(np.int32)
    ell.n_rows = int(new_sent)
    return ell


# ====================================================================
# Bit-packed lanes: 8 query lanes per uint8 word, little bit order —
# bit k of word j is lane 8j+k at every public function of the port.
# ====================================================================
LANE_BITS = 8


def lanes_width(B: int) -> int:
    """uint8 words per frontier row for a B-query batch."""
    return -(-B // LANE_BITS)


def pack_lanes_host(f: np.ndarray) -> np.ndarray:
    """[R, B] truthy -> uint8 [R, ceil(B/8)] (little bit order: bit k
    of word j is lane j*8+k)."""
    return np.packbits(np.asarray(f) != 0, axis=1, bitorder="little")


def unpack_lanes_host(fp: np.ndarray, B: int) -> np.ndarray:
    """uint8 [R, W] -> bool [R, B]."""
    return np.unpackbits(fp, axis=1, bitorder="little")[:, :B] > 0


def dense_hop_bytes(ell: EllIndex, lane_bytes_per_row: int,
                    steps: int) -> int:
    """The reference's traffic model of one packed dense GO dispatch:
    per advance, each bucket row pays D word-gathers of
    ``lane_bytes_per_row`` plus an accumulator read+write.  It leaves
    out the 8 bytes per slot of the ``nbr``/``et`` tables themselves
    and the 32-byte sector a narrow word-gather really moves —
    ``chip_smoke.py`` counts both for the card's bound."""
    per_advance = sum(nbr.shape[0] * (nbr.shape[1] + 2)
                      for nbr in ell.bucket_nbr) * lane_bytes_per_row
    return max(steps - 1, 1) * per_advance
