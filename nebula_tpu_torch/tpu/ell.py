"""Degree-bucketed ELL tables — the host half of ``nebula_tpu/tpu/ell.py``
(``:51-359``, ``:457``, ``:483-500``, ``:780-808``, ``:1127``,
``:1189-1220``, ``:1475``).

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
The write path's host half is the reference's too (``ell.py:809-1008``):
``plan_ell_absorb`` computes every affected row's replacement content
(with growth-spare claims), ``apply_ell_absorb_host`` the next
generation's copy-on-write host index, and ``absorb_update_arrays``
the padded per-bucket arguments of ``ell_ops.ell_absorb``.
``shard_ell`` (``ell.py:1688``) cuts the buckets into the row shards of
the replicated-frontier mesh, and ``mesh_tables`` lays them out on the
mesh's shard devices; ``build_sharded_ell`` (``ell.py:1871``) cuts the
row space into the chunks of the frontier-sharded mesh, and
``sharded_tables`` lays those out.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

INT16_INF = np.int16(2**15 - 1)     # ell.py:51: an unreached BFS depth
# kernels.py:37, kept here (the port has no tpu/kernels.py): an
# unreached depth once FIND PATH widens the depth rows to int32
INT32_INF = np.int32(2**31 - 1)


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

    def to_old(self, frontier_new: np.ndarray) -> np.ndarray:
        """[.., B] rows in new-id space -> old dense-id space."""
        return frontier_new[self.perm]

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

    def hub_table(self) -> np.ndarray:
        """bool[n+1]: vertex owns hub extra rows (slot spill) — the
        adaptive single-query program switches to the dense pull when
        one enters its frontier, because a push from the main row alone
        would miss the spilled slots (the batched sparse program expands
        hubs into their extra rows instead: ``hub_expansion``).
        Unclaimed growth spares (owner = the spare sentinel, past every
        real vertex) are filtered: they belong to nobody yet."""
        is_hub = np.zeros(self.n + 1, dtype=bool)
        if len(self.extra_owner):
            u = np.unique(self.extra_owner)
            is_hub[u[u < self.n]] = True
        return is_hub

    def hub_expansion(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ecnt int32[n+1], e0 int32[n+1]): per-vertex extra-row run —
        hub vertex v owns rows [e0[v], e0[v] + ecnt[v]) besides its main
        row v (extras of one owner are contiguous: ``build`` appends
        them in owner order).  Non-hubs: ecnt 0, e0 n_rows.  The batched
        sparse program pushes out of a hub's spilled slots through it."""
        ecnt = np.zeros(self.n + 1, np.int32)
        e0 = np.full(self.n + 1, self.n_rows, np.int32)
        if len(self.extra_owner):
            owners, first = np.unique(self.extra_owner, return_index=True)
            cnts = np.bincount(self.extra_owner, minlength=self.n)
            ecnt[:self.n] = cnts[:self.n].astype(np.int32)
            # unclaimed growth spares carry the out-of-range spare
            # sentinel as owner — scattering THAT into e0 would walk
            # off the array; they have no expansion until claimed
            real = owners < self.n
            e0[owners[real]] = (self.n + first[real]).astype(np.int32)
        return ecnt, e0

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


def plan_ell_absorb(ell: EllIndex,
                    ins_dst: np.ndarray, ins_src: np.ndarray,
                    ins_et: np.ndarray,
                    del_dst: np.ndarray, del_src: np.ndarray,
                    del_et: np.ndarray, claims_out: Optional[list] = None):
    """Replacement-row plan for absorbing overlay edges into ``ell``.

    Inputs are OLD-dense-id edge rows exactly as the CsrMirror stores
    them (both directions present as separate rows; reverse rides
    -etype).  Returns {bucket: (local_rows int32[k], nbr [k, D_b],
    et [k, D_b])} — the full new content of every affected row — or
    None when any owner's new slot count outgrows its resident
    capacity (main row + existing extra rows), which only the rebuild
    can serve.  Work is O(delta x row width): only affected owners'
    rows are read and rewritten.

    In-place slot growth: when ``claims_out`` is a list and the index
    holds unclaimed growth spares (EllIndex.build growth_slack), an
    overflowing owner that is NOT already a hub claims enough spare
    rows to hold its new degree — ``(spare_index, owner_new_id)``
    pairs are appended to ``claims_out`` and the plan rewrites the
    claimed rows like any other.  Narrow by design: existing-vertex
    slot extension only — hubs (and previously-grown vertices, which
    look like hubs) and new-vertex ingest still take the rebuild, and
    claims always consume the LOWEST free spares so the free set stays
    a contiguous suffix (hub_expansion's contiguity contract)."""
    import bisect
    from collections import Counter

    if ell.n == 0:
        return None if (len(ins_dst) or len(del_dst)) else {}
    sentinel = np.int32(ell.n_rows)
    ecnt, e0 = ell.hub_expansion()
    bstarts: List[int] = []
    acc = 0
    for nbr in ell.bucket_nbr:
        bstarts.append(acc)
        acc += nbr.shape[0]
    free_spares: List[int] = []
    if claims_out is not None and len(ell.extra_owner):
        free_spares = np.nonzero(
            ell.extra_owner == np.int32(ell.spare_sentinel()))[0] \
            .tolist()

    owners: Dict[int, Tuple[Counter, list]] = {}

    def owner_of(dst_old: int):
        r = int(ell.perm[dst_old])
        o = owners.get(r)
        if o is None:
            o = owners[r] = (Counter(), [])
        return o

    for i in range(len(ins_dst)):
        owner_of(int(ins_dst[i]))[1].append(
            (int(ell.perm[int(ins_src[i])]), int(ins_et[i])))
    for i in range(len(del_dst)):
        owner_of(int(del_dst[i]))[0][
            (int(ell.perm[int(del_src[i])]), int(del_et[i]))] += 1

    upd: Dict[int, Tuple[list, list, list]] = {}
    for r, (dels_c, ins_l) in owners.items():
        rows = [r] + list(range(int(e0[r]), int(e0[r]) + int(ecnt[r])))
        entries: list = []
        widths: List[Tuple[int, int, int]] = []
        for row in rows:
            b = bisect.bisect_right(bstarts, row) - 1
            local = row - bstarts[b]
            nbr_row = ell.bucket_nbr[b][local]
            et_row = ell.bucket_et[b][local]
            widths.append((b, local, int(nbr_row.shape[0])))
            fill = nbr_row != sentinel
            entries.extend(zip(nbr_row[fill].tolist(),
                               et_row[fill].tolist()))
        if dels_c:
            left = Counter(dels_c)
            kept = []
            for ent in entries:
                if left.get(ent, 0) > 0:
                    left[ent] -= 1
                else:
                    kept.append(ent)
            if any(v > 0 for v in left.values()):
                # a tombstone names an edge the table doesn't hold —
                # the overlay and the tables disagree; only the
                # rebuild can reconcile
                return None
            entries = kept
        entries.extend(ins_l)
        total_w = sum(w for _b, _l, w in widths)
        if len(entries) > total_w:
            # in-place slot growth: claim spare rows for a NON-hub
            # owner whose degree outgrew its resident width (narrow
            # scope — a hub, or a vertex grown in an earlier window,
            # already owns extras whose contiguity a scattered claim
            # would break: those still rebuild)
            if not free_spares or int(ecnt[r]) > 0:
                return None      # slot overflow past the hub budget
            d_spare = int(ell.bucket_nbr[-1].shape[1])
            need = -(-(len(entries) - total_w) // d_spare)
            if need > len(free_spares):
                return None      # growth slack exhausted: rebuild
            take, free_spares[:need] = free_spares[:need], []
            for idx in take:
                row = ell.n + int(idx)
                b = bisect.bisect_right(bstarts, row) - 1
                widths.append((b, row - bstarts[b], d_spare))
                claims_out.append((int(idx), int(r)))
        pos = 0
        for b, local, w in widths:
            take = entries[pos:pos + w]
            pos += w
            nn = np.full(w, sentinel, np.int32)
            ne = np.zeros(w, np.int32)
            if take:
                nn[:len(take)] = [t[0] for t in take]
                ne[:len(take)] = [t[1] for t in take]
            rb = upd.setdefault(b, ([], [], []))
            rb[0].append(local)
            rb[1].append(nn)
            rb[2].append(ne)
    return {b: (np.asarray(v[0], np.int32), np.vstack(v[1]),
                np.vstack(v[2]))
            for b, v in upd.items()}


def apply_ell_absorb_host(ell: EllIndex, plan, m_new: int,
                          claims=()) -> EllIndex:
    """Next-generation EllIndex: identical shapes/permutation (cached
    kernels keyed by shape_sig keep serving), updated slot content.
    Buckets WITH updates are copied before the scatter; untouched
    buckets (and perm/inv — and extra_owner when no spare was
    claimed) share memory with the old generation, whose arrays stay
    exactly as published — the immutable-generation contract
    in-flight dispatches rely on.  ``claims`` are plan_ell_absorb's
    (spare_index, owner) growth claims: the next generation's
    extra_owner is a COPY with those spares assigned (table SHAPES
    still survive — only n_hubs, a kernel-argument size, moves)."""
    out = EllIndex()
    out.n, out.m = ell.n, m_new
    out.perm, out.inv = ell.perm, ell.inv
    out.bucket_D = list(ell.bucket_D)
    out.extra_owner = ell.extra_owner
    if claims:
        eo = ell.extra_owner.copy()
        for idx, owner in claims:
            eo[idx] = owner
        out.extra_owner = eo
    out.n_rows = ell.n_rows
    out.bucket_nbr = list(ell.bucket_nbr)
    out.bucket_et = list(ell.bucket_et)
    for b, (rows, nn, ne) in plan.items():
        nbr = ell.bucket_nbr[b].copy()
        et = ell.bucket_et[b].copy()
        nbr[rows] = nn
        et[rows] = ne
        out.bucket_nbr[b] = nbr
        out.bucket_et[b] = et
    return out


def absorb_update_arrays(ell: EllIndex, plan):
    """Device-kernel argument form of an absorb plan (``ell.py:970``):
    per bucket, (rows, nbr_rows, et_rows) padded to ONE uniform pow-2
    count kp >= 8 — the rung of the largest per-bucket update set (the
    reference bounds its jit cache with it; the port keeps the layout
    so its kernel takes the reference's arguments).  Pad entries carry
    the index ``bucket row count``, out of range for the bucket and
    dropped by the scatter (``ell_ops.ell_absorb``).  Returns (counts
    tuple, the per-bucket arrays)."""
    per_bucket = []
    kmax = 1
    for b, nbr_np in enumerate(ell.bucket_nbr):
        nbk, D = nbr_np.shape
        rows, nn, ne = plan.get(b, (np.zeros(0, np.int32),
                                    np.zeros((0, D), np.int32),
                                    np.zeros((0, D), np.int32)))
        per_bucket.append((nbk, D, rows, nn, ne))
        kmax = max(kmax, len(rows))
    kp = max(8, 1 << (kmax - 1).bit_length())
    counts: List[int] = []
    outs = []
    for nbk, D, rows, nn, ne in per_bucket:
        k = len(rows)
        rp = np.full(kp, nbk, np.int32)
        pn = np.full((kp, D), np.int32(ell.n_rows), np.int32)
        pe = np.zeros((kp, D), np.int32)
        rp[:k] = rows
        pn[:k] = nn
        pe[:k] = ne
        counts.append(kp)
        outs.append((rp, pn, pe))
    return tuple(counts), outs


def absorb_live(ell: EllIndex, plan) -> Tuple[int, ...]:
    """Per bucket, the real entries of ``absorb_update_arrays(ell,
    plan)``: its first ones, the rest being pads (the rows the mesh's
    absorb walks, ``ell_ops.mesh_absorb``)."""
    return tuple(len(plan[b][0]) if b in plan else 0
                 for b in range(len(ell.bucket_nbr)))


# ====================================================================
# Row-sharded tables of the replicated-frontier mesh (ell.py:1688)
# ====================================================================
def shard_ell(ell: EllIndex, k: int):
    """The reference's ``shard_ell`` (``ell.py:1688``) as host arrays:
    each bucket is padded to a multiple of ``k`` rows with sentinel rows
    (nbr ``n_rows``, et 0) and cut into k equal chunks, shard s taking
    the bucket-local rows ``[s * padded / k, (s + 1) * padded / k)``
    (an empty bucket pads to k rows).  Returns (nbr[s][b], et[s][b],
    real_rows[b]) — shard s's ``[padded_b / k, D_b]`` block of bucket b
    and each bucket's unpadded row count."""
    if k < 1:
        raise ValueError(f"k={k} shards")
    sentinel = np.int32(ell.n_rows)
    nbrs: List[List[np.ndarray]] = [[] for _ in range(k)]
    ets: List[List[np.ndarray]] = [[] for _ in range(k)]
    reals: List[int] = []
    for nbr, et in zip(ell.bucket_nbr, ell.bucket_et):
        nb, D = nbr.shape
        padded = ((nb + k - 1) // k) * k if nb else k
        if padded != nb:
            nbr = np.concatenate(
                [nbr, np.full((padded - nb, D), sentinel, np.int32)])
            et = np.concatenate([et, np.zeros((padded - nb, D), np.int32)])
        chunk = padded // k
        for s in range(k):
            nbrs[s].append(nbr[s * chunk:(s + 1) * chunk])
            ets[s].append(et[s * chunk:(s + 1) * chunk])
        reals.append(int(nb))
    return nbrs, ets, reals


class MeshTables(NamedTuple):
    """``shard_ell``'s tables on a mesh (``mesh.PartsMesh``), one
    ``DeviceTables`` per shard on its device: shard s's
    ``shards[s].rows[b]`` is bucket b's chunk, its ``row0[b]`` the
    frontier row of the chunk's first row (``brow0[b] + s * chunk``),
    its ``slot0`` shard-local.  ``real_rows[b]`` trims the padding:
    only chunk rows below it are frontier rows."""
    mesh: object
    shards: Tuple[DeviceTables, ...]
    real_rows: Tuple[int, ...]
    brow0: Tuple[int, ...]

    @property
    def k(self) -> int:
        return len(self.shards)

    def owned(self, s: int) -> List[Tuple[int, int]]:
        """Shard s's frontier rows, as one half-open range per bucket
        (empty ranges left out)."""
        t = self.shards[s]
        out = []
        for b, real in enumerate(self.real_rows):
            lo = t.row0[b]
            hi = self.brow0[b] + min(real, (s + 1) * t.rows[b])
            if hi > lo:
                out.append((lo, hi))
        return out

    def host_shards(self):
        """(nbr[s][b], et[s][b]) as numpy, ``shard_ell``'s form."""
        nbrs, ets = [], []
        for t in self.shards:
            nbrs.append([a.cpu().numpy() for a in
                         (t.bucket(b)[0] for b in range(len(t.D)))])
            ets.append([a.cpu().numpy() for a in
                        (t.bucket(b)[1] for b in range(len(t.D)))])
        return nbrs, ets


def mesh_tables(ell: EllIndex, mesh) -> MeshTables:
    """``shard_ell(ell, mesh.k)`` laid out flat on each shard's device."""
    nbrs, ets, reals = shard_ell(ell, mesh.k)
    brow0, r = [], 0
    for nbr in ell.bucket_nbr:
        brow0.append(r)
        r += int(nbr.shape[0])
    shards = []
    for s, dev in enumerate(mesh.devices):
        row0, rows, Ds, slot0 = [], [], [], []
        off = 0
        for b, blk in enumerate(nbrs[s]):
            chunk, D = blk.shape
            row0.append(brow0[b] + s * chunk)
            rows.append(int(chunk))
            Ds.append(int(D))
            slot0.append(off)
            off += int(blk.size)

        def flat(parts, dev=dev):
            a = (np.concatenate([p.reshape(-1) for p in parts])
                 if parts else np.zeros(0, np.int32))
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
                .to(dev)
        shards.append(DeviceTables(flat(nbrs[s]), flat(ets[s]),
                                   tuple(row0), tuple(rows), tuple(Ds),
                                   tuple(slot0), int(ell.n),
                                   int(ell.n_rows)))
    return MeshTables(mesh, tuple(shards), tuple(reals), tuple(brow0))



# ====================================================================
# Chunk-sharded tables of the frontier-sharded mesh (ell.py:1849-1934)
# ====================================================================
class ShardedEll:
    """The reference's ``ShardedEll`` (``ell.py:1849``), host arrays:
    the new-id row space [0, n_rows] cut into k contiguous chunks of
    ``chunk`` rows, shard d owning rows [d * chunk, (d + 1) * chunk).
    Every bucket's intersection with a chunk is one local block, padded
    (nbr ``n_rows``, et 0) to the largest block across shards:
    ``nbr_s[b]``/``et_s[b]`` are [k, mx[b], D[b]], ``starts_s[d, b]``
    the global row of shard d's block row 0, ``bstarts[b]`` the
    bucket's first global row.  ``ecnt_s``/``e0_s`` [k, chunk] are the
    hub expansion (``EllIndex.hub_expansion``) cut by the same chunks,
    0 / n_rows past the real vertices."""

    __slots__ = ("k", "chunk", "bstarts", "mx", "D", "nbr_s", "et_s",
                 "starts_s", "ecnt_s", "e0_s", "n", "n_rows", "n_extras")


def build_sharded_ell(ell: EllIndex, k: int) -> ShardedEll:
    """Split ``ell`` into k per-shard chunks (``ell.py:1871``)."""
    if k < 1:
        raise ValueError(f"k={k} shards")
    sh = ShardedEll()
    sh.k = k
    R1 = ell.n_rows + 1
    sh.chunk = -(-R1 // k)
    sh.n, sh.n_rows = ell.n, ell.n_rows
    sh.n_extras = len(ell.extra_owner)
    sh.bstarts, sh.mx, sh.D = [], [], []
    sh.nbr_s, sh.et_s = [], []
    starts = np.zeros((k, len(ell.bucket_nbr)), np.int32)
    sentinel = np.int32(ell.n_rows)
    bstart = 0
    for b, (nbr, et) in enumerate(zip(ell.bucket_nbr, ell.bucket_et)):
        nb, D = nbr.shape
        lo = np.maximum(bstart, np.arange(k, dtype=np.int64) * sh.chunk)
        hi = np.minimum(bstart + nb,
                        (np.arange(k, dtype=np.int64) + 1) * sh.chunk)
        cnt = np.maximum(hi - lo, 0)
        mx = max(int(cnt.max()), 1) if nb else 1
        nbr_k = np.full((k, mx, D), sentinel, np.int32)
        et_k = np.zeros((k, mx, D), np.int32)
        for d in range(k):
            c = int(cnt[d])
            if c:
                s = int(lo[d]) - bstart
                nbr_k[d, :c] = nbr[s:s + c]
                et_k[d, :c] = et[s:s + c]
            starts[d, b] = int(lo[d])
        sh.bstarts.append(bstart)
        sh.mx.append(mx)
        sh.D.append(D)
        sh.nbr_s.append(nbr_k)
        sh.et_s.append(et_k)
        bstart += nb
    sh.starts_s = starts
    ecnt, e0 = ell.hub_expansion()
    pad = k * sh.chunk
    ec = np.zeros(pad, np.int32)
    ez = np.full(pad, ell.n_rows, np.int32)
    ec[:len(ecnt) - 1] = ecnt[:-1]        # rows >= n never expand
    ez[:len(e0) - 1] = e0[:-1]
    sh.ecnt_s = ec.reshape(k, sh.chunk)
    sh.e0_s = ez.reshape(k, sh.chunk)
    return sh


def split_start_pairs_by_owner(sh: ShardedEll, new_ids: np.ndarray,
                               qids: np.ndarray, c0: int):
    """Place each (query, start row) pair on the shard owning the row
    (``ell.py:1934``): (ids [k, c0] padded with n_rows, qid [k, c0]
    padded with 0), or None when a shard's share passes ``c0``.  ``sh``
    is a ShardedEll or a ShardedTables (its k, chunk and n_rows)."""
    k, chunk = sh.k, sh.chunk
    ids = np.full((k, c0), sh.n_rows, np.int32)
    qid = np.zeros((k, c0), np.int32)
    new_ids = np.asarray(new_ids)
    qids = np.asarray(qids)
    owner = new_ids // chunk
    for d in range(k):
        sel = owner == d
        c = int(sel.sum())
        if c > c0:
            return None
        ids[d, :c] = new_ids[sel]
        qid[d, :c] = qids[sel]
    return ids, qid


def sharded_sparse_pairs(out: np.ndarray):
    """Decode the frontier-sharded GO's [k, 2 + 2c] output (``ell.py:
    2162``) -> (overflow, qids, new row ids), merged across shards."""
    out = np.asarray(out)
    k = out.shape[0]
    c = (out.shape[1] - 2) // 2
    overflow = bool(out[:, 1].any())
    qs, us = [], []
    for d in range(k):
        q = out[d, 2:2 + c]
        u = out[d, 2 + c:]
        live = q >= 0
        qs.append(q[live])
        us.append(u[live])
    return overflow, np.concatenate(qs), np.concatenate(us)


class ShardedTables(NamedTuple):
    """A ``ShardedEll`` on a mesh (``mesh.PartsMesh``), the port's form
    of the reference's ``sharded_device_args``: per shard, on its
    device, its local blocks flat as a ``DeviceTables`` (``row0[b]`` the
    global row of block row 0, ``rows[b]`` the padded block rows
    ``mx[b]``, ``slot0`` shard-local) and its chunk of the hub
    expansion (``ecnt``/``e0`` int32 [chunk]).  ``bstarts`` are the
    buckets' first global rows; shard s's rows start at ``s * chunk``."""
    mesh: object
    shards: Tuple[DeviceTables, ...]
    ecnt: Tuple[torch.Tensor, ...]
    e0: Tuple[torch.Tensor, ...]
    bstarts: Tuple[int, ...]
    chunk: int
    n_extras: int

    @property
    def k(self) -> int:
        return len(self.shards)

    @property
    def n_rows(self) -> int:
        return self.shards[0].n_rows

    def bucket_end(self, b: int) -> int:
        """One past bucket b's last global row."""
        return self.bstarts[b + 1] if b + 1 < len(self.bstarts) \
            else self.n_rows

    def host_shards(self):
        """(nbr[s][b], et[s][b], ecnt[s], e0[s]) as numpy: the blocks of
        ``build_sharded_ell``'s ``nbr_s[b][s]``, ``et_s[b][s]``."""
        nbrs, ets = [], []
        for t in self.shards:
            nbrs.append([t.bucket(b)[0].cpu().numpy()
                         for b in range(len(t.D))])
            ets.append([t.bucket(b)[1].cpu().numpy()
                        for b in range(len(t.D))])
        return (nbrs, ets, [x.cpu().numpy() for x in self.ecnt],
                [x.cpu().numpy() for x in self.e0])


def sharded_tables(sh: ShardedEll, mesh) -> ShardedTables:
    """``sh`` laid out flat on each of the mesh's shard devices."""
    if mesh.k != sh.k:
        raise ValueError(f"a {sh.k}-way ShardedEll on a {mesh.k}-shard "
                         f"mesh")
    shards, ecnt, e0 = [], [], []
    for s, dev in enumerate(mesh.devices):
        slot0, off = [], 0
        for nbr in sh.nbr_s:
            slot0.append(off)
            off += int(nbr[s].size)

        def flat(parts, dev=dev):
            a = (np.concatenate([p[s].reshape(-1) for p in parts])
                 if parts else np.zeros(0, np.int32))
            return torch.from_numpy(np.ascontiguousarray(a, np.int32)) \
                .to(dev)
        shards.append(DeviceTables(
            flat(sh.nbr_s), flat(sh.et_s),
            tuple(int(x) for x in sh.starts_s[s]), tuple(sh.mx),
            tuple(sh.D), tuple(slot0), int(sh.n), int(sh.n_rows)))
        ecnt.append(torch.from_numpy(sh.ecnt_s[s].copy()).to(dev))
        e0.append(torch.from_numpy(sh.e0_s[s].copy()).to(dev))
    return ShardedTables(mesh, tuple(shards), tuple(ecnt), tuple(e0),
                         tuple(int(x) for x in sh.bstarts), int(sh.chunk),
                         int(sh.n_extras))

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


def unpack_bits(packed: np.ndarray, R1: int) -> np.ndarray:
    """Host half of the reference's ``pack_bits`` (ell.py:439, row-major
    bits, little bit order): uint8 [G, B] -> bool [R1, B]."""
    return np.unpackbits(packed, axis=0, bitorder="little")[:R1] > 0


# ====================================================================
# Sparse pair-list GO: static capacities and the output's host decode.
# ====================================================================
def sparse_caps(c0: int, d_max: int, steps: int, cap: int,
                growth: int = 8) -> Tuple[int, ...]:
    """Static per-hop pair-list capacities of the sparse batched GO
    (ell.py:1189): intermediate caps grow geometrically from the start
    capacity (``growth`` ~ the expected out-degree), the final cap gets
    the full budget.  A hop that outgrows its cap reports overflow and
    the caller reruns dense — capacity is a performance knob, never a
    correctness one."""
    caps = [max(8, c0)]
    for h in range(max(steps - 1, 0)):
        hard = max(8, caps[-1]) * max(d_max, 1)   # can't exceed expansion
        if h == steps - 2:
            caps.append(min(cap, hard))
        else:
            caps.append(min(cap, hard,
                            max(8, c0) * (max(growth, 2) ** (h + 1))))
    return tuple(caps)


def sparse_limit_cap(caps: Tuple[int, ...], c0: int, limit: int) -> int:
    """Output capacity of a LIMIT-reduced sparse GO (ell.py:1212): each
    kept vertex has final-hop degree >= 1, so a query keeps at most
    ``limit`` pairs and at most c0 queries are live — ``limit * c0``
    rounded up to a power of two, never above the unreduced cap."""
    return int(min(caps[-1],
                   1 << (max(8, limit * max(c0, 1)) - 1).bit_length()))


def sparse_pack32(qmax: int, n_rows: int) -> bool:
    """Whether a (query, vertex) pair packs into one int32 key
    ``q * (n_rows + 1) + v`` for every query index below ``qmax``
    (ell.py:1318): the output then holds one key per pair."""
    return qmax * (n_rows + 1) <= 2**31 - 1


def sparse_go_pairs(out: np.ndarray, pack32: bool, R1: int):
    """Decode a sparse GO output array -> (cnt, overflow, qids, new
    ids) (ell.py:1475): with ``pack32`` the keys ``q * R1 + i`` (unused
    places 2^31-1), else the qids (-1 unused) then the ids."""
    out = np.asarray(out)
    cnt, overflow = int(out[0]), bool(out[1])
    if pack32:
        keys = out[2:]
        keys = keys[keys != np.int32(2**31 - 1)]
        return cnt, overflow, keys // R1, keys % R1
    c_fin = (len(out) - 2) // 2
    qids = out[2:2 + c_fin]
    ids = out[2 + c_fin:]
    live = qids >= 0
    return cnt, overflow, qids[live], ids[live]
