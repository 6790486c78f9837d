"""Continuous-dispatch multi-hop GO over torch tensors — the slice of
``nebula_tpu/tpu/runtime.py`` that the default serving mode runs.

``TorchQueryRuntime`` holds per-space mirrors (``load_space`` stands in
for the reference's KV fold), their ELL indexes and device tables, and
a ``ContinuousGoScheduler`` (graph/batch_dispatch.py) that keeps one
lane batch in flight per (space, OVER set).  ``serve_go`` is the entry
point: it answers ``GO [UPTO] N STEPS FROM ... OVER e YIELD e._dst
[| YIELD COUNT(*)]`` and declines everything else with ``TpuDecline``.

Semantics held exactly: ``GO N STEPS`` is N-1 device hops, then the
host-side final hop over the frontier's out-edges in the OVER set
(``_frontier_edges_multi``); UPTO lanes read the union accumulator,
which includes depth 0 because join sets the start bits in it too.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.flags import flags
from ..graph.batch_dispatch import ContinuousGoScheduler
from ..storage.device import TpuDecline
from . import ell_ops
from .csr import CsrMirror
from .device import DeviceLike, resolve_device
from .ell import DeviceTables, EllIndex, lanes_width


class _GoQuery:
    """One GO request riding the continuous batch (the slice's subset
    of the reference's _GoQuery: no WHERE, no YIELD expressions)."""

    __slots__ = ("start_vids", "column")

    def __init__(self, start_vids: Sequence[int], column: str):
        self.start_vids = list(start_vids)
        self.column = column


def _ladder() -> List[int]:
    return sorted(int(w) for w in
                  str(flags.get("go_batch_widths") or
                      "128,1024").split(",") if w.strip()) or [128]


class TorchQueryRuntime:
    """The port's device runtime for continuous multi-hop GO."""

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self.mirrors: Dict[int, CsrMirror] = {}
        self.stats = {"go_device": 0, "go_reduced": 0, "fetch_bytes": 0,
                      "fetch_wait_s": 0.0}
        self.continuous = ContinuousGoScheduler(self)

    def close(self) -> None:
        """Stop every stream's pump thread (seated riders are failed)."""
        self.continuous.shutdown()

    # --------------------------------------------------- mirror lifecycle
    def load_space(self, space_id: int, mirror: CsrMirror) -> None:
        """Publish ``mirror`` for ``space_id``.  A space loads once: the
        generation drain/re-anchor that would let a stream move to a
        new mirror is not ported yet, so a second load raises."""
        with self._lock:
            if space_id in self.mirrors:
                raise ValueError(f"space {space_id} is already loaded")
            self.mirrors[space_id] = mirror

    def mirror(self, space_id: int) -> Optional[CsrMirror]:
        with self._lock:
            return self.mirrors.get(space_id)

    @staticmethod
    def ell(m: CsrMirror) -> EllIndex:
        """EllIndex for a mirror (cached on it)."""
        ix = getattr(m, "_ell", None)
        if ix is None:
            ix = EllIndex.build(m.edge_src, m.edge_dst, m.edge_etype,
                                m.n,
                                cap=int(flags.get("tpu_ell_cap") or 512),
                                growth_slack=int(
                                    flags.get("tpu_ell_growth_slack")
                                    or 0))
            m._ell = ix
        return ix

    def _device_tables(self, m: CsrMirror, ix: EllIndex) -> DeviceTables:
        """The ELL buckets on this runtime's device, cached per mirror
        (EllIndex has __slots__, so the cache hangs on the mirror)."""
        cache = getattr(m, "_tables_cache", None)
        if cache is None:
            cache = m._tables_cache = {}
        key = str(self.device)
        if key not in cache:
            cache[key] = ix.device_tables(self.device)
        return cache[key]

    def _hub_merge_dev(self, m: CsrMirror, ix: EllIndex
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(eslot, hrows) on the device for the hop's OR-merge
        (ell.EllIndex.hub_merge), cached per mirror."""
        cache = getattr(m, "_hub_merge_cache", None)
        if cache is None:
            cache = m._hub_merge_cache = {}
        key = str(self.device)
        if key not in cache:
            eslot, hrows = ix.hub_merge()
            cache[key] = (torch.from_numpy(eslot).to(self.device),
                          torch.from_numpy(hrows).to(self.device))
        return cache[key]

    # ------------------------------------------------------ entry point
    def serve_go(self, space_id: int, start_vids: Sequence[int],
                 etypes: Sequence[int], steps: int,
                 etype_to_alias: Dict[int, str], upto: bool = False,
                 reduce=None, yield_cols: Optional[Sequence[str]] = None,
                 where=None, limit: Optional[int] = None
                 ) -> Tuple[List[str], List[List[int]]]:
        """Serve one multi-hop GO; returns (columns, rows).

        ``etypes`` are signed (negative = REVERSELY) and must name one
        edge alias in ``etype_to_alias``; the result column is
        ``"<alias>._dst"`` with one row per final-hop edge, or with
        ``reduce=("count",)`` the single row ``[[n]]`` under
        ``"__count__"``.  WHERE, other YIELD columns, LIMIT, other
        reductions, ``steps < 2`` and unloaded spaces raise
        TpuDecline."""
        if where is not None:
            raise TpuDecline("WHERE is not served by the device slice")
        if limit is not None:
            raise TpuDecline("LIMIT is not served by the device slice")
        if reduce is not None and tuple(reduce) != ("count",):
            raise TpuDecline(f"reduction {reduce!r} is not served")
        steps = int(steps)
        if steps < 2:
            raise TpuDecline("single-step GO is not served by the "
                             "continuous device path")
        et_tuple = tuple(sorted(set(int(e) for e in etypes)))
        if not et_tuple or 0 in et_tuple:
            raise TpuDecline("GO needs an OVER edge type")
        aliases = {etype_to_alias.get(e) for e in et_tuple}
        if len(aliases) != 1 or None in aliases:
            raise TpuDecline("the device slice serves one OVER edge alias")
        column = f"{aliases.pop()}._dst"
        if yield_cols is not None and list(yield_cols) != [column]:
            raise TpuDecline(f"YIELD {list(yield_cols)} is not served; "
                             f"only {column}")
        if self.mirror(space_id) is None:
            raise TpuDecline(f"space {space_id} is not loaded")
        with self._lock:
            self.stats["go_device"] += 1
        result, _m = self.continuous.submit(
            space_id, et_tuple, _GoQuery(start_vids, column), steps,
            bool(upto), None if reduce is None else tuple(reduce))
        return result

    # ------------------------------------- continuous dispatch seam
    def continuous_session(self, space_id: int,
                           et_tuple: Tuple[int, ...],
                           min_lanes: int = 1
                           ) -> Optional["_ContinuousGoSession"]:
        """Anchor one device session for a (space, OVER set) stream over
        the current mirror, on the smallest ``go_batch_widths`` rung
        covering ``min_lanes``; None for an empty or unloaded space."""
        m = self.mirror(space_id)
        if m is None or m.m == 0:
            return None
        ix = self.ell(m)
        ladder = _ladder()
        B = ladder[-1]
        for w in ladder:
            if min_lanes <= w:
                B = w
                break
        return _ContinuousGoSession(self, space_id, m, ix, et_tuple, B)

    def continuous_results(self, space_id: int, m: CsrMirror,
                           queries: List[_GoQuery], reduces,
                           vs_lists, et_tuple: Tuple[int, ...]):
        """Post-frontier half for a leave cohort: COUNT riders fold the
        cached degree vector over their frontier, the rest assemble
        their ``_dst`` rows.  results[i] is (columns, rows)."""
        results: List[object] = [None] * len(queries)
        count_idx = [i for i, red in enumerate(reduces)
                     if red is not None and red[0] == "count"]
        other_idx = [i for i, red in enumerate(reduces)
                     if not (red is not None and red[0] == "count")]
        if count_idx:
            folded = self._count_results(
                m, [vs_lists[i] for i in count_idx], et_tuple)
            for j, i in enumerate(count_idx):
                results[i] = folded[j]
            with self._lock:
                self.stats["go_reduced"] += len(count_idx)
        if other_idx:
            sub = self._assemble_results(
                m, [queries[i] for i in other_idx],
                [vs_lists[i] for i in other_idx], et_tuple)
            for j, i in enumerate(other_idx):
                results[i] = sub[j]
        return results

    def _count_results(self, m: CsrMirror, vs_lists,
                       et_tuple: Tuple[int, ...]):
        """Per-query COUNT(*) from the fetched frontier lists folded
        through the cached per-vertex degree vector."""
        deg = self._deg_host(m, et_tuple)
        return [(["__count__"], [[int(deg[vs].sum()) if len(vs) else 0]])
                for vs in vs_lists]

    def _assemble_results(self, m: CsrMirror, queries: List[_GoQuery],
                          vs_lists, et_tuple: Tuple[int, ...]):
        """``_dst`` rows per query: one vectorized candidate pass for
        the cohort, split back per query."""
        cand, _qseg, qbounds = self._frontier_edges_multi(m, vs_lists,
                                                          et_tuple)
        dst = m.vids[m.edge_dst[cand]].tolist()
        return [([q.column], [[v] for v in dst[qbounds[g]:qbounds[g + 1]]])
                for g, q in enumerate(queries)]

    def _deg_host(self, m: CsrMirror, et_tuple: Tuple[int, ...]
                  ) -> np.ndarray:
        """int64[n]: per-vertex final-hop candidate-edge count over the
        OVER set, cached per (mirror, OVER)."""
        cache = getattr(m, "_deg_cache", None)
        if cache is None:
            cache = m._deg_cache = {}
        deg = cache.get(et_tuple)
        if deg is None:
            if len(cache) >= 8:
                cache.clear()
            mask = self._etype_edge_mask(m, et_tuple)
            deg = np.bincount(m.edge_src[mask], minlength=m.n) \
                .astype(np.int64)
            cache[et_tuple] = deg
        return deg

    def _note_fetch(self, arr: np.ndarray, waited_s: float) -> None:
        """Account the bytes one resolver pulled off the device and the
        seconds it waited for them."""
        with self._lock:
            self.stats["fetch_bytes"] += int(arr.nbytes)
            self.stats["fetch_wait_s"] += waited_s

    # -------------------------------------------------- final-hop edges
    @staticmethod
    def _etype_edge_mask(m: CsrMirror,
                         et_tuple: Tuple[int, ...]) -> np.ndarray:
        """bool[m]: edge etype in the OVER set, cached per mirror."""
        cache = getattr(m, "_etype_mask_cache", None)
        if cache is None:
            cache = m._etype_mask_cache = {}
        mask = cache.get(et_tuple)
        if mask is None:
            if len(cache) >= 8:   # each entry is O(m) — bound the memory
                cache.clear()
            mask = np.isin(m.edge_etype,
                           np.asarray(et_tuple, dtype=np.int32))
            cache[et_tuple] = mask
        return mask

    def _frontier_edges_multi(self, m: CsrMirror, vs_lists,
                              et_tuple: Tuple[int, ...]):
        """Batched candidate assembly: per-query frontier vertex lists
        -> (edge idx concat, per-edge query segment, per-query bounds),
        walking only the frontier vertices' CSR row slices."""
        nq = len(vs_lists)
        vq_counts = np.fromiter((len(v) for v in vs_lists), np.int64,
                                count=nq)
        if vq_counts.sum() == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(nq + 1, np.int64))
        vs = np.concatenate([np.asarray(v, np.int64) for v in vs_lists])
        vq = np.repeat(np.arange(nq, dtype=np.int64), vq_counts)
        starts = m.row_ptr[vs].astype(np.int64)
        counts = (m.row_ptr[vs + 1].astype(np.int64) - starts)
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(nq + 1, np.int64))
        if nq == 1 and total * 5 >= m.m:
            # saturated single frontier: one flat bool gather over all m
            # edges beats per-row index assembly
            frontier = np.zeros(m.n, dtype=bool)
            frontier[vs] = True
            idx = np.nonzero(frontier[m.edge_src]
                             & self._etype_edge_mask(m, et_tuple))[0]
            qseg = np.zeros(len(idx), np.int64)
            return idx, qseg, np.searchsorted(qseg, np.arange(nq + 1))
        nz = counts > 0
        s2, c2, q2 = starts[nz], counts[nz], vq[nz]
        # multi-range arange: global position -> within-range offset +
        # range start, fully vectorized
        excl = np.concatenate(([0], np.cumsum(c2)[:-1]))
        idx = np.repeat(s2 - excl, c2) + np.arange(total, dtype=np.int64)
        qseg = np.repeat(q2, c2)
        keep = self._etype_edge_mask(m, et_tuple)[idx]
        idx, qseg = idx[keep], qseg[keep]
        return idx, qseg, np.searchsorted(qseg, np.arange(nq + 1))


# ================================================ continuous dispatch
class _ContinuousGoSession:
    """Resident device state of ONE continuous stream: the packed
    frontier pair (exact-depth frontier ``fp`` + UPTO union ``accp``)
    for a (space, OVER set) lane batch, advanced one hop per tick, plus
    the spare buffer the hop writes into (the two frontier buffers
    ping-pong where the reference donated).

    Owned by the stream's single pump thread, so it carries no lock.
    Every op is enqueued on the pump thread's current CUDA stream and
    returns before the card finishes; the only host wait is the extract
    resolver's event, which the pump forces after the next hop is
    enqueued (the overlap of host assembly with device compute).

    In place: join and clear write both carriers, the hop writes
    ``accp`` and the spare; extract reads the pair into a fresh buffer.
    """

    def __init__(self, rt: TorchQueryRuntime, space_id: int, m: CsrMirror,
                 ix: EllIndex, et_tuple: Tuple[int, ...], B: int):
        self.rt = rt
        self.space_id = space_id
        self.m = m
        self.ix = ix
        self.et_tuple = et_tuple
        self.B = B                          # lane count (width rung)
        self.W = lanes_width(B)
        self.device = rt.device
        self.tables = rt._device_tables(m, ix)
        self.eslot, self.hrows = rt._hub_merge_dev(m, ix)
        shape = (ix.n_rows + 1, self.W)
        self.fp = torch.zeros(shape, dtype=torch.uint8, device=self.device)
        self.accp = torch.zeros_like(self.fp)
        self._spare = torch.empty_like(self.fp)

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def join(self, joiners) -> None:
        """Set the arrivals' start bits in their lanes: ``joiners`` is
        [(lane, start_vids)].  Unmappable vids drop; (row, lane) pairs
        are deduped per lane so each bit lands on a zero bit."""
        vids = [np.asarray(list(v), np.int64) for _lane, v in joiners]
        lanes = np.repeat(np.asarray([lane for lane, _ in joiners],
                                     np.int64),
                          [len(v) for v in vids])
        if not len(lanes):
            return
        d = self.m.to_dense(np.concatenate(vids)).astype(np.int64)
        ok = d >= 0
        # one (lane, vertex) pair per bit, whatever the start list repeats
        key = np.unique(lanes[ok] * (self.m.n + 1) + d[ok])
        S = len(key)
        if S == 0:
            return                          # empty starts stay zero
        lane_k, d_k = np.divmod(key, self.m.n + 1)
        Sp = max(8, 1 << (S - 1).bit_length())   # padded like the reference
        rows_p = np.full(Sp, self.ix.n_rows, np.int32)   # pad row
        words_p = np.zeros(Sp, np.int32)
        vals_p = np.zeros(Sp, np.uint8)          # zero: no-op
        rows_p[:S] = self.ix.perm[d_k]
        words_p[:S] = lane_k >> 3
        vals_p[:S] = np.left_shift(1, lane_k & 7)
        ell_ops.lane_join(self.fp, self.accp, self._up(rows_p),
                          self._up(words_p), self._up(vals_p))

    def hop(self) -> None:
        """Advance every seated lane one hop; ``accp`` unions the new
        frontier (exact-depth lanes never read it)."""
        out, _ = ell_ops.go_hop(self.fp, self.accp, self._spare,
                                self.tables, self.eslot, self.hrows,
                                self.et_tuple)
        self._spare, self.fp = self.fp, out

    def extract(self, leavers):
        """Gather the leaving lanes' word columns (UPTO lanes read the
        accumulator) and start their copy to the host; returns a
        zero-arg resolver -> per-leaver ascending old-dense-id frontier
        arrays.  Call the resolver AFTER enqueueing the next hop."""
        pair_ix: Dict[Tuple[int, bool], int] = {}
        for lane, upto in leavers:
            pair_ix.setdefault((lane >> 3, bool(upto)), len(pair_ix))
        np_pairs = len(pair_ix)
        P = max(8, 1 << (np_pairs - 1).bit_length())
        words_p = np.zeros(P, np.int32)
        sel_p = np.zeros(P, np.uint8)
        for (word, upto), j in pair_ix.items():
            words_p[j] = word
            sel_p[j] = 1 if upto else 0
        out = torch.empty((self.ix.n_rows + 1, P), dtype=torch.uint8,
                          device=self.device)
        ell_ops.lane_extract(self.fp, self.accp, self._up(words_p),
                             self._up(sel_p), out)
        event = None
        if self.device.type == "cuda":
            host = torch.empty(out.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(out, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = out
        cols_of = [pair_ix[(lane >> 3, bool(upto))]
                   for lane, upto in leavers]
        inv, n = self.ix.inv, self.ix.n
        rt = self.rt

        def resolve():
            t0 = time.perf_counter()
            if event is not None:
                event.synchronize()
            waited = time.perf_counter() - t0
            cols = host.numpy()                 # [R1, P] uint8, P % 8 == 0
            rt._note_fetch(cols[:, :np_pairs], waited)
            # one pass finds the real rows with any bit set in the used
            # columns (read 8 at a time as uint64 words); per leaver,
            # those rows with its bit, mapped back to old dense ids.  The
            # reference gathers each whole column through perm instead:
            # the same ascending set at O(n) per leaver
            words64 = cols[:n].view(np.uint64)[:, :(np_pairs + 7) // 8]
            row_any = words64[:, 0].copy()
            for k in range(1, words64.shape[1]):
                row_any |= words64[:, k]
            live = np.flatnonzero(row_any)
            sub = cols[live]
            return [np.sort(inv[live[((sub[:, j] >> (lane & 7)) & 1) != 0]])
                    .astype(np.int64)
                    for (lane, _upto), j in zip(leavers, cols_of)]

        return resolve

    def clear(self, lanes) -> None:
        """Zero the freed lanes' bits in both carriers; the ledger hands
        the lanes out again only after this op is enqueued (stream
        order makes the next join's bits land on zeros)."""
        keep = np.full(self.W, 0xFF, np.uint8)
        for lane in lanes:
            keep[lane >> 3] &= np.uint8(0xFF ^ (1 << (lane & 7)))
        ell_ops.lane_clear(self.fp, self.accp, self._up(keep))
