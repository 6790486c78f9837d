"""Per-space CSR mirror — the counterpart of ``nebula_tpu/tpu/csr.py``.

``build_mirror`` folds a space's KV parts into a ``CsrMirror`` with the
reference's per-row builder (``_build_mirror_slow``, ``csr.py:751-933``;
the vectorized bulk builder waits for a later slice).  The write path's
host half follows it: ``build_delta_mirror`` folds a window of
committed edge events into an overlay, ``absorb_overlay`` splices it
into the next generation's CSR (``_merge_edge_cols`` and
``_refinalize_numeric`` for the columns), and ``plan_vertex_events`` /
``commit_vertex_plan`` apply vertex-row writes in place, values first
and valid bits last (``csr.py:247-725``).

``mirror_from_edges`` builds the same arrays from an edge list (with
optional edge and vertex property columns), and
``mirror_from_reference`` takes them as the reference computed them,
property columns included.

Property columns (``Column``, ``csr.py:70-210``) are re-encoded into
order-preserving device spaces as the reference does: strings become
codes into a sorted per-column dictionary, int columns int32 when the
value range fits, else float32 when exactly representable, else the
column is marked uncompilable and a WHERE touching it declines.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from ..codec.rows import RowReader
from ..common.clock import now_s
from ..common.keys import KeyUtils
from ..interface.common import Schema, SupportedType


def _now_s() -> float:
    return now_s()


_NO_ABSORB = object()   # Column.absorb_form: "this write needs a rebuild"


def _ttl_expiry(reader: RowReader):
    """Absolute expiry time (seconds) of a row under its schema's TTL, or
    None when the schema has no TTL / the column is unusable
    (``csr.py:52``)."""
    prop = reader.schema.schema_prop
    if not prop.ttl_col or not prop.ttl_duration:
        return None
    try:
        base = reader.get(prop.ttl_col)
    except KeyError:
        return None
    if not isinstance(base, (int, float)) or isinstance(base, bool):
        return None
    return base + prop.ttl_duration


class _DictRaw:
    """Row -> string view of a dictionary-encoded column built from
    codes (``mirror_from_edges``), standing in for the per-row string
    list the reference keeps in ``Column.raw``."""

    __slots__ = ("codes", "dictionary")

    def __init__(self, codes: np.ndarray, dictionary: np.ndarray):
        self.codes = codes
        self.dictionary = dictionary

    def __getitem__(self, i):
        return self.dictionary[self.codes[i]]


class Column:
    """One columnar property: numeric array or dictionary-encoded strings.

    ``values`` is aligned to the edge array (edge props) or to the dense
    vertex array (tag props).  ``valid`` marks rows that actually carry the
    column (a vertex may lack the tag; an edge row written under an older
    schema version may miss appended columns).
    """

    __slots__ = ("name", "stype", "values", "valid", "dictionary",
                 "device_ok", "raw", "_int32_ok")

    def __init__(self, name: str, stype: SupportedType, size: int):
        self.name = name
        self.stype = stype
        self.valid = np.zeros(size, dtype=bool)
        self.dictionary: Optional[np.ndarray] = None  # sorted unique strings
        self.device_ok = True
        self.raw = None
        self._int32_ok: Optional[bool] = None   # lazily cached: int64
        # values all int32-representable (device uses int32, else f32)
        if stype == SupportedType.STRING:
            self.raw = [""] * size          # filled then dict-encoded
            self.values = None
        elif stype in (SupportedType.FLOAT, SupportedType.DOUBLE):
            self.values = np.zeros(size, dtype=np.float64)
        elif stype == SupportedType.BOOL:
            self.values = np.zeros(size, dtype=bool)
        else:  # INT / VID / TIMESTAMP
            self.values = np.zeros(size, dtype=np.int64)

    @staticmethod
    def numeric_device_ok(values: np.ndarray) -> bool:
        """The device-representability decision for a numeric column's
        values: int64 must fit int32 or round-trip float32 exactly (the
        device compares in float32, and CPU-float64 vs device-float32
        comparisons could otherwise disagree at the boundary); float64
        must round-trip float32 exactly."""
        if values.dtype == np.int64 and len(values):
            lo, hi = int(values.min()), int(values.max())
            if not (-2**31 < lo and hi < 2**31):
                as32 = values.astype(np.float32)
                return bool(np.array_equal(as32.astype(np.int64),
                                           values))
        elif values.dtype == np.float64 and len(values):
            as32 = values.astype(np.float32)
            return bool(np.array_equal(as32.astype(np.float64), values,
                                       equal_nan=True))
        return True

    def finalize(self) -> None:
        """Dictionary-encode strings; decide device representability."""
        if self.stype == SupportedType.STRING:
            arr = np.asarray(self.raw, dtype=object)
            self.dictionary, codes = np.unique(
                arr.astype(str), return_inverse=True)
            self.values = codes.astype(np.int32)
            self.raw = arr
            return
        if not Column.numeric_device_ok(self.values):
            self.device_ok = False

    def device_values(self):
        """int32/float32/bool view for the device (codes for strings)."""
        if self.stype == SupportedType.STRING:
            return self.values                      # int32 codes
        if self.values.dtype == np.int64:
            if self._is_int32_representable():
                return self.values.astype(np.int32)
            return self.values.astype(np.float32)
        if self.values.dtype == np.float64:
            return self.values.astype(np.float32)
        return self.values

    def _is_int32_representable(self) -> bool:
        """Does the device serve this int64 column as int32 (vs the
        float32-exact fallback)?  Cached."""
        if self._int32_ok is None:
            if len(self.values):
                lo, hi = int(self.values.min()), int(self.values.max())
                self._int32_ok = -2**31 < lo and hi < 2**31
            else:
                self._int32_ok = True
        return self._int32_ok

    def absorb_form(self, v):
        """The storable form of an in-place write of ``v`` to this
        column, or _NO_ABSORB when the write would change how the
        device represents the column (the single source of the same
        int32/float32 rules device_values serves by — keep in sync):

          * strings: only values already in the dictionary (growing it
            re-encodes every row's code, torn for racing readers) —
            returns (raw, code);
          * int64 on the int32 path: v must fit int32;
          * int64 on the float32-exact path / float64: v must
            round-trip through float32, or device and CPU comparisons
            diverge at the boundary."""
        if self.stype == SupportedType.STRING:
            if self.dictionary is None:
                return _NO_ABSORB
            s = v if isinstance(v, str) else str(v)
            pos = int(np.searchsorted(self.dictionary, s))
            if pos >= len(self.dictionary) \
                    or str(self.dictionary[pos]) != s:
                return _NO_ABSORB       # new string: dictionary grows
            return (s, pos)
        try:
            if self.values.dtype == np.int64 and self.device_ok:
                if self._is_int32_representable():
                    if not (-2**31 < int(v) < 2**31):
                        return _NO_ABSORB
                elif int(np.int64(np.float32(v))) != int(v):
                    return _NO_ABSORB
            if self.values.dtype == np.float64 and self.device_ok:
                if float(np.float64(np.float32(v))) != float(v):
                    return _NO_ABSORB
        except (OverflowError, ValueError):
            # e.g. int64-max values where np.float32 rounds UP to 2^63
            # and the int64() round-trip overflows (raises on NumPy 2):
            # any conversion failure means "can't absorb", never an
            # exception escaping into the live query's mirror() call
            return _NO_ABSORB
        return v

    def host_value(self, i: int):
        """Python value at row i (for result rows)."""
        if self.stype == SupportedType.STRING:
            return str(self.raw[i])
        v = self.values[i]
        if self.stype == SupportedType.BOOL:
            return bool(v)
        if self.values.dtype == np.float64:
            return float(v)
        return int(v)


class CsrMirror:
    """Per-space CSR over a dense vertex space.

    Edge arrays are sorted by (src_dense, etype, rank, dst) — the KV scan
    order — and carry BOTH directions (the reverse edge is stored under
    -etype), so ``GO ... REVERSELY`` is an etype-sign flip.  Device-side
    caches (the ELL index, its device tables, the hub-merge arrays, the
    fused route's edge arrays and columns) hang off the mirror as
    attributes, exactly as the reference caches them.  Property columns
    are keyed by the row's signed etype, ``(etype, prop)``, and by
    ``(tag_id, prop)``; ``has_tag`` maps a tag id to bool[n].
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
        self.edge_cols: Dict[Tuple[int, str], Column] = {}
        self.vertex_cols: Dict[Tuple[int, str], Column] = {}
        self.has_tag: Dict[int, np.ndarray] = {}
        self.build_version = -1
        # earliest future TTL expiry among mirrored rows (seconds), or
        # None; the runtime rebuilds once it passes
        self.expires_at_s = None

    def note_expiry(self, exp_s: float) -> None:
        if self.expires_at_s is None or exp_s < self.expires_at_s:
            self.expires_at_s = exp_s

    def expired_now(self) -> bool:
        return self.expires_at_s is not None and _now_s() >= self.expires_at_s

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


def check_row_index(edge_src: np.ndarray, row_ptr: np.ndarray) -> None:
    """Raise unless ``row_ptr`` is the CSR row index of ``edge_src``: 0
    first, the edge count last, never falling, and the edges of row v
    (``[row_ptr[v], row_ptr[v + 1])``) all from source v, so the edge
    list is sorted by source.  The card's edge-list hop walks those
    rows and trusts this."""
    rp = np.asarray(row_ptr, np.int64)
    if len(rp) == 0 or rp[0] != 0 or rp[-1] != len(edge_src) \
            or (np.diff(rp) < 0).any():
        raise ValueError("row_ptr is not a CSR row index of the edges")
    if not np.array_equal(np.repeat(np.arange(len(rp) - 1), np.diff(rp)),
                          edge_src):
        raise ValueError("the edge rows are not sorted by source as "
                         "row_ptr says")


def check_rows(m: CsrMirror) -> None:
    """``check_row_index`` of a mirror.  Every function that makes a
    mirror keeps its rows so by its (src, etype, rank, dst) sort and
    ``row_ptr`` from the sorted sources' counts;
    ``mirror_from_reference`` checks the arrays it is given."""
    if len(m.row_ptr) != m.n + 1:
        raise ValueError("row_ptr is not a CSR row index of the edges")
    check_row_index(m.edge_src, m.row_ptr)


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


def _row_order(src_d, e_all, r_all, dst_d, n: int) -> np.ndarray:
    """Indices of the rows to keep, in (src, etype, rank, dst) order; of
    a repeated key the LAST occurrence is kept, as a later write of the
    same KV key wins (the property columns follow these rows)."""
    vb = max(int(n - 1).bit_length(), 1)
    e_lo = int(e_all.min())
    eb = max((int(e_all.max()) - e_lo).bit_length(), 1)
    if not r_all.any() and 2 * vb + eb <= 63:
        key = (src_d << (vb + eb)) | ((e_all - e_lo) << vb) | dst_d
        order = np.argsort(key, kind="stable")
        k = key[order]
        last = np.ones(len(k), dtype=bool)
        last[:-1] = k[1:] != k[:-1]
        return order[last]
    order = np.lexsort((np.arange(len(src_d)), dst_d, r_all, e_all, src_d))
    s_, e_, r_, d_ = (src_d[order], e_all[order], r_all[order],
                      dst_d[order])
    last = np.ones(len(order), dtype=bool)
    last[:-1] = ((s_[1:] != s_[:-1]) | (e_[1:] != e_[:-1])
                 | (r_[1:] != r_[:-1]) | (d_[1:] != d_[:-1]))
    return order[last]


def _column(name: str, spec, rows: np.ndarray, valid: np.ndarray
            ) -> Column:
    """A finalized Column of ``len(rows)`` rows: ``spec`` is ``(stype,
    values)`` or, for strings, ``(SupportedType.STRING, codes,
    dictionary)`` (dictionary sorted and unique); row i takes input
    element ``rows[i]`` where ``valid[i]``.  As in the reference's
    build, an invalid string row holds "" (so "" joins the
    dictionary)."""
    stype = SupportedType(int(spec[0]))
    c = Column(name, stype, len(rows))
    c.valid = valid.copy()
    if stype == SupportedType.STRING:
        dictionary = np.asarray(spec[2]).astype(str)
        codes = np.zeros(len(rows), np.int32)
        codes[valid] = np.asarray(spec[1], np.int32)[rows[valid]]
        if not valid.all() and not (len(dictionary)
                                    and dictionary[0] == ""):
            dictionary = np.concatenate([[""], dictionary])
            codes[valid] += 1
        c.dictionary = dictionary
        c.values = codes
        c.raw = _DictRaw(codes, dictionary)
        return c
    vals = np.asarray(spec[1])
    c.values[valid] = vals[rows[valid]].astype(c.values.dtype)
    c.finalize()
    return c


def mirror_from_edges(src_vids, dst_vids, etype, rank=None,
                      space_id: int = 0, edge_props=None,
                      vertex_props=None) -> CsrMirror:
    """What ``build_mirror`` folds from KV for an edge list.

    ``src_vids``/``dst_vids`` are vid values, ``etype`` the (positive)
    edge type per edge or one int for all, ``rank`` per edge (default
    0).  Both directions are stored (the reverse under ``-etype``), a
    repeated (src, etype, rank, dst) keeps one row as the KV key does
    (the last one given), rows sort by (src_dense, etype, rank, dst),
    and ``vids`` is the sorted unique set of endpoints and tagged
    vertices.

    ``edge_props`` is ``{etype: {prop: spec}}`` with each spec's values
    aligned to the input edges (``_column``); both directions of an
    edge of that etype carry them, under ``(etype, prop)`` and
    ``(-etype, prop)``.  ``vertex_props`` is ``{tag_id: (vids,
    {prop: spec})}`` with values aligned to ``vids``, the vertices that
    carry the tag."""
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
    vertex_props = dict(vertex_props or {})
    m = CsrMirror(space_id)
    tagged = [np.asarray(v, np.int64) for v, _p in vertex_props.values()]
    m.vids = np.unique(np.concatenate([src, dst] + tagged))
    m.n = len(m.vids)
    if k:
        s_all = np.concatenate([src, dst])
        d_all = np.concatenate([dst, src])
        e_all = np.concatenate([et, -et])
        r_all = np.concatenate([rk, rk])
        src_d = _dense_index(m.vids, s_all)
        dst_d = _dense_index(m.vids, d_all)
        keep = _row_order(src_d, e_all, r_all, dst_d, m.n)
        src_d, e_all = src_d[keep], e_all[keep]
        r_all, dst_d = r_all[keep], dst_d[keep]
        origin = keep % k                # the input edge of each row
        for et_p, props in (edge_props or {}).items():
            for sign in (1, -1):
                on = e_all == sign * int(et_p)
                for prop, spec in props.items():
                    m.edge_cols[(sign * int(et_p), prop)] = _column(
                        prop, spec, origin, on)
        m.edge_src = src_d.astype(np.int32)
        m.edge_dst = dst_d.astype(np.int32)
        m.edge_etype = e_all.astype(np.int32)
        m.edge_rank = r_all.astype(np.int64)
        m.m = len(m.edge_src)
    for tag_id, (vids, props) in vertex_props.items():
        vids = np.asarray(vids, np.int64)
        where = np.full(m.n, -1, np.int64)
        where[_dense_index(m.vids, vids)] = np.arange(len(vids))
        on = where >= 0
        m.has_tag[int(tag_id)] = on
        for prop, spec in props.items():
            m.vertex_cols[(int(tag_id), prop)] = _column(
                prop, spec, np.maximum(where, 0), on)
    return _finish(m)


MIRROR_FIELDS = ("vids", "edge_src", "edge_dst", "edge_etype",
                 "edge_rank", "row_ptr")


def _carry_column(c) -> Column:
    """A port Column holding what the reference's Column holds."""
    out = Column(str(c.name), SupportedType(int(c.stype)), 0)
    out.valid = np.asarray(c.valid, bool).copy()
    out.values = None if c.values is None else np.asarray(c.values).copy()
    out.dictionary = None if c.dictionary is None \
        else np.asarray(c.dictionary).copy()
    out.raw = None if c.raw is None else np.asarray(c.raw,
                                                     dtype=object).copy()
    out.device_ok = bool(c.device_ok)
    return out


def mirror_from_reference(arrays: Mapping[str, np.ndarray],
                          space_id: Optional[int] = None,
                          edge_cols=None, vertex_cols=None, has_tag=None,
                          build_version: int = -1) -> CsrMirror:
    """A CsrMirror carrying the reference's arrays as they are: the
    ``MIRROR_FIELDS`` of a ``nebula_tpu`` CsrMirror, as numpy arrays
    (``space_id`` from the mapping when not given), and optionally its
    ``edge_cols`` / ``vertex_cols`` (each Column's stype, values,
    valid, dictionary, raw and device_ok), ``has_tag`` and
    ``build_version``.  Both packages then compute on identical
    state."""
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
    m.build_version = int(build_version)
    if len(m.row_ptr) != m.n + 1 or any(
            len(a) != m.m for a in (m.edge_dst, m.edge_etype,
                                    m.edge_rank)):
        raise ValueError("reference mirror arrays disagree in length")
    check_rows(m)
    m.edge_cols = {(int(k[0]), str(k[1])): _carry_column(c)
                   for k, c in (edge_cols or {}).items()}
    m.vertex_cols = {(int(k[0]), str(k[1])): _carry_column(c)
                     for k, c in (vertex_cols or {}).items()}
    m.has_tag = {int(t): np.asarray(a, bool).copy()
                 for t, a in (has_tag or {}).items()}
    for key, c in m.edge_cols.items():
        if len(c.valid) != m.m:
            raise ValueError(f"edge column {key} has {len(c.valid)} rows, "
                             f"not {m.m}")
    for key, c in m.vertex_cols.items():
        if len(c.valid) != m.n:
            raise ValueError(f"vertex column {key} has {len(c.valid)} "
                             f"rows, not {m.n}")
    return m


def iter_leader_parts(space_id: int, stores):
    """Yield (store, part_id) for every part this scan must fold: parts
    sorted per store, leaders only, first claiming store wins (a stale
    leadership claim mid-transfer must not fold a part twice).  The
    SINGLE source of the part-selection rule shared by the per-row and
    bulk mirror builders — their bit-identical contract depends on
    scanning the same part set."""
    folded: set = set()
    for store in stores:
        for part in sorted(store.part_ids(space_id)):
            if part in folded:
                continue
            p = store.part(space_id, part)
            if p is None or not p.is_leader():
                continue
            folded.add(part)
            yield store, part


def _scatter_bool(src: np.ndarray, remap: np.ndarray,
                  n: int) -> np.ndarray:
    out = np.zeros(n, dtype=bool)
    out[remap] = src
    return out


def _base_edge_index(base: CsrMirror, src_d: int, et: int, rank: int,
                     dst_d: int) -> int:
    """Base edge row for one identity, or -1.  Row slices are tiny
    (one vertex's out-edges), so the linear probe is fine at delta
    scale."""
    lo, hi = int(base.row_ptr[src_d]), int(base.row_ptr[src_d + 1])
    for e in range(lo, hi):
        if int(base.edge_etype[e]) == et \
                and int(base.edge_rank[e]) == rank \
                and int(base.edge_dst[e]) == dst_d:
            return e
    return -1


def build_delta_mirror(base: CsrMirror, events, schema_man,
                       space_id: int) -> Optional[CsrMirror]:
    """Fold committed edge mutation EVENTS into a small overlay mirror
    over ``base`` (SURVEY §7 hard part (a): mutations without the O(m)
    rebuild).  Events are the store's typed delta stream
    (kvstore/store.py delta_since): ("put", key, value) inserts AND
    in-place updates, ("del", identity32) whole-edge deletes.

    The overlay carries, beyond its own appended rows:
      * ``base_dead``   — sorted base edge rows superseded by an update
                          or killed by a delete (candidate assembly
                          excludes them);
      * ``extra_vids``  — endpoint vids the base doesn't know (the
                          overlay's dense space grows to the sorted
                          union; ``remap_from_base`` translates base
                          dense ids);
      * ``has_deletes`` — a base edge died with no same-identity
                          replacement, which changes reachability: the
                          runtime must not run multi-hop frontier
                          advances over the base ELL then (it forces
                          the rebuild for those queries only).

    Returns None — full rebuild — for TTL'd rows and unresolvable
    schemas.  Same-identity overwrite ordering assumes the forward
    wall clock that inverted-timestamp versioning itself relies on.
    """
    sm = schema_man
    # collapse in commit order: the last event per edge identity wins
    # (vertex events are applied in place by plan_vertex_events + commit_vertex_plan, not
    # through the edge overlay)
    final: Dict[Tuple[int, int, int, int], Optional[bytes]] = {}
    for ev in events:
        if ev[0] == "vput":
            continue
        if ev[0] == "put":
            _part, src, et, rank, dst, _ver = KeyUtils.parse_edge(ev[1])
            final[(src, et, rank, dst)] = ev[2]
        else:       # ("del", identity32): all versions of one edge
            _part, src, et, rank, dst, _ = KeyUtils.parse_edge(
                ev[1] + b"\x00" * 8)     # pad the absent version field
            final[(src, et, rank, dst)] = None

    puts = {k: v for k, v in final.items() if v is not None}
    dels = [k for k, v in final.items() if v is None]

    # ---- extended dense vid space (new endpoint vids) ----------------
    put_idents = list(puts.keys())
    src_vids = np.asarray([i[0] for i in put_idents], dtype=np.int64)
    dst_vids = np.asarray([i[3] for i in put_idents], dtype=np.int64)
    known_src = base.to_dense(src_vids)
    known_dst = base.to_dense(dst_vids)
    extra = np.unique(np.concatenate([
        src_vids[known_src < 0] if len(put_idents) else
        np.zeros(0, np.int64),
        dst_vids[known_dst < 0] if len(put_idents) else
        np.zeros(0, np.int64)]))

    d = CsrMirror(space_id)
    d.base_dead = np.zeros(0, dtype=np.int64)
    d.extra_vids = extra
    d.remap_from_base = None
    d.has_deletes = False
    if len(extra) == 0:
        d.vids = base.vids             # shared dense-id space
        d.n = base.n
        d.vertex_cols = base.vertex_cols   # vertex side unchanged by
        d.has_tag = base.has_tag           # edge mutations
    else:
        # re-seat the shared vertex side in the grown dense space.
        # Vectorized scatters only (no per-row Python, no re-encode:
        # dictionaries and device_ok carry over — added rows are
        # invalid, never read), and cached on the base keyed by the
        # extra set: absorptions repeat over the accumulated event
        # list, and this runs under the runtime lock
        ext_key = extra.tobytes()
        cached = getattr(base, "_ext_vertex_cache", None)
        if cached is not None and cached[0] == ext_key:
            d.vids, d.n, d.remap_from_base, d.vertex_cols, d.has_tag = \
                cached[1:]
        else:
            d.vids = np.unique(np.concatenate([base.vids, extra]))
            d.n = len(d.vids)
            remap = np.searchsorted(d.vids, base.vids).astype(np.int32)
            d.remap_from_base = remap
            d.vertex_cols = {}
            for key, c in base.vertex_cols.items():
                nc = Column(c.name, c.stype, d.n)
                nc.valid[remap] = c.valid
                nc.device_ok = c.device_ok
                if c.raw is not None:
                    raw = np.empty(d.n, dtype=object)
                    raw[:] = ""
                    raw[remap] = np.asarray(c.raw, dtype=object)
                    nc.raw = raw
                    nc.dictionary = c.dictionary
                    codes = np.zeros(d.n, dtype=np.int32)
                    codes[remap] = c.values
                    nc.values = codes
                else:
                    nc.values[remap] = c.values
                d.vertex_cols[key] = nc
            d.has_tag = {t: _scatter_bool(flags_arr, remap, d.n)
                         for t, flags_arr in base.has_tag.items()}
            base._ext_vertex_cache = (ext_key, d.vids, d.n,
                                      d.remap_from_base, d.vertex_cols,
                                      d.has_tag)

    # ---- base rows superseded / deleted ------------------------------
    # (vectorized endpoint translation — known_src/known_dst already
    # cover the puts; one batch covers the dels.  The per-identity row
    # probe stays Python but walks only one vertex's slice each.)
    dead: List[int] = []
    for i, (src, et, rank, dst) in enumerate(put_idents):
        sd, dd = int(known_src[i]), int(known_dst[i])
        if sd < 0 or dd < 0:
            continue                    # brand-new edge: nothing to kill
        e = _base_edge_index(base, sd, et, rank, dd)
        if e >= 0:
            dead.append(e)              # in-place update: override
    if dels:
        del_sd = base.to_dense(
            np.asarray([k[0] for k in dels], dtype=np.int64))
        del_dd = base.to_dense(
            np.asarray([k[3] for k in dels], dtype=np.int64))
        for i, (src, et, rank, dst) in enumerate(dels):
            sd, dd = int(del_sd[i]), int(del_dd[i])
            if sd < 0 or dd < 0:
                continue                # deleting an unknown edge: no-op
            e = _base_edge_index(base, sd, et, rank, dd)
            if e >= 0:
                dead.append(e)
                d.has_deletes = True    # reachability changed
    d.base_dead = np.unique(np.asarray(dead, dtype=np.int64))

    m = len(put_idents)
    d.m = m
    if m == 0:
        d.row_ptr = np.zeros(d.n + 1, dtype=np.int32)
        return d
    src_d = d.to_dense(src_vids)
    dst_d = d.to_dense(dst_vids)
    etype_a = np.asarray([i[1] for i in put_idents], dtype=np.int32)
    rank_a = np.asarray([i[2] for i in put_idents], dtype=np.int64)
    order = np.lexsort((dst_d, rank_a, etype_a, src_d))
    d.edge_src = src_d[order].astype(np.int32)
    d.edge_dst = dst_d[order].astype(np.int32)
    d.edge_etype = etype_a[order]
    d.edge_rank = rank_a[order]

    cols: Dict[Tuple[int, str], Column] = {}
    for et in np.unique(d.edge_etype).tolist():
        schema = sm.get_edge_schema(space_id, abs(et), -1)
        if schema is None:
            return None
        for col in schema.columns:
            cols[(et, col.name)] = Column(col.name, col.type, m)
    vals = [puts[put_idents[j]] for j in order]
    for i, blob in enumerate(vals):
        if not blob:
            continue
        et = int(d.edge_etype[i])
        try:
            reader = RowReader.from_resolver(
                blob, lambda ver, _et=abs(et): sm.get_edge_schema(
                    space_id, _et, ver))
        except KeyError:
            return None
        if _ttl_expiry(reader) is not None:
            return None                # TTL rows need the rebuild path
        for cname in reader.schema.names():
            c = cols.get((et, cname))
            if c is None:
                continue
            try:
                v = reader.get(cname)
            except KeyError:
                continue
            if c.raw is not None:
                c.raw[i] = v if isinstance(v, str) else str(v)
            else:
                c.values[i] = v
            c.valid[i] = True
    for c in cols.values():
        c.finalize()
    d.edge_cols = cols
    counts = np.bincount(d.edge_src, minlength=d.n)
    d.row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return d


def _refinalize_numeric(c: Column) -> None:
    """Re-run finalize()'s device-representability decision on a
    MERGED numeric column: two individually device_ok sides can mix
    representation classes (base on the float32-exact path, overlay
    int32-representable but not float32-exact), and the merged column
    must re-earn its device_ok on the union of values — through the
    same Column.numeric_device_ok decision a fresh build uses."""
    c._int32_ok = None
    if c.device_ok and c.values is not None and len(c.values):
        c.device_ok = Column.numeric_device_ok(c.values)


def _merge_edge_cols(base: CsrMirror, d: CsrMirror, keep: np.ndarray,
                     order: np.ndarray,
                     m_new: int) -> Dict[Tuple[int, str], Column]:
    """Columnar half of absorb_overlay: splice overlay columns into
    the kept base rows and restore canonical order.  Dictionary-coded
    strings re-encode through the sorted UNION dictionary when the
    sides' dictionaries differ (codes stay order-preserving, so
    compiled comparisons keep translating); rows a side doesn't carry
    stay invalid."""
    kept = int(keep.sum())
    cols: Dict[Tuple[int, str], Column] = {}
    for key in set(base.edge_cols) | set(d.edge_cols):
        b = base.edge_cols.get(key)
        o = d.edge_cols.get(key)
        ref = b if b is not None else o
        c = Column.__new__(Column)
        c.name, c.stype = ref.name, ref.stype
        c.dictionary = None
        c.raw = None
        c._int32_ok = None
        c.device_ok = (b is None or b.device_ok) \
            and (o is None or o.device_ok)
        valid = np.zeros(m_new, dtype=bool)
        if b is not None:
            valid[:kept] = b.valid[keep]
        if o is not None:
            valid[kept:] = o.valid
        c.valid = valid[order]
        if ref.stype == SupportedType.STRING:
            raw = np.empty(m_new, dtype=object)
            raw[:] = ""
            if b is not None and b.raw is not None:
                raw[:kept] = np.asarray(b.raw, dtype=object)[keep]
            if o is not None and o.raw is not None:
                raw[kept:] = np.asarray(o.raw, dtype=object)
            c.raw = raw[order]
            dicts = [x.dictionary for x in (b, o)
                     if x is not None and x.dictionary is not None]
            same = len(dicts) == 2 and np.array_equal(dicts[0], dicts[1])
            codes = np.zeros(m_new, np.int32)
            if len(dicts) <= 1 or same:
                c.dictionary = dicts[0] if dicts else \
                    np.zeros(0, dtype=object)
                if b is not None:
                    codes[:kept] = b.values[keep]
                if o is not None:
                    codes[kept:] = o.values
            else:
                union = np.unique(np.concatenate(dicts))
                c.dictionary = union
                remap_b = np.searchsorted(union, b.dictionary)
                codes[:kept] = remap_b[b.values[keep]]
                remap_o = np.searchsorted(union, o.dictionary)
                codes[kept:] = remap_o[o.values]
            c.values = codes[order].astype(np.int32)
        else:
            vals = np.zeros(m_new, dtype=ref.values.dtype)
            if b is not None:
                vals[:kept] = b.values[keep]
            if o is not None:
                vals[kept:] = o.values
            c.values = vals[order]
            _refinalize_numeric(c)
        cols[key] = c
    return cols


def absorb_overlay(base: CsrMirror, d: CsrMirror) -> Optional[CsrMirror]:
    """Fold an edge overlay (build_delta_mirror) into a NEW CsrMirror
    — the host-CSR half of incremental delta absorption (the device
    half is ell.make_ell_absorb_kernel; docs/durability.md "The
    generation state machine").

    The vertex side (vids / vertex_cols / has_tag) is SHARED with the
    base: vertex writes commit in place (commit_vertex_plan) under the
    documented values-first/valid-last bounded-staleness stance.  The
    edge side is a vectorized splice — base rows minus the overlay's
    tombstones (base_dead), plus the overlay rows, restored to the
    canonical (src, etype, rank, dst) scan order every other builder
    produces — O(m) host memcpy, never a store re-scan.

    Returns None when the overlay grew the dense-id space
    (extra_vids: a vertex-plan change only the rebuild can serve)."""
    if len(getattr(d, "extra_vids", ())):
        return None
    keep = np.ones(base.m, dtype=bool)
    dead = getattr(d, "base_dead", None)
    if dead is not None and len(dead):
        keep[np.asarray(dead, dtype=np.int64)] = False
    out = CsrMirror(base.space_id)
    out.vids, out.n = base.vids, base.n
    out.vertex_cols = base.vertex_cols
    out.has_tag = base.has_tag
    out.expires_at_s = base.expires_at_s
    src = np.concatenate([base.edge_src[keep], d.edge_src])
    dst = np.concatenate([base.edge_dst[keep], d.edge_dst])
    et = np.concatenate([base.edge_etype[keep], d.edge_etype])
    rank = np.concatenate([base.edge_rank[keep], d.edge_rank])
    order = np.lexsort((dst, rank, et, src))
    out.edge_src = src[order].astype(np.int32)
    out.edge_dst = dst[order].astype(np.int32)
    out.edge_etype = et[order].astype(np.int32)
    out.edge_rank = rank[order]
    out.m = len(out.edge_src)
    out.edge_cols = _merge_edge_cols(base, d, keep, order, out.m)
    counts = np.bincount(out.edge_src, minlength=out.n)
    out.row_ptr = np.concatenate([[0], np.cumsum(counts)]) \
        .astype(np.int32)
    return out


def plan_vertex_events(base: CsrMirror, events, schema_man,
                       space_id: int):
    """Validate committed vertex-row writes ("vput" events) against the
    base mirror and return an apply plan for commit_vertex_plan — the
    vertex-side half of incremental maintenance.  NOTHING is mutated
    here: the caller commits the plan only after every other
    absorption step has succeeded, so no decline path can expose half
    of a commit batch.  Returns None ("do the full rebuild") for any
    write the in-place path can't reproduce exactly:

      * a vid or tag the base doesn't know (dense space / column set
        would change);
      * string values NOT already in the column's dictionary (growing
        or re-sorting a dictionary re-encodes every row's code, which
        a concurrently evaluating plan would read torn; writing an
        EXISTING value is a single-element code store, safe like the
        numeric case — this covers the common re-insert-row-to-update-
        one-field pattern);
      * TTL'd schemas (need expiry tracking);
      * values that break a column's device representability (the
        compiled plans assume the checked range).

    Numeric single-element stores are effectively atomic on the host;
    queries racing an absorption see either the old or the new value —
    the same bounded-staleness window every mirror refresh already has.
    """
    sm = schema_man
    # newest write per (vid, tag) wins (commit order)
    newest: Dict[Tuple[int, int], bytes] = {}
    for ev in events:
        if ev[0] != "vput":
            continue
        _part, vid, tag, _ver = KeyUtils.parse_vertex(ev[1])
        newest[(vid, tag)] = ev[2]
    plan = []        # (dense, tag, tag_cols, present | None)
    for (vid, tag), blob in newest.items():
        dense = int(base.to_dense([vid])[0])
        if dense < 0 or tag not in base.has_tag:
            return None
        tag_cols = {cname: c for (t, cname), c in base.vertex_cols.items()
                    if t == tag}
        if not blob:
            plan.append((dense, tag, tag_cols, None))
            continue
        try:
            reader = RowReader.from_resolver(
                blob, lambda ver, _t=tag: sm.get_tag_schema(space_id, _t,
                                                            ver))
        except KeyError:
            return None
        if _ttl_expiry(reader) is not None:
            return None
        present: Dict[str, object] = {}
        for cname in reader.schema.names():
            c = tag_cols.get(cname)
            if c is None:
                return None             # schema drift: rebuild
            try:
                present[cname] = reader.get(cname)
            except KeyError:
                pass
        for cname, v in list(present.items()):
            absorbed = tag_cols[cname].absorb_form(v)
            if absorbed is _NO_ABSORB:
                return None
            present[cname] = absorbed
        plan.append((dense, tag, tag_cols, present))
    return plan


def commit_vertex_plan(base: CsrMirror, plan) -> None:
    """Apply a plan_vertex_events plan IN PLACE.  Values first,
    validity flags LAST: a reader racing the absorption then sees each
    column as either its old state (stale valid bit) or its new state
    (fresh value + fresh bit) — never valid=True over a not-yet-written
    value."""
    for dense, tag, tag_cols, present in plan:
        if present is None:
            # the newest committed row is empty: it REPLACES the old
            # one, so no column survives (rebuild semantics —
            # build_mirror's first-wins dedup never reads older rows)
            for c in tag_cols.values():
                c.valid[dense] = False
        else:
            for cname, v in present.items():
                c = tag_cols[cname]
                if c.stype == SupportedType.STRING:
                    s, code = v
                    c.raw[dense] = s
                    c.values[dense] = code
                else:
                    c.values[dense] = v
            for cname, c in tag_cols.items():
                c.valid[dense] = cname in present
        base.has_tag[tag][dense] = True
    # grown-space vertex copies (extras cache) are now stale
    if plan and getattr(base, "_ext_vertex_cache", None) is not None:
        base._ext_vertex_cache = None


def build_mirror(space_id: int, stores, schema_man) -> CsrMirror:
    """Scan every part of ``space_id`` across the given stores and fold
    the KV ranges into a CsrMirror (``csr.py:751``).  The reference
    first tries its vectorized bulk builder (``csr_bulk.py`` and the
    native batch codec, not ported); the port always runs the per-row
    builder, which the reference keeps as the bulk path's oracle."""
    return _build_mirror_slow(space_id, stores, schema_man)


def _build_mirror_slow(space_id: int, stores, schema_man) -> CsrMirror:
    """The per-row reference builder (see build_mirror)."""
    sm = schema_man
    edge_schema_cache: Dict[Tuple[int, int], Optional[Schema]] = {}
    tag_schema_cache: Dict[Tuple[int, int], Optional[Schema]] = {}

    def edge_schema(etype: int, ver: int) -> Optional[Schema]:
        key = (etype, ver)
        if key not in edge_schema_cache:
            edge_schema_cache[key] = sm.get_edge_schema(
                space_id, abs(etype), ver)
        return edge_schema_cache[key]

    def tag_schema(tag_id: int, ver: int) -> Optional[Schema]:
        key = (tag_id, ver)
        if key not in tag_schema_cache:
            tag_schema_cache[key] = sm.get_tag_schema(space_id, tag_id, ver)
        return tag_schema_cache[key]

    # ---- pass 1: scan KV, dedup multi-version, collect raw tuples ----
    # keys sort latest-version-first within (rank, dst) / (vid, tag), so
    # dedup is "first wins" in scan order.
    edges: List[Tuple[int, int, int, int, bytes]] = []  # src,etype,rank,dst,val
    verts: List[Tuple[int, int, bytes]] = []            # vid,tag,val
    seen_edge_prev: Optional[Tuple[int, int, int, int]] = None
    seen_vert_prev: Optional[Tuple[int, int]] = None
    for store, part in iter_leader_parts(space_id, stores):
        seen_edge_prev = seen_vert_prev = None
        for key, val in store.prefix(space_id, part,
                                     KeyUtils.part_prefix(part)):
            if KeyUtils.is_edge(key):
                _, src, et, rank, dst, _ = KeyUtils.parse_edge(key)
                ident = (src, et, rank, dst)
                if ident == seen_edge_prev:
                    continue          # older version of same edge
                seen_edge_prev = ident
                edges.append((src, et, rank, dst, val))
            elif KeyUtils.is_vertex(key):
                _, vid, tag, _ = KeyUtils.parse_vertex(key)
                ident = (vid, tag)
                if ident == seen_vert_prev:
                    continue
                seen_vert_prev = ident
                verts.append((vid, tag, val))

    mirror = CsrMirror(space_id)

    # ---- dense vertex space ------------------------------------------
    vid_parts = [np.asarray([v for v, _, _ in verts], dtype=np.int64)]
    if edges:
        e_src = np.asarray([e[0] for e in edges], dtype=np.int64)
        e_dst = np.asarray([e[3] for e in edges], dtype=np.int64)
        vid_parts += [e_src, e_dst]
    all_vids = np.concatenate(vid_parts) if vid_parts else \
        np.zeros(0, dtype=np.int64)
    mirror.vids = np.unique(all_vids)
    mirror.n = len(mirror.vids)
    n = mirror.n

    # ---- edge arrays (sort by (src_dense, etype, rank, dst)) ---------
    m = len(edges)
    mirror.m = m
    if m:
        src_d = np.searchsorted(mirror.vids, e_src).astype(np.int32)
        dst_d = np.searchsorted(mirror.vids, e_dst).astype(np.int32)
        etype_a = np.asarray([e[1] for e in edges], dtype=np.int32)
        rank_a = np.asarray([e[2] for e in edges], dtype=np.int64)
        order = np.lexsort((dst_d, rank_a, etype_a, src_d))
        mirror.edge_src = src_d[order]
        mirror.edge_dst = dst_d[order]
        mirror.edge_etype = etype_a[order]
        mirror.edge_rank = rank_a[order]

        # ---- edge prop columns ---------------------------------------
        etypes_present = np.unique(mirror.edge_etype)
        cols: Dict[Tuple[int, str], Column] = {}
        for et in etypes_present.tolist():
            schema = edge_schema(et, -1)
            if schema is None:
                continue
            for col in schema.columns:
                cols[(et, col.name)] = Column(col.name, col.type, m)
        vals_in_order = [edges[i][4] for i in order]
        et_in_order = mirror.edge_etype
        keep = np.ones(m, dtype=bool)
        for i, blob in enumerate(vals_in_order):
            et = int(et_in_order[i])
            if not blob:
                continue
            try:
                reader = RowReader.from_resolver(
                    blob, lambda ver, _et=et: edge_schema(_et, ver))
            except KeyError:
                continue
            # TTL parity: the CPU read path skips expired rows
            # (processors._ttl_expired); expired edges must not traverse
            exp = _ttl_expiry(reader)
            if exp is not None:
                if exp < _now_s():
                    keep[i] = False
                    continue
                mirror.note_expiry(exp)
            for cname in reader.schema.names():
                c = cols.get((et, cname))
                if c is None:
                    continue
                try:
                    v = reader.get(cname)
                except KeyError:
                    continue
                if c.raw is not None:
                    c.raw[i] = v if isinstance(v, str) else str(v)
                else:
                    c.values[i] = v
                c.valid[i] = True
        if not keep.all():
            mirror.edge_src = mirror.edge_src[keep]
            mirror.edge_dst = mirror.edge_dst[keep]
            mirror.edge_etype = mirror.edge_etype[keep]
            mirror.edge_rank = mirror.edge_rank[keep]
            kept_idx = np.nonzero(keep)[0]
            for c in cols.values():
                c.valid = c.valid[keep]
                if c.raw is not None:
                    c.raw = [c.raw[j] for j in kept_idx]
                else:
                    c.values = c.values[keep]
            m = len(mirror.edge_src)
            mirror.m = m
        for c in cols.values():
            c.finalize()
        mirror.edge_cols = cols
        counts = np.bincount(mirror.edge_src, minlength=n)
        mirror.row_ptr = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int32)
    else:
        mirror.row_ptr = np.zeros(n + 1, dtype=np.int32)

    # ---- vertex (tag) prop columns -----------------------------------
    vcols: Dict[Tuple[int, str], Column] = {}
    tag_ids = sorted({t for _, t, _ in verts})
    for t in tag_ids:
        schema = tag_schema(t, -1)
        if schema is None:
            continue
        for col in schema.columns:
            vcols[(t, col.name)] = Column(col.name, col.type, n)
        mirror.has_tag[t] = np.zeros(n, dtype=bool)
    for vid, t, blob in verts:
        di = int(np.searchsorted(mirror.vids, np.int64(vid)))
        if not blob:
            if t in mirror.has_tag:
                mirror.has_tag[t][di] = True
            continue
        try:
            reader = RowReader.from_resolver(
                blob, lambda ver, _t=t: tag_schema(_t, ver))
        except KeyError:
            continue
        exp = _ttl_expiry(reader)
        if exp is not None:
            if exp < _now_s():
                continue    # expired tag row: CPU path treats it as absent
            mirror.note_expiry(exp)
        if t in mirror.has_tag:
            mirror.has_tag[t][di] = True
        for cname in reader.schema.names():
            c = vcols.get((t, cname))
            if c is None:
                continue
            try:
                v = reader.get(cname)
            except KeyError:
                continue
            if c.raw is not None:
                c.raw[di] = v if isinstance(v, str) else str(v)
            else:
                c.values[di] = v
            c.valid[di] = True
    for c in vcols.values():
        c.finalize()
    mirror.vertex_cols = vcols
    return mirror
