"""Per-space CSR mirror — the counterpart of ``nebula_tpu/tpu/csr.py``.

The reference folds the mirror from the KV store (``build_mirror``).
The port has no KV layer yet, so ``mirror_from_edges`` builds the same
arrays from an edge list (with optional edge and vertex property
columns), and ``mirror_from_reference`` takes them as the reference
computed them, property columns included.

Property columns (``Column``, a copy of ``csr.py:70-210`` less the
write path's ``absorb_form``) are re-encoded into order-preserving
device spaces as the reference does: strings become codes into a
sorted per-column dictionary, int columns int32 when the value range
fits, else float32 when exactly representable, else the column is
marked uncompilable and a WHERE touching it declines.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..interface.common import SupportedType


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
