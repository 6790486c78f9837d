"""The port's device runtime over torch tensors — the slices of
``nebula_tpu/tpu/runtime.py`` that serve GO and FIND PATH.

``TorchQueryRuntime`` holds per-space mirrors, their ELL indexes and
device tables, and a ``GoBatchDispatcher`` (graph/batch_dispatch.py)
that every device query enters.  A space's mirror comes from one of two
places:

- the runtime's stores (``TorchQueryRuntime(stores=[...],
  schema_man=...)``, runtime.py:452-470): ``mirror()`` folds the
  space's parts with the per-row builder (``csr.build_mirror``) and,
  once committed writes move the store versions, folds their delta
  into the NEXT immutable generation (runtime.py:655-1118):
  ``_try_absorb`` -> ``_absorb_once`` (vertex writes planned first and
  committed last) -> ``_absorb_build``, whose device half is the
  ``ell_absorb`` kernel deriving the next generation's ELL tables from
  the resident ones.  A window that cannot absorb (a new vertex, a
  delta past ``mirror_delta_max``, a slot overflow, an opaque or
  truncated log) is counted and rebuilds from the store.  In-flight
  queries finish on the generation they captured; a query admitted
  after a publish sees it.  The reference's asynchronous rebuild
  (``mirror_refresh_mode=async``) and peer-delta absorption are not
  ported;
- ``load_space``, which installs a ready-made mirror that never
  changes (the earlier slices' tests and smoke phases).

The entry points:

- ``serve_go`` answers ``GO [UPTO] N STEPS FROM ... OVER e [, f | *]
  [REVERSELY] [WHERE ...] YIELD [DISTINCT] ... [| YIELD COUNT(*)]
  [| LIMIT n]``.  With
  ``go_dispatch_mode=continuous`` (the default) multi-hop GO rides one
  in-flight lane batch per (space, OVER set)
  (``_ContinuousGoSession``); windowed mode and single-step GO ride
  the coalescing dispatcher into ``go_batch_execute``, whose
  ``_launch_frontiers`` picks the reference's route: the sparse
  pair-list program (``sparse_go``, its COUNT and LIMIT variants, split
  into ladder-sized launches for wide batches), the adaptive
  single-query program (``adaptive_go``) or the dense ``ell_go`` /
  ``ell_go_count`` programs.
  Given the reference's expression parameters (``where_blob``,
  ``yield_specs``, ``distinct``, ``pushed_mode``), a GO whose WHERE
  compiles takes the fused route as ``_go_via_dispatcher`` sends it
  (``runtime.py:1376-1390``): ``_execute_fused`` runs one query
  outside the dispatcher, the edge-list ``go_filtered`` program with
  the compiled WHERE (``expr_filter``) on the card, then YIELD
  materialization on the host.  Every other planned GO (a WHERE with
  UPTO or under ``tpu_filter_mode=host``, YIELD props or meta columns
  with no WHERE, DISTINCT, several OVER aliases) rides the dispatcher:
  the frontier advance on the card for the whole batch or cohort, then
  on the host one numpy int64 / float64 pass per (WHERE, YIELD, mode)
  signature group (``_assemble_results``: ``_host_filter``,
  ``_materialize_group``), a query that must decline declining alone.
- ``serve_find_path`` answers ``FIND SHORTEST|ALL PATH``: batched BFS
  depths on the card (``ell_bfs``, or ``ell_bfs_i8`` with packing
  off), then the host's parent walk
  (``_reconstruct_paths``).

With ``tpu_packed_frontier=false`` the dense GO and the BFS ride the
int8 carrier instead (``ell_go_i8``, ``ell_bfs_i8``; the GO result
bit-packed along rows by its last advance, the BFS's targets uploaded
as lane bits by ``frontier_upload``), and the continuous tier is
refused, so every GO takes the windowed pipeline.

With ``tpu_mesh_devices=k > 1`` the runtime serves on a mesh of k
shards (``mesh.PartsMesh``: the first k cards, k shards of the CPU
when the runtime's device is the CPU, or the ``mesh_devices`` it was
given).  In the default ``tpu_mesh_mode=sparse`` windowed GO with a
sparse rung and FIND PATH run the frontier-sharded programs over the
chunk-sharded tables (``mesh_sparse_go``, ``mesh_sparse_bfs``; the
view built per mirror on first use, never carried to the next
generation); a start placement past the cap, or an overflow in the
program, runs the batch on the replicated-frontier design of
``tpu_mesh_mode=dense`` instead (counted in ``sparse_overflows`` when
the program overflowed): ``ell_go_sharded`` and ``ell_bfs_sharded``
over the row-sharded tables (always packed, COUNT(*) and LIMIT
applied on the host).  Absorbed writes update the row-sharded tables
with ``ell_absorb_sharded``; the continuous tier is refused, and UPTO
on a mesh declines.

Everything else raises ``TpuDecline`` naming what it needs: a WHERE
that does not compile, a pipe reduction the reference's front end
never pushes down (over a WHERE, DISTINCT or YIELD props), UPTO on a
mesh.

Semantics held exactly: ``GO N STEPS`` is N-1 device hops, then the
host-side final hop over the frontier's out-edges in the OVER set
(``_frontier_edges_multi``); UPTO reads the union of depths 0..N-1.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import protocol
from ..common.flags import flags
from ..filter.expressions import (EdgeDstIdExpr, EdgeRankExpr,
                                  EdgeSrcIdExpr, EdgeTypeExpr, Expression,
                                  ExprContext, ExprError, LogicalExpr,
                                  decode_expr)
from ..graph.batch_dispatch import ContinuousGoScheduler, GoBatchDispatcher
from ..graph.interim import (ColumnarRows, ConstCol, DictCol, _col_tolist,
                             default_col_name)
from ..meta.schema import SchemaView
from ..storage.device import DeviceExecError, TpuDecline
from . import edge_ops, ell_ops
from .csr import (CsrMirror, absorb_overlay, build_delta_mirror,
                  build_mirror, commit_vertex_plan, plan_vertex_events)
from .device import DeviceLike, resolve_device
from .ell import (INT16_INF, INT32_INF, DeviceTables, EllIndex,
                  MeshTables, ShardedTables, absorb_live,
                  absorb_update_arrays,
                  apply_ell_absorb_host, build_sharded_ell, lanes_width,
                  mesh_tables, plan_ell_absorb, sharded_sparse_pairs,
                  sharded_tables, sparse_caps, sparse_go_pairs,
                  sparse_pack32, split_start_pairs_by_owner, unpack_bits,
                  unpack_lanes_host)
from .expr_compile import (K_BOOL, K_FLOAT, K_STR, K_STRCODE, K_VIDRANK,
                           CompileError, CVal, Env, ExprCompiler)
from .expr_program import B as T_BOOL, F as T_FLOAT, I as T_INT
from .expr_program import ExprProgram, trace_filter
from .mesh import PartsMesh


class _Pending:
    """Two-phase dispatcher contract: the leader launched device work
    (async on the card's stream); ``finish()`` blocks on the transfer
    and completes the host half.  While one batch finishes, the next
    batch's leader may launch."""

    __slots__ = ("finish",)

    def __init__(self, finish):
        self.finish = finish


class _DeviceCounts:
    """What a count-reduced launch's resolver returns instead of
    per-query frontier vertex lists: the card already collapsed the
    result to per-query candidate-edge counts (int64[nq])."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr


class _GoQuery:
    """One GO request riding a ``go_batch_execute`` dispatch or the
    continuous stream (runtime.py:120-138): its starts, its plan (the
    compiled WHERE and the OVER aliases), its YIELD columns, DISTINCT,
    the decoded WHERE (recompiled when the dispatch's mirror is newer
    than the plan's) and the OVER set's aliases.  A query error raises
    DeviceExecError."""

    __slots__ = ("start_vids", "plan", "yield_cols", "distinct",
                 "where_expr", "etype_to_alias")

    def __init__(self, start_vids: Sequence[int], plan: "_GoPlan",
                 yield_cols, distinct: bool, where_expr,
                 etype_to_alias: Dict[int, str]):
        self.start_vids = list(start_vids)
        self.plan = plan
        self.yield_cols = yield_cols
        self.distinct = distinct
        self.where_expr = where_expr
        self.etype_to_alias = etype_to_alias


class _GoPlan:
    """A planned GO with a compiled WHERE (runtime.py:71)."""

    __slots__ = ("mirror", "alias_to_etype", "filter_cval", "filter_used",
                 "pushed_mode", "compiler", "expr_str", "sc_or")

    def __init__(self, mirror, alias_to_etype, filter_cval, filter_used,
                 pushed_mode, compiler, expr_str, sc_or=False):
        self.mirror = mirror
        self.alias_to_etype = alias_to_etype
        self.filter_cval = filter_cval
        self.filter_used = filter_used      # dict key -> descriptor
        self.pushed_mode = pushed_mode      # True: skip-invalid (storage
        self.compiler = compiler            # semantics); False: raise
        self.expr_str = expr_str            # canonical WHERE text (cache key)
        # WHERE contains a disjunction: `x || missing` short-circuits
        # on the CPU path (row kept without touching the prop), which
        # the vectorized validity mask cannot reproduce — rows with
        # invalid used props must decline then
        self.sc_or = sc_or


def _filter_has_or(expr) -> bool:
    """True when the predicate can short-circuit PAST a prop read in a
    way the validity AND-mask cannot reproduce (runtime.py:94): any
    disjunction, and any non-logical operator over a logical subtree."""
    if expr is None:
        return False

    def scan(nd, under_non_logical: bool) -> bool:
        if isinstance(nd, LogicalExpr):
            if nd.op != "&&" or under_non_logical:
                return True
            return any(scan(c, False) for c in nd.children())
        return any(scan(c, True) for c in nd.children())

    return scan(expr, False)


def _pad_pow2(arr: np.ndarray, fill=-1, min_size: int = 8) -> np.ndarray:
    """``arr`` padded with ``fill`` to a power of two of at least
    ``min_size`` (runtime.py:166)."""
    size = max(min_size, 1 << (max(len(arr), 1) - 1).bit_length())
    if len(arr) >= size:
        return arr
    return np.concatenate([arr, np.full(size - len(arr), fill,
                                        dtype=arr.dtype)])


class _YieldCol:
    """One decoded YIELD column: its expression and alias."""

    __slots__ = ("expr", "alias")

    def __init__(self, expr: Expression, alias: Optional[str]):
        self.expr = expr
        self.alias = alias


# the YIELD columns that never raise per row: a pipe reduction is pushed
# down only over these (traverse.py:976-980)
_META_EXPRS = (EdgeDstIdExpr, EdgeSrcIdExpr, EdgeRankExpr, EdgeTypeExpr)

_DEVICE_TYPE = {np.dtype(bool): T_BOOL, np.dtype(np.int32): T_INT,
                np.dtype(np.float32): T_FLOAT}


def _ladder() -> List[int]:
    return sorted(int(w) for w in
                  str(flags.get("go_batch_widths") or
                      "128,1024").split(",") if w.strip()) or [128]


class TorchQueryRuntime:
    """The port's device runtime: GO (continuous and windowed) and
    FIND PATH, over mirrors folded from ``stores`` (``NebulaStore``s,
    with ``schema_man`` resolving their schemas and names) or loaded
    ready-made (``load_space``).  ``mesh_devices`` places mesh shard i
    on ``mesh_devices[i]`` (repeats allowed) when
    ``tpu_mesh_devices`` > 1; None means the first k cards, or k shards
    of the CPU when ``device`` is the CPU."""

    def __init__(self, stores=None, schema_man=None,
                 device: DeviceLike = None, mesh_devices=None):
        self.device = resolve_device(device)
        self._mesh_devices = None if mesh_devices is None else [
            torch.device(d) for d in mesh_devices]
        self._mesh_cache: Optional[Tuple[int, Optional[PartsMesh]]] = None
        self._mesh_warned = False
        self._mesh_lock = threading.Lock()
        self.stores = list(stores or [])
        self.sm = schema_man
        self._lock = threading.Lock()
        self._build_locks: Dict[int, threading.Lock] = {}
        self.mirrors: Dict[int, CsrMirror] = {}
        self._loaded: set = set()       # spaces installed by load_space
        # the outcome of the newest absorption attempt (a protocol
        # reason) and the wall seconds of the newest absorbed windows
        self.last_absorb_reason: Optional[str] = None
        self.absorb_wall_s: collections.deque = collections.deque(
            maxlen=65536)
        # counters; the t_*_s entries are host wall seconds, summed over
        # the threads that spent them: the windowed leader's launch
        # (enqueue), fetch and assembly, FIND PATH's BFS dispatch
        # (levels, flag reads and the depth fetch) and its host parent
        # walk; cpu_paths_s is the walk's own CPU time (thread_time),
        # which leaves out the waits for the GIL that t_paths_s counts
        self.stats = {"go_device": 0, "go_reduced": 0, "go_dense": 0,
                      "go_sparse": 0, "go_sparse_split": 0,
                      "sparse_overflows": 0, "go_adaptive": 0,
                      "path_device": 0, "bfs_dispatches": 0,
                      # the replicated-frontier mesh's GO launches, BFS
                      # dispatches and absorbed table generations, and
                      # the frontier-sharded mesh's GO launches and BFS
                      # dispatches that served
                      "go_mesh": 0, "path_mesh": 0, "mesh_absorbs": 0,
                      "go_mesh_sparse": 0, "bfs_mesh_sparse": 0,
                      "bfs_levels": 0, "fetch_bytes": 0,
                      "fetch_wait_s": 0.0, "t_launch_s": 0.0,
                      "t_fetch_s": 0.0, "t_assemble_s": 0.0,
                      "t_bfs_s": 0.0, "t_paths_s": 0.0,
                      "cpu_paths_s": 0.0, "go_fused": 0,
                      "t_fused_launch_s": 0.0, "t_fused_fetch_s": 0.0,
                      "t_fused_materialize_s": 0.0,
                      # the write path (runtime.py:485-500): full folds,
                      # absorbed generations, absorbed windows (vertex-
                      # only ones included), declines, declines past
                      # mirror_delta_max, growth-spare claims, the
                      # absorb wall seconds, and of those the host CSR
                      # splice's and the ELL half's (plan, host copy,
                      # replacement-row upload, kernel enqueue)
                      "mirror_builds": 0, "mirror_absorbs": 0,
                      "mirror_deltas": 0, "mirror_absorb_failed": 0,
                      "mirror_delta_overflow": 0, "mirror_slot_grows": 0,
                      "t_absorb_s": 0.0, "t_absorb_splice_s": 0.0,
                      "t_absorb_ell_s": 0.0}
        self.schemas: Dict[int, SchemaView] = {}
        # compiled WHERE programs per (space, mirror, pushed mode, OVER
        # aliases, WHERE text), as the reference caches its fused
        # kernels by build_version; nothing is compiled per shape
        self._programs: Dict[tuple, ExprProgram] = {}
        self.dispatcher = GoBatchDispatcher(self)

    @property
    def continuous(self) -> ContinuousGoScheduler:
        """The dispatcher's continuous tier (one stream per (space,
        OVER set))."""
        return self.dispatcher.continuous

    def close(self) -> None:
        """Stop every stream's pump thread (seated riders are failed)."""
        self.continuous.shutdown()

    def _bump(self, key: str, n=1) -> None:
        with self._lock:
            self.stats[key] += n

    def _tick(self, key: str, t0: float) -> float:
        """Add the seconds since ``t0`` to a stats bucket; returns now."""
        now = time.perf_counter()
        with self._lock:
            self.stats[key] += now - t0
        return now

    # --------------------------------------------------- mirror lifecycle
    def load_space(self, space_id: int, mirror: CsrMirror,
                   schema: Optional[SchemaView] = None) -> None:
        """Publish a ready-made ``mirror`` for ``space_id``, with the
        space's tag and edge names (``schema``; a WHERE naming a tag
        needs them).  A loaded space is served as it is: it has no store
        behind it, so nothing absorbs into it, and a second load
        raises."""
        with self._lock:
            if space_id in self.mirrors or space_id in self._loaded:
                raise ValueError(f"space {space_id} is already loaded")
            self._loaded.add(space_id)
            self.mirrors[space_id] = mirror
            self.schemas[space_id] = schema if schema is not None \
                else SchemaView()

    def _store_versions(self, space_id: int, stores) -> List[int]:
        return [s.mutation_version(space_id) for s in stores]

    @staticmethod
    def _space_version(space_id: int, stores, vers: List[int]) -> int:
        v = 0
        for s, sv in zip(stores, vers):
            v += sv
            v += 7919 * len(s.part_ids(space_id))
        return v

    @staticmethod
    def _fresh(m: CsrMirror, ver: int) -> bool:
        return getattr(m, "_fresh_version", m.build_version) == ver \
            and not m.expired_now()

    def mirror(self, space_id: int) -> Optional[CsrMirror]:
        """The space's current generation (runtime.py:678): a loaded
        mirror as it is; for a store-backed space, the published
        generation when it is fresh, else the committed delta absorbed
        into the next generation, else a rebuild from the stores under
        the space's build lock.  None when no store holds the space."""
        with self._lock:
            if space_id in self._loaded:
                return self.mirrors.get(space_id)
        stores = self.stores
        if not any(s.part_ids(space_id) for s in stores):
            return None
        # versions captured BEFORE any scan: a write landing during the
        # build leaves the published version stale, so the next query
        # absorbs or rebuilds it
        vers = self._store_versions(space_id, stores)
        ver = self._space_version(space_id, stores, vers)
        with self._lock:
            m = self.mirrors.get(space_id)
            if m is not None and self._fresh(m, ver):
                return m
            stale = m is not None and not m.expired_now()
        if stale:
            a = self._try_absorb(space_id, ver)
            if a is not None:
                return a
        with self._build_lock(space_id):
            # re-captured: a build for an older version published over a
            # newer mirror would regress freshness
            vers = self._store_versions(space_id, stores)
            ver = self._space_version(space_id, stores, vers)
            with self._lock:
                m = self.mirrors.get(space_id)
                if m is not None and self._fresh(m, ver):
                    return m
            built = build_mirror(space_id, stores, self.sm)
            with self._lock:
                return self._publish(space_id, built, ver, stores, vers)

    def _build_lock(self, space_id: int) -> threading.Lock:
        with self._lock:
            lk = self._build_locks.get(space_id)
            if lk is None:
                lk = self._build_locks[space_id] = threading.Lock()
            return lk

    def _publish(self, space_id: int, m: CsrMirror, ver: int, stores,
                 vers: List[int], cursors: Optional[Dict[int, int]] = None,
                 absorbed_from: Optional[CsrMirror] = None) -> CsrMirror:
        """Install a mirror GENERATION (caller holds the lock): a full
        build, whose delta cursors are the store versions captured
        before its scan, or an absorbed next generation with the
        cursors after its window (runtime.py:757).  Published
        generations are immutable: in-flight queries keep the object
        and the device tables they captured.  The space's compiled
        WHERE programs are dropped (runtime.py:816-823): an absorb can
        re-type a column, and a mirror's id() may be reused."""
        m.build_version = ver
        m._fresh_version = ver       # advanced by vertex-only absorbs
        m._delta_cursors = cursors if cursors is not None \
            else {i: v for i, v in enumerate(vers)}
        m._part_sig = tuple(len(s.part_ids(space_id)) for s in stores)
        prev = absorbed_from if absorbed_from is not None \
            else self.mirrors.get(space_id)
        m.generation = getattr(prev, "generation", 0) + 1
        if absorbed_from is not None:
            self.stats["mirror_absorbs"] += 1
            self.stats["mirror_deltas"] += 1
        else:
            self.stats["mirror_builds"] += 1
        self.mirrors[space_id] = m
        self._programs = {k: v for k, v in self._programs.items()
                          if k[0] != space_id}
        return m

    # ------------------------------------------------ delta absorption
    def _try_absorb(self, space_id: int,
                    caller_ver: int) -> Optional[CsrMirror]:
        """Fold committed write deltas into the resident tables as the
        NEXT immutable generation (runtime.py:829), under the space's
        build lock.  None: this window cannot absorb and the caller
        rebuilds; the decline is counted once per declined version (a
        negative cache on the mirror), not once per query."""
        if not flags.get("mirror_absorb", True):
            return None
        with self._build_lock(space_id):
            with self._lock:
                m = self.mirrors.get(space_id)
                if m is None or m.expired_now():
                    return None
                if getattr(m, "_fresh_version",
                           m.build_version) == caller_ver:
                    return m     # absorbed or rebuilt while we waited
                if getattr(m, "_delta_cursors", None) is None:
                    return None
                if getattr(m, "_absorb_declined_ver",
                           None) == caller_ver:
                    return None  # already declined at this version
            # re-captured once under the build lock: absorb up to the
            # latest committed state, and publish with matching cursors
            stores = self.stores
            vers = self._store_versions(space_id, stores)
            ver = self._space_version(space_id, stores, vers)
            with self._lock:
                if getattr(m, "_fresh_version", m.build_version) == ver:
                    return m
            t0 = time.perf_counter()
            out, reason, n_events = self._absorb_once(space_id, m, ver,
                                                      stores, vers)
            with self._lock:
                self.last_absorb_reason = reason
            if out is None:
                with self._lock:
                    m._absorb_declined_ver = ver
                self._note_absorb_failure(space_id, reason, n_events)
                return None
            wall = time.perf_counter() - t0
            with self._lock:
                self.stats["t_absorb_s"] += wall
                self.absorb_wall_s.append(wall)
            return out

    def _note_absorb_failure(self, space_id: int, reason: str,
                             n_events: int) -> None:
        """A decline is a rebuild about to happen: count it (delta-budget
        overflows get their own counter)."""
        with self._lock:
            self.stats["mirror_absorb_failed"] += 1
            if reason == protocol.ABSORB_DELTA_OVERFLOW:
                self.stats["mirror_delta_overflow"] += 1

    def _absorb_once(self, space_id: int, m: CsrMirror, ver: int,
                     stores, vers):
        """One absorption attempt against the published mirror ``m``
        (caller holds the build lock; runtime.py:884).  Returns
        (mirror | None, reason, event count): the next generation, or
        ``m`` itself for a vertex-only window (its in-place commit is
        the absorb), or None with the decline reason.  Everything that
        can decline runs before anything is committed."""
        sig = tuple(len(s.part_ids(space_id)) for s in stores)
        if getattr(m, "_part_sig", None) != sig:
            return None, protocol.ABSORB_PART_MOVED, 0
        if len(stores) != len(m._delta_cursors):
            return None, protocol.ABSORB_PEER_SET_CHANGED, 0
        new_events = []
        cursors = dict(m._delta_cursors)
        for i, s in enumerate(stores):
            if vers[i] == cursors[i]:
                continue
            evs = s.delta_since(space_id, cursors[i])
            if evs is None:
                return None, protocol.ABSORB_OPAQUE_EVENTS, 0
            new_events.extend(evs)
            cursors[i] = vers[i]
        n_events = len(new_events)
        edge_events = [e for e in new_events if e[0] != "vput"]
        if len(edge_events) > int(flags.get("mirror_delta_max") or 4096):
            return None, protocol.ABSORB_DELTA_OVERFLOW, n_events
        vplan = plan_vertex_events(m, new_events, self.sm, space_id)
        if vplan is None:
            return None, protocol.ABSORB_VERTEX_UNABSORBABLE, n_events

        def commit_in_place():
            with self._lock:
                self._commit_vertices(m, vplan)
                m._delta_cursors = cursors
                m._fresh_version = ver
                self.stats["mirror_deltas"] += 1
            return m

        if not edge_events:
            return commit_in_place(), protocol.ABSORB_VERTEX_IN_PLACE, \
                n_events
        d = build_delta_mirror(m, edge_events, self.sm, space_id)
        if d is None:
            return None, protocol.ABSORB_OVERLAY_UNBUILDABLE, n_events
        if len(d.extra_vids):
            return None, protocol.ABSORB_VERTEX_PLAN_CHANGE, n_events
        if d.m == 0 and not len(d.base_dead):
            return commit_in_place(), protocol.ABSORB_NO_OP, n_events
        new_m = self._absorb_build(space_id, m, d)
        if new_m is None:
            return None, protocol.ABSORB_SLOT_OVERFLOW, n_events
        with self._lock:
            self._commit_vertices(m, vplan)
            self._publish(space_id, new_m, ver, stores, vers,
                          cursors=cursors, absorbed_from=m)
        return new_m, protocol.ABSORBED, n_events

    @staticmethod
    def _commit_vertices(m: CsrMirror, vplan) -> None:
        """Commit a vertex plan in place (csr.commit_vertex_plan: values
        first, valid bits last), then retire the device copies of the
        vertex columns: the next fused query uploads them afresh, and an
        upload racing this commit lands under the old epoch, which no
        later query reads."""
        if not vplan:
            return
        commit_vertex_plan(m, vplan)
        m._vertex_epoch = getattr(m, "_vertex_epoch", 0) + 1
        for cache in (getattr(m, "_env_dev_cache", None) or {}).values():
            for key in [k for k in cache if "vertex" in k[:2]]:
                cache.pop(key, None)

    def _absorb_build(self, space_id: int, m: CsrMirror,
                      d) -> Optional[CsrMirror]:
        """The CSR and ELL halves of one absorption (runtime.py:1035):
        the merged host CSR (a new mirror sharing the vertex side), the
        replacement-row plan, the copy-on-write host ELL, and on the
        device ``ell_absorb``, whose output becomes the new mirror's
        tables — the upload is the replacement rows, never the tables.
        Hub caches carry over only when no growth spare was claimed
        (a claim changes extra_owner, which they derive from); nothing
        else carries.  None = slot overflow."""
        t_start = time.perf_counter()
        ix = self.ell(m)
        dead = np.asarray(getattr(d, "base_dead", ()), dtype=np.int64)
        # the ELL keys rows by DST (slots hold srcs)
        claims: List = []
        plan = plan_ell_absorb(
            ix, d.edge_dst, d.edge_src, d.edge_etype,
            m.edge_dst[dead], m.edge_src[dead], m.edge_etype[dead],
            claims_out=claims)
        if plan is None:
            return None
        t0 = time.perf_counter()
        new_m = absorb_overlay(m, d)
        t1 = self._tick("t_absorb_splice_s", t0)
        if new_m is None:
            return None
        ix2 = apply_ell_absorb_host(ix, plan, new_m.m, claims=claims)
        tables = (getattr(m, "_tables_cache", None) or {}).get(
            str(self.device))
        mesh_cached = getattr(m, "_mesh_tables_cache", None)
        if tables is not None or mesh_cached is not None:
            _counts, upd = absorb_update_arrays(ix, plan)
            rows, nn, ne = self._absorb_args(upd)
        if tables is not None:
            new_m._tables_cache = {str(self.device): ell_ops.ell_absorb(
                tables, rows, nn, ne)}
        if mesh_cached is not None:
            # the resident mesh tables absorb shard by shard, each shard
            # applying only the rows it owns (runtime.py:1081-1095) —
            # never a re-shard of the host arrays
            k, mt = mesh_cached
            new_m._mesh_tables_cache = (k, ell_ops.ell_absorb_sharded(
                mt, rows, nn, ne, absorb_live(ix, plan)))
            self._bump("mesh_absorbs")
        self._bump("t_absorb_ell_s",
                   time.perf_counter() - t_start - (t1 - t0))
        new_m._ell = ix2
        if not claims:
            for attr in ("_hub_dev_cache", "_hub_exp_cache",
                         "_hub_merge_cache"):
                val = getattr(m, attr, None)
                if val is not None:
                    setattr(new_m, attr, val)
        else:
            self._bump("mirror_slot_grows", len(claims))
            new_m._slot_claims = len(claims)
        return new_m

    def _absorb_args(self, upd):
        """absorb_update_arrays' per-bucket (rows, nbr rows, et rows) as
        device tensors: one host buffer, one upload, per-bucket views."""
        parts = [a.reshape(-1) for trip in upd for a in trip]
        flat = self._up(np.ascontiguousarray(np.concatenate(parts),
                                             np.int32))
        views = []
        off = 0
        for a in parts:
            views.append(flat[off:off + a.size])
            off += a.size
        rows, nn, ne = [], [], []
        for b, (r, un, ue) in enumerate(upd):
            rows.append(views[3 * b])
            nn.append(views[3 * b + 1].view(un.shape))
            ne.append(views[3 * b + 2].view(ue.shape))
        return rows, nn, ne

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

    def _up(self, a: np.ndarray) -> torch.Tensor:
        """A host array copied to this runtime's device."""
        return torch.from_numpy(a).to(self.device)

    def _up_async(self, a: np.ndarray) -> torch.Tensor:
        """A host array on this runtime's device by one non-blocking
        copy from pinned memory, which the caching host allocator keeps
        until the copy is done: the host does not wait on the card (a
        copy from pageable memory waits for the stream)."""
        src = torch.from_numpy(a)
        if self.device.type != "cuda":
            return src.to(self.device)
        host = torch.empty(src.shape, dtype=src.dtype,
                           pin_memory=True).copy_(src)
        return torch.empty_like(host, device=self.device).copy_(
            host, non_blocking=True)

    def _mirror_cached(self, m: CsrMirror, attr: str, build,
                       device: Optional[torch.device] = None):
        """``build()`` cached on the mirror per device (this runtime's,
        or ``device``) under ``attr`` (EllIndex has __slots__, so device
        caches hang on the mirror)."""
        cache = getattr(m, attr, None)
        if cache is None:
            cache = {}
            setattr(m, attr, cache)
        key = str(self.device if device is None else device)
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def _device_tables(self, m: CsrMirror, ix: EllIndex) -> DeviceTables:
        """The ELL buckets on this runtime's device, cached per mirror."""
        return self._mirror_cached(m, "_tables_cache",
                                   lambda: ix.device_tables(self.device))

    def _hub_merge_dev(self, m: CsrMirror, ix: EllIndex
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(eslot, hrows) on the device for the hop's OR-merge
        (ell.EllIndex.hub_merge), cached per mirror."""
        return self._mirror_cached(
            m, "_hub_merge_cache",
            lambda: tuple(self._up(a) for a in ix.hub_merge()))

    def _hub_merge_shards(self, m: CsrMirror, ix: EllIndex,
                          mesh: PartsMesh):
        """(eslot per shard, hrows per shard): the hub OR-merge arrays
        on each shard's device (one cached copy per device)."""
        per = [self._mirror_cached(
            m, "_hub_merge_cache",
            lambda d=d: tuple(torch.from_numpy(a).to(d)
                              for a in ix.hub_merge()), device=d)
            for d in mesh.devices]
        return [p[0] for p in per], [p[1] for p in per]

    # ------------------------------------------------------------- mesh
    def _mesh_only(self) -> Optional[PartsMesh]:
        """The configured mesh (runtime.py:3144), or None when
        ``tpu_mesh_devices`` <= 1 — without building any table.  With
        no ``mesh_devices`` list and fewer than k cards visible, the
        reference's one-time warning goes to stderr and the runtime
        runs single-device."""
        k = int(flags.get("tpu_mesh_devices") or 0)
        if k <= 1:
            return None
        cached = self._mesh_cache
        if cached is not None and cached[0] == k:
            return cached[1]
        if self._mesh_devices is not None:
            devs = self._mesh_devices
        elif self.device.type == "cpu":
            devs = [self.device] * k
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
        if len(devs) < k:
            if not self._mesh_warned:
                self._mesh_warned = True
                import sys
                sys.stderr.write(
                    f"tpu_mesh_devices={k} but only {len(devs)} devices "
                    f"visible — running single-device\n")
            self._mesh_cache = (k, None)
            return None
        mesh = PartsMesh(devs[:k])
        self._mesh_cache = (k, mesh)
        return mesh

    def _mesh_tables(self, m: CsrMirror, ix: EllIndex
                     ) -> Optional[MeshTables]:
        """The row-sharded tables on the mesh (runtime.py:3170), cached
        on the mirror per k so they follow its lifecycle (an absorbed
        generation carries its own); None without a mesh."""
        mesh = self._mesh_only()
        if mesh is None:
            return None
        with self._mesh_lock:
            cached = getattr(m, "_mesh_tables_cache", None)
            if cached is not None and cached[0] == mesh.k \
                    and cached[1].mesh == mesh:
                return cached[1]
            mt = mesh_tables(ix, mesh)
            m._mesh_tables_cache = (mesh.k, mt)
            return mt

    def _sharded_tables(self, m: CsrMirror, ix: EllIndex,
                        mesh: PartsMesh) -> ShardedTables:
        """The k-way chunk-sharded view (runtime.py:1916
        ``_sharded_ell``) on the mesh, cached on the mirror per k: the
        one view both frontier-sharded entry points (GO and FIND PATH)
        read.  An absorbed generation builds its own on first use."""
        with self._mesh_lock:
            cached = getattr(m, "_sharded_ell_cache", None)
            if cached is not None and cached[0] == mesh.k \
                    and cached[1].mesh == mesh:
                return cached[1]
            st = sharded_tables(build_sharded_ell(ix, mesh.k), mesh)
            m._sharded_ell_cache = (mesh.k, st)
            return st

    def _up_shards(self, st: ShardedTables, *arrays: np.ndarray):
        """The host arrays [k, c] (all of one shape) as the card groups'
        [members, c] slabs (``mesh.slabs``' form), one upload a card
        group: a list of slabs for each array."""
        both = np.stack(arrays)                            # [m, k, c]
        per = [torch.from_numpy(np.ascontiguousarray(
            both[:, list(members)])).to(d).unbind(0)
            for d, members in st.mesh.groups]
        return tuple([p[i] for p in per] for i in range(len(arrays)))

    def _hub_dev(self, m: CsrMirror, ix: EllIndex) -> torch.Tensor:
        """uint8[n+1] hub table (ell.EllIndex.hub_table) on the device
        for the adaptive program, cached per mirror."""
        return self._mirror_cached(
            m, "_hub_dev_cache",
            lambda: self._up(ix.hub_table().astype(np.uint8)))

    def _hub_expansion_dev(self, m: CsrMirror, ix: EllIndex
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ecnt, e0) on the device for the sparse program's exact hub
        push (ell.EllIndex.hub_expansion), cached per mirror."""
        return self._mirror_cached(
            m, "_hub_exp_cache",
            lambda: tuple(self._up(a) for a in ix.hub_expansion()))

    # ------------------------------------------------------ entry point
    def serve_go(self, space_id: int, start_vids: Sequence[int],
                 etypes: Sequence[int], steps: int,
                 etype_to_alias: Dict[int, str], upto: bool = False,
                 reduce=None, yield_cols: Optional[Sequence[str]] = None,
                 where=None, limit: Optional[int] = None,
                 where_blob: Optional[bytes] = None, yield_specs=None,
                 distinct: bool = False, pushed_mode: bool = True
                 ) -> Tuple[List[str], List[List[object]]]:
        """Serve one GO; returns (columns, rows).

        With the reference's expression parameters (runtime.py:1309):
        ``where_blob`` the encoded WHERE tree, ``yield_specs`` a list of
        (encoded YIELD expression, alias or None), ``distinct`` and
        ``pushed_mode`` (True: storaged's filter semantics, an invalid
        prop drops the row; False: graphd's remnant filter, where a
        real x/0 or an invalid prop on a candidate declines), the GO is
        routed by ``_serve_go_exprs``.  Otherwise:

        ``etypes`` are signed (negative = REVERSELY) and must name one
        edge alias in ``etype_to_alias`` (several ride ``yield_specs``);
        the result column is
        ``"<alias>._dst"`` with one row per final-hop edge, or with
        ``reduce=("count",)`` the single row ``[[n]]`` under
        ``"__count__"``.  ``limit=n`` is ``GO ... | LIMIT n``: the
        request carries ``reduce=("limit", n)``, which the sparse route
        cuts on the card, and the first n assembled rows are returned,
        as the reference's pipe does (traverse.py:1037-1050); a
        device-cut LIMIT may keep another deterministic subset than the
        dense route's first rows.  The request enters the dispatcher as
        ``_go_via_dispatcher`` (runtime.py:1352) submits it: multi-hop
        GO rides the continuous stream in continuous mode, everything
        else ``go_batch_execute``.  A ``where``, other ``yield_cols``,
        other reductions, LIMIT with UPTO or a reduction (the
        reference's ``_go_reduce_shape`` never pushes those down) and
        unloaded spaces raise TpuDecline."""
        if where_blob is not None or yield_specs is not None:
            if where is not None or yield_cols is not None:
                raise TpuDecline("WHERE and YIELD come either as blobs "
                                 "or as where / yield_cols, not both")
            return self._serve_go_exprs(
                space_id, start_vids, etypes, steps, etype_to_alias,
                upto, reduce, limit, where_blob, yield_specs, distinct,
                pushed_mode)
        if where is not None:
            raise TpuDecline("a WHERE is served only as where_blob")
        if reduce is not None and tuple(reduce) != ("count",):
            raise TpuDecline(f"reduction {reduce!r} is not served")
        if limit is not None:
            if upto or reduce is not None or int(limit) < 0:
                raise TpuDecline("LIMIT is pushed down only onto a plain "
                                 "exact-depth GO")
            limit = int(limit)
            reduce = ("limit", limit)
        steps = int(steps)
        et_tuple = tuple(sorted(set(int(e) for e in etypes)))
        if not et_tuple or 0 in et_tuple:
            raise TpuDecline("GO needs an OVER edge type")
        aliases = {etype_to_alias.get(e) for e in et_tuple}
        if len(aliases) != 1 or None in aliases:
            raise TpuDecline("yield_cols names its column by one OVER "
                             "edge alias; several ride yield_specs")
        alias = aliases.pop()
        column = f"{alias}._dst"
        if yield_cols is not None and list(yield_cols) != [column]:
            raise TpuDecline(f"YIELD {list(yield_cols)} is not served; "
                             f"only {column}")
        m = self.mirror(space_id)
        if m is None:
            raise TpuDecline(f"space {space_id} is not loaded")
        plan = _GoPlan(m, {a: et for et, a in etype_to_alias.items()},
                       None, {}, True, None, None)
        return self._dispatch_go(
            space_id, et_tuple, steps, upto, reduce, limit,
            _GoQuery(start_vids, plan, [_YieldCol(EdgeDstIdExpr(alias),
                                                  None)],
                     False, None, etype_to_alias))

    def _dispatch_go(self, space_id: int, et_tuple: Tuple[int, ...],
                     steps: int, upto: bool, reduce, limit: Optional[int],
                     q: _GoQuery):
        """Submit one GO onto the coalescing dispatcher
        (``_go_via_dispatcher``'s else branch, runtime.py:1386-1393):
        multi-hop GO rides the continuous stream in continuous mode,
        everything else ``go_batch_execute``.  ``| LIMIT n`` keeps the
        first n assembled rows, as the reference's pipe does."""
        self._bump("go_device")
        cols, rows = self.dispatcher.submit_batched(
            ("go_batch_execute", space_id, et_tuple, int(steps), bool(upto),
             None if reduce is None else tuple(reduce)), q)[0]
        if limit is not None:
            return cols, rows[:limit]
        return cols, rows

    # ---------------------------------------- GO with WHERE and YIELD
    def _schema(self, space_id: int):
        """The space's names: a loaded space's SchemaView, else the
        runtime's schema manager."""
        with self._lock:
            return self.schemas.get(space_id) or self.sm or SchemaView()

    def _serve_go_exprs(self, space_id: int, start_vids: Sequence[int],
                        etypes: Sequence[int], steps: int,
                        etype_to_alias: Dict[int, str], upto: bool,
                        reduce, limit: Optional[int],
                        where_blob: Optional[bytes], yield_specs,
                        distinct: bool, pushed_mode: bool):
        """The reference ``serve_go``'s routing (runtime.py:1309-1393):
        decode the trees, plan, and send a compiled WHERE with no UPTO
        and no reduction to ``_execute_fused`` when ``tpu_filter_mode``
        is ``auto`` or ``device``.  Every other planned GO (a WHERE with
        UPTO or under ``tpu_filter_mode=host``, any YIELD with no WHERE,
        DISTINCT, any OVER set) rides the dispatcher, whose host half
        filters and materializes per signature group
        (``_assemble_results``).  A reduction (``| YIELD COUNT(*)``,
        ``| LIMIT n``) is served only on the shapes the reference's
        front end pushes down (traverse.py:958-994): no WHERE, no
        DISTINCT, meta-only YIELD columns, and LIMIT not with UPTO;
        the reference's ``go_batch_execute`` would reduce an unfiltered
        frontier, so anything else declines."""
        try:
            where_expr = decode_expr(where_blob) if where_blob else None
            ycols = [_YieldCol(decode_expr(blob), alias)
                     for blob, alias in (yield_specs or [])]
        except Exception as e:      # noqa: BLE001 — undecodable tree
            raise TpuDecline(f"undecodable expression: {e}")
        et_tuple = tuple(sorted(set(int(e) for e in etypes)))
        if not et_tuple or 0 in et_tuple:
            raise TpuDecline("GO needs an OVER edge type")
        if upto and int(flags.get("tpu_mesh_devices") or 0) > 1:
            raise TpuDecline("UPTO on a mesh-sharded space")
        if self.mirror(space_id) is None:
            raise TpuDecline(f"space {space_id} is not loaded")
        if reduce is not None and tuple(reduce) != ("count",):
            raise TpuDecline(f"reduction {reduce!r} is not served")
        if limit is not None:
            if reduce is not None or upto or int(limit) < 0:
                raise TpuDecline("LIMIT is pushed down only onto a plain "
                                 "exact-depth GO")
            limit = int(limit)
            reduce = ("limit", limit)
        if reduce is not None:
            if where_expr is not None or distinct or not all(
                    isinstance(c.expr, _META_EXPRS) for c in ycols):
                raise TpuDecline("a pipe reduction is pushed down only "
                                 "onto a GO with no WHERE, no DISTINCT "
                                 "and meta-only YIELD columns")
        alias_to_etype = {a: et for et, a in etype_to_alias.items()}
        plan = self._plan_go(space_id, alias_to_etype, where_expr,
                             bool(pushed_mode))
        if plan is None:
            raise TpuDecline("device cannot reproduce this query")
        if plan.filter_cval is not None and not upto and reduce is None \
                and flags.get("tpu_filter_mode") in ("device", "auto"):
            self._bump("go_device")
            self._bump("go_fused")
            return self._execute_fused(space_id, plan, start_vids, et_tuple,
                                       int(steps), etype_to_alias, ycols,
                                       bool(distinct), where_expr,
                                       DeviceExecError)
        return self._dispatch_go(
            space_id, et_tuple, steps, upto, reduce, limit,
            _GoQuery(start_vids, plan, ycols, bool(distinct), where_expr,
                     etype_to_alias))

    def _plan_go(self, space_id: int, alias_to_etype: Dict[str, int],
                 where_expr: Optional[Expression],
                 pushed_mode: bool) -> Optional[_GoPlan]:
        """Compile a GO plan against the space's mirror, or None when
        the device can't reproduce the CPU semantics (runtime.py:1200):
        an uncompilable WHERE, a rank column beyond int32, or div guards
        in graphd mode (the device cannot raise on a real x/0)."""
        m = self.mirror(space_id)
        if m is None:
            return None
        filter_cval = None
        filter_used: Dict[str, Tuple] = {}
        compiler = ExprCompiler(m, space_id, self._schema(space_id),
                                alias_to_etype)
        if where_expr is not None:
            try:
                filter_cval = compiler.compile(where_expr)
            except CompileError:
                return None
            filter_used = dict(compiler.used)
            if "rank" in filter_used and not self._rank_device_ok(m):
                return None
            if compiler.div_guards and not pushed_mode:
                return None
        return _GoPlan(
            m, alias_to_etype, filter_cval, filter_used,
            pushed_mode=pushed_mode, compiler=compiler,
            expr_str=(str(where_expr) if where_expr is not None else None),
            sc_or=_filter_has_or(where_expr))

    @staticmethod
    def _rank_device_ok(m: CsrMirror) -> bool:
        """int32-representability of the rank column (runtime.py:1174),
        a host check."""
        return m.m == 0 or bool(m.edge_rank.min() > -2**31
                                and m.edge_rank.max() < 2**31)

    def _device_csr(self, m: CsrMirror) -> Dict[str, Optional[torch.Tensor]]:
        """The edge arrays, their CSR row index ``row_ptr`` (the edge-list
        hop walks the live sources' rows) and the int32 rank (None when
        it does not fit) on this runtime's device, uploaded once per
        mirror (runtime.py:1153 ``_device_csr`` / ``_to_device``)."""
        return self._mirror_cached(m, "_csr_dev_cache",
                                   lambda: self._to_device(m))

    def _to_device(self, m: CsrMirror) -> Dict[str, Optional[torch.Tensor]]:
        dev = {"edge_src": self._up(m.edge_src),
               "edge_dst": self._up(m.edge_dst),
               "edge_etype": self._up(m.edge_etype),
               "row_ptr": self._up(np.ascontiguousarray(m.row_ptr,
                                                        np.int32))}
        dev["rank"] = self._up(m.edge_rank.astype(np.int32)) \
            if self._rank_device_ok(m) else None
        return dev

    def _execute_fused(self, space_id: int, plan: _GoPlan,
                       start_vids: Sequence[int], et_tuple: Tuple[int, ...],
                       steps: int, etype_to_alias: Dict[int, str],
                       yield_cols, distinct: bool, where_expr, ExcType):
        """The fused-filter route (runtime.py:2571): the compiled WHERE
        runs inside the GO program on the card, one query, no
        cross-query batching; the final edge mask and the frontier come
        back and the host materializes the YIELD columns of the kept
        edges in ascending edge order."""
        m = plan.mirror
        columns = [c.alias or default_col_name(c.expr) for c in yield_cols]
        if steps < 1 or not start_vids or m.m == 0:
            return columns, []
        if plan.pushed_mode and plan.sc_or:
            # the kernel ANDs validity into the mask; a disjunction
            # short-circuits past missing props on the CPU path
            for _k, desc in plan.filter_used.items():
                if desc[0] == "edge":
                    col = m.edge_cols[(desc[1], desc[2])]
                elif desc[0] == "vertex":
                    col = m.vertex_cols[(desc[1], desc[2])]
                else:
                    continue
                if not col.valid.all():
                    raise TpuDecline(
                        "fused WHERE with || reads a partially-invalid "
                        "column; CPU short-circuit semantics decide")
        t0 = time.perf_counter()
        start_idx = _pad_pow2(m.to_dense(start_vids))
        final_dev, frontier_dev = self._run_go_kernel(
            m, space_id, steps, et_tuple, plan, start_idx)
        t0 = self._tick("t_fused_launch_s", t0)
        final_mask = self._fetch(final_dev)
        frontier = self._fetch(frontier_dev)
        t0 = self._tick("t_fused_fetch_s", t0)
        idx = np.nonzero(final_mask)[0]
        if not plan.pushed_mode:
            vs = np.nonzero(frontier[:m.n])[0]
            cand_idx = self._frontier_edges(m, vs, et_tuple)
            inv = self._invalid_candidates(m, plan.filter_used, cand_idx)
            if inv is not None and inv.any():
                raise TpuDecline(
                    "WHERE reads a prop invalid on candidate rows; "
                    "CPU short-circuit semantics decide")
        rows = self._materialize(m, space_id, plan.alias_to_etype,
                                 etype_to_alias, yield_cols, idx, ExcType)
        if distinct:
            seen = set()
            out = []
            for r in rows:
                key = tuple(r)
                if key not in seen:
                    seen.add(key)
                    out.append(r)
            rows = out
        self._tick("t_fused_materialize_s", t0)
        return columns, rows

    def _run_go_kernel(self, m: CsrMirror, space_id: int, steps: int,
                       et_tuple: Tuple[int, ...], plan: _GoPlan,
                       start_idx: np.ndarray):
        """Launch ``go`` (no WHERE) or ``go_filtered`` (runtime.py:2725);
        returns the device (final edge mask, frontier)."""
        dev = self._device_csr(m)
        start = self._up(np.ascontiguousarray(start_idx, np.int32))
        if plan.filter_cval is None:
            return edge_ops.go(dev["edge_src"], dev["edge_dst"],
                               dev["edge_etype"], dev["row_ptr"], start, m.n,
                               steps, et_tuple)
        prog = self._filter_program(m, space_id, plan)
        env = self._env_cols(m, plan.alias_to_etype, plan.filter_used,
                             with_valid=plan.pushed_mode)
        slots = [env[key] for key, _kind, _t in prog.slots]
        return edge_ops.go_filtered(dev["edge_src"], dev["edge_dst"],
                                    dev["edge_etype"], dev["row_ptr"], start,
                                    m.n, steps, et_tuple, prog, slots)

    def _filter_program(self, m: CsrMirror, space_id: int, plan: _GoPlan
                        ) -> ExprProgram:
        """The plan's WHERE as an ExprProgram, compiled once per (space,
        mirror, pushed mode, OVER aliases, WHERE text).  A program the
        kernel cannot hold raises TpuDecline."""
        key = (space_id, id(m), m.build_version, plan.pushed_mode,
               tuple(sorted(plan.alias_to_etype.items())), plan.expr_str)
        with self._lock:
            prog = self._programs.get(key)
        if prog is not None:
            return prog
        types = {k: _DEVICE_TYPE[np.dtype(self._col_dtype(m, desc))]
                 for k, desc in plan.filter_used.items()}
        try:
            prog = trace_filter(plan.filter_cval, plan.filter_used,
                                plan.compiler.div_guards, plan.pushed_mode,
                                types)
        except CompileError as e:
            raise TpuDecline(f"WHERE does not lower to the device: {e}")
        with self._lock:
            if len(self._programs) >= 256:
                self._programs.clear()
            return self._programs.setdefault(key, prog)

    @staticmethod
    def _col_dtype(m: CsrMirror, desc: Tuple):
        if desc[0] == "edge":
            return m.edge_cols[(desc[1], desc[2])].device_values().dtype
        if desc[0] == "vertex":
            return m.vertex_cols[(desc[1], desc[2])].device_values().dtype
        return np.int32        # rank, etype_alias, src_idx, dst_idx

    def _env_cols(self, m: CsrMirror, alias_to_etype: Dict[str, int],
                  used: Dict[str, Tuple], with_valid: bool
                  ) -> Dict[str, torch.Tensor]:
        """Device env for a compiled filter: {key: tensor} (+ "valid:key"
        when ``with_valid``); columns upload once per mirror and
        device.  Vertex columns change in place when a vertex write
        commits (``_commit_vertices``), so their entries are keyed by
        the mirror's vertex epoch and uploaded from a copy, the valid
        bits before the values (runtime.py:2799-2817)."""
        cache = self._mirror_cached(m, "_env_dev_cache", dict)
        env: Dict[str, torch.Tensor] = {}
        dev = self._device_csr(m)
        epoch = getattr(m, "_vertex_epoch", 0)

        def cached(key, build):
            t = cache.get(key)
            if t is None:
                t = cache.setdefault(key, self._up(np.array(build(),
                                                            copy=True)))
            return t

        for k, desc in used.items():
            if desc[0] in ("edge", "vertex"):
                col = m.edge_cols[(desc[1], desc[2])] \
                    if desc[0] == "edge" \
                    else m.vertex_cols[(desc[1], desc[2])]
                stamp = (epoch,) if desc[0] == "vertex" else ()
                if with_valid:
                    env["valid:" + k] = cached(("valid", desc[0], desc[1],
                                                desc[2]) + stamp,
                                               lambda c=col: c.valid)
                env[k] = cached((desc[0], desc[1], desc[2]) + stamp,
                                lambda c=col: c.device_values())
            elif desc[0] == "rank":
                env["rank"] = dev["rank"]
            elif desc[0] == "etype_alias":
                akey = ("etype_alias",) + tuple(sorted(
                    alias_to_etype.items()))
                env["etype_alias"] = cached(
                    akey, lambda: self._etype_alias_codes(m, alias_to_etype))
            elif desc[0] == "src_idx":
                env["src_idx"] = dev["edge_src"]
            elif desc[0] == "dst_idx":
                env["dst_idx"] = dev["edge_dst"]
        return env

    @staticmethod
    def _etype_alias_codes(m: CsrMirror,
                           alias_to_etype: Dict[str, int]) -> np.ndarray:
        """int32[m]: per-edge code into the sorted alias dictionary
        (runtime.py:2815), cached per mirror and alias map."""
        cache = getattr(m, "_alias_code_cache", None)
        if cache is None:
            cache = m._alias_code_cache = {}
        key = tuple(sorted(alias_to_etype.items()))
        codes = cache.get(key)
        if codes is not None:
            return codes
        if len(cache) >= 8:
            cache.clear()
        alias_pos = {a: i for i, a in enumerate(sorted(alias_to_etype))}
        codes = np.zeros(m.m, dtype=np.int32)
        for a, et in alias_to_etype.items():
            codes[m.edge_etype == et] = alias_pos[a]
        cache[key] = codes
        return codes

    def _frontier_edges(self, m: CsrMirror, vs: np.ndarray,
                        et_tuple: Tuple[int, ...]) -> np.ndarray:
        """Final-hop candidate edges of the frontier vertices ``vs`` as
        an ascending index array (runtime.py:2866)."""
        idx, _, _ = self._frontier_edges_multi(m, [vs], et_tuple)
        return idx

    @staticmethod
    def _invalid_candidates(m: CsrMirror, used: Dict[str, Tuple],
                            cand: np.ndarray) -> Optional[np.ndarray]:
        """bool[cand]: the candidate edge reads an invalid used prop
        (runtime.py:2552), or None when nothing is used."""
        if not used or len(cand) == 0:
            return None
        inv = np.zeros(len(cand), dtype=bool)
        for _k, desc in used.items():
            if desc[0] == "edge":
                col = m.edge_cols[(desc[1], desc[2])]
                inv |= ~col.valid[cand]
            elif desc[0] == "vertex":
                col = m.vertex_cols[(desc[1], desc[2])]
                gather = m.edge_src[cand] if desc[3] == "src" \
                    else m.edge_dst[cand]
                inv |= ~col.valid[gather]
        return inv

    def _gather_cols(self, m: CsrMirror, alias_to_etype: Dict[str, int],
                     used: Dict[str, Tuple],
                     idx: np.ndarray) -> Dict[str, np.ndarray]:
        """numpy columns over edge rows ``idx`` for host evaluation of
        compiled expressions (runtime.py:2620)."""
        cols: Dict[str, np.ndarray] = {}
        for k, desc in used.items():
            if desc[0] == "edge":
                cols[k] = m.edge_cols[(desc[1], desc[2])].values[idx]
            elif desc[0] == "vertex":
                col = m.vertex_cols[(desc[1], desc[2])]
                gather = m.edge_src[idx] if desc[3] == "src" \
                    else m.edge_dst[idx]
                cols[k] = col.values[gather]
            elif desc[0] == "rank":
                cols["rank"] = m.edge_rank[idx]
            elif desc[0] == "src_idx":
                cols["src_idx"] = m.edge_src[idx]
            elif desc[0] == "dst_idx":
                cols["dst_idx"] = m.edge_dst[idx]
            elif desc[0] == "etype_alias":
                cols["etype_alias"] = \
                    self._etype_alias_codes(m, alias_to_etype)[idx]
        return cols

    def _materialize(self, m: CsrMirror, space_id: int,
                     alias_to_etype: Dict[str, int],
                     etype_to_alias: Dict[int, str], yield_cols,
                     idx: np.ndarray, exc_type) -> List[List[object]]:
        """YIELD columns of the kept edges ``idx`` (runtime.py:3002):
        numpy at full int64 / float64 precision when every column
        compiles, else per-row evaluation, which reproduces the CPU
        executor's errors."""
        if len(idx) == 0:
            return []
        compiler = ExprCompiler(m, space_id, self._schema(space_id),
                                alias_to_etype)
        try:
            cvals = [compiler.compile(c.expr) for c in yield_cols]
        except CompileError:
            return self._materialize_per_row(
                m, space_id, alias_to_etype, etype_to_alias, yield_cols,
                idx, exc_type)
        inv = self._invalid_candidates(m, compiler.used, idx)
        if inv is not None and inv.any():
            return self._materialize_per_row(
                m, space_id, alias_to_etype, etype_to_alias,
                yield_cols, idx, exc_type)
        env = Env(np, self._gather_cols(m, alias_to_etype, compiler.used,
                                        idx))
        for g in compiler.div_guards:
            if np.any(g(env)):
                return self._materialize_per_row(
                    m, space_id, alias_to_etype, etype_to_alias,
                    yield_cols, idx, exc_type)
        out_cols: List[List[object]] = []
        k_edges = len(idx)
        for cv, yc in zip(cvals, yield_cols):
            arr = cv.fn(env)
            out_cols.append(_col_tolist(
                self._decode_col(m, cv, yc, arr, idx, k_edges,
                                 etype_to_alias)))
        if len(out_cols) == 1:
            return [[v] for v in out_cols[0]]
        return [list(t) for t in zip(*out_cols)]

    @staticmethod
    def _decode_col(m: CsrMirror, cv: CVal, yc, arr, idx: np.ndarray,
                    k: int, etype_to_alias: Dict[int, str]):
        """One YIELD column -> a flat column container (runtime.py:3049)."""
        if cv.kind == K_VIDRANK:
            return m.vids[np.asarray(arr)]
        if cv.kind == K_STR:
            return ConstCol(cv.const, k)
        if cv.kind == K_STRCODE:
            return DictCol(np.asarray(arr),
                           [str(v) for v in cv.dictionary])
        a = np.broadcast_to(np.asarray(arr), (k,))
        if cv.kind == K_BOOL:
            return a.astype(bool)
        if cv.kind == K_FLOAT:
            return a.astype(np.float64)
        return a.astype(np.int64)

    def _materialize_per_row(self, m: CsrMirror, space_id: int,
                             alias_to_etype: Dict[str, int],
                             etype_to_alias: Dict[int, str], yield_cols,
                             idx: np.ndarray, exc_type
                             ) -> List[List[object]]:
        """Row-at-a-time evaluation with the CPU executor's getter
        semantics (runtime.py:3067)."""
        schema = self._schema(space_id)
        tag_ids: Dict[str, Optional[int]] = {}

        def tag_id(tag: str) -> Optional[int]:
            if tag not in tag_ids:
                r = schema.to_tag_id(space_id, tag)
                tag_ids[tag] = r.value() if r.ok() else None
            return tag_ids[tag]

        rows = []
        for e in idx.tolist():
            src_i, dst_i = int(m.edge_src[e]), int(m.edge_dst[e])
            et = int(m.edge_etype[e])
            ctx = ExprContext()

            def vget(which_i, tag, prop):
                t = tag_id(tag)
                col = m.vertex_cols.get((t, prop)) if t is not None else None
                if col is None or not col.valid[which_i]:
                    raise ExprError(f"{tag}.{prop} unavailable")
                return col.host_value(which_i)

            ctx.get_src_tag_prop = lambda tag, prop, _i=src_i: \
                vget(_i, tag, prop)
            ctx.get_dst_tag_prop = lambda tag, prop, _i=dst_i: \
                vget(_i, tag, prop)

            def eget(alias, prop, _e=e, _et=et):
                col = m.edge_cols.get((_et, prop))
                if col is None or not col.valid[_e]:
                    raise ExprError(f"{alias}.{prop} unavailable")
                return col.host_value(_e)

            ctx.get_alias_prop = eget
            ctx.get_edge_dst_id = lambda a, _i=dst_i: int(m.vids[_i])
            ctx.get_edge_src_id = lambda a, _i=src_i: int(m.vids[_i])
            ctx.get_edge_rank = lambda a, _e=e: int(m.edge_rank[_e])
            ctx.get_edge_type = lambda a, _et=et: \
                etype_to_alias.get(_et, str(_et))
            try:
                rows.append([c.expr.eval(ctx) for c in yield_cols])
            except ExprError as ex:
                raise exc_type(str(ex))
        return rows

    # ------------------------------------------------ batch entry point
    def go_batch_execute(self, space_id: int, queries: List[_GoQuery],
                         et_tuple: Tuple[int, ...], steps: int,
                         upto: bool = False, reduce=None) -> _Pending:
        """Dispatcher leader entry: one device launch for the whole
        batch's frontier advance, then one vectorized host pass per
        (WHERE, YIELD, mode) signature group (``_assemble_results``).
        The returned _Pending's finish() yields (results, mirror),
        results[i] being (columns, rows) or an Exception for that query
        alone (the dispatcher raises it only for its own waiter)."""
        t0 = time.perf_counter()
        launch = self._launch_frontiers(
            space_id, [q.start_vids for q in queries], et_tuple, steps,
            upto=upto, reduce=reduce)
        self._tick("t_launch_s", t0)

        def finish():
            t1 = time.perf_counter()
            vs_lists, m = launch()
            t1 = self._tick("t_fetch_s", t1)
            if reduce is not None and reduce[0] == "count":
                results = self._count_results(m, vs_lists, et_tuple)
                self._bump("go_reduced", len(queries))
            else:
                if reduce is not None:       # LIMIT: the caller slices
                    self._bump("go_reduced", len(queries))
                results = self._assemble_results(space_id, m, queries,
                                                 vs_lists, et_tuple)
            self._tick("t_assemble_s", t1)
            return results, m

        return _Pending(finish)

    def go_batch(self, space_id: int, starts_per_query,
                 etypes: Sequence[int], steps: int) -> np.ndarray:
        """Run B concurrent multi-hop GOs; returns bool [B, n] final
        frontiers (the final-hop *destinations*, i.e. ``steps``
        advances — the kernel's steps counts like kernels._go_body, so
        pass steps + 1) in the mirror's dense-id space.  Oversized
        batches run in go_batch_max chunks."""
        et_tuple = tuple(sorted(set(int(e) for e in etypes)))
        self._bump("go_device", len(starts_per_query))
        if not starts_per_query:
            m = self.mirror(space_id)
            return np.zeros((0, 0 if m is None else m.n), dtype=bool)
        max_b = int(flags.get("go_batch_max") or 1024)
        outs = []
        for lo in range(0, len(starts_per_query), max_b):
            out, _ = self._go_batch_frontiers(
                space_id, starts_per_query[lo:lo + max_b], et_tuple,
                steps + 1)
            outs.append(out)
        return np.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]

    def _go_batch_frontiers(self, space_id: int, starts_per_query,
                            et_tuple: Tuple[int, ...], kernel_steps: int):
        """``kernel_steps - 1`` frontier advances for B queries; returns
        (bool [B, n] frontiers in dense-id space, mirror)."""
        resolver = self._launch_frontiers(space_id, starts_per_query,
                                          et_tuple, kernel_steps)
        vs_lists, m = resolver()
        out = np.zeros((len(starts_per_query), m.n), dtype=bool)
        for q, vs in enumerate(vs_lists):
            out[q, vs] = True
        return out, m

    # ------------------------------------- continuous dispatch seam
    def continuous_session(self, space_id: int,
                           et_tuple: Tuple[int, ...],
                           min_lanes: int = 1
                           ) -> Optional["_ContinuousGoSession"]:
        """Anchor one device session for a (space, OVER set) stream over
        the current mirror, on the smallest ``go_batch_widths`` rung
        covering ``min_lanes``; None for an empty or unloaded space or
        with ``tpu_packed_frontier`` off (runtime.py:1529: the session's
        carriers are packed only) or on a mesh (runtime.py:1531-1534:
        the replicated-frontier kernels have no resident-lane protocol,
        so the stream is refused and GO serves windowed through the
        mesh; the flag alone decides, and no mesh state is built)."""
        if not flags.get("tpu_packed_frontier", True):
            return None
        if int(flags.get("tpu_mesh_devices") or 0) > 1:
            return None
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
        """Post-frontier half for a leave cohort (runtime.py:1555): COUNT
        riders fold the cached degree vector over their frontier, the
        rest (LIMIT riders too: their caller slices; UPTO unions) run
        the windowed leader's grouped assembly.  results[i] is
        (columns, rows) or an Exception for that rider alone."""
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
                space_id, m, [queries[i] for i in other_idx],
                [vs_lists[i] for i in other_idx], et_tuple)
            n_lim = 0
            for j, i in enumerate(other_idx):
                results[i] = sub[j]
                n_lim += reduces[i] is not None
            if n_lim:
                self._bump("go_reduced", n_lim)
        return results

    def _count_results(self, m: CsrMirror, vs_lists,
                       et_tuple: Tuple[int, ...]):
        """Per-query COUNT(*): either the card already counted
        (_DeviceCounts) or the fetched frontier lists fold through the
        cached per-vertex degree vector."""
        if isinstance(vs_lists, _DeviceCounts):
            counts = vs_lists.arr.tolist()
        else:
            deg = self._deg_host(m, et_tuple)
            counts = [int(deg[vs].sum()) if len(vs) else 0
                      for vs in vs_lists]
        return [(["__count__"], [[int(c)]]) for c in counts]

    def _assemble_results(self, space_id: int, m: CsrMirror,
                          queries: List[_GoQuery], vs_lists,
                          et_tuple: Tuple[int, ...]):
        """Vectorized final hop for a batch (runtime.py:2431): queries
        grouped by (WHERE, pushed mode, OVER aliases, YIELD, DISTINCT)
        signature, then per group ONE candidate assembly, filter and
        materialization over the concatenated frontier, split back per
        query.  A group's failure reaches only its own riders."""
        results: List[object] = [None] * len(queries)
        groups: Dict[Tuple, List[int]] = {}
        for i, q in enumerate(queries):
            sig = (q.plan.expr_str, q.plan.pushed_mode,
                   tuple(sorted(q.plan.alias_to_etype.items())),
                   tuple((str(c.expr), c.alias) for c in q.yield_cols),
                   q.distinct)
            groups.setdefault(sig, []).append(i)
        for idxs in groups.values():
            try:
                self._assemble_group(space_id, m, queries, idxs, vs_lists,
                                     et_tuple, results)
            except Exception as ex:     # noqa: BLE001 — group-level
                for i in idxs:
                    if results[i] is None:
                        results[i] = ex
        return results

    def _assemble_group(self, space_id: int, m: CsrMirror,
                        queries: List[_GoQuery], idxs: List[int],
                        vs_lists, et_tuple: Tuple[int, ...],
                        results: List[object]) -> None:
        """One signature group's host half (runtime.py:2457): the WHERE
        recompiled against the dispatch's mirror when planning raced a
        generation bump; the queries whose candidates read an invalid
        used prop decline alone (graphd mode, or a pushed ``||``) and
        their rows leave before the group mask; then ``_host_filter``,
        ``_materialize_group`` and DISTINCT per query (first occurrence
        kept)."""
        rep = queries[idxs[0]]
        plan = rep.plan
        columns = [c.alias or default_col_name(c.expr)
                   for c in rep.yield_cols]
        vs_group = [vs_lists[i] for i in idxs]
        if plan.mirror is not m and plan.filter_cval is not None:
            compiler = ExprCompiler(m, space_id, self._schema(space_id),
                                    plan.alias_to_etype)
            try:
                cval = compiler.compile(rep.where_expr)
            except CompileError:
                for i in idxs:
                    results[i] = DeviceExecError(
                        "schema changed while the query ran")
                return
            plan = _GoPlan(m, plan.alias_to_etype, cval,
                           dict(compiler.used), plan.pushed_mode,
                           compiler, plan.expr_str, sc_or=plan.sc_or)
        cand, qseg, _qb = self._frontier_edges_multi(m, vs_group, et_tuple)
        bad = np.zeros(len(idxs), dtype=bool)
        if plan.filter_cval is not None \
                and (not plan.pushed_mode or plan.sc_or):
            # a mask cannot reproduce the CPU executor's short-circuit
            # order over an invalid prop: the affected queries decline,
            # and their rows leave before the group mask, which would
            # otherwise raise for the whole group
            invalid = self._invalid_candidates(m, plan.filter_used, cand)
            if invalid is not None and invalid.any():
                hit = np.unique(qseg[invalid])
                bad[hit] = True
                for g in hit:
                    results[idxs[int(g)]] = TpuDecline(
                        "WHERE reads a prop invalid on candidate rows; "
                        "CPU short-circuit semantics decide")
                keep_rows = ~bad[qseg]
                cand, qseg = cand[keep_rows], qseg[keep_rows]
        if plan.filter_cval is not None:
            mask = self._host_filter(m, plan, cand)
            cand, qseg = cand[mask], qseg[mask]
        qb = np.searchsorted(qseg, np.arange(len(idxs) + 1))
        rows_per_query = self._materialize_group(
            m, space_id, plan.alias_to_etype, rep.etype_to_alias,
            rep.yield_cols, cand, qseg, qb, len(idxs))
        for g, i in enumerate(idxs):
            rows = rows_per_query[g]
            if bad[g] or isinstance(rows, Exception):
                if results[i] is None:
                    results[i] = rows if isinstance(rows, Exception) \
                        else DeviceExecError("prop unavailable in WHERE")
                continue
            if queries[i].distinct:
                seen = set()
                out = []
                for r in rows:
                    key = tuple(r)
                    if key not in seen:
                        seen.add(key)
                        out.append(r)
                rows = out
            results[i] = (columns, rows)

    def _host_filter(self, m: CsrMirror, plan: _GoPlan,
                     idx: np.ndarray) -> np.ndarray:
        """The compiled WHERE over candidate edges ``idx`` in numpy
        int64 / float64 (runtime.py:2666): the CPU executor's exact
        precision, with pushed mode's validity and div-guard semantics.
        Returns a bool mask."""
        if len(idx) == 0:
            return np.zeros(0, dtype=bool)
        # pushed-mode validity is snapshotted BEFORE the value gather: a
        # vertex write commits values first and valid bits last, so a
        # valid bit read here is never fresher than the value it gates
        valid_snap: Dict[str, np.ndarray] = {}
        if plan.pushed_mode:
            for k, desc in plan.filter_used.items():
                if desc[0] == "edge":
                    valid_snap[k] = \
                        m.edge_cols[(desc[1], desc[2])].valid[idx]
                elif desc[0] == "vertex":
                    gather = m.edge_src[idx] if desc[3] == "src" \
                        else m.edge_dst[idx]
                    valid_snap[k] = \
                        m.vertex_cols[(desc[1], desc[2])].valid[gather]
            if plan.sc_or and valid_snap \
                    and not all(v.all() for v in valid_snap.values()):
                # `x || missing` keeps the row on the per-row path
                # without touching the prop; an AND with validity cannot
                raise TpuDecline(
                    "pushed WHERE with || over a partially-valid "
                    "prop; per-row short-circuit semantics decide")
        env = Env(np, self._gather_cols(m, plan.alias_to_etype,
                                        plan.filter_used, idx))
        with np.errstate(divide="ignore", invalid="ignore"):
            mask = np.broadcast_to(np.asarray(plan.filter_cval.fn(env)),
                                   idx.shape)
            if mask.dtype != np.bool_:
                # a numeric WHERE keeps a nonzero row, and the caller
                # indexes with the mask, so it is always bool
                mask = mask != 0
            else:
                mask = mask.copy()
            for g in plan.compiler.div_guards:
                # a real x/0 drops the row in pushed mode (_plan_go
                # declines div guards in graphd mode)
                mask &= ~np.broadcast_to(np.asarray(g(env)), idx.shape)
        if plan.pushed_mode:
            for v in valid_snap.values():
                mask &= v
        return mask

    def _materialize_group(self, m: CsrMirror, space_id: int,
                           alias_to_etype: Dict[str, int],
                           etype_to_alias: Dict[int, str], yield_cols,
                           idx: np.ndarray, qseg: np.ndarray,
                           qbounds: np.ndarray, nq: int) -> List[object]:
        """A signature group's YIELD (runtime.py:2923): one compile and
        one column evaluation over the group's kept edges, split per
        query as ``ColumnarRows``.  A query whose rows are irregular (an
        invalid prop, a live div guard) and every query of a YIELD that
        does not compile fall back to ``_materialize`` alone, its result
        or error its own.  Returns per query rows or an Exception."""
        def slice_q(g):
            return idx[qbounds[g]:qbounds[g + 1]]

        def alone(g):
            try:
                return self._materialize(
                    m, space_id, alias_to_etype, etype_to_alias,
                    yield_cols, slice_q(g), DeviceExecError)
            except Exception as ex:     # noqa: BLE001 — per query
                return ex

        if len(idx) == 0:
            return [[] for _ in range(nq)]
        compiler = ExprCompiler(m, space_id, self._schema(space_id),
                                alias_to_etype)
        try:
            cvals = [compiler.compile(c.expr) for c in yield_cols]
        except CompileError:
            return [alone(g) for g in range(nq)]
        irregular = np.zeros(nq, dtype=bool)
        inv = self._invalid_candidates(m, compiler.used, idx)
        if inv is not None and inv.any():
            irregular[np.unique(qseg[inv])] = True
        if irregular.all():
            return [alone(g) for g in range(nq)]
        env = Env(np, self._gather_cols(m, alias_to_etype, compiler.used,
                                        idx))
        if compiler.div_guards:
            g_any = np.zeros(len(idx), dtype=bool)
            for guard in compiler.div_guards:
                g_any |= np.broadcast_to(np.asarray(guard(env)), idx.shape)
            if g_any.any():
                irregular[np.unique(qseg[g_any])] = True
        k_edges = len(idx)
        out_cols = [self._decode_col(m, cv, yc, cv.fn(env), idx, k_edges,
                                     etype_to_alias)
                    for cv, yc in zip(cvals, yield_cols)]
        results: List[object] = [None] * nq
        for g in range(nq):
            if irregular[g]:
                results[g] = alone(g)
                continue
            lo, hi = int(qbounds[g]), int(qbounds[g + 1])
            results[g] = ColumnarRows([c[lo:hi] for c in out_cols], hi - lo)
        return results

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

    def _deg_dev(self, m: CsrMirror, ix: EllIndex,
                 et_tuple: Tuple[int, ...]) -> torch.Tensor:
        """int32[n_rows+1] NEW-id-space device copy of _deg_host (zero
        for hub extra rows and the pad row, so junk extras never
        count), cached per (mirror, OVER) and device."""
        cache = getattr(m, "_deg_dev_cache", None)
        if cache is None:
            cache = m._deg_dev_cache = {}
        key = (et_tuple, str(self.device))
        dev = cache.get(key)
        if dev is None:
            if len(cache) >= 8:
                cache.clear()
            deg = np.zeros(ix.n_rows + 1, np.int32)
            deg[ix.perm] = np.minimum(self._deg_host(m, et_tuple),
                                      2**31 - 1).astype(np.int32)
            dev = cache[key] = torch.from_numpy(deg).to(self.device)
        return dev

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

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Copy a device result to the host (blocking), accounting its
        bytes and the wait."""
        t0 = time.perf_counter()
        host = t.cpu().numpy()
        self._note_fetch(host, time.perf_counter() - t0)
        return host

    # ------------------------------------------------ frontier launch
    @staticmethod
    def _sparse_ladder() -> List[int]:
        """The pinned sparse start-capacity ladder (ascending)."""
        return sorted(int(x) for x in
                      str(flags.get("tpu_sparse_c0s") or
                          "256,2048").split(",") if x.strip())

    @classmethod
    def _sparse_c0(cls, total_starts: int) -> Optional[int]:
        """Smallest pinned sparse start-capacity holding the batch, or
        None when the batch is empty / outgrows the ladder."""
        if total_starts <= 0:
            return None
        for w in cls._sparse_ladder():
            if total_starts <= w:
                return w
        return None

    @staticmethod
    def _batch_width(nq: int) -> int:
        """Pad the query count to a pinned ladder width
        (``go_batch_widths``), as the reference does to keep its set of
        program shapes small; past the ladder, the next power of two."""
        for w in _ladder():
            if nq <= w:
                return w
        return max(_ladder()[-1], 1 << (nq - 1).bit_length())

    def _launch_frontiers(self, space_id: int, starts_per_query,
                          et_tuple: Tuple[int, ...], steps: int,
                          upto: bool = False, reduce=None):
        """Start the device work for ``steps - 1`` frontier advances of
        B queries; returns a zero-arg resolver -> (per-query ascending
        dense-id frontier arrays, or _DeviceCounts, and the mirror).
        The reference's selection order (runtime.py:1664-1693):
        host-only (steps == 1) → mesh → sparse pair-list → sparse split
        → adaptive single → dense bit-packed.  On a mesh in
        ``tpu_mesh_mode=sparse`` a batch with a sparse rung and no UPTO
        runs ``mesh_sparse_go`` (runtime.py:1648-1662); every other
        mesh batch, and one whose starts outgrow a shard's share, runs
        ``ell_go_sharded``, and the single-device sparse, split and
        adaptive routes stay off.  ``upto`` returns the UNION of depths
        0..steps-1."""
        m = self.mirror(space_id)
        if m is None:
            raise TpuDecline(f"space {space_id} is not loaded")
        nq = len(starts_per_query)
        if steps < 1:
            empty = [np.zeros(0, np.int64)] * nq
            return lambda: (empty, m)

        # one flat (dense id, query) vector, deduped by one lexsort
        lens = [len(s) for s in starts_per_query]
        flat: List[int] = []
        for s in starts_per_query:
            flat.extend(int(v) for v in s)
        d_all = m.to_dense(np.asarray(flat, dtype=np.int64))
        q_all = np.repeat(np.arange(nq, dtype=np.int64),
                          np.asarray(lens, np.int64))
        keep = d_all >= 0
        d_all, q_all = d_all[keep].astype(np.int64), q_all[keep]
        order = np.lexsort((d_all, q_all))
        d_all, q_all = d_all[order], q_all[order]
        if len(d_all):
            first = np.ones(len(d_all), dtype=bool)
            first[1:] = (q_all[1:] != q_all[:-1]) | (d_all[1:] != d_all[:-1])
            d_all, q_all = d_all[first], q_all[first]
        qbounds = np.searchsorted(q_all, np.arange(nq + 1))

        if steps == 1 or m.m == 0:
            # frontier before the final hop IS the start set
            starts_v = [d_all[qbounds[q]:qbounds[q + 1]]
                        for q in range(nq)]
            return lambda: (starts_v, m)

        ix = self.ell(m)
        c0 = self._sparse_c0(len(d_all))
        mesh = self._mesh_only()
        if mesh is not None and c0 is not None and not upto \
                and flags.get("tpu_mesh_mode") == "sparse":
            # the dense replicated-frontier tables are NOT built here;
            # the dense fallback builds them on overflow only
            launched = self._launch_mesh_sparse(m, ix, d_all, q_all, nq,
                                                et_tuple, steps, c0, mesh)
            if launched is not None:
                return launched
            # start placement outgrew a shard's share: the dense mesh
        mesh_mt = self._mesh_tables(m, ix) if mesh is not None else None
        if mesh_mt is not None:
            return self._launch_dense(m, ix, d_all, q_all, nq, et_tuple,
                                      steps, upto=upto, reduce=reduce,
                                      mesh_mt=mesh_mt)
        if flags.get("tpu_sparse_go") and c0 is not None:
            return self._launch_sparse(m, ix, d_all, q_all, nq, et_tuple,
                                       steps, c0, upto=upto, reduce=reduce)
        if flags.get("tpu_sparse_go") and c0 is None and nq > 1:
            # total starts outgrew the sparse ladder: split at query
            # boundaries into ladder-sized sparse launches; only a query
            # that alone outgrows the ladder sends the batch dense
            launched = self._launch_sparse_split(
                m, ix, d_all, q_all, nq, et_tuple, steps, qbounds,
                upto=upto, reduce=reduce)
            if launched is not None:
                return launched
        if nq == 1 and not upto and reduce is None \
                and flags.get("tpu_adaptive_single") \
                and len(d_all) <= int(flags.get("tpu_adaptive_k") or 2048):
            return self._launch_adaptive(m, ix, d_all, et_tuple, steps)
        return self._launch_dense(m, ix, d_all, q_all, nq, et_tuple, steps,
                                  upto=upto, reduce=reduce)

    def _launch_mesh_sparse(self, m: CsrMirror, ix: EllIndex,
                            d_all: np.ndarray, q_all: np.ndarray, nq: int,
                            et_tuple: Tuple[int, ...], steps: int, c0: int,
                            mesh: PartsMesh):
        """The frontier-sharded GO (runtime.py:1930-1990): the starts
        placed on the shards owning them (one upload a card),
        ``mesh_sparse_go`` on the mesh, its output fetched in one copy
        when the shards share a card; None when a shard's share
        outgrows ``c0`` (the caller runs the dense mesh).  The resolver
        merges the shards' pairs and re-sorts them by (query, old id),
        or, when the program overflowed, reruns the batch on
        ``ell_go_sharded`` with no reduction (COUNT(*) and LIMIT then
        apply on the host)."""
        st = self._sharded_tables(m, ix, mesh)
        placed = split_start_pairs_by_owner(
            st, ix.perm[d_all].astype(np.int32),
            q_all.astype(np.int32), c0)
        if placed is None:
            return None
        d_max = max(ix.bucket_D) if ix.bucket_D else 1
        cap = int(flags.get("tpu_sparse_cap") or (1 << 17))
        caps = sparse_caps(c0, d_max, steps, cap,
                           growth=int(flags.get("tpu_sparse_growth") or 8))
        k = mesh.k
        cap_x = max(256, caps[-1] // max(k // 2, 1))
        cap_e = max(64, c0)
        outs = ell_ops.mesh_sparse_go(
            *self._up_shards(st, placed[0], placed[1]), st, et_tuple, steps,
            caps, cap_x, cap_e, max(nq, 1))
        self._bump("go_mesh_sparse")

        def resolve():
            overflow, qids, vids_new = sharded_sparse_pairs(
                self._fetch(mesh.stacked(outs)))
            if overflow:
                self._bump("sparse_overflows")
                return self._launch_dense(m, ix, d_all, q_all, nq,
                                          et_tuple, steps,
                                          mesh_mt=self._mesh_tables(m, ix))()
            vs_old = ix.inv[vids_new].astype(np.int64)
            order2 = np.lexsort((vs_old, qids))
            q2, v2 = qids[order2], vs_old[order2]
            bounds = np.searchsorted(q2, np.arange(nq + 1))
            return [v2[bounds[q]:bounds[q + 1]] for q in range(nq)], m

        return resolve

    def _launch_sparse_split(self, m: CsrMirror, ix: EllIndex,
                             d_all: np.ndarray, q_all: np.ndarray, nq: int,
                             et_tuple: Tuple[int, ...], steps: int,
                             qbounds: np.ndarray, upto: bool = False,
                             reduce=None):
        """Greedy query-boundary split of an over-wide batch into sparse
        launches, each within the c0 ladder (runtime.py:1695); all are
        enqueued back to back and the resolver stitches the per-query
        results in submission order.  None when one query alone
        outgrows the ladder (only the dense pull can hold it)."""
        cap_max = max(self._sparse_ladder())
        groups: List[Tuple[int, int]] = []
        lo = 0
        while lo < nq:
            hi = lo + 1
            while hi < nq and qbounds[hi + 1] - qbounds[lo] <= cap_max:
                hi += 1
            if qbounds[hi] - qbounds[lo] > cap_max:
                return None          # one query alone outgrows the ladder
            groups.append((lo, hi))
            lo = hi
        parts = []
        for g_lo, g_hi in groups:
            seg = slice(int(qbounds[g_lo]), int(qbounds[g_hi]))
            d_seg = d_all[seg]
            q_seg = q_all[seg] - g_lo
            c0g = self._sparse_c0(len(d_seg))
            if c0g is None:          # empty group (queries w/o starts)
                parts.append((g_lo, g_hi, None))
                continue
            parts.append((g_lo, g_hi, self._launch_sparse(
                m, ix, d_seg, q_seg, g_hi - g_lo, et_tuple, steps, c0g,
                upto=upto, reduce=reduce)))
        self._bump("go_sparse_split")

        def resolve():
            if reduce is not None and reduce[0] == "count":
                # count launches resolve to _DeviceCounts (device- or
                # dense-rerun counted): stitch the per-query numbers
                counts = np.zeros(nq, np.int64)
                for g_lo, g_hi, r in parts:
                    if r is None:
                        continue        # start-less queries count 0
                    vals, mm = r()
                    if isinstance(vals, _DeviceCounts):
                        counts[g_lo:g_hi] = vals.arr
                    else:               # defensive: vertex lists
                        deg = self._deg_host(mm, et_tuple)
                        counts[g_lo:g_hi] = [
                            int(deg[np.asarray(v, np.int64)].sum())
                            if len(v) else 0 for v in vals]
                return _DeviceCounts(counts), m
            out: List[np.ndarray] = [np.zeros(0, np.int64)] * nq
            for g_lo, g_hi, r in parts:
                if r is None:
                    continue
                vs, _mm = r()
                out[g_lo:g_hi] = vs
            return out, m

        return resolve

    def _launch_sparse(self, m: CsrMirror, ix: EllIndex, d_all: np.ndarray,
                       q_all: np.ndarray, nq: int,
                       et_tuple: Tuple[int, ...], steps: int, c0: int,
                       upto: bool = False, reduce=None):
        """The sparse pair-list route (runtime.py:1806): the starts in
        per-query new-id order, ``sparse_go`` (``limit``: the LIMIT
        pushdown; ``count``: per-query counts) on the card; the
        resolver decodes the pairs and re-sorts them by (query, old
        id), or reruns the batch dense when the program overflowed.
        Unlike the reference, whose COUNT variant is built without
        ``upto`` (its front end never sends UPTO with a count), the
        count here folds the UPTO union, as the dense route's does."""
        d_max = max(ix.bucket_D) if ix.bucket_D else 1
        cap = int(flags.get("tpu_sparse_cap") or (1 << 17))
        caps = sparse_caps(c0, d_max, steps, cap,
                           growth=int(flags.get("tpu_sparse_growth") or 8))
        if upto and caps[-1] < c0:
            # the union starts as the c0 start places padded to the
            # final cap (the reference cannot build this shape)
            return self._launch_dense(m, ix, d_all, q_all, nq, et_tuple,
                                      steps, upto=upto, reduce=reduce)
        qmax = max(int(flags.get("go_batch_max") or 1024), nq)
        limit = int(reduce[1]) if reduce is not None \
            and reduce[0] == "limit" else None
        count_mode = reduce is not None and reduce[0] == "count"
        S = len(d_all)
        # the starts as one [2, c0] upload: row 0 the ids, row 1 the qids
        st = np.zeros((2, c0), np.int32)
        st[0] = ix.n_rows
        new = ix.perm[d_all]
        order = np.lexsort((new, q_all))     # per-query ascending new ids
        st[0, :S] = new[order]
        st[1, :S] = q_all[order]
        ecnt, e0 = self._hub_expansion_dev(m, ix)
        deg = self._deg_dev(m, ix, et_tuple) \
            if (limit is not None or count_mode) else None
        st_dev = self._up(st)
        out_dev = ell_ops.sparse_go(
            st_dev[0], st_dev[1], ecnt, e0, deg,
            self._device_tables(m, ix), et_tuple, steps, caps, qmax, nq,
            upto=upto, limit=limit, count=count_mode)
        self._bump("go_sparse")

        def dense():
            self._bump("sparse_overflows")
            return self._launch_dense(m, ix, d_all, q_all, nq, et_tuple,
                                      steps, upto=upto, reduce=reduce)()

        if count_mode:
            def resolve_counts():
                out_host = self._fetch(out_dev)
                if bool(out_host[1]):            # overflow: dense rerun
                    return dense()
                return _DeviceCounts(
                    out_host[2:2 + nq].astype(np.int64)), m
            return resolve_counts

        def resolve():
            out_host = self._fetch(out_dev)
            _cnt, overflow, qids, vids_new = sparse_go_pairs(
                out_host, sparse_pack32(qmax, ix.n_rows), ix.n_rows + 1)
            if overflow:
                return dense()
            vs_old = ix.inv[vids_new].astype(np.int64)
            # by (query, old dense id): the dense route's row order
            order2 = np.lexsort((vs_old, qids))
            qids, vs_old = qids[order2], vs_old[order2]
            bounds = np.searchsorted(qids, np.arange(nq + 1))
            return [vs_old[bounds[q]:bounds[q + 1]] for q in range(nq)], m

        return resolve

    def _launch_adaptive(self, m: CsrMirror, ix: EllIndex,
                         d_all: np.ndarray, et_tuple: Tuple[int, ...],
                         steps: int):
        """The adaptive single-query route (runtime.py:1998):
        ``adaptive_go`` on the card, then the fetched bitmap read in
        old-id order."""
        K = int(flags.get("tpu_adaptive_k") or 2048)
        eslot, hrows = self._hub_merge_dev(m, ix)
        starts = self._up(ix.perm[d_all].astype(np.int32))
        out_dev = ell_ops.adaptive_go(starts, self._hub_dev(m, ix),
                                      self._device_tables(m, ix), eslot,
                                      hrows, et_tuple, steps, K)
        self._bump("go_adaptive")

        def resolve():
            packed = self._fetch(out_dev)
            bitmap = unpack_bits(packed[:, None], ix.n_rows + 1)[:, 0]
            return [np.nonzero(bitmap[ix.perm])[0]], m

        return resolve

    def _launch_dense(self, m: CsrMirror, ix: EllIndex, d_all: np.ndarray,
                      q_all: np.ndarray, nq: int,
                      et_tuple: Tuple[int, ...], steps: int,
                      upto: bool = False, reduce=None,
                      mesh_mt: Optional[MeshTables] = None):
        """The single-chip dense route (runtime.py:2020): upload the
        start lanes, enqueue ``ell_go`` or, for COUNT(*),
        ``ell_go_count``; the resolver fetches the live word columns (or
        the nq counts).  Unlike the reference, whose count kernel is
        built without ``upto`` (its front end never sends UPTO with a
        count reduction), the count here folds the UPTO union, as the
        continuous path's count does.  With ``tpu_packed_frontier``
        off the int8 route runs instead (``_launch_dense_i8``).  Given
        the mesh tables ``mesh_mt`` the batch runs ``ell_go_sharded``
        (runtime.py:2053-2076): always packed, whatever the flag, with
        no count kernel (a COUNT(*) gets the vertex lists and the host
        folds them) and no UPTO (the mesh declines it)."""
        if mesh_mt is None and not flags.get("tpu_packed_frontier", True):
            return self._launch_dense_i8(m, ix, d_all, q_all, nq, et_tuple,
                                         steps, upto)
        if mesh_mt is not None and upto:
            raise TpuDecline("UPTO on a mesh-sharded space")
        B = self._batch_width(nq)
        f0 = self._upload_frontier_packed(ix, ix.perm[d_all],
                                          q_all.astype(np.int32), B)
        count_mode = reduce is not None and reduce[0] == "count" \
            and mesh_mt is None
        if mesh_mt is not None:
            eslot, hrows = self._hub_merge_shards(m, ix, mesh_mt.mesh)
            # the k replicas are equal: shard 0's is the answer
            out_dev = ell_ops.ell_go_sharded(f0, mesh_mt, eslot, hrows,
                                             et_tuple, steps)[0]
            self._bump("go_mesh")
        elif count_mode:
            out_dev = ell_ops.ell_go_count(
                f0, self._deg_dev(m, ix, et_tuple),
                self._device_tables(m, ix), *self._hub_merge_dev(m, ix),
                et_tuple, steps, upto)
        else:
            out_dev = ell_ops.ell_go(f0, self._device_tables(m, ix),
                                     *self._hub_merge_dev(m, ix), et_tuple,
                                     steps, upto)
        self._bump("go_dense")

        if count_mode:
            def resolve_counts():
                counts = self._fetch(out_dev[:nq])
                return _DeviceCounts(counts.astype(np.int64)), m
            return resolve_counts

        def resolve():
            # slice to the live query words ON DEVICE before the fetch
            nwp = min(lanes_width(B), max(1, -(-nq // 8)))
            lanes = self._fetch(out_dev[:, :nwp])   # [R1, nwp] uint8
            return _per_query(unpack_lanes_host(lanes, nq)[ix.perm]), m

        return resolve

    def _launch_dense_i8(self, m: CsrMirror, ix: EllIndex,
                         d_all: np.ndarray, q_all: np.ndarray, nq: int,
                         et_tuple: Tuple[int, ...], steps: int,
                         upto: bool = False):
        """The unpacked dense route (runtime.py:2050-2055, :2106-2115,
        :2139-2144): the int8 start upload, ``ell_go_i8`` with its
        result bit-packed along ROWS (uint8 [ceil(R1 / 8), B]); the
        resolver fetches the first ``nqp`` columns and unpacks them by
        rows.  There is no count kernel on this route (the reference's
        ``count_mode`` needs the packed layout): a COUNT(*) gets the
        vertex lists, and ``_count_results`` or the split's stitch
        folds them on the host."""
        B = self._batch_width(nq)
        f0 = self._upload_frontier(ix, ix.perm[d_all],
                                   q_all.astype(np.int32), B)
        eslot, hrows = self._hub_merge_dev(m, ix)
        out_dev = ell_ops.ell_go_i8(f0, self._device_tables(m, ix), eslot,
                                    hrows, et_tuple, steps, upto, pack=True)
        self._bump("go_dense")

        def resolve():
            # slice to the live query columns ON DEVICE before the fetch
            nqp = min(B, max(8, -(-nq // 8) * 8))
            packed = self._fetch(out_dev[:, :nqp])   # [G, nqp] uint8
            return _per_query(unpack_bits(packed[:, :nq],
                                          ix.n_rows + 1)[ix.perm]), m

        return resolve

    def _upload_frontier(self, ix: EllIndex, new_ids: np.ndarray,
                         qcols: np.ndarray, B: int) -> torch.Tensor:
        """The int8 start frontier [rows+1, B] built ON the card from
        the flat (new-id row, query col) coordinates (runtime.py:3228):
        the list pads to a power of two of at least 8 entries aimed at
        the pad row with value 0; duplicates need no dedup."""
        S = len(new_ids)
        Sp = max(8, 1 << (max(S, 1) - 1).bit_length())
        rows_p = np.full(Sp, ix.n_rows, np.int32)
        cols_p = np.zeros(Sp, np.int32)
        rows_p[:S] = new_ids
        cols_p[:S] = qcols
        out = torch.empty((ix.n_rows + 1, B), dtype=torch.int8,
                          device=self.device)
        return ell_ops.frontier_upload_i8(out, self._up(rows_p),
                                          self._up(cols_p), S)

    def _upload_frontier_packed(self, ix: EllIndex, new_ids: np.ndarray,
                                qcols: np.ndarray, B: int) -> torch.Tensor:
        """The packed start frontier uint8 [rows+1, B/8] built ON the
        card from the flat (new-id row, query col) coordinates
        (runtime.py:3251).  (row, query) pairs are deduped HERE, as the
        reference does, and the dedup leaves them sorted by row and
        lane, the order the kernel takes; they travel as one int32
        [2, S] array (``_up_async``), so nothing here waits on the
        card."""
        out = torch.empty((ix.n_rows + 1, lanes_width(B)), dtype=torch.uint8,
                          device=self.device)
        return ell_ops.frontier_upload(out, self._up_async(
            self._packed_coords(new_ids, qcols, B)))

    @staticmethod
    def _packed_coords(new_ids: np.ndarray, qcols: np.ndarray,
                       B: int) -> np.ndarray:
        """The deduped (row, lane) pairs, sorted, as int32 [2, S]."""
        Bk = max(B, 1)
        key = np.unique(np.asarray(new_ids, np.int64) * Bk
                        + np.asarray(qcols, np.int64))
        return np.stack(np.divmod(key, Bk)).astype(np.int32)

    # ================================================== FIND PATH
    @staticmethod
    def _flat_coords(m: CsrMirror, ix: EllIndex, per_query, nq: int):
        """Per-query vid lists -> flat (new-id rows, query ids) with
        unknown vids dropped."""
        lens = [len(s) for s in per_query]
        flat: List[int] = []
        for s in per_query:
            flat.extend(int(v) for v in s)
        d = m.to_dense(flat)
        q = np.repeat(np.arange(nq, dtype=np.int32),
                      np.asarray(lens, np.int64))
        keep = d >= 0
        return ix.perm[d[keep]], q[keep]

    def _bfs_depths(self, space_id: int, m: CsrMirror, starts_per_query,
                    targets_per_query, et_tuple: Tuple[int, ...],
                    max_steps: int, shortest: bool) -> np.ndarray:
        """Batched BFS core against an already-fetched mirror: int16
        [B, n] depths (INT16_INF = unreached), the single-chip route of
        runtime.py:3319, packed or (``tpu_packed_frontier`` off) int8;
        both give depths [n_rows + 1, B].  On a mesh (runtime.py:3327-
        3351) ``tpu_mesh_mode=sparse`` runs ``mesh_sparse_bfs``
        (``_mesh_sparse_bfs``) and, when its placement or the program
        overflows, the batch runs ``ell_bfs_sharded`` as ``dense`` does,
        packed whatever the flag."""
        mesh = self._mesh_only()
        t0 = time.perf_counter()
        ix = self.ell(m)
        nq = len(starts_per_query)
        B = self._batch_width(nq)
        if mesh is not None and flags.get("tpu_mesh_mode") == "sparse":
            d = self._mesh_sparse_bfs(m, ix, starts_per_query,
                                      targets_per_query, et_tuple,
                                      max_steps, shortest, B, mesh, t0)
            if d is not None:
                return d
            # placement or overflow: the replicated-frontier design
        mt = self._mesh_tables(m, ix) if mesh is not None else None
        # the int8 route (runtime.py:3369-3380) only off the mesh
        packed = mt is not None or flags.get("tpu_packed_frontier", True)
        upload = self._upload_frontier_packed if packed \
            else self._upload_frontier
        f0 = upload(ix, *self._flat_coords(m, ix, starts_per_query, nq), B)
        # the int8 route reads its targets as a lane bitmap: K1 writes it
        # where its rows are whole 4-byte words, else K15's first pass
        # packs K12's carrier
        if not packed and lanes_width(B) % 4 == 0:
            upload = self._upload_frontier_packed
        t0p = upload(ix, *self._flat_coords(m, ix, targets_per_query, nq),
                     B)
        self._bump("path_device", nq)
        if mt is not None:
            self._bump("path_mesh")
            d_dev, levels = ell_ops.ell_bfs_sharded(
                f0, t0p, mt, *self._hub_merge_shards(m, ix, mt.mesh),
                et_tuple, max_steps, stop_when_found=shortest)
        else:
            bfs = ell_ops.ell_bfs if packed else ell_ops.ell_bfs_i8
            d_dev, levels = bfs(f0, t0p, self._device_tables(m, ix),
                                *self._hub_merge_dev(m, ix), et_tuple,
                                max_steps, stop_when_found=shortest)
        nqp = min(B, max(8, -(-nq // 8) * 8))
        host = self._fetch(d_dev[:, :nqp])[:, :nq]   # device slice
        with self._lock:
            self.stats["bfs_dispatches"] += 1
            self.stats["bfs_levels"] += levels
        self._tick("t_bfs_s", t0)
        if host.dtype == np.int8:        # in-kernel compression (-1=INF)
            d = np.where(host < 0, INT16_INF, host).astype(np.int16)
        else:
            d = host
        return ix.to_old(d).T

    def _mesh_sparse_bfs(self, m: CsrMirror, ix: EllIndex,
                         starts_per_query, targets_per_query,
                         et_tuple: Tuple[int, ...], max_steps: int,
                         shortest: bool, B: int, mesh: PartsMesh,
                         t0: float) -> Optional[np.ndarray]:
        """The frontier-sharded BFS (runtime.py:3433-3505): starts and
        targets placed on their owners at ``tpu_sparse_cap`` pairs a
        shard, ``mesh_sparse_bfs`` on the mesh, the shards' depth blocks
        fetched (the live query columns only) and stacked in row order;
        returns depths as ``_bfs_depths`` does, or None when a shard's
        share outgrows the cap or the program overflows."""
        st = self._sharded_tables(m, ix, mesh)
        nq = len(starts_per_query)
        cap = int(flags.get("tpu_sparse_cap") or (1 << 17))
        k = mesh.k
        cap_x = max(256, cap // max(k // 2, 1))
        cap_e = max(64, cap // 8)
        ps = split_start_pairs_by_owner(
            st, *self._flat_coords(m, ix, starts_per_query, nq), cap)
        pt = split_start_pairs_by_owner(
            st, *self._flat_coords(m, ix, targets_per_query, nq), cap)
        if ps is None or pt is None:
            return None
        dep, overflow, levels = ell_ops.mesh_sparse_bfs(
            *self._up_shards(st, ps[0], ps[1], pt[0], pt[1]), st, et_tuple,
            max_steps, cap, cap_x, cap_e, B, stop_when_found=shortest)
        if overflow:
            self._bump("sparse_overflows")
            return None
        self._bump("path_device", nq)
        self._bump("bfs_mesh_sparse")
        nqp = min(B, max(8, -(-nq // 8) * 8))
        host = np.concatenate([self._fetch(d[:, :nqp])
                               for d in dep])[:ix.n_rows + 1, :nq]
        with self._lock:
            self.stats["bfs_dispatches"] += 1
            self.stats["bfs_levels"] += levels
        self._tick("t_bfs_s", t0)
        return ix.to_old(host).T

    def bfs_batch(self, space_id: int, starts_per_query, targets_per_query,
                  etypes: Sequence[int], max_steps: int,
                  shortest: bool = True) -> np.ndarray:
        """Batched BFS depths: int16 [B, n] (INT16_INF = unreached)."""
        if len(starts_per_query) != len(targets_per_query):
            raise ValueError(
                f"bfs_batch: {len(starts_per_query)} start lists vs "
                f"{len(targets_per_query)} target lists")
        rows, _ = self.bfs_batch_dispatch(
            space_id, list(zip(starts_per_query, targets_per_query)),
            tuple(sorted(set(int(e) for e in etypes))), max_steps,
            shortest)
        return np.asarray(rows)

    def bfs_batch_dispatch(self, space_id: int, pairs,
                           et_tuple: Tuple[int, ...], max_steps: int,
                           shortest: bool):
        """Dispatcher entry: ``pairs`` is [(srcs, dsts), ...]; returns
        (depth rows, mirror)."""
        m = self.mirror(space_id)
        if m is None:
            raise TpuDecline(f"space {space_id} is not loaded")
        d = self._bfs_depths(space_id, m, [p[0] for p in pairs],
                             [p[1] for p in pairs], et_tuple, max_steps,
                             shortest)
        return list(d), m

    def run_find_path(self, space_id: int, srcs: Sequence[int],
                      dsts: Sequence[int], etypes: Sequence[int],
                      max_steps: int, shortest: bool,
                      etype_names: Dict[int, str]
                      ) -> Tuple[List[str], List[List[str]]]:
        """FIND PATH: BFS depths on the card, coalesced with concurrent
        same-shaped FIND PATHs by the dispatcher, then the host's
        parent walk.  Returns (["path"], rows)."""
        if not srcs or not dsts:
            return ["path"], []
        et_tuple = tuple(sorted(set(int(e) for e in etypes)))
        d16, m = self.dispatcher.submit_batched(
            ("bfs_batch_dispatch", space_id, et_tuple, int(max_steps),
             bool(shortest)), (list(srcs), list(dsts)))
        if m.m == 0:
            return ["path"], []
        depth = np.where(d16 == INT16_INF, INT32_INF,
                         d16.astype(np.int32))
        t0, c0 = time.perf_counter(), time.thread_time()
        out = _reconstruct_paths(m, depth, srcs, dsts, et_tuple,
                                 int(max_steps), bool(shortest),
                                 etype_names,
                                 self._in_edges(m, et_tuple))
        self._tick("t_paths_s", t0)
        self._bump("cpu_paths_s", time.thread_time() - c0)
        return out

    def serve_find_path(self, space_id: int, srcs: Sequence[int],
                        dsts: Sequence[int], etypes: Sequence[int],
                        max_steps: int, shortest: bool,
                        etype_names: Dict[int, str]
                        ) -> Tuple[List[str], List[List[str]]]:
        """Serve one ``FIND SHORTEST|ALL PATH FROM srcs TO dsts OVER ...
        UPTO max_steps STEPS``; returns (columns, rows) with one
        formatted path string per row, sorted.  ``etypes`` are signed
        (negative = REVERSELY); ``etype_names`` maps a signed etype to
        the name a path prints.  Raises TpuDecline for an unloaded
        space."""
        if self.mirror(space_id) is None:
            raise TpuDecline(f"space {space_id} is not loaded")
        return self.run_find_path(space_id, srcs, dsts, etypes, max_steps,
                                  shortest, etype_names)

    def _in_edges(self, m: CsrMirror, et_tuple: Tuple[int, ...]):
        """(edge ids, their dst) of the OVER-set edges, stably sorted by
        dst — the in-edge view the parent walk reads, cached per
        (mirror, OVER).  The reference argsorts all m edges on every
        call and skips the other etypes edge by edge; the rows come out
        the same."""
        cache = getattr(m, "_in_edge_cache", None)
        if cache is None:
            cache = m._in_edge_cache = {}
        got = cache.get(et_tuple)
        if got is None:
            if len(cache) >= 8:
                cache.clear()
            ok = np.nonzero(self._etype_edge_mask(m, et_tuple))[0]
            order = ok[np.argsort(m.edge_dst[ok], kind="stable")]
            got = cache[et_tuple] = (order, m.edge_dst[order])
        return got


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
        ell_ops.lane_join(self.fp, self.accp, self.rt._up(rows_p),
                          self.rt._up(words_p), self.rt._up(vals_p))

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
        ell_ops.lane_extract(self.fp, self.accp, self.rt._up(words_p),
                             self.rt._up(sel_p), out)
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
        ell_ops.lane_clear(self.fp, self.accp, self.rt._up(keep))


# ================================================== path reconstruction
MAX_PATHS = 1000


def _per_query(old: np.ndarray) -> List[np.ndarray]:
    """bool [n, nq] frontier bits in old dense ids -> each query's
    ascending vertex array."""
    nq = old.shape[1]
    qs, vs = np.nonzero(old.T)
    bounds = np.searchsorted(qs, np.arange(nq + 1))
    return [vs[bounds[q]:bounds[q + 1]] for q in range(nq)]


def _reconstruct_paths(m: CsrMirror, depth: np.ndarray, srcs, dsts,
                       et_tuple, max_steps: int, shortest: bool,
                       etype_names: Dict[int, str], in_edges_ok
                       ) -> Tuple[List[str], List[List[str]]]:
    """Host half of FIND PATH (runtime.py:3765): the parent walk over
    the CSR's in-edge view.  ``depth`` is int32 [n] (INT32_INF =
    unreached); ``in_edges_ok`` is (OVER-set edge ids sorted by dst,
    their dst).  Each vertex's candidate edges are filtered in one
    numpy step and then walked in the reference's order, so MAX_PATHS
    truncates at the same path.  Returns (["path"], sorted rows)."""
    order, sorted_dst = in_edges_ok
    src_set = {int(i) for i in m.to_dense(srcs) if i >= 0}
    paths: List[str] = []

    def in_edges(v: int) -> np.ndarray:
        lo = np.searchsorted(sorted_dst, v, "left")
        hi = np.searchsorted(sorted_dst, v, "right")
        return order[lo:hi]

    def step_of(e: int, v: int):
        return (int(m.edge_etype[e]), int(m.edge_rank[e]), v)

    def fmt(chain, start_dense: int) -> str:
        parts = [str(int(m.vids[start_dense]))]
        for (etype, rank, node) in chain:
            parts.append(f"<{etype_names.get(etype, etype)},{rank}>")
            parts.append(str(int(m.vids[node])))
        return " ".join(parts)

    if shortest:
        def build_shortest(v: int, acc, d: int):
            if len(paths) >= MAX_PATHS:
                return
            if d == 0:
                if v in src_set:
                    paths.append(fmt(acc, v))
                return
            es = in_edges(v)
            for e in es[depth[m.edge_src[es]] == d - 1].tolist():
                build_shortest(int(m.edge_src[e]), [step_of(e, v)] + acc,
                               d - 1)

        for dd in m.to_dense(dsts):
            dd = int(dd)
            if dd >= 0 and 0 < depth[dd] < INT32_INF:
                build_shortest(dd, [], int(depth[dd]))
    else:
        # ALL: every edge whose src was discovered within max_steps-1
        # is a parent edge (FindPathExecutor records exactly those)
        def build_all(v: int, acc, visited):
            if len(paths) >= MAX_PATHS or len(acc) > max_steps:
                return
            if v in src_set and acc:
                paths.append(fmt(acc, v))
            es = in_edges(v)
            for e in es[depth[m.edge_src[es]] <= max_steps - 1].tolist():
                u = int(m.edge_src[e])
                if u not in visited:
                    build_all(u, [step_of(e, v)] + acc, visited | {u})

        for dd in m.to_dense(dsts):
            dd = int(dd)
            if dd >= 0:
                build_all(dd, [], {dd})
    return ["path"], [[p] for p in sorted(paths)]
