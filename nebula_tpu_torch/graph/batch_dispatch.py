"""The dispatch tier — the slice of ``nebula_tpu/graph/batch_dispatch.py``
that coalesces concurrent device queries.

``GoBatchDispatcher.submit_batched`` is the one seam every device query
enters.  An eligible multi-hop GO key (``ContinuousGoScheduler.
route_eligible``) rides the continuous tier below; everything else —
windowed-mode GO, single-step GO, FIND PATH's BFS — queues per shape
key, one waiter becomes the batch leader, and the whole batch rides one
runtime call.  The leader of a two-phase runtime call (``_Pending``)
hands leadership on once the device work is launched, so the next batch
launches while this one fetches and assembles; ``go_batch_inflight``
bounds the batches in flight, and an adaptive pooling window
(``_WindowController``) lets arrivals gather before a leader launches.
Not yet ported from the windowed tier: admission shedding, deadlines,
KILL QUERY and the device busy meter.

One ``_ContinuousStream`` per (space, OVER set) owns a device session
(tpu/runtime.py ``_ContinuousGoSession``) and a pump thread that runs
the hop-tick loop:

    seat queued riders on the lowest free lanes -> join their start
    frontiers -> enqueue hop k -> riders done with steps-1 hops leave:
    enqueue their lane extraction + clear -> resolve and assemble hop
    k-1's leavers while hop k runs on the card -> wake their waiters

A new mirror generation drains the stream (batch_dispatch.py:488-520,
:652-718): riders already seated finish on the generation their
session captured, new arrivals wait, and once the seat map is empty the
stream re-anchors on the current generation.  Only riders queued
before a tick's generation check are seated in that tick, so a query
admitted after generation g publishes never seats on an older session
(read-your-writes).

Not yet ported (the reference has them): deadline eviction and
admission shedding, widening to the next lane rung when the seat map
saturates, the flight recorder, tracing spans, the live-query registry
and the circuit breaker.  A rider that finds every lane taken waits in
the queue for a lane to free.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common.flags import flags
from ..storage.device import TpuDecline


class _LaneLedger:
    """The continuous batch's seat map: which of the B packed lanes
    (bit k of word k>>3 in the resident uint8 frontier) are occupied.
    Lanes hand out lowest-index-first so a lightly loaded stream's
    occupancy clusters into few WORDS (the leave-extract fetch is per
    word).  Pure bookkeeping — the caller (the
    stream, under its condition) sequences it against the device-side
    clear: a lane re-enters the free heap only after its bits were
    cleared from the resident pair, which is what makes the join
    kernel's scatter-add exact.  Double-seating any lane raises."""

    __slots__ = ("width", "_free", "_seated")

    def __init__(self, width: int):
        self.width = int(width)
        self._free = list(range(self.width))
        heapq.heapify(self._free)
        self._seated: set = set()

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("lane ledger exhausted")
        lane = heapq.heappop(self._free)
        if lane in self._seated:        # pragma: no cover — invariant
            raise RuntimeError(f"lane {lane} double-seated")
        self._seated.add(lane)
        return lane

    def release(self, lane: int) -> None:
        if lane not in self._seated:
            raise RuntimeError(f"lane {lane} released but not seated")
        self._seated.discard(lane)
        heapq.heappush(self._free, lane)

    def free_count(self) -> int:
        return len(self._free)

    def seated_count(self) -> int:
        return len(self._seated)


class ContinuousUnavailable(TpuDecline):
    """The stream could not anchor a device session for this space
    (empty or unloaded mirror) or is stopping: the query declines."""


class _Rider:
    """One query riding the continuous batch: queued until a lane
    frees, seated for steps-1 hop ticks, extracted + assembled at its
    last hop.  Fields are written by the pump under the stream
    condition; the submitting thread reads result/error after ``done``
    flips."""

    __slots__ = ("payload", "steps", "upto", "reduce", "lane",
                 "remaining", "midflight", "done", "result", "mirror",
                 "error")

    def __init__(self, payload, steps: int, upto: bool, reduce):
        self.payload = payload
        self.steps = int(steps)
        self.upto = bool(upto)
        self.reduce = tuple(reduce) if reduce is not None else None
        self.lane = -1
        self.remaining = 0
        self.midflight = False
        self.done = False
        self.result = None
        self.mirror = None
        self.error = None


class _ContinuousStream:
    """One (space, OVER set) continuous lane batch with its pump."""

    def __init__(self, sched: "ContinuousGoScheduler", space_id: int,
                 et_tuple: Tuple):
        self.sched = sched
        self.space_id = space_id
        self.et_tuple = et_tuple
        self.cond = threading.Condition()
        self.queue: List[_Rider] = []
        self.seated: Dict[int, _Rider] = {}
        self.ledger: Optional[_LaneLedger] = None
        self.draining = False           # generation change: no seats
        self.stopping = False
        # counters the tests and the smoke run read (under cond); the
        # t_*_s entries are host seconds the pump spent per phase: the
        # enqueue of each device op, the wait for a cohort's fetch, and
        # its assembly
        self.stats = {"ticks": 0, "joins": 0, "midflight_joins": 0,
                      "leaves": 0, "lane_reuses": 0, "anchors": 0,
                      "drains": 0, "t_join_s": 0.0,
                      "t_hop_s": 0.0, "t_extract_s": 0.0,
                      "t_clear_s": 0.0, "t_fetch_s": 0.0,
                      "t_assemble_s": 0.0}
        self._used_lanes: set = set()
        # pump-thread-only device state
        self.session = None
        # sleep this long before each tick, so a test can make arrivals
        # land while earlier riders are mid-flight
        self.tick_delay_s = 0.0
        self._pump_thread = threading.Thread(
            target=self._pump, daemon=True,
            name=f"continuous-go-{space_id}")
        self._pump_thread.start()

    # --------------------------------------------------------- pump
    def _pump(self) -> None:
        pending = None
        while True:
            with self.cond:
                while (not self.queue and not self.seated
                       and pending is None and not self.stopping):
                    self.cond.wait()
                if self.stopping:
                    break
            delay = self.tick_delay_s
            if delay > 0:
                time.sleep(delay)
            try:
                pending = self._tick(pending)
            except BaseException as ex:  # noqa: BLE001 — pump must
                # survive: fail everyone riding, INCLUDING the
                # extracted-but-unassembled previous cohort, drop the
                # session (its buffers may be mid-update), keep serving
                err = (ex if isinstance(ex, Exception)
                       else RuntimeError(f"pump interrupted: {ex!r}"))
                self._fail_all(err)
                if pending is not None:
                    self._fail_cohort(pending, err)
                    pending = None
                if not isinstance(ex, Exception):
                    raise
        self._fail_all(ContinuousUnavailable("continuous dispatcher "
                                             "stopped"))
        if pending is not None:
            self._finish(pending)

    def _fail_cohort(self, pending, ex: Exception) -> None:
        _resolver, leavers, _m = pending
        with self.cond:
            for r in leavers:
                if r.error is None and r.result is None:
                    r.error = ex
                r.done = True
            self.cond.notify_all()

    def _fail_all(self, ex: Exception) -> None:
        """Wake every queued and seated rider with ``ex`` and reset the
        seat map."""
        self.session = None
        with self.cond:
            riders = list(self.queue) + list(self.seated.values())
            self.queue.clear()
            self.seated.clear()
            self.ledger = None
            self.draining = False
            for r in riders:
                if r.error is None and r.result is None:
                    r.error = ex
                r.done = True
            self.cond.notify_all()

    def _anchor(self) -> None:
        """Ensure a device session over the CURRENT mirror generation
        (pump thread, outside the condition: ``mirror()`` may absorb or
        build, and the first anchor builds the ELL index and uploads
        the tables).  A generation change while lanes are seated flips
        ``draining`` instead: the seated riders finish on what they
        captured, and the stream re-anchors once they have left."""
        rt = self.sched.runtime
        sess = self.session
        if sess is not None:
            if rt.mirror(self.space_id) is sess.m:
                with self.cond:
                    self.draining = False
                return
            with self.cond:
                if self.seated:
                    if not self.draining:
                        self.stats["drains"] += 1
                    self.draining = True
                    return
            self.session = None
        with self.cond:
            backlog = len(self.queue)
        sess = rt.continuous_session(self.space_id, self.et_tuple,
                                     min_lanes=backlog)
        if sess is None:
            raise ContinuousUnavailable(
                f"space {self.space_id} cannot ride continuous dispatch")
        self.session = sess
        with self.cond:
            self.draining = False
            self.ledger = _LaneLedger(sess.B)
            self._used_lanes = set()
            self.stats["anchors"] += 1

    def _tick(self, pending):
        """One hop tick; returns this tick's leave cohort (or None).
        ``pending`` is the PREVIOUS tick's cohort — it resolves and
        assembles here, after this tick's hop is enqueued."""
        with self.cond:
            # riders present BEFORE this tick's generation check are
            # the only seatable ones: a later arrival waits for the next
            # tick's check, so it never seats on an older generation
            n_eligible = len(self.queue)
            want_seats = n_eligible > 0 and not self.stopping
        if want_seats:
            try:
                self._anchor()
            except ContinuousUnavailable as ex:
                with self.cond:
                    waiting = list(self.queue)
                    self.queue.clear()
                    for r in waiting:
                        r.error = ex
                        r.done = True
                    self.cond.notify_all()

        sess = self.session
        joiners: List[_Rider] = []
        with self.cond:
            if sess is not None and not self.draining \
                    and not self.stopping:
                # mid-flight: hops are already running for earlier riders
                was_running = bool(self.seated)
                while self.queue and n_eligible > 0 \
                        and self.ledger.free_count() > 0:
                    n_eligible -= 1
                    r = self.queue.pop(0)
                    r.lane = self.ledger.alloc()
                    if r.lane in self._used_lanes:
                        self.stats["lane_reuses"] += 1
                    self._used_lanes.add(r.lane)
                    r.remaining = r.steps - 1
                    r.midflight = was_running
                    self.seated[r.lane] = r
                    joiners.append(r)
            seated_now = bool(self.seated)

        new_pending = None
        leavers: List[_Rider] = []
        if sess is not None and (joiners or seated_now):
            resolver = None
            t = [time.perf_counter()]

            def lap(key):
                now = time.perf_counter()
                self.stats[key] += now - t[0]
                t[0] = now
            try:
                if joiners:
                    sess.join([(r.lane, r.payload.start_vids)
                               for r in joiners])
                    lap("t_join_s")
                sess.hop()
                lap("t_hop_s")
                with self.cond:
                    for lane, r in list(self.seated.items()):
                        r.remaining -= 1
                        if r.remaining <= 0:
                            del self.seated[lane]
                            leavers.append(r)
                if leavers:
                    resolver = sess.extract([(r.lane, r.upto)
                                             for r in leavers])
                    lap("t_extract_s")
                    sess.clear([r.lane for r in leavers])
                    lap("t_clear_s")
            except BaseException as ex:
                # leavers already left the seat map — the pump-level
                # _fail_all can no longer reach them, so wake them here
                if isinstance(ex, Exception):
                    with self.cond:
                        for r in leavers:
                            if r.error is None and r.result is None:
                                r.error = ex
                            r.done = True
                        self.cond.notify_all()
                raise
            with self.cond:
                for r in leavers:
                    self.ledger.release(r.lane)
                self.stats["ticks"] += 1
                self.stats["joins"] += len(joiners)
                self.stats["midflight_joins"] += sum(
                    1 for r in joiners if r.midflight)
            if leavers:
                new_pending = (resolver, leavers, sess.m)

        # hop k is on the card; assemble hop k-1's leavers now
        if pending is not None:
            self._finish(pending)
        # nothing left in flight: this cohort has no hop to hide behind
        if new_pending is not None:
            with self.cond:
                empty = not self.seated and not self.queue
            if empty:
                self._finish(new_pending)
                new_pending = None
        return new_pending

    def _finish(self, pending) -> None:
        """Force the cohort's fetch, assemble, wake the waiters; a
        cohort-level failure wakes every member with it."""
        resolver, leavers, m = pending
        rt = self.sched.runtime
        t0 = time.perf_counter()
        t1 = t0
        try:
            vs_lists = resolver()
            t1 = time.perf_counter()
            results = rt.continuous_results(
                self.space_id, m, [r.payload for r in leavers],
                [r.reduce for r in leavers], vs_lists, self.et_tuple)
        except Exception as ex:         # noqa: BLE001 — cohort-level
            results = [ex] * len(leavers)
        t2 = time.perf_counter()
        with self.cond:
            self.stats["leaves"] += len(leavers)
            self.stats["t_fetch_s"] += t1 - t0
            self.stats["t_assemble_s"] += t2 - t1
            for r, out in zip(leavers, results):
                if isinstance(out, Exception):
                    r.error = out
                else:
                    r.result = out
                    r.mirror = m
                r.done = True
            self.cond.notify_all()

    # ------------------------------------------------------- submit
    def submit(self, payload, steps: int, upto: bool, reduce):
        """Queue one rider and block until it leaves (or fails)."""
        rider = _Rider(payload, steps, upto, reduce)
        with self.cond:
            if self.stopping:
                raise ContinuousUnavailable("stream stopping")
            self.queue.append(rider)
            self.cond.notify_all()
            while not rider.done:
                self.cond.wait()
        if rider.error is not None:
            raise rider.error
        return rider.result, rider.mirror

    # ------------------------------------------------------ control
    def stop(self, timeout_s: float = 10.0) -> None:
        with self.cond:
            self.stopping = True
            self.cond.notify_all()
        self._pump_thread.join(timeout=timeout_s)


class ContinuousGoScheduler:
    """One _ContinuousStream per (space, OVER set)."""

    def __init__(self, runtime):
        self.runtime = runtime
        self._lock = threading.Lock()
        self._streams: Dict[Tuple, _ContinuousStream] = {}

    @staticmethod
    def route_eligible(key: Tuple) -> bool:
        """Static routing decision from the shape key alone:
        ('go_batch_execute', space, et_tuple, steps, upto, reduce).
        Session-level eligibility (an empty mirror) is the stream's
        ContinuousUnavailable fallback."""
        if flags.get("go_dispatch_mode") != "continuous":
            return False
        if not flags.get("tpu_packed_frontier", True):
            return False
        if int(flags.get("tpu_mesh_devices") or 0) > 1:
            return False
        if key[0] != "go_batch_execute" or len(key) < 6:
            return False
        try:
            steps = int(key[3])
        except (TypeError, ValueError):
            return False
        reduce = key[5]
        if reduce is not None and reduce[0] not in ("count", "limit"):
            return False
        return steps >= 2

    def submit(self, space_id: int, et_tuple: Tuple, payload, steps: int,
               upto: bool, reduce):
        """Ride the (space, OVER set) stream; returns (result, mirror)."""
        return self._stream(space_id, et_tuple).submit(payload, steps,
                                                       upto, reduce)

    def _stream(self, space_id: int, et_tuple: Tuple
                ) -> _ContinuousStream:
        with self._lock:
            st = self._streams.get((space_id, et_tuple))
            if st is None:
                st = self._streams[(space_id, et_tuple)] = \
                    _ContinuousStream(self, space_id, et_tuple)
            return st

    def streams(self) -> List[_ContinuousStream]:
        with self._lock:
            return list(self._streams.values())

    def seat_counts(self) -> Tuple[int, int]:
        """(seated, queued) across every stream."""
        seated = queued = 0
        for st in self.streams():
            with st.cond:
                seated += len(st.seated)
                queued += len(st.queue)
        return seated, queued

    def shutdown(self, timeout_s: float = 10.0) -> None:
        for st in self.streams():
            st.stop(timeout_s=timeout_s)


# ==================================================== windowed tier
class _Request:
    __slots__ = ("payload", "done", "result", "mirror", "error")

    def __init__(self, payload):
        self.payload = payload   # per-query input, method-defined (GO:
        self.done = False        # _GoQuery; BFS: (srcs, dsts)); the
        self.result = None       # leader maps ids against ONE mirror
        self.mirror = None
        self.error = None


class _KeyState:
    __slots__ = ("cond", "queue", "dispatching", "rt_ema_s")

    def __init__(self):
        self.cond = threading.Condition()
        self.queue: List[_Request] = []
        self.dispatching = False
        # EMA of this key's batch round-trip (leader entering _run ->
        # results materialized); feeds the adaptive batch window.  0.0
        # until the first batch completes, so a fresh key never sleeps
        # on a guess.
        self.rt_ema_s = 0.0


class _PrioritySlots:
    """Counted pipeline slots whose waiters are served in priority
    order (lower value first; FIFO within a class): when a slot frees
    under contention, a cheap interactive GO leader takes it ahead of
    a deep FIND PATH BFS leader.  With no contention this is a plain
    semaphore."""

    def __init__(self, n: int):
        self._cond = threading.Condition()
        self._free = max(1, int(n))
        self._seq = 0
        self._waiters: List[Tuple[int, int]] = []   # heap (prio, seq)

    def acquire(self, priority: int = 1) -> None:
        with self._cond:
            self._seq += 1
            me = (int(priority), self._seq)
            heapq.heappush(self._waiters, me)
            try:
                while self._free <= 0 or self._waiters[0] != me:
                    self._cond.wait()
            except BaseException:
                # an interrupted waiter must not wedge the queue head
                self._waiters = [w for w in self._waiters if w != me]
                heapq.heapify(self._waiters)
                self._cond.notify_all()
                raise
            heapq.heappop(self._waiters)
            self._free -= 1
            if self._free > 0 and self._waiters:
                # two release()s can land while the old head is inside
                # one wait(): popping ourselves makes a NEW head that
                # nobody will notify again — hand the spare slot on
                self._cond.notify_all()

    def release(self) -> None:
        with self._cond:
            self._free += 1
            self._cond.notify_all()


class _WindowController:
    """Closed-loop cap on the pooling window: tracks the queue depth
    leaders observe and scales ``go_batch_window_max_ms`` down as depth
    grows — cap = max_ms / (1 + depth_ema / depth_ref).  An idle
    dispatcher keeps the full window; a saturated queue drives the wait
    toward zero because arrivals already pool behind the in-flight
    batches.  (The reference also tracks dispatch latency here for its
    gauges, which the port does not export yet.)"""

    def __init__(self):
        self._lock = threading.Lock()
        self.depth_ema = 0.0

    def observe_depth(self, depth: int) -> None:
        with self._lock:
            self.depth_ema = 0.8 * self.depth_ema + 0.2 * float(depth)

    def cap_s(self) -> float:
        cap_raw = flags.get("go_batch_window_max_ms")
        cap_s = (25.0 if cap_raw is None else float(cap_raw)) / 1000.0
        ref_raw = flags.get("admission_window_depth_ref")
        ref = 8.0 if ref_raw is None else float(ref_raw)
        if ref <= 0:
            return cap_s
        with self._lock:
            depth = self.depth_ema
        return cap_s / (1.0 + depth / ref)


class GoBatchDispatcher:
    """Coalesces concurrent device queries into one runtime call per
    shape key; routes continuous-eligible GO to the seat-map tier."""

    def __init__(self, runtime):
        self.runtime = runtime
        self._lock = threading.Lock()
        self._keys: Dict[Tuple, _KeyState] = {}
        self._inflight = _PrioritySlots(
            max(1, int(flags.get("go_batch_inflight") or 3)))
        self.window = _WindowController()
        self.stats = {"batches": 0, "batched_queries": 0, "max_batch": 0,
                      "query_errors": 0}
        self.continuous = ContinuousGoScheduler(runtime)

    def _state(self, key: Tuple) -> _KeyState:
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState()
            return st

    @staticmethod
    def _priority_for_key(key: Tuple) -> int:
        """Per-query-class priority (lower = sooner): 1-hop and reduced
        GO ahead of multi-hop GO ahead of FIND PATH BFS."""
        method = key[0]
        if method == "go_batch_execute":
            steps = key[3] if len(key) > 3 else 1
            if len(key) > 5 and key[5] is not None:
                return 0             # reduced fetch: interactive class
            try:
                return 0 if int(steps) <= 1 else 1
            except (TypeError, ValueError):
                return 1
        if method == "bfs_batch_dispatch":
            return 2
        return 1

    def submit_batched(self, key: Tuple, payload):
        """Coalesce any batched runtime entry point: ``key[0]`` names a
        runtime method with signature ``fn(space_id, payloads, *key[2:])
        -> (per-query results, mirror)`` — or a two-phase ``_Pending``
        (an object with ``.finish()``) whose launch half has already
        run.  Requests sharing the key ride one device dispatch.  A
        per-query result that is an Exception instance is raised only
        for its own submitter.  An eligible multi-hop GO key rides the
        continuous tier; a stream that cannot anchor a session bounces
        the rider back here."""
        if ContinuousGoScheduler.route_eligible(key):
            try:
                return self.continuous.submit(key[1], key[2], payload,
                                              int(key[3]), bool(key[4]),
                                              key[5])
            except ContinuousUnavailable:
                pass                    # windowed fallback below
        st = self._state(key)
        req = _Request(payload)
        st.cond.acquire()
        try:
            st.queue.append(req)
            while not req.done:
                if st.dispatching or not st.queue:
                    st.cond.wait()
                    continue
                # become the leader for the next batch.  ANY failure
                # between taking leadership and entering _run (whose
                # finally hands it back) must reset `dispatching`
                st.dispatching = True
                sem_held = False
                # a lone request skips the pooling wait (nothing to pool
                # with), and so does a queue already at go_batch_max
                qlen = len(st.queue)
                self.window.observe_depth(qlen)
                no_wait = qlen <= 1 or \
                    qlen >= int(flags.get("go_batch_max") or 1024)
                rt_ema_s = st.rt_ema_s
                try:
                    # take the pipeline slot BEFORE snapshotting the
                    # batch: while go_batch_inflight batches are on the
                    # device, arrivals pool and the next leader takes
                    # them all
                    st.cond.release()
                    try:
                        window = self._window_s(rt_ema_s)
                        if no_wait:
                            window = 0.0
                        if window > 0:
                            time.sleep(window)
                        self._inflight.acquire(self._priority_for_key(key))
                        sem_held = True
                    finally:
                        st.cond.acquire()
                    max_b = int(flags.get("go_batch_max") or 1024)
                    batch = st.queue[:max_b]
                    del st.queue[:max_b]
                except BaseException:       # cond is held here
                    if sem_held:
                        self._inflight.release()
                    st.dispatching = False
                    st.cond.notify_all()
                    raise
                st.cond.release()
                released = [False]

                def release_leadership():
                    # device work for this batch is queued; the next
                    # leader may launch while we fetch and assemble
                    with st.cond:
                        st.dispatching = False
                        st.cond.notify_all()
                    released[0] = True

                try:
                    self._run(key, batch, release_leadership)
                finally:
                    st.cond.acquire()
                    if not released[0]:
                        st.dispatching = False
                    st.cond.notify_all()
        finally:
            st.cond.release()
        if req.error is not None:
            raise req.error
        return req.result, req.mirror

    def _window_s(self, rt_ema_s: float) -> float:
        """Pooling wait (seconds) before the leader takes a pipeline
        slot: ``go_batch_window_ms`` when set (>= 0), else
        ``go_batch_window_frac`` of the key's round-trip EMA, capped by
        the closed-loop controller."""
        raw = flags.get("go_batch_window_ms")
        window_ms = float(raw if raw is not None else -1)
        if window_ms >= 0:
            return window_ms / 1000.0
        frac_raw = flags.get("go_batch_window_frac")
        frac = 0.12 if frac_raw is None else float(frac_raw)
        return min(rt_ema_s * frac, self.window.cap_s())

    def _run(self, key: Tuple, batch: List[_Request],
             release_leadership) -> None:
        method, space_id = key[0], key[1]
        st_key = self._state(key)
        t_run0 = time.perf_counter()
        n_errors = 0
        try:
            # the leader already holds an in-flight slot (acquired
            # before the batch snapshot in submit_batched)
            try:
                fn = getattr(self.runtime, method)
                res = fn(space_id, [r.payload for r in batch], *key[2:])
                if hasattr(res, "finish"):   # two-phase _Pending
                    release_leadership()
                    results, mirror = res.finish()
                else:
                    results, mirror = res
                dur = time.perf_counter() - t_run0
                with st_key.cond:
                    st_key.rt_ema_s = dur if st_key.rt_ema_s == 0.0 \
                        else 0.7 * st_key.rt_ema_s + 0.3 * dur
            finally:
                self._inflight.release()
            for i, r in enumerate(batch):
                out = results[i]
                if isinstance(out, Exception):
                    r.error = out                # only this waiter fails
                    n_errors += 1
                else:
                    r.result = out
                    r.mirror = mirror
        except BaseException as ex:        # noqa: BLE001 — batch-level
            for r in batch:                # failure wakes every waiter
                if r.error is None and r.result is None:
                    r.error = ex
            if not isinstance(ex, Exception):
                raise                      # KeyboardInterrupt etc.
        finally:
            with self._lock:   # leaders for different keys run concurrently
                self.stats["batches"] += 1
                self.stats["batched_queries"] += len(batch)
                self.stats["query_errors"] += n_errors
                self.stats["max_batch"] = max(self.stats["max_batch"],
                                              len(batch))
            for r in batch:
                r.done = True
