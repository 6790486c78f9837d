"""Continuous hop-boundary dispatch — the slice of
``nebula_tpu/graph/batch_dispatch.py:371-1190`` that serves multi-hop GO.

One ``_ContinuousStream`` per (space, OVER set) owns a device session
(tpu/runtime.py ``_ContinuousGoSession``) and a pump thread that runs
the hop-tick loop:

    seat queued riders on the lowest free lanes -> join their start
    frontiers -> enqueue hop k -> riders done with steps-1 hops leave:
    enqueue their lane extraction + clear -> resolve and assemble hop
    k-1's leavers while hop k runs on the card -> wake their waiters

Not yet ported (the reference has them): deadline eviction and
admission shedding, generation drain/re-anchor, widening to the next
lane rung when the seat map saturates, the flight recorder, tracing
spans, the live-query registry and the circuit breaker.  A rider that
finds every lane taken waits in the queue for a lane to free.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional, Tuple

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
        self.stopping = False
        # counters the tests and the smoke run read (under cond); the
        # t_*_s entries are host seconds the pump spent per phase: the
        # enqueue of each device op, the wait for a cohort's fetch, and
        # its assembly
        self.stats = {"ticks": 0, "joins": 0, "midflight_joins": 0,
                      "leaves": 0, "lane_reuses": 0, "t_join_s": 0.0,
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
            for r in riders:
                if r.error is None and r.result is None:
                    r.error = ex
                r.done = True
            self.cond.notify_all()

    def _anchor(self) -> None:
        """Ensure a device session (pump thread, outside the condition:
        the first anchor builds the ELL index and uploads the tables)."""
        if self.session is not None:
            return
        with self.cond:
            backlog = len(self.queue)
        sess = self.sched.runtime.continuous_session(
            self.space_id, self.et_tuple, min_lanes=backlog)
        if sess is None:
            raise ContinuousUnavailable(
                f"space {self.space_id} cannot ride continuous dispatch")
        self.session = sess
        with self.cond:
            self.ledger = _LaneLedger(sess.B)
            self._used_lanes = set()

    def _tick(self, pending):
        """One hop tick; returns this tick's leave cohort (or None).
        ``pending`` is the PREVIOUS tick's cohort — it resolves and
        assembles here, after this tick's hop is enqueued."""
        with self.cond:
            want_seats = bool(self.queue) and not self.stopping
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
            if sess is not None and not self.stopping:
                # mid-flight: hops are already running for earlier riders
                was_running = bool(self.seated)
                while self.queue and self.ledger.free_count() > 0:
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
