"""Timing on the card with CUDA events, and launch counts under
``torch.profiler``, shared by ``chip_smoke.py`` and
``tools/hop_bench.py``.  Each helper takes the ``torch`` module, so
importing this one imports nothing."""
from __future__ import annotations

import time

SPIN_CYCLES = 8_000_000   # about 4 ms of the card's clock


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card by CUDA events over
    ``iters`` back-to-back calls (the host's launch path included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def queued_times(torch, fn, iters: int, spin: int = SPIN_CYCLES) -> tuple:
    """(mean milliseconds of ``fn()`` on the card alone, host
    milliseconds to enqueue them all): a spin kernel of ``spin`` cycles
    holds the card while the host enqueues the calls, so the events
    bracket only their device work as long as the enqueue stays below
    the spin's time (``fn`` must not wait on the card)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    torch.cuda._sleep(spin)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    enqueue_ms = (time.perf_counter() - h0) * 1e3
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters, enqueue_ms


def queued_ms(torch, fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card alone (queued_times)."""
    return queued_times(torch, fn, iters)[0]


def split_calls(events, gap_us: float) -> list:
    """Device events ``(name, start_us, end_us)`` split into the calls
    that made them: a new call starts where the card was idle for more
    than ``gap_us``.  Returns one list of (name, ms) a call, in order."""
    calls, end = [], None
    for name, t0, t1 in sorted(events, key=lambda e: e[1]):
        if end is None or t0 - end > gap_us:
            calls.append([])
        calls[-1].append((name, (t1 - t0) / 1e3))
        end = t1 if end is None else max(end, t1)
    return calls


def profiled_calls(torch, ell_ops, fn, calls: int = 3,
                   gap_s: float = 0.05) -> tuple:
    """``calls`` calls of ``fn`` (after a warm one) in one
    ``torch.profiler`` trace with the CUDA activity, each ``gap_s``
    after the last one ended on the card.  Returns (the device events —
    kernels, memsets and memcpys — as (name, ms), split into calls where
    the card idled; each call's checked C calls: calls of
    ``ell_ops._ok``, which every kernel wrapper makes once a C call).
    The tracer loses device events, most in the first call it traces
    but not only there (PERF.md section 7): a call may show fewer
    launches than it made, or none, so the split is a reading, not a
    count."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    n_ok = [0]
    real = ell_ops._ok

    def counting(rc, what):
        n_ok[0] += 1
        return real(rc, what)
    c_calls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            time.sleep(gap_s)
            n_ok[0] = 0
            ell_ops._ok = counting
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                ell_ops._ok = real
            c_calls.append(n_ok[0])
        time.sleep(gap_s)
    events = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.device_type.name == "CUDA"]
    return split_calls(events, gap_s * 1e6 / 2), c_calls


# CUgraphNodeType (cuda.h): the nodes a captured call's launches make
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}


def graph_launches(torch, ell_ops, fn) -> dict:
    """The device launches one call of ``fn`` makes, counted exactly: the
    call captured into a CUDA graph (nothing runs on the card) and the
    graph's kernel, memcpy and memset nodes counted through libcuda
    (``cuGraphGetNodes``, ``cuGraphNodeGetType``); other nodes are
    counted apart; the checked C calls (calls of ``ell_ops._ok``)
    beside.  ``fn`` must not wait on the card, and must have run once
    (its lazy set-up outside the capture)."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    n_ok = [0]
    real = ell_ops._ok

    def counting(rc, what):
        n_ok[0] += 1
        return real(rc, what)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    ell_ops._ok = counting
    try:
        with torch.cuda.graph(g):
            fn()
    finally:
        ell_ops._ok = real
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    if cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds: dict = {}
    t = ctypes.c_int(-1)
    for node in nodes[:n.value]:
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)):
            raise RuntimeError("cuGraphNodeGetType failed")
        name = NODE_KINDS.get(t.value, f"node type {t.value}")
        kinds[name] = kinds.get(name, 0) + 1
    g.reset()
    return dict(launches_a_call=sum(kinds.get(k, 0)
                                    for k in NODE_KINDS.values()),
                c_calls_a_call=n_ok[0], launch_kinds=kinds)


def merged_calls(seen, launches: int, calls: int) -> bool:
    """Whether a trace that shows a call with more than ``launches``
    launches is explained by the tracer merging neighbouring calls: the
    tracer can shift a call's device timestamps onto its neighbour's, so
    that the idle gap between them vanishes and the two read as one.  A
    merge is shown when every over-counted call shows a whole multiple k
    of ``launches`` (k calls), and the calls so read, with the others,
    are no more than were made."""
    over = [s for s in seen if s > launches]
    if not launches or any(s % launches for s in over):
        return False
    return len(seen) + sum(s // launches - 1 for s in over) <= calls


def launches_a_call(torch, ell_ops, fn, replay=None, reads: int = 0,
                    calls: int = 3) -> dict:
    """The device launches (kernels, memcpys and memsets) and checked C
    calls of one call of ``fn``, counted by ``graph_launches``.  A call
    that waits on the card (a BFS reads its level flags) is counted on
    ``replay``: the same call with the flags it read given back, plus
    ``reads`` host copies (one a read).  Beside the count, ``fn``'s
    calls traced under ``torch.profiler`` (``profiled_calls``):
    ``launches_traced`` a call; raises when a call makes other C calls
    than the count, when the trace splits into more calls than were
    made, or when a traced call shows more launches than the count and
    no merge of calls (``merged_calls``) explains it."""
    row = graph_launches(torch, ell_ops, replay or fn)
    row["launches_a_call"] += reads
    if reads:
        row["launch_kinds"]["memcpy"] = \
            row["launch_kinds"].get("memcpy", 0) + reads
        row["host_reads"] = reads
    traced, c_calls = profiled_calls(torch, ell_ops, fn, calls)
    seen = [len(c) for c in traced]
    n = row["launches_a_call"]
    if len(traced) > calls or set(c_calls) != {row["c_calls_a_call"]} \
            or (max(seen, default=0) > n
                and not merged_calls(seen, n, calls)):
        raise AssertionError(f"{n} launches and "
                             f"{row['c_calls_a_call']} C calls a call, "
                             f"but traced {seen} in {c_calls}")
    row.update(launches_traced=seen, counted_by="CUDA graph capture"
               + (" of the replay, plus the host reads" if reads else ""))
    return row


def kernel_ms(torch, ell_ops, fn, calls: int = 5) -> dict:
    """Each device kernel's mean milliseconds a launch in calls of
    ``fn``, by the kernels' durations in a ``torch.profiler`` trace of
    ``calls`` calls (``profiled_calls``; the tracer may lose launches,
    so a mean is over the launches it saw, and each kernel's count of
    them is given): {name: (ms, launches seen)}."""
    traced, _c = profiled_calls(torch, ell_ops, fn, calls)
    tot: dict = {}
    for evs in traced:
        for name, ms in evs:
            a = tot.setdefault(name, [0.0, 0])
            a[0] += ms
            a[1] += 1
    return {name: (ms / n, n) for name, (ms, n) in tot.items()}
