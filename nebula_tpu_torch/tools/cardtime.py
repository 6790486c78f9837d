"""Timing on the card with CUDA events, shared by ``chip_smoke.py`` and
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
