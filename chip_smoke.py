#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nebula_tpu_torch``) on one
Hopper card.

    python3 chip_smoke.py [--vertices N] [--edges M] [--seed S]
                          [--requests R] [--threads T] [--cap C]
                          [--widths LIST] [--profile R]

The defaults are the serve cell; ``--vertices 16777216 --edges
105000000 --cap 256 --widths 128`` is the round-5 scale shape, and
``--profile R`` adds a profiled serve window after phase 4.

Phases, in order; any failure exits non-zero:

1. device   the card's name, compute capability, and its name and power
            limit as nvidia-smi prints them
2. build    compile the CUDA kernels from ``nebula_tpu_torch/tpu/csrc``
            with nvcc (sm_90a) and load them
3. kernels  each of the four kernels against its plain PyTorch version
            on the serve graph's real tables, at W = 128 (B = 1024 lanes)
            and W = 16 (B = 128): exact equality, CUDA-event times for
            the kernel, the plain version and, where one exists, the
            PyTorch library call computing the same function, and the
            card's bound for the work
4. serve    a seeded power-law graph (default 2^19 vertices, 2^22 edges,
            stored in both directions) served by ``TorchQueryRuntime``:
            R multi-hop GO requests from T threads, 64 of them checked
            exactly against a numpy oracle; every kernel must have been
            launched on this path
5. a JSON line ``{"kernels": [...]}`` with each kernel's numbers
6. the last line ``{"ok": true, "device": {...}}``

The script imports nothing of the JAX package.  It needs one CUDA card
and refuses to run (non-zero exit, no result) without one.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
REPLACES = {
    "go_hop": "nebula_tpu/tpu/ell.py:665",
    "lane_join": "nebula_tpu/tpu/ell.py:691",
    "lane_extract": "nebula_tpu/tpu/ell.py:726",
    "lane_clear": "nebula_tpu/tpu/ell.py:713",
}
SOURCE = "nebula_tpu_torch/tpu/csrc/ell_lanes.cu"


# ============================================================== oracle
class GoOracle:
    """Plain numpy semantics of ``GO [UPTO] N STEPS FROM v OVER e YIELD
    e._dst`` on a forward edge list, independent of the port: an edge
    key (src, dst) is stored once; N-1 hops advance the frontier set;
    UPTO unions depths 0..N-1; the final hop yields the dst of every
    out-edge of that set.  ``traversed`` counts the out-edges scanned on
    every hop (bench.py's cpu_go definition)."""

    def __init__(self, src_vids: np.ndarray, dst_vids: np.ndarray):
        key = np.unique((np.asarray(src_vids, np.int64) << 32)
                        | np.asarray(dst_vids, np.int64))
        self.src = key >> 32
        self.dst = key & 0xFFFFFFFF
        self.vmax = int(max(self.src.max(initial=0),
                            self.dst.max(initial=0)))

    def go(self, starts, steps: int, upto: bool):
        """(sorted final-hop dst vids, edges traversed)."""
        size = max(self.vmax, max(starts)) + 1
        f = np.zeros(size, dtype=bool)
        f[np.asarray(starts, np.int64)] = True
        acc = f.copy()
        traversed = 0
        for _ in range(steps - 1):
            active = f[self.src]
            traversed += int(active.sum())
            f = np.zeros(size, dtype=bool)
            f[self.dst[active]] = True
            acc |= f
        active = (acc if upto else f)[self.src]
        traversed += int(active.sum())
        return np.sort(self.dst[active]), traversed


# ============================================================= helpers
def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card by CUDA events."""
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


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# ============================================================ phase 3
def kernel_phase(torch, ell_ops, tables, eslot, hrows, ix, B: int,
                 over, rng) -> dict:
    """The four kernels against their plain versions at lane width B on
    the serve tables; returns {name: numbers}."""
    dev = tables.nbr.device
    W = B // 8
    R1 = ix.n_rows + 1
    u8 = torch.uint8
    # a frontier pair with ~2% of the real rows live
    fp_h = np.zeros((R1, W), np.uint8)
    live = rng.random(ix.n) < 0.02
    fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                     dtype=np.uint8)
    acc_h = fp_h | (rng.integers(0, 256, (R1, W), dtype=np.uint8)
                    & (rng.random((R1, 1)) < 0.02).astype(np.uint8) * 255)
    acc_h[-1] = 0
    fp0 = torch.from_numpy(fp_h).to(dev)
    acc0 = torch.from_numpy(acc_h).to(dev)
    res = {}

    # ---- hop: three chained hops, kernel vs plain
    fk, ak, ok_ = fp0.clone(), acc0.clone(), torch.empty_like(fp0)
    fr, ar, orf = fp0.clone(), acc0.clone(), torch.empty_like(fp0)
    err = 0
    for _ in range(3):
        ell_ops.go_hop(fk, ak, ok_, tables, eslot, hrows, over)
        ell_ops.go_hop_ref(fr, ar, orf, tables, eslot, hrows, over)
        torch.cuda.synchronize()
        if not (torch.equal(ok_, orf) and torch.equal(ak, ar)):
            raise AssertionError(f"go_hop != go_hop_ref at B={B}")
        err = max(err, max_abs_err(torch, ok_, orf),
                  max_abs_err(torch, ak, ar))
        fk, ok_ = ok_, fk
        fr, orf = orf, fr
    out = torch.empty_like(fp0)
    a1 = acc0.clone()
    ms = cuda_ms(torch, lambda: ell_ops.go_hop(fp0, a1, out, tables, eslot,
                                               hrows, over), 50)
    a2 = acc0.clone()
    plain = cuda_ms(torch, lambda: ell_ops.go_hop_ref(
        fp0, a2, out, tables, eslot, hrows, over), 2, warmup=1)
    slots = int(tables.nbr.numel())
    n_extras = ix.n_rows - ix.n
    hop_bytes = (8 * slots + 4 * R1 * W
                 + 4 * (n_extras + int(hrows.numel())))
    gather_bytes = sum(r * ((d + 2) * max(W, 32) + 8 * d)
                       for r, d in zip(tables.rows, tables.D))
    res["go_hop"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bytes_ms(hop_bytes), bound_by="bytes",
                         library_ms=None, bytes=hop_bytes,
                         gather_model_ms=bytes_ms(gather_bytes))

    # ---- clear: drop 8 random lanes
    keep_h = np.full(W, 0xFF, np.uint8)
    lanes = rng.choice(B, 8, replace=False)
    for ln in lanes:
        keep_h[ln >> 3] &= np.uint8(0xFF ^ (1 << (ln & 7)))
    keep = torch.from_numpy(keep_h).to(dev)
    fk, ak = fp0.clone(), acc0.clone()
    fr, ar = fp0.clone(), acc0.clone()
    ell_ops.lane_clear(fk, ak, keep)
    ell_ops.lane_clear_ref(fr, ar, keep)
    torch.cuda.synchronize()
    if not (torch.equal(fk, fr) and torch.equal(ak, ar)):
        raise AssertionError(f"lane_clear != lane_clear_ref at B={B}")
    err = max(max_abs_err(torch, fk, fr), max_abs_err(torch, ak, ar))
    ms = cuda_ms(torch, lambda: ell_ops.lane_clear(fk, ak, keep), 50)
    plain = cuda_ms(torch, lambda: ell_ops.lane_clear_ref(fr, ar, keep), 50)

    def lib_clear():
        torch.bitwise_and(fr, keep, out=fr)
        torch.bitwise_and(ar, keep, out=ar)
    lib = cuda_ms(torch, lib_clear, 50)
    res["lane_clear"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bytes_ms(4 * R1 * W + W),
                             bound_by="bytes", library_ms=lib)

    # ---- join: 8 cleared lanes reseated, 64 start rows each
    base_f, base_a = fk.clone(), ak.clone()     # those lanes are clear
    rows_l, words_l, vals_l = [], [], []
    for ln in lanes:
        r = rng.choice(ix.n, 64, replace=False).astype(np.int32)
        rows_l.append(r)
        words_l.append(np.full(64, ln >> 3, np.int32))
        vals_l.append(np.full(64, 1 << (ln & 7), np.uint8))
    S = 64 * len(lanes)
    Sp = max(8, 1 << (S - 1).bit_length())
    rows_h = np.full(Sp, ix.n_rows, np.int32)
    words_h = np.zeros(Sp, np.int32)
    vals_h = np.zeros(Sp, np.uint8)
    rows_h[:S] = np.concatenate(rows_l)
    words_h[:S] = np.concatenate(words_l)
    vals_h[:S] = np.concatenate(vals_l)
    rows_t = torch.from_numpy(rows_h).to(dev)
    words_t = torch.from_numpy(words_h).to(dev)
    vals_t = torch.from_numpy(vals_h).to(dev)
    fk, ak = base_f.clone(), base_a.clone()
    fr, ar = base_f.clone(), base_a.clone()
    ell_ops.lane_join(fk, ak, rows_t, words_t, vals_t)
    ell_ops.lane_join_ref(fr, ar, rows_t, words_t, vals_t)
    torch.cuda.synchronize()
    if not (torch.equal(fk, fr) and torch.equal(ak, ar)):
        raise AssertionError(f"lane_join != lane_join_ref at B={B}")
    err = max(max_abs_err(torch, fk, fr), max_abs_err(torch, ak, ar))
    # timed on fresh copies each round would time the copy too: the
    # kernel's OR is idempotent, so repeated joins do the same work
    ms = cuda_ms(torch, lambda: ell_ops.lane_join(fk, ak, rows_t, words_t,
                                                  vals_t), 50)
    fj, aj = base_f.clone(), base_a.clone()

    def plain_join():
        # the add is exact only on clear bits: re-clear the lanes first
        fj.copy_(base_f)
        aj.copy_(base_a)
        ell_ops.lane_join_ref(fj, aj, rows_t, words_t, vals_t)

    def copy_only():
        fj.copy_(base_f)
        aj.copy_(base_a)
    plain = max(0.0, cuda_ms(torch, plain_join, 20)
                - cuda_ms(torch, copy_only, 20))
    idx = (rows_t.long(), words_t.long())

    def lib_join():
        fj.copy_(base_f)
        aj.copy_(base_a)
        fj.index_put_(idx, vals_t, accumulate=True)
        aj.index_put_(idx, vals_t, accumulate=True)
    lib = max(0.0, cuda_ms(torch, lib_join, 20)
              - cuda_ms(torch, copy_only, 20))
    join_bytes = 9 * Sp + 4 * S + 2 * W
    res["lane_join"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bytes_ms(join_bytes), bound_by="bytes",
                            library_ms=lib)

    # ---- extract: 8 word columns, mixed exact-depth / UPTO
    P = 8
    words_e = torch.from_numpy(
        rng.choice(W, P, replace=False).astype(np.int32)).to(dev)
    sel_e = torch.from_numpy(
        (rng.random(P) < 0.5).astype(np.uint8)).to(dev)
    ok_ = torch.empty((R1, P), dtype=u8, device=dev)
    orf = torch.empty((R1, P), dtype=u8, device=dev)
    ell_ops.lane_extract(fp0, acc0, words_e, sel_e, ok_)
    ell_ops.lane_extract_ref(fp0, acc0, words_e, sel_e, orf)
    torch.cuda.synchronize()
    if not torch.equal(ok_, orf):
        raise AssertionError(f"lane_extract != lane_extract_ref at B={B}")
    err = max_abs_err(torch, ok_, orf)
    ms = cuda_ms(torch, lambda: ell_ops.lane_extract(fp0, acc0, words_e,
                                                     sel_e, ok_), 50)
    plain = cuda_ms(torch, lambda: ell_ops.lane_extract_ref(
        fp0, acc0, words_e, sel_e, orf), 50)
    res["lane_extract"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bytes_ms(2 * R1 * P + 5 * P),
                               bound_by="bytes", library_ms=None)
    return res


# ============================================================ phase 4
def request_mix(rng, n: int, requests: int):
    """The serve traffic: one start vid each, 2-4 steps, a quarter UPTO;
    every 4-step request and a quarter of the rest end in COUNT(*)."""
    starts = rng.integers(1, n + 1, requests)
    steps = rng.integers(2, 5, requests)
    upto = rng.random(requests) < 0.25
    count = (steps == 4) | (rng.random(requests) < 0.25)
    return starts, steps, upto, count


def drive(rt, mix, threads: int, keep=frozenset()):
    """Serve every request of ``mix`` through ``serve_go`` from
    ``threads`` client threads.  Returns (wall seconds, per-request
    latency seconds, {i: answer} for i in ``keep``); raises if any
    request failed."""
    starts, steps, upto, count = mix
    requests = len(starts)
    kept = {}
    lat = np.zeros(requests)
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                next_i[0] += 1
            if i >= requests:
                return
            t0 = time.perf_counter()
            try:
                out = rt.serve_go(1, [int(starts[i])], [1], int(steps[i]),
                                  {1: "e"}, upto=bool(upto[i]),
                                  reduce=("count",) if count[i] else None)
            except Exception as ex:     # noqa: BLE001 — raised below
                with lock:
                    errors.append(f"request {i}: {ex!r}")
                return
            lat[i] = time.perf_counter() - t0
            if i in keep:
                kept[i] = out

    pool = [threading.Thread(target=worker, name=f"smoke-client-{k}")
            for k in range(threads)]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{len(errors)} requests failed: "
                             f"{errors[:3]}")
    return wall, lat, kept


def serve_phase(torch, rt, ell_ops, oracle: GoOracle, n: int,
                requests: int, threads: int, seed: int) -> dict:
    """The main path, counted: every launch count is zeroed just before
    the requests and read just after; 64 answers are checked exactly
    against the oracle.  Returns the numbers."""
    rng = np.random.default_rng(seed + 1)
    mix = request_mix(rng, n, requests)
    starts, steps, upto, count = mix
    check = set(rng.choice(requests, min(64, requests),
                           replace=False).tolist())
    # warm the stream (session anchor, table upload) outside the window
    rt.serve_go(1, [1], [1], 2, {1: "e"})
    torch.cuda.synchronize()
    ell_ops.reset_launches()
    wall, lat, results = drive(rt, mix, threads, check)
    launches = dict(ell_ops.LAUNCHES)
    traversed = []
    for i in sorted(check):
        want, tr = oracle.go([int(starts[i])], int(steps[i]),
                             bool(upto[i]))
        traversed.append(tr)
        cols, rows = results[i]
        if count[i]:
            if cols != ["__count__"] or rows != [[len(want)]]:
                raise AssertionError(f"request {i}: count {rows} != "
                                     f"{len(want)}")
        else:
            got = np.sort(np.asarray([r[0] for r in rows], np.int64))
            if cols != ["e._dst"] or not np.array_equal(got, want):
                raise AssertionError(f"request {i}: rows differ from the "
                                     f"oracle ({len(got)} vs {len(want)})")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the serve "
                                 f"path")
    st = rt.continuous.streams()[0].stats
    qps = requests / wall
    return dict(requests=requests, threads=threads, wall_s=wall, qps=qps,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                checked=len(check),
                edges_traversed_per_query=float(np.mean(traversed)),
                edges_traversed_per_s=float(np.mean(traversed)) * qps,
                launches=launches, stream=dict(st),
                runtime=dict(rt.stats))


# ========================================================= --profile
def profile_phase(torch, rt, n: int, requests: int, threads: int,
                  seed: int) -> dict:
    """A further serve window under torch.profiler (CPU + CUDA): the
    card's busy time by kernel and its idle share over the window.  Not
    part of the default run; device times are None when the profiler
    recorded none."""
    from torch.profiler import ProfilerActivity, profile
    mix = request_mix(np.random.default_rng(seed + 2), n, requests)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _lat, _kept = drive(rt, mix, threads)
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us and us > 0:
            per[e.key] = per.get(e.key, 0.0) + float(us)
    busy_ms = sum(per.values()) / 1e3 if per else None
    top = sorted(per.items(), key=lambda kv: -kv[1])[:8]
    return dict(requests=requests, wall_s=wall, qps=requests / wall,
                device_busy_ms=busy_ms,
                device_idle_share=(None if busy_ms is None
                                   else 1.0 - busy_ms / (wall * 1e3)),
                top_device_us={k: v for k, v in top})


# ================================================================ main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vertices", type=int, default=1 << 19)
    ap.add_argument("--edges", type=int, default=1 << 22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=4096)
    ap.add_argument("--threads", type=int, default=64)
    ap.add_argument("--cap", type=int, default=None,
                    help="tpu_ell_cap override (default: the flag's 512)")
    ap.add_argument("--widths", default=None,
                    help="go_batch_widths override (default 128,1024)")
    ap.add_argument("--profile", type=int, default=0, metavar="R",
                    help="after the serve phase, serve R more requests "
                         "under torch.profiler and print the card's "
                         "busy time and idle share")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.tpu import _build, ell_ops
    from nebula_tpu_torch.tpu.csr import mirror_from_edges
    from nebula_tpu_torch.tpu.device import (resolve_device,
                                             smi_name_and_power_limit)
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    from nebula_tpu_torch.tools.graphgen import powerlaw_graph

    # ---- 1. device
    dev = resolve_device(None)
    name = torch.cuda.get_device_name(dev)
    cap = torch.cuda.get_device_capability(dev)
    smi = smi_name_and_power_limit()
    if not smi:
        raise RuntimeError("nvidia-smi printed no card")
    log(f"[device] {name} capability {cap[0]}.{cap[1]} "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)

    # ---- 2. build
    t0 = time.perf_counter()
    _build.build(force=True)
    _build.load()
    log(f"[build] nvcc {_build.NVCC_FLAGS[1]} "
        f"{time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}")

    if args.cap is not None:
        flags.set("tpu_ell_cap", args.cap)
    if args.widths is not None:
        flags.set("go_batch_widths", args.widths)

    # ---- the serve graph (phase 3 runs on its tables)
    t0 = time.perf_counter()
    src, dst = powerlaw_graph(args.vertices, args.edges, 2.2, 20000,
                              args.seed)
    m = mirror_from_edges(src, dst, 1, space_id=1)
    rt = TorchQueryRuntime()
    try:
        rt.load_space(1, m)
        ix = rt.ell(m)
        tables = rt._device_tables(m, ix)
        eslot, hrows = rt._hub_merge_dev(m, ix)
        torch.cuda.synchronize()
        log(f"[graph] n={m.n} m={m.m} (both directions) n_rows={ix.n_rows} "
            f"extras={ix.n_rows - ix.n} buckets={list(tables.D)} "
            f"slots={int(tables.nbr.numel())} "
            f"built in {time.perf_counter() - t0:.2f} s")

        # ---- 3. kernels vs plain
        rng = np.random.default_rng(args.seed + 7)
        per_width = {}
        for B in (1024, 128):
            per_width[B] = kernel_phase(torch, ell_ops, tables, eslot,
                                        hrows, ix, B, (1,), rng)
            for k, v in per_width[B].items():
                log(f"[kernel] {k} B={B} W={B // 8} equal=True "
                    + " ".join(f"{a}={b}" for a, b in v.items()))

        # ---- 4. serve
        oracle = GoOracle(src, dst)
        serve = serve_phase(torch, rt, ell_ops, oracle, args.vertices,
                            args.requests, args.threads, args.seed)
        log("[serve] " + json.dumps(serve))
        if args.profile:
            prof = profile_phase(torch, rt, args.vertices, args.profile,
                                 args.threads, args.seed)
            log("[profile] " + json.dumps(prof))
    finally:
        rt.close()

    # ---- 5. kernels line: the serve rung's numbers (B=128, W=16),
    # with the W=128 numbers beside them
    kernels = []
    for k in ("go_hop", "lane_join", "lane_extract", "lane_clear"):
        row = dict(name=k, route="cuda", source=SOURCE,
                   replaces=REPLACES[k], launches=serve["launches"][k],
                   equal=True, width_words=16)
        v = per_width[128][k]
        row.update({a: v[a] for a in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")})
        if k == "go_hop":
            row["gather_model_ms"] = v["gather_model_ms"]
        row["w128"] = {a: per_width[1024][k][a]
                       for a in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "library_ms")}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
