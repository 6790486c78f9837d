"""Time the packed hop (``ell_ops.go_hop``), ``ell_go``, ``or_into``,
the adaptive program (``ell_ops.adaptive_go``), the sparse pair-list
program (``ell_ops.sparse_go``) in its emit, COUNT and LIMIT forms, the
fused WHERE program (``edge_ops.go_filtered``), the int8 hop K13
(``go_hop_i8``) with its programs ``ell_go_i8`` and ``ell_bfs_i8``, and
the replicated-frontier mesh's M1 (``shard_hop``), row replication
(M3), hop and programs (``ell_go_sharded``, ``ell_bfs_sharded``), and
the frontier-sharded mesh's programs (``mesh_sparse_go``,
``mesh_sparse_bfs``) of one checkout of the port on one card, so that
two checkouts can be held side by side in one run.

    python3 nebula_tpu_torch/tools/hop_bench.py [--tree DIR] [--rows LIST]

Run it as a script: the timing helpers (``cardtime.py``, beside this
file) come from this file's checkout, the port from ``--tree DIR``
(default: this file's checkout), for instance a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore``
lists; DIR's kernels build into DIR's own build directory.  The graph
is ``chip_smoke.py``'s serve graph at its defaults:
``powerlaw_graph(2^19, 2^22, 2.2, 20000, 0)`` stored in both
directions, its ELL as the runtime builds it at the default flags.
At W = 16 and 128 (128 and 1024 lanes): three chained hops with an
accumulator held equal to ``go_hop_ref``, then the hop's device time
(calls queued behind a spin kernel, so the events bracket device work
alone) and its event time (back-to-back calls, the host's launch path
included); ``ell_go`` at 3 steps, exact and UPTO, the same two ways.
``or_into`` and ``torch.bitwise_or`` on 2^19 bytes the same two ways.
``adaptive_go`` at 3 steps from one start with 16 to 128 out-edges
(the kind of start ``chip_smoke.py``'s row times), at K = 2048 (the
sparse arm alone) and K = 8 (the dense arm after the first switch),
held equal to its plain version: by events, the median of ROUNDS
measurements, and, where the checkout chooses the arm on the card
(``ell_ops._adaptive_plan``), its device time and its launches and C
calls a call by capture; a checkout whose host reads the mode word
each sparse hop is timed by events and traced.  Either way its device
time by kernel from a trace, and, where the arm is chosen on the card,
the dense arm's hop at W = 4 on the frontier it pulls at K = 8 on the
plan's whole grid (``go_hop``) and gated as the program launches it,
its gate open and shut.  ``sparse_go`` at c0
256, 8 queries, 3 steps (``chip_smoke.py``'s headline batch), plain,
COUNT and ``LIMIT 10``, held equal to its plain version, device and
event times, launches and C calls a call.  ``go_filtered`` from one
start at 3 steps with ``chip_smoke.py``'s predicate 3 (``e.w % 7 == 3
&& e.score > 1.0``, pushed) on the same seeded columns, held equal to
its plain version, the same numbers; and ``expr_filter`` with that
predicate over every edge alone, its device time an instruction and
edge.
K13 at B = 128 and 1024 on the start frontier (one start a lane,
uploaded by K12: B live rows) and on a dense one (every byte of every
real row random int8, negative ones included), exact and with the UPTO
accumulator, held equal to ``go_hop_i8_ref``, device and event times
of one call as a program's first hop makes it (no live array passed:
the row-live pass is part of the call where the checkout has one);
``ell_go_i8`` at 3 steps, exact and UPTO, row-packed, from the start
frontier, the same two ways; ``ell_bfs_i8`` (UPTO 5, stop when found,
random targets) by events.  The mesh at k = 4 shards on this card and
W = 16 / 128: M1 over every shard, the replication of the hop's owned
rows, one whole mesh hop and ``ell_go_sharded`` at 3 steps, device
and event times, each held equal to the single-card functions;
``ell_bfs_sharded`` (UPTO 5) by events; the frontier-sharded
``mesh_sparse_go`` (c0 256 and 2048, 3 steps; device and event times,
held to its plain version) and ``mesh_sparse_bfs`` (UPTO 5, by
events); for the four programs the CUDA launches (kernels, memsets,
memcpys: a call captured into a CUDA graph, the BFS programs only
traced under ``torch.profiler``) and checked C calls a call.  A
checkout from before the card stages (``ell_ops.HOP_STAGES``) runs M1 a
shard and replicates by ``mesh.replicate_rows``; each checkout is
called in its own form.
K5 (``pair_compact``) alone at c0 256 and 2048 on the mark the first
hop leaves, device and event times and its kernels from a trace; and
``ell_bfs_sharded`` beside the single-card ``ell_bfs`` on the same
starts and targets, event times, both split by kernel from a trace.
K3 (``bfs_level``: its first pass, a level on a 2 %-dense frontier and
on level 1),
``bfs_depth_i8`` and the three BFS programs on the same inputs for
both checkouts, with one trace of ``ell_bfs`` by kernel
(``bfs_rows``).
K1 (``frontier_upload``) at B = 128 and 1024, the kernel alone in each
checkout's own form and the runtime's whole ``_upload_frontier_packed``
(device, enqueue and event times, launches and copies a call by capture,
or traced where the call cannot be captured); K2 (``go_count``) on the
3-step frontier, an all-ones one and a random one a quarter dense,
the last also with deg up to 2^17 (``upload_rows``, ``count_rows``).
K8 (``edge_hop``) on a 2 %-dense frontier, one start (as a bitmap and,
where the checkout's hop takes it, as the start list), every vertex
and the 16 longest rows, and ``edge_seed`` with 1 and 256 starts:
device and event times, launches a call by capture (``edge_rows``).
The continuous session's join, extract and clear at W = 16 and 128
(the extract on random words, the smallest leave cohort and, at W =
128, words within two 16-byte units and one in each unit), device and
event times, launches a call by capture (``lane_rows``); K4
(``sparse_expand``) alone as ``sg_program``'s two hops make it at c0
256 and 2048, its launches in ``adaptive_go`` at K = 2048 and gated
off at K = 8 by kernel from a trace, and the launches a call of both
programs (``k4_rows``); each checkout in its own call form.  The
frontier-sharded mesh's X1 (``mesh_route_card``, both modes) and X3 (the
BFS stamp) alone on clones of the operands ``mesh_sparse_go`` (c0 256 and
2048) and ``mesh_sparse_bfs`` (B = 128, cap 2^17) give them, with both
programs: device and event times, launches and C calls a call by capture
(``mesh_x_rows``).  K15 (``bfs_level_i8``) with ``ell_go_i8`` and
``ell_bfs_i8`` at B = 128 and 1024 in each checkout's own form, the
BFS's device time split by launch (``k15_rows``).
``--rows`` picks row groups (default all): ``hop`` (the hop, ``ell_go``
and ``or_into``), ``adaptive``, ``sparse``, ``fused``, ``edge``, ``int8``,
``mesh``, ``mesh_sparse``, ``k5``, ``bfs_pair``, ``bfs``, ``upload``,
``count``, ``lanes``, ``k4``, ``mesh_x``, ``k15``.
Prints the card's name and power limit, then one JSON line.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

try:        # run as a script, this file's directory is sys.path[0]: the
    # timing helpers of this checkout, whichever tree the port comes from
    from cardtime import (SPIN_CYCLES, cuda_ms, graph_launches, kernel_ms,
                          launches_a_call, profiled_calls, queued_ms,
                          queued_times)
except ImportError:        # imported as a module of the package
    from nebula_tpu_torch.tools.cardtime import (SPIN_CYCLES, cuda_ms,
                                                 graph_launches, kernel_ms,
                                                 launches_a_call,
                                                 profiled_calls, queued_ms,
                                                 queued_times)

VERTICES, EDGES, SEED = 1 << 19, 1 << 22, 0    # chip_smoke.py's defaults
QUEUED = 8                     # calls queued behind the spin
BACK_TO_BACK = 50              # calls timed back to back
ADAPTIVE_CALLS = 20            # adaptive_go calls in one measurement
SPLIT_CALLS = 5                # adaptive_go calls traced for the split
ROUNDS = 5                     # adaptive_go measurements (the median)
MESH_K = 4                     # the mesh's shards, all on this card
PROGRAM_CALLS = 10             # back-to-back calls of a timed program
BFS_CALLS = 3                  # back-to-back calls of a timed BFS
MESH_QUEUED = 4                # mesh_sparse_go calls queued behind a spin
MESH_SPIN = 16 * SPIN_CYCLES   # about 64 ms: four calls' host enqueue
MESH_X_SETS = 8                # X1 / X3 steps timed, each on its own clones
MESH_X_CAP = 1 << 17           # the BFS's pair cap (tpu_sparse_cap)
ROW_GROUPS = ("hop", "adaptive", "sparse", "fused", "edge", "int8", "mesh",
              "mesh_sparse", "k5", "bfs_pair", "bfs", "upload", "count",
              "lanes", "k4", "mesh_x", "k15")
SPARSE_C0, SPARSE_QUERIES = 256, 8     # chip_smoke.py's headline batch
LIMIT_N = 10                   # chip_smoke.py's | LIMIT n
# chip_smoke.py's predicate 3 and its seeded columns (fused_columns)
PREDICATE = ["logic", "&&",
             ["rel", "==", ["arith", "%", ["edge", "e", "w"], ["lit", 7]],
              ["lit", 3]],
             ["rel", ">", ["edge", "e", "score"], ["lit", 1.0]]]


def _equal(torch, what, *pairs):
    torch.cuda.synchronize()
    for a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: kernel and plain version differ")


def int8_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng, dev):
    """K13, ``ell_go_i8`` and ``ell_bfs_i8`` at B = 128 and 1024."""
    import numpy as np
    R1 = ix.n_rows + 1
    res = {}
    for B in (128, 1024):
        start = torch.zeros((R1, B), dtype=torch.int8, device=dev)
        rows = torch.from_numpy(ix.perm[rng.integers(0, ix.n, B)]
                                .astype(np.int64)).to(dev)
        start[rows, torch.arange(B, device=dev)] = 1
        dense = torch.randint(-128, 128, (R1, B), dtype=torch.int8,
                              device=dev)
        dense[-1] = 0
        for name, f0 in (("start", start), ("dense", dense)):
            out, ref = torch.empty_like(f0), torch.empty_like(f0)
            for upto in (False, True):
                a, ar = f0.clone(), f0.clone()
                ell_ops.go_hop_i8(f0, a if upto else None, out, tables,
                                  eslot, hrows, over)
                ell_ops.go_hop_i8_ref(f0, ar if upto else None, ref, tables,
                                      eslot, hrows, over)
                _equal(torch, f"go_hop_i8 B={B} {name} upto={upto}",
                       (out, ref), (a, ar))
                acc = f0.clone() if upto else None

                def hop():
                    ell_ops.go_hop_i8(f0, acc, out, tables, eslot, hrows,
                                      over)
                key = f"go_hop_i8_b{B}_{name}" + ("_upto" if upto else "")
                res[key] = dict(ms=queued_ms(torch, hop, QUEUED),
                                event_ms=cuda_ms(torch, hop, BACK_TO_BACK))
            del ref
        work = torch.empty_like(start)

        def copy():
            work.copy_(start)
        for upto in (False, True):
            def go():
                copy()
                ell_ops.ell_go_i8(work, tables, eslot, hrows, over, 3, upto,
                                  pack=True)
            key = f"ell_go_i8_b{B}" + ("_upto" if upto else "")
            res[key] = dict(
                ms=queued_ms(torch, go, QUEUED)
                - queued_ms(torch, copy, QUEUED),
                event_ms=cuda_ms(torch, go, PROGRAM_CALLS)
                - cuda_ms(torch, copy, PROGRAM_CALLS))
        targets = torch.zeros_like(start)
        trows = torch.from_numpy(ix.perm[rng.integers(0, ix.n, B)]
                                 .astype(np.int64)).to(dev)
        targets[trows, torch.arange(B, device=dev)] = 1

        def bfs():
            copy()
            ell_ops.ell_bfs_i8(work, targets, tables, eslot, hrows, over, 5)
        res[f"ell_bfs_i8_b{B}"] = dict(
            event_ms=cuda_ms(torch, bfs, BFS_CALLS, 1)
            - cuda_ms(torch, copy, BFS_CALLS, 1))
        del start, dense, work, targets
    return res


def _lane_bits(torch, x):
    """An int8 carrier [R1, B] as a lane bitmap uint8 [R1, ceil(B / 8)]
    (bit j of byte w lane 8w + j > 0), in plain torch, for either
    checkout."""
    R1, B = x.shape
    pos = torch.zeros((R1, 8 * -(-B // 8)), dtype=torch.uint8,
                      device=x.device)
    pos[:, :B] = x > 0
    w = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8,
                     device=x.device)
    return (pos.view(R1, -1, 8) * w).sum(dim=2, dtype=torch.uint8)


def _graph_ms(torch, fn, iters: int = PROGRAM_CALLS) -> float:
    """Mean device milliseconds of ``fn`` captured once into a CUDA graph
    and replayed ``iters`` times between two events (no host launch
    path; ``fn`` must not wait on the card and must have run once)."""
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / iters
    g.reset()
    return ms


def _stage_split(torch, ell_ops, fn) -> dict:
    """``fn``'s launches in order with each one's device ms, from the
    ``torch.profiler`` trace of three calls (the call that showed the
    most launches: the tracer loses some), and their sums by stage."""
    traced, _c = profiled_calls(torch, ell_ops, fn, 3)
    call = max(traced, key=len)
    by: dict = {}
    for name, ms in call:
        k = _kernel_name(name)
        by[k] = by.get(k, 0.0) + ms
    return dict(launches=[[_kernel_name(n), ms] for n, ms in call],
                by_kernel=by, busy_ms=sum(ms for _n, ms in call),
                traced_a_call=[len(c) for c in traced])


def k15_rows(torch, ell_ops, ix, tables, eslot, hrows, over, dev):
    """The int8 route's BFS level pass K15 (``bfs_level_i8``) and both
    int8 programs at B = 128 and 1024, in each checkout's own form
    (lane bitmaps ``seen`` and ``tp`` with ``d`` in the result's form
    where ``bfs_level_i8`` takes ``seen``, else an int16 ``d`` and int8
    targets), on inputs made from SEED and B alone.  K15's first pass
    from one random start a lane (the targets as an int8 carrier, and
    in the new form also as the lane bitmap K1 uploads); a level on a
    2 %-dense frontier (2 % of the rows 0/1 lanes at random) after the
    starts' first pass, on a dense one (the hop of a 2 %-dense start)
    after that start's first pass, and level 1 (the hop of the starts):
    device time less the restore of the state, and event time, each
    level held equal to its plain version.  ``ell_go_i8`` at 3 steps,
    exact and UPTO, row-packed: device and event times less the start's
    copy, launches and C calls a call by capture, K14 launches a call,
    held equal.  ``ell_bfs_i8`` (UPTO 5, stop when found, one target a
    lane): event time, device time of the replayed loop captured into a
    CUDA graph (less the start's copy), its launches in order with
    their device ms from a trace, the ``bfs_depth_i8`` launches a call,
    held equal with its levels."""
    import inspect
    import numpy as np
    new = "seen" in inspect.signature(ell_ops.bfs_level_i8).parameters
    R1 = ix.n_rows + 1
    res = dict(k15_form="lane bitmaps" if new else "int16 d")
    for B in (128, 1024):
        seed = np.random.default_rng(SEED + 3 * B)
        i8 = torch.int8
        f_h = np.zeros((R1, B), np.int8)
        live = seed.random(ix.n) < 0.02
        f_h[:ix.n][live] = seed.integers(0, 2, (int(live.sum()), B))
        sparse2 = torch.from_numpy(f_h).to(dev)
        del f_h
        lanes = torch.arange(B, device=dev)

        def one_a_lane():
            x = torch.zeros((R1, B), dtype=i8, device=dev)
            rows = torch.from_numpy(ix.perm[seed.integers(0, ix.n, B)]
                                    .astype(np.int64)).to(dev)
            x[rows, lanes] = 1
            return x
        one, tgt = one_a_lane(), one_a_lane()
        tbits = _lane_bits(torch, tgt)
        flags = torch.zeros((2, 2), dtype=torch.int32, device=dev)
        if new:
            d = torch.empty((R1, B), dtype=i8, device=dev)
            seen = torch.empty((R1, -(-B // 8)), dtype=torch.uint8,
                               device=dev)
            tpk = torch.empty_like(seen)
            state = (seen, d)

            def level(nxt, flag, first=False, t8=None):
                ell_ops.bfs_level_i8(nxt, tbits if t8 is None else tpk,
                                     seen, d, flag, 0, first, True, t8)

            def plain(nxt, st, flag):
                ell_ops.bfs_level_i8_ref(nxt, tbits, st[0], st[1], flag, 0,
                                         False, True)
        else:
            d = torch.empty((R1, B), dtype=torch.int16, device=dev)
            state = (d,)

            def level(nxt, flag, first=False, t8=None):
                ell_ops.bfs_level_i8(nxt, tgt, d, flag, 0, first)

            def plain(nxt, st, flag):
                ell_ops.bfs_level_i8_ref(nxt, tgt, st[0], flag, 0, False,
                                         True)
        tag = f"b{B}"
        # the first pass from the starts
        firsts = {"first": lambda: level(one, flags[0], True, tgt)}
        if new:
            firsts["first_tbits"] = lambda: level(one, flags[0], True)
        for name, fn in firsts.items():
            fn()
            res[f"k15_{name}_{tag}"] = dict(
                ms=queued_ms(torch, fn, QUEUED),
                event_ms=cuda_ms(torch, fn, BACK_TO_BACK))
        # the levels
        h_one, h_dense = torch.empty_like(one), torch.empty_like(one)
        ell_ops.go_hop_i8(one, None, h_one, tables, eslot, hrows, over)
        ell_ops.go_hop_i8(sparse2, None, h_dense, tables, eslot, hrows,
                          over)
        for name, start, nxt0 in (("2pct", one, sparse2),
                                  ("dense", sparse2, h_dense),
                                  ("level1", one, h_one)):
            level(start, flags[0], True, tgt)
            st0 = [x.clone() for x in state]
            nk = nxt0.clone()

            def restore():
                nk.copy_(nxt0)
                for x, x0 in zip(state, st0):
                    x.copy_(x0)

            def run():
                level(nk, flags[1])
            restore()
            flags[1].zero_()
            run()
            nr, sr = nxt0.clone(), [x.clone() for x in st0]
            fr = torch.zeros_like(flags[1])
            plain(nr, sr, fr)
            _equal(torch, f"bfs_level_i8 {name} B={B}", (nk, nr),
                   *zip(state, sr), (flags[1], fr))

            def both():
                restore()
                run()
            res[f"k15_level_{name}_{tag}"] = dict(
                ms=max(0.0, queued_ms(torch, both, QUEUED)
                       - queued_ms(torch, restore, QUEUED)),
                event_ms=cuda_ms(torch, both, BACK_TO_BACK)
                - cuda_ms(torch, restore, BACK_TO_BACK),
                live_lanes=int((nxt0 > 0).sum().item()),
                newly_lanes=int((nk > 0).sum().item()))
            del st0, nk, nr, sr
        del h_one, h_dense, sparse2
        # ell_go_i8, 3 steps, row-packed
        work = torch.empty_like(one)

        def copy():
            work.copy_(one)
        for upto in (False, True):
            got = ell_ops.ell_go_i8(one.clone(), tables, eslot, hrows, over,
                                    3, upto, pack=True)
            want = ell_ops.ell_go_i8_ref(one.clone(), tables, eslot, hrows,
                                         over, 3, upto, pack=True)
            _equal(torch, f"ell_go_i8 B={B} upto={upto}", (got, want))
            del got, want

            def go():
                copy()
                ell_ops.ell_go_i8(work, tables, eslot, hrows, over, 3, upto,
                                  pack=True)
            k14 = ell_ops.LAUNCHES["pack_rows"]
            go()
            k14 = ell_ops.LAUNCHES["pack_rows"] - k14
            res[f"k15_ell_go_i8_{tag}" + ("_upto" if upto else "")] = dict(
                ms=queued_ms(torch, go, QUEUED)
                - queued_ms(torch, copy, QUEUED),
                event_ms=cuda_ms(torch, go, PROGRAM_CALLS)
                - cuda_ms(torch, copy, PROGRAM_CALLS),
                pack_rows_a_call=k14,
                **_launches(torch, ell_ops, lambda: ell_ops.ell_go_i8(
                    work, tables, eslot, hrows, over, 3, upto, pack=True)))
        # ell_bfs_i8, UPTO 5
        targets = {"t8": tgt, "tbits": tbits} if new else {"t8": tgt}
        for tname, t in targets.items():
            dk, lk = ell_ops.ell_bfs_i8(one.clone(), t, tables, eslot,
                                        hrows, over, 5)
            dr, lr = ell_ops.ell_bfs_i8_ref(one.clone(), tgt, tables, eslot,
                                            hrows, over, 5)
            _equal(torch, f"ell_bfs_i8 B={B} {tname}", (dk, dr))
            if lk != lr:
                raise AssertionError(f"ell_bfs_i8 ran {lk} levels, plain "
                                     f"{lr}")
            del dk, dr

            def loop(read, t=t):
                chain = ell_ops._live_chain(ell_ops.go_hop_i8, R1, dev)
                args = (one.clone(), t, tables, eslot, hrows, over, 5, True,
                        chain, ell_ops.bfs_level_i8)
                if not new:
                    args += (ell_ops.bfs_depth_i8,)
                return ell_ops._bfs_loop_i8(*args, read=read)
            reads: list = []
            loop(lambda flag: reads.append(flag.tolist()) or reads[-1])

            def replay():
                it = iter(reads)
                return loop(lambda _flag: next(it))

            def bfs(t=t):
                return ell_ops.ell_bfs_i8(one.clone(), t, tables, eslot,
                                          hrows, over, 5)
            k = ell_ops.LAUNCHES["bfs_depth_i8"]
            bfs()
            k = ell_ops.LAUNCHES["bfs_depth_i8"] - k
            clone_ms = _graph_ms(torch, lambda: one.clone())
            res[f"k15_ell_bfs_i8_{tag}_{tname}"] = dict(
                levels=lk, bfs_depth_i8_a_call=k,
                event_ms=cuda_ms(torch, bfs, BFS_CALLS, 1)
                - cuda_ms(torch, lambda: one.clone(), BFS_CALLS, 1),
                device_ms=_graph_ms(torch, replay) - clone_ms,
                clone_ms=clone_ms, flag_reads=len(reads),
                split=_stage_split(torch, ell_ops, replay),
                **{a: v for a, v in graph_launches(
                    torch, ell_ops, replay).items()})
        del one, tgt, tbits, work, d, state
    return res


def counts(torch, ell_ops, fn, waits: bool = False) -> dict:
    """``launches_a_call`` without the node kinds.  A call that waits on
    the card (a BFS reads its level flags) cannot be captured: only its
    traced launches a call (``profiled_calls``; the tracer may lose some,
    so these are at most what it made) and its C calls."""
    if waits:
        traced, c_calls = profiled_calls(torch, ell_ops, fn)
        return dict(launches_traced=[len(c) for c in traced],
                    c_calls_a_call=max(c_calls))
    n = launches_a_call(torch, ell_ops, fn)
    n.pop("launch_kinds")
    return n


def mesh_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng, dev):
    """M1, the row replication, a whole mesh hop, ``ell_go_sharded`` and
    ``ell_bfs_sharded`` at k = MESH_K on this card, W = 16 and 128, in
    the checkout's own form: one ``mesh_hop`` call a stage over the
    card's shards where the checkout has it, else M1 a shard and the
    replication by ``mesh.replicate_rows``."""
    import inspect

    import numpy as np
    from nebula_tpu_torch.tpu import mesh as pmesh
    from nebula_tpu_torch.tpu.ell import mesh_tables
    k = MESH_K
    mt = mesh_tables(ix, pmesh.PartsMesh([dev] * k))
    blocks = [mt.owned(s) for s in range(k)]
    es, hs = [eslot] * k, [hrows] * k
    card = hasattr(ell_ops, "HOP_STAGES")
    if not card and len(inspect.signature(ell_ops.mesh_hop).parameters) \
            != 10:
        raise AssertionError("mesh_hop's form is not known here")
    R1 = ix.n_rows + 1
    res = dict(mesh_k=k, card_stages=card)
    for W in (16, 128):
        fp_h = np.zeros((R1, W), np.uint8)
        live = rng.random(ix.n) < 0.02
        fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                         dtype=np.uint8)
        fp0 = torch.from_numpy(fp_h).to(dev)
        if card:
            g = mt.mesh.groups[0]
            cur = mt.mesh.replicas(fp0)[0]
            out = torch.empty_like(cur)
            outs = list(out.unbind(0))

            def stage(st_):
                return lambda: ell_ops.mesh_hop(cur, out, mt, g, eslot, hrows,
                                                over, st_)
            m1, m3 = stage(ell_ops.HOP_GATHER), stage(ell_ops.HOP_COPY)
            hop = stage(ell_ops.HOP_STAGES)
        else:
            cur = [fp0.clone() for _ in range(k)]
            outs = [torch.empty_like(fp0) for _ in range(k)]

            def m1():
                for s in range(k):
                    ell_ops.shard_hop(fp0, outs[s], mt, s, over)

            def m3():
                pmesh.replicate_rows(outs, blocks, ell_ops.copy_rows)

            def hop():
                ell_ops.mesh_hop(cur, outs, mt, es, hs, over, blocks,
                                 ell_ops.shard_hop, ell_ops.hop_merge,
                                 ell_ops.copy_rows)
        res[f"shard_hop_w{W}"] = dict(ms=queued_ms(torch, m1, QUEUED),
                                      event_ms=cuda_ms(torch, m1,
                                                       BACK_TO_BACK),
                                      shards=k)
        res[f"replicate_rows_w{W}"] = dict(
            ms=queued_ms(torch, m3, QUEUED),
            event_ms=cuda_ms(torch, m3, BACK_TO_BACK))
        hop()
        single = torch.empty_like(fp0)
        ell_ops.go_hop(fp0, None, single, tables, eslot, hrows, over)
        _equal(torch, f"mesh_hop W={W}", *[(o, single) for o in outs])
        res[f"mesh_hop_w{W}"] = dict(
            ms=queued_ms(torch, hop, QUEUED),
            event_ms=cuda_ms(torch, hop, BACK_TO_BACK))

        def go():
            ell_ops.ell_go_sharded(fp0, mt, es, hs, over, 3)
        _equal(torch, f"ell_go_sharded W={W}",
               (ell_ops.ell_go_sharded(fp0, mt, es, hs, over, 3)[0],
                ell_ops.ell_go(fp0.clone(), tables, eslot, hrows, over, 3)))
        res[f"ell_go_sharded_w{W}"] = dict(
            ms=queued_ms(torch, go, QUEUED),
            event_ms=cuda_ms(torch, go, PROGRAM_CALLS),
            **counts(torch, ell_ops, go))
        t0 = fp0.roll(1, dims=0).contiguous()

        def bfs():
            ell_ops.ell_bfs_sharded(fp0, t0, mt, es, hs, over, 5)
        res[f"ell_bfs_sharded_w{W}"] = dict(
            event_ms=cuda_ms(torch, bfs, BFS_CALLS, 1),
            **counts(torch, ell_ops, bfs, waits=True))
        del outs, cur
    return res


def mesh_sparse_rows(torch, ell_ops, ix, tables, over, rng, dev):
    """``mesh_sparse_go`` (c0 256: 128 queries, one start each; c0 2048:
    1024 queries, two each; 3 steps) and ``mesh_sparse_bfs`` (128
    queries, UPTO 5, stop when found) at k = MESH_K on this card, the
    starts in the checkout's own form (one slab a card group where the
    checkout has the card stages, ``ell_ops.mesh_dedup``; else a tensor
    a shard): the GO held equal to its plain version, its device time
    over calls queued behind a longer spin (MESH_SPIN: the parent's host
    takes about 4 ms a call) with the host's enqueue beside it, its
    event time, and for both the launches a call."""
    import numpy as np
    from nebula_tpu_torch.tpu import mesh as pmesh
    from nebula_tpu_torch.tpu.ell import (build_sharded_ell, sharded_tables,
                                          sparse_caps,
                                          split_start_pairs_by_owner)
    k = MESH_K
    st = sharded_tables(build_sharded_ell(ix, k), pmesh.PartsMesh([dev] * k))
    res = {}
    if hasattr(ell_ops, "mesh_dedup"):
        def up(a):
            return st.mesh.split(torch.from_numpy(a).to(dev))
        stacked = st.mesh.stacked
    else:
        def up(a):
            return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in a]

        def stacked(out):
            return torch.stack(list(out))
    for c0, nq, per in ((256, 128, 1), (2048, 1024, 2)):
        rows = ix.perm[rng.integers(0, ix.n, nq * per)].astype(np.int32)
        qs = (np.arange(nq * per) // per).astype(np.int32)
        placed = split_start_pairs_by_owner(st, rows, qs, c0)
        ids, qid = up(placed[0]), up(placed[1])
        caps = sparse_caps(c0, max(tables.D), 3, 1 << 17)
        cap_x, cap_e = max(256, caps[-1] // max(k // 2, 1)), max(64, c0)

        def go():
            return ell_ops.mesh_sparse_go(ids, qid, st, over, 3, caps, cap_x,
                                          cap_e, nq)
        got = stacked(go())
        want = stacked(ell_ops.mesh_sparse_go_ref(
            ids, qid, st, over, 3, caps, cap_x, cap_e, nq))
        _equal(torch, f"mesh_sparse_go c0={c0} flags",
               (got[:, 1], want[:, 1]))
        if not bool(want[:, 1].any()):
            _equal(torch, f"mesh_sparse_go c0={c0}", (got, want))
        ms, enq = queued_times(torch, go, MESH_QUEUED, MESH_SPIN)
        res[f"mesh_sparse_go_c0_{c0}"] = dict(
            ms=ms, enqueue_ms=enq, event_ms=cuda_ms(torch, go,
                                                    PROGRAM_CALLS),
            overflow=bool(want[:, 1].any()), **counts(torch, ell_ops, go))
    cap = 1 << 17
    s_new = ix.perm[rng.integers(0, ix.n, 128)].astype(np.int32)
    t_new = ix.perm[rng.integers(0, ix.n, 128)].astype(np.int32)
    qq = np.arange(128, dtype=np.int32)
    ps = split_start_pairs_by_owner(st, s_new, qq, cap)
    pt = split_start_pairs_by_owner(st, t_new, qq, cap)
    args = (up(ps[0]), up(ps[1]), up(pt[0]), up(pt[1]))

    def bfs():
        return ell_ops.mesh_sparse_bfs(*args, st, over, 5, cap,
                                       max(256, cap // max(k // 2, 1)),
                                       max(64, cap // 8), 128)
    res["mesh_sparse_bfs_b128"] = dict(event_ms=cuda_ms(torch, bfs,
                                                        BFS_CALLS, 1),
                                       levels=bfs()[2],
                                       **counts(torch, ell_ops, bfs,
                                                waits=True))
    return res


def _clones(torch, args) -> list:
    return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]


def _set_times(torch, fn, calls, sets: int = MESH_X_SETS) -> dict:
    """``fn`` over the operand lists ``calls`` (one step: every call of
    it, in order), ``sets`` times, each set on its own clones of the
    operands as they were: device ms a set (the sets queued behind a
    spin, clones made before it), the host's enqueue, event ms a set
    (back to back, no spin)."""
    res = {}
    for key in ("ms", "event_ms"):
        copies = [[_clones(torch, a) for a in calls] for _ in range(sets)]
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        if key == "ms":
            torch.cuda._sleep(SPIN_CYCLES)
        t0.record()
        for one in copies:
            for a in one:
                fn(*a)
        t1.record()
        if key == "ms":
            res["enqueue_ms"] = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        res[key] = t0.elapsed_time(t1) / sets
        del copies
    return res


def _blocks_same(torch, a, b) -> bool:
    """Two exchange slabs [members, k, 1 + cap] equal as X1 defines
    them: every count, and each block's kept keys as a set where the
    block kept them all (past the cap X1 keeps any cap of them)."""
    if not torch.equal(a[:, :, 0], b[:, :, 0]):
        return False
    cap = a.shape[2] - 1
    for m in range(a.shape[0]):
        for d in range(a.shape[1]):
            c = int(a[m, d, 0])
            if c <= cap and not torch.equal(
                    torch.sort(a[m, d, 1:1 + c])[0],
                    torch.sort(b[m, d, 1:1 + c])[0]):
                return False
    return True


def mesh_x_rows(torch, ell_ops, ix, tables, over, rng, dev):
    """X1 (``mesh_route_card``, candidate and hub mode) and X3 (the BFS
    stamp) alone at k = MESH_K on this card, on the operands the
    programs give them, and the two frontier-sharded programs whole.
    The programs run once with every X1 and X3 call's operands kept
    (cloned before the call): ``mesh_sparse_go`` at c0 256 (128 queries,
    one start each) and c0 2048 (1024 queries, two each), 3 steps (hop 1
    routes the start list, hop 2 the list K5 left); ``mesh_sparse_bfs``
    at B = 128, UPTO 5, stop when found, cap 2^17, each target one the
    BFS reaches within 2 levels (``chip_smoke.py``'s
    ``b128_shortest_s5``).  Each kept call is held to its plain version
    on a clone of its operands, then timed on MESH_X_SETS clones: device
    ms behind a spin, event ms, launches and C calls a call by capture.
    X3 is timed a step (init, a level) over every call the step makes:
    one a shard where the checkout stamps a shard at a time, one a card
    group where it has ``mesh_bfs_stamp_card``.  The programs: device
    ms (the BFS replayed with the level flags its run read), event ms,
    launches and C calls a call by capture (the BFS on the replay, plus
    its flag reads).  Each checkout in its own call form."""
    import numpy as np
    from nebula_tpu_torch.tpu import mesh as pmesh
    from nebula_tpu_torch.tpu.ell import (build_sharded_ell, sharded_tables,
                                          sparse_caps,
                                          split_start_pairs_by_owner)
    k = MESH_K
    st = sharded_tables(build_sharded_ell(ix, k), pmesh.PartsMesh([dev] * k))
    card = hasattr(ell_ops, "mesh_bfs_stamp_card")
    stamp = ell_ops.mesh_bfs_stamp_card if card else ell_ops.mesh_bfs_stamp
    stamp_ref = ell_ops.mesh_bfs_stamp_card_ref if card \
        else ell_ops.mesh_bfs_stamp_ref
    route_k, route_r = ell_ops.mesh_route_card, ell_ops.mesh_route_card_ref
    res = dict(mesh_k=k, stamp_a_card=card)

    def up(a):
        return st.mesh.split(torch.from_numpy(a).to(dev))
    kept = []

    def keep(name, fn):
        def call(*args):
            kept.append((name, _clones(torch, args)))
            return fn(*args)
        return call

    def live_of(ids):
        return int((ids != st.n_rows).sum())

    def x1_row(args):
        got, want = _clones(torch, args), _clones(torch, args)
        route_k(*got)
        route_r(*want)
        torch.cuda.synchronize()
        for i in (6, 7):
            if got[i] is not None and not _blocks_same(torch, got[i],
                                                       want[i]):
                raise AssertionError("mesh_route_card != its plain version")
        if not torch.equal(got[8], want[8]):
            raise AssertionError("mesh_route_card's ctl != its plain "
                                 "version's")
        one = _clones(torch, args)
        return dict(_set_times(torch, route_k, [args]),
                    places=int(args[1].numel()),
                    live_places=live_of(args[1]),
                    counted=bool(len(args) > 10 and args[10]),
                    received_hub_keys=int(
                        args[9][:, :, 0].clamp(max=args[9].shape[2] - 1)
                        .sum()) if len(args) > 9 and args[9] is not None
                    else 0,
                    **_launches(torch, ell_ops, lambda: route_k(*one)))

    def x3_row(calls):
        for args in calls:
            got, want = _clones(torch, args), _clones(torch, args)
            stamp(*got)
            stamp_ref(*want)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                    raise AssertionError("the BFS stamp != its plain "
                                         "version")
        row = dict(_set_times(torch, stamp, calls), calls=len(calls))
        if len(calls) > 1:
            row["per_call_ms"] = [_set_times(torch, stamp, [a])["ms"]
                                  for a in calls]
        sets = [_clones(torch, a) for a in calls]

        def step():
            for a in sets:
                stamp(*a)
        row.update(_launches(torch, ell_ops, step))
        return row

    # ---- the GO: X1 on both hops, both modes; the program
    for c0, nq, per in ((256, 128, 1), (2048, 1024, 2)):
        rows = ix.perm[rng.integers(0, ix.n, nq * per)].astype(np.int32)
        qs = (np.arange(nq * per) // per).astype(np.int32)
        placed = split_start_pairs_by_owner(st, rows, qs, c0)
        ids, qid = up(placed[0]), up(placed[1])
        caps = sparse_caps(c0, max(tables.D), 3, MESH_X_CAP)
        cap_x, cap_e = max(256, caps[-1] // max(k // 2, 1)), max(64, c0)
        kept.clear()
        outs = ell_ops._mesh_go_steps(
            ids, qid, st, over, 3, caps, cap_x, cap_e, nq,
            keep("route", route_k), ell_ops.mesh_dedup,
            (ell_ops.mesh_agree, ell_ops.or_many), ell_ops.mesh_emit)[0]
        want = st.mesh.stacked(ell_ops.mesh_sparse_go_ref(
            ids, qid, st, over, 3, caps, cap_x, cap_e, nq))
        got = st.mesh.stacked(outs)
        _equal(torch, f"mesh_sparse_go c0={c0} flags", (got[:, 1],
                                                        want[:, 1]))
        if not bool(want[:, 1].any()):
            _equal(torch, f"mesh_sparse_go c0={c0}", (got, want))
        hops = {True: 0, False: 0}
        for _n, args in list(kept):
            hub = bool(args[0])
            hops[hub] += 1
            mode = "hub" if hub else "cand"
            res[f"x1_go_c0_{c0}_{mode}_hop{hops[hub]}"] = x1_row(args)

        def go():
            return ell_ops.mesh_sparse_go(ids, qid, st, over, 3, caps, cap_x,
                                          cap_e, nq)
        ms, enq = queued_times(torch, go, MESH_QUEUED, MESH_SPIN)
        res[f"mesh_sparse_go_c0_{c0}"] = dict(
            ms=ms, enqueue_ms=enq,
            event_ms=cuda_ms(torch, go, PROGRAM_CALLS),
            overflow=bool(want[:, 1].any()), **counts(torch, ell_ops, go))

    # ---- the BFS: X1 and X3 a level; the program
    B, cap = 128, MESH_X_CAP
    cap_x, cap_e = max(256, cap // max(k // 2, 1)), max(64, cap // 8)
    s_new = ix.perm[rng.integers(0, ix.n, B)].astype(np.int32)
    qq = np.arange(B, dtype=np.int32)
    ps = split_start_pairs_by_owner(st, s_new, qq, cap)
    near, _o, _l = ell_ops.mesh_sparse_bfs(
        up(ps[0]), up(ps[1]), up(ps[0]), up(ps[1]), st, over, 2, cap, cap_x,
        cap_e, B, False)
    reach = torch.cat(near)[:ix.n].cpu().numpy()
    t_new = s_new.copy()
    for q in range(B):
        cand = np.nonzero((reach[:, q] >= 1) & (reach[:, q] <= 2))[0]
        if len(cand):
            t_new[q] = cand[rng.integers(len(cand))]
    del near, reach
    pt = split_start_pairs_by_owner(st, t_new, qq, cap)
    args = (up(ps[0]), up(ps[1]), up(pt[0]), up(pt[1]))
    seen = []

    def record(ctl):
        seen.append(ell_ops._read_ctl(ctl))
        return seen[-1]
    kept.clear()
    dep, ovf, levels, _x, _b = ell_ops._mesh_bfs_steps(
        *args, st, over, 5, cap, cap_x, cap_e, B, True,
        keep("route", route_k), ell_ops.mesh_dedup, keep("stamp", stamp),
        read=record)
    wdep, wovf, wlev = ell_ops.mesh_sparse_bfs_ref(
        *args, st, over, 5, cap, cap_x, cap_e, B, True)
    if ovf != wovf or levels != wlev or not (ovf or all(
            torch.equal(a, b) for a, b in zip(dep, wdep))):
        raise AssertionError("mesh_sparse_bfs != its plain version")
    del dep, wdep
    level, stamps = 0, {}
    for name, a in list(kept):
        if name == "stamp":
            stamps.setdefault("init" if a[0] else f"level{level}",
                              []).append(a)
        elif a[0]:
            res[f"x1_bfs_level{level + 1}_hub"] = x1_row(a)
        else:
            level += 1
            res[f"x1_bfs_level{level}_cand"] = x1_row(a)
    for step, calls in stamps.items():
        res[f"x3_bfs_{step}"] = x3_row(calls)
    kept.clear()

    def bfs():
        return ell_ops.mesh_sparse_bfs(*args, st, over, 5, cap, cap_x, cap_e,
                                       B, True)

    def replay():
        flags = iter(seen)
        return ell_ops._mesh_bfs_steps(
            *args, st, over, 5, cap, cap_x, cap_e, B, True, route_k,
            ell_ops.mesh_dedup, stamp, read=lambda _c: next(flags))
    ms, enq = queued_times(torch, replay, 3, MESH_SPIN)
    res["mesh_sparse_bfs_b128"] = dict(
        ms=ms, enqueue_ms=enq, event_ms=cuda_ms(torch, bfs, BFS_CALLS, 1),
        levels=levels, overflow=bool(ovf),
        **launches_a_call(torch, ell_ops, bfs, replay=replay,
                          reads=len(seen) * len(st.mesh.groups)))
    return res


def hop_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng, dev):
    """The packed hop and ``ell_go`` at W = 16 and 128, and ``or_into``."""
    import numpy as np
    R1 = ix.n_rows + 1
    res = {}
    for W in (16, 128):
        fp_h = np.zeros((R1, W), np.uint8)
        live = rng.random(ix.n) < 0.02
        fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                         dtype=np.uint8)
        acc_h = fp_h | rng.integers(0, 256, (R1, W), dtype=np.uint8) \
            * (rng.random((R1, 1)) < 0.02)
        acc_h[-1] = 0
        fp0 = torch.from_numpy(fp_h).to(dev)
        acc0 = torch.from_numpy(acc_h).to(dev)
        fk, ak, ok_ = fp0.clone(), acc0.clone(), torch.empty_like(fp0)
        fr, ar, orf = fp0.clone(), acc0.clone(), torch.empty_like(fp0)
        for _ in range(3):
            ell_ops.go_hop(fk, ak, ok_, tables, eslot, hrows, over)
            ell_ops.go_hop_ref(fr, ar, orf, tables, eslot, hrows, over)
            torch.cuda.synchronize()
            if not (torch.equal(ok_, orf) and torch.equal(ak, ar)):
                raise AssertionError(f"go_hop != go_hop_ref at W={W}")
            fk, ok_ = ok_, fk
            fr, orf = orf, fr
        out, a1 = torch.empty_like(fp0), acc0.clone()

        def hop():
            ell_ops.go_hop(fp0, a1, out, tables, eslot, hrows, over)
        res[f"go_hop_w{W}"] = dict(ms=queued_ms(torch, hop, QUEUED),
                                   event_ms=cuda_ms(torch, hop,
                                                    BACK_TO_BACK))
        # ell_go consumes its start frontier: each call runs on a fresh
        # copy, and the copy's own time is taken off
        f0 = torch.empty_like(fp0)

        def copy():
            f0.copy_(fp0)
        for upto in (False, True):
            def go():
                copy()
                ell_ops.ell_go(f0, tables, eslot, hrows, over, 3, upto)
            key = f"ell_go_w{W}" + ("_upto" if upto else "")
            res[key] = dict(
                ms=queued_ms(torch, go, QUEUED)
                - queued_ms(torch, copy, QUEUED),
                event_ms=cuda_ms(torch, go, BACK_TO_BACK)
                - cuda_ms(torch, copy, BACK_TO_BACK))
    nb = 1 << 19
    a = torch.rand(nb, device=dev) < 0.01
    b = torch.rand(nb, device=dev) < 0.01

    def one():
        ell_ops.or_into(a, b)

    def lib():
        torch.bitwise_or(b, a, out=b)
    res["or_into"] = dict(bytes=nb, ms=queued_ms(torch, one, QUEUED),
                          event_ms=cuda_ms(torch, one, BACK_TO_BACK),
                          bitwise_or_ms=queued_ms(torch, lib, QUEUED),
                          bitwise_or_event_ms=cuda_ms(torch, lib,
                                                      BACK_TO_BACK))

    return res


def _kernel_name(name: str) -> str:
    """A traced kernel's name without its namespace, template arguments
    and parameters ("Memset (Device)" stays whole)."""
    if name.startswith(("Memset", "Memcpy")):
        return name
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    return re.split(r"[<(]", s, 1)[0].split("::")[-1]


def kernel_split(torch, ell_ops, fn) -> dict:
    """``fn``'s device time by kernel, from a ``torch.profiler`` trace of
    SPLIT_CALLS calls (``kernel_ms``): each kernel's mean ms a launch
    and the launches the trace saw a call, and their sum a call (the
    card's busy time; the rest of a call's device time is the gaps
    between its launches)."""
    split = kernel_ms(torch, ell_ops, fn, SPLIT_CALLS)
    by = {}
    for name, (ms, seen) in split.items():
        k = by.setdefault(_kernel_name(name), [0.0, 0])
        k[0] += ms * seen
        k[1] += seen
    return dict(kernels={k: dict(ms=t / n, a_call=n / SPLIT_CALLS)
                         for k, (t, n) in by.items()},
                busy_ms_a_call=sum(t for t, _n in by.values())
                / SPLIT_CALLS)


def gated_hop_rows(torch, ell_ops, start, hub, tables, eslot, hrows, over,
                   dev):
    """The dense arm's hop at W = 4 on the frontier it pulls at K = 8
    (the one after the first, sparse, hop): ``go_hop``'s gather on the
    plan's whole grid against the gated gather ``ad_program`` launches
    (``ell_go_hop`` with a gate word), its gate open and shut, device
    times of one call (gather and hub merge), held equal."""
    R1 = tables.n_rows + 1
    bits = ell_ops.adaptive_go(start, hub, tables, eslot, hrows, over, 2,
                               2048)
    words = torch.zeros(4 * ell_ops._words(R1), dtype=torch.uint8,
                        device=dev)
    words[:bits.numel()] = bits
    f = torch.empty((R1, 4), dtype=torch.uint8, device=dev)
    ell_ops.bitmap_lanes(True, words.view(torch.int32), f, R1)
    out_u, out_g = torch.empty_like(f), torch.empty_like(f)
    gate = torch.zeros(1, dtype=torch.int64, device=dev)
    desc, blocks, lgc = ell_ops._hop_desc(tables.row0, tables.slot0,
                                          tables.rows, tables.D, 4, 4)

    def whole():
        ell_ops.go_hop(f, None, out_u, tables, eslot, hrows, over)

    def gated():
        rc = ell_ops._lib().ell_go_hop(
            f.data_ptr(), None, out_g.data_ptr(), tables.nbr.data_ptr(),
            tables.et.data_ptr(), desc, len(tables.D), blocks, lgc, 0,
            eslot.data_ptr(), hrows.data_ptr(), tables.n_rows - tables.n,
            ell_ops._over_array(over), len(over), tables.n, tables.n_rows,
            4, gate.data_ptr(), ell_ops.MODE_DENSE, ell_ops._stream(dev))
        ell_ops._ok(rc, "ell_go_hop")
    gate.fill_(ell_ops.MODE_DENSE)
    whole()
    gated()
    _equal(torch, "the gated hop", (out_u, out_g))
    row = dict(plan_blocks=blocks, frontier_rows=int(f[:, 0].sum()),
               whole_grid_ms=queued_ms(torch, whole, QUEUED),
               gated_open_ms=queued_ms(torch, gated, QUEUED))
    gate.fill_(ell_ops.MODE_SPARSE)
    row["gated_shut_ms"] = queued_ms(torch, gated, QUEUED)
    return row


def adaptive_rows(torch, ell_ops, m, ix, tables, eslot, hrows, over, dev):
    """``adaptive_go`` at 3 steps, K = 2048 and 8, in the checkout's own
    form (see the head of this file)."""
    import numpy as np
    is_over = m.edge_etype == over[0]
    deg = np.bincount(m.edge_src[is_over], minlength=m.n)[:m.n]
    first = int(np.nonzero((deg > 16) & (deg <= 128))[0][0])
    start = torch.from_numpy(
        ix.perm[np.asarray([first])].astype(np.int32)).to(dev)
    hub = torch.from_numpy(ix.hub_table().astype(np.uint8)).to(dev)
    on_card = hasattr(ell_ops, "_adaptive_plan")
    res = {}
    for K in (2048, 8):
        def adaptive():
            return ell_ops.adaptive_go(start, hub, tables, eslot, hrows,
                                       over, 3, K)
        lanes = []

        def counting(*a):
            lanes.append(1)
            return ell_ops.bitmap_lanes(*a)
        plain = ell_ops._adaptive_steps(
            start, hub, tables, eslot, hrows, over, 3, K,
            ell_ops.sparse_expand, ell_ops.pair_compact,
            ell_ops.adaptive_switch, counting, ell_ops.go_hop)
        dense = bool(lanes)
        if dense != (K == 8):
            raise AssertionError(f"adaptive_go K={K}: dense arm ran "
                                 f"{dense}")
        want = ell_ops.adaptive_go_ref(start, hub, tables, eslot, hrows,
                                       over, 3, K)
        real = ell_ops._unpack_ref(want[None, :])[0][:ix.n]
        for got in (adaptive(), plain):
            bits = ell_ops._unpack_ref(got[None, :])[0][:ix.n]
            _equal(torch, f"adaptive_go K={K}", (bits, real))
        times = [cuda_ms(torch, adaptive, ADAPTIVE_CALLS)
                 for _ in range(ROUNDS)]
        row = dict(event_ms=float(np.median(times)), rounds=times,
                   dense_arm=dense, arm_on_card=on_card)
        if on_card:
            row["ms"] = queued_ms(torch, adaptive, QUEUED)
        row.update(counts(torch, ell_ops, adaptive, waits=not on_card))
        row.update(kernel_split(torch, ell_ops, adaptive))
        res[f"adaptive_K{K}_s3"] = row
    if on_card:
        res["adaptive_dense_hop_W4"] = gated_hop_rows(
            torch, ell_ops, start, hub, tables, eslot, hrows, over, dev)
    return res


def sparse_rows(torch, ell_ops, rt, m, ix, tables, over, rng, dev):
    """``sparse_go`` at chip_smoke.py's headline batch in its three
    forms."""
    import numpy as np
    from nebula_tpu_torch.tpu.ell import sparse_caps
    deg_h = rt._deg_host(m, tuple(over))
    pool = np.nonzero(deg_h > 0)[0]
    old = rng.choice(pool, SPARSE_QUERIES, replace=False)
    new = ix.perm[old].astype(np.int32)
    q = np.arange(SPARSE_QUERIES, dtype=np.int32)
    o = np.lexsort((new, q))
    ids_h = np.full(SPARSE_C0, ix.n_rows, np.int32)
    qid_h = np.zeros(SPARSE_C0, np.int32)
    ids_h[:SPARSE_QUERIES], qid_h[:SPARSE_QUERIES] = new[o], q[o]
    ids = torch.from_numpy(ids_h).to(dev)
    qid = torch.from_numpy(qid_h).to(dev)
    ecnt, e0 = rt._hub_expansion_dev(m, ix)
    deg = rt._deg_dev(m, ix, tuple(over))
    caps = sparse_caps(SPARSE_C0, max(tables.D), 3, 1 << 17)
    qmax = 1024
    res = {}
    for form, kw in (("plain", {}), ("count", dict(count=True)),
                     ("limit", dict(limit=LIMIT_N))):
        def go():
            return ell_ops.sparse_go(ids, qid, ecnt, e0, deg, tables, over,
                                     3, caps, qmax, SPARSE_QUERIES, **kw)
        want = ell_ops.sparse_go_ref(ids, qid, ecnt, e0, deg, tables, over,
                                     3, caps, qmax, **kw)
        got = go()
        _equal(torch, f"sparse_go {form} flags", (got[1], want[1]))
        if not int(want[1]):
            _equal(torch, f"sparse_go {form}", (got, want))
        ms, enq = queued_times(torch, go, QUEUED)
        res[f"sparse_go_{form}_c0_{SPARSE_C0}"] = dict(
            ms=ms, enqueue_ms=enq,
            event_ms=cuda_ms(torch, go, BACK_TO_BACK),
            overflow=bool(int(want[1])), **counts(torch, ell_ops, go))
    return res


def k5_rows(torch, ell_ops, rt, m, ix, tables, over, rng, dev):
    """K5 (``pair_compact``) alone at c0 256 (8 queries) and c0 2048
    (1024 queries, about 8,200 chunks of 2048 words), on the mark
    bitmap the first hop of ``sparse_go`` leaves (K4 from the batch's
    starts), cut at that hop's cap: held equal to its plain version,
    then the device time (calls queued behind a spin) and event time of
    calls that keep the bitmap (``zero`` off), and the device time by
    kernel from one trace.  A checkout with K5's look-back state
    (``ell_ops.compact_state_words``) is given one zeroed state for all
    its calls; an older one allocates its block sums itself."""
    import numpy as np
    from nebula_tpu_torch.tpu.ell import sparse_caps
    deg_h = rt._deg_host(m, tuple(over))
    pool = np.nonzero(deg_h > 0)[0]
    ecnt, e0 = rt._hub_expansion_dev(m, ix)
    R1w = (ix.n_rows + 32) // 32
    state = hasattr(ell_ops, "compact_state_words")
    res = {}
    for c0, nq in ((SPARSE_C0, SPARSE_QUERIES), (2048, 1024)):
        new = ix.perm[rng.choice(pool, nq, replace=False)].astype(np.int32)
        ids = torch.from_numpy(new).to(dev)
        qid = torch.arange(nq, dtype=torch.int32, device=dev)
        caps = sparse_caps(c0, max(tables.D), 3, 1 << 17)
        words = nq * R1w
        mark = torch.zeros(words, dtype=torch.int32, device=dev)
        ctl = torch.zeros(8, dtype=torch.int64, device=dev)
        ell_ops.sparse_expand(ids, qid, ecnt, e0, tables, over, mark, R1w,
                              ctl, 1 << 20)
        c_out = caps[1]
        out = torch.empty((2, c_out), dtype=torch.int32, device=dev)
        extra = ()
        if state:
            extra = (torch.zeros(ell_ops.compact_state_words(words),
                                 dtype=torch.int64, device=dev),)

        def k5():
            ell_ops.pair_compact(mark, R1w, c_out, out[0], out[1], ctl, -1,
                                 ix.n_rows, None, None, False, 0, *extra)
        k5()
        want = out.clone()
        ell_ops.pair_compact_ref(mark.clone(), R1w, c_out, want[0], want[1],
                                 ctl.clone(), -1, ix.n_rows, None, None,
                                 False)
        _equal(torch, f"pair_compact c0={c0}", (out, want))
        set_bits = int(ctl[0])
        res[f"pair_compact_c0_{c0}"] = dict(
            ms=queued_ms(torch, k5, QUEUED),
            event_ms=cuda_ms(torch, k5, BACK_TO_BACK), words=words,
            set_bits=set_bits, c_out=c_out, look_back_state=state,
            bound_ms=(4 * words + 8 * c_out) / 3.35e9,
            **kernel_split(torch, ell_ops, k5))
    return res


def _pair_frontiers(torch, ix, W, rng, dev):
    """``chip_smoke.kernel_phase``'s frontier pair at W bytes a row: about
    2 % of the real rows random in fp, accp their union with another 2 %
    of the rows random."""
    import numpy as np
    R1 = ix.n_rows + 1
    fp_h = np.zeros((R1, W), np.uint8)
    live = rng.random(ix.n) < 0.02
    fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                     dtype=np.uint8)
    acc_h = fp_h | (rng.integers(0, 256, (R1, W), dtype=np.uint8)
                    & (rng.random((R1, 1)) < 0.02).astype(np.uint8) * 255)
    acc_h[-1] = 0
    return torch.from_numpy(fp_h).to(dev), torch.from_numpy(acc_h).to(dev)


def extract_cases(W: int, rng) -> dict:
    """The extract's (words, sel) cases at W bytes a row, P = 8: random
    distinct words and random sel (``chip_smoke.kernel_phase``'s); the
    smallest leave cohort the continuous session makes (one word, exact
    and UPTO, then its pads: word 0, exact); at W = 128 the words within
    two 16-byte units of fp, and one word in each 16-byte unit (all 4
    sectors of a row) with random sel."""
    import numpy as np
    P = 8
    w = int(rng.integers(0, W))
    cases = {
        "random": (rng.choice(W, P, replace=False),
                   (rng.random(P) < 0.5).astype(np.uint8)),
        "cohort": (np.array([w, w] + [0] * (P - 2)),
                   np.array([0, 1] + [0] * (P - 2), np.uint8))}
    if W >= 64:
        units = rng.choice(W // 16, 2, replace=False)
        cases["units2"] = (16 * units[rng.integers(0, 2, P)]
                           + rng.integers(0, 16, P),
                           np.zeros(P, np.uint8))
        cases["spread"] = (16 * rng.permutation(W // 16)[:P]
                           + rng.integers(0, 16, P),
                           (rng.random(P) < 0.5).astype(np.uint8))
    return {k: (np.asarray(a, np.int32), s) for k, (a, s) in cases.items()}


def lane_rows(torch, ell_ops, ix, rng, dev):
    """The continuous session's join, extract and clear at W = 16 and 128
    on ``chip_smoke.kernel_phase``'s inputs (join: 8 cleared lanes, 64
    start rows each; clear: 8 lanes; extract: ``extract_cases``), held
    equal to their plain versions: device time (calls queued behind a
    spin), event time (back-to-back calls, the wrapper's launch path
    included) and launches a call by capture."""
    import numpy as np
    R1 = ix.n_rows + 1
    res = {}
    for W in (16, 128):
        B = 8 * W
        fp0, acc0 = _pair_frontiers(torch, ix, W, rng, dev)
        lanes = rng.choice(B, 8, replace=False)
        keep_h = np.full(W, 0xFF, np.uint8)
        for ln in lanes:
            keep_h[ln >> 3] &= np.uint8(0xFF ^ (1 << (ln & 7)))
        keep = torch.from_numpy(keep_h).to(dev)
        fk, ak = fp0.clone(), acc0.clone()
        fr, ar = fp0.clone(), acc0.clone()
        ell_ops.lane_clear(fk, ak, keep)
        ell_ops.lane_clear_ref(fr, ar, keep)
        _equal(torch, f"lane_clear W={W}", (fk, fr), (ak, ar))

        def clear():
            ell_ops.lane_clear(fk, ak, keep)
        res[f"lane_clear_w{W}"] = dict(
            ms=queued_ms(torch, clear, QUEUED),
            event_ms=cuda_ms(torch, clear, BACK_TO_BACK),
            **_launches(torch, ell_ops, clear))
        S = 64 * len(lanes)
        rows_h = np.concatenate([rng.choice(ix.n, 64, replace=False)
                                 for _ in lanes]).astype(np.int32)
        words_h = np.repeat(lanes >> 3, 64).astype(np.int32)
        vals_h = np.repeat(np.left_shift(1, lanes & 7), 64).astype(np.uint8)
        join = tuple(torch.from_numpy(a).to(dev)
                     for a in (rows_h, words_h, vals_h))
        fj, aj = fk.clone(), ak.clone()
        ell_ops.lane_join(fk, ak, *join)
        ell_ops.lane_join_ref(fj, aj, *join)
        _equal(torch, f"lane_join W={W}", (fk, fj), (ak, aj))

        def joined():         # the OR is idempotent: each call the same work
            ell_ops.lane_join(fk, ak, *join)
        res[f"lane_join_w{W}"] = dict(
            ms=queued_ms(torch, joined, QUEUED),
            event_ms=cuda_ms(torch, joined, BACK_TO_BACK), starts=S,
            **_launches(torch, ell_ops, joined))
        for case, (words_h, sel_h) in extract_cases(W, rng).items():
            words = torch.from_numpy(words_h).to(dev)
            sel = torch.from_numpy(sel_h).to(dev)
            P = len(words_h)
            out = torch.empty((R1, P), dtype=torch.uint8, device=dev)
            want = torch.empty_like(out)
            ell_ops.lane_extract(fp0, acc0, words, sel, out)
            ell_ops.lane_extract_ref(fp0, acc0, words, sel, want)
            _equal(torch, f"lane_extract W={W} {case}", (out, want))

            def extract():
                ell_ops.lane_extract(fp0, acc0, words, sel, out)
            units = {(int(s), int(w) // 16) for w, s in zip(words_h, sel_h)}
            sectors = {(int(s), int(w) // 32) for w, s in zip(words_h, sel_h)}
            res[f"lane_extract_w{W}_{case}"] = dict(
                ms=queued_ms(torch, extract, QUEUED),
                event_ms=cuda_ms(torch, extract, BACK_TO_BACK), P=P,
                units16=len(units), sectors32=len(sectors),
                bound_ms=(2 * R1 * P + 5 * P) / 3.35e9,
                **_launches(torch, ell_ops, extract))
        del fp0, acc0, fk, ak, fr, ar, fj, aj
    return res


def k4_rows(torch, ell_ops, rt, m, ix, tables, eslot, hrows, over, rng,
            dev):
    """K4 (``sparse_expand``) alone as ``sg_program``'s hops make it at
    c0 256 (8 queries) and c0 2048 (1024 queries), 3 steps: hop 1 on the
    padded start list, hop 2 on the list K5 leaves (cut at the hop's cap,
    the pads after its count), each with the plan's hub budget clamp, held
    equal to the plain version; then device and event times and launches
    a call by capture, in the checkout's own form (a checkout whose K4
    reads the live count K5 left in ``ctl``, ``counted``, is given it
    from hop 2).  The adaptive program's K4 (3 steps, one start with 16
    to 128 out-edges) by kernel from a trace of ``adaptive_go`` at K =
    2048 (the sparse arm: K4 runs) and K = 8 (the dense arm from hop 2:
    K4's launch returns at once on its mode word), and where the wrapper
    takes a gate (``gate=``), the gated launch alone behind a spin, its
    gate shut.  Last, the launches and C calls a call of ``sparse_go``
    and ``adaptive_go`` by capture."""
    import inspect

    import numpy as np
    from nebula_tpu_torch.tpu.ell import sparse_caps
    params = inspect.signature(ell_ops.sparse_expand).parameters
    counted, gated = "counted" in params, "gate" in params
    deg_h = rt._deg_host(m, tuple(over))
    pool = np.nonzero(deg_h > 0)[0]
    ecnt, e0 = rt._hub_expansion_dev(m, ix)
    R1w = (ix.n_rows + 32) // 32
    res = {}
    for c0, nq in ((SPARSE_C0, SPARSE_QUERIES), (2048, 1024)):
        new = ix.perm[rng.choice(pool, nq, replace=False)].astype(np.int32)
        q = np.arange(nq, dtype=np.int32)
        o = np.lexsort((new, q))
        ids_h = np.full(c0, ix.n_rows, np.int32)
        qid_h = np.zeros(c0, np.int32)
        ids_h[:nq], qid_h[:nq] = new[o], q[o]
        caps = sparse_caps(c0, max(tables.D), 3, 1 << 17)
        pl = ell_ops._sparse_plan(c0, tuple(caps), 1024, nq, tables.n,
                                  tables.n_rows, False, None, False)
        ids = torch.from_numpy(ids_h).to(dev)
        qid = torch.from_numpy(qid_h).to(dev)
        if c0 == SPARSE_C0:
            def go(ids=ids, qid=qid, caps=caps, nq=nq):
                return ell_ops.sparse_go(ids, qid, ecnt, e0, None, tables,
                                         over, 3, caps, 1024, nq)
            go()
            res[f"sparse_go_plain_c0_{c0}"] = counts(torch, ell_ops, go)
        mark = torch.zeros(nq * R1w, dtype=torch.int32, device=dev)
        ctl = torch.zeros(8, dtype=torch.int64, device=dev)
        for h, (c_out, ex, c_lim) in enumerate(pl.hops):
            args = (ids, qid, ecnt, e0, tables, over, mark, R1w, ctl, c_lim)
            extra = (False, h > 0) if counted else ()
            m_r, c_r = mark.clone(), ctl.clone()
            ell_ops.sparse_expand(*args, *extra)
            ell_ops.sparse_expand_ref(*args[:6], m_r, R1w, c_r, c_lim,
                                      *extra)
            _equal(torch, f"sparse_expand c0={c0} hop {h + 1}", (mark, m_r),
                   (ctl, c_r))
            live = int((ids != ix.n_rows).sum())

            def k4():
                ell_ops.sparse_expand(*args, *extra)
            res[f"sparse_expand_c0_{c0}_hop{h + 1}"] = dict(
                ms=queued_ms(torch, k4, QUEUED),
                event_ms=cuda_ms(torch, k4, BACK_TO_BACK),
                pairs=int(ids.numel()), live_pairs=live,
                reads_live_count=bool(extra and extra[1]),
                **_launches(torch, ell_ops, k4))
            if h + 1 == len(pl.hops):
                break
            # the timed calls left the hop's bits (the pushes are ORs);
            # K5 cuts them to the next hop's list, the count into ctl
            nxt = torch.empty((2, c_out), dtype=torch.int32, device=dev)
            ctl.zero_()
            ell_ops.pair_compact_ref(mark, R1w, c_out, nxt[0], nxt[1], ctl,
                                     -1, ix.n_rows)
            ids, qid = nxt[0], nxt[1]
    is_over = m.edge_etype == over[0]
    deg = np.bincount(m.edge_src[is_over], minlength=m.n)[:m.n]
    first = int(np.nonzero((deg > 16) & (deg <= 128))[0][0])
    start = torch.from_numpy(
        ix.perm[np.asarray([first])].astype(np.int32)).to(dev)
    hub = torch.from_numpy(ix.hub_table().astype(np.uint8)).to(dev)
    for K in (2048, 8):
        def adaptive():
            return ell_ops.adaptive_go(start, hub, tables, eslot, hrows,
                                       over, 3, K)
        split = kernel_split(torch, ell_ops, adaptive)
        row = {k: v for k, v in split["kernels"].items()
               if k == "sparse_expand_kernel"}
        res[f"sparse_expand_adaptive_K{K}"] = dict(
            traced=row, **counts(torch, ell_ops, adaptive))
    if gated:
        fr = torch.full((2048,), ix.n_rows, dtype=torch.int32, device=dev)
        cand = torch.zeros(R1w, dtype=torch.int32, device=dev)
        ctl = torch.zeros(8, dtype=torch.int64, device=dev)
        ctl[ell_ops.CTL_MODE] = ell_ops.MODE_DENSE

        def shut():
            ell_ops.sparse_expand(fr, None, None, None, tables, over, cand,
                                  R1w, ctl, 0, False, True,
                                  gate=ctl[ell_ops.CTL_MODE:
                                           ell_ops.CTL_MODE + 1],
                                  want=ell_ops.MODE_SPARSE)
        res["sparse_expand_gated_shut"] = dict(
            ms=queued_ms(torch, shut, QUEUED),
            event_ms=cuda_ms(torch, shut, BACK_TO_BACK),
            **_launches(torch, ell_ops, shut))
    return res


def bfs_pair_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng, dev):
    """``ell_bfs_sharded`` at k = MESH_K on this card beside the single-
    card ``ell_bfs`` on the same starts and targets (one random start
    and target a lane, UPTO 5, stop when found) at W = 16 and 128, both
    held equal: event times, and each one's device time by kernel from
    one trace, the flag reads included."""
    import numpy as np
    from nebula_tpu_torch.tpu import mesh as pmesh
    from nebula_tpu_torch.tpu.ell import mesh_tables
    k = MESH_K
    mt = mesh_tables(ix, pmesh.PartsMesh([dev] * k))
    es, hs = [eslot] * k, [hrows] * k
    R1 = ix.n_rows + 1
    res = {}
    for W in (16, 128):
        B = 8 * W
        f0 = torch.zeros((R1, W), dtype=torch.uint8, device=dev)
        t0 = torch.zeros_like(f0)
        lane = torch.arange(B, device=dev)
        for f in (f0, t0):
            rows = torch.from_numpy(ix.perm[rng.integers(0, ix.n, B)]
                                    .astype(np.int64)).to(dev)
            f.view(-1).index_put_((rows * W + lane // 8,),
                                  (1 << (lane % 8)).to(torch.uint8),
                                  accumulate=True)

        def mesh():
            return ell_ops.ell_bfs_sharded(f0, t0, mt, es, hs, over, 5)

        def one():
            return ell_ops.ell_bfs(f0.clone(), t0, tables, eslot, hrows,
                                   over, 5)
        (dm, lm), (d1, l1) = mesh(), one()
        _equal(torch, f"ell_bfs_sharded W={W}", (dm, d1))
        if lm != l1:
            raise AssertionError(f"ell_bfs_sharded ran {lm} levels, "
                                 f"ell_bfs {l1}")
        res[f"bfs_pair_w{W}"] = dict(
            levels=lm, ell_bfs_sharded_event_ms=cuda_ms(torch, mesh,
                                                        BFS_CALLS, 1),
            ell_bfs_event_ms=cuda_ms(torch, one, BFS_CALLS, 1),
            ell_bfs_sharded_split=kernel_split(torch, ell_ops, mesh),
            ell_bfs_split=kernel_split(torch, ell_ops, one))
    return res


def _one_a_lane(torch, ix, W, rng, dev):
    """A packed [n_rows + 1, W] frontier with one random row a lane."""
    import numpy as np
    R1, B = ix.n_rows + 1, 8 * W
    f = torch.zeros((R1, W), dtype=torch.uint8, device=dev)
    lane = torch.arange(B, device=dev)
    rows = torch.from_numpy(ix.perm[rng.integers(0, ix.n, B)]
                            .astype(np.int64)).to(dev)
    f.view(-1).index_put_((rows * W + lane // 8,),
                          (1 << (lane % 8)).to(torch.uint8), accumulate=True)
    return f


def bfs_rows(torch, ell_ops, ix, tables, eslot, hrows, over, dev):
    """K3 (``bfs_level``), ``bfs_depth_i8`` and the three BFS programs at
    W = 16 and 128 (B = 128 and 1024), on inputs made from SEED and W
    alone, so that two checkouts see the same ones.  K3 in the
    checkout's own form (a reached bitmap ``seen`` and ``d`` in the
    result's form where it has ``ell_ops.depth_dtype``, else an int16
    ``d``; each int16 and int8 where the checkout has both): its first
    pass on a 2 %-dense frontier (2 % of the rows random bytes), beside
    a fill of ``d`` alone (``Tensor.fill_``, the copy bound's own
    kernel); the level after one hop of that frontier (device time less
    the restore of its state); the level after the first hop from
    one random start a lane.  Each level of the checkout's own form held
    equal to its plain version.  ``bfs_depth_i8`` on a seeded int16
    matrix (70 % INF, made on the card from SEED and W).  ``ell_bfs``,
    ``ell_bfs_sharded`` (k = MESH_K on this card) and ``ell_bfs_i8`` at
    UPTO 5, stop when found, from one random start and target a lane,
    by events and held equal; one trace's device time of ``ell_bfs`` by
    kernel."""
    import numpy as np
    from nebula_tpu_torch.tpu import mesh as pmesh
    from nebula_tpu_torch.tpu.ell import INT16_INF, mesh_tables
    new = hasattr(ell_ops, "depth_dtype")
    R1, k = ix.n_rows + 1, MESH_K
    mt = mesh_tables(ix, pmesh.PartsMesh([dev] * k))
    es, hs = [eslot] * k, [hrows] * k
    res = dict(bfs_form="seen" if new else "int16 d")

    def level(nxt, tp, seen, d, flags, step, first=False):
        if new:
            ell_ops.bfs_level(nxt, tp, seen, d, flags, step, first)
        else:
            ell_ops.bfs_level(nxt, tp, d, flags, step, first)

    def held(what, nxt, tp, seen, d, flags, step, first, got):
        if not new:
            return
        want = [x.clone() for x in (nxt, seen, d, flags)]
        ell_ops.bfs_level_ref(*want[:1], tp, *want[1:], step, first, True)
        _equal(torch, what, *zip(got, want))

    def restored(run, restore, iters=QUEUED):
        def both():
            restore()
            run()
        return max(0.0, queued_ms(torch, both, iters)
                   - queued_ms(torch, restore, iters))

    for W in (16, 128):
        B = 8 * W
        seed = np.random.default_rng(SEED + W)
        fp_h = np.zeros((R1, W), np.uint8)
        live = seed.random(ix.n) < 0.02
        fp_h[:ix.n][live] = seed.integers(0, 256, (int(live.sum()), W),
                                          dtype=np.uint8)
        fp0 = torch.from_numpy(fp_h).to(dev)
        tl = torch.from_numpy(np.where(seed.random((R1, W)) < 0.02,
                                       seed.integers(0, 256, (R1, W)), 0)
                              .astype(np.uint8)).to(dev)
        f1, t1 = (_one_a_lane(torch, ix, W, seed, dev) for _ in range(2))
        flags = torch.zeros((2, 2), dtype=torch.int32, device=dev)
        for dt in (torch.int8, torch.int16) if new else (torch.int16,):
            tag = f"w{W}_" + ("i8" if dt == torch.int8 else "i16")
            d = torch.empty((R1, B), dtype=dt, device=dev)
            seen = torch.empty_like(fp0) if new else None
            unreached = -1 if dt == torch.int8 else int(INT16_INF)

            def first():
                level(fp0, tl, seen, d, flags[0], 0, True)
            first()
            held(f"first pass {tag}", fp0, tl, seen, d, flags[0], 0, True,
                 [fp0, seen, d, flags[0]])
            res[f"bfs_first_{tag}"] = dict(
                ms=queued_ms(torch, first, QUEUED),
                event_ms=cuda_ms(torch, first, BACK_TO_BACK),
                fill_ms=queued_ms(torch, lambda: d.fill_(unreached), QUEUED))
            for name, start in (("dense", fp0), ("level1", f1)):
                level(start, tl, seen, d, flags[0], 0, True)
                nxt0 = torch.empty_like(start)
                ell_ops.go_hop(start, None, nxt0, tables, eslot, hrows, over)
                s0 = seen.clone() if new else None
                d0 = d.clone()
                nk = nxt0.clone()

                def restore():
                    nk.copy_(nxt0)
                    d.copy_(d0)
                    if new:
                        seen.copy_(s0)

                def run():
                    level(nk, tl, seen, d, flags[1], 0)
                restore()
                flags[1].zero_()
                run()
                held(f"{name} level {tag}", nxt0, tl, s0, d0,
                     torch.zeros_like(flags[1]), 0, False,
                     [nk, seen, d, flags[1]])
                res[f"bfs_level_{name}_{tag}"] = dict(
                    ms=restored(run, restore),
                    event_ms=cuda_ms(torch, lambda: (restore(), run()),
                                     BACK_TO_BACK)
                    - cuda_ms(torch, restore, BACK_TO_BACK),
                    live_bits=int(ell_ops._unpack_ref(nxt0).sum(
                        dtype=torch.int64)))
                del d0, nk, nxt0, s0
            del d, seen
        # the int8 form of an int16 result
        g = torch.Generator(device=dev).manual_seed(SEED + W)
        dd = torch.where(torch.rand((R1, B), generator=g, device=dev) < 0.7,
                         int(INT16_INF),
                         torch.randint(0, 6, (R1, B), generator=g,
                                       device=dev)).to(torch.int16)
        o8, w8 = torch.empty(dd.shape, dtype=torch.int8, device=dev), \
            torch.empty(dd.shape, dtype=torch.int8, device=dev)
        ell_ops.bfs_depth_i8(dd, o8)
        ell_ops.bfs_depth_i8_ref(dd, w8)
        _equal(torch, f"bfs_depth_i8 W={W}", (o8, w8))
        res[f"bfs_depth_i8_w{W}"] = dict(
            ms=queued_ms(torch, lambda: ell_ops.bfs_depth_i8(dd, o8), QUEUED),
            event_ms=cuda_ms(torch, lambda: ell_ops.bfs_depth_i8(dd, o8),
                             BACK_TO_BACK))
        del dd, o8, w8

        # the programs
        def one():
            return ell_ops.ell_bfs(f1.clone(), t1, tables, eslot, hrows,
                                   over, 5)

        def mesh():
            return ell_ops.ell_bfs_sharded(f1, t1, mt, es, hs, over, 5)
        s8, t8 = (ell_ops._unpack_ref(x).view(torch.int8).contiguous()
                  for x in (f1, t1))

        def i8():
            return ell_ops.ell_bfs_i8(s8.clone(), t8, tables, eslot, hrows,
                                      over, 5)
        (d1, l1), (dm, lm), (di, li) = one(), mesh(), i8()
        _equal(torch, f"BFS programs W={W}", (dm, d1), (di, d1))
        if not l1 == lm == li:
            raise AssertionError(f"BFS levels {l1}, {lm}, {li} at W={W}")
        del d1, dm, di
        res[f"bfs_programs_w{W}"] = dict(
            levels=l1,
            ell_bfs_event_ms=cuda_ms(torch, one, BFS_CALLS, 1)
            - cuda_ms(torch, lambda: f1.clone(), BFS_CALLS, 1),
            ell_bfs_sharded_event_ms=cuda_ms(torch, mesh, BFS_CALLS, 1),
            ell_bfs_i8_event_ms=cuda_ms(torch, i8, BFS_CALLS, 1)
            - cuda_ms(torch, lambda: s8.clone(), BFS_CALLS, 1),
            ell_bfs_split=kernel_split(torch, ell_ops, one))
    return res


def fused_rows(torch, edge_ops, rt, m, rng, dev):
    """``go_filtered`` from one start at 3 steps, predicate 3, pushed."""
    import numpy as np
    from nebula_tpu_torch.filter.expressions import (_from_wire,
                                                     decode_expr,
                                                     encode_expr)
    plan = rt._plan_go(1, {"e": 1}, decode_expr(encode_expr(
        _from_wire(PREDICATE))), True)
    prog = rt._filter_program(m, 1, plan)
    env = rt._env_cols(m, {"e": 1}, plan.filter_used, True)
    slots = [env[k] for k, _kind, _t in prog.slots]
    csr = rt._device_csr(m)
    # the edges as the checkout's programs take them: with their row
    # index where the hop walks the CSR rows (edge_ops.edge_scan_hop)
    edges = (csr["edge_src"], csr["edge_dst"], csr["edge_etype"]) + (
        (csr["row_ptr"],) if hasattr(edge_ops, "edge_scan_hop") else ())
    src, dst = edges[:2]
    deg = np.bincount(m.edge_src[m.edge_etype == 1], minlength=m.n)[:m.n]
    st_h = np.full(8, -1, np.int32)
    st_h[0] = int(rng.choice(np.nonzero(deg > 0)[0]))
    st = torch.from_numpy(st_h).to(dev)

    def go():
        return edge_ops.go_filtered(*edges, st, m.n, 3, (1,), prog, slots)
    got = go()
    want = edge_ops.go_filtered_ref(*edges, st, m.n, 3, (1,), prog, slots)
    _equal(torch, "go_filtered", *zip(got, want))
    k10 = edge_ops.LAUNCHES["expr_filter"]
    go()
    k10 = edge_ops.LAUNCHES["expr_filter"] - k10
    # the interpreter over every edge, alone: its cost an instruction
    mask = torch.empty(src.shape, dtype=torch.bool, device=dev)
    want_mask = torch.empty_like(mask)
    edge_ops.expr_filter(prog, slots, src, dst, mask)
    edge_ops.expr_filter_ref(prog, slots, src, dst, want_mask)
    _equal(torch, "expr_filter", (mask, want_mask))

    def k10_all():
        edge_ops.expr_filter(prog, slots, src, dst, mask)
    k10_ms = queued_ms(torch, k10_all, QUEUED)
    return {"expr_filter_p3": dict(
        ms=k10_ms, instructions=len(prog), edges=int(src.shape[0]),
        ns_an_instruction_and_edge=k10_ms * 1e6 / (len(prog)
                                                   * int(src.shape[0])),
        event_ms=cuda_ms(torch, k10_all, BACK_TO_BACK)),
            "go_filtered_S1_s3_p3": dict(
        ms=queued_ms(torch, go, QUEUED),
        event_ms=cuda_ms(torch, go, BACK_TO_BACK),
        kept=int(got[0].sum()),
        expr_filter_launches=k10,
        **counts(torch, edge_ops, go))}


def edge_rows(torch, edge_ops, rt, m, rng, dev):
    """K8 (``edge_hop``) on four frontiers of the serve graph: 2 % of
    the vertices set (``chip_smoke.py``'s), one start, every vertex,
    the 16 vertices with the longest rows; ``edge_seed`` with 1 and 256
    starts.  Each held equal to its plain version, with its device
    time, event time and launches a call by capture, in the checkout's
    own form: where ``edge_ops.edge_scan_hop`` exists, K8 walks the
    mirror's CSR rows (``row_ptr`` on the card) and also takes the
    start list itself (the ``start_list`` row); before, it scans every
    edge."""
    import numpy as np
    csr = rt._device_csr(m)
    src, dst, et = csr["edge_src"], csr["edge_dst"], csr["edge_etype"]
    walk = hasattr(edge_ops, "edge_scan_hop")
    n, over = m.n, (1,)
    rows = np.diff(m.row_ptr)
    hubs = np.argsort(rows, kind="stable")[-16:]
    start = int(rng.choice(np.nonzero(rows > 0)[0]))
    frontiers = {"dense2": torch.from_numpy(rng.random(n) < 0.02),
                 "start": torch.zeros(n, dtype=torch.bool),
                 "all": torch.ones(n, dtype=torch.bool),
                 "hubs16": torch.zeros(n, dtype=torch.bool)}
    frontiers["start"][start] = True
    frontiers["hubs16"][torch.from_numpy(hubs)] = True
    ids = np.full(8, -1, np.int32)
    ids[0] = start
    forms = {k: f.to(dev) for k, f in frontiers.items()}
    if walk:
        forms["start_list"] = torch.from_numpy(ids).to(dev)
        lead = (src, dst, et, csr["row_ptr"])
    else:
        lead = (src, dst, et)
    res = {}
    for label, f in forms.items():
        out = torch.empty(n, dtype=torch.bool, device=dev)
        want = torch.empty_like(out)
        edge_ops.edge_hop(f, out, *lead, over)
        edge_ops.edge_hop_ref(f, want, *lead, over)
        _equal(torch, f"edge_hop {label}", (out, want))

        def hop():
            edge_ops.edge_hop(f, out, *lead, over)
        live = frontiers.get(label, frontiers["start"]).numpy()
        res[f"edge_hop_{label}"] = dict(
            ms=queued_ms(torch, hop, QUEUED),
            event_ms=cuda_ms(torch, hop, BACK_TO_BACK),
            live=int(live.sum()), live_edges=int(rows[live].sum()),
            reached=int(out.sum()), **counts(torch, edge_ops, hop))
    for S in (1, 256):
        idx_h = np.full(max(8, 1 << (S - 1).bit_length()), -1, np.int32)
        idx_h[:S] = rng.integers(0, n, S)
        idx = torch.from_numpy(idx_h).to(dev)
        sk = torch.empty(n, dtype=torch.bool, device=dev)
        sr = torch.empty_like(sk)
        edge_ops.edge_seed(sk, idx)
        edge_ops.edge_seed_ref(sr, idx)
        _equal(torch, f"edge_seed S={S}", (sk, sr))

        def seed():
            edge_ops.edge_seed(sk, idx)
        res[f"edge_seed_s{S}"] = dict(
            ms=queued_ms(torch, seed, QUEUED),
            event_ms=cuda_ms(torch, seed, BACK_TO_BACK),
            **counts(torch, edge_ops, seed))
    return res


def _launches(torch, ell_ops, fn) -> dict:
    """Launches and C calls a call of ``fn`` by capture, with their
    kinds; a call that cannot be captured (a copy from pageable memory
    waits on the stream) is traced instead."""
    try:
        n = launches_a_call(torch, ell_ops, fn)
    except Exception as e:          # noqa: BLE001 -- reported, not hidden
        traced, c_calls = profiled_calls(torch, ell_ops, fn)
        return dict(launches_traced=[len(c) for c in traced],
                    kinds_traced=sorted({k for c in traced for k, _ in c}),
                    c_calls_a_call=max(c_calls),
                    not_captured=f"{type(e).__name__}: {e}"[:200])
    return {a: n[a] for a in ("launches_a_call", "c_calls_a_call",
                              "launch_kinds", "launches_traced")}


def upload_rows(torch, ell_ops, rt, ix, rng, dev):
    """K1 at B = 128 and 1024 from one random start a query: the kernel
    alone on the list the checkout's runtime sends it (a sorted int32
    [2, S] array where ``ell_ops.count_state`` exists, else the padded
    rows / words / vals) and the runtime's whole
    ``_upload_frontier_packed``, held equal to the plain version."""
    import numpy as np
    new = hasattr(ell_ops, "count_state")
    res = {}
    for B in (128, 1024):
        new_ids = ix.perm[rng.integers(0, ix.n, B)].astype(np.int32)
        q = np.arange(B, dtype=np.int32)
        got = rt._upload_frontier_packed(ix, new_ids, q, B)
        out = torch.empty_like(got)
        want = torch.empty_like(got)
        if new:
            args = (torch.from_numpy(rt._packed_coords(new_ids, q, B)).to(
                dev),)
        else:
            Sp = max(8, 1 << (B - 1).bit_length())
            rows = np.full(Sp, ix.n_rows, np.int32)
            rows[:B] = new_ids
            words = np.zeros(Sp, np.int32)
            words[:B] = q >> 3
            vals = np.zeros(Sp, np.uint8)
            vals[:B] = np.left_shift(1, q & 7)
            args = tuple(torch.from_numpy(a).to(dev)
                         for a in (rows, words, vals))
        ell_ops.frontier_upload(out, *args)
        ell_ops.frontier_upload_ref(want, *args)
        _equal(torch, f"frontier_upload B={B}", (out, want), (got, want))

        def kernel():
            ell_ops.frontier_upload(out, *args)

        def call():
            rt._upload_frontier_packed(ix, new_ids, q, B)
        call_ms, enqueue_ms = queued_times(torch, call, QUEUED)
        res[f"frontier_upload_b{B}"] = dict(
            ms=queued_ms(torch, kernel, QUEUED),
            event_ms=cuda_ms(torch, kernel, BACK_TO_BACK),
            call_ms=call_ms, call_enqueue_ms=enqueue_ms / QUEUED,
            call_event_ms=cuda_ms(torch, call, BACK_TO_BACK),
            **_launches(torch, ell_ops, call))
    return res


def count_rows(torch, ell_ops, rt, m, ix, tables, eslot, hrows, over, rng,
               dev):
    """K2 at B = 128 and 1024 on the exact 3-step frontier from one
    random start a query (``chip_smoke.py``'s), on an all-ones frontier
    and on a random one a quarter dense (every word mixed), with the
    real deg, and the quarter-dense one with deg up to 2^17 (most rows
    past what K2's register pairs take), held equal to the plain
    version."""
    import numpy as np
    deg = rt._deg_dev(m, ix, tuple(over))
    res = {}
    for B in (128, 1024):
        f0 = rt._upload_frontier_packed(
            ix, ix.perm[rng.integers(0, ix.n, B)].astype(np.int32),
            np.arange(B, dtype=np.int32), B)
        step3 = ell_ops.ell_go(f0, tables, eslot, hrows, over, 3)
        ones = torch.full_like(step3, 255)
        ones[-1] = 0
        shape = tuple(step3.shape)
        quarter = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)
            & rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        quarter[ix.n:] = 0
        big = torch.from_numpy(rng.integers(0, 2**17, ix.n_rows + 1)
                               .astype(np.int32)).to(dev)
        big[ix.n:] = 0
        for label, out, dg in (("step3", step3, deg), ("ones", ones, deg),
                               ("quarter", quarter, deg),
                               ("quarter_big_deg", quarter, big)):
            ck = torch.empty(B, dtype=torch.int32, device=dev)
            cr = torch.empty_like(ck)
            ell_ops.go_count(out, dg, ck)
            ell_ops.go_count_ref(out, dg, cr)
            _equal(torch, f"go_count {label} B={B}", (ck, cr))

            def kernel():
                ell_ops.go_count(out, dg, ck)
            res[f"go_count_{label}_b{B}"] = dict(
                ms=queued_ms(torch, kernel, QUEUED),
                event_ms=cuda_ms(torch, kernel, BACK_TO_BACK),
                **_launches(torch, ell_ops, kernel))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tree", default=here)
    ap.add_argument("--rows", default=",".join(ROW_GROUPS),
                    help="row groups to time: " + ", ".join(ROW_GROUPS))
    args = ap.parse_args(argv)
    rows = set(args.rows.split(","))
    if not rows <= set(ROW_GROUPS):
        ap.error(f"--rows: unknown groups {sorted(rows - set(ROW_GROUPS))}")
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hop_bench: no CUDA device", file=sys.stderr)
        return 2
    from nebula_tpu_torch.interface.common import SupportedType as T
    from nebula_tpu_torch.meta.schema import SchemaView
    from nebula_tpu_torch.tpu import _build, edge_ops, ell_ops
    from nebula_tpu_torch.tpu.csr import mirror_from_edges
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    from nebula_tpu_torch.tools.graphgen import powerlaw_graph

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    src, dst = powerlaw_graph(VERTICES, EDGES, 2.2, 20000, SEED)
    crng = np.random.default_rng(SEED + 17)   # chip_smoke.fused_columns
    w = crng.integers(0, 1000, len(src))
    score = crng.integers(0, 64, len(src)) / 8.0
    m = mirror_from_edges(src, dst, 1, space_id=1, edge_props={
        1: {"w": (T.INT, w), "score": (T.DOUBLE, score)}})
    rt = TorchQueryRuntime()
    rt.load_space(1, m, SchemaView().add_space(1, {}, {"e": 1}))
    ix = rt.ell(m)
    tables = ix.device_tables(dev)
    eslot, hrows = (torch.from_numpy(a.astype(np.int32)).to(dev)
                    for a in ix.hub_merge())
    rng = np.random.default_rng(SEED + 7)
    over = (1,)
    res = dict(tree=os.path.abspath(args.tree), card=smi, build_s=build_s,
               n_rows=ix.n_rows, slots=int(tables.nbr.numel()),
               buckets=list(tables.D))
    groups = (
        ("hop", lambda: hop_rows(torch, ell_ops, ix, tables, eslot, hrows,
                                 over, rng, dev)),
        ("adaptive", lambda: adaptive_rows(torch, ell_ops, m, ix, tables,
                                           eslot, hrows, over, dev)),
        ("sparse", lambda: sparse_rows(torch, ell_ops, rt, m, ix, tables,
                                       over, rng, dev)),
        ("fused", lambda: fused_rows(torch, edge_ops, rt, m, rng, dev)),
        ("edge", lambda: edge_rows(torch, edge_ops, rt, m, rng, dev)),
        ("int8", lambda: int8_rows(torch, ell_ops, ix, tables, eslot, hrows,
                                   over, rng, dev)),
        ("mesh", lambda: mesh_rows(torch, ell_ops, ix, tables, eslot, hrows,
                                   over, rng, dev)),
        ("mesh_sparse", lambda: mesh_sparse_rows(torch, ell_ops, ix, tables,
                                                 over, rng, dev)),
        ("k5", lambda: k5_rows(torch, ell_ops, rt, m, ix, tables, over, rng,
                               dev)),
        ("bfs_pair", lambda: bfs_pair_rows(torch, ell_ops, ix, tables, eslot,
                                           hrows, over, rng, dev)),
        ("bfs", lambda: bfs_rows(torch, ell_ops, ix, tables, eslot, hrows,
                                 over, dev)),
        ("upload", lambda: upload_rows(torch, ell_ops, rt, ix, rng, dev)),
        ("count", lambda: count_rows(torch, ell_ops, rt, m, ix, tables,
                                     eslot, hrows, over, rng, dev)),
        ("lanes", lambda: lane_rows(torch, ell_ops, ix, rng, dev)),
        ("k4", lambda: k4_rows(torch, ell_ops, rt, m, ix, tables, eslot,
                               hrows, over, rng, dev)),
        ("mesh_x", lambda: mesh_x_rows(torch, ell_ops, ix, tables, over, rng,
                                       dev)),
        ("k15", lambda: k15_rows(torch, ell_ops, ix, tables, eslot, hrows,
                                 over, dev)))
    try:
        for name, fn in groups:
            if name in rows:
                res.update(fn())
    finally:
        rt.close()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
