#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nebula_tpu_torch``) on one
Hopper card.

    python3 chip_smoke.py [--vertices N] [--edges M] [--seed S]
                          [--requests R] [--threads T] [--cap C]
                          [--widths LIST] [--path-requests P]
                          [--path-threads PT] [--profile R]
                          [--fused-requests F] [--fused-threads FT]
                          [--write-vertices WN] [--write-edges WM]
                          [--write-seconds WS] [--unpacked-requests U]
                          [--unpacked-path-requests UP]
                          [--mesh-requests MR] [--mesh-path-requests MP]
                          [--props-requests PR]

The defaults are the serve cell; ``--vertices 16777216 --edges
105000000 --cap 256 --widths 128`` is the round-5 scale shape, and
``--profile R`` adds a profiled window of each traffic kind after
phase 9.

Phases, in order; any failure exits non-zero:

1. device    the card's name, compute capability, and its name and
             power limit as nvidia-smi prints them
2. build     compile the CUDA kernels from ``nebula_tpu_torch/tpu/csrc``
             with nvcc (sm_90a) and load them
3. kernels   each kernel against its plain PyTorch version on the serve
             graph's real tables, at W = 128 (B = 1024 lanes) and W = 16
             (B = 128): exact equality, CUDA-event times for the kernel
             (for the hop, ``or_into`` and the lane join, extract and
             clear their device time, the calls queued behind a spin
             kernel, with the event time beside), the plain version
             and, where one exists, the PyTorch library call computing
             the same function, and the card's bound for the work.
             The continuous session's four kernels (the extract also
             on words within two 16-byte units and one in each unit at
             W = 128, the sectors its words touch beside its bound, and
             held untimed at P = 8, 16 and 2W, at W = 4, on odd P, an
             output one byte off and carriers off 16-byte alignment),
             then the windowed path's: the packed frontier
             upload K1 (the runtime's call too: one kernel and one
             copy a call by capture, its host enqueue behind a spin
             kernel below the spin's time), ``ell_go`` at 3 steps
             (exact and UPTO), the COUNT(*) fold K2 (the 3-step
             frontier, an all-ones one, a deg whose sums wrap; one
             launch a call), both also at B = 32 and on rows that are
             not a whole number of K1's 8 KB blocks, K3 the BFS level
             pass (every level of an
             UPTO 5 BFS, int8 depths, and of a ``max_steps`` 121 one,
             int16, held to the plain level on the same state; alone,
             its first pass and the level after one hop from one start
             a lane and from a 2 %-dense frontier, with a bound for the
             reached-bitmap design and the one before it; the UPTO 5
             program's bound from its kernels' bytes) and the int8
             form of the int16 result; then
             the sparse GO program (K4 expand, K5 compact, K6 reduce)
             at c0 256 and 2048, 3 and 4 steps, with a tight-cap batch
             that overflows, and the adaptive program (K4, K5, K7, the
             lane layout change, the hop) at the default K and a K
             that forces the dense switch: every kernel call of those
             runs is held against its plain version on copies of its
             operands, and each program's output against the program's
             plain version, run once as its step sequence and once as the
             runtime calls it, one C call (``sg_program``,
             ``ad_program``: device and event times, launches and C
             calls a call by capture, held to the designed counts, and
             50 calls more, each equal to the first); K4 held untimed
             at odd shapes (``k4_odd_check``: live prefixes followed
             by stale pairs or sentinels, self mode, hub runs past the
             clamp, buckets of 1-40 slots off alignment, up to 9000
             pairs) and its gated launch timed shut and open; K5, one launch a
             call, then held bit for bit to ``pair_compact_ref`` in
             each caller's form (``k5_caller_check``: alone,
             ``sg_program``'s workspace at 8 and 1024 queries,
             ``ad_program``'s gate open and shut, ``mesh_dedup``'s
             four shards) on an empty bitmap, bits only in the last
             chunk, the cap inside a chunk and on a chunk's edge, and
             50 calls on one look-back state;
             then the edge-list kernels on the graph's
             edge arrays and generated columns: K8 ``edge_hop``, the
             walk over the CSR rows, on a 2 %-dense frontier (with
             ``scatter_reduce_`` amax as its library yardstick), one
             start as a bitmap and as a start list, every vertex and
             the 16 longest rows (device and event times, a memset
             and one kernel a call by capture), ``edge_final``,
             ``edge_seed`` from 1 and 256 starts (one launch a call),
             ``expr_filter`` for each
             predicate of phase 8's family in each of its modes,
             ``edge_bfs_level``, the programs ``go`` and
             ``go_filtered`` at 1-3 steps from 1 and 256 starts (at 3
             steps 5 launches in 3 C calls by capture: no start
             bitmap, the first hop reads the start list;
             ``go_filtered`` launching no ``expr_filter``: its WHERE
             runs in its final pass ``edge_final_where``, which is held
             per predicate-mode to its plain version and to K9 over
             K10's whole mask), and ``bfs`` on a connected and an
             unreachable pair, all exactly; then ``ell_absorb`` on the graph's flat tables for
             three absorb plans made by ``plan_ell_absorb``: 4096 edge
             events (updates, deletes, inserts on non-hub owners, both
             directions), a growth-spare claim, and every bucket's last
             row with pads at every bucket's end; equal to the plain
             version and to the host's next generation, the input
             tables unchanged; then the packing-off route's kernels
             (``csrc/ell_int8.cu``) at B = 1024 and 128 on the inputs
             that route gives them: K12 ``frontier_upload_i8`` (with
             ``index_put_`` as its library yardstick), K13 ``go_hop_i8``
             (three chained hops, their live bitmaps chained as a
             program chains them, exact and UPTO, on the start
             frontier, a dense and an arbitrary one, every ``live_out``
             equal to the plain version's and a superset of the rows
             with a byte > 0; device and event times on the start and
             dense frontiers, as a first hop and as a later one),
             K13's row-packed last advance (with and without UPTO, from
             a first and a later hop), ``ell_go_i8`` at 1-4 steps
             (exact and UPTO, row-packed; timed at 3, its launches a
             call by capture, no K14) beside the packed ``ell_go`` on
             the same starts and tables (the same vertex sets), K14
             ``pack_rows`` (a 1-step call's only pass), ``ell_bfs_i8``
             (UPTO 5, a connected and an unreachable pair among random
             lanes, its targets as K1's lane bits and as an int8
             carrier, every level held to the plain level, no
             ``bfs_depth_i8``) and K15 ``bfs_level_i8`` (its first pass
             both ways, a level on level 1's state and on a dense
             frontier); and all of them once more, untimed, off the
             ladder: B = 10 (K13's byte columns, K15's byte path), 12
             (their 4-byte paths) and 128 with the carriers 4 bytes off
             a 16-byte boundary, K15 five levels state by state with an
             int8 and an int16 d; the row-packed advance on hand-made
             tables whose buckets start inside 8-row groups; the
             packed hop, untimed, three chained hops with and without
             the accumulator at W = 16, 128, 4, 12, 20 and 48, at
             W = 16 on rows, slot tables or both 4 bytes off alignment
             (its 4-byte paths), and at W = 160 on rows off alignment
             (more 4-byte columns than a warp has lanes); then the
             replicated-frontier mesh (``mesh_kernel_phase``) with the
             serve tables cut into k = 2 and 4 shards that all sit on
             this card, at B = 1024 and 128: ``mesh_hop``'s stages, each
             one launch over every shard: M1 ``shard_hop`` (the hop's
             gather on each shard's chunk), M3 ``replicate_rows``
             (against the per-block ``copy_`` loop it replaced),
             ``hop_merge``, and the whole hop against ``go_hop``, the
             BFS level stage (``mesh_level``: one launch over the
             card's replicas, one reached bitmap and int8 depth matrix)
             against
             ``mesh_level_ref`` and the single-card ``bfs_level``,
             ``ell_go_sharded`` at 1-4 steps against its plain version
             and ``ell_go``, ``ell_bfs_sharded`` at 1-4 steps and UPTO
             5 (shortest and all) against ``ell_bfs`` (its bound counts
             one depth matrix a card group, the per-shard design's
             beside as ``old_bound_ms``), ``ell_absorb_sharded`` (one
             ``mesh_absorb`` a card group: two kernels in one C call
             by capture) on one card and over two pretended cards, the
             update set walked whole and to the plan's real rows, and
             M2 ``shard_absorb`` (its one-member call) on the absorb
             plans (gathered shards equal to ``ell_absorb``'s tables,
             inputs unchanged),
             ``sharded_go`` and ``or_into`` against the ``go`` program,
             its hop ``edge_scan_hop`` (the scan over a shard's slice)
             against its plain version,
             all exactly, and ``mesh.psum_or`` (receive slabs, one ``or_many`` a
             shard) at 2^19 bytes and 8 against the pairwise
             composition of ``or_into`` calls it replaced and the same
             pairs combined by ``torch.bitwise_or`` (equal outputs,
             event times, OR launches: k against k(k - 1));
             last the frontier-sharded mesh (``mesh_sparse_kernel_phase``)
             on the serve tables cut into k = 2 and 4 chunks on this
             card: ``mesh_sparse_go`` at c0 256 (128 queries, also
             against ``ell_go_sharded`` on the same starts) and 2048,
             3 and 4 steps, and four tight-cap batches (cap_x, the dedup
             cap, the hub budget, cap_e), ``mesh_sparse_bfs`` shortest
             and all at B = 128 and 1024 (against its plain version and
             ``ell_bfs``), every call of the card stages (X1
             ``mesh_route_card``, X2 + K5 ``mesh_dedup``,
             ``mesh_agree``, K6 ``mesh_emit``, X3
             ``mesh_bfs_stamp_card``, each one launch a kernel over
             every shard, X3's init two) held to its plain version on
             copies of its operands, X1 also timed call by call in the
             BFS; per-shard outputs equal when no overflow, the flags
             always, for the probed run and for one call of each public
             wrapper; then (``mesh_stage_check``) the stages and all four
             programs again on hub-free tables at k = 2 and 4 and on the
             serve tables at k = 4, at caps they keep and at a tight one,
             on one card and with the shards split over two pretended
             cards, and (``mesh_list_check``) X1 and X3 on every shape of
             list they take (a start list read whole, a list read to
             the count K5 left: 0, the live count, c, past c, X3's pads
             inside it; short and long; hub keys received; blocks past
             their cap), and (``emit_count_check``) K6's emit, which
             reads only the count K5 left, at count 0, 1, c / 3, c and
             past c as ``mesh_emit``, ``pair_reduce``'s emit and
             ``sparse_go``'s plain result, each list also with its tail
             overwritten (the same output), ``mesh_emit`` timed at each
             count.  A program's ``ms`` is its device time, its calls
             queued behind a spin kernel (the BFS replayed with the
             level flags the probed run read, so the host never waits
             on the card), its event time beside as ``event_ms``, and
             the four mesh programs' and the card stages'
             ``launches_a_call`` (CUDA kernels, memsets and memcpys: a
             call captured into a CUDA graph, a BFS's replay with its
             host reads added; three calls traced under
             ``torch.profiler`` beside, none showing more) and
             ``c_calls_a_call`` (checked C calls), each stage held to
             its 1, 2 or 3 launches in one C call (``stage_launches``),
             and X2 + K5 split by kernel in the trace (``dedup_split``)
4. serve     a seeded power-law graph (default 2^19 vertices, 2^22
             edges, stored in both directions, with seeded columns:
             edge ``w`` int, ``score`` double, ``kind`` string, tag
             ``person(age)`` on 15/16 of the vertices) served by
             ``TorchQueryRuntime`` in continuous mode: R GO requests
             from T threads, 64 checked exactly against a numpy oracle;
             each extract's (word, sel) pairs recorded on the host, then
             the extract timed on the commonest pattern and on the one
             touching the most 16-byte units
5. windowed  the same R requests with ``go_dispatch_mode=windowed``,
             ``tpu_sparse_go=false`` and ``tpu_adaptive_single=false``
             (the dense ``ell_go`` route), 64 checked against the oracle
6. sparse    R requests of the same kinds (another seed) windowed with
             every other flag at its default (the sparse route, its
             split and its dense rerun on overflow); a quarter of the
             plain exact-depth ones end in ``| LIMIT 10``; 64 checked
             against the oracle (LIMIT: min(10, total) rows, each one
             of the full answer's)
7. adaptive  256 single-start plain GO requests, one after another from
             one thread, windowed with ``tpu_sparse_go=false`` (the
             adaptive route), a sixteenth of them from a hub so that
             the dense arm runs (the program picks its arm on the card:
             the requests that run a dense hop are predicted from the
             oracle); 64 checked against the oracle
8. fused     F ``GO 1-3 STEPS FROM v OVER e WHERE P YIELD e._dst, e.w``
             requests from FT threads on the fused route (``$$.person.age``
             also yielded behind the predicate that reads it), P from
             a family of 8 (int, float and string compares, && and ||,
             % 7, $$ and $^ tag props, a vid compare, a guarded /), a
             quarter DISTINCT, three quarters in pushed mode; 64
             checked against a numpy oracle written without the port's
             compiler
9. path      P ``FIND SHORTEST PATH ... UPTO 5 STEPS`` requests (1 src,
             1 dst each) from PT threads, 64 checked against a numpy
             BFS and path enumeration, then a checked sample of ``FIND
             ALL PATH ... UPTO 3 STEPS``
10. write    a space in the port's own store (default 2^17 vertices,
             2^19 edges of ``e(w int)`` written in both directions
             through the processors, tag ``person(age)`` on 15/16 of
             the vertices, 8 parts), folded by the per-row
             ``build_mirror``; then for WS seconds 2 writers (the
             reference soak's mix: in-place updates of a live edge's
             ``w``, round-robin inserts of new ranks, FIFO deletes,
             every 16th write a vertex ``person.age``), each edge
             write checked for read-your-writes by a fused GO from
             both ends and a continuous ``GO 1 TO 2 STEPS`` from its
             src, and WRITE_READERS readers (GO 1-3 STEPS, a quarter
             COUNT(*), an eighth a fused ``WHERE e.w > k``, a
             sixteenth FIND SHORTEST PATH); no rebuild and no delta
             overflow in the window, absorbs > 0, the continuous
             stream re-anchored; 64 queries against a numpy oracle, then the rebuild
             oracle (a fresh fold gives the same answers and the same
             ELL slots); then three forced windows: a growth claim,
             4097 edge events (a counted overflow and a rebuild) and
             an edge to a new vertex (a rebuild)
11. unpacked ``tpu_packed_frontier=false`` on the serve graph, one
             counted window in three parts: (a) U requests of phase 4's
             kinds (another seed, a quarter of the plain exact-depth
             ones ``| LIMIT 10``) from T threads in the default
             continuous mode, with ``tpu_sparse_cap`` 1024 so that
             batches overflow: no continuous stream may anchor or take a
             rider, the sparse route and its dense rerun on the unpacked
             ``ell_go`` must both answer; (b) the same requests on the
             dense route (``go_dispatch_mode=windowed``,
             ``tpu_sparse_go=false``, ``tpu_adaptive_single=false``:
             UPTO, COUNT(*) counted on the host, LIMIT), then a burst
             of 256 one-shape ``GO 3 STEPS`` from 256 threads whose
             widest batch must pass 128 (the 1024 rung); (c) UP ``FIND
             SHORTEST PATH ... UPTO 5 STEPS`` from PT threads, every
             answer checked, and 8 aimed ``FIND ALL PATH ... UPTO 3
             STEPS``; 64 GO answers of (a) and of (b) checked
12. mesh     ``tpu_mesh_devices=4``, ``tpu_mesh_mode=dense`` on a runtime
             with ``mesh_devices=[cuda:0] * 4``, one counted window:
             (a) MR GO of phase 4's kinds without UPTO (COUNT(*), and
             ``| LIMIT 10`` on a quarter of the plain ones) from T
             threads in the default continuous mode, no stream may
             anchor, 64 checked; (b) MP FIND SHORTEST PATH from PT
             threads and 8 FIND ALL PATH, every answer checked; (c) an
             UPTO GO must decline; (d) a 2^14-vertex
             store-backed space on the same mesh: 64 edge writes, each
             read back by a mesh GO from both ends, absorbed into the
             sharded tables (``ell_absorb_sharded``), which must then
             equal ``shard_ell`` of the new host ELL; no single-card
             hop, count or absorb kernel may run in the window
13. mesh-sparse  ``tpu_mesh_devices=4`` in the default
             ``tpu_mesh_mode=sparse``, 4 shards on this card, one
             counted window: (a) MR GO as in phase 12 (a) from T
             threads, continuous (refused), 64 checked; (b) MP FIND
             SHORTEST PATH ... UPTO 5 STEPS from PT threads and 8 FIND
             ALL PATH, every answer checked; (c) phase 12 (d)'s space
             with 16 writes, each read back by a frontier-sharded GO
             from both ends, the new generation's chunk-sharded view
             equal to ``build_sharded_ell`` of its ELL.
             ``mesh_sparse_go`` and ``mesh_sparse_bfs`` must serve; a
             batch they overflow reruns on the dense mesh (counted); no
             single-card hop, sparse or adaptive kernel may run
14. props    the shapes the dispatcher's host half serves, on the
             serve graph at default flags (continuous), one counted
             window of PR requests from 16 threads, a quarter each: (a)
             ``GO UPTO 2-3 STEPS ... WHERE P YIELD e._dst, e.w`` (P
             from phase 8's family in its modes, a quarter DISTINCT) on
             the continuous stream, which must take every one; (b)
             phase 8's ``GO 1-3 STEPS ... WHERE P`` under
             ``tpu_filter_mode=host``, windowed; (c) ``GO 1-3 STEPS ...
             YIELD e._src, e._dst, e._rank, e.w, e.score, e.kind`` (an
             eighth ``YIELD DISTINCT e.kind``); (d) ``GO 2-3 STEPS ...
             YIELD e._src, e._dst``, half ``| LIMIT 10``, half ``|
             YIELD COUNT(*)``; 64 answers of each held to a numpy
             int64 / float64 oracle; then (e) a second space of the
             same edges, each of type e or f by a seeded coin: 128 ``GO
             2 STEPS ... OVER e, f YIELD e._dst, e._type`` and 64
             REVERSELY, every answer checked.  No request may decline
             or fail, nothing may fuse, the window must launch the
             continuous session's kernels and the sparse program's,
             and (e), counted apart, the continuous session's
15. a JSON line ``{"kernels": [...]}`` with each kernel's numbers
16. the last line ``{"ok": true, "device": {...}}``

Every mesh number is k shards on ONE card: the exchange between shards
is a copy on that card, and a link between separate cards is not
measured.  Every launch count is zeroed just before each of phases 4-14
drives the port and read just after it; every kernel of a phase's path
must have been launched there.  The script imports nothing of the JAX package.
It needs one CUDA card and refuses to run (non-zero exit, no result)
without one.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import threading
import time

import numpy as np

from nebula_tpu_torch.tools.cardtime import (SPIN_CYCLES, cuda_ms,
                                           kernel_ms, launches_a_call,
                                           queued_ms, queued_times)

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
REPLACES = {
    "go_hop": "nebula_tpu/tpu/ell.py:665",
    "lane_join": "nebula_tpu/tpu/ell.py:691",
    "lane_extract": "nebula_tpu/tpu/ell.py:726",
    "lane_clear": "nebula_tpu/tpu/ell.py:713",
    "frontier_upload": "nebula_tpu/tpu/runtime.py:3251",
    "ell_go": "nebula_tpu/tpu/ell.py:572",
    "go_count": "nebula_tpu/tpu/ell.py:572",
    "bfs_level": "nebula_tpu/tpu/ell.py:1080",
    "bfs_depth_i8": "nebula_tpu/tpu/ell.py:1121",
    "sparse_expand": "nebula_tpu/tpu/ell.py:1315",
    "pair_compact": "nebula_tpu/tpu/ell.py:1346",
    "pair_reduce": "nebula_tpu/tpu/ell.py:1386",
    "sparse_go": "nebula_tpu/tpu/ell.py:1222",
    "sparse_go_count": "nebula_tpu/tpu/ell.py:1222",
    "sparse_go_limit": "nebula_tpu/tpu/ell.py:1222",
    "adaptive_switch": "nebula_tpu/tpu/ell.py:1593",
    "bitmap_lanes": "nebula_tpu/tpu/ell.py:1582",
    "adaptive_go": "nebula_tpu/tpu/ell.py:1493",
    "edge_seed": "nebula_tpu/tpu/kernels.py:256",
    "edge_hop": "nebula_tpu/tpu/kernels.py:264",
    "edge_final": "nebula_tpu/tpu/kernels.py:264",
    "edge_final_where": "nebula_tpu/tpu/kernels.py:296",
    "expr_filter": "nebula_tpu/tpu/expr_compile.py:468",
    "edge_bfs_level": "nebula_tpu/tpu/kernels.py:315",
    "go": "nebula_tpu/tpu/kernels.py:284",
    "go_filtered": "nebula_tpu/tpu/kernels.py:296",
    "bfs": "nebula_tpu/tpu/kernels.py:315",
    "ell_absorb": "nebula_tpu/tpu/ell.py:1011",
    "frontier_upload_i8": "nebula_tpu/tpu/runtime.py:3228",
    "go_hop_i8": "nebula_tpu/tpu/ell.py:1140",
    "pack_rows": "nebula_tpu/tpu/ell.py:439",
    "bfs_level_i8": "nebula_tpu/tpu/ell.py:1616",
    "ell_go_i8": "nebula_tpu/tpu/ell.py:1140",
    "ell_bfs_i8": "nebula_tpu/tpu/ell.py:1616",
    "shard_hop": "nebula_tpu/tpu/ell.py:1740",
    "hop_merge": "nebula_tpu/tpu/ell.py:1792",
    "replicate_rows": "nebula_tpu/tpu/ell.py:1789",
    "shard_absorb": "nebula_tpu/tpu/ell.py:1036",
    "or_into": "nebula_tpu/tpu/kernels.py:384",
    "ell_go_sharded": "nebula_tpu/tpu/ell.py:1712",
    "ell_bfs_sharded": "nebula_tpu/tpu/ell.py:1799",
    "ell_absorb_sharded": "nebula_tpu/tpu/ell.py:1036",
    "sharded_go": "nebula_tpu/tpu/kernels.py:364",
    "edge_scan_hop": "nebula_tpu/tpu/kernels.py:380",
    "mesh_route": "nebula_tpu/tpu/ell.py:1970",
    "mesh_mark": "nebula_tpu/tpu/ell.py:2019",
    "mesh_bfs_stamp": "nebula_tpu/tpu/ell.py:2279",
    "mesh_sparse_go": "nebula_tpu/tpu/ell.py:2052",
    "mesh_sparse_bfs": "nebula_tpu/tpu/ell.py:2179",
    "mesh_hop": "nebula_tpu/tpu/ell.py:1740",
    "mesh_dedup": "nebula_tpu/tpu/ell.py:2019",
    "mesh_agree": "nebula_tpu/tpu/ell.py:2148",
    "mesh_emit": "nebula_tpu/tpu/ell.py:2162",
    "mesh_level": "nebula_tpu/tpu/ell.py:1799",
}
INT8_KERNELS = ("frontier_upload_i8", "go_hop_i8", "pack_rows",
                "bfs_level_i8", "ell_go_i8", "ell_bfs_i8")
SOURCES = {k: "nebula_tpu_torch/tpu/csrc/ell_lanes.cu"
           for k in list(REPLACES)[:9]}
SOURCES.update({k: "nebula_tpu_torch/tpu/csrc/sparse_go.cu"
                for k in list(REPLACES)[9:18]})
SOURCES.update({k: "nebula_tpu_torch/tpu/csrc/edge_go.cu"
                for k in ("edge_seed", "edge_hop", "edge_final",
                          "edge_bfs_level", "go", "bfs")})
SOURCES.update({"expr_filter": "nebula_tpu_torch/tpu/csrc/expr_filter.cu "
                               "+ expr_core.cuh",
                "edge_final_where": "nebula_tpu_torch/tpu/csrc/edge_go.cu "
                                    "+ expr_core.cuh",
                "go_filtered": "nebula_tpu_torch/tpu/csrc/edge_go.cu "
                               "+ expr_core.cuh"})
SOURCES["adaptive_go"] += " + ell_lanes.cu"
SOURCES["ell_absorb"] = "nebula_tpu_torch/tpu/csrc/ell_absorb.cu"
SOURCES.update({k: "nebula_tpu_torch/tpu/csrc/ell_int8.cu"
                for k in INT8_KERNELS})
SOURCES["ell_bfs_i8"] += " + ell_lanes.cu"
SOURCES["go_hop_i8"] += " + hop_plan.cuh"
MESH_KERNELS = ("shard_hop", "hop_merge", "replicate_rows", "shard_absorb",
                "or_into", "ell_go_sharded", "ell_bfs_sharded",
                "ell_absorb_sharded", "sharded_go", "mesh_hop", "mesh_level",
                "edge_scan_hop")
SOURCES.update({
    "shard_hop": "nebula_tpu_torch/tpu/csrc/ell_lanes.cu + hop_plan.cuh",
    "replicate_rows": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu",
    "hop_merge": "nebula_tpu_torch/tpu/csrc/ell_lanes.cu",
    "mesh_hop": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu + ell_lanes.cu + "
                "hop_plan.cuh",
    "mesh_level": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu + ell_lanes.cu",
    "shard_absorb": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu + "
                    "ell_absorb.cu",
    "or_into": "nebula_tpu_torch/tpu/csrc/ell_lanes.cu",
    "ell_go_sharded": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu + "
                      "ell_lanes.cu",
    "ell_bfs_sharded": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu + "
                       "ell_lanes.cu",
    "ell_absorb_sharded": "nebula_tpu_torch/tpu/csrc/ell_mesh.cu + "
                          "ell_absorb.cu",
    "sharded_go": "nebula_tpu_torch/tpu/csrc/edge_go.cu + ell_lanes.cu",
    "edge_scan_hop": "nebula_tpu_torch/tpu/csrc/edge_go.cu"})
MESH_SPARSE_KERNELS = ("mesh_route", "mesh_mark", "mesh_bfs_stamp",
                       "mesh_sparse_go", "mesh_sparse_bfs", "mesh_dedup",
                       "mesh_agree", "mesh_emit")
SOURCES.update({k: "nebula_tpu_torch/tpu/csrc/mesh_sparse.cu"
                for k in MESH_SPARSE_KERNELS[:3] + ("mesh_agree",)})
SOURCES.update({
    "mesh_dedup": "nebula_tpu_torch/tpu/csrc/mesh_sparse.cu + sparse_go.cu",
    "mesh_emit": "nebula_tpu_torch/tpu/csrc/sparse_go.cu"})
SOURCES.update({
    "mesh_sparse_go": "nebula_tpu_torch/tpu/csrc/mesh_sparse.cu + "
                      "sparse_go.cu + ell_lanes.cu",
    "mesh_sparse_bfs": "nebula_tpu_torch/tpu/csrc/mesh_sparse.cu + "
                       "sparse_go.cu"})
# the edge-list programs no runtime path calls (the reference's only
# caller of go is _run_go_kernel's no-filter branch, which
# _execute_fused never takes; bfs has only its registry entry; the
# reference runtime never calls make_sharded_go_kernel), K9 without the
# WHERE (only go and sharded_go run it), expr_filter (registry and
# smoke only: go_filtered evaluates the WHERE in its final pass),
# or_into, which only sharded_go and shards on separate cards (psum_or)
# run, and edge_scan_hop, sharded_go's hop
NO_RUNTIME_PATH = ("go", "bfs", "edge_bfs_level", "sharded_go", "or_into",
                   "expr_filter", "edge_final", "edge_scan_hop")
EDGE_KERNELS = ("edge_seed", "edge_hop", "edge_final", "edge_final_where",
                "expr_filter", "edge_bfs_level", "go", "go_filtered", "bfs")
# kernels kept ported that no runtime path launches any more: K14 runs
# only for a row-packed GO with no advance (steps <= 1, which the
# runtime answers on the host), and no BFS converts an int16 d since
# every level pass keeps d in the result's form
OFF_PATH = ("pack_rows", "bfs_depth_i8")
# which counted phase runs each kernel on its main path
PATH_KERNELS = {
    "serve": ("go_hop", "lane_join", "lane_extract", "lane_clear"),
    "windowed": ("frontier_upload", "go_hop", "ell_go", "go_count"),
    "sparse": ("sparse_expand", "pair_compact", "pair_reduce",
               "sparse_go", "sparse_go_count", "sparse_go_limit"),
    "adaptive": ("sparse_expand", "pair_compact", "adaptive_switch",
                 "bitmap_lanes", "go_hop", "adaptive_go"),
    "fused": ("edge_seed", "edge_hop", "edge_final_where", "go_filtered"),
    "path": ("frontier_upload", "go_hop", "bfs_level"),
    "write": ("ell_absorb", "go_hop", "lane_join", "lane_extract",
              "lane_clear"),
    "unpacked": ("frontier_upload_i8", "frontier_upload", "go_hop_i8",
                 "bfs_level_i8", "ell_go_i8", "ell_bfs_i8"),
    "mesh": ("frontier_upload", "shard_hop", "hop_merge", "replicate_rows",
             "ell_go_sharded", "mesh_level", "ell_bfs_sharded",
             "shard_absorb", "ell_absorb_sharded",
             "mesh_hop"),
    "mesh_sparse": ("mesh_route", "mesh_mark", "pair_compact",
                    "pair_reduce", "mesh_sparse_go", "mesh_bfs_stamp",
                    "mesh_sparse_bfs", "mesh_dedup", "mesh_agree",
                    "mesh_emit"),
}
LIMIT_N = 10                   # the sparse phase's | LIMIT n
MAX_PATHS = 1000               # the port's FIND PATH result cap
PATH_PHASE_S = 120.0           # the path phase stops issuing past this


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

    def out_edges(self, f: np.ndarray) -> np.ndarray:
        """Indices of every out-edge of the vids ``f`` (sorted, unique):
        the keys are sorted by src, so each vid's edges are one range."""
        lo = np.searchsorted(self.src, f, "left")
        cnt = np.searchsorted(self.src, f, "right") - lo
        first = np.cumsum(cnt) - cnt
        return np.repeat(lo - first, cnt) + np.arange(int(cnt.sum()))

    def frontier_sizes(self, starts, steps: int):
        """The frontier's vids at depths 0..steps-1 (what the adaptive
        route's switch reads)."""
        f = np.unique(np.asarray(starts, np.int64))
        out = [f]
        for _ in range(steps - 1):
            f = np.unique(self.dst[self.out_edges(f)])
            out.append(f)
        return out

    def go(self, starts, steps: int, upto: bool):
        """(sorted final-hop dst vids, edges traversed)."""
        f = np.unique(np.asarray(starts, np.int64))
        acc = f
        traversed = 0
        for _ in range(steps - 1):
            idx = self.out_edges(f)
            traversed += len(idx)
            f = np.unique(self.dst[idx])
            acc = np.union1d(acc, f)
        idx = self.out_edges(acc if upto else f)
        traversed += len(idx)
        return np.sort(self.dst[idx]), traversed


class PathOracle:
    """Plain numpy/Python semantics of ``FIND SHORTEST|ALL PATH FROM s
    TO t OVER e UPTO k STEPS`` on a forward edge list, independent of
    the port: level-synchronous BFS depths from the sources (a level
    runs while the frontier is nonempty, fewer than k levels ran and,
    for SHORTEST, a target is still unreached), then the paths walked
    back from the target over the in-edges.  Paths print as
    ``v0 <e,0> v1 <e,0> v2 ...`` (one edge type, rank 0)."""

    INF = np.iinfo(np.int32).max

    def __init__(self, go: GoOracle):
        self.go = go
        self.src, self.dst = go.src, go.dst
        self.size = go.vmax + 1
        self.key = (self.src << 32) | self.dst     # sorted, unique
        order = np.argsort(self.dst, kind="stable")
        self.in_src = self.src[order]
        self.in_ptr = np.searchsorted(self.dst[order],
                                      np.arange(self.size + 1))

    def preds(self, v: int) -> np.ndarray:
        return self.in_src[self.in_ptr[v]:self.in_ptr[v + 1]]

    def depths(self, srcs, dsts, max_steps: int, shortest: bool):
        """int32 [vmax + 1] depths (INF = unreached) and levels run."""
        depth = np.full(self.size, self.INF, np.int32)
        f = np.unique(np.asarray(srcs, np.int64))
        depth[f] = 0
        tgt = np.unique(np.asarray(dsts, np.int64))
        step = 0
        while step < max_steps and len(f) and not (
                shortest and not (depth[tgt] == self.INF).any()):
            nxt = np.unique(self.dst[self.go.out_edges(f)])
            f = nxt[depth[nxt] == self.INF]
            depth[f] = step + 1
            step += 1
        return depth, step

    def shortest_paths(self, srcs, dst: int, depth) -> list:
        """Every shortest path from the sources to ``dst`` (at most
        MAX_PATHS + 1 of them)."""
        out: list = []
        src_set = set(int(s) for s in srcs)

        def walk(v, tail):
            if len(out) > MAX_PATHS:
                return
            if depth[v] == 0:
                if v in src_set:
                    out.append([v] + tail)
                return
            for u in self.preds(v).tolist():
                if depth[u] == depth[v] - 1:
                    walk(u, [v] + tail)

        if 0 < depth[dst] < self.INF:
            walk(dst, [])
        return out

    def all_paths(self, srcs, dst: int, max_steps: int) -> list:
        """Every simple path of 1..max_steps edges from a source to
        ``dst`` (at most MAX_PATHS + 1 of them)."""
        out: list = []
        src_set = set(int(s) for s in srcs)

        def walk(v, tail, seen):
            if len(out) > MAX_PATHS:
                return
            if v in src_set and tail:
                out.append([v] + tail)
            if len(tail) == max_steps:
                return
            for u in self.preds(v).tolist():
                if u not in seen:
                    walk(u, [v] + tail, seen | {u})

        walk(dst, [], {dst})
        return out

    def check(self, rows, want_paths, srcs, dst: int, length=None) -> None:
        """Each row is a chain of existing edges from a source to
        ``dst`` (of ``length`` edges when given); where the oracle found
        fewer than MAX_PATHS paths, the sets are equal."""
        got = []
        for (p,) in rows:
            tok = p.split(" ")
            vs = [int(t) for t in tok[0::2]]
            if any(t != "<e,0>" for t in tok[1::2]):
                raise AssertionError(f"path {p!r}: unexpected edge label")
            if vs[0] not in srcs or vs[-1] != dst:
                raise AssertionError(f"path {p!r} does not join "
                                     f"{srcs} to {dst}")
            if length is not None and len(vs) - 1 != length:
                raise AssertionError(f"path {p!r} is not {length} long")
            hop = (np.asarray(vs[:-1], np.int64) << 32) \
                | np.asarray(vs[1:], np.int64)
            pos = np.minimum(np.searchsorted(self.key, hop),
                             len(self.key) - 1)
            if not (self.key[pos] == hop).all():
                raise AssertionError(f"path {p!r} uses a missing edge")
            got.append(tuple(vs))
        if len(got) != len(set(got)):
            raise AssertionError("a path is repeated")
        if len(want_paths) < MAX_PATHS and \
                set(got) != {tuple(p) for p in want_paths}:
            raise AssertionError(f"{len(got)} paths, the oracle has "
                                 f"{len(want_paths)}")


# ============================================================= helpers
def log(msg: str) -> None:
    print(msg, flush=True)


def timed(torch, fn):
    """(``fn()``, its milliseconds on the card by CUDA events): one
    call, for the plain versions that are slow at full size."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def max_abs_err(torch, a, b) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def bytes_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def restored_ms(torch, run, restore, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``run()`` on a state ``restore()`` rebuilds before each
    call (the kernel rewrites its input), less the restore's own time."""
    def both():
        restore()
        run()
    return max(0.0, cuda_ms(torch, both, iters, warmup)
               - cuda_ms(torch, restore, iters, warmup))


def require_equal(torch, name: str, B: int, *pairs) -> int:
    """Raise unless every (kernel, plain) pair is equal; max_abs_err."""
    torch.cuda.synchronize()
    for a, b in pairs:
        if not torch.equal(a, b):
            raise AssertionError(f"{name} != its plain version at B={B}")
    return max(max_abs_err(torch, a, b) for a, b in pairs)


def popcount(torch, ell_ops, fp) -> int:
    return int(ell_ops._unpack_ref(fp).sum(dtype=torch.int64).item())


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

    def hop():
        ell_ops.go_hop(fp0, a1, out, tables, eslot, hrows, over)
    hops = ell_ops.LAUNCHES["go_hop"]
    ors = ell_ops.LAUNCHES["or_into"]
    ms = queued_ms(torch, hop, PROBE_REPS)      # device time
    event_ms = cuda_ms(torch, hop, 50)
    if ell_ops.LAUNCHES["go_hop"] == hops or \
            ell_ops.LAUNCHES["or_into"] != ors:
        raise AssertionError("the timed hops did not launch ell_go_hop "
                             "alone")
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
                         library_ms=None, event_ms=event_ms,
                         bytes=hop_bytes,
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

    def clear():
        ell_ops.lane_clear(fk, ak, keep)
    ms = queued_ms(torch, clear, PROBE_REPS)       # device time
    event_ms = cuda_ms(torch, clear, 50)
    plain = cuda_ms(torch, lambda: ell_ops.lane_clear_ref(fr, ar, keep), 50)

    def lib_clear():
        torch.bitwise_and(fr, keep, out=fr)
        torch.bitwise_and(ar, keep, out=ar)
    lib = cuda_ms(torch, lib_clear, 50)
    res["lane_clear"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bytes_ms(4 * R1 * W + W),
                             bound_by="bytes", library_ms=lib,
                             event_ms=event_ms)

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

    def join():
        ell_ops.lane_join(fk, ak, rows_t, words_t, vals_t)
    ms = queued_ms(torch, join, PROBE_REPS)        # device time
    event_ms = cuda_ms(torch, join, 50)
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
                            library_ms=lib, event_ms=event_ms)

    # ---- extract: 8 word columns, mixed exact-depth / UPTO, and the
    # row patterns; held at the odd shapes untimed
    res["lane_extract"] = extract_rows(torch, ell_ops, fp0, acc0, rng)
    res["lane_extract"]["odd_shapes"] = extract_odd_check(
        torch, ell_ops, fp0, acc0, rng)
    return res


def extract_cases(W: int, rng) -> dict:
    """The extract's (words, sel) cases at W bytes a row, P = 8 (the
    same as ``tools/hop_bench.py``'s; this script keeps its own copy, as
    ``tools/phase_bench.py`` runs its phases on another checkout's
    port): random distinct words, random sel; the smallest leave cohort
    (one word, exact and UPTO, then the pads at word 0); at W >= 64 the
    words within two 16-byte units of fp, and one word in each of 8
    units with random sel (every 32-byte sector of a 128-byte row)."""
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


def extract_units(words, sel) -> dict:
    """The 16-byte units and 32-byte sectors of a row that the chosen
    words touch, in fp and accp together."""
    return dict(units16=len({(int(s), int(w) // 16)
                             for w, s in zip(words, sel)}),
                sectors32=len({(int(s), int(w) // 32)
                               for w, s in zip(words, sel)}))


def extract_time(torch, ell_ops, fp0, acc0, words_h, sel_h, what: str,
                 plain: bool = False) -> dict:
    """One extract held to its plain version, then its device time
    (PROBE_REPS calls queued behind a spin) and event time (50 back to
    back), the bytes bound (each output byte's source byte read, the
    output written, the pairs read) and the units its words touch."""
    dev = fp0.device
    R1 = fp0.shape[0]
    P = len(words_h)
    words = torch.from_numpy(np.asarray(words_h, np.int32)).to(dev)
    sel = torch.from_numpy(np.asarray(sel_h, np.uint8)).to(dev)
    out = torch.empty((R1, P), dtype=torch.uint8, device=dev)
    want = torch.empty_like(out)
    ell_ops.lane_extract(fp0, acc0, words, sel, out)
    ell_ops.lane_extract_ref(fp0, acc0, words, sel, want)
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"lane_extract != lane_extract_ref ({what})")

    def extract():
        ell_ops.lane_extract(fp0, acc0, words, sel, out)
    row = dict(ms=queued_ms(torch, extract, PROBE_REPS),
               event_ms=cuda_ms(torch, extract, 50), P=P,
               bound_ms=bytes_ms(2 * R1 * P + 5 * P),
               **extract_units(words_h, sel_h))
    if plain:
        row["plain_ms"] = cuda_ms(torch, lambda: ell_ops.lane_extract_ref(
            fp0, acc0, words, sel, want), 50)
    return row


def extract_rows(torch, ell_ops, fp0, acc0, rng) -> dict:
    """The extract on ``extract_cases`` at the carriers' width: the row's
    numbers from the random case (device time; events beside), every
    case's under ``cases``."""
    cases = {k: extract_time(torch, ell_ops, fp0, acc0, w, s,
                             f"{k} W={fp0.shape[1]}", plain=k == "random")
             for k, (w, s) in extract_cases(fp0.shape[1], rng).items()}
    head = cases["random"]
    return dict(max_abs_err=0, ms=head["ms"], plain_ms=head["plain_ms"],
                bound_ms=head["bound_ms"], bound_by="bytes",
                library_ms=None, event_ms=head["event_ms"],
                units16=head["units16"], sectors32=head["sectors32"],
                cases={k: v for k, v in cases.items() if k != "random"})


def extract_odd_check(torch, ell_ops, fp0, acc0, rng) -> dict:
    """The extract held to its plain version (untimed) at P = 8, 16 and
    2W with distinct, repeated and cohort words and mixed sel, at the
    carriers' width and at W = 4 (their first 4 bytes a row); then P = 6
    and 12 (byte and word stores), an output one byte off alignment, and
    carriers 4 bytes off a 16-byte boundary (the 4-byte unit path)."""
    dev = fp0.device
    R1 = fp0.shape[0]
    n = 0

    def hold(fp, acc, w, s, what, off=0):
        nonlocal n
        P = len(w)
        words = torch.from_numpy(np.asarray(w, np.int32)).to(dev)
        sel = torch.from_numpy(np.asarray(s, np.uint8)).to(dev)
        buf = torch.empty(R1 * P + 16, dtype=torch.uint8, device=dev)
        out = buf[off:off + R1 * P].view(R1, P)
        want = torch.empty((R1, P), dtype=torch.uint8, device=dev)
        ell_ops.lane_extract(fp, acc, words, sel, out)
        ell_ops.lane_extract_ref(fp, acc, words, sel, want)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"lane_extract != lane_extract_ref "
                                 f"({what})")
        n += 1

    for fp, acc in ((fp0, acc0), (fp0[:, :4].contiguous(),
                                  acc0[:, :4].contiguous())):
        W = fp.shape[1]
        for P in sorted({8, 16, 2 * W}):
            sel = (rng.random(P) < 0.5).astype(np.uint8)
            sel[0], sel[1] = 0, 1
            cohort = np.zeros(P, np.int64)
            cohort[:2] = rng.integers(0, W)
            for kind, w in (
                    ("distinct", np.concatenate(
                        [rng.permutation(W)] * (P // W + 1))[:P]),
                    ("repeated", rng.choice(rng.integers(0, W, 3), P)),
                    ("cohort", cohort)):
                hold(fp, acc, w, sel, f"W={W} P={P} {kind}")
        for P, off in ((6, 0), (12, 0), (8, 1)):
            hold(fp, acc, rng.integers(0, W, P),
                 (rng.random(P) < 0.5).astype(np.uint8),
                 f"W={W} P={P} out +{off}", off)
    W = fp0.shape[1]
    shifted = []
    for t in (fp0, acc0):
        buf = torch.empty(R1 * W + 16, dtype=torch.uint8, device=dev)
        v = buf[4:4 + R1 * W].view(R1, W)
        v.copy_(t)
        shifted.append(v)
    hold(*shifted, rng.integers(0, W, 8), (rng.random(8) < 0.5).astype(
        np.uint8), f"W={W} carriers 4 bytes off 16")
    return dict(cases=n, widths=[W, 4], equal=True)


def enqueue_check(torch, what: str, fn) -> dict:
    """``fn`` queued behind a spin kernel, 8 calls: its device time and
    its host enqueue time, which must stay below the spin's (a call that
    waits on the card would wait out the spin).  First behind a spin 16
    times as long, where the 8 calls may take new pinned blocks (the
    caching host allocator's blocks of calls still in flight are not
    free yet), then again behind the usual spin."""
    cold_spin = cuda_ms(torch, lambda: torch.cuda._sleep(16 * SPIN_CYCLES),
                        2, 1)
    spin_ms = cuda_ms(torch, lambda: torch.cuda._sleep(SPIN_CYCLES), 3, 1)
    row = {}
    for label, spin, ms in (("cold_", 16 * SPIN_CYCLES, cold_spin),
                            ("", SPIN_CYCLES, spin_ms)):
        dev_ms, enqueue_ms = queued_times(torch, fn, PROBE_REPS, spin)
        if enqueue_ms >= ms:
            raise AssertionError(f"{what}: {PROBE_REPS} calls took "
                                 f"{enqueue_ms} ms to enqueue behind a {ms}"
                                 f" ms spin: the call waits on the card")
        row.update({f"{label}call_ms": dev_ms,
                    f"{label}enqueue_ms": enqueue_ms / PROBE_REPS,
                    f"{label}spin_ms": ms})
    return dict(row, enqueue_calls=PROBE_REPS)


def counted(torch, ell_ops, fn, want: dict, what: str) -> dict:
    """``launches_a_call`` of ``fn``, held to ``want`` (launch kinds)."""
    n = launches_a_call(torch, ell_ops, fn)
    if n["launch_kinds"] != want or n["c_calls_a_call"] != 1:
        raise AssertionError(f"{what}: {n['launch_kinds']} in "
                             f"{n['c_calls_a_call']} C calls a call, "
                             f"expected {want} in 1")
    return {a: n[a] for a in ("launches_a_call", "c_calls_a_call",
                              "launch_kinds", "launches_traced")}


def upload_rows(torch, ell_ops, rt, ix, B: int, new_ids, qcols):
    """K1 on the start list (new-id rows, query lanes): the runtime's
    call (dedup, one pinned copy, one launch) and the kernel alone on
    the list it sends, held to the plain version; (numbers, frontier).
    ``ms`` is the kernel's device time (calls queued behind a spin),
    ``event_ms`` its back-to-back event time, ``call_*`` the runtime's
    whole call; launches and copies a call by capture."""
    dev = rt.device
    R1, W = ix.n_rows + 1, B // 8
    fk = rt._upload_frontier_packed(ix, new_ids, qcols, B)
    coords = torch.from_numpy(rt._packed_coords(new_ids, qcols, B)).to(dev)
    S = int(coords.shape[1])
    fa = torch.empty_like(fk)
    ell_ops.frontier_upload(fa, coords)
    fr = torch.empty_like(fk)
    ell_ops.frontier_upload_ref(fr, coords)
    err = require_equal(torch, "frontier_upload", B, (fk, fr), (fa, fr))
    f0 = fk.clone()

    def kernel():
        ell_ops.frontier_upload(fa, coords)

    def call():
        rt._upload_frontier_packed(ix, new_ids, qcols, B)
    rows, lanes = coords.long()
    idx = rows * W + (lanes >> 3)
    vals = torch.bitwise_left_shift(torch.ones_like(lanes), lanes & 7).to(
        torch.uint8)

    def lib_upload():
        fr.zero_()
        fr.view(-1).index_put_((idx,), vals, accumulate=True)
    lib_upload()
    require_equal(torch, "frontier_upload's library call", B, (fr, fk))
    return dict(
        max_abs_err=err, ms=queued_ms(torch, kernel, PROBE_REPS),
        event_ms=cuda_ms(torch, kernel, 50),
        plain_ms=cuda_ms(torch, lambda: ell_ops.frontier_upload_ref(
            fr, coords), 20),
        bound_ms=bytes_ms(R1 * W + 8 * S), bound_by="bytes",
        library_ms=cuda_ms(torch, lib_upload, 50),
        library_is="zero_ + index_put_ (accumulate)", entries=S,
        rows_bytes_multiple_of_8192=(R1 * W) % 8192 == 0,
        call_event_ms=cuda_ms(torch, call, 50),
        **enqueue_check(torch, f"_upload_frontier_packed B={B}", call),
        **counted(torch, ell_ops, call, {"kernel": 1, "memcpy": 1},
                  f"_upload_frontier_packed B={B}")), f0


def count_bytes(torch, out, B: int) -> int:
    """K2's bytes on this frontier: every frontier byte, the 32-byte deg
    sectors that hold a row with a nonzero word, counts written."""
    R1, W = out.shape
    live = out.view(torch.int32).ne(0).any(dim=1)
    pad = (-R1) % 8
    sectors = int(torch.nn.functional.pad(live, (0, pad)).view(-1, 8)
                  .any(dim=1).sum().item())
    return R1 * W + 32 * sectors + 4 * B


def count_rows(torch, ell_ops, out, deg, B: int, what: str,
               library: bool = True) -> dict:
    """K2 on the frontier ``out`` with ``deg``, held to its plain version
    and to a matrix-vector product (float64, exact below 2^53, compared
    modulo 2^32): device and event times, launches by capture."""
    dev = out.device
    ck = torch.full((B,), 7, dtype=torch.int32, device=dev)
    cr = torch.empty_like(ck)
    ell_ops.go_count(out, deg, ck)
    ell_ops.go_count_ref(out, deg, cr)
    err = require_equal(torch, f"go_count ({what})", B, (ck, cr))
    again = ck.clone()
    ell_ops.go_count(out, deg, again)        # the state came back zero
    require_equal(torch, f"go_count ({what}) twice", B, (again, cr))

    def kernel():
        ell_ops.go_count(out, deg, ck)
    row = dict(max_abs_err=err, ms=queued_ms(torch, kernel, PROBE_REPS),
               event_ms=cuda_ms(torch, kernel, 50),
               plain_ms=cuda_ms(torch, lambda: ell_ops.go_count_ref(
                   out, deg, cr), 3, 1),
               bound_ms=bytes_ms(count_bytes(torch, out, B)),
               bound_by="bytes", library_ms=None,
               live_bits=popcount(torch, ell_ops, out),
               **counted(torch, ell_ops, kernel, {"kernel": 1},
                         f"go_count ({what})"))
    if library:
        def unpack():
            return ell_ops._unpack_ref(out).double()
        row["library_unpack_ms"] = cuda_ms(torch, unpack, 2, 1)
        bits = unpack()
        degd = deg.double()
        row["library_ms"] = cuda_ms(torch, lambda: torch.mv(bits.t(), degd),
                                    5)
        mv = torch.mv(bits.t(), degd).to(torch.int64)
        if not torch.equal(mv.remainder(2**32), ck.to(torch.int64)
                           .remainder(2**32)):
            raise AssertionError(f"torch.mv disagrees with go_count "
                                 f"({what}) at B={B}")
        row["library_is"] = "torch.mv of the unpacked float64 bits"
        del bits
    return row


def odd_rows_check(torch, ell_ops, dev, rng) -> dict:
    """K1 and K2, untimed, on R1 = 100003 rows (R1 * W not a multiple of
    an upload block's 8192 bytes) at B = 32, 128 and 1024: a sorted list
    with repeats and entries at the pad row and beyond; a random frontier
    with a wrapping deg, the same with deg up to 2^17, and the all-ones
    one."""
    R1 = 100003
    held = {}
    for B in (32, 128, 1024):
        W = B // 8
        rows = np.concatenate([rng.integers(0, R1 + 2, 4 * B),
                               [R1 - 2, R1 - 1]])
        lanes = np.concatenate([rng.integers(0, B, 4 * B), [B - 1, 0]])
        key = np.sort(np.concatenate([rows * B + lanes, rows[:B] * B
                                      + lanes[:B]]))
        coords = torch.from_numpy(np.stack(np.divmod(key, B)).astype(
            np.int32)).to(dev)
        fk = torch.empty((R1, W), dtype=torch.uint8, device=dev)
        fr = torch.empty_like(fk)
        ell_ops.frontier_upload(fk, coords)
        ell_ops.frontier_upload_ref(fr, coords)
        require_equal(torch, "frontier_upload, odd rows", B, (fk, fr))
        deg = torch.from_numpy(rng.integers(0, 2**31 - 1, R1).astype(
            np.int32)).to(dev)
        deg[-1] = 0
        rand = torch.from_numpy(rng.integers(0, 256, (R1, W), dtype=np.uint8)
                                ).to(dev)
        deg17 = torch.from_numpy(rng.integers(0, 2**17, R1).astype(
            np.int32)).to(dev)
        deg17[-1] = 0
        for label, out, dg in (("random", rand, deg),
                               ("random, deg up to 2^17", rand, deg17),
                               ("ones", torch.full_like(rand, 255), deg),
                               ("upload", fk, deg)):
            ck = torch.empty(B, dtype=torch.int32, device=dev)
            cr = torch.empty_like(ck)
            ell_ops.go_count(out, dg, ck)
            ell_ops.go_count_ref(out, dg, cr)
            require_equal(torch, f"go_count, odd rows, {label}", B, (ck, cr))
        held[B] = dict(rows=R1, entries=int(coords.shape[1]),
                       blocks_of_8192=(R1 * W) / 8192)
    return held


def batch_kernel_phase(torch, ell_ops, rt, m, ix, tables, eslot, hrows,
                       B: int, over, rng) -> dict:
    """The windowed path's kernels against their plain versions at lane
    width B on the serve tables, on the inputs that path gives them: a
    batch of B queries with one start each.  Returns {name: numbers}."""
    dev = tables.nbr.device
    W = B // 8
    R1 = ix.n_rows + 1
    i32 = torch.int32
    slots = int(tables.nbr.numel())
    hub_bytes = 4 * ((ix.n_rows - ix.n) + int(hrows.numel()))
    res = {}

    def up(a):
        return torch.from_numpy(a).to(dev)

    # ---- K1 frontier upload: query q starts at one random vertex
    res["frontier_upload"], f0 = upload_rows(
        torch, ell_ops, rt, ix, B, ix.perm[rng.integers(0, ix.n, B)],
        np.arange(B, dtype=np.int32))

    # ---- ell_go at 3 steps, exact and UPTO (two hops each)
    work = torch.empty_like(f0)

    def restore():
        work.copy_(f0)
    go_bytes = 8 * slots + 2 * R1 * W + hub_bytes
    go_rows = {}
    outs = {}
    for upto in (False, True):
        gk = ell_ops.ell_go(f0.clone(), tables, eslot, hrows, over, 3, upto)
        gr = ell_ops.ell_go_ref(f0.clone(), tables, eslot, hrows, over, 3,
                                upto)
        err = require_equal(torch, f"ell_go upto={upto}", B, (gk, gr))
        outs[upto] = gk
        ms = restored_ms(torch, lambda: ell_ops.ell_go(
            work, tables, eslot, hrows, over, 3, upto), restore, 20)
        plain = restored_ms(torch, lambda: ell_ops.ell_go_ref(
            work, tables, eslot, hrows, over, 3, upto), restore, 2, 1)
        go_rows[upto] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bytes_ms(go_bytes + (R1 * W if upto
                                                           else 0)),
                             bound_by="bytes", library_ms=None, steps=3,
                             live_bits=popcount(torch, ell_ops, gk))
    res["ell_go"] = dict(go_rows[False], upto=go_rows[True])

    # ---- K2 the COUNT(*) fold of the exact 3-step frontier, of an
    # all-ones frontier, of a random one a quarter dense (mixed words),
    # and of those two with a deg whose sums wrap (the quarter-dense one
    # with deg up to 2^17: register pairs flushed often, and past 0xFFFF
    # the atomic path)
    deg = rt._deg_dev(m, ix, tuple(over))
    ones = torch.full_like(f0, 255)
    ones[-1] = 0
    quarter = torch.from_numpy(
        rng.integers(0, 256, (R1, W), dtype=np.uint8)
        & rng.integers(0, 256, (R1, W), dtype=np.uint8)).to(dev)
    quarter[ix.n:] = 0
    wrap = torch.from_numpy(rng.integers(
        2**30, 2**31 - 1, R1).astype(np.int32)).to(dev)
    wrap[ix.n:] = 0
    wrap17 = torch.from_numpy(rng.integers(0, 2**17, R1).astype(
        np.int32)).to(dev)
    wrap17[ix.n:] = 0
    res["go_count"] = dict(count_rows(torch, ell_ops, outs[False], deg, B,
                                      "3-step"),
                           all_ones=count_rows(torch, ell_ops, ones, deg, B,
                                               "all-ones"),
                           all_ones_wrapping=count_rows(
                               torch, ell_ops, ones, wrap, B,
                               "all-ones, wrapping deg", library=False),
                           quarter=count_rows(torch, ell_ops, quarter, deg,
                                              B, "a quarter dense"),
                           quarter_wrapping=count_rows(
                               torch, ell_ops, quarter, wrap17, B,
                               "a quarter dense, deg up to 2^17",
                               library=False))
    del ones, quarter, wrap, wrap17

    # ---- K3 through whole BFS programs (UPTO 5, stop when found: the
    # int8 form; and max_steps 121: an int16 d), every level held to the
    # plain level on the same state, the program to its plain version
    t0 = rt._upload_frontier_packed(ix, ix.perm[rng.integers(0, ix.n, B)],
                                    np.arange(B, dtype=np.int32), B)
    programs = {}
    # the UPTO 5 program's bytes, kernel by kernel on this run's data: the
    # first pass, and a level's hop (its tables, frontier read, output
    # written, hubs) and K3 level
    prog_bytes = []
    for max_steps in (5, 121):
        held = []

        def level_held(nxt, tp, seen, d, flags, step, first, stop,
                       max_steps=max_steps, held=held):
            if max_steps == 5:
                prog_bytes.append(
                    k3_first_bytes(R1, W, d.element_size())["bytes"]
                    if first else 8 * slots + 2 * R1 * W + hub_bytes
                    + k3_level_bytes(torch, ell_ops, nxt, seen, tp,
                                     d.element_size())["bytes"])
            before = [x.clone() for x in (nxt, seen, d, flags)]
            ell_ops.bfs_level(nxt, tp, seen, d, flags, step, first, stop)
            ell_ops.bfs_level_ref(before[0], tp, *before[1:], step, first,
                                  stop)
            require_equal(torch, f"bfs_level max_steps={max_steps} "
                          f"step={step} first={first}", B,
                          *zip((nxt, seen, d, flags), before))
            held.append(step)
        dk, lk = ell_ops._bfs_loop(f0.clone(), t0, tables, eslot, hrows,
                                   over, max_steps, True, ell_ops.go_hop,
                                   level_held)
        dr, lr = ell_ops.ell_bfs_ref(f0.clone(), t0, tables, eslot, hrows,
                                     over, max_steps)
        d1, l1 = ell_ops.ell_bfs(f0.clone(), t0, tables, eslot, hrows, over,
                                 max_steps)
        err_bfs = require_equal(torch, f"ell_bfs max_steps={max_steps}", B,
                                (dk, dr), (d1, dr))
        if not lk == lr == l1 or dk.dtype != ell_ops.depth_dtype(max_steps):
            raise AssertionError(f"ell_bfs max_steps={max_steps}: {l1} "
                                 f"levels ({lk} held), plain {lr}, "
                                 f"{dk.dtype}")
        programs[max_steps] = (d1, lk, len(held))
        del dk, dr
    bfs_ms = cuda_ms(torch, lambda: ell_ops.ell_bfs(
        f0.clone(), t0, tables, eslot, hrows, over, 5), 5, 1)
    bfs_plain = cuda_ms(torch, lambda: ell_ops.ell_bfs_ref(
        f0.clone(), t0, tables, eslot, hrows, over, 5), 1, 0)
    # its launches: the loop replayed with the level flags a run read
    # (nothing waits on the card, so it captures), plus those reads, less
    # the start's clone the call here adds
    flag_reads = []

    def bfs_loop(read):
        return ell_ops._bfs_loop(f0.clone(), t0, tables, eslot, hrows, over,
                                 5, True, ell_ops.go_hop, ell_ops.bfs_level,
                                 read=read)
    bfs_loop(lambda flag: flag_reads.append(flag.tolist())
             or flag_reads[-1])

    def bfs_replay():
        it = iter(flag_reads)
        return bfs_loop(lambda _flag: next(it))
    bfs_n = launches_a_call(torch, ell_ops, lambda: ell_ops.ell_bfs(
        f0.clone(), t0, tables, eslot, hrows, over, 5), replay=bfs_replay,
        reads=len(flag_reads))
    bfs_n["launches_a_call"] -= 1
    bfs_n["launch_kinds"]["memcpy"] -= 1
    bfs_n["less"] = "the start frontier's clone"

    # ... and alone, in the result's int8 form: its first pass and the
    # level after one hop, on level 1's state (one start a lane, targets
    # one a lane) and on a 2 %-dense frontier (2 % of the real rows
    # random bytes, 2 % of the target bytes random: mesh_level's
    # frontier)
    live_h = np.zeros((R1, W), np.uint8)
    live = rng.random(ix.n) < 0.02
    live_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                       dtype=np.uint8)
    dense0 = up(live_h)
    dense_t = up(np.where(rng.random((R1, W)) < 0.02,
                          rng.integers(0, 256, (R1, W)), 0)
                 .astype(np.uint8))
    flags = torch.zeros((2, 2), dtype=i32, device=dev)
    d0 = torch.empty((R1, B), dtype=torch.int8, device=dev)
    seen0 = torch.empty_like(f0)
    rows = {}
    for label, start, tp in (("level1", f0, t0), ("dense", dense0,
                                                  dense_t)):
        fk, sk, dk0, flk = start.clone(), seen0, d0, flags[0].zero_()
        ell_ops.bfs_level(fk, tp, sk, dk0, flk, 0, first=True)
        fr, sr, dr0, flr = start.clone(), torch.empty_like(sk), \
            torch.empty_like(dk0), torch.zeros_like(flk)
        ell_ops.bfs_level_ref(fr, tp, sr, dr0, flr, 0, True, True)
        require_equal(torch, f"bfs_level first pass {label}", B, (fk, fr),
                      (sk, sr), (dk0, dr0), (flk, flr))
        first_ms = cuda_ms(torch, lambda: ell_ops.bfs_level(
            start, tp, sk, dk0, flk, 0, first=True), 20)
        first_plain = cuda_ms(torch, lambda: ell_ops.bfs_level_ref(
            fr, tp, sr, dr0, flr, 0, True, True), 5)
        fill_ms = cuda_ms(torch, lambda: dr0.fill_(-1), 20)
        nxt0 = torch.empty_like(start)
        ell_ops.go_hop(start, None, nxt0, tables, eslot, hrows, over)
        s_first, d_first = sk.clone(), dk0.clone()
        nk, flk1 = nxt0.clone(), flags[1].zero_()
        ell_ops.bfs_level(nk, tp, sk, dk0, flk1, 0)
        nr, sr, dr1, flr1 = nxt0.clone(), s_first.clone(), d_first.clone(), \
            torch.zeros_like(flk1)
        ell_ops.bfs_level_ref(nr, tp, sr, dr1, flr1, 0, False, True)
        err = require_equal(torch, f"bfs_level {label}", B, (nk, nr),
                            (sk, sr), (dk0, dr1), (flk1, flr1))

        def restore():
            nk.copy_(nxt0)
            sk.copy_(s_first)
            dk0.copy_(d_first)
        ms = restored_ms(torch, lambda: ell_ops.bfs_level(
            nk, tp, sk, dk0, flk1, 0), restore, 20)
        plain = restored_ms(torch, lambda: ell_ops.bfs_level_ref(
            nr, tp, sr, dr1, flr1, 0, False, True),
            lambda: (nr.copy_(nxt0), sr.copy_(s_first),
                     dr1.copy_(d_first)), 5)
        lb = k3_level_bytes(torch, ell_ops, nxt0, s_first, tp, 1)
        fb = k3_first_bytes(R1, W, 1)
        rows[label] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain,
            bound_ms=bytes_ms(min(lb["bytes"], lb["old_bytes"])),
            old_bound_ms=bytes_ms(lb["old_bytes"]),
            seen_bound_ms=bytes_ms(lb["bytes"]),
            live_bits=lb["live_bits"], newly_bits=lb["newly_bits"],
            first_ms=first_ms, first_plain_ms=first_plain,
            first_bound_ms=bytes_ms(min(fb["bytes"], fb["old_bytes"])),
            first_old_bound_ms=bytes_ms(fb["old_bytes"]),
            fill_ms=fill_ms)
        del fr, sr, dr0, nr, dr1, nxt0, s_first, d_first
    one = rows["level1"]
    res["bfs_level"] = dict(
        one, max_abs_err=max(err_bfs, one["max_abs_err"],
                             rows["dense"]["max_abs_err"]),
        bound_by="bytes", library_ms=None,
        library_none="none: a depth update with its loop flags",
        dense=rows["dense"], bfs_ms=bfs_ms, bfs_plain_ms=bfs_plain,
        bfs_bound_ms=bytes_ms(sum(prog_bytes)),
        bfs_levels=programs[5][1], bfs_levels_held=programs[5][2],
        bfs121_levels=programs[121][1], bfs121_levels_held=programs[121][2],
        bfs121_dtype="int16", bfs_dtype="int8",
        bfs_launches={a: bfs_n[a] for a in (
            "launches_a_call", "c_calls_a_call", "launch_kinds", "less",
            "host_reads", "launches_traced")})

    # ---- the int8 form of an int16 result (the max_steps 121 BFS's d)
    d16 = programs[121][0]
    ok8 = torch.empty((R1, B), dtype=torch.int8, device=dev)
    or8 = torch.empty_like(ok8)
    ell_ops.bfs_depth_i8(d16, ok8)
    ell_ops.bfs_depth_i8_ref(d16, or8)
    err = require_equal(torch, "bfs_depth_i8", B, (ok8, or8))
    ms = cuda_ms(torch, lambda: ell_ops.bfs_depth_i8(d16, ok8), 50)
    plain = cuda_ms(torch, lambda: ell_ops.bfs_depth_i8_ref(d16, or8), 20)
    # INT16_INF's low byte is 0xFF, -1 as int8: one narrowing copy is the
    # same function, so it is the library call.
    ol8 = torch.empty_like(ok8)
    ol8.copy_(d16)
    require_equal(torch, "bfs_depth_i8 library copy_", B, (ol8, or8))
    lib = cuda_ms(torch, lambda: ol8.copy_(d16), 50)
    res["bfs_depth_i8"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                               bound_ms=bytes_ms(3 * R1 * B),
                               bound_by="bytes", library_ms=lib,
                               library_call="int8 out.copy_(d)")
    return res


def k3_first_bytes(R1: int, W: int, dsize: int) -> dict:
    """K3's first pass: nxt and the targets read, seen and d written
    whole (``bytes``); the design before ``seen`` read nxt and wrote an
    int16 d (``old_bytes``)."""
    return dict(bytes=3 * R1 * W + 8 * R1 * W * dsize,
                old_bytes=R1 * W + 16 * R1 * W)


def k3_level_bytes(torch, ell_ops, nxt, seen, tp, dsize: int,
                   replicas: int = 1) -> dict:
    """K3's later level on this run's data: nxt, seen and the targets
    read, seen's changed words and the frontier's (in every replica)
    written, d at the newly reached lanes (``bytes``); the design before
    ``seen`` read nxt and the targets, the int16 d of the live bits and
    of the target bits not live, and wrote the changed words and the
    newly reached depths (``old_bytes``)."""
    R1, W = nxt.shape
    newly = nxt & ~seen
    grew = int((newly.view(torch.int32) != 0).sum().item())
    changed = int((newly.view(torch.int32) != nxt.view(torch.int32))
                  .sum().item())
    live = popcount(torch, ell_ops, nxt)
    n_new = popcount(torch, ell_ops, newly)
    t_other = popcount(torch, ell_ops, tp & ~nxt)
    return dict(bytes=3 * R1 * W + 4 * grew + 4 * replicas * changed
                + dsize * n_new,
                old_bytes=2 * R1 * W + 4 * replicas * changed
                + 2 * (live + n_new + t_other),
                live_bits=live, newly_bits=n_new, changed_words=changed)


# ====================================================== phase 3, int8
TAIL_B = 10                    # an off-ladder width: the byte-tail path
# K13's column paths off the ladder: bytes, 4-byte words, and 4-byte
# words at a 16-byte multiple on carriers 4 bytes off alignment
TAIL_CASES = ((TAIL_B, 0), (12, 0), (128, 4))


def int8_pairs(m):
    """A connected (start, target) pair two forward hops apart and an
    unreachable one (a target with no in-edge), as old dense ids."""
    fwd = m.edge_etype == 1
    in_deg = np.bincount(m.edge_dst[fwd], minlength=m.n)
    for k in np.nonzero(fwd)[0]:
        mid = m.edge_dst[k]
        nxt = m.edge_dst[fwd & (m.edge_src == mid)]
        s = int(m.edge_src[k])
        far = [int(t) for t in nxt if t != s and
               not (fwd & (m.edge_src == s) & (m.edge_dst == t)).any()]
        if far:
            break
    else:
        raise AssertionError("no vertex two hops from another")
    sources = np.nonzero(in_deg == 0)[0]
    sources = sources[sources != s]
    if not len(sources):
        raise AssertionError("the graph has no vertex without in-edges")
    return (s, far[0]), (s, int(sources[0]))


def k13_bytes(slots: int, R1: int, B: int, live_rows: int, hub_bytes: int,
              upto: bool) -> int:
    """The bytes one K13 advance must move for this data: the slot
    tables (8 bytes a slot), the written carrier, the live bitmaps read
    and written, each live source row once, the hub arrays, and with
    UPTO the accumulator read and written.  A program's first hop also
    reads the carrier once for its live bitmap: that pass is work the
    data does not need, so it is not counted."""
    return (8 * slots + R1 * B + 8 * ((R1 + 31) // 32) + live_rows * B
            + hub_bytes + (2 * R1 * B if upto else 0))


def go_i8_bytes(slots: int, R1: int, B: int, G: int, live_hops,
                hub_bytes: int, upto: bool) -> int:
    """The bytes ``ell_go_i8`` at 3 steps must move for this data, as
    one program with the row pack fused into its last advance (as
    ell.py:439 is): each advance's slot tables and hub arrays and the
    rows its input holds live (``live_hops``), the first advance's
    written carrier, and the packed [G, B] result; with UPTO the start
    frontier and the first advance's carrier read once more for the
    max.  The row-live pass and the bitmaps are the design's, not the
    data's."""
    return (2 * (8 * slots + hub_bytes) + R1 * B + B * sum(live_hops)
            + G * B + (2 * R1 * B if upto else 0))


def k15_first_bytes(R1: int, B: int, dsize: int, packs: bool) -> dict:
    """K15's first pass: the start carrier read, ``seen`` and ``d`` written
    whole, the targets' lane bits read (as K1 uploads them) or, with
    ``packs``, their int8 carrier read and its bits written (``bytes``);
    the int16 design read the start and the targets whole and wrote an
    int16 d (``old_bytes``)."""
    Wb = -(-B // 8)
    return dict(bytes=R1 * B + R1 * Wb + dsize * R1 * B
                + (R1 * B + R1 * Wb if packs else R1 * Wb),
                old_bytes=4 * R1 * B)


def k15_level_bytes(torch, ell_ops, nxt, seen, dsize: int) -> dict:
    """K15's later level on this run's data: nxt, ``seen`` and the target
    bits read, the seen bytes and the nxt bytes that change written, and
    the newly lanes' d (``bytes``); the int16 design read nxt and the
    int8 targets whole, the int16 d of the live lanes, and wrote the
    changed nxt bytes and the newly lanes' d (``old_bytes``)."""
    R1, B = nxt.shape
    Wb = seen.shape[1]
    newly = ell_ops.lane_bits_ref(nxt) & ~seen
    lanes = ell_ops._unpack_ref(newly)[:, :B]
    n_new = int(lanes.sum(dtype=torch.int64).item())
    live = int((nxt > 0).sum().item())
    changed = int((nxt != lanes.to(torch.int8)).sum().item())
    grew = int((newly != 0).sum().item())
    return dict(bytes=R1 * B + 2 * R1 * Wb + grew + changed + dsize * n_new,
                old_bytes=2 * R1 * B + changed + 2 * (live + n_new),
                live_lanes=live, newly_lanes=n_new, changed_bytes=changed)


def fused_pack_check(torch, ell_ops, f0, tables, eslot, hrows, over,
                     label: str, mk=None) -> int:
    """K13's row-packed last advance against its plain version: the
    packed result, exact and with the UPTO accumulator (read, not
    written), from a program's first hop (no live array) and from a
    later one (the row-live array given), and ``out``'s extra rows,
    which the hub pass reads.  ``mk`` places the kernel's carriers
    (default: a clone).  Returns the max abs error (0)."""
    mk = mk or (lambda t: t.clone())
    R1, B = f0.shape
    n, n_rows = tables.n, tables.n_rows
    live = ell_ops.row_live_i8_ref(f0)
    fk = mk(f0)
    for upto in (False, True):
        for live_in in (None, live):
            ak = mk(f0) if upto else None
            ok_ = mk(torch.zeros_like(f0))
            pk = ell_ops.packed_rows(R1, B, f0.device)
            got, _a = ell_ops.go_hop_i8(fk, ak, ok_, tables, eslot, hrows,
                                        over, live_in, None, pk)
            orf = torch.zeros_like(f0)
            pr = ell_ops.packed_rows(R1, B, f0.device)
            ell_ops.go_hop_i8_ref(f0, f0.clone() if upto else None, orf,
                                  tables, eslot, hrows, over, live_in, None,
                                  pr)
            pairs = [(got, pr), (ok_[n:n_rows], orf[n:n_rows])]
            if upto:
                pairs.append((ak, f0))
            require_equal(torch, f"fused pack {label} upto={upto} "
                          f"live_in={live_in is not None}", B, *pairs)
    return 0


def fused_pack_odd_check(torch, ell_ops, rng, dev) -> dict:
    """The row-packed last advance on hand-made tables whose buckets start
    inside 8-row groups, whose hub owners sit in the groups two buckets
    share and in the group the first extra rows share with the last real
    rows, with an unclaimed spare (owner n_rows), and whose n_rows + 1
    is no multiple of 8 (and again with n_rows a multiple of 8: the pad
    row's group its own), at B = 10, 12, 128 and 1024; and the packed
    programs at 2 and 3 steps, exact and UPTO.  Equal to the plain
    versions throughout."""
    out = {}
    for n, extra in ((4101, 37), (4099, 45)):
        T, _runs = odd_tables(torch, rng, n, (4, 8, 16, 32), extra, 0, dev)
        starts = [r for r in T.row0[1:] if r % 8]
        owners = [s - 1 for s in starts] + [s + 1 for s in starts] \
            + [n - 1, n - 2]
        hrows_h = np.array([owners[e % len(owners)] for e in range(extra)],
                           np.int32)
        hrows_h[-1] = T.n_rows                  # an unclaimed spare
        hr = torch.from_numpy(hrows_h).to(dev)
        es = torch.arange(extra, dtype=torch.int32, device=dev)
        R1 = T.n_rows + 1
        for B in (10, 12, 128, 1024):
            f0 = torch.zeros((R1, B), dtype=torch.int8, device=dev)
            f0[:n] = torch.from_numpy(rng.choice(
                np.array([0, 0, 0, 1, 2, -1], np.int8), (n, B))).to(dev)
            fused_pack_check(torch, ell_ops, f0, T, es, hr, (-1, 1, 2),
                             f"odd n={n} B={B}")
            for steps in (2, 3):
                for upto in (False, True):
                    require_equal(
                        torch, f"ell_go_i8 odd n={n} B={B} steps={steps} "
                        f"upto={upto}", B,
                        (ell_ops.ell_go_i8(f0.clone(), T, es, hr, (-1, 1, 2),
                                           steps, upto, pack=True),
                         ell_ops.ell_go_i8_ref(f0.clone(), T, es, hr,
                                               (-1, 1, 2), steps, upto,
                                               pack=True)))
        out[f"n{n}"] = dict(row0=list(T.row0), n_rows=T.n_rows,
                            mid_group_starts=starts, equal=True)
    return out


def k13_check(torch, ell_ops, f0, tables, eslot, hrows, over, label: str,
              mk=None, hops: int = 3) -> int:
    """K13 against its plain version: ``hops`` chained advances of
    ``f0``, without and with the UPTO accumulator, the live arrays
    chained as a program chains them (none for the first hop, then
    each hop's ``live_out``); every output, accumulator and
    ``live_out`` equal, and every ``live_out`` a superset of the rows
    of its output that hold a byte > 0.  ``mk`` places the kernel's
    carriers (default: a clone).  Returns the max abs error (0)."""
    mk = mk or (lambda t: t.clone())
    R1, B = f0.shape
    dev = f0.device
    for upto in (False, True):
        fk, fr = mk(f0), f0.clone()
        ak = mk(f0) if upto else None
        ar = f0.clone() if upto else None
        ok_, orf = mk(torch.zeros_like(f0)), torch.empty_like(f0)
        lk = [torch.empty(ell_ops.live_words(R1), dtype=torch.int32,
                          device=dev) for _ in range(2)]
        lr = [torch.empty_like(x) for x in lk]
        li_k = li_r = None
        for h in range(hops):
            ell_ops.go_hop_i8(fk, ak, ok_, tables, eslot, hrows, over, li_k,
                              lk[h % 2])
            ell_ops.go_hop_i8_ref(fr, ar, orf, tables, eslot, hrows, over,
                                  li_r, lr[h % 2])
            pairs = [(ok_, orf), (lk[h % 2], lr[h % 2])]
            require_equal(torch, f"go_hop_i8 {label} upto={upto} hop {h}",
                          B, *pairs + ([(ak, ar)] if upto else []))
            missed = (ok_ > 0).any(1) & ~ell_ops.live_rows(lk[h % 2], R1)
            if bool(missed.any()):
                raise AssertionError(f"go_hop_i8 {label} hop {h}: live_out "
                                     f"misses a row with a byte > 0")
            li_k, li_r = lk[h % 2], lr[h % 2]
            fk, ok_ = ok_, fk
            fr, orf = orf, fr
    return 0


def int8_kernel_phase(torch, ell_ops, m, ix, tables, eslot, hrows, B: int,
                      over, rng) -> dict:
    """The packing-off route's kernels (K12-K15) and programs
    (``ell_go_i8``, ``ell_bfs_i8``) against their plain versions at lane
    width B on the serve tables, on the inputs that route gives them: a
    batch of B queries with one start each, uploaded by K12.  Exact
    equality throughout; the hop also on an arbitrary int8 frontier.
    Returns {name: numbers}."""
    dev = tables.nbr.device
    R1 = ix.n_rows + 1
    G = -(-R1 // 8)
    i8 = torch.int8
    slots = int(tables.nbr.numel())
    hub_bytes = 4 * ((ix.n_rows - ix.n) + int(hrows.numel()))
    res = {}

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def coords(vertices):
        """runtime._upload_frontier's padded list: query q starts at
        ``vertices[q]`` (old dense ids)."""
        S = len(vertices)
        Sp = max(8, 1 << (S - 1).bit_length())
        rows_h = np.full(Sp, ix.n_rows, np.int32)
        cols_h = np.zeros(Sp, np.int32)
        rows_h[:S] = ix.perm[vertices]
        cols_h[:S] = np.arange(S)
        return up(rows_h), up(cols_h), S

    # ---- K12 upload
    starts = rng.integers(0, ix.n, B)
    rows_t, cols_t, S = coords(starts)
    Sp = int(rows_t.numel())
    fk = torch.empty((R1, B), dtype=i8, device=dev)
    fr = torch.empty_like(fk)
    ell_ops.frontier_upload_i8(fk, rows_t, cols_t, S)
    ell_ops.frontier_upload_i8_ref(fr, rows_t, cols_t, S)
    err = require_equal(torch, "frontier_upload_i8", B, (fk, fr))
    f0 = fk.clone()
    ms = cuda_ms(torch, lambda: ell_ops.frontier_upload_i8(
        fk, rows_t, cols_t, S), 50)
    plain = cuda_ms(torch, lambda: ell_ops.frontier_upload_i8_ref(
        fr, rows_t, cols_t, S), 20)
    vals = torch.zeros(Sp, dtype=i8, device=dev)
    vals[:S] = 1
    idx = (rows_t.long(), cols_t.long())
    lib = cuda_ms(torch, lambda: torch.zeros(
        (R1, B), dtype=i8, device=dev).index_put_(idx, vals), 50)
    res["frontier_upload_i8"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        bound_ms=bytes_ms(R1 * B + 8 * Sp), bound_by="bytes",
        library_ms=lib)

    # ---- K13 hop: three chained advances (the live arrays chained as
    # a program chains them), exact and with the UPTO accumulator, on
    # the start frontier, a dense one and an arbitrary one
    dense = (torch.rand((R1, B), device=dev) < 0.5).to(i8)
    dense[-1] = 0
    arb = torch.randint(-128, 128, (R1, B), dtype=i8, device=dev)
    err = 0
    for label, fx in (("start", f0), ("dense", dense), ("arbitrary", arb)):
        err = max(err, k13_check(torch, ell_ops, fx, tables, eslot, hrows,
                                 over, f"B={B} {label}"))
        err = max(err, fused_pack_check(torch, ell_ops, fx, tables, eslot,
                                        hrows, over, f"B={B} {label}"))
    del arb
    out = torch.empty_like(f0)
    lout = torch.empty(ell_ops.live_words(R1), dtype=torch.int32,
                       device=dev)
    k13 = {}
    for label, fx in (("start", f0), ("dense", dense)):
        live_rows = int((fx > 0).any(1).sum().item())
        lin = ell_ops.row_live_i8_ref(fx)
        acc = fx.clone()
        for upto in (False, True):
            a = acc if upto else None

            def first():       # a program's first hop: the pass included
                ell_ops.go_hop_i8(fx, a, out, tables, eslot, hrows, over,
                                  None, lout)

            def later():       # a later hop: the previous live_out given
                ell_ops.go_hop_i8(fx, a, out, tables, eslot, hrows, over,
                                  lin, lout)
            nbytes = k13_bytes(slots, R1, B, live_rows, hub_bytes, upto)
            k13[label, upto] = dict(
                ms=queued_ms(torch, first, PROBE_REPS),
                event_ms=cuda_ms(torch, first, 20),
                live_in_ms=queued_ms(torch, later, PROBE_REPS),
                live_in_event_ms=cuda_ms(torch, later, 20),
                bound_ms=bytes_ms(nbytes), bytes=nbytes, live_rows=live_rows)
    del dense
    plain = cuda_ms(torch, lambda: ell_ops.go_hop_i8_ref(
        f0, None, out, tables, eslot, hrows, over), 2, warmup=1)
    row = k13["start", False]
    res["go_hop_i8"] = dict(
        max_abs_err=err, ms=row["ms"], plain_ms=plain,
        bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
        library_none="none: no call gathers over ELL slots with an etype "
                     "mask and a hub merge",
        **{x: row[x] for x in ("event_ms", "live_in_ms",
                               "live_in_event_ms", "bytes", "live_rows")},
        upto=k13["start", True], dense=k13["dense", False],
        dense_upto=k13["dense", True])

    # ---- the program at 3 steps, exact and UPTO, row-packed; the
    # packed ell_go beside it on the same starts and tables
    work = torch.empty_like(f0)

    def restore():
        work.copy_(f0)
    go_rows = {}
    h1 = torch.empty_like(f0)
    ell_ops.go_hop_i8(f0, None, h1, tables, eslot, hrows, over)
    live_hops = [int((x > 0).any(1).sum().item()) for x in (f0, h1)]
    del h1
    for upto in (False, True):
        gk = ell_ops.ell_go_i8(f0.clone(), tables, eslot, hrows, over, 3,
                               upto, pack=True)
        gr = ell_ops.ell_go_i8_ref(f0.clone(), tables, eslot, hrows, over,
                                   3, upto, pack=True)
        err = require_equal(torch, f"ell_go_i8 upto={upto}", B, (gk, gr))
        ms = restored_ms(torch, lambda: ell_ops.ell_go_i8(
            work, tables, eslot, hrows, over, 3, upto, pack=True),
            restore, 10)
        plain = restored_ms(torch, lambda: ell_ops.ell_go_i8_ref(
            work, tables, eslot, hrows, over, 3, upto, pack=True),
            restore, 1, 1)
        go_bytes = go_i8_bytes(slots, R1, B, G, live_hops, hub_bytes, upto)
        # its launches a call by capture: the last advance writes the
        # packed result, so no K14
        k14 = ell_ops.LAUNCHES["pack_rows"]
        ell_ops.ell_go_i8(work, tables, eslot, hrows, over, 3, upto,
                          pack=True)
        if ell_ops.LAUNCHES["pack_rows"] != k14:
            raise AssertionError("ell_go_i8 at 3 steps launched K14")
        go_n = launches_a_call(torch, ell_ops, lambda: ell_ops.ell_go_i8(
            work, tables, eslot, hrows, over, 3, upto, pack=True))
        go_rows[upto] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             bound_ms=bytes_ms(go_bytes), bound_by="bytes",
                             library_ms=None, steps=3, live_rows=live_hops,
                             live_bits=int(ell_ops._unpack_ref(gk).sum(
                                 dtype=torch.int64).item()),
                             pack_rows_a_call=0,
                             **{a: go_n[a] for a in (
                                 "launches_a_call", "c_calls_a_call",
                                 "launch_kinds", "launches_traced")})
        if not upto:
            packed_out = gk
    # the other depths, untimed: 1, 2 and 4 steps, exact and UPTO
    for steps in (1, 2, 4):
        for upto in (False, True):
            require_equal(torch, f"ell_go_i8 steps={steps} upto={upto}", B,
                          (ell_ops.ell_go_i8(f0.clone(), tables, eslot,
                                             hrows, over, steps, upto,
                                             pack=True),
                           ell_ops.ell_go_i8_ref(f0.clone(), tables, eslot,
                                                 hrows, over, steps, upto,
                                                 pack=True)))
    # the packed route on the same starts: its lane bits are the same
    # vertex set as the int8 route's row bits
    W = B // 8
    key = torch.unique(rows_t[:S].long() * B + cols_t[:S])
    f0p = torch.empty((R1, W), dtype=torch.uint8, device=dev)
    ell_ops.frontier_upload(f0p, torch.stack((key // B, key % B)).to(
        torch.int32))
    lanes = ell_ops.ell_go(f0p.clone(), tables, eslot, hrows, over, 3)
    bits_i8 = ell_ops._unpack_ref(packed_out.t().contiguous())[:, :R1]
    bits_lanes = ell_ops._unpack_ref(lanes)[:, :B].t()
    if not torch.equal(bits_i8, bits_lanes):
        raise AssertionError(f"ell_go_i8 and ell_go disagree at B={B}")
    workp = torch.empty_like(f0p)
    packed_ms = restored_ms(torch, lambda: ell_ops.ell_go(
        workp, tables, eslot, hrows, over, 3),
        lambda: workp.copy_(f0p), 10)
    res["ell_go_i8"] = dict(go_rows[False], upto=go_rows[True],
                            packed_ell_go_ms=packed_ms,
                            int8_over_packed=go_rows[False]["ms"]
                            / max(packed_ms, 1e-9))

    # ---- K14 the row pack of a 3-step frontier (the programs run it only
    # where there is no advance: a 1-step call, one launch)
    x = ell_ops.ell_go_i8(f0.clone(), tables, eslot, hrows, over, 3)
    pk = torch.empty((G, B), dtype=torch.uint8, device=dev)
    pr = torch.empty_like(pk)
    ell_ops.pack_rows(x, pk)
    ell_ops.pack_rows_ref(x, pr)
    err = require_equal(torch, "pack_rows", B, (pk, pr))
    ms = cuda_ms(torch, lambda: ell_ops.pack_rows(x, pk), 50)
    plain = cuda_ms(torch, lambda: ell_ops.pack_rows_ref(x, pr), 5)
    k14 = ell_ops.LAUNCHES["pack_rows"]
    ell_ops.ell_go_i8(f0.clone(), tables, eslot, hrows, over, 1, pack=True)
    res["pack_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                            bound_ms=bytes_ms(R1 * B + G * B),
                            bound_by="bytes", library_ms=None,
                            one_step_launches=ell_ops.LAUNCHES["pack_rows"]
                            - k14, runs="ell_go_i8 at steps <= 1 only")

    # ---- the BFS (UPTO 5, stop when found): lane 0 a connected pair,
    # lane 1 an unreachable one, the rest random; the targets as the
    # runtime uploads them (K1's lane bits) and as an int8 carrier (the
    # first pass packs it), every level held to the plain level on the
    # same state
    (s0, t0_), (s1, t1_) = int8_pairs(m)
    starts_b = starts.copy()
    starts_b[:2] = (s0, s1)
    targets = rng.integers(0, ix.n, B)
    targets[:2] = (t0_, t1_)
    b_rows, b_cols, bS = coords(starts_b)
    t_rows, t_cols, tS = coords(targets)
    fb = torch.empty_like(f0)
    tb = torch.empty_like(f0)
    ell_ops.frontier_upload_i8(fb, b_rows, b_cols, bS)
    ell_ops.frontier_upload_i8(tb, t_rows, t_cols, tS)
    Wb = -(-B // 8)
    tbits = torch.empty((R1, Wb), dtype=torch.uint8, device=dev)
    tkey = torch.unique(t_rows[:tS].long() * B + t_cols[:tS])
    ell_ops.frontier_upload(tbits, torch.stack((tkey // B, tkey % B)).to(
        torch.int32))
    prog_bytes = []

    def level_held(nxt, tp, seen, d, flags, step, first, stop, t8=None):
        prog_bytes.append(
            k15_first_bytes(R1, B, 1, t8 is not None)["bytes"] if first
            else k15_level_bytes(torch, ell_ops, nxt, seen, 1)["bytes"])
        before = [x.clone() for x in (nxt, tp, seen, d, flags)]
        ell_ops.bfs_level_i8(nxt, tp, seen, d, flags, step, first, stop, t8)
        ell_ops.bfs_level_i8_ref(*before, step, first, stop, t8)
        require_equal(torch, f"bfs_level_i8 step={step} first={first}", B,
                      *zip((nxt, tp, seen, d, flags), before))

    def hop_counted(f, acc, out, tables_, eslot_, hrows_, over_, live_in,
                    live_out):
        prog_bytes.append(k13_bytes(slots, R1, B, int((f > 0).any(1).sum()
                                                      .item()),
                                    hub_bytes, False))
        return ell_ops.go_hop_i8(f, acc, out, tables_, eslot_, hrows_, over_,
                                 live_in, live_out)
    dh, lh = ell_ops._bfs_loop_i8(fb.clone(), tbits, tables, eslot, hrows,
                                  over, 5, True,
                                  ell_ops._live_chain(hop_counted, R1, dev),
                                  level_held)
    dk, lk = ell_ops.ell_bfs_i8(fb.clone(), tbits, tables, eslot, hrows,
                                over, 5)
    d8, l8 = ell_ops.ell_bfs_i8(fb.clone(), tb, tables, eslot, hrows, over,
                                5)
    dr, lr = ell_ops.ell_bfs_i8_ref(fb.clone(), tb, tables, eslot, hrows,
                                    over, 5)
    err_bfs = require_equal(torch, "ell_bfs_i8", B, (dk, dr), (d8, dr),
                            (dh, dr))
    if not lk == l8 == lr == lh or dk.dtype != torch.int8:
        raise AssertionError(f"ell_bfs_i8 ran {lk} / {l8} levels ({lh} "
                             f"held), plain {lr}, {dk.dtype}")
    d_conn = int(dk[int(ix.perm[t0_]), 0].item())
    d_none = int(dk[int(ix.perm[t1_]), 1].item())
    if d_conn != 2 or d_none != -1:
        raise AssertionError(f"BFS depths {d_conn} (want 2) and {d_none} "
                             f"(want -1) on the aimed lanes")
    del dh, d8
    wb = torch.empty_like(fb)
    bfs_ms = restored_ms(torch, lambda: ell_ops.ell_bfs_i8(
        wb, tbits, tables, eslot, hrows, over, 5), lambda: wb.copy_(fb), 3, 1)
    bfs_t8_ms = restored_ms(torch, lambda: ell_ops.ell_bfs_i8(
        wb, tb, tables, eslot, hrows, over, 5), lambda: wb.copy_(fb), 3, 1)
    bfs_plain = restored_ms(torch, lambda: ell_ops.ell_bfs_i8_ref(
        wb, tb, tables, eslot, hrows, over, 5), lambda: wb.copy_(fb), 1, 1)
    # its launches: the loop replayed with the level flags a run read,
    # plus those reads, less the start's clone the call here adds; no
    # bfs_depth_i8 (d is kept in the result's form)
    flag_reads = []

    def bfs_loop(read):
        return ell_ops._bfs_loop_i8(
            fb.clone(), tbits, tables, eslot, hrows, over, 5, True,
            ell_ops._live_chain(ell_ops.go_hop_i8, R1, dev),
            ell_ops.bfs_level_i8, read=read)
    bfs_loop(lambda flag: flag_reads.append(flag.tolist())
             or flag_reads[-1])

    def bfs_replay():
        it = iter(flag_reads)
        return bfs_loop(lambda _flag: next(it))
    depth_passes = ell_ops.LAUNCHES["bfs_depth_i8"]
    bfs_n = launches_a_call(torch, ell_ops, lambda: ell_ops.ell_bfs_i8(
        fb.clone(), tbits, tables, eslot, hrows, over, 5),
        replay=bfs_replay, reads=len(flag_reads))
    if ell_ops.LAUNCHES["bfs_depth_i8"] != depth_passes:
        raise AssertionError("ell_bfs_i8 launched bfs_depth_i8")
    bfs_n["launches_a_call"] -= 1
    bfs_n["launch_kinds"]["memcpy"] -= 1
    res["ell_bfs_i8"] = dict(max_abs_err=err_bfs, ms=bfs_ms,
                             plain_ms=bfs_plain, levels=lk,
                             bound_ms=bytes_ms(8 * slots + 2 * R1 * B
                                               + R1 * Wb + hub_bytes),
                             old_bound_ms=bytes_ms(8 * slots + 3 * R1 * B
                                                   + hub_bytes),
                             design_bound_ms=bytes_ms(sum(prog_bytes)),
                             bound_by="bytes", library_ms=None,
                             int8_targets_ms=bfs_t8_ms,
                             connected_depth=d_conn, unreachable_depth=d_none,
                             bfs_depth_i8_a_call=0,
                             less="the start frontier's clone",
                             **{a: bfs_n[a] for a in (
                                 "launches_a_call", "c_calls_a_call",
                                 "launch_kinds", "host_reads",
                                 "launches_traced")})

    # ---- K15 alone (device time queued behind a spin, events beside):
    # the first pass (the targets as lane bits, and packed from the int8
    # carrier), then a level after a hop on level 1's state (one start
    # and target a lane) and on a dense frontier (the hop of a start with
    # 2 % of the rows 0/1 lanes at random)
    d0 = torch.empty((R1, B), dtype=torch.int8, device=dev)
    seen0 = torch.empty((R1, Wb), dtype=torch.uint8, device=dev)
    tpk = torch.empty_like(seen0)
    flg = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    first_in = fb.clone()
    firsts = {}
    for label, tp, t8 in (("bits", tbits, None), ("carrier", tpk, tb)):
        ell_ops.bfs_level_i8(first_in, tp, seen0, d0, flg[0].zero_(), 0,
                             True, True, t8)
        rr = [torch.empty_like(x) for x in (tp, seen0, d0)]
        if t8 is None:
            rr[0].copy_(tp)
        fr0 = torch.zeros(2, dtype=torch.int32, device=dev)
        ell_ops.bfs_level_i8_ref(fb.clone(), rr[0], rr[1], rr[2], fr0, 0,
                                 True, True, t8)
        require_equal(torch, f"bfs_level_i8 first pass {label}", B,
                      (first_in, fb), (tp, rr[0]), (seen0, rr[1]),
                      (d0, rr[2]), (flg[0], fr0))
        fbytes = k15_first_bytes(R1, B, 1, t8 is not None)

        def first():
            ell_ops.bfs_level_i8(first_in, tp, seen0, d0, flg[0], 0, True,
                                 True, t8)
        firsts[label] = dict(
            ms=queued_ms(torch, first, PROBE_REPS),
            event_ms=cuda_ms(torch, first, 20),
            plain_ms=cuda_ms(torch, lambda: ell_ops.bfs_level_i8_ref(
                first_in, rr[0], rr[1], rr[2], fr0, 0, True, True, t8), 3),
            bound_ms=bytes_ms(fbytes["bytes"]),
            old_bound_ms=bytes_ms(fbytes["old_bytes"]))
    live_h = np.zeros((R1, B), np.int8)
    rows2 = rng.random(ix.n) < 0.02
    live_h[:ix.n][rows2] = rng.integers(0, 2, (int(rows2.sum()), B))
    dense0 = up(live_h)
    del live_h
    levels = {}
    for label, start in (("level1", fb), ("dense", dense0)):
        ell_ops.bfs_level_i8(start, tbits, seen0, d0, flg[0].zero_(), 0,
                             True)
        nxt0 = torch.empty_like(start)
        ell_ops.go_hop_i8(start, None, nxt0, tables, eslot, hrows, over)
        s_first, d_first = seen0.clone(), d0.clone()
        nk, fk1 = nxt0.clone(), flg[1].zero_()
        ell_ops.bfs_level_i8(nk, tbits, seen0, d0, fk1, 0)
        nr, sr, dr1, fr1 = nxt0.clone(), s_first.clone(), d_first.clone(), \
            torch.zeros_like(fk1)
        ell_ops.bfs_level_i8_ref(nr, tbits, sr, dr1, fr1, 0, False, True)
        err = require_equal(torch, f"bfs_level_i8 {label}", B, (nk, nr),
                            (seen0, sr), (d0, dr1), (fk1, fr1))

        def restore():
            nk.copy_(nxt0)
            seen0.copy_(s_first)
            d0.copy_(d_first)
        lb = k15_level_bytes(torch, ell_ops, nxt0, s_first, 1)

        def level():
            ell_ops.bfs_level_i8(nk, tbits, seen0, d0, fk1, 0)
        levels[label] = dict(
            max_abs_err=err,
            ms=restored_queued_ms(torch, level, restore,
                                  f"bfs_level_i8 {label} B={B}"),
            event_ms=restored_ms(torch, level, restore, 20),
            plain_ms=restored_ms(torch, lambda: ell_ops.bfs_level_i8_ref(
                nr, tbits, sr, dr1, fr1, 0, False, True),
                lambda: (nr.copy_(nxt0), sr.copy_(s_first),
                         dr1.copy_(d_first)), 5),
            bound_ms=bytes_ms(lb["bytes"]),
            old_bound_ms=bytes_ms(lb["old_bytes"]),
            live_lanes=lb["live_lanes"], newly_lanes=lb["newly_lanes"])
        del nxt0, s_first, d_first, nr, sr, dr1
    del dense0
    one = levels["level1"]
    res["bfs_level_i8"] = dict(
        one, bound_by="bytes", library_ms=None,
        first_ms=firsts["bits"]["ms"],
        first_bound_ms=firsts["bits"]["bound_ms"],
        first=firsts, dense=levels["dense"])
    return res


def int8_tail_check(torch, ell_ops, ix, tables, eslot, hrows, over, rng,
                    B: int = TAIL_B, offset: int = 0) -> dict:
    """The int8 route off the 128/1024 ladder, untimed, each function
    equal to its plain version: upload, ``ell_go_i8`` with and without
    UPTO and the row pack, K13 chained (``k13_check``) and its row-packed
    last advance (``fused_pack_check``) on the start, a dense and an
    arbitrary frontier, and the BFS (targets as an int8 carrier and as
    lane bits, with and without stop) with K15's first pass and five
    levels held state by state, int8 and int16 d.
    B = 10 takes K13's byte columns, B = 12 its 4-byte ones; ``offset``
    places K13's carriers that many bytes past a 16-byte boundary (B =
    128 at 4: the 4-byte columns at a width the 16-byte ones take).
    K13 also runs on slot tables 4 bytes off a 16-byte boundary (its
    one-slot scan, ``Q = false``) with aligned carriers: at B = 128 on
    its 16-byte columns, at B = 12 on 4-byte ones, at B = 10 on bytes."""
    dev = tables.nbr.device
    R1 = ix.n_rows + 1
    S = min(4 * B, 64)
    rows_h = np.full(64, ix.n_rows, np.int32)
    cols_h = np.zeros(64, np.int32)
    rows_h[:S] = ix.perm[rng.integers(0, ix.n, S)]
    cols_h[:S] = np.arange(S) % B
    rows_t = torch.from_numpy(rows_h).to(dev)
    cols_t = torch.from_numpy(cols_h).to(dev)
    fk = torch.empty((R1, B), dtype=torch.int8, device=dev)
    fr = torch.empty_like(fk)
    ell_ops.frontier_upload_i8(fk, rows_t, cols_t, S)
    ell_ops.frontier_upload_i8_ref(fr, rows_t, cols_t, S)
    require_equal(torch, "frontier_upload_i8", B, (fk, fr))
    for upto in (False, True):
        for pack in (False, True):
            gk = ell_ops.ell_go_i8(fk.clone(), tables, eslot, hrows, over,
                                   4, upto, pack)
            gr = ell_ops.ell_go_i8_ref(fk.clone(), tables, eslot, hrows,
                                       over, 4, upto, pack)
            require_equal(torch, f"ell_go_i8 upto={upto} pack={pack}", B,
                          (gk, gr))

    def shifted(t):       # the same values `offset` bytes past 16
        buf = torch.empty(t.numel() + 16, dtype=torch.int8, device=dev)
        v = buf[offset:offset + t.numel()].view(t.shape)
        v.copy_(t)
        return v
    dense = (torch.rand((R1, B), device=dev) < 0.5).to(torch.int8)
    dense[-1] = 0
    arb = torch.randint(-128, 128, (R1, B), dtype=torch.int8, device=dev)
    def slots_off(t):     # int32 slots 4 bytes past a 16-byte boundary
        buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=dev)
        v = buf[1:1 + t.numel()].view(t.shape)
        v.copy_(t)
        return v
    off_tables = tables._replace(nbr=slots_off(tables.nbr),
                                 et=slots_off(tables.et))
    for label, fx in (("start", fk), ("dense", dense), ("arbitrary", arb)):
        k13_check(torch, ell_ops, fx, tables, eslot, hrows, over,
                  f"B={B} offset={offset} {label}",
                  shifted if offset else None)
        k13_check(torch, ell_ops, fx, off_tables, eslot, hrows, over,
                  f"B={B} slots 4 bytes off {label}")
        fused_pack_check(torch, ell_ops, fx, tables, eslot, hrows, over,
                         f"B={B} offset={offset} {label}",
                         shifted if offset else None)
    del dense, arb, off_tables
    # the BFS with and without stop, its targets as an int8 carrier and
    # as lane bits, then K15's passes alone on carriers `offset` bytes
    # off (B = 128 at 4: the 8-lane path with 4-byte words), each held
    tk = fk.roll(1, dims=0).contiguous()
    tbits = ell_ops.lane_bits_ref(tk)
    for stop in (False, True):
        dr, lr = ell_ops.ell_bfs_i8_ref(fk.clone(), tk, tables, eslot,
                                        hrows, over, 5, stop)
        for t in (tk, tbits):
            dk, lk = ell_ops.ell_bfs_i8(fk.clone(), t, tables, eslot, hrows,
                                        over, 5, stop)
            require_equal(torch, f"ell_bfs_i8 stop={stop}", B, (dk, dr))
            if lk != lr:
                raise AssertionError(f"ell_bfs_i8 ran {lk} levels, plain "
                                     f"{lr}")
    place = shifted if offset else (lambda t: t.clone())
    Wb = -(-B // 8)
    seen = torch.empty((R1, Wb), dtype=torch.uint8, device=dev)
    tp = torch.empty_like(seen)
    for dt in (torch.int8, torch.int16):
        dk = torch.empty((R1, B), dtype=dt, device=dev)
        if offset:        # d `offset` * element size bytes off as well
            buf = torch.empty(R1 * B + 16, dtype=dt, device=dev)
            dk = buf[offset:offset + R1 * B].view(R1, B)
        st_r = [torch.empty_like(tp), torch.empty_like(seen),
                torch.empty((R1, B), dtype=dt, device=dev)]
        flk = torch.zeros((6, 2), dtype=torch.int32, device=dev)
        flr = torch.zeros_like(flk)
        cur_k, cur_r = place(fk), fk.clone()
        t8k = place(tk)
        ell_ops.bfs_level_i8(cur_k, tp, seen, dk, flk[0], 0, True, True, t8k)
        ell_ops.bfs_level_i8_ref(cur_r, *st_r, flr[0], 0, True, True, tk)
        chain_k = ell_ops._live_chain(ell_ops.go_hop_i8, R1, dev)
        for step in range(5):
            require_equal(torch, f"bfs_level_i8 {dt} B={B} offset={offset} "
                          f"step={step}", B, (cur_k, cur_r), (tp, st_r[0]),
                          (seen, st_r[1]), (dk, st_r[2]), (flk, flr))
            nk, nr = place(torch.zeros_like(fk)), torch.empty_like(fk)
            chain_k(cur_k, None, nk, tables, eslot, hrows, over)
            ell_ops.go_hop_i8_ref(cur_r, None, nr, tables, eslot, hrows, over)
            ell_ops.bfs_level_i8(nk, tp, seen, dk, flk[step + 1], step)
            ell_ops.bfs_level_i8_ref(nr, *st_r, flr[step + 1], step, False,
                                     True)
            cur_k, cur_r = nk, nr
        require_equal(torch, f"bfs_level_i8 {dt} B={B} offset={offset} "
                      f"last level", B, (cur_k, cur_r), (seen, st_r[1]),
                      (dk, st_r[2]), (flk, flr))
    # the int8 form at this width: the whole matrix, a length that is no
    # multiple of 8 (the vector path, then its tail), and rows from the
    # second on (not 16-byte aligned at B = 10: one entry a step)
    inf = int(ell_ops.INT16_INF)
    d16 = torch.where(torch.rand((R1, B), device=dev) < 0.5, inf,
                      torch.randint(0, 121, (R1, B), device=dev)
                      ).to(torch.int16)
    flat = d16.view(-1)
    forms = {"whole": d16, "odd_length": flat[:flat.numel() - 3].view(1, -1),
             "rows_from_1": d16[1:]}
    for label, x in forms.items():
        o8 = torch.empty(x.shape, dtype=torch.int8, device=dev)
        w8 = torch.empty_like(o8)
        ell_ops.bfs_depth_i8(x, o8)
        ell_ops.bfs_depth_i8_ref(x, w8)
        require_equal(torch, f"bfs_depth_i8 B={B} {label}", B, (o8, w8))
    return dict(B=B, offset=offset, levels=lk, equal=True,
                bfs_depth_i8_forms=list(forms),
                k15_paths="16-lane" if B % 16 == 0 and not offset
                else "8-lane, 4-byte words" if B % 4 == 0 else "8-lane, bytes")


HOP_TAIL_WIDTHS = (4, 12, 20, 48)   # off the ladder: the 4-byte columns,
                                    # and 16-byte columns that fill no warp


def hop_width_check(torch, ell_ops, ix, tables, eslot, hrows, over,
                    rng) -> dict:
    """``go_hop`` against ``go_hop_ref``, untimed: three chained hops
    with and without the UPTO accumulator at W = 16 and 128 and at the
    off-ladder widths, then at W = 16 on rows 4 bytes off a 16-byte
    boundary (the 4-byte row path), on slot tables 4 bytes off (the
    4-byte slot path) and on both (the two 4-byte paths together), and
    at W = 160 on rows 4 bytes off (40 4-byte columns a row: more than
    a warp's lanes, so each lane takes two), all on the serve tables
    with their hub rows."""
    dev = tables.nbr.device
    R1 = ix.n_rows + 1

    def shifted(t):       # the same values 4 bytes past an aligned start
        buf = torch.empty(t.numel() * t.element_size() + 4,
                          dtype=torch.uint8, device=dev)
        v = buf[4:].view(t.dtype).view(t.shape)
        v.copy_(t)
        return v
    cases = [(W, False, False) for W in (16, 128) + HOP_TAIL_WIDTHS]
    cases += [(16, True, False), (16, False, True), (16, True, True),
              (160, True, False)]
    for W, rows_off, slots_off in cases:
        tb = tables
        if slots_off:
            tb = tables._replace(nbr=shifted(tables.nbr),
                                 et=shifted(tables.et))
        f_h = np.zeros((R1, W), np.uint8)
        live = rng.random(ix.n) < 0.02
        f_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                        dtype=np.uint8)
        f0 = torch.from_numpy(f_h).to(dev)
        for with_acc in (True, False):
            mk = shifted if rows_off else (lambda t: t.clone())
            fk, ok_ = mk(f0), mk(torch.zeros_like(f0))
            fr, orf = f0.clone(), torch.zeros_like(f0)
            ak = mk(f0) if with_acc else None
            ar = f0.clone() if with_acc else None
            for h in range(3):
                ell_ops.go_hop(fk, ak, ok_, tb, eslot, hrows, over)
                ell_ops.go_hop_ref(fr, ar, orf, tb, eslot, hrows, over)
                pairs = [(ok_, orf)] + ([(ak, ar)] if with_acc else [])
                require_equal(torch, f"go_hop W={W} acc={with_acc} "
                              f"rows_off={rows_off} slots_off={slots_off} "
                              f"hop {h}", 8 * W, *pairs)
                fk, ok_ = ok_, fk
                fr, orf = orf, fr
    return dict(cases=[dict(W=W, rows_off=r, slots_off=q)
                       for W, r, q in cases], chained_hops=3,
                with_and_without_acc=True, equal=True)


# =================================================== phase 3, sparse
PROBE_REPS = 8            # timed calls of each probed kernel call


class Probe:
    """Stands in for one kernel wrapper inside a program run: every call
    also runs the plain version on copies of the tensor operands, holds
    every operand equal afterwards, and times both with CUDA events.
    The kernel is timed over PROBE_REPS more calls, each on its own
    copy of the operands as they were, queued behind a spin kernel
    that holds the card while the host enqueues them, so the events
    bracket device work alone (``enqueue_ms``, the longest host time
    from the spin to the last event, must stay below the spin's).
    ``pre(args)`` / ``post(args)`` give the
    bytes the call must move (read before and after the call);
    Each call's device ms and bound are kept (``call_ms``,
    ``call_bound_ms``, given by ``numbers`` up to 32 calls);
    ``lib(args)``, when given, times the PyTorch library call computing
    the same function; ``same(i, a, b)``, when given, decides whether
    operand i of the kernel's call (``a``) equals the plain version's
    (``b``) in place of ``torch.equal``.  ``first(spares)``, when given,
    runs once, after the first call, on ``spares`` more copies of that
    call's operands as they were, and returns numbers that ``numbers``
    adds."""

    def __init__(self, torch, name, kern, ref, pre=None, post=None,
                 lib=None, same=None, first=None, spares=0):
        self.torch, self.name = torch, name
        self.kern, self.ref = kern, ref
        self.pre, self.post, self.lib = pre, post, lib
        self.same = same or (lambda _i, a, b: torch.equal(a, b))
        self.first, self.spares = first, spares
        self.calls = 0
        self.k_ms = self.r_ms = self.enqueue_ms = 0.0
        self.bytes = 0
        self.lib_ms = []
        self.call_ms, self.call_bound_ms = [], []
        self.extra = {}

    def __call__(self, *args):
        torch = self.torch
        nb = self.pre(args) if self.pre else 0
        if self.lib is not None:
            t = self.lib(args)
            if t is not None:
                self.lib_ms.append(t)
        first = self.first if self.calls == 0 else None
        copies = [[a.clone() if isinstance(a, torch.Tensor) else a
                   for a in args]
                  for _ in range(1 + PROBE_REPS + (self.spares if first
                                                   else 0))]
        spares = copies[1 + PROBE_REPS:]
        del copies[1 + PROBE_REPS:]
        out = self.kern(*args)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        self.ref(*copies[0])
        ev[1].record()
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(args, copies[0])):
            if isinstance(a, torch.Tensor) and not self.same(k, a, b):
                raise AssertionError(f"{self.name} != its plain version "
                                     f"(operand {k})")
        t0 = time.perf_counter()
        torch.cuda._sleep(SPIN_CYCLES)
        ev[2].record()
        for c in copies[1:]:
            self.kern(*c)
        ev[3].record()
        self.enqueue_ms = max(self.enqueue_ms,
                              (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        self.r_ms += ev[0].elapsed_time(ev[1])
        self.call_ms.append(ev[2].elapsed_time(ev[3]) / PROBE_REPS)
        self.k_ms += self.call_ms[-1]
        nb += self.post(args) if self.post else 0
        self.call_bound_ms.append(bytes_ms(nb))
        self.bytes += nb
        self.calls += 1
        if first is not None:
            self.extra.update(first(spares))
            del spares
        return out

    def numbers(self) -> dict:
        c = max(self.calls, 1)
        return dict(max_abs_err=0, ms=self.k_ms / c, plain_ms=self.r_ms / c,
                    bound_ms=bytes_ms(self.bytes / c), bound_by="bytes",
                    library_ms=(float(np.mean(self.lib_ms))
                                if self.lib_ms else None),
                    enqueue_ms=self.enqueue_ms,
                    calls=self.calls, **({} if self.calls > 32 else dict(
                        call_ms=self.call_ms,
                        call_bound_ms=self.call_bound_ms)), **self.extra)


def stage_launches(torch, ell_ops, fn, want: int, counters: dict,
                   label: str) -> dict:
    """One call of a card stage, its launches measured two ways and held
    to what the stage must launch: the trace's device launches a call
    (``launches_a_call``: the call captured into a CUDA graph) must be
    ``want`` in one checked C call, and
    the wrappers' counters (``ell_ops.LAUNCHES``, read around one call)
    must move by ``counters`` ({name: count}).  Raises otherwise."""
    before = dict(ell_ops.LAUNCHES)
    fn()
    torch.cuda.synchronize()
    moved = {n: ell_ops.LAUNCHES[n] - before[n] for n in counters}
    if moved != counters:
        raise AssertionError(f"{label}: counters moved {moved}, not "
                             f"{counters}")
    row = launches_a_call(torch, ell_ops, fn)
    if row["launches_a_call"] != want or row["c_calls_a_call"] != 1:
        raise AssertionError(f"{label}: {row['launches_a_call']} launches "
                             f"in {row['c_calls_a_call']} C calls, not "
                             f"{want} in 1 ({row['launch_kinds']})")
    row["counters_moved"] = moved
    return row


def _arg(args, i):
    """Positional operand i of a probed call, None when not passed."""
    return args[i] if len(args) > i else None


def _scan_free(torch, at: int):
    """A probe's operand test for K5's callers: every operand equal but
    the look-back state at position ``at``, the kernel's own working
    memory, which the plain version does not keep."""
    return lambda i, a, b: i == at or torch.equal(a, b)


def sparse_probes(torch, ell_ops, tables, ix):
    """Probes of K4-K7, the lane layout change and the hop, with their
    bytes bounds from this run's data (8 bytes per slot of the rows a
    push walks, the bitmap words read, zeroed and written, the pairs
    written; K6 the live pairs, their degrees and its output) and the
    library yardsticks (``torch.unique`` of the hop's candidate keys for
    K5, which waits on the card for its output's size, so its time
    includes the host's part; ``index_add_`` for K6's COUNT)."""
    dev = tables.nbr.device
    n, n_rows = tables.n, tables.n_rows
    R1 = n_rows + 1
    d_row = torch.repeat_interleave(
        torch.tensor(tables.D, device=dev),
        torch.tensor(tables.rows, device=dev))
    ctx = {}

    def walked(args):
        ids, qid, ecnt, e0 = args[:4]
        rows, rq, ce = ell_ops.expand_rows(ids, qid, ecnt, e0, n, n_rows)
        return rows, rq, int(d_row[rows].sum())

    def expand_pre(args):
        ids, ecnt = args[0], args[2]
        if _arg(args, 11):                   # counted: K5's live prefix
            live = min(int(args[8][ell_ops.CTL_CNT]), ids.numel())
            args = (ids[:live], None if args[1] is None else
                    args[1][:live]) + tuple(args[2:])
            ids = args[0]
        if _arg(args, 10):                   # self mode: the start marks
            return 8 * ids.numel()
        rows, rq, slots = walked(args)
        ctx["slots"] = ctx.get("slots", 0) + slots
        if args[1] is not None:              # a sparse GO hop
            qs, us = ell_ops._slot_targets(rows, rq, tables,
                                           tuple(-t for t in args[5]))
            ctx["keys"] = qs * (args[7] * 32) + us
        return 8 * ids.numel() + (8 * ids.numel() if ecnt is not None
                                  else 0) + 8 * slots

    def expand_post(args):
        return 4 * int((args[6] != 0).sum())

    def compact_pre(args):
        mark, uni, copy_to = args[0], _arg(args, 8), _arg(args, 9)
        words = mark.numel()
        return (4 * words + 4 * int((mark != 0).sum())
                + (8 * words if uni is not None else 0)
                + (4 * words if copy_to is not None else 0)
                + (8 if args[4] is not None else 4) * args[2])

    def compact_lib(args):
        keys = ctx.pop("keys", None)
        if keys is None:
            return None
        return cuda_ms(torch, lambda: torch.unique(keys, sorted=True), 5, 1)

    def reduce_pre(args):
        # the live pairs (and, for COUNT and LIMIT, their degrees) read
        # and the output written; COUNT and LIMIT also read the padded
        # tail of the capacity-sized list, a cost of the design kept
        # apart (the emit stops at K5's count)
        op, ids, qid, deg, out = args[:5]
        live = int((qid != ell_ops.BIG_Q).sum())
        ctx["padded_read_bytes"] = 0 if op == ell_ops.REDUCE_EMIT \
            else 8 * (ids.numel() - live)
        return 8 * live + (4 * live if op else 0) + 4 * out.numel()

    def reduce_lib(args):
        op, ids, qid, deg = args[:4]
        if op != ell_ops.REDUCE_COUNT:
            return None
        live = qid != ell_ops.BIG_Q
        q, w = qid[live].long(), deg[ids[live].long()].long()
        acc = torch.zeros(args[9], dtype=torch.int64, device=dev)

        def fold():
            acc.zero_()
            acc.index_add_(0, q, w)
        return queued_ms(torch, fold, 10)

    def switch_ref(fr, hub, n_, n_rows_, ctl):
        return ell_ops.adaptive_switch_ref(fr, fr.shape[0], hub, n_,
                                           n_rows_, ctl)

    hop_bytes = 8 * int(tables.nbr.numel()) + 8 * R1 \
        + 4 * ((n_rows - n) * 2)

    probes = {
        "sparse_expand": Probe(torch, "sparse_expand", ell_ops.sparse_expand,
                               ell_ops.sparse_expand_ref, expand_pre,
                               expand_post),
        "pair_compact": Probe(torch, "pair_compact", ell_ops.pair_compact,
                              ell_ops.pair_compact_ref, compact_pre,
                              lib=compact_lib, same=_scan_free(torch, 12)),
        "pair_reduce": Probe(torch, "pair_reduce", ell_ops.pair_reduce,
                             ell_ops.pair_reduce_ref, reduce_pre,
                             lib=reduce_lib),
        "adaptive_switch": Probe(torch, "adaptive_switch",
                                 ell_ops.adaptive_switch, switch_ref,
                                 lambda a: 5 * a[0].numel() + 16),
        "bitmap_lanes": Probe(torch, "bitmap_lanes", ell_ops.bitmap_lanes,
                              ell_ops.bitmap_lanes_ref,
                              lambda a: 4 * R1 + (R1 + 7) // 8),
        "go_hop": Probe(torch, "go_hop", ell_ops.go_hop, ell_ops.go_hop_ref,
                        lambda a: hop_bytes),
    }
    return probes, ctx


def sparse_batch(ix, starts, c0: int, nq: int):
    """The runtime's start layout for ``nq`` queries sharing the given
    start vertices round-robin (old dense ids), padded to c0."""
    S = min(len(starts), c0)
    new = ix.perm[np.asarray(starts[:S], np.int64)]
    q = np.arange(S) % nq
    order = np.lexsort((new, q))
    ids = np.full(c0, ix.n_rows, np.int32)
    qid = np.zeros(c0, np.int32)
    ids[:S], qid[:S] = new[order], q[order]
    return ids, qid


def odd_tables(torch, rng, n: int, Ds, extra_rows: int, pad: int, dev):
    """Hand-made slot tables: rows 0 .. n - 1 over buckets of widths Ds
    (row0 ascending), the ``extra_rows`` hub extra rows in the last
    bucket, ``pad`` unused slots before each bucket (slot0 off 16 bytes
    when pad % 4); random neighbours (the sentinel among them) and
    etypes in {-2, -1, 0, 1, 2}; with each of 3 hubs' extra-row runs
    (ecnt, e0)."""
    from nebula_tpu_torch.tpu.ell import DeviceTables
    nb = len(Ds)
    cuts = sorted(rng.choice(np.arange(1, n), nb - 1, replace=False))
    row0 = [0] + [int(c) for c in cuts]
    rows = [b - a for a, b in zip(row0, row0[1:] + [n])]
    rows[-1] += extra_rows
    n_rows = n + extra_rows
    slot0, nbr, et, at = [], [], [], 0
    for b in range(nb):
        nbr.append(np.full(pad, -7, np.int32))
        et.append(np.zeros(pad, np.int32))
        at += pad
        slot0.append(at)
        k = rows[b] * Ds[b]
        nbr.append(rng.integers(0, n_rows + 1, k).astype(np.int32))
        et.append(rng.choice([1, -1, 2, -2, 0], k).astype(np.int32))
        at += k
    T = DeviceTables(torch.from_numpy(np.concatenate(nbr)).to(dev),
                     torch.from_numpy(np.concatenate(et)).to(dev),
                     tuple(row0), tuple(rows), tuple(Ds), tuple(slot0), n,
                     n_rows)
    ecnt = np.zeros(n + 1, np.int32)
    e0 = np.zeros(n + 1, np.int32)
    cuts = sorted(rng.choice(np.arange(1, extra_rows), 2, replace=False))
    for o, a, b in zip(rng.choice(n, 3, replace=False), [0] + cuts,
                       cuts + [extra_rows]):
        ecnt[o], e0[o] = b - a, n + a
    return T, (torch.from_numpy(ecnt).to(dev), torch.from_numpy(e0).to(dev))


def k4_odd_check(torch, ell_ops, rt, m, ix, tables, rng) -> dict:
    """K4 held to its plain version on the card (untimed) at the shapes
    its callers can give it: on the serve tables a 256-pair list whose
    40-pair live prefix is followed by stale pairs that only the count K5
    left cuts off (``counted``) or by sentinels, one and three queries,
    self mode, the hubs' extra-row runs past a per-pair clamp of 1; on
    hand-made tables buckets of D = 1, 2, 3, 5, 33 and 40 slots off
    16-byte alignment, and of 8, 16, 36 and 64 aligned (16-byte units),
    lists of 5 to 9000 pairs (several tiles a warp).  Then the gated
    launch as ``ad_program`` makes it on a K = 2048 list: shut (the mark
    left untouched) and open (held), each with its device time (queued
    behind a spin) and event time."""
    dev = tables.nbr.device
    n = 0

    def hold(label, T, ids_h, qid_h, hub, nq, c_lim, self_mode=False,
             counted=False, live=0):
        nonlocal n
        R1w = ell_ops._words(T.n_rows + 1)
        ids = torch.from_numpy(np.asarray(ids_h, np.int32)).to(dev)
        qid = None if qid_h is None else torch.from_numpy(
            np.asarray(qid_h, np.int32)).to(dev)
        ec, e_0 = hub if hub is not None else (None, None)
        mark = torch.zeros(nq * R1w, dtype=torch.int32, device=dev)
        ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64, device=dev)
        ctl[ell_ops.CTL_CNT] = live
        mr, cr = mark.clone(), ctl.clone()
        ell_ops.sparse_expand(ids, qid, ec, e_0, T, (1,), mark, R1w, ctl,
                              c_lim, self_mode, counted)
        ell_ops.sparse_expand_ref(ids, qid, ec, e_0, T, (1,), mr, R1w, cr,
                                  c_lim, self_mode, counted)
        torch.cuda.synchronize()
        if not (torch.equal(mark, mr) and torch.equal(ctl, cr)):
            raise AssertionError(f"sparse_expand != its plain version "
                                 f"({label})")
        n += 1

    hub = rt._hub_expansion_dev(m, ix)
    for nq in (1, 3):
        for pad, counted in (("stale", True), ("sentinel", False)):
            ids = ix.perm[rng.integers(0, ix.n, 256)].astype(np.int32)
            qid = rng.integers(0, nq, 256).astype(np.int32)
            o = np.lexsort((ids[:40], qid[:40]))
            ids[:40], qid[:40] = ids[:40][o], qid[:40][o]
            if pad == "sentinel":
                ids[40:], qid[40:] = ix.n_rows, ell_ops.BIG_Q
            for self_mode in (False, True):
                hold(f"serve nq={nq} {pad} self={self_mode}", tables, ids,
                     qid if nq > 1 else None, hub, nq, 1 << 20, self_mode,
                     counted, 40)
    owners = np.nonzero(hub[0].cpu().numpy() > 1)[0]
    if len(owners):
        hold("serve hubs past the clamp", tables,
             owners[:64].astype(np.int32), None, hub, 1, 1)
    for Ds, pad in (((1, 2, 3, 5, 33, 40), 1), ((8, 16, 36, 64), 0)):
        T, th = odd_tables(torch, rng, 3000, Ds, 40, pad, dev)
        for c_in in (5, 300, 9000):
            ids = rng.integers(0, T.n_rows + 1, c_in).astype(np.int32)
            for nq in (1, 3):
                qid = rng.integers(0, nq, c_in) if nq > 1 else None
                for c_lim in (1, 1 << 20):
                    hold(f"D={Ds} c_in={c_in} nq={nq} c_lim={c_lim}", T,
                         ids, qid, th, nq, c_lim)
                hold(f"D={Ds} c_in={c_in} nq={nq} counted", T, ids, qid,
                     th, nq, 1 << 20, False, True, c_in // 3)
    # the adaptive program's gated launch: a K = 2048 list, a gate word
    K = 2048
    R1w = ell_ops._words(ix.n_rows + 1)
    fr = torch.from_numpy(ix.perm[rng.integers(0, ix.n, K)].astype(
        np.int32)).to(dev)
    cand = torch.zeros(R1w, dtype=torch.int32, device=dev)
    ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64, device=dev)
    ctl[ell_ops.CTL_CNT] = 600
    gate = ctl[ell_ops.CTL_MODE:ell_ops.CTL_MODE + 1]
    row = dict(odd_cases=n)
    for mode, label in ((ell_ops.MODE_DENSE, "shut"),
                        (ell_ops.MODE_SPARSE, "open")):
        ctl[ell_ops.CTL_MODE] = mode
        cand.zero_()
        cr, mr = ctl.clone(), cand.clone()

        def gated():
            ell_ops.sparse_expand(fr, None, None, None, tables, (1,), cand,
                                  R1w, ctl, 0, False, True, gate=gate,
                                  want=ell_ops.MODE_SPARSE)
        gated()
        ell_ops.sparse_expand_ref(fr, None, None, None, tables, (1,), mr,
                                  R1w, cr, 0, False, True,
                                  gate=cr[ell_ops.CTL_MODE:
                                          ell_ops.CTL_MODE + 1],
                                  want=ell_ops.MODE_SPARSE)
        torch.cuda.synchronize()
        if not torch.equal(cand, mr) or bool(cand.any()) != (label ==
                                                              "open"):
            raise AssertionError(f"the gated sparse_expand ({label}) != "
                                 f"its plain version")
        row[f"gated_{label}_ms"] = queued_ms(torch, gated, PROBE_REPS)
        row[f"gated_{label}_event_ms"] = cuda_ms(torch, gated, 50)
    return row


# the run each program's and kernel's kernels-line row comes from: the
# programs and K4, K5 at the headline batch, K6 from its COUNT fold, K7
# and adaptive_go at the default K, the layout change from the K whose
# dense arm runs
ROW_FROM = {"sparse_go": "c0_256_s3_plain",
            "sparse_go_count": "c0_256_s3_count",
            "sparse_go_limit": "c0_256_s3_limit",
            "adaptive_go": "adaptive_K2048_s3",
            "sparse_expand": "c0_256_s3_plain",
            "pair_compact": "c0_256_s3_plain",
            "pair_reduce": "c0_256_s3_count",
            "adaptive_switch": "adaptive_K2048_s3",
            "bitmap_lanes": "adaptive_K8_s3"}


def sparse_launches(hops: int, upto: bool, op: int) -> int:
    """The launches ``sg_program`` is designed to make: the workspace's
    memset, with UPTO the starts' self-mark, per hop K4 and K5 (one
    launch), with UPTO the union's K5, COUNT's output memset, K6
    (LIMIT's three passes, else one)."""
    return (1 + (1 if upto else 0) + 2 * hops + (1 if upto else 0)
            + (1 if op == 1 else 0) + (3 if op == 2 else 1))


def adaptive_launches(hops: int, hub_rows: bool) -> int:
    """The launches ``ad_program`` is designed to make, the gated ones
    included: the workspace's memset, the start list, its self-mark,
    per hop K7, the change to lanes, K4, K5 (one launch), the hop's
    gather and (with hub extra rows) its merge, then the change back."""
    return 3 + hops * (5 + (1 if hub_rows else 0)) + 1


def sparse_kernel_phase(torch, ell_ops, rt, m, ix, tables, eslot, hrows,
                        over, starts) -> tuple:
    """The sparse and adaptive programs against their plain versions on
    the serve tables: the step sequences (``_sparse_go_steps``,
    ``_adaptive_steps``) with every kernel call probed, and the
    programs as the runtime calls them, one C call each (``sparse_go``:
    ``sg_program``; ``adaptive_go``: ``ad_program``), held to the plain
    version, their device time (calls queued behind a spin kernel) and
    event time, and their launches and C calls a call by capture, held
    to the designed counts (``sparse_launches``, ``adaptive_launches``)
    and the kernels' counters to the calls each C call reports
    (``stage_launches``).
    ``starts`` are old dense ids from the serve mix.  Returns ({name:
    numbers}, {run: numbers}): the kernels' rows (ROW_FROM), the
    programs' at the headline (c0 256, 3 steps, an 8-query batch like
    the windowed batches; adaptive: the default K, 3 steps), and every
    run."""
    from nebula_tpu_torch.tpu.ell import sparse_caps
    d_max = max(tables.D)
    ecnt, e0 = rt._hub_expansion_dev(m, ix)
    deg = rt._deg_dev(m, ix, tuple(over))
    R1 = ix.n_rows + 1
    spin_ms = cuda_ms(torch, lambda: torch.cuda._sleep(SPIN_CYCLES), 3, 1)

    # (label, c0, queries, starts, steps, cap, variants): an 8-query
    # batch as the windowed dispatcher forms them, the largest batch
    # (go_batch_max queries), and a tight cap that overflows
    configs = [
        ("c0_256_s3", 256, 8, 8, 3, 1 << 17, ("plain", "upto", "count",
                                               "limit")),
        ("c0_256_s4", 256, 8, 8, 4, 1 << 17, ("plain",)),
        ("c0_256_s3_tight", 256, 8, 8, 3, 8, ("plain",)),
        ("c0_2048_s3", 2048, 1024, 1024, 3, 1 << 17, ("plain", "count")),
        ("c0_2048_s4", 2048, 1024, 1024, 4, 1 << 17, ("plain",)),
    ]
    runs = {}
    # the tight batch starts on the mix's widest vertices, so that it
    # overflows at any graph size
    wide = starts[np.argsort(-rt._deg_host(m, tuple(over))[starts],
                             kind="stable")]
    for label, c0, nq, S, steps, cap, variants in configs:
        chosen = wide if label.endswith("tight") else starts
        ids_h, qid_h = sparse_batch(ix, chosen[:S], c0, nq)
        ids, qid = rt._up(ids_h), rt._up(qid_h)
        caps = sparse_caps(c0, d_max, steps, cap)
        qmax = max(1024, nq)
        for var in variants:
            run_label = f"{label}_{var}"
            kw = dict(upto=var == "upto", count=var == "count",
                      limit=LIMIT_N if var == "limit" else None)
            probes, ctx = sparse_probes(torch, ell_ops, tables, ix)
            out = ell_ops._sparse_go_steps(
                ids, qid, ecnt, e0, deg, tables, tuple(over), steps, caps,
                qmax, nq, kw["upto"], kw["limit"], kw["count"],
                probes["sparse_expand"], probes["pair_compact"],
                probes["pair_reduce"])
            want, plain = timed(torch, lambda: ell_ops.sparse_go_ref(
                ids, qid, ecnt, e0, deg, tables, tuple(over), steps, caps,
                qmax, **kw))
            if int(out[1]) != int(want[1]) or (
                    not int(want[1]) and not torch.equal(out, want)):
                raise AssertionError(f"sparse_go {run_label} != its "
                                     f"plain version")

            def run():
                return ell_ops.sparse_go(ids, qid, ecnt, e0, deg, tables,
                                         tuple(over), steps, caps, qmax,
                                         nq, **kw)
            got = run()
            if int(got[1]) != int(want[1]) or (
                    not int(want[1]) and not torch.equal(got, want)):
                raise AssertionError(f"sparse_go {run_label}: the one-call "
                                     f"program != its plain version")
            for r in range(K5_REPEATS):     # K5's look-back, call after call
                if not torch.equal(run(), got):
                    raise AssertionError(f"sparse_go {run_label}: repeat "
                                         f"{r} differs")
            op = (ell_ops.REDUCE_COUNT if kw["count"] else
                  ell_ops.REDUCE_LIMIT if kw["limit"] is not None else
                  ell_ops.REDUCE_EMIT)
            name = ("sparse_go_count" if var == "count" else
                    "sparse_go_limit" if var == "limit" else "sparse_go")
            k45 = steps - 1 + (1 if kw["upto"] else 0)
            counts = stage_launches(
                torch, ell_ops, run,
                sparse_launches(steps - 1, kw["upto"], op),
                {name: 1, "sparse_expand": k45, "pair_compact": k45,
                 "pair_reduce": 1}, run_label)
            ms, enqueue_ms = queued_times(torch, run, PROBE_REPS)
            event_ms = cuda_ms(torch, run, 20, 2)
            prog_bytes = 8 * c0 + 8 * ctx.get("slots", 0) \
                + 4 * out.numel()
            kernels = {k: p.numbers() for k, p in probes.items()
                       if p.calls}
            if "padded_read_bytes" in ctx:
                kernels["pair_reduce"]["padded_read_bytes"] = \
                    ctx["padded_read_bytes"]
            runs[run_label] = dict(
                name=name, max_abs_err=0, ms=ms, plain_ms=plain,
                bound_ms=bytes_ms(prog_bytes), bound_by="bytes",
                library_ms=None, event_ms=event_ms, enqueue_ms=enqueue_ms,
                kernels_device_ms=sum(p.k_ms for p in probes.values()),
                **counts,
                overflow=int(want[1]),
                count=int(want[0]), caps=list(caps), queries=nq, starts=S,
                steps=steps, kernels=kernels)
    flags_seen = {r["overflow"] for r in runs.values()}
    if flags_seen != {0, 1}:
        raise AssertionError(f"sparse runs saw overflow flags {flags_seen}, "
                             f"not both")

    # ---- adaptive: one start of the mix with 16 to 128 out-edges, the
    # default K and a K that its first hop outgrows
    hub = rt._hub_dev(m, ix)
    deg_h = rt._deg_host(m, tuple(over))[starts]
    pick = np.nonzero((deg_h > 16) & (deg_h <= 128))[0]
    first = int(starts[pick[0] if len(pick) else 0])
    start = rt._up(ix.perm[np.asarray([first], np.int64)].astype(np.int32))
    dev = start.device
    switched = {}
    for K in (2048, 8):
        for steps in (3, 4):
            label = f"adaptive_K{K}_s{steps}"
            probes, ctx = sparse_probes(torch, ell_ops, tables, ix)
            out = ell_ops._adaptive_steps(
                start, hub, tables, eslot, hrows, tuple(over), steps, K,
                probes["sparse_expand"], probes["pair_compact"],
                probes["adaptive_switch"], probes["bitmap_lanes"],
                probes["go_hop"])
            want, plain = timed(torch, lambda: ell_ops.adaptive_go_ref(
                start, hub, tables, eslot, hrows, tuple(over), steps, K))
            keep = torch.ones(out.numel() * 8, dtype=torch.bool, device=dev)
            keep[ix.n:R1 - 1] = False            # hub extra rows: junk
            bits = ell_ops._unpack_ref(out[None, :])[0][:keep.numel()]
            wbits = ell_ops._unpack_ref(want[None, :])[0][:keep.numel()]
            if not torch.equal(bits[keep], wbits[keep]):
                raise AssertionError(f"adaptive_go K={K} steps={steps} != "
                                     f"its plain version")
            # the dense arm ran: the layout change was launched
            dense = probes["bitmap_lanes"].calls > 0
            switched[(K, steps)] = dense

            def run_a():
                return ell_ops.adaptive_go(start, hub, tables, eslot, hrows,
                                           tuple(over), steps, K)
            got = run_a()
            gbits = ell_ops._unpack_ref(got[None, :])[0][:keep.numel()]
            if not torch.equal(gbits[keep], wbits[keep]):
                raise AssertionError(f"adaptive_go K={K} steps={steps}: the "
                                     f"one-call program != its plain "
                                     f"version")
            got = got.clone()
            for r in range(K5_REPEATS):     # K5's look-back, call after call
                if not torch.equal(run_a(), got):
                    raise AssertionError(f"adaptive_go K={K} steps={steps}: "
                                         f"repeat {r} differs")
            hops = steps - 1
            counts = stage_launches(
                torch, ell_ops, run_a,
                adaptive_launches(hops, ix.n_rows > ix.n),
                {"adaptive_go": 1, "sparse_expand": 1 + hops,
                 "pair_compact": hops, "adaptive_switch": hops,
                 "bitmap_lanes": hops + 1, "go_hop": hops}, label)
            ms, enqueue_ms = queued_times(torch, run_a, PROBE_REPS)
            event_ms = cuda_ms(torch, run_a, 20, 2)
            prog_bytes = sum(p.bytes for k, p in probes.items()
                             if k in ("sparse_expand", "go_hop")) \
                + (R1 + 7) // 8
            runs[label] = dict(
                name="adaptive_go", max_abs_err=0, ms=ms, plain_ms=plain,
                bound_ms=bytes_ms(prog_bytes), bound_by="bytes",
                library_ms=None, event_ms=event_ms, enqueue_ms=enqueue_ms,
                kernels_device_ms=sum(p.k_ms for p in probes.values()),
                **counts,
                dense_switch=dense, K=K, steps=steps,
                kernels={k: p.numbers() for k, p in probes.items()
                         if p.calls})
    if not (switched[(8, 3)] and switched[(8, 4)]):
        raise AssertionError(f"the small K did not force the dense arm: "
                             f"{switched}")
    late = {f"{label}.{k}": v["enqueue_ms"] for label, r in runs.items()
            for k, v in r["kernels"].items() if v["enqueue_ms"] >= spin_ms}
    late.update({label: r["enqueue_ms"] for label, r in runs.items()
                 if r["enqueue_ms"] >= spin_ms})
    log(f"[kernel] spin {spin_ms:.3f} ms; calls whose host enqueue "
        f"outlasted it (their ms include host time): {late or 'none'}")
    kernel_rows = {}
    for k, label in ROW_FROM.items():
        row = runs[label]["kernels"][k] if k in runs[label]["kernels"] \
            else {a: b for a, b in runs[label].items()
                  if a not in ("kernels", "name")}
        kernel_rows[k] = dict(row, run=label)
    return kernel_rows, runs


K5_REPEATS = 50                # repeated K5 calls on one look-back state


def k5_cases(torch, ell_ops, words: int, row_words: int, dev, rng,
             rows: int = None) -> dict:
    """K5's edge cases on a bitmap of ``words`` words, rows of
    ``row_words`` words (``rows``: the valid bits a row, all when None):
    {case: (bitmap, c_out)} — an empty bitmap; set bits only in the last
    chunk (the kernel's chunk for this size, ``ell_ops.compact_chunk``);
    one bit a word with the cap inside a chunk and on a chunk's edge; a
    random one with the cap past its count."""
    chunk = ell_ops.compact_chunk(words)
    valid = torch.ones(words, dtype=torch.int64, device=dev)
    if rows is not None:            # a row's bits past ``rows`` stay clear
        w_in = torch.arange(words, device=dev) % row_words
        n_ok = (rows - 32 * w_in).clamp(0, 32)
        valid = torch.where(n_ok >= 32, torch.full_like(n_ok, -1),
                            (1 << n_ok) - 1)
    ok = lambda x: (x & valid).to(torch.int32)      # noqa: E731
    last = torch.zeros(words, dtype=torch.int64, device=dev)
    lo = (-(-words // chunk) - 1) * chunk
    at = torch.from_numpy(rng.integers(lo, words, 40)).to(dev)
    last[at] = torch.from_numpy(rng.integers(1, 2**31, 40)).to(dev)
    ones = ok(torch.ones(words, dtype=torch.int64, device=dev))
    rnd = torch.from_numpy(rng.integers(0, 2**31, words)).to(dev) \
        & torch.from_numpy((rng.random(words) < 0.02).astype(np.int64) *
                           0x01000101).to(dev)
    return {"empty": (torch.zeros(words, dtype=torch.int32, device=dev),
                      4 * chunk),
            "last_chunk": (ok(last), 4 * chunk),
            "cap_inside_chunk": (ones, chunk + chunk // 2),
            "cap_on_chunk_edge": (ones, 2 * chunk),
            "random": (ok(rnd), 4 * chunk)}


def _held(torch, name, a, b) -> None:
    for i, (x, y) in enumerate(zip(a, b)):
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            raise AssertionError(f"K5 {name}: operand {i} differs from "
                                 f"its plain version")


def k5_caller_check(torch, ell_ops, ix, tables, rng) -> dict:
    """K5 (one launch a call) held bit for bit to ``pair_compact_ref``
    in the form each of its callers launches it, on ``k5_cases``: the
    standalone ``sg_compact`` (its own zeroed state); ``sg_program``'s
    (the mark, the UPTO union and the look-back state in one workspace
    laid out by ``_sparse_plan``, two hops on one state, then the
    union's compaction) at 8 and 1024 queries (about 8,200 chunks of
    2048 words); ``ad_program``'s, gated on the mode word (held to the
    plain version when the word says sparse, and to touching nothing
    when it says dense); ``mesh_dedup``'s (4 shards of the serve graph
    on this card, X2 from receive blocks holding each case's bits, K5
    with the row bases and the clears).  Each form also runs the random
    case K5_REPEATS times on one state, every call held to the plain
    version.  Returns the cases and calls held per form."""
    from nebula_tpu_torch.tpu.ell import (build_sharded_ell, sharded_tables,
                                          sparse_caps)
    from nebula_tpu_torch.tpu.mesh import PartsMesh
    dev = tables.nbr.device
    R1 = ix.n_rows + 1
    R1w = ell_ops._words(R1)
    out = {}

    def hold(name, fn, ref, args, reps=1):
        for _ in range(reps):
            a = [x.clone() if isinstance(x, torch.Tensor) else x
                 for x in args]
            b = [x.clone() if isinstance(x, torch.Tensor) else x
                 for x in args]
            fn(*a)
            ref(*b)
            torch.cuda.synchronize()
            _held(torch, name, a[:12], b[:12])
        return reps

    # ---- sg_compact alone, and sg_program's form, at 8 and 1024 queries
    for nq, c0 in ((8, 256), (1024, 2048)):
        words = nq * R1w
        caps = sparse_caps(c0, max(tables.D), 3, 1 << 17)
        pl = ell_ops._sparse_plan(c0, tuple(caps), 1024, nq, ix.n,
                                  ix.n_rows, True, None, False)
        held = {"sg_compact": 0, "sg_program": 0}
        for case, (bm, c_out) in k5_cases(torch, ell_ops, words, R1w, dev,
                                          rng).items():
            ids = torch.full((c_out,), -7, dtype=torch.int32, device=dev)
            ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64,
                              device=dev)
            args = [bm, R1w, c_out, ids, ids.clone(), ctl, -1, ix.n_rows]
            reps = K5_REPEATS if case == "random" else 1
            held["sg_compact"] += hold(f"sg_compact {case} nq={nq}",
                                       ell_ops.pair_compact,
                                       ell_ops.pair_compact_ref, args, reps)
            # the program's workspace: one state for every K5 call
            ws = torch.empty(pl.words, dtype=torch.int32, device=dev)
            ws[:pl.zero].zero_()
            mark = ws[pl.mark:pl.mark + words]
            uni = ws[pl.uni:pl.uni + words]
            scan = ws[pl.scan:pl.zero].view(torch.int64)
            ref_uni = uni.clone()
            cap = max(c_out, pl.c_fin)
            bufs = torch.full((2, cap), -7, dtype=torch.int32, device=dev)
            rbufs = bufs.clone()
            for call in range(2 + reps):
                last = call == 1 + reps          # the union's compaction
                src = uni if last else mark
                if not last:
                    mark.copy_(bm)
                ref_src = ref_uni.clone() if last else bm.clone()
                c = c_out if not last else pl.c_fin
                ctl.zero_()
                rctl = ctl.clone()
                ell_ops.pair_compact(src, R1w, c, bufs[0], bufs[1], ctl, -1,
                                     ix.n_rows, None if last else uni,
                                     None, not last, 0, scan)
                ell_ops.pair_compact_ref(ref_src, R1w, c, rbufs[0],
                                         rbufs[1], rctl, -1, ix.n_rows,
                                         None if last else ref_uni, None,
                                         not last)
                torch.cuda.synchronize()
                _held(torch, f"sg_program {case} nq={nq} call {call}",
                      (src, bufs, ctl, uni), (ref_src, rbufs, rctl, ref_uni))
                held["sg_program"] += 1
            del ws
        out[f"nq{nq}"] = dict(held, words=words,
                              chunks=-(-words // ell_ops.compact_chunk(words)))

    # ---- ad_program's form: gated, the state copied, K ids, no qid
    pl = ell_ops._adaptive_plan(R1, 2048, 2)
    held = {"gated_on": 0, "gated_off": 0}
    for case, (bm, K) in k5_cases(torch, ell_ops, R1w, R1w, dev,
                                  rng).items():
        for mode in (ell_ops.MODE_SPARSE, ell_ops.MODE_DENSE):
            ws = torch.empty(pl.words, dtype=torch.int32, device=dev)
            ws[:pl.zero].zero_()
            scan = ws[pl.scan:pl.zero].view(torch.int64)
            reps = K5_REPEATS if case == "random" else 1
            for _ in range(reps):
                cand = bm.clone()
                state = torch.full((R1w,), 7, dtype=torch.int32, device=dev)
                fr = torch.full((K,), -3, dtype=torch.int32, device=dev)
                ctl = torch.zeros(ell_ops.CTL_SIZE, dtype=torch.int64,
                                  device=dev)
                ctl[ell_ops.CTL_MODE] = mode
                before = [x.clone() for x in (cand, state, fr, ctl)]
                ell_ops.pair_compact(cand, R1w, K, fr, None, ctl, -1,
                                     ix.n_rows, None, state, True, 0, scan,
                                     ctl[ell_ops.CTL_MODE:ell_ops.CTL_MODE
                                         + 1], ell_ops.MODE_SPARSE)
                want = [x.clone() for x in before]
                if mode == ell_ops.MODE_SPARSE:
                    ell_ops.pair_compact_ref(want[0], R1w, K, want[2], None,
                                             want[3], -1, ix.n_rows, None,
                                             want[1], True)
                torch.cuda.synchronize()
                _held(torch, f"ad_program {case} mode {mode}",
                      (cand, state, fr, ctl), want)
                held["gated_on" if mode == ell_ops.MODE_SPARSE
                     else "gated_off"] += 1
    out["ad_program"] = dict(held, words=R1w)

    # ---- mesh_dedup's form: 4 shards on this card, X2 then K5
    k, qmax = 4, 128
    st = sharded_tables(build_sharded_ell(ix, k), PartsMesh([dev] * k))
    g = st.mesh.groups[0]
    W = ell_ops._words(st.chunk)
    words = qmax * W
    held = 0
    for case, (bm, c_out) in k5_cases(torch, ell_ops, words, W, dev, rng,
                                      rows=st.chunk).items():
        # each member's bits as keys (q, its base + row), in the receive
        # blocks from every source shard in turn
        idx = torch.nonzero(ell_ops._bits_of(bm)).reshape(-1)
        q, row = idx // (W * 32), idx % (W * 32)
        per = -(-max(idx.numel(), 1) // k)
        recv = torch.zeros((k, k, 1 + per), dtype=torch.int64, device=dev)
        for y in range(k):
            keys = (q << 32) | (y * st.chunk + row)
            for s_ in range(k):
                part = keys[s_ * per:(s_ + 1) * per]
                recv[y, s_, 0] = part.numel()
                recv[y, s_, 1:1 + part.numel()] = part
        marks = torch.zeros((k, words), dtype=torch.int32, device=dev)
        scan = torch.zeros((k, ell_ops.compact_state_words(words)),
                           dtype=torch.int64, device=dev)
        reps = K5_REPEATS if case == "random" else 1
        for _ in range(reps):
            ids = torch.full((k, c_out), -7, dtype=torch.int32, device=dev)
            ctl = torch.zeros((k, ell_ops.CTL_SIZE), dtype=torch.int64,
                              device=dev)
            a = [recv.clone(), st, g, marks, c_out, ids, ids.clone(), ctl]
            b = [x.clone() if isinstance(x, torch.Tensor) else x for x in a]
            ell_ops.mesh_dedup(*a, None, None, None, scan)
            ell_ops.mesh_dedup_ref(*b)
            torch.cuda.synchronize()
            _held(torch, f"mesh_dedup {case}", a, b)
            held += 1
    out["mesh_dedup"] = dict(calls=held, words_a_member=words, members=k)
    return out


# ============================================================ phase 4
def request_mix(rng, n: int, requests: int):
    """The serve traffic: one start vid each, 2-4 steps, a quarter UPTO;
    every 4-step request and a quarter of the rest end in COUNT(*)."""
    starts = rng.integers(1, n + 1, requests)
    steps = rng.integers(2, 5, requests)
    upto = rng.random(requests) < 0.25
    count = (steps == 4) | (rng.random(requests) < 0.25)
    return starts, steps, upto, count


def drive_calls(call, reqs, threads: int, keep):
    """``call(req)`` for every request from ``threads`` client threads.
    Returns (wall s, latency s a request, {i: answer} for i in
    ``keep``); raises if any request declined or failed."""
    kept = {}
    lat = np.zeros(len(reqs))
    errors = []
    next_i = [0]
    lock = threading.Lock()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                next_i[0] += 1
            if i >= len(reqs):
                return
            t0 = time.perf_counter()
            try:
                out = call(reqs[i])
            except Exception as ex:     # noqa: BLE001 — raised below
                with lock:
                    errors.append(f"request {i} {reqs[i]}: {ex!r}")
                return
            lat[i] = time.perf_counter() - t0
            if i in keep:
                kept[i] = out

    pool = [threading.Thread(target=worker, name=f"smoke-props-{k}")
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


def drive(rt, mix, threads: int, keep=frozenset(), limits=None):
    """Serve every request of ``mix`` through ``serve_go`` from
    ``threads`` client threads (request i ends in ``| LIMIT LIMIT_N``
    where ``limits[i]``).  Returns (wall seconds, per-request latency
    seconds, {i: answer} for i in ``keep``); raises if any request
    failed."""
    starts, steps, upto, count = mix
    return drive_calls(
        lambda i: rt.serve_go(1, [int(starts[i])], [1], int(steps[i]),
                              {1: "e"}, upto=bool(upto[i]),
                              reduce=("count",) if count[i] else None,
                              limit=LIMIT_N if limits is not None
                              and limits[i] else None),
        range(len(starts)), threads, keep)


def check_go(oracle: GoOracle, mix, results, check, limits=None) -> list:
    """Hold the kept answers to the oracle (a LIMIT request: min(LIMIT_N,
    total) rows, each one of the full answer's, counted with their
    multiplicity); returns the edges each traversed."""
    starts, steps, upto, count = mix
    traversed = []
    for i in sorted(check):
        want, tr = oracle.go([int(starts[i])], int(steps[i]),
                             bool(upto[i]))
        traversed.append(tr)
        cols, rows = results[i]
        if limits is not None and limits[i]:
            got = np.asarray([r[0] for r in rows], np.int64)
            vals, n_want = np.unique(want, return_counts=True)
            gv, n_got = np.unique(got, return_counts=True)
            pos = np.searchsorted(vals, gv)
            if cols != ["e._dst"] or len(got) != min(LIMIT_N, len(want)) \
                    or (pos >= len(vals)).any() \
                    or (vals[np.minimum(pos, len(vals) - 1)] != gv).any() \
                    or (n_got > n_want[np.minimum(pos, len(vals) - 1)]).any():
                raise AssertionError(f"request {i}: LIMIT {LIMIT_N} rows "
                                     f"are not a cut of the oracle's")
            continue
        if count[i]:
            if cols != ["__count__"] or rows != [[len(want)]]:
                raise AssertionError(f"request {i}: count {rows} != "
                                     f"{len(want)}")
        else:
            got = np.sort(np.asarray([r[0] for r in rows], np.int64))
            if cols != ["e._dst"] or not np.array_equal(got, want):
                raise AssertionError(f"request {i}: rows differ from the "
                                     f"oracle ({len(got)} vs {len(want)})")
    return traversed


def require_launched(launches: dict, phase: str) -> None:
    for k in PATH_KERNELS[phase]:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was never launched on the {phase} "
                                 f"path")


def serve_phase(torch, rt, ell_ops, oracle: GoOracle, n: int,
                requests: int, threads: int, seed: int) -> dict:
    """The main path, counted: every launch count is zeroed just before
    the requests and read just after; 64 answers are checked exactly
    against the oracle.  Returns the numbers."""
    rng = np.random.default_rng(seed + 1)
    mix = request_mix(rng, n, requests)
    check = set(rng.choice(requests, min(64, requests),
                           replace=False).tolist())
    # warm the stream (session anchor, table upload) outside the window
    rt.serve_go(1, [1], [1], 2, {1: "e"})
    torch.cuda.synchronize()
    ell_ops.reset_launches()
    with extract_patterns() as patterns:
        wall, lat, results = drive(rt, mix, threads, check)
    launches = dict(ell_ops.LAUNCHES)
    traversed = check_go(oracle, mix, results, check)
    require_launched(launches, "serve")
    st = rt.continuous.streams()[0].stats
    qps = requests / wall
    return dict(requests=requests, threads=threads, wall_s=wall, qps=qps,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                checked=len(check),
                edges_traversed_per_query=float(np.mean(traversed)),
                edges_traversed_per_s=float(np.mean(traversed)) * qps,
                launches=launches, stream=dict(st),
                runtime=dict(rt.stats), extracts=patterns)


@contextlib.contextmanager
def extract_patterns():
    """Inside: every extract the continuous session makes is recorded on
    the host (its (word, sel) pairs as the session lays them out: one
    pair a leaving (lane byte, UPTO) class, padded to P, a power of two
    >= 8, with (0, exact)), at no cost to the card.  Yields a list that
    holds, on exit, (W, words, sel) a call."""
    from nebula_tpu_torch.tpu.runtime import _ContinuousGoSession
    seen = []
    real = _ContinuousGoSession.extract

    def extract(self, leavers):
        pairs = {}
        for lane, upto in leavers:
            pairs.setdefault((lane >> 3, bool(upto)), len(pairs))
        P = max(8, 1 << (len(pairs) - 1).bit_length())
        words = np.zeros(P, np.int32)
        sel = np.zeros(P, np.uint8)
        for (w, u), j in pairs.items():
            words[j], sel[j] = w, u
        seen.append((self.W, words, sel))
        return real(self, leavers)
    _ContinuousGoSession.extract = extract
    try:
        yield seen
    finally:
        _ContinuousGoSession.extract = real


def serve_extract_rows(torch, ell_ops, ix, patterns, rng, dev) -> dict:
    """The serve phase's extracts: how many of each (W, P, 16-byte units
    of a row its words touch), and the kernel timed (``extract_time``)
    on a 2 %-live carrier pair at that W on the commonest pattern and on
    the one that touches the most units."""
    if not patterns:
        raise AssertionError("the serve phase made no extract")
    hist = {}
    for W, w, s in patterns:
        key = (int(W), len(w), extract_units(w, s)["units16"])
        hist[key] = hist.get(key, 0) + 1
    common = max(hist, key=hist.get)
    widest = max(hist, key=lambda k: (k[2], hist[k]))
    out = dict(calls=len(patterns), by_width_p_units16={
        f"{W}/{P}/{u}": c for (W, P, u), c in sorted(hist.items())})
    R1 = ix.n_rows + 1
    for label, key in (("commonest", common), ("widest", widest)):
        W, w, s = next(p for p in patterns
                       if (int(p[0]), len(p[1]),
                           extract_units(p[1], p[2])["units16"]) == key)
        fp_h = np.zeros((R1, W), np.uint8)
        live = rng.random(ix.n) < 0.02
        fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                         dtype=np.uint8)
        acc_h = fp_h | (rng.integers(0, 256, (R1, W), dtype=np.uint8)
                        & (rng.random((R1, 1)) < 0.02).astype(np.uint8)
                        * 255)
        acc_h[-1] = 0
        fp0 = torch.from_numpy(fp_h).to(dev)
        acc0 = torch.from_numpy(acc_h).to(dev)
        out[label] = dict(W=W, words=w.tolist(), sel=s.tolist(),
                          **extract_time(torch, ell_ops, fp0, acc0, w, s,
                                         f"serve {label}"))
    return out


WINDOWED = {"go_dispatch_mode": "windowed", "tpu_sparse_go": False,
            "tpu_adaptive_single": False}
SPARSE = {"go_dispatch_mode": "windowed"}      # the rest at defaults
ADAPTIVE = {"go_dispatch_mode": "windowed", "tpu_sparse_go": False}


@contextlib.contextmanager
def flag_mode(flags, values):
    """``values`` set on the port's flags, restored on exit."""
    old = {k: flags.get(k) for k in values}
    for k, v in values.items():
        flags.set(k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            flags.set(k, v)



def windowed_phase(torch, rt, ell_ops, flags, oracle: GoOracle, n: int,
                   requests: int, threads: int, seed: int) -> dict:
    """Phase 4's request mix (same seed) through the windowed dispatcher
    and the dense ``ell_go`` route, counted and checked the same way."""
    rng = np.random.default_rng(seed + 1)
    mix = request_mix(rng, n, requests)
    check = set(rng.choice(requests, min(64, requests),
                           replace=False).tolist())
    with flag_mode(flags, WINDOWED):
        # warm the count fold's degree vector outside the window
        rt.serve_go(1, [1], [1], 2, {1: "e"}, reduce=("count",))
        torch.cuda.synchronize()
        before = dict(rt.dispatcher.stats)
        rt0 = dict(rt.stats)
        ell_ops.reset_launches()
        wall, lat, results = drive(rt, mix, threads, check)
        launches = dict(ell_ops.LAUNCHES)
    traversed = check_go(oracle, mix, results, check)
    require_launched(launches, "windowed")
    batches = rt.dispatcher.stats["batches"] - before["batches"]
    queries = (rt.dispatcher.stats["batched_queries"]
               - before["batched_queries"])
    qps = requests / wall
    return dict(requests=requests, threads=threads, wall_s=wall, qps=qps,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                checked=len(check),
                edges_traversed_per_query=float(np.mean(traversed)),
                edges_traversed_per_s=float(np.mean(traversed)) * qps,
                batches=batches, mean_batch=queries / max(batches, 1),
                max_batch=rt.dispatcher.stats["max_batch"],
                launches=launches,
                runtime={k: rt.stats[k] - rt0[k] for k in rt0})


def sparse_phase(torch, rt, ell_ops, flags, oracle: GoOracle, n: int,
                 requests: int, threads: int, seed: int) -> dict:
    """The serve mix's kinds on another seed, windowed with every other
    flag at its default: the sparse route (COUNT and LIMIT pushed down,
    wide batches split, overflowing batches rerun dense).  A quarter of
    the plain exact-depth requests end in ``| LIMIT LIMIT_N``.  Counted
    and checked as phase 5."""
    rng = np.random.default_rng(seed + 11)
    mix = request_mix(rng, n, requests)
    _starts, _steps, upto, count = mix
    limits = ~upto & ~count & (rng.random(requests) < 0.25)
    # 64 checked: a quarter of them LIMIT requests, the rest the others
    lim_i, rest_i = np.nonzero(limits)[0], np.nonzero(~limits)[0]
    n_lim = min(16, len(lim_i))
    check = set(rng.choice(lim_i, n_lim, replace=False).tolist()) | set(
        rng.choice(rest_i, min(64 - n_lim, len(rest_i)),
                   replace=False).tolist())
    with flag_mode(flags, SPARSE):
        # warm the degree and hub tables outside the window
        rt.serve_go(1, [1], [1], 3, {1: "e"}, reduce=("count",))
        rt.serve_go(1, [1], [1], 3, {1: "e"}, limit=LIMIT_N)
        torch.cuda.synchronize()
        before = dict(rt.dispatcher.stats)
        rt0 = dict(rt.stats)
        ell_ops.reset_launches()
        wall, lat, results = drive(rt, mix, threads, check, limits)
        launches = dict(ell_ops.LAUNCHES)
    traversed = check_go(oracle, mix, results, check, limits)
    require_launched(launches, "sparse")
    stats = {k: rt.stats[k] - rt0[k] for k in rt0}
    batches = rt.dispatcher.stats["batches"] - before["batches"]
    queries = (rt.dispatcher.stats["batched_queries"]
               - before["batched_queries"])
    qps = requests / wall
    return dict(requests=requests, threads=threads, wall_s=wall, qps=qps,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                checked=len(check),
                checked_limit=int(sum(limits[i] for i in check)),
                limit_requests=int(limits.sum()),
                edges_traversed_per_query=float(np.mean(traversed)),
                edges_traversed_per_s=float(np.mean(traversed)) * qps,
                batches=batches, mean_batch=queries / max(batches, 1),
                go_sparse=stats["go_sparse"],
                sparse_overflows=stats["sparse_overflows"],
                go_sparse_split=stats["go_sparse_split"],
                go_dense=stats["go_dense"],
                overflow_share=stats["sparse_overflows"]
                / max(stats["go_sparse"], 1),
                launches=launches, runtime=stats)


def adaptive_switches(oracle: GoOracle, hub_old: np.ndarray, m, start,
                      steps: int, K: int) -> bool:
    """Whether the adaptive program runs a dense hop for this request
    (ell.py:1593): before each hop a hub in the frontier, or a previous
    sparse hop whose result passed K ids, sends it dense."""
    sizes = oracle.frontier_sizes([start], steps)
    sparse = True
    for h in range(steps - 1):
        d = m.to_dense(sizes[h])
        if sparse and not hub_old[d[d >= 0]].any():
            if len(sizes[h + 1]) > K:
                sparse = False
        else:
            return True
    return False


def adaptive_phase(torch, rt, ell_ops, flags, oracle: GoOracle, n: int,
                   requests: int, seed: int) -> dict:
    """``requests`` single-start plain GO requests at 2-4 steps, one
    after another from one thread, windowed with tpu_sparse_go=false:
    each rides the adaptive route alone.  A sixteenth of them start on
    a hub (the hubs of least out-degree, at 2 steps), so that the
    program's dense arm runs on this path.  64 checked against the
    oracle, 8 of them hub starts.  The program chooses its arm on the
    card and its host reads nothing a call; the requests that ran a
    dense hop are counted on the card (K7 adds one to
    ``ell_ops.adaptive_dense_tally`` when a call turns dense; zeroed
    before the drive, read once after it), and the count must equal the
    oracle's prediction (``adaptive_switches``), which holds every hub
    start; the checked hub starts show that the dense arm answered them
    (the sparse arm pushes no hub extra row, so a hub start it served
    would miss edges)."""
    rng = np.random.default_rng(seed + 13)
    starts = rng.integers(1, n + 1, requests)
    steps = rng.integers(2, 5, requests)
    m = rt.mirror(1)
    ix = rt.ell(m)
    hub_old = ix.hub_table()[ix.perm]
    out_deg = rt._deg_host(m, (1,))
    pool = np.nonzero(hub_old & (out_deg > 0))[0]
    if not len(pool):
        raise AssertionError("the graph has no hub to start from")
    pool = m.vids[pool[np.argsort(out_deg[pool], kind="stable")[:64]]]
    at_hub = rng.choice(requests, max(1, requests // 16), replace=False)
    starts[at_hub] = rng.choice(pool, len(at_hub))
    steps[at_hub] = 2
    none = np.zeros(requests, dtype=bool)
    mix = (starts, steps, none, none)
    n_hub_check = min(8, len(at_hub))
    rest = np.setdiff1d(np.arange(requests), at_hub)
    check = set(rng.choice(at_hub, n_hub_check, replace=False).tolist()) \
        | set(rng.choice(rest, min(64 - n_hub_check, len(rest)),
                         replace=False).tolist())
    tally = ell_ops.adaptive_dense_tally(rt.device)
    with flag_mode(flags, ADAPTIVE):
        rt.serve_go(1, [1], [1], 3, {1: "e"})
        torch.cuda.synchronize()
        rt0 = dict(rt.stats)
        ell_ops.reset_launches()
        tally.zero_()
        torch.cuda.synchronize()
        wall, lat, results = drive(rt, mix, 1, check)
        launches = dict(ell_ops.LAUNCHES)
        torch.cuda.synchronize()
        went_dense = int(tally[0])
    traversed = check_go(oracle, mix, results, check)
    require_launched(launches, "adaptive")
    stats = {k: rt.stats[k] - rt0[k] for k in rt0}
    if stats["go_adaptive"] != requests:
        raise AssertionError(f"{stats['go_adaptive']} of {requests} "
                             f"requests rode the adaptive route")
    K = int(flags.get("tpu_adaptive_k") or 2048)
    switches = [adaptive_switches(oracle, hub_old, m, int(starts[i]),
                                  int(steps[i]), K)
                for i in range(requests)]
    dense = int(sum(switches))
    if dense < len(at_hub) or not all(switches[i] for i in at_hub):
        raise AssertionError(f"{dense} requests predicted to run a dense "
                             f"hop, and not every one of the "
                             f"{len(at_hub)} hub starts")
    if went_dense < len(at_hub) or went_dense != dense:
        raise AssertionError(f"{went_dense} requests ran a dense hop on "
                             f"the card; {len(at_hub)} hub starts, "
                             f"{dense} predicted by the oracle")
    checked_dense = sum(switches[i] for i in check)
    qps = requests / wall
    return dict(requests=requests, threads=1, wall_s=wall, qps=qps,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                checked=len(check), hub_starts=len(at_hub),
                checked_hub_starts=n_hub_check,
                dense_requests=went_dense, dense_requests_predicted=dense,
                checked_dense_switch=int(checked_dense),
                edges_traversed_per_query=float(np.mean(traversed)),
                go_adaptive=stats["go_adaptive"], launches=launches,
                runtime=stats)


def drive_paths(rt, srcs, dsts, threads: int):
    """``FIND SHORTEST PATH FROM srcs[i] TO dsts[i] OVER e UPTO 5 STEPS``
    from ``threads`` client threads; no request starts once the drive
    passes PATH_PHASE_S.  Returns (wall seconds, {i: latency s},
    {i: answer}); raises if any request failed."""
    results, lat = {}, {}
    errors = []
    next_i = [0]
    lock = threading.Lock()
    t_start = time.perf_counter()

    def worker():
        while True:
            with lock:
                i = next_i[0]
                next_i[0] += 1
            if i >= len(srcs) or \
                    time.perf_counter() - t_start > PATH_PHASE_S:
                return
            t0 = time.perf_counter()
            try:
                out = rt.serve_find_path(1, [int(srcs[i])], [int(dsts[i])],
                                         [1], 5, True, {1: "e"})
            except Exception as ex:     # noqa: BLE001 — raised below
                with lock:
                    errors.append(f"request {i}: {ex!r}")
                return
            with lock:
                lat[i] = time.perf_counter() - t0
                results[i] = out

    pool = [threading.Thread(target=worker, name=f"smoke-path-{k}")
            for k in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    wall = time.perf_counter() - t_start
    if errors:
        raise AssertionError(f"{len(errors)} requests failed: {errors[:3]}")
    return wall, lat, results


@contextlib.contextmanager
def uncounted(ell_ops):
    """Launches made inside are left out of ``ell_ops.LAUNCHES``."""
    before = dict(ell_ops.LAUNCHES)
    try:
        yield
    finally:
        ell_ops.LAUNCHES.update(before)


def bfs_plain_check(torch, ell_ops, rt, srcs, dsts, kind: str) -> dict:
    """One batch of a phase's FIND SHORTEST PATH requests (UPTO 5) through
    the phase's BFS program as ``rt._bfs_depths`` uploads it (``path``:
    ``ell_bfs``; ``unpacked``: ``ell_bfs_i8``; ``mesh``:
    ``ell_bfs_sharded``), held bit for bit, with its levels, to the
    program's plain version; its launches, the two uploads included,
    left uncounted."""
    m = rt.mirror(1)
    ix = rt.ell(m)
    nq = len(srcs)
    B = rt._batch_width(nq)
    up = rt._upload_frontier if kind == "unpacked" \
        else rt._upload_frontier_packed
    with uncounted(ell_ops):
        f0, t0 = (up(ix, *rt._flat_coords(m, ix, [[int(v)] for v in vs],
                                          nq), B) for vs in (srcs, dsts))
        if kind == "mesh":
            mt = rt._mesh_tables(m, ix)
            args = (mt, *rt._hub_merge_shards(m, ix, mt.mesh), (1,), 5)
            got = ell_ops.ell_bfs_sharded(f0, t0, *args)
            want = ell_ops.ell_bfs_sharded_ref(f0, t0, *args)
        else:
            prog, ref = (ell_ops.ell_bfs_i8, ell_ops.ell_bfs_i8_ref) \
                if kind == "unpacked" else (ell_ops.ell_bfs,
                                            ell_ops.ell_bfs_ref)
            args = (rt._device_tables(m, ix), *rt._hub_merge_dev(m, ix),
                    (1,), 5)
            got = prog(f0.clone(), t0, *args)
            want = ref(f0.clone(), t0, *args)
        require_equal(torch, f"[{kind}] BFS program", B, (got[0], want[0]))
    if got[1] != want[1]:
        raise AssertionError(f"[{kind}] BFS program ran {got[1]} levels, "
                             f"plain {want[1]}")
    return dict(queries=nq, lanes=B, levels=got[1],
                dtype=str(got[0].dtype).split(".")[-1], equal=True)


def path_phase(torch, rt, ell_ops, oracle: PathOracle, vids: np.ndarray,
               requests: int, threads: int, seed: int) -> dict:
    """FIND SHORTEST PATH traffic, counted: ``requests`` (1 src, 1 dst,
    UPTO 5 STEPS) from ``threads`` threads, issuing stopped once the
    phase passes PATH_PHASE_S; 64 checked against the oracle (the depth
    row over every vertex, then the paths), then a checked sample of
    FIND ALL PATH UPTO 3 STEPS."""
    rng = np.random.default_rng(seed + 3)
    srcs = rng.choice(vids, requests)
    dsts = rng.choice(vids, requests)
    check = set(rng.choice(requests, min(64, requests),
                           replace=False).tolist())
    names = {1: "e"}
    rt.serve_find_path(1, [int(srcs[0])], [int(dsts[0])], [1], 5, True,
                       names)
    torch.cuda.synchronize()
    rt0 = dict(rt.stats)
    before = dict(rt.dispatcher.stats)
    ell_ops.reset_launches()
    wall, lat, results = drive_paths(rt, srcs, dsts, threads)
    launches = dict(ell_ops.LAUNCHES)
    require_launched(launches, "path")
    plain_held = bfs_plain_check(torch, ell_ops, rt, srcs[:64], dsts[:64],
                                 "path")
    served = len(results)
    stats = {k: rt.stats[k] - rt0[k] for k in rt0}
    batches = rt.dispatcher.stats["batches"] - before["batches"]

    m = rt.mirror(1)
    checked = reachable = n_paths = 0
    for i in sorted(check & set(results)):
        s, t = int(srcs[i]), int(dsts[i])
        want, _levels = oracle.depths([s], [t], 5, True)
        got = rt.bfs_batch(1, [[s]], [[t]], [1], 5, True)[0]
        got32 = np.where(got == np.iinfo(np.int16).max, oracle.INF,
                         got.astype(np.int32))
        if not np.array_equal(got32, want[m.vids]):
            raise AssertionError(f"path request {i}: depth row differs")
        if (np.delete(want, m.vids) != oracle.INF).any():
            raise AssertionError("the oracle reached a vertex with no edge")
        cols, rows = results[i]
        if cols != ["path"]:
            raise AssertionError(f"path request {i}: columns {cols}")
        d = int(want[t])
        if d == oracle.INF or d == 0:
            if rows:
                raise AssertionError(f"path request {i}: rows for an "
                                     f"unreached target")
        else:
            reachable += 1
            oracle.check(rows, oracle.shortest_paths([s], t, want), [s], t,
                         length=d)
        n_paths += len(rows)
        checked += 1
    # random pairs are mostly out of reach at 5 steps, so two seeded
    # samples aim at targets the oracle reaches: SHORTEST at 2..5 levels
    # and ALL at 1..3 (uncounted, after the window)
    sample = np.random.default_rng(seed + 4)
    aimed = {"shortest": [0, 0], "all": [0, 0]}
    t_all = 0.0
    for kind, k, lo, count in (("shortest", 5, 2, 24), ("all", 3, 1, 8)):
        for s in sample.choice(vids, count).tolist():
            reach, _ = oracle.depths([s], [], k, False)
            cand = np.nonzero((reach >= lo) & (reach <= k))[0]
            if not len(cand):
                continue
            t = int(sample.choice(cand))
            t0 = time.perf_counter()
            cols, rows = rt.serve_find_path(1, [s], [t], [1], k,
                                            kind == "shortest", names)
            if kind == "shortest":
                want, _ = oracle.depths([s], [t], k, True)
                oracle.check(rows, oracle.shortest_paths([s], t, want),
                             [s], t, length=int(want[t]))
            else:
                t_all += time.perf_counter() - t0
                oracle.check(rows, oracle.all_paths([s], t, k), [s], t)
            if not rows:
                raise AssertionError(f"FIND {kind} PATH {s} -> {t}: no "
                                     f"path to a reached target")
            aimed[kind][0] += 1
            aimed[kind][1] += len(rows)
    lats = np.asarray(list(lat.values()))
    return dict(requests=requests, served=served, threads=threads,
                wall_s=wall, qps=served / wall,
                p50_ms=float(np.percentile(lats, 50) * 1e3),
                p99_ms=float(np.percentile(lats, 99) * 1e3),
                checked=checked, checked_reachable=reachable,
                checked_paths=n_paths, batches=batches,
                mean_batch=served / max(batches, 1),
                levels_per_dispatch=stats["bfs_levels"]
                / max(stats["bfs_dispatches"], 1),
                bfs_host_s=stats["t_bfs_s"],
                reconstruct_host_s=stats["t_paths_s"],
                reconstruct_cpu_s=stats["cpu_paths_s"], launches=launches,
                runtime=stats,
                aimed_shortest_checked=aimed["shortest"][0],
                aimed_shortest_paths=aimed["shortest"][1],
                all_path_checked=aimed["all"][0],
                all_path_rows=aimed["all"][1], all_path_s=t_all,
                plain_program=plain_held)


# ============================================== the fused WHERE route
FUSED_TAG = 2                  # person's tag id in the serve space
KINDS = [f"k{i:02d}" for i in range(16)]    # e.kind's 16 values, sorted
E_ = ["edge", "e"]
# the [fused] phase's predicate family: int, float (literals exact in
# float32) and string compares, && and ||, % 7, $$ / $^ tag props, a
# vid compare, a guarded integer /; the vid literal is set per graph
FUSED_PREDICATES = [
    ["rel", ">", E_ + ["w"], ["lit", 500]],
    ["rel", "<=", E_ + ["score"], ["lit", 2.5]],
    ["logic", "||", ["rel", "==", E_ + ["kind"], ["lit", "k03"]],
     ["rel", ">", E_ + ["kind"], ["lit", "k12"]]],
    ["logic", "&&", ["rel", "==", ["arith", "%", E_ + ["w"], ["lit", 7]],
                     ["lit", 3]],
     ["rel", ">", E_ + ["score"], ["lit", 1.0]]],
    ["rel", ">", ["dst", "person", "age"], ["lit", 40]],
    ["logic", "&&", ["rel", "<", ["src", "person", "age"], ["lit", 30]],
     ["rel", "<", E_ + ["w"], ["lit", 700]]],
    ["rel", "<", ["e_dst", "e"], ["lit", None]],
    ["rel", ">", ["arith", "/", ["lit", 1000], E_ + ["w"]], ["lit", 3]],
]
# graphd (remnant) mode reads only the edge columns, valid on every
# candidate, and takes no div guard, so none of its requests declines;
# pushed mode leaves out the || predicate: the reference declines a
# pushed || over a column with an invalid row (runtime.py:2585), and
# an edge column's rows of the other direction are invalid
GRAPHD_PREDICATES = (0, 1, 2, 3, 6)
PUSHED_PREDICATES = (0, 1, 3, 4, 5, 6, 7)
AGE_PREDICATE = 4              # YIELD $$.person.age only behind it


def _modes(p: int) -> tuple:
    """The pushed modes predicate ``p`` is served in."""
    return tuple(pm for pm, ok in ((True, p in PUSHED_PREDICATES),
                                   (False, p in GRAPHD_PREDICATES)) if ok)


def fused_predicates(n: int) -> list:
    out = json.loads(json.dumps(FUSED_PREDICATES))
    out[6][3][1] = n // 2
    return out


def fused_columns(src, dst, n: int, seed: int):
    """The serve graph's generated columns, seeded: edge ``w`` int
    0..999, ``score`` double (multiples of 1/8), ``kind`` string (16
    values), aligned to the input edges; tag ``person(age)`` on 15/16 of
    the vids 1..n.  Returns (edge_props, vertex_props, raw arrays)."""
    from nebula_tpu_torch.interface.common import SupportedType as T
    rng = np.random.default_rng(seed + 17)
    k = len(src)
    w = rng.integers(0, 1000, k)
    score = rng.integers(0, 64, k) / 8.0
    kind = rng.integers(0, len(KINDS), k)
    tagged = rng.random(n + 1) >= 1 / 16
    tagged[0] = False                   # vids start at 1
    age = rng.integers(0, 100, n + 1)
    vids = np.nonzero(tagged)[0]
    edge_props = {1: {"w": (T.INT, w), "score": (T.DOUBLE, score),
                      "kind": (T.STRING, kind, np.asarray(KINDS))}}
    vertex_props = {FUSED_TAG: (vids, {"age": (T.INT, age[vids])})}
    return edge_props, vertex_props, dict(w=w, score=score, kind=kind,
                                          tagged=tagged, age=age)


class FusedOracle:
    """Plain numpy semantics of ``GO N STEPS FROM v OVER e WHERE P YIELD
    e._dst, e.w [, $$.person.age] [DISTINCT]`` on the forward edge list,
    independent of the port's compiler: an edge key keeps the values of
    its last input occurrence (a later write of the key wins); N-1 hops
    as GoOracle; the final hop's out-edges in (src, dst) order; each
    predicate written directly in int32 / float32 as the card evaluates
    it; in pushed mode a row whose predicate reads an absent tag prop,
    or divides by zero, drops."""

    def __init__(self, go: GoOracle, src, dst, raw, n: int):
        self.go = go
        key = (np.asarray(src, np.int64) << 32) | np.asarray(dst, np.int64)
        uk, first = np.unique(key[::-1], return_index=True)
        if not np.array_equal(uk, (go.src << 32) | go.dst):
            raise AssertionError("oracle keys disagree")
        last = len(key) - 1 - first
        self.w = raw["w"][last].astype(np.int32)
        self.score = raw["score"][last].astype(np.float32)
        self.kind = raw["kind"][last]
        self.tagged, self.age = raw["tagged"], raw["age"].astype(np.int32)
        self.vid_lit = n // 2

    def where(self, p: int, idx: np.ndarray, pushed: bool) -> np.ndarray:
        w, s, k = self.w[idx], self.score[idx], self.kind[idx]
        sv, dv = self.go.src[idx], self.go.dst[idx]
        if p == 0:
            return w > 500
        if p == 1:
            return s <= np.float32(2.5)
        if p == 2:
            return (k == 3) | (k > 12)
        if p == 3:
            return (w % 7 == 3) & (s > np.float32(1.0))
        if p == 4:
            return self.tagged[dv] & (self.age[dv] > 40)
        if p == 5:
            return self.tagged[sv] & (self.age[sv] < 30) & (w < 700)
        if p == 6:
            return dv < self.vid_lit
        if p == 7:
            return (w != 0) & (1000 // np.maximum(w, 1) > 3)
        raise ValueError(p)

    def rows(self, start: int, steps: int, p: int, pushed: bool,
             distinct: bool):
        """(columns, rows) of one request."""
        f = self.go.frontier_sizes([start], steps)[-1]
        idx = self.go.out_edges(f)
        idx = idx[self.where(p, idx, pushed)]
        cols = [self.go.dst[idx], self.w[idx]]
        names = ["e._dst", "e.w"]
        if p == AGE_PREDICATE:
            cols.append(self.age[self.go.dst[idx]])
            names.append("$$.person.age")
        rows = [list(r) for r in zip(*[c.tolist() for c in cols])]
        if distinct:
            seen, out = set(), []
            for r in rows:
                if tuple(r) not in seen:
                    seen.add(tuple(r))
                    out.append(r)
            rows = out
        return names, rows


def fused_request_blobs(preds):
    """(where blob, yield specs) per predicate, encoded by the port."""
    from nebula_tpu_torch.filter.expressions import _from_wire, encode_expr
    ys = [(encode_expr(_from_wire(["e_dst", "e"])), None),
          (encode_expr(_from_wire(E_ + ["w"])), None)]
    age = [(encode_expr(_from_wire(["dst", "person", "age"])), None)]
    return [(encode_expr(_from_wire(p)),
             ys + (age if i == AGE_PREDICATE else []))
            for i, p in enumerate(preds)]


def _slot_bytes(prog, m_edges: int, n: int) -> int:
    """The bytes an ExprProgram must move: each edge-aligned column and
    validity byte once an edge, each vertex column once a vertex (every
    value is some edge's), the src / dst index once an edge where a
    vertex column is gathered, one output byte an edge."""
    size = {0: 1, 1: 4, 2: 4}
    total, idx = m_edges, set()
    for _key, kind, typ in prog.slots:
        if kind == 0:
            total += size[typ] * m_edges
        else:
            total += size[typ] * n
            idx.add(kind)
    return total + 4 * m_edges * len(idx)


def edge_pass_bytes(torch, edge_ops, f, src, et, over, kind: str) -> int:
    """The bytes an edge-list pass from frontier ``f`` (bool [n]) must
    move on this run's data: src on every edge and f once; etype only
    on the edges whose source is in f, since each kernel tests
    ``f[src[e]]`` first and reads ``et[e]`` only then.  ``kind``: "hop"
    (K8) adds dst on the edges that pass both tests and the n-byte next
    frontier; "final" (K9 without a mask, ``edge_final_where`` before
    its WHERE) the 1-byte out of every edge; "final_mask" (K9 with a
    WHERE mask) also the mask on the passing edges."""
    M, n = src.numel(), f.numel()
    from_f = int(f[src.long()].sum())
    passing = int(edge_ops.edge_final_ref(
        f, src, et, over, None, torch.empty(M, dtype=torch.bool,
                                            device=src.device)).sum())
    nb = 4 * M + n + 4 * from_f
    if kind == "hop":
        return nb + 4 * passing + n
    return nb + M + (passing if kind == "final_mask" else 0)


def walk_bytes(torch, edge_ops, f, rp, et, over, n: int) -> int:
    """The bytes K8's walk over the CSR rows must move on this run's
    data: the frontier f (n bytes) or the start list (4 bytes an id),
    row_ptr at each live source (v and v + 1), etype on each edge of a
    live source, dst on each of those that passes OVER, and the n-byte
    next frontier."""
    v = edge_ops.live_sources(f, n)
    e = edge_ops.row_edges(rp, v)
    passing = int(edge_ops._etype_ok(et[e], over).sum())
    first = n if f.dtype == torch.bool else 4 * f.numel()
    return first + 8 * v.numel() + 4 * e.numel() + 4 * passing + n


def _live_slot_bytes(prog, live: int) -> int:
    """The bytes the fused final pass must move for the WHERE: each used
    column's value for each kept edge (a vertex column gathered at the
    edge's src or dst), and the dst index where a column is read there
    (src is read for every edge by the pass's own test)."""
    size = {0: 1, 1: 4, 2: 4}
    total = sum(size[typ] * live for _key, _kind, typ in prog.slots)
    if any(kind == 2 for _key, kind, _typ in prog.slots):
        total += 4 * live
    return total


def transcendental_check(torch, edge_ops, rt, m, src, dst) -> dict:
    """K10 on CUDA's libm against the plain version's torch functions:
    ``log(e.w + 1) + sin(e.score) + exp2(e.score) - cbrt(e.w) > 6``.
    The two may differ by a few ulp, so the masks must agree exactly
    wherever the plain value lies 1e-4 or more from the threshold."""
    from nebula_tpu_torch.filter.expressions import _from_wire
    from nebula_tpu_torch.tpu.expr_compile import ExprCompiler
    from nebula_tpu_torch.tpu.expr_program import trace_filter
    w, sc = E_ + ["w"], E_ + ["score"]
    v = ["arith", "-", ["arith", "+", ["arith", "+", [
        "fn", "log", [["arith", "+", w, ["lit", 1.0]]]],
        ["fn", "sin", [sc]]], ["fn", "exp2", [sc]]], ["fn", "cbrt", [w]]]
    plan = rt._plan_go(1, {"e": 1}, _from_wire(["rel", ">", v,
                                                 ["lit", 6.0]]), True)
    prog = rt._filter_program(m, 1, plan)
    env = rt._env_cols(m, {"e": 1}, plan.filter_used, True)
    slots = [env[k] for k, _kind, _t in prog.slots]
    comp = ExprCompiler(m, 1, rt._schema(1), {"e": 1})
    cval = comp.compile(_from_wire(v))
    types = {k: 2 if rt._col_dtype(m, d) == np.float32 else 1
             for k, d in comp.used.items()}
    vprog = trace_filter(cval, comp.used, [], False, types, root="value")
    value = edge_ops.run_program(vprog, [env[k] for k, _kd, _t in
                                         vprog.slots], src, dst)
    ek = torch.empty(m.m, dtype=torch.bool, device=src.device)
    er = torch.empty_like(ek)
    edge_ops.expr_filter(prog, slots, src, dst, ek)
    edge_ops.expr_filter_ref(prog, slots, src, dst, er)
    far = (value - 6.0).abs() >= 1e-4
    torch.cuda.synchronize()
    if not torch.equal(ek[far], er[far]):
        raise AssertionError("expr_filter on the transcendentals differs "
                             "from its plain version away from the "
                             "threshold")
    return dict(ops=sorted(set(prog.ops)), near=int((~far).sum()),
                near_differ=int((ek != er)[~far].sum()), kept=int(ek.sum()))


def edge_kernel_phase(torch, edge_ops, rt, m, oracle: GoOracle,
                      blobs, rng) -> tuple:
    """The edge-list kernels and programs against their plain versions
    on the serve graph's real edge arrays and generated columns,
    exactly: K8 ``edge_hop``, K9 ``edge_final`` (with and without the
    WHERE mask), ``edge_seed``, K10 ``expr_filter`` for each predicate
    of the [fused] family in its modes, K11 ``edge_bfs_level``; the
    programs ``go`` and ``go_filtered`` at 1-3 steps from 1 and 256
    starts (``go_filtered`` launching no ``expr_filter``; its launches
    and C calls a call at 3 steps by capture), ``bfs`` on a connected
    and an unreachable pair; then ``go_filtered``'s final pass
    ``edge_final_where`` on those runs' 3-step frontiers for every
    predicate-mode, against its plain version and against K9 over K10's
    whole mask on the card.  Returns ({kernel: numbers}, {run:
    numbers})."""
    from nebula_tpu_torch.filter.expressions import decode_expr
    csr = rt._device_csr(m)
    src, dst, et = csr["edge_src"], csr["edge_dst"], csr["edge_etype"]
    dev = src.device
    n, M = m.n, m.m
    over = (1,)
    rows, runs = {}, {}
    b = torch.bool

    def same(name, a, b_):
        torch.cuda.synchronize()
        if not torch.equal(a, b_):
            raise AssertionError(f"{name} != its plain version")

    # ---- K8 edge_hop, the walk over the CSR rows, on four frontiers:
    # about 2 % of the vertices set (the headline row), one start (as a
    # bitmap and as the start list a program's first hop takes), every
    # vertex, the 16 longest rows
    rp = csr["row_ptr"]
    rows_h = np.diff(m.row_ptr)
    one = int(rng.choice(np.nonzero(rows_h > 0)[0]))
    f = torch.from_numpy(rng.random(n) < 0.02).to(dev)
    fronts = {"dense2": f, "start": torch.zeros(n, dtype=b, device=dev),
              "all": torch.ones(n, dtype=b, device=dev),
              "hubs16": torch.zeros(n, dtype=b, device=dev)}
    fronts["start"][one] = True
    fronts["hubs16"][torch.from_numpy(
        np.argsort(rows_h, kind="stable")[-16:]).to(dev)] = True
    one_h = np.full(8, -1, np.int32)
    one_h[0] = one
    fronts["start_list"] = torch.from_numpy(one_h).to(dev)
    ok_, orf = (torch.empty(n, dtype=b, device=dev) for _ in range(2))
    hop_rows = {}
    for label, fl in fronts.items():
        edge_ops.edge_hop(fl, ok_, src, dst, et, rp, over)
        edge_ops.edge_hop_ref(fl, orf, src, dst, et, rp, over)
        same(f"edge_hop {label}", ok_, orf)

        def hop(fl=fl):
            edge_ops.edge_hop(fl, ok_, src, dst, et, rp, over)
        hop_rows[label] = dict(
            ms=queued_ms(torch, hop, 8), event_ms=cuda_ms(torch, hop, 20),
            bound_ms=bytes_ms(walk_bytes(torch, edge_ops, fl, rp, et, over,
                                         n)),
            scan_bound_ms=bytes_ms(edge_pass_bytes(
                torch, edge_ops, fl if fl.dtype == b else fronts["start"],
                src, et, over, "hop")),
            live=int(edge_ops.live_sources(fl, n).numel()),
            reached=int(ok_.sum()))
        hop_rows[label].update(launches_a_call(torch, edge_ops, hop))
        if hop_rows[label]["launches_a_call"] != 2:
            raise AssertionError(f"edge_hop {label}: "
                                 f"{hop_rows[label]['launch_kinds']}, not a "
                                 f"memset and one kernel")
    edge_ops.edge_hop(f, ok_, src, dst, et, rp, over)
    active = (f[src.long()] & (et == 1)).to(torch.uint8)
    dst64 = dst.long()
    out8 = torch.zeros(n, dtype=torch.uint8, device=dev)

    def lib_hop():
        out8.zero_()
        out8.scatter_reduce_(0, dst64, active, "amax")
    head = hop_rows["dense2"]
    rows["edge_hop"] = dict(
        max_abs_err=0, ms=head["ms"],
        plain_ms=cuda_ms(torch, lambda: edge_ops.edge_hop_ref(
            f, orf, src, dst, et, rp, over), 3, 1),
        bound_ms=head["bound_ms"], bound_by="bytes",
        library_ms=queued_ms(torch, lib_hop, 8),
        library_event_ms=cuda_ms(torch, lib_hop, 20),
        headline="the 2 %-dense frontier", frontiers=hop_rows)
    same("scatter_reduce_ (the library yardstick)", out8.bool(), ok_)

    # ---- K9 edge_final, without and with a WHERE mask
    fmask = torch.from_numpy(rng.random(M) < 0.5).to(dev)
    fk, fr = (torch.empty(M, dtype=b, device=dev) for _ in range(2))
    for mask in (None, fmask):
        edge_ops.edge_final(f, src, et, over, mask, fk)
        edge_ops.edge_final_ref(f, src, et, over, mask, fr)
        same("edge_final", fk, fr)
    rows["edge_final"] = dict(
        max_abs_err=0,
        ms=cuda_ms(torch, lambda: edge_ops.edge_final(f, src, et, over,
                                                      fmask, fk), 20),
        plain_ms=cuda_ms(torch, lambda: edge_ops.edge_final_ref(
            f, src, et, over, fmask, fr), 3, 1),
        bound_ms=bytes_ms(edge_pass_bytes(torch, edge_ops, f, src, et,
                                          over, "final_mask")),
        bound_by="bytes", library_ms=None,
        ms_no_mask=cuda_ms(torch, lambda: edge_ops.edge_final(
            f, src, et, over, None, fk), 20),
        bound_ms_no_mask=bytes_ms(edge_pass_bytes(torch, edge_ops, f, src,
                                                  et, over, "final")))

    # ---- edge_seed: 1 and 256 starts (-1 padded to 8 and 512), one
    # launch a call
    seeds = {}
    sk, sr = (torch.empty(n, dtype=b, device=dev) for _ in range(2))
    for S in (1, 256):
        idx_h = np.full(max(8, 2 * S), -1, np.int32)
        idx_h[:S] = rng.integers(0, n, S)
        idx = torch.from_numpy(idx_h).to(dev)
        edge_ops.edge_seed(sk, idx)
        edge_ops.edge_seed_ref(sr, idx)
        same(f"edge_seed S={S}", sk, sr)

        def seed(idx=idx):
            edge_ops.edge_seed(sk, idx)
        seeds[S] = dict(
            max_abs_err=0, ms=queued_ms(torch, seed, 8),
            event_ms=cuda_ms(torch, seed, 20),
            plain_ms=cuda_ms(torch, lambda: edge_ops.edge_seed_ref(sr, idx),
                             5, 1),
            bound_ms=bytes_ms(n + 4 * idx_h.size), bound_by="bytes",
            library_ms=None, starts=S)
        seeds[S].update(launches_a_call(torch, edge_ops, seed))
        if seeds[S]["launches_a_call"] != 1:
            raise AssertionError(f"edge_seed S={S}: "
                                 f"{seeds[S]['launch_kinds']}, not one "
                                 f"launch")
    rows["edge_seed"] = dict(seeds[1], s256=seeds[256],
                             library_none="none: zeros then an index fill, "
                                          "two calls")

    # ---- K10 expr_filter: every predicate of the family in its modes
    alias = {"e": 1}
    per_pred = []
    progs = {}
    for i, (where, _ys) in enumerate(blobs):
        for pushed in _modes(i):
            plan = rt._plan_go(1, alias, decode_expr(where), pushed)
            prog = rt._filter_program(m, 1, plan)
            env = rt._env_cols(m, alias, plan.filter_used, pushed)
            slots = [env[k] for k, _kind, _t in prog.slots]
            progs[(i, pushed)] = (prog, slots)
            ek, er = (torch.empty(M, dtype=b, device=dev) for _ in range(2))
            edge_ops.expr_filter(prog, slots, src, dst, ek)
            edge_ops.expr_filter_ref(prog, slots, src, dst, er)
            same(f"expr_filter predicate {i} pushed={pushed}", ek, er)
            per_pred.append(dict(
                predicate=i, pushed=pushed, instructions=len(prog),
                registers=prog.n_regs, kept=int(ek.sum()),
                ms=cuda_ms(torch, lambda: edge_ops.expr_filter(
                    prog, slots, src, dst, ek), 10),
                plain_ms=cuda_ms(torch, lambda: edge_ops.expr_filter_ref(
                    prog, slots, src, dst, er), 2, 1),
                bound_ms=bytes_ms(_slot_bytes(prog, M, n))))
    head = next(r for r in per_pred if r["predicate"] == 3 and r["pushed"])
    rows["expr_filter"] = dict(
        max_abs_err=0, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by="bytes", library_ms=None,
        headline="predicate 3 (w % 7 == 3 && score > 1.0), pushed",
        predicates=per_pred,
        transcendental=transcendental_check(torch, edge_ops, rt, m, src,
                                            dst))

    # ---- K11 edge_bfs_level: a first level, then one after a hop
    d = torch.empty(n, dtype=torch.int32, device=dev)
    tk = torch.from_numpy(rng.random(n) < 0.001).to(dev)
    reached = torch.empty_like(f)
    edge_ops.edge_hop(f, reached, src, dst, et, rp, over)
    d0 = torch.empty_like(d)
    fl = torch.zeros(2, dtype=torch.int32, device=dev)
    edge_ops.edge_bfs_level(f.clone(), d0, tk, fl, 0, True, True)
    dk, dr = d0.clone(), d0.clone()
    rk, rr = reached.clone(), reached.clone()
    flk, flr = (torch.zeros(2, dtype=torch.int32, device=dev)
                for _ in range(2))
    edge_ops.edge_bfs_level(rk, dk, tk, flk, 0, False, True)
    edge_ops.edge_bfs_level_ref(rr, dr, tk, flr, 0, False, True)
    for a, c in ((dk, dr), (rk, rr), (flk, flr)):
        same("edge_bfs_level", a, c)
    rb = reached.clone()

    def level_run():
        rb.copy_(reached)
        dk.copy_(d0)
        edge_ops.edge_bfs_level(rb, dk, tk, flk, 0, False, True)

    def level_plain():
        rb.copy_(reached)
        dr.copy_(d0)
        edge_ops.edge_bfs_level_ref(rb, dr, tk, flr, 0, False, True)

    def restore():
        rb.copy_(reached)
        dk.copy_(d0)
    rows["edge_bfs_level"] = dict(
        max_abs_err=0, ms=restored_ms(torch, level_run, restore, 20),
        plain_ms=restored_ms(torch, level_plain, restore, 3, 1),
        bound_ms=bytes_ms(11 * n), bound_by="bytes", library_ms=None)

    # ---- programs: go and go_filtered (predicate 3, pushed) at 1-3
    # steps from 1 and 256 starts
    prog3, slots3 = progs[(3, True)]
    finals = {}
    for S in (1, 256):
        st_h = np.full(max(8, 1 << (S - 1).bit_length()), -1, np.int32)
        st_h[:S] = rng.integers(0, n, S)
        st = torch.from_numpy(st_h).to(dev)
        for steps in (1, 2, 3):
            for name in ("go", "go_filtered"):
                extra = (prog3, slots3) if name == "go_filtered" else ()
                kern = getattr(edge_ops, name)
                ref = getattr(edge_ops, name + "_ref")
                k10 = edge_ops.LAUNCHES["expr_filter"]
                out = kern(src, dst, et, rp, st, n, steps, over, *extra)
                if edge_ops.LAUNCHES["expr_filter"] != k10:
                    raise AssertionError(f"{name} launched expr_filter")
                (want, plain) = timed(torch, lambda: ref(
                    src, dst, et, rp, st, n, steps, over, *extra))
                for a, c in zip(out, want):
                    same(f"{name} S={S} steps={steps}", a, c)
                # this run's data: the start bitmap at one step, else each
                # hop's walk from the list or frontier it starts from
                # (go_ref's frontier after h hops), the final pass's bytes,
                # the fused pass's WHERE columns on the kept edges only
                live = int(edge_ops.edge_final_ref(
                    out[1], src, et, over, None,
                    torch.empty(M, dtype=b, device=dev)).sum())
                hops = [st] + [edge_ops.go_ref(src, dst, et, rp, st, n,
                                               h + 1, over)[1]
                               for h in range(1, steps - 1)]
                nb = (n + 4 * st.numel() if steps == 1 else 0) \
                    + edge_pass_bytes(torch, edge_ops, out[1], src, et,
                                      over, "final") \
                    + sum(walk_bytes(torch, edge_ops, fh, rp, et, over, n)
                          for fh in hops[:steps - 1]) \
                    + (_live_slot_bytes(prog3, live) if extra else 0)

                def call():
                    return kern(src, dst, et, rp, st, n, steps, over,
                                *extra)
                runs[f"{name}_S{S}_s{steps}"] = dict(
                    name=name, max_abs_err=0, ms=queued_ms(torch, call, 10),
                    event_ms=cuda_ms(torch, call, 10),
                    plain_ms=plain, bound_ms=bytes_ms(nb), bound_by="bytes",
                    library_ms=None, starts=S, steps=steps, live_edges=live,
                    kept=int(out[0].sum()))
                if steps == 3:
                    # no start bitmap: each hop a memset and a kernel, the
                    # first from the start list; the final pass one
                    # kernel; no expr_filter
                    row = launches_a_call(torch, edge_ops, call)
                    want_l, want_c = 2 * (steps - 1) + 1, steps
                    if row["launches_a_call"] != want_l \
                            or row["c_calls_a_call"] != want_c:
                        raise AssertionError(
                            f"{name} S={S}: {row['launches_a_call']} "
                            f"launches in {row['c_calls_a_call']} C calls, "
                            f"not {want_l} in {want_c} "
                            f"({row['launch_kinds']})")
                    runs[f"{name}_S{S}_s{steps}"].update(row)
                    if name == "go_filtered":
                        finals[S] = out[1].clone()

    # ---- go_filtered's final pass on the 3-step frontiers, every
    # predicate-mode: the WHERE run on the kept edges only
    per_final = []
    for S, f_fin in finals.items():
        keep = edge_ops.edge_final_ref(f_fin, src, et, over, None,
                                       torch.empty(M, dtype=b, device=dev))
        live = int(keep.sum())
        final_nb = edge_pass_bytes(torch, edge_ops, f_fin, src, et, over,
                                   "final")
        for (i, pushed), (prog, slots) in progs.items():
            fk, fr_, k9 = (torch.empty(M, dtype=b, device=dev)
                           for _ in range(3))
            edge_ops.edge_final_where(f_fin, src, dst, et, over, prog, slots,
                                      fk)
            edge_ops.edge_final_where_ref(f_fin, src, dst, et, over, prog,
                                          slots, fr_)
            same(f"edge_final_where S={S} predicate {i} pushed={pushed}",
                 fk, fr_)
            mask = torch.empty(M, dtype=b, device=dev)
            edge_ops.expr_filter(prog, slots, src, dst, mask)
            edge_ops.edge_final(f_fin, src, et, over, mask, k9)
            same(f"edge_final_where S={S} predicate {i}: K9 over K10", fk,
                 k9)
            per_final.append(dict(
                starts=S, predicate=i, pushed=pushed, live_edges=live,
                kept=int(fk.sum()), instructions=len(prog),
                ms=cuda_ms(torch, lambda: edge_ops.edge_final_where(
                    f_fin, src, dst, et, over, prog, slots, fk), 20),
                k9_k10_ms=cuda_ms(torch, lambda: (
                    edge_ops.expr_filter(prog, slots, src, dst, mask),
                    edge_ops.edge_final(f_fin, src, et, over, mask, k9)),
                    20),
                plain_ms=cuda_ms(torch, lambda: edge_ops.edge_final_where_ref(
                    f_fin, src, dst, et, over, prog, slots, fr_), 2, 1),
                bound_ms=bytes_ms(final_nb + _live_slot_bytes(prog,
                                                              live))))
    head = next(r for r in per_final
                if r["starts"] == 1 and r["predicate"] == 3 and r["pushed"])
    rows["edge_final_where"] = dict(
        max_abs_err=0, ms=head["ms"], plain_ms=head["plain_ms"],
        bound_ms=head["bound_ms"], bound_by="bytes", library_ms=None,
        headline="go_filtered's final pass on the 1-start 3-step frontier, "
                 "predicate 3 (w % 7 == 3 && score > 1.0), pushed",
        live_edges=head["live_edges"], k9_k10_ms=head["k9_k10_ms"],
        per_frontier_and_predicate=per_final)

    # ---- bfs: a connected pair (a target 2-4 levels away) and an
    # unreachable one (a vid with no in-edge over e), 5 levels
    srcs_o = oracle.src
    s_v = int(srcs_o[np.argmax(np.bincount(srcs_o))])     # a hub start
    path_o = PathOracle(oracle)
    depth, _lv = path_o.depths([s_v], [], 4, False)
    far = np.nonzero((depth >= 2) & (depth <= 4))[0]
    no_in = np.setdiff1d(np.unique(srcs_o), np.unique(oracle.dst))
    pairs = {"connected": (s_v, int(far[0]) if len(far) else s_v)}
    if len(no_in):
        pairs["unreachable"] = (s_v, int(no_in[0]))
    else:
        log("[kernel] bfs: every vertex has an in-edge; no unreachable "
            "pair in this graph")
    for label, (a, t) in pairs.items():
        sa = torch.from_numpy(np.asarray(
            [m.to_dense([a])[0]] + [-1] * 7, np.int32)).to(dev)
        ta = torch.from_numpy(np.asarray(
            [m.to_dense([t])[0]] + [-1] * 7, np.int32)).to(dev)
        got, levels = edge_ops.bfs(src, dst, et, rp, sa, ta, n, 5, over)
        (want, wl), plain = timed(torch, lambda: edge_ops.bfs_ref(
            src, dst, et, rp, sa, ta, n, 5, over))
        same(f"bfs {label}", got, want)
        if levels != wl:
            raise AssertionError(f"bfs {label}: {levels} levels, the plain "
                                 f"version ran {wl}")
        dt = int(got[m.to_dense([t])[0]])
        want_d = int(depth[t]) if label == "connected" else None
        if label == "connected" and dt != want_d:
            raise AssertionError(f"bfs connected depth {dt} != {want_d}")
        if label == "unreachable" and dt != edge_ops.INT32_INF:
            raise AssertionError("bfs reached an unreachable target")
        # the seeds and first level, then each level's walk from the
        # vertices at that depth and its level pass
        nb = 2 * n + 9 * n + sum(
            walk_bytes(torch, edge_ops, got == lv, rp, et, over, n) + 11 * n
            for lv in range(levels))
        runs[f"bfs_{label}"] = dict(
            name="bfs", max_abs_err=0,
            ms=cuda_ms(torch, lambda: edge_ops.bfs(src, dst, et, rp, sa, ta,
                                                   n, 5, over), 5, 1),
            plain_ms=plain, bound_ms=bytes_ms(nb), bound_by="bytes",
            scan_bound_ms=bytes_ms(2 * n + levels * (12 * M + 13 * n)
                                   + 9 * n),
            library_ms=None, levels=levels, target_depth=dt)
    rows["go"] = dict(runs["go_S1_s3"])
    rows["go_filtered"] = dict(runs["go_filtered_S1_s3"])
    rows["bfs"] = dict(runs["bfs_connected"])
    return rows, runs


def drive_fused(rt, reqs, blobs, threads: int, keep):
    """Serve every fused request from ``threads`` client threads.
    Returns (wall s, latency s per request, {i: answer} for i in
    ``keep``); raises if any request failed."""
    def call(req):
        start, steps, p, pushed, distinct = req
        where, ys = blobs[p]
        return rt.serve_go(1, [start], [1], steps, {1: "e"},
                           where_blob=where, yield_specs=ys,
                           distinct=distinct, pushed_mode=pushed)
    return drive_calls(call, reqs, threads, keep)


def fused_phase(torch, rt, edge_ops, fo: FusedOracle, blobs, n: int,
                requests: int, threads: int, seed: int) -> dict:
    """``GO N STEPS FROM v OVER e WHERE P YIELD e._dst, e.w`` (and
    ``$$.person.age`` behind its own predicate) on the fused route:
    ``requests`` from ``threads`` threads, one start vid, 1-3 steps, P
    from the family, a quarter DISTINCT, three quarters in pushed mode
    (graphd mode reads only the all-valid edge columns).  Counted: the
    launch counts are zeroed just before the requests and read just
    after; 64 answers are checked exactly against FusedOracle."""
    rng = np.random.default_rng(seed + 19)
    starts = rng.integers(1, n + 1, requests)
    steps = rng.integers(1, 4, requests)
    pushed = rng.random(requests) < 0.75
    distinct = rng.random(requests) < 0.25
    preds = np.where(pushed, rng.choice(PUSHED_PREDICATES, requests),
                     rng.choice(GRAPHD_PREDICATES, requests))
    reqs = [(int(starts[i]), int(steps[i]), int(preds[i]),
             bool(pushed[i]), bool(distinct[i])) for i in range(requests)]
    check = set(rng.choice(requests, min(64, requests),
                           replace=False).tolist())
    # compile every (predicate, mode) program and upload the columns
    # outside the window, as a server holds them warm
    for i, (where, ys) in enumerate(blobs):
        for pm in _modes(i):
            rt.serve_go(1, [1], [1], 1, {1: "e"}, where_blob=where,
                        yield_specs=ys, pushed_mode=pm)
    torch.cuda.synchronize()
    rt0 = dict(rt.stats)
    edge_ops.reset_launches()
    wall, lat, results = drive_fused(rt, reqs, blobs, threads, check)
    launches = dict(edge_ops.LAUNCHES)
    stats = {k: rt.stats[k] - rt0[k] for k in rt0}
    n_rows = 0
    for i in sorted(check):
        start, st, p, pm, dist = reqs[i]
        want = fo.rows(start, st, p, pm, dist)
        got = (list(results[i][0]), [list(r) for r in results[i][1]])
        if got != (want[0], want[1]):
            raise AssertionError(
                f"fused request {i} (start {start}, {st} steps, predicate "
                f"{p}, pushed {pm}, distinct {dist}): {len(got[1])} rows, "
                f"the oracle has {len(want[1])}")
        n_rows += len(want[1])
    require_launched(launches, "fused")
    if launches["expr_filter"] or launches["edge_final"]:
        raise AssertionError(f"the fused route launched expr_filter "
                             f"{launches['expr_filter']} and edge_final "
                             f"{launches['edge_final']} times: its WHERE "
                             f"runs in edge_final_where")
    if stats["go_fused"] != requests:
        raise AssertionError(f"{stats['go_fused']} of {requests} requests "
                             f"rode the fused route")
    qps = requests / wall
    return dict(requests=requests, threads=threads, wall_s=wall, qps=qps,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3),
                checked=len(check), checked_rows=n_rows,
                pushed=int(pushed.sum()), distinct=int(distinct.sum()),
                launch_s=stats["t_fused_launch_s"],
                fetch_s=stats["t_fused_fetch_s"],
                materialize_s=stats["t_fused_materialize_s"],
                fetch_bytes=stats["fetch_bytes"], launches=launches,
                runtime=stats)


# ====================================================== phase 3: absorb
ABSORB_ITERS = 20


def _row_fill(ix):
    """(filled slots, width) per ELL row, in new-id order."""
    filled = np.concatenate([(nbr != ix.n_rows).sum(axis=1)
                             for nbr in ix.bucket_nbr])
    width = np.concatenate([np.full(nbr.shape[0], nbr.shape[1])
                            for nbr in ix.bucket_nbr])
    return filled.astype(np.int64), width.astype(np.int64)


def absorb_windows(m, ix, rng, events: int = 4096):
    """Three absorb plans over the serve ELL, made by the port's
    ``plan_ell_absorb``: (a) ``events`` edge events (both directions)
    of in-place updates, deletes and inserts on non-hub owners; (b) a
    non-hub vertex grown past its width (a growth-spare claim); (c)
    rows that include every bucket's last row (every growth spare
    claimed, so the widest bucket's too) and no bucket's first row,
    with pads at every bucket's end.  Returns {label: (plan, claims,
    events)}."""
    from nebula_tpu_torch.tpu.ell import plan_ell_absorb
    n = ix.n
    ecnt, _e0 = ix.hub_expansion()
    filled, width = _row_fill(ix)
    nonhub_new = np.zeros(ix.n_rows, bool)
    nonhub_new[:n] = ecnt[:n] == 0
    nonhub = nonhub_new[ix.perm]                 # by old dense id
    free = np.where(nonhub_new[:n], width[:n] - filled[:n], 0)[ix.perm]
    out = {}

    def plan(ins, dels, claims_ok=True):
        ins = np.asarray(ins, np.int64).reshape(-1, 3)
        dels = np.asarray(dels, np.int64).reshape(-1, 3)
        claims = []
        p = plan_ell_absorb(ix, ins[:, 1], ins[:, 0],
                            ins[:, 2].astype(np.int32), dels[:, 1],
                            dels[:, 0], dels[:, 2].astype(np.int32),
                            claims_out=claims if claims_ok else None)
        if p is None:
            raise AssertionError("an absorb plan the ELL should hold "
                                 "declined")
        return p, claims

    # (a) forward edges between non-hub owners: 45 % updates, 25 %
    # deletes, the rest inserts between owners with a free slot
    fwd = np.nonzero((m.edge_etype == 1) & nonhub[m.edge_src]
                     & nonhub[m.edge_dst])[0]
    k = events // 2
    n_upd, n_del = int(k * 0.45), int(k * 0.25)
    pick = rng.choice(fwd, n_upd + n_del, replace=False)
    rows_of = [(int(m.edge_src[e]), int(m.edge_dst[e])) for e in pick]
    both = lambda s, d: [(s, d, 1), (d, s, -1)]      # noqa: E731
    ins, dels = [], []
    for s, d in rows_of[:n_upd]:
        ins += both(s, d)
        dels += both(s, d)
    for s, d in rows_of[n_upd:]:
        dels += both(s, d)
    room = free.copy()
    open_v = np.nonzero(room >= 1)[0]
    n_ins = 0
    while n_ins < k - n_upd - n_del:
        s, d = (int(v) for v in rng.choice(open_v, 2))
        if s == d or room[s] < 1 or room[d] < 1:
            continue
        room[s] -= 1
        room[d] -= 1
        ins += both(s, d)
        n_ins += 1
    p, c = plan(ins, dels, claims_ok=False)
    out["a_4096_events"] = (p, c, len(ins) - 2 * n_upd + len(dels))

    # (b) a full non-hub row in a bucket narrower than the cap grows
    cap_w = int(ix.bucket_D[-1])
    full = np.nonzero(nonhub & (free == 0)
                      & (width[:n][ix.perm] < cap_w)
                      & (filled[:n][ix.perm] > 0))[0]
    v = int(rng.choice(full))
    srcs = rng.choice(np.nonzero(free >= 1)[0], 3, replace=False)
    p, c = plan([(int(u), v, 1) for u in srcs], [])
    if not c:
        raise AssertionError("window (b) claimed no growth spare")
    out["b_growth_claim"] = (p, c, 3)

    # (c) every bucket's last row, no bucket's first row; the widest
    # bucket's last rows are growth spares: one small vertex claims
    # them all
    row0 = np.cumsum([0] + [nbr.shape[0] for nbr in ix.bucket_nbr])
    firsts = set(row0[:-1].tolist())
    ins, dels = [], []
    targets = [int(row0[b + 1] - 1) for b in range(len(ix.bucket_nbr) - 1)]
    b0 = [r for r in range(1, int(row0[1]) - 1) if r < n]
    targets += [int(r) for r in rng.choice(b0, min(8, len(b0)),
                                           replace=False)]
    for r in targets:
        owner = int(ix.inv[r])
        b = int(np.searchsorted(row0, r, "right") - 1)
        nbr_row = ix.bucket_nbr[b][r - row0[b]]
        et_row = ix.bucket_et[b][r - row0[b]]
        if nbr_row[0] != ix.n_rows:               # swap one slot
            dels.append((int(ix.inv[nbr_row[0]]), owner, int(et_row[0])))
        ins.append((int(rng.integers(0, n)), owner, 1))
    spares = int((ix.extra_owner == ix.spare_sentinel()).sum())
    cands = [int(r) for r in range(1, int(row0[1]) - 1)
             if r not in targets and r not in firsts and r < n
             and nonhub_new[r]]
    g = int(ix.inv[cands[0]])
    need = (spares - 1) * cap_w + 1 + int(width[cands[0]]
                                          - filled[cands[0]])
    ins += [(int(u), g, 1) for u in rng.integers(0, n, need)]
    p, c = plan(ins, dels)
    if len(c) != spares:
        raise AssertionError(f"window (c) claimed {len(c)} of {spares} "
                             f"spares")
    touched = {b: v[0] for b, v in p.items()}
    for b, nbr in enumerate(ix.bucket_nbr):
        if b not in touched or nbr.shape[0] - 1 not in touched[b] \
                or 0 in touched[b]:
            raise AssertionError(f"window (c) bucket {b} does not hold "
                                 f"its last row without its first")
    out["c_bucket_ends"] = (p, c, len(ins) + len(dels))
    return out


def absorb_kernel_phase(torch, ell_ops, rt, m, ix, tables, rng) -> dict:
    """``ell_absorb`` against its plain version on the serve graph's real
    flat tables, for each window of ``absorb_windows``: both output
    tables equal the plain version's and the host index's next
    generation exactly, and the input tables are byte-identical before
    and after (no donation).  Times: the kernel's device time over
    PROBE_REPS calls queued behind a spin kernel (``ms``; ``event_ms``
    the CUDA-event time of ABSORB_ITERS back-to-back calls, launch path
    included), the plain version, and the library yardstick (``clone``
    of both tables, then ``index_copy_`` of each bucket's in-range
    rows).  The bound is the bytes the function must move: both tables
    read and written, every padded row index read, and the contents of
    the in-range replacement rows only (a pad row's are never read)."""
    from nebula_tpu_torch.tpu.ell import (absorb_update_arrays,
                                          apply_ell_absorb_host)
    dev = tables.nbr.device
    spin_ms = cuda_ms(torch, lambda: torch.cuda._sleep(SPIN_CYCLES), 3, 1)
    out = {}
    for label, (plan, claims, events) in absorb_windows(m, ix,
                                                        rng).items():
        counts, upd = absorb_update_arrays(ix, plan)
        rows, nn, ne = rt._absorb_args(upd)
        nbr0, et0 = tables.nbr.clone(), tables.et.clone()
        got = ell_ops.ell_absorb(tables, rows, nn, ne)
        want = ell_ops.ell_absorb_ref(tables, rows, nn, ne)
        host = apply_ell_absorb_host(ix, plan, ix.m, claims=claims) \
            .device_tables(dev)
        require_equal(torch, f"ell_absorb {label}", 0,
                      (got.nbr, want.nbr), (got.et, want.et),
                      (got.nbr, host.nbr), (got.et, host.et))
        if not (torch.equal(tables.nbr, nbr0)
                and torch.equal(tables.et, et0)):
            raise AssertionError(f"ell_absorb {label} changed its input "
                                 f"tables")
        del got, want, host, nbr0, et0
        kern = lambda: ell_ops.ell_absorb(tables, rows, nn, ne)  # noqa: E731
        event_ms = cuda_ms(torch, kern, ABSORB_ITERS)
        ms, enqueue_ms = queued_times(torch, kern, PROBE_REPS)
        if enqueue_ms >= spin_ms:
            log(f"[kernel] ell_absorb {label}: host enqueue {enqueue_ms:.3f}"
                f" ms outlasted the spin ({spin_ms:.3f} ms); its device "
                f"time holds launch gaps")
        plain_ms = cuda_ms(torch, lambda: ell_ops.ell_absorb_ref(
            tables, rows, nn, ne), 3, warmup=1)
        keep = [(r.long() < tables.rows[b]).nonzero().squeeze(1)
                for b, r in enumerate(rows)]
        idx = [rows[b].long()[keep[b]] for b in range(len(rows))]
        n_in = [nn[b][keep[b]].contiguous() for b in range(len(rows))]
        e_in = [ne[b][keep[b]].contiguous() for b in range(len(rows))]

        def lib():
            a, e = tables.nbr.clone(), tables.et.clone()
            for b in range(len(rows)):
                lo, k = tables.slot0[b], tables.rows[b] * tables.D[b]
                shape = (tables.rows[b], tables.D[b])
                a[lo:lo + k].view(shape).index_copy_(0, idx[b], n_in[b])
                e[lo:lo + k].view(shape).index_copy_(0, idx[b], e_in[b])
            return a, e
        lib_ms = cuda_ms(torch, lib, ABSORB_ITERS)
        slots = int(tables.nbr.numel())
        kp = counts[0]
        real = sum(int(k.numel()) for k in keep)
        if real != sum(len(v[0]) for v in plan.values()):
            raise AssertionError(f"ell_absorb {label}: the in-range rows "
                                 f"are not the plan's rows")
        nbytes = 16 * slots + 4 * len(rows) * kp \
            + 8 * sum(int(k.numel()) * d for k, d in zip(keep, tables.D))
        out[label] = dict(max_abs_err=0, ms=ms, event_ms=event_ms,
                          enqueue_ms=enqueue_ms, spin_ms=spin_ms,
                          plain_ms=plain_ms,
                          bound_ms=bytes_ms(nbytes), bound_by="bytes",
                          library_ms=lib_ms, bytes=nbytes, slots=slots,
                          kp=kp, rows_replaced=real,
                          pads=len(rows) * kp - real, claims=len(claims),
                          events=events, inputs_unchanged=True)
    row = dict(out["a_4096_events"])
    row["windows"] = {k: {a: v[a] for a in ("ms", "event_ms", "enqueue_ms",
                                             "plain_ms", "library_ms",
                                             "bound_ms", "rows_replaced",
                                             "pads", "claims", "events")}
                      for k, v in out.items()}
    return {"ell_absorb": row}


# ============================================================ [write]
WRITE_SPACE = 7
WRITE_PARTS = 8
WRITE_ET = 1
WRITE_TAG = 2
WRITE_READERS = 16


class WriteOracle:
    """Plain numpy semantics of GO over a live edge set with ranks, held
    apart from the port: ``live`` maps (src, dst, rank) to ``w``.  The
    frontier advances over the distinct (src, dst) pairs (GoOracle); the
    final hop yields one row per live edge of the frontier, with its
    ``w``."""

    def __init__(self, live: dict):
        keys = np.asarray(list(live.keys()), np.int64).reshape(-1, 3)
        w = np.asarray(list(live.values()), np.int64)
        order = np.lexsort((keys[:, 2], keys[:, 1], keys[:, 0]))
        self.src, self.dst = keys[order, 0], keys[order, 1]
        self.w = w[order]
        self.go = GoOracle(self.src, self.dst)

    def rows(self, starts, steps: int, upto: bool = False):
        """Final-hop (dst, w) rows, sorted."""
        fs = self.go.frontier_sizes(starts, steps)
        f = np.unique(np.concatenate(fs)) if upto else fs[-1]
        sel = np.isin(self.src, f)
        out = np.stack([self.dst[sel], self.w[sel]], axis=1)
        return out[np.lexsort((out[:, 1], out[:, 0]))]


class WriteSpace:
    """The [write] phase's space, held in the port's own store and
    written through its processors: edge ``e(w int)`` stored in both
    directions as the insert executor writes it, tag ``person(age
    int)`` on 15/16 of the vertices, ``WRITE_PARTS`` parts.  Beside the
    live edges it keeps their forward adjacency (``adj``: src -> {dst:
    live ranks}) and, after the load, every new (src, dst) key in write
    order (``added``)."""

    def __init__(self, n: int, m: int, seed: int):
        from nebula_tpu_torch.codec.rows import encode_row
        from nebula_tpu_torch.interface.common import (ColumnDef, Schema,
                                                       SupportedType)
        from nebula_tpu_torch.kvstore.store import NebulaStore
        from nebula_tpu_torch.meta.schema_manager import AdHocSchemaManager
        from nebula_tpu_torch.storage.processors import (
            AddEdgesProcessor, AddVerticesProcessor, DeleteProcessor)
        from nebula_tpu_torch.tools.graphgen import powerlaw_graph
        self.encode = encode_row
        self.store = NebulaStore()
        for p in range(1, WRITE_PARTS + 1):
            self.store.add_part(WRITE_SPACE, p)
        self.sm = AdHocSchemaManager()
        self.e = Schema([ColumnDef("w", SupportedType.INT)])
        self.person = Schema([ColumnDef("age", SupportedType.INT)])
        self.sm.add_edge_schema(WRITE_SPACE, WRITE_ET, "e", self.e)
        self.sm.add_tag_schema(WRITE_SPACE, WRITE_TAG, "person",
                               self.person)
        self.add_e = AddEdgesProcessor(self.store, self.sm)
        self.add_v = AddVerticesProcessor(self.store, self.sm)
        self.dele = DeleteProcessor(self.store, self.sm)
        rng = np.random.default_rng(seed + 41)
        src, dst = powerlaw_graph(n, m, 2.2, 20000, seed + 40)
        w = rng.integers(0, 1000, m)
        tagged = rng.random(n + 1) >= 1 / 16
        tagged[0] = False
        self.ages = {int(v): int(a) for v, a in zip(
            np.nonzero(tagged)[0], rng.integers(0, 100, int(tagged.sum())))}
        self.live = {}
        self.adj = {}
        self.added = []
        self.lock = threading.Lock()
        t0 = time.perf_counter()
        chunk = 1 << 16
        for lo in range(0, m, chunk):
            self.write_edges([(int(s), int(d), 0, int(x)) for s, d, x in
                              zip(src[lo:lo + chunk], dst[lo:lo + chunk],
                                  w[lo:lo + chunk])])
        self.write_ages(list(self.ages.items()))
        self.added.clear()
        self.load_s = time.perf_counter() - t0
        self.out_deg = np.bincount(src, minlength=n + 1)

    def _part(self, vid: int) -> int:
        return (vid & 0xFFFFFFFFFFFFFFFF) % WRITE_PARTS + 1

    def write_edges(self, edges, both: bool = True) -> None:
        """One AddEdges request: (src, dst, rank, w) each, the reverse
        row too unless ``both`` is False."""
        parts = {}
        for s, d, r, w in edges:
            row = self.encode(self.e, {"w": w})
            for a, sgn, b in ((s, 1, d), (d, -1, s))[:2 if both else 1]:
                parts.setdefault(self._part(a), []).append(
                    {"src": a, "etype": sgn * WRITE_ET, "rank": r,
                     "dst": b, "props": row})
        self.add_e.process({"space_id": WRITE_SPACE, "parts": parts})
        with self.lock:
            for s, d, r, w in edges:
                if (s, d, r) not in self.live:
                    nb = self.adj.setdefault(s, {})
                    nb[d] = nb.get(d, 0) + 1
                    self.added.append((s, d))
                self.live[(s, d, r)] = w

    def delete_edges(self, keys) -> None:
        parts = {}
        for s, d, r in keys:
            for a, sgn, b in ((s, 1, d), (d, -1, s)):
                parts.setdefault(self._part(a), []).append(
                    [a, sgn * WRITE_ET, r, b])
        self.dele.delete_edges({"space_id": WRITE_SPACE, "parts": parts})
        with self.lock:
            for k in keys:
                if k in self.live:
                    del self.live[k]
                    nb = self.adj[k[0]]
                    nb[k[1]] -= 1
                    if not nb[k[1]]:
                        del nb[k[1]]

    def reach2(self, s: int) -> set:
        """The dsts of ``GO 1 TO 2 STEPS FROM s`` over the live edges
        (call under ``lock``)."""
        hop1 = set(self.adj.get(s, ()))
        return hop1.union(*(self.adj.get(x, ()) for x in hop1))

    def write_ages(self, pairs) -> None:
        parts = {}
        for v, a in pairs:
            parts.setdefault(self._part(v), []).append(
                {"id": v, "tags": [[WRITE_TAG,
                                    self.encode(self.person, {"age": a})]]})
        self.add_v.process({"space_id": WRITE_SPACE, "parts": parts})
        with self.lock:
            self.ages.update(dict(pairs))

    def oracle(self) -> WriteOracle:
        with self.lock:
            return WriteOracle(dict(self.live))


def write_blobs():
    """Encoded trees of the [write] phase's reads."""
    from nebula_tpu_torch.filter.expressions import _from_wire, encode_expr
    enc = lambda w: encode_expr(_from_wire(w))      # noqa: E731
    return dict(
        ydst=[(enc(["e_dst", "e"]), None)],
        yw=[(enc(["e_dst", "e"]), None), (enc(E_ + ["w"]), None)],
        w_ge0=enc(["rel", ">=", E_ + ["w"], ["lit", 0]]),
        w_gt=lambda k: enc(["rel", ">", E_ + ["w"], ["lit", int(k)]]),
        age_eq=lambda a: enc(["rel", "==", ["src", "person", "age"],
                              ["lit", int(a)]]))


def _slot_multiset(m, ix) -> np.ndarray:
    """Every filled ELL slot as (owner vid, slot vid, etype), sorted."""
    row0 = 0
    parts = []
    for nbr, et in zip(ix.bucket_nbr, ix.bucket_et):
        rows = np.arange(row0, row0 + nbr.shape[0])
        row0 += nbr.shape[0]
        owner = np.where(rows < ix.n, rows, 0)
        extra = rows >= ix.n
        owner[extra] = ix.extra_owner[rows[extra] - ix.n]
        r, c = np.nonzero(nbr != ix.n_rows)
        keep = owner[r] < ix.n
        r, c = r[keep], c[keep]
        parts.append(np.stack([m.vids[ix.inv[owner[r]]],
                               m.vids[ix.inv[nbr[r, c]]],
                               et[r, c].astype(np.int64)], axis=1))
    a = np.concatenate(parts)
    return a[np.lexsort((a[:, 2], a[:, 1], a[:, 0]))]


def write_phase(torch, ell_ops, n: int, m: int, seconds: float,
                readers: int, seed: int, device=None) -> dict:
    """The write path, counted (see the module docstring, phase 10);
    ``device`` is the runtime's (None: the card)."""
    from nebula_tpu_torch.common import protocol
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    out = {}
    t0 = time.perf_counter()
    ws = WriteSpace(n, m, seed)
    out["load_s"] = ws.load_s
    out["stored_edge_rows"] = 2 * len(ws.live)
    rt = TorchQueryRuntime(stores=[ws.store], schema_man=ws.sm,
                           device=device)
    blobs = write_blobs()
    S, E, A = WRITE_SPACE, WRITE_ET, {WRITE_ET: "e"}

    def go_w(start, steps, et=E, where=None):
        return rt.serve_go(S, [start], [et], steps, {et: "e"},
                           where_blob=where or blobs["w_ge0"],
                           yield_specs=blobs["yw"])
    try:
        t1 = time.perf_counter()
        m0 = rt.mirror(S)
        out["fold_s"] = time.perf_counter() - t1
        out["mirror"] = dict(n=m0.n, m=m0.m)
        # warm every route (ELL, tables, programs) outside the window
        rt.serve_go(S, [1], [E], 2, A, yield_specs=blobs["ydst"])
        rt.serve_go(S, [1], [E], 2, A, yield_specs=blobs["ydst"],
                    reduce=("count",))
        go_w(1, 2, where=blobs["w_gt"](500))
        go_w(1, 1, et=-E)
        rt.serve_find_path(S, [1], [2], [E], 5, True, {E: "e"})
        torch.cuda.synchronize()
        out["warm_s"] = time.perf_counter() - t1 - out["fold_s"]
        ix = rt.ell(m0)
        filled, width = _row_fill(ix)
        ecnt, _e0 = ix.hub_expansion()
        room_new = np.where(ecnt[:ix.n] == 0,
                            width[:ix.n] - filled[:ix.n], 0)
        room = room_new[ix.perm]                      # by old dense id
        cands = [int(v) for v in m0.vids[np.nonzero(room >= 4)[0]]]
        rng_c = np.random.default_rng(seed + 43)
        rng_c.shuffle(cands)
        aged = [v for v in sorted(ws.ages) if ws.out_deg[v] > 0]

        stop = [time.perf_counter() + seconds]
        errors, lat_w, lat_r, ryw, ryw_cont = [], [], [], [0], [0]
        op_seq = [10_000]
        glock = threading.Lock()

        def check_ryw(kind, key, w_old, w_new):
            s, d, _r = key
            fwd = {tuple(r) for r in go_w(s, 1)[1]}
            rev = {tuple(r) for r in go_w(d, 1, et=-E)[1]}
            if kind == "delete":
                bad = (d, w_old) in fwd or (s, w_old) in rev
            else:
                bad = (d, w_new) not in fwd or (s, w_new) not in rev \
                    or (w_old is not None and ((d, w_old) in fwd
                                               or (s, w_old) in rev))
            if bad:
                raise AssertionError(f"{kind} {key} w {w_old}->{w_new} "
                                     f"not visible after its ack")

        def check_continuous(kind, key):
            """Read-your-writes on the continuous tier: ``GO 1 TO 2 STEPS
            FROM src YIELD e._dst`` holds dst after an insert or an
            update; after a delete it holds dst only if dst is within
            two hops of src over the live edges at the query's admission
            or over an edge added while it ran (from src or to dst)."""
            s, d, _r = key
            with ws.lock:
                p0 = len(ws.added)
                reach = ws.reach2(s) if kind == "delete" else None
            got = {r[0] for r in rt.serve_go(S, [s], [E], 2, A, upto=True,
                                             yield_specs=blobs["ydst"])[1]}
            if kind != "delete":
                bad = d not in got
            else:
                with ws.lock:
                    racing = any(a == s or b == d for a, b in ws.added[p0:])
                bad = d in got and d not in reach and not racing
            if bad:
                raise AssertionError(f"continuous GO UPTO 2 FROM {s}: "
                                     f"{kind} {key} not visible after its "
                                     f"ack")
            ryw_cont[0] += 1

        def writer(wid):
            wrng = np.random.default_rng(seed + 100 + wid)
            mine = {}                         # key -> w, insertion order
            cursor = wid * max(1, len(cands) // 2)
            i = 0
            while time.perf_counter() < stop[0]:
                i += 1
                with glock:
                    op_seq[0] += 1
                    w = op_seq[0]
                t0 = time.perf_counter()
                if i % 16 == 0:
                    v = aged[int(wrng.integers(0, len(aged)))]
                    a = (ws.ages[v] + 1 + int(wrng.integers(0, 98))) % 100
                    ws.write_ages([(v, a)])
                    lat_w.append(time.perf_counter() - t0)
                    rows = rt.serve_go(S, [v], [E], 1, A,
                                       where_blob=blobs["age_eq"](a),
                                       yield_specs=blobs["ydst"])[1]
                    if not rows:
                        raise AssertionError(f"age {a} of {v} not visible "
                                             f"after its ack")
                    ryw[0] += 1
                    continue
                roll = wrng.random()
                if mine and (len(mine) >= 1024 or roll < 0.25):
                    kind = "delete" if len(mine) >= 1024 \
                        or roll < 0.125 else "update"
                elif roll < 0.45 and mine:
                    kind = "update"
                else:
                    kind = "insert"
                if kind == "delete":
                    key = next(iter(mine))            # FIFO: the oldest
                    w_old = mine.pop(key)
                    ws.delete_edges([key])
                    w_new = None
                elif kind == "update":
                    keys = list(mine)
                    key = keys[int(wrng.integers(0, len(keys)))]
                    w_old = mine[key]
                    mine[key] = w
                    ws.write_edges([key + (w,)])
                    w_new = w
                else:
                    cursor += 1
                    s = cands[cursor % len(cands)]
                    d = cands[(cursor * 7 + 3) % len(cands)]
                    key = (s, d, w)
                    mine[key] = w
                    ws.write_edges([key + (w,)])
                    w_old, w_new = None, w
                lat_w.append(time.perf_counter() - t0)
                check_ryw(kind, key, w_old, w_new)
                check_continuous(kind, key)
                ryw[0] += 1

        def reader(rid):
            rrng = np.random.default_rng(seed + 200 + rid)
            i = rid
            while time.perf_counter() < stop[0]:
                r = i % 16
                i += readers
                v = int(rrng.integers(1, n + 1))
                steps = int(rrng.integers(1, 4))
                t0 = time.perf_counter()
                if r == 0:
                    rt.serve_find_path(S, [v], [int(rrng.integers(1, n + 1))],
                                       [E], 5, True, {E: "e"})
                elif r in (1, 9):
                    go_w(v, steps, where=blobs["w_gt"](
                        rrng.integers(0, 1000)))
                else:
                    rt.serve_go(S, [v], [E], steps, A,
                                yield_specs=blobs["ydst"],
                                reduce=("count",) if r in (2, 6, 10, 14)
                                else None)
                lat_r.append(time.perf_counter() - t0)

        def guard(fn, k):
            try:
                fn(k)
            except Exception as ex:        # noqa: BLE001 — raised below
                errors.append(f"{fn.__name__} {k}: {ex!r}")
                stop[0] = 0.0

        def stream_stats():
            return {k: sum(st.stats[k] for st in rt.continuous.streams())
                    for k in ("anchors", "drains")}

        st0 = dict(rt.stats)
        ss0 = stream_stats()
        gen0 = rt.mirror(S).generation
        ell_ops.reset_launches()
        pool = [threading.Thread(target=guard, args=(writer, k))
                for k in range(2)]
        pool += [threading.Thread(target=guard, args=(reader, k))
                 for k in range(readers)]
        t_w = time.perf_counter()
        for t in pool:
            t.start()
        for t in pool:
            t.join()
        wall = time.perf_counter() - t_w
        launches = dict(ell_ops.LAUNCHES)
        if errors:
            raise AssertionError(f"{len(errors)} write-phase failures: "
                                 f"{errors[:3]}")
        m1 = rt.mirror(S)
        st = {k: rt.stats[k] - st0[k] for k in
              ("mirror_builds", "mirror_absorbs", "mirror_deltas",
               "mirror_absorb_failed", "mirror_delta_overflow",
               "mirror_slot_grows", "t_absorb_s", "t_absorb_splice_s",
               "t_absorb_ell_s")}
        walls = np.asarray(list(rt.absorb_wall_s)[-st["mirror_deltas"]:]
                           if st["mirror_deltas"] else [0.0])
        if st["mirror_builds"] != 0 or st["mirror_delta_overflow"] != 0 \
                or st["mirror_absorbs"] <= 0:
            raise AssertionError(f"the steady window rebuilt or absorbed "
                                 f"nothing: {st}")
        stream = {k: v - ss0[k] for k, v in stream_stats().items()}
        if stream["anchors"] < 1:
            raise AssertionError(f"the continuous stream never re-anchored "
                                 f"on a new generation: {stream}")
        require_launched(launches, "write")
        out.update(
            window_s=wall, writes_acked=len(lat_w),
            writes_per_s=len(lat_w) / wall, ryw_checked=ryw[0],
            ryw_continuous_checked=ryw_cont[0],
            stream=stream,
            write_p50_ms=float(np.percentile(lat_w, 50) * 1e3),
            reads=len(lat_r), reader_qps=len(lat_r) / wall,
            reader_p50_ms=float(np.percentile(lat_r, 50) * 1e3),
            reader_p99_ms=float(np.percentile(lat_r, 99) * 1e3),
            absorb_windows=st["mirror_deltas"],
            absorb_p50_ms=float(np.percentile(walls, 50) * 1e3),
            absorb_p99_ms=float(np.percentile(walls, 99) * 1e3),
            generations=int(m1.generation - gen0), counters=st,
            launches=launches)

        # ---- 64 queries against the oracle, then the rebuild oracle
        def answers(qs):
            got = []
            for v, steps, kind, k in qs:
                if kind == "fused":
                    rows = go_w(v, steps, where=blobs["w_gt"](k))[1]
                    got.append(sorted(tuple(r) for r in rows))
                else:
                    rows = rt.serve_go(S, [v], [E], steps, A,
                                       yield_specs=blobs["ydst"],
                                       reduce=("count",) if kind == "count"
                                       else None)[1]
                    got.append(rows if kind == "count"
                               else sorted(r[0] for r in rows))
            return got

        def oracle_check(qs, got, label):
            orc = ws.oracle()
            for (v, steps, kind, k), g in zip(qs, got):
                rows = orc.rows([v], steps)
                if kind == "fused":
                    want = sorted(tuple(int(x) for x in r)
                                  for r in rows if r[1] > k)
                elif kind == "count":
                    want = [[len(rows)]]
                else:
                    want = sorted(int(x) for x in rows[:, 0])
                if g != want:
                    raise AssertionError(f"{label}: GO {steps} STEPS FROM "
                                         f"{v} ({kind}) differs from the "
                                         f"oracle")

        qrng = np.random.default_rng(seed + 300)
        touched = [k[0] for k in list(ws.live)[-256:]]

        def queries(count):
            qs = []
            for j in range(count):
                v = int(touched[j % len(touched)]) if j % 2 \
                    else int(qrng.integers(1, n + 1))
                kind = ("plain", "count", "fused", "plain")[j % 4]
                qs.append((v, int(qrng.integers(1, 4)), kind,
                           int(qrng.integers(0, 1000))))
            return qs
        qs = queries(64)
        got = answers(qs)
        oracle_check(qs, got, "after the window")
        ix_a = rt.ell(m1)
        slots_a = _slot_multiset(m1, ix_a)
        t2 = time.perf_counter()
        with rt._lock:
            rt.mirrors.clear()
        m2 = rt.mirror(S)
        out["rebuild_fold_s"] = time.perf_counter() - t2
        if answers(qs) != got:
            raise AssertionError("the rebuilt mirror answers differently")
        if not np.array_equal(_slot_multiset(m2, rt.ell(m2)), slots_a):
            raise AssertionError("the rebuilt ELL holds other slots")
        out["oracle_checked"] = len(qs)

        # ---- forced windows
        forced = {}

        def forced_window(label, write, reason, **delta):
            base = dict(rt.stats)
            write()
            qs = queries(16)
            oracle_check(qs, answers(qs), label)
            got_d = {k: rt.stats[k] - base[k] for k in delta}
            if got_d != delta or rt.last_absorb_reason != reason:
                raise AssertionError(f"{label}: {got_d} "
                                     f"{rt.last_absorb_reason}, expected "
                                     f"{delta} {reason}")
            forced[label] = dict(got_d, reason=reason)

        ix2 = rt.ell(m2)
        filled, width = _row_fill(ix2)
        ecnt, _e0 = ix2.hub_expansion()
        nonhub = np.zeros(ix2.n, bool)
        nonhub[:] = ecnt[:ix2.n] == 0
        full_new = np.nonzero(nonhub & (filled[:ix2.n] == width[:ix2.n])
                              & (width[:ix2.n] < ix2.bucket_D[-1]))[0]
        free_new = np.nonzero(nonhub & (filled[:ix2.n]
                                        < width[:ix2.n]))[0]
        v = int(m2.vids[ix2.inv[full_new[0]]])
        us = [int(m2.vids[ix2.inv[r]]) for r in free_new[:3]]
        forced_window("growth", lambda: ws.write_edges(
            [(u, v, 7, 5000 + j) for j, u in enumerate(us)]),
            protocol.ABSORBED, mirror_slot_grows=1, mirror_builds=0)
        burst = [(cands[j % len(cands)], cands[(3 * j + 1) % len(cands)],
                  20 + j, 6000 + j) for j in range(2048)]
        forced_window("overflow_4097", lambda: (
            ws.write_edges(burst), ws.write_edges(
                [(cands[0], cands[1], 19, 9999)], both=False)),
            protocol.ABSORB_DELTA_OVERFLOW, mirror_delta_overflow=1,
            mirror_builds=1)
        forced_window("new_vertex", lambda: ws.write_edges(
            [(1, n + 1000, 0, 1)]), protocol.ABSORB_VERTEX_PLAN_CHANGE,
            mirror_builds=1)
        out["forced"] = forced
        out["phase_s"] = time.perf_counter() - t0
        return out
    finally:
        rt.close()


# ===================================================== phase 11, unpacked
UNPACKED = {"tpu_packed_frontier": False}
# part (a) at default routes, with a sparse cap low enough that batches
# overflow and rerun dense: at the default cap (131072 pairs) the
# [sparse] phase's batches never overflowed, and at 8192 two of 286 did
UNPACKED_SPARSE_CAP = 1024
BURST = 256                    # part (b)'s one-shape burst: > 128 queries


def unpacked_mix(rng, n: int, requests: int):
    """Phase 4's mix with ``| LIMIT LIMIT_N`` on a quarter of the plain
    exact-depth requests: (mix, limits)."""
    mix = request_mix(rng, n, requests)
    _starts, _steps, upto, count = mix
    return mix, ~upto & ~count & (rng.random(requests) < 0.25)


def go_check_set(rng, limits, requests: int) -> set:
    """64 requests to check, 16 of them LIMIT requests."""
    lim_i, rest_i = np.nonzero(limits)[0], np.nonzero(~limits)[0]
    n_lim = min(16, len(lim_i))
    return set(rng.choice(lim_i, n_lim, replace=False).tolist()) | set(
        rng.choice(rest_i, min(64 - n_lim, len(rest_i)),
                   replace=False).tolist())


def lat_stats(requests: int, wall: float, lat) -> dict:
    lat = np.asarray(lat)
    return dict(requests=requests, wall_s=wall, qps=requests / wall,
                p50_ms=float(np.percentile(lat, 50) * 1e3),
                p99_ms=float(np.percentile(lat, 99) * 1e3))


def check_paths(rt, path_oracle: PathOracle, vids: np.ndarray, srcs, dsts,
                presults, rng) -> tuple:
    """Every FIND SHORTEST PATH answer of ``drive_paths`` against the
    oracle, then 8 aimed ``FIND ALL PATH ... UPTO 3 STEPS`` (a source
    and a target it reaches within 3) served and checked.  Returns
    (reachable answers, ALL PATH pairs, their rows, their seconds)."""
    if len(presults) != len(srcs):
        raise AssertionError(f"{len(presults)} of {len(srcs)} path "
                             f"requests served")
    reachable = 0
    for i in range(len(srcs)):
        s, t = int(srcs[i]), int(dsts[i])
        want, _ = path_oracle.depths([s], [t], 5, True)
        cols, rows = presults[i]
        d = int(want[t])
        if cols != ["path"]:
            raise AssertionError(f"path request {i}: columns {cols}")
        if d == path_oracle.INF or d == 0:
            if rows:
                raise AssertionError(f"path request {i}: rows for an "
                                     f"unreached target")
            continue
        reachable += 1
        path_oracle.check(rows, path_oracle.shortest_paths([s], t, want),
                          [s], t, length=d)
    all_rows = all_checked = 0
    t_all = time.perf_counter()
    for s in rng.choice(vids, 64).tolist():
        if all_checked == 8:
            break
        reach, _ = path_oracle.depths([s], [], 3, False)
        cand = np.nonzero((reach >= 1) & (reach <= 3))[0]
        if not len(cand):
            continue
        t = int(rng.choice(cand))
        cols, rows = rt.serve_find_path(1, [s], [t], [1], 3, False,
                                        {1: "e"})
        path_oracle.check(rows, path_oracle.all_paths([s], t, 3), [s], t)
        if not rows:
            raise AssertionError(f"FIND ALL PATH {s} -> {t}: no path to a "
                                 f"reached target")
        all_checked += 1
        all_rows += len(rows)
    t_all = time.perf_counter() - t_all
    if all_checked < 8:
        raise AssertionError(f"{all_checked} FIND ALL PATH pairs found")
    return reachable, all_checked, all_rows, t_all


def unpacked_phase(torch, rt, ell_ops, flags, oracle: GoOracle,
                   path_oracle: PathOracle, vids: np.ndarray, n: int,
                   requests: int, threads: int, path_requests: int,
                   path_threads: int, seed: int) -> dict:
    """``tpu_packed_frontier=false`` on the serve graph, counted as one
    window (launch counts zeroed before part a, read after part c):
    (a) the mix in the default continuous mode (no stream may anchor:
    every GO takes the windowed sparse route, its overflowing batches
    rerun on the unpacked ``ell_go``); (b) the same mix on the dense
    route (``go_dispatch_mode=windowed``, sparse and adaptive off), then
    a burst of BURST one-shape requests so that a batch passes 128 and
    the 1024 rung runs; (c) FIND SHORTEST PATH and FIND ALL PATH.  64
    GO answers of each of (a) and (b) and every path answer are checked
    against the oracles."""
    out = {}
    rng = np.random.default_rng(seed + 17)
    mix, limits = unpacked_mix(rng, n, requests)
    check = go_check_set(rng, limits, requests)
    streams = rt.continuous.streams()
    anchored0 = [dict(s.stats) for s in streams]
    cap = {"tpu_sparse_cap": UNPACKED_SPARSE_CAP}
    with flag_mode(flags, UNPACKED), flag_mode(flags, cap):
        if rt.continuous_session(1, (1,)) is not None:
            raise AssertionError("a continuous session anchored with "
                                 "packing off")
        # warm the degree and hub tables outside the window
        rt.serve_go(1, [1], [1], 3, {1: "e"}, reduce=("count",))
        torch.cuda.synchronize()
        ell_ops.reset_launches()
        rt0 = dict(rt.stats)
        wall, lat, results = drive(rt, mix, threads, check, limits)
        stats = {k: rt.stats[k] - rt0[k] for k in rt0}
    a_launch = dict(ell_ops.LAUNCHES)
    check_go(oracle, mix, results, check, limits)
    if len(rt.continuous.streams()) != len(streams) or any(
            s.stats["anchors"] != a["anchors"] or s.stats["joins"] !=
            a["joins"] for s, a in zip(streams, anchored0)):
        raise AssertionError("a continuous stream anchored or took riders "
                             "with packing off")
    if not (stats["go_sparse"] and stats["sparse_overflows"]
            and stats["go_dense"]):
        raise AssertionError(f"part (a) did not ride the sparse route and "
                             f"its dense rerun: {stats}")
    out["a"] = dict(lat_stats(requests, wall, lat), threads=threads,
                    checked=len(check), go_sparse=stats["go_sparse"],
                    sparse_overflows=stats["sparse_overflows"],
                    go_dense=stats["go_dense"],
                    limit_requests=int(limits.sum()),
                    sparse_cap=UNPACKED_SPARSE_CAP)

    # (b) the dense route, then the wide burst
    rng_b = np.random.default_rng(seed + 19)
    check_b = go_check_set(rng_b, limits, requests)
    with flag_mode(flags, UNPACKED), flag_mode(flags, WINDOWED):
        rt0 = dict(rt.stats)
        d0 = dict(rt.dispatcher.stats)
        wall, lat, results = drive(rt, mix, threads, check_b, limits)
        stats = {k: rt.stats[k] - rt0[k] for k in rt0}
        batches = rt.dispatcher.stats["batches"] - d0["batches"]
        rt.dispatcher.stats["max_batch"] = 0      # a running max
        burst = (rng_b.integers(1, n + 1, BURST), np.full(BURST, 3),
                 np.zeros(BURST, bool), np.zeros(BURST, bool))
        with flag_mode(flags, {"go_batch_window_ms": 300}):
            b_wall, b_lat, _ = drive(rt, burst, BURST)
        burst_max = rt.dispatcher.stats["max_batch"]
    check_go(oracle, mix, results, check_b, limits)
    if stats["go_sparse"] or stats["go_adaptive"] or not stats["go_dense"]:
        raise AssertionError(f"part (b) left the dense route: {stats}")
    if burst_max <= 128:
        raise AssertionError(f"the burst's widest batch was {burst_max}, "
                             f"so the 1024 rung never ran")
    out["b"] = dict(lat_stats(requests, wall, lat), threads=threads,
                    checked=len(check_b), go_dense=stats["go_dense"],
                    batches=batches,
                    mean_batch=requests / max(batches, 1),
                    burst=dict(lat_stats(BURST, b_wall, b_lat),
                               threads=BURST, max_batch=burst_max))

    # (c) FIND SHORTEST PATH from path_threads threads, then FIND ALL
    # PATH on aimed pairs
    rng_c = np.random.default_rng(seed + 23)
    srcs = rng_c.choice(vids, path_requests)
    dsts = rng_c.choice(vids, path_requests)
    with flag_mode(flags, UNPACKED):
        rt0 = dict(rt.stats)
        wall, plat, presults = drive_paths(rt, srcs, dsts, path_threads)
        stats = {k: rt.stats[k] - rt0[k] for k in rt0}
        reachable, all_checked, all_rows, t_all = check_paths(
            rt, path_oracle, vids, srcs, dsts, presults, rng_c)
    launches = dict(ell_ops.LAUNCHES)
    require_launched(launches, "unpacked")
    with flag_mode(flags, UNPACKED):
        plain_held = bfs_plain_check(torch, ell_ops, rt, srcs[:64],
                                     dsts[:64], "unpacked")
    out["c"] = dict(lat_stats(path_requests, wall, list(plat.values())),
                    threads=path_threads, checked=path_requests,
                    checked_reachable=reachable,
                    bfs_dispatches=stats["bfs_dispatches"],
                    levels_per_dispatch=stats["bfs_levels"]
                    / max(stats["bfs_dispatches"], 1),
                    all_path_checked=all_checked, all_path_rows=all_rows,
                    all_path_s=t_all, plain_program=plain_held)
    out["launches"] = launches
    out["launches_a"] = a_launch
    return out


# ============================================================ the mesh
MESH_KS = (2, 4)               # phase 3's shard counts, all on one card
MESH_MAIN = (4, 128)           # the (k, B) the kernels line reports
MESH_VERTICES = 1 << 14        # part (d)'s store-backed space
MESH_WRITES = 64               # part (d)'s acked, read-back edge writes


MESH_SPIN = 8 * SPIN_CYCLES     # about 32 ms: a mesh program's enqueue
_MESH_SPIN_MS: list = []        # the spin's milliseconds, measured once


def mesh_queued_ms(torch, fn, label: str, iters: int = PROBE_REPS) -> float:
    """Device milliseconds of ``fn()`` over ``iters`` calls queued behind
    a MESH_SPIN spin kernel (``queued_times``); logs when the host's
    enqueue outlasted the spin, so the time holds launch gaps."""
    ms, enqueue_ms = queued_times(torch, fn, iters, MESH_SPIN)
    if not _MESH_SPIN_MS:
        _MESH_SPIN_MS.append(cuda_ms(
            torch, lambda: torch.cuda._sleep(MESH_SPIN), 1, 1))
    spin_ms = _MESH_SPIN_MS[0]
    if enqueue_ms >= spin_ms:
        log(f"[kernel] {label}: host enqueue {enqueue_ms:.3f} ms outlasted "
            f"the spin ({spin_ms:.3f} ms); its device time holds launch "
            f"gaps")
    return ms


def restored_queued_ms(torch, run, restore, label: str,
                       iters: int = 4 * PROBE_REPS) -> float:
    """``restored_ms`` in device time: ``run()`` after ``restore()``,
    less ``restore()`` alone, each queued behind a spin kernel."""
    def both():
        restore()
        run()
    return max(0.0, mesh_queued_ms(torch, both, label, iters)
               - mesh_queued_ms(torch, restore, label + " restore", iters))


def absorb_launches(torch, ell_ops, fn, groups: int, copies: int,
                    what: str) -> dict:
    """``launches_a_call`` of a mesh absorb, held to two kernels (the
    copy and the scatter) in one C call a card group and at most
    ``copies`` copies of the update set."""
    n = launches_a_call(torch, ell_ops, fn)
    kinds = n["launch_kinds"]
    kernels = kinds.get("kernel", 0)
    extra = kernels + kinds.get("memcpy", 0) - 2 * groups
    if set(kinds) - {"kernel", "memcpy"} or kernels < 2 * groups \
            or not 0 <= extra <= copies or n["c_calls_a_call"] != groups:
        raise AssertionError(f"{what}: {n['launch_kinds']} in "
                             f"{n['c_calls_a_call']} C calls a call, "
                             f"expected 2 kernels a card group in one C "
                             f"call each ({groups}), {copies} copies at "
                             f"most")
    return {a: n[a] for a in ("launches_a_call", "c_calls_a_call",
                              "launch_kinds", "launches_traced")}


def mesh_kernel_phase(torch, ell_ops, edge_ops, rt, m, ix, tables, eslot,
                      hrows, k: int, B: int, over, rng, windows) -> dict:
    """The replicated-frontier mesh's kernels and programs on the serve
    graph's tables, cut into k shards that all sit on this card (each
    shard its own buffers; what moves between shards is copied), at
    lane width B.  Exact equality throughout: ``mesh_hop``'s stages
    (one call, one launch each over every shard) against its plain
    version — M1 ``shard_hop``, M3 ``replicate_rows`` (also against the
    per-block ``copy_`` loop), ``hop_merge`` — and one whole mesh hop
    against the single-card ``go_hop``; ``ell_go_sharded`` at 1-4 steps
    against its
    plain version and the single-card ``ell_go``; ``ell_bfs_sharded`` at
    1-4 steps and UPTO 5, shortest and all, against ``ell_bfs`` (and its
    plain version); ``ell_absorb_sharded`` on ``windows`` (the absorb
    phase's three plans) against its plain version, its gathered shards
    against the single-card ``ell_absorb``, its inputs unchanged;
    ``sharded_go`` against the ``go`` program from 1 and 256 starts.
    The stages, the hop, M2 and ``ell_absorb_sharded`` report device
    time over calls queued behind a spin kernel (``ms``; their event
    time beside as ``event_ms``), ``ell_go_sharded`` adds its as
    ``device_ms``; both programs and each of ``mesh_hop``'s stages
    report their launches and checked C calls a call
    (``launches_a_call``), a stage held to its launches in one call
    (``stage_launches``).
    Bounds are the bytes each function must move over the card's rate;
    an absorb counts only the real replacement rows, once, at the
    shard that owns each.  Returns {name: numbers}."""
    from nebula_tpu_torch.tpu.ell import (absorb_live, absorb_update_arrays,
                                          mesh_tables)
    from nebula_tpu_torch.tpu.mesh import PartsMesh, replicate_rows
    dev = tables.nbr.device
    mesh = PartsMesh([dev] * k)
    mt = mesh_tables(ix, mesh)
    W = B // 8
    R1 = ix.n_rows + 1
    n_extras = ix.n_rows - ix.n
    es, hs = [eslot] * k, [hrows] * k
    blocks = [mt.owned(s) for s in range(k)]
    hub_bytes = 4 * (n_extras + int(hrows.numel()))
    res = {}

    # ---- M1 over the card's shards, on a frontier with ~2% of the real
    # rows live: one mesh_hop call (the gather stage), one launch
    fp_h = np.zeros((R1, W), np.uint8)
    live = rng.random(ix.n) < 0.02
    fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                     dtype=np.uint8)
    fp0 = torch.from_numpy(fp_h).to(dev)
    g = mesh.groups[0]
    cur = mesh.replicas(fp0)[0]
    outs = torch.empty_like(cur)

    def stage(st_, out=outs, fn=ell_ops.mesh_hop):
        return lambda: fn(cur, out, mt, g, eslot, hrows, over, st_)
    # each stage's launches, measured in the trace and by the counters
    # the C call's report moves: M1, M3 and the merge one each
    stage_n = {}
    for st_ in (ell_ops.HOP_GATHER, ell_ops.HOP_COPY, ell_ops.HOP_MERGE,
                ell_ops.HOP_STAGES):
        ok_ = torch.randint(0, 256, cur.shape, dtype=torch.uint8,
                            device=dev)
        or_ = ok_.clone()
        stage(st_, ok_)()
        stage(st_, or_, ell_ops.mesh_hop_ref)()
        require_equal(torch, f"mesh_hop k={k} stages={st_}", B, (ok_, or_))
        if dev.type == "cuda":
            moves = {"mesh_hop": 1,
                     "shard_hop": int(bool(st_ & ell_ops.HOP_GATHER)),
                     "replicate_rows": int(bool(st_ & ell_ops.HOP_COPY)),
                     "hop_merge": int(bool(st_ & ell_ops.HOP_MERGE)
                                      and n_extras > 0)}
            stage_n[st_] = stage_launches(
                torch, ell_ops, stage(st_, ok_), sum(moves.values()) - 1,
                moves, f"mesh_hop k={k} stages={st_}")
    m1_ms = mesh_queued_ms(torch, stage(ell_ops.HOP_GATHER),
                           f"shard_hop k={k} B={B}")
    m1_ev = cuda_ms(torch, stage(ell_ops.HOP_GATHER), 50)
    m1_plain = cuda_ms(torch, stage(ell_ops.HOP_GATHER,
                                    fn=ell_ops.mesh_hop_ref), 2, warmup=1)
    owned = sum(hi - lo for rows in blocks for lo, hi in rows)
    slots_all = sum(int(t.nbr.numel()) for t in mt.shards)
    res["shard_hop"] = dict(
        max_abs_err=0, ms=m1_ms, event_ms=m1_ev, plain_ms=m1_plain,
        bound_ms=bytes_ms(8 * slots_all + k * R1 * W + (owned + k) * W),
        bound_by="bytes", library_ms=None, k=k,
        **stage_n.get(ell_ops.HOP_GATHER, {}),
        library_none="none: no PyTorch call gathers over ELL slots with "
                     "an etype mask")

    # ---- M3: every shard's owned rows to the card's other replicas, one
    # launch, against the per-block copy_ loop it replaced
    bufs = torch.randint(0, 256, cur.shape, dtype=torch.uint8, device=dev)
    bk_, br_ = bufs.clone(), bufs.clone()
    ell_ops.mesh_hop(cur, bk_, mt, g, eslot, hrows, over, ell_ops.HOP_COPY)
    copy_bytes = replicate_rows(list(br_.unbind(0)), blocks,
                                lambda _m: None,
                                tuple((dev, (s,)) for s in range(k)))
    require_equal(torch, f"replicate_rows k={k}", B, (bk_, br_))
    del bk_, br_
    rows_b = list(bufs.unbind(0))
    loop = lambda: replicate_rows(  # noqa: E731
        rows_b, blocks, lambda _m: None,
        tuple((dev, (s,)) for s in range(k)))
    copy_ms = mesh_queued_ms(torch, stage(ell_ops.HOP_COPY, bufs),
                             f"replicate_rows k={k} B={B}")
    copy_ev = cuda_ms(torch, stage(ell_ops.HOP_COPY, bufs), 20)
    copy_plain = cuda_ms(torch, stage(ell_ops.HOP_COPY, bufs,
                                      ell_ops.mesh_hop_ref), 5)
    loop_ms = cuda_ms(torch, loop, 20)
    loop_dev = mesh_queued_ms(torch, loop, f"copy_ loop k={k} B={B}")
    del bufs, rows_b
    res["replicate_rows"] = dict(
        max_abs_err=0, ms=copy_ms, event_ms=copy_ev, plain_ms=copy_plain,
        bound_ms=bytes_ms(k * ix.n_rows * W), bound_by="bytes",
        library_ms=loop_ms,
        library_call="Tensor.copy_ per (owned block, receiver), events",
        library_device_ms=loop_dev, **stage_n.get(ell_ops.HOP_COPY, {}),
        copies_replaced=sum(len(r) for r in blocks) * (k - 1),
        bytes=copy_bytes, k=k)

    # ---- the hub merge on every replica, one launch
    stage(ell_ops.HOP_GATHER)()
    pre = outs.clone()
    merge_ms = restored_queued_ms(torch, stage(ell_ops.HOP_MERGE),
                                  lambda: outs.copy_(pre),
                                  f"hop_merge k={k} B={B}")
    merge_ev = restored_ms(torch, stage(ell_ops.HOP_MERGE),
                           lambda: outs.copy_(pre), 50)
    merge_plain = restored_ms(torch, stage(ell_ops.HOP_MERGE,
                                           fn=ell_ops.mesh_hop_ref),
                              lambda: outs.copy_(pre), 3)
    n_owners = int(torch.unique(hrows[eslot.long()]).numel()) \
        if n_extras else 0
    res["hop_merge"] = dict(
        max_abs_err=0, ms=merge_ms, event_ms=merge_ev, plain_ms=merge_plain,
        bound_ms=bytes_ms(hub_bytes + k * (n_extras + 2 * n_owners) * W),
        bound_by="bytes", library_ms=None,
        library_none="none: torch has no OR scatter (scatter_reduce_ "
                     "has no bitwise or)", n_extras=n_extras,
        owners=n_owners, replicas=k, **stage_n.get(ell_ops.HOP_MERGE, {}))

    # ---- one whole mesh hop (one call, three launches) against the
    # single-card hop
    stage(ell_ops.HOP_STAGES)()
    single = torch.empty_like(fp0)
    ell_ops.go_hop(fp0, None, single, tables, eslot, hrows, over)
    require_equal(torch, f"mesh hop k={k}", B,
                  *[(o, single) for o in outs.unbind(0)])
    hop_ms = mesh_queued_ms(torch, stage(ell_ops.HOP_STAGES),
                            f"mesh_hop k={k} B={B}")
    mesh_hop_ms = cuda_ms(torch, stage(ell_ops.HOP_STAGES), 20)
    hop_plain = cuda_ms(torch, stage(ell_ops.HOP_STAGES,
                                     fn=ell_ops.mesh_hop_ref), 2, warmup=1)
    go_hop_ms = cuda_ms(torch, lambda: ell_ops.go_hop(
        fp0, None, single, tables, eslot, hrows, over), 20)
    res["mesh_hop"] = dict(
        max_abs_err=0, ms=hop_ms, event_ms=mesh_hop_ms, plain_ms=hop_plain,
        bound_ms=res["shard_hop"]["bound_ms"]
        + res["replicate_rows"]["bound_ms"] + res["hop_merge"]["bound_ms"],
        bound_by="bytes", library_ms=None,
        library_none="none: three kernels (M1, M3, the merge)", k=k,
        single_card_go_hop_ms=go_hop_ms,
        **stage_n.get(ell_ops.HOP_STAGES, {}))

    # ---- the BFS level stage (one launch over the card's replicas): the
    # first pass on the start replicas, then a level on the whole hop's
    # output, against mesh_level_ref and the single-card bfs_level, in
    # the result's int8 form
    tl = torch.from_numpy(np.where(rng.random((R1, W)) < 0.02,
                                   rng.integers(0, 256, (R1, W)), 0)
                          .astype(np.uint8)).to(dev)
    sl = torch.empty((R1, W), dtype=torch.uint8, device=dev)
    dl = torch.empty((R1, B), dtype=torch.int8, device=dev)
    fl = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    ML = ell_ops.MeshLevel

    def level(nxt_, s_, d_, fl_, first, fn=ell_ops.mesh_hop):
        stages = ell_ops.HOP_LEVEL
        return lambda: fn(outs if nxt_ is cur else cur, nxt_, mt, g, eslot,
                          hrows, over, stages, ML(tl, s_, d_, fl_, 0, first,
                                                  True))
    start_rep = cur.clone()
    level(cur, sl, dl, fl[0], True)()
    s_ref, d_ref, f_ref = torch.empty_like(sl), torch.empty_like(dl), \
        torch.zeros_like(fl[0])
    ell_ops.mesh_level_ref(start_rep.clone(), ML(tl, s_ref, d_ref, f_ref, 0,
                                                 True, True))
    s_one, d_one, f_one = torch.empty_like(sl), torch.empty_like(dl), \
        torch.zeros_like(fl[0])
    ell_ops.bfs_level(fp0.clone(), tl, s_one, d_one, f_one, 0, first=True)
    require_equal(torch, f"mesh_level first k={k}", B, (cur, start_rep),
                  (sl, s_ref), (dl, d_ref), (sl, s_one), (dl, d_one),
                  (fl[0], f_ref), (fl[0], f_one))
    first_ms = mesh_queued_ms(torch, level(cur, sl, dl, fl[0], True),
                              f"mesh_level first k={k} B={B}")
    stage(ell_ops.HOP_STAGES)()          # outs: the hop's output replicas
    hop_out, s_first, d_first = outs.clone(), sl.clone(), dl.clone()
    level(outs, sl, dl, fl[1], False)()
    n_ref, s_ref, d_ref, f_ref = hop_out.clone(), s_first.clone(), \
        d_first.clone(), torch.zeros_like(fl[1])
    ell_ops.mesh_level_ref(n_ref, ML(tl, s_ref, d_ref, f_ref, 0, False,
                                     True))
    n_one, s_one, d_one, f_one = hop_out[0].clone(), s_first.clone(), \
        d_first.clone(), torch.zeros_like(fl[1])
    ell_ops.bfs_level(n_one, tl, s_one, d_one, f_one, 0)
    require_equal(torch, f"mesh_level k={k}", B, (outs, n_ref),
                  (sl, s_ref), (dl, d_ref), (fl[1], f_ref), (sl, s_one),
                  (dl, d_one), (fl[1], f_one),
                  *[(o, n_one) for o in outs.unbind(0)])

    def lv_restore():
        outs.copy_(hop_out)
        sl.copy_(s_first)
        dl.copy_(d_first)
    lv_ms = restored_queued_ms(torch, level(outs, sl, dl, fl[2], False),
                               lv_restore, f"mesh_level k={k} B={B}")
    lv_ev = restored_ms(torch, level(outs, sl, dl, fl[2], False),
                        lv_restore, 20)
    lv_plain = restored_ms(torch, level(outs, sl, dl, fl[2], False,
                                        ell_ops.mesh_hop_ref), lv_restore, 3)
    one_ms = restored_ms(torch, lambda: ell_ops.bfs_level(
        outs[0], tl, sl, dl, fl[2], 0), lv_restore, 20)
    lv_restore()
    stage_lv = {}
    if dev.type == "cuda":
        stage_lv = stage_launches(
            torch, ell_ops, level(outs, sl, dl, fl[2], False), 1,
            {"mesh_hop": 1, "mesh_level": 1, "shard_hop": 0,
             "replicate_rows": 0, "hop_merge": 0}, f"mesh_level k={k}")
    lv_restore()
    lb = k3_level_bytes(torch, ell_ops, hop_out[0], s_first, tl, 1,
                        replicas=k)
    fb = k3_first_bytes(R1, W, 1)
    res["mesh_level"] = dict(
        max_abs_err=0, ms=lv_ms, event_ms=lv_ev, plain_ms=lv_plain,
        bound_ms=bytes_ms(min(lb["bytes"], lb["old_bytes"])),
        old_bound_ms=bytes_ms(lb["old_bytes"]),
        seen_bound_ms=bytes_ms(lb["bytes"]),
        bound_by="bytes", library_ms=None,
        library_none="none: a depth update with its loop flags", k=k,
        first_ms=first_ms,
        first_bound_ms=bytes_ms(min(fb["bytes"], fb["old_bytes"])),
        first_old_bound_ms=bytes_ms(fb["old_bytes"]),
        single_card_bfs_level_ms=one_ms, replicas_written=k,
        changed_words=lb["changed_words"], live_bits=lb["live_bits"],
        newly_bits=lb["newly_bits"], **stage_lv)
    del hop_out, s_first, d_first, n_ref, s_ref, d_ref, n_one, s_one, \
        d_one, start_rep

    # ---- ell_go_sharded at 1-4 steps; B queries, one start each
    starts = rng.integers(0, ix.n, B)
    f0 = rt._upload_frontier_packed(ix, ix.perm[starts],
                                    np.arange(B, dtype=np.int32), B)
    for steps in (1, 2, 3, 4):
        gk = ell_ops.ell_go_sharded(f0, mt, es, hs, over, steps)
        gr = ell_ops.ell_go_sharded_ref(f0, mt, es, hs, over, steps)
        one = ell_ops.ell_go(f0.clone(), tables, eslot, hrows, over, steps)
        require_equal(torch, f"ell_go_sharded k={k} steps={steps}", B,
                      *[(a, gr[0]) for a in gk + gr[1:]], (gk[0], one))
    go_ms = cuda_ms(torch, lambda: ell_ops.ell_go_sharded(
        f0, mt, es, hs, over, 3), 10)
    go_dev = mesh_queued_ms(torch, lambda: ell_ops.ell_go_sharded(
        f0, mt, es, hs, over, 3), f"ell_go_sharded k={k} B={B}")
    go_plain = cuda_ms(torch, lambda: ell_ops.ell_go_sharded_ref(
        f0, mt, es, hs, over, 3), 1, warmup=0)
    one_ms = cuda_ms(torch, lambda: ell_ops.ell_go(
        f0.clone(), tables, eslot, hrows, over, 3), 10)
    go_bytes = 2 * (8 * slots_all + (1 + k) * R1 * W + hub_bytes)
    res["ell_go_sharded"] = dict(
        max_abs_err=0, ms=go_ms, plain_ms=go_plain,
        bound_ms=bytes_ms(go_bytes), bound_by="bytes", library_ms=None,
        library_none="none: a multi-kernel program", k=k, steps=3,
        device_ms=go_dev, single_card_ell_go_ms=one_ms,
        mesh_hop_ms=mesh_hop_ms,
        single_card_go_hop_ms=go_hop_ms, copy_ms=copy_ms,
        copy_bytes=copy_bytes,
        copy_bound_ms=res["replicate_rows"]["bound_ms"],
        **launches_a_call(torch, ell_ops, lambda: ell_ops.ell_go_sharded(
            f0, mt, es, hs, over, 3)))

    # ---- ell_bfs_sharded, shortest and all, UPTO 5
    t0 = rt._upload_frontier_packed(ix, ix.perm[rng.integers(0, ix.n, B)],
                                    np.arange(B, dtype=np.int32), B)
    for steps in (1, 2, 3, 4):      # the shorter programs, untimed
        dk, lk = ell_ops.ell_bfs_sharded(f0, t0, mt, es, hs, over, steps)
        dr, lr = ell_ops.ell_bfs_sharded_ref(f0, t0, mt, es, hs, over,
                                             steps)
        d1, l1 = ell_ops.ell_bfs(f0.clone(), t0, tables, eslot, hrows, over,
                                 steps)
        require_equal(torch, f"ell_bfs_sharded k={k} steps={steps}", B,
                      (dk, dr), (dk, d1))
        if not lk == lr == l1:
            raise AssertionError(f"ell_bfs_sharded ran {lk} levels, plain "
                                 f"{lr}, ell_bfs {l1}")
    bfs_rows = {}
    for stop in (True, False):
        dk, lk = ell_ops.ell_bfs_sharded(f0, t0, mt, es, hs, over, 5, stop)
        dr, lr = ell_ops.ell_bfs_sharded_ref(f0, t0, mt, es, hs, over, 5,
                                             stop)
        d1, l1 = ell_ops.ell_bfs(f0.clone(), t0, tables, eslot, hrows, over,
                                 5, stop)
        require_equal(torch, f"ell_bfs_sharded k={k} stop={stop}", B,
                      (dk, dr), (dk, d1))
        if not lk == lr == l1:
            raise AssertionError(f"ell_bfs_sharded ran {lk} levels, plain "
                                 f"{lr}, ell_bfs {l1}")
        ms = cuda_ms(torch, lambda: ell_ops.ell_bfs_sharded(
            f0, t0, mt, es, hs, over, 5, stop), 3, 1)
        plain = cuda_ms(torch, lambda: ell_ops.ell_bfs_sharded_ref(
            f0, t0, mt, es, hs, over, 5, stop), 1, warmup=0)
        one = cuda_ms(torch, lambda: ell_ops.ell_bfs(
            f0.clone(), t0, tables, eslot, hrows, over, 5, stop), 3, 1)
        # the hops, then a card group's level passes: its targets read,
        # its reached bitmap written and read, its int8 depth matrix
        # written once (the design before the level stage kept an int16
        # depth matrix and the targets once a shard, and converted the
        # result: old_bound_ms)
        hops_bytes = lk * (8 * slots_all + (1 + k) * R1 * W + hub_bytes)
        groups = len(mt.mesh.groups)
        nbytes = hops_bytes + groups * (3 * R1 * W + R1 * B)
        old_bytes = hops_bytes + k * (2 * R1 * B + 2 * R1 * W) + 3 * R1 * B
        bfs_rows[stop] = dict(max_abs_err=0, ms=ms, plain_ms=plain,
                              bound_ms=bytes_ms(nbytes), bound_by="bytes",
                              library_ms=None, levels=lk,
                              old_bound_ms=bytes_ms(old_bytes),
                              card_groups=groups,
                              single_card_ell_bfs_ms=one)
    # its launches: the loop replayed with the level flags a run read
    # (nothing waits on the card, so it captures), plus those reads
    flag_reads = []

    def bfs_loop(read):
        return ell_ops._bfs_sharded_loop(
            f0, t0, mt, es, hs, over, 5, True, ell_ops.mesh_hop, read=read)
    bfs_loop(lambda flag: flag_reads.append(flag.tolist())
             or flag_reads[-1])

    def bfs_replay():
        it = iter(flag_reads)
        return bfs_loop(lambda _flag: next(it))
    res["ell_bfs_sharded"] = dict(
        bfs_rows[True], library_none="none: a multi-kernel program", k=k,
        max_steps=5, all_paths=bfs_rows[False],
        **launches_a_call(torch, ell_ops, lambda: ell_ops.ell_bfs_sharded(
            f0, t0, mt, es, hs, over, 5, True), replay=bfs_replay,
            reads=len(flag_reads)))

    # ---- ell_absorb_sharded on the absorb phase's three plans: one
    # mesh_absorb a card group (a copy of its members' tables, then one
    # walk over the update set, read in place), on one card and over two
    # pretended cards (the second group takes one copy of the set)
    absorb = {}
    m2 = {}
    half = (k + 1) // 2
    mesh2 = PartsMesh([dev] * k)
    mesh2.groups = ((dev, tuple(range(half))), (dev, tuple(range(half, k))))
    mt2 = mt._replace(mesh=mesh2)
    for label, (plan, claims, _events) in windows.items():
        _counts, upd = absorb_update_arrays(ix, plan)
        rows, nn, ne = rt._absorb_args(upd)
        live = absorb_live(ix, plan)
        before = [(t.nbr.clone(), t.et.clone()) for t in mt.shards]
        want = ell_ops.ell_absorb_sharded_ref(mt, rows, nn, ne)
        one = ell_ops.ell_absorb(tables, rows, nn, ne)
        for lv in (None, live):
            for cards, m_ in (("one card", mt), ("two cards", mt2)):
                got = ell_ops.ell_absorb_sharded(m_, rows, nn, ne, lv)
                pairs = []
                for a, b in zip(got.shards, want.shards):
                    pairs += [(a.nbr, b.nbr), (a.et, b.et)]
                for b in range(len(tables.D)):
                    real = mt.real_rows[b]
                    for col in (0, 1):
                        gathered = torch.cat([t.bucket(b)[col] for t in
                                              got.shards])[:real]
                        pairs.append((gathered, one.bucket(b)[col]))
                require_equal(torch, f"ell_absorb_sharded k={k} {label} "
                              f"{cards} live={lv is not None}", 0, *pairs)
        for t, (n0, e0) in zip(mt.shards, before):
            if not (torch.equal(t.nbr, n0) and torch.equal(t.et, e0)):
                raise AssertionError(f"ell_absorb_sharded {label} changed "
                                     f"its input tables")
        del got, want, one, before, pairs
        kp = int(rows[0].numel())
        nb = len(rows)
        n_real = [int((r.long() < mt.real_rows[b]).sum())
                  for b, r in enumerate(rows)]
        if n_real != list(live):
            raise AssertionError(f"ell_absorb_sharded {label}: the plan's "
                                 f"{live} real rows, the set holds "
                                 f"{n_real}")
        walked = 4 * sum(live) + 8 * sum(c * d for c, d in
                                         zip(live, mt.shards[0].D))
        ms_s, ev_s, plain_s, lib_s, bound_s = [], [], [], [], []
        owned = [0] * nb
        for s in range(k):
            t = mt.shards[s]
            # M2 through its one-member call: shard s's copy, then the
            # walk over the whole set, keeping the rows it owns
            kern = lambda: ell_ops.shard_absorb(  # noqa: E731
                mt, s, rows, nn, ne, live)
            ev_s.append(cuda_ms(torch, kern, ABSORB_ITERS))
            ms_s.append(mesh_queued_ms(torch, kern,
                                       f"shard_absorb k={k} s={s}"))
            plain_s.append(cuda_ms(torch, lambda: ell_ops.shard_absorb_ref(
                mt, s, rows, nn, ne, live), 3, warmup=1))
            keep = []
            for b, r in enumerate(rows):
                r = r[:live[b]].long()
                loc = r - s * t.rows[b]
                keep.append(((loc >= 0) & (loc < t.rows[b]))
                            .nonzero().squeeze(1))
                owned[b] += int(keep[b].numel())
            idx = [rows[b][:live[b]].long()[keep[b]] - s * t.rows[b]
                   for b in range(nb)]
            n_in = [nn[b][keep[b]].contiguous() for b in range(nb)]
            e_in = [ne[b][keep[b]].contiguous() for b in range(nb)]

            def lib(t=t, idx=idx, n_in=n_in, e_in=e_in):
                a, e = t.nbr.clone(), t.et.clone()
                for b in range(len(idx)):
                    lo, cnt = t.slot0[b], t.rows[b] * t.D[b]
                    shape = (t.rows[b], t.D[b])
                    a[lo:lo + cnt].view(shape).index_copy_(0, idx[b],
                                                           n_in[b])
                    e[lo:lo + cnt].view(shape).index_copy_(0, idx[b],
                                                           e_in[b])
                return a, e
            lib_s.append(cuda_ms(torch, lib, ABSORB_ITERS))
            # its tables copied, every walked row's index read, its own
            # rows' contents read
            bound_s.append(bytes_ms(
                16 * int(t.nbr.numel()) + 4 * sum(live)
                + 8 * sum(int(x.numel()) * d for x, d in zip(keep, t.D))))
        if owned != n_real:
            raise AssertionError(f"ell_absorb_sharded {label}: the shards "
                                 f"own {owned} real rows, the set holds "
                                 f"{n_real}")
        prog = lambda: ell_ops.ell_absorb_sharded(  # noqa: E731
            mt, rows, nn, ne, live)
        prog2 = lambda: ell_ops.ell_absorb_sharded(  # noqa: E731
            mt2, rows, nn, ne, live)
        prog_ev = cuda_ms(torch, prog, ABSORB_ITERS)
        prog_ms = mesh_queued_ms(torch, prog, f"ell_absorb_sharded k={k}")
        prog_plain = cuda_ms(torch, lambda: ell_ops.ell_absorb_sharded_ref(
            mt, rows, nn, ne, live), 3, warmup=1)
        prog_bytes = 16 * sum(int(t.nbr.numel()) for t in mt.shards) \
            + walked
        # by capture: a copy and a scatter a card group, one C call a
        # group; over two pretended cards also the second group's one
        # copy of the update set
        counts_ = [absorb_launches(torch, ell_ops, f, groups, copies,
                                   f"{what} {label}")
                   for f, groups, copies, what in (
                       (prog, 1, 0, f"ell_absorb_sharded k={k}"),
                       (prog2, 2, 1, f"ell_absorb_sharded k={k} two cards"),
                       (lambda: ell_ops.shard_absorb(
                           mt, k - 1, rows, nn, ne, live), 1, 0,
                        f"shard_absorb k={k}"))]
        absorb[label] = dict(
            max_abs_err=0, ms=prog_ms, event_ms=prog_ev, plain_ms=prog_plain,
            bound_ms=bytes_ms(prog_bytes), bound_by="bytes",
            library_ms=None, claims=len(claims), kp=kp,
            rows_replaced=sum(n_real), pads=nb * kp - sum(n_real),
            two_cards=dict(ms=mesh_queued_ms(
                torch, prog2, f"ell_absorb_sharded k={k} two cards"),
                event_ms=cuda_ms(torch, prog2, ABSORB_ITERS), **counts_[1]),
            **counts_[0])
        m2[label] = dict(max_abs_err=0, ms=float(np.mean(ms_s)),
                         event_ms=float(np.mean(ev_s)),
                         plain_ms=float(np.mean(plain_s)),
                         bound_ms=float(np.mean(bound_s)), bound_by="bytes",
                         library_ms=float(np.mean(lib_s)),
                         library_call="clone + index_copy_",
                         per_shard_ms=ms_s, **counts_[2])
    keys = ("ms", "event_ms", "plain_ms", "bound_ms", "claims",
            "launches_a_call", "c_calls_a_call")
    res["ell_absorb_sharded"] = dict(
        absorb["a_4096_events"], k=k, inputs_unchanged=True,
        library_none="none: a per-shard program",
        windows={a: {x: v[x] for x in keys} for a, v in absorb.items()})
    res["shard_absorb"] = dict(
        m2["a_4096_events"], k=k,
        windows={a: {x: v[x] for x in ("ms", "event_ms", "plain_ms",
                                       "bound_ms", "library_ms",
                                       "launches_a_call")}
                 for a, v in m2.items()})

    # ---- sharded_go (edge-sharded, psum_or) against the go program
    src_h = m.edge_src.astype(np.int32)
    dst_h = m.edge_dst.astype(np.int32)
    et_h = m.edge_etype.astype(np.int32)
    src_sh, dst_sh, et_sh, size = edge_ops.shard_edges(mesh, src_h, dst_h,
                                                       et_h)
    up = lambda a: torch.from_numpy(a).to(dev)      # noqa: E731
    e_src, e_dst, e_et = up(src_h), up(dst_h), up(et_h)
    e_rp = up(m.row_ptr.astype(np.int32))
    n = m.n
    for S in (1, 256):
        idx_h = rng.integers(0, n, S).astype(np.int32)
        idx = up(idx_h)
        f0b = torch.zeros(n, dtype=torch.bool, device=dev)
        f0b[idx.long()] = True
        fin, fr = edge_ops.sharded_go(src_sh, dst_sh, et_sh, f0b, n, 3,
                                      over, mesh)
        fin_r, fr_r = edge_ops.sharded_go_ref(src_sh, dst_sh, et_sh, f0b, n,
                                              3, over, mesh)
        gm, gf = edge_ops.go(e_src, e_dst, e_et, e_rp, idx, n, 3, over)
        require_equal(torch, f"sharded_go k={k} S={S}", 0,
                      (torch.cat(fin), torch.cat(fin_r)),
                      (torch.cat(fin)[:m.m], gm),
                      *[(a, gf) for a in fr + fr_r])
    sg_ms = cuda_ms(torch, lambda: edge_ops.sharded_go(
        src_sh, dst_sh, et_sh, f0b, n, 3, over, mesh), 10)
    sg_plain = cuda_ms(torch, lambda: edge_ops.sharded_go_ref(
        src_sh, dst_sh, et_sh, f0b, n, 3, over, mesh), 3, warmup=1)
    go1_ms = cuda_ms(torch, lambda: edge_ops.go(e_src, e_dst, e_et, e_rp,
                                                idx, n, 3, over), 10)
    sg_bytes = 2 * (12 * size + 3 * k * n + 2 * k * (k - 1) * n) \
        + 9 * size + k * n
    res["sharded_go"] = dict(
        max_abs_err=0, ms=sg_ms, plain_ms=sg_plain,
        bound_ms=bytes_ms(sg_bytes), bound_by="bytes", library_ms=None,
        library_none="none: a multi-kernel program", k=k, steps=3,
        starts=256, single_card_go_ms=go1_ms)

    # ---- edge_scan_hop (sharded_go's hop) on shard 0's slice, from the
    # 2-step frontier of the 256 starts
    f2 = edge_ops.go(e_src, e_dst, e_et, e_rp, idx, n, 2, over)[1]
    sk, sr = (torch.empty(n, dtype=torch.bool, device=dev)
              for _ in range(2))
    edge_ops.edge_scan_hop(f2, sk, src_sh[0], dst_sh[0], et_sh[0], over)
    edge_ops.edge_scan_hop_ref(f2, sr, src_sh[0], dst_sh[0], et_sh[0], over)
    require_equal(torch, f"edge_scan_hop k={k}", 0, (sk, sr))

    def scan():
        edge_ops.edge_scan_hop(f2, sk, src_sh[0], dst_sh[0], et_sh[0], over)
    res["edge_scan_hop"] = dict(
        max_abs_err=0, ms=queued_ms(torch, scan, 8),
        event_ms=cuda_ms(torch, scan, 20),
        plain_ms=cuda_ms(torch, lambda: edge_ops.edge_scan_hop_ref(
            f2, sr, src_sh[0], dst_sh[0], et_sh[0], over), 3, 1),
        bound_ms=bytes_ms(edge_pass_bytes(torch, edge_ops, f2, src_sh[0],
                                          et_sh[0], over, "hop")),
        bound_by="bytes", library_ms=None,
        library_none="none: scatter_reduce_ needs the active mask first",
        k=k, slice_edges=int(src_sh[0].numel()), frontier=int(f2.sum()))

    # ---- or_into (or_many's one-source call) on two [n] bitmaps
    n4 = -(-n // 4) * 4
    a = (torch.rand(n4, device=dev) < 0.01)
    b = (torch.rand(n4, device=dev) < 0.01)
    ok_, or_ = b.clone(), b.clone()
    ell_ops.or_into(a, ok_)
    ell_ops.or_into_ref(a, or_)
    require_equal(torch, f"or_into k={k}", 0, (ok_, or_))
    one = lambda: ell_ops.or_into(a, ok_)                   # noqa: E731
    lib_or = lambda: torch.bitwise_or(or_, a, out=or_)      # noqa: E731
    or_plain = cuda_ms(torch, lambda: ell_ops.or_into_ref(a, or_), 50)
    res["or_into"] = dict(
        max_abs_err=0, ms=queued_ms(torch, one, 50), plain_ms=or_plain,
        bound_ms=bytes_ms(3 * n4), bound_by="bytes",
        library_ms=queued_ms(torch, lib_or, 50),
        library_call="bitwise_or", event_ms=cuda_ms(torch, one, 50),
        library_event_ms=cuda_ms(torch, lib_or, 50), bytes=n4)
    return res


PSUM_BYTES = (1 << 19, 8)      # psum_or's sizes: a [n] bitmap, a ctl word
PSUM_ROUNDS = 4                # event timings of each composition


def psum_phase(torch, ell_ops, psum_or, k: int, dev, rng) -> dict:
    """``mesh.psum_or`` over k shards on this card (receive slabs, one
    ``or_many`` a shard) against the pairwise composition it replaced
    (each received partial OR-ed in by its own ``or_into``) and the same
    pairs combined by ``torch.bitwise_or``: equal outputs, the OR
    launches of one call, and event times over back-to-back calls (the
    median of PSUM_ROUNDS measurements each, the three taken in turns,
    forward then backward, since the host's launch path is most of the
    time), at a bitmap of 2^19 bytes and at one 8-byte word (the agreed
    overflow's)."""
    res = {}
    for nb in PSUM_BYTES:
        parts = [torch.from_numpy(
            rng.integers(0, 256, nb, dtype=np.uint8)
            & (rng.random(nb) < 0.05).astype(np.uint8) * 255).to(dev)
            for _ in range(k)]
        outs = {c: [torch.empty(nb, dtype=torch.uint8, device=dev)
                    for _ in range(k)]
                for c in ("slab", "pairwise", "torch")}
        slabs = [torch.empty((k - 1, nb), dtype=torch.uint8, device=dev)
                 for _ in range(k)]
        recv = [torch.empty(nb, dtype=torch.uint8, device=dev)
                for _ in range(k)]

        def pairwise(combine, out_list):
            for s, out in enumerate(out_list):
                out.copy_(parts[s])
                for t, p in enumerate(parts):
                    if t != s:
                        recv[s].copy_(p)
                        combine(recv[s], out)
        runs = {
            "slab": lambda: psum_or(parts, outs["slab"], slabs,
                                    ell_ops.or_many),
            "pairwise": lambda: pairwise(ell_ops.or_into, outs["pairwise"]),
            "torch": lambda: pairwise(
                lambda r, o: torch.bitwise_or(o, r, out=o), outs["torch"])}
        row, times = {}, {c: [] for c in runs}
        for c, fn in runs.items():
            before = ell_ops.LAUNCHES["or_into"]
            fn()
            row[f"{c}_launches"] = ell_ops.LAUNCHES["or_into"] - before
        for r in range(PSUM_ROUNDS):
            for c in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
                times[c].append(cuda_ms(torch, runs[c], 50))
        for c, ts in times.items():
            row[f"{c}_ms"] = float(np.median(ts))
        want = parts[0].clone()
        for p in parts[1:]:
            want |= p
        require_equal(torch, f"psum_or k={k} bytes={nb}", 0,
                      *[(o, want) for c in outs for o in outs[c]])
        if row["slab_launches"] != k or \
                row["pairwise_launches"] != k * (k - 1):
            raise AssertionError(f"psum_or k={k}: {row['slab_launches']} "
                                 f"OR launches (want {k}), pairwise "
                                 f"{row['pairwise_launches']}")
        row["bound_ms"] = bytes_ms(k * (3 * k + 1) * nb)
        res[nb] = row
    return res


MESH = {"tpu_mesh_devices": 4, "tpu_mesh_mode": "dense"}
# a mesh path that quietly ran single-device would launch one of these
SINGLE_CARD = ("go_hop", "ell_go", "go_count", "sparse_go", "adaptive_go",
               "ell_absorb", "go_hop_i8", "lane_join", "bfs_level")


def mesh_write_part(torch, ell_ops, flags, dev, seed: int,
                    writes: int = MESH_WRITES, sparse: bool = False) -> dict:
    """Phase 12 (d), and with ``sparse`` phase 13 (c): a store-backed
    space (``WriteSpace`` at MESH_VERTICES vertices) served on a 4-shard
    mesh on this card, windowed.  ``writes`` new edges s -> d are
    written one at a time; each is read back by a mesh GO from both
    ends (``GO 2 STEPS FROM s`` must yield every out-neighbour of d,
    ``GO 2 STEPS FROM d REVERSELY`` every in-neighbour of s; every
    eighth checked whole against the oracle).  Then the row-sharded
    tables (dense mode) must equal ``shard_ell`` of the host's new ELL,
    or (sparse mode) the newest generation's chunk-sharded view must
    equal ``build_sharded_ell`` of it."""
    from nebula_tpu_torch.tpu.ell import build_sharded_ell, shard_ell
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    ws = WriteSpace(MESH_VERTICES, 8 * MESH_VERTICES, seed + 5)
    rt = TorchQueryRuntime(stores=[ws.store], schema_man=ws.sm, device=dev,
                           mesh_devices=[dev] * MESH["tpu_mesh_devices"])
    S, E = WRITE_SPACE, WRITE_ET
    rng = np.random.default_rng(seed + 61)
    out = {"load_s": ws.load_s}
    try:
        with flag_mode(flags, {"go_dispatch_mode": "windowed"}):
            t0 = time.perf_counter()
            rt.serve_go(S, [1], [E], 2, {E: "e"})
            out["fold_s"] = time.perf_counter() - t0
            radj = {}
            for (a, b, _r) in ws.live:
                radj.setdefault(b, set()).add(a)
            outv = np.nonzero(ws.out_deg > 0)[0]
            inv_ = np.asarray(sorted(radj), np.int64)
            lat = []
            checked_whole = 0
            for i in range(writes):
                while True:
                    s_, d_ = int(rng.choice(inv_)), int(rng.choice(outv))
                    if s_ != d_ and d_ not in ws.adj.get(s_, {}):
                        break
                t0 = time.perf_counter()
                ws.write_edges([(s_, d_, 1000 + i, int(rng.integers(0,
                                                                  1000)))])
                radj.setdefault(d_, set()).add(s_)
                _c, fwd = rt.serve_go(S, [s_], [E], 2, {E: "e"})
                _c, rev = rt.serve_go(S, [d_], [-E], 2, {-E: "e"})
                lat.append(time.perf_counter() - t0)
                got_f = {r[0] for r in fwd}
                got_r = {r[0] for r in rev}
                if not set(ws.adj.get(d_, {})) <= got_f \
                        or not radj[s_] <= got_r:
                    raise AssertionError(f"write {i} ({s_} -> {d_}) not "
                                         f"read back by the mesh GO")
                if i % 8 == 0:
                    want = ws.oracle().rows([s_], 2)[:, 0]
                    if sorted(r[0] for r in fwd) != sorted(want.tolist()):
                        raise AssertionError(f"write {i}: GO 2 STEPS FROM "
                                             f"{s_} differs from the oracle")
                    checked_whole += 1
            m1 = rt.mirror(S)
            if sparse:
                k, st = m1._sharded_ell_cache
                gn, ge, gc, _gz = st.host_shards()
                want = build_sharded_ell(rt.ell(m1), k)
                hn = [[want.nbr_s[b][s] for b in range(len(want.D))]
                      for s in range(k)]
                he = [[want.et_s[b][s] for b in range(len(want.D))]
                      for s in range(k)]
                if not all(np.array_equal(gc[s], want.ecnt_s[s])
                           for s in range(k)):
                    raise AssertionError("the sharded hub runs after the "
                                         "window != build_sharded_ell")
            else:
                k, mt = m1._mesh_tables_cache
                gn, ge = mt.host_shards()
                hn, he, _ = shard_ell(rt.ell(m1), k)
            for s in range(k):
                for b in range(len(hn[s])):
                    if not (np.array_equal(gn[s][b], hn[s][b])
                            and np.array_equal(ge[s][b], he[s][b])):
                        raise AssertionError(f"shard {s} bucket {b} after "
                                             f"the window != its host "
                                             f"build")
        out.update(writes=writes, checked_whole=checked_whole,
                   write_read_p50_ms=float(np.percentile(lat, 50) * 1e3),
                   write_read_p99_ms=float(np.percentile(lat, 99) * 1e3),
                   **{x: rt.stats[x] for x in (
                       "mirror_builds", "mirror_absorbs", "mesh_absorbs",
                       "mirror_absorb_failed", "go_mesh", "go_mesh_sparse",
                       "sparse_overflows")})
        if not rt.stats["mirror_absorbs"] or not (
                rt.stats["go_mesh_sparse"] if sparse
                else rt.stats["mesh_absorbs"]):
            raise AssertionError(f"the mesh window absorbed nothing or "
                                 f"left the mesh: {out}")
    finally:
        rt.close()
    return out


def mesh_phase(torch, ell_ops, flags, m, schema, oracle: GoOracle,
               path_oracle: PathOracle, vids: np.ndarray, n: int,
               requests: int, threads: int, path_requests: int,
               path_threads: int, seed: int, device=None) -> dict:
    """``tpu_mesh_devices=4``, ``tpu_mesh_mode=dense`` on a runtime whose
    4 shards all sit on this card (``mesh_devices=[cuda:0] * 4``),
    counted as one window (launch counts zeroed before part a, read
    after part d): (a) ``requests`` GO of the serve kinds without UPTO
    (COUNT(*) and ``| LIMIT 10`` among them) from ``threads`` threads
    in the default continuous mode — no stream may anchor; (b)
    ``path_requests`` FIND SHORTEST PATH from ``path_threads`` threads
    and 8 FIND ALL PATH, every answer checked; (c) an UPTO GO must
    decline; (d) ``mesh_write_part``.  64 GO answers of (a)
    are checked against the oracle; no single-card kernel may run.
    ``device`` is the shards' (None: the card)."""
    from nebula_tpu_torch.storage.device import TpuDecline
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    dev = torch.device("cuda", 0) if device is None else device
    rt = TorchQueryRuntime(device=dev,
                           mesh_devices=[dev] * MESH["tpu_mesh_devices"])
    out = {}
    try:
        rt.load_space(1, m, schema)
        rng = np.random.default_rng(seed + 67)
        mix, limits = unpacked_mix(rng, n, requests)
        mix = (mix[0], mix[1], np.zeros(requests, bool), mix[3])
        limits = ~mix[3] & (rng.random(requests) < 0.25)
        check = go_check_set(rng, limits, requests)
        with flag_mode(flags, MESH):
            if rt.continuous_session(1, (1,)) is not None:
                raise AssertionError("a continuous session anchored on a "
                                     "mesh")
            t0 = time.perf_counter()
            rt.serve_go(1, [1], [1], 3, {1: "e"})     # shards the tables
            out["shard_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            ell_ops.reset_launches()
            rt0 = dict(rt.stats)
            wall, lat, results = drive(rt, mix, threads, check, limits)
            stats = {x: rt.stats[x] - rt0[x] for x in rt0}
        check_go(oracle, mix, results, check, limits)
        if rt.continuous.streams():
            raise AssertionError("a continuous stream anchored on a mesh")
        if not stats["go_mesh"] or stats["go_sparse"] \
                or stats["go_adaptive"]:
            raise AssertionError(f"part (a) left the mesh: {stats}")
        out["a"] = dict(lat_stats(requests, wall, lat), threads=threads,
                        checked=len(check), go_mesh=stats["go_mesh"],
                        mean_batch=requests / max(stats["go_mesh"], 1),
                        count_requests=int(mix[3].sum()),
                        limit_requests=int(limits.sum()))

        # (b) FIND SHORTEST PATH, every answer checked, then FIND ALL PATH
        rng_b = np.random.default_rng(seed + 71)
        srcs = rng_b.choice(vids, path_requests)
        dsts = rng_b.choice(vids, path_requests)
        with flag_mode(flags, MESH):
            rt0 = dict(rt.stats)
            wall, plat, presults = drive_paths(rt, srcs, dsts, path_threads)
            reachable, all_checked, all_rows, t_all = check_paths(
                rt, path_oracle, vids, srcs, dsts, presults, rng_b)
            stats = {x: rt.stats[x] - rt0[x] for x in rt0}
            plain_held = bfs_plain_check(torch, ell_ops, rt, srcs[:64],
                                         dsts[:64], "mesh")
        if stats["path_mesh"] != stats["bfs_dispatches"] \
                or not stats["path_mesh"]:
            raise AssertionError(f"part (b) left the mesh: {stats}")
        out["b"] = dict(lat_stats(path_requests, wall, list(plat.values())),
                        threads=path_threads, checked=path_requests,
                        checked_reachable=reachable,
                        bfs_dispatches=stats["bfs_dispatches"],
                        levels_per_dispatch=stats["bfs_levels"]
                        / max(stats["bfs_dispatches"], 1),
                        all_path_checked=all_checked,
                        all_path_rows=all_rows, all_path_s=t_all,
                        plain_program=plain_held)

        # (c) what the mesh still declines
        declined = []
        for label, mode, kw, needs in (
                ("upto", MESH, {"upto": True}, "UPTO"),):
            with flag_mode(flags, mode):
                try:
                    rt.serve_go(1, [int(vids[0])], [1], 3, {1: "e"}, **kw)
                except TpuDecline as ex:
                    if needs not in str(ex):
                        raise AssertionError(f"({label}) declined without "
                                             f"naming {needs}: {ex}")
                    declined.append(label)
                    continue
            raise AssertionError(f"({label}) was served on a mesh")
        out["c"] = {"declined": declined}

        # (d) writes absorbed into the sharded tables, read back
        with flag_mode(flags, MESH):
            out["d"] = mesh_write_part(torch, ell_ops, flags, dev, seed)
    finally:
        rt.close()
    launches = dict(ell_ops.LAUNCHES)
    require_launched(launches, "mesh")
    ran = {x: launches[x] for x in SINGLE_CARD if launches[x]}
    if ran:
        raise AssertionError(f"the mesh phase ran single-card kernels: {ran}")
    out["launches"] = launches
    return out


# ============================================== the frontier-sharded mesh
MESH_SPARSE_MAIN = 4           # the k the kernels line reports


def _send_same(torch):
    """Probe ``same`` for X1: the exchange slabs' counts must be equal,
    and each block's live keys as a set where the block kept them all
    (the kernel places them in any order; past the cap it keeps any
    cap of them); the rest equal."""
    def same(i, a, b):
        if i not in (6, 7):
            return torch.equal(a, b)
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
    return same


DEDUP_SPLIT_CALLS = 5           # X2 + K5 calls traced for their split
DEDUP_SPLIT_TRACES = 4          # traces tried before the split fails


def dedup_split(torch, ell_ops, st, spares, nbytes) -> dict:
    """X2 + K5 (``mesh_dedup``) split by kernel, each part beside its own
    bound and plain version: each kernel's mean duration in a trace
    (``kernel_ms``: DEDUP_SPLIT_CALLS calls and a warm one, each on its
    own copy of ``spares[1]``, the operands as they were), X2's
    (``mark_kernel``) and K5's one pass.  The tracer can lose every
    launch of one kernel in a trace (launches are counted by capture,
    not here), so a trace that shows not both kernels is taken again on
    new copies, at most DEDUP_SPLIT_TRACES traces in all.  The plain
    parts (``mesh_mark_ref`` on each member, then ``pair_compact_ref``
    with the shard's row base, as ``mesh_dedup_ref`` runs them) timed by
    events on ``spares[0]``; ``nbytes`` = (X2's bytes, K5's) of this
    call, as ``dedup_pre`` counts them.  Returns the mesh_dedup row's
    ``kernel_ms``, ``split`` and the traces it took."""
    seen = []
    for _ in range(DEDUP_SPLIT_TRACES):
        it = iter([[a.clone() if isinstance(a, torch.Tensor) else a
                    for a in spares[1]]
                   for _ in range(1 + DEDUP_SPLIT_CALLS)])
        per = kernel_ms(torch, ell_ops,
                        lambda: ell_ops.mesh_dedup(*next(it)),
                        DEDUP_SPLIT_CALLS)
        x2 = [ms for n, (ms, _s) in per.items() if "::mark_kernel" in n]
        seen.append(sorted(per))
        if len(x2) == 1 and len(per) == 2:
            break
    else:
        raise AssertionError(f"mesh_dedup's kernels in {len(seen)} "
                             f"traces: {seen}")
    recv, _st, g, marks, c_out, ids, qid, ctl = spares[0][:8]
    chunk, W = st.chunk, (st.chunk + 31) // 32
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    for y, s in enumerate(g[1]):
        ell_ops.mesh_mark_ref(recv[y], s * chunk, chunk, marks[y], W)
    ev[1].record()
    for y, s in enumerate(g[1]):
        ell_ops.pair_compact_ref(marks[y], W, c_out, ids[y], qid[y], ctl[y],
                                 -1, st.n_rows, None, None, True, s * chunk)
    ev[2].record()
    torch.cuda.synchronize()
    x2_ms = x2[0]
    return dict(kernel_ms={n: ms for n, (ms, _s) in per.items()},
                kernel_launches_traced={n: c for n, (_m, c) in per.items()},
                split_traces=len(seen),
                split={
        "mesh_mark": dict(ms=x2_ms, plain_ms=ev[0].elapsed_time(ev[1]),
                          bound_ms=bytes_ms(nbytes[0])),
        "pair_compact": dict(ms=sum(ms for ms, _s in per.values()) - x2_ms,
                             plain_ms=ev[1].elapsed_time(ev[2]),
                             bound_ms=bytes_ms(nbytes[1]))})


def mesh_sparse_probes(torch, ell_ops, st, first: bool = False):
    """Probes of the card stages — X1 (``mesh_route_card``, both modes),
    X2 + K5 (``mesh_dedup``, K5 with the shards' row bases), the
    agreement (``mesh_agree``), K6's emit (``mesh_emit``) and X3
    (``mesh_bfs_stamp_card``) — with their bytes bounds from this run's
    data, over the places each call reads (a list read to its count: that
    prefix), where a pad (ids == n_rows) counts its ids word only: X1 the
    places' ids, the live pairs' qids, 8 bytes a slot of the rows walked
    (hub mode: the live pairs' ecnt, and e0 and qid where a run starts)
    and the keys and counts written; X2 + K5 the keys and counts read,
    the bitmap words set, the bitmap read and its set words zeroed, the
    pairs written and the cleared counts; the agreement a word read and
    written a shard; the emit the pairs read and the output written; X3
    the list's ids, the live pairs' qids and depth cells, the fresh
    ones' depth writes and target words, the others' pad writes (init:
    the starts' ids, the live ones' qids and depth writes, the targets'
    ids, the live ones' qids, target words and depth cells).  X2 + K5's
    library yardstick is ``torch.unique`` over the received keys packed
    as q * chunk + row (their dedup in one call; it waits on the card
    for its output's size).  With ``first``, each card stage's first
    call also has its launches measured and held (``stage_launches``:
    X1, the agreement and the emit one, X2 + K5 four), and X2 + K5's
    first call is split by kernel (``dedup_split``)."""
    bstarts = torch.tensor(st.bstarts, device=st.shards[0].nbr.device)
    Ds = torch.tensor(st.shards[0].D, device=bstarts.device)
    W = (st.chunk + 31) // 32
    ctx = {"slots": 0, "keys": [], "live": 0}

    def route_pre(args):
        hub, ids, qid, _st, g = args[:5]
        hub_recv, counted = _arg(args, 9), bool(_arg(args, 10))
        nb = 0
        for y, s in enumerate(g[1]):
            places = ids[y, :ell_ops._counted(ids, args[8], y, counted)]
            live = places.long() != st.n_rows
            n_live = int(live.sum())
            nb += 4 * places.numel() + 4 * n_live
            if hub:
                li = places.long()[live] - s * st.chunk
                nb += 8 * int((st.ecnt[s].long()[li.clamp(0, st.chunk - 1)]
                               > 0).sum())
                continue
            rows = places.long()[live]
            if hub_recv is not None:
                rows = torch.cat([rows, ell_ops._slot_pairs(hub_recv[y])[1]])
            b = torch.bucketize(rows, bstarts, right=True) - 1
            slots = int(Ds[b.clamp(min=0)].sum())
            ctx["slots"] += slots
            nb += 8 * (rows.numel() - n_live) + 8 * slots
        return nb

    def route_post(args):
        recv = args[6]
        cap = recv.shape[2] - 1
        return 8 * int(recv[:, :, 0].clamp(max=cap).sum()) \
            + 8 * recv.shape[0] * recv.shape[1]

    def dedup_pre(args):
        recv, _st, g, marks = args[:4]
        x2 = k5 = 0
        for y, s in enumerate(g[1]):
            q, u = ell_ops._slot_pairs(recv[y])
            li = u - s * st.chunk
            keys = q * st.chunk + li
            if y == 0:
                ctx["keys"].append(keys)
            words = int(torch.unique(q * W + (li >> 5)).numel())
            x2 += 8 * q.numel() + 8 * recv.shape[1] + 4 * words
            k5 += 4 * marks.shape[1] + 4 * words + 8 * args[4]
        cleared = [x for x in (recv, *args[8:]) if x is not None]
        k5 += sum(16 * x.shape[0] * x.shape[1] for x in cleared)
        ctx["dedup_bytes"] = (x2, k5)
        return x2 + k5

    def dedup_lib(args):
        keys = ctx["keys"][-1]
        return cuda_ms(torch, lambda: torch.unique(keys, sorted=True), 5, 1)

    def stamp_pre(args):
        init, ids = args[:2]
        ctl, counted = args[8], bool(_arg(args, 11))
        nb = ctx["live"] = 0
        for y in range(ids.shape[0]):
            places = ids[y, :ell_ops._counted(ids, ctl, y, counted)]
            live = int((places.long() != st.n_rows).sum())
            ctx["live"] += live
            nb += 4 * places.numel() + 6 * live
        if init:
            tids = args[9]
            tl = int((tids.long() != st.n_rows).sum())
            nb += 4 * tids.numel() + 10 * tl
        return nb

    def stamp_post(args):
        if args[0]:
            return 0
        fresh = int(args[8][:, ell_ops.CTL_LIVE].sum())
        return 6 * fresh + 8 * (ctx["live"] - fresh)

    def launches(fn, want, counters):
        if not first:
            return None
        return lambda spares: stage_launches(
            torch, ell_ops, lambda: fn(*spares[0]), want, counters,
            f"{fn.__name__} k={st.k}")

    def dedup_first(spares):
        row = launches(ell_ops.mesh_dedup, 2, {
            "mesh_dedup": 1, "mesh_mark": 1, "pair_compact": 1})(spares)
        row.update(dedup_split(torch, ell_ops, st, spares[1:],
                               ctx["dedup_bytes"]))
        return row

    probes = {
        "mesh_route": Probe(torch, "mesh_route", ell_ops.mesh_route_card,
                            ell_ops.mesh_route_card_ref, route_pre,
                            route_post, same=_send_same(torch),
                            first=launches(ell_ops.mesh_route_card, 1,
                                           {"mesh_route": 1}), spares=1),
        "mesh_dedup": Probe(torch, "mesh_dedup", ell_ops.mesh_dedup,
                            ell_ops.mesh_dedup_ref, dedup_pre,
                            lib=dedup_lib, same=_scan_free(torch, 11),
                            first=dedup_first if first else None,
                            spares=3),
        "mesh_agree": Probe(torch, "mesh_agree", ell_ops.mesh_agree,
                            ell_ops.mesh_agree_ref,
                            lambda a: 16 * a[0].shape[0],
                            first=launches(ell_ops.mesh_agree, 1,
                                           {"mesh_agree": 1}), spares=1),
        "mesh_emit": Probe(torch, "mesh_emit", ell_ops.mesh_emit,
                           ell_ops.mesh_emit_ref,
                           lambda a: 16 * a[0].shape[0],
                           lambda a: 4 * a[3].numel() + 8 * int(
                               a[2][:, ell_ops.CTL_CNT].clamp(
                                   0, a[0].shape[1]).sum()),
                           first=launches(ell_ops.mesh_emit, 1, {
                               "mesh_emit": 1, "pair_reduce": 1}),
                           spares=1),
        "mesh_bfs_stamp": Probe(torch, "mesh_bfs_stamp",
                                ell_ops.mesh_bfs_stamp_card,
                                ell_ops.mesh_bfs_stamp_card_ref, stamp_pre,
                                stamp_post),
    }
    return probes, ctx


def _mesh_batch(ix, starts, per_query: int, nq: int):
    """(new rows, qids): ``nq`` queries of ``per_query`` start vertices
    each, drawn in order from ``starts`` (old dense ids)."""
    S = nq * per_query
    new = ix.perm[np.asarray(starts[:S], np.int64)].astype(np.int32)
    return new, (np.arange(len(new)) // per_query).astype(np.int32)


def mesh_sparse_kernel_phase(torch, ell_ops, rt, m, ix, tables, eslot,
                             hrows, k: int, over, starts, rng) -> dict:
    """The frontier-sharded mesh's kernels and programs on the serve
    graph's tables cut into k chunks that all sit on this card, every
    stage call of the programs probed (X1, X2 + K5 with the shards' row
    bases, the agreement and K6's emit, each one launch a kernel over
    every shard, and X3 a shard, against their plain versions on copies
    of their operands, timed as device time behind a spin kernel).
    ``mesh_sparse_go`` at c0 256 (128 queries, one start each, the
    ``ell_go_sharded`` comparison of the dense mesh) and 2048 (1024
    queries, two starts each), 3 and 4
    steps, and four tight-cap batches, each setting one overflow
    source (cap_x, the dedup cap, the hub budget, cap_e): per-shard
    outputs equal to the plain version's when no overflow, the flag
    always; the c0 256 pairs equal to ``ell_go_sharded``'s frontier.
    ``mesh_sparse_bfs``, shortest (UPTO 5, each target one a single-
    card BFS reaches within 2 levels) and all (2 levels) at B = 128 and
    1024, equal to its plain version and, at every real vertex, to
    ``ell_bfs`` on the same starts.  One call of each public wrapper is
    held to the plain version too.  A program's ``ms`` is device time
    behind a spin kernel: the BFS is replayed with the level flags the
    probed run read, so its host loop waits on nothing (``event_ms``,
    the public call's CUDA-event time, holds a host read per level).
    ``starts`` are old dense ids from the serve mix.  Returns {name:
    numbers}."""
    from nebula_tpu_torch.tpu.ell import (INT16_INF, build_sharded_ell,
                                          mesh_tables, sharded_sparse_pairs,
                                          sharded_tables, sparse_caps,
                                          split_start_pairs_by_owner)
    from nebula_tpu_torch.tpu.mesh import PartsMesh
    dev = tables.nbr.device
    mesh = PartsMesh([dev] * k)
    t0 = time.perf_counter()
    st = sharded_tables(build_sharded_ell(ix, k), mesh)
    shard_s = time.perf_counter() - t0
    over = tuple(over)
    d_max = max(tables.D)
    up = lambda a: mesh.split(torch.from_numpy(a).to(dev))  # noqa: E731
    res = {"go_runs": {}, "bfs_runs": {}}
    hubs = np.nonzero(ix.hub_table()[:ix.n])[0]        # new ids
    wide = starts[np.argsort(-rt._deg_host(m, over)[starts], kind="stable")]
    # (label, c0, queries, starts a query, steps, start set, tight caps)
    configs = [
        ("c0_256_s3", 256, 128, 1, 3, starts, {}),
        ("c0_256_s4", 256, 128, 1, 4, starts, {}),
        ("c0_2048_s3", 2048, 1024, 2, 3, starts, {}),
        ("c0_2048_s4", 2048, 1024, 2, 4, starts, {}),
        ("tight_cap_x", 256, 64, 1, 3, wide, {"cap_x": 64}),
        ("tight_dedup", 256, 64, 1, 3, starts, {"final": 16}),
        ("tight_hub_budget", 256, len(hubs), 1, 3,
         ix.inv[hubs], {}),
        ("tight_cap_e", 256, len(hubs), 1, 3, ix.inv[hubs],
         {"cap_e": 4, "cap_x": 1 << 17}),
    ]
    go_probes = None
    moved_hops = {}
    for label, c0, nq, per, steps, pool, tight in configs:
        rows, qs = _mesh_batch(ix, pool, per, nq)
        if label == "tight_hub_budget":
            # one start on every hub: the runs' total passes c0 = EX
            rows, qs = rows[:c0], qs[:c0]
        placed = split_start_pairs_by_owner(st, rows, qs, c0)
        if placed is None:
            raise AssertionError(f"mesh_sparse_go {label}: a shard's share "
                                 f"passed c0")
        caps = sparse_caps(c0, d_max, steps, 1 << 17)
        if "final" in tight:
            caps = caps[:-1] + (tight["final"],)
        cap_x = tight.get("cap_x", max(256, caps[-1] // max(k // 2, 1)))
        cap_e = tight.get("cap_e", max(64, c0))
        ids, qid = up(placed[0]), up(placed[1])
        probes, ctx = mesh_sparse_probes(torch, ell_ops, st,
                                         first=label == "c0_256_s3")
        outs, exchanges, ctl = ell_ops._mesh_go_steps(
            ids, qid, st, over, steps, caps, cap_x, cap_e, nq,
            probes["mesh_route"], probes["mesh_dedup"],
            (probes["mesh_agree"], ell_ops.or_many), probes["mesh_emit"])
        moved = ell_ops.exchanged_bytes(ctl)
        want, plain = timed(torch, lambda: ell_ops.mesh_sparse_go_ref(
            ids, qid, st, over, steps, caps, cap_x, cap_e, nq))
        got_h = mesh.stacked(outs).cpu().numpy()
        want_h = mesh.stacked(want).cpu().numpy()
        ovf = bool(want_h[:, 1].any())
        if not np.array_equal(got_h[:, 1], want_h[:, 1]) or (
                not ovf and not np.array_equal(got_h, want_h)):
            raise AssertionError(f"mesh_sparse_go k={k} {label} != its "
                                 f"plain version")
        if (label.startswith("tight") and not ovf) or (
                label == "c0_256_s3" and ovf):
            raise AssertionError(f"mesh_sparse_go k={k} {label}: overflow "
                                 f"{ovf}")

        def run():
            return ell_ops.mesh_sparse_go(ids, qid, st, over, steps, caps,
                                          cap_x, cap_e, nq)
        pub_h = mesh.stacked(run()).cpu().numpy()
        if not np.array_equal(pub_h[:, 1], want_h[:, 1]) or (
                not ovf and not np.array_equal(pub_h, want_h)):
            raise AssertionError(f"ell_ops.mesh_sparse_go k={k} {label} "
                                 f"!= its plain version")
        for r in range(K5_REPEATS):         # K5's look-back, call after call
            rep_h = mesh.stacked(run()).cpu().numpy()
            # on overflow only the flags are defined (X1 keeps any cap of
            # a block's keys)
            if not np.array_equal(rep_h[:, 1], pub_h[:, 1]) or (
                    not ovf and not np.array_equal(rep_h, pub_h)):
                raise AssertionError(f"mesh_sparse_go k={k} {label}: repeat "
                                     f"{r} differs")
        ev = cuda_ms(torch, run, 5, 1)
        dev_ms = mesh_queued_ms(torch, run, f"mesh_sparse_go k={k} {label}",
                                4)
        out_bytes = 4 * sum(o.numel() for o in outs)
        n_live = int((placed[0] != st.n_rows).sum())
        prog_bytes = 4 * k * c0 + 4 * n_live + 8 * ctx["slots"] + out_bytes
        hops = steps - 1
        moved_hops[label] = moved / max(hops, 1)
        row = dict(max_abs_err=0, ms=dev_ms, event_ms=ev, plain_ms=plain,
                   bound_ms=bytes_ms(prog_bytes), bound_by="bytes",
                   library_ms=None, overflow=int(ovf),
                   count=int(want_h[:, 0].sum()), caps=list(caps),
                   cap_x=cap_x, cap_e=cap_e, queries=nq,
                   starts=int(len(rows)), steps=steps,
                   exchanges_per_hop=exchanges / max(hops, 1),
                   exchanged_bytes_per_hop=moved / max(hops, 1),
                   kernels={a: p.numbers() for a, p in probes.items()
                            if p.calls})
        if label == "c0_256_s3":
            go_probes = probes
            row.update(launches_a_call(torch, ell_ops, run))
            # the dense mesh on the same starts, one query a lane
            mt = mesh_tables(ix, mesh)
            es_, hs_ = [eslot] * k, [hrows] * k
            f0 = rt._upload_frontier_packed(ix, rows, qs, 128)
            dense = ell_ops.ell_go_sharded(f0, mt, es_, hs_, over, steps)[0]
            lanes = ell_ops._unpack_ref(dense)[:ix.n, :nq]
            _o, q_, u_ = sharded_sparse_pairs(want_h)
            pairs = torch.zeros_like(lanes)
            pairs[torch.from_numpy(u_).long().to(dev),
                  torch.from_numpy(q_).long().to(dev)] = True
            if not torch.equal(lanes, pairs):
                raise AssertionError(f"mesh_sparse_go k={k} != "
                                     f"ell_go_sharded on the same starts")
            row["ell_go_sharded_ms"] = cuda_ms(
                torch, lambda: ell_ops.ell_go_sharded(f0, mt, es_, hs_,
                                                      over, steps), 10)
            del mt, dense, lanes, pairs
        res["go_runs"][label] = row
    res["mesh_sparse_go"] = dict(
        {a: b for a, b in res["go_runs"]["c0_256_s3"].items()
         if a != "kernels"},
        library_none="none: a multi-kernel program", k=k, shard_s=shard_s,
        others={lb: {a: r[a] for a in ("ms", "event_ms", "plain_ms",
                                       "bound_ms", "overflow")}
                for lb, r in res["go_runs"].items() if lb != "c0_256_s3"})

    # ---- BFS: B queries, one start each: shortest (UPTO 5) toward
    # targets a single-card BFS reaches within ``near`` levels, and all
    # at ``max_steps`` levels; the last run's frontier outgrows the caps
    bfs_probes = None
    cap = 1 << 17
    cap_x, cap_e = max(256, cap // max(k // 2, 1)), max(64, cap // 8)
    runs = [(128, True, 5, 2), (128, False, 2, 0), (1024, True, 5, 1),
            (1024, False, 1, 0), (1024, False, 4, 0)]
    exact = {128: 0, 1024: 0}
    inputs = {}
    for B, stop, max_steps, near in runs:
        if B not in inputs:
            s_new = ix.perm[rng.choice(starts, B)].astype(np.int32)
            qq = np.arange(B, dtype=np.int32)
            f0 = rt._upload_frontier_packed(ix, s_new, qq, B)
            reach, _l = ell_ops.ell_bfs(f0.clone(), torch.zeros_like(f0),
                                        tables, eslot, hrows, over, 2,
                                        False)
            inputs[B] = (s_new, qq, f0, reach[:ix.n].cpu().numpy())
        s_new, qq, f0, reach = inputs[B]
        t_new = s_new.copy()
        if near:
            for q in range(B):
                cand = np.nonzero((reach[:, q] >= 1)
                                  & (reach[:, q] <= near))[0]
                if len(cand):
                    t_new[q] = cand[rng.integers(len(cand))]
        ps = split_start_pairs_by_owner(st, s_new, qq, cap)
        pt = split_start_pairs_by_owner(st, t_new, qq, cap)
        args = (up(ps[0]), up(ps[1]), up(pt[0]), up(pt[1]))
        t0p = rt._upload_frontier_packed(ix, t_new, qq, B)
        label = f"b{B}_{'shortest' if stop else 'all'}_s{max_steps}"
        probes, ctx = mesh_sparse_probes(torch, ell_ops, st)
        seen = []

        def record(ctl):
            seen.append(ell_ops._read_ctl(ctl))
            return seen[-1]
        dep, ovf, levels, exchanges, moved = ell_ops._mesh_bfs_steps(
            *args, st, over, max_steps, cap, cap_x, cap_e, B, stop,
            probes["mesh_route"], probes["mesh_dedup"],
            probes["mesh_bfs_stamp"], read=record)
        (wdep, wovf, wlev), plain = timed(
            torch, lambda: ell_ops.mesh_sparse_bfs_ref(
                *args, st, over, max_steps, cap, cap_x, cap_e, B, stop))
        if ovf != wovf or levels != wlev or not (ovf or all(
                torch.equal(a, b) for a, b in zip(dep, wdep))):
            raise AssertionError(f"mesh_sparse_bfs k={k} {label} != its "
                                 f"plain version (overflow {ovf} / {wovf}, "
                                 f"levels {levels} / {wlev})")
        if not ovf:
            one, _ol = ell_ops.ell_bfs(f0.clone(), t0p, tables, eslot,
                                       hrows, over, max_steps, stop)
            one = one[:ix.n].to(torch.int16)
            one = torch.where(one < 0, int(INT16_INF), one)
            if not torch.equal(one, torch.cat(dep)[:ix.n]):
                raise AssertionError(f"mesh_sparse_bfs k={k} {label} != "
                                     f"ell_bfs on the same starts")
            exact[B] += 1

        def run():
            return ell_ops.mesh_sparse_bfs(*args, st, over, max_steps, cap,
                                           cap_x, cap_e, B, stop)
        before = ell_ops.LAUNCHES["mesh_bfs_stamp"]
        pdep, povf, plev = run()
        if povf != wovf or plev != wlev or not (povf or all(
                torch.equal(a, b) for a, b in zip(pdep, wdep))):
            raise AssertionError(f"ell_ops.mesh_sparse_bfs k={k} {label} "
                                 f"!= its plain version")
        stamps = ell_ops.LAUNCHES["mesh_bfs_stamp"] - before
        if stamps != (plev + 1) * len(mesh.groups):
            raise AssertionError(f"mesh_sparse_bfs k={k} {label}: {stamps} "
                                 f"X3 calls for {plev} levels, not one a "
                                 f"card group a level and at init")
        del pdep

        def replay():
            # the same kernels and copies, the level flags given back
            # from the probed run: nothing waits on the card
            flags = iter(seen)
            return ell_ops._mesh_bfs_steps(
                *args, st, over, max_steps, cap, cap_x, cap_e, B, stop,
                ell_ops.mesh_route_card, ell_ops.mesh_dedup,
                ell_ops.mesh_bfs_stamp_card, read=lambda _c: next(flags))
        dev_ms = mesh_queued_ms(torch, replay,
                                f"mesh_sparse_bfs k={k} {label}", 3)
        ms = cuda_ms(torch, run, 3, 1)
        one_ms = cuda_ms(torch, lambda: ell_ops.ell_bfs(
            f0.clone(), t0p, tables, eslot, hrows, over, max_steps, stop),
            3, 1)
        n_live = sum(int((p[0] != st.n_rows).sum()) for p in (ps, pt))
        nbytes = 8 * k * cap + 4 * n_live + 8 * ctx["slots"] \
            + 2 * k * st.chunk * B
        res["bfs_runs"][label] = dict(
            max_abs_err=0, ms=dev_ms, event_ms=ms, plain_ms=plain,
            bound_ms=bytes_ms(nbytes), bound_by="bytes", library_ms=None,
            levels=levels, overflow=int(ovf), max_steps=max_steps,
            queries=B, single_card_ell_bfs_ms=one_ms,
            exchanges_per_level=exchanges / max(levels, 1),
            exchanged_bytes_per_level=moved / max(levels, 1),
            kernels={a: p.numbers() for a, p in probes.items() if p.calls})
        if label == "b128_shortest_s5":
            bfs_probes = probes
            # counted on the replay, plus the flag reads (one copy a
            # card group a read)
            res["bfs_runs"][label].update(launches_a_call(
                torch, ell_ops, run, replay=replay,
                reads=len(seen) * len(st.mesh.groups)))
    if not all(exact.values()):
        raise AssertionError(f"mesh_sparse_bfs k={k}: no run without "
                             f"overflow at some width: {exact}")
    res["mesh_sparse_bfs"] = dict(
        {a: b for a, b in res["bfs_runs"]["b128_shortest_s5"].items()
         if a != "kernels"},
        library_none="none: a multi-kernel program", k=k,
        others={lb: {a: r[a] for a in ("ms", "event_ms", "plain_ms",
                                       "bound_ms", "levels", "overflow")}
                for lb, r in res["bfs_runs"].items()
                if lb != "b128_shortest_s5"})
    for name in ("mesh_route", "mesh_dedup", "mesh_agree", "mesh_emit"):
        res[name] = dict(go_probes[name].numbers(), run="c0_256_s3", k=k)
    res["mesh_dedup"]["library_call"] = "torch.unique (X2 + K5)"
    res["mesh_route"]["library_none"] = \
        "none: no call routes pairs to per-owner slot blocks"
    res["mesh_agree"]["library_none"] = \
        "none: an OR of k words into each of them (any + a copy: two calls)"
    res["mesh_emit"]["library_none"] = \
        "none: two selects into one layout (torch.where twice, a cat)"
    # X2 and K5 run in one call (mesh_dedup): their rows are its first
    # call split by kernel in the trace, each part against its own bound
    split = res["mesh_dedup"].pop("split")
    x2_n = res["mesh_dedup"]["counters_moved"]["mesh_mark"]
    for name, n in (("mesh_mark", x2_n),
                    ("pair_compact",
                     res["mesh_dedup"]["launches_a_call"] - x2_n)):
        res[name] = dict(
            split[name], max_abs_err=0, bound_by="bytes", library_ms=None,
            run="c0_256_s3", k=k, calls=1, launches_a_call=n,
            ms_by="the kernels' mean durations in a trace of mesh_dedup's "
                  f"first call, {DEDUP_SPLIT_CALLS} copies")
    res["mesh_mark"]["library_none"] = \
        "none: an OR of keys into a bitmap (scatter_reduce_ has no bitwise or)"
    res["mesh_bfs_stamp"] = dict(bfs_probes["mesh_bfs_stamp"].numbers(),
                                 run="b128_shortest_s5", k=k,
                                 library_none="none: a depth update with "
                                              "its loop flags")
    # X1 in the BFS, where its lists are widest: a level's hub-mode call,
    # then its candidate call
    res["mesh_route"]["bfs"] = dict(
        {a: b for a, b in bfs_probes["mesh_route"].numbers().items()
         if a in ("ms", "plain_ms", "bound_ms", "enqueue_ms", "calls",
                  "call_ms", "call_bound_ms")},
        run="b128_shortest_s5", k=k)
    res["exchanged_bytes_per_hop"] = moved_hops
    return res


def emit_count_check(torch, ell_ops, rt, m, ix, tables, rng) -> dict:
    """K6's emit (``pair_emit_kernel``) on K5's lists at count 0, one, a
    mid count, c and past c (an overflowed list, its flag raised), held
    exactly to its plain version over the whole list: as ``mesh_emit``
    (4 members at the main path's c = 2^17, and 3 members at c = 130
    and 131, whose members' rows sit off 16-byte alignment), as
    ``pair_reduce``'s emit in both layouts into outputs 0-3 words off
    alignment, and as ``sparse_go``'s plain result (one query, one hop,
    both layouts: no live start, the cap past the count, the cap cut to
    the count, one below it: an overflow, whose flags are held); each
    list again with its places past min(count, c) overwritten gives the
    same output (the kernel reads none of them).  ``mesh_emit`` at
    c = 2^17 is timed at each count (device ms, calls queued behind a
    spin) beside its plain version and its bound (the counted prefix
    read, the whole output written).  Returns the numbers."""
    E = ell_ops
    dev = tables.nbr.device
    n_rows = ix.n_rows
    R1 = n_rows + 1
    R1w = (R1 + 31) // 32
    nq = max(4, -(-2 * ((1 << 17) + 8) // R1))     # room for c + 7 pairs

    def k5_slab(members, c, bits):
        ids = torch.empty((members, c), dtype=torch.int32, device=dev)
        qid = torch.empty_like(ids)
        ctl = torch.zeros((members, E.CTL_SIZE), dtype=torch.int64,
                          device=dev)
        for y in range(members):
            flat = rng.choice(nq * R1, bits, replace=False)
            q, v = flat // R1, flat % R1
            words = np.zeros(nq * R1w, np.uint32)
            np.bitwise_or.at(words, q * R1w + v // 32,
                             np.left_shift(1, v % 32).astype(np.uint32))
            mark = torch.from_numpy(words.view(np.int32)).to(dev)
            E.pair_compact(mark, R1w, c, ids[y], qid[y], ctl[y], -1, n_rows)
        return ids, qid, ctl

    def poisoned(ids, qid, ctl):
        ids2, qid2 = ids.clone(), qid.clone()
        for y, cnt in enumerate(ctl[:, E.CTL_CNT].tolist()):
            n = min(cnt, ids.shape[1])
            ids2[y, n:] = 5
            qid2[y, n:] = 0
        return ids2, qid2

    res = {"mesh_emit": {}, "pair_reduce": {}, "sparse_go": {}}
    for members, c in ((4, 1 << 17), (3, 130), (3, 131)):
        for bits in sorted({0, 1, c // 3, c, c + 7}):
            label = f"c{c}_count{bits}"
            ids, qid, ctl = k5_slab(members, c, bits)
            out = torch.full((members, 2 + 2 * c), 7, dtype=torch.int32,
                             device=dev)
            want = torch.full_like(out, 9)
            E.mesh_emit(ids, qid, ctl, out, n_rows)
            E.mesh_emit_ref(ids, qid, ctl, want, n_rows)
            pairs = [(out, want)]
            if dev.type == "cuda":      # the plain version reads the tail
                out2 = torch.full_like(out, 3)
                E.mesh_emit(*poisoned(ids, qid, ctl), ctl, out2, n_rows)
                pairs.append((out2, want))
            require_equal(torch, f"mesh_emit {label}", 0, *pairs)
            for y in (0, members - 1):
                for pack32 in (False, True):
                    w = 2 + (1 if pack32 else 2) * c
                    for off in range(4):
                        buf = torch.full((off + w,), 7, dtype=torch.int32,
                                         device=dev)
                        ref = torch.full((w,), 9, dtype=torch.int32,
                                         device=dev)
                        E.pair_reduce(E.REDUCE_EMIT, ids[y], qid[y], None,
                                      buf[off:], pack32, R1, n_rows, nq, nq,
                                      0, 0, ctl[y])
                        E.pair_reduce_ref(E.REDUCE_EMIT, ids[y], qid[y],
                                          None, ref, pack32, R1, n_rows, nq,
                                          nq, 0, 0, ctl[y])
                        require_equal(torch, f"pair_reduce emit {label} "
                                      f"pack32={pack32} off={off}", 0,
                                      (buf[off:], ref))
            if c != 1 << 17:
                continue
            live = sum(min(x, c) for x in ctl[:, E.CTL_CNT].tolist())

            def kern(ids=ids, qid=qid, ctl=ctl, out=out):
                return E.mesh_emit(ids, qid, ctl, out, n_rows)
            res["mesh_emit"][label] = dict(
                ms=mesh_queued_ms(torch, kern, f"mesh_emit {label}"),
                event_ms=cuda_ms(torch, kern, 20),
                plain_ms=cuda_ms(torch, lambda: E.mesh_emit_ref(
                    ids, qid, ctl, want, n_rows), 3, warmup=1),
                bound_ms=bytes_ms(8 * live + 16 * members
                                  + 4 * out.numel()),
                bound_by="bytes", live_pairs=live, members=members)
        res["pair_reduce"][f"c{c}"] = "held at every count, both layouts"

    # sparse_go's plain result: one query from a vertex of a few edges
    from nebula_tpu_torch.tpu.ell import sparse_pack32
    ecnt, e0 = rt._hub_expansion_dev(m, ix)
    deg_h = rt._deg_host(m, (1,))
    v = int(np.flatnonzero((deg_h > 2) & (deg_h < 200))[0])
    c0 = 8
    for qmax in (1, (2**31 - 1) // R1 + 1):     # both output layouts
        layout = "pack32" if sparse_pack32(qmax, n_rows) else "pairs"
        for label, start in (("none live", None), ("one start", v)):
            ids_h, qid_h = sparse_batch(
                ix, np.zeros(0, np.int64) if start is None
                else np.array([start]), c0, 1)
            ids, qid = rt._up(ids_h), rt._up(qid_h)

            def go(cap):
                args = (ids, qid, ecnt, e0, None, tables, (1,), 2,
                        (c0, cap), qmax)
                return E.sparse_go(*args, 1), E.sparse_go_ref(*args)
            got, want = go(1 << 17)
            require_equal(torch, f"sparse_go {layout} {label}", 0,
                          (got, want))
            cnt = int(want[0])
            res["sparse_go"][f"{layout} {label}"] = cnt
            if start is None:
                if cnt:
                    raise AssertionError("sparse_go from no live start "
                                         f"counted {cnt}")
                continue
            for cap, what in ((cnt, "count = c"), (cnt - 1, "overflow")):
                if cap < 1:
                    continue
                got, want = go(cap)
                if got[:2].tolist() != want[:2].tolist() or \
                        int(want[1]) != (cap < cnt):
                    raise AssertionError(f"sparse_go {layout} {what}: "
                                         f"{got[:2].tolist()} against "
                                         f"{want[:2].tolist()}")
                if cap == cnt:
                    require_equal(torch, f"sparse_go {layout} {what}", 0,
                                  (got, want))
                res["sparse_go"][f"{layout} {what}"] = got[:2].tolist()
    return res


def mesh_stage_check(torch, ell_ops, ix, k: int, over, rng, label: str,
                     dev) -> dict:
    """Untimed: the card stages of both mesh programs against their
    plain versions on the tables of ``ix`` cut into k shards on this
    card (the phase-3 runs hold them on the serve tables, which have
    hub extra rows; here also tables without), and each program with
    its k shards split over two pretended cards — the exchange's
    cross-card blocks by ``mesh.all_to_all``, the hop's owned rows by
    ``copy_``, the overflow agreed by ``psum_or`` — equal to the one-card
    run: ``mesh_hop``'s stages at W = 16 and 12 (its 4-byte rows), then
    ``ell_go_sharded`` at 3 steps and ``ell_bfs_sharded`` (5 levels)
    against ``ell_go`` / ``ell_bfs``; ``mesh_sparse_go`` (128 queries,
    3 steps) with every stage call probed, at caps it keeps and at a
    tight cap_x whose overflow every shard must report;
    ``mesh_sparse_bfs`` (2 levels) against its plain version (the flags
    always, the depths where neither overflowed).  Returns the runs'
    overflow flags and the exchanged bytes."""
    from nebula_tpu_torch.tpu.ell import (build_sharded_ell, mesh_tables,
                                          sharded_tables, sparse_caps,
                                          split_start_pairs_by_owner)
    from nebula_tpu_torch.tpu.mesh import PartsMesh
    tables = ix.device_tables(dev)
    eslot, hrows = (torch.from_numpy(a.astype(np.int32)).to(dev)
                    for a in ix.hub_merge())
    R1 = ix.n_rows + 1
    half = (k + 1) // 2
    cards = ((dev, tuple(range(half))), (dev, tuple(range(half, k))))
    meshes = [PartsMesh([dev] * k), PartsMesh([dev] * k)]
    meshes[1].groups = cards
    es, hs = [eslot] * k, [hrows] * k
    out = {"hubs": ix.n_rows > ix.n}
    for W in (16, 12):
        mt = mesh_tables(ix, meshes[0])
        g = mt.mesh.groups[0]
        fh = np.zeros((R1, W), np.uint8)
        live = rng.random(ix.n) < 0.05
        fh[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                       dtype=np.uint8)
        f0 = torch.from_numpy(fh).to(dev)
        cur = mt.mesh.replicas(f0)[0]
        for st_ in (ell_ops.HOP_GATHER, ell_ops.HOP_COPY, ell_ops.HOP_MERGE,
                    ell_ops.HOP_STAGES):
            a = torch.randint(0, 256, cur.shape, dtype=torch.uint8,
                              device=dev)
            b = a.clone()
            ell_ops.mesh_hop(cur, a, mt, g, eslot, hrows, over, st_)
            ell_ops.mesh_hop_ref(cur, b, mt, g, eslot, hrows, over, st_)
            require_equal(torch, f"mesh_hop {label} k={k} W={W} "
                          f"stages={st_}", W * 8, (a, b))
        one = torch.empty_like(f0)
        ell_ops.go_hop(f0, None, one, tables, eslot, hrows, over)
        require_equal(torch, f"mesh_hop {label} k={k} W={W}", W * 8,
                      *[(r, one) for r in a.unbind(0)])
        if W == 12:
            continue
        want = ell_ops.ell_go(f0.clone(), tables, eslot, hrows, over, 3)
        t0p = f0.roll(7, 0).contiguous()
        t0p[-1] = 0
        d1, l1 = ell_ops.ell_bfs(f0.clone(), t0p, tables, eslot, hrows, over,
                                 5)
        for mesh in meshes:
            mtx = mesh_tables(ix, mesh)
            got = ell_ops.ell_go_sharded(f0, mtx, es, hs, over, 3)
            require_equal(torch, f"ell_go_sharded {label} k={k} cards="
                          f"{len(mesh.groups)}", W * 8,
                          *[(r, want) for r in got])
            d2, l2 = ell_ops.ell_bfs_sharded(f0, t0p, mtx, es, hs, over, 5)
            require_equal(torch, f"ell_bfs_sharded {label} k={k} cards="
                          f"{len(mesh.groups)}", W * 8, (d2, d1))
            if l1 != l2:
                raise AssertionError(f"ell_bfs_sharded {label}: {l2} levels, "
                                     f"ell_bfs {l1}")
    nq, c0 = 128, 256
    rows = ix.perm[rng.integers(0, ix.n, nq)].astype(np.int32)
    qs = np.arange(nq, dtype=np.int32)
    caps = sparse_caps(c0, max(ix.bucket_D), 3, 1 << 17)
    for mesh in meshes:
        st = sharded_tables(build_sharded_ell(ix, k), mesh)
        placed = split_start_pairs_by_owner(st, rows, qs, c0)
        ids, qid = (mesh.split(torch.from_numpy(x).to(dev)) for x in placed)
        n_cards = len(mesh.groups)
        for cap_x, tight in ((1 << 17, False), (64, True)):
            probes, _ctx = mesh_sparse_probes(torch, ell_ops, st)
            got, _x, ctl = ell_ops._mesh_go_steps(
                ids, qid, st, over, 3, caps, cap_x, 1 << 12, nq,
                probes["mesh_route"], probes["mesh_dedup"],
                (probes["mesh_agree"], ell_ops.or_many), probes["mesh_emit"])
            got = mesh.stacked(got)
            want = mesh.stacked(ell_ops.mesh_sparse_go_ref(
                ids, qid, st, over, 3, caps, cap_x, 1 << 12, nq))
            flags = want[:, 1].tolist()
            if got[:, 1].tolist() != flags or len(set(flags)) != 1 or (
                    tight and not flags[0]):
                raise AssertionError(f"mesh_sparse_go {label} k={k} cards="
                                     f"{n_cards} tight={tight}: flags "
                                     f"{got[:, 1].tolist()} / {flags}")
            out[f"overflow_cards{n_cards}_tight{int(tight)}"] = flags[0]
            if not flags[0]:
                require_equal(torch, f"mesh_sparse_go {label} k={k} cards="
                              f"{n_cards}", 0, (got, want))
                out[f"bytes_cards{n_cards}"] = ell_ops.exchanged_bytes(ctl)
        cap = 1 << 17
        ps = split_start_pairs_by_owner(st, rows, qs, cap)
        pt = split_start_pairs_by_owner(st, np.roll(rows, 3), qs, cap)
        args = [mesh.split(torch.from_numpy(x).to(dev)) for x in (*ps, *pt)]
        d, o, lv = ell_ops.mesh_sparse_bfs(*args, st, over, 2, cap, cap,
                                           1 << 12, nq, False)
        wd, wo, wl = ell_ops.mesh_sparse_bfs_ref(*args, st, over, 2, cap,
                                                 cap, 1 << 12, nq, False)
        if o != wo or lv != wl:
            raise AssertionError(f"mesh_sparse_bfs {label} k={k}: overflow "
                                 f"{o} / {wo}, levels {lv} / {wl}")
        out[f"bfs_overflow_cards{n_cards}"] = o
        if not o:
            require_equal(torch, f"mesh_sparse_bfs {label} k={k} cards="
                          f"{n_cards}", 0, *zip(d, wd))
    if out.get("bytes_cards1") != out.get("bytes_cards2"):
        raise AssertionError(f"mesh_sparse_go {label} k={k}: the exchanges "
                             f"moved {out['bytes_cards1']} bytes on one card, "
                             f"{out['bytes_cards2']} over two")
    return out


def _pair_lists(st, rng, c: int, live: int, starts: bool):
    """(ids, qid) int32 [k, c] numpy: on each shard ``live`` distinct
    (q, row) pairs of its own rows — a start list's scattered between
    pads (n_rows, 0), else sorted by (q, row) and first, the pads
    (n_rows, BIG_Q) after them, as K5 writes a list."""
    k, chunk, n_rows = st.k, st.chunk, st.n_rows
    ids = np.full((k, c), n_rows, np.int32)
    qid = np.full((k, c), 0 if starts else 1 << 30, np.int32)
    for s in range(k):
        lo, hi = s * chunk, min((s + 1) * chunk, n_rows)
        key = np.unique(rng.integers(0, 64, 4 * live) * chunk
                        + rng.integers(lo, hi, 4 * live) - lo)[:live]
        at = np.arange(len(key))
        if starts:
            rng.shuffle(key)
            at = np.sort(rng.choice(c, len(key), replace=False))
        ids[s, at] = key % chunk + lo
        qid[s, at] = key // chunk
    return ids, qid


def mesh_list_check(torch, ell_ops, ix, k: int, over, rng, label: str,
                    dev) -> dict:
    """Untimed: X1 (``mesh_route_card``, both modes) and X3
    (``mesh_bfs_stamp_card``, init and a level) against their plain
    versions on every shape of list they take, on the tables of ``ix``
    cut into k shards on this card, one card group and two pretended
    cards: a start list read whole, its pads between its live pairs; a
    list whose live pairs come first read to its count, with
    ``ctl[CTL_CNT]`` 0, the live count, c and past c (an overflowed K5),
    and with X3's in-place pads inside that prefix; short lists (a warp
    a pair) and long ones (a tile of pairs a warp); candidate mode with
    hub keys received, some blocks past their cap; and a cap the blocks
    fill past.  Returns the cases run."""
    from nebula_tpu_torch.tpu.ell import build_sharded_ell, sharded_tables
    from nebula_tpu_torch.tpu.mesh import PartsMesh
    cap_e = 64
    half = (k + 1) // 2
    meshes = [PartsMesh([dev] * k), PartsMesh([dev] * k)]
    meshes[1].groups = ((dev, tuple(range(half))), (dev, tuple(range(half,
                                                                      k))))
    sh = build_sharded_ell(ix, k)
    same = _send_same(torch)
    cases = 0
    for mesh in meshes:
        st = sharded_tables(sh, mesh)
        chunk, n_rows = st.chunk, st.n_rows
        W = (chunk + 31) // 32
        qmax = 64
        for c, live, starts, cnt, cap in (
                (2048, 300, True, None, 1 << 16),
                (1 << 15, 20000, True, None, 1 << 16),
                (2048, 300, False, "live", 1 << 16),
                (2048, 300, False, "zero", 1 << 16),
                (2048, 300, False, "c", 1 << 16),
                (2048, 300, False, "past", 1 << 16),
                (2048, 300, False, "pads", 1 << 16),
                (1 << 15, 20000, False, "pads", 1 << 16),
                (2048, 300, False, "live", 16)):
            ids_h, qid_h = _pair_lists(st, rng, c, live, starts)
            ids_all = torch.from_numpy(ids_h).to(dev)
            qid_all = torch.from_numpy(qid_h).to(dev)
            for g in mesh.groups:
                members = list(g[1])
                kg = len(members)
                ids = ids_all[members].contiguous()
                qid = qid_all[members].contiguous()
                ctl = torch.zeros((kg, 8), dtype=torch.int64, device=dev)
                n_live = (ids != n_rows).sum(1)
                ctl[:, 0] = {None: 0, "live": n_live, "zero": 0, "c": c,
                             "past": c + 5, "pads": n_live}[cnt]
                if cnt == "pads":                    # X3's in-place pads
                    hole = torch.rand(ids.shape, device=dev) < 0.3
                    ids[hole], qid[hole] = n_rows, 1 << 30
                counted = cnt is not None
                hub_recv = torch.zeros((kg, k, 1 + cap_e), dtype=torch.int64,
                                       device=dev)
                for y in range(kg):
                    for d in range(k):
                        n = int(rng.integers(0, 2 * cap_e))
                        lo = members[y] * chunk
                        rows = rng.integers(lo, min(lo + chunk, n_rows),
                                            min(n, cap_e))
                        hub_recv[y, d, 0] = n
                        hub_recv[y, d, 1:1 + len(rows)] = torch.from_numpy(
                            (rng.integers(0, qmax, len(rows)) << 32)
                            | rows).to(dev)
                for hub, hr in ((True, None), (False, None),
                                (False, hub_recv)):
                    recv = torch.zeros((kg, k, 1 + cap), dtype=torch.int64,
                                       device=dev)
                    send = torch.zeros_like(recv) if kg < k else None
                    args = [hub, ids, qid, st, g, tuple(over), recv, send,
                            ctl.clone(), hr, counted]
                    want = [a.clone() if isinstance(a, torch.Tensor) else a
                            for a in args]
                    ell_ops.mesh_route_card(*args)
                    ell_ops.mesh_route_card_ref(*want)
                    torch.cuda.synchronize()
                    for i, (a, b) in enumerate(zip(args, want)):
                        if isinstance(a, torch.Tensor) and not same(i, a, b):
                            raise AssertionError(
                                f"mesh_route_card {label} k={k} c={c} "
                                f"cnt={cnt} hub={hub} recv={hr is not None}"
                                f" cap={cap} cards={len(mesh.groups)} != its "
                                f"plain version (operand {i})")
                    cases += 1
                depth = torch.full((kg, chunk, qmax), 0x7FFF,
                                   dtype=torch.int16, device=dev)
                depth[torch.rand(depth.shape, device=dev) < 0.01] = 1
                tbits = torch.randint(-2**31, 2**31 - 1, (kg, qmax * W),
                                      dtype=torch.int32, device=dev)
                tick = torch.zeros((kg, 2), dtype=torch.int64, device=dev)
                init = starts
                tt = (ids.roll(3, 1).contiguous(), qid.roll(3, 1)
                      .contiguous()) if init else (None, None)
                args = [init, ids.clone(), qid.clone(), depth, tbits, st, g,
                        2, ctl.clone(), *tt, counted, tick]
                want = [a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args]
                ell_ops.mesh_bfs_stamp_card(*args)
                ell_ops.mesh_bfs_stamp_card_ref(*want)
                torch.cuda.synchronize()
                for i, (a, b) in enumerate(zip(args, want)):
                    if isinstance(a, torch.Tensor) and not torch.equal(a, b):
                        raise AssertionError(
                            f"mesh_bfs_stamp_card {label} k={k} c={c} "
                            f"cnt={cnt} init={init} cards="
                            f"{len(mesh.groups)} != its plain version "
                            f"(operand {i})")
                cases += 1
    return {"cases": cases}


def hubless_ell(n: int, seed: int):
    """A power-law graph whose every vertex fits its ELL row (no hub
    extra rows): ``powerlaw_graph(n, 8n, 2.2, 256, seed)`` at cap 512."""
    from nebula_tpu_torch.tpu.csr import mirror_from_edges
    from nebula_tpu_torch.tpu.ell import EllIndex
    from nebula_tpu_torch.tools.graphgen import powerlaw_graph
    src, dst = powerlaw_graph(n, 8 * n, 2.2, 256, seed)
    m = mirror_from_edges(src, dst, 1, space_id=1)
    ix = EllIndex.build(m.edge_src, m.edge_dst, m.edge_etype, m.n, cap=512)
    if ix.n_rows != ix.n:
        raise AssertionError("the hub-free graph has hub extra rows")
    return ix


MESH_SPARSE = {"tpu_mesh_devices": 4, "tpu_mesh_mode": "sparse"}
MESH_SPARSE_WRITES = 16        # part (c)'s acked, read-back edge writes
# a frontier-sharded batch that quietly ran single-device would launch
# one of these
SINGLE_SPARSE = SINGLE_CARD + ("sparse_expand",)


def mesh_sparse_phase(torch, ell_ops, flags, m, schema, oracle: GoOracle,
                      path_oracle: PathOracle, vids: np.ndarray, n: int,
                      requests: int, threads: int, path_requests: int,
                      path_threads: int, seed: int, device=None) -> dict:
    """``tpu_mesh_devices=4`` in the default ``tpu_mesh_mode=sparse`` on
    a runtime whose 4 shards all sit on this card, counted as one window
    (launch counts zeroed before part a, read after part c): (a)
    ``requests`` GO of the serve kinds without UPTO (COUNT(*) and ``|
    LIMIT 10`` among them) from ``threads`` threads in the default
    continuous mode, which refuses the stream; (b) ``path_requests``
    FIND SHORTEST PATH ... UPTO 5 STEPS from ``path_threads`` threads and
    8 FIND ALL PATH, every answer checked; (c) ``mesh_write_part`` in
    sparse mode with MESH_SPARSE_WRITES writes.  64 GO answers of (a)
    are checked against the oracle.  ``mesh_sparse_go`` and
    ``mesh_sparse_bfs`` must have served; a batch the frontier-sharded
    programs overflow reruns on the dense mesh (counted); no single-card
    hop, sparse or adaptive kernel may run.  ``device`` is the shards'
    (None: the card)."""
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    dev = torch.device("cuda", 0) if device is None else device
    rt = TorchQueryRuntime(device=dev,
                           mesh_devices=[dev] * MESH_SPARSE[
                               "tpu_mesh_devices"])
    out = {}
    served = {}
    try:
        rt.load_space(1, m, schema)
        rng = np.random.default_rng(seed + 73)
        mix, limits = unpacked_mix(rng, n, requests)
        mix = (mix[0], mix[1], np.zeros(requests, bool), mix[3])
        limits = ~mix[3] & (rng.random(requests) < 0.25)
        check = go_check_set(rng, limits, requests)
        with flag_mode(flags, MESH_SPARSE):
            if rt.continuous_session(1, (1,)) is not None:
                raise AssertionError("a continuous session anchored on a "
                                     "mesh")
            t0 = time.perf_counter()
            rt.serve_go(1, [1], [1], 3, {1: "e"})     # cuts the chunks
            out["shard_s"] = time.perf_counter() - t0
            torch.cuda.synchronize()
            ell_ops.reset_launches()
            rt0 = dict(rt.stats)
            wall, lat, results = drive(rt, mix, threads, check, limits)
            stats = {x: rt.stats[x] - rt0[x] for x in rt0}
        check_go(oracle, mix, results, check, limits)
        if rt.continuous.streams():
            raise AssertionError("a continuous stream anchored on a mesh")
        if not stats["go_mesh_sparse"] or stats["go_sparse"] \
                or stats["go_adaptive"]:
            raise AssertionError(f"part (a) left the mesh: {stats}")
        out["a"] = dict(lat_stats(requests, wall, lat), threads=threads,
                        checked=len(check),
                        go_mesh_sparse=stats["go_mesh_sparse"],
                        go_mesh_dense=stats["go_mesh"],
                        sparse_overflows=stats["sparse_overflows"],
                        mean_batch=requests / max(
                            stats["go_mesh_sparse"] + stats["go_mesh"]
                            - stats["sparse_overflows"], 1),
                        count_requests=int(mix[3].sum()),
                        limit_requests=int(limits.sum()))
        served["go"] = {"mesh_sparse_go": stats["go_mesh_sparse"]
                        - stats["sparse_overflows"],
                        "ell_go_sharded": stats["go_mesh"]}

        # (b) FIND SHORTEST PATH, every answer checked, then FIND ALL PATH
        rng_b = np.random.default_rng(seed + 79)
        srcs = rng_b.choice(vids, path_requests)
        dsts = rng_b.choice(vids, path_requests)
        with flag_mode(flags, MESH_SPARSE):
            rt0 = dict(rt.stats)
            wall, plat, presults = drive_paths(rt, srcs, dsts, path_threads)
            reachable, all_checked, all_rows, t_all = check_paths(
                rt, path_oracle, vids, srcs, dsts, presults, rng_b)
            stats = {x: rt.stats[x] - rt0[x] for x in rt0}
        if stats["bfs_mesh_sparse"] + stats["path_mesh"] \
                != stats["bfs_dispatches"] or not stats["bfs_mesh_sparse"]:
            raise AssertionError(f"part (b) left the mesh or never took "
                                 f"the frontier-sharded BFS: {stats}")
        out["b"] = dict(lat_stats(path_requests, wall, list(plat.values())),
                        threads=path_threads, checked=path_requests,
                        checked_reachable=reachable,
                        bfs_dispatches=stats["bfs_dispatches"],
                        bfs_mesh_sparse=stats["bfs_mesh_sparse"],
                        bfs_mesh_dense=stats["path_mesh"],
                        sparse_overflows=stats["sparse_overflows"],
                        levels_per_dispatch=stats["bfs_levels"]
                        / max(stats["bfs_dispatches"], 1),
                        all_path_checked=all_checked,
                        all_path_rows=all_rows, all_path_s=t_all)
        served["bfs"] = {"mesh_sparse_bfs": stats["bfs_mesh_sparse"],
                         "ell_bfs_sharded": stats["path_mesh"]}

        # (c) writes read back through the frontier-sharded mesh
        with flag_mode(flags, MESH_SPARSE):
            out["c"] = mesh_write_part(torch, ell_ops, flags, dev, seed,
                                       writes=MESH_SPARSE_WRITES,
                                       sparse=True)
    finally:
        rt.close()
    launches = dict(ell_ops.LAUNCHES)
    require_launched(launches, "mesh_sparse")
    ran = {x: launches[x] for x in SINGLE_SPARSE if launches[x]}
    if ran:
        raise AssertionError(f"the mesh-sparse phase ran single-card "
                             f"kernels: {ran}")
    log(f"[mesh-sparse] batches served by design: {json.dumps(served)}; "
        f"sparse_overflows (a) {out['a']['sparse_overflows']}, (b) "
        f"{out['b']['sparse_overflows']}")
    out["served"] = served
    out["launches"] = launches
    return out


# ================================= phase 14: the dispatcher's host half
PROPS_THREADS = 16
PROPS_E = (128, 64)            # part (e): OVER e, f; the same REVERSELY
PROPS_COLS = ["e._src", "e._dst", "e._rank", "e.w", "e.score", "e.kind"]
# the windowed route's kernels part (b) runs (the sparse program at the
# default flags) beside the continuous session's four
PATH_KERNELS["props"] = PATH_KERNELS["serve"] + (
    "sparse_go", "sparse_expand", "pair_compact", "pair_reduce")


class PropsOracle:
    """Plain numpy semantics, at the store's precision (int64, float64),
    of the GO shapes the dispatcher's host half serves, independent of
    the port's compiler: ``GO [UPTO] N STEPS FROM v OVER e [WHERE P]
    YIELD ...`` on the forward edge list (an edge key keeps the values
    of its last input occurrence, N-1 hops as GoOracle, UPTO the union
    of depths 0..N-1, the final hop's out-edges in (src, dst) order), P
    one of ``FUSED_PREDICATES`` written directly in int64 / float64, a
    pushed row whose P reads an absent tag prop or divides by zero
    dropped."""

    def __init__(self, go: GoOracle, src, dst, raw, n: int):
        self.go = go
        key = (np.asarray(src, np.int64) << 32) | np.asarray(dst, np.int64)
        uk, first = np.unique(key[::-1], return_index=True)
        if not np.array_equal(uk, (go.src << 32) | go.dst):
            raise AssertionError("oracle keys disagree")
        last = len(key) - 1 - first
        self.w = raw["w"][last].astype(np.int64)
        self.score = raw["score"][last].astype(np.float64)
        self.kind = raw["kind"][last].astype(np.int64)
        self.tagged, self.age = raw["tagged"], raw["age"].astype(np.int64)
        self.vid_lit = n // 2

    def frontier(self, start: int, steps: int, upto: bool) -> np.ndarray:
        f = np.unique(np.asarray([start], np.int64))
        acc = f
        for _ in range(steps - 1):
            f = np.unique(self.go.dst[self.go.out_edges(f)])
            acc = np.union1d(acc, f)
        return acc if upto else f

    def where(self, p: int, idx: np.ndarray) -> np.ndarray:
        w, s, k = self.w[idx], self.score[idx], self.kind[idx]
        sv, dv = self.go.src[idx], self.go.dst[idx]
        if p == 0:
            return w > 500
        if p == 1:
            return s <= 2.5
        if p == 2:
            return (k == 3) | (k > 12)
        if p == 3:
            return (w % 7 == 3) & (s > 1.0)
        if p == 4:
            return self.tagged[dv] & (self.age[dv] > 40)
        if p == 5:
            return self.tagged[sv] & (self.age[sv] < 30) & (w < 700)
        if p == 6:
            return dv < self.vid_lit
        if p == 7:
            return (w != 0) & (1000 // np.maximum(w, 1) > 3)
        raise ValueError(p)

    @staticmethod
    def _distinct(rows):
        seen, out = set(), []
        for r in rows:
            if tuple(r) not in seen:
                seen.add(tuple(r))
                out.append(r)
        return out

    def where_rows(self, start: int, steps: int, upto: bool, p: int,
                   distinct: bool):
        """(columns, rows) of ``... WHERE P YIELD e._dst, e.w`` (and
        ``$$.person.age`` behind AGE_PREDICATE)."""
        idx = self.go.out_edges(self.frontier(start, steps, upto))
        idx = idx[self.where(p, idx)]
        cols = [self.go.dst[idx], self.w[idx]]
        names = ["e._dst", "e.w"]
        if p == AGE_PREDICATE:
            cols.append(self.age[self.go.dst[idx]])
            names.append("$$.person.age")
        rows = [list(r) for r in zip(*[c.tolist() for c in cols])]
        return names, self._distinct(rows) if distinct else rows

    def prop_rows(self, start: int, steps: int, kind_only: bool):
        """(columns, rows) of ``YIELD e._src, e._dst, e._rank, e.w,
        e.score, e.kind``, or of ``YIELD DISTINCT e.kind``."""
        idx = self.go.out_edges(self.frontier(start, steps, False))
        kinds = np.asarray(KINDS)[self.kind[idx]].tolist()
        if kind_only:
            return ["e.kind"], self._distinct([[k] for k in kinds])
        cols = [self.go.src[idx].tolist(), self.go.dst[idx].tolist(),
                [0] * len(idx), self.w[idx].tolist(),
                self.score[idx].tolist(), kinds]
        return list(PROPS_COLS), [list(r) for r in zip(*cols)]

    def meta_rows(self, start: int, steps: int) -> list:
        idx = self.go.out_edges(self.frontier(start, steps, False))
        return [list(r) for r in zip(self.go.src[idx].tolist(),
                                     self.go.dst[idx].tolist())]


class TypedOracle:
    """``GO 2 STEPS FROM v OVER e, f [REVERSELY] YIELD e._dst, e._type``
    on an edge list whose edges have a type each (1 = e, 2 = f),
    independent of the port: a stored row per (src, type, dst) in both
    directions (a reverse row under -type, so f's rows lead there), a
    vertex's rows sorted by (signed type, dst); the frontier is every
    row's dst out of the start, the final hop every row out of it in
    vid order."""

    def __init__(self, src, dst, types):
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        types = np.asarray(types, np.int64)
        self.rows = {}
        for reverse, (a, b, t) in ((False, (src, dst, types)),
                                   (True, (dst, src, -types))):
            key = np.unique(((a << 34) | ((t + 2) << 31) | b))
            self.rows[reverse] = (key >> 34, ((key >> 31) & 7) - 2,
                                  key & ((1 << 31) - 1))

    def rows_from(self, start: int, reverse: bool) -> list:
        a, t, b = self.rows[reverse]
        lo, hi = np.searchsorted(a, [start, start + 1])
        f = np.unique(b[lo:hi])
        lo, hi = np.searchsorted(a, f, "left"), np.searchsorted(a, f, "right")
        idx = np.concatenate([np.arange(x, y) for x, y in zip(lo, hi)]
                             + [np.zeros(0, np.int64)]).astype(np.int64)
        return [[int(v), "e" if abs(int(e)) == 1 else "f"]
                for v, e in zip(b[idx], t[idx])]


def props_mix(rng, n: int, requests: int):
    """The four windowed parts' requests: (part, start, steps, predicate,
    pushed, distinct, variant) a request, a quarter each."""
    q = requests // 4
    out = []
    for part in "abcd":
        starts = rng.integers(1, n + 1, q)
        pushed = rng.random(q) < 0.75
        preds = np.where(pushed, rng.choice(PUSHED_PREDICATES, q),
                         rng.choice(GRAPHD_PREDICATES, q))
        distinct = rng.random(q) < 0.25
        if part == "a":
            steps = rng.integers(2, 4, q)
        elif part == "d":
            steps = rng.integers(2, 4, q)
            distinct = rng.random(q) < 0.5          # variant: LIMIT
        else:
            steps = rng.integers(1, 4, q)
        if part == "c":
            distinct = rng.random(q) < 0.125        # YIELD DISTINCT e.kind
        out.append([(part, int(starts[i]), int(steps[i]), int(preds[i]),
                     bool(pushed[i]), bool(distinct[i]))
                    for i in range(q)])
    return out


def props_call(rt, blobs, meta, req):
    """One request of ``props_mix`` through the user's entry point."""
    part, start, steps, p, pushed, flag = req
    if part in "ab":
        where, ys = blobs[p]
        return rt.serve_go(1, [start], [1], steps, {1: "e"},
                           upto=part == "a", where_blob=where,
                           yield_specs=ys, distinct=flag,
                           pushed_mode=pushed)
    if part == "c":
        ys = meta["kind"] if flag else meta["props"]
        return rt.serve_go(1, [start], [1], steps, {1: "e"},
                           yield_specs=ys, distinct=flag)
    return rt.serve_go(1, [start], [1], steps, {1: "e"},
                       yield_specs=meta["meta"],
                       reduce=None if flag else ("count",),
                       limit=LIMIT_N if flag else None)


def _limit_cut(rows, full, label: str) -> None:
    """``rows`` are min(LIMIT_N, len(full)) rows of ``full``, each as
    often at most as it is there (phase 6's LIMIT check)."""
    want = {}
    for r in full:
        want[tuple(r)] = want.get(tuple(r), 0) + 1
    got = {}
    for r in rows:
        got[tuple(r)] = got.get(tuple(r), 0) + 1
    if len(rows) != min(LIMIT_N, len(full)) or any(
            c > want.get(k, 0) for k, c in got.items()):
        raise AssertionError(f"{label}: LIMIT {LIMIT_N} rows are not a "
                             f"cut of the oracle's")


def props_check(po: PropsOracle, req, answer) -> int:
    """Hold one answer of ``props_mix`` to the oracle; returns its
    rows."""
    part, start, steps, p, pushed, flag = req
    cols, rows = list(answer[0]), [list(r) for r in answer[1]]
    label = f"[props] ({part}) {req}"
    if part in "ab":
        want = po.where_rows(start, steps, part == "a", p, flag)
    elif part == "c":
        want = po.prop_rows(start, steps, flag)
    elif flag:
        if cols != ["e._src", "e._dst"]:
            raise AssertionError(f"{label}: columns {cols}")
        _limit_cut(rows, po.meta_rows(start, steps), label)
        return len(rows)
    else:
        want = (["__count__"], [[len(po.meta_rows(start, steps))]])
    if (cols, rows) != (want[0], want[1]):
        raise AssertionError(f"{label}: {len(rows)} rows, the oracle has "
                             f"{len(want[1])}")
    return len(rows)


def _assemble_s(rt) -> float:
    """Host assembly seconds so far: the windowed leaders' and every
    continuous stream's."""
    return rt.stats["t_assemble_s"] + sum(
        st.stats["t_assemble_s"] for st in rt.continuous.streams())


def _leaves(rt, space: int) -> int:
    return sum(st.stats["leaves"] for st in rt.continuous.streams()
               if st.space_id == space)


def props_space(src, dst, n: int, seed: int):
    """Part (e)'s space: the serve graph's edges, each of type e (1) or
    f (2) by a seeded coin, with the serve graph's columns on both
    types.  Returns (mirror, the type of each input edge)."""
    from nebula_tpu_torch.tpu.csr import mirror_from_edges
    types = np.where(np.random.default_rng(seed + 23).random(len(src))
                     < 0.5, 1, 2)
    edge_props, vertex_props, _raw = fused_columns(src, dst, n, seed)
    m2 = mirror_from_edges(src, dst, types, space_id=2,
                           edge_props={1: edge_props[1], 2: edge_props[1]},
                           vertex_props=vertex_props)
    return m2, types


def props_phase(torch, rt, ell_ops, edge_ops, flags, po: PropsOracle,
                blobs, src, dst, n: int, requests: int, seed: int,
                fused_qps: float) -> dict:
    """Phase 14: the shapes the dispatcher's host half serves, on the
    serve graph at default flags (continuous mode).  One counted window
    of four parts, each from PROPS_THREADS threads: (a) ``GO UPTO 2-3
    STEPS ... WHERE P YIELD e._dst, e.w`` (P from phase 8's family in
    its modes, a quarter DISTINCT) on the continuous stream; (b) phase
    8's ``GO 1-3 STEPS ... WHERE P`` under ``tpu_filter_mode=host``,
    windowed at the default routes; (c) ``GO 1-3 STEPS ... YIELD
    e._src, e._dst, e._rank, e.w, e.score, e.kind`` (an eighth ``YIELD
    DISTINCT e.kind``); (d) ``GO 2-3 STEPS ... YIELD e._src, e._dst``,
    half ``| LIMIT 10``, half ``| YIELD COUNT(*)``.  64 answers of each
    checked.  Then (e) on a second space (the same edges, each of type
    e or f): PROPS_E ``GO 2 STEPS ... OVER e, f YIELD e._dst, e._type``
    and as many REVERSELY, every answer checked.  No request may
    decline or fail, nothing may fuse, the continuous stream must take
    the UPTO riders and every (e) request, the window of (a)-(d) must
    launch the continuous session's kernels and the windowed route's,
    and (e)'s own counted window the continuous session's."""
    from nebula_tpu_torch.filter.expressions import _from_wire, encode_expr
    from nebula_tpu_torch.meta.schema import SchemaView

    def enc(ws):
        return [(encode_expr(_from_wire(w)), None) for w in ws]

    meta = {"props": enc([["e_src", "e"], ["e_dst", "e"], ["e_rank", "e"],
                          E_ + ["w"], E_ + ["score"], E_ + ["kind"]]),
            "kind": enc([E_ + ["kind"]]),
            "meta": enc([["e_src", "e"], ["e_dst", "e"]])}
    rng = np.random.default_rng(seed + 29)
    parts = props_mix(rng, n, requests)
    # warm every (predicate, mode) group's columns and the stream outside
    # the window, as a server holds them warm
    for i, (where, ys) in enumerate(blobs):
        for pm in _modes(i):
            rt.serve_go(1, [1], [1], 2, {1: "e"}, upto=True,
                        where_blob=where, yield_specs=ys, pushed_mode=pm)
    torch.cuda.synchronize()
    rt0 = dict(rt.stats)
    ell_ops.reset_launches()
    edge_ops.reset_launches()
    out = {}
    for part, reqs in zip("abcd", parts):
        check = set(rng.choice(len(reqs), min(64, len(reqs)),
                               replace=False).tolist())
        leaves0, asm0 = _leaves(rt, 1), _assemble_s(rt)
        mode = {"tpu_filter_mode": "host", "go_dispatch_mode": "windowed"} \
            if part == "b" else {}
        with flag_mode(flags, mode):
            wall, lat, kept = drive_calls(
                lambda r: props_call(rt, blobs, meta, r), reqs,
                PROPS_THREADS, check)
        rows = sum(props_check(po, reqs[i], kept[i]) for i in sorted(check))
        out[part] = dict(lat_stats(len(reqs), wall, lat), checked=len(check),
                         checked_rows=rows,
                         t_assemble_s=_assemble_s(rt) - asm0,
                         stream_leaves=_leaves(rt, 1) - leaves0)
        out[part]["t_assemble_s_per_request"] = \
            out[part]["t_assemble_s"] / len(reqs)
    launches = dict(ell_ops.LAUNCHES)
    fused_launches = dict(edge_ops.LAUNCHES)
    stats = {k: rt.stats[k] - rt0[k] for k in rt0}
    require_launched(launches, "props")
    if out["a"]["stream_leaves"] != len(parts[0]):
        raise AssertionError(f"the continuous stream took "
                             f"{out['a']['stream_leaves']} of "
                             f"{len(parts[0])} UPTO riders")
    # (e): a second space with two edge types
    t0 = time.perf_counter()
    m2, types = props_space(src, dst, n, seed)
    rt.load_space(2, m2, SchemaView().add_space(
        2, {"person": FUSED_TAG}, {"e": 1, "f": 2}))
    typed = TypedOracle(src, dst, types)
    ys = enc([["e_dst", "e"], ["e_type", "e"]])
    fwd, rev = ({1: "e", 2: "f"}, {-1: "e", -2: "f"})
    for e2a in (fwd, rev):
        rt.serve_go(2, [1], list(e2a), 2, e2a, yield_specs=ys)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    e_reqs = [(int(v), False) for v in rng.integers(1, n + 1, PROPS_E[0])] \
        + [(int(v), True) for v in rng.integers(1, n + 1, PROPS_E[1])]
    leaves0, asm0, fused0 = _leaves(rt, 2), _assemble_s(rt), \
        rt.stats["go_fused"]
    ell_ops.reset_launches()
    edge_ops.reset_launches()
    wall, lat, kept = drive_calls(
        lambda r: rt.serve_go(2, [r[0]], list(rev if r[1] else fwd), 2,
                              rev if r[1] else fwd, yield_specs=ys),
        e_reqs, PROPS_THREADS, set(range(len(e_reqs))))
    launches_e = dict(ell_ops.LAUNCHES)
    fused_launches = {k: v + edge_ops.LAUNCHES[k]
                      for k, v in fused_launches.items()}
    require_launched(launches_e, "serve")
    rows_e = 0
    for i, (start, reverse) in enumerate(e_reqs):
        cols, rows = kept[i]
        want = typed.rows_from(start, reverse)
        if list(cols) != ["e._dst", "e._type"] or \
                [list(r) for r in rows] != want:
            raise AssertionError(f"[props] (e) {start} reverse {reverse}: "
                                 f"{len(rows)} rows, the oracle has "
                                 f"{len(want)}")
        rows_e += len(want)
    out["e"] = dict(lat_stats(len(e_reqs), wall, lat),
                    checked=len(e_reqs), checked_rows=rows_e,
                    reversely=PROPS_E[1], load_s=load_s,
                    t_assemble_s=_assemble_s(rt) - asm0,
                    stream_leaves=_leaves(rt, 2) - leaves0)
    out["e"]["t_assemble_s_per_request"] = \
        out["e"]["t_assemble_s"] / len(e_reqs)
    if out["e"]["stream_leaves"] != len(e_reqs):
        raise AssertionError(f"the continuous stream took "
                             f"{out['e']['stream_leaves']} of "
                             f"{len(e_reqs)} (e) requests")
    launches = {k: v + launches_e[k] for k, v in launches.items()}
    fused_moved = stats["go_fused"] + rt.stats["go_fused"] - fused0
    if fused_moved or any(fused_launches.values()):
        raise AssertionError(f"go_fused moved by {fused_moved} in [props]")
    out.update(requests=requests + len(e_reqs), threads=PROPS_THREADS,
               fused_qps_same_family=fused_qps, launches=launches,
               go_fused=fused_moved, runtime=stats)
    return out


# ========================================================= --profile
def profile_phase(torch, run) -> dict:
    """``run() -> (requests, wall seconds)`` under torch.profiler (CPU +
    CUDA): the card's busy time by kernel and its idle share over the
    window.  Not part of the default run; device times are None when
    the profiler recorded none."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        requests, wall = run()
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


def profile_all(torch, rt, flags, vids, args, blobs) -> dict:
    """``--profile R``: a further window of each traffic kind — R
    continuous GO, R windowed GO on the dense route and R on the sparse
    route, R / 16 sequential adaptive GO, R / 4 fused GO with a WHERE,
    R / 4 FIND SHORTEST PATH, then R GO without UPTO on a 4-shard mesh
    on this card (``[mesh]``'s runtime and flags) — each under the
    profiler, on fresh seeds."""
    R = args.profile
    mix = request_mix(np.random.default_rng(args.seed + 2), args.vertices,
                      R)

    def go():
        return R, drive(rt, mix, args.threads)[0]

    out = {"serve": profile_phase(torch, go)}
    with flag_mode(flags, WINDOWED):
        out["windowed"] = profile_phase(torch, go)
    with flag_mode(flags, SPARSE):
        out["sparse"] = profile_phase(torch, go)
    A = max(1, R // 16)
    single = (mix[0][:A], mix[1][:A], np.zeros(A, bool), np.zeros(A, bool))
    with flag_mode(flags, ADAPTIVE):
        out["adaptive"] = profile_phase(
            torch, lambda: (A, drive(rt, single, 1)[0]))
    rng = np.random.default_rng(args.seed + 5)
    P = max(1, R // 4)
    fr = np.random.default_rng(args.seed + 6)
    pushed = fr.random(P) < 0.75
    reqs = [(int(fr.integers(1, args.vertices + 1)), int(fr.integers(1, 4)),
             int(fr.choice(PUSHED_PREDICATES if pm else GRAPHD_PREDICATES)),
             bool(pm), bool(fr.random() < 0.25)) for pm in pushed]
    out["fused"] = profile_phase(torch, lambda: (
        P, drive_fused(rt, reqs, blobs, args.fused_threads, set())[0]))
    ends = rng.choice(vids, (2, P))
    out["path"] = profile_phase(torch, lambda: (
        P, drive_paths(rt, ends[0], ends[1], args.path_threads)[0]))
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    dev = torch.device("cuda", 0)
    mrt = TorchQueryRuntime(device=dev,
                            mesh_devices=[dev] * MESH["tpu_mesh_devices"])
    try:
        mrt.load_space(1, rt.mirror(1), rt.schemas[1])
        flat = (mix[0], mix[1], np.zeros(R, bool), mix[3])
        with flag_mode(flags, MESH):
            mrt.serve_go(1, [1], [1], 3, {1: "e"})     # shards the tables
            out["mesh"] = profile_phase(torch, lambda: (
                R, drive(mrt, flat, args.threads)[0]))
    finally:
        mrt.close()
    return out


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
    ap.add_argument("--path-requests", type=int, default=512)
    ap.add_argument("--path-threads", type=int, default=16)
    ap.add_argument("--profile", type=int, default=0, metavar="R",
                    help="after phase 9, serve R more continuous, R "
                         "dense and R sparse windowed GO requests, R/16 "
                         "adaptive GO, R/4 fused GO, R/4 FIND PATH "
                         "and R GO on a 4-shard mesh, each "
                         "under torch.profiler, and print the card's busy "
                         "time and idle share")
    ap.add_argument("--adaptive-requests", type=int, default=256)
    ap.add_argument("--fused-requests", type=int, default=512)
    ap.add_argument("--fused-threads", type=int, default=16)
    ap.add_argument("--write-vertices", type=int, default=1 << 17)
    ap.add_argument("--write-edges", type=int, default=1 << 19,
                    help="forward edges of the [write] space (each "
                         "stored in both directions)")
    ap.add_argument("--write-seconds", type=float, default=20.0)
    ap.add_argument("--unpacked-requests", type=int, default=1024,
                    help="GO requests of each of the [unpacked] phase's "
                         "parts a and b")
    ap.add_argument("--unpacked-path-requests", type=int, default=128)
    ap.add_argument("--mesh-requests", type=int, default=1024,
                    help="GO requests of the [mesh] and [mesh-sparse] "
                         "phases' part a")
    ap.add_argument("--mesh-path-requests", type=int, default=128,
                    help="FIND SHORTEST PATH requests of the [mesh] and "
                         "[mesh-sparse] phases' part b")
    ap.add_argument("--props-requests", type=int, default=512,
                    help="GO requests of the [props] phase's parts a-d, "
                         "a quarter each")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 2
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.meta.schema import SchemaView
    from nebula_tpu_torch.tpu import _build, edge_ops, ell_ops
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
    steps = _build.LAST_BUILD
    log(f"[build] nvcc {_build.NVCC_FLAGS[1]} "
        f"{time.perf_counter() - t0:.2f} s -> {_build.LIB_PATH}; "
        + ", ".join(f"{k} {v:.2f} s" for k, v in steps.items())
        + f" (the sources compile together; one after another they "
        f"would take {sum(steps.values()):.2f} s)")

    if args.cap is not None:
        flags.set("tpu_ell_cap", args.cap)
    if args.widths is not None:
        flags.set("go_batch_widths", args.widths)

    # ---- the serve graph (phase 3 runs on its tables)
    t0 = time.perf_counter()
    src, dst = powerlaw_graph(args.vertices, args.edges, 2.2, 20000,
                              args.seed)
    edge_props, vertex_props, raw = fused_columns(src, dst, args.vertices,
                                                  args.seed)
    m = mirror_from_edges(src, dst, 1, space_id=1, edge_props=edge_props,
                          vertex_props=vertex_props)
    rt = TorchQueryRuntime()
    try:
        rt.load_space(1, m, SchemaView().add_space(
            1, {"person": FUSED_TAG}, {"e": 1}))
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
            t0 = time.perf_counter()
            per_width[B] = kernel_phase(torch, ell_ops, tables, eslot,
                                        hrows, ix, B, (1,), rng)
            per_width[B].update(batch_kernel_phase(
                torch, ell_ops, rt, m, ix, tables, eslot, hrows, B, (1,),
                rng))
            for k, v in per_width[B].items():
                log(f"[kernel] {k} B={B} W={B // 8} equal=True "
                    + " ".join(f"{a}={b}" for a, b in v.items()))
            log(f"[kernel] B={B} phase {time.perf_counter() - t0:.2f} s")
        # K1 and K2 at B = 32 too, and on rows off an upload block's range
        t0 = time.perf_counter()
        b32, f32 = upload_rows(torch, ell_ops, rt, ix, 32,
                               ix.perm[rng.integers(0, ix.n, 32)],
                               np.arange(32, dtype=np.int32))
        per_width[128]["frontier_upload"]["b32"] = b32
        per_width[128]["go_count"]["b32"] = count_rows(
            torch, ell_ops, ell_ops.ell_go(f32, tables, eslot, hrows, (1,), 3),
            rt._deg_dev(m, ix, (1,)), 32, "3-step")
        for k in ("frontier_upload", "go_count"):
            log(f"[kernel] {k} B=32 equal=True "
                + json.dumps(per_width[128][k]["b32"]))
        log("[kernel] frontier_upload and go_count on odd rows equal=True "
            + json.dumps(odd_rows_check(torch, ell_ops, dev, rng)))
        log(f"[kernel] K1 and K2 at B=32 and on odd rows "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        mix_starts = m.to_dense(request_mix(
            np.random.default_rng(args.seed + 1), args.vertices,
            args.requests)[0])
        sparse_rows, sparse_runs = sparse_kernel_phase(
            torch, ell_ops, rt, m, ix, tables, eslot, hrows, (1,),
            mix_starts[mix_starts >= 0])
        for label, v in sparse_runs.items():
            log(f"[kernel] {label} equal=True " + json.dumps(v))
        k4 = k4_odd_check(torch, ell_ops, rt, m, ix, tables, rng)
        log("[kernel] sparse_expand at odd shapes and gated equal=True "
            + json.dumps(k4))
        sparse_rows["sparse_expand"].update(k4)
        k5 = k5_caller_check(torch, ell_ops, ix, tables, rng)
        log("[kernel] pair_compact in each caller's form equal=True "
            + json.dumps(k5))
        sparse_rows["pair_compact"].update(
            callers_held=k5, c0_2048={
                a: sparse_runs["c0_2048_s3_plain"]["kernels"][
                    "pair_compact"][a]
                for a in ("ms", "plain_ms", "bound_ms", "calls")})
        log(f"[kernel] sparse and adaptive phase "
            f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        oracle = GoOracle(src, dst)
        blobs = fused_request_blobs(fused_predicates(args.vertices))
        edge_rows, edge_runs = edge_kernel_phase(torch, edge_ops, rt, m,
                                                 oracle, blobs, rng)
        for label, v in edge_runs.items():
            log(f"[kernel] {label} equal=True " + json.dumps(v))
        for k in ("edge_seed", "edge_hop", "edge_final", "edge_final_where",
                  "expr_filter", "edge_bfs_level"):
            log(f"[kernel] {k} equal=True " + json.dumps(edge_rows[k]))
        log(f"[kernel] edge-list phase {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        absorb_rows = absorb_kernel_phase(torch, ell_ops, rt, m, ix,
                                          tables, rng)
        log("[kernel] ell_absorb equal=True inputs_unchanged=True "
            + json.dumps(absorb_rows["ell_absorb"]))
        log(f"[kernel] absorb phase {time.perf_counter() - t0:.2f} s")
        int8_rows = {}
        for B in (1024, 128):
            t0 = time.perf_counter()
            int8_rows[B] = int8_kernel_phase(torch, ell_ops, m, ix, tables,
                                             eslot, hrows, B, (1,), rng)
            for k, v in int8_rows[B].items():
                log(f"[kernel] {k} B={B} equal=True " + json.dumps(v))
            log(f"[kernel] int8 B={B} phase "
                f"{time.perf_counter() - t0:.2f} s")
        for B, offset in TAIL_CASES:
            tail = int8_tail_check(torch, ell_ops, ix, tables, eslot, hrows,
                                   (1,), rng, B, offset)
            log("[kernel] int8 off the ladder " + json.dumps(tail))
        log("[kernel] go_hop_i8 row-packed on mid-group buckets equal=True "
            + json.dumps(fused_pack_odd_check(torch, ell_ops, rng, dev)))
        log("[kernel] go_hop widths " + json.dumps(hop_width_check(
            torch, ell_ops, ix, tables, eslot, hrows, (1,), rng)))
        log("[compare] ell_go at 3 steps, int8 vs packed, ms: "
            + json.dumps({B: [int8_rows[B]["ell_go_i8"]["ms"],
                              int8_rows[B]["ell_go_i8"]["packed_ell_go_ms"]]
                          for B in (1024, 128)}))
        mesh_rows = {}
        mesh_windows = absorb_windows(m, ix,
                                      np.random.default_rng(args.seed + 13))
        for k in MESH_KS:
            for B in (1024, 128):
                t0 = time.perf_counter()
                mesh_rows[k, B] = mesh_kernel_phase(
                    torch, ell_ops, edge_ops, rt, m, ix, tables, eslot,
                    hrows, k, B, (1,), rng, mesh_windows)
                for kname, v in mesh_rows[k, B].items():
                    log(f"[kernel] {kname} k={k} B={B} equal=True "
                        + json.dumps(v))
                log(f"[kernel] mesh k={k} B={B} phase "
                    f"{time.perf_counter() - t0:.2f} s")
        del mesh_windows
        from nebula_tpu_torch.tpu.mesh import psum_or
        psum_rows = {}
        for k in MESH_KS:
            psum_rows[k] = psum_phase(torch, ell_ops, psum_or, k,
                                      tables.nbr.device, rng)
            log(f"[kernel] psum_or k={k} equal=True "
                + json.dumps(psum_rows[k]))
        mesh_sparse_rows = {}
        for k in MESH_KS:
            t0 = time.perf_counter()
            mesh_sparse_rows[k] = mesh_sparse_kernel_phase(
                torch, ell_ops, rt, m, ix, tables, eslot, hrows, k, (1,),
                mix_starts[mix_starts >= 0], rng)
            for label, v in mesh_sparse_rows[k]["go_runs"].items():
                log(f"[kernel] mesh_sparse_go k={k} {label} equal=True "
                    + json.dumps(v))
            for label, v in mesh_sparse_rows[k]["bfs_runs"].items():
                log(f"[kernel] mesh_sparse_bfs k={k} {label} equal=True "
                    + json.dumps(v))
            log(f"[kernel] mesh-sparse k={k} phase "
                f"{time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        hubless = hubless_ell(1 << 16, args.seed + 17)
        for k, lab, ixx in ((2, "hub-free", hubless),
                            (4, "hub-free", hubless), (4, "serve", ix)):
            log(f"[kernel] mesh stages {lab} k={k} equal=True "
                + json.dumps(mesh_stage_check(torch, ell_ops, ixx, k, (1,),
                                              rng, lab, tables.nbr.device)))
            log(f"[kernel] mesh lists {lab} k={k} equal=True "
                + json.dumps(mesh_list_check(torch, ell_ops, ixx, k, (1,),
                                             rng, lab, tables.nbr.device)))
        del hubless
        log(f"[kernel] mesh stage checks {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        emit_rows = emit_count_check(torch, ell_ops, rt, m, ix, tables, rng)
        log("[kernel] K6 emit at counts 0, 1, mid, c, past c equal=True "
            + json.dumps(emit_rows))
        mesh_sparse_rows[MESH_SPARSE_MAIN]["mesh_emit"]["at_counts"] = \
            emit_rows["mesh_emit"]
        sparse_rows["sparse_go"]["emit_at_counts"] = emit_rows["sparse_go"]
        log(f"[kernel] emit checks {time.perf_counter() - t0:.2f} s")

        # ---- 4. serve (continuous)
        serve = serve_phase(torch, rt, ell_ops, oracle, args.vertices,
                            args.requests, args.threads, args.seed)
        serve["extracts"] = serve_extract_rows(
            torch, ell_ops, ix, serve["extracts"], rng, tables.nbr.device)
        per_width[128]["lane_extract"]["serve"] = serve["extracts"]
        log("[serve] " + json.dumps(serve))

        # ---- 5. windowed
        windowed = windowed_phase(torch, rt, ell_ops, flags, oracle,
                                  args.vertices, args.requests,
                                  args.threads, args.seed)
        log("[windowed] " + json.dumps(windowed))
        log("[compare] continuous vs windowed, same mix: " + json.dumps({
            k: [serve[k], windowed[k]]
            for k in ("qps", "p50_ms", "p99_ms", "edges_traversed_per_s")}))

        # ---- 6. sparse (windowed at default flags)
        t0 = time.perf_counter()
        sparse = sparse_phase(torch, rt, ell_ops, flags, oracle,
                              args.vertices, args.requests, args.threads,
                              args.seed)
        log("[sparse] " + json.dumps(sparse))
        log(f"[sparse] phase {time.perf_counter() - t0:.2f} s")

        # ---- 7. adaptive (single queries, sparse route off)
        t0 = time.perf_counter()
        adaptive = adaptive_phase(torch, rt, ell_ops, flags, oracle,
                                  args.vertices, args.adaptive_requests,
                                  args.seed)
        log("[adaptive] " + json.dumps(adaptive))
        log(f"[adaptive] phase {time.perf_counter() - t0:.2f} s")

        # ---- 8. fused (GO ... WHERE ... YIELD on the fused route)
        t0 = time.perf_counter()
        fo = FusedOracle(oracle, src, dst, raw, args.vertices)
        fused = fused_phase(torch, rt, edge_ops, fo, blobs, args.vertices,
                            args.fused_requests, args.fused_threads,
                            args.seed)
        log("[fused] " + json.dumps(fused))
        log(f"[fused] phase {time.perf_counter() - t0:.2f} s")

        # ---- 9. path
        t0 = time.perf_counter()
        path = path_phase(torch, rt, ell_ops, PathOracle(oracle), m.vids,
                          args.path_requests, args.path_threads, args.seed)
        log("[path] " + json.dumps(path))
        log(f"[path] phase {time.perf_counter() - t0:.2f} s, "
            f"{path['served']} of {path['requests']} requests served")
        if args.profile:
            for k, v in profile_all(torch, rt, flags, m.vids, args,
                                    blobs).items():
                log(f"[profile] {k} " + json.dumps(v))

        # ---- 10. write (a store-backed space written while it is read)
        t0 = time.perf_counter()
        write = write_phase(torch, ell_ops, args.write_vertices,
                            args.write_edges, args.write_seconds,
                            WRITE_READERS, args.seed)
        log("[write] " + json.dumps(write))
        log(f"[write] phase {time.perf_counter() - t0:.2f} s")
        log("[compare] reader qps while writing vs [serve]: " + json.dumps(
            [write["reader_qps"], serve["qps"]]))

        # ---- 11. unpacked (tpu_packed_frontier=false on the serve graph)
        t0 = time.perf_counter()
        unpacked = unpacked_phase(
            torch, rt, ell_ops, flags, oracle, PathOracle(oracle), m.vids,
            args.vertices, args.unpacked_requests, args.threads,
            args.unpacked_path_requests, args.path_threads, args.seed)
        log("[unpacked] " + json.dumps(unpacked))
        log(f"[unpacked] phase {time.perf_counter() - t0:.2f} s")

        # ---- 12. mesh (tpu_mesh_mode=dense, 4 shards on this card)
        t0 = time.perf_counter()
        mesh = mesh_phase(
            torch, ell_ops, flags, m, rt.schemas[1], oracle,
            PathOracle(oracle), m.vids, args.vertices, args.mesh_requests,
            args.threads, args.mesh_path_requests, args.path_threads,
            args.seed)
        log("[mesh] " + json.dumps(mesh))
        log(f"[mesh] phase {time.perf_counter() - t0:.2f} s")

        # ---- 13. mesh-sparse (tpu_mesh_mode=sparse, 4 shards, this card)
        t0 = time.perf_counter()
        mesh_sparse = mesh_sparse_phase(
            torch, ell_ops, flags, m, rt.schemas[1], oracle,
            PathOracle(oracle), m.vids, args.vertices,
            args.mesh_requests, args.threads, args.mesh_path_requests,
            args.path_threads, args.seed)
        log("[mesh-sparse] " + json.dumps(mesh_sparse))
        log(f"[mesh-sparse] phase {time.perf_counter() - t0:.2f} s")

        # ---- 14. props (the dispatcher's host filter and YIELD groups)
        t0 = time.perf_counter()
        props = props_phase(
            torch, rt, ell_ops, edge_ops, flags,
            PropsOracle(oracle, src, dst, raw, args.vertices), blobs, src,
            dst, args.vertices, args.props_requests, args.seed, fused["qps"])
        log("[props] " + json.dumps(props))
        log("[compare] WHERE family qps, host filter (b) vs fused [fused]: "
            + json.dumps([props["b"]["qps"], fused["qps"]]))
        log(f"[props] phase {time.perf_counter() - t0:.2f} s")
    finally:
        rt.close()

    # ---- 15. kernels line: the serve rung's numbers (B=128, W=16),
    # with the W=128 (B=1024) numbers beside them, and for the sparse and
    # adaptive programs and their kernels the runs ROW_FROM names (the
    # programs: c0 256, 3 steps, an 8-query batch; adaptive K 2048, 3
    # steps); launches from the counted phases that run each kernel
    phases = {"serve": serve["launches"], "windowed": windowed["launches"],
              "sparse": sparse["launches"],
              "adaptive": adaptive["launches"], "fused": fused["launches"],
              "path": path["launches"], "write": write["launches"],
              "unpacked": unpacked["launches"], "mesh": mesh["launches"],
              "mesh_sparse": mesh_sparse["launches"],
              "props": props["launches"]}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    kernels = []
    for k in REPLACES:
        by_phase = {p: ln[k] for p, ln in phases.items()
                    if k in PATH_KERNELS[p]}
        row = dict(name=k, route="cuda", source=SOURCES[k],
                   replaces=REPLACES[k], launches=sum(by_phase.values()),
                   launches_by_phase=by_phase, equal=True)
        if k in MESH_SPARSE_KERNELS:
            v = mesh_sparse_rows[MESH_SPARSE_MAIN][k]
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
            row.update(shards=MESH_SPARSE_MAIN, shards_on_one_card=True)
            row["others"] = {f"k{kk}": {
                a: mesh_sparse_rows[kk][k][a]
                for a in ("ms", "plain_ms", "bound_ms", "library_ms")}
                for kk in mesh_sparse_rows if kk != MESH_SPARSE_MAIN}
            row["runtime_path"] = True
        elif k in MESH_KERNELS:
            v = mesh_rows[MESH_MAIN][k]
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
            row.update(width_lanes=MESH_MAIN[1], shards=MESH_MAIN[0],
                       shards_on_one_card=True)
            row["others"] = {f"k{kk}_b{bb}": {
                a: mesh_rows[kk, bb][k][a]
                for a in ("ms", "plain_ms", "bound_ms", "library_ms")}
                for kk, bb in mesh_rows if (kk, bb) != MESH_MAIN}
            row["runtime_path"] = k not in NO_RUNTIME_PATH
        elif k in EDGE_KERNELS:
            v = edge_rows[k]
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
            row["runtime_path"] = k not in NO_RUNTIME_PATH
        elif k in INT8_KERNELS:
            v = int8_rows[128][k]
            row["width_lanes"] = 128
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
            row["b1024"] = {a: b for a, b in int8_rows[1024][k].items()
                            if a != "bound_by"}
        elif k in absorb_rows:
            v = absorb_rows[k]
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
        elif k in per_width[128]:
            v = per_width[128][k]
            row["width_words"] = 16
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
            row["w128"] = {a: b for a, b in per_width[1024][k].items()
                           if a != "bound_by"}
        else:
            v = sparse_rows[k]
            row.update({a: v[a] for a in keys})
            row.update({a: b for a, b in v.items() if a not in keys})
        if k in OFF_PATH:
            row["runtime_path"] = False
        if k == "or_into":            # the mesh's psum_or over it
            row["psum_or"] = {f"k{kk}": v for kk, v in psum_rows.items()}
        if k == "pair_compact":       # K5 with the shard's row base
            row["mesh_base"] = {kk: {
                a: mesh_sparse_rows[kk][k][a]
                for a in ("ms", "plain_ms", "bound_ms", "calls",
                          "launches_a_call", "ms_by")}
                for kk in mesh_sparse_rows}
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
