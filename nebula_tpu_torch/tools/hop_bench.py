"""Time the packed hop (``ell_ops.go_hop``), ``ell_go``, ``or_into``,
the adaptive program (``ell_ops.adaptive_go``), the int8 hop K13
(``go_hop_i8``) with its programs ``ell_go_i8`` and ``ell_bfs_i8``, and
the replicated-frontier mesh's M1 (``shard_hop``), row replication
(M3), hop and programs (``ell_go_sharded``, ``ell_bfs_sharded``) of one
checkout of the port on one card, so that two checkouts can be held
side by side in one run.

    python3 nebula_tpu_torch/tools/hop_bench.py [--tree DIR]

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
by events only: the program reads its mode word on the host each
sparse hop, so its calls cannot queue behind a spin; the median of
ROUNDS measurements.
K13 at B = 128 and 1024 on the start frontier (one start a lane,
uploaded by K12: B live rows) and on a dense one (every byte of every
real row random int8, negative ones included), exact and with the UPTO
accumulator, held equal to ``go_hop_i8_ref``, device and event times
of one call as a program's first hop makes it (no live array passed:
the row-live pass is part of the call where the checkout has one);
``ell_go_i8`` at 3 steps, exact and UPTO, row-packed, from the start
frontier, the same two ways; ``ell_bfs_i8`` (UPTO 5, stop when found,
random targets) by events.  The mesh at k = 4 shards on this card and
W = 16 / 128: M1 on each shard (the mean), the replication of the
hop's owned rows (``mesh.replicate_rows``), one whole ``mesh_hop`` and
``ell_go_sharded`` at 3 steps, device and event times, each held equal
to the single-card functions; ``ell_bfs_sharded`` (UPTO 5) by events.
A checkout from before M3 (``ell_ops.copy_rows``) replicates by
``copy_``; both forms are called as that checkout defines them.
Prints the card's name and power limit, then one JSON line.  Needs a
CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

try:        # run as a script, this file's directory is sys.path[0]: the
    # timing helpers of this checkout, whichever tree the port comes from
    from cardtime import cuda_ms, queued_ms
except ImportError:        # imported as a module of the package
    from nebula_tpu_torch.tools.cardtime import cuda_ms, queued_ms

VERTICES, EDGES, SEED = 1 << 19, 1 << 22, 0    # chip_smoke.py's defaults
QUEUED = 8                     # calls queued behind the spin
BACK_TO_BACK = 50              # calls timed back to back
ADAPTIVE_CALLS = 20            # adaptive_go calls in one measurement
ROUNDS = 5                     # adaptive_go measurements (the median)
MESH_K = 4                     # the mesh's shards, all on this card
PROGRAM_CALLS = 10             # back-to-back calls of a timed program
BFS_CALLS = 3                  # back-to-back calls of a timed BFS


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


def mesh_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng, dev):
    """M1, the row replication, ``mesh_hop``, ``ell_go_sharded`` and
    ``ell_bfs_sharded`` at k = MESH_K on this card, W = 16 and 128."""
    import inspect

    import numpy as np
    from nebula_tpu_torch.tpu.ell import mesh_tables
    from nebula_tpu_torch.tpu.mesh import PartsMesh, replicate_rows
    k = MESH_K
    mt = mesh_tables(ix, PartsMesh([dev] * k))
    blocks = [mt.owned(s) for s in range(k)]
    es, hs = [eslot] * k, [hrows] * k
    m3 = hasattr(ell_ops, "copy_rows")
    extra = (ell_ops.copy_rows,) if m3 else ()
    if len(inspect.signature(ell_ops.mesh_hop).parameters) != 9 + len(extra):
        raise AssertionError("mesh_hop's form is not known here")

    def replicate(bufs):
        return replicate_rows(bufs, blocks, *extra)
    R1 = ix.n_rows + 1
    res = dict(mesh_k=k, m3=m3)
    for W in (16, 128):
        fp_h = np.zeros((R1, W), np.uint8)
        live = rng.random(ix.n) < 0.02
        fp_h[:ix.n][live] = rng.integers(0, 256, (int(live.sum()), W),
                                         dtype=np.uint8)
        fp0 = torch.from_numpy(fp_h).to(dev)
        outs = [torch.empty_like(fp0) for _ in range(k)]
        per_ms, per_ev = [], []
        for s in range(k):
            a, b = torch.full_like(fp0, 0xA5), torch.full_like(fp0, 0xA5)
            ell_ops.shard_hop(fp0, a, mt, s, over)
            ell_ops.shard_hop_ref(fp0, b, mt, s, over)
            _equal(torch, f"shard_hop W={W} s={s}", (a, b))

            def m1(s=s):
                ell_ops.shard_hop(fp0, outs[s], mt, s, over)
            per_ms.append(queued_ms(torch, m1, QUEUED))
            per_ev.append(cuda_ms(torch, m1, BACK_TO_BACK))
        res[f"shard_hop_w{W}"] = dict(ms=float(np.mean(per_ms)),
                                      event_ms=float(np.mean(per_ev)),
                                      per_shard_ms=per_ms)
        nbytes = replicate(outs)
        res[f"replicate_rows_w{W}"] = dict(
            ms=queued_ms(torch, lambda: replicate(outs), QUEUED),
            event_ms=cuda_ms(torch, lambda: replicate(outs), BACK_TO_BACK),
            bytes=nbytes)
        cur = [fp0.clone() for _ in range(k)]
        hop = (ell_ops.shard_hop, ell_ops.hop_merge) + extra

        def mesh_hop():
            ell_ops.mesh_hop(cur, outs, mt, es, hs, over, blocks, *hop)
        mesh_hop()
        single = torch.empty_like(fp0)
        ell_ops.go_hop(fp0, None, single, tables, eslot, hrows, over)
        _equal(torch, f"mesh_hop W={W}", *[(o, single) for o in outs])
        res[f"mesh_hop_w{W}"] = dict(
            ms=queued_ms(torch, mesh_hop, QUEUED),
            event_ms=cuda_ms(torch, mesh_hop, BACK_TO_BACK))

        def go():
            ell_ops.ell_go_sharded(fp0, mt, es, hs, over, 3)
        _equal(torch, f"ell_go_sharded W={W}",
               (ell_ops.ell_go_sharded(fp0, mt, es, hs, over, 3)[0],
                ell_ops.ell_go(fp0.clone(), tables, eslot, hrows, over, 3)))
        res[f"ell_go_sharded_w{W}"] = dict(
            ms=queued_ms(torch, go, QUEUED),
            event_ms=cuda_ms(torch, go, PROGRAM_CALLS))
        t0 = fp0.roll(1, dims=0).contiguous()
        res[f"ell_bfs_sharded_w{W}"] = dict(event_ms=cuda_ms(
            torch, lambda: ell_ops.ell_bfs_sharded(fp0, t0, mt, es, hs, over,
                                                   5), BFS_CALLS, 1))
        del outs, cur
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tree", default=here)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("hop_bench: no CUDA device", file=sys.stderr)
        return 2
    from nebula_tpu_torch.tpu import _build, ell_ops
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
    m = mirror_from_edges(src, dst, 1, space_id=1)
    ix = TorchQueryRuntime.ell(m)
    tables = ix.device_tables(dev)
    eslot, hrows = (torch.from_numpy(a.astype(np.int32)).to(dev)
                    for a in ix.hub_merge())
    rng = np.random.default_rng(SEED + 7)
    R1, over = ix.n_rows + 1, (1,)
    res = dict(tree=os.path.abspath(args.tree), card=smi, build_s=build_s,
               n_rows=ix.n_rows, slots=int(tables.nbr.numel()),
               buckets=list(tables.D))
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

    # adaptive_go: the first vertex with 16 to 128 out-edges over OVER
    is_over = m.edge_etype == over[0]
    deg = np.bincount(m.edge_src[is_over], minlength=m.n)[:m.n]
    first = int(np.nonzero((deg > 16) & (deg <= 128))[0][0])
    start = torch.from_numpy(
        ix.perm[np.asarray([first])].astype(np.int32)).to(dev)
    hub = torch.from_numpy(ix.hub_table().astype(np.uint8)).to(dev)
    for K in (2048, 8):
        def adaptive():
            ell_ops.adaptive_go(start, hub, tables, eslot, hrows, over, 3,
                                K)
        lanes = ell_ops.LAUNCHES["bitmap_lanes"]
        adaptive()
        dense = ell_ops.LAUNCHES["bitmap_lanes"] > lanes
        if dense != (K == 8):
            raise AssertionError(f"adaptive_go K={K}: dense arm ran "
                                 f"{dense}")
        times = [cuda_ms(torch, adaptive, ADAPTIVE_CALLS)
                 for _ in range(ROUNDS)]
        res[f"adaptive_K{K}_s3"] = dict(event_ms=float(np.median(times)),
                                        rounds=times, dense_arm=dense)
    res.update(int8_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng,
                         dev))
    res.update(mesh_rows(torch, ell_ops, ix, tables, eslot, hrows, over, rng,
                         dev))
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
