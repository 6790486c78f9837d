"""Run ``chip_smoke.py``'s end-to-end phases [serve], [windowed],
[sparse], [adaptive], [fused], [path], [unpacked], [mesh],
[mesh-sparse] and [props] on one checkout of the port, so that two
checkouts can be held side by side in one run on one card.

    python3 nebula_tpu_torch/tools/phase_bench.py [--tree DIR]
                                                  [--phases LIST]
                                                  [--fused-requests N]
                                                  [--props-requests N]

Run it as a script.  The phases are the functions of this checkout's
``chip_smoke.py`` at its defaults: the serve graph
(``powerlaw_graph(2^19, 2^22, 2.2, 20000, 0)`` with the [fused]
columns), 4096 GO requests from 64 threads through the continuous
dispatcher and then the windowed one, the same mix on the sparse
route, 256 adaptive single-start requests, 512 ``GO 1-3 STEPS ... WHERE
P YIELD e._dst, e.w`` from 16 threads on the fused route (its 64 checked
answers against ``FusedOracle``), 512 FIND SHORTEST PATH
requests from 16 threads, the packing-off route ([unpacked]: 1024 GO
on the sparse route with its dense reruns, the same on the dense route
and a burst to the 1024 rung, then 128 FIND SHORTEST PATH and FIND ALL
PATH), and the dense mesh of 4 shards on the card
(1024 GO requests from 64 threads, then 128 FIND SHORTEST PATH from
16, then its write part), the same on the frontier-sharded mesh
(``tpu_mesh_mode=sparse``, [mesh-sparse]), and the dispatcher's host
half ([props]: 512 GO with WHERE and UPTO, WHERE under
``tpu_filter_mode=host``, YIELD props, meta-only LIMIT and COUNT(*),
then 192 over two edge types on a second space); each checks its answers
against the oracle and its launches as the smoke does.  The port comes
from ``--tree DIR``
(default: this file's checkout), for instance a parent commit unpacked
with ``git archive`` into a directory that ``.gitignore`` lists; DIR's
kernels build into DIR's own build directory.  [adaptive] runs only
on a checkout that counts its dense calls on the card
(``ell_ops.adaptive_dense_tally``).  ``--phases`` picks phases
(default all), in the smoke's order; ``--fused-requests`` and
``--props-requests`` size [fused]'s window and [props]'s (a)-(d)
window (default 512 each, the smoke's).  Prints the card's name and power
limit, then one JSON line: each phase's qps, p50 and p99 ms and wall
seconds ([mesh] and [mesh-sparse]: the GO part ``a`` and the path part
``b`` apart; [unpacked]: its parts ``a``, ``b`` and ``c``; [props]: its
parts ``a``-``e``, or a note on a checkout without the host filter,
which declines those shapes).  A checkout
whose int8 BFS level pass keeps no lane bitmaps (before ``seen``) is
held to the [unpacked] launches of its own path: K14 and
``bfs_depth_i8``, and no K1.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

PHASES = ("serve", "windowed", "sparse", "adaptive", "fused", "path",
          "unpacked", "mesh", "mesh_sparse", "props")
REQUESTS, THREADS, SEED = 4096, 64, 0          # chip_smoke.py's defaults
ADAPTIVE_REQUESTS = 256
FUSED_REQUESTS, FUSED_THREADS = 512, 16
PATH_REQUESTS, PATH_THREADS = 512, 16
MESH_REQUESTS, MESH_PATH_REQUESTS = 1024, 128
PROPS_REQUESTS = 512
UNPACKED_REQUESTS, UNPACKED_PATH_REQUESTS = 1024, 128
# the [unpacked] path's kernels on a checkout before the int8 route's
# lane bitmaps
UNPACKED_BEFORE_BITMAPS = ("frontier_upload_i8", "go_hop_i8", "pack_rows",
                           "bfs_level_i8", "bfs_depth_i8", "ell_go_i8",
                           "ell_bfs_i8")
VERTICES, EDGES = 1 << 19, 1 << 22


def main(argv=None) -> int:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=here)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="phases to run: " + ", ".join(PHASES))
    ap.add_argument("--fused-requests", type=int, default=FUSED_REQUESTS)
    ap.add_argument("--props-requests", type=int, default=PROPS_REQUESTS)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"--phases: unknown {sorted(set(phases) - set(PHASES))}")
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("phase_bench: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(here, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from nebula_tpu_torch.common.flags import flags
    from nebula_tpu_torch.meta.schema import SchemaView
    from nebula_tpu_torch.tpu import _build, edge_ops, ell_ops
    from nebula_tpu_torch.tpu.csr import mirror_from_edges
    from nebula_tpu_torch.tpu.runtime import TorchQueryRuntime
    from nebula_tpu_torch.tools.graphgen import powerlaw_graph

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load()
    res = dict(tree=os.path.abspath(args.tree), card=smi,
               build_s=time.perf_counter() - t0)
    src, dst = powerlaw_graph(VERTICES, EDGES, 2.2, 20000, SEED)
    edge_props, vertex_props, raw = smoke.fused_columns(src, dst, VERTICES,
                                                        SEED)
    m = mirror_from_edges(src, dst, 1, space_id=1, edge_props=edge_props,
                          vertex_props=vertex_props)
    rt = TorchQueryRuntime()
    try:
        rt.load_space(1, m, SchemaView().add_space(
            1, {"person": smoke.FUSED_TAG}, {"e": 1}))
        rt._device_tables(m, rt.ell(m))
        oracle = smoke.GoOracle(src, dst)
        runs = {
            "serve": lambda: smoke.serve_phase(
                torch, rt, ell_ops, oracle, VERTICES, REQUESTS, THREADS,
                SEED),
            "windowed": lambda: smoke.windowed_phase(
                torch, rt, ell_ops, flags, oracle, VERTICES, REQUESTS,
                THREADS, SEED),
            "sparse": lambda: smoke.sparse_phase(
                torch, rt, ell_ops, flags, oracle, VERTICES, REQUESTS,
                THREADS, SEED),
            "adaptive": lambda: smoke.adaptive_phase(
                torch, rt, ell_ops, flags, oracle, VERTICES,
                ADAPTIVE_REQUESTS, SEED),
            "fused": lambda: smoke.fused_phase(
                torch, rt, edge_ops, smoke.FusedOracle(oracle, src, dst, raw,
                                                       VERTICES),
                smoke.fused_request_blobs(smoke.fused_predicates(VERTICES)),
                VERTICES, args.fused_requests, FUSED_THREADS, SEED),
            "path": lambda: smoke.path_phase(
                torch, rt, ell_ops, smoke.PathOracle(oracle), m.vids,
                PATH_REQUESTS, PATH_THREADS, SEED),
            "unpacked": lambda: smoke.unpacked_phase(
                torch, rt, ell_ops, flags, oracle, smoke.PathOracle(oracle),
                m.vids, VERTICES, UNPACKED_REQUESTS, THREADS,
                UNPACKED_PATH_REQUESTS, PATH_THREADS, SEED),
            "mesh": lambda: smoke.mesh_phase(
                torch, ell_ops, flags, m, rt.schemas[1], oracle,
                smoke.PathOracle(oracle), m.vids, VERTICES, MESH_REQUESTS,
                THREADS, MESH_PATH_REQUESTS, PATH_THREADS, SEED),
            "mesh_sparse": lambda: smoke.mesh_sparse_phase(
                torch, ell_ops, flags, m, rt.schemas[1], oracle,
                smoke.PathOracle(oracle), m.vids, VERTICES, MESH_REQUESTS,
                THREADS, MESH_PATH_REQUESTS, PATH_THREADS, SEED),
            "props": lambda: smoke.props_phase(
                torch, rt, ell_ops, edge_ops, flags,
                smoke.PropsOracle(oracle, src, dst, raw, VERTICES),
                smoke.fused_request_blobs(smoke.fused_predicates(VERTICES)),
                src, dst, VERTICES, args.props_requests, SEED, None)}
        if "seen" not in inspect.signature(
                ell_ops.bfs_level_i8).parameters:
            smoke.PATH_KERNELS["unpacked"] = UNPACKED_BEFORE_BITMAPS
        for name in PHASES:
            if name not in phases or (
                    name == "adaptive"
                    and not hasattr(ell_ops, "adaptive_dense_tally")):
                continue
            if name == "props" and not hasattr(rt, "_host_filter"):
                res[name] = "not served by this checkout"
                continue
            t0 = time.perf_counter()
            out = runs[name]()
            keep = ("qps", "p50_ms", "p99_ms")
            res[name] = {k: out[k] for k in keep if k in out}
            if name in ("mesh", "mesh_sparse", "unpacked", "props"):
                per = keep + (("t_assemble_s_per_request",)
                              if name == "props" else ())
                res[name] = {part: {k: out[part][k] for k in per
                                    if k in out[part]}
                             for part in ("a", "b", "c", "d", "e")
                             if "qps" in out.get(part, {})}
            res[name]["phase_s"] = time.perf_counter() - t0
            if name == "adaptive":
                res[name]["dense_requests"] = out["dense_requests"]
                res[name]["dense_requests_predicted"] = \
                    out["dense_requests_predicted"]
            if name == "path":
                res[name]["served"] = out["served"]
    finally:
        rt.close()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
