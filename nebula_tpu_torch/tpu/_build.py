"""Build and load the port's CUDA kernels.

``load()`` compiles ``csrc/ell_lanes.cu``, ``csrc/sparse_go.cu``,
``csrc/edge_go.cu``, ``csrc/expr_filter.cu``, ``csrc/ell_absorb.cu``,
``csrc/ell_int8.cu``, ``csrc/ell_mesh.cu`` and ``csrc/mesh_sparse.cu``
with nvcc into
``_build_out/libell_lanes.so`` beside this file (a
directory git ignores) at first use, rebuilding when a source is newer
than the library (or a header they share: ``csrc/hop_plan.cuh``, the
hops' plan, and ``csrc/expr_core.cuh``, the WHERE interpreter), and
loads it with ctypes.  Each source compiles to an
object in its own nvcc process, all started together, and one more
nvcc call links them; ``LAST_BUILD`` keeps each step's seconds.  The
sources have a plain C interface and include no PyTorch header, so a
build takes seconds.  A failed build raises with nvcc's stderr;
nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
OUT_DIR = os.path.join(HERE, "_build_out")
SOURCES = (os.path.join(CSRC, "ell_lanes.cu"),
           os.path.join(CSRC, "sparse_go.cu"),
           os.path.join(CSRC, "edge_go.cu"),
           os.path.join(CSRC, "expr_filter.cu"),
           os.path.join(CSRC, "ell_absorb.cu"),
           os.path.join(CSRC, "ell_int8.cu"),
           os.path.join(CSRC, "ell_mesh.cu"),
           os.path.join(CSRC, "mesh_sparse.cu"))
# included by ell_lanes.cu, ell_int8.cu and ell_mesh.cu (the hop's
# plan), by expr_filter.cu and edge_go.cu (the WHERE interpreter) and by
# ell_lanes.cu, sparse_go.cu, edge_go.cu, mesh_sparse.cu and ell_int8.cu
# (the SM count)
HEADERS = (os.path.join(CSRC, "hop_plan.cuh"),
           os.path.join(CSRC, "expr_core.cuh"),
           os.path.join(CSRC, "sm_count.cuh"))
LIB_PATH = os.path.join(OUT_DIR, "libell_lanes.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# seconds of the last build's steps: each source's compile (they run
# together) and the link
LAST_BUILD: Dict[str, float] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(os.path.join(home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, "
                           "PATH): the port's kernels cannot be built")
    return found


def _stale() -> bool:
    if not os.path.isfile(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(s) > built for s in SOURCES + HEADERS)


def _run_all(cmds) -> list:
    """Run the nvcc commands concurrently; returns each one's seconds,
    or raises with the stderr of the first that failed, after every one
    has ended."""
    def one(cmd):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        return r, time.perf_counter() - t0
    with ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(one, cmds))
    for cmd, (r, _s) in zip(cmds, done):
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}): "
                               f"{' '.join(cmd)}\n{r.stderr}")
    return [s for _r, s in done]


def build(force: bool = False) -> str:
    """Compile the sources into LIB_PATH when missing or stale; returns
    the library path.  Every source compiles to an object in parallel,
    then one call links them.  The library is written under a
    temporary name and renamed, so a concurrent reader never loads half
    a file."""
    if not force and not _stale():
        return LIB_PATH
    nvcc = find_nvcc()
    os.makedirs(OUT_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    tmp = f"{LIB_PATH}.{tag}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [os.path.join(OUT_DIR, os.path.basename(src) + f".{tag}.o")
            for src in SOURCES]
    try:
        secs = _run_all([[nvcc, *compile_flags, "-c", "-o", obj, src]
                         for src, obj in zip(SOURCES, objs)])
        link = _run_all([[nvcc, *NVCC_FLAGS, "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)
    LAST_BUILD.clear()
    LAST_BUILD.update({os.path.basename(src): t
                       for src, t in zip(SOURCES, secs)})
    LAST_BUILD["link"] = link[0]
    return LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point's
    argtypes and restype declared (pointers and the stream as c_void_p
    so ctypes never truncates them)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        p64, p32 = ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(
            ctypes.c_int32)
        lib.ell_go_hop.argtypes = [
            vp, vp, vp, vp, vp, p64, i32, i64, i32, i32, vp, vp, i64, p32,
            i32, i64, i64, i64, vp, i64, vp]
        lib.ell_or_many.argtypes = [vp, ctypes.POINTER(vp), i32, i64, vp]
        lib.ell_lane_join.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64,
                                      vp]
        lib.ell_lane_extract.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                         i64, vp]
        lib.ell_lane_clear.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.ell_frontier_upload.argtypes = [vp, vp, vp, i64, i64, i64, vp]
        lib.ell_go_count.argtypes = [vp, vp, vp, vp, i64, i64, i64, vp]
        lib.ell_bfs_level.argtypes = [vp, vp, vp, vp, i32, vp, i32, i32,
                                      i32, i64, i64, vp]
        lib.ell_bfs_depth_i8.argtypes = [vp, vp, i64, vp]
        # csrc/sparse_go.cu
        lib.sg_expand.argtypes = [vp, vp, i64, vp, vp, vp, vp, vp, p64,
                                  i32, p32, i32, i64, i64, i64, vp, vp, i64,
                                  i32, vp, i64, vp]
        lib.sg_compact_state.argtypes = [i64]
        lib.sg_compact_state.restype = i64
        lib.sg_compact.argtypes = [vp, i64, i64, i64, vp, vp, vp, vp, i64,
                                   vp, vp, i32, i64, i64, vp, i64, vp]
        lib.sg_reduce.argtypes = [i32, vp, vp, i64, vp, vp, i32, i64, i64,
                                  i64, i64, i64, i64, vp, vp, vp]
        lib.ad_switch.argtypes = [vp, i64, vp, i64, i64, vp, vp, vp]
        lib.ad_bitmap_lanes.argtypes = [i32, vp, vp, i64, vp]
        # the whole programs, one call each (the tables by value)
        from .ell_ops import _SparseTables
        lib.sg_program.argtypes = [_SparseTables, vp, vp, i64, vp, p64, i32,
                                   vp, vp, i64, vp, p32]
        lib.ad_program.argtypes = [_SparseTables, vp, i64, vp, p64, p64, i64,
                                   i32, p32, i32, vp, vp, vp, vp, vp, p32]
        # csrc/edge_go.cu and csrc/expr_filter.cu (the slot table
        # travels by value, as edge_ops._Slots)
        from .edge_ops import _Slots
        lib.edge_seed.argtypes = [vp, vp, i64, i64, vp]
        lib.edge_hop.argtypes = [vp, vp, i64, vp, vp, vp, vp, i64, p32,
                                 i32, vp]
        lib.edge_scan_hop.argtypes = [vp, vp, vp, vp, vp, i64, i64, p32,
                                      i32, vp]
        lib.edge_final.argtypes = [vp, vp, vp, vp, vp, i64, p32, i32, vp]
        lib.edge_bfs_level.argtypes = [vp, vp, vp, vp, i32, i32, i32, i64,
                                       vp]
        lib.expr_filter.argtypes = [vp, i32, i32, i32, _Slots, vp, vp, i64,
                                    vp, vp]
        lib.edge_final_where.argtypes = [vp, vp, vp, vp, p32, i32, vp, i32,
                                         i32, i32, _Slots, i64, vp, vp]
        # csrc/ell_absorb.cu (the bucket table by value)
        from .ell_ops import _AbsorbBuckets
        lib.ell_absorb.argtypes = [vp, vp, vp, vp, i64, _AbsorbBuckets, vp]
        # csrc/ell_int8.cu
        lib.i8_frontier_upload.argtypes = [vp, vp, vp, i64, i64, i64, i64,
                                           vp]
        lib.i8_row_live.argtypes = [vp, vp, i64, i64, vp]
        lib.i8_go_hop.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, p64, i32,
                                  i64, i32, i32, i32, vp, vp, i64, p32, i32,
                                  i64, i64, i64, vp]
        lib.i8_pack_rows.argtypes = [vp, vp, i64, i64, vp]
        lib.i8_bfs_level.argtypes = [vp, vp, vp, vp, i32, vp, vp, i32, i32,
                                     i32, i64, i64, vp]
        lib.ell_table_copy.argtypes = [vp, vp, vp, vp, i64, vp]
        # the mesh: csrc/ell_mesh.cu (tables by value) and the lane
        # kernels it reuses from csrc/ell_lanes.cu
        from .ell_ops import _MeshCard, _MeshHop, _ShardAbsorb
        lib.ell_mesh_hop.argtypes = [i32, vp, vp, i64, _MeshHop, p64, i32,
                                     i64, i32, i32, p32, i32, vp, vp, i64,
                                     i64, i64, vp, vp, vp, i32, vp, i32,
                                     i32, i32, vp, p32]
        lib.ell_shard_absorb.argtypes = [vp, vp, vp, vp, i64, _ShardAbsorb,
                                         vp]
        # the frontier-sharded mesh: csrc/mesh_sparse.cu (X1-X3, the
        # agreement) and K6's emit over a card (csrc/sparse_go.cu)
        lib.mesh_route.argtypes = [i32, _MeshCard, vp, vp, i64, i32, vp,
                                   i64, p64, i32, p32, i32, i64, i64, vp, vp,
                                   i64, vp, i64, vp]
        lib.mesh_dedup.argtypes = [_MeshCard, vp, i64, i64, vp, i64, i64,
                                   i64, vp, vp, i64, vp, vp, i64,
                                   ctypes.POINTER(vp), p64, p32, vp]
        lib.mesh_agree.argtypes = [vp, i32, vp]
        lib.sg_emit.argtypes = [vp, vp, i64, vp, i32, i64, i64, vp, vp]
        lib.mesh_bfs_stamp.argtypes = [i32, _MeshCard, vp, vp, i64, i32,
                                       vp, vp, i64, vp, i64, i64, vp, i64,
                                       i64, i64, i64, vp, vp, vp]
        for fn in (lib.ell_go_hop, lib.ell_lane_join,
                   lib.ell_lane_extract, lib.ell_lane_clear,
                   lib.ell_frontier_upload, lib.ell_go_count,
                   lib.ell_bfs_level, lib.ell_bfs_depth_i8, lib.sg_expand,
                   lib.sg_compact, lib.sg_reduce, lib.ad_switch,
                   lib.ad_bitmap_lanes, lib.sg_program, lib.ad_program,
                   lib.edge_seed, lib.edge_hop, lib.edge_final,
                   lib.edge_final_where, lib.edge_bfs_level,
                   lib.expr_filter,
                   lib.ell_absorb, lib.i8_frontier_upload,
                   lib.i8_row_live, lib.i8_go_hop, lib.i8_pack_rows,
                   lib.i8_bfs_level, lib.ell_table_copy, lib.ell_mesh_hop,
                   lib.ell_shard_absorb, lib.ell_or_many, lib.mesh_route,
                   lib.mesh_dedup, lib.mesh_agree, lib.sg_emit,
                   lib.mesh_bfs_stamp):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
