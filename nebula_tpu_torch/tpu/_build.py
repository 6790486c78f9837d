"""Build and load the port's CUDA kernels.

``load()`` compiles ``csrc/ell_lanes.cu`` with nvcc into
``_build_out/libell_lanes.so`` beside this file (a directory git
ignores) at first use, rebuilding when the source is newer than the
library, and loads it with ctypes.  The source has a plain C interface
and includes no PyTorch header, so a build takes seconds.  A failed
build raises with nvcc's stderr; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "csrc")
OUT_DIR = os.path.join(HERE, "_build_out")
SOURCES = (os.path.join(CSRC, "ell_lanes.cu"),)
LIB_PATH = os.path.join(OUT_DIR, "libell_lanes.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


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
    return any(os.path.getmtime(s) > built for s in SOURCES)


def build(force: bool = False) -> str:
    """Compile the sources into LIB_PATH when missing or stale; returns
    the library path.  The library is written under a temporary name
    and renamed, so a concurrent reader never loads half a file."""
    if not force and not _stale():
        return LIB_PATH
    nvcc = find_nvcc()
    os.makedirs(OUT_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *SOURCES]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): "
                           f"{' '.join(cmd)}\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
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
        lib.ell_go_hop.argtypes = [
            vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int64), i32,
            vp, vp, i64, ctypes.POINTER(ctypes.c_int32), i32, i64, i64,
            i64, vp]
        lib.ell_lane_join.argtypes = [vp, vp, vp, vp, vp, i64, i64, i64,
                                      vp]
        lib.ell_lane_extract.argtypes = [vp, vp, vp, vp, vp, i64, i64,
                                         i64, vp]
        lib.ell_lane_clear.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.ell_frontier_upload.argtypes = [vp, vp, vp, vp, i64, i64, i64,
                                            vp]
        lib.ell_go_count.argtypes = [vp, vp, vp, i64, i64, vp]
        lib.ell_bfs_level.argtypes = [vp, vp, vp, vp, i32, i32, i32, i64,
                                      i64, vp]
        lib.ell_bfs_depth_i8.argtypes = [vp, vp, i64, vp]
        for fn in (lib.ell_go_hop, lib.ell_lane_join,
                   lib.ell_lane_extract, lib.ell_lane_clear,
                   lib.ell_frontier_upload, lib.ell_go_count,
                   lib.ell_bfs_level, lib.ell_bfs_depth_i8):
            fn.restype = ctypes.c_int
        _lib = lib
        return lib
