"""The port's kernel registry: the counterpart of the reference's
``nebula_tpu/tpu/kernels.py`` ``KERNEL_REGISTRY``, as a plain dict.

Keyed by the reference's 22 ``KernelSpec`` family names, plus the
unregistered device helpers under their reference names
(``_upload_frontier``, ``_upload_frontier_packed``,
``make_batched_go_kernel``, ``make_batched_bfs_kernel``).  Each entry
holds the port's plain PyTorch function (run on CPU tensors and held
against the JAX function in the tests), its hand-kernel function (the
wrapper that launches the CUDA kernel on a card tensor), and the
``csrc`` sources that kernel is built from; every family has all
three.  The replicated-frontier mesh families run their shards'
kernels from ``csrc/ell_mesh.cu`` and reuse the single-card ones; the
frontier-sharded ones (``mesh_sparse_go``, ``mesh_sparse_bfs``) run
X1-X3 from ``csrc/mesh_sparse.cu`` with K5 / K6 from
``csrc/sparse_go.cu`` and ``or_many`` from ``csrc/ell_lanes.cu``.
``sparse_go_count`` and
``sparse_go_limit`` are ``sparse_go`` with ``count=True`` and
``limit=n``, as in the reference, where one factory makes all three;
each program runs on the card as one C call (``sg_program``), as does
``adaptive_go`` (``ad_program``, whose dense arm is ``ell_lanes.cu``'s
hop).  ``go_filtered`` evaluates the WHERE inside its final pass
(``edge_go.cu`` with the interpreter of ``expr_core.cuh``); the
``expr_filter`` entry, the same interpreter over every edge, serves the
registry alone.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

from . import edge_ops, ell_ops


class PortKernel(NamedTuple):
    plain: Optional[Callable]
    hand: Optional[Callable]
    csrc: Optional[Tuple[str, ...]]


_LANES = ("ell_lanes.cu",)
_SPARSE = ("sparse_go.cu",)
_EDGE = ("edge_go.cu",)
_INT8 = ("ell_int8.cu",)
_MESH = ("ell_mesh.cu",)
_MESH_SPARSE = ("mesh_sparse.cu",) + _SPARSE
# the WHERE interpreter, which go_filtered's final pass (edge_go.cu) and
# expr_filter.cu both include
_EXPR = ("expr_core.cuh",)

KERNELS: Dict[str, PortKernel] = {
    # continuous session (ell.py:665-743)
    "ell_go_hop": PortKernel(ell_ops.go_hop_ref, ell_ops.go_hop, _LANES),
    "ell_lane_join": PortKernel(ell_ops.lane_join_ref, ell_ops.lane_join,
                                _LANES),
    "ell_lane_extract": PortKernel(ell_ops.lane_extract_ref,
                                   ell_ops.lane_extract, _LANES),
    "ell_lane_clear": PortKernel(ell_ops.lane_clear_ref,
                                 ell_ops.lane_clear, _LANES),
    # packed windowed dense route (ell.py:572, :1080)
    "ell_go": PortKernel(ell_ops.ell_go_ref, ell_ops.ell_go, _LANES),
    "ell_go_count": PortKernel(ell_ops.ell_go_count_ref,
                               ell_ops.ell_go_count, _LANES),
    "ell_bfs": PortKernel(ell_ops.ell_bfs_ref, ell_ops.ell_bfs, _LANES),
    # sparse pair-list and adaptive routes (ell.py:1222, :1493)
    "sparse_go": PortKernel(ell_ops.sparse_go_ref, ell_ops.sparse_go,
                            _SPARSE),
    "sparse_go_count": PortKernel(ell_ops.sparse_go_ref, ell_ops.sparse_go,
                                  _SPARSE),
    "sparse_go_limit": PortKernel(ell_ops.sparse_go_ref, ell_ops.sparse_go,
                                  _SPARSE),
    "adaptive_go": PortKernel(ell_ops.adaptive_go_ref, ell_ops.adaptive_go,
                              _SPARSE + _LANES),
    # edge-list programs and the WHERE (kernels.py:284-315,
    # expr_compile.py:512)
    "go": PortKernel(edge_ops.go_ref, edge_ops.go, _EDGE),
    "go_filtered": PortKernel(edge_ops.go_filtered_ref,
                              edge_ops.go_filtered, _EDGE + _EXPR),
    "bfs": PortKernel(edge_ops.bfs_ref, edge_ops.bfs, _EDGE),
    "expr_filter": PortKernel(edge_ops.expr_filter_ref,
                              edge_ops.expr_filter,
                              ("expr_filter.cu",) + _EXPR),
    # the write path (ell.py:1011)
    "ell_absorb": PortKernel(ell_ops.ell_absorb_ref, ell_ops.ell_absorb,
                             ("ell_absorb.cu",)),
    # the replicated-frontier mesh (kernels.py:364; ell.py:1712, :1799,
    # :1036): edge-sharded GO over the edge kernels and or_many, and the
    # row-sharded programs over mesh_hop (M1, M3 and the merge, one call
    # a card) and M2
    "sharded_go": PortKernel(edge_ops.sharded_go_ref, edge_ops.sharded_go,
                             _EDGE + _LANES),
    "ell_go_sharded": PortKernel(ell_ops.ell_go_sharded_ref,
                                 ell_ops.ell_go_sharded, _MESH + _LANES),
    "ell_bfs_sharded": PortKernel(ell_ops.ell_bfs_sharded_ref,
                                  ell_ops.ell_bfs_sharded, _MESH + _LANES),
    "ell_absorb_sharded": PortKernel(ell_ops.ell_absorb_sharded_ref,
                                     ell_ops.ell_absorb_sharded,
                                     _MESH),
    # the frontier-sharded mesh (ell.py:2052, :2179): X1-X3 with K5 (and
    # for GO K6 and the agreed overflow), each stage one call a card
    "mesh_sparse_go": PortKernel(ell_ops.mesh_sparse_go_ref,
                                 ell_ops.mesh_sparse_go,
                                 _MESH_SPARSE + _LANES),
    "mesh_sparse_bfs": PortKernel(ell_ops.mesh_sparse_bfs_ref,
                                  ell_ops.mesh_sparse_bfs, _MESH_SPARSE),
    # unregistered runtime helpers (runtime.py:3228, :3251) and the
    # packing-off programs (ell.py:1140, :1616)
    "_upload_frontier": PortKernel(ell_ops.frontier_upload_i8_ref,
                                   ell_ops.frontier_upload_i8, _INT8),
    "_upload_frontier_packed": PortKernel(ell_ops.frontier_upload_ref,
                                          ell_ops.frontier_upload, _LANES),
    "make_batched_go_kernel": PortKernel(ell_ops.ell_go_i8_ref,
                                         ell_ops.ell_go_i8, _INT8),
    "make_batched_bfs_kernel": PortKernel(ell_ops.ell_bfs_i8_ref,
                                          ell_ops.ell_bfs_i8,
                                          _INT8 + _LANES),
}
