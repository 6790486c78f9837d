"""nebula_tpu_torch: the PyTorch/CUDA port of nebula-tpu's device path.

A second package beside ``nebula_tpu`` (the JAX reference, which stays
as it is).  It serves continuous-dispatch multi-hop ``GO`` from a
device-resident, degree-bucketed ELL mirror of the edge store on an
NVIDIA Hopper card.  Each of the four per-tick device programs of the
reference's continuous session (``ell_lane_join``, ``ell_go_hop``,
``ell_lane_extract``, ``ell_lane_clear``) is a hand-written CUDA kernel
for ``sm_90a`` (``tpu/csrc/ell_lanes.cu``), with a plain PyTorch version
beside each wrapper (``tpu/ell_ops.py``).

Module names follow the reference so a reader finds each counterpart:
``tpu/csr.py`` <-> ``nebula_tpu/tpu/csr.py`` and so on.  The package
imports ``torch`` and numpy, never ``jax`` and nothing of
``nebula_tpu``; importing it has no side effects (no thread, no build,
no device touch).  Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
