"""The port's kernel registry (``nebula_tpu_torch/tpu/kernels.py``)
against the reference's ``KERNEL_REGISTRY``: every reference family
has an entry, and every one (the six mesh families included) has a
plain version and a hand kernel whose sources exist; no family is
without a hand kernel."""
import os

import pytest

from nebula_tpu.tpu import ell as _jell  # noqa: F401 — registers its families
from nebula_tpu.tpu import expr_compile as _jexpr  # noqa: F401 — and its
from nebula_tpu.tpu.kernels import KERNEL_REGISTRY
from nebula_tpu_torch.tpu import ell_ops, kernels

CSRC = os.path.join(os.path.dirname(ell_ops.__file__), "csrc")
HELPERS = ("_upload_frontier", "_upload_frontier_packed",
           "make_batched_go_kernel", "make_batched_bfs_kernel")
MESH = {name for name, spec in KERNEL_REGISTRY.items()
        if spec.mesh_instantiate is not None}
UNPORTED: set = set()            # every family has a hand kernel


def test_every_reference_family_has_an_entry():
    assert len(KERNEL_REGISTRY) == 22
    assert set(KERNEL_REGISTRY) <= set(kernels.KERNELS)
    assert set(kernels.KERNELS) == set(KERNEL_REGISTRY) | set(HELPERS)


@pytest.mark.parametrize("name", sorted(set(KERNEL_REGISTRY) - UNPORTED)
                         + list(HELPERS))
def test_single_card_entries_have_a_plain_and_a_hand_kernel(name):
    entry = kernels.KERNELS[name]
    assert callable(entry.plain) and callable(entry.hand)
    assert entry.plain is not entry.hand
    assert entry.plain.__name__.endswith("_ref")
    assert entry.csrc
    for src in entry.csrc:
        assert os.path.isfile(os.path.join(CSRC, src)), src


def test_only_the_six_mesh_families_have_no_hand_kernel():
    """No family lacks a hand kernel now: the six mesh families, the
    four of the replicated-frontier design (``ell_mesh.cu``, and the
    edge kernels for ``sharded_go``) and the two frontier-sharded ones
    (``mesh_sparse.cu`` with ``sparse_go.cu``'s K5 / K6), all have one."""
    assert MESH == {"sharded_go", "ell_go_sharded", "ell_bfs_sharded",
                    "ell_absorb_sharded", "mesh_sparse_go",
                    "mesh_sparse_bfs"}
    missing = {name for name, e in kernels.KERNELS.items()
               if e.hand is None or e.plain is None or not e.csrc}
    assert missing == UNPORTED == set()
    for name in MESH:
        src = kernels.KERNELS[name].csrc
        if name.startswith("mesh_sparse"):
            assert "mesh_sparse.cu" in src and "sparse_go.cu" in src
        else:
            assert "ell_mesh.cu" in src or name == "sharded_go"
