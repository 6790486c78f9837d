"""The port's kernel registry (``nebula_tpu_torch/tpu/kernels.py``)
against the reference's ``KERNEL_REGISTRY``: every reference family
has an entry; every family that runs on one card, and the four
replicated-frontier mesh families, have a plain version and a hand
kernel whose sources exist; only the two frontier-sharded mesh
families have none yet."""
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
UNPORTED = {"mesh_sparse_go", "mesh_sparse_bfs"}


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
    """Of the six mesh families, the four of the replicated-frontier
    design are ported; the two frontier-sharded ones have nothing yet."""
    assert MESH == {"sharded_go", "ell_go_sharded", "ell_bfs_sharded",
                    "ell_absorb_sharded", "mesh_sparse_go",
                    "mesh_sparse_bfs"}
    missing = {name for name, e in kernels.KERNELS.items()
               if e.hand is None}
    assert missing == UNPORTED and UNPORTED < MESH
    assert all(kernels.KERNELS[n].plain is None
               and kernels.KERNELS[n].csrc is None for n in UNPORTED)
    for name in MESH - UNPORTED:
        assert "ell_mesh.cu" in kernels.KERNELS[name].csrc \
            or name == "sharded_go"
