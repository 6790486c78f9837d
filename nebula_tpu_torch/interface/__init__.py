"""Wire-contract types of the port (a subset of ``nebula_tpu/interface``)."""
