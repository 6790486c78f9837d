"""Expression trees of the port (copies of ``nebula_tpu/filter``)."""
