"""Schema names of the port (the subset of ``nebula_tpu/meta`` the
expression compiler reads)."""
