"""Device layer of the PyTorch port: mirror tables, the CUDA kernels and
their wrappers, and the continuous-GO runtime.  Importing this package
imports nothing else (the reference's ``tpu/__init__.py`` pulls jax; this
one stays empty so host-only modules load alone)."""
