"""The plain references of the benchmark's configurations, in NumPy, SciPy
and plain PyTorch.  Nothing here imports JAX, the JAX package or the
program (``elemental_tpu_torch``)."""
