"""The benchmark harness of ``elemental_tpu_torch``: it finds a cell's
configuration, traffic mix, operation and metric readers by name, runs the
measured window, checks the outputs against ``benchmarks/reference`` and
prints the result line.  It imports neither JAX nor the JAX package."""
