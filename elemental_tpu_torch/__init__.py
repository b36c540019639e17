"""elemental_tpu_torch: the PyTorch + CUDA port of ``elemental_tpu``.

Ported so far: the sparse-direct interior-point LP path (``lp_direct``), with
the multifrontal extend-add as a hand-written Hopper kernel
(``kernels/extend_add.py``, ``csrc/extend_add.cu``).  Every public entry point
takes an explicit ``device`` and ``dtype``.  The package imports no JAX.
"""

from . import core, kernels, matrices, optimization, sparse, sparse_direct

__all__ = ["core", "kernels", "matrices", "optimization", "sparse",
           "sparse_direct"]
