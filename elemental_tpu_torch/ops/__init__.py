"""BLAS-like tier of the port (counterpart of ``elemental_tpu/ops``;
reference ``src/blas_like``, layer L5): plain torch on the blocks of a
``DistMatrix`` (SUMMA for the products) or on local tensors, and the 3-D
GEMM over a mesh of whole tensors."""

from .level1 import *  # noqa: F401,F403
from .level2 import (apply_givens_sequence, gemv, ger, geru, hemv, her, her2,
                     symv, syr, syr2, trmv, trsv)
from .level3 import (gemm, hemm, her2k, herk, multishift_trsm, quasi_trsm,
                     safe_multishift_trsm,
                     symm, syr2k, syrk, trmm, trr2k, trrk, trsm,
                     twosided_trmm, twosided_trsm)
from . import summa
from .gemm3d import gemm_3d, make_3d_mesh
from .level3 import hermitian_from_evd, normal_from_evd, set_matmul_precision
