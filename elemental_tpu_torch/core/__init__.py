"""Core runtime of the port: grids, distributions, distributed matrices,
redistribution, environment, RNG, profiling, dtype policies and type
helpers (counterpart of ``elemental_tpu/core``)."""

from .policy import (effective_dtype, index_dtype, real_working_dtype,
                     residual_bound, working_dtype)
from .types import (complex_type, conj_if, epsilon, is_complex, real_type,
                    safe_min)
from .dist import (CIRC, MC, MD, MR, STAR, VC, VR, DIST_PAIRS, Dist,
                   diag_col, gathered_dist, is_replicated, partial_dist,
                   partition_spec, transpose_pair, vector_spec)
from .grid import Grid
from .distmatrix import DistMatrix, as_array, distribute, grid_of, like
from .blockcyclic import BlockCyclicMatrix, block_cyclic_perm
from .redistribute import (all_gather, axpy_contract, col_filter, contract,
                           row_filter, translate, translate_between_grids,
                           transpose_dist)
from .environment import (Args, Timer, args, blocksize, finalize, initialize,
                          initialized, output, output_from_root,
                          pop_blocksize_stack, push_blocksize_stack,
                          set_blocksize, set_local_blocksize)
from .profiling import (enable_profiling, enable_sync_profiling,
                        profile_region, profiled, reset_stage_times,
                        stage_times)
from . import random_ as random
from . import flamepart
from .proxy import ReadProxy, ReadWriteProxy
