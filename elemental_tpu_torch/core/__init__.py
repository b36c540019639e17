"""Core policies and type helpers of the port."""

from .policy import (effective_dtype, index_dtype, real_working_dtype,
                     residual_bound, working_dtype)
from .types import (complex_type, conj_if, epsilon, is_complex, real_type,
                    safe_min)
