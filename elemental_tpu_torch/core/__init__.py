"""Core policies of the port."""

from .policy import (effective_dtype, index_dtype, residual_bound,
                     working_dtype)
