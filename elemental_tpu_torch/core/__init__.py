"""Core policies of the port."""

from .policy import effective_dtype, residual_bound, working_dtype
