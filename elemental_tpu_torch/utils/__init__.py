"""Utilities: the transfer count (``transfers``), the port's counterpart of
the JAX package's HLO collective audit."""

from .transfers import KINDS, Transfer, TransferLog, count_transfers

__all__ = ["KINDS", "Transfer", "TransferLog", "count_transfers"]
