"""Utilities: the transfer count (``transfers``), the port's counterpart of
the JAX package's HLO collective audit, and the roofline audit
(``roofline``) against the H100's data-sheet peaks."""

from .transfers import KINDS, Transfer, TransferLog, count_transfers

__all__ = ["KINDS", "Transfer", "TransferLog", "count_transfers"]
