"""Conic optimization: the direct-form interior-point LP."""

from .lp import Approach, LPCtrl, LPResult, lp_direct, sparse_ruiz
from .kkt import KKTBuilder, KKTFactor, KKTSystem
