"""ctypes bridge to the native C++ symbolic kernels.

The source is the JAX package's ``elemental_tpu/native/symbolic.cpp``
(JAX-free C++: quotient-graph minimum degree, the SuiteSparse-AMD slot of
reference §2.6 item 2).  It is read in place, compiled with ``g++`` into the
port's ``_build/`` at first use, and required: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import List

import numpy as np

from .._build import build_host_library

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "elemental_tpu", "native", "symbolic.cpp")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_host_library("elemental_native",
                                         [os.path.normpath(SOURCE)]))
    lib.el_minimum_degree.restype = ctypes.c_int
    lib.el_minimum_degree.argtypes = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
    ]
    return lib


def minimum_degree(adj: List[np.ndarray]) -> np.ndarray:
    """Minimum-degree elimination order of the graph given by adjacency
    lists (symmetrized, no self loops)."""
    n = len(adj)
    rowptr = np.zeros(n + 1, np.int64)
    for i, a in enumerate(adj):
        rowptr[i + 1] = rowptr[i] + len(a)
    colind = (np.concatenate(adj) if n and rowptr[-1] else
              np.zeros(0, np.int64)).astype(np.int64)
    perm = np.zeros(n, np.int64)
    rc = _lib().el_minimum_degree(n, rowptr, colind, perm)
    if rc != 0:
        raise RuntimeError(f"el_minimum_degree failed: {rc}")
    return perm
