"""ctypes bridge to the native C++ symbolic kernels.

The source is the JAX package's ``elemental_tpu/native/symbolic.cpp``
(JAX-free C++: quotient-graph minimum degree, the SuiteSparse-AMD slot of
reference §2.6 item 2, and reverse Cuthill-McKee).  It is read in place,
compiled with ``g++`` into the port's ``_build/`` at first use, and
required: a failed build raises.
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
    csr_sig = [
        ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
        np.ctypeslib.ndpointer(np.int64, flags="C"),
    ]
    for fn in (lib.el_minimum_degree, lib.el_rcm):
        fn.restype = ctypes.c_int
        fn.argtypes = csr_sig
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


def rcm(rowptr: np.ndarray, colind: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee order of the graph given as a symmetrized CSR
    pattern without self loops (``el_rcm``)."""
    n = int(rowptr.shape[0]) - 1
    perm = np.zeros(n, np.int64)
    rc = _lib().el_rcm(n, np.ascontiguousarray(rowptr, np.int64),
                       np.ascontiguousarray(colind, np.int64), perm)
    if rc != 0:
        raise RuntimeError(f"el_rcm failed: {rc}")
    return perm
