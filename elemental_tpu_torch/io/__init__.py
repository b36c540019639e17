"""IO (counterpart of ``elemental_tpu/io``; reference ``src/io``: Read and
Write in ASCII / ASCII-Matlab / Binary / BinaryFlat / MatrixMarket, Print,
Display and Spy, ColorMap).

The files are the JAX package's, byte for byte: a tensor is read into
NumPy (from any device) and written by NumPy; :func:`read` puts what it
reads on ``device``.  ``display`` and ``spy`` draw with matplotlib where it
is installed and return ``None`` where it is not (``display`` then prints
the matrix), as the JAX functions do; ``color_map`` needs matplotlib and
raises ``ImportError`` without it.
"""

from __future__ import annotations

import sys
from typing import Optional, Union

import numpy as np
import torch

from ..core.distmatrix import DistMatrix, as_numpy
from ..sparse.csr import SparseMatrix
from ..sparse.io import read_matrix_market, write_matrix_market

Arr = Union[torch.Tensor, DistMatrix]

FORMATS = ("ascii", "ascii_matlab", "binary", "binary_flat",
           "matrix_market")


def print_matrix(A: Arr, title: str = "", file=None) -> None:
    """Reference ``Print``: a formatted dump."""
    f = file or sys.stdout
    a = as_numpy(A)
    if title:
        f.write(title + "\n")
    if a.ndim == 1:
        a = a[:, None]
    for row in a:
        f.write(" ".join(f"{v: .6g}" for v in row) + "\n")
    f.flush()


def write(path: str, A: Arr, fmt: str = "binary", title: str = "A") -> None:
    """Reference ``Write`` (format enum ``types.hpp:548-556``)."""
    a = as_numpy(A)
    fmt = fmt.lower()
    if fmt == "ascii":
        np.savetxt(path, a)
    elif fmt == "ascii_matlab":
        with open(path, "w") as f:
            f.write(f"{title} = [\n")
            for row in np.atleast_2d(a):
                f.write(" ".join(repr(float(v)) for v in row) + ";\n")
            f.write("];\n")
    elif fmt == "binary":
        with open(path, "wb") as f:
            f.write(np.array(a.shape, np.int64).tobytes())
            f.write(np.ascontiguousarray(a).tobytes())
    elif fmt == "binary_flat":
        with open(path, "wb") as f:
            f.write(np.ascontiguousarray(a).tobytes())
    elif fmt == "matrix_market":
        write_matrix_market(path, SparseMatrix.from_dense(a))
    else:
        raise ValueError(f"unknown format {fmt!r}")


def read(path: str, fmt: str = "binary", shape=None, dtype=np.float64, *,
         device) -> torch.Tensor:
    """Reference ``Read``: the matrix in ``path`` on ``device`` (``dtype``
    is the NumPy dtype of the binary formats' values)."""
    fmt = fmt.lower()
    if fmt == "ascii":
        a = np.loadtxt(path)
    elif fmt == "binary":
        with open(path, "rb") as f:
            hdr = np.frombuffer(f.read(16), np.int64)
            a = np.frombuffer(f.read(), dtype).reshape(hdr)
    elif fmt == "binary_flat":
        if shape is None:
            raise ValueError("binary_flat needs the shape")
        with open(path, "rb") as f:
            a = np.frombuffer(f.read(), dtype).reshape(shape)
    elif fmt == "matrix_market":
        a = read_matrix_market(path).to_dense()
    else:
        raise ValueError(f"unknown format {fmt!r}")
    return torch.from_numpy(np.array(a)).to(device)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def display(A: Arr, title: str = "", save: Optional[str] = None):
    """Reference ``Display``: a heatmap (matplotlib); without matplotlib
    the matrix is printed and ``None`` returned."""
    try:
        plt = _pyplot()
    except ImportError:
        print_matrix(A, title)
        return None
    fig, ax = plt.subplots()
    im = ax.imshow(np.real(as_numpy(A)), cmap="RdBu")
    ax.set_title(title)
    fig.colorbar(im)
    if save:
        fig.savefig(save)
        plt.close(fig)
    return fig


def spy(A, tol: float = 0.0, title: str = "", save: Optional[str] = None):
    """Reference ``Spy``: the nonzero pattern (matplotlib; ``None``
    without it)."""
    try:
        plt = _pyplot()
    except ImportError:
        return None
    a = A.to_dense() if isinstance(A, SparseMatrix) else as_numpy(A)
    fig, ax = plt.subplots()
    ax.spy(np.abs(a) > tol)
    ax.set_title(title)
    if save:
        fig.savefig(save)
        plt.close(fig)
    return fig


def color_map(values, cmap: str = "RdBu"):
    """Reference ``ColorMap``: scalar → RGBA (needs matplotlib)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors as colors
    v = as_numpy(values).astype(float)
    norm = colors.Normalize(vmin=float(v.min()), vmax=float(v.max()))
    return matplotlib.colormaps[cmap](norm(v))


__all__ = ["FORMATS", "color_map", "display", "print_matrix", "read",
           "read_matrix_market", "spy", "write", "write_matrix_market"]
