"""Process grid → an h×w array of torch devices (counterpart of
``elemental_tpu/core/grid.py``).

The reference's ``Grid`` (``include/El/core/Grid.hpp:15-146``) owns a 2D
process grid and the communicators derived from it.  The JAX package holds
a ``Mesh`` with axes ``('mc', 'mr')`` in one process that sees every device;
the port keeps that single-controller model: a grid is an h×w array of
``torch.device``s, and a :class:`~.distmatrix.DistMatrix` holds one local
block per grid position.  The communicators become axis names:

  =============  =============================================
  reference      port
  =============  =============================================
  mcComm         axis ``'mc'`` (the h positions of a grid column)
  mrComm         axis ``'mr'`` (the w positions of a grid row)
  vcComm         flattened axes ``('mc','mr')``
  vrComm         flattened axes ``('mr','mc')``
  viewing comm   a second Grid over a device subset
  =============  =============================================

A device may appear at several positions.  That is how the CPU, torch's one
CPU device, carries a 2×4 grid, and how one card carries a 2×2 grid; the
blocks of those positions then live on the same device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .dist import Axes


def _grid_height(size: int) -> int:
    """Near-square factorization, mirroring the reference's default
    (``Grid::Grid`` picks the largest factor ≤ √p)."""
    h = int(math.isqrt(size))
    while size % h != 0:
        h -= 1
    return h


def cuda_devices() -> list:
    """Every visible CUDA device; raises where there is none (the port never
    falls back to the CPU by itself: pass CPU devices explicitly)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the grid's devices "
                           "explicitly, e.g. [torch.device('cpu')] * 8")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _as_device_array(devices: Sequence, height: int, width: int) -> np.ndarray:
    arr = np.empty((height, width), dtype=object)
    for k, d in enumerate(devices):
        arr[k // width, k % width] = torch.device(d)
    return arr


class Grid:
    """A 2D grid of torch devices.

    Parameters
    ----------
    devices:
        Flat sequence of torch devices (or names), row-major over the grid;
        repeats are allowed.  Defaults to every visible CUDA device, and
        raises where there is none.
    height:
        Number of grid rows (``MC`` extent).  Defaults to the largest factor
        of ``len(devices)`` that is ≤ its square root, like the reference.
    viewers:
        Devices that take part in the program but own no block of this
        grid's data (reference ``Grid(viewers, owners, height)``,
        ``include/El/core/Grid.hpp:59``).
    """

    _default: Optional["Grid"] = None

    def __init__(self, devices: Optional[Sequence] = None,
                 height: Optional[int] = None,
                 viewers: Optional[Sequence] = None):
        if devices is None:
            devices = cuda_devices()
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("a grid needs at least one device")
        self._viewers = tuple(torch.device(d) for d in viewers or ())
        size = len(devices)
        if height is None:
            height = _grid_height(size)
        if size % height != 0:
            raise ValueError(f"grid height {height} does not divide {size}")
        self._height = height
        self._width = size // height
        self._devices = _as_device_array(devices, height, self._width)

    # -- shape ------------------------------------------------------------
    @property
    def height(self) -> int:
        return self._height

    @property
    def width(self) -> int:
        return self._width

    @property
    def size(self) -> int:
        return self._height * self._width

    @property
    def devices(self) -> np.ndarray:
        """The (height, width) object array of ``torch.device``s."""
        return self._devices

    @property
    def viewers(self) -> Tuple[torch.device, ...]:
        """Devices viewing (not owning) this grid (reference
        ``Grid::InGrid``'s false case / viewing comm members)."""
        return self._viewers

    def device(self, i: int, j: int) -> torch.device:
        """The device of grid position (i, j)."""
        return self._devices[i, j]

    def positions(self):
        """Every (i, j), row-major."""
        return [(i, j) for i in range(self._height)
                for j in range(self._width)]

    def in_grid(self, device) -> bool:
        """Reference ``Grid::InGrid``: does ``device`` own a block?"""
        device = torch.device(device)
        return any(d == device for d in self._devices.ravel())

    def subgrid(self, n: int, height: Optional[int] = None) -> "Grid":
        """Owner sub-grid over the first n devices; the rest become
        viewers (reference multi-grid ensembles,
        ``tests/core/DifferentGrids.cpp:36-74``)."""
        devs = list(self._devices.ravel())
        return Grid(devices=devs[:n], height=height, viewers=devs[n:])

    # -- the axes of a spec -----------------------------------------------
    def axis_size(self, axes: Axes) -> int:
        """How many chunks a dimension cut over ``axes`` has."""
        if axes is None:
            return 1
        n = 1
        for ax in ((axes,) if isinstance(axes, str) else axes):
            n *= {"mc": self._height, "mr": self._width}[ax]
        return n

    def chunk_index(self, axes: Axes, i: int, j: int) -> int:
        """Which chunk of a dimension cut over ``axes`` position (i, j)
        holds: mesh-major for a tuple of axes, as ``NamedSharding`` cuts."""
        if axes is None:
            return 0
        k = 0
        for ax in ((axes,) if isinstance(axes, str) else axes):
            size, idx = ((self._height, i) if ax == "mc"
                         else (self._width, j))
            k = k * size + idx
        return k

    # -- singletons -------------------------------------------------------
    @classmethod
    def default(cls) -> "Grid":
        """The grid over every CUDA device (raises where there is none)."""
        if cls._default is None:
            cls._default = cls()
        return cls._default

    @classmethod
    def set_default(cls, grid: Optional["Grid"]) -> None:
        cls._default = grid

    @classmethod
    def trivial(cls) -> "Grid":
        """Single-device grid on the first CUDA device (reference
        ``Grid::Trivial``)."""
        return cls(devices=cuda_devices()[:1])

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self._devices.ravel())
        return f"Grid({self._height}x{self._width}, devices=[{devs}])"

    def _key(self):
        return (self._height, self._width, tuple(self._devices.ravel()))

    def __eq__(self, other) -> bool:
        return isinstance(other, Grid) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())
