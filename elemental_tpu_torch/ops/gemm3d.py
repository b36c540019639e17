"""3D (2.5D) GEMM (counterpart of ``elemental_tpu/ops/gemm3d.py``; reference
``experimental/g3d/G3DGemm.cpp``: replicate over a depth dimension of
independent grids, split the contraction, sum).

A (d, h, w) array of devices, axes ('d', 'mc', 'mr').  A's columns are cut
over ('d', 'mr') and B's rows over ('d', 'mc'), as in the JAX package; each
depth slice runs a stationary-C SUMMA on its (mc, mr) grid over its share
of k, and the depth slices' products are summed in depth order (the JAX
package's ``psum`` over 'd').  Like every product of the port it runs
under the library's matmul precision (TF32 off by default)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.grid import _grid_height, cuda_devices
from .level3 import with_precision


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh3D:
    """A (d, h, w) object array of ``torch.device``s (repeats allowed)."""

    devices: np.ndarray

    @property
    def shape(self) -> Dict[str, int]:
        d, h, w = self.devices.shape
        return {"d": d, "mc": h, "mr": w}


def make_3d_mesh(devices: Optional[Sequence] = None, depth: int = 2,
                 height: Optional[int] = None) -> Mesh3D:
    """Devices (default: every CUDA device; raises where there is none) as
    ``depth`` grids of ``height`` rows."""
    devices = [torch.device(d) for d in
               (cuda_devices() if devices is None else devices)]
    n = len(devices)
    if n % depth:
        raise ValueError(f"depth {depth} does not divide {n} devices")
    per = n // depth
    if height is None:
        height = _grid_height(per)
    if per % height:
        raise ValueError(f"height {height} does not divide {per}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh3D(arr.reshape(depth, height, per // height))


@with_precision
def gemm_3d(A: torch.Tensor, B: torch.Tensor, mesh: Mesh3D) -> torch.Tensor:
    """C = A·B with the contraction dimension split over the 'd' axis; C
    comes back whole on the mesh's first device."""
    m, k = A.shape
    k2, n = B.shape
    d, h, w = mesh.devices.shape
    if k != k2:
        raise ValueError(f"inner dimensions differ: {tuple(A.shape)} @ "
                         f"{tuple(B.shape)}")
    if m % h or n % w or k % (d * w) or k % (d * h):
        raise ValueError(f"({m}, {k}) @ ({k}, {n}) does not divide over "
                         f"the ({d}, {h}, {w}) mesh")
    mr, nc, ka, kb = m // h, n // w, k // (d * w), k // (d * h)
    on: dict = {}

    def there(X, dev):
        if (id(X), dev) not in on:
            on[(id(X), dev)] = X.to(dev)
        return on[(id(X), dev)]

    # a_blk(dd, i, j) = A[rows i, k-chunk dd·w + j]; b_blk(dd, i, j) =
    # B[k-chunk dd·h + i, cols j] (A: P('mc', ('d','mr')), B: P(('d','mc'),
    # 'mr'))
    def a_blk(dd, i, j, dev):
        c = dd * w + j
        return there(A, dev)[i * mr:(i + 1) * mr, c * ka:(c + 1) * ka]

    def b_blk(dd, i, j, dev):
        r = dd * h + i
        return there(B, dev)[r * kb:(r + 1) * kb, j * nc:(j + 1) * nc]

    first = mesh.devices[0, 0, 0]
    rows = []
    for i in range(h):
        row = []
        for j in range(w):
            acc = None
            for dd in range(d):
                dev = mesh.devices[dd, i, j]
                # per-depth stationary-C: gather along 'mr' and 'mc'
                a_row = torch.cat([a_blk(dd, i, jj, mesh.devices[dd, i, jj])
                                   .to(dev) for jj in range(w)], dim=1)
                b_col = torch.cat([b_blk(dd, ii, j, mesh.devices[dd, ii, j])
                                   .to(dev) for ii in range(h)], dim=0)
                part = torch.matmul(a_row, b_col).to(first)
                acc = part if acc is None else acc + part
            row.append(acc)
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)
