"""Redistribution between different grids (counterpart of
``examples/different_grids.py``; mirror of the reference's
``tests/core/DifferentGrids.cpp``): round-trip a matrix between a 2×4, a
4×2 and a 1×1 grid, bit-exact.  The grids repeat ``--device`` where there
are fewer than 8 devices.

    python -m elemental_tpu_torch.examples.different_grids
"""

import numpy as np
import torch

from ..core import MC, MR, Grid, as_array, distribute
from ..core.environment import Args, output
from ..core.redistribute import translate_between_grids
from . import device_and_dtype


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    devs = [device] * 8
    g24 = Grid(devices=devs, height=2)
    g42 = Grid(devices=devs, height=4)
    g11 = Grid(devices=devs[:1], height=1)
    rng = np.random.default_rng(16)
    a = torch.from_numpy(rng.standard_normal((48, 40))).to(dtype)
    A = distribute(a, MC, MR, g24)
    B = translate_between_grids(A, g42)
    C = translate_between_grids(B, g11)
    D = translate_between_grids(C, g24)
    if not torch.equal(as_array(D).cpu(), a):
        raise AssertionError("the round trip changed the matrix")
    output(f"different_grids: 2x4 -> 4x2 -> 1x1 -> 2x4 round-trip bit-exact "
           f"({dtype} on {device})")


if __name__ == "__main__":
    main()
