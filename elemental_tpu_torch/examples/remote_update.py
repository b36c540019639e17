"""Remote entrywise updates (counterpart of ``examples/remote_update.py``;
mirror of the reference's ``examples/interface/RemoteUpdate.py``): queue
updates and pulls against a distributed matrix; ``process_queues`` drains
each block's share as one scatter-add.

    python -m elemental_tpu_torch.examples.remote_update --n 24
"""

import numpy as np
import torch

from ..core import MC, MR, Grid, distribute
from ..core.environment import Args, output
from . import device_and_dtype


def main():
    args = Args()
    args.input("n", "size", 24)
    where = device_and_dtype(args)
    args.process_input()
    device, dtype = where()
    n = args["n"]
    g = Grid(devices=[device] * 4, height=2)
    A = distribute(torch.zeros((n, n), dtype=dtype), MC, MR, g)
    rng = np.random.default_rng(15)
    expect = np.zeros((n, n), np.float64)
    for _ in range(50):
        i, j = int(rng.integers(n)), int(rng.integers(n))
        v = float(rng.standard_normal())
        A.queue_update(i, j, v)
        expect[i, j] += v
    A = A.process_queues()
    atol = 10 * float(torch.finfo(dtype).eps)
    if not np.allclose(A.to_numpy(), expect, atol=atol):
        raise AssertionError("queued updates disagree")
    A.queue_pull(0, 0)
    A.queue_pull(n - 1, n - 1)
    vals = A.process_pull_queue()
    if not np.allclose(vals, [expect[0, 0], expect[-1, -1]], atol=atol):
        raise AssertionError("queued pulls disagree")
    output(f"remote updates: 50 queued updates + 2 pulls verified on a "
           f"{g.size}-position grid ({dtype} on {device})")


if __name__ == "__main__":
    main()
