"""``elemental_tpu_torch.entry.entry``, the counterpart of
``__graft_entry__.entry``: the same 25 CG iterations on the unscaled 64²
Laplacian's ELL form in float32, held to the JAX forward step on the same
arrays within 1e-4 relative in x and ‖r‖."""

import os
import sys

import numpy as np
import torch

import jax

from elemental_tpu_torch.entry import entry

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import __graft_entry__  # noqa: E402

torch.set_num_threads(2)


def test_entry_forward_matches_jax():
    jfwd, jargs = __graft_entry__.entry()
    jx, jr = jax.jit(jfwd)(*jargs)
    fwd, args = entry(device="cpu")
    cols, vals, b = args
    assert vals.dtype == torch.float32 and b.dtype == torch.float32
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jargs[0]))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(b.numpy(), np.asarray(jargs[2]))
    x, r = fwd(*args)
    jx, jr = np.asarray(jx), float(jr)
    assert x.shape == (64 * 64,) and x.dtype == torch.float32
    assert np.abs(x.numpy() - jx).max() <= 1e-4 * np.abs(jx).max()
    assert abs(float(r) - jr) <= 1e-4 * jr
    # 25 iterations make progress on ‖b‖
    assert float(r) < 0.5 * float(torch.linalg.norm(b))
