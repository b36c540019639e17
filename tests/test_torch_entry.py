"""``elemental_tpu_torch.entry``, the counterpart of ``__graft_entry__``:
``entry()``'s 25 CG iterations on the unscaled 64² Laplacian's ELL form in
float32, held to the JAX forward step on the same arrays within 1e-4
relative in x and ‖r‖; ``dryrun_multichip`` and ``_weak_scaling`` on
repeated CPU positions, their gates held; and the small leftovers of the
sparse-direct tier (``postorder``, the JAX package's exports,
``SparseBuilder.reserve``) against the JAX package."""

import os
import sys

import numpy as np
import pytest
import torch

import jax

from elemental_tpu_torch.entry import _weak_scaling, dryrun_multichip, entry

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


CPU = torch.device("cpu")


def test_dryrun_multichip_on_eight_cpu_positions():
    """``dryrun_multichip`` on a 2×4 grid of the CPU at a 10³ Laplacian:
    every step's gate held (it raises otherwise), its numbers returned."""
    out = dryrun_multichip(8, devices=[CPU] * 8, lap3d=10, scaling=False)
    assert out["positions"] == 8 and out["grid"] == (2, 4)
    assert out["ldl_residual"] < out["ldl_bound"]
    assert out["cg_residual"] < 1e-5 and out["cg_iterations"] <= 50
    assert out["spgemm_err"] < 1e-5
    assert out["lp"] == "synthetic 12x30" and out["ipm_iterations"] > 0
    assert out["factor_gflop"] > 0 and out["factor_s_grid"] > 0
    assert out["factor_transfers"]["count"] >= 0
    assert np.isfinite(out["scalar"]) and out["scaling"] is None


def test_dryrun_multichip_refuses_short_device_lists():
    with pytest.raises(RuntimeError, match="need 4 devices"):
        dryrun_multichip(4, devices=[CPU] * 2, lap3d=6, scaling=False)


def test_weak_scaling_rows_count_transfers():
    """Toy sizes over 1, 2 and 4 positions: one row an op and a count,
    each with its transfer bytes, none at one position; SUMMA and the
    distributed SpMV move bytes between positions."""
    rows = _weak_scaling([CPU] * 4, gemm_m=32, spmv_side=16, lap3d=5)
    assert [(r["op"], r["positions"]) for r in rows] == [
        (op, d) for d in (1, 2, 4)
        for op in ("summa_gemm", "dist_spmv", "mf_factor")]
    for r in rows:
        assert r["ms"] > 0 and r["work"] > 0
        if r["positions"] == 1:
            assert r["bytes"] == r["transfers"] == 0
            assert r["efficiency"] == 1.0
        elif r["op"] != "mf_factor":
            assert r["bytes"] > 0


def test_postorder_and_exports_match_jax():
    """``postorder`` on a random forest, and the exports ``etree``,
    ``column_structures``, ``find_supernodes`` under the JAX names, equal
    to the JAX package's on a 3-D Laplacian."""
    from elemental_tpu import sparse_direct as jsd
    from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
    from elemental_tpu_torch import sparse_direct as tsd
    from elemental_tpu_torch.matrices import sparse_laplacian_3d
    rng = np.random.default_rng(4)
    n = 200
    parent = np.array([-1 if rng.random() < 0.05 or v == n - 1
                       else int(rng.integers(v + 1, n)) for v in range(n)])
    np.testing.assert_array_equal(tsd.postorder(parent),
                                  jsd.postorder(parent))
    A = sparse_laplacian_3d(5, 5, 5, scaled=False)
    Aj = JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)
    par = tsd.etree(A)
    np.testing.assert_array_equal(par, jsd.etree(Aj))
    st, stj = tsd.column_structures(A, par), jsd.column_structures(Aj, par)
    assert all(np.array_equal(a, b) for a, b in zip(st, stj))
    sn = tsd.find_supernodes(par, st)
    snj = jsd.find_supernodes(par, stj)
    assert [(s.cols, s.parent) for s in sn] == [(s.cols, s.parent)
                                                for s in snj]
    assert tsd.DistSparseLDLFactorization.__mro__[1] \
        is tsd.SparseLDLFactorization


def test_sparse_builder_reserve_matches_jax():
    from elemental_tpu.sparse.csr import SparseBuilder as JaxBuilder
    from elemental_tpu_torch.sparse.csr import SparseBuilder
    out = []
    for cls in (SparseBuilder, JaxBuilder):
        b = cls(3, 3)
        assert b.reserve(10) is None
        b.queue_update(0, 1, 2.0)
        b.queue_updates([2, 1], [2, 0], [3.0, 4.0])
        out.append(b.process_queues().to_dense())
    np.testing.assert_array_equal(*out)
