"""Parity of the port's CSR SpMV plan (K2's plain version) with the JAX
package's windowed-gather Pallas kernel (``interpret=True``, as
``tests/sparse/test_unstructured.py`` runs it), on the CPU in float64.

The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu.kernels.unstructured import (
    plan_gather_spmv as jax_plan_gather)
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix

from elemental_tpu_torch.kernels.unstructured import (GatherPlan,
                                                      gather_spmv,
                                                      gather_spmv_plain,
                                                      plan_gather_spmv)
from elemental_tpu_torch.sparse import SparseMatrix

torch.set_num_threads(1)


def _uniform():
    """``test_gather_spmv_uniform_random``'s matrix and x."""
    n, nnzr = 1536, 6
    rng = np.random.default_rng(0)
    A = SparseMatrix.from_coo(n, n, np.repeat(np.arange(n), nnzr),
                              rng.integers(0, n, n * nnzr),
                              rng.standard_normal(n * nnzr))
    return A, np.random.default_rng(0).standard_normal(n), 1e-12


def _skewed():
    """``test_gather_spmv_skewed_and_rect``: power-law columns, 700×900."""
    rng = np.random.default_rng(3)
    m, n, nnz = 700, 900, 5000
    cols = (n * rng.random(nnz) ** 3).astype(np.int64)
    rows = rng.integers(0, m, nnz)
    A = SparseMatrix.from_coo(m, n, rows, cols, rng.standard_normal(nnz))
    return A, rng.standard_normal(n), 1e-11


CASES = {"uniform_random": _uniform, "skewed_and_rect": _skewed}


def _jax(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gather_spmv_matches_pallas(case):
    A, x, tol = CASES[case]()
    plan = plan_gather_spmv(A)
    y = plan.matvec(torch.from_numpy(x)).numpy()
    yj = np.asarray(jax_plan_gather(_jax(A)).matvec(jnp.asarray(x),
                                                    interpret=True))
    np.testing.assert_allclose(y, yj, rtol=tol, atol=tol)
    np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_from_reference_rebuilds_the_csr(case):
    A, x, tol = CASES[case]()
    plan = GatherPlan.from_reference(jax_plan_gather(_jax(A)))
    own = plan_gather_spmv(A)
    assert (plan.n_rows, plan.n_cols, plan.nnz, plan.col_max) == (
        own.n_rows, own.n_cols, own.nnz, own.col_max)
    for f in ("rowptr", "colind", "vals", "rows"):
        assert torch.equal(getattr(plan, f), getattr(own, f)), f
    np.testing.assert_allclose(gather_spmv(plan, torch.from_numpy(x)),
                               A.to_scipy() @ x, rtol=tol, atol=tol)


def test_plan_layout():
    """CSR arrays under the index-width rule, the lane group from the mean
    row length, and x cast to the plan's dtype."""
    A, x, _ = _uniform()
    plan = plan_gather_spmv(A)
    assert plan.rowptr.dtype == plan.colind.dtype == torch.int32
    assert plan.rowptr[-1] == plan.nnz == A.nnz
    assert plan.group == 8
    f32 = plan.to(dtype=torch.float32)
    assert f32.vals.dtype == torch.float32
    y = gather_spmv_plain(f32, torch.from_numpy(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), A.to_scipy() @ x,
                               atol=1e-5 * np.abs(A.to_scipy() @ x).max())
