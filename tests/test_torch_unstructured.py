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

from elemental_tpu_torch.kernels.unstructured import (SHARE, TAIL,
                                                      GatherPlan,
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


def _empty_and_long():
    """Rows of 0-3 entries, a third of them empty, with one row of 3,000
    entries (more than ten kernel shares) in the middle: 600×800."""
    rng = np.random.default_rng(5)
    m, n = 600, 800
    lengths = rng.choice([0, 0, 1, 2, 3], m)
    lengths[0] = lengths[-1] = 0
    lengths[300] = 3000
    rows = np.repeat(np.arange(m), lengths)
    A = SparseMatrix.from_coo(m, n, rows, rng.integers(0, n, rows.size),
                              rng.standard_normal(rows.size))
    return A, rng.standard_normal(n), 1e-11


CASES = {"uniform_random": _uniform, "skewed_and_rect": _skewed,
         "empty_and_long": _empty_and_long}


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
    """CSR arrays under the index-width rule, the kernel's share split in
    the same type, and x cast to the plan's dtype."""
    A, x, _ = _uniform()
    plan = plan_gather_spmv(A)
    assert plan.rowptr.dtype == plan.colind.dtype == torch.int32
    assert plan.split.dtype == torch.int32
    assert plan.rowptr[-1] == plan.nnz == A.nnz
    assert plan.n_shares == -(-A.nnz // SHARE)
    # rows of about 6 entries never reach far past a share boundary: the
    # kernel finishes all of them without its fix-up pass
    assert plan.fix.numel() == 0 and plan.fix.dtype == torch.int32
    f32 = plan.to(dtype=torch.float32)
    assert f32.vals.dtype == torch.float32
    y = gather_spmv_plain(f32, torch.from_numpy(x))
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), A.to_scipy() @ x,
                               atol=1e-5 * np.abs(A.to_scipy() @ x).max())


def _csr_of_lengths(lengths, n_cols=50, seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    rows = np.repeat(np.arange(lengths.size), lengths)
    return SparseMatrix.from_coo(lengths.size, n_cols, rows,
                                 rng.integers(0, n_cols, rows.size),
                                 rng.standard_normal(rows.size))


SPLIT_CASES = {
    "no_entries": [0] * 40,
    "one_row": [1],
    "one_long_row": [100_000],
    "empty_ends": [0] * 9 + [3] * 400 + [0] * 11,
    "share_multiples": [SHARE] * 5,
    "zipf": np.minimum(np.random.default_rng(1).zipf(1.7, 3000) - 1, 4096),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_is_searchsorted_of_rowptr(case):
    """The stored split equals ``np.searchsorted`` of ``rowptr`` at every
    share start, ``fix`` lists the end shares of the rows cut by a share
    boundary that reach more than ``TAIL`` entries past it, and the
    plain version gives 0 for empty rows and scipy's y otherwise."""
    A = _csr_of_lengths(SPLIT_CASES[case])
    plan = plan_gather_spmv(A)
    rowptr = plan.rowptr.numpy().astype(np.int64)
    n_shares = max(1, -(-A.nnz // SHARE))
    expect = np.searchsorted(rowptr, SHARE * np.arange(n_shares + 1),
                             side="right") - 1
    assert np.array_equal(plan.split.numpy(), expect)
    assert plan.split[-1] == A.height
    fix = []
    for r in range(A.height):
        a, b = rowptr[r], rowptr[r + 1]
        if b > a and a // SHARE != (b - 1) // SHARE and \
                b - (a // SHARE + 1) * SHARE > TAIL:
            fix.append((b - 1) // SHARE)
    assert plan.fix.tolist() == fix
    x = np.random.default_rng(2).standard_normal(A.width)
    y = gather_spmv(plan, torch.from_numpy(x)).numpy()
    assert np.all(y[np.diff(rowptr) == 0] == 0)
    np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-12, atol=1e-12)
