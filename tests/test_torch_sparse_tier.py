"""Parity of the port's single-device sparse containers, PDE generators,
type helpers and grid ordering with the JAX package, on the CPU, from the
same NumPy inputs: BSR (mirrors ``tests/sparse/test_sparse.py:84``), the
``SparseMatrix`` algebra (``:202``), the Helmholtz shift (``:146``), the
dense PDE overloads, ``helmholtz_pml_2d`` entry for entry and
``natural_nested_dissection`` (``tests/sparse_direct/test_sparse_ldl.py:
35-40``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu import matrices as jmat
from elemental_tpu.core import types as jtypes
from elemental_tpu.sparse import BSRMatrix as JaxBSR
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse_direct import (
    natural_nested_dissection as jax_natural_nd)

from elemental_tpu_torch import core, matrices as tmat
from elemental_tpu_torch.sparse import BSRMatrix, SparseMatrix
from elemental_tpu_torch.sparse_direct import (analyze,
                                               natural_nested_dissection)

torch.set_num_threads(1)


def _random_sparse(m, n, density, seed, complex_=False):
    rng = np.random.default_rng(seed)
    nnz = int(m * n * density)
    vals = rng.standard_normal(nnz)
    if complex_:
        vals = vals + 1j * rng.standard_normal(nnz)
    return SparseMatrix.from_coo(m, n, rng.integers(0, m, nnz),
                                 rng.integers(0, n, nnz), vals)


def _jax(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


def _same(A, B):
    for f in ("height", "width"):
        assert getattr(A, f) == getattr(B, f)
    for f in ("rowptr", "colind", "vals"):
        np.testing.assert_array_equal(getattr(A, f), getattr(B, f))


@pytest.mark.parametrize("complex_", [False, True])
@pytest.mark.parametrize("shape,block", [((37, 37), 8), ((40, 40), 4),
                                         ((16, 16), 16)])
def test_bsr_matvec_matches_reference(shape, block, complex_):
    """The blocks, their dense form and the device product, against the
    JAX container and the dense product."""
    A = _random_sparse(*shape, 0.15, seed=1, complex_=complex_)
    bsr, jbsr = BSRMatrix.from_sparse(A, block), JaxBSR.from_sparse(_jax(A),
                                                                   block)
    for f in ("rowptr", "colind", "vals"):
        np.testing.assert_array_equal(getattr(bsr, f), getattr(jbsr, f))
    assert bsr.nnzb == jbsr.nnzb
    np.testing.assert_array_equal(bsr.to_dense(), A.to_dense())
    np.testing.assert_array_equal(bsr.to_dense(), jbsr.to_dense())
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape[1])
    dt = torch.complex128 if complex_ else torch.float64
    dev = bsr.device(device="cpu", dtype=dt)
    y = dev.matvec(torch.as_tensor(x).to(dt)).numpy()
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-10, atol=1e-12)
    yj = np.asarray(jbsr.device().matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, yj, rtol=1e-10, atol=1e-12)


def test_bsr_rectangular():
    """A matrix whose width is not a multiple of the block (the port pads
    x to whole blocks)."""
    A = _random_sparse(20, 29, 0.2, seed=3)
    bsr = BSRMatrix.from_sparse(A, 8)
    np.testing.assert_array_equal(bsr.to_dense(), A.to_dense())
    x = np.random.default_rng(4).standard_normal(29)
    y = bsr.device(device="cpu", dtype=torch.float64).matvec(
        torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("complex_", [False, True])
def test_matrix_algebra_matches_reference(complex_):
    """symmetric_scale, diagonal, update_diagonal, conj, add and scale
    against the JAX container, bit for bit, and the dense algebra."""
    A = _random_sparse(20, 20, 0.2, seed=5, complex_=complex_)
    B = _random_sparse(20, 20, 0.1, seed=6, complex_=complex_)
    Aj, Bj = _jax(A), _jax(B)
    rng = np.random.default_rng(7)
    d = np.abs(rng.standard_normal(20)) + 0.5
    _same(A.symmetric_scale(d), Aj.symmetric_scale(d))
    np.testing.assert_allclose(A.symmetric_scale(d).to_dense(),
                               np.diag(d) @ A.to_dense() @ np.diag(d),
                               rtol=1e-12)
    np.testing.assert_array_equal(A.diagonal(), Aj.diagonal())
    np.testing.assert_array_equal(A.diagonal(), np.diag(A.to_dense()))
    _same(A.update_diagonal(np.ones(20)), Aj.update_diagonal(np.ones(20)))
    np.testing.assert_allclose(A.update_diagonal(np.ones(20)).to_dense(),
                               A.to_dense() + np.eye(20), rtol=1e-12)
    _same(A.conj(), Aj.conj())
    np.testing.assert_array_equal(A.conj().to_dense(), A.to_dense().conj())
    alpha = 0.5 - 2j if complex_ else -1.5
    _same(A.add(B, alpha), Aj.add(Bj, alpha))
    np.testing.assert_allclose(A.add(B, alpha).to_dense(),
                               A.to_dense() + alpha * B.to_dense(),
                               rtol=1e-12, atol=1e-14)
    _same(A.scale(alpha), Aj.scale(alpha))
    assert A.dtype == Aj.dtype


def test_complex_csr_products():
    """The device CSR product on complex values against the dense one."""
    A = _random_sparse(30, 25, 0.2, seed=8, complex_=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal(25) + 1j * rng.standard_normal(25)
    X = rng.standard_normal((25, 3)) + 1j * rng.standard_normal((25, 3))
    csr = A.device_csr(device="cpu", dtype=torch.complex128)
    np.testing.assert_allclose(csr.matvec(torch.as_tensor(x)).numpy(),
                               A.to_dense() @ x, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(csr.matmat(torch.as_tensor(X)).numpy(),
                               A.to_dense() @ X, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("shift", [7.0, 30.0 * (1 + 0.3j)])
def test_helmholtz_shift(shift):
    """−Δ − shift, a complex shift kept complex (as in the JAX package),
    equal to the JAX matrices in 2-D and 3-D."""
    A = tmat.sparse_laplacian_2d(5, 5)
    H = tmat.sparse_helmholtz_2d(5, 5, shift=shift)
    np.testing.assert_allclose(H.to_dense(), A.to_dense() - shift * np.eye(25),
                               rtol=1e-12)
    assert np.iscomplexobj(H.vals) == isinstance(shift, complex)
    _same(H, jmat.sparse_helmholtz_2d(5, 5, shift=shift))
    _same(tmat.sparse_helmholtz_3d(4, 3, 5, shift),
          jmat.sparse_helmholtz_3d(4, 3, 5, shift))
    c = tmat.sparse_helmholtz_2d(4, 4, shift)
    assert c.vals.dtype == jmat.sparse_helmholtz_2d(4, 4, shift).vals.dtype


@pytest.mark.parametrize("name,args", [
    ("laplacian_1d", (7,)), ("laplacian_2d", (4, 5)),
    ("laplacian_3d", (3, 4, 2)), ("helmholtz_1d", (6, 3.0)),
    ("helmholtz_2d", (4, 3, 2.0 - 1j)), ("helmholtz_3d", (2, 3, 4, 5.0))])
def test_dense_pde_overloads_match_reference(name, args):
    got = getattr(tmat, name)(*args, device="cpu")
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(getattr(jmat, name)(*args)))


@pytest.mark.parametrize("args", [(8, 8, 20.0), (7, 11, 13.0, 3, 2.0),
                                  (12, 5, 3.0, 0), (3, 3, 1.0)])
def test_helmholtz_pml_matches_reference_entry_for_entry(args):
    """The vectorised PML stencil equals the JAX loop's CSR exactly; it is
    not symmetric inside the band (the docstring's warning)."""
    A, ref = tmat.helmholtz_pml_2d(*args), jmat.helmholtz_pml_2d(*args)
    _same(A, ref)
    D = A.to_dense()
    if args[:3] == (8, 8, 20.0):
        np.testing.assert_allclose(np.abs(D - D.T).max(), 21.594283369555818,
                                   rtol=1e-12)


@pytest.mark.parametrize("dims,cutoff", [((7, 9), 8), ((12, 11), 8),
                                         ((6, 6, 6), 8), ((13, 7, 5), 1),
                                         ((2, 40), 4), ((5,), 3), ((1, 1), 8),
                                         ((64, 48), 8)])
def test_natural_nested_dissection_matches_reference(dims, cutoff):
    """The same permutation as the JAX ordering, and a permutation."""
    perm = natural_nested_dissection(dims, cutoff)
    np.testing.assert_array_equal(perm, jax_natural_nd(dims, cutoff))
    assert perm.dtype == np.int64
    assert np.array_equal(np.sort(perm), np.arange(int(np.prod(dims))))


def test_natural_nested_dissection_reduces_fill():
    """Mirrors test_sparse_ldl.py:44: the grid ordering beats the natural
    order's fill."""
    A = tmat.sparse_laplacian_2d(12, 12, scaled=False)
    nat = analyze(A, perm=np.arange(A.height))
    nnd = analyze(A, perm=natural_nested_dissection((12, 12)))
    assert nnd.nnz_factor < nat.nnz_factor


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.complex64, torch.complex128])
def test_type_helpers_match_reference(dtype):
    npdt = {torch.float32: np.float32, torch.float64: np.float64,
            torch.complex64: np.complex64,
            torch.complex128: np.complex128}[dtype]
    real = {np.float32: torch.float32, np.float64: torch.float64}
    assert core.real_type(dtype) == real[np.dtype(
        jtypes.real_type(npdt)).type]
    assert core.complex_type(dtype) == {
        np.complex64: torch.complex64, np.complex128: torch.complex128}[
            np.dtype(jtypes.complex_type(npdt)).type]
    assert core.is_complex(dtype) == bool(jtypes.is_complex(npdt))
    assert core.epsilon(dtype) == jtypes.epsilon(npdt)
    assert core.safe_min(dtype) == jtypes.safe_min(npdt)
    x = torch.tensor([1 + 2j, 3 - 1j]).to(dtype) if dtype.is_complex \
        else torch.tensor([1.0, -2.0], dtype=dtype)
    np.testing.assert_array_equal(core.conj_if(True, x).numpy(),
                                  np.asarray(jtypes.conj_if(True, x.numpy())))
    assert core.conj_if(False, x) is x


def test_working_dtype_policy():
    """Complex working dtypes are accepted; other dtypes are refused; the
    real engines refuse complex ones."""
    for dt in (torch.float32, torch.float64, torch.complex64,
               torch.complex128):
        assert core.working_dtype(dt) == dt
    assert core.working_dtype(np.complex64) == torch.complex64
    with pytest.raises(TypeError):
        core.working_dtype(torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        core.real_working_dtype(torch.complex128)
    assert core.residual_bound(torch.complex64, 10) == \
        core.residual_bound(torch.float32, 10)
