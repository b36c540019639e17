"""Parity of the port's sparse products and distributed sparse containers
(``elemental_tpu_torch.sparse.matmul``, ``.distsparse``) with the JAX
package on the CPU, mirroring the tests of ``tests/sparse/test_sparse.py``
that no earlier port file mirrors: ``multiply`` in every orientation, on a
``Graph`` and with β·Y, SpGEMM and its plan, the Galerkin product, and the
distributed half (SpMV, SpMM, transpose, ``change_nonzero_values``, CG,
orientations, ``dist_spgemm``, ``dist_galerkin``, ``DistMap``).  The JAX
side runs on the conftest's ``grid8`` (2×4 over forced host devices), the
port on a 2×4 grid over torch's CPU device, with the same seeded inputs.

The host plans are NumPy in both packages and are held bit-equal; values
are held to the JAX function's output within 1e-12 (float64) and 1e-5
(float32) of its largest entry.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from elemental_tpu import sparse as jsp
from elemental_tpu.lapack import cg as jcg
from elemental_tpu.matrices import sparse_laplacian_2d, sparse_laplacian_3d
from elemental_tpu.sparse import matmul as jmm
from elemental_tpu.sparse.distsparse import DistMap as JDistMap

from elemental_tpu_torch import sparse as tsp
from elemental_tpu_torch.core import Grid
from elemental_tpu_torch.lapack import cg as tcg

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5,
       np.dtype(np.complex128): 1e-12}


@pytest.fixture(scope="module")
def tgrid8():
    return Grid(devices=[CPU] * 8, height=2)


def rng(seed=17):
    return np.random.default_rng(seed)


def port(A, dtype=None):
    """The JAX package's SparseMatrix as the port's (same arrays)."""
    vals = A.vals if dtype is None else A.vals.astype(dtype)
    return tsp.SparseMatrix.from_arrays(A.height, A.width, A.rowptr,
                                        A.colind, vals)


def jax_matrix(A, dtype=None):
    vals = A.vals if dtype is None else A.vals.astype(dtype)
    return jsp.SparseMatrix(A.height, A.width, A.rowptr.copy(),
                            A.colind.copy(), vals)


def random_sparse(r, m, n, density=0.1, complex_=False):
    nnz = int(m * n * density)
    rows = r.integers(0, m, nnz)
    cols = r.integers(0, n, nnz)
    vals = r.standard_normal(nnz)
    if complex_:
        vals = vals + 1j * r.standard_normal(nnz)
    return jsp.SparseMatrix.from_coo(m, n, rows, cols, vals)


def npy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().resolve_conj().numpy()
    if isinstance(x, tsp.DistMultiVec):
        return x.to_numpy()
    return np.asarray(x)


def close(got, want, dtype=np.float64):
    got, want = npy(got), npy(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL[np.dtype(dtype)], err


def stack(blocks):
    return torch.stack([b.cpu() for b in blocks]).numpy()


# ---------------------------------------------------------------- multiply

@pytest.mark.parametrize("orientation", ["N", "T", "C"])
@pytest.mark.parametrize("complex_", [False, True])
def test_multiply_orientations_match_jax(orientation, complex_):
    r = rng(3)
    A = random_sparse(r, 25, 30, 0.15, complex_)
    m, n = (25, 30) if orientation == "N" else (30, 25)
    x = r.standard_normal(n) + (1j * r.standard_normal(n) if complex_ else 0)
    y = r.standard_normal(m)
    want = jmm.multiply(orientation, 2.0, A, jnp.asarray(x), -1.0,
                        jnp.asarray(y))
    got = tsp.multiply(orientation, 2.0, port(A), torch.from_numpy(x), -1.0,
                       torch.from_numpy(y))
    close(got, want, np.complex128 if complex_ else np.float64)
    dense = A.to_dense()
    op = {"N": dense, "T": dense.T, "C": dense.conj().T}[orientation]
    np.testing.assert_allclose(npy(got), 2.0 * op @ x - y, rtol=1e-12)


def test_multiply_graph_and_spmm_match_jax():
    r = rng(4)
    A = random_sparse(r, 50, 40)
    x = r.standard_normal(40)
    X = r.standard_normal((40, 7))
    g_j, g_t = A.graph(), port(A).graph()
    close(tsp.multiply("N", 1.0, g_t, torch.from_numpy(x)),
          jmm.multiply("N", 1.0, g_j, jnp.asarray(x)))
    np.testing.assert_allclose(
        npy(tsp.multiply("N", 1.0, g_t, torch.from_numpy(x))),
        (A.to_dense() != 0) @ x, rtol=1e-12)
    close(tsp.multiply("N", 0.5, port(A), torch.from_numpy(X)),
          jmm.multiply("N", 0.5, A, jnp.asarray(X)))
    # the device forms take the same call
    ell = port(A).device_ell(device=CPU, dtype=torch.float64)
    close(tsp.multiply("N", 1.0, ell, torch.from_numpy(X)),
          jmm.multiply("N", 1.0, A.device_ell(), jnp.asarray(X)))
    with pytest.raises(TypeError):
        tsp.multiply("N", 1.0, object(), torch.from_numpy(x))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_multiply_takes_device_and_dtype_from_x(dtype):
    r = rng(5)
    A = random_sparse(r, 20, 20)
    x = r.standard_normal(20).astype(dtype)
    got = tsp.multiply("N", 1.0, port(A), torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.device == CPU
    close(got, jmm.multiply("N", 1.0, jax_matrix(A, dtype), jnp.asarray(x)),
          dtype)


# ---------------------------------------------------------------- SpGEMM

def test_spgemm_vs_scipy_and_plan_bit_equal():
    r = rng(6)
    A = random_sparse(r, 30, 40, 0.1)
    B = random_sparse(r, 40, 25, 0.1)
    jp, tp = jmm.spgemm_plan(A, B), tsp.spgemm_plan(port(A), port(B))
    for name in ("a_idx", "b_idx", "c_idx"):
        assert np.array_equal(npy(getattr(tp, name)),
                              np.asarray(getattr(jp, name))), name
        assert getattr(tp, name).dtype == torch.int64
    assert tp.c_nnz == jp.c_nnz
    for name in ("rowptr", "colind"):
        assert np.array_equal(getattr(tp.c_struct, name),
                              getattr(jp.c_struct, name))
    C = tsp.spgemm(port(A), port(B), device=CPU)
    expect = (A.to_scipy() @ B.to_scipy()).toarray()
    np.testing.assert_allclose(C.to_dense(), expect, rtol=1e-10, atol=1e-12)
    close(C.vals, jmm.spgemm(A, B).vals)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spgemm_plan_reuse(dtype):
    """Fixed structure, changing values — the IPM per-iteration path."""
    r = rng(7)
    A = random_sparse(r, 20, 30, 0.15)
    B = random_sparse(r, 30, 20, 0.15)
    jp, tp = jmm.spgemm_plan(A, B), tsp.spgemm_plan(port(A), port(B))
    for _ in range(3):
        a2 = r.standard_normal(A.nnz).astype(dtype)
        b = B.vals.astype(dtype)
        got = tp.numeric(torch.from_numpy(a2), torch.from_numpy(b))
        assert got.dtype == torch.from_numpy(a2).dtype
        close(got, jp.numeric(jnp.asarray(a2), jnp.asarray(b)), dtype)
        A2 = A.change_nonzero_values(a2.astype(np.float64))
        np.testing.assert_allclose(
            tp.c_struct.change_nonzero_values(npy(got)).to_dense(),
            (A2.to_scipy() @ B.to_scipy()).toarray(),
            rtol=1e-10 if dtype == np.float64 else 1e-4,
            atol=1e-12 if dtype == np.float64 else 1e-5)


def test_spgemm_rejects_mismatched_shapes():
    r = rng(8)
    with pytest.raises(ValueError):
        tsp.spgemm_plan(port(random_sparse(r, 4, 5)),
                        port(random_sparse(r, 4, 5)))


def test_galerkin_adat_and_plan_bit_equal():
    """A·diag(d)·Aᵀ — BASELINE config #3."""
    r = rng(9)
    A = random_sparse(r, 25, 40, 0.12)
    d = np.abs(r.standard_normal(40)) + 0.1
    jp, tp = jmm.galerkin_plan(A), tsp.galerkin_plan(port(A))
    for name in ("a_idx", "at_idx", "d_idx", "c_idx"):
        assert np.array_equal(npy(getattr(tp, name)),
                              np.asarray(getattr(jp, name))), name
    assert np.array_equal(tp.c_struct.colind, jp.c_struct.colind)
    C = tsp.syrk_sparse(port(A), d, device=CPU)
    close(C.vals, jmm.syrk_sparse(A, d).vals)
    expect = A.to_dense() @ np.diag(d) @ A.to_dense().T
    np.testing.assert_allclose(C.to_dense(), expect, rtol=1e-10, atol=1e-12)
    # plan reuse with a new d, and d defaulting to ones
    d2 = np.abs(r.standard_normal(40)) + 0.1
    close(tp.numeric(torch.from_numpy(A.vals), torch.from_numpy(d2)),
          jp.numeric(jnp.asarray(A.vals), jnp.asarray(d2)))
    close(tsp.syrk_sparse(port(A), device=CPU).vals,
          jmm.syrk_sparse(A).vals)


# ------------------------------------------------------- distributed half

PLAN_FIELDS = ("lrows", "lcols", "lvals", "send_idx")


def dist_pair(A, grid8, tgrid8, dtype=None):
    jA = jsp.DistSparseMatrix.from_sparse(jax_matrix(A, dtype), grid8)
    tA = tsp.DistSparseMatrix.from_sparse(port(A, dtype), tgrid8)
    return jA, tA


def assert_plan_equal(jA, tA):
    for name in ("rs", "cs", "halo", "nnz", "height", "width"):
        assert getattr(tA, name) == getattr(jA, name), name
    assert np.array_equal(tA.val_slot, jA.val_slot)
    assert tA.slots == jA.lvals.shape[1]
    for name in PLAN_FIELDS:
        got, want = stack(getattr(tA, name)), np.asarray(getattr(jA, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("case", ["lap16", "lap6x3", "rand100x75"])
def test_dist_plan_bit_equal(grid8, tgrid8, case):
    A = {"lap16": lambda: sparse_laplacian_2d(16, 16),
         "lap6x3": lambda: sparse_laplacian_3d(6, 6, 6),
         "rand100x75": lambda: jsp.SparseMatrix.from_scipy(
             sp.random(100, 75, density=0.08, format="csr",
                       random_state=3))}[case]()
    jA, tA = dist_pair(A, grid8, tgrid8)
    assert_plan_equal(jA, tA)
    assert all(t.device == d for t, d in
               zip(tA.lvals, tgrid8.devices.ravel()))
    assert tA.lrows[0].dtype == torch.int32 and tA.shape == A.shape


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_dist_spmv_and_spmm(grid8, tgrid8, dtype):
    """Distributed SpMV over the 2×4 grid against the JAX package."""
    r = rng(10)
    A = sparse_laplacian_2d(16, 16)
    jA, tA = dist_pair(A, grid8, tgrid8, dtype)
    x = r.standard_normal(256).astype(dtype)
    close(tA.matvec(torch.from_numpy(x)), jA.matvec(jnp.asarray(x)), dtype)
    A3 = sparse_laplacian_3d(6, 6, 6)
    jA3, tA3 = dist_pair(A3, grid8, tgrid8, dtype)
    X = r.standard_normal((216, 4)).astype(dtype)
    got = tA3.matmat(torch.from_numpy(X))
    close(got, jA3.matmat(jnp.asarray(X)), dtype)
    assert got.dtype == torch.from_numpy(X).dtype


def test_dist_spmv_transpose(grid8, tgrid8):
    """The reversed halo exchange (reference Multiply(TRANSPOSE,
    DistSparseMatrix, ...))."""
    r = rng(11)
    R = sp.random(100, 75, density=0.08, format="csr", random_state=3)
    jA, tA = dist_pair(jsp.SparseMatrix.from_scipy(R), grid8, tgrid8)
    x = r.standard_normal(100)
    close(tA.matvec_transpose(x), jA.matvec_transpose(x))
    np.testing.assert_allclose(npy(tA.matvec_transpose(x)), R.T @ x,
                               rtol=1e-10, atol=1e-12)
    X = r.standard_normal((100, 3))
    close(tA.matmat_transpose(X), jA.matmat_transpose(X))


def test_dist_multivec_blocks_in_blocks_out(grid8, tgrid8):
    """A DistMultiVec goes through as [VC,*] blocks; a product's blocks feed
    the next product; a height the grid does not divide is replicated with
    the JAX package's warning."""
    r = rng(12)
    A = sparse_laplacian_2d(16, 16)
    jA, tA = dist_pair(A, grid8, tgrid8)
    x = r.standard_normal(256)
    xv = tsp.DistMultiVec.from_array(x, tgrid8)
    assert xv.height == 256 and xv.width == 1 and not xv.replicated
    assert [b.shape[0] for b in xv.blocks] == [32] * 8
    y = tA.matvec(xv)
    assert isinstance(y, tsp.DistMultiVec)
    yy = tA.matvec(y)
    close(yy, jA.matvec(jA.matvec(jnp.asarray(x))))
    with pytest.warns(RuntimeWarning, match="REPLICATED"):
        rv = tsp.DistMultiVec.from_array(r.standard_normal((100, 2)), tgrid8)
    with pytest.warns(RuntimeWarning, match="REPLICATED"):
        jsp.DistMultiVec.from_array(np.zeros((100, 2)), grid8)
    assert rv.replicated and rv.width == 2 and rv.height == 100
    R = sp.random(75, 100, density=0.08, format="csr", random_state=4)
    jR, tR = dist_pair(jsp.SparseMatrix.from_scipy(R), grid8, tgrid8)
    close(tR.matmat(rv), jR.matmat(jnp.asarray(rv.to_numpy())))


def test_dist_change_nonzero_values(grid8, tgrid8):
    r = rng(13)
    A = sparse_laplacian_2d(8, 8)
    jA, tA = dist_pair(A, grid8, tgrid8)
    newvals = r.standard_normal(A.nnz)
    jA2, tA2 = (jA.change_nonzero_values(newvals),
                tA.change_nonzero_values(newvals))
    assert np.array_equal(stack(tA2.lvals), np.asarray(jA2.lvals))
    assert np.array_equal(tA2.host.vals, newvals)
    x = r.standard_normal(64)
    close(tA2.matvec(x), jA2.matvec(jnp.asarray(x)))
    # complex values make the matrix complex, as the JAX package's would be
    cvals = newvals + 1j * r.standard_normal(A.nnz)
    tA3 = tA.change_nonzero_values(cvals)
    assert tA3.dtype == torch.complex128
    np.testing.assert_allclose(
        npy(tA3.matvec(x)), A.change_nonzero_values(cvals).to_dense() @ x,
        rtol=1e-12)


def test_cg_on_sparse_laplacian(grid8, tgrid8):
    """SURVEY §7's end-to-end slice: the 2-D Laplacian row-partitioned over
    the grid, solved by CG with the residual checked."""
    r = rng(14)
    A = sparse_laplacian_2d(16, 16)
    jA, tA = dist_pair(A, grid8, tgrid8)
    b = r.standard_normal(256)
    got = tcg(lambda v: tA.matvec(v), torch.from_numpy(b), tol=1e-10,
              max_iters=2000)
    want = jcg(lambda v: jA.matvec(v), jnp.asarray(b), tol=1e-10,
               max_iters=2000)
    x = npy(got.x)
    assert np.linalg.norm(A.to_dense() @ x - b) / np.linalg.norm(b) < 1e-8
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(x, np.asarray(want.x), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("orientation", ["N", "T", "C"])
def test_dist_multiply_orientations(grid8, tgrid8, orientation):
    r = rng(15)
    A = sparse_laplacian_2d(10, 10)
    A = A.change_nonzero_values(A.vals * (1 + 0.1 * r.standard_normal(A.nnz)))
    jA, tA = dist_pair(A, grid8, tgrid8)
    x = r.standard_normal(100)
    y = r.standard_normal(100)
    close(tsp.multiply(orientation, 2.0, tA, x, 0.5, y),
          jmm.multiply(orientation, 2.0, jA, x, 0.5, jnp.asarray(y)))
    with pytest.warns(RuntimeWarning, match="REPLICATED"):   # 100 rows
        xv = tsp.DistMultiVec.from_array(x, tgrid8)
        yv = tsp.DistMultiVec.from_array(y, tgrid8)
    out = tsp.multiply(orientation, 2.0, tA, xv, 0.5, yv)
    assert isinstance(out, tsp.DistMultiVec)
    op = A.to_dense() if orientation == "N" else A.to_dense().T
    np.testing.assert_allclose(out.to_numpy(), 2.0 * op @ x + 0.5 * y,
                               rtol=1e-10)
    stripped = tA.change_nonzero_values(A.vals)
    stripped.host = None
    if orientation == "C":
        with pytest.raises(ValueError, match="host CSR"):
            tsp.multiply("C", 1.0, stripped, x)


def test_dist_spgemm_matches_jax(grid8, tgrid8):
    """Distributed SpGEMM == the JAX package's, and == single-device
    spgemm, on rectangular, non-divisible shapes; its plan bit-equal."""
    Ra = sp.random(83, 61, density=0.1, format="csr", random_state=5)
    Rb = sp.random(61, 47, density=0.12, format="csr", random_state=6)
    A, B = (jsp.SparseMatrix.from_scipy(R) for R in (Ra, Rb))
    jA, tA = dist_pair(A, grid8, tgrid8)
    jB, tB = dist_pair(B, grid8, tgrid8)
    jp, tp = jmm.dist_spgemm_plan(jA, jB), tsp.dist_spgemm_plan(tA, tB)
    for name in ("halo", "emul", "ec"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("send_idx", "a_idx", "w_idx", "c_idx"):
        got, want = stack(getattr(tp, name)), np.asarray(getattr(jp, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert np.array_equal(tp.c_host.colind, jp.c_host.colind)
    assert_plan_equal(jp.c_template, tp.c_template)
    dC, jC = tp.product(tA, tB), jp.product(jA, jB)
    close(stack(dC.lvals), np.asarray(jC.lvals))
    close(dC.host.vals, jC.host.vals)
    C = tsp.spgemm(port(A), port(B), device=CPU)
    np.testing.assert_allclose(dC.host.to_dense(), C.to_dense(),
                               rtol=1e-10, atol=1e-12)
    x = rng(16).standard_normal(47)
    close(dC.matvec(x), jC.matvec(jnp.asarray(x)))
    close(stack(tsp.dist_spgemm(tA, tB).lvals), np.asarray(jC.lvals))


def test_dist_galerkin_matches_syrk(grid8, tgrid8):
    r = rng(18)
    Ra = sp.random(40, 64, density=0.15, format="csr", random_state=7)
    A = jsp.SparseMatrix.from_scipy(Ra)
    d = np.abs(r.standard_normal(64)) + 0.5
    jA, tA = dist_pair(A, grid8, tgrid8)
    dC = tsp.dist_galerkin(tA, d)
    close(dC.host.vals, jmm.dist_galerkin(jA, d).host.vals)
    np.testing.assert_allclose(dC.host.to_dense(),
                               tsp.syrk_sparse(port(A), d,
                                               device=CPU).to_dense(),
                               rtol=1e-10, atol=1e-12)
    stripped = tsp.DistSparseMatrix.from_sparse(port(A), tgrid8)
    stripped.host = None
    with pytest.raises(ValueError, match="host CSR"):
        tsp.dist_galerkin(stripped, d)


def test_distmap_translate_device(grid8, tgrid8):
    """DistMap.translate_device: the lookup in the positions' blocks equals
    the host translate and the JAX package's (reference
    DistMap::Translate, decl.hpp:28-40)."""
    r = np.random.default_rng(3)
    n = 103
    perm = r.permutation(n)
    jm, tm = JDistMap(perm), tsp.DistMap(perm)
    dm = tm.to(tgrid8)
    assert len(dm._blocks) == 8 and dm._blocks[0].dtype == torch.int64
    idx = r.integers(0, n, 57)
    got = dm.translate_device(torch.from_numpy(idx))
    assert got.dtype == torch.int64
    assert np.array_equal(npy(got), tm.translate(idx))
    assert np.array_equal(npy(got),
                          np.asarray(jm.device(grid8).translate_device(idx)))
    assert np.array_equal(npy(tm.translate_device(idx)), tm.translate(idx))
    # inverse round trip
    assert np.array_equal(tm.inverse().translate(tm.translate(np.arange(n))),
                          np.arange(n))
    assert len(tm) == n


def test_dist_graph_keeps_pattern_and_grid(tgrid8):
    g = tsp.Graph.from_edges(5, 5, [0, 1, 2, 0], [1, 2, 3, 4])
    dg = tsp.DistGraph.from_graph(g, tgrid8)
    assert dg.grid is tgrid8 and dg.num_edges == 4
    assert list(dg.neighbors(0)) == [1, 4]
    assert isinstance(dg, tsp.Graph)
