"""Parity of the port's SpMV slice (DIA, the stencil plan and K3's plain
version, RCM, ``plan_spmv``) with the JAX package, on the CPU, from the same
NumPy inputs.  The JAX stencil kernel runs in Pallas interpret mode, as
``tests/sparse/test_dia_stencil.py`` and ``test_auto_plan.py`` run it.

The CUDA kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from elemental_tpu import matrices as jax_matrices
from elemental_tpu.kernels.spmv import (plan_stencil_spmv as
                                        jax_plan_stencil,
                                        stencil_spmv as jax_stencil_spmv)
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse import plan_spmv as jax_plan_spmv
from elemental_tpu.sparse import to_dia as jax_to_dia
from elemental_tpu.sparse_direct import native as jax_native
from elemental_tpu.sparse_direct.ordering import (
    reverse_cuthill_mckee as jax_rcm)

from elemental_tpu_torch import matrices
from elemental_tpu_torch.kernels.spmv import (StencilPlan, plan_stencil_spmv,
                                              stencil_spmv,
                                              stencil_spmv_from_csr,
                                              stencil_spmv_plain)
from elemental_tpu_torch.sparse import (DIAMatrix, ELLMatrix, SparseMatrix,
                                        best_device_format, plan_spmv, to_dia)
from elemental_tpu_torch.sparse_direct import reverse_cuthill_mckee

torch.set_num_threads(1)
F64 = torch.float64


def _jax(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


def _coo(n, offs, rng, width=None):
    """A banded n×width matrix with the diagonals ``offs``."""
    width = n if width is None else width
    rows, cols, vals = [], [], []
    for off in offs:
        r = np.arange(max(0, -off), min(n, width - off))
        rows.append(r)
        cols.append(r + off)
        vals.append(rng.standard_normal(r.shape[0]))
    return SparseMatrix.from_coo(n, width, np.concatenate(rows),
                                 np.concatenate(cols), np.concatenate(vals))


def _scrambled_banded(rng, n=512, bw=6):
    """``test_auto_plan.py``'s symmetric banded matrix, scrambled."""
    offs = range(-bw, bw + 1)
    S = sp.diags([rng.standard_normal(n) for _ in offs], list(offs),
                 shape=(n, n), format="csr")
    S = (S + S.T).astype(np.float32)
    p = rng.permutation(n)
    return SparseMatrix.from_scipy(S[p][:, p].tocsr())


@pytest.mark.parametrize("name,args", [
    ("sparse_laplacian_1d", (7,)), ("sparse_laplacian_2d", (5, 6)),
    ("sparse_helmholtz_2d", (5, 6, 3.5)),
    ("sparse_helmholtz_3d", (3, 4, 5, 2.0))])
def test_generators_match_reference(name, args):
    A = getattr(matrices, name)(*args)
    J = getattr(jax_matrices, name)(*args)
    assert A.shape == J.shape
    np.testing.assert_array_equal(A.rowptr, J.rowptr)
    np.testing.assert_array_equal(A.colind, J.colind)
    np.testing.assert_array_equal(A.vals, J.vals)


def test_to_dia_roundtrip():
    A = matrices.sparse_laplacian_2d(6, 6, scaled=False)
    dia, jdia = to_dia(A), jax_to_dia(_jax(A))
    assert dia.offsets == jdia.offsets and len(dia.offsets) == 5
    np.testing.assert_array_equal(dia.diags, np.asarray(jdia.diags))
    x = np.random.default_rng(31).standard_normal(36)
    y = dia.to("cpu", F64).matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, np.asarray(jdia.device().matvec(
        jnp.asarray(x))), rtol=1e-12)
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-12)
    X = np.random.default_rng(32).standard_normal((36, 3))
    Y = dia.to("cpu", F64).matmat(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, np.asarray(jdia.device().matmat(
        jnp.asarray(X))), rtol=1e-12)


def test_to_dia_rejects_unstructured():
    rng = np.random.default_rng(31)
    nnz = 500
    A = SparseMatrix.from_coo(100, 100, rng.integers(0, 100, nnz),
                              rng.integers(0, 100, nnz),
                              rng.standard_normal(nnz))
    assert to_dia(A) is None and jax_to_dia(_jax(A)) is None
    assert isinstance(best_device_format(A, device="cpu", dtype=F64),
                      ELLMatrix)
    L = matrices.sparse_laplacian_2d(4, 4)
    assert isinstance(best_device_format(L, device="cpu", dtype=F64),
                      DIAMatrix)


def _stencil_case(case):
    rng = np.random.default_rng(31)
    if case == "banded":
        return _coo(200, [-13, -1, 0, 2, 17], rng), 32
    if case == "3d_5":
        return matrices.sparse_laplacian_3d(5, 5, 5, scaled=False), 32
    n1, n2 = {"2d_12x12": (12, 12), "2d_8x16": (8, 16),
              "2d_16x16": (16, 16)}[case]
    return matrices.sparse_laplacian_2d(n1, n2, scaled=False), 16


@pytest.mark.parametrize("case", ["2d_12x12", "2d_8x16", "3d_5", "banded",
                                  "2d_16x16"])
def test_stencil_matches_pallas(case):
    """The port's plan and K3's plain version against the JAX halo-panel
    Pallas kernel (interpret mode, tile_rows=8), float64."""
    A, cols = _stencil_case(case)
    dia = to_dia(A)
    plan = plan_stencil_spmv(dia.offsets, dia.diags, A.height, cols=cols)
    jplan = jax_plan_stencil(dia.offsets, dia.diags, A.height, cols=cols)
    assert plan.nnz == jplan.nnz
    x = np.random.default_rng(7).standard_normal(A.width)
    y = stencil_spmv(plan, torch.from_numpy(x)).numpy()
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jax_stencil_spmv(jplan, jnp.asarray(x),
                                         tile_rows=8))
    np.testing.assert_allclose(y, yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-10)


def test_from_reference_carries_the_plan():
    A = matrices.sparse_laplacian_3d(5, 5, 5, scaled=False)
    dia = to_dia(A)
    jplan = jax_plan_stencil(dia.offsets, dia.diags, A.height, cols=32)
    plan = StencilPlan.from_reference(jplan)
    own = plan_stencil_spmv(dia.offsets, dia.diags, A.height, cols=32)
    assert plan.offsets == own.offsets and plan.nnz == own.nnz
    assert torch.equal(plan.offsets_t, own.offsets_t)
    assert torch.equal(plan.weights, own.weights)
    x = np.random.default_rng(8).standard_normal(A.width)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(jax_stencil_spmv(jplan, jnp.asarray(x),
                                         tile_rows=8))
    y = stencil_spmv(plan.to("cpu", F64), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, yj, rtol=1e-12)
    assert stencil_spmv_from_csr(A, cols=32).offsets == own.offsets


def test_halo_rule_matches_reference():
    """A diagonal whose lane shift exceeds max_halo gives no plan, in both
    packages."""
    A = _coo(600, [-300, 0, 1], np.random.default_rng(3))
    dia = to_dia(A)
    for mh in (8, 512):
        got = plan_stencil_spmv(dia.offsets, dia.diags, A.height, cols=1024,
                                max_halo=mh)
        ref = jax_plan_stencil(dia.offsets, dia.diags, A.height, cols=1024,
                               max_halo=mh)
        assert (got is None) == (ref is None)
    assert plan_stencil_spmv(dia.offsets, dia.diags, 600, max_halo=8) is None


def test_rcm_matches_reference():
    A = _scrambled_banded(np.random.default_rng(1))
    perm = reverse_cuthill_mckee(A)
    assert sorted(perm.tolist()) == list(range(A.height))
    if jax_native.has_rcm():
        np.testing.assert_array_equal(perm, jax_rcm(_jax(A)))
    c = A.to_scipy()[perm][:, perm].tocoo()
    assert int(np.abs(c.row - c.col).max()) <= 13


def _plan_case(case, rng):
    """The matrices of ``tests/sparse/test_auto_plan.py`` (float32)."""
    if case == "laplacian":
        A = matrices.sparse_laplacian_2d(24, 24, scaled=False)
        return SparseMatrix.from_scipy(A.to_scipy().astype(np.float32)), {}
    if case == "scrambled_banded":
        return _scrambled_banded(rng), {}
    if case in ("unstructured", "unstructured_csr"):
        n, k = 256, 4
        S = sp.csr_matrix((rng.standard_normal(n * k).astype(np.float32),
                           (np.repeat(np.arange(n), k),
                            rng.integers(0, n, n * k))), shape=(n, n))
        kw = {"pallas_gather": case == "unstructured"}
        return SparseMatrix.from_scipy(S), kw
    S = sp.random(96, 128, density=0.05, format="csr", random_state=4,
                  dtype=np.float32)
    return SparseMatrix.from_scipy(S), {}


@pytest.mark.parametrize("case,kind", [
    ("laplacian", "stencil"), ("scrambled_banded", "stencil_rcm"),
    ("unstructured", "gather_csr"), ("unstructured_csr", "csr"),
    ("rectangular", "gather_csr")])
def test_plan_spmv_matches_reference(case, kind):
    """Same kind (and perm) as the JAX planner; y in float32 against the
    JAX plan (interpret mode) and scipy."""
    rng = np.random.default_rng({"laplacian": 0, "scrambled_banded": 1,
                                 "rectangular": 3}.get(case, 2))
    A, kw = _plan_case(case, rng)
    plan = plan_spmv(A, cols=128, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # the TPU note
        jplan = jax_plan_spmv(_jax(A), cols=128, **kw)
    assert plan.kind == jplan.kind == kind
    if kind == "stencil_rcm" and jax_native.has_rcm():
        np.testing.assert_array_equal(plan.perm, jplan.perm)
        np.testing.assert_array_equal(plan.iperm, jplan.iperm)
    x = rng.standard_normal(A.width).astype(np.float32)
    xp = plan.to_plan_space(x)
    y = plan.from_plan_space(plan.matvec(torch.from_numpy(xp)).numpy())
    with pltpu.force_tpu_interpret_mode():
        yj = jplan.from_plan_space(np.asarray(jplan.matvec(
            jnp.asarray(jplan.to_plan_space(x)))))
    expect = A.to_scipy() @ x
    atol = 1e-5 * max(1.0, np.abs(expect).max())
    assert y.dtype == np.float32
    np.testing.assert_allclose(y, expect, atol=atol)
    np.testing.assert_allclose(y, yj, atol=atol)
    # the permutation boundary also takes tensors
    yt = plan.from_plan_space(plan.matvec(plan.to_plan_space(
        torch.from_numpy(x))))
    np.testing.assert_array_equal(yt.numpy(), y)


def test_stream_bytes_accounting():
    A = matrices.sparse_laplacian_2d(16, 16, scaled=False)
    A = SparseMatrix.from_scipy(A.to_scipy().astype(np.float32))
    plan = plan_spmv(A, cols=128)
    assert plan.stream_bytes == (5 + 2) * 256 * 4
    assert plan.to(dtype=F64).stream_bytes == (5 + 2) * 256 * 8
    U, _ = _plan_case("unstructured", np.random.default_rng(2))
    g = plan_spmv(U)
    n, nnz = U.height, U.nnz
    assert g.stream_bytes == nnz * (4 + 4) + (n + 1) * 4 + 2 * n * 4
    assert plan_spmv(U, pallas_gather=False).stream_bytes > 0


def test_nonsquare_banded_is_right():
    """Deliberate difference: on a 96×128 banded matrix both planners pick
    'stencil'; the reference's halo panel then cannot take the 128-entry x,
    while the port's kernel reads x within [0, width) and is right."""
    A = _coo(96, [-3, 0, 1, 5, 32], np.random.default_rng(4), width=128)
    plan = plan_spmv(A)
    assert plan.kind == jax_plan_spmv(_jax(A)).kind == "stencil"
    x = np.random.default_rng(5).standard_normal(128)
    y = plan.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A.to_scipy() @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(stencil_spmv_plain(plan.stencil,
                                                  torch.from_numpy(x)), y)
    with pytest.raises((TypeError, ValueError)):
        with pltpu.force_tpu_interpret_mode():
            jax_plan_spmv(_jax(A)).matvec(jnp.asarray(x))


def test_bridged_is_not_ported():
    """``kind='bridged'`` plans the bridged tier (K7; its parity tests are
    in ``test_torch_bridged.py``) even where 'auto' picks a stencil; an
    unknown kind is refused."""
    A = matrices.sparse_laplacian_2d(4, 4)
    plan = plan_spmv(A, kind="bridged")
    assert plan.kind == "bridged" and plan.stencil is None
    x = np.random.default_rng(0).standard_normal(A.width)
    np.testing.assert_allclose(plan.matvec(torch.from_numpy(x)).numpy(),
                               A.to_scipy() @ x, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        plan_spmv(A, kind="ell")
