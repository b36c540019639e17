"""Parity of the port's complex sparse-direct tier with the JAX package, on
the CPU in complex128 (complex64 against its bound), from the same NumPy
inputs: complex-symmetric LDLᵀ of damped Helmholtz (the reference's
``examples/lapack_like/Helmholtz.cpp`` scenario) and Hermitian LDLᴴ, and
HPD Cholesky, of a magnetic Laplacian.

The JAX package's Hermitian value map is right only where every pair
(i,j)/(j,i) meets the permuted lower triangle first in CSR order (the
reversed natural order here); the port is held to the JAX package there and
to a dense solve under every ordering (ROADMAP.md, queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elemental_tpu.matrices import (sparse_helmholtz_2d as jax_helmholtz_2d,
                                    sparse_helmholtz_3d as jax_helmholtz_3d)
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse_direct import SparseLDLFactorization as JaxLDL
from elemental_tpu.sparse_direct.numeric import factor as jax_factor
from elemental_tpu.sparse_direct.ordering import (
    nested_dissection as jax_nested_dissection)
from elemental_tpu.sparse_direct.symbolic import analyze as jax_analyze

from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                    extend_add_plain)
from elemental_tpu_torch.matrices import (sparse_helmholtz_2d,
                                          sparse_helmholtz_3d,
                                          sparse_laplacian_2d)
from elemental_tpu_torch.sparse import SparseMatrix
from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                               analyze, build_ea_plan, factor,
                                               from_reference,
                                               natural_nested_dissection)

torch.set_num_threads(1)
C128 = torch.complex128
TOL = 1e-10
SHIFT = 30.0 * (1 + 0.3j)           # damped Helmholtz: ω²(1 + iγ)


def magnetic_laplacian(n1, n2, phi=1 / 8, sigma=0.5):
    """The unscaled n1×n2 grid Laplacian in the Landau gauge, flux ``phi``
    a plaquette: the edges along axis 0 carry e^{±2πi·phi·j} (j the index
    along axis 1); minus ``sigma`` on the diagonal.  Hermitian."""
    A = sparse_laplacian_2d(n1, n2, scaled=False)
    r, c = A.row_ids(), A.colind
    phase = np.exp(2j * np.pi * phi * (r % n2))
    v = A.vals.astype(np.complex128)
    v = np.where(c - r == n2, v * phase, v)
    v = np.where(r - c == n2, v * phase.conj(), v)
    v = np.where(r == c, v - sigma, v)
    return SparseMatrix.from_arrays(A.height, A.width, A.rowptr, A.colind, v)


def _jax_matrix(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _rhs(n, k=None, seed=9):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _ordering(A, dims, name):
    if name == "nd":
        return jax_nested_dissection(_jax_matrix(A), cutoff=16)
    if name == "natural_nd":
        return natural_nested_dissection(dims)
    if name == "reversed":
        return np.arange(A.height)[::-1].copy()
    return np.arange(A.height)


MATRICES = {
    "helmholtz_2d": ((12, 11), lambda: sparse_helmholtz_2d(12, 11, SHIFT)),
    "helmholtz_3d": ((6, 6, 6), lambda: sparse_helmholtz_3d(6, 6, 6, SHIFT)),
    "magnetic_2d": ((12, 11), lambda: magnetic_laplacian(12, 11)),
}

# name: (matrix, ordering, hermitian, spd, panel_blocksize) — orderings
# where the JAX package's value map is right.  The 3-D tops eliminate 36
# columns, so the JAX package takes its blocked front kernel there (the
# port takes it on every level); the Hermitian LDL takes it everywhere with
# panels of 4
PARITY_CASES = {
    "helmholtz_2d_nd": ("helmholtz_2d", "nd", False, False, 32),
    "helmholtz_2d_natural_nd": ("helmholtz_2d", "natural_nd", False, False,
                                32),
    "helmholtz_3d_nd": ("helmholtz_3d", "nd", False, False, 32),
    "helmholtz_3d_natural_nd": ("helmholtz_3d", "natural_nd", False, False,
                                32),
    "magnetic_ldl_reversed": ("magnetic_2d", "reversed", True, False, 4),
    "magnetic_hpd_reversed": ("magnetic_2d", "reversed", True, True, 32),
}


def _jax_outputs(symb, vals, b, conjugate, spd, nb):
    """The JAX factor and everything the tests read of it, in one compiled
    program (one compile a case)."""
    def run(v, b):
        num = jax_factor(symb, v, conjugate=conjugate, dtype=jnp.complex128,
                         spd=spd, panel_blocksize=nb)
        ctx = num.solve_context()
        return dict(pool=num.pool, d=num.d, x=num.solve(b), ctx=ctx,
                    x_ctx=num.solve(b, ctx), inertia=num.inertia(),
                    **{f"l{int(adj)}": num.multiply_with_l(b, adj)
                       for adj in (False, True)})
    return jax.jit(run)(jnp.asarray(vals), jnp.asarray(b))


@pytest.fixture(scope="module", params=sorted(PARITY_CASES))
def factor_pair(request):
    """(A, b, the JAX package's outputs, the port's factor), the two
    factors from identical plans."""
    mname, order, herm, spd, nb = PARITY_CASES[request.param]
    dims, make = MATRICES[mname]
    A = make()
    b = _rhs(A.height)
    jsymb = jax_analyze(_jax_matrix(A), perm=_ordering(A, dims, order))
    host = from_reference(jsymb, A)
    ref = _jax_outputs(jsymb, A.vals, b, herm, spd, nb)
    tnum = factor(host.to("cpu"), A.vals, ea_plan=build_ea_plan(host).to(
        "cpu"), dtype=C128, conjugate=herm, spd=spd, panel_blocksize=nb)
    return A, b, ref, tnum


def test_pool_and_d_match_reference(factor_pair):
    """The whole pool (panels, pivots, Schur blocks) and d."""
    _, _, ref, tnum = factor_pair
    assert tnum.pool.dtype == C128
    assert _rel(tnum.pool.numpy(), ref["pool"]) <= TOL
    assert _rel(tnum.d.numpy(), ref["d"]) <= TOL


def test_solves_match_reference(factor_pair):
    """solve, the panel inverses, the solve through them (whose backward
    step is conj(L⁻ᵀ) when Hermitian), multiply_with_l both ways and the
    inertia against the JAX factor; solves of one and three right-hand
    sides against a dense solve."""
    A, b, ref, tnum = factor_pair
    x = tnum.solve(b).numpy()
    assert _rel(x, ref["x"]) <= TOL
    assert _rel(x, np.linalg.solve(A.to_dense(), b)) <= TOL
    B = _rhs(A.height, 3)
    assert _rel(tnum.solve(B).numpy(), np.linalg.solve(A.to_dense(), B)) \
        <= TOL
    tctx = tnum.solve_context()
    for lj, lt in zip(ref["ctx"], tctx):
        assert _rel(lt.numpy(), lj) <= TOL
    assert _rel(tnum.solve(b, tctx).numpy(), ref["x_ctx"]) <= TOL
    # both packages' context solves agree with their substitution
    assert _rel(ref["x_ctx"], ref["x"]) <= TOL
    for adjoint in (False, True):
        assert _rel(tnum.multiply_with_l(b, adjoint).numpy(),
                    ref[f"l{int(adjoint)}"]) <= TOL
    assert tnum.inertia() == tuple(int(v) for v in ref["inertia"])


@pytest.mark.parametrize("case", ["helmholtz_2d_natural_nd",
                                  "magnetic_ldl_reversed"])
def test_facade_matches_reference(case):
    """The facade end to end against the JAX facade (complex128 under x64):
    solve, the refined solve against a dense solve, the members the JAX
    facade has, and a refactor with new values."""
    mname, order, herm, spd, _ = PARITY_CASES[case]
    dims, make = MATRICES[mname]
    A = make()
    perm = _ordering(A, dims, order)
    b = _rhs(A.height)
    f = SparseLDLFactorization(device="cpu", dtype=C128, spd=spd)
    assert not f.initialized
    f.initialize(A, hermitian=herm, perm=perm)
    assert f.initialized and not f.factored
    f.factor()
    j = JaxLDL(spd=spd)
    j.initialize(_jax_matrix(A), hermitian=herm, perm=perm)
    j.factor()
    assert f.factored and f.hermitian == j.hermitian == herm
    x = f.solve(b).numpy()
    assert _rel(x, j.solve(jnp.asarray(b))) <= TOL
    assert _rel(f.diagonal().numpy(), j.diagonal()) <= TOL
    assert f.factor_nnz() == j.factor_nnz()
    assert f.residual_bound() == j.residual_bound()
    xr = f.solve_with_iterative_refinement(b, iters=2).numpy()
    assert _rel(xr, np.linalg.solve(A.to_dense(), b)) <= TOL
    r = np.linalg.norm(A.to_scipy() @ xr - b) / np.linalg.norm(b)
    assert r < f.residual_bound()
    new = A.vals * 1.5
    f.change_nonzero_values(new)
    j.change_nonzero_values(new)
    assert _rel(f.solve(b).numpy(), j.solve(jnp.asarray(b))) <= TOL


@pytest.mark.parametrize("spd", [False, True])
@pytest.mark.parametrize("order", ["nd", "natural_nd", "natural"])
def test_hermitian_matches_dense_under_every_ordering(order, spd):
    """A deliberate difference.  The JAX package assembles the first of
    (i,j)/(j,i) in CSR order without conjugating it where it lies above the
    permuted diagonal, so its LDLᴴ factors another matrix: on this 132-node
    magnetic Laplacian that value map solves to 5.7 (nested dissection),
    6.7 (natural nested dissection) and 0.97 (natural order) relative to a
    dense solve, and is right only in the reversed natural order
    (``tools/hermitian_probe.py --value-map``).  The port conjugates those
    entries (``LevelPlan.asm_conj``) and solves to a dense solve's accuracy
    under every ordering."""
    A = magnetic_laplacian(12, 11)
    perm = _ordering(A, (12, 11), order)
    f = SparseLDLFactorization(device="cpu", dtype=C128, spd=spd)
    f.initialize(A, hermitian=True, perm=perm).factor()
    b = _rhs(A.height, 2)
    assert _rel(f.solve(b).numpy(), np.linalg.solve(A.to_dense(), b)) <= TOL
    host = f.symb
    assert any(bool(lev.asm_conj.any()) for lev in host.levels)
    if order == "nd" and not spd:
        # the reference fault this repairs, pinned where it shows
        j = JaxLDL()
        j.initialize(_jax_matrix(A), hermitian=True, perm=perm)
        j.factor()
        xj = np.asarray(j.solve(jnp.asarray(b[:, 0])))
        assert _rel(xj, np.linalg.solve(A.to_dense(), b[:, 0])) > 1e-3


def test_hermitian_needs_the_value_map():
    """A plan copied from the JAX package without its matrix has no
    Hermitian value map: a Hermitian factor refuses it, a complex-symmetric
    one does not need it."""
    A = magnetic_laplacian(6, 5)
    host = from_reference(jax_analyze(_jax_matrix(A),
                                      perm=np.arange(A.height)))
    assert all(lev.asm_conj is None for lev in host.levels)
    kw = dict(ea_plan=build_ea_plan(host).to("cpu"), dtype=C128)
    with pytest.raises(ValueError, match="value map"):
        factor(host.to("cpu"), A.vals, conjugate=True, **kw)
    factor(host.to("cpu"), A.vals, conjugate=False, **kw)
    with_a = from_reference(jax_analyze(_jax_matrix(A),
                                        perm=np.arange(A.height)), A)
    own = analyze(A, perm=np.arange(A.height))
    for lw, lo in zip(with_a.levels, own.levels):
        np.testing.assert_array_equal(lw.asm_conj, lo.asm_conj)


@pytest.mark.parametrize("order", ["nd", "natural_nd"])
def test_conjugate_solve_context_matches_substitution(order):
    """Mirrors tests/sparse_direct/test_solve_context.py:23 on a Hermitian
    indefinite factor: the solve through the panel inverses (whose backward
    step applies conj(L⁻ᵀ)) and substitution agree, both to a dense solve's
    residual.  (The JAX package's two paths are held to each other in
    ``test_solves_match_reference``, on the ordering where its value map is
    right.)"""
    A = magnetic_laplacian(12, 11)
    f = SparseLDLFactorization(device="cpu", dtype=C128)
    f.initialize(A, hermitian=True, perm=_ordering(A, (12, 11), order))
    num = f.factor().numeric
    b = _rhs(A.height)
    x0, x1 = num.solve(b).numpy(), num.solve(b, num.solve_context()).numpy()
    S = A.to_scipy()
    for x in (x0, x1):
        assert np.linalg.norm(S @ x - b) / np.linalg.norm(b) < 1e-12
    np.testing.assert_allclose(x1, x0, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("case", ["helmholtz_2d", "magnetic_2d"])
def test_ldl_reproduces_permuted_matrix(case):
    """Mirrors tests/sparse_direct/test_sparse_ldl.py:142: L·D·Lᵀ (L·D·Lᴴ
    when Hermitian) applied to v equals (A·v) in permuted order."""
    dims, make = MATRICES[case]
    A = make()
    herm = case.startswith("magnetic")
    f = SparseLDLFactorization(device="cpu", dtype=C128)
    f.initialize(A, hermitian=herm, perm=natural_nested_dissection(dims))
    f.factor()
    v = _rhs(A.height, seed=3)
    perm = f.symb.perm.numpy()
    lt_v = f.multiply_with_l(v[perm], adjoint=True)
    w = f.multiply_with_l(f.diagonal() * lt_v).numpy()
    np.testing.assert_allclose(w, (A.to_dense() @ v)[perm], atol=1e-9)


@pytest.mark.parametrize("sigma", [0.0, 1.7, 4.2])
def test_inertia_matches_eigenvalues(sigma):
    """The pivots' signs (real parts) count the Hermitian matrix's positive
    and negative eigenvalues (Sylvester)."""
    A = magnetic_laplacian(12, 11, sigma=sigma)
    f = SparseLDLFactorization(device="cpu", dtype=C128)
    f.initialize(A, hermitian=True, perm=natural_nested_dissection((12, 11)))
    f.factor()
    ev = np.linalg.eigvalsh(A.to_dense())
    assert np.abs(ev).min() > 1e-6
    assert f.inertia() == (int((ev > 0).sum()), int((ev < 0).sum()), 0)
    assert np.abs(f.diagonal().imag.numpy()).max() <= 1e-12


@pytest.mark.parametrize("case", ["helmholtz_3d", "magnetic_2d"])
def test_complex64_under_its_bound(case):
    """complex64 factor and solve: the relative residual, computed in
    complex128, under the dtype's bound (100·eps·n)."""
    dims, make = MATRICES[case]
    A = make()
    f = SparseLDLFactorization(device="cpu", dtype=torch.complex64)
    f.initialize(A, hermitian=case.startswith("magnetic"),
                 perm=natural_nested_dissection(dims)).factor()
    assert f.numeric.pool.dtype == torch.complex64
    b = _rhs(A.height)
    x = f.solve(b).numpy().astype(np.complex128)
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < f.residual_bound()
    xr = f.solve_with_iterative_refinement(b, iters=2).numpy()
    r2 = np.linalg.norm(A.to_scipy() @ xr.astype(np.complex128) - b) \
        / np.linalg.norm(b)
    assert r2 < f.residual_bound()


@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_plain_extend_add_on_complex_pool(dtype):
    """On a CPU pool the K1 wrapper takes the plain version; on a complex
    pool it equals ``index_add_`` on the real and imaginary parts apart."""
    dims, make = MATRICES["helmholtz_3d"]
    A = make()
    host = analyze(A, perm=natural_nested_dissection(dims))
    plan = build_ea_plan(host).to("cpu")
    rng = np.random.default_rng(4)
    z = rng.standard_normal(host.pool_size) \
        + 1j * rng.standard_normal(host.pool_size)
    pool = torch.from_numpy(z).to(dtype)
    parts = [pool.real.clone(), pool.imag.clone()]
    before = extend_add.launches
    for li in sorted(plan.levels):
        extend_add(pool, plan.levels[li])
        for p in parts:
            extend_add_plain(p, plan.levels[li])
    assert extend_add.launches == before
    assert torch.equal(pool.real, parts[0])
    assert torch.equal(pool.imag, parts[1])


def test_complex_symmetric_differs_from_hermitian():
    """The same complex matrix factored both ways: LDLᵀ solves the matrix
    as it is; ``hermitian`` must not be set for a non-Hermitian one."""
    A = sparse_helmholtz_2d(8, 7, SHIFT)
    np.testing.assert_array_equal(A.to_dense(), jax_helmholtz_2d(
        8, 7, SHIFT).to_dense())
    np.testing.assert_array_equal(
        sparse_helmholtz_3d(3, 4, 2, SHIFT).to_dense(),
        jax_helmholtz_3d(3, 4, 2, SHIFT).to_dense())
    b = _rhs(A.height)
    xd = np.linalg.solve(A.to_dense(), b)
    f = SparseLDLFactorization(device="cpu", dtype=C128)
    f.initialize(A, perm=natural_nested_dissection((8, 7))).factor()
    assert _rel(f.solve(b).numpy(), xd) <= TOL
    g = SparseLDLFactorization(device="cpu", dtype=C128)
    g.initialize(A, hermitian=True, perm=natural_nested_dissection((8, 7)))
    assert _rel(g.factor().solve(b).numpy(), xd) > 1e-3
    # a real matrix in a complex dtype is promoted, not refused
    R = dataclasses.replace(A, vals=A.vals.real.copy())
    h = SparseLDLFactorization(device="cpu", dtype=C128)
    h.initialize(R, perm=natural_nested_dissection((8, 7))).factor()
    assert h.numeric.pool.dtype == C128
    assert _rel(h.solve(b).numpy(), np.linalg.solve(R.to_dense(), b)) <= TOL
