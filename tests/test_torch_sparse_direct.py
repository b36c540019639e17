"""Parity of the port's sparse-direct tier (ordering, ``analyze``, the
multifrontal factor, tree solves and the facade) with the JAX package, on
the CPU in float64, from the same NumPy inputs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elemental_tpu.matrices import sparse_laplacian_3d as jax_laplacian
from elemental_tpu.optimization.lp import _build_lp_kkt as jax_build_lp_kkt
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse_direct import SparseLDLFactorization as JaxLDL
from elemental_tpu.sparse_direct.numeric import (LDLFactorization as JaxNum,
                                                 factor as jax_factor)
from elemental_tpu.sparse_direct.ordering import (
    nested_dissection as jax_nested_dissection)
from elemental_tpu.sparse_direct.symbolic import analyze as jax_analyze

from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_3d
from elemental_tpu_torch.sparse import SparseMatrix
from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                               analyze, build_ea_plan, factor,
                                               from_reference,
                                               nested_dissection)
from elemental_tpu_torch.sparse_direct.symbolic import LEVEL_ARRAY_FIELDS

torch.set_num_threads(1)
F64 = torch.float64


def _kkt_matrix(n1=4, theta=None):
    """The LP KKT of concat_fd_2d(n1, n1) (quasi-definite, indefinite) as
    a port matrix, its values with Θ = ``theta`` (default I)."""
    A = concat_fd_2d(n1, n1)
    Aj = JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)
    kkt, _ = jax_build_lp_kkt(Aj, 1e-2, 1e-2, None)
    n = A.width
    vals = np.array(kkt.assemble([jnp.asarray(
        np.ones(n) if theta is None else theta)]))
    p = kkt.pattern
    return SparseMatrix.from_arrays(p.height, p.width, p.rowptr, p.colind,
                                    vals)


def _jax_matrix(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


MATRICES = {
    "laplacian_6": lambda: sparse_laplacian_3d(6, 6, 6, scaled=False),
    "kkt_fd_4": _kkt_matrix,
}


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_laplacian_and_analyze_match_reference(name):
    """Same matrix, same ordering, and every LevelPlan array equal as
    integers."""
    A = MATRICES[name]()
    Aj = _jax_matrix(A)
    if name.startswith("laplacian"):
        ref = jax_laplacian(6, 6, 6, scaled=False).to_dense()
        np.testing.assert_array_equal(A.to_dense(), ref)
    perm = nested_dissection(A, cutoff=16)
    np.testing.assert_array_equal(perm, jax_nested_dissection(Aj, cutoff=16))
    got = analyze(A, perm=perm)
    ref = jax_analyze(Aj, perm=perm)
    for f in ("n", "pool_size", "nnz_factor"):
        assert getattr(got, f) == getattr(ref, f)
    np.testing.assert_array_equal(got.perm, ref.perm)
    np.testing.assert_array_equal(got.iperm, ref.iperm)
    np.testing.assert_array_equal(got.a_perm_src, ref.a_perm_src)
    assert len(got.levels) == len(ref.levels)
    for lg, lr in zip(got.levels, ref.levels):
        assert (lg.front_size, lg.offset) == (lr.front_size, lr.offset)
        for f in ("sn_ids", "ns") + LEVEL_ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(lg, f), getattr(lr, f))
    # the device form keeps the values, in int32 below 2**31 elements
    dev = got.to("cpu")
    assert dev.perm.dtype == torch.int32
    np.testing.assert_array_equal(dev.levels[-1].front_rows.numpy(),
                                  got.levels[-1].front_rows)


FACTOR_CASES = {
    # name: (matrix, spd, panel_blocksize, pivot floor magnitude)
    "spd": ("laplacian_6", True, 32, None),
    "ldl": ("laplacian_6", False, 1 << 20, None),
    "ldl_blocked": ("laplacian_6", False, 4, None),
    "kkt_blocked": ("kkt_fd_4", False, 4, None),
    "kkt_pivot_floor": ("kkt_fd_4", False, 4, 0.5),
}


def _shared_plans(A):
    """JAX symbolic plan and the port's copy of it (identical plans)."""
    Aj = _jax_matrix(A)
    jsymb = jax_analyze(Aj, perm=jax_nested_dissection(Aj, cutoff=16))
    host = from_reference(jsymb)
    return jsymb, host


@pytest.fixture(scope="module", params=sorted(FACTOR_CASES))
def factor_pair(request):
    mname, spd, nb, floor = FACTOR_CASES[request.param]
    A = MATRICES[mname]()
    jsymb, host = _shared_plans(A)
    pf = None
    if floor is not None:
        # signed floors above some pivot magnitudes, so clamps happen
        sign = np.where(np.arange(A.height) % 3 == 0, -1.0, 1.0)
        pf = floor * sign
    reg = np.random.default_rng(5).uniform(0, 0.1, A.height)
    pool, d = jax.jit(lambda v: _pool_d(jax_factor(
        jsymb, v, reg=reg, dtype=jnp.float64, spd=spd, panel_blocksize=nb,
        pivot_floor=pf)))(jnp.asarray(A.vals))
    jnum = _JittedReference(JaxNum(jsymb, pool, d, False))
    tnum = factor(host.to("cpu"), A.vals, ea_plan=build_ea_plan(
        host).to("cpu"), dtype=F64, reg=reg, spd=spd, panel_blocksize=nb,
        pivot_floor=pf)
    return A, jnum, tnum


def _pool_d(num):
    return num.pool, num.d


class _JittedReference:
    """The JAX factor's solves, each compiled once (eager JAX dispatch would
    compile every small op of the tree walk separately)."""

    def __init__(self, num):
        self.num = num
        self.pool, self.d = num.pool, num.d
        symb = num.symb
        mk = lambda p, d: JaxNum(symb, p, d, False)  # noqa: E731
        self._solve = jax.jit(lambda p, d, b, c: mk(p, d).solve(b, c))
        self._ctx = jax.jit(lambda p, d: mk(p, d).solve_context())
        self._mul = jax.jit(lambda p, d, x, adj: mk(p, d).multiply_with_l(
            x, adj), static_argnums=3)

    def solve(self, b, ctx=None):
        return self._solve(self.pool, self.d, b, ctx)

    def solve_context(self):
        return self._ctx(self.pool, self.d)

    def multiply_with_l(self, x, adjoint):
        return self._mul(self.pool, self.d, x, adjoint)

    def inertia(self):
        return self.num.inertia()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def test_factor_pool_matches_reference(factor_pair):
    """The whole pool (panels, pivots, Schur blocks) and d, to 1e-12."""
    _, jnum, tnum = factor_pair
    assert _rel(tnum.pool.numpy(), jnum.pool) <= 1e-12
    assert _rel(tnum.d.numpy(), jnum.d) <= 1e-12
    assert np.all(np.isfinite(tnum.pool.numpy()))


def test_solves_match_reference(factor_pair):
    """solve, solve_context, solve with the context, multiply_with_l."""
    A, jnum, tnum = factor_pair
    rng = np.random.default_rng(9)
    b = rng.standard_normal(A.height)
    B = rng.standard_normal((A.height, 3))
    assert _rel(tnum.solve(b).numpy(), jnum.solve(jnp.asarray(b))) <= 1e-12
    assert _rel(tnum.solve(B).numpy(), jnum.solve(jnp.asarray(B))) <= 1e-12
    jctx, tctx = jnum.solve_context(), tnum.solve_context()
    for lj, lt in zip(jctx, tctx):
        assert _rel(lt.numpy(), lj) <= 1e-12
    assert _rel(tnum.solve(b, tctx).numpy(),
                jnum.solve(jnp.asarray(b), jctx)) <= 1e-12
    for adjoint in (False, True):
        assert _rel(tnum.multiply_with_l(b, adjoint).numpy(),
                    jnum.multiply_with_l(jnp.asarray(b), adjoint)) <= 1e-12
    jin = tuple(int(v) for v in jnum.inertia())
    assert tnum.inertia() == jin


@pytest.mark.parametrize("spd", [True, False])
def test_facade_matches_reference(spd):
    """The facade end to end against the JAX facade: solve, refactor with
    new values, accounting; the refined solve against a dense solve."""
    A = sparse_laplacian_3d(6, 6, 6, scaled=False)
    b = np.random.default_rng(2).standard_normal(A.height)
    f = SparseLDLFactorization(device="cpu", dtype=F64, spd=spd)
    f.initialize(A, cutoff=16).factor()
    j = JaxLDL(spd=spd)
    j.initialize(_jax_matrix(A), cutoff=16)
    j.factor()
    x = f.solve(b).numpy()
    assert _rel(x, j.solve(jnp.asarray(b))) <= 1e-12
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < f.residual_bound()
    assert f.residual_bound() == j.residual_bound()
    assert f.factor_gflops() == j.factor_gflops()
    xr = f.solve_with_iterative_refinement(b, iters=2).numpy()
    assert _rel(xr, np.linalg.solve(A.to_dense(), b)) <= 1e-12
    new = A.vals * 1.5
    f.change_nonzero_values(new)
    j.change_nonzero_values(new)
    assert _rel(f.solve(b).numpy(), j.solve(jnp.asarray(b))) <= 1e-12
    assert f.inertia() == (A.height, 0, 0)


def test_facade_rejects_complex_and_wrong_dtypes():
    A = sparse_laplacian_3d(3, 3, 3)
    Ac = dataclasses.replace(A, vals=A.vals.astype(np.complex128))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SparseLDLFactorization(device="cpu", dtype=F64).initialize(Ac)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SparseLDLFactorization(device="cpu", dtype=torch.complex128)
    with pytest.raises(TypeError):
        SparseLDLFactorization(device="cpu", dtype=torch.float16)
    f = SparseLDLFactorization(device="cpu", dtype=F64)
    with pytest.raises(RuntimeError, match="initialize"):
        f.factor()


def test_factor_rejects_foreign_plan():
    """An extend-add plan of another analysis is refused, not applied."""
    A = sparse_laplacian_3d(4, 4, 4)
    B = sparse_laplacian_3d(5, 4, 4)
    ha = analyze(A, perm=nested_dissection(A, cutoff=16))
    hb = analyze(B, perm=nested_dissection(B, cutoff=16))
    with pytest.raises(ValueError, match="does not belong"):
        factor(ha.to("cpu"), A.vals, ea_plan=build_ea_plan(hb).to("cpu"),
               dtype=F64)


def test_containers_match_reference():
    """SparseBuilder (duplicates summed), transpose, padded ELL and the
    device products against the JAX containers and SciPy."""
    from elemental_tpu.sparse import SparseBuilder as JaxBuilder
    from elemental_tpu_torch.sparse import SparseBuilder
    rng = np.random.default_rng(6)
    rows = rng.integers(0, 9, 60)
    cols = rng.integers(0, 7, 60)
    vals = rng.standard_normal(60)
    tb, jb = SparseBuilder(9, 7), JaxBuilder(9, 7)
    tb.queue_updates(rows, cols, vals)
    jb.queue_updates(rows, cols, vals)
    tb.queue_update(8, 6, 2.5)
    jb.queue_update(8, 6, 2.5)
    A, Aj = tb.process_queues(), jb.process_queues()
    for f in ("rowptr", "colind", "vals"):
        np.testing.assert_array_equal(getattr(A, f), getattr(Aj, f))
        np.testing.assert_array_equal(getattr(A.transpose(), f),
                                      getattr(Aj.transpose(), f))
    for got, ref in zip(A.host_ell()[:2], Aj.host_ell()[:2]):
        np.testing.assert_array_equal(got, ref)
    x = rng.standard_normal(7)
    X = rng.standard_normal((7, 3))
    S = A.to_scipy()
    csr = A.device_csr(device="cpu", dtype=F64)
    ell = A.device_ell(device="cpu", dtype=F64)
    assert ell.dropped == 0
    np.testing.assert_allclose(csr.matvec(torch.as_tensor(x)).numpy(),
                               S @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(ell.matvec(torch.as_tensor(x)).numpy(),
                               S @ x, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(csr.matmat(torch.as_tensor(X)).numpy(),
                               S @ X, rtol=1e-13, atol=1e-13)
    g = A.graph().symmetrize()
    assert g.num_sources == 9 and np.all(np.isin(g.neighbors(0),
                                                 np.arange(9)))
