"""The plain reference against small cases worked by hand or by a dense
solve."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from reference import lap3d, lp_fd2d, precision


def test_tf32_rounding():
    v = np.array([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, 1 + 2 ** -10, -2.5])
    # 10 mantissa bits: 1 + 2^-11 ties to even (1), 1 + 3·2^-11 to 1 + 2^-9
    assert precision.tf32(v).tolist() == [1.0, 1.0, 1 + 2 ** -9,
                                          1 + 2 ** -10, -2.5]
    assert precision.float32(np.array([0.1]))[0] == np.float32(0.1)


def test_concat_fd_2d_by_hand():
    A = lp_fd2d.concat_fd_2d(2, 2).toarray()
    # row 0: grid point (0, 0) of 2×2: itself, +x neighbour, +y neighbour
    want = np.zeros(8)
    want[[0, 4, 1, 5, 2, 6]] = [11, -20, 2, -20, 4, 3]
    assert A.shape == (4, 8) and np.array_equal(A[0], want)
    # row 3: grid point (1, 1): itself, −x, −y
    want = np.zeros(8)
    want[[3, 7, 2, 6, 1, 5]] = [11, -20, -1, -17, -30, -3]
    assert np.array_equal(A[3], want)


def test_laplacian_by_hand():
    L = lap3d.laplacian(2).toarray()
    assert np.array_equal(np.diag(L), np.full(8, 6.0))
    assert (L.sum(1) == 3.0).all()          # every corner has 3 neighbours
    assert np.array_equal(L, L.T)


def test_diffusion_values():
    L = lap3d.laplacian(3)
    vals = lap3d.diffusion_values(L, np.random.default_rng(0), 0.5, 1.5)
    M = L.copy()
    M.data = vals
    D = M.toarray()
    off = D - np.diag(np.diag(D))
    assert np.allclose(D, D.T) and (off <= 0).all()
    assert ((-off[off < 0] >= 0.5) & (-off[off < 0] < 1.5)).all()
    assert np.allclose(np.diag(D), -off.sum(1) + 1.0)
    assert np.linalg.eigvalsh(D).min() >= 1.0 - 1e-12


def test_cg_against_dense():
    L = lap3d.laplacian(4)
    B = np.random.default_rng(1).standard_normal((L.shape[0], 3))
    X = lap3d.solve(L, B, "cpu")
    assert lap3d.forward_error(X, np.linalg.solve(L.toarray(), B)) < 1e-12
    X32 = lap3d.solve(L, B, "cpu", dtype=torch.float32, rtol=1e-7)
    assert 1e-9 < lap3d.forward_error(X32, np.linalg.solve(
        L.toarray(), B)) < 1e-4


def test_kkt_solver_against_dense():
    A = lp_fd2d.concat_fd_2d(3, 3)
    m, n = A.shape
    theta = lp_fd2d.interior_point(n, 3)
    K = np.block([[np.diag(theta), A.T.toarray()],
                  [A.toarray(), np.zeros((m, m))]])
    r = np.random.default_rng(2).standard_normal(n + m)
    p, q = lp_fd2d.kkt_solver(A, A.T.tocsr(), theta)(r[:n], r[n:])
    assert np.allclose(np.concatenate([p, q]), np.linalg.solve(K, r),
                       rtol=1e-10, atol=1e-12)


def test_ruiz_scales():
    A = lp_fd2d.concat_fd_2d(4, 4)
    Ah, r, s = lp_fd2d.ruiz(A)
    assert np.allclose((sp.diags(r) @ Ah @ sp.diags(s)).toarray(),
                       A.toarray())
    assert np.allclose(abs(Ah).max(axis=1).toarray(), 1.0, atol=1e-3)


def test_mehrotra_converges_to_the_optimum():
    """Run to convergence, the reference's IPM meets SciPy's HiGHS on a
    small instance of the configuration's LP."""
    from scipy.optimize import linprog
    A = lp_fd2d.concat_fd_2d(5, 5)
    b, c = lp_fd2d.instance(A, 7, 0)
    ref = lp_fd2d.mehrotra(A, b, c, 60, 1e-10)
    opt = linprog(c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    assert opt.status == 0
    assert ref["objective"] == pytest.approx(opt.fun, rel=1e-7)
    assert np.linalg.norm(A @ ref["x"] - b) < 1e-6 * np.linalg.norm(b)
    assert ref["x"].min() >= 0


def test_iterate_errors():
    ref = dict(x=np.array([3.0, 4.0]), y=np.ones(1), z=np.ones(2),
               objective=9.0)
    got = dict(x=np.array([3.0, 4.5]), y=np.ones(1), z=np.ones(2),
               objective=10.0)
    e = lp_fd2d.iterate_errors(got, ref)
    assert e["x_err"] == pytest.approx(0.1) and e["y_err"] == 0.0
    assert e["obj_err"] == pytest.approx(0.1)
