"""Plain reference of the ``lp_fd2d`` configuration: Elemental's
``examples/interface/LPDirect.py`` ConcatFD2D LP, min cᵀx s.t. Ax = b,
x ≥ 0, its instances, and a Mehrotra interior-point method in float64
NumPy/SciPy that follows the rules of the port's ``lp_direct`` step by step
(Ruiz scaling, the Θ = I start, the predictor-corrector, the
fraction-to-boundary steps, the backoff safeguard and the best-iterate
rule).  Each Newton system, K₀·[p; q] = [f; g] with K₀ = [[Θ, Aᵀ], [A, 0]],
is solved exactly through its normal equations with SuperLU.

Imports nothing of the program: the matrix, the scaling and every solve
are worked out here."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import splu

from .precision import same


def concat_fd_2d(n0: int, n1: int) -> sp.csr_matrix:
    """[FD₁ FD₂] of the reference ``BP.py``/``LPDirect.py`` ConcatFD2D
    stencil: m = n0·n1 rows, 2m columns, sorted CSR."""
    m = n0 * n1
    s = np.arange(m)
    x0, x1 = s % n0, s // n0
    rows, cols, vals = [], [], []
    for mask, col, val in (
            (np.ones(m, bool), s, 11.0), (np.ones(m, bool), s + m, -20.0),
            (x0 > 0, s - 1, -1.0), (x0 > 0, s + m - 1, -17.0),
            (x0 + 1 < n0, s + 1, 2.0), (x0 + 1 < n0, s + m + 1, -20.0),
            (x1 > 0, s - n0, -30.0), (x1 > 0, s + m - n0, -3.0),
            (x1 + 1 < n1, s + n0, 4.0), (x1 + 1 < n1, s + m + n0, 3.0)):
        rows.append(s[mask])
        cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), val))
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(m, 2 * m))
    A.sum_duplicates()
    A.sort_indices()
    return A


def rng_for(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng([seed & (2 ** 64 - 1), *key])


def instance(A: sp.csr_matrix, seed: int, k: int):
    """(b, c) of instance ``k`` from ``seed``, as ``LPDirect.py`` draws
    them: x0 = |N(0,1)| + 0.1, b = A·x0, c = |N(0,1)| + 0.5."""
    rng = rng_for(seed, 0, k)
    n = A.shape[1]
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    c = np.abs(rng.standard_normal(n)) + 0.5
    return A @ x0, c


def interior_point(n: int, seed: int):
    """A seeded interior iterate (x, z > 0) and its Θ = z/x."""
    rng = rng_for(seed, 1)
    x = np.abs(rng.standard_normal(n)) + 0.1
    z = np.abs(rng.standard_normal(n)) + 0.1
    return z / x


def ruiz(A: sp.csr_matrix, iters: int = 10):
    """Ruiz equilibration: Â = R⁻¹·A·S⁻¹, with the row and column scales
    (the square roots of the row and column maxima, ``iters`` times)."""
    A = A.tocsr().astype(np.float64, copy=True)
    m, n = A.shape
    r, s = np.ones(m), np.ones(n)
    for _ in range(iters):
        rowmax = np.asarray(abs(A).max(axis=1).todense()).ravel()
        rr = np.where(rowmax > 0, np.sqrt(rowmax), 1.0)
        A = sp.diags(1.0 / rr) @ A
        r *= rr
        colmax = np.asarray(abs(A).max(axis=0).todense()).ravel()
        ss = np.where(colmax > 0, np.sqrt(colmax), 1.0)
        A = (A @ sp.diags(1.0 / ss)).tocsr()
        s *= ss
    return A, r, s


def kkt_solver(A: sp.csr_matrix, At: sp.csr_matrix, theta: np.ndarray,
               rnd=same):
    """Exact solves of K₀·[p; q] = [f; g], K₀ = [[diag(θ), Aᵀ], [A, 0]],
    by the normal equations (A·Θ⁻¹·Aᵀ)·q = A·Θ⁻¹·f − g; ``rnd`` rounds
    every operand and result (the controls)."""
    ti = rnd(1.0 / theta)
    M = (A @ sp.diags(ti) @ At).tocsc()
    M.data = rnd(M.data)
    # M is symmetric positive definite: a symmetric ordering, no pivoting
    lu = splu(M, permc_spec="MMD_AT_PLUS_A", diag_pivot_thresh=0.0,
              options=dict(SymmetricMode=True))

    def solve(f, g):
        q = rnd(lu.solve(rnd(A @ (ti * f) - g)))
        p = rnd(ti * (f - At @ q))
        return p, q
    return solve


def _steplen(v, dv, tau):
    neg = dv < 0
    if not neg.any():
        return 1.0
    return min(1.0, tau * float(np.min(-v[neg] / dv[neg])))


def mehrotra(A: sp.csr_matrix, b: np.ndarray, c: np.ndarray, max_iters: int,
             tol: float, tau: float = 0.995, rnd=same) -> dict:
    """The capped Mehrotra IPM of ``lp_direct``, in float64 (or rounded by
    ``rnd``).  Returns x, y, z, the objective and the iterations."""
    A, r, s = ruiz(A)
    A.data = rnd(A.data)
    b, c = rnd(b / r), rnd(c / s)
    m, n = A.shape
    At = A.T.tocsr()
    nrm = np.linalg.norm
    bnorm, cnorm = nrm(b) + 1.0, nrm(c) + 1.0

    solve = kkt_solver(A, At, np.ones(n), rnd)
    x_t, _ = solve(np.zeros(n), b)
    z_t, y = solve(c, np.zeros(m))
    dx = max(-1.5 * x_t.min(), 0.0)
    dz = max(-1.5 * z_t.min(), 0.0)
    x_h, z_h = x_t + dx + 1e-10, z_t + dz + 1e-10
    xs = x_h @ z_h
    x = np.maximum(x_h + 0.5 * xs / max(z_h.sum(), 1e-10), 1e-8)
    z = np.maximum(z_h + 0.5 * xs / max(x_h.sum(), 1e-10), 1e-8)
    nb = (x @ z / n) / max(nrm(b - A @ x) / bnorm, 1e-30)

    def gap_of(x, y):
        cx = c @ x
        return abs(cx - b @ y) / (1.0 + abs(cx))

    def metric_of(x, y, z):
        return max(nrm(b - A @ x) / bnorm, nrm(c - At @ y - z) / cnorm,
                   gap_of(x, y))

    def step(x, y, z):
        rb = b - A @ x
        rc = c - At @ y - z
        mu = x @ z / n
        solve = kkt_solver(A, At, z / x, rnd)
        dxa, q = solve(-z - rc, rb)
        dza = rc + At @ q
        ap, ad = _steplen(x, dxa, 1.0), _steplen(z, dza, 1.0)
        mu_aff = (x + ap * dxa) @ (z + ad * dza) / n
        sigma = (mu_aff / mu) ** 3 if mu > 0 else 0.0
        rmu = sigma * mu - x * z - dxa * dza
        p, q = solve(rmu / x - rc, rb)
        dx, dy = p, -q
        dz = rc - At @ dy
        ap, ad = _steplen(x, dx, tau), _steplen(z, dz, tau)
        rbn = nrm(rb) / bnorm
        for _ in range(12):
            xn, zn = x + ap * dx, z + ad * dz
            rbn_new = nrm(b - A @ xn) / bnorm
            if not (rbn > 10 * tol and xn @ zn / n < 1e-5 * nb * rbn_new
                    and rbn_new > 10 * tol):
                break
            ap, ad = ap * 0.7, ad * 0.7
        xn, yn, zn = rnd(x + ap * dx), rnd(y + ad * dy), rnd(z + ad * dz)
        ok = all(np.isfinite(v).all() for v in (xn, yn, zn))
        return xn, yn, zn, nrm(rb), nrm(rc), gap_of(x, y), ok

    it = 0
    best_metric, best = np.inf, None
    for it in range(1, max_iters + 1):
        xp, yp, zp = x, y, z
        x, y, z, rbn, rcn, gap, ok = step(x, y, z)
        metric = max(rbn / bnorm, rcn / cnorm, gap)
        if np.isfinite(metric) and metric < best_metric:
            best_metric, best = metric, (xp, yp, zp)
        if np.isfinite(metric) and metric < tol:
            x, y, z = xp, yp, zp
            break
        if not ok or not np.isfinite(rbn + rcn + gap):
            x, y, z = best if best is not None else (xp, yp, zp)
            break
    else:
        if best is not None:
            fin = metric_of(x, y, z)
            if not np.isfinite(fin) or best_metric < fin:
                x, y, z = best
    return dict(x=x / s, y=y / r, z=z * s, objective=float(c @ x),
                iterations=it)


def lp_tolerance(dtype: str) -> float:
    """The tolerance ``lp_direct`` tests at a working precision: 1e-8,
    raised to 50·eps where that is above it."""
    eps = float(np.finfo(np.dtype(dtype)).eps)
    return max(1e-8, 50.0 * eps)


def iterate_errors(got: dict, ref: dict) -> dict:
    """Relative gaps of an IPM result (x, y, z, objective) to the
    reference's."""
    nrm = np.linalg.norm
    out = {f"{k}_err": nrm(np.asarray(got[k], np.float64) - ref[k])
           / max(nrm(ref[k]), 1e-300) for k in ("x", "y", "z")}
    out["obj_err"] = (abs(got["objective"] - ref["objective"])
                      / (1.0 + abs(ref["objective"])))
    return out
