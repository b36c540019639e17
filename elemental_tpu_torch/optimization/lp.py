"""Interior-point linear programming, direct form (counterpart of
``elemental_tpu/optimization/lp.py:lp_direct``; reference spec
``examples/interface/LPDirect.py:70-115``):

    min cᵀx  s.t.  A·x = b,  x ≥ 0

The regularized quasi-definite augmented KKT is assembled ONCE as a fixed
sparse pattern (:class:`.kkt.KKTBuilder`); each Mehrotra (or IPF) iteration
scatters the barrier diagonal Θ = z/x into the value vector, refactors with
the multifrontal LDL (symbolic analysis reused), and solves the predictor and
corrector systems with restarted FGMRES.  Residuals and the duality gap are
evaluated in double-word arithmetic.

One path: the JAX package's python-orchestrated ``large`` branch
(``lp.py:324-483``), which is the one that can restart the refined solve.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.policy import working_dtype
from ..extended import dd_add, dd_dot, dd_neg, two_prod, two_sum
from ..sparse.csr import SparseMatrix
from .kkt import KKTBuilder, KKTSystem


class Approach:
    MEHROTRA = "mehrotra"
    IPF = "ipf"


@dataclasses.dataclass
class LPCtrl:
    """Reference ``LPDirectCtrl`` analog."""
    approach: str = Approach.MEHROTRA
    max_iters: int = 100
    tol: float = 1e-8
    tau: float = 0.995          # fraction-to-boundary
    sigma_ipf: float = 0.3      # centering for IPF
    reg: Optional[float] = None   # None: dtype-aware (1e-9 f64, ~1e-2 f32)
    refine_iters: Optional[int] = None  # FGMRES steps vs the exact KKT;
                                # None: 8 in float64, 16 in float32
    verbose: bool = False
    ordering: Optional[np.ndarray] = None  # precomputed KKT fill ordering


@dataclasses.dataclass
class LPResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    objective: float
    iterations: int
    converged: bool                 # w.r.t. tol_effective, NOT ctrl.tol
    tol_effective: Optional[float] = None  # the tolerance actually tested
    metric: Optional[float] = None  # achieved max(rb/‖b‖, rc/‖c‖, gap)


def _resolve_numerics(ctrl: LPCtrl, dtype: torch.dtype) -> Tuple[float, float]:
    """Working-dtype-aware (reg, tol).  The f64 defaults (γ=δ=1e-9,
    tol=1e-8) are below f32 resolution; in f32 γ = 30·√eps sits at the
    measured element-growth knee of the pivot-free quasi-definite LDL, and
    the tolerance floor is 50·eps.  A clamped tolerance warns, and
    ``LPResult.converged`` refers to the clamped value."""
    eps = float(torch.finfo(dtype).eps)
    reg = ctrl.reg
    if reg is None:
        reg = 1e-9 if eps < 1e-10 else 30.0 * float(np.sqrt(eps))
    tol = max(ctrl.tol, 50.0 * eps)
    if tol > ctrl.tol:
        warnings.warn(
            f"LP tolerance {ctrl.tol:g} is below the working-precision "
            f"floor; clamped to {tol:g} (eps={eps:g}).  LPResult.converged "
            f"refers to the clamped tolerance (LPResult.tol_effective).",
            stacklevel=3)
    return reg, tol


def _resolve_refine(ctrl: LPCtrl, dtype: torch.dtype) -> int:
    """Dtype-aware FGMRES depth (see LPCtrl.refine_iters)."""
    if ctrl.refine_iters is not None:
        return int(ctrl.refine_iters)
    return 8 if float(torch.finfo(dtype).eps) < 1e-10 else 16


def sparse_ruiz(A: SparseMatrix, iters: int = 10
                ) -> Tuple[SparseMatrix, np.ndarray, np.ndarray]:
    """Ruiz equilibration on the CSR arrays (reference ``equilibrate/Ruiz``;
    never densifies): returns (Â, r, s) with Â = R⁻¹·A·S⁻¹."""
    m, n = A.shape
    rows = np.repeat(np.arange(m), A.row_nnz())
    cols = A.colind
    v = A.vals.astype(np.float64).copy()
    r = np.ones(m)
    s = np.ones(n)
    for _ in range(iters):
        rowmax = np.zeros(m)
        np.maximum.at(rowmax, rows, np.abs(v))
        rr = np.where(rowmax > 0, np.sqrt(rowmax), 1.0)
        v /= rr[rows]
        r *= rr
        colmax = np.zeros(n)
        np.maximum.at(colmax, cols, np.abs(v))
        ss = np.where(colmax > 0, np.sqrt(colmax), 1.0)
        v /= ss[cols]
        s *= ss
    return A.change_nonzero_values(v), r, s


def _steplen(v: torch.Tensor, dv: torch.Tensor, tau: float) -> torch.Tensor:
    """Fraction-to-boundary step length (0-d tensor)."""
    neg = dv < 0
    ratios = torch.where(neg, -v / torch.where(neg, dv, -torch.ones_like(dv)),
                         torch.full_like(v, float("inf")))
    return torch.clamp(tau * torch.min(ratios), max=1.0)


def _build_lp_kkt(A: SparseMatrix, gamma: float, delta: float,
                  ordering: Optional[np.ndarray], *, device,
                  dtype) -> Tuple[KKTSystem, int]:
    """Fixed-pattern K = [[Θ+γI, Aᵀ],[A, −δI]] with Θ the dynamic slot 0.
    Solving K[p;q]=[f;g] yields dx=p, dy=−q for the unsymmetric Newton rows
    Θ·dx − Aᵀ·dy = f, A·dx = g (quasi-definite ⇒ pivot-free LDL is stable)."""
    m, n = A.shape
    N = n + m
    kb = KKTBuilder(N)
    arows = np.repeat(np.arange(m), A.row_nnz()) + n
    kb.add_static(arows, A.colind, A.vals)
    kb.add_static(A.colind, arows, A.vals)
    kb.add_static(np.arange(n), np.arange(n), np.full(n, gamma))
    kb.add_static(np.arange(n, N), np.arange(n, N), np.full(m, -delta))
    slot = kb.add_dynamic(np.arange(n), np.arange(n))
    return kb.finalize(perm=ordering, device=device, dtype=dtype), slot


def _dd_minus_spmv(acc, cols, vals, x):
    """(hi, lo) of acc − A·x via compensated per-row chains over the padded
    ELL rows of A."""
    xg = x[cols]
    hi = acc
    lo = torch.zeros_like(acc)
    for j in range(cols.shape[1]):
        p, e = two_prod(vals[:, j], xg[:, j])
        hi, e2 = two_sum(hi, -p)
        lo = lo - e + e2
    return hi, lo


def _dd_gap(bj, cj, x, y) -> torch.Tensor:
    """|cᵀx − bᵀy| / (1 + |cᵀx|) with double-word dots (an f32 dot carries
    ~√n·eps of noise)."""
    cx = dd_dot(cj, x)
    by = dd_dot(bj, y)
    diff = dd_add(cx, dd_neg(by))
    return torch.abs(diff.hi + diff.lo) / (1 + torch.abs(cx.hi))


def lp_direct(A: SparseMatrix, b: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None, *, device,
              dtype) -> LPResult:
    """Solve min cᵀx s.t. Ax = b, x ≥ 0 (reference ``LPDirect``) on
    ``device`` in ``dtype`` (float32 or float64)."""
    ctrl = ctrl or LPCtrl()
    dtype = working_dtype(dtype)
    device = torch.device(device)
    m, n = A.shape
    A, r, s = sparse_ruiz(A)
    b = b / r
    c = c / s

    gamma, tol = _resolve_numerics(ctrl, dtype)
    delta = gamma
    kkt, _ = _build_lp_kkt(A, gamma, delta, ctrl.ordering, device=device,
                           dtype=dtype)
    T = lambda a: torch.as_tensor(a).to(device, dtype)  # noqa: E731
    reg_diag = T(np.concatenate([np.full(n, gamma), np.full(m, -delta)]))
    Ad = A.device_csr(device=device, dtype=dtype)
    Atd = A.transpose().device_csr(device=device, dtype=dtype)
    ea = A.device_ell(device=device, dtype=dtype)
    eat = A.transpose().device_ell(device=device, dtype=dtype)
    bj, cj = T(b), T(c)
    bnorm = float(np.linalg.norm(b)) + 1.0
    cnorm = float(np.linalg.norm(c)) + 1.0
    tau = ctrl.tau
    nref = _resolve_refine(ctrl, dtype)
    mehrotra = ctrl.approach == Approach.MEHROTRA
    zeros = lambda k: torch.zeros(k, dtype=dtype, device=device)  # noqa

    def factor(theta):
        # dynamic pivot floors stay off, as in the JAX package: boosting
        # the pivots that sit exactly at ±γ made the θ=1 solve 1000× worse
        fact = kkt.prepare(kkt.assemble([theta]))
        # panel inverses once per FACTOR, not once per FGMRES sweep
        return fact, fact.solve_context()

    def ksolve(fact_ctx, f, g):
        """Restarted FGMRES(nref): a single sweep can plateau at ~5e-2
        relative early in the IPM; restarting on the true residual squares
        the contraction per sweep, to 1e-6·‖rhs‖ (near convergence the rhs
        carries huge entries while the binding components of x are
        μ-small)."""
        fact, ctx = fact_ctx
        rhs = torch.cat([f, g])
        sol = fact.solve_refined(rhs, reg_diag, iters=nref, ctx=ctx)
        rn0 = float(torch.linalg.norm(rhs))
        for _ in range(5):
            res = rhs - (kkt.matvec(fact.vals, sol) - reg_diag * sol)
            rn = float(torch.linalg.norm(res))
            if rn <= 1e-6 * rn0 or not np.isfinite(rn):
                break
            sol = sol + fact.solve_refined(res, reg_diag, iters=nref,
                                           ctx=ctx)
        return sol[:n], sol[n:]

    def start():
        """Mehrotra starting point from the Θ=I system: min-norm Ax=b
        iterate and dual least squares, shifted into the orthant."""
        fact_ctx = factor(torch.ones(n, dtype=dtype, device=device))
        x_t, _ = ksolve(fact_ctx, zeros(n), bj)
        z_t, y = ksolve(fact_ctx, cj, zeros(m))
        dx = torch.clamp(-1.5 * torch.min(x_t), min=0.0)
        dz = torch.clamp(-1.5 * torch.min(z_t), min=0.0)
        x_h = x_t + dx + 1e-10
        z_h = z_t + dz + 1e-10
        xs = x_h @ z_h
        x = x_h + 0.5 * xs / torch.clamp(torch.sum(z_h), min=1e-10)
        z = z_h + 0.5 * xs / torch.clamp(torch.sum(x_h), min=1e-10)
        return torch.clamp(x, min=1e-8), y, torch.clamp(z, min=1e-8)

    def pre(x, y, z):
        """Compensated residuals b−Ax, c−Aᵀy−z (per-row TwoProd/TwoSum
        chains, ~eps²) and gap; plain f32 residuals carry eps·‖A‖‖x‖ of
        evaluation noise that the direction solves then chase."""
        hi, lo = _dd_minus_spmv(bj, ea.cols, ea.vals, x)
        rb = hi + lo
        hi, lo = _dd_minus_spmv(cj, eat.cols, eat.vals, y)
        hi, e2 = two_sum(hi, -z)
        rc = hi + (lo + e2)
        mu = x @ z / n
        return rb, rc, mu, _dd_gap(bj, cj, x, y), z / x

    def post(x, y, z, p, q, rb, rc, gap, nb):
        dx, dy = p, -q
        dz = rc - Atd.matvec(dy)
        ap = _steplen(x, dx, tau)
        ad = _steplen(z, dz, tau)
        rbn = torch.linalg.norm(rb) / bnorm
        # infeasible-IPM neighborhood safeguard: keep μ₊ coupled to ‖rb₊‖,
        # scale-free through nb = μ₀/‖rb₀‖
        for _ in range(12):
            xn = x + ap * dx
            zn = z + ad * dz
            mun = xn @ zn / n
            rbn_new = torch.linalg.norm(bj - Ad.matvec(xn)) / bnorm
            if not bool((rbn > 10 * tol) & (mun < 1e-5 * nb * rbn_new)
                        & (rbn_new > 10 * tol)):
                break
            ap, ad = ap * 0.7, ad * 0.7
        xn, yn, zn = x + ap * dx, y + ad * dy, z + ad * dz
        # finiteness of the NEW iterate: a NaN step is caught in the
        # iteration that produced it
        ok = bool(torch.isfinite(xn).all() & torch.isfinite(yn).all()
                  & torch.isfinite(zn).all())
        return (xn, yn, zn, torch.linalg.norm(rb), torch.linalg.norm(rc),
                gap, ok)

    def step(x, y, z, nb):
        rb, rc, mu, gap, theta = pre(x, y, z)
        fact_ctx = factor(theta)
        if mehrotra:
            dxa, q = ksolve(fact_ctx, -z - rc, rb)     # rhs (−x·z)/x − rc
            dza = rc - Atd.matvec(-q)
            ap = _steplen(x, dxa, 1.0)
            ad = _steplen(z, dza, 1.0)
            mu_aff = (x + ap * dxa) @ (z + ad * dza) / n
            sigma = torch.where(mu > 0, (mu_aff / mu) ** 3,
                                torch.zeros_like(mu))
            rmu = sigma * mu - x * z - dxa * dza
        else:
            rmu = ctrl.sigma_ipf * mu - x * z
        p, q = ksolve(fact_ctx, rmu / x - rc, rb)
        return post(x, y, z, p, q, rb, rc, gap, nb)

    x, y, z = start()
    # neighborhood scale μ₀/‖rb₀‖ for the scale-free backoff safeguard
    mu0 = float(x @ z) / n
    rb0n = float(torch.linalg.norm(bj - Ad.matvec(x))) / bnorm
    nb = torch.tensor(mu0 / max(rb0n, 1e-30), dtype=dtype, device=device)
    it = 0
    converged = False
    best_metric, best_xyz = np.inf, None
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, zp = x, y, z
        x, y, z, rbn, rcn, gap, ok = step(x, y, z, nb)
        rbn, rcn, gap = float(rbn), float(rcn), float(gap)
        metric = max(rbn / bnorm, rcn / cnorm, gap)
        if np.isfinite(metric) and metric < best_metric:
            # residuals belong to the PRE-step iterate: track the best
            best_metric, best_xyz = metric, (xp, yp, zp)
        if np.isfinite(metric) and metric < tol:
            # the PRE-step iterate meets the tolerance: convergence stands
            # even when the step just taken blew up
            x, y, z = xp, yp, zp
            converged = True
            break
        if not ok or not np.isfinite(rbn + rcn + gap):
            x, y, z = best_xyz if best_xyz is not None else (xp, yp, zp)
            break
        if ctrl.verbose:
            print(f"  it {it}: rb={rbn:.2e} rc={rcn:.2e} gap={gap:.2e}")
    else:
        # max_iters exhausted: the last iterate is unevaluated, and f32
        # trajectories degrade after stagnating; keep the best iterate
        # when it beats the final one
        if best_xyz is not None:
            fin = _lp_metric(Ad, Atd, bj, cj, x, y, z, bnorm, cnorm)
            if not np.isfinite(fin) or best_metric < fin:
                x, y, z = best_xyz

    achieved = _lp_metric(Ad, Atd, bj, cj, x, y, z, bnorm, cnorm)
    x, y, z = (v.cpu().numpy() for v in (x, y, z))
    obj = float(c @ x)  # ĉᵀx̂ = cᵀx: the objective is scaling-invariant
    return LPResult(x / s, y / r, z * s, obj, it, converged,
                    tol_effective=tol, metric=achieved)


def _lp_metric(Ad, Atd, bj, cj, x, y, z, bnorm, cnorm) -> float:
    """max(‖b−Ax‖/‖b‖, ‖c−Aᵀy−z‖/‖c‖, relgap) of an iterate; the gap via
    double-word dots."""
    rb = float(torch.linalg.norm(bj - Ad.matvec(x)))
    rc = float(torch.linalg.norm(cj - Atd.matvec(y) - z))
    return max(rb / bnorm, rc / cnorm, float(_dd_gap(bj, cj, x, y)))
