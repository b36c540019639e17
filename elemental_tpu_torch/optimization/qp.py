"""Interior-point quadratic programming (counterpart of
``elemental_tpu/optimization/qp.py``; spec from the reference's
``examples/interface/QP*.py`` callers):

  direct form:  min ½ xᵀQx + cᵀx  s.t.  A·x = b,  x ≥ 0
  box form:     min ½ xᵀQx + cᵀx  s.t.  l ≤ x ≤ u
  affine form:  min ½ xᵀQx + cᵀx  s.t.  A·x = b,  G·x + s = h,  s ≥ 0

Mehrotra predictor-corrector on the fixed-pattern quasi-definite KKT
[[Q + Θ + γI, Aᵀ], [A, −δI]] (affine: [[Q+γI, Aᵀ, Gᵀ], [A, −δI, 0],
[G, 0, −(W+δ)I]]) through the multifrontal LDL; the barrier diagonal is the
only per-iteration change (``ChangeNonzeroValues`` reuse,
``DistSparseLDLFactorization.cpp:149``).  The JAX step runs eagerly here,
one factor an iteration and the panel-inverse context built once for its
two solves.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.policy import real_working_dtype
from ..sparse.csr import SparseMatrix
from .lp import (LPCtrl, LPResult, _as_sparse, _build_affine_kkt,
                 _build_lp_kkt, _host_scalars, _resolve_numerics,
                 _resolve_refine, _steplen)


def qp_direct(Q, A, b: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None, *, device,
              dtype) -> LPResult:
    """min ½xᵀQx + cᵀx s.t. Ax = b, x ≥ 0 (reference ``QPDirect``) on
    ``device`` in ``dtype``."""
    ctrl = ctrl or LPCtrl()
    dtype = real_working_dtype(dtype)
    device = torch.device(device)
    Q, A = _as_sparse(Q), _as_sparse(A)
    m, n = A.shape
    gamma, tol = _resolve_numerics(ctrl, dtype)
    delta = gamma
    kkt, _ = _build_lp_kkt(A, gamma, delta, ctrl.ordering, device=device,
                           dtype=dtype, Q=Q)
    T = lambda a: torch.as_tensor(a).to(device, dtype)  # noqa: E731
    reg_diag = kkt.reg
    Qd = Q.device_csr(device=device, dtype=dtype)
    Ad, Atd = (M.device_csr(device=device, dtype=dtype)
               for M in (A, A.transpose()))
    bj, cj = T(b), T(c)
    tau = ctrl.tau
    nref = _resolve_refine(ctrl, dtype)

    def step(x, y, z):
        rb = bj - Ad.matvec(x)
        rc = cj + Qd.matvec(x) - Atd.matvec(y) - z
        mu = x @ z / n
        theta = z / x
        fact = kkt.prepare(kkt.assemble([theta]))
        ctx = fact.default_context()

        def directions(rmu):
            # (Q+Θ)dx − Aᵀdy = −rc + rmu/x ; A dx = rb
            # symmetric K[p;q] = [f;g] with dy = −q
            rhs = torch.cat([-rc + rmu / x, rb])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref, ctx=ctx)
            dx, dy = sol[:n], -sol[n:]
            dz = (rmu - z * dx) / x
            return dx, dy, dz

        dxa, _, dza = directions(-x * z)
        ap = _steplen(x, dxa, 1.0)
        ad = _steplen(z, dza, 1.0)
        mu_aff = (x + ap * dxa) @ (z + ad * dza) / n
        sigma = torch.where(mu > 0, (mu_aff / mu) ** 3, torch.zeros_like(mu))
        dx, dy, dz = directions(sigma * mu - x * z - dxa * dza)
        alpha = torch.minimum(_steplen(x, dx, tau), _steplen(z, dz, tau))
        xn, yn, zn = x + alpha * dx, y + alpha * dy, z + alpha * dz
        # finiteness of the NEW iterate (the residuals are of the input)
        ok = (torch.isfinite(xn).all() & torch.isfinite(yn).all()
              & torch.isfinite(zn).all())
        return (xn, yn, zn) + tuple(_host_scalars(
            torch.linalg.norm(rb), torch.linalg.norm(rc), mu, ok))

    x = torch.ones(n, dtype=dtype, device=device)
    y = torch.zeros(m, dtype=dtype, device=device)
    z = torch.ones(n, dtype=dtype, device=device)
    bnorm = float(np.linalg.norm(b)) + 1.0
    cnorm = float(np.linalg.norm(c)) + 1.0

    it = 0
    converged = False
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, zp = x, y, z
        x, y, z, rbn, rcn, mu, ok = step(x, y, z)
        if not ok or not np.isfinite(rbn + rcn + mu):
            x, y, z = xp, yp, zp
            break
        if rbn / bnorm < tol and rcn / cnorm < tol and mu < tol:
            x, y, z = xp, yp, zp
            converged = True
            break
        if ctrl.verbose:
            print(f"  it {it}: mu={mu:.3e}")

    Qx = Qd.matvec(x).cpu().numpy()
    x, y, z = (v.cpu().numpy() for v in (x, y, z))
    obj = float(0.5 * x @ Qx + c @ x)
    return LPResult(x, y, z, obj, it, converged)


def qp_box(Q, c: np.ndarray, lower: np.ndarray, upper: np.ndarray,
           ctrl: Optional[LPCtrl] = None, *, device, dtype) -> np.ndarray:
    """min ½xᵀQx + cᵀx s.t. l ≤ x ≤ u (reference box-constrained QP), via
    the shift x = l + s, s + t = u − l, s,t ≥ 0 in direct form."""
    ctrl = ctrl or LPCtrl()
    n = c.shape[0]
    lower = np.asarray(lower, float)
    upper = np.asarray(upper, float)
    span = upper - lower
    Qs = _as_sparse(Q)
    # variables v = [s; t]; Q̂ acts on s only; constraint s + t = span
    qrows = Qs.row_ids()
    Qh = SparseMatrix.from_coo(2 * n, 2 * n, qrows, Qs.colind, Qs.vals)
    Ql = np.zeros(n)
    np.add.at(Ql, qrows, Qs.vals * lower[Qs.colind])
    ch = np.concatenate([c + Ql, np.zeros(n)])
    idx = np.arange(n)
    Ah = SparseMatrix.from_coo(
        n, 2 * n, np.concatenate([idx, idx]),
        np.concatenate([idx, idx + n]), np.ones(2 * n))
    res = qp_direct(Qh, Ah, span, ch, ctrl, device=device, dtype=dtype)
    return lower + res.x[:n]


def qp_affine(Q, A, b: np.ndarray, G, h: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None, *, device,
              dtype) -> LPResult:
    """min ½xᵀQx + cᵀx s.t. Ax = b, Gx + s = h, s ≥ 0 (reference
    ``QPAffine``, spec from ``examples/interface/QPAffine.py``) on
    ``device`` in ``dtype``, W = s/z the dynamic slot of the affine KKT."""
    ctrl = ctrl or LPCtrl()
    dtype = real_working_dtype(dtype)
    device = torch.device(device)
    Q, A, G = _as_sparse(Q), _as_sparse(A), _as_sparse(G)
    m, n = A.shape
    k = G.shape[0]
    gamma, tol = _resolve_numerics(ctrl, dtype)
    delta = gamma
    kkt = _build_affine_kkt(A, G, gamma, delta, ctrl.ordering,
                            device=device, dtype=dtype, Q=Q)
    reg_diag = kkt.reg
    T = lambda a: torch.as_tensor(a).to(device, dtype)  # noqa: E731
    Qd = Q.device_csr(device=device, dtype=dtype)
    Ad, Atd = (M.device_csr(device=device, dtype=dtype)
               for M in (A, A.transpose()))
    Gd, Gtd = (M.device_csr(device=device, dtype=dtype)
               for M in (G, G.transpose()))
    bj, hj, cj = T(b), T(h), T(c)
    tau = ctrl.tau
    nref = _resolve_refine(ctrl, dtype)

    def step(x, y, s, z):
        rb = bj - Ad.matvec(x)
        rh = hj - Gd.matvec(x) - s
        Qx = Qd.matvec(x)
        rc = -(cj + Qx + Atd.matvec(y) + Gtd.matvec(z))
        mu = s @ z / k
        pobj = 0.5 * x @ Qx + cj @ x
        gap = torch.abs(mu) / (1 + torch.abs(pobj))
        w = s / z
        fact = kkt.prepare(kkt.assemble([-w]))
        ctx = fact.default_context()

        def directions(rmu):
            rhs = torch.cat([rc, rb, rh - rmu / z])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref, ctx=ctx)
            dx, dy, dz = sol[:n], sol[n:n + m], sol[n + m:]
            ds = (rmu - s * dz) / z
            return dx, dy, dz, ds

        dxa, dya, dza, dsa = directions(-s * z)
        ap = _steplen(s, dsa, 1.0)
        ad = _steplen(z, dza, 1.0)
        mu_aff = (s + ap * dsa) @ (z + ad * dza) / k
        sigma = torch.where(mu > 0, (mu_aff / mu) ** 3, torch.zeros_like(mu))
        dx, dy, dz, ds = directions(sigma * mu - s * z - dsa * dza)

        alpha = torch.minimum(_steplen(s, ds, tau), _steplen(z, dz, tau))
        xn, yn = x + alpha * dx, y + alpha * dy
        sn, zn = s + alpha * ds, z + alpha * dz
        ok = (torch.isfinite(xn).all() & torch.isfinite(yn).all()
              & torch.isfinite(sn).all() & torch.isfinite(zn).all())
        return (xn, yn, sn, zn) + tuple(_host_scalars(
            torch.linalg.norm(rb), torch.linalg.norm(rh),
            torch.linalg.norm(rc), gap, mu, ok))

    x = torch.zeros(n, dtype=dtype, device=device)
    y = torch.zeros(m, dtype=dtype, device=device)
    s = torch.clamp(hj - Gd.matvec(x), min=1.0)
    z = torch.ones(k, dtype=dtype, device=device)
    bn = 1 + float(np.linalg.norm(b))
    hn = 1 + float(np.linalg.norm(h))
    cn = 1 + float(np.linalg.norm(c))
    it = 0
    converged = False
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, sp, zp = x, y, s, z
        x, y, s, z, rbn, rhn, rcn, gap, mu, ok = step(x, y, s, z)
        if not ok or not np.isfinite(rbn + rcn + gap):
            x, y, s, z = xp, yp, sp, zp
            break
        if (rbn < tol * bn and rhn < tol * hn and rcn < tol * cn
                and (gap < tol or mu < tol)):
            x, y, s, z = xp, yp, sp, zp
            converged = True
            break
        if ctrl.verbose:
            print(f"  it {it}: mu={mu:.3e} gap={gap:.3e}")

    Qx = Qd.matvec(x).cpu().numpy()
    x, y, s, z = (v.cpu().numpy() for v in (x, y, s, z))
    obj = float(0.5 * x @ Qx + c @ x)
    return LPResult(x, y, z, obj, it, converged, s=s, tol_effective=tol)
