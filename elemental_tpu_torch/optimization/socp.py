"""Second-order-cone programming (counterpart of
``elemental_tpu/optimization/socp.py``; API spec from the reference's
``examples/interface/SOCP_trivial.py`` / ``SOCAtom.py``: Jordan-algebra atoms
over a product of Lorentz cones given by ``orders``/``firstInds``).

  affine form:  min cᵀx  s.t.  A·x = b,  G·x + s = h,  s ∈ K
  K = K₁ × ... × K_r, each K_i = {(s₀, s̄) : s₀ ≥ ‖s̄‖}

Solver: Nesterov–Todd-scaled Mehrotra predictor-corrector (NT scaling point
per Alizadeh–Goldfarb).  The Newton system is the fixed-pattern
quasi-definite KKT [[γI, Aᵀ, Gᵀ], [A, −δI, 0], [G, 0, −Q_w−δI]] where
Q_w = 2wwᵀ − det(w)·J is the quadratic representation of the NT point w
(Q_w z = s); the per-cone Q_w blocks are the dynamic slot.  Cones of equal
order are stacked as (count, order) index tensors on the device, so every
per-cone formula is one batched tensor op a group (:class:`ConeOps`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.policy import real_working_dtype
from ..sparse.csr import SparseMatrix
from .lp import (LPCtrl, _as_sparse, _build_affine_kkt, _host_scalars,
                 _resolve_numerics, _resolve_refine)


# --------------------------------------------------------------------------
# Jordan-algebra / SOC atoms on the host (reference SOCAtom.py surface)
# --------------------------------------------------------------------------

class Cones:
    """Product of Lorentz cones described by member orders (reference
    ``orders``/``firstInds`` vectors)."""

    def __init__(self, orders: Sequence[int]):
        self.orders = tuple(int(o) for o in orders)
        self.first = np.cumsum([0] + list(self.orders[:-1]))
        self.dim = int(sum(self.orders))

    def blocks(self, s: np.ndarray) -> List[np.ndarray]:
        return [s[f:f + o] for f, o in zip(self.first, self.orders)]


def soc_dets(s: np.ndarray, cones: Cones) -> np.ndarray:
    """det(s_i) = s₀² − ‖s̄‖² per cone (reference ``SOCDets``)."""
    return np.array([b[0] ** 2 - b[1:] @ b[1:] for b in cones.blocks(s)])


def soc_identity(cones: Cones) -> np.ndarray:
    e = np.zeros(cones.dim)
    e[cones.first] = 1.0
    return e


def soc_apply(x: np.ndarray, y: np.ndarray, cones: Cones) -> np.ndarray:
    """Jordan product x∘y per cone (reference ``SOCApply``)."""
    out = np.zeros(cones.dim)
    for f, o in zip(cones.first, cones.orders):
        xb, yb = x[f:f + o], y[f:f + o]
        out[f] = xb @ yb
        out[f + 1:f + o] = xb[0] * yb[1:] + yb[0] * xb[1:]
    return out


def soc_inverse(x: np.ndarray, cones: Cones) -> np.ndarray:
    """Jordan inverse per cone."""
    out = np.zeros(cones.dim)
    for f, o in zip(cones.first, cones.orders):
        xb = x[f:f + o]
        det = xb[0] ** 2 - xb[1:] @ xb[1:]
        out[f] = xb[0] / det
        out[f + 1:f + o] = -xb[1:] / det
    return out


def soc_min_eig(s: np.ndarray, cones: Cones) -> float:
    """min over cones of λ_min(s_i) = s₀ − ‖s̄‖ (reference ``SOCMinEig``)."""
    return min(b[0] - np.linalg.norm(b[1:]) for b in cones.blocks(s))


def in_cone(s: np.ndarray, cones: Cones, margin: float = 0.0) -> bool:
    return soc_min_eig(s, cones) > margin


def max_step(s: np.ndarray, ds: np.ndarray, cones: Cones,
             tau: float = 0.995) -> float:
    """Largest α ≤ 1 with s + α·ds ∈ K (fraction-to-boundary, bisection)."""
    lo, hi = 0.0, 1.0
    if in_cone(s + ds, cones):
        return 1.0
    for _ in range(50):
        mid = (lo + hi) / 2
        if in_cone(s + mid * ds, cones):
            lo = mid
        else:
            hi = mid
    return tau * lo


# --------------------------------------------------------------------------
# Order-grouped cone operations on tensors
# --------------------------------------------------------------------------

def _det(sb: torch.Tensor) -> torch.Tensor:
    return sb[:, 0] ** 2 - torch.sum(sb[:, 1:] ** 2, dim=1)


def _jmul(vb: torch.Tensor) -> torch.Tensor:
    """J·v per row, J = diag(1, −1, …, −1)."""
    return torch.cat([vb[:, :1], -vb[:, 1:]], dim=1)


def _jdiag(o: int, like: torch.Tensor) -> torch.Tensor:
    """J = diag(1, −1, …, −1) of order o."""
    j = -torch.ones(o, dtype=like.dtype, device=like.device)
    j[0] = 1.0
    return torch.diag(j)


class ConeOps:
    """Order-grouped cone operations on device tensors: the cones of each
    order are one (count, order) index tensor on ``device``, so every
    per-cone formula is one batched op a group.  An order-1 cone has an
    empty ``[:, 1:]`` slice, and its sums over it are zero."""

    def __init__(self, cones: Cones, *, device):
        orders = np.asarray(cones.orders)
        first = np.asarray(cones.first)
        self.dim = cones.dim
        self.r = len(cones.orders)
        self._host_groups: List[Tuple[int, np.ndarray]] = []
        self.groups: List[Tuple[int, torch.Tensor]] = []
        for o in sorted(set(orders.tolist())):
            f = first[orders == o]
            idx = f[:, None] + np.arange(o)[None, :]
            self._host_groups.append((int(o), idx))
            self.groups.append((int(o), torch.as_tensor(idx).to(device)))

    def _per_cone(self, fn, *vs: torch.Tensor) -> torch.Tensor:
        """Vector out of ``fn(order, *blocks)`` per group, scattered back to
        each cone's positions."""
        out = torch.zeros_like(vs[0])
        for o, idx in self.groups:
            out[idx] = fn(o, *(v[idx] for v in vs))
        return out

    def _blocks(self, fn, v: torch.Tensor) -> torch.Tensor:
        """Flattened per-cone (order × order) blocks of ``fn(order,
        block)``, group-major (the dynamic-slot layout of
        :meth:`dyn_indices`)."""
        return torch.cat([fn(o, v[idx]).reshape(-1)
                          for o, idx in self.groups])

    def min_eig(self, s: torch.Tensor) -> torch.Tensor:
        vals = [torch.min(s[idx][:, 0] - torch.linalg.norm(s[idx][:, 1:],
                                                           dim=1))
                for _, idx in self.groups]
        return torch.min(torch.stack(vals))

    def grad(self, s: torch.Tensor) -> torch.Tensor:
        """∇F(s) = −2·Js/det per cone."""
        return self._per_cone(
            lambda o, sb: -2.0 * _jmul(sb) / _det(sb)[:, None], s)

    def duality(self, s: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        return s @ z / self.r

    def hinv_vals(self, s: torch.Tensor) -> torch.Tensor:
        """Flattened per-cone blocks of (∇²F(s))⁻¹ = ssᵀ − (det/2)·J."""
        return self._blocks(
            lambda o, sb: torch.einsum("ci,cj->cij", sb, sb)
            - 0.5 * _det(sb)[:, None, None] * _jdiag(o, sb)[None], s)

    def hinv_apply(self, s: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """(∇²F(s))⁻¹·v = s(sᵀv) − (det/2)·Jv per cone."""
        return self._per_cone(
            lambda o, sb, vb: sb * torch.sum(sb * vb, dim=1)[:, None]
            - 0.5 * _det(sb)[:, None] * _jmul(vb), s, v)

    def hess_vals(self, z: torch.Tensor) -> torch.Tensor:
        """Flattened per-cone blocks of ∇²F(z) = (4/det²)(Jz)(Jz)ᵀ −
        (2/det)J."""
        def block(o, zb):
            det = _det(zb)[:, None, None]
            jz = _jmul(zb)
            return ((4.0 / det ** 2) * torch.einsum("ci,cj->cij", jz, jz)
                    - (2.0 / det) * _jdiag(o, zb)[None])
        return self._blocks(block, z)

    def hess_apply(self, z: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """∇²F(z)·v = (4/det²)(Jz)((Jz)ᵀv) − (2/det)Jv per cone."""
        def apply(o, zb, vb):
            det = _det(zb)[:, None]
            jz = _jmul(zb)
            dot = torch.sum(jz * vb, dim=1)[:, None]
            return (4.0 / det ** 2) * jz * dot - (2.0 / det) * _jmul(vb)
        return self._per_cone(apply, z, v)

    # -- Jordan/NT-scaling atoms -------------------------------------------

    def jprod(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Jordan product a∘b per cone (device ``SOCApply``)."""
        return self._per_cone(
            lambda o, ab, bb: torch.cat(
                [torch.sum(ab * bb, dim=1, keepdim=True),
                 ab[:, :1] * bb[:, 1:] + bb[:, :1] * ab[:, 1:]], dim=1),
            a, b)

    def jsqrt(self, a: torch.Tensor) -> torch.Tensor:
        """Jordan square root: √a = (a + √det(a)·e)/√(2(a₀ + √det(a)))."""
        def root(o, ab):
            rd = torch.sqrt(torch.clamp(_det(ab), min=0.0))
            denom = torch.sqrt(torch.clamp(2.0 * (ab[:, 0] + rd), min=1e-30))
            return torch.cat([(ab[:, :1] + rd[:, None]) / denom[:, None],
                              ab[:, 1:] / denom[:, None]], dim=1)
        return self._per_cone(root, a)

    def jinv(self, a: torch.Tensor) -> torch.Tensor:
        """Jordan inverse a⁻¹ = J·a / det(a) per cone."""
        return self._per_cone(lambda o, ab: _jmul(ab) / _det(ab)[:, None], a)

    def qrep_apply(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Q_u·v = 2u(uᵀv) − det(u)·Jv per cone (quadratic rep)."""
        return self._per_cone(
            lambda o, ub, vb: 2.0 * ub * torch.sum(ub * vb, dim=1)[:, None]
            - _det(ub)[:, None] * _jmul(vb), u, v)

    def qrep_vals(self, u: torch.Tensor) -> torch.Tensor:
        """Flattened per-cone blocks of Q_u = 2uuᵀ − det(u)·J, group-major
        (matches the dynamic-slot layout)."""
        return self._blocks(
            lambda o, ub: 2.0 * torch.einsum("ci,cj->cij", ub, ub)
            - _det(ub)[:, None, None] * _jdiag(o, ub)[None], u)

    def arrow_solve(self, lam: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """u with λ∘u = q per cone: u₀ = (λ₀q₀ − λ̄ᵀq̄)/det(λ),
        ū = (q̄ − u₀λ̄)/λ₀."""
        def solve(o, lb, qb):
            u0 = (lb[:, 0] * qb[:, 0]
                  - torch.sum(lb[:, 1:] * qb[:, 1:], dim=1)) / _det(lb)
            ut = (qb[:, 1:] - u0[:, None] * lb[:, 1:]) / lb[:, :1]
            return torch.cat([u0[:, None], ut], dim=1)
        return self._per_cone(solve, lam, q)

    def nt_scaling(self, s: torch.Tensor, z: torch.Tensor):
        """Nesterov–Todd scaling point per cone: w = η·w̄ with
        w̄ = (s̃ + Jz̃)/√(2(1 + s̃ᵀz̃)), s̃ = s/√det(s), z̃ = z/√det(z),
        η = (det(s)/det(z))^¼, the unique w with Q_w z = s.  Returns
        (w, w^½, w^{−½}, λ = Q_{w^½} z)."""
        def point(o, sb, zb):
            sd = torch.sqrt(torch.clamp(_det(sb), min=1e-30))
            zd = torch.sqrt(torch.clamp(_det(zb), min=1e-30))
            st = sb / sd[:, None]
            zt = zb / zd[:, None]
            dot = torch.sum(st * zt, dim=1)
            denom = torch.sqrt(torch.clamp(2.0 * (1.0 + dot), min=1e-30))
            wb = (st + _jmul(zt)) / denom[:, None]
            return ((sd / zd) ** 0.5)[:, None] * wb
        w = self._per_cone(point, s, z)
        wh = self.jsqrt(w)
        whi = self.jinv(wh)
        lam = self.qrep_apply(wh, z)
        return w, wh, whi, lam

    def dyn_indices(self, offset: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the per-cone dense blocks, group-major, shifted
        by ``offset``: the dynamic-slot pattern for the KKT builder."""
        rows, cols = [], []
        for o, idx in self._host_groups:
            gi = idx + offset
            rows.append(np.broadcast_to(gi[:, :, None],
                                        (gi.shape[0], o, o)).reshape(-1))
            cols.append(np.broadcast_to(gi[:, None, :],
                                        (gi.shape[0], o, o)).reshape(-1))
        return np.concatenate(rows), np.concatenate(cols)

    def max_step(self, s: torch.Tensor, ds: torch.Tensor,
                 tau: float) -> torch.Tensor:
        """min(1, τ·α*) with α* = sup{α : s + α·ds ∈ K}, analytic: with
        a = det(ds), b = s₀d₀ − s̄ᵀd̄, c = det(s) > 0 the quadratic
        aα² + 2bα + c has its smallest positive root α* = c/(−b + √(b²−ac)),
        existing iff a < 0 or (b < 0 and b² ≥ ac); otherwise the ray stays
        in the cone.  τ always margins the boundary.

        An order-1 cone (s₀ ≥ 0) exits at α* = −s₀/d₀ where d₀ < 0.  Its
        b² − ac is 0 in exact arithmetic, and the JAX package's rounding of
        it to a negative value drops the cone from the step (the iterate
        then leaves the orthant), so the port takes that root directly."""
        inf = float("inf")
        alpha = torch.full((), inf, dtype=s.dtype, device=s.device)
        for o, idx in self.groups:
            sb, db = s[idx], ds[idx]
            if o == 1:
                neg = db[:, 0] < 0
                root = sb[:, 0] / torch.where(neg, -db[:, 0],
                                              torch.ones_like(sb[:, 0]))
                cand = torch.where(neg, root, torch.full_like(root, inf))
                alpha = torch.minimum(alpha, torch.min(cand))
                continue
            a = _det(db)
            b = sb[:, 0] * db[:, 0] - torch.sum(sb[:, 1:] * db[:, 1:], dim=1)
            c = _det(sb)
            disc = b * b - a * c
            sqd = torch.sqrt(torch.clamp(disc, min=0.0))
            exists = (a < 0) | ((b < 0) & (disc >= 0))
            denom = -b + sqd
            root = c / torch.where(denom > 0, denom, torch.ones_like(denom))
            cand = torch.where(exists & (denom > 0), root,
                               torch.full_like(root, inf))
            alpha = torch.minimum(alpha, torch.min(cand))
        return torch.clamp(tau * alpha, max=1.0)


@dataclasses.dataclass
class SOCPResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    s: np.ndarray
    objective: float
    iterations: int
    converged: bool


def _build_socp_kkt(A, G, cones: Cones, gamma: float, delta: float,
                    ordering: Optional[np.ndarray], *, device, dtype):
    """The SOCP's KKT (the affine KKT with one dense order×order block a
    cone in its last block) and the :class:`ConeOps` of ``cones``."""
    ops = ConeOps(cones, device=device)
    kkt = _build_affine_kkt(A, G, gamma, delta, ordering, device=device,
                            dtype=dtype, dyn=ops.dyn_indices(0))
    return kkt, ops


def socp_affine(A, b: np.ndarray, G, h: np.ndarray, c: np.ndarray,
                cones: Cones, ctrl: Optional[LPCtrl] = None, *, device,
                dtype) -> SOCPResult:
    """min cᵀx s.t. Ax = b, Gx + s = h, s ∈ K (reference ``SOCPAffine``) on
    ``device`` in ``dtype``."""
    ctrl = ctrl or LPCtrl()
    dtype = real_working_dtype(dtype)
    device = torch.device(device)
    A, G = _as_sparse(A), _as_sparse(G)
    m, n = A.shape
    if n == 0:
        n = c.shape[0]
        A = SparseMatrix.from_coo(m, n, [], [], np.zeros(0))
    gamma, tol = _resolve_numerics(ctrl, dtype)
    delta = gamma
    kkt, ops = _build_socp_kkt(A, G, cones, gamma, delta, ctrl.ordering,
                               device=device, dtype=dtype)
    reg_diag = kkt.reg
    T = lambda a: torch.as_tensor(a).to(device, dtype)  # noqa: E731
    Ad, Atd = (M.device_csr(device=device, dtype=dtype)
               for M in (A, A.transpose()))
    Gd, Gtd = (M.device_csr(device=device, dtype=dtype)
               for M in (G, G.transpose()))
    bj, hj, cj = T(b), T(h), T(c)
    tau = ctrl.tau
    nref = _resolve_refine(ctrl, dtype)
    ident = T(soc_identity(cones))

    def step(x, y, s, z):
        """NT-scaled Mehrotra predictor-corrector.  NT scaling is
        symmetric (λ = W z = W⁻ᵀs), so both sides stay centered; the KKT
        (3,3) block is −Q_w, and the scaled complementarity gives
        ds = W(v − W dz), v = λ⁻¹∘(target − λ∘λ − corrector)."""
        rb = bj - Ad.matvec(x)
        rh = hj - Gd.matvec(x) - s
        rc = -(cj + Atd.matvec(y) + Gtd.matvec(z))
        mu = ops.duality(s, z)
        gap = s @ z
        pobj = cj @ x
        w, wh, whi, lam = ops.nt_scaling(s, z)
        fact = kkt.prepare(kkt.assemble([-ops.qrep_vals(w)]))
        ctx = fact.default_context()

        def directions(target):
            v = ops.arrow_solve(lam, target - ops.jprod(lam, lam))
            wv = ops.qrep_apply(wh, v)
            rhs = torch.cat([rc, rb, rh - wv])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref, ctx=ctx)
            dx, dy, dz = sol[:n], sol[n:n + m], sol[n + m:]
            ds = wv - ops.qrep_apply(w, dz)
            return dx, dy, dz, ds

        # predictor (affine): target 0
        dxa, dya, dza, dsa = directions(torch.zeros_like(s))
        ap = ops.max_step(s, dsa, 1.0)
        ad = ops.max_step(z, dza, 1.0)
        aa = torch.minimum(ap, ad)
        mu_aff = ((s + aa * dsa) @ (z + aa * dza)) / ops.r
        sigma_m = torch.clamp(torch.where(mu > 0, (mu_aff / mu) ** 3,
                                          torch.zeros_like(mu)), 0.0, 1.0)
        # corrector: σμe − (W⁻ᵀdsₐ)∘(W dzₐ)
        corr = ops.jprod(ops.qrep_apply(whi, dsa), ops.qrep_apply(wh, dza))
        dx, dy, dz, ds = directions(sigma_m * mu * ident - corr)
        alpha = torch.minimum(ops.max_step(s, ds, tau),
                              ops.max_step(z, dz, tau))
        xn, yn = x + alpha * dx, y + alpha * dy
        sn, zn = s + alpha * ds, z + alpha * dz
        # finiteness of the NEW iterate (the residuals are of the input)
        ok = (torch.isfinite(xn).all() & torch.isfinite(yn).all()
              & torch.isfinite(sn).all() & torch.isfinite(zn).all())
        return (xn, yn, sn, zn) + tuple(_host_scalars(
            torch.linalg.norm(rb), torch.linalg.norm(rh),
            torch.linalg.norm(rc), gap, pobj, ok))

    x = torch.zeros(n, dtype=dtype, device=device)
    s = ident.clone()
    z = ident.clone()
    y = torch.zeros(m, dtype=dtype, device=device)

    bn = 1 + float(np.linalg.norm(b))
    hn = 1 + float(np.linalg.norm(h))
    cn = 1 + float(np.linalg.norm(c))
    it = 0
    converged = False
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, sp, zp = x, y, s, z
        x, y, s, z, rbn, rhn, rcn, gap, pobj, ok = step(x, y, s, z)
        if not ok or not np.isfinite(rbn + rcn + gap):
            x, y, s, z = xp, yp, sp, zp
            break
        if (rbn < tol * bn and rhn < tol * hn and rcn < tol * cn
                and gap < tol * (1 + abs(pobj))):
            x, y, s, z = xp, yp, sp, zp
            converged = True
            break
        if ctrl.verbose:
            print(f"  it {it}: gap={gap:.3e} obj={pobj:.8g}")

    x, y, s, z = (v.cpu().numpy() for v in (x, y, s, z))
    return SOCPResult(x, y, z, s, float(c @ x), it, converged)
