"""Multifrontal numeric factorization and tree solves (counterpart of
``elemental_tpu/sparse_direct/numeric.py``; reference
``src/lapack_like/factor/LDL/sparse/numeric``: ``Process.hpp:150-275``
extend-add, ``ProcessFront.hpp:29-60`` dense front kernel,
``LowerSolve/Forward.hpp:77-183`` tree solves).

The elimination tree is processed level by level.  Each level is a batch of
padded fronts in one flat pool; per level the factor runs

  1. the extend-add of every child Schur complement into its parent front,
     through the Hopper kernel K1 (``kernels/extend_add.py``) on every level
     that has children;
  2. a batched masked *partial* LDL of all fronts of the level (the Schur
     complement is left in place).

The fronts are updated in place in the pool (views of it), which keeps the
factor's memory at one pool.  Solves use the padded-unit trick: the partial
factor extended with an identity trailing block makes one batched triangular
solve per level do both the panel solve and the update accumulation.

Precision: the factor, the solves and the panel inverses run with TF32 off
(:func:`full_fp32_matmul`), as the JAX package pins
``default_matmul_precision("highest")``: low-precision products destroy the
quasi-definite KKT factor (EXPERIMENTS §E5.3).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..kernels.extend_add import extend_add
from .ea_plan import EAPlan
from .symbolic import SymbolicFactorization


@contextlib.contextmanager
def full_fp32_matmul():
    """Run the block with TF32 off for cuBLAS and cuDNN; restore after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _clamp_pivot(dk, s):
    """Dynamic pivot regularization (reference ``RegularizedLDL``): where a
    signed floor s ≠ 0 is given, boost a too-small pivot's MAGNITUDE to |s|,
    keeping the pivot's own sign (an exactly-zero pivot takes s's sign)."""
    mag = torch.abs(s)
    keep = torch.where(dk == 0, torch.sign(s), torch.sign(dk))
    return torch.where((s != 0) & (torch.abs(dk) < mag), keep * mag, dk)


def _masked_partial_ldl(F, ns, max_ns: int, pf=None):
    """Eliminate the first ``ns[f]`` columns of each padded front ``F[f]``
    (nf×S×S, lower), in place: unit L in the panel, D on the diagonal, the
    Schur complement in the trailing block.  ``pf``: optional (nf, S)
    signed pivot floors (see :func:`_clamp_pivot`)."""
    S = F.shape[1]
    idx = torch.arange(S, device=F.device)
    for k in range(max_ns):
        elim = ns > k
        dk = F[:, k, k].clone()
        if pf is not None:
            dk = torch.where(elim, _clamp_pivot(dk, pf[:, k]), dk)
        safe = torch.where(dk == 0, torch.ones_like(dk), dk)
        below = (idx > k)[None, :] & elim[:, None]
        col = torch.where(below, F[:, :, k] / safe[:, None],
                          torch.zeros((), dtype=F.dtype, device=F.device))
        # the rank-1 update touches only (i, j) > k: col is 0 elsewhere
        c = col[:, k + 1:]
        F[:, k + 1:, k + 1:] -= c[:, :, None] * c[:, None, :] \
            * dk[:, None, None]
        F[:, :, k] = torch.where(below, col, F[:, :, k])
        F[:, k, k] = dk
    return F


def _masked_partial_ldl_blocked(F, ns, max_ns: int, nb: int = 32,
                                pf=None):
    """Blocked right-looking variant of :func:`_masked_partial_ldl`
    (reference ``ProcessFront.hpp:29-60``): per nb-column panel, rank-1
    eliminations inside the S×nb panel, then the trailing rank-nb update as
    one batched matmul.  Same update domain as the rank-1 version."""
    nf, S, _ = F.shape
    nb = max(1, min(nb, max_ns))
    npan = -(-max_ns // nb)
    Sp = max(S, npan * nb)
    Fw = F
    if Sp != S:
        Fw = torch.nn.functional.pad(F, (0, Sp - S, 0, Sp - S))
        if pf is not None:
            pf = torch.nn.functional.pad(pf, (0, Sp - S))
    idx = torch.arange(Sp, device=F.device)
    tpan = torch.arange(nb, device=F.device)
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    for p in range(npan):
        j0, j1 = p * nb, (p + 1) * nb
        Fp = Fw[:, :, j0:j1].clone()
        for kk in range(nb):
            k = j0 + kk
            elim = ns > k
            dk = Fp[:, k, kk].clone()
            if pf is not None:
                dk = torch.where(elim, _clamp_pivot(dk, pf[:, k]), dk)
            safe = torch.where(dk == 0, torch.ones_like(dk), dk)
            below = (idx > k)[None, :] & elim[:, None]
            col = torch.where(below, Fp[:, :, kk] / safe[:, None], zero)
            # within-panel update: rows > k, panel columns > kk
            Fp[:, k + 1:, kk + 1:] -= col[:, k + 1:, None] \
                * col[:, None, k + 1:j1] * dk[:, None, None]
            Fp[:, :, kk] = torch.where(below, col, Fp[:, :, kk])
            Fp[:, k, kk] = dk
        Fw[:, :, j0:j1] = Fp
        if j1 < Sp:
            # trailing rank-nb update U = (Lp·dp)·Lpᵀ on columns ≥ j1
            prow = j0 + tpan
            dp = Fp[:, prow, tpan]
            # non-eliminated panel columns (pivot ≥ ns) hold Schur data
            keep = ((idx[:, None] > prow[None, :])[None]
                    & (prow[None, None, :] < ns[:, None, None]))
            Lp = torch.where(keep, Fp, zero)
            Fw[:, :, j1:] -= torch.matmul(Lp * dp[:, None, :],
                                          Lp[:, j1:, :].transpose(1, 2))
    if Sp != S:
        F.copy_(Fw[:, :S, :S])
    return F


def _masked_partial_spd(F, ns, max_ns: int):
    """SPD path, in place: masked batched Cholesky of the leading block, one
    triangular solve for the panel, one matmul for the Schur complement.
    Same pool layout as the LDL kernels (unit-L panel, D on the diagonal).
    A front that is not positive definite comes out NaN, as in the JAX
    package, without a device synchronisation."""
    S = F.shape[1]
    m = int(max_ns)
    dev, dt = F.device, F.dtype
    im = torch.arange(m, device=dev)
    iS = torch.arange(S, device=dev)
    nsb = ns[:, None, None]
    lead = F[:, :m, :m]
    # fronts carry only the lower triangle; Cholesky reads a full matrix
    lead = torch.tril(lead) + torch.tril(lead, -1).transpose(1, 2)
    maskb = (im[None, :, None] < nsb) & (im[None, None, :] < nsb)
    A11 = torch.where(maskb, lead, torch.eye(m, dtype=dt, device=dev))
    L11, info = torch.linalg.cholesky_ex(A11)
    L11 = torch.where((info == 0)[:, None, None], L11,
                      torch.full((), float("nan"), dtype=dt, device=dev))
    colm = im[None, None, :] < nsb
    zero = torch.zeros((), dtype=dt, device=dev)
    B = torch.where(colm, F[:, :, :m], zero)
    # P·L11ᵀ = B  ⇒  P = the Cholesky panel (rows of L), S×m
    P = torch.linalg.solve_triangular(L11.transpose(1, 2), B, upper=True,
                                      left=False)
    dm = torch.diagonal(L11, dim1=-2, dim2=-1)
    Lunit = P / dm[:, None, :]
    panel = torch.where(colm & (iS[None, :, None] > im[None, None, :]),
                        Lunit, F[:, :, :m])
    panel = torch.where(colm & (iS[None, :, None] == im[None, None, :]),
                        (dm * dm)[:, None, :], panel)
    U = torch.matmul(P, P.transpose(1, 2))
    F[:, :, :m] = panel
    F -= U * (iS[None, None, :] >= nsb)
    return F


@dataclasses.dataclass
class LDLFactorization:
    """Numeric factor state (reference ``(Dist)SparseLDLFactorization``,
    ``numeric.hpp:550``).  ``symb`` holds tensors (``.to(device)``)."""

    symb: SymbolicFactorization
    pool: torch.Tensor           # flat packed fronts (L panels + Schur)
    d: torch.Tensor              # (n,) pivots in permuted order

    # -- solves -------------------------------------------------------------
    def solve(self, b, ctx=None) -> torch.Tensor:
        """x = A⁻¹·b by forward, diagonal and backward tree solves.
        ``ctx``: the panel inverses from :meth:`solve_context`."""
        with full_fp32_matmul():
            return self._solve_impl(b, ctx)

    def solve_context(self):
        """Per-level explicit panel inverses L⁻¹, computed once per factor:
        every later solve's level step is then one batched matmul.  Applying
        an explicit inverse bounds the residual by eps·κ(L_panel) instead of
        substitution's eps·‖L‖, so the context is meant for a Krylov wrapper
        (``KKTFactor.solve_refined``), not the plain direct solve."""
        with full_fp32_matmul():
            out = []
            for lev in self.symb.levels:
                lp = self._level_panels(lev)
                eye = torch.eye(lev.front_size, dtype=lp.dtype,
                                device=lp.device)
                out.append(torch.linalg.solve_triangular(
                    lp, eye.expand_as(lp), upper=False, unitriangular=True))
            return tuple(out)

    def _solve_impl(self, b, ctx=None) -> torch.Tensor:
        symb = self.symb
        n = symb.n
        x = torch.as_tensor(b).to(self.pool.device, self.pool.dtype)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[:, None]
        k = x.shape[1]
        # x extended with a dummy row absorbing padded scatter traffic
        xe = torch.cat([x[symb.perm], x.new_zeros((1, k))])
        for i, lev in enumerate(symb.levels):
            self._level_solve(xe, lev, True, None if ctx is None else ctx[i])
        xe[:n] = xe[:n] / self.d[:, None]
        for i in reversed(range(len(symb.levels))):
            self._level_solve(xe, symb.levels[i], False,
                              None if ctx is None else ctx[i])
        out = xe[:n][symb.iperm]
        return out[:, 0] if squeeze else out

    def _level_fronts(self, lev) -> torch.Tensor:
        nf = lev.sn_ids.shape[0]
        S = lev.front_size
        return self.pool[lev.offset:lev.offset + nf * S * S].view(nf, S, S)

    def _level_panels(self, lev) -> torch.Tensor:
        """Masked unit-lower panels (nf, S, S) of one level."""
        S = lev.front_size
        fronts = self._level_fronts(lev)
        idx = torch.arange(S, device=fronts.device)
        ns = torch.as_tensor(lev.ns).to(fronts.device)
        keep = ((idx[None, None, :] < ns[:, None, None])
                & (idx[None, :, None] > idx[None, None, :]))
        eye = torch.eye(S, dtype=fronts.dtype, device=fronts.device)
        return torch.where(keep, fronts, torch.zeros(
            (), dtype=fronts.dtype, device=fronts.device)) + eye

    def _level_solve(self, xe, lev, forward: bool, linv=None) -> None:
        """One level of the forward (or backward) tree solve, in place on
        the extended right-hand side ``xe``."""
        rows = lev.front_rows                              # (nf, S)
        xf = xe[rows]                                      # (nf, S, k)
        if linv is not None:
            w = torch.matmul(linv if forward else linv.transpose(1, 2), xf)
        else:
            lp = self._level_panels(lev)
            if forward:
                w = torch.linalg.solve_triangular(lp, xf, upper=False,
                                                  unitriangular=True)
            else:
                w = torch.linalg.solve_triangular(
                    lp.transpose(1, 2), xf, upper=True, unitriangular=True)
        delta = w - xf
        xe.index_add_(0, rows.reshape(-1), delta.reshape(-1, xe.shape[1]))

    def solve_with_iterative_refinement(self, A_apply, b, iters: int = 6):
        """x ← x + F⁻¹(b − A·x) (reference ``SolveWithIterativeRefinement``,
        ``DistSparseLDLFactorization.cpp:264``)."""
        b = torch.as_tensor(b).to(self.pool.device, self.pool.dtype)
        x = self.solve(b)
        for _ in range(iters):
            x = x + self.solve(b - A_apply(x))
        return x

    # -- products ------------------------------------------------------------
    def multiply_with_l(self, x, adjoint: bool = False) -> torch.Tensor:
        """y = L·x (or Lᵀ·x) in permuted order (reference
        ``MultiplyWithL``)."""
        with full_fp32_matmul():
            xe = torch.as_tensor(x).to(self.pool.device, self.pool.dtype)
            squeeze = xe.dim() == 1
            if squeeze:
                xe = xe[:, None]
            xe = torch.cat([xe, xe.new_zeros((1, xe.shape[1]))])
            # y = x + Σ_panels (L−I)_panel·x: panel contributions are linear
            # in the ORIGINAL x (columns are disjoint across supernodes)
            ye = xe.clone()
            for lev in self.symb.levels:
                lp = self._level_panels(lev)
                if adjoint:
                    lp = lp.transpose(1, 2)
                rows = lev.front_rows
                xf = xe[rows]
                yf = torch.matmul(lp, xf)
                ye.index_add_(0, rows.reshape(-1),
                              (yf - xf).reshape(-1, xf.shape[-1]))
            out = ye[:self.symb.n]
            return out[:, 0] if squeeze else out

    def inertia(self):
        """(#positive, #negative, #zero) pivots."""
        d = self.d
        return (int((d > 0).sum()), int((d < 0).sum()), int((d == 0).sum()))


def factor(symb: SymbolicFactorization, a_vals, *, ea_plan: EAPlan, dtype,
           reg=None, spd: bool = False, pivot_floor=None,
           panel_blocksize: int = 32) -> LDLFactorization:
    """Numeric multifrontal LDL from the symbolic plan (on the device, see
    ``SymbolicFactorization.to``) and A's values in original entry order.

    ``reg``: optional diagonal regularization in *original* order (the
    ``RegularizedLDL`` path).  ``spd``: the Cholesky front kernel (A must be
    positive definite).  ``pivot_floor``: optional (n,) SIGNED pivot floors
    in original order (see :func:`_clamp_pivot`).  ``panel_blocksize``:
    levels eliminating more columns than this use the blocked LDL kernel.
    ``ea_plan``: the extend-add plan of ``symb`` (``ea_plan.build_ea_plan``),
    applied through K1."""
    with full_fp32_matmul():
        return _factor_impl(symb, a_vals, ea_plan, dtype, reg, spd,
                            pivot_floor, panel_blocksize)


def _factor_impl(symb, a_vals, ea_plan, dtype, reg, spd, pivot_floor,
                 panel_blocksize):
    dev = symb.perm.device
    with_children = {li for li, lev in enumerate(symb.levels)
                     if lev.child_dst.numel()}
    if ea_plan.pool_size != symb.pool_size or \
            set(ea_plan.levels) != with_children:
        raise ValueError("extend-add plan does not belong to this "
                         "symbolic factorization")
    a_vals = torch.as_tensor(a_vals).to(dev, dtype)
    pool = torch.zeros(symb.pool_size, dtype=dtype, device=dev)
    pfp = None
    if pivot_floor is not None:
        # permuted floors, with a trailing 0 row absorbing padded gathers
        pfp = torch.cat([torch.as_tensor(pivot_floor).to(dev, dtype)[
            symb.perm], torch.zeros(1, dtype=dtype, device=dev)])
    regp = None
    if reg is not None:
        regp = torch.as_tensor(reg).to(dev, dtype)[symb.perm]

    # assemble every level's A entries up front (independent of elimination)
    for lev in symb.levels:
        if lev.asm_dst.numel():
            pool.index_add_(0, lev.asm_dst, a_vals[lev.asm_src])
        if regp is not None and lev.diag_dst.numel():
            pool.index_add_(0, lev.diag_dst, regp[lev.diag_cols])

    d = torch.zeros(symb.n, dtype=dtype, device=dev)
    for li, lev in enumerate(symb.levels):
        if li in ea_plan.levels:
            extend_add(pool, ea_plan.levels[li])
        nf = lev.sn_ids.shape[0]
        S = lev.front_size
        fronts = pool[lev.offset:lev.offset + nf * S * S].view(nf, S, S)
        max_ns = int(lev.ns.max())
        ns = torch.as_tensor(lev.ns).to(dev)
        if spd:
            _masked_partial_spd(fronts, ns, max_ns)
        else:
            pf = None if pfp is None else pfp[lev.front_rows]
            if max_ns > panel_blocksize:
                _masked_partial_ldl_blocked(fronts, ns, max_ns,
                                            nb=panel_blocksize, pf=pf)
            else:
                _masked_partial_ldl(fronts, ns, max_ns, pf=pf)
        d[lev.diag_cols] = pool[lev.diag_dst]
    return LDLFactorization(symb, pool, d)
