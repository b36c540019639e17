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

Values may be real or complex.  ``conjugate`` makes the factor an LDLᴴ of a
Hermitian matrix: the assembly conjugates the entries the symbolic plan
marks (``LevelPlan.asm_conj``), and every product with Lᵀ becomes one with
Lᴴ, as in the JAX package; without it a complex matrix is factored as
complex-symmetric, LDLᵀ.

The fronts are updated in place in the pool (views of it), which keeps the
factor's memory at one pool.  A plain solve takes each level step by
substitution through K10 (``kernels/level_solve.py``), which reads each
front's L panel in place in the pool: forward, it solves the pivot rows in
place and leaves ``-L21·w1`` at the update slots, which K9
(``kernels/level_scatter.py``) adds into their rows; backward, it solves
the pivot rows alone.  A solve with the panel inverses (the solve context)
takes each level step as one batched product, whose result K9 adds back
over the level's real slots.  Both follow the plans of ``solve_plan.py``
and never touch a padded front slot.

Precision: the factor, the solves and the panel inverses run with TF32 off
(:func:`full_fp32_matmul`, which covers complex64 products too), as the JAX
package pins
``default_matmul_precision("highest")``: low-precision products destroy the
quasi-definite KKT factor (EXPERIMENTS §E5.3).

The JAX package eliminates a level of at most ``panel_blocksize`` columns by
a rank-1 column loop and a wider one by the blocked kernel; the port takes
the blocked kernel (K8 panels) on every LDLᵀ level.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..core.policy import tf32
from ..core.profiling import profile_region, profiled
from ..kernels.extend_add import extend_add
from ..kernels.front_panel import NB, ldl_panel
from ..kernels.level_scatter import level_scatter
from ..kernels.level_solve import level_solve
from ..utils import transfers
from .dist_front import PANEL, dist_partial_ldl, padded_size
from .ea_plan import EAPlan
from .symbolic import SymbolicFactorization

# run the block with TF32 off; restore the caller's setting after
full_fp32_matmul = functools.partial(tf32, False)


def _masked_partial_ldl_blocked(F, ns, max_ns: int, conjugate: bool,
                                nb: int = 32, pf=None):
    """Eliminate the first ``ns[f]`` columns of each padded front ``F[f]``
    (nf×S×S, lower), in place: unit L in the panel, D on the diagonal, the
    Schur complement in the trailing block (L·D·Lᴴ with ``conjugate``).
    ``pf``: optional (nf, S) signed pivot floors (see
    ``kernels.front_panel._clamp_pivot``).

    Blocked right-looking (reference ``ProcessFront.hpp:29-60``): per
    nb-column panel, the panel's eliminations for every front in one call
    of ``kernels.front_panel.ldl_panel`` (K8 on the card), then the
    trailing rank-nb update U = (Lp·dp)·Lpᵀ (Lpᴴ) on columns ≥ j1, rows
    ≥ j0, as one batched matmul.  A level of at most nb columns is one
    panel; the ragged last panel is a narrower one.  Where the rest of the
    front fits one panel or one K8 launch (:data:`NB` columns), the panel
    runs to its end: the Schur complement then takes the panel's rank-1
    updates, without the product (one launch, and on a Hermitian front a
    diagonal that stays real, as the column loop leaves it)."""
    nf, S, _ = F.shape
    nb = max(1, min(nb, max_ns))
    arrivals = torch.zeros(nf, dtype=torch.int32, device=F.device)
    for j0 in range(0, max_ns, nb):
        if S - j0 <= max(nb, NB):
            ldl_panel(F, ns, j0, S - j0, conjugate, pf, arrivals=arrivals)
            break
        j1 = j0 + nb
        # the masked panel and Lp·dp, rows ≥ j0 (K8 writes them)
        Lp = F.new_empty(nf, S - j0, nb)
        LD = torch.empty_like(Lp)
        ldl_panel(F, ns, j0, nb, conjugate, pf, Lp, LD, arrivals)
        Lt = Lp[:, nb:, :]
        F[:, j0:, j1:] -= torch.matmul(LD, Lt.mH if conjugate else Lt.mT)
    return F


def _masked_partial_spd(F, ns, max_ns: int, conjugate: bool):
    """SPD (HPD with ``conjugate``) path, in place: masked batched Cholesky
    of the leading block, one triangular solve for the panel, one matmul for
    the Schur complement.
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
    up = torch.tril(lead, -1)
    lead = torch.tril(lead) + (up.mH if conjugate else up.mT)
    maskb = (im[None, :, None] < nsb) & (im[None, None, :] < nsb)
    A11 = torch.where(maskb, lead, torch.eye(m, dtype=dt, device=dev))
    L11, info = torch.linalg.cholesky_ex(A11)
    L11 = torch.where((info == 0)[:, None, None], L11,
                      torch.full((), float("nan"), dtype=dt, device=dev))
    colm = im[None, None, :] < nsb
    zero = torch.zeros((), dtype=dt, device=dev)
    B = torch.where(colm, F[:, :, :m], zero)
    # P·L11ᵀ = B (P·L11ᴴ = B)  ⇒  P = the Cholesky panel (rows of L), S×m
    P = torch.linalg.solve_triangular(L11.mH if conjugate else L11.mT, B,
                                      upper=True, left=False)
    dm = torch.diagonal(L11, dim1=-2, dim2=-1)
    Lunit = P / dm[:, None, :]
    panel = torch.where(colm & (iS[None, :, None] > im[None, None, :]),
                        Lunit, F[:, :, :m])
    panel = torch.where(colm & (iS[None, :, None] == im[None, None, :]),
                        (dm * dm)[:, None, :], panel)
    U = torch.matmul(P, P.mH if conjugate else P.mT)
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
    conjugate: bool = False      # L·D·Lᴴ (Hermitian) instead of L·D·Lᵀ

    # -- solves -------------------------------------------------------------
    @profiled("el.ldl.solve")
    def solve(self, b, ctx=None) -> torch.Tensor:
        """x = A⁻¹·b by forward, diagonal and backward tree solves.
        ``ctx``: the panel inverses from :meth:`solve_context`."""
        with full_fp32_matmul():
            return self._solve_impl(b, ctx)

    @profiled("el.ldl.solve_context")
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
        # x extended with a zero row that the padded front slots read
        xe = torch.cat([x[symb.perm], x.new_zeros((1, k))])
        # K10's forward buffer of -L21·w1, one level's slots
        delta = (xe.new_empty(symb.solve_plan.max_level_slots, k)
                 if ctx is None else None)
        levels = range(len(symb.levels))
        for i in levels:
            with profile_region("el.ldl.solve.forward"):
                self._level_solve(xe, i, True, ctx, delta)
        xe[:n] = xe[:n] / self.d[:, None]
        for i in reversed(levels):
            with profile_region("el.ldl.solve.backward"):
                self._level_solve(xe, i, False, ctx, delta)
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

    def _adjoint(self, m: torch.Tensor) -> torch.Tensor:
        """The batch's transposes, conjugated for a Hermitian factor."""
        return m.mH if self.conjugate else m.mT

    def _level_solve(self, xe, i: int, forward: bool, ctx=None,
                     delta=None) -> None:
        """Level ``i`` of the forward (or backward) tree solve, in place on
        the extended right-hand side ``xe``.  With the solve context
        ``ctx``, one batched product with the panel inverses, added back by
        K9 over the level's real slots; without it, K10's substitution
        (forward: K9 then adds the level's ``-L21·w1`` from ``delta``)."""
        lev = self.symb.levels[i]
        plan = self.symb.solve_plan
        if ctx is not None:
            # backward: L⁻ᵀ, or conj(L⁻ᵀ) = L⁻ᴴ for a Hermitian factor
            linv = ctx[i]
            xf = xe[lev.front_rows]                        # (nf, S, k)
            w = torch.matmul(linv if forward else self._adjoint(linv), xf)
            level_scatter(xe, w.contiguous(), xf, plan.levels[i])
            return
        sub = plan.substitution[i]
        level_solve(xe, self.pool, lev, sub, forward, self.conjugate, delta)
        if forward and sub.update.n_rows:
            level_scatter(xe, delta, None, sub.update)

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
        """y = L·x (or Lᵀ·x, Lᴴ·x for a Hermitian factor) in permuted order
        (reference ``MultiplyWithL``)."""
        with full_fp32_matmul():
            xe = torch.as_tensor(x).to(self.pool.device, self.pool.dtype)
            squeeze = xe.dim() == 1
            if squeeze:
                xe = xe[:, None]
            xe = torch.cat([xe, xe.new_zeros((1, xe.shape[1]))])
            # y = x + Σ_panels (L−I)_panel·x: panel contributions are linear
            # in the ORIGINAL x (columns are disjoint across supernodes)
            ye = xe.clone()
            for lev, scatter in zip(self.symb.levels,
                                    self.symb.solve_plan.levels):
                lp = self._level_panels(lev)
                if adjoint:
                    lp = self._adjoint(lp)
                xf = xe[lev.front_rows]
                level_scatter(ye, torch.matmul(lp, xf), xf, scatter)
            out = ye[:self.symb.n]
            return out[:, 0] if squeeze else out

    def inertia(self):
        """(#positive, #negative, #zero) pivots, by their real parts."""
        d = self.d.real
        return (int((d > 0).sum()), int((d < 0).sum()), int((d == 0).sum()))


# the batch split's threshold (the JAX package's, ``_shard_level``): a
# level is split over the positions when it has at least one front a
# position and nf·S³ reaches it
SPLIT_MIN_WORK = 2e9

# the default order from which a level of at most 8 fronts takes the
# distributed front factor (``dist_front.py``) on a grid: the JAX package's
# accelerator value
DIST_FRONT_MIN = 1536


def level_tier(lev, *, grid, spd: bool, dtype, dist_front_min: int) -> str:
    """How :func:`factor` takes the level ``lev``, which is also the suffix
    of its ``el.ldl.front.*`` span:

    * "dist": on a grid, a real level of at most 8 fronts of order ≥
      ``dist_front_min``, front by front over every position
      (``dist_front.dist_partial_ldl``);
    * "split": on a grid, a level of at least ``grid.size`` fronts and
      nf·S³ ≥ :data:`SPLIT_MIN_WORK`, cut into chunks over the positions
      (:func:`_shard_level`), each taking the one-device kernel;
    * otherwise the one-device kernel: "spd" (:func:`_masked_partial_spd`)
      or "blocked" (:func:`_masked_partial_ldl_blocked`)."""
    nf, S = lev.sn_ids.shape[0], lev.front_size
    if grid is not None:
        if S >= dist_front_min and nf <= 8 and not dtype.is_complex:
            return "dist"
        if nf >= grid.size and nf * S ** 3 >= SPLIT_MIN_WORK:
            return "split"
    return "spd" if spd else "blocked"


@profiled("el.ldl.factor")
def factor(symb: SymbolicFactorization, a_vals, *, ea_plan: EAPlan, dtype,
           conjugate: bool = False, reg=None, spd: bool = False,
           pivot_floor=None, panel_blocksize: int = 32, grid=None,
           tree_axis=None,
           dist_front_min: int = DIST_FRONT_MIN) -> LDLFactorization:
    """Numeric multifrontal LDL from the symbolic plan (on the device, see
    ``SymbolicFactorization.to``) and A's values in original entry order.

    ``conjugate``: factor a Hermitian A as L·D·Lᴴ (a complex A is
    otherwise complex-symmetric, L·D·Lᵀ; a real A does not notice).
    ``reg``: optional diagonal regularization in *original* order (the
    ``RegularizedLDL`` path).  ``spd``: the Cholesky front kernel (A must be
    positive definite).  ``pivot_floor``: optional (n,) SIGNED pivot floors
    in original order (see ``kernels.front_panel._clamp_pivot``).
    ``panel_blocksize``: the LDL kernel's panel width.
    ``ea_plan``: the extend-add plan of ``symb`` (``ea_plan.build_ea_plan``),
    applied through K1.

    ``grid``: optional ``core.Grid``; the pool stays on the plan's device
    (the grid's first position's, from the facade) and two tiers of levels
    go to the positions (reference subtree→subteam mapping,
    ``Process.hpp:150-275``, and L2D fronts, ``numeric.hpp:29-38``), as
    :func:`level_tier` chooses: a "dist" level front by front over every
    position (SPD fronts too, by the LDL elimination, as in JAX), a
    "split" level in contiguous chunks over the positions of ``tree_axis``
    (an axis name or a tuple of them; default ``'mc'``, the JAX mesh's
    first axis), each factored by the one-device kernel on its position's
    device.

    Each result's return to the replicated pool is recorded in an open
    ``utils.transfers.count_transfers`` log as the ``all-gather`` the JAX
    package needs."""
    with full_fp32_matmul():
        return _factor_impl(symb, a_vals, ea_plan, dtype, reg, spd,
                            pivot_floor, panel_blocksize, conjugate, grid,
                            tree_axis, dist_front_min)


def _record_replication(parts, holders, positions: int) -> None:
    """Record the ``all-gather`` that replicates a tensor cut into
    ``parts`` at each of ``positions`` positions; ``holders[c]``: the
    positions that already hold part c."""
    if not transfers.recording:
        return
    shape = (sum(t.shape[0] for t in parts),) + tuple(parts[0].shape[1:])
    for q in range(positions):
        transfers.record("all-gather", (shape, parts[0].dtype),
                         [(t, q if q in held else held[0])
                          for t, held in zip(parts, holders)], q)


def _shard_level(fronts, ns, max_ns: int, pf, grid, tree_axis,
                 kernel) -> None:
    """Split a level's batch into contiguous chunks over the positions of
    ``tree_axis`` (JAX ``_shard_level``: the batch axis sharded over that
    axis, sibling subtrees to positions; chunks of ⌈nf/c⌉ fronts, the
    uneven tiling of a ``NamedSharding``) and factor each with ``kernel``
    on its first holder's device, in place in the pool.  The chunks of
    other devices than the pool's are copied out and launched first, so
    the devices factor at once; then the pool's own, then the returns
    (``transfers.peer_copy``: the host does not wait)."""
    nchunks = grid.axis_size(tree_axis)
    holders = [[] for _ in range(nchunks)]
    for q, (i, j) in enumerate(grid.positions()):
        holders[grid.chunk_index(tree_axis, i, j)].append(q)
    size = -(-fronts.shape[0] // nchunks)
    devs = [grid.device(i, j) for i, j in grid.positions()]
    parts = [fronts[c * size:(c + 1) * size] for c in range(nchunks)]
    order = sorted((c for c in range(nchunks) if parts[c].shape[0]),
                   key=lambda c: devs[holders[c][0]] == fronts.device)
    done = []
    for c in order:
        dev = devs[holders[c][0]]
        cut = slice(c * size, (c + 1) * size)
        work = transfers.peer_copy(parts[c], dev)
        kernel(work, transfers.peer_copy(ns[cut], dev), max_ns,
               None if pf is None else transfers.peer_copy(pf[cut], dev))
        done.append((parts[c], work))
    with profile_region("el.ldl.dist.return"):
        for sub, work in done:
            if work is not sub:
                transfers.peer_copy_(sub, work)
    _record_replication(parts, holders, grid.size)


def _factor_impl(symb, a_vals, ea_plan, dtype, reg, spd, pivot_floor,
                 panel_blocksize, conjugate, grid=None, tree_axis=None,
                 dist_front_min=DIST_FRONT_MIN):
    dev = symb.perm.device
    with_children = {li for li, lev in enumerate(symb.levels)
                     if lev.child_dst.numel()}
    if ea_plan.pool_size != symb.pool_size or \
            set(ea_plan.levels) != with_children:
        raise ValueError("extend-add plan does not belong to this "
                         "symbolic factorization")
    # only a complex Hermitian factor reads the value map's conjugation mask
    hermitian = conjugate and dtype.is_complex
    if hermitian and any(lev.asm_conj is None for lev in symb.levels):
        raise ValueError("this symbolic plan has no Hermitian value map "
                         "(from_reference without its matrix)")
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
    with profile_region("el.ldl.assemble"):
        for lev in symb.levels:
            if lev.asm_dst.numel():
                vals = a_vals[lev.asm_src]
                if hermitian:
                    vals = torch.where(lev.asm_conj, vals.conj(), vals)
                pool.index_add_(0, lev.asm_dst, vals)
            if regp is not None and lev.diag_dst.numel():
                pool.index_add_(0, lev.diag_dst, regp[lev.diag_cols])

    if spd:
        def kernel(fronts, ns, max_ns, pf):
            _masked_partial_spd(fronts, ns, max_ns, conjugate)
    else:
        def kernel(fronts, ns, max_ns, pf):
            _masked_partial_ldl_blocked(fronts, ns, max_ns, conjugate,
                                        nb=panel_blocksize, pf=pf)

    if tree_axis is None:
        tree_axis = "mc"
    d = torch.zeros(symb.n, dtype=dtype, device=dev)
    for li, lev in enumerate(symb.levels):
        with profile_region("el.ldl.level"):
            if li in ea_plan.levels:
                with profile_region("el.ldl.extend_add"):
                    extend_add(pool, ea_plan.levels[li])
            nf = lev.sn_ids.shape[0]
            S = lev.front_size
            fronts = pool[lev.offset:lev.offset + nf * S * S].view(nf, S, S)
            max_ns = int(lev.ns.max())
            ns = torch.as_tensor(lev.ns).to(dev)
            pf = None if pfp is None or spd else pfp[lev.front_rows]
            tier = level_tier(lev, grid=grid, spd=spd, dtype=dtype,
                              dist_front_min=dist_front_min)
            with profile_region("el.ldl.front." + tier):
                if tier == "dist":
                    pfd = None if pfp is None else pfp[lev.front_rows]
                    rl = padded_size(S, PANEL, grid.size) // grid.size
                    for f in range(nf):
                        dist_partial_ldl(fronts[f], int(lev.ns[f]), grid,
                                         conjugate=conjugate,
                                         pf=None if pfd is None else pfd[f])
                        _record_replication(
                            [fronts[f][q * rl:(q + 1) * rl]
                             for q in range(grid.size)],
                            [[q] for q in range(grid.size)], grid.size)
                elif tier == "split":
                    _shard_level(fronts, ns, max_ns, pf, grid, tree_axis,
                                 kernel)
                else:
                    kernel(fronts, ns, max_ns, pf)
            d[lev.diag_cols] = pool[lev.diag_dst]
    return LDLFactorization(symb, pool, d, conjugate)
