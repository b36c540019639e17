"""Driver entry points (counterpart of ``__graft_entry__.py``).

``entry()``: the single-card forward step, 25 CG iterations on the
unscaled 64² Laplacian in its ELL form, float32, plain torch.

    forward, args = entry()          # on the card
    x, rnorm = forward(*args)

``dryrun_multichip(n)``: one distributed step over an n-position grid,
each piece checked: SUMMA gemm, the dense Cholesky solve, CG on a
``DistSparseMatrix``, the distributed multifrontal factor of a 3-D
Laplacian with its factor rate on the grid beside one position,
``dist_spgemm`` and one sparse IPM solve; then the weak-scaling table
(``_weak_scaling``) with the transfer log's bytes (``utils/transfers.py``)
in place of the JAX package's HLO audit.  The grid's positions may repeat
one device (one card, or the CPU): then the run proves the distributed
code and counts its bytes; it measures no speed-up.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import torch

from .matrices import sparse_laplacian_2d

# the netlib LP the dry run solves when the file is in the repository (the
# JAX dry run reads it from the reference's data); else a synthetic LP
AFIRO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "optimization", "afiro.mps")
AFIRO_OBJECTIVE = -464.75314286

ITERATIONS = 25


def entry(device=None):
    """Return ``(forward, (cols, vals, b))`` on ``device`` (default
    ``cuda``); ``forward(cols, vals, b)`` returns ``(x, ‖r‖)``."""
    device = torch.device("cuda" if device is None else device)
    n1 = 64
    A = sparse_laplacian_2d(n1, n1, scaled=False)
    ell = A.device_ell(device=device, dtype=torch.float32)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(n1 * n1)
                         .astype(np.float32)).to(device)

    def forward(cols, vals, b):
        def matvec(x):
            return torch.sum(vals * x[cols], dim=1)

        x = torch.zeros_like(b)
        r = b - matvec(x)
        p = r
        rz = torch.dot(r, r)
        for _ in range(ITERATIONS):
            ap = matvec(p)
            alpha = rz / torch.dot(p, ap)
            x = x + alpha * p
            r = r - alpha * ap
            rz_new = torch.dot(r, r)
            p = r + (rz_new / rz) * p
            rz = rz_new
        return x, torch.linalg.norm(r)

    return forward, (ell.cols, ell.vals, b)


def _grid_on(devices):
    """A near-square grid over ``devices`` (the JAX dry run's height)."""
    from .core import Grid
    n = len(devices)
    h = int(math.isqrt(n))
    while n % h:
        h -= 1
    return Grid(devices=devices, height=h)


def _sync(device) -> None:
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(fn, device, reps: int = 3) -> float:
    """Least seconds of ``fn()`` over ``reps`` runs after one warm run,
    each ending in a synchronisation of ``device``."""
    fn()
    best = math.inf
    for _ in range(reps):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, *, devices=None, lap3d: int = 32,
                     scaling: bool = True) -> dict:
    """Run one distributed step over an ``n_devices``-position grid and
    return its numbers (also printed).  ``devices``: the positions'
    devices (default: the CUDA devices, repeated up to ``n_devices``;
    raises without CUDA).  ``lap3d``: the side of the 3-D Laplacian the
    multifrontal factor takes (the JAX ``DRYRUN_LAP3D``); ``scaling``: run
    the weak-scaling table (``DRYRUN_SCALING``)."""
    from . import lapack, ops
    from .core import MC, MR, as_array, distribute
    from .core.grid import cuda_devices
    from .matrices import sparse_laplacian_3d
    from .sparse import DistSparseMatrix
    from .sparse.matmul import dist_spgemm
    from .sparse_direct import (DistSparseLDLFactorization,
                                SparseLDLFactorization, nested_dissection)
    from .utils.transfers import count_transfers

    if devices is None:
        cuda = cuda_devices()
        devices = [cuda[q % len(cuda)] for q in range(n_devices)]
    devices = [torch.device(d) for d in devices][:n_devices]
    _check(len(devices) == n_devices, f"need {n_devices} devices, have "
           f"{len(devices)}")
    grid = _grid_on(devices)
    first = devices[0]
    out = {"positions": n_devices, "grid": (grid.height, grid.width)}

    rng = np.random.default_rng(0)
    n = 8 * n_devices       # tiny, and the grid divides it
    a_np = rng.standard_normal((n, n)).astype(np.float32)
    spd = (a_np @ a_np.T + n * np.eye(n)).astype(np.float32)
    b_np = rng.standard_normal((n, 4)).astype(np.float32)
    A = distribute(a_np, MC, MR, grid)
    S = distribute(spd, MC, MR, grid)
    B = distribute(b_np, MC, MR, grid)
    # SUMMA gemm over the 2-D grid
    G = as_array(ops.gemm("N", "T", 1.0, A, A, alg="stationary_c"))
    g_ref = a_np.astype(np.float64) @ a_np.T
    err = float(np.abs(G.cpu().double().numpy() - g_ref).max()
                / np.abs(g_ref).max())
    _check(err < 1e-5, f"SUMMA gemm off by {err:.2e}")
    # the dense Cholesky factor and solve
    L = lapack.cholesky("L", S)
    X = as_array(lapack.cholesky_solve_after("L", "N", L, B))
    xs = X.cpu().double().numpy()
    res_chol = float(np.linalg.norm(spd @ xs - b_np) / np.linalg.norm(b_np))
    _check(res_chol < 1e-4, f"Cholesky solve residual {res_chol:.2e}")
    # CG on the row-partitioned Laplacian
    lap = sparse_laplacian_2d(8, 8, scaled=False)
    dlap = DistSparseMatrix.from_sparse(lap, grid)
    rhs = torch.from_numpy(rng.standard_normal(64)).to(first)
    sol = lapack.cg(lambda v: dlap.matvec(v), rhs, tol=1e-6, max_iters=50)
    out["scalar"] = float(G.sum() + X.sum() + sol.x.sum())
    out["cg_residual"] = sol.residual
    out["cg_iterations"] = sol.iterations
    _check(sol.residual <= 1e-6 * float(torch.linalg.norm(rhs)),
           f"CG residual {sol.residual:.2e} after {sol.iterations} steps")

    # the multifrontal factor and solve on the grid: big level batches
    # split over the positions, the top fronts factored over all of them
    lap3 = sparse_laplacian_3d(lap3d, lap3d, lap3d, scaled=False)
    perm = nested_dissection(lap3, cutoff=64)
    fd = DistSparseLDLFactorization(dtype=torch.float64, spd=True)
    fd.initialize(DistSparseMatrix.from_sparse(lap3, grid), perm=perm,
                  size_bucket=1.5)
    with count_transfers() as log:
        fd.factor()
    bb = rng.standard_normal(lap3.height)
    xx = fd.solve(bb).cpu().numpy()
    res_ldl = float(np.linalg.norm(lap3.to_scipy() @ xx - bb)
                    / np.linalg.norm(bb))
    bound = fd.residual_bound()
    _check(res_ldl < bound, f"sparse LDL residual {res_ldl:.2e} > {bound}")
    f1 = SparseLDLFactorization(device=first, dtype=torch.float64, spd=True)
    f1.initialize(lap3, perm=perm, size_bucket=1.5)
    gf = fd.factor_gflops()
    t_grid = _best_of(fd.factor, first)
    t_one = _best_of(f1.factor, first)
    out.update(ldl_residual=res_ldl, ldl_bound=bound, factor_gflop=gf,
               factor_s_grid=t_grid, factor_s_one=t_one,
               factor_transfers=log.audit()["total"])
    print(f"multifrontal {lap3d}^3 Laplacian factor: {gf / t_grid:.2f} GF/s "
          f"on the {n_devices}-position grid, {gf / t_one:.2f} GF/s on one "
          f"position (ratio {t_one / t_grid:.2f}); "
          f"{out['factor_transfers']['bytes']} bytes across positions")

    # distributed SpGEMM (A·A of the Laplacian)
    C = dist_spgemm(dlap, dlap)
    c_ref = (lap.to_scipy() @ lap.to_scipy()).toarray()
    err_gemm = float(np.abs(C.host.to_dense() - c_ref).max()
                     / max(np.abs(c_ref).max(), 1.0))
    _check(err_gemm < 1e-5, f"dist SpGEMM mismatch {err_gemm:.2e}")
    out["spgemm_err"] = err_gemm

    # one sparse IPM solve: netlib afiro where the file is there, else a
    # synthetic 12×30 LP
    from .optimization import LPCtrl, lp_direct, solve_mps
    from .sparse import SparseMatrix, read_mps
    if os.path.exists(AFIRO):
        resl, _ = solve_mps(read_mps(AFIRO), LPCtrl(tol=1e-8, max_iters=200),
                            device=first, dtype=torch.float64)
        _check(resl.converged, "netlib afiro did not converge")
        obj_err = abs(resl.objective - AFIRO_OBJECTIVE) / abs(AFIRO_OBJECTIVE)
        _check(obj_err < 1e-4, f"afiro objective off by {obj_err:.2e}")
        out["lp"] = "afiro"
    else:
        rngl = np.random.default_rng(1)
        al = np.abs(rngl.standard_normal((12, 30))) + 0.1
        x0l = np.abs(rngl.standard_normal(30)) + 0.1
        resl = lp_direct(SparseMatrix.from_dense(al), al @ x0l,
                         np.abs(rngl.standard_normal(30)) + 0.5,
                         LPCtrl(tol=1e-6, max_iters=40), device=first,
                         dtype=torch.float64)
        _check(resl.converged, "the synthetic LP did not converge")
        out["lp"] = "synthetic 12x30"
    out["ipm_iterations"] = resl.iterations
    out["lp_objective"] = resl.objective

    out["scaling"] = _weak_scaling(devices) if scaling else None
    print(f"dryrun_multichip({n_devices}): ok, scalar={out['scalar']:.4f}, "
          f"cg_residual={sol.residual:.2e}, ldl_residual={res_ldl:.2e}, "
          f"spgemm_err={err_gemm:.2e}, ipm_its={resl.iterations} "
          f"({out['lp']})")
    return out


def _weak_scaling(devices, *, gemm_m: int = 384, spmv_side: int = 160,
                  lap3d: int = 16) -> list:
    """Weak-scaling table over 1, 2, 4, ... of ``devices``' positions: the
    work per position held about constant (SUMMA gemm m ∝ d^(1/3) from
    ``gemm_m``, the distributed SpMV's rows ∝ d from ``spmv_side``², the
    multifrontal factor's side ∝ d^(1/6) from ``lap3d``), efficiency =
    t(1)/t(d) per unit of work, and the transfer log's count and bytes of
    one call.  Returns the rows (dicts), also printed."""
    from . import ops
    from .core import MC, MR, distribute
    from .matrices import sparse_laplacian_3d
    from .sparse import DistSparseMatrix
    from .sparse_direct import DistSparseLDLFactorization
    from .utils.transfers import count_transfers

    devices = [torch.device(d) for d in devices]
    rng = np.random.default_rng(7)
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= len(devices)]
    distinct = len(set(devices))
    one = "one card" if devices[0].type == "cuda" else "one CPU device"
    label = (f"{one}, repeated positions: the times measure no scaling"
             if distinct == 1 else f"{distinct} devices")
    print(f"weak scaling ({label}; bytes across positions are the port's "
          f"schedule's):")
    print(f"{'op':<12} {'pos':>4} {'work':>10} {'t[ms]':>8} {'eff':>6} "
          f"{'xfer#':>6} {'xferMB':>8}")
    rows, base = [], {}

    def row(op, d, work, per_pos, t, log):
        aud = log.audit()["total"]
        eff = base.setdefault(op, t / per_pos) / (t / per_pos)
        rows.append({"op": op, "positions": d, "work": work, "ms": t * 1e3,
                     "efficiency": eff, "transfers": aud["count"],
                     "bytes": aud["bytes"]})
        print(f"{op:<12} {d:>4} {work:>10.2e} {t * 1e3:>8.1f} {eff:>6.2f} "
              f"{aud['count']:>6} {aud['bytes'] / 1e6:>8.2f}")

    for d in counts:
        g = _grid_on(devices[:d])
        first = devices[0]

        # SUMMA gemm: flops ∝ d ⇒ m ∝ d^(1/3)
        m = int(round(gemm_m * d ** (1 / 3) / 16)) * 16
        a_np = rng.standard_normal((m, m)).astype(np.float32)
        A = distribute(a_np, MC, MR, g)
        B = distribute(a_np.T.copy(), MC, MR, g)

        def gemm():
            return ops.gemm("N", "N", 1.0, A, B, alg="stationary_c")

        t = _best_of(gemm, first)
        with count_transfers() as log:
            gemm()
        row("summa_gemm", d, 2.0 * m ** 3, 2.0 * m ** 3 / d, t, log)

        # distributed SpMV: rows ∝ d
        n1 = int(round((spmv_side * spmv_side * d) ** 0.5 / 8)) * 8
        lap = sparse_laplacian_2d(n1, n1, scaled=False)
        dl = DistSparseMatrix.from_sparse(lap, g)
        v = torch.from_numpy(rng.standard_normal(lap.height)).to(first)
        t = _best_of(lambda: dl.matvec(v), first)
        with count_transfers() as log:
            dl.matvec(v)
        row("dist_spmv", d, lap.nnz, lap.nnz / d, t, log)

        # multifrontal factor: flops ∝ d ⇒ side ∝ d^(1/6)
        nl = int(round(lap3d * d ** (1 / 6)))
        lap3 = sparse_laplacian_3d(nl, nl, nl, scaled=False)
        fd = DistSparseLDLFactorization(dtype=torch.float64, spd=True)
        fd.initialize(DistSparseMatrix.from_sparse(lap3, g), cutoff=64,
                      size_bucket=1.5)
        t = _best_of(fd.factor, first)
        with count_transfers() as log:
            fd.factor()
        gfl = fd.factor_gflops() * 1e9
        row("mf_factor", d, gfl, gfl / d, t, log)
    return rows
