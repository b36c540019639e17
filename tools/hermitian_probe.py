#!/usr/bin/env python3
"""Probe the port's Hermitian LDLᴴ on magnetic Laplacians (chip_smoke.py
phase 18's H), on the CPU or one CUDA card.

    python3 tools/hermitian_probe.py --value-map
    python3 tools/hermitian_probe.py [--n 384] [--sigma S ...] [--device D]

``--value-map``: the unscaled 12×11 magnetic Laplacian of
``tests/test_torch_complex_ldl.py`` (flux 1/8 a plaquette, minus 0.5) in
complex128, under nested dissection, natural nested dissection, the
natural and the reversed natural order: the relative error of the port's
solve against a dense solve, and of the same factor with the reference's
value map (every entry assembled as stored, ``LevelPlan.asm_conj``
cleared, as the JAX package assembles it).

Otherwise, for each shift σ of ``chip_smoke.magnetic_laplacian(n, σ)``
(default ω² = (2π(n+1)/10)² and the middle of the lowest Landau gap): the
six eigenvalues of the unshifted matrix nearest σ (scipy ``eigsh``,
shift-invert, on the host), then the LDLᴴ factor in complex128 and
complex64 on ``--device``: the pivots' largest magnitude, the inertia, the
relative residual of a solve and of the refined solve (6 steps, on the
host in complex128), and from complex128 an estimate of κ
(``chip_smoke.kappa_estimate``).
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def value_map() -> None:
    import numpy as np
    import torch
    from elemental_tpu_torch.matrices import sparse_laplacian_2d
    from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                                   natural_nested_dissection,
                                                   nested_dissection)
    n1, n2 = 12, 11
    L = sparse_laplacian_2d(n1, n2, scaled=False)
    r, c = L.row_ids(), L.colind
    phase = np.exp(2j * np.pi / 8 * (r % n2))
    v = L.vals.astype(np.complex128)
    v = np.where(c - r == n2, v * phase, v)
    v = np.where(r - c == n2, v * phase.conj(), v)
    A = L.change_nonzero_values(np.where(r == c, v - 0.5, v))
    b = np.random.default_rng(0).standard_normal(A.height) + 0j
    x_ref = np.linalg.solve(A.to_dense(), b)
    orders = {"nested_dissection": nested_dissection(A, cutoff=16),
              "natural_nested_dissection": natural_nested_dissection(
                  (n1, n2)),
              "natural": np.arange(A.height),
              "reversed natural": np.arange(A.height)[::-1].copy()}
    for name, perm in orders.items():
        f = SparseLDLFactorization(device="cpu", dtype=torch.complex128)
        f.initialize(A, hermitian=True, perm=perm)
        errs = []
        for keep in (True, False):
            if not keep:
                for lev in f.symb.levels:
                    lev.asm_conj = torch.zeros_like(lev.asm_conj)
            x = f.factor().solve(b).numpy()
            errs.append(np.abs(x - x_ref).max() / np.abs(x_ref).max())
        print(f"{name}: the port {errs[0]:.3e}, with the reference's value "
              f"map {errs[1]:.3e} (max-norm relative error to a dense "
              f"solve)")


def shifts(n: int, sigmas, device: str) -> None:
    import numpy as np
    import scipy.sparse.linalg as sla
    import torch
    import chip_smoke as cs
    from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                                   natural_nested_dissection)
    H0 = cs.magnetic_laplacian(n, 0.0)
    perm = natural_nested_dissection((n, n))
    base = SparseLDLFactorization(device=device, dtype=torch.complex128)
    base.initialize(H0, hermitian=True, perm=perm)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(H0.height) + 1j * rng.standard_normal(H0.height)
    for sigma in sigmas:
        ev = sla.eigsh(H0.to_scipy().tocsc(), k=6, sigma=sigma, which="LM",
                       return_eigenvectors=False)
        print(f"σ = {sigma:.6g}: the unshifted matrix's eigenvalues nearest "
              f"it " + ", ".join(f"{e:.6g}" for e in np.sort(ev.real)))
        H = cs.magnetic_laplacian(n, sigma)
        S = H.to_scipy()
        for dtype in (torch.complex128, torch.complex64):
            f = cs.same_analysis(base, H, dtype=dtype, hermitian=True,
                                 spd=False)
            f.factor()

            def resid(x):
                x = x.cpu().numpy().astype(np.complex128)
                return np.linalg.norm(S @ x - b) / np.linalg.norm(b)

            line = (f"  {str(dtype)[6:]}: max|d| "
                    f"{float(f.diagonal().abs().max()):.3e}, inertia "
                    f"{f.inertia()}, residual {resid(f.solve(b)):.3e}, "
                    f"refined {resid(f.solve_with_iterative_refinement(b)):.3e}"
                    f" (bound {f.residual_bound():.3e})")
            if dtype == torch.complex128:
                line += f", κ ≥ {cs.kappa_estimate(f):.3e}"
            print(line, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--value-map", action="store_true")
    ap.add_argument("--n", type=int, default=384)
    ap.add_argument("--sigma", type=float, nargs="*")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    if args.value_map:
        value_map()
        return 0
    import chip_smoke as cs
    sigmas = args.sigma or [cs.helmholtz_shift(args.n).real,
                            cs.landau_gap_shift(args.n)]
    shifts(args.n, sigmas, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
