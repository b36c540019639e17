"""The unpivoted complex64 LDLᴴ of a magnetic Laplacian at σ = ω², in the
port and in the JAX package, on the same elimination.

The JAX package's Hermitian value map is right only under the reversed
natural order.  So the natural nested dissection p of the n×n grid is
applied to the matrix itself: M = H[q][:, q] with q = p reversed, factored
under the reversed natural order, eliminates the columns of H in the order
p, with p's supernodes and levels.  The tier-1 case holds, at a small n,
the port's factor of H under p to its factor of M under the reversed
order, and both to the JAX package's factor of M: complex128 pivots within
1e-10, complex64 ones within 1e-3 of the complex128 ones.

Run as a script it prints, for each n given, the refined relative
residual (6 steps, in the factor's dtype, as each package's facade
refines) of both complex64 factors and how many of their pivots are more
than 1 % away from the complex128 factor's; ``--threads`` sets torch's
CPU threads (2 by default), which changes the port's rounding path:

    JAX_PLATFORMS=cpu python tests/test_torch_hermitian_probe.py 105 145
"""

import sys

import numpy as np
import torch

import jax

if __name__ == "__main__":             # the probe's numbers need float64
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix  # noqa: E402
from elemental_tpu.sparse_direct.numeric import factor as jax_factor  # noqa
from elemental_tpu.sparse_direct.symbolic import analyze as jax_analyze  # noqa

from elemental_tpu_torch.matrices import sparse_laplacian_2d  # noqa: E402
from elemental_tpu_torch.sparse import SparseMatrix  # noqa: E402
from elemental_tpu_torch.sparse_direct import (  # noqa: E402
    SparseLDLFactorization, natural_nested_dissection)

torch.set_num_threads(2)


def magnetic_laplacian(n: int, flux: float = 1 / 64):
    """chip_smoke.py's magnetic Laplacian (scaled n×n grid, Landau gauge)
    shifted by ω² = (2π(n+1)/10)²."""
    L = sparse_laplacian_2d(n, n)
    r, c = L.row_ids(), L.colind
    phase = np.exp(2j * np.pi * flux * (r % n))
    v = L.vals.astype(np.complex128)
    v = np.where(c - r == n, v * phase, v)
    v = np.where(r - c == n, v * phase.conj(), v)
    sigma = (2 * np.pi * (n + 1) / 10) ** 2
    return L.change_nonzero_values(np.where(r == c, v - sigma, v))


def reversed_nd(H, n: int):
    """(M, q): H permuted by the reversed natural nested dissection."""
    q = natural_nested_dissection((n, n))[::-1].copy()
    S = H.to_scipy().tocsr()[q][:, q].tocsr()
    S.sort_indices()
    return SparseMatrix.from_scipy(S), q


def port_factor(A, perm, dtype):
    f = SparseLDLFactorization(device="cpu", dtype=dtype)
    f.initialize(A, hermitian=True, perm=perm)
    return f.factor()


def jax_numeric(M, dtype):
    JM = JaxSparseMatrix(M.height, M.width, M.rowptr, M.colind,
                         M.vals.astype(dtype))
    symb = jax_analyze(JM, perm=np.arange(M.height)[::-1].copy()).device()
    return JM, jax_factor(symb, jnp.asarray(JM.vals), conjugate=True,
                          dtype=dtype)


def test_same_elimination_in_both_packages():
    n = 6
    H = magnetic_laplacian(n)
    M, _ = reversed_nd(H, n)
    rev = np.arange(M.height)[::-1].copy()
    p = natural_nested_dissection((n, n))
    ref = port_factor(M, rev, torch.complex128).diagonal().numpy()
    np.testing.assert_array_equal(
        port_factor(H, p, torch.complex128).diagonal().numpy(), ref)
    _, num = jax_numeric(M, np.complex128)
    scale = np.abs(ref).max()
    assert np.abs(np.asarray(num.d) - ref).max() <= 1e-10 * scale
    for d64 in (port_factor(M, rev, torch.complex64).diagonal().numpy(),
                np.asarray(jax_numeric(M, np.complex64)[1].d)):
        assert np.abs(d64 - ref).max() <= 1e-3 * scale


def probe(n: int) -> None:
    H = magnetic_laplacian(n)
    M, _ = reversed_nd(H, n)
    rev = np.arange(M.height)[::-1].copy()
    S = M.to_scipy()
    rng = np.random.default_rng(0)
    b = rng.standard_normal(M.height) + 1j * rng.standard_normal(M.height)

    def resid(x):
        x = np.asarray(x).astype(np.complex128)
        return np.linalg.norm(S @ x - b) / np.linalg.norm(b)

    ref = port_factor(M, rev, torch.complex128).diagonal().numpy()
    f = port_factor(M, rev, torch.complex64)
    JM, num = jax_numeric(M, np.complex64)
    dev = JM.device_csr()
    xj = num.solve_with_iterative_refinement(
        dev.matvec, jnp.asarray(b.astype(np.complex64)), 6)
    for name, d, res in (
            ("port", f.diagonal().numpy(),
             resid(f.solve_with_iterative_refinement(b).numpy())),
            ("JAX", np.asarray(num.d), resid(xj))):
        off = int((np.abs(d - ref) / np.abs(ref) > 1e-2).sum())
        print(f"n = {n} (N = {M.height}, {torch.get_num_threads()} torch "
              f"threads), {name} complex64: refined "
              f"residual {res:.3e} (bound {f.residual_bound():.3e}), "
              f"{off} pivots more than 1 % from complex128's, max|d| "
              f"{np.abs(d).max():.3e}", flush=True)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="+")
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    for n in args.n:
        probe(n)
