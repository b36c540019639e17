"""Parity of the port's LP path (double-word pieces, sparse Ruiz, the KKT
engine, ``lp_direct``) with the JAX package, on the CPU, from the same NumPy
inputs; and the port's freedom from JAX.
"""

import importlib.util
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elemental_tpu import extended as jext
from elemental_tpu.optimization import lp as jlp
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix

from elemental_tpu_torch import extended as text
from elemental_tpu_torch.matrices import concat_fd_2d
from elemental_tpu_torch.optimization import lp as tlp
from elemental_tpu_torch.sparse import SparseMatrix

torch.set_num_threads(1)
F64 = torch.float64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_matrix(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


def test_two_sum_two_prod_error_free_in_f32():
    """hi + lo equals the float64 sum / product exactly, in both
    packages."""
    rng = np.random.default_rng(1)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)
         ).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.integers(-8, 8, 4096)
         ).astype(np.float32)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for (s, e), exact in ((text.two_sum(ta, tb), a64 + b64),
                          (text.two_prod(ta, tb), a64 * b64),
                          (jext.two_sum(ja, jb), a64 + b64),
                          (jext.two_prod(ja, jb), a64 * b64)):
        got = np.asarray(s).astype(np.float64) + np.asarray(e).astype(
            np.float64)
        np.testing.assert_array_equal(got, exact)
    s, e = text.quick_two_sum(torch.as_tensor(np.float32(1e4)),
                              torch.as_tensor(np.float32(1e-4)))
    assert float(s) + float(e) == 1e4 + float(np.float32(1e-4))


@pytest.mark.parametrize("n", [1, 1000, 4097])
def test_dd_dot_matches_exact_dot(n):
    """dd_dot of f32 vectors is within 1e-12 of the exact dot (math.fsum
    of the exact f64 products), and equal between the packages."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    exact = math.fsum(x.astype(np.float64) * y.astype(np.float64))
    t = text.dd_dot(torch.as_tensor(x), torch.as_tensor(y))
    j = jext.dd_dot(jnp.asarray(x), jnp.asarray(y))
    tv = float(t.hi) + float(t.lo)
    assert abs(tv - exact) <= 1e-12 * max(abs(exact), 1.0)
    assert (float(t.hi), float(t.lo)) == (float(j.hi), float(j.lo))


def test_dd_add_sum_match_reference():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((3, 37))
    lo = rng.standard_normal((3, 37)) * 1e-17
    t = text.dd_sum(text.DD(torch.as_tensor(h), torch.as_tensor(lo)))
    j = jext.dd_sum(jext.DD(jnp.asarray(h), jnp.asarray(lo)))
    np.testing.assert_array_equal(t.hi.numpy(), np.asarray(j.hi))
    np.testing.assert_array_equal(t.lo.numpy(), np.asarray(j.lo))
    t = text.dd_add(text.DD(torch.as_tensor(h), torch.as_tensor(lo)),
                    text.dd_neg(text.DD(torch.as_tensor(lo),
                                        torch.as_tensor(h))))
    j = jext.dd_add(jext.DD(jnp.asarray(h), jnp.asarray(lo)),
                    jext.dd_neg(jext.DD(jnp.asarray(lo), jnp.asarray(h))))
    np.testing.assert_array_equal(t.hi.numpy(), np.asarray(j.hi))


def test_generators_match_example(monkeypatch):
    """The port's concat_fd_2d is the operator of examples/lp_direct_large.py."""
    exdir = os.path.join(REPO, "examples")
    monkeypatch.syspath_prepend(exdir)
    spec = importlib.util.spec_from_file_location(
        "example_lp_direct_large", os.path.join(exdir, "lp_direct_large.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    np.testing.assert_array_equal(concat_fd_2d(5, 7).to_dense(),
                                  mod.concat_fd_2d(5, 7).to_dense())


@pytest.fixture(scope="module")
def kkt_pair():
    """Both packages' LP KKT of concat_fd_2d(6, 6), Ruiz-scaled, with the
    same ordering."""
    A = concat_fd_2d(6, 6)
    As, r, s = tlp.sparse_ruiz(A)
    Ajs, rj, sj = jlp.sparse_ruiz(_jax_matrix(A))
    jk, _ = jlp._build_lp_kkt(Ajs, 1e-2, 1e-2, None)
    tk, _ = tlp._build_lp_kkt(As, 1e-2, 1e-2, np.asarray(jk.symb.perm),
                              device="cpu", dtype=F64)
    return (A, As, r, s, Ajs, rj, sj), jk, tk


def test_sparse_ruiz_matches_reference(kkt_pair):
    (A, As, r, s, Ajs, rj, sj), _, _ = kkt_pair
    assert _rel(As.vals, Ajs.vals) <= 1e-12
    assert _rel(r, rj) <= 1e-12 and _rel(s, sj) <= 1e-12
    np.testing.assert_array_equal(As.colind, Ajs.colind)


def test_kkt_pieces_match_reference(kkt_pair):
    """assemble, equilibrate, matvec, and solve_refined with and without
    the panel-inverse context, to 1e-10."""
    (A, *_), jk, tk = kkt_pair
    n = A.width
    rng = np.random.default_rng(8)
    theta = rng.uniform(0.05, 20.0, n)
    x = rng.standard_normal(tk.N)
    jv = jk.assemble([jnp.asarray(theta)])
    tv = tk.assemble([torch.as_tensor(theta)])
    assert _rel(tv.numpy(), jv) <= 1e-12
    (jve, jd), (tve, td) = jk.equilibrate(jv), tk.equilibrate(tv)
    assert _rel(tve.numpy(), jve) <= 1e-10 and _rel(td.numpy(), jd) <= 1e-10
    assert _rel(tk.matvec(tv, torch.as_tensor(x)).numpy(),
                jk.matvec(jv, jnp.asarray(x))) <= 1e-10
    reg = np.concatenate([np.full(n, 1e-2), np.full(tk.N - n, -1e-2)])
    jf = jax.jit(lambda v: jk.prepare(v))(jv)
    tf = tk.prepare(tv)
    assert _rel(tf.pool.numpy(), jf.pool) <= 1e-10
    jsolve = jax.jit(lambda f, b, c: f.solve_refined(b, jnp.asarray(reg),
                                                     iters=4, ctx=c))
    for use_ctx in (False, True):
        jc = jax.jit(lambda f: f.solve_context())(jf) if use_ctx else None
        tc = tf.solve_context() if use_ctx else None
        got = tf.solve_refined(torch.as_tensor(x), torch.as_tensor(reg),
                               iters=4, ctx=tc)
        assert _rel(got.numpy(), jsolve(jf, jnp.asarray(x), jc)) <= 1e-10


def _rand_lp(m, n, seed=53):
    """tests/optimization/test_ipm.py's generator."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n))
    x0 = np.abs(rng.standard_normal(n))
    b = A @ x0
    c = rng.standard_normal(n)
    c = np.abs(rng.standard_normal(n)) + A.T @ rng.standard_normal(m)
    return SparseMatrix.from_dense(A), b, c


def _fd_lp(n1):
    """examples/lp_direct_large.py's LP."""
    A = concat_fd_2d(n1, n1)
    rng = np.random.default_rng(0)
    x0 = np.abs(rng.standard_normal(A.width)) + 0.1
    return A, A.to_scipy() @ x0, np.abs(rng.standard_normal(A.width)) + 0.5


@pytest.mark.parametrize("case", ["rand_12x30", "fd_8", "rand_10x24_ipf"])
def test_lp_direct_matches_reference(case, monkeypatch):
    """The slice end to end: port lp_direct against the JAX lp_direct on
    its python-orchestrated path (LARGE_FUSED_N=1, as test_ipm.py forces
    it): same iteration count, objective to 1e-7, x to 1e-6."""
    if case == "fd_8":
        A, b, c = _fd_lp(8)
    elif case == "rand_12x30":
        A, b, c = _rand_lp(12, 30)
    else:
        A, b, c = _rand_lp(10, 24, seed=7)
    approach = tlp.Approach.IPF if case.endswith("ipf") else \
        tlp.Approach.MEHROTRA
    monkeypatch.setattr(jlp, "LARGE_FUSED_N", 1)
    ref = jlp.lp_direct(_jax_matrix(A), b, c,
                        jlp.LPCtrl(tol=1e-9, approach=approach,
                                   max_iters=300))
    got = tlp.lp_direct(A, b, c, tlp.LPCtrl(tol=1e-9, approach=approach,
                                            max_iters=300),
                        device="cpu", dtype=F64)
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.objective, ref.objective, rtol=1e-7)
    np.testing.assert_allclose(got.x, ref.x, atol=1e-6)


SPECTRAL_DRIVERS = ("eig", "fox_li", "pseudospectra_portrait",
                    "triang_eig_ex", "pnorm", "product_lanczos_ex",
                    "inv_pos", "lattice_tools", "lll_reduction",
                    "lll_singular", "control_ex", "lcf")


def test_port_imports_without_jax():
    """The port imports with JAX blocked (the machine with the card has
    none)."""
    code = ("import sys; sys.modules['jax'] = None\n"
            "import elemental_tpu_torch\n"
            "import elemental_tpu_torch.kernels.extend_add\n"
            "import elemental_tpu_torch.optimization.lp\n"
            "import elemental_tpu_torch.optimization.qp\n"
            "import elemental_tpu_torch.optimization.socp\n"
            "import elemental_tpu_torch.optimization.solvers\n"
            "import elemental_tpu_torch.sparse.io\n"
            "import elemental_tpu_torch.lapack.sparse_min\n"
            "import elemental_tpu_torch.sparse_direct.facade\n"
            "import elemental_tpu_torch.sparse_direct.dist_front\n"
            "import elemental_tpu_torch.core.grid\n"
            "import elemental_tpu_torch.core.distmatrix\n"
            "import elemental_tpu_torch.core.redistribute\n"
            "import elemental_tpu_torch.core.environment\n"
            "import elemental_tpu_torch.ops.level3\n"
            "import elemental_tpu_torch.ops._blocks\n"
            "import elemental_tpu_torch.ops.summa\n"
            "import elemental_tpu_torch.ops.gemm3d\n"
            "import elemental_tpu_torch.examples.lp_direct_large\n"
            "import elemental_tpu_torch.sparse.distsparse\n"
            "import elemental_tpu_torch.sparse.matmul\n"
            "import elemental_tpu_torch.utils.transfers\n"
            "import elemental_tpu_torch.entry\n"
            "import elemental_tpu_torch.examples.bp\n"
            "import elemental_tpu_torch.examples.remote_dist_sparse\n"
            "import elemental_tpu_torch.extended\n"
            "import elemental_tpu_torch.matrices.deterministic\n"
            "import elemental_tpu_torch.matrices.random_gen\n"
            "import elemental_tpu_torch.lapack.util\n"
            "import elemental_tpu_torch.lapack.perm\n"
            "import elemental_tpu_torch.lapack.reflect\n"
            "import elemental_tpu_torch.lapack.cholesky\n"
            "import elemental_tpu_torch.lapack.lu\n"
            "import elemental_tpu_torch.lapack.ldl\n"
            "import elemental_tpu_torch.lapack.qr\n"
            "import elemental_tpu_torch.lapack.props\n"
            "import elemental_tpu_torch.lapack.equilibrate\n"
            "import elemental_tpu_torch.lapack.euclidean_min\n"
            "import elemental_tpu_torch.lapack.solve\n"
            "import elemental_tpu_torch.examples.gepp_growth\n"
            "import elemental_tpu_torch.examples.matrix_zoo\n"
            "import elemental_tpu_torch.lapack.condense\n"
            "import elemental_tpu_torch.lapack.tridiag_eig\n"
            "import elemental_tpu_torch.lapack.spectral\n"
            "import elemental_tpu_torch.lapack.funcs\n"
            "import elemental_tpu_torch.lapack.lattice\n"
            "import elemental_tpu_torch.control\n"
            "import elemental_tpu_torch.io\n"
            "import elemental_tpu_torch.utils.roofline\n"
            + "".join(f"import elemental_tpu_torch.examples.{name}\n"
                      for name in SPECTRAL_DRIVERS) +
            "assert not any(m == 'jax' or m.startswith(('jax.', "
            "'elemental_tpu.')) for m in sys.modules if sys.modules[m])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
