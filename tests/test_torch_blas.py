"""Parity of the port's BLAS tier (``elemental_tpu_torch.ops``: level 1-3,
the SUMMA variants, ``choose_algorithm`` and the 3-D GEMM) with the JAX
package on the CPU, mirroring ``tests/ops/test_level1_2_3.py`` and
``tests/ops/test_gemm.py``: the same seeded NumPy inputs go through both
packages, local and distributed (the JAX package's ``grid8``, 2×4 over
forced host devices; the port's 2×4 grid over torch's CPU device).

Tolerances (relative to the largest entry of the JAX result): float64 and
complex128 1e-12, float32 and complex64 1e-5.  Distributions and shapes of
distributed results must be the JAX package's exactly.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elemental_tpu as jel
from elemental_tpu import ops as jops
from elemental_tpu.ops import summa as jsumma

import elemental_tpu_torch as tel
from elemental_tpu_torch import ops as tops
from elemental_tpu_torch.core import Grid
from elemental_tpu_torch.ops import summa as tsumma

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = {np.dtype(np.float32): 1e-5, np.dtype(np.complex64): 1e-5,
       np.dtype(np.float64): 1e-12, np.dtype(np.complex128): 1e-12}
SUMMA = ["xla", "stationary_c", "stationary_a", "stationary_b", "pipelined"]


@pytest.fixture(scope="module")
def tgrid8():
    return Grid(devices=[CPU] * 8, height=2)


def rand(rng, shape, dtype=np.float64):
    a = rng.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def npy(x):
    """NumPy values of a result of either package (tuples recursively)."""
    if isinstance(x, tuple):
        return tuple(npy(v) for v in x)
    if isinstance(x, (tel.DistMatrix, jel.DistMatrix)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def close(got, want, dtype, what="", dist=None):
    """``got`` (port) within TOL[dtype] of ``want`` (JAX), relative to the
    largest |want|.  A distributed result must carry the dist of a
    distributed ``want``, or ``dist`` where that is given."""
    if isinstance(want, jel.DistMatrix):
        dist = tuple(tel.Dist(d.value) for d in want.dist())
    if dist is not None:
        assert isinstance(got, tel.DistMatrix), what
        assert got.dist() == dist, what
    g, w = npy(got), npy(want)
    if isinstance(w, tuple):
        for gi, wi in zip(g, w):
            close(gi, wi, dtype, what)
        return
    assert g.shape == w.shape, (what, g.shape, w.shape)
    tol = TOL[np.dtype(dtype)]
    scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                               err_msg=what)


def both(x, where, jgrid, tgrid):
    """(JAX operand, port operand) of the NumPy array ``x``: ``local``,
    both local arrays; ``grid``, the port's operand an [MC,MR] DistMatrix on
    its 2×4 grid against the JAX function on the local array (the JAX
    package's sharding does not change its values; its SPMD compiles would
    take most of this file's time); ``grids``, both distributed on the 2×4
    grids."""
    if where == "local":
        return jnp.asarray(x), torch.from_numpy(np.array(x))
    port = tel.distribute(x, tel.MC, tel.MR, tgrid)
    if where == "grid":
        return jnp.asarray(x), port
    return jel.distribute(x, jel.MC, jel.MR, jgrid), port


# -- level 1 -------------------------------------------------------------------

def _level1_cases(rng, dtype):
    """name → (NumPy operands, extra arguments or a tag naming the call's
    shape, see ``_call``), and the diagonal ``d`` the diagonal ops take."""
    a, b = rand(rng, (8, 8), dtype), rand(rng, (8, 8), dtype)
    d = (np.arange(8) + 1.0).astype(np.float64)
    rows, cols = np.array([0, 3, 5]), np.array([1, 2, 2, 7])
    sub = rand(rng, (3, 4), dtype)
    return {
        "copy": ([a], ()), "zero": ([a], ()), "fill": ([a], (2.5,)),
        "entrywise_map": ([a], (lambda x: 2 * x + 1,)),
        "scale": ([a], "alpha_first"), "axpy": ([a, b], "alpha_first"),
        "axpby": ([a, b], "axpby"), "safe_scale": ([a], "safe_scale"),
        "shift": ([a], (1.5,)), "shift_diagonal": ([a], (2.0, 1)),
        "dot": ([a, b], ()), "dotu": ([a, b], ()), "nrm2": ([a], ()),
        "hadamard": ([a, b], ()), "max_abs_loc": ([a], ()),
        "min_abs_loc": ([a], ()), "column_norms": ([a], ()),
        "row_norms": ([a], ()), "column_max_norms": ([a], ()),
        "row_max_norms": ([a], ()), "transpose": ([a], ()),
        "adjoint": ([a], ()), "conjugate": ([a], ()),
        "get_diagonal": ([a], (-2,)), "set_diagonal": ([a], (d[:6], 2)),
        "update_diagonal": ([a], (d[:7], -1)),
        "get_submatrix": ([a], (rows, cols)),
        "set_submatrix": ([a], (rows, cols, sub)),
        "update_submatrix": ([a], (rows, cols, 0.5, sub)),
        "kronecker": ([a[:3, :2], b[:2, :3]], ()),
        "concatenate": ([a, b], "list"), "reshape": ([a], (4, 16)),
        "swap_rows": ([a], (1, 6)), "round_": ([3 * a], ()),
        "real": ([a], ()), "imag": ([a], ()),
        "make_symmetric": ([a], ("U",)), "make_hermitian": ([a], ("L",)),
        "make_trapezoidal": ([a], ("U", -1)),
        "diagonal_scale": ([a], "diag_L"), "diagonal_solve": ([a], "diag_R"),
        "symmetric_diagonal_equil": ([a], "equil"),
        "index_dependent_map": ([a], (lambda i, j, v: v + i * 10 + j,)),
        "entrywise_fill": ([a], (lambda shape: np.full(shape, 3.0),)),
    }, d


def _call(mod, name, ops_, extra, d):
    fn = getattr(mod, name)
    if extra == "alpha_first":
        return fn(2.0, *ops_)
    if extra == "axpby":
        return fn(2.0, ops_[0], -0.5, ops_[1])
    if extra == "safe_scale":
        return fn(3.0, 7.0, *ops_)
    if extra == "list":
        return fn(ops_, 1)
    if extra in ("diag_L", "diag_R"):
        return fn(extra[-1], d, *ops_)
    if extra == "equil":
        return fn(ops_[0], d)
    return fn(*ops_, *extra)


LEVEL1 = sorted(_level1_cases(np.random.default_rng(0), np.float64)[0])
NOT_DISTRIBUTED = {"dot", "dotu", "nrm2", "max_abs_loc", "min_abs_loc",
                   "column_norms", "row_norms", "column_max_norms",
                   "row_max_norms", "get_diagonal", "get_submatrix",
                   "kronecker", "concatenate"}


def test_level1_covers_all_44():
    assert len(LEVEL1) == 44 == len(tops.level1.__all__)
    assert set(LEVEL1) == set(tops.level1.__all__)


@pytest.mark.parametrize("where", ["local", "grid"])
@pytest.mark.parametrize("name", LEVEL1)
def test_level1_matches_jax(grid8, tgrid8, name, where):
    """Every level-1 function in float64 and complex128, on local and on
    distributed operands; a distributed result keeps the template's dist
    (swapped by ``transpose``/``adjoint``)."""
    dist = None
    if where == "grid" and name not in NOT_DISTRIBUTED:
        dist = ((tel.MR, tel.MC) if name in ("transpose", "adjoint")
                else (tel.MC, tel.MR))
    for dtype in (np.float64, np.complex128):
        rng = np.random.default_rng(11)
        cases, d = _level1_cases(rng, dtype)
        arrays, extra = cases[name]
        if where == "grid" and name == "kronecker":
            arrays = [arrays[0][:2, :4], arrays[1][:2, :4]]
        pairs = [both(x, where, grid8, tgrid8) for x in arrays]
        want = _call(jops, name, [p[0] for p in pairs], extra, d)
        got = _call(tops, name, [p[1] for p in pairs], extra, d)
        close(got, want, dtype, f"{name} {np.dtype(dtype)}", dist)


def test_axpy_dot_nrm2(dtype):
    rng = np.random.default_rng(11)
    x, y = rand(rng, (8, 8), dtype), rand(rng, (8, 8), dtype)
    close(tops.axpy(2.0, torch.from_numpy(x), torch.from_numpy(y)),
          jops.axpy(2.0, jnp.asarray(x), jnp.asarray(y)), dtype)
    close(tops.dot(x, y), jops.dot(x, y), dtype)
    close(tops.nrm2(x), jops.nrm2(x), dtype)


def test_level1_distributed_keeps_dist(grid8, tgrid8):
    a = rand(np.random.default_rng(1), (16, 16), np.float32)
    B = tops.scale(3.0, tel.distribute(a, tel.MC, tel.MR, tgrid8))
    assert B.dist() == (tel.MC, tel.MR) and B.grid is tgrid8
    close(B, jops.scale(3.0, jel.distribute(a, jel.MC, jel.MR, grid8)),
          np.float32)


def test_max_abs_loc_first_of_ties():
    a = np.array([[1.0, -5.0], [5.0, 2.0]])
    val, (i, j) = tops.max_abs_loc(torch.from_numpy(a))
    jval, (ji, jj) = jops.max_abs_loc(jnp.asarray(a))
    assert (float(val), int(i), int(j)) == (float(jval), int(ji), int(jj))


# -- level 2 -------------------------------------------------------------------

# every dtype; float64 and complex128 on distributed operands
DTYPE_WHERE = [(np.dtype(d), w) for d, w in (
    ("float32", "local"), ("complex64", "local"), ("float64", "grid"),
    ("complex128", "grid"))]
DW_IDS = [f"{d.name}-{w}" for d, w in DTYPE_WHERE]


@pytest.mark.parametrize("dtype,where", DTYPE_WHERE, ids=DW_IDS)
def test_level2_matches_jax(grid8, tgrid8, dtype, where):
    rng = np.random.default_rng(12)
    n = 8
    a, x, y = rand(rng, (n, n), dtype), rand(rng, (n,), dtype), \
        rand(rng, (n,), dtype)
    ja, ta = both(a, where, grid8, tgrid8)
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    jy, ty = jnp.asarray(y), torch.from_numpy(y.copy())
    tri = np.tril(a) + n * np.eye(n, dtype=dtype)
    jt, tt = both(tri, where, grid8, tgrid8)
    c, s = rng.standard_normal(n - 1), rng.standard_normal(n - 1)
    cases = [
        ("gemv N", lambda m, A, X, Y: m.gemv("N", 1.5, A, X)),
        ("gemv T", lambda m, A, X, Y: m.gemv("T", 1.0, A, X, 0.5, Y)),
        ("gemv C", lambda m, A, X, Y: m.gemv("C", 1.0, A, Y)),
        ("ger", lambda m, A, X, Y: m.ger(2.0, Y, X, A)),
        ("geru", lambda m, A, X, Y: m.geru(2.0, Y, X, A)),
        ("symv", lambda m, A, X, Y: m.symv("U", 1.0, A, X, 2.0, Y)),
        ("hemv", lambda m, A, X, Y: m.hemv("L", 1.0, A, X)),
        ("syr", lambda m, A, X, Y: m.syr("L", 0.5, X, A)),
        ("her", lambda m, A, X, Y: m.her("U", 0.5, X, A)),
        ("syr2", lambda m, A, X, Y: m.syr2("U", 0.5, X, Y, A)),
        ("her2", lambda m, A, X, Y: m.her2("L", 0.5, X, Y, A)),
        ("givens L", lambda m, A, X, Y: m.apply_givens_sequence("L", c, s, A)),
        ("givens R", lambda m, A, X, Y: m.apply_givens_sequence("R", c, s, A)),
    ]
    for what, f in cases:
        close(f(tops, ta, tx, ty), f(jops, ja, jx, jy), dtype, what)
    for uplo, orient, diag in (("L", "N", "N"), ("L", "T", "U"),
                               ("U", "C", "N"), ("U", "N", "U")):
        tri_j, tri_t = (jt, tt) if uplo == "L" else both(
            tri.T.copy(), where, grid8, tgrid8)
        close(tops.trmv(uplo, orient, diag, tri_t, tx),
              jops.trmv(uplo, orient, diag, tri_j, jx), dtype, "trmv")
        close(tops.trsv(uplo, orient, diag, tri_t, tx),
              jops.trsv(uplo, orient, diag, tri_j, jx), dtype, "trsv")


# -- level 3 -------------------------------------------------------------------

def test_trsm_all_cases(dtype):
    """Every side, uplo, orientation and diag, as the reference test, on a
    full (not masked) A."""
    rng = np.random.default_rng(11)
    n, k = 20, 7
    a = (rand(rng, (n, n), dtype) + n * np.eye(n)).astype(dtype)
    ja, ta = jnp.asarray(a), torch.from_numpy(a)
    for side in "LR":
        for uplo in "LU":
            for orient in "NTC":
                for diag in "NU":
                    b = rand(rng, (n, k) if side == "L" else (k, n), dtype)
                    close(tops.trsm(side, uplo, orient, diag, 1.5, ta,
                                    torch.from_numpy(b)),
                          jops.trsm(side, uplo, orient, diag, 1.5, ja,
                                    jnp.asarray(b)),
                          dtype, f"{side}{uplo}{orient}{diag}")


@pytest.mark.parametrize("side,uplo,orient", [("L", "L", "N"),
                                              ("R", "U", "C"),
                                              ("L", "U", "T")])
def test_trsm_recursive_large(side, uplo, orient):
    """n = 600 > ``_MIN_RECURSIVE``: the recursive split, against the JAX
    package's recursion."""
    rng = np.random.default_rng(13)
    n = 600
    a = rand(rng, (n, n), np.complex128) + n * np.eye(n)
    b = rand(rng, (n, 3) if side == "L" else (3, n), np.complex128)
    close(tops.trsm(side, uplo, orient, "N", 1.0, torch.from_numpy(a),
                    torch.from_numpy(b)),
          jops.trsm(side, uplo, orient, "N", 1.0, jnp.asarray(a),
                    jnp.asarray(b)), np.complex128)


@pytest.mark.parametrize("dtype,where", DTYPE_WHERE, ids=DW_IDS)
def test_rank_k_updates_keep_the_masking(grid8, tgrid8, dtype, where):
    """herk, syrk, her2k, syr2k (one triangle of the result), trrk and
    trr2k (the other triangle of C kept) as the reference masks them."""
    rng = np.random.default_rng(14)
    a, b = rand(rng, (8, 5), dtype), rand(rng, (8, 5), dtype)
    c = rand(rng, (8, 8), dtype)
    ja, ta = both(a, where, grid8, tgrid8)
    jb, tb = both(b, where, grid8, tgrid8)
    jc, tc = both(c, where, grid8, tgrid8)
    bt = b.T.copy()
    jbt, tbt = both(bt, where, grid8, tgrid8)
    cases = [
        ("herk", lambda m, A, B, C, BT: m.herk("L", "N", 1.0, A)),
        ("herk C", lambda m, A, B, C, BT: m.herk("U", "C", 2.0, BT)),
        ("herk beta", lambda m, A, B, C, BT: m.herk("U", "N", 2.0, A, 0.5, C)),
        ("syrk", lambda m, A, B, C, BT: m.syrk("U", "T", 2.0, BT)),
        ("syrk beta", lambda m, A, B, C, BT: m.syrk("L", "N", 1.0, A, -1.0,
                                                    C)),
        ("her2k", lambda m, A, B, C, BT: m.her2k("L", "N", 1.5, A, B, 1.0, C)),
        ("syr2k", lambda m, A, B, C, BT: m.syr2k("U", "N", 0.5, A, B)),
        ("trrk", lambda m, A, B, C, BT: m.trrk("L", "N", "N", 1.0, A, BT,
                                               1.0, C)),
        ("trrk U", lambda m, A, B, C, BT: m.trrk("U", "N", "C", 2.0, A, B,
                                                 0.5, C)),
        ("trr2k", lambda m, A, B, C, BT: m.trr2k("L", "N", "N", "N", "T", 1.0,
                                                 A, BT, -1.0, B, A, 0.5, C)),
    ]
    for what, f in cases:
        got = f(tops, ta, tb, tc, tbt)
        close(got, f(jops, ja, jb, jc, jbt), dtype, what)
    out = npy(tops.trrk("L", "N", "N", 1.0, ta, tbt, 1.0, tc))
    np.testing.assert_array_equal(np.triu(out, 1), np.triu(c, 1))


@pytest.mark.parametrize("dtype", [np.dtype(np.float64),
                                   np.dtype(np.complex128)],
                         ids=["float64", "complex128"])
def test_trmm_symm_hemm(dtype):
    rng = np.random.default_rng(15)
    n = 10
    a, b = rand(rng, (n, n), dtype), rand(rng, (n, 6), dtype)
    bt = rand(rng, (6, n), dtype)
    c = rand(rng, (n, 6), dtype)
    T = torch.from_numpy
    J = jnp.asarray
    for side in "LR":
        bb = b if side == "L" else bt
        for uplo in "LU":
            for orient, diag in zip("NTC", "NUN" if uplo == "L" else "UNU"):
                close(tops.trmm(side, uplo, orient, diag, 1.5, T(a), T(bb)),
                      jops.trmm(side, uplo, orient, diag, 1.5, J(a), J(bb)),
                      dtype, f"trmm {side}{uplo}{orient}{diag}")
            close(tops.symm(side, uplo, 2.0, T(a), T(bb)),
                  jops.symm(side, uplo, 2.0, J(a), J(bb)), dtype, "symm")
            close(tops.hemm(side, uplo, 1.0, T(a), T(bb)),
                  jops.hemm(side, uplo, 1.0, J(a), J(bb)), dtype, "hemm")
    close(tops.symm("L", "L", 1.0, T(a), T(b), -0.5, T(c)),
          jops.symm("L", "L", 1.0, J(a), J(b), -0.5, J(c)), dtype, "symm C")


@pytest.mark.parametrize("dtype", [np.dtype(np.float64),
                                   np.dtype(np.complex128)],
                         ids=["float64", "complex128"])
def test_twosided_and_evd(dtype):
    rng = np.random.default_rng(16)
    n = 12
    a = rand(rng, (n, n), dtype)
    a = (a + a.conj().T + 2 * n * np.eye(n)).astype(dtype)
    l = (np.tril(rand(rng, (n, n), dtype)) + n * np.eye(n)).astype(dtype)
    T, J = torch.from_numpy, jnp.asarray
    for uplo in "LU":
        ll = l if uplo == "L" else l.T.copy()
        for diag, conj in (("N", True), ("U", False)):
            close(tops.twosided_trsm(uplo, diag, T(a), T(ll), conj),
                  jops.twosided_trsm(uplo, diag, J(a), J(ll), conj),
                  dtype, f"twosided_trsm {uplo}{diag}{conj}")
            close(tops.twosided_trmm(uplo, diag, T(a), T(ll), conj),
                  jops.twosided_trmm(uplo, diag, J(a), J(ll), conj),
                  dtype, f"twosided_trmm {uplo}{diag}{conj}")
    z = rand(rng, (n, n), dtype)
    w = rng.standard_normal(n)
    for uplo in ("L", "U", ""):
        close(tops.hermitian_from_evd(uplo, w, T(z)),
              jops.hermitian_from_evd(uplo, J(w), J(z)), dtype, "hfevd")
    wc = (w + 1j * rng.standard_normal(n)).astype(np.complex128)
    got = tops.normal_from_evd(wc, T(z))
    close(got, jops.normal_from_evd(J(wc), J(z)),
          np.complex128 if got.dtype == torch.complex128 else np.complex64,
          "normal_from_evd")


def test_multishift_quasi_safe():
    rng = np.random.default_rng(17)
    n, k = 16, 5
    a = np.triu(rand(rng, (n, n))) + n * np.eye(n)
    a[4, 3], a[9, 8] = 0.7, -0.4          # 2×2 blocks for quasi_trsm
    shifts = rng.standard_normal(k)
    b = rand(rng, (n, k))
    T, J = torch.from_numpy, jnp.asarray
    for uplo in "LU":
        aa = a if uplo == "U" else a.T.copy()
        for orient in "NTC":
            close(tops.multishift_trsm("L", uplo, orient, 1.5, T(aa),
                                       T(shifts), T(b)),
                  jops.multishift_trsm("L", uplo, orient, 1.5, J(aa),
                                       J(shifts), J(b)), np.float64,
                  f"multishift {uplo}{orient}")
            close(tops.quasi_trsm("L", uplo, orient, 2.0, T(aa), T(b)),
                  jops.quasi_trsm("L", uplo, orient, 2.0, J(aa), J(b)),
                  np.float64, f"quasi {uplo}{orient}")
    close(tops.safe_multishift_trsm("L", "U", "N", 1.0, T(a), T(shifts),
                                    T(b)),
          jops.safe_multishift_trsm("L", "U", "N", 1.0, J(a), J(shifts),
                                    J(b)), np.float64, "safe")
    huge = np.diag(np.full(n, 1e-200))
    x, s = tops.safe_multishift_trsm("L", "U", "N", 1.0, T(huge),
                                     T(np.zeros(k)), T(b))
    jx, js = jops.safe_multishift_trsm("L", "U", "N", 1.0, J(huge),
                                       J(np.zeros(k)), J(b))
    np.testing.assert_allclose(npy(s), npy(js), rtol=1e-12)
    assert np.isfinite(npy(x)).all()


def test_level3_distributed(grid8, tgrid8):
    """Distributed operands (sizes the 2×4 grid divides and not)."""
    rng = np.random.default_rng(18)
    for n in (16, 13):
        a = rand(rng, (n, n)) + n * np.eye(n)
        b = rand(rng, (n, 8))
        with (pytest.warns(RuntimeWarning) if n == 13
              else contextlib.nullcontext()):
            ja, ta = both(a, "grid", grid8, tgrid8)
        jb, tb = both(b, "grid", grid8, tgrid8)
        close(tops.trsm("L", "L", "N", "N", 1.0, ta, tb),
              jops.trsm("L", "L", "N", "N", 1.0, ja, jb), np.float64)
        close(tops.trmm("R", "U", "T", "U", 2.0, ta, ta),
              jops.trmm("R", "U", "T", "U", 2.0, ja, ja), np.float64)
        close(tops.herk("L", "N", 1.0, tb), jops.herk("L", "N", 1.0, jb),
              np.float64)


# -- gemm and SUMMA ------------------------------------------------------------

@pytest.mark.parametrize("alg", SUMMA)
@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_summa_variants_match(grid8, tgrid8, alg, dt):
    rng = np.random.default_rng(7)
    m, k, n = 48, 32, 64
    a, b = rand(rng, (m, k), dt), rand(rng, (k, n), dt)
    ja, ta = both(a, "grids", grid8, tgrid8)
    jb, tb = both(b, "grids", grid8, tgrid8)
    C = tops.gemm("N", "N", 1.0, ta, tb, alg=alg)
    assert C.dist() == (tel.MC, tel.MR) and C.dtype == ta.dtype
    want = jops.gemm("N", "N", 1.0, ja, jb, alg=alg)
    close(C, want, dt, alg)
    if alg != "xla":
        close(tsumma.gemm_summa(torch.from_numpy(a), torch.from_numpy(b),
                                tgrid8, alg), want.to_numpy(), dt, alg)


@pytest.mark.parametrize("alg", SUMMA[1:])
@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_summa_nondivisible_shapes(grid8, tgrid8, alg, dt):
    """Padding path: shapes the grid does not divide."""
    rng = np.random.default_rng(8)
    m, k, n = 37, 23, 51
    a, b = rand(rng, (m, k), dt), rand(rng, (k, n), dt)
    with pytest.warns(RuntimeWarning):
        ja, ta = both(a, "grids", grid8, tgrid8)
    with pytest.warns(RuntimeWarning):
        jb, tb = both(b, "grids", grid8, tgrid8)
    close(tops.gemm("N", "N", 1.0, ta, tb, alg=alg),
          jops.gemm("N", "N", 1.0, ja, jb, alg=alg), dt, alg)


@pytest.mark.parametrize("oA,oB", [("N", "N"), ("N", "T"), ("T", "N"),
                                   ("T", "T"), ("C", "C"), ("C", "N")])
def test_gemm_orientations(grid8, tgrid8, oA, oB):
    rng = np.random.default_rng(9)
    m, k, n = 24, 16, 32
    dt = np.complex64 if "C" in (oA, oB) else np.float32
    a = rand(rng, (m, k) if oA == "N" else (k, m), dt)
    b = rand(rng, (k, n) if oB == "N" else (n, k), dt)
    ja, ta = both(a, "grid", grid8, tgrid8)
    jb, tb = both(b, "grid", grid8, tgrid8)
    close(tops.gemm(oA, oB, 2.0, ta, tb), jops.gemm(oA, oB, 2.0, ja, jb), dt)


def test_gemm_beta_accumulate_and_local(grid8, tgrid8):
    rng = np.random.default_rng(10)
    a, b, c = (rand(rng, (16, 16)) for _ in range(3))
    (ja, ta), (jb, tb), (jc, tc) = (both(x, "grids", grid8, tgrid8)
                                    for x in (a, b, c))
    out = tops.gemm("N", "N", 1.5, ta, tb, beta=-0.5, C=tc)
    assert out.dist() == (tel.MC, tel.MR)
    close(out, jops.gemm("N", "N", 1.5, ja, jb, beta=-0.5, C=jc), np.float64)
    close(tops.gemm("T", "N", 1.0, torch.from_numpy(a), torch.from_numpy(b)),
          jops.gemm("T", "N", 1.0, jnp.asarray(a), jnp.asarray(b)),
          np.float64)


def test_gemm_associativity(tgrid8):
    """(AB)x == A(Bx) (``Gemm_Suite.cpp`` TestAssociativity)."""
    rng = np.random.default_rng(7)
    m, k, n = 40, 24, 40
    a, b = rand(rng, (m, k)), rand(rng, (k, n))
    x = rng.standard_normal((n, 1))
    AB = tops.gemm("N", "N", 1.0, tel.distribute(a, tel.MC, tel.MR, tgrid8),
                   tel.distribute(b, tel.MC, tel.MR, tgrid8),
                   alg="stationary_c")
    np.testing.assert_allclose(AB.to_numpy() @ x, a @ (b @ x), rtol=1e-10)


def test_choose_algorithm_matches_jax(grid8, grid4, tgrid8):
    tgrid4 = Grid(devices=[CPU] * 4, height=2)
    tgrid1 = Grid(devices=[CPU])
    jgrid1 = jel.Grid(devices=jax.devices("cpu")[:1])
    sizes = [8, 64, 512, 4096, 1 << 14, 1 << 15]
    seen = set()
    for jg, tg in ((grid8, tgrid8), (grid4, tgrid4), (jgrid1, tgrid1)):
        for m in sizes:
            for n in sizes:
                for k in sizes:
                    for item in (4, 8):
                        want = jsumma.choose_algorithm(m, n, k, jg, item)
                        assert tsumma.choose_algorithm(m, n, k, tg,
                                                       item) == want
                        seen.add(want)
    assert seen == set(SUMMA)


def test_precision_setting_is_restored():
    """'highest' turns TF32 off for the call and restores the caller's
    flags; 'high' allows it."""
    seen = {}

    def probe(*_):
        seen["tf32"] = torch.backends.cuda.matmul.allow_tf32
        return torch.zeros(2, 2)

    from elemental_tpu_torch.ops import level3
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        wrapped = level3.with_precision(probe)
        wrapped()
        assert seen["tf32"] is False
        assert torch.backends.cuda.matmul.allow_tf32 is True
        level3.set_matmul_precision("high")
        wrapped()
        assert seen["tf32"] is True
        with pytest.raises(ValueError):
            level3.set_matmul_precision("bf16")
    finally:
        level3.set_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_gemm_3d(dt):
    """2×2×2 mesh: k split over depth, against the JAX package's."""
    rng = np.random.default_rng(19)
    m, k, n = 32, 64, 48
    a, b = rand(rng, (m, k), dt), rand(rng, (k, n), dt)
    jmesh = jops.make_3d_mesh(jax.devices("cpu"), depth=2)
    tmesh = tops.make_3d_mesh([CPU] * 8, depth=2)
    assert dict(tmesh.shape) == dict(jmesh.shape)
    close(tops.gemm_3d(torch.from_numpy(a), torch.from_numpy(b), tmesh),
          jops.gemm_3d(jnp.asarray(a), jnp.asarray(b), jmesh), dt)
    with pytest.raises(ValueError):
        tops.gemm_3d(torch.zeros(32, 62), torch.zeros(62, 48), tmesh)
