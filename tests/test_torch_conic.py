"""Parity of the port's interior-point engines beyond ``lp_direct`` with the
JAX package, on the CPU in float64, from the same NumPy inputs:
``lp_affine`` (Mehrotra and IPF), ``solve_mps``, ``qp_direct``, ``qp_box``,
``qp_affine``, ``socp_affine``, the SOC atoms and ``ConeOps``, and
``KKTFactor.solve_refined`` building its own panel-inverse context above
N = 4096.  The engines must take the JAX package's iteration counts, with
the objective to rtol 1e-7 and x to atol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from elemental_tpu.optimization import lp as jlp
from elemental_tpu.optimization import qp as jqp
from elemental_tpu.optimization import socp as jsocp
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse import io as jio

from elemental_tpu_torch.matrices import concat_fd_2d
from elemental_tpu_torch.optimization import lp as tlp
from elemental_tpu_torch.optimization import qp as tqp
from elemental_tpu_torch.optimization import socp as tsocp
from elemental_tpu_torch.sparse import SparseMatrix
from elemental_tpu_torch.sparse import io as tio

torch.set_num_threads(1)
F64 = torch.float64
CPU = dict(device="cpu", dtype=F64)


def _jax_matrix(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


def _ctrls(**kw):
    return jlp.LPCtrl(**kw), tlp.LPCtrl(**kw)


def _same_result(got, ref, rtol=1e-7, atol=1e-6):
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations
    np.testing.assert_allclose(got.objective, ref.objective, rtol=rtol)
    np.testing.assert_allclose(got.x, ref.x, atol=atol)


def _lp_affine_instance(seed=53):
    """tests/optimization/test_ipm.py:67's generator."""
    rng = np.random.default_rng(seed)
    m, k, n = 5, 12, 8
    A = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    b = A @ x0
    G = rng.standard_normal((k, n))
    h = G @ x0 + np.abs(rng.standard_normal(k)) + 0.1
    c = rng.standard_normal(n)
    return A, b, G, h, c


@pytest.mark.parametrize("approach", ["mehrotra", "ipf"])
def test_lp_affine_matches_reference(approach):
    A, b, G, h, c = _lp_affine_instance()
    jc, tc = _ctrls(tol=1e-9, approach=approach, max_iters=200)
    ref = jlp.lp_affine(JaxSparseMatrix.from_dense(A), b,
                        JaxSparseMatrix.from_dense(G), h, c, jc)
    got = tlp.lp_affine(SparseMatrix.from_dense(A), b,
                        SparseMatrix.from_dense(G), h, c, tc, **CPU)
    _same_result(got, ref)
    np.testing.assert_allclose(got.s, ref.s, atol=1e-6)
    assert got.tol_effective == ref.tol_effective
    # the slack is where the reference puts it: before tol_effective
    names = [f.name for f in dataclasses.fields(tlp.LPResult)]
    assert names == [f.name for f in dataclasses.fields(jlp.LPResult)]


def general_form_mps(n1: int, seed: int, upper_only: bool = True) -> str:
    """A feasible, bounded general-form LP on concat_fd_2d(n1, n1) as MPS
    text: E rows, every 10th row from the 4th L and from the 8th G, RANGES
    on half of those, and UP, LO, FX, FR, MI and a negative UP bound on
    every 20th column from the 2nd to the 7th (with ``upper_only`` False,
    the negative UP bounds are left out); an objective constant.  The
    interior point x0 satisfies every row and bound; c = A_Eᵀy0 + d with d
    ≥ 0 on lower-bounded columns, ≤ 0 on upper-bounded ones and 0 on free
    ones, so the dual is feasible too."""
    A = concat_fd_2d(n1, n1)
    m, n = A.shape
    rng = np.random.default_rng(seed)
    kind = np.full(m, "E")
    kind[3::10], kind[7::10] = "L", "G"
    ranged = (kind != "E") & (np.arange(m) % 20 >= 10)
    x0 = rng.uniform(0.5, 1.5, n)
    bound = np.full(n, "", dtype="<U3")
    for off, bk in enumerate(("UP", "LO", "FX", "FR", "MI", "UPN"), 1):
        bound[off::20] = bk
    if not upper_only:
        bound[bound == "UPN"] = ""
    x0[bound == "UPN"] = -rng.uniform(2.0, 3.0, int((bound == "UPN").sum()))
    val = {"UP": x0 + 1.0, "LO": x0 - 1.0, "FX": x0, "UPN": x0 + 1.0}
    ax = A.to_scipy() @ x0
    rhs = ax + np.where(kind == "L", 1.0, np.where(kind == "G", -1.0, 0.0))
    eq = np.nonzero(kind == "E")[0]
    d = rng.uniform(0.1, 1.0, n)
    d[bound == "UPN"] *= -1.0
    d[(bound == "FR") | (bound == "MI")] = 0.0
    d[(bound == "UP") | (bound == "FX")] -= 0.55
    Aeq = A.to_scipy()[eq]
    c = Aeq.T @ rng.standard_normal(eq.size) + d
    csc = A.to_scipy().tocsc()
    out = [f"NAME          GEN{n1}", "ROWS", " N  OBJ"]
    out += [f" {kind[i]}  R{i}" for i in range(m)]
    out.append("COLUMNS")
    for j in range(n):
        out.append(f"    C{j}  OBJ  {float(c[j])!r}")
        for p in range(csc.indptr[j], csc.indptr[j + 1]):
            out.append(f"    C{j}  R{csc.indices[p]}  {float(csc.data[p])!r}")
    out.append("RHS")
    out.append(f"    RHS  OBJ  {-7.25!r}")
    out += [f"    RHS  R{i}  {float(rhs[i])!r}" for i in range(m)]
    out.append("RANGES")
    out += [f"    RNG  R{i}  3.0" for i in np.nonzero(ranged)[0]]
    out.append("BOUNDS")
    for j in np.nonzero(bound != "")[0]:
        bk = bound[j]
        v = f"  {float(val[bk][j])!r}" if bk in val else ""
        out.append(f" {'UP' if bk == 'UPN' else bk} BND  C{j}{v}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"


def test_solve_mps_matches_reference(tmp_path, monkeypatch):
    """solve_mps on a general-form file against the JAX solve_mps on its
    python-orchestrated path (LARGE_FUSED_N=1), the JAX data given the
    port's objective constant; without upper-only columns, which the JAX
    package standardizes into an infeasible LP (see the next test)."""
    path = str(tmp_path / "gen.mps")
    with open(path, "w") as f:
        f.write(general_form_mps(4, seed=2, upper_only=False))
    t = tio.read_mps(path)
    assert t.c0 == 7.25
    j = dataclasses.replace(jio.read_mps(path), c0=t.c0)
    monkeypatch.setattr(jlp, "LARGE_FUSED_N", 1)
    jc, tc = _ctrls(tol=1e-9, max_iters=200)
    ref, xr = jlp.solve_mps(j, jc)
    got, xg = tlp.solve_mps(t, tc, **CPU)
    # x in the general form: the standard form's free-column splits
    # xp − xm have a null direction, along which the two may part
    _same_result(dataclasses.replace(got, x=xg), dataclasses.replace(ref,
                                                                     x=xr))


@pytest.mark.parametrize("n1", [4, 8])
def test_solve_mps_matches_highs(tmp_path, n1):
    """solve_mps with every bound kind, upper-only columns included, to
    HiGHS's objective on the general form (rtol 1e-7)."""
    import scipy.optimize as so
    path = str(tmp_path / "gen.mps")
    with open(path, "w") as f:
        f.write(general_form_mps(n1, seed=2))
    lp = tio.read_mps(path)
    assert np.isneginf(lp.lower).any() and np.isfinite(lp.upper).any()
    res, x = tlp.solve_mps(lp, tlp.LPCtrl(tol=1e-9, max_iters=200), **CPU)
    bounds = [(None if np.isneginf(lo) else lo,
               None if np.isposinf(hi) else hi)
              for lo, hi in zip(lp.lower, lp.upper)]
    ref = so.linprog(lp.c, A_ub=lp.A_le.to_dense(), b_ub=lp.b_le,
                     A_eq=lp.A_eq.to_dense(), b_eq=lp.b_eq, bounds=bounds,
                     method="highs")
    assert ref.success and res.converged
    np.testing.assert_allclose(res.objective, ref.fun + lp.c0, rtol=1e-7)
    np.testing.assert_allclose(lp.c @ x + lp.c0, res.objective, rtol=1e-9)


def _qp_direct_instance(seed=53):
    """tests/optimization/test_ipm.py:85's generator."""
    rng = np.random.default_rng(seed)
    n, m = 10, 3
    L = rng.standard_normal((n, n))
    Q = L @ L.T + np.eye(n)
    A = rng.standard_normal((m, n))
    b = A @ np.abs(rng.standard_normal(n))
    c = rng.standard_normal(n)
    return Q, A, b, c


def test_qp_direct_matches_reference():
    Q, A, b, c = _qp_direct_instance()
    jc, tc = _ctrls(tol=1e-9)
    ref = jqp.qp_direct(Q, A, b, c, jc)
    got = tqp.qp_direct(Q, A, b, c, tc, **CPU)
    _same_result(got, ref)
    # test_ipm.py:94-98's KKT gate on the port
    x, y, z = got.x, got.y, got.z
    np.testing.assert_allclose(Q @ x + c, A.T @ y + z, atol=1e-6)
    assert x.min() > -1e-9 and z.min() > -1e-9
    assert abs(x @ z) < 1e-6


def test_qp_box_matches_reference():
    rng = np.random.default_rng(9)
    n = 12
    M = rng.standard_normal((n, n))
    Q = M @ M.T + np.eye(n)
    c = rng.standard_normal(n) * 5
    lower, upper = -np.ones(n), np.full(n, 0.5)
    jc, tc = _ctrls(tol=1e-9)
    ref = jqp.qp_box(Q, c, lower, upper, jc)
    got = tqp.qp_box(Q, c, lower, upper, tc, **CPU)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    assert got.min() >= -1 - 1e-6 and got.max() <= 0.5 + 1e-6


def test_qp_affine_matches_reference():
    """examples/qp_affine_ex.py's instance: box |x| ≤ 1 as Gx + s = h."""
    rng = np.random.default_rng(5)
    n, m = 12, 3
    M = rng.standard_normal((n, n))
    Q = M @ M.T + n * np.eye(n)
    c = rng.standard_normal(n)
    A = rng.standard_normal((m, n))
    b = A @ rng.uniform(-0.4, 0.4, n)
    G = np.concatenate([np.eye(n), -np.eye(n)])
    h = np.ones(2 * n)
    jc, tc = _ctrls(tol=1e-8)
    ref = jqp.qp_affine(Q, A, b, G, h, c, jc)
    got = tqp.qp_affine(Q, A, b, G, h, c, tc, **CPU)
    _same_result(got, ref)
    np.testing.assert_allclose(got.s, ref.s, atol=1e-6)


def _socp_lstsq_instance(seed=53):
    """tests/optimization/test_ipm.py:112's least-squares SOCP."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((12, 5))
    d = rng.standard_normal(12)
    n = 6
    G = np.zeros((13, n))
    G[0, 5] = -1.0
    G[1:, :5] = -B
    h = np.concatenate([[0], -d])
    c = np.zeros(n)
    c[5] = 1.0
    return np.zeros((0, n)), np.zeros(0), G, h, c, [13], (B, d)


def _socp_mixed_instance(seed=4):
    """Orders 1, 2, 3 and 5 interleaved, an equality row, a strictly
    feasible primal (h − Gx0 in the cones' interior) and dual (c =
    −Aᵀy0 − Gᵀz0, z0 in the interior), so the optimum is finite."""
    rng = np.random.default_rng(seed)
    orders = [3, 1, 5, 2, 1, 3, 1, 2]
    k, n, m = sum(orders), 7, 2
    cones = jsocp.Cones(orders)
    inner = np.zeros(k)
    for f, o in zip(cones.first, cones.orders):
        v = rng.standard_normal(o) * 0.3
        v[0] = np.linalg.norm(v[1:]) + rng.uniform(0.5, 1.5)
        inner[f:f + o] = v
    G = rng.standard_normal((k, n))
    A = rng.standard_normal((m, n))
    x0 = rng.standard_normal(n)
    h = G @ x0 + inner
    b = A @ x0
    z0 = 0.7 * inner + 0.2 * jsocp.soc_identity(cones)
    c = -A.T @ rng.standard_normal(m) - G.T @ z0
    return A, b, G, h, c, orders, None


@pytest.mark.parametrize("case", ["lstsq_13", "mixed_orders"])
def test_socp_affine_matches_reference(case):
    inst = (_socp_lstsq_instance() if case == "lstsq_13"
            else _socp_mixed_instance())
    A, b, G, h, c, orders, extra = inst
    jc, tc = _ctrls(max_iters=200, tol=1e-9)
    ref = jsocp.socp_affine(A, b, G, h, c, jsocp.Cones(orders), jc)
    got = tsocp.socp_affine(A, b, G, h, c, tsocp.Cones(orders), tc, **CPU)
    _same_result(got, ref)
    for f in ("y", "z", "s"):
        np.testing.assert_allclose(getattr(got, f), getattr(ref, f),
                                   atol=1e-6)
    assert tsocp.in_cone(got.s, tsocp.Cones(orders), -1e-9)
    if extra is not None:                       # test_ipm.py:126-127's gate
        B, d = extra
        expect, *_ = np.linalg.lstsq(B, d, rcond=None)
        np.testing.assert_allclose(got.x[:5], expect, atol=1e-6)


def test_soc_atoms_match_reference():
    """test_ipm.py:101's atoms, then every host atom on random points, to
    1e-12 of the JAX package's."""
    cones = tsocp.Cones([3, 2])
    e = tsocp.soc_identity(cones)
    np.testing.assert_array_equal(e, [1, 0, 0, 1, 0])
    s = np.array([2.0, 1.0, 0.5, 3.0, 1.0])
    np.testing.assert_allclose(tsocp.soc_dets(s, cones), [4 - 1.25, 8.0])
    sinv = tsocp.soc_inverse(s, cones)
    np.testing.assert_allclose(tsocp.soc_apply(s, sinv, cones), e,
                               atol=1e-12)
    rng = np.random.default_rng(3)
    orders = [4, 1, 3, 2, 5]
    tc, jc = tsocp.Cones(orders), jsocp.Cones(orders)
    for _ in range(4):
        x, y = rng.standard_normal(tc.dim), rng.standard_normal(tc.dim)
        x[tc.first] = np.abs(x[tc.first]) + 3.0
        for name in ("soc_dets", "soc_inverse", "soc_min_eig"):
            np.testing.assert_allclose(getattr(tsocp, name)(x, tc),
                                       getattr(jsocp, name)(x, jc),
                                       rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(tsocp.soc_apply(x, y, tc),
                                   jsocp.soc_apply(x, y, jc), atol=1e-12)
        assert tsocp.in_cone(x, tc) == jsocp.in_cone(x, jc)
        assert tsocp.max_step(x, y * 5, tc) == jsocp.max_step(x, y * 5, jc)


def _interior(rng, cones, scale=1.0):
    v = rng.standard_normal(cones.dim) * scale
    for f, o in zip(cones.first, cones.orders):
        v[f] = np.linalg.norm(v[f + 1:f + o]) + rng.uniform(0.2, 2.0)
    return v


def test_cone_ops_match_reference():
    """ConeOps on tensors against the JAX ConeOps on random interior points
    of a mixed-order cone set (order-1 cones included), to 1e-12 relative:
    nt_scaling, max_step, arrow_solve, qrep_vals and the other batched
    atoms, and dyn_indices exactly."""
    rng = np.random.default_rng(11)
    orders = [1, 4, 2, 1, 3, 4, 6, 1, 2]
    tc, jc = tsocp.Cones(orders), jsocp.Cones(orders)
    tops, jops = tsocp.ConeOps(tc, device="cpu"), jsocp.ConeOps(jc)
    for off in (0, 17):
        for a, b in zip(tops.dyn_indices(off), jops.dyn_indices(off)):
            np.testing.assert_array_equal(a, b)
    T, J = torch.as_tensor, jnp.asarray

    def same(got, ref, tol=1e-12):
        ref = np.asarray(ref)
        got = got.numpy() if isinstance(got, torch.Tensor) else got
        scale = max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(got - ref).max()) <= tol * scale

    for _ in range(3):
        s, z = _interior(rng, tc), _interior(rng, tc)
        v, ds = rng.standard_normal(tc.dim), rng.standard_normal(tc.dim) * 4
        for got, ref in zip(tops.nt_scaling(T(s), T(z)),
                            jops.nt_scaling(J(s), J(z))):
            same(got, ref)
        for tau in (1.0, 0.99):
            same(tops.max_step(T(s), T(ds), tau),
                 jops.max_step(J(s), J(ds), tau))
        same(tops.arrow_solve(T(s), T(v)), jops.arrow_solve(J(s), J(v)))
        for name in ("qrep_vals", "hinv_vals", "hess_vals", "jsqrt", "jinv",
                     "grad"):
            same(getattr(tops, name)(T(s)), getattr(jops, name)(J(s)))
        for name in ("qrep_apply", "hinv_apply", "hess_apply", "jprod",
                     "duality"):
            same(getattr(tops, name)(T(s), T(v)),
                 getattr(jops, name)(J(s), J(v)))
        same(tops.min_eig(T(s)), jops.min_eig(J(s)))


def test_solve_refined_builds_context_above_4096():
    """KKTFactor.solve_refined with no context at N > 4096 (the LP KKT of
    concat_fd_2d(40, 40), N = 4,800): port and JAX each build the panel
    inverses themselves; the solves agree to 1e-10, and equal the port's
    solve with the context passed in."""
    A = tlp.sparse_ruiz(concat_fd_2d(40, 40))[0]
    jk, _ = jlp._build_lp_kkt(_jax_matrix(A), 1e-2, 1e-2, None)
    tk, _ = tlp._build_lp_kkt(A, 1e-2, 1e-2, np.asarray(jk.symb.perm),
                              **CPU)
    assert tk.N == 4800
    n = A.width
    rng = np.random.default_rng(12)
    theta = rng.uniform(0.05, 20.0, n)
    x = rng.standard_normal(tk.N)
    reg = np.concatenate([np.full(n, 1e-2), np.full(tk.N - n, -1e-2)])
    jf = jax.jit(lambda v: jk.prepare(v))(jk.assemble([jnp.asarray(theta)]))
    ref = jax.jit(lambda f, b: f.solve_refined(b, jnp.asarray(reg),
                                               iters=3))(jf, jnp.asarray(x))
    tf = tk.prepare(tk.assemble([torch.as_tensor(theta)]))
    assert tk.N > tf.SOLVE_CONTEXT_MIN_N and tf.default_context() is not None
    got = tf.solve_refined(torch.as_tensor(x), torch.as_tensor(reg), iters=3)
    ref = np.asarray(ref)
    assert np.abs(got.numpy() - ref).max() <= 1e-10 * np.abs(ref).max()
    with_ctx = tf.solve_refined(torch.as_tensor(x), torch.as_tensor(reg),
                                iters=3, ctx=tf.solve_context())
    torch.testing.assert_close(got, with_ctx, rtol=0, atol=0)

