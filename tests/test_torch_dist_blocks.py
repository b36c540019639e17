"""The port's DistMatrix stores one block per grid position and its BLAS
tier computes on the blocks, held against the JAX package on 2×2 grids
(the JAX package's ``grid4`` over forced host devices; the port's 2×2 grid
over torch's CPU device).

* Storage: every block owns storage of its own size, made by
  ``distribute`` and by an op.
* The HLO oracle: for every public function of ``ops.level1-3`` on
  64×64 [MC,MR] operands, the JAX call is compiled on ``grid4`` and its
  all-gathers read; where none of them gathers a whole operand or result,
  the port's transfer log holds no such all-gather and the port neither
  assembles a matrix nor cuts a whole one.  Where the JAX HLO gathers a
  whole operand, the port may assemble, and the assembly is recorded.
* ``ops.gemm`` on two DistMatrix, every algorithm, at 64×128×96 and at
  37×23×51 (every dimension replicated).
* The assembly at the first position is counted; a 1×1 grid and host
  reads record nothing.

Tolerances: 1e-12 (float64) and 1e-5 (float32) of max|JAX result|.
Distributions of distributed results are the JAX package's.
"""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import elemental_tpu as jel
from elemental_tpu import ops as jops
from elemental_tpu.utils.collectives import _OP_RE, _SHAPE_RE

import elemental_tpu_torch as tel
from elemental_tpu_torch import ops as tops
from elemental_tpu_torch.core import MC, MR, STAR, VC, Grid, distribute
from elemental_tpu_torch.core.distmatrix import DistMatrix
from elemental_tpu_torch.ops import level1, level2, level3
from elemental_tpu_torch.utils import count_transfers

torch.set_num_threads(1)

CPU = torch.device("cpu")
N = 64
TOL = {np.float32: 1e-5, np.float64: 1e-12}
INT_TYPES = {"pred", "s8", "s16", "s32", "s64", "u8", "u16", "u32", "u64"}


@pytest.fixture(scope="module")
def tgrid4():
    return Grid(devices=[CPU] * 4, height=2)


def npy(x):
    if isinstance(x, tuple):
        return tuple(npy(v) for v in x)
    if isinstance(x, (tel.DistMatrix, jel.DistMatrix)):
        return x.to_numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().resolve_conj().resolve_neg().numpy()
    return np.asarray(x)


def close(got, want, tol, what=""):
    g, w = npy(got), npy(want)
    if isinstance(w, tuple):
        assert isinstance(g, tuple) and len(g) == len(w), what
        for gi, wi in zip(g, w):
            close(gi, wi, tol, what)
        return
    assert g.shape == w.shape, (what, g.shape, w.shape)
    scale = max(1.0, float(np.max(np.abs(w)))) if w.size else 1.0
    np.testing.assert_allclose(g, w, rtol=tol, atol=tol * scale,
                               err_msg=what)


def owns_storage(t: torch.Tensor) -> bool:
    return t.untyped_storage().nbytes() == t.numel() * t.element_size()


# -- storage -------------------------------------------------------------------

@pytest.mark.parametrize("made", ["distribute", "op"])
@pytest.mark.parametrize("dist", [(MC, MR), (VC, STAR), (STAR, STAR)],
                         ids=["MC,MR", "VC,STAR", "STAR,STAR"])
def test_blocks_own_their_storage(tgrid4, dist, made):
    """Each block's storage is its own size; [MC,MR] and [VC,STAR] blocks
    are four tensors, a replicated matrix one tensor shared by the
    positions on the one device."""
    a = np.random.default_rng(0).standard_normal((N, N))
    A = distribute(a, *dist, tgrid4)
    if made == "op":
        A = tops.axpy(2.0, A, tops.scale(0.5, A))
        a = 2.5 * a
    blocks = [A.local(i, j) for i, j in tgrid4.positions()]
    assert all(owns_storage(b) for b in blocks)
    distinct = {b.data_ptr() for b in blocks}
    assert len(distinct) == (1 if dist == (STAR, STAR) else 4)
    np.testing.assert_allclose(A.to_numpy(), a, rtol=1e-14)


def test_redistributed_blocks_own_their_storage(tgrid4):
    """A filter from a replicated matrix copies each block out of it."""
    S = distribute(np.ones((N, N)), STAR, STAR, tgrid4)
    for pair in ((MC, MR), (VC, STAR), (MR, MC)):
        B = S.redistribute(*pair)
        assert all(owns_storage(B.local(i, j)) for i, j in tgrid4.positions())
        assert B.local(1, 1).untyped_storage().nbytes() < N * N * 8


# -- the assembly is counted ---------------------------------------------------

def test_assembly_is_an_all_gather_at_the_first_position(tgrid4):
    a = np.arange(float(N * N)).reshape(N, N)
    A = distribute(a, MC, MR, tgrid4)
    with count_transfers() as log:
        whole = tel.core.as_array(A)
    assert [(r.kind, r.shape) for r in log] == [("all-gather", (N, N))]
    assert log.bytes() == 3 * N * N * 8 // 4     # the three other blocks
    np.testing.assert_array_equal(whole.numpy(), a)
    with count_transfers() as log:
        B = A.like(whole)
    assert [r.kind for r in log] == ["collective-permute"] * 3
    assert log.bytes() == 3 * N * N * 8 // 4
    with count_transfers() as log:
        np.testing.assert_array_equal(A.to_numpy(), a)
        np.testing.assert_array_equal(tel.core.distmatrix.as_numpy(B), a)
    assert len(log) == 0
    g1 = Grid(devices=[CPU])
    with count_transfers() as log:
        tel.core.as_array(distribute(a, MC, MR, g1))
    assert len(log) == 0


def test_mixed_layouts_and_local_operands(tgrid4):
    """A [VC,STAR] operand against an [MC,MR] template is relaid out
    (recorded, no whole gather); a local operand is sliced unrecorded."""
    rng = np.random.default_rng(1)
    x, y = rng.standard_normal((N, N)), rng.standard_normal((N, N))
    Y = distribute(y, MC, MR, tgrid4)
    with count_transfers() as log:
        out = tops.axpy(2.0, distribute(x, VC, STAR, tgrid4), Y)
    assert out.dist() == (MC, MR)
    assert log.of("all-to-all") and not log.of("all-gather")
    np.testing.assert_allclose(out.to_numpy(), y + 2.0 * x, rtol=1e-15)
    with count_transfers() as log:
        out = tops.axpy(2.0, torch.from_numpy(x), Y)
    assert len(log) == 0
    np.testing.assert_allclose(out.to_numpy(), y + 2.0 * x, rtol=1e-15)


# -- the HLO oracle ------------------------------------------------------------

ROWS, COLS = np.array([0, 3, 40, 63]), np.array([1, 2, 33, 50, 7])


def _cases():
    """name → fn(ops, A, B, C, x, y, d, sub), a case per public function
    (variants after a space)."""
    r, c = ROWS, COLS
    return {
        "copy": lambda m, A, B, C, x, y, d, s: m.copy(A),
        "zero": lambda m, A, B, C, x, y, d, s: m.zero(A),
        "fill": lambda m, A, B, C, x, y, d, s: m.fill(A, 2.5),
        "entrywise_fill": lambda m, A, B, C, x, y, d, s: m.entrywise_fill(
            A, lambda shape: np.full(shape, 3.0)),
        "entrywise_map": lambda m, A, B, C, x, y, d, s: m.entrywise_map(
            A, lambda v: 2 * v + 1),
        "index_dependent_map": lambda m, A, B, C, x, y, d, s:
            m.index_dependent_map(A, lambda i, j, v: v + i * 10 + j),
        "scale": lambda m, A, B, C, x, y, d, s: m.scale(2.0, A),
        "axpy": lambda m, A, B, C, x, y, d, s: m.axpy(2.0, A, B),
        "axpby": lambda m, A, B, C, x, y, d, s: m.axpby(2.0, A, -0.5, B),
        "safe_scale": lambda m, A, B, C, x, y, d, s: m.safe_scale(3.0, 7.0,
                                                                  A),
        "shift": lambda m, A, B, C, x, y, d, s: m.shift(A, 1.5),
        "shift_diagonal": lambda m, A, B, C, x, y, d, s:
            m.shift_diagonal(A, 2.0, 1),
        "dot": lambda m, A, B, C, x, y, d, s: m.dot(A, B),
        "dotu": lambda m, A, B, C, x, y, d, s: m.dotu(A, B),
        "nrm2": lambda m, A, B, C, x, y, d, s: m.nrm2(A),
        "hadamard": lambda m, A, B, C, x, y, d, s: m.hadamard(A, B),
        "max_abs_loc": lambda m, A, B, C, x, y, d, s: m.max_abs_loc(A),
        "min_abs_loc": lambda m, A, B, C, x, y, d, s: m.min_abs_loc(A),
        "column_norms": lambda m, A, B, C, x, y, d, s: m.column_norms(A),
        "row_norms": lambda m, A, B, C, x, y, d, s: m.row_norms(A),
        "column_max_norms": lambda m, A, B, C, x, y, d, s:
            m.column_max_norms(A),
        "row_max_norms": lambda m, A, B, C, x, y, d, s: m.row_max_norms(A),
        "transpose": lambda m, A, B, C, x, y, d, s: m.transpose(A),
        "adjoint": lambda m, A, B, C, x, y, d, s: m.adjoint(A),
        "conjugate": lambda m, A, B, C, x, y, d, s: m.conjugate(A),
        "get_diagonal": lambda m, A, B, C, x, y, d, s: m.get_diagonal(A, -2),
        "set_diagonal": lambda m, A, B, C, x, y, d, s: m.set_diagonal(
            A, d[:62], 2),
        "update_diagonal": lambda m, A, B, C, x, y, d, s: m.update_diagonal(
            A, d[:63], -1),
        "get_submatrix": lambda m, A, B, C, x, y, d, s: m.get_submatrix(
            A, r, c),
        "set_submatrix": lambda m, A, B, C, x, y, d, s: m.set_submatrix(
            A, r, c, s),
        "update_submatrix": lambda m, A, B, C, x, y, d, s:
            m.update_submatrix(A, r, c, 0.5, s),
        "kronecker": lambda m, A, B, C, x, y, d, s: m.kronecker(A, B),
        "concatenate": lambda m, A, B, C, x, y, d, s: m.concatenate([A, B],
                                                                    1),
        "concatenate rows": lambda m, A, B, C, x, y, d, s: m.concatenate(
            [A, B], 0),
        "reshape": lambda m, A, B, C, x, y, d, s: m.reshape(A, 32, 128),
        "swap_rows": lambda m, A, B, C, x, y, d, s: m.swap_rows(A, 1, 60),
        "round_": lambda m, A, B, C, x, y, d, s: m.round_(A),
        "real": lambda m, A, B, C, x, y, d, s: m.real(A),
        "imag": lambda m, A, B, C, x, y, d, s: m.imag(A),
        "make_symmetric": lambda m, A, B, C, x, y, d, s: m.make_symmetric(
            A, "U"),
        "make_hermitian": lambda m, A, B, C, x, y, d, s: m.make_hermitian(
            A, "L"),
        "make_trapezoidal": lambda m, A, B, C, x, y, d, s:
            m.make_trapezoidal(A, "U", -1),
        "diagonal_scale": lambda m, A, B, C, x, y, d, s: m.diagonal_scale(
            "L", d, A),
        "diagonal_solve": lambda m, A, B, C, x, y, d, s: m.diagonal_solve(
            "R", d, A),
        "symmetric_diagonal_equil": lambda m, A, B, C, x, y, d, s:
            m.symmetric_diagonal_equil(A, d),
        # level 2
        "gemv": lambda m, A, B, C, x, y, d, s: m.gemv("N", 1.5, A, x),
        "gemv T": lambda m, A, B, C, x, y, d, s: m.gemv("T", 1.5, A, x, 0.5,
                                                        y),
        "ger": lambda m, A, B, C, x, y, d, s: m.ger(2.0, x, y, A),
        "geru": lambda m, A, B, C, x, y, d, s: m.geru(2.0, x, y, A),
        "symv": lambda m, A, B, C, x, y, d, s: m.symv("U", 1.0, A, x, 2.0,
                                                      y),
        "hemv": lambda m, A, B, C, x, y, d, s: m.hemv("L", 1.0, A, x),
        "syr": lambda m, A, B, C, x, y, d, s: m.syr("L", 0.5, x, A),
        "her": lambda m, A, B, C, x, y, d, s: m.her("U", 0.5, x, A),
        "syr2": lambda m, A, B, C, x, y, d, s: m.syr2("U", 0.5, x, y, A),
        "her2": lambda m, A, B, C, x, y, d, s: m.her2("L", 0.5, x, y, A),
        "trmv": lambda m, A, B, C, x, y, d, s: m.trmv("L", "N", "N", A, x),
        "trmv T": lambda m, A, B, C, x, y, d, s: m.trmv("U", "T", "U", A, x),
        "trsv": lambda m, A, B, C, x, y, d, s: m.trsv("L", "N", "N", C, x),
        "apply_givens_sequence": lambda m, A, B, C, x, y, d, s:
            m.apply_givens_sequence("L", x[:63], y[:63], A),
        "apply_givens_sequence R": lambda m, A, B, C, x, y, d, s:
            m.apply_givens_sequence("R", x[:63], y[:63], A),
        # level 3
        "gemm": lambda m, A, B, C, x, y, d, s: m.gemm("N", "N", 1.0, A, B),
        "gemm TN": lambda m, A, B, C, x, y, d, s: m.gemm("T", "N", 1.5, A, B,
                                                         0.5, C),
        "gemm NT": lambda m, A, B, C, x, y, d, s: m.gemm("N", "T", 1.0, A, B,
                                                         alg="xla"),
        "symm": lambda m, A, B, C, x, y, d, s: m.symm("L", "L", 2.0, A, B,
                                                      0.5, C),
        "symm R": lambda m, A, B, C, x, y, d, s: m.symm("R", "U", 2.0, A, B),
        "hemm": lambda m, A, B, C, x, y, d, s: m.hemm("L", "U", 1.0, A, B),
        "herk": lambda m, A, B, C, x, y, d, s: m.herk("L", "N", 1.0, A),
        "herk C": lambda m, A, B, C, x, y, d, s: m.herk("U", "C", 1.0, A,
                                                        0.5, C),
        "syrk": lambda m, A, B, C, x, y, d, s: m.syrk("U", "T", 2.0, A),
        "her2k": lambda m, A, B, C, x, y, d, s: m.her2k("L", "N", 1.5, A, B,
                                                        1.0, C),
        "syr2k": lambda m, A, B, C, x, y, d, s: m.syr2k("U", "T", 0.5, A, B),
        "trrk": lambda m, A, B, C, x, y, d, s: m.trrk("L", "N", "N", 1.0, A,
                                                      B, 1.0, C),
        "trrk UC": lambda m, A, B, C, x, y, d, s: m.trrk("U", "N", "C", 2.0,
                                                         A, B, 0.5, C),
        "trr2k": lambda m, A, B, C, x, y, d, s: m.trr2k(
            "L", "N", "N", "N", "T", 1.0, A, B, -1.0, B, A, 0.5, C),
        "trmm": lambda m, A, B, C, x, y, d, s: m.trmm("L", "U", "N", "N",
                                                      1.0, A, B),
        "trmm RLT": lambda m, A, B, C, x, y, d, s: m.trmm("R", "L", "T", "U",
                                                          1.0, A, B),
        "trsm": lambda m, A, B, C, x, y, d, s: m.trsm("L", "L", "N", "N",
                                                      1.0, C, B),
        "multishift_trsm": lambda m, A, B, C, x, y, d, s:
            m.multishift_trsm("L", "U", "N", 1.0, C, -d, B),
        "quasi_trsm": lambda m, A, B, C, x, y, d, s: m.quasi_trsm(
            "L", "U", "N", 1.0, C, B),
        "twosided_trsm": lambda m, A, B, C, x, y, d, s: m.twosided_trsm(
            "L", "N", A, C),
        "twosided_trmm": lambda m, A, B, C, x, y, d, s: m.twosided_trmm(
            "L", "N", A, B),
        "twosided_trmm U": lambda m, A, B, C, x, y, d, s: m.twosided_trmm(
            "U", "U", A, B, False),
        "hermitian_from_evd": lambda m, A, B, C, x, y, d, s:
            m.hermitian_from_evd("L", d, A),
        "normal_from_evd": lambda m, A, B, C, x, y, d, s:
            m.normal_from_evd(d + 0.5j, A),
        "safe_multishift_trsm": lambda m, A, B, C, x, y, d, s:
            m.safe_multishift_trsm("L", "U", "N", 1.0, C, -d, B),
    }


CASES = _cases()


def _public(module):
    return {n for n, f in vars(module).items()
            if callable(f) and not n.startswith("_")
            and getattr(f, "__module__", None) == module.__name__}


def test_the_oracle_covers_every_public_function():
    named = {k.split()[0] for k in CASES}
    want = (set(level1.__all__) | _public(level2) | _public(level3)) \
        - {"set_matmul_precision", "with_precision"}
    assert want <= named, sorted(want - named)


def _operands(dtype):
    """A, B, C (C triangular-dominant, for the solves), x, y, d, sub."""
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal((N, N)).astype(dtype) for _ in range(2))
    c = (np.tril(rng.standard_normal((N, N))) + N * np.eye(N)).astype(dtype)
    c = c + np.triu(c.T, 1) * 0.01
    x, y = (rng.standard_normal(N).astype(dtype) for _ in range(2))
    d = (np.arange(N) + 1.0).astype(dtype)
    sub = rng.standard_normal((4, 5)).astype(dtype)
    return (a, b, c), (x, y, d, sub)


def _whole(shape, dtype_txt, wholes, matrix_numel) -> bool:
    """An all-gather of ``shape`` holds a whole operand or result: a
    floating shape equal to one, or at least a whole matrix's entries."""
    if dtype_txt in INT_TYPES:
        return False
    return tuple(shape) in wholes or int(np.prod(shape)) >= matrix_numel


def _jax_gathers(txt):
    """(dims, dtype) of each all-gather of a compiled HLO text."""
    out = []
    for line in txt.splitlines():
        m = _OP_RE.search(line)
        if m and m.group(2) == "all-gather" and "-done(" not in line:
            out += [(tuple(int(v) for v in dims.split(",") if v), dt)
                    for dt, dims in _SHAPE_RE.findall(m.group(1))]
    return out


def _shapes(x):
    if isinstance(x, tuple):
        return set().union(*(_shapes(v) for v in x))
    return {tuple(x.shape)}


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_blocks_where_the_hlo_has_no_whole_gather(grid4, tgrid4, name, dt,
                                                  monkeypatch):
    mats, vecs = _operands(dt)
    fn = CASES[name]
    J = [jel.distribute(v, jel.MC, jel.MR, grid4) for v in mats]
    T = [distribute(v, MC, MR, tgrid4) for v in mats]
    compiled = jax.jit(lambda A, B, C: fn(jops, A, B, C, *vecs)) \
        .lower(*J).compile()
    want = compiled(*J)
    tv = [torch.from_numpy(v.copy()) for v in vecs]
    calls = {"assemble": 0, "like": 0}
    for meth in calls:
        orig = getattr(DistMatrix, meth)

        def counted(self, *a, _orig=orig, _meth=meth, **k):
            calls[_meth] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(DistMatrix, meth, counted)
    with count_transfers() as log:
        got = fn(tops, *T, *tv)
    monkeypatch.undo()
    close(got, want, TOL[dt], name)
    if isinstance(want, jel.DistMatrix):
        assert got.dist() == tuple(tel.Dist(v.value) for v in want.dist())
    wholes = {(N, N)} | _shapes(npy(want))
    jax_whole = any(_whole(s, t, wholes, N * N)
                    for s, t in _jax_gathers(compiled.as_text()))
    port_whole = [r for r in log.of("all-gather")
                  if _whole(r.shape, "", wholes, N * N)]
    if not jax_whole:
        assert not port_whole, (name, port_whole)
        assert calls == {"assemble": 0, "like": 0}, (name, calls)
    elif calls["assemble"]:
        assert port_whole, name                   # the assembly is recorded
    assert (name.split()[0] in WHOLE_IN_JAX) == jax_whole, name


# the functions whose JAX HLO on grid4 gathers a whole operand
WHOLE_IN_JAX = {"make_symmetric", "make_hermitian", "max_abs_loc",
                "min_abs_loc", "symv", "hemv", "trsv", "trsm",
                "multishift_trsm", "quasi_trsm", "twosided_trsm",
                "safe_multishift_trsm"}


# -- gemm on two DistMatrix ----------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128, 96), (37, 23, 51)],
                         ids=["64x128x96", "37x23x51"])
@pytest.mark.parametrize("alg", ["xla", "stationary_c", "stationary_a",
                                 "stationary_b", "pipelined"])
def test_gemm_on_blocks(grid4, tgrid4, alg, shape):
    """No whole operand or result is gathered, the product stays [MC,MR]
    in blocks, and the values are the JAX package's."""
    m, k, n = shape
    for dt in (np.float32, np.float64):
        rng = np.random.default_rng(6)
        a, b = (rng.standard_normal(s).astype(dt) for s in ((m, k), (k, n)))
        with pytest.warns(RuntimeWarning) if m % 2 else nullcontext():
            J = [jel.distribute(v, jel.MC, jel.MR, grid4) for v in (a, b)]
        with pytest.warns(RuntimeWarning) if m % 2 else nullcontext():
            T = [distribute(v, MC, MR, tgrid4) for v in (a, b)]
        with count_transfers() as log:
            C = tops.gemm("N", "N", 1.0, *T, alg=alg)
        assert C.dist() == (MC, MR)
        assert all(owns_storage(C.local(i, j)) for i, j in tgrid4.positions())
        whole = {(m, k), (k, n), (m, n)}
        assert not [r for r in log.of("all-gather") if r.shape in whole]
        if m % 2 == 0:
            assert log.of("all-gather")           # SUMMA's panels
        else:
            assert len(log) == 0                  # every block is whole
        if alg == "xla" and m % 2:
            # the JAX GSPMD path refuses a shape the mesh does not divide
            want = jops.gemm("N", "N", 1.0, *(jnp.asarray(v) for v in (a, b)))
        else:
            want = jops.gemm("N", "N", 1.0, *J, alg=alg)
        close(C, want, TOL[dt], alg)
