"""Parity of the port's sparse IO (``elemental_tpu_torch.sparse.io``) and its
MPS front end (``optimization.lp.mps_to_standard``) with the JAX package, on
the CPU, from the same files; and that the port compiles only its own
sources.
"""

import dataclasses
import os

import numpy as np
import pytest

from elemental_tpu.optimization import lp as jlp
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse import io as jio

import elemental_tpu_torch
from elemental_tpu_torch import _build
from elemental_tpu_torch.kernels import (elementwise, extend_add, matmul,
                                         spmv, unstructured)
from elemental_tpu_torch.optimization import lp as tlp
from elemental_tpu_torch.sparse import SparseMatrix
from elemental_tpu_torch.sparse import io as tio
from elemental_tpu_torch.sparse_direct import native

RNG = np.random.default_rng(23)

# Every section and bound kind the reader knows: E/L/G rows, integer
# MARKER lines, several pairs on one line, RHS on the objective row (the
# objective constant), RANGES on L, G and E rows, and UP (also negative
# with the default lower bound), LO, FX, FR, MI, PL and BV bounds.
MPS = """\
* a comment line
NAME          TESTLP
ROWS
 N  COST
 E  R1
 L  R2
 G  R3
 L  R4
 G  R5
 E  R6
COLUMNS
    X1        COST         1.5   R1           1.0
    X1        R2           2.0   R3          -1.0
    MARKER                 'MARKER'                 'INTORG'
    X2        COST        -2.0   R1           3.0
    X2        R4           1.25
    MARKER                 'MARKER'                 'INTEND'
    X3        R2          -1.0   R5           4.0
    X3        R6           0.5   COST         0.75
    X4        R3           2.5   R4          -3.0
    X5        R1          -1.0   R6           1.0
    X6        COST         1.0   R5          -2.0
    X7        R2           1.0   R3           1.0
    X8        R4           2.0   COST        -0.5
    X9        R6          -1.0   R1           2.0
RHS
    RHS       COST       -12.5   R1           4.0
    RHS       R2           6.0   R3          -1.0
    RHS       R4           3.5   R5           2.0
    RHS       R6           1.0
RANGES
    RNG       R2           2.0   R3          -1.5
    RNG       R6           3.0
BOUNDS
 UP BND       X1           4.0
 UP BND       X2          -1.0
 LO BND       X3          -2.5
 FX BND       X4           1.5
 FR BND       X5
 MI BND       X6
 UP BND       X6           3.0
 LO BND       X7           1.0
 PL BND       X7
 BV BND       X8
ENDATA
"""


def _write(tmp_path, text, name="lp.mps"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(text)
    return path


def _jax_matrix(A):
    return JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)


def _same_matrix(a, b):
    assert (a.height, a.width) == (b.height, b.width)
    np.testing.assert_array_equal(a.rowptr, b.rowptr)
    np.testing.assert_array_equal(a.colind, b.colind)
    np.testing.assert_array_equal(a.vals, b.vals)


def test_matrix_market_roundtrip(tmp_path):
    """tests/sparse/test_io.py:17 on the port, and each package reading the
    other's file to the same matrix."""
    m, n, nnz = 12, 9, 30
    rows, cols = RNG.integers(0, m, nnz), RNG.integers(0, n, nnz)
    vals = RNG.standard_normal(nnz)
    A = SparseMatrix.from_coo(m, n, rows, cols, vals)
    path = str(tmp_path / "a.mtx")
    tio.write_matrix_market(path, A)
    B = tio.read_matrix_market(path)
    np.testing.assert_allclose(B.to_dense(), A.to_dense(), rtol=1e-15)
    _same_matrix(B, jio.read_matrix_market(path))
    jpath = str(tmp_path / "j.mtx")
    jio.write_matrix_market(jpath, JaxSparseMatrix.from_coo(m, n, rows, cols,
                                                            vals))
    _same_matrix(tio.read_matrix_market(jpath), B)


@pytest.mark.parametrize("symmetry", ["symmetric", "skew-symmetric"])
def test_matrix_market_symmetric_matches_reference(tmp_path, symmetry):
    """A lower-triangle file expands to the full matrix in both packages;
    an array file reads column-major in both."""
    text = (f"%%MatrixMarket matrix coordinate real {symmetry}\n% c\n"
            "4 4 5\n1 1 2.0\n2 1 -1.5\n3 2 4.0\n4 4 1.0\n4 3 0.5\n")
    if symmetry == "skew-symmetric":
        text = text.replace("1 1 2.0\n", "2 2 0.0\n").replace(
            "4 4 1.0\n", "3 3 0.0\n")
    path = _write(tmp_path, text, "s.mtx")
    _same_matrix(tio.read_matrix_market(path), jio.read_matrix_market(path))
    dense = _write(tmp_path, "%%MatrixMarket matrix array real general\n"
                   "2 3\n1\n2\n3\n4\n5\n6\n", "d.mtx")
    got = tio.read_matrix_market(dense)
    np.testing.assert_array_equal(got.to_dense(), [[1, 3, 5], [2, 4, 6]])
    _same_matrix(got, jio.read_matrix_market(dense))


def _same_mps(t, j):
    """MPSData field by field, the objective constant apart (the JAX
    reader drops it)."""
    for f in dataclasses.fields(t):
        if f.name == "c0":
            continue
        a, b = getattr(t, f.name), getattr(j, f.name)
        if f.name in ("A_eq", "A_le"):
            _same_matrix(a, b)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name


def test_read_mps_matches_reference(tmp_path):
    """Every section and bound kind: the port's MPSData equals the JAX
    reader's field by field and holds what the file says; the objective
    constant is −RHS(objective row) in the port and 0 in the JAX reader."""
    path = _write(tmp_path, MPS)
    t, j = tio.read_mps(path), jio.read_mps(path)
    _same_mps(t, j)
    assert t.c0 == 12.5 and j.c0 == 0.0
    assert t.name == "TESTLP"
    assert t.col_names == [f"X{i}" for i in range(1, 10)]
    assert t.row_names == ["R1", "R2", "R3", "R4", "R5", "R6"]
    np.testing.assert_array_equal(t.c, [1.5, -2.0, 0.75, 0, 0, 1.0, 0,
                                        -0.5, 0])
    inf = np.inf
    np.testing.assert_array_equal(
        t.lower, [0, -inf, -2.5, 1.5, -inf, -inf, 1.0, 0, 0])
    np.testing.assert_array_equal(
        t.upper, [4.0, -1.0, inf, 1.5, inf, 3.0, inf, 1.0, inf])
    # E rows R1, R6; then L/G rows R2..R5 with G negated; then one range
    # row each for R2 (L, 2.0) and R3 (G, |−1.5|) (ranges on E rows are
    # not read, as in the JAX reader)
    np.testing.assert_array_equal(t.b_eq, [4.0, 1.0])
    np.testing.assert_array_equal(t.A_eq.to_dense(),
                                  [[1, 3, 0, 0, -1, 0, 0, 0, 2],
                                   [0, 0, 0.5, 0, 1, 0, 0, 0, -1]])
    np.testing.assert_array_equal(t.b_le, [6.0, 1.0, 3.5, -2.0,
                                           -(6.0 - 2.0), -(1.0 - 1.5)])
    np.testing.assert_array_equal(t.A_le.to_dense(),
                                  [[2, 0, -1, 0, 0, 0, 1, 0, 0],
                                   [1, 0, 0, -2.5, 0, 0, -1, 0, 0],
                                   [0, 1.25, 0, -3, 0, 0, 0, 2, 0],
                                   [0, 0, -4, 0, 0, 2, 0, 0, 0],
                                   [-2, 0, 1, 0, 0, 0, -1, 0, 0],
                                   [-1, 0, 0, 2.5, 0, 0, 1, 0, 0]])


def test_read_mps_without_objective_constant_is_reference(tmp_path):
    """With no RHS on the objective row the two readers agree on every
    field, c0 included."""
    path = _write(tmp_path, MPS.replace("COST       -12.5   ", ""))
    t, j = tio.read_mps(path), jio.read_mps(path)
    _same_mps(t, j)
    assert t.c0 == j.c0 == 0.0


# MPS with its two upper-only columns (X2: UP below 0; X6: MI with UP) left
# with their default and MI bounds: the columns the JAX package standardizes
# as the port does
MPS_NO_UPPER_ONLY = MPS.replace(" UP BND       X2          -1.0\n", "") \
    .replace(" UP BND       X6           3.0\n", "")


def test_mps_to_standard_matches_reference(tmp_path):
    """A, b, c, the objective shift and recover() of the standard form
    equal the JAX ones (the JAX data given the port's c0)."""
    path = _write(tmp_path, MPS_NO_UPPER_ONLY)
    t = tio.read_mps(path)
    j = dataclasses.replace(jio.read_mps(path), c0=t.c0)
    At, bt, ct, st, rect = tlp.mps_to_standard(t)
    Aj, bj, cj, sj, recj = jlp.mps_to_standard(j)
    _same_matrix(At, Aj)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(ct, cj)
    assert st == sj
    x = RNG.uniform(0, 2, At.width)
    np.testing.assert_array_equal(rect(x), recj(x))
    # the shift carries the constant: c·lower over the finite lower bounds
    # plus c0
    assert st == pytest.approx(0.75 * -2.5 + 12.5, rel=1e-15)


def test_mps_to_standard_reflects_upper_only_columns(tmp_path):
    """A column with no lower bound and a finite upper bound u is x = u − x'
    in the port's standard form: every x' ≥ 0 maps to x ≤ u, with A_std·x'
    − b_std the general form's row residuals.  (The JAX package bounds the
    positive part of a free split by u, infeasible for X2's u = −1.)"""
    t = tio.read_mps(_write(tmp_path, MPS))
    A, b, c, shift, recover = tlp.mps_to_standard(t)
    xs = RNG.uniform(0, 3, A.width)
    x = recover(xs)
    assert x[1] <= -1.0 and x[5] <= 3.0            # X2, X6
    assert np.all(x >= t.lower)
    r = A.to_scipy() @ xs - b
    m_eq, m_le = t.A_eq.height, t.A_le.height
    np.testing.assert_allclose(r[:m_eq], t.A_eq.to_scipy() @ x - t.b_eq,
                               atol=1e-12)
    # the ≤ rows carry their slack: A_le·x + s = b_le with s ≥ 0
    slack = xs[A.width - m_le - (A.height - m_eq - m_le):][:m_le]
    np.testing.assert_allclose(r[m_eq:m_eq + m_le],
                               t.A_le.to_scipy() @ x + slack - t.b_le,
                               atol=1e-12)
    np.testing.assert_allclose(c @ xs + shift, t.c @ x + t.c0, rtol=1e-13)
    j = jio.read_mps(_write(tmp_path, MPS, "j.mps"))
    Aj, bj, *_ = jlp.mps_to_standard(j)
    # the JAX form splits X2 and X6 and adds an upper-bound row with its
    # slack for each
    assert (Aj.height, Aj.width) == (A.height + 2, A.width + 4)


def test_port_compiles_only_its_own_sources(monkeypatch, tmp_path):
    """Every source the port builds lies under elemental_tpu_torch/ (the
    native ordering library included), and the host library is built from
    csrc/symbolic.cpp."""
    pkg = os.path.dirname(os.path.abspath(elemental_tpu_torch.__file__))
    sources = [native.SOURCE, extend_add.SOURCE, spmv.SOURCE,
               elementwise.SOURCE, matmul.SOURCE, matmul.SOURCE_SM90,
               unstructured.SOURCE, unstructured.BRIDGED_SOURCE]
    for src in sources:
        real = os.path.realpath(src)
        assert real.startswith(os.path.join(pkg, "csrc") + os.sep), src
        assert os.path.isfile(real), src
    assert os.path.basename(native.SOURCE) == "symbolic.cpp"
    seen = []
    real_compile = _build._compile

    def compile_(compiler, flags, name, srcs):
        seen.extend(srcs)
        return real_compile(compiler, flags, name, srcs)

    monkeypatch.setattr(_build, "_compile", compile_)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    _build.build_host_library("elemental_native", [native.SOURCE])
    assert seen == [native.SOURCE]
    assert os.listdir(tmp_path) and all(
        f.startswith("libelemental_native-") for f in os.listdir(tmp_path))
