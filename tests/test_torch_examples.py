"""The port's drivers (``elemental_tpu_torch/examples``) run on the CPU at
their small default sizes, as ``tests/examples/test_examples.py`` runs the
JAX package's; each driver checks its own answer.  ``lp_direct`` reads an
MPS file this test writes (the netlib files are not in the repository) and
its objective is held against HiGHS."""

import importlib
import sys

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

torch.set_num_threads(2)

DRIVERS = ["lp_direct_large", "cg_laplacian", "helmholtz_solve",
           "sequential_least_squares", "different_grids", "remote_update",
           "least_squares", "linear_solve", "simple_solve",
           "symmetric_solve_ex", "lse", "glm", "tikhonov_ex", "gepp_growth",
           "matrix_zoo", "eig", "fox_li", "pseudospectra_portrait",
           "triang_eig_ex", "pnorm", "product_lanczos_ex", "inv_pos",
           "lattice_tools", "lll_reduction", "lll_singular", "control_ex",
           "lcf"]

# min x1 + 2·x2 − x3  s.t.  x1 + x2 = 4,  x1 + x3 ≤ 3,  x2 + x3 ≥ 1,
# x ≥ 0,  x3 ≤ 2
MPS = """\
NAME          TINY
ROWS
 N  COST
 E  R1
 L  R2
 G  R3
COLUMNS
    X1        COST      1.0          R1        1.0
    X1        R2        1.0
    X2        COST      2.0          R1        1.0
    X2        R3        1.0
    X3        COST      -1.0         R2        1.0
    X3        R3        1.0
RHS
    RHS       R1        4.0          R2        3.0
    RHS       R3        1.0
BOUNDS
 UP BND       X3        2.0
ENDATA
"""


def _run(name, monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu", *argv])
    mod = importlib.import_module(f"elemental_tpu_torch.examples.{name}")
    return mod.main()


@pytest.mark.parametrize("name", DRIVERS)
def test_example_driver(name, monkeypatch):
    _run(name, monkeypatch)


def test_lp_direct_on_an_mps_file(tmp_path, monkeypatch):
    path = tmp_path / "tiny.mps"
    path.write_text(MPS)
    res, x = _run("lp_direct", monkeypatch, "--mps", str(path), "--dtype",
                  "float64")
    ref = linprog([1.0, 2.0, -1.0], A_ub=[[1, 0, 1], [0, -1, -1]],
                  b_ub=[3, -1], A_eq=[[1, 1, 0]], b_eq=[4],
                  bounds=[(0, None), (0, None), (0, 2)], method="highs")
    assert res.converged
    np.testing.assert_allclose(res.objective, ref.fun, rtol=1e-7, atol=1e-7)
    # the optimum is a face: x must be feasible with HiGHS's objective
    assert abs(x[0] + x[1] - 4) < 1e-7 and x[0] + x[2] <= 3 + 1e-7
    assert x[1] + x[2] >= 1 - 1e-7 and (x >= -1e-7).all() and x[2] <= 2
    np.testing.assert_allclose(x @ [1.0, 2.0, -1.0], ref.fun, rtol=1e-7)


def test_lp_direct_needs_a_file(monkeypatch):
    with pytest.raises(SystemExit, match="--mps"):
        _run("lp_direct", monkeypatch)
