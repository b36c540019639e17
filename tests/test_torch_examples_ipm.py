"""The port's drivers of the conic, sparse-solver and sparse-product tiers
(``elemental_tpu_torch/examples``) run on the CPU at their default sizes, as
``tests/examples/test_examples.py`` runs the JAX package's; each driver
checks its own answer with the JAX driver's thresholds."""

import importlib
import sys

import pytest
import torch

torch.set_num_threads(2)

DRIVERS = ["bp", "bp_complex", "bp_dense", "bpdn", "bpdn_dense", "cp",
           "cp_dense", "ds", "ds_dense", "en", "en_dense", "lav",
           "lav_dense", "long_only_portfolio", "lp_affine",
           "lp_affine_dense", "lp_direct_dense", "nnls", "nnls_dense",
           "qp_affine_dense", "qp_affine_ex", "qp_direct_dense",
           "qp_direct_ex", "rls", "rnnls_ex", "soc_atom", "soc_members",
           "socp_trivial", "svm", "svm_dense", "tv",
           "sequential_linear_solve", "sequential_lse",
           "dynamic_reg_counter", "sparse_multiply", "multiply_ex",
           "remote_dist_sparse"]


@pytest.mark.parametrize("name", DRIVERS)
def test_example_driver(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", [name, "--device", "cpu"])
    importlib.import_module(f"elemental_tpu_torch.examples.{name}").main()


def test_check_raises_with_its_message():
    """The drivers' self-check raises ``AssertionError`` (kept under
    ``python -O``, unlike an ``assert``) and passes a true condition."""
    from elemental_tpu_torch.examples import check
    check(True, "never raised")
    with pytest.raises(AssertionError, match="objective"):
        check(False, "objective above the feasible point's")
