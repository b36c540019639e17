"""Parity of the port's lattice tier (``elemental_tpu_torch.lapack.lattice``)
with the JAX package, mirroring ``tests/lapack/test_lattice.py`` case for
case.  Both packages run the same host NumPy code, so every result, the
reduced basis, U, R, the certificate and the relations, must be bit-equal
to the JAX package's on the same input; the port's results are also held
to the reference tests' own checks.  The bases of the last case come from
the JAX package's random generators and go to both packages, the port
taking them as torch tensors.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu.core import random_ as jrng
from elemental_tpu.lapack import lattice as jlat
from elemental_tpu.matrices import ajtai_type_basis, knapsack_type_basis

from elemental_tpu_torch.lapack import (algebraic_relation_search,
                                        lattice_image_and_kernel, lll,
                                        z_dependence_search)


def same(got, ref):
    """Every array bit-equal and every certificate field equal."""
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if dataclasses.is_dataclass(g):
            assert dataclasses.asdict(g) == dataclasses.asdict(r)
        elif isinstance(g, float):
            assert g == r
        else:
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("variant", ["weak", "normal", "deep"])
@pytest.mark.parametrize("delta", [0.5, 0.75, 0.98])
def test_lll_is_unimodular_and_size_reduced(variant, delta):
    r = np.random.default_rng(0)
    B = np.round(r.uniform(0, 10, (16, 16)))
    out = lll(torch.from_numpy(B), delta, variant=variant)
    same(out, jlat.lll(B, delta, variant=variant))
    Br, U, R, info = out
    assert np.abs(Br - B @ U).max() < 1e-6
    assert abs(abs(np.linalg.det(U)) - 1.0) < 1e-6
    if delta >= 0.75:
        assert np.linalg.norm(Br[:, 0]) <= np.linalg.norm(
            B, axis=0).min() + 1e-9
    G = Br.T @ Br
    assert np.abs(G - R.T @ R).max() < 1e-6 * max(1.0, np.abs(G).max())
    if variant != "weak":
        assert info.eta <= 0.52


def test_lll_presort_variants_agree_on_lattice():
    r = np.random.default_rng(1)
    B = np.round(r.uniform(0, 10, (12, 12)))
    vol = abs(np.linalg.det(B))
    for presort, smallest in [(True, True), (True, False), (False, False)]:
        out = lll(B, presort=presort, smallest_first=smallest)
        same(out, jlat.lll(B, presort=presort, smallest_first=smallest))
        assert abs(abs(np.linalg.det(out[0])) - vol) < 1e-4 * vol


def test_lll_singular_detects_nullity():
    r = np.random.default_rng(2)
    B = np.round(r.uniform(0, 5, (10, 7)))
    B[:, 6] = 3 * B[:, 0] - B[:, 2]
    B[:, 5] = B[:, 1] + B[:, 3]
    out = lattice_image_and_kernel(torch.from_numpy(B))
    same(out, jlat.lattice_image_and_kernel(B))
    img, ker, info = out
    assert info.nullity == 2
    assert ker.shape[1] == 2
    assert np.abs(B @ ker).max() < 1e-6
    assert img.shape[1] == 5


def test_z_dependence_search_recovers_hidden_relation():
    r = np.random.default_rng(3)
    n = 15
    z = r.uniform(10, 15, n)
    a_hidden = np.round(r.uniform(-5, 5, n - 1))
    z[-1] = a_hidden @ z[:-1]
    out = z_dependence_search(torch.from_numpy(z), n_sqrt=1e8)
    same(out, jlat.z_dependence_search(z, n_sqrt=1e8))
    a, res, _ = out
    assert res < 1e-4
    assert np.abs(a).max() > 0


def test_z_dependence_search_complex():
    r = np.random.default_rng(4)
    n = 10
    z = r.uniform(8, 12, n) + 1j * r.uniform(8, 12, n)
    a_hidden = np.round(r.uniform(-4, 4, n - 1))
    z[-1] = a_hidden @ z[:-1]
    out = z_dependence_search(torch.from_numpy(z), n_sqrt=1e8)
    same(out, jlat.z_dependence_search(z, n_sqrt=1e8))
    assert out[1] < 1e-3


def test_algebraic_relation_search_finds_min_polys():
    # √2 → x² − 2; golden ratio → x² − x − 1
    out = algebraic_relation_search(np.sqrt(2.0), 2, 1e8)
    same(out, jlat.algebraic_relation_search(np.sqrt(2.0), 2, 1e8))
    c, res, _ = out
    assert res < 1e-6
    c = c // np.gcd.reduce(np.abs(c[c != 0]))
    assert set(np.abs(c)) <= {0, 1, 2}
    phi = (1 + np.sqrt(5)) / 2
    out2 = algebraic_relation_search(torch.tensor(phi, dtype=torch.float64),
                                     2, 1e8)
    same(out2, jlat.algebraic_relation_search(phi, 2, 1e8))
    assert out2[1] < 1e-6


def test_lll_on_reference_lattice_bases():
    jrng.seed(11)
    K = np.array(knapsack_type_basis(10, 1000.0))
    out = lll(torch.from_numpy(K))
    same(out, jlat.lll(K))
    Br, U, _, info = out
    assert np.abs(Br - K @ U).max() < 1e-6
    A = np.array(ajtai_type_basis(8, 0.5))
    out2 = lll(torch.from_numpy(A))
    same(out2, jlat.lll(jnp.asarray(A)))
    assert abs(abs(np.linalg.det(out2[1])) - 1.0) < 1e-6
