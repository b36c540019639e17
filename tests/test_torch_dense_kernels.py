"""Parity of the port's dense kernel tier (K4 ``matmul``, K5
``masked_rank_k_update``, K6 ``elementwise``, through their plain versions)
with the JAX package's Pallas kernels under
``pltpu.force_tpu_interpret_mode()``, as ``tests/lapack/test_aux_tiers.py``
runs them, on the CPU, from the same NumPy inputs.

The CUDA kernels themselves run only on a card:
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from elemental_tpu.kernels import elementwise as jax_ew
from elemental_tpu.kernels import matmul as jax_mm

from elemental_tpu_torch.kernels import elementwise as ew
from elemental_tpu_torch.kernels.matmul import (_matmul_path, _rank_k_path,
                                                masked_rank_k_update, matmul,
                                                matmul_plain)

torch.set_num_threads(1)

DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(dtype, *shapes, seed=0):
    """NumPy normals rounded to ``dtype``, as (JAX array, torch tensor)
    pairs holding the same values."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        v = jnp.asarray(rng.standard_normal(shape), jdt)
        t = torch.from_numpy(np.array(v.astype(jnp.float64))).to(tdt)
        out.append((v, t))
    return out


def _f64(v):
    if isinstance(v, torch.Tensor):
        return v.double().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float64))


# K4 ------------------------------------------------------------------------
#
# Tolerances, against max|C|: float32 1e-5 (both sum in float32, in another
# order); float64 1e-5 against the reference, which sums float64 in float32
# on the MXU, and 1e-12 against NumPy's float64 product; bfloat16 2⁻⁷, one
# bfloat16 rounding of the output (unit roundoff 2⁻⁸) on either side, and
# 2⁻⁸ + 1e-5 against the exact product of the rounded inputs.

MATMUL_TOL = {"float32": (1e-5, 1e-5), "float64": (1e-5, 1e-12),
              "bfloat16": (2.0**-7, 2.0**-8 + 1e-5)}


@pytest.mark.parametrize("shape", [(96, 40, 72), (64, 32, 64), (1, 1, 1),
                                   (130, 257, 129)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_matches_pallas(dtype, shape):
    m, k, n = shape
    (aj, at), (bj, bt) = _inputs(dtype, (m, k), (k, n))
    with pltpu.force_tpu_interpret_mode():
        cj = jax_mm.matmul(aj, bj)
    ct = matmul(at, bt)
    assert ct.dtype == at.dtype and ct.shape == (m, n)
    exact = _f64(at) @ _f64(bt)
    scale = np.abs(exact).max()
    tol_ref, tol_exact = MATMUL_TOL[dtype]
    assert np.abs(_f64(ct) - _f64(cj)).max() <= tol_ref * scale
    assert np.abs(_f64(ct) - exact).max() <= tol_exact * scale


# K4's route on the card: ``_matmul_path`` is a pure function of dtype,
# shape and alignment.  The Hopper paths load 16-byte vectors of rows, so
# they take k > 0 with k and n multiples of the dtype's vector and 16-byte
# aligned data; everything else goes to the SIMT kernel.
PATH_OF = {"bfloat16": ("wgmma", 8), "float32": ("ffma", 4),
           "float64": ("dmma", 2)}
RULE_SHAPES = [(1, 1, 1), (130, 257, 129), (96, 40, 72), (256, 128, 384),
               (70, 2, 72), (9, 0, 16), (3000, 1000, 2056)]


@pytest.mark.parametrize("shape", RULE_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_path_rule(dtype, aligned, shape):
    m, k, n = shape
    tdt = DTYPES[dtype][1]
    off = 0 if aligned else 1
    a = torch.zeros(m * k + off, dtype=tdt)[off:].view(m, k)
    b = torch.zeros(k * n, dtype=tdt).view(k, n)
    path, vec = PATH_OF[dtype]
    fits = aligned and k > 0 and k % vec == 0 and n % vec == 0
    assert _matmul_path(a, b) == (path if fits else "simt")
    # the same rule for b's alignment
    b_off = torch.zeros(k * n + 1, dtype=tdt)[1:].view(k, n)
    if k * n:
        assert _matmul_path(a, b_off) == "simt"


def test_matmul_path_rule_other_dtypes():
    a = torch.zeros(64, 64, dtype=torch.float16)
    assert _matmul_path(a, a) == "simt"
    assert _matmul_path(a.float(), a.double()) == "simt"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_matmul_on_the_cpu_is_the_plain_version(dtype):
    """CPU tensors take the plain version and count no launch, whatever
    path the rule names for them."""
    (_, at), (_, bt) = _inputs(dtype, (130, 64), (64, 136), seed=3)
    before = (matmul.launches, dict(matmul.launches_by_path))
    out = matmul(at, bt)
    assert (matmul.launches, matmul.launches_by_path) == before
    assert torch.equal(out, matmul_plain(at, bt))


# K5 ------------------------------------------------------------------------

def _rank_k_against_pallas(dtype, lower, m, k, n):
    (cj, ct), (aj, at), (bj, bt) = _inputs(dtype, (m, n), (m, k), (k, n))
    with pltpu.force_tpu_interpret_mode():
        oj = jax_mm.masked_rank_k_update(cj, aj, bj, alpha=0.5, lower=lower)
    out = masked_rank_k_update(ct, at, bt, alpha=0.5, lower=lower)
    assert out.dtype == ct.dtype and out.shape == ct.shape
    rows, cols = np.indices(ct.shape)
    mask = rows >= cols if lower else rows <= cols
    expect = np.where(mask, _f64(ct) + 0.5 * (_f64(at) @ _f64(bt)),
                      _f64(ct))
    scale = np.abs(expect).max()
    assert np.abs(_f64(out) - _f64(oj)).max() <= 1e-5 * scale
    tol = 1e-12 if dtype == "float64" else 1e-5
    assert np.abs(_f64(out) - expect).max() <= tol * scale
    for o in (out.numpy(), np.asarray(oj)):
        np.testing.assert_array_equal(o[~mask], ct.numpy()[~mask])


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_masked_rank_k_update_matches_pallas(dtype, lower):
    """The updated triangle within 1e-5·max|out| of the reference (its
    product sums in float32 for either dtype) and of float64 NumPy (1e-12
    in float64); the other triangle equal to c bit for bit in both."""
    _rank_k_against_pallas(dtype, lower, 96, 40, 72)


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_masked_rank_k_update_matches_pallas_across_tiles(dtype, lower):
    """c (256, 384), k = 32, with the gates above: m != n, and on the
    card's 128 x 128 tiles copy tiles, tiles wholly inside the triangle and
    two that its diagonal crosses."""
    _rank_k_against_pallas(dtype, lower, 256, 32, 384)


# K5's route on the card: K4's rule over k and n, with all three of c, a
# and b 16-byte aligned; float32 and float64 only.
RANK_K_PATH_OF = {"float32": ("ffma", 4), "float64": ("dmma", 2)}


@pytest.mark.parametrize("shape", RULE_SHAPES)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rank_k_path_rule(dtype, aligned, shape):
    m, k, n = shape
    tdt = DTYPES[dtype][1]

    def operand(rows, cols, off=0):
        return torch.zeros(rows * cols + off, dtype=tdt)[off:].view(rows,
                                                                    cols)

    ops = [operand(m, n), operand(m, k), operand(k, n)]       # c, a, b
    if dtype not in RANK_K_PATH_OF:
        with pytest.raises(TypeError):
            _rank_k_path(*ops)
        return
    path, vec = RANK_K_PATH_OF[dtype]
    fits = k > 0 and k % vec == 0 and n % vec == 0
    assert _rank_k_path(*ops) == (path if fits else "simt")
    if not aligned:
        # each of c, a and b off 16 bytes in turn
        for i, (rows, cols) in enumerate(((m, n), (m, k), (k, n))):
            if rows * cols:
                mis = list(ops)
                mis[i] = operand(rows, cols, off=1)
                assert _rank_k_path(*mis) == "simt"
    other = torch.float64 if tdt == torch.float32 else torch.float32
    with pytest.raises(TypeError):
        _rank_k_path(ops[0], ops[1].to(other), ops[2])


# K6 ------------------------------------------------------------------------
#
# copy, fill and transpose move bits: equal to the reference exactly.  The
# arithmetic ops in float32 and float64: within one rounding of the
# largest term, eps·(|y| + |α·x|) (axpy may fuse its multiply-add on one
# side and not on the other).  In bfloat16 the reference rounds α, α·x and
# the sum to bfloat16 one by one, the port computes in float32 and rounds
# once: within two bfloat16 ulps, 2⁻⁶·max|out|.

EW_OPS = ["axpy", "scale", "hadamard", "copy", "fill", "transpose"]


def _ew(mod, op, x, y, dtype, device=None):
    if op == "axpy":
        return mod.axpy(1.7, x, y)
    if op == "scale":
        return mod.scale(-0.3, x)
    if op == "hadamard":
        return mod.hadamard(x, y)
    if op == "copy":
        return mod.copy(x)
    if op == "transpose":
        return mod.transpose(x)
    if device is None:
        return mod.fill((24, 200), 1.1, DTYPES[dtype][0])
    return mod.fill((24, 200), 1.1, DTYPES[dtype][1], device=device)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("op", EW_OPS)
def test_elementwise_matches_pallas(op, dtype):
    (xj, xt), (yj, yt) = _inputs(dtype, (24, 200), (24, 200), seed=1)
    with pltpu.force_tpu_interpret_mode():
        rj = _ew(jax_ew, op, xj, yj, dtype)
    before = getattr(ew, op).launches
    rt = _ew(ew, op, xt, yt, dtype, device="cpu")
    assert getattr(ew, op).launches == before     # CPU: the plain version
    assert rt.dtype == DTYPES[dtype][1] and tuple(rt.shape) == rj.shape
    got, ref = _f64(rt), _f64(rj)
    if op in ("copy", "fill", "transpose"):
        np.testing.assert_array_equal(got, ref)
        return
    if dtype == "bfloat16":
        assert np.abs(got - ref).max() <= 2.0**-6 * np.abs(ref).max()
        return
    x, y = _f64(xt), _f64(yt)
    size = {"axpy": np.abs(y) + np.abs(1.7 * x), "scale": np.abs(0.3 * x),
            "hadamard": np.abs(x * y)}[op]
    eps = np.finfo(DTYPES[dtype][0]).eps
    assert np.all(np.abs(got - ref) <= eps * size)


# sizes off whole 16-byte packs, float64: the wrappers on CPU tensors (their
# plain versions) against the Pallas kernels in interpret mode; the card's
# kernels at such sizes are tested in test_torch_cuda.py
@pytest.mark.parametrize("shape", [(3, 1367), (1025, 9)])
@pytest.mark.parametrize("op", EW_OPS)
def test_elementwise_sizes_match_pallas(op, shape):
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(shape))
    y = torch.from_numpy(np.random.default_rng(5).standard_normal(shape))
    with pltpu.force_tpu_interpret_mode():
        rj = {"axpy": lambda: jax_ew.axpy(1.7, jnp.asarray(x.numpy()),
                                          jnp.asarray(y.numpy())),
              "scale": lambda: jax_ew.scale(-0.3, jnp.asarray(x.numpy())),
              "hadamard": lambda: jax_ew.hadamard(jnp.asarray(x.numpy()),
                                                  jnp.asarray(y.numpy())),
              "copy": lambda: jax_ew.copy(jnp.asarray(x.numpy())),
              "transpose": lambda: jax_ew.transpose(jnp.asarray(x.numpy())),
              "fill": lambda: jax_ew.fill(shape, 1.1, np.float64)}[op]()
    before = getattr(ew, op).launches
    rt = {"axpy": lambda: ew.axpy(1.7, x, y),
          "scale": lambda: ew.scale(-0.3, x),
          "hadamard": lambda: ew.hadamard(x, y), "copy": lambda: ew.copy(x),
          "transpose": lambda: ew.transpose(x),
          "fill": lambda: ew.fill(shape, 1.1, torch.float64,
                                  device="cpu")}[op]()
    assert getattr(ew, op).launches == before     # CPU: the plain version
    got, ref = rt.numpy(), np.asarray(rj)
    assert got.shape == ref.shape
    if op in ("copy", "fill", "transpose"):
        np.testing.assert_array_equal(got, ref)
        return
    xn, yn = x.numpy(), y.numpy()
    size = {"axpy": np.abs(yn) + np.abs(1.7 * xn), "scale": np.abs(0.3 * xn),
            "hadamard": np.abs(xn * yn)}[op]
    assert np.all(np.abs(got - ref) <= np.finfo(np.float64).eps * size)


@pytest.mark.parametrize("shape", [(24, 200), (200, 24), (1, 7), (64, 128)])
def test_transpose_shapes(shape):
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(shape))
    with pltpu.force_tpu_interpret_mode():
        rj = jax_ew.transpose(jnp.asarray(x.numpy()))
    out = ew.transpose(x)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(out.numpy(), x.numpy().T)


def test_dense_wrappers_refuse_bad_shapes_on_the_cpu():
    a, b = torch.zeros(4, 3), torch.zeros(5, 2)
    with pytest.raises(ValueError, match="do not multiply"):
        matmul(a, b)
    with pytest.raises(ValueError, match="is not"):
        masked_rank_k_update(torch.zeros(4, 4), a, torch.zeros(3, 2))
    with pytest.raises(TypeError):
        ew.fill((2, 2), 1.0)                          # no device
