"""K9, the tree solve's level scatter (``kernels/level_scatter.py``,
``csrc/level_scatter.cu``), and its plan (``sparse_direct/solve_plan.py``).

CPU tests: the plan of the LP KKT of ``concat_fd_2d(16, 16)`` and of the
12³ Laplacian holds every real front slot once and no padded one; with
the panel inverses (the solve context) the plain version, level step by
level step, whole solves and ``multiply_with_l`` are bit-equal to the
scatter the solve ran before (``w - xf`` and ``index_add_`` over every
slot, kept below as ``_old_level_solve``); without them the level step is
K10's substitution and K9's sum of its ``-L21·w1`` over the update slots
(``kernels/level_solve.py``), within rounding of that old step.  Tests
marked ``cuda`` hold the kernel against the plain version on the card;
they skip without a card.  The file imports no JAX:

    python -m pytest tests/test_torch_level_scatter.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from elemental_tpu_torch.kernels.level_scatter import (level_scatter,
                                                       level_scatter_plain)
from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_3d
from elemental_tpu_torch.optimization.lp import _build_lp_kkt, sparse_ruiz
from elemental_tpu_torch.sparse_direct import SparseLDLFactorization, numeric
from elemental_tpu_torch.sparse_direct.solve_plan import (
    INDEX_FIELDS, build_scatter_level)

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
CASES = ("kkt_fd_16", "laplacian_12")


def _factor(case, dtype, device="cpu"):
    """An LDLFactorization of the case's matrix in ``dtype``: the KKT
    Ruiz-equilibrated with its signed floors (LDLᵀ, complex-symmetric in a
    complex dtype), the Laplacian through the facade (LDLᴴ in a complex
    dtype)."""
    if case == "kkt_fd_16":
        A = sparse_ruiz(concat_fd_2d(16, 16))[0]
        kkt, _ = _build_lp_kkt(A, 1e-2, 1e-2, None, device=device,
                               dtype=torch.float64)
        theta = torch.as_tensor(np.random.default_rng(3).uniform(
            0.1, 10.0, A.width), dtype=torch.float64, device=device)
        v, scale = kkt.equilibrate(kkt.assemble([theta]))
        return numeric.factor(kkt.symb, v, ea_plan=kkt.ea_plan, dtype=dtype,
                              pivot_floor=kkt.reg * scale * scale)
    A = sparse_laplacian_3d(12, 12, 12, scaled=False)
    f = SparseLDLFactorization(device=device, dtype=dtype)
    f.initialize(A, hermitian=dtype.is_complex, cutoff=32)
    return f.factor().numeric


_FACTORS = {}


def _cached_factor(case, dtype):
    if (case, dtype) not in _FACTORS:
        _FACTORS[case, dtype] = _factor(case, dtype)
    return _FACTORS[case, dtype]


def _rhs(n, k, dtype, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, k))
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal((n, k))
    return torch.as_tensor(b).to(device, dtype)


def _old_level_solve(self, xe, lev, scatter, forward, linv=None):
    """The level step as the solve ran it before K9: ``w - xf`` added into
    every slot, padded ones (row n) included, by ``index_add_``."""
    rows = lev.front_rows
    xf = xe[rows]
    if linv is not None:
        w = torch.matmul(linv if forward else self._adjoint(linv), xf)
    else:
        lp = self._level_panels(lev)
        if forward:
            w = torch.linalg.solve_triangular(lp, xf, upper=False,
                                              unitriangular=True)
        else:
            w = torch.linalg.solve_triangular(
                self._adjoint(lp), xf, upper=True, unitriangular=True)
    delta = w - xf
    xe.index_add_(0, rows.reshape(-1), delta.reshape(-1, xe.shape[1]))


def _old_step(self, xe, i, forward, ctx=None, delta=None):
    """``_old_level_solve`` in the place of ``_level_solve``."""
    _old_level_solve(self, xe, self.symb.levels[i], None, forward,
                     None if ctx is None else ctx[i])


def _tol(dtype, steps):
    """Rounding room against the old step: ``steps`` × 16 units in the
    last place of ``dtype``'s real type, relative to the largest value."""
    return steps * 16 * torch.finfo(dtype).eps


def _close(got, ref, dtype, steps):
    err = float((got - ref).abs().max() / ref.abs().max())
    return err <= _tol(dtype, steps), err


def _old_multiply_with_l(num, x, adjoint):
    """``multiply_with_l`` as it ran before K9."""
    xe = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    ye = xe.clone()
    for lev in num.symb.levels:
        lp = num._level_panels(lev)
        if adjoint:
            lp = num._adjoint(lp)
        rows = lev.front_rows
        xf = xe[rows]
        yf = torch.matmul(lp, xf)
        ye.index_add_(0, rows.reshape(-1),
                      (yf - xf).reshape(-1, xf.shape[-1]))
    return ye[:num.symb.n]


# ------------------------------------------------------------------ plan


def test_plan_of_a_small_level():
    """Two fronts of 3 slots over rows 0-4, padding → 5."""
    lv = build_scatter_level(np.array([[0, 2, 5], [2, 1, 5]]), 5)
    assert lv.rows.tolist() == [0, 1, 2]
    assert lv.offsets.tolist() == [0, 1, 2, 4]
    assert lv.slots.tolist() == [0, 4, 1, 3]
    assert lv.dst.tolist() == [0, 1, 2, 2]
    assert (lv.n, lv.n_level_slots) == (5, 6)
    assert lv.slots.dtype == np.int32
    with pytest.raises(ValueError):
        build_scatter_level(np.array([[0, 6]]), 5)


@pytest.mark.parametrize("case", CASES)
def test_plan_holds_every_real_slot_once(case):
    symb = _cached_factor(case, torch.float64).symb
    plan = symb.solve_plan
    assert len(plan.levels) == len(symb.levels)
    padded = 0
    for lev, sc in zip(symb.levels, plan.levels):
        fr = lev.front_rows.numpy().reshape(-1)
        rows, off, slots, dst = (getattr(sc, f).numpy()
                                 for f in INDEX_FIELDS)
        assert sc.n == symb.n and sc.n_level_slots == fr.size
        assert rows.dtype == off.dtype == slots.dtype == np.int32
        # every real slot once, no padded one
        assert np.array_equal(np.sort(slots), np.flatnonzero(fr != symb.n))
        padded += int((fr == symb.n).sum())
        # unique ascending destinations, segments ascending by slot
        assert np.all(np.diff(rows) > 0) and off[0] == 0
        assert off[-1] == slots.size and np.all(np.diff(off) > 0)
        assert np.array_equal(dst, np.repeat(rows, np.diff(off)))
        assert np.array_equal(fr[slots], dst)
        seg = np.repeat(np.arange(rows.size), np.diff(off))
        step = np.diff(slots)
        assert np.all(step[seg[1:] == seg[:-1]] > 0)
    assert padded > 0       # the case exercises the padding


# ------------------------------------------------------- the plain version


@pytest.mark.parametrize("ctx", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_level_steps_equal_the_old_scatter(case, dtype, k, ctx):
    """Each level step of both directions, from the same ``xe``, leaves the
    same bits as the old scatter with the solve context, and the same
    values within rounding (4 × 16 ulps of the largest) by substitution;
    row n stays exactly 0."""
    num = _cached_factor(case, dtype)
    symb = num.symb
    n, levels = symb.n, symb.levels
    c = num.solve_context() if ctx else None
    b = _rhs(n, k, dtype)
    old = torch.cat([b[symb.perm], b.new_zeros((1, k))])
    delta = old.new_empty(symb.solve_plan.max_level_slots, k)
    steps = [(True, i) for i in range(len(levels))] + \
        [(False, i) for i in reversed(range(len(levels)))]
    with numeric.full_fp32_matmul():
        for forward, i in steps:
            if (forward, i) == (False, len(levels) - 1):
                old[:n] = old[:n] / num.d[:, None]
            new = old.clone()
            _old_level_solve(num, old, levels[i], None, forward,
                             None if c is None else c[i])
            num._level_solve(new, i, forward, c, delta)
            if ctx:
                assert torch.equal(old, new), (forward, i)
            else:
                ok, err = _close(new, old, dtype, 4)
                assert ok, (forward, i, err)
            assert bool((new[n] == 0).all())
            old = new


@pytest.mark.parametrize("ctx", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_solves_equal_the_old_path(monkeypatch, case, dtype, ctx):
    """Bit-equal with the solve context; by substitution within rounding
    (16 × 16 ulps of the largest value)."""
    num = _cached_factor(case, dtype)
    c = num.solve_context() if ctx else None
    b = _rhs(num.symb.n, 2, dtype, seed=1)
    got = num.solve(b, c), num.solve(b[:, 0], c)
    monkeypatch.setattr(numeric.LDLFactorization, "_level_solve", _old_step)
    ref = num.solve(b, c), num.solve(b[:, 0], c)
    for g, r in zip(got, ref):
        assert torch.equal(g, r) if ctx else _close(g, r, dtype, 16)[0]


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_multiply_with_l_equals_the_old_path(case, dtype, adjoint):
    num = _cached_factor(case, dtype)
    x = _rhs(num.symb.n, 2, dtype, seed=2)
    with numeric.full_fp32_matmul():
        ref = _old_multiply_with_l(num, x, adjoint)
    assert torch.equal(num.multiply_with_l(x, adjoint), ref)


def test_cpu_scatter_launches_no_kernel():
    num = _cached_factor("laplacian_12", torch.float64)
    before = level_scatter.launches
    num.solve(_rhs(num.symb.n, 1, torch.float64))
    assert level_scatter.launches == before


def test_no_kernel_for_another_device():
    lv = build_scatter_level(np.array([[0, 1, 2]]), 2)
    meta = torch.device("meta")
    xe = torch.zeros(3, 1, device=meta)
    w = torch.zeros(1, 3, 1, device=meta)
    with pytest.raises(ValueError):
        level_scatter(xe, w, w, lv.to(meta))


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _level_values(sc, k, dtype, seed, device):
    """Random ``xe`` (row n set to 7), ``w`` and ``xf`` for one level."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape):
        t = torch.randn(*shape, generator=g, dtype=torch.float64)
        if dtype.is_complex:
            t = torch.complex(t, torch.randn(*shape, generator=g,
                                             dtype=torch.float64))
        return t.to(dtype).to(device)

    xe = rand(sc.n + 1, k)
    xe[sc.n] = 7
    return xe, rand(sc.n_level_slots, k), rand(sc.n_level_slots, k)


def _as_index(sc, idt):
    return dataclasses.replace(sc, **{f: getattr(sc, f).to(idt)
                                      for f in INDEX_FIELDS})


@pytest.mark.cuda
@pytest.mark.parametrize("idt", [torch.int32, torch.int64])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_every_level(cuda, case, dtype, k, idt):
    """K9 on the card against the plain version on the CPU, bit for bit,
    twice, every level of the plan; row n is never written."""
    plan = _cached_factor(case, torch.float64).symb.solve_plan
    before = level_scatter.launches
    for i, sc in enumerate(plan.levels):
        host = _as_index(sc, idt)
        dev = host.to(cuda)
        xe, w, xf = _level_values(sc, k, dtype, i, cuda)
        runs = []
        for _ in range(2):
            out = xe.clone()
            level_scatter(out, w, xf, dev)
            runs.append(out)
        torch.cuda.synchronize()
        ref = xe.cpu()
        level_scatter_plain(ref, w.cpu(), xf.cpu(), host)
        assert torch.equal(runs[0].cpu(), ref), i
        assert torch.equal(runs[0], runs[1]), i
        assert bool((runs[0][sc.n] == 7).all())
    assert level_scatter.launches - before == 2 * len(plan.levels)


def _plain_on_cpu(xe, w, xf, sc):
    """The plain scatter on CPU copies, written back: a stand-in for
    ``numeric.level_scatter`` that leaves every other step on the card."""
    out = xe.cpu()
    level_scatter_plain(out, w.cpu(), None if xf is None else xf.cpu(),
                        sc.to("cpu"))
    xe.copy_(out)


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_solve_on_card_matches_plain_scatter(cuda, monkeypatch, case, dtype,
                                             ctx):
    """A whole solve on the card through K9, against the same solve with
    the plain scatter run on the CPU copies: bit-equal, and the same bits
    on a second run; two launches a level with the solve context, one a
    level with update slots by substitution (forward only)."""
    num = _factor(case, dtype, cuda)
    c = num.solve_context() if ctx else None
    b = _rhs(num.symb.n, 2, dtype, seed=4, device=cuda)
    before = level_scatter.launches
    got = num.solve(b, c)
    again = num.solve(b, c)
    torch.cuda.synchronize()
    per_solve = (2 * len(num.symb.levels) if ctx else
                 sum(bool(sub.update.n_rows)
                     for sub in num.symb.solve_plan.substitution))
    assert level_scatter.launches - before == 2 * per_solve
    assert torch.equal(got, again)

    monkeypatch.setattr(numeric, "level_scatter", _plain_on_cpu)
    assert torch.equal(got, num.solve(b, c))


@pytest.mark.cuda
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_multiply_with_l_on_card_matches_plain_scatter(cuda, monkeypatch,
                                                       dtype, adjoint):
    num = _factor("laplacian_12", dtype, cuda)
    x = _rhs(num.symb.n, 2, dtype, seed=5, device=cuda)
    before = level_scatter.launches
    got = num.multiply_with_l(x, adjoint)
    torch.cuda.synchronize()
    assert level_scatter.launches - before == len(num.symb.levels)
    monkeypatch.setattr(numeric, "level_scatter", _plain_on_cpu)
    assert torch.equal(got, num.multiply_with_l(x, adjoint))


def _card_refusals(cuda):
    plan = _cached_factor("laplacian_12", torch.float64).symb.solve_plan
    sc = plan.levels[0]
    dev = sc.to(cuda)
    xe, w, xf = _level_values(sc, 2, torch.float64, 0, cuda)
    return {
        "plan_on_cpu": (ValueError, (xe, w, xf, sc)),
        "xe_rows": (ValueError, (xe[1:].contiguous(), w, xf, dev)),
        "xe_1d": (ValueError, (xe[:, 0].contiguous(), w, xf, dev)),
        "w_slots": (ValueError, (xe, w[1:].contiguous(), xf, dev)),
        "xf_columns": (ValueError, (xe, w, xf[:, :1].contiguous(), dev)),
        "w_not_contiguous": (ValueError, (xe, w.t().contiguous().t(), xf,
                                          dev)),
        "xf_dtype": (ValueError, (xe, w, xf.float(), dev)),
        "w_on_cpu": (ValueError, (xe, w.cpu(), xf, dev)),
        "half": (TypeError, (xe.half(), w.half(), xf.half(), dev)),
    }


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda):
    for name, (err, args) in _card_refusals(cuda).items():
        xe = args[0]
        before = xe.clone()
        with pytest.raises(err):
            level_scatter(*args)
        assert torch.equal(xe, before), name
