"""K10, the plain tree solve's level step (``kernels/level_solve.py``,
``csrc/level_solve.cu``), and its plan (``solve_plan.SubstitutionLevel``).

CPU tests hold the plain version, level step by level step and in whole
solves, against the formulation the solve ran before (masked nf×S×S
unit-lower panels and one batched triangular solve over each level's whole
padded triangle, kept below as ``_masked_step``), on the plans of the LP
KKT of ``concat_fd_2d(16, 16)`` and of the 12³ Laplacian (LDLᵀ, and LDLᴴ of
complex Hermitian values on the Laplacian's pattern) and on made-up levels
with fronts of ns = S and ns = 1; and a pool whose every entry outside the
L panels is NaN leaves a solve finite and unchanged.  Tests marked
``cuda`` hold the kernel against the plain version on the card (the 24³
and 48³ levels among them), two solves to the same bits, the launch
count, and a plain solve captured in a CUDA graph; they skip without a
card.  The file imports no JAX:

    python -m pytest tests/test_torch_level_solve.py -m cuda --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

from elemental_tpu_torch.kernels.level_scatter import level_scatter
from elemental_tpu_torch.kernels.level_solve import (level_solve,
                                                     level_solve_plain)
from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_3d
from elemental_tpu_torch.optimization.lp import _build_lp_kkt, sparse_ruiz
from elemental_tpu_torch.sparse import SparseMatrix
from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                               numeric, solve_plan)
from elemental_tpu_torch.sparse_direct.solve_plan import (
    build_substitution_level)

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
# (case, conjugate): the KKT is LDLᵀ (complex-symmetric in a complex dtype);
# the Laplacian's pattern takes complex-symmetric (LDLᵀ) or Hermitian
# (LDLᴴ) values in a complex dtype
FACTORS = [(case, herm, dt) for dt in DTYPES
           for case, herm in (("kkt_fd_16", False), ("laplacian_12", False),
                              ("laplacian_12", True))
           if dt.is_complex or not herm]


def _laplacian(side, dtype, hermitian):
    """The unscaled 7-point Laplacian; in a complex dtype its off-diagonal
    entries get an imaginary part 0.3·i, antisymmetric (Hermitian values)
    or symmetric."""
    A = sparse_laplacian_3d(side, side, side, scaled=False)
    if not dtype.is_complex:
        return A
    rows, cols = A.row_ids(), A.colind
    sign = np.sign(cols - rows) if hermitian else (cols != rows)
    return SparseMatrix.from_arrays(A.height, A.width, A.rowptr, A.colind,
                                    A.vals + 0.3j * sign)


def _factor(case, dtype, hermitian=False, device="cpu", side=12,
            cutoff=32):
    if case == "kkt_fd_16":
        A = sparse_ruiz(concat_fd_2d(16, 16))[0]
        kkt, _ = _build_lp_kkt(A, 1e-2, 1e-2, None, device=device,
                               dtype=torch.float64)
        theta = torch.as_tensor(np.random.default_rng(3).uniform(
            0.1, 10.0, A.width), dtype=torch.float64, device=device)
        v, scale = kkt.equilibrate(kkt.assemble([theta]))
        return numeric.factor(kkt.symb, v, ea_plan=kkt.ea_plan, dtype=dtype,
                              pivot_floor=kkt.reg * scale * scale)
    f = SparseLDLFactorization(device=device, dtype=dtype)
    f.initialize(_laplacian(side, dtype, hermitian), hermitian=hermitian,
                 cutoff=cutoff)
    return f.factor().numeric


_FACTORS = {}


def _cached_factor(case, dtype, hermitian):
    key = case, dtype, hermitian
    if key not in _FACTORS:
        _FACTORS[key] = _factor(case, dtype, hermitian)
    return _FACTORS[key]


def _rhs(n, k, dtype, seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((n, k))
    if dtype.is_complex:
        b = b + 1j * rng.standard_normal((n, k))
    return torch.as_tensor(b).to(device, dtype)


def _close(got, ref, dtype, ulps):
    """Within ``ulps`` units in the last place of ``dtype``'s real type,
    relative to the largest value of ``ref``."""
    err = float((got - ref).abs().max() / ref.abs().max())
    return err <= ulps * torch.finfo(dtype).eps, err


# --------------------------------------------------------------- the oracle


def _masked_panels(pool, lev, ns):
    """The masked unit-lower (nf, S, S) panels the solve built before K10
    (``LDLFactorization._level_panels``)."""
    nf, S = lev.front_rows.shape
    F = pool[lev.offset:lev.offset + nf * S * S].view(nf, S, S)
    idx = torch.arange(S, device=pool.device)
    ns = torch.as_tensor(np.asarray(ns)).to(pool.device)
    keep = ((idx[None, None, :] < ns[:, None, None])
            & (idx[None, :, None] > idx[None, None, :]))
    eye = torch.eye(S, dtype=pool.dtype, device=pool.device)
    return torch.where(keep, F, torch.zeros((), dtype=pool.dtype,
                                            device=pool.device)) + eye


def _masked_step(xe, pool, lev, ns, forward, conjugate):
    """The level step as the solve ran it before K10: one triangular solve
    over every padded S×S panel, ``w - xf`` added into every slot."""
    lp = _masked_panels(pool, lev, ns)
    rows = lev.front_rows.long()
    xf = xe[rows]
    if forward:
        w = torch.linalg.solve_triangular(lp, xf, upper=False,
                                          unitriangular=True)
    else:
        w = torch.linalg.solve_triangular(lp.mH if conjugate else lp.mT, xf,
                                          upper=True, unitriangular=True)
    xe.index_add_(0, rows.reshape(-1), (w - xf).reshape(-1, xe.shape[1]))


def _masked_level_solve(self, xe, i, forward, ctx=None, delta=None):
    """``_masked_step`` in the place of ``LDLFactorization._level_solve``."""
    _masked_step(xe, self.pool, self.symb.levels[i], self.symb.levels[i].ns,
                 forward, self.conjugate)


def _k10_step(xe, pool, lev, sub, forward, conjugate):
    """One level step as the solve takes it: K10, then (forward) K9 over
    the update slots."""
    delta = xe.new_empty(lev.front_rows.numel(), xe.shape[1])
    level_solve(xe, pool, lev, sub, forward, conjugate, delta)
    if forward and sub.update.n_rows:
        level_scatter(xe, delta, None, sub.update)


def _l_panel_entries(symb):
    """Flat pool indices of every L panel entry: j < ns, j < i < sz."""
    out = []
    for lev in symb.levels:
        fr = np.asarray(lev.front_rows.cpu())
        S = lev.front_size
        for f, ns in enumerate(np.asarray(lev.ns)):
            sz = int((fr[f] != symb.n).sum())
            i, j = np.tril_indices(sz, -1)
            keep = j < ns
            out.append(lev.offset + f * S * S + i[keep] * S + j[keep])
    return np.concatenate(out)


def _poisoned(num):
    """The factor with every pool entry outside its L panels set to NaN."""
    keep = torch.zeros(num.pool.numel(), dtype=torch.bool,
                       device=num.pool.device)
    keep[torch.as_tensor(_l_panel_entries(num.symb),
                         device=num.pool.device)] = True
    pool = torch.where(keep, num.pool, torch.full(
        (), float("nan"), dtype=num.pool.dtype, device=num.pool.device))
    return numeric.LDLFactorization(num.symb, pool, num.d, num.conjugate)


# ----------------------------------------------------------- made-up levels


def _made_up_level(dtype, index_type, seed, device="cpu", S=40,
                   ns=(40, 1, 7, 33, 1), sz=(40, 40, 19, 40, 1), shared=48,
                   offset=5):
    """A level of fronts with the given pivots and real rows in a padded
    order S: pivot rows of their own, update rows drawn from ``shared``
    rows that several fronts hit; a random pool whose entries outside the
    L panels are NaN, its L entries small enough that the substitution
    stays tame.  Returns (xe, pool, lev, sub) and the pivot counts."""
    rng = np.random.default_rng(seed)
    nf = len(ns)
    P = int(sum(ns))
    n = P + shared
    fr = np.full((nf, S), n, np.int64)
    first = np.cumsum((0,) + ns[:-1])
    for f in range(nf):
        fr[f, :ns[f]] = first[f] + np.arange(ns[f])
        fr[f, ns[f]:sz[f]] = P + np.sort(rng.choice(shared, sz[f] - ns[f],
                                                    replace=False))
    vals = rng.uniform(-1, 1, offset + nf * S * S) / (2 * S)
    if dtype.is_complex:
        vals = vals + 1j * rng.uniform(-1, 1, vals.size) / (2 * S)
    pool = torch.as_tensor(vals).to(dtype)
    keep = np.zeros(vals.size, bool)
    for f in range(nf):
        i, j = np.tril_indices(sz[f], -1)
        ok = j < ns[f]
        keep[offset + f * S * S + i[ok] * S + j[ok]] = True
    pool[torch.as_tensor(~keep)] = float("nan")
    lev = types.SimpleNamespace(
        front_rows=torch.as_tensor(fr.astype(index_type)).to(device),
        offset=offset, front_size=S)
    sub = build_substitution_level(fr, np.asarray(ns), n, index_type)
    xe = _rhs(n + 1, 2, dtype, seed)
    xe[n] = 0
    return xe.to(device), pool.to(device), lev, sub.to(device), ns


# ------------------------------------------------------------------ plan


def test_plan_of_a_small_level():
    """Two fronts of S = 4 over rows 0-5, padding → 6."""
    fr = np.array([[0, 1, 4, 5], [2, 4, 6, 6]])
    sub = build_substitution_level(fr, np.array([2, 1]), 6, np.int32)
    assert sub.ns.tolist() == [2, 1] and sub.sz.tolist() == [4, 2]
    assert sub.ns.dtype == sub.sz.dtype == np.int32
    # the update slots alone: front 0's rows 4, 5 and front 1's row 4
    assert sub.update.slots.tolist() == [2, 5, 3]
    assert sub.update.rows.tolist() == [4, 5]
    assert sub.update.n_level_slots == 8
    assert (sub.max_ns, sub.warps, sub.split, sub.update_warps) == \
        (2, 1, False, 1)
    assert sub.launches == 1
    for bad in (np.array([0, 1]), np.array([5, 1])):
        with pytest.raises(ValueError):
            build_substitution_level(fr, bad, 6, np.int32)
    with pytest.raises(ValueError):     # a padded slot before a real one
        build_substitution_level(np.array([[0, 6, 1]]), np.array([1]), 6,
                                 np.int32)


def test_plan_splits_few_large_fronts(monkeypatch):
    """A level of few fronts with a large L21 goes a panel a launch with
    launches of its own for the products, a front of more than a panel's
    pivots too; lowering the threshold splits a small level."""
    fr = np.arange(600).reshape(1, 600)
    sub = build_substitution_level(fr, np.array([100]), 600, np.int64)
    assert (sub.warps, sub.split, sub.update_warps, sub.panels,
            sub.launches) == (4, True, 4, 1, 2)
    sub = build_substitution_level(fr, np.array([600]), 600, np.int64)
    assert (sub.warps, sub.split, sub.update_warps, sub.panels,
            sub.launches) == (8, True, 8, 3, 6)
    small = np.array([[0, 1, 4, 5], [2, 4, 6, 6]])
    monkeypatch.setattr(solve_plan, "SPLIT_MIN_PANEL", 1)
    sub = build_substitution_level(small, np.array([2, 1]), 6, np.int32)
    assert (sub.warps, sub.split, sub.launches) == (1, True, 2)


@pytest.mark.parametrize("case", ["kkt_fd_16", "laplacian_12"])
def test_plan_of_every_level(case):
    num = _cached_factor(case, torch.float64, False)
    symb = num.symb
    plan = symb.solve_plan
    assert len(plan.substitution) == len(symb.levels)
    assert plan.max_level_slots == max(lev.front_rows.numel()
                                       for lev in symb.levels)
    for lev, sub in zip(symb.levels, plan.substitution):
        fr = lev.front_rows.numpy()
        assert sub.ns.dtype == sub.sz.dtype == lev.front_rows.dtype
        assert np.array_equal(sub.ns.numpy(), lev.ns)
        assert np.array_equal(sub.sz.numpy(), (fr != symb.n).sum(1))
        update = np.arange(fr.shape[1])[None, :] >= lev.ns[:, None]
        want = np.flatnonzero(update & (fr != symb.n))
        assert np.array_equal(np.sort(sub.update.slots.numpy()), want)
        assert sub.max_ns == int(lev.ns.max())


# ------------------------------------------------------- the plain version


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("case,hermitian,dtype", FACTORS)
def test_level_steps_match_the_masked_solve(case, hermitian, dtype, k):
    """Each level step of both directions, from the same ``xe``, within
    64 ulps of the masked formulation; row n stays exactly 0."""
    num = _cached_factor(case, dtype, hermitian)
    symb = num.symb
    n, levels = symb.n, symb.levels
    b = _rhs(n, k, dtype)
    ref = torch.cat([b[symb.perm], b.new_zeros((1, k))])
    steps = [(True, i) for i in range(len(levels))] + \
        [(False, i) for i in reversed(range(len(levels)))]
    with numeric.full_fp32_matmul():
        for forward, i in steps:
            if (forward, i) == (False, len(levels) - 1):
                ref[:n] = ref[:n] / num.d[:, None]
            got = ref.clone()
            _masked_step(ref, num.pool, levels[i], levels[i].ns, forward,
                         num.conjugate)
            _k10_step(got, num.pool, levels[i],
                      symb.solve_plan.substitution[i], forward,
                      num.conjugate)
            ok, err = _close(got, ref, dtype, 64)
            assert ok, (forward, i, err)
            assert bool((got[n] == 0).all())
            ref = got


@pytest.mark.parametrize("case,hermitian,dtype", FACTORS)
def test_solves_match_the_masked_solve(monkeypatch, case, hermitian, dtype):
    """Whole solves, one column and three, within 256 ulps of the masked
    formulation's, and A·x = b to the dtype's rounding."""
    num = _cached_factor(case, dtype, hermitian)
    b = _rhs(num.symb.n, 3, dtype, seed=1)
    got = num.solve(b), num.solve(b[:, 0])
    monkeypatch.setattr(numeric.LDLFactorization, "_level_solve",
                        _masked_level_solve)
    ref = num.solve(b), num.solve(b[:, 0])
    for g, r in zip(got, ref):
        ok, err = _close(g, r, dtype, 256)
        assert ok, err


@pytest.mark.parametrize("case,hermitian,dtype", FACTORS)
def test_poisoned_pool_leaves_the_solve_unchanged(case, hermitian, dtype):
    """Every pool entry outside the L panels (padding, D, the trailing
    block, the upper triangle) set to NaN: the solve stays finite and
    bit-equal."""
    num = _cached_factor(case, dtype, hermitian)
    bad = _poisoned(num)
    assert bool(bad.pool.isnan().any())
    b = _rhs(num.symb.n, 2, dtype, seed=2)
    got = bad.solve(b)
    assert bool(got.isfinite().all())
    assert torch.equal(got, num.solve(b))


@pytest.mark.parametrize("conjugate", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_made_up_level_matches_the_masked_step(dtype, conjugate):
    """Fronts with ns = S, ns = 1 and ns = sz = 1, update rows shared
    between fronts, an offset pool with NaN outside the L panels: both
    directions within 64 ulps of the masked step, the pivot rows' values
    finite."""
    for forward in (True, False):
        xe, pool, lev, sub, ns = _made_up_level(dtype, np.int64, 7)
        ref = xe.clone()
        # the masked panels read the padded rows, which a factor leaves 0
        _masked_step(ref, torch.nan_to_num(pool, 0.0), lev, ns, forward,
                     conjugate)
        _k10_step(xe, pool, lev, sub, forward, conjugate)
        assert bool(xe.isfinite().all())
        ok, err = _close(xe, ref, dtype, 64)
        assert ok, (forward, err)


def test_plain_delta_holds_minus_l21_w1():
    """The forward ``delta`` at a front's update slot is −L21·w1 there."""
    xe, pool, lev, sub, ns = _made_up_level(torch.float64, np.int64, 3)
    x0 = xe.clone()
    delta = torch.full((lev.front_rows.numel(), 2), 9.0, dtype=xe.dtype)
    level_solve_plain(xe, pool, lev, sub, True, False, delta)
    S = lev.front_size
    f = 1                       # ns = 1, sz = S: w1 = x1, one column of L21
    L = pool[lev.offset + f * S * S:lev.offset + (f + 1) * S * S].view(S, S)
    r = lev.front_rows[f].long()
    assert torch.equal(xe[r[0]], x0[r[0]])
    want = -L[1:, :1] @ x0[r[0]][None, :]
    assert torch.allclose(delta[f * S + 1:(f + 1) * S], want, rtol=1e-14,
                          atol=0)


def test_cpu_solve_launches_no_kernel():
    num = _cached_factor("laplacian_12", torch.float64, False)
    before = level_solve.launches, level_scatter.launches
    num.solve(_rhs(num.symb.n, 1, torch.float64))
    assert (level_solve.launches, level_scatter.launches) == before


def test_no_kernel_for_another_device():
    xe, pool, lev, sub, _ = _made_up_level(torch.float32, np.int32, 0)
    meta = torch.device("meta")
    with pytest.raises(ValueError):
        level_solve(xe.to(meta), pool.to(meta), lev, sub, False)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _split_all(sub, lev, n, monkeypatch):
    """The level's plan rebuilt with every level split (the L21 products in
    launches of their own)."""
    monkeypatch.setattr(solve_plan, "SPLIT_MIN_PANEL", 1)
    monkeypatch.setattr(solve_plan, "SPLIT_MAX_FRONTS", 1 << 30)
    fr = lev.front_rows.cpu().numpy()
    out = build_substitution_level(fr, sub.ns.cpu().numpy(), n,
                                   fr.dtype).to(sub.ns.device)
    monkeypatch.undo()
    return out


def _check_level_on_card(pool, lev, sub, n, dtype, k, conjugate, seed,
                         ulps=64):
    """K10 (+ K9) on the card against the plain version on CPU copies of
    the level, both directions, from random ``xe``; the kernel twice to the
    same bits."""
    host = types.SimpleNamespace(front_rows=lev.front_rows.cpu(), offset=0,
                                 front_size=lev.front_size)
    nf, S = lev.front_rows.shape
    host_pool = pool[lev.offset:lev.offset + nf * S * S].cpu()
    host_sub = sub.to("cpu")
    for forward in (True, False):
        xe = _rhs(n + 1, k, dtype, seed, device=pool.device)
        xe[n] = 0
        runs = []
        for _ in range(2):
            out = xe.clone()
            _k10_step(out, pool, lev, sub, forward, conjugate)
            runs.append(out)
        torch.cuda.synchronize()
        assert torch.equal(runs[0], runs[1])
        ref = xe.cpu()
        _k10_step(ref, host_pool, host, host_sub, forward, conjugate)
        ok, err = _close(runs[0].cpu(), ref, dtype, ulps)
        assert ok, (forward, err)
        assert bool((runs[0][n] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("idt", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("conjugate", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_a_made_up_level(cuda, monkeypatch, dtype,
                                                 conjugate, k, idt, split):
    xe, pool, lev, sub, ns = _made_up_level(dtype, idt, 11, device=cuda)
    n = xe.shape[0] - 1
    if split:
        sub = _split_all(sub, lev, n, monkeypatch)
        assert sub.split
    _check_level_on_card(pool, lev, sub, n, dtype, k, conjugate, 5)


@pytest.fixture(scope="module")
def lap24():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {dt: _factor("laplacian_24", dt, device="cuda", side=24,
                        cutoff=64) for dt in DTYPES}


@pytest.mark.cuda
@pytest.mark.parametrize("split", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_plain_on_the_24_levels(lap24, monkeypatch, dtype, k,
                                               split):
    num = lap24[dtype]
    symb = num.symb
    for i, (lev, sub) in enumerate(zip(symb.levels,
                                       symb.solve_plan.substitution)):
        if split:
            sub = _split_all(sub, lev, symb.n, monkeypatch)
        _check_level_on_card(num.pool, lev, sub, symb.n, dtype, k, False, i)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_48_levels(cuda):
    """The benchmark's 48³ plan in float64: every level, one column."""
    num = _factor("laplacian_48", torch.float64, device=cuda, side=48,
                  cutoff=64)
    symb = num.symb
    split = sum(sub.split for sub in symb.solve_plan.substitution)
    assert 0 < split < len(symb.levels)
    assert symb.solve_plan.substitution[-1].panels == 11
    for i, (lev, sub) in enumerate(zip(symb.levels,
                                       symb.solve_plan.substitution)):
        _check_level_on_card(num.pool, lev, sub, symb.n, torch.float64, 1,
                             False, i)
    b = _rhs(symb.n, 1, torch.float64, 1, device=cuda)
    before = level_solve.launches
    x, again = num.solve(b), num.solve(b)
    torch.cuda.synchronize()
    per_solve = 2 * sum(sub.launches for sub in symb.solve_plan.substitution)
    assert level_solve.launches - before == 2 * per_solve
    assert torch.equal(x, again)


@pytest.mark.cuda
@pytest.mark.parametrize("case,hermitian,dtype", FACTORS)
def test_solves_on_card_repeat_bits_and_count_launches(cuda, monkeypatch,
                                                       case, hermitian,
                                                       dtype):
    """Two solves to the same bits, within 256 ulps of the masked
    formulation's on the same factor, and 2 × levels K10 launches a solve
    (these plans split no level)."""
    num = _factor(case, dtype, hermitian, device=cuda)
    plan = num.symb.solve_plan
    assert all(sub.launches == 1 for sub in plan.substitution)
    b = _rhs(num.symb.n, 3, dtype, seed=4, device=cuda)
    before = level_solve.launches
    got, again = num.solve(b), num.solve(b)
    torch.cuda.synchronize()
    assert level_solve.launches - before == 2 * 2 * len(num.symb.levels)
    assert torch.equal(got, again)
    monkeypatch.setattr(numeric.LDLFactorization, "_level_solve",
                        _masked_level_solve)
    ok, err = _close(got, num.solve(b), dtype, 256)
    assert ok, err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex64])
def test_poisoned_pool_on_card(lap24, dtype):
    num = lap24[dtype]
    b = _rhs(num.symb.n, 1, dtype, seed=6, device="cuda")
    got = _poisoned(num).solve(b)
    torch.cuda.synchronize()
    assert bool(got.isfinite().all())
    assert torch.equal(got, num.solve(b))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_solve_replays_from_a_cuda_graph(lap24, dtype):
    """A plain solve captured in a CUDA graph under sync-debug mode
    "error" (no host wait, no host copy) replays to the eager solve's
    bits."""
    num = lap24[dtype]
    b = _rhs(num.symb.n, 1, dtype, seed=8, device="cuda")
    want = num.solve(b)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        num.solve(b)                    # warm the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.cuda.graph(graph):
            out = num.solve(b)
        graph.replay()
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _card_refusals(cuda):
    xe, pool, lev, sub, _ = _made_up_level(torch.float64, np.int32, 0,
                                           device=cuda)
    delta = xe.new_empty(lev.front_rows.numel(), xe.shape[1])
    host_sub = sub.to("cpu")
    return {
        "plan_on_cpu": (ValueError, (xe, pool, lev, host_sub, True, False,
                                     delta)),
        "xe_rows": (ValueError, (xe[1:].contiguous(), pool, lev, sub, False)),
        "xe_1d": (ValueError, (xe[:, 0].contiguous(), pool, lev, sub, False)),
        "pool_short": (ValueError, (xe, pool[:-1], lev, sub, False)),
        "pool_dtype": (ValueError, (xe, pool.float(), lev, sub, False)),
        "no_delta": (ValueError, (xe, pool, lev, sub, True, False, None)),
        "delta_short": (ValueError, (xe, pool, lev, sub, True, False,
                                     delta[1:])),
        "xe_not_contiguous": (ValueError, (xe.t().contiguous().t(), pool,
                                           lev, sub, False)),
        "half": (TypeError, (xe.half(), pool.half(), lev, sub, False)),
    }


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(cuda):
    for name, (err, args) in _card_refusals(cuda).items():
        xe = args[0]
        before = xe.clone()
        with pytest.raises(err):
            level_solve(*args)
        assert torch.equal(xe, before), name
