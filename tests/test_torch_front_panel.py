"""K8, the blocked LDLᵀ front factor's panel kernel (``kernels/front_panel.py``,
``csrc/front_panel.cu``).

CPU tests: the plain panel function and the blocked factor built on it
against the column loop the factor ran before (kept below as
``_loop_blocked``), bit for bit, and the wrapper's refusals.  Tests marked
``cuda`` hold the kernel against the plain version on the card and factor
on the card against the CPU; they skip without a card.  The file imports no
JAX:

    python -m pytest tests/test_torch_front_panel.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from elemental_tpu_torch.kernels.front_panel import (NB, _clamp_pivot,
                                                     ldl_panel,
                                                     ldl_panel_plain)
from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_3d
from elemental_tpu_torch.optimization.lp import _build_lp_kkt, sparse_ruiz
from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                               numeric)

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]


def _loop_panel(Fw, ns, j0: int, nb: int, conjugate: bool, pf, idx):
    """One panel of the column loop the blocked factor ran before K8, on
    the padded batch ``Fw``: the panel in place, and its masked Lp and
    Lp·dp (all rows)."""
    j1 = j0 + nb
    tpan = torch.arange(nb, device=Fw.device)
    zero = torch.zeros((), dtype=Fw.dtype, device=Fw.device)
    Fp = Fw[:, :, j0:j1].clone()
    for kk in range(nb):
        k = j0 + kk
        elim = ns > k
        dk = Fp[:, k, kk].clone()
        if pf is not None:
            dk = torch.where(elim, _clamp_pivot(dk, pf[:, k]), dk)
        safe = torch.where(dk == 0, torch.ones_like(dk), dk)
        below = (idx > k)[None, :] & elim[:, None]
        col = torch.where(below, Fp[:, :, kk] / safe[:, None], zero)
        row = col[:, k + 1:j1]
        if conjugate:
            row = row.conj()
        Fp[:, k + 1:, kk + 1:] -= col[:, k + 1:, None] \
            * row[:, None, :] * dk[:, None, None]
        Fp[:, :, kk] = torch.where(below, col, Fp[:, :, kk])
        Fp[:, k, kk] = dk
    Fw[:, :, j0:j1] = Fp
    prow = j0 + tpan
    dp = Fp[:, prow, tpan]
    keep = ((idx[:, None] > prow[None, :])[None]
            & (prow[None, None, :] < ns[:, None, None]))
    Lp = torch.where(keep, Fp, zero)
    return Lp, Lp * dp[:, None, :]


def _loop_blocked(F, ns, max_ns: int, conjugate: bool, nb: int = 32,
                  pf=None):
    """The blocked factor as it ran before K8: each panel's column loop in
    Python over the whole batch, padded to a multiple of nb; where the rest
    of the front fits one panel or NB columns, one panel to its end, as the
    factor schedules it."""
    nf, S, _ = F.shape
    nb = max(1, min(nb, max_ns))
    npan = -(-max_ns // nb)
    Sp = max(S, npan * nb)
    Fw = F
    if Sp != S:
        Fw = torch.nn.functional.pad(F, (0, Sp - S, 0, Sp - S))
        if pf is not None:
            pf = torch.nn.functional.pad(pf, (0, Sp - S))
    idx = torch.arange(Sp, device=F.device)
    for p in range(npan):
        j0, j1 = p * nb, (p + 1) * nb
        if S - j0 <= max(nb, NB):
            _loop_panel(Fw, ns, j0, Sp - j0, conjugate, pf, idx)
            break
        Lp, LD = _loop_panel(Fw, ns, j0, nb, conjugate, pf, idx)
        if j1 < Sp:
            Lt = Lp[:, j1:, :].mH if conjugate else Lp[:, j1:, :].mT
            Fw[:, :, j1:] -= torch.matmul(LD, Lt)
    if Sp != S:
        F.copy_(Fw[:, :S, :S])
    return F


# name: (nf, S, ns, with floors, conjugate).  ns: "ragged" draws 0..S with
# 0 and S among them; an int is every front's count
CASES = {
    "ragged_ns": (7, 77, "ragged", False, False),
    "pivot_floor": (6, 70, "ragged", True, False),
    "conjugate": (5, 68, "ragged", True, True),
    "ragged_last_panel": (4, 75, 75, True, False),
    "one_large_front": (1, 1100, 1100, True, False),
    "many_small_fronts": (300, 40, "ragged", True, False),
}


def _batch(case, dtype, seed=0, device="cpu"):
    """A random padded level batch: (F, ns, max_ns, pf, conjugate).  Its
    diagonal is large with either sign (an indefinite, stable batch), a
    few pivots are exactly 0 and some floors exceed their pivots."""
    nf, S, ns_kind, floors, conj = CASES[case]
    rng = np.random.default_rng(seed)
    shape = (nf, S, S)
    a = rng.standard_normal(shape)
    if dtype.is_complex:
        a = a + 1j * rng.standard_normal(shape)
    sign = np.where(rng.random((nf, S)) < 0.5, -1.0, 1.0)
    idx = np.arange(S)
    a[:, idx, idx] += sign * (2.0 * np.sqrt(S))
    if ns_kind == "ragged":
        ns = rng.integers(0, S + 1, nf)
        ns[0], ns[-1] = 0, S
        if nf > 2:
            ns[1] = 33
    else:
        ns = np.full(nf, ns_kind)
    pf = None
    if floors:
        # an exact zero pivot in column 0 of every front, floors above
        # some pivots, and floors of 0 (no clamp)
        a[:, 0, 0] = 0.0
        mag = np.where(rng.random((nf, S)) < 0.3, 4.0 * np.sqrt(S), 0.0)
        pf = torch.as_tensor(mag * np.where(rng.random((nf, S)) < 0.5,
                                            -1.0, 1.0)).to(device, dtype)
    F = torch.as_tensor(a).to(device, dtype).contiguous()
    ns_t = torch.as_tensor(ns, dtype=torch.int64).to(device)
    return F, ns_t, int(ns.max()), pf, conj


@pytest.mark.parametrize("cut", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_blocked_factor_equals_the_column_loop(case, dtype, cut):
    """The blocked factor through the plain panel function equals the
    column loop it replaced, bit for bit (``torch.equal``), on the CPU;
    ``cut`` stops every front 40 columns short of S, so no panel is
    ragged.  One exception: where the loop padded the batch to whole
    panels, its last trailing product was a complex gemm of another width,
    which the CPU's BLAS rounds otherwise: there complex values agree to a
    few ulps of the batch's largest value."""
    F, ns, max_ns, pf, conj = _batch(case, dtype)
    S = F.shape[1]
    if cut:
        max_ns = min(max_ns, S - 40)
        ns = ns.clamp(max=max_ns)
    ref = _loop_blocked(F.clone(), ns, max_ns, conj, 32, pf)
    got = numeric._masked_partial_ldl_blocked(F.clone(), ns, max_ns, conj,
                                              32, pf)
    if dtype.is_complex and -(-max_ns // 32) * 32 > S:
        eps = torch.finfo(dtype).eps
        assert float((got - ref).abs().max()) <= 8 * eps * float(
            ref.abs().max())
    else:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("j0,nb", [(0, 32), (32, 32), (0, 4), (36, 4),
                                   (64, 4)])
def test_plain_panel_equals_the_loop_body(j0, nb):
    """One panel of the plain version, with its scratch, against the old
    loop body on the same panel: the panel and Lp, Lp·dp (rows ≥ j0; the
    loop's rows above are 0) bit for bit."""
    F, ns, _, pf, conj = _batch("pivot_floor", torch.float64, seed=3)
    nf, S, _ = F.shape
    lp = torch.empty(nf, S - j0, nb, dtype=F.dtype)
    ld = torch.empty_like(lp)
    got = F.clone()
    ldl_panel(got, ns, j0, nb, conj, pf, lp, ld)
    ref = F.clone()
    Lp, LD = _loop_panel(ref, ns, j0, nb, conj, pf, torch.arange(S))
    assert torch.equal(got, ref)
    assert torch.equal(lp, Lp[:, j0:]) and torch.equal(ld, LD[:, j0:])
    assert not Lp[:, :j0].any() and not LD[:, :j0].any()


def _near(got, ref, dtype, scale, ulps=16):
    """Equal up to rounding: within ``ulps`` of the batch's largest value
    (the CPU's readings reach 6; the card's gemm may sum in another
    order, so its tests allow 32)."""
    eps = torch.finfo(dtype).eps
    return float((got - ref).abs().max()) <= ulps * eps * scale


def _wide(S):
    """A panel wider than NB that fits fronts of order S (S > NB)."""
    return min(2 * NB + 6, S)


@pytest.mark.parametrize("scratch", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_wide_panel_near_the_plain_loop(case, dtype, scratch):
    """A panel wider than NB (sub-panels of NB, each with its update of
    the panel's later columns) against the plain loop over the whole
    width: the panel, and its scratch Lp and Lp·dp, up to rounding."""
    F, ns, _, pf, conj = _batch(case, dtype, seed=4)
    nf, S, _ = F.shape
    w = _wide(S)
    scale = float(F.abs().max())
    sc = [None] * 4
    if scratch:
        sc = [torch.full((nf, S, w), float("nan"), dtype=dtype)
              for _ in range(4)]
    got, ref = F.clone(), F.clone()
    ldl_panel(got, ns, 0, w, conj, pf, *sc[:2])
    ldl_panel_plain(ref, ns, 0, w, conj, pf, *sc[2:])
    assert _near(got, ref, dtype, scale)
    if scratch:
        for a, b in zip(sc[:2], sc[2:]):
            assert _near(a, b, dtype, scale)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["ragged_ns", "pivot_floor", "conjugate",
                                  "ragged_last_panel"])
def test_wide_blocked_factor_near_the_column_loop(case, dtype):
    """The blocked factor with panels of 2·NB (``panel_blocksize`` above
    the kernel's width) against the column loop at the same panel width,
    up to rounding."""
    F, ns, max_ns, pf, conj = _batch(case, dtype, seed=5)
    scale = float(F.abs().max())
    ref = _loop_blocked(F.clone(), ns, max_ns, conj, 2 * NB, pf)
    got = numeric._masked_partial_ldl_blocked(F.clone(), ns, max_ns, conj,
                                              2 * NB, pf)
    assert _near(got, ref, dtype, scale)


def test_cpu_panel_launches_no_kernel():
    F, ns, _, pf, conj = _batch("ragged_ns", torch.float32)
    before = ldl_panel.launches
    ldl_panel(F, ns, 0, NB, conj, pf)
    assert ldl_panel.launches == before


def _refusal_cases():
    F, ns, _, pf, _ = _batch("pivot_floor", torch.float64)
    nf, S, _ = F.shape
    lp = torch.empty(nf, S, NB, dtype=F.dtype)
    meta = torch.device("meta")
    return {
        "dtype": (TypeError, (F.to(torch.float16), ns, 0, NB), {}),
        "not_3d": (ValueError, (F[0], ns, 0, NB), {}),
        # a front of other than S columns is taken, as the distributed
        # front's gathered panel, while the panel lies in its columns
        "not_square": (ValueError, (F[:, :, :NB - 1].contiguous(), ns, 0,
                                    NB), {}),
        "not_contiguous": (ValueError, (F.transpose(1, 2), ns, 0, NB), {}),
        "panel_outside": (ValueError, (F, ns, S - 8, NB), {}),
        "empty_panel": (ValueError, (F, ns, 0, 0), {}),
        "ns_dtype": (TypeError, (F, ns.to(torch.int32), 0, NB), {}),
        "ns_shape": (TypeError, (F, ns[1:], 0, NB), {}),
        "pf_dtype": (ValueError, (F, ns, 0, NB), {"pf": pf.float()}),
        "pf_shape": (ValueError, (F, ns, 0, NB), {"pf": pf[:, 1:]}),
        "pf_not_contiguous": (ValueError, (F, ns, 0, NB),
                              {"pf": pf.t().contiguous().t()}),
        "one_scratch": (ValueError, (F, ns, 0, NB), {"lp": lp}),
        "scratch_shape": (ValueError, (F, ns, 0, NB),
                          {"lp": lp[:, 1:], "ld": lp[:, 1:]}),
        "arrivals_dtype": (TypeError, (F, ns, 0, NB),
                           {"arrivals": torch.zeros(nf)}),
        "device_mismatch": (ValueError, (F, ns.to(meta), 0, NB), {}),
        "no_kernel_device": (ValueError, (F.to(meta), ns.to(meta), 0, NB),
                             {}),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_wrapper_refuses_bad_inputs(case):
    err, args, kw = _refusal_cases()[case]
    F = args[0]
    before = None if F.device.type == "meta" else F.clone()
    with pytest.raises(err):
        ldl_panel(*args, conjugate=False, **kw)
    if before is not None:
        assert torch.equal(F, before)


def _laplacian_factor(device, n=10):
    A = sparse_laplacian_3d(n, n, n, scaled=False)
    f = SparseLDLFactorization(device=device, dtype=torch.float64,
                               spd=False)
    return f.initialize(A, cutoff=32)


def test_facade_factor_equals_the_column_loop(monkeypatch):
    """The whole factor of the 10³ Laplacian (LDLᵀ kernel) equals the one
    the column loop gives, bit for bit."""
    got = _laplacian_factor("cpu").factor().numeric
    monkeypatch.setattr(numeric, "_masked_partial_ldl_blocked",
                        _loop_blocked)
    ref = _laplacian_factor("cpu").factor().numeric
    assert torch.equal(got.pool, ref.pool) and torch.equal(got.d, ref.d)


def _kkt(device, n1=8):
    A = sparse_ruiz(concat_fd_2d(n1, n1))[0]
    kkt, slot = _build_lp_kkt(A, 1e-2, 1e-2, None, device=device,
                              dtype=torch.float64)
    theta = torch.as_tensor(np.random.default_rng(2).uniform(
        0.1, 10.0, A.width), dtype=torch.float64, device=device)
    return kkt, kkt.assemble([theta])


def test_kkt_factor_equals_the_column_loop(monkeypatch):
    """The LP's KKT factor (n1 = 8, quasi-definite, floors retaken on a
    zero pivot) equals the one the column loop gives, bit for bit."""
    kkt, vals = _kkt("cpu")
    got = kkt.prepare(vals)
    monkeypatch.setattr(numeric, "_masked_partial_ldl_blocked",
                        _loop_blocked)
    ref = kkt.prepare(vals)
    assert torch.equal(got.pool, ref.pool) and torch.equal(got.d, ref.d)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(got, ref, dtype, scale):
    """Real: bit-equal.  Complex: within a few ulps of the front's norm."""
    if not dtype.is_complex:
        return torch.equal(got, ref)
    eps = torch.finfo(dtype).eps
    return float((got - ref).abs().max()) <= 16 * eps * scale


def _panels(S, max_ns, nb=32):
    return [(j0, min(j0 + nb, S) - j0) for j0 in range(0, max_ns, nb)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_on_every_panel(cuda, case, dtype):
    """K8 against the plain version on the card, panel after panel of the
    level (so each panel starts from a factored prefix), with the scratch
    panels and without, the arrivals left zeroed."""
    F, ns, max_ns, pf, conj = _batch(case, dtype, seed=1, device=cuda)
    nf, S, _ = F.shape
    scale = float(F.abs().max())
    got, ref = F.clone(), F.clone()
    arrivals = torch.zeros(nf, dtype=torch.int32, device=cuda)
    before = ldl_panel.launches
    panels = _panels(S, max_ns)
    for i, (j0, w) in enumerate(panels):
        scratch = [None, None]
        if i % 2 == 0 and j0 + w < S:
            scratch = [torch.full((nf, S - j0, w), float("nan"),
                                  dtype=dtype, device=cuda)
                       for _ in range(4)]
        ldl_panel(got, ns, j0, w, conj, pf, *scratch[:2], arrivals)
        ldl_panel_plain(ref, ns, j0, w, conj, pf, *scratch[2:])
        torch.cuda.synchronize()
        assert _close(got, ref, dtype, scale), (j0, w)
        if scratch[0] is not None:
            for a, b in zip(scratch[:2], scratch[2:]):
                assert _close(a, b, dtype, scale), (j0, w)
        # the next panel starts from the plain version's state
        got.copy_(ref)
    assert ldl_panel.launches - before == len(panels)
    assert not arrivals.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["ragged_ns", "conjugate",
                                  "ragged_last_panel", "one_large_front"])
def test_blocked_factor_kernel_matches_plain(cuda, monkeypatch, case, dtype):
    """The blocked factor on the card through K8 against the same factor
    with the plain panel function: one launch a panel."""
    F, ns, max_ns, pf, conj = _batch(case, dtype, seed=2, device=cuda)
    scale = float(F.abs().max())
    before = ldl_panel.launches
    got = numeric._masked_partial_ldl_blocked(F.clone(), ns, max_ns, conj,
                                              32, pf)
    launches = ldl_panel.launches - before
    monkeypatch.setattr(numeric, "ldl_panel",
                        lambda F, ns, j0, w, c, pf, lp=None, ld=None,
                        arrivals=None: ldl_panel_plain(F, ns, j0, w, c, pf,
                                                       lp, ld))
    ref = numeric._masked_partial_ldl_blocked(F.clone(), ns, max_ns, conj,
                                              32, pf)
    torch.cuda.synchronize()
    assert launches == len(_panels(F.shape[1], max_ns))
    assert _close(got, ref, dtype, scale)


def _blocked_panels(symb, nb=32):
    """The plan's panel count: the blocked kernel takes every level."""
    return sum(-(-int(lev.ns.max()) // nb) for lev in symb.levels)


@pytest.mark.cuda
def test_laplacian_factor_on_card_matches_cpu(cuda):
    """The 24³ Laplacian's LDLᵀ factor on the card against the CPU's, in
    float64 (to 1e-12 of max|pool|), with one K8 launch a blocked panel."""
    fc = _laplacian_factor("cpu", n=24).factor()
    fg = _laplacian_factor(cuda, n=24)
    panels = _blocked_panels(fg.symb)
    before = ldl_panel.launches
    fg.factor()
    torch.cuda.synchronize()
    assert panels > 0
    assert ldl_panel.launches - before == panels
    pc, pg = fc.numeric.pool, fg.numeric.pool.cpu()
    assert float((pc - pg).abs().max()) <= 1e-12 * float(pc.abs().max())


@pytest.mark.cuda
def test_kkt_factor_on_card_matches_cpu(cuda):
    """A small FD2D LP KKT (n1 = 16) factored on the card against the CPU,
    in float64 (to 1e-12 of max|pool|), one K8 launch a blocked panel."""
    kc, vc = _kkt("cpu", 16)
    kg, vg = _kkt(cuda, 16)
    panels = _blocked_panels(kg.symb)
    before = ldl_panel.launches
    fg = kg.prepare(vg)
    torch.cuda.synchronize()
    launches = ldl_panel.launches - before
    fc = kc.prepare(vc)
    assert panels > 0
    # a zero pivot retakes the factor with floors: a whole second factor
    assert launches in (panels, 2 * panels)
    pc, pg = fc.pool, fg.pool.cpu()
    assert float((pc - pg).abs().max()) <= 1e-12 * float(pc.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["ragged_ns", "conjugate",
                                  "one_large_front"])
def test_wide_panel_kernel_near_plain(cuda, case, dtype):
    """A panel wider than NB on the card (one K8 launch a sub-panel of NB)
    against the plain loop over the whole width, up to rounding."""
    F, ns, _, pf, conj = _batch(case, dtype, seed=6, device=cuda)
    nf, S, _ = F.shape
    w = _wide(S)
    scale = float(F.abs().max())
    sc = [torch.full((nf, S, w), float("nan"), dtype=dtype, device=cuda)
          for _ in range(4)]
    got, ref = F.clone(), F.clone()
    before = ldl_panel.launches
    ldl_panel(got, ns, 0, w, conj, pf, *sc[:2])
    launches = ldl_panel.launches - before
    ldl_panel_plain(ref, ns, 0, w, conj, pf, *sc[2:])
    torch.cuda.synchronize()
    assert launches == -(-w // NB)
    assert _near(got, ref, dtype, scale, 32)
    for a, b in zip(sc[:2], sc[2:]):
        assert _near(a, b, dtype, scale, 32)


@pytest.mark.cuda
def test_laplacian_factor_wide_panels_on_card(cuda):
    """``panel_blocksize`` = 2·NB on the card: the 24³ Laplacian's LDLᵀ
    factor against the CPU's at the same panel width, in float64 (to
    1e-12 of max|pool|), one K8 launch a sub-panel of NB."""
    nb = 2 * NB

    def run(f):
        return numeric.factor(f.symb, f.A.vals, ea_plan=f.ea_plan,
                              dtype=torch.float64, spd=False,
                              panel_blocksize=nb)

    fc = _laplacian_factor("cpu", n=24)
    fg = _laplacian_factor(cuda, n=24)
    launches = 0
    for lev in fg.symb.levels:
        max_ns, S = int(lev.ns.max()), lev.front_size
        w = max(1, min(nb, max_ns))
        launches += sum(-(-(min(j0 + w, S) - j0) // NB)
                        for j0 in range(0, max_ns, w))
    before = ldl_panel.launches
    pg = run(fg).pool
    torch.cuda.synchronize()
    assert launches > 0
    assert ldl_panel.launches - before == launches
    pc = run(fc).pool
    assert float((pc - pg.cpu()).abs().max()) <= 1e-12 * float(
        pc.abs().max())
