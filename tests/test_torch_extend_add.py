"""Parity of the port's extend-add (its plan and K1's plain version) with the
JAX package's Pallas route-add (interpret mode, as
``tests/sparse_direct/test_extend_add.py`` runs it) and its XLA flat scatter.

The CUDA kernel itself runs only on a card: ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from elemental_tpu.matrices import sparse_laplacian_3d as jax_laplacian
from elemental_tpu.optimization.lp import _build_lp_kkt as jax_build_lp_kkt
from elemental_tpu.sparse import SparseMatrix as JaxSparseMatrix
from elemental_tpu.sparse_direct.ea_plan import build_ea_plans
from elemental_tpu.sparse_direct.numeric import _ea_apply
from elemental_tpu.sparse_direct.ordering import (
    nested_dissection as jax_nested_dissection)
from elemental_tpu.sparse_direct.symbolic import analyze as jax_analyze

from elemental_tpu_torch.kernels.extend_add import (RUN_BLOCK, extend_add,
                                                    extend_add_plain)
from elemental_tpu_torch.matrices import concat_fd_2d
from elemental_tpu_torch.sparse_direct import (build_ea_plan,
                                               from_reference)
from elemental_tpu_torch.sparse_direct.ea_plan import build_ea_level

torch.set_num_threads(1)


def _jax_symb(name):
    """The JAX package's symbolic plan of a test matrix (host arrays)."""
    if name == "laplacian_7":
        A = jax_laplacian(7, 7, 7, scaled=False)
        return jax_analyze(A, perm=jax_nested_dissection(A, cutoff=16))
    A = concat_fd_2d(8, 8)
    Aj = JaxSparseMatrix(A.height, A.width, A.rowptr, A.colind, A.vals)
    kkt, _ = jax_build_lp_kkt(Aj, 1e-2, 1e-2, None)
    return kkt.symb


@pytest.fixture(scope="module", params=["laplacian_7", "kkt_fd_8"])
def jsymb(request):
    return _jax_symb(request.param)


def test_plan_matches_numpy_model(jsymb):
    """Plan invariants, and plan-driven plain extend-add == np.add.at."""
    symb = from_reference(jsymb)
    plan = build_ea_plan(symb)
    rng = np.random.default_rng(3)
    pool = rng.standard_normal(symb.pool_size)
    expect = pool.copy()
    got = torch.as_tensor(pool.copy())
    with_children = [li for li, lev in enumerate(symb.levels)
                     if lev.child_dst.size]
    assert sorted(plan.levels) == with_children
    for li in with_children:
        lev, lv = symb.levels[li], plan.levels[li]
        m = int(lv.offsets[-1])                          # multi-source pairs
        assert np.all(np.diff(lv.udst) > 0)              # unique, sorted
        assert lv.offsets[0] == 0 and m + lv.n_run_pairs == lv.n_pairs
        assert np.all(np.diff(lv.offsets) >= 2)          # two sources or more
        assert np.array_equal(lv.dst[:m], np.repeat(lv.udst,
                                                    np.diff(lv.offsets)))
        # the multi-source destinations' sources in stable destination
        # order, as the symbolic plan has them
        order = np.argsort(lev.child_dst, kind="stable")
        multi = np.isin(lev.child_dst[order], lv.udst)
        assert np.array_equal(lv.src[:m], lev.child_src[order][multi])
        # the run part is the rest, in the symbolic plan's order
        single = ~np.isin(lev.child_dst, lv.udst)
        assert np.array_equal(lv.dst[m:], lev.child_dst[single])
        assert np.array_equal(lv.src[m:], lev.child_src[single])
        assert lv.src_max == lev.child_src.max()
        np.add.at(expect, lev.child_dst, expect[lev.child_src])
        extend_add(got, lv.to("cpu"))
        np.testing.assert_allclose(got.numpy(), expect, rtol=0,
                                   atol=1e-12 * np.abs(expect).max())


def test_plan_rejects_unsafe_geometry():
    """A source inside the level's own segment would make the update in
    place unsafe: the plan refuses it."""
    symb = from_reference(_jax_symb("laplacian_7"))
    li = next(i for i, lev in enumerate(symb.levels) if lev.child_dst.size)
    lev = symb.levels[li]
    bad = dataclasses.replace(lev, child_src=lev.child_dst.copy())
    levels = list(symb.levels)
    levels[li] = bad
    with pytest.raises(ValueError, match="own segment"):
        build_ea_plan(dataclasses.replace(symb, levels=levels))
    bad = dataclasses.replace(lev, child_dst=lev.child_dst - lev.offset - 1)
    levels[li] = bad
    with pytest.raises(ValueError, match="destination outside"):
        build_ea_plan(dataclasses.replace(symb, levels=levels))


def test_level_to_checks_the_plan_once():
    """``EALevel.to`` refuses a plan whose arrays do not fit together: one
    index type, offsets one longer than the destinations, run blocks as
    ``RUN_BLOCK`` gives them."""
    symb = from_reference(_jax_symb("laplacian_7"))
    lv = next(iter(build_ea_plan(symb).levels.values()))
    lv.to("cpu")
    with pytest.raises(TypeError, match="one index"):
        dataclasses.replace(lv, src=lv.src.astype(np.int64)).to("cpu")
    with pytest.raises(ValueError, match="offsets"):
        dataclasses.replace(lv, offsets=lv.offsets[:-1]).to("cpu")
    with pytest.raises(ValueError, match="run_blk"):
        dataclasses.replace(lv, run_blk=lv.run_blk[:-1]).to("cpu")
    with pytest.raises(ValueError, match="multi-source and the run"):
        dataclasses.replace(lv, n_run_pairs=lv.n_run_pairs - 1).to("cpu")


def _expand_runs(lv):
    """The (dst, src) pairs of a level's runs, in run order."""
    lengths = np.diff(lv.run_off.astype(np.int64))
    step = np.arange(lv.n_run_pairs) - np.repeat(lv.run_off[:-1], lengths)
    return (np.repeat(lv.run_dst, lengths) + step,
            np.repeat(lv.run_src, lengths) + step)


@pytest.mark.parametrize("idt", [np.int32, np.int64])
def test_run_form_expands_to_the_symbolic_pairs(jsymb, idt):
    """The runs and the multi-source part together are exactly the
    symbolic plan's (dst, src) pairs; the runs are maximal and in the
    symbolic order; ``run_blk`` is ``np.searchsorted`` of ``run_off``."""
    symb = from_reference(jsymb)
    for lev in symb.levels:
        if not lev.child_dst.size:
            continue
        lo = int(lev.offset)
        hi = lo + len(lev.sn_ids) * lev.front_size ** 2
        lv = build_ea_level(lev.child_dst, lev.child_src, lo, hi,
                            symb.pool_size, idt)
        assert all(getattr(lv, f).dtype == idt for f in (
            "udst", "offsets", "src", "dst", "run_dst", "run_src",
            "run_off", "run_blk"))
        rd, rs = _expand_runs(lv)
        m = int(lv.offsets[-1])
        assert np.array_equal(rd, lv.dst[m:]) and np.array_equal(rs,
                                                                 lv.src[m:])
        got = np.stack([np.concatenate([lv.dst[:m], rd]),
                        np.concatenate([lv.src[:m], rs])]).astype(np.int64)
        want = np.stack([lev.child_dst, lev.child_src])
        assert np.array_equal(got[:, np.lexsort(got[::-1])],
                              want[:, np.lexsort(want[::-1])])
        # maximal: a run's end does not continue into the next run
        ends = lv.run_off[1:-1].astype(np.int64) - 1
        assert not np.any((rd[ends] + 1 == lv.run_dst[1:])
                          & (rs[ends] + 1 == lv.run_src[1:]))
        assert np.all(np.diff(lv.run_off) >= 1)
        blocks = -(-lv.n_run_pairs // RUN_BLOCK)
        assert np.array_equal(lv.run_blk, np.searchsorted(
            lv.run_off, RUN_BLOCK * np.arange(blocks + 1), side="right") - 1)


def test_run_and_multi_destinations_are_disjoint(jsymb):
    """No destination is in both parts, and each run destination has one
    source."""
    symb = from_reference(jsymb)
    for lv in build_ea_plan(symb).levels.values():
        rd, _ = _expand_runs(lv)
        assert np.unique(rd).size == rd.size
        assert np.intersect1d(rd, lv.udst).size == 0


def test_level_of_single_pair_runs():
    """Pairs with no neighbour in common make one run each, across several
    run blocks; the plain extend-add of the level matches np.add.at."""
    rng = np.random.default_rng(4)
    n = 3 * RUN_BLOCK + 17
    dst = n + rng.permutation(n)
    src = rng.permutation(n)
    lv = build_ea_level(dst, src, n, 2 * n, 2 * n)
    assert lv.n_multi == 0 and lv.n_runs == lv.n_run_pairs == n
    assert lv.run_blk.size == 5 and lv.run_blk[-1] == n
    pool = rng.standard_normal(2 * n)
    expect = pool.copy()
    np.add.at(expect, dst, expect[src])
    got = torch.as_tensor(pool.copy())
    extend_add(got, lv.to("cpu"))
    assert np.array_equal(got.numpy(), expect)


def test_extend_add_matches_reference(jsymb):
    """Level by level: port extend-add == the JAX Pallas route-add
    (interpret mode, plans for every level) == the XLA flat scatter, to
    1e-12·max|pool| (the reference's own bound)."""
    plans = build_ea_plans(jsymb, min_elems=1)
    assert plans is not None
    symb = from_reference(jsymb)
    plan = build_ea_plan(symb).to("cpu")
    assert sorted(plans.levels) == sorted(plan.levels)
    rng = np.random.default_rng(11)
    pool0 = rng.standard_normal(plans.pool_alloc)
    ref_pallas = jnp.asarray(pool0)
    ref_xla = jnp.asarray(pool0[:symb.pool_size])
    got = torch.as_tensor(pool0[:symb.pool_size].copy())
    for li in sorted(plan.levels):
        lev = jsymb.levels[li]
        lp = plans.levels[li]
        if lp.spill_dst.size:
            ref_pallas = ref_pallas.at[lp.spill_dst].add(
                ref_pallas[lp.spill_src])
        ref_pallas = _ea_apply(ref_pallas, lev, lp, interpret=True)
        ref_xla = ref_xla.at[jnp.asarray(lev.child_dst)].add(
            ref_xla[jnp.asarray(lev.child_src)])
        extend_add(got, plan.levels[li])
        p = np.asarray(ref_pallas)[:symb.pool_size]
        x = np.asarray(ref_xla)
        scale = np.abs(x).max()
        assert np.abs(got.numpy() - p).max() <= 1e-12 * scale
        assert np.abs(got.numpy() - x).max() <= 1e-12 * scale


def test_wrapper_device_rules():
    """CPU tensors take the plain version and count no launch; a device
    with no kernel raises instead of falling back."""
    symb = from_reference(_jax_symb("laplacian_7"))
    lv = next(iter(build_ea_plan(symb).levels.values())).to("cpu")
    pool = torch.ones(symb.pool_size, dtype=torch.float64)
    before = extend_add.launches
    extend_add(pool, lv)
    assert extend_add.launches == before
    expect = torch.ones(symb.pool_size, dtype=torch.float64)
    extend_add_plain(expect, lv)
    assert torch.equal(pool, expect)
    with pytest.raises(ValueError, match="no kernel"):
        extend_add(torch.ones(symb.pool_size, device="meta"), lv)
