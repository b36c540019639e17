"""The port's own spans (``core.profiling``): an inactive region is one
shared null context that records nothing; under a CPU ``torch.profiler``
the IPM and multifrontal layers open their ``el.*`` spans with the counts
and nesting the benchmark's ``program_span`` metrics read; results keep
their bits with the profiler on; NVTX ranges only under an explicit
``enable_profiling(True)``.  No JAX."""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from elemental_tpu_torch.core import Grid
from elemental_tpu_torch.core import profiling
from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_3d
from elemental_tpu_torch.optimization import LPCtrl, lp_direct
from elemental_tpu_torch.optimization.kkt import KKTBuilder
from elemental_tpu_torch.sparse import DistSparseMatrix
from elemental_tpu_torch.sparse_direct import (DistSparseLDLFactorization,
                                               SparseLDLFactorization,
                                               nested_dissection, numeric)

CPU = torch.device("cpu")
F64 = torch.float64


def traced(fn):
    """Run ``fn`` under a CPU profiler; its result and the ``el.*`` spans
    as (name, start ns, end ns), by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("el.")]
    return out, sorted(spans, key=lambda v: v[1])


def named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def inside(inner, outer):
    """Each interval of ``inner`` lies in one of ``outer``."""
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def lp_case(seed=0):
    A = concat_fd_2d(12, 12)
    rng = np.random.default_rng(seed)
    x0 = np.abs(rng.standard_normal(A.width)) + 0.1
    b = A.to_scipy() @ x0
    c = np.abs(rng.standard_normal(A.width)) + 0.5
    return A, b, c


def run_lp():
    A, b, c = lp_case()
    return lp_direct(A, b, c, LPCtrl(max_iters=3), device=CPU, dtype=F64)


def test_inactive_region_is_the_shared_null_context():
    assert not profiling._enabled        # the default
    profiling.reset_stage_times()
    r1, r2 = profiling.profile_region("el.a"), profiling.profile_region("b")
    assert r1 is r2 is profiling._NULL
    with r1:
        with profiling.profile_region("el.c"):
            pass
    assert profiling.stage_times() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        active = profiling.profile_region("el.a")
        assert active is not profiling._NULL
        with active:
            pass
    assert set(profiling.stage_times()) == {"el.a"}
    profiling.reset_stage_times()
    # a host operator, not a user annotation (which the profiler projects
    # onto the device timeline)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "el.a"]
    if hasattr(ev, "activity_type"):
        assert ev.activity_type() == "cpu_op"


def test_lp_direct_spans():
    res, spans = traced(run_lp)
    counts = Counter(n for n, _, _ in spans)
    it = res.iterations
    assert it == 3
    call = named(spans, "el.lp.call")
    assert len(call) == 1
    for child in ("el.kkt.finalize", "el.lp.scale", "el.lp.start"):
        assert counts[child] == 1 and inside(named(spans, child), call)
    # the ordering comes from the call itself here (LPCtrl.ordering None)
    for host in ("el.ordering.nested_dissection", "el.symbolic.analyze",
                 "el.ea_plan.build"):
        assert counts[host] == 1
        assert inside(named(spans, host), named(spans, "el.kkt.finalize"))
    assert counts["el.lp.iteration"] == it
    assert inside(named(spans, "el.lp.iteration"), call)
    retakes = counts["el.kkt.factor_retake"]
    assert counts["el.ldl.factor"] == it + 1 + retakes
    assert counts["el.kkt.prepare"] == it + 1
    assert inside(named(spans, "el.ldl.factor"),
                  named(spans, "el.kkt.prepare"))
    assert inside(named(spans, "el.kkt.equilibrate"),
                  named(spans, "el.kkt.prepare"))
    assert counts["el.kkt.solve_refined"] >= 2 * (it + 1)
    assert counts["el.ldl.solve_context"] == it + 1
    assert inside(named(spans, "el.ldl.solve"),
                  named(spans, "el.kkt.solve_refined"))
    # the iterations and the start hold every factor and refined solve
    steps = named(spans, "el.lp.iteration") + named(spans, "el.lp.start")
    assert inside(named(spans, "el.ldl.factor"), steps)
    assert inside(named(spans, "el.kkt.solve_refined"), steps)


def test_factor_retake_span():
    """A KKT whose first pivot cancels to exactly zero is factored again
    with the regularization as floors: one retake span, its factor inside
    it, both inside the one prepare."""
    kb = KKTBuilder(2)
    kb.add_static([0, 1], [1, 0], [1.0, 1.0])
    kb.add_static([0, 1], [0, 1], [-1e-3, 1.0])
    kb.add_regularization([0], [1e-3])
    kkt = kb.finalize(perm=np.array([0, 1]), device=CPU, dtype=F64)
    fact, spans = traced(lambda: kkt.prepare(kkt.assemble([]),
                                             equilibrate=False))
    assert float(fact.d.abs().min()) > 0
    prep = named(spans, "el.kkt.prepare")
    retake = named(spans, "el.kkt.factor_retake")
    factors = named(spans, "el.ldl.factor")
    assert len(prep) == 1 and len(retake) == 1 and len(factors) == 2
    assert inside(retake, prep) and inside(factors, prep)
    assert sum(inside([f], retake) for f in factors) == 1


def expected_kind(lev, grid, spd, dist_front_min, split_min):
    """The front kernel a level takes, by ``numeric.factor``'s rule."""
    nf, S = lev.sn_ids.shape[0], lev.front_size
    if grid is not None and S >= dist_front_min and nf <= 8:
        return "dist"
    if grid is not None and nf >= grid.size and nf * S ** 3 >= split_min:
        return "split"
    return "spd" if spd else "blocked"


@pytest.fixture(scope="module")
def lap8():
    A = sparse_laplacian_3d(8, 8, 8, scaled=False)
    return A, nested_dissection(A, cutoff=32)


@pytest.mark.parametrize("spd, on_grid", [(False, False), (True, False),
                                          (True, True)])
def test_factor_and_solve_spans(lap8, spd, on_grid, monkeypatch):
    """One level span per level, one front span inside each, of the kind
    the level's kernel rule gives; K1's span on the levels with children;
    one forward and one backward level step a level in a solve."""
    A, perm = lap8
    grid = split_min = None
    dist_front_min = numeric.DIST_FRONT_MIN
    if on_grid:
        grid, split_min, dist_front_min = Grid([CPU] * 4, height=2), 1.0, 64
        monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", split_min)
        f = DistSparseLDLFactorization(dtype=F64, spd=spd,
                                       dist_front_min=dist_front_min)
        f.initialize(DistSparseMatrix.from_sparse(A, grid), perm=perm)
    else:
        f = SparseLDLFactorization(device=CPU, dtype=F64, spd=spd)
        f.initialize(A, perm=perm)
    _, spans = traced(f.factor)
    levels = f.symb.levels
    assert len(named(spans, "el.ldl.factor")) == 1
    assert len(named(spans, "el.ldl.assemble")) == 1
    lv = named(spans, "el.ldl.level")
    assert len(lv) == len(levels)
    fronts = [(n, s, e) for n, s, e in spans
              if n.startswith("el.ldl.front.")]
    kinds = [n[len("el.ldl.front."):] for n, _, _ in fronts]
    assert kinds == [expected_kind(lev, grid, spd, dist_front_min,
                                   split_min) for lev in levels]
    assert all(inside([(s, e)], [v]) for (_, s, e), v in zip(fronts, lv))
    ea = named(spans, "el.ldl.extend_add")
    assert len(ea) == len(f.ea_plan.levels) and inside(ea, lv)
    if on_grid:
        assert {"dist", "split"} <= set(kinds)
    else:
        assert set(kinds) == ({"spd"} if spd else {"blocked"})

    b = np.random.default_rng(1).standard_normal(A.height)
    _, spans = traced(lambda: f.solve(b))
    assert len(named(spans, "el.ldl.solve")) == 1
    for d in ("forward", "backward"):
        steps = named(spans, f"el.ldl.solve.{d}")
        assert len(steps) == len(levels)
        assert inside(steps, named(spans, "el.ldl.solve"))


def test_bits_equal_with_the_profiler(lap8):
    plain = run_lp()
    got, _ = traced(run_lp)
    for key in ("x", "y", "z"):
        assert np.array_equal(getattr(plain, key), getattr(got, key))
    assert plain.objective == got.objective
    A, perm = lap8
    b = np.random.default_rng(2).standard_normal(A.height)
    f = SparseLDLFactorization(device=CPU, dtype=F64).initialize(A, perm=perm)
    x0 = f.factor().solve(b)
    pool0 = f.numeric.pool.clone()
    x1, _ = traced(lambda: f.factor().solve(b))
    assert torch.equal(pool0, f.numeric.pool) and torch.equal(x0, x1)


def test_nvtx_only_when_enabled(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.profile_region("el.a"):
            pass
    assert calls == []
    monkeypatch.setattr(profiling, "_enabled", True)
    with profiling.profile_region("el.b"):
        pass
    assert calls == [("push", "el.b"), ("pop",)]
    profiling.reset_stage_times()
