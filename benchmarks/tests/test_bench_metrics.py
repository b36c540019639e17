"""The metric arithmetic, on synthetic windows and intervals worked by
hand: the idle share, the window rule, the 95th percentile's rank and K1's
value bytes."""

import numpy as np
import pytest

from harness.core import BENCH_DIR, Window, load_module
from harness.peaks import H100_SXM, least_seconds, peaks_for
from harness.trace import Trace, busy_union, gaps


def metric(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def trace(intervals, window_s, names=None, host=()):
    s = np.array([a for a, _ in intervals], float)
    e = np.array([b for _, b in intervals], float)
    names = names or ["k"] * len(intervals)
    hs = np.array([a for a, _, _ in host], float)
    he = np.array([b for _, b, _ in host], float)
    return Trace(window_s, s, e, list(names), hs, he,
                 [n for _, _, n in host], [])


def window(**kw):
    base = dict(workload="w", setup_s=12.5, elapsed_s=10.0, requests=4,
                latencies_s=[2.5] * 4, units={}, spans={}, counters={},
                info={})
    base.update(kw)
    return Window(**base)


@pytest.mark.parametrize("intervals, lo, hi, busy", [
    ([], 0, 10, 0.0),
    ([(1, 2), (3, 5)], 0, 10, 3.0),
    ([(1, 4), (2, 3), (3.5, 6)], 0, 10, 5.0),      # nested and overlapping
    ([(-2, 1), (9, 12)], 0, 10, 2.0),              # clipped to the window
    ([(0, 10), (1, 2)], 0, 10, 10.0),
])
def test_busy_union(intervals, lo, hi, busy):
    s = [a for a, _ in intervals]
    e = [b for _, b in intervals]
    assert busy_union(np.array(s), np.array(e), lo, hi) == pytest.approx(busy)


def test_gaps():
    s, e = gaps(np.array([1.0, 3.0, 2.5]), np.array([2.0, 5.0, 3.5]), 0, 10)
    assert s.tolist() == [0.0, 2.0, 5.0] and e.tolist() == [1.0, 2.5, 10.0]


def test_idle_share():
    w = window(units={"solves": 4},
               trace=trace([(1, 2), (3, 5), (4, 6)], 10.0))
    # busy 1 + 3 = 4 of 10 s
    assert metric("device_idle.solve").read(w) == pytest.approx(60.0)
    assert metric("device_idle.refactor").read(w) is None   # no refactors
    assert metric("device_idle.solve").read(window(units={"solves": 4})) \
        is None                                              # untraced


def test_idle_gap_labels():
    host = [(0.0, 10.0, "aten::outer"), (2.0, 2.9, "aten::inner")]
    tr = trace([(0, 2), (3, 10)], 10.0, host=host)
    assert tr.idle_gaps() == [["aten::inner", pytest.approx(1.0)]]


def test_window_rule():
    """A rate is all the window's work over all its time."""
    w = window(elapsed_s=31.0, requests=3, units={"iterations": 18,
                                                  "calls": 3})
    assert metric("ipm_iter_s").read(w) == pytest.approx(31.0 / 18)
    w = window(elapsed_s=30.5, requests=122, units={"refactors": 122})
    assert metric("refactor_wall_s").read(w) == pytest.approx(0.25)
    assert metric("solve_after_refactor_ms").read(w) is None
    w = window(units={"refactors": 4, "solve_after_refactor_s": 0.5})
    assert metric("solve_after_refactor_ms").read(w) == pytest.approx(125.0)
    w = window(elapsed_s=30.0, requests=400, units={"solves": 400})
    assert metric("solve_ms").read(w) == pytest.approx(75.0)
    assert metric("setup_s").read(w) == 12.5
    assert metric("ipm_iter_s").read(w) is None


@pytest.mark.parametrize("n, rank", [(1, 1), (19, 19), (20, 19), (200, 190),
                                     (201, 191)])
def test_p95_nearest_rank(n, rank):
    lat = list(np.random.default_rng(n).permutation(np.arange(1, n + 1)))
    w = window(latencies_s=[v / 1e3 for v in lat], units={"solves": n})
    assert metric("solve_p95_ms").read(w) == pytest.approx(rank)


def test_kernels_per_unit():
    tr = trace([(0, 1), (2, 3), (4, 5), (11, 12)], 10.0)   # one outside
    w = window(units={"iterations": 3, "solves": 1, "refactors": 2},
               trace=tr)
    assert metric("kernels_per_iter.ipm").read(w) == pytest.approx(1.0)
    assert metric("kernels_per_solve").read(w) == pytest.approx(3.0)
    assert metric("kernels_per_factor.refactor").read(w) == \
        pytest.approx(1.5)


def test_k1_bytes_hand_count():
    k1 = load_module(BENCH_DIR / "metrics" / "_k1.py")
    # level 1: 10 pairs into 4 destinations; level 2: 6 pairs into 6
    levels = [(10, 4), (6, 6)]
    assert k1.values_bytes(levels, 4) == (10 * 4 + 2 * 4 * 4) + \
        (6 * 4 + 2 * 6 * 4)
    assert k1.values_bytes(levels, 8) == 2 * k1.values_bytes(levels, 4)


def test_k1_bytes_of_a_run_plan():
    """On a real plan of a small pattern: pairs are the sources read once,
    destinations the unique entries written."""
    from elemental_tpu_torch.sparse import SparseMatrix
    from elemental_tpu_torch.sparse_direct import (analyze, build_ea_plan,
                                                   nested_dissection)
    from reference import lap3d
    A = SparseMatrix.from_scipy(lap3d.laplacian(6))
    plan = build_ea_plan(analyze(A, perm=nested_dissection(A, cutoff=8)))
    k1 = load_module(BENCH_DIR / "metrics" / "_k1.py")
    levels = [(lv.n_pairs, lv.n_dest) for lv in plan.levels.values()]
    hand = 0
    for lv in plan.levels.values():
        dst = np.asarray(lv.dst)
        hand += 8 * dst.size + 2 * 8 * np.unique(dst).size
    assert k1.values_bytes(levels, 8) == hand


def test_k1_roofline():
    names = ["void extend_add_kernel<double, int>", "other"]
    tr = trace([(0, 2e-3), (3, 4)], 10.0, names=names)
    levels = [(1_000_000, 250_000)]
    w = window(units={"refactors": 2}, trace=tr, peaks=H100_SXM,
               counters={"k1_launches": 2},
               info={"k1_levels": levels, "itemsize": 8})
    per_factor = 1_000_000 * 8 + 2 * 250_000 * 8
    want = 100 * 2 * per_factor / 3.35e12 / 2e-3
    assert metric("k1_roofline.refactor").read(w) == pytest.approx(want)
    assert metric("k1_roofline.ipm").read(w) is None        # no iterations
    w.counters = {"k1_launches": 0}
    assert metric("k1_roofline.refactor").read(w) is None


def test_peaks():
    assert peaks_for("NVIDIA H100 80GB HBM3") is H100_SXM
    with pytest.raises(LookupError):
        peaks_for("NVIDIA A100-SXM4-80GB")
    assert least_seconds(H100_SXM, 3.35e12) == pytest.approx(1.0)
    assert least_seconds(H100_SXM, 0, 67e12, "float64") == pytest.approx(1.0)


def test_spread_by_hand():
    spread = load_module(BENCH_DIR / "spread.py").spread
    # exclusive quartiles of 1..8: 2.25 and 6.75; median 4.5
    med, q1, q3, s = spread([8, 1, 7, 2, 6, 3, 5, 4])
    assert (med, q1, q3) == (4.5, 2.25, 6.75) and s == pytest.approx(1.0)


class _OldEvent:
    """A kineto event of a torch release without ``activity_type``."""

    def __init__(self, name, cuda, start_us, dur_us):
        self._n, self._c, self._s, self._d = name, cuda, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return "cuda" if self._c else "cpu"

    def start_us(self):
        return self._s

    def duration_us(self):
        return self._d


def test_trace_from_old_events():
    from harness.trace import from_events
    ev = [_OldEvent("bench.window", False, 100, 1000),
          _OldEvent("bench.window", True, 100, 1000),   # its device range
          _OldEvent("bench.request", False, 100, 900),
          _OldEvent("aten::mm", False, 150, 50),
          _OldEvent("void gemm_kernel", True, 300, 200),
          _OldEvent("Memcpy HtoD", True, 600, 100)]
    tr = from_events(ev, "cuda")
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.dev_name == ["void gemm_kernel", "Memcpy HtoD"]
    assert tr.busy_s() == pytest.approx(3e-4)
    assert tr.spans == [("request", 0.0, pytest.approx(9e-4))]
    assert tr.host_name == ["aten::mm"]


def test_innermost_open_event():
    from harness.trace import innermost
    starts = np.array([2.0, 0.0, 1.0])
    ends = np.array([3.0, 10.0, 4.0])
    names = ["C", "A", "B"]
    got = innermost(starts, ends, names, np.array([0.5, 2.5, 3.5, 5.0, 11.0]))
    assert got == ["A", "C", "B", "A", "python (no operator)"]
