"""The ``lap48.dist_refactor`` cell on the CPU: its operation on a 2×2 grid
of CPU positions at a small side (both grid tiers lowered so that they take
levels) reads correct, traced and untraced; a refactor that keeps the old
factor and the control read not correct; and each of the cell's five per-layer
readers gives None on a window without its spans or counter and the right
number on a synthetic one."""

import time

import numpy as np
import pytest
import torch

from harness import core
from harness.core import BENCH_DIR, Cell, Spans, Window, load_module, measure
from harness.trace import Trace

CELL = "lap48.dist_refactor"
SMALL = {"side": 12, "dist_front_min": 96,
         "grid": {"height": 2, "width": 2, "devices": ["cpu"] * 4}}
CPU = torch.device("cpu")
SEED = 2 ** 31 + 1231
NEW = ("factor_s.dist_refactor", "dist_front_s.dist_refactor",
       "split_s.dist_refactor", "peer_gb.dist_refactor",
       "front_launches.dist_refactor")


@pytest.fixture(autouse=True)
def low_split(monkeypatch):
    """The batch split takes levels at the small side too."""
    from elemental_tpu_torch.sparse_direct import numeric
    monkeypatch.setattr(numeric, "SPLIT_MIN_WORK", 1e6)


def run(trace=False, seconds=0.3):
    cell = Cell.find(CELL, overrides=SMALL)
    return measure(cell, SEED, seconds, trace, CPU, time.perf_counter())


def test_cell_reads_correct():
    r = run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "solve_after_refactor_ms"}
    assert r["checks"]["x_err"]["value"] < 1e-12
    assert r["device"]["count"] == 4


def test_traced_cell_reports_the_grid_metrics():
    """On the CPU every new metric but the launch count (CUDA runtime
    events) is read; nothing leaves the one device."""
    r = run(trace=True)
    assert r["correct"] is True
    got = {k for k in r["metrics"] if k in NEW}
    assert got == set(NEW) - {"front_launches.dist_refactor"}
    assert r["metrics"]["peer_gb.dist_refactor"]["value"] == 0.0
    assert r["metrics"]["dist_front_s.dist_refactor"]["value"] > 0
    assert r["metrics"]["split_s.dist_refactor"]["value"] > 0
    assert "host_analysis_s" in r["metrics"]


def test_fault_refactor_keeps_the_old_factor(monkeypatch):
    """change_nonzero_values takes the values but does not refactor."""
    from elemental_tpu_torch.sparse_direct import facade

    def stale(self, new_vals):
        self.A = self.A.change_nonzero_values(new_vals)
        return self
    monkeypatch.setattr(facade.SparseLDLFactorization,
                        "change_nonzero_values", stale)
    assert run(seconds=0.5)["correct"] is False


def test_control_fails():
    """CG in float32, the precision below the configuration's, put in the
    program's place, fails the cell's check; the program passes it."""
    cell = Cell.find(CELL, overrides=SMALL)
    limits = cell.limits()
    state = cell.op.setup(cell.config, cell.traffic, SEED, CPU, Spans())
    for k in range(cell.traffic["check_requests"]):
        cell.op.request(state, k)
    cell.op.release(state)
    assert cell.op.check(state, SEED)["x_err"] <= limits["x_err"]
    assert cell.op.check(state, SEED, control=True)["x_err"] > limits["x_err"]


def metric(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def window(host=(), refactors=0, counters=None):
    tr = Trace(20.0, np.zeros(0), np.zeros(0), [],
               np.array([a for a, _, _ in host], float),
               np.array([b for _, b, _ in host], float),
               [n for _, _, n in host], [])
    units = {"refactors": refactors} if refactors else {}
    return Window(workload=CELL, setup_s=1.0, elapsed_s=20.0, requests=1,
                  latencies_s=[20.0], units=units, spans={},
                  counters=counters or {}, info={}, trace=tr)


@pytest.mark.parametrize("name", NEW)
def test_none_without_spans_or_counter(name):
    assert metric(name).read(window(refactors=2)) is None
    assert metric(name).read(window([(0, 1, "aten::mm")], 2,
                                    {"k1_launches": 5})) is None


def test_readers_on_a_synthetic_window():
    host = [(0, 10, "el.ldl.factor"), (11, 19, "el.ldl.factor"),
            (1, 3, "el.ldl.front.dist"), (4, 4.5, "el.ldl.front.dist"),
            (12, 14, "el.ldl.front.dist"), (5, 6, "el.ldl.front.split"),
            (15, 16.5, "el.ldl.front.split"),
            (7, 8, "el.ldl.front.blocked"),
            (1.2, 1.3, "el.ldl.dist.gather"),
            (2, 2.1, "cudaLaunchKernel"), (5.5, 5.6, "cuLaunchKernel"),
            (7.5, 7.6, "cudaLaunchKernelExC"),
            (9, 9.1, "cudaLaunchKernel"),              # outside the fronts
            (15.5, 15.6, "cudaMemcpyAsync")]           # not a launch
    w = window(host, 2, {"peer_bytes": 3.0e9})
    assert metric("factor_s.dist_refactor").read(w) == pytest.approx(9.0)
    assert metric("dist_front_s.dist_refactor").read(w) == pytest.approx(
        4.5 / 2)
    assert metric("split_s.dist_refactor").read(w) == pytest.approx(2.5 / 2)
    assert metric("peer_gb.dist_refactor").read(w) == pytest.approx(1.5)
    assert metric("front_launches.dist_refactor").read(w) == pytest.approx(
        3 / 2)
    cpu = [h for h in host if not h[2].startswith("cu")]
    assert metric("front_launches.dist_refactor").read(
        window(cpu, 2)) is None


def test_window_counts_peer_bytes(monkeypatch):
    """The op's counter is the program's, and the window's delta is what
    the reader divides."""
    windows = []

    def keep(*a, **kw):
        windows.append(Window(*a, **kw))
        return windows[-1]
    monkeypatch.setattr(core, "Window", keep)
    run()
    assert windows[0].counters["peer_bytes"] == 0
