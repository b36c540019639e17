"""The ``program_span`` metrics: each reader on synthetic traces worked by
hand (None without its spans, and None on the CPU where it counts CUDA
runtime events), whole traced runs of the small cells on the CPU, and the
one clock the program's spans share with the benchmark's window."""

import time

import numpy as np
import pytest
import torch

from harness import core
from harness.core import BENCH_DIR, Cell, Window, load_module, measure
from harness.trace import Trace, from_profiler

SMALL = {"lp224.mehrotra": {"n1": 12}, "lap48.refactor": {"side": 8},
         "lap48.solves": {"side": 8}, "lp224.kkt_solves": {"n1": 12}}
SEED = 2 ** 31 + 4093
IPM = ("kkt_build_s.ipm", "factor_s.ipm", "refined_solve_s.ipm",
       "fgmres_sweeps.ipm")
REFACTOR = ("factor_s.refactor",)
CARD_ONLY = ("host_syncs.ipm", "front_launches.refactor",
             "factor_idle.refactor")


def metric(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py")


def trace(host, dev=(), window_s=20.0):
    """host: (start, end, name); dev: (start, end)."""
    return Trace(window_s,
                 np.array([a for a, _ in dev], float),
                 np.array([b for _, b in dev], float), ["k"] * len(dev),
                 np.array([a for a, _, _ in host], float),
                 np.array([b for _, b, _ in host], float),
                 [n for _, _, n in host], [])


def window(tr, **units):
    return Window(workload="w", setup_s=1.0, elapsed_s=20.0, requests=1,
                  latencies_s=[20.0], units=units, spans={}, counters={},
                  info={}, trace=tr)


def test_span_seconds_and_counts():
    tr = trace([(1, 3, "el.kkt.finalize"), (11, 12, "el.kkt.finalize"),
                (3, 5, "el.ldl.factor"), (6, 6.5, "el.ldl.factor"),
                (7, 8, "el.kkt.solve_refined"),
                (8, 10, "el.kkt.solve_refined"),
                (8.5, 9, "el.ldl.solve"), (0, 2, "aten::mm")])
    w = window(tr, calls=2, iterations=4)
    assert metric("kkt_build_s.ipm").read(w) == pytest.approx(1.5)
    assert metric("factor_s.ipm").read(w) == pytest.approx(2.5 / 4)
    assert metric("refined_solve_s.ipm").read(w) == pytest.approx(3 / 4)
    assert metric("fgmres_sweeps.ipm").read(w) == pytest.approx(2 / 4)
    assert metric("factor_s.refactor").read(w) == pytest.approx(1.25)


@pytest.mark.parametrize("name", IPM + REFACTOR + CARD_ONLY)
def test_none_without_spans(name):
    tr = trace([(0, 1, "aten::mm"), (2, 3, "cudaLaunchKernel"),
                (4, 5, "cudaStreamSynchronize")], dev=[(0, 1)])
    units = dict(calls=1, iterations=6, refactors=2)
    assert metric(name).read(window(tr, **units)) is None
    assert metric(name).read(window(None, **units)) is None


@pytest.mark.parametrize("name", IPM)
def test_none_without_units(name):
    tr = trace([(0, 1, n) for n in ("el.kkt.finalize", "el.ldl.factor",
                                    "el.kkt.solve_refined")])
    assert metric(name).read(window(tr)) is None


def test_host_syncs_inside_iterations():
    host = [(0, 4, "el.lp.iteration"), (5, 9, "el.lp.iteration"),
            (1, 1.1, "cudaStreamSynchronize"),
            (2, 2.1, "cudaStreamSynchronize"),
            (2.5, 3, "el.ldl.factor"),                  # nested: once
            (2.6, 2.7, "cudaStreamSynchronize"),
            (4.5, 4.6, "cudaDeviceSynchronize"),        # between them
            (8.5, 8.6, "cudaEventSynchronize"),
            (1.5, 1.6, "cudaLaunchKernel"),             # not a wait
            (9.5, 9.6, "cudaStreamSynchronize")]        # after them
    w = window(trace(host), iterations=2)
    assert metric("host_syncs.ipm").read(w) == pytest.approx(4 / 2)
    cpu = [h for h in host if not h[2].startswith("cuda")]
    assert metric("host_syncs.ipm").read(window(trace(cpu),
                                                iterations=2)) is None


def test_front_launches_per_factor():
    host = [(0, 10, "el.ldl.factor"), (11, 19, "el.ldl.factor"),
            (1, 2, "el.ldl.front.rank1"), (3, 5, "el.ldl.front.blocked"),
            (12, 13, "el.ldl.front.spd"),
            (1.5, 1.6, "cudaLaunchKernel"), (4, 4.1, "cudaLaunchKernel"),
            (4.5, 4.6, "cudaLaunchKernelExC"), (3.5, 3.6, "cuLaunchKernel"),
            (12.5, 12.6, "cudaLaunchKernel"),
            (6, 6.1, "cudaLaunchKernel"),               # K1, outside
            (4.2, 4.3, "cudaMemcpyAsync")]              # not a launch
    w = window(trace(host), refactors=2)
    assert metric("front_launches.refactor").read(w) == pytest.approx(5 / 2)
    cpu = [h for h in host if not h[2].startswith("cu")]
    assert metric("front_launches.refactor").read(
        window(trace(cpu), refactors=2)) is None


def test_factor_idle_share():
    host = [(0, 4, "el.ldl.factor"), (6, 10, "el.ldl.factor"),
            (1, 3, "el.ldl.level")]
    dev = [(1, 2), (1.5, 1.8), (3, 7), (9, 12)]
    w = window(trace(host, dev), refactors=2)
    # busy inside the spans: [1, 2] + [3, 4] + [6, 7] + [9, 10] = 4 of 8
    assert metric("factor_idle.refactor").read(w) == pytest.approx(50.0)
    assert metric("factor_idle.refactor").read(
        window(trace(host), refactors=2)) is None       # no device


def test_merged_and_inside():
    spans = load_module(BENCH_DIR / "metrics" / "_spans.py")
    s, e = spans.merged(np.array([0.0, 1.0, 5.0, 6.0]),
                        np.array([4.0, 2.0, 7.0, 6.5]))
    assert s.tolist() == [0.0, 5.0] and e.tolist() == [4.0, 7.0]
    tr = trace([(0, 4, "a"), (1, 2, "a"), (5, 7, "a"), (3, 3, "x"),
                (4, 4, "x"), (6.9, 7, "x"), (-1, 0, "x")])
    w = window(tr)
    a = spans.intervals(w, spans.named("a"))
    assert spans.starting_inside(w, spans.named("x"), a) == 2


def run_traced(workload, monkeypatch):
    """A traced CPU run of a small cell: its result and its window."""
    windows = []

    def keep(*a, **kw):
        windows.append(Window(*a, **kw))
        return windows[-1]
    monkeypatch.setattr(core, "Window", keep)
    cell = Cell.find(workload, overrides=SMALL[workload])
    r = measure(cell, SEED, 0.3, True, torch.device("cpu"),
                time.perf_counter())
    return r, windows[0]


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_traced_small_cells(workload, monkeypatch):
    """The span-time metrics appear where their spans are; the CUDA
    counts and the device share do not on the CPU; every program span
    lies inside the benchmark's window, on its clock."""
    r, w = run_traced(workload, monkeypatch)
    assert r["correct"]
    want = {"lp224.mehrotra": set(IPM), "lap48.refactor": set(REFACTOR)}
    new = set(IPM + REFACTOR + CARD_ONLY)
    assert set(r["metrics"]) & new == want.get(workload, set())
    el = [i for i, n in enumerate(w.trace.host_name) if n.startswith("el.")]
    assert el
    s, e = w.trace.host_start[el], w.trace.host_end[el]
    assert s.min() >= 0 and e.max() <= w.trace.window_s
    if workload == "lp224.mehrotra":
        m = r["metrics"]
        assert m["fgmres_sweeps.ipm"]["value"] >= 2 * 7 / 6
        assert m["kkt_build_s.ipm"]["unit"] == "s/call"


def test_gap_under_a_program_span_takes_its_name():
    """The benchmark's window and a program span are read on one clock: a
    span that sleeps in the middle of the window lies inside it, and the
    idle gap there is labelled by the span."""
    from elemental_tpu_torch.core.profiling import profile_region
    from torch.profiler import ProfilerActivity, profile, record_function
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            for _ in range(10):
                x = x + 1
            with profile_region("el.sleep"):
                time.sleep(0.2)
            for _ in range(10):
                x = x + 1
    tr = from_profiler(prof)
    (i,) = [k for k, n in enumerate(tr.host_name) if n == "el.sleep"]
    assert 0 <= tr.host_start[i] < tr.host_end[i] <= tr.window_s
    assert tr.host_end[i] - tr.host_start[i] >= 0.2
    # no device here: the window is one gap, labelled at its middle
    assert tr.idle_gaps() == [["el.sleep", pytest.approx(tr.window_s)]]
