"""Whole runs of each cell on the CPU at small sizes: the result line's
schema, the checks as they decide ``correct``, the faults each cell can
have (which must come out not correct), the controls (the reference in
the precision below the configuration's, which must fail a check), and a
run without a card or without the program, which prints no result."""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from harness.core import BENCH_DIR, Cell, Spans, measure

ROOT = BENCH_DIR.parent
SMALL = {"lp224.mehrotra": {"n1": 12}, "lp224.kkt_solves": {"n1": 12},
         "lap48.refactor": {"side": 8}, "lap48.solves": {"side": 8}}
CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def run(workload, trace=False, seconds=0.3, seed=SEED):
    cell = Cell.find(workload, overrides=SMALL[workload])
    return measure(cell, seed, seconds, trace, CPU, time.perf_counter())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_result_line(workload):
    r = run(workload)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device",
                       "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(r["metrics"]) == want
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("workload", ["lap48.solves", "lp224.mehrotra"])
def test_traced_result_line(workload):
    r = run(workload, trace=True)
    assert r["correct"] and "breakdown" in r and list(r)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "host_analysis_s" in r["metrics"]       # no device here: the
    assert not any(k.startswith("device_idle") for k in r["metrics"])


def _alter_answer(monkeypatch, cls, name):
    orig = getattr(cls, name)

    def altered(self, *a, **kw):
        x = orig(self, *a, **kw).clone()
        x[0] += 1.0
        return x
    monkeypatch.setattr(cls, name, altered)


def test_fault_solve_answer_altered(monkeypatch):
    from elemental_tpu_torch.sparse_direct.numeric import LDLFactorization
    _alter_answer(monkeypatch, LDLFactorization, "solve")
    assert run("lap48.solves")["correct"] is False


def test_fault_refactor_answer_altered(monkeypatch):
    from elemental_tpu_torch.sparse_direct.numeric import LDLFactorization
    _alter_answer(monkeypatch, LDLFactorization, "solve")
    assert run("lap48.refactor")["correct"] is False


def test_fault_refactor_state_unchanged(monkeypatch):
    """change_nonzero_values takes the values but does not refactor."""
    from elemental_tpu_torch.sparse_direct import facade

    def stale(self, new_vals):
        self.A = self.A.change_nonzero_values(new_vals)
        return self
    monkeypatch.setattr(facade.SparseLDLFactorization,
                        "change_nonzero_values", stale)
    assert run("lap48.refactor", seconds=0.5)["correct"] is False


def test_fault_kkt_answer_altered(monkeypatch):
    from elemental_tpu_torch.optimization.kkt import KKTFactor
    _alter_answer(monkeypatch, KKTFactor, "solve_refined")
    assert run("lp224.kkt_solves")["correct"] is False


def test_fault_ipm_step_unchanged(monkeypatch):
    """Every IPM step returns the iterate it was given."""
    from elemental_tpu_torch.optimization import lp
    monkeypatch.setattr(lp, "_steplen",
                        lambda v, dv, tau: torch.zeros((), dtype=v.dtype))
    assert run("lp224.mehrotra")["correct"] is False


def test_fault_ipm_answer_altered(monkeypatch):
    from elemental_tpu_torch.optimization import lp
    orig = lp.lp_direct

    def altered(*a, **kw):
        res = orig(*a, **kw)
        res.x = res.x.copy()
        res.x[0] += 1.0
        return res
    monkeypatch.setattr(lp, "lp_direct", altered)
    import elemental_tpu_torch.optimization as opt
    monkeypatch.setattr(opt, "lp_direct", altered)
    assert run("lp224.mehrotra")["correct"] is False


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_control_fails(workload):
    """The reference computed in the precision below the configuration's,
    put in the program's place, fails one of the cell's checks; the
    program passes them all."""
    cell = Cell.find(workload, overrides=SMALL[workload])
    limits = cell.limits()
    state = cell.op.setup(cell.config, cell.traffic, SEED, CPU, Spans())
    n = cell.traffic.get("check_requests", cell.traffic.get("check_calls"))
    for k in range(n):
        cell.op.request(state, k)
    program = cell.op.check(state, SEED)
    control = cell.op.check(state, SEED, control=True)
    assert all(program[k] <= limits[k] for k in limits)
    assert any(control[k] > limits[k] for k in limits)


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "lap48.solves",
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, **(env or {})))


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run_py(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / BENCH_DIR.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path, env={"PYTHONPATH": ""})
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_card():
    """A whole run of the smallest cell on the card, at its small size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = Cell.find("lap48.solves", overrides=SMALL["lap48.solves"])
    r = measure(cell, SEED, 1.0, False, torch.device("cuda", 0),
                time.perf_counter())
    assert r["correct"] and r["device"]["platform"] == "gpu"
