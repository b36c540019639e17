"""One run of one cell: find its pieces by name, set up, measure the window,
read the metrics, check the outputs against the plain reference.

Every piece is found by the name ``BENCHMARK.json`` gives it, so a later
change adds a configuration, a traffic mix, an operation or a metric as new
files and new entries, never by editing a file that is here:

* ``configs/<config>.json`` (the entry's ``file``): the configuration;
* ``traffic/<traffic>.json``: the mix's parameters, its ``op`` and the
  limits of its checks, by dtype;
* ``ops/<op>.py``: ``setup``, ``request``, ``counters`` and ``check`` of one
  way of driving the program;
* ``metrics/<metric>.py``: ``read(window)`` of one metric, a number or
  None where the window holds nothing to read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Window:
    """What one run measured, as the metric readers see it."""
    workload: str
    setup_s: float
    elapsed_s: float
    requests: int
    latencies_s: List[float]
    units: Dict[str, float]          # counts the requests returned, summed
    spans: Dict[str, float]          # the set-up's spans, seconds
    counters: Dict[str, float]       # program counters, window deltas
    info: Dict[str, object]          # the operation's static facts
    trace: Optional[object] = None   # harness.trace.Trace, traced runs
    peaks: Optional[object] = None   # harness.peaks.Peaks of the card


class Spans:
    """The benchmark's own host spans (set-up and window), by name; inside
    a traced window each also becomes a ``bench.<name>`` profiler range."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(f"bench.{name}")
        t0 = time.perf_counter()
        with rf:
            yield
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import one file of the benchmark by its path (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"benchmark piece not found: {path}")
    name = "bench_" + "_".join(path.parts[-2:])
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(bench: dict, workload: str, kind: str) -> List[dict]:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") a cell
    reports: those without ``workloads``, and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


@dataclasses.dataclass
class Cell:
    bench: dict
    workload: dict
    config: dict
    traffic: dict
    op: object
    bench_dir: Path = BENCH_DIR

    @classmethod
    def find(cls, workload: str, root: Path = ROOT,
             overrides: Optional[dict] = None) -> "Cell":
        bench = load_json(root / "BENCHMARK.json")
        cell = by_name(bench["workloads"], workload, "workload")
        entry = by_name(bench["configs"], cell["config"], "config")
        config = dict(load_json(root / entry["file"]), **(overrides or {}))
        bench_dir = root / BENCH_DIR.name
        traffic = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
        op = load_module(bench_dir / "ops" / f"{traffic['op']}.py")
        return cls(bench, cell, config, traffic, op, bench_dir)

    def metric(self, name: str):
        return load_module(self.bench_dir / "metrics" / f"{name}.py")

    def limits(self) -> Dict[str, float]:
        return self.traffic["limits"][self.config["dtype"]]


def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, log=sys.stderr) -> dict:
    """Set up, run the window and check; returns the result line's object
    with the checks under ``checks`` (the last key)."""
    import torch
    spans = Spans()
    state = cell.op.setup(cell.config, cell.traffic, seed, device, spans)
    synchronize(device)
    setup_s = time.perf_counter() - t_start
    before = cell.op.counters(state)

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        spans.profiling = True
    if trace:       # the mix may trace a shorter window (trace_seconds)
        seconds = min(seconds, cell.traffic.get("trace_seconds", seconds))
    latencies, units, failed = [], {}, 0
    from torch.profiler import record_function
    window = record_function("bench.window") if trace else \
        contextlib.nullcontext()
    with window:
        t0 = time.perf_counter()
        k = 0
        while True:
            t_req = time.perf_counter()
            try:
                with spans("request"):
                    got = cell.op.request(state, k)
            except Exception:          # a request that fails is counted
                traceback.print_exc(file=log)
                failed += 1
                break
            latencies.append(time.perf_counter() - t_req)
            for key, v in got.items():
                units[key] = units.get(key, 0) + v
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        elapsed = time.perf_counter() - t0
    spans.profiling = False
    if prof is not None:
        prof.stop()
    after = cell.op.counters(state)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    from . import peaks as peaks_mod, trace as trace_mod
    tr = None
    if prof is not None:
        t_read = time.perf_counter()
        tr = trace_mod.from_profiler(prof)
        print(f"trace: {len(tr.dev_name)} device operations, "
              f"{len(tr.host_name)} host events, read in "
              f"{time.perf_counter() - t_read:.1f} s", file=log)
    del prof
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    w = Window(cell.workload["name"], setup_s, elapsed, len(latencies),
               latencies, units, dict(spans.seconds),
               {key: after[key] - before.get(key, 0) for key in after},
               cell.op.info(state), tr,
               peaks_mod.peaks_for(name) if on_card else None)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(cell.bench, w.workload, kind):
        v = cell.metric(m["name"]).read(w)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": int(cell.workload["chips"]),
                   "memory_peak_bytes": int(peak)}
    out = {"attempted": len(latencies) + failed, "failed": failed,
           "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    del w, tr

    limits = cell.limits()
    cell.op.release(state)
    readings = cell.op.check(state, seed)
    checks = {}
    for key, value in readings.items():
        checks[key] = {"value": float(value), "limit": float(limits[key])}
    ok = (failed == 0 and len(latencies) > 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    return {"correct": ok, **out, "checks": checks}
