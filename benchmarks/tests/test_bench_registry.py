"""The benchmark finds every piece by name, and a configuration, a traffic
mix, an operation and a metric are added as new files plus new entries
without editing a file that is there.  BENCHMARK.json keeps to the
contract's shapes."""

import json
import re
import shutil
from pathlib import Path

import pytest

from harness.core import BENCH_DIR, Cell, Window, cell_metrics, load_json

ROOT = BENCH_DIR.parent
BENCH = load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmarks/run.py"]
    assert BENCH["paths"] == ["benchmarks"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmarks/") and (ROOT / c["file"]
                                                        ).is_file()
        body = load_json(ROOT / c["file"])
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = Cell.find(w["name"])       # every piece is found by name
        assert cell.limits()


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    per = {m["name"]: m for m in BENCH["per_layer"]}
    assert not set(e2e) & set(per) and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("w", [c["name"] for c in BENCH["workloads"]])
def test_each_cell_reports(w):
    e2e = [m["name"] for m in cell_metrics(BENCH, w, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = cell_metrics(BENCH, w, "per_layer")
    assert per
    for m in per:      # a per-layer metric moves a metric its cell reports
        assert m["moves"] in e2e


def test_add_pieces_as_new_files(tmp_path):
    """A dummy configuration, traffic mix, operation and metric join as new
    files and new entries; no file that is there changes."""
    bench_dir = tmp_path / BENCH_DIR.name
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads(json.dumps(BENCH))
    (bench_dir / "configs" / "dummy_cfg.json").write_text(json.dumps(
        {"name": "dummy_cfg", "source": "https://example.org/paper",
         "dtype": "float64", "size": 3, "reduced": []}))
    (bench_dir / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"op": "dummy_op", "requests_per_unit": 2,
         "limits": {"float64": {"err": 0.5}}}))
    (bench_dir / "ops" / "dummy_op.py").write_text(
        "def setup(cfg, params, seed, device, span):\n"
        "    with span('host_analysis'):\n"
        "        pass\n"
        "    return {'n': cfg['size'], 'k': params['requests_per_unit']}\n"
        "def reseed(state, seed):\n    pass\n"
        "def release(state):\n    pass\n"
        "def request(state, k):\n    return {'items': state['k']}\n"
        "def counters(state):\n    return {}\n"
        "def info(state):\n    return {}\n"
        "def check(state, seed, control=False):\n"
        "    return {'err': 0.25}\n")
    (bench_dir / "metrics" / "items_per_s.py").write_text(
        "def read(w):\n    return w.units['items'] / w.elapsed_s\n")
    (bench_dir / "metrics" / "dummy_layer.py").write_text(
        "def read(w):\n    return w.spans.get('host_analysis')\n")
    bench["configs"].append({"name": "dummy_cfg",
                             "source": "https://example.org/paper",
                             "file": "benchmarks/configs/dummy_cfg.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "items_per_s", "unit": "items/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.cell"]})
    bench["per_layer"].append({"name": "dummy_layer", "unit": "s",
                               "better": "lower", "source": "host_clock",
                               "layer": "dummy", "moves": "items_per_s",
                               "workloads": ["dummy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    import time
    import torch
    from harness.core import measure
    cell = Cell.find("dummy.cell", root=tmp_path)
    r = measure(cell, 5, 0.05, False, torch.device("cpu"),
                time.perf_counter())
    assert r["correct"] and r["checks"] == {"err": {"value": 0.25,
                                                    "limit": 0.5}}
    assert set(r["metrics"]) == {"setup_s", "items_per_s"}
    assert r["metrics"]["items_per_s"]["unit"] == "items/s"
    r = measure(cell, 5, 0.05, True, torch.device("cpu"),
                time.perf_counter())
    assert set(r["metrics"]) == {"host_analysis_s", "dummy_layer"}
    after = {p: p.read_bytes() for p in bench_dir.rglob("*")
             if p.is_file() and p in before}
    assert after == before
