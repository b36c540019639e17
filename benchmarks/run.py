"""Run one cell of the benchmark of ``elemental_tpu_torch`` once:

    python3 benchmarks/run.py --workload lap48.solves --seed 7 \
        --seconds 30 --trace 0

It sets up (inputs from the seed, host analysis, warm-up of the cell's
shapes), measures for ``--seconds``, checks what the timed path produced
against ``benchmarks/reference`` and prints one JSON line last on standard
output; the numbers compared, each beside its limit, are the last lines on
standard error.  ``--trace 1`` is a run of its own under ``torch.profiler``
and reports the per-layer metrics.  Without a CUDA card it exits with 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache at a fixed place inside the checkout, so only a checkout's
# first run builds (the port's own libraries go to its ``_build/``)
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
os.environ["USE_FLAX"] = "0"
for p in (str(ROOT), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "elemental_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``elemental_tpu_torch`` is not ``elemental_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out[0] if out else "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.core import Cell, measure
    cell = Cell.find(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found {found}: "
              f"no result", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: no result", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks               # the last key of the line
    print(json.dumps(result), flush=True)
    print(f"correct {str(result['correct']).lower()}", file=sys.stderr)
    for name, c in checks.items():       # the last lines: each number
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
