"""The spread of a set of runs, from which the bounds of BENCHMARK.json are
set:

    python3 benchmarks/spread.py run1.out run2.out ...

Each file holds one run's standard output; its last line is the result.
For each metric it prints the median, the quartiles (Python's
``statistics.quantiles(values, n=4)``) and the spread, the distance
between the quartiles as a share of the median."""

import json
import statistics
import sys


def last_result(path):
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    return json.loads(lines[-1])


def spread(values):
    """(median, q1, q3, (q3 − q1) / median)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return med, q1, q3, (q3 - q1) / med


def main(paths):
    runs = [last_result(p) for p in paths]
    names = sorted({k for r in runs for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in runs
                if name in r["metrics"]]
        if len(vals) < 2:
            continue
        med, q1, q3, s = spread(vals)
        print(json.dumps({"metric": name, "n": len(vals), "median": med,
                          "q1": q1, "q3": q3, "spread": s,
                          "values": vals}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
