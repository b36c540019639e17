#!/usr/bin/env python3
"""One traced run of a benchmark cell, read by the program's own spans
(the ``el.*`` ranges that ``elemental_tpu_torch.core.profiling`` opens while
a profiler records):

- each span name with its count and summed seconds;
- the window's idle time by the innermost ``el.*`` span open at the middle
  of each gap, and the share of idle time the harness's own label (the
  innermost host event) leaves to Python outside any operator or to a bare
  ``el.lp.call``;
- the share of each ``el.lp.call``'s time that its named children cover;
- the CUDA runtime and driver events by name, in all and inside the
  ``el.lp.iteration`` and ``el.ldl.front.*`` spans (the events that
  ``host_syncs.ipm`` and ``front_launches.refactor`` count).

    python3 tools/span_breakdown.py --workload lap48.refactor --seed 7 \\
        --seconds 30

The run is the harness's traced run (``benchmarks/run.py --trace 1``):
the mix's ``trace_seconds`` cut ``--seconds``.  Prints one JSON object;
needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
CHILDREN = ("el.kkt.finalize", "el.lp.scale", "el.lp.start",
            "el.lp.iteration")
NO_SPAN = "(no el. span)"


def run_traced(cell, seed, seconds, device, t_start):
    """The harness's traced run; returns its result and its window."""
    from harness import core
    windows = []
    made = core.Window

    def window(*a, **kw):
        windows.append(made(*a, **kw))
        return windows[-1]
    core.Window = window
    try:
        result = core.measure(cell, seed, seconds, True, device, t_start)
    finally:
        core.Window = made
    return result, windows[0]


def breakdown(w) -> dict:
    """What the spans say of one traced window ``w``."""
    import numpy as np
    from harness.trace import gaps, innermost
    from metrics import _spans
    tr = w.trace
    el = _spans.events(tr, lambda n: n.startswith("el."))
    es, ee = tr.host_start[el], tr.host_end[el]
    en = [n for n, m in zip(tr.host_name, el.tolist()) if m]
    count, secs = Counter(en), defaultdict(float)
    for n, d in zip(en, (ee - es).tolist()):
        secs[n] += d
    spans = {n: {"count": c, "seconds": secs[n]}
             for n, c in count.most_common()}

    gs, ge = gaps(tr.dev_start, tr.dev_end, 0.0, tr.window_s)
    mids, length = 0.5 * (gs + ge), (ge - gs).tolist()
    by_span = defaultdict(float)
    for label, t in zip(innermost(es, ee, en, mids), length):
        by_span[NO_SPAN if label == "python (no operator)" else label] += t
    idle = float(sum(length))
    bare = sum(t for label, t in zip(
        innermost(tr.host_start, tr.host_end, tr.host_name, mids), length)
        if label in ("python (no operator)", "el.lp.call"))

    covered = []
    call = _spans.intervals(w, _spans.named("el.lp.call"))
    kids = _spans.intervals(w, CHILDREN.__contains__)
    if call is not None:
        for a, b in zip(*call):
            if kids is None:
                covered.append(0.0)
                continue
            s = np.clip(kids[0], a, b)
            e = np.clip(kids[1], a, b)
            ms, me = _spans.merged(s, e)
            covered.append(float(np.sum(me - ms)) / (b - a))

    cuda = {"all": Counter(n for n in tr.host_name if n.startswith("cu"))}
    for key, match in (("in el.lp.iteration", _spans.named(
            "el.lp.iteration")), ("in el.ldl.front.*",
                                  lambda n: n.startswith("el.ldl.front."))):
        span = _spans.intervals(w, match)
        if span is None:
            continue
        ms, me = _spans.merged(*span)
        inside = Counter()
        for n in cuda["all"]:
            got = _spans.starting_inside(w, _spans.named(n), (ms, me))
            if got:
                inside[n] = got
        cuda[key] = inside
    return {
        "units": w.units, "window_s": tr.window_s, "idle_s": idle,
        "spans": spans,
        "idle_by_span": sorted(([n, t] for n, t in by_span.items()),
                               key=lambda v: -v[1])[:20],
        "idle_share_python_or_bare_call": bare / idle if idle else None,
        "lp_call_covered_by_children": covered,
        "cuda_events": {k: dict(v.most_common(20)) for k, v in cuda.items()},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "benchmarks")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from harness.core import Cell
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell.find(args.workload)
    result, w = run_traced(cell, args.seed, args.seconds,
                           torch.device("cuda", 0), T_START)
    out = {"workload": args.workload, "correct": result["correct"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "device": result["device"], **breakdown(w)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
