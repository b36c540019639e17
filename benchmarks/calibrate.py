"""Readings that the check limits are set from, for one cell, in one
process (the set-up is paid once):

    python3 benchmarks/calibrate.py --workload lap48.solves \
        --seeds 11,12,13 --requests 8 --control-seeds 21,22,23

For each of ``--seeds`` it draws the seed's inputs, runs ``--requests``
requests of the timed path and prints the check's numbers; for each of
``--control-seeds`` it puts the reference computed in the precision below
the configuration's in the program's place and prints the same numbers.
One JSON line a seed.  Runs on a CUDA card, like ``run.py``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch
    from harness.core import Cell, Spans, synchronize
    cell = Cell.find(args.workload)
    device = torch.device(args.device)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    op = cell.op
    t0 = time.perf_counter()
    state = op.setup(cell.config, cell.traffic, (seeds or controls)[0],
                     device, Spans())
    print(json.dumps({"workload": args.workload,
                      "setup_s": time.perf_counter() - t0}), flush=True)
    for seed in seeds:
        op.reseed(state, seed)
        t1 = time.perf_counter()
        for k in range(args.requests):
            op.request(state, k)
        synchronize(device)
        t2 = time.perf_counter()
        got = op.check(state, seed)
        print(json.dumps({"seed": seed, "side": "program",
                          "request_s": (t2 - t1) / args.requests,
                          "check_s": time.perf_counter() - t2, **got}),
              flush=True)
    for seed in controls:
        op.reseed(state, seed)
        for k in range(args.requests):      # the sample's indices only
            state["sample"].offer(k, None)
        t2 = time.perf_counter()
        got = op.check(state, seed, control=True)
        print(json.dumps({"seed": seed, "side": "control",
                          "check_s": time.perf_counter() - t2, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
