#!/usr/bin/env python3
"""Time one factor's extend-add (K1) at the at-scale LP's KKT plan, for the
port found in ``--repo`` (by default this checkout), on one CUDA card.

    python3 tools/k1_graph_time.py [--repo DIR] [--n1 224] [--seed 0]

For float32 and float64 it prints, as one JSON line, the kernel's and
``index_add_``'s time for the whole factor's levels: issued from the host
level by level (as the factor issues them) and replayed as a CUDA graph
(device time), and the host's microseconds a kernel call; with
``--levels``, each level's float32 launch as a graph of its own, and the
floor of any 36 launches (a graph of 36 one-element kernels).  Pointing
``--repo`` at an earlier tree unpacked with ``git archive`` times its
kernel beside this one's in the same call to the card; the timing helpers
are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose elemental_tpu_torch is timed")
    ap.add_argument("--n1", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--levels", action="store_true",
                    help="also time each level's float32 launch alone")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs                 # timing helpers; no JAX
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, repo)

    import numpy as np  # noqa: F401  (the port's host code needs it)
    import torch
    if not torch.cuda.is_available():
        print("k1_graph_time: no CUDA device", file=sys.stderr)
        return 1
    import elemental_tpu_torch
    if not os.path.abspath(elemental_tpu_torch.__file__).startswith(repo):
        print(f"k1_graph_time: imported {elemental_tpu_torch.__file__}, "
              f"not the port in {repo}", file=sys.stderr)
        return 1
    from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                        extend_add_plain)
    from elemental_tpu_torch.matrices import concat_fd_2d
    from elemental_tpu_torch.optimization import LPCtrl
    from elemental_tpu_torch.optimization.lp import (_build_lp_kkt,
                                                     _resolve_numerics,
                                                     sparse_ruiz)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    A = concat_fd_2d(args.n1, args.n1)
    gamma, _ = _resolve_numerics(LPCtrl(), torch.float32)
    kkt, _ = _build_lp_kkt(sparse_ruiz(A)[0], gamma, gamma, None,
                           device="cuda", dtype=torch.float32)
    plan = kkt.ea_plan
    levels = [plan.levels[li] for li in sorted(plan.levels)]
    out = {"repo": repo, "card": card, "levels": len(levels),
           "pairs": plan.n_pairs}
    for dtype in (torch.float32, torch.float64):
        g = torch.Generator(device="cuda").manual_seed(args.seed)
        pk = torch.rand(plan.pool_size, generator=g, device="cuda",
                        dtype=dtype)
        pp = pk.clone()

        def run_kernel():
            for lv in levels:
                extend_add(pk, lv)

        def run_plain():
            for lv in levels:
                extend_add_plain(pp, lv)

        ms, plain_ms = cs.time_pair(run_kernel, run_plain, reps=5)
        try:
            g_plain = cs.graph_ms(run_plain)
        except RuntimeError:                # index_add_ not capturable
            g_plain = None
        out[str(dtype)[6:]] = dict(
            ms=ms, plain_ms=plain_ms, graph_ms=cs.graph_ms(run_kernel),
            graph_plain_ms=g_plain,
            host_us=cs.host_us(run_kernel, len(levels)))
        if args.levels and dtype == torch.float32:
            # (pairs, ms) of each level's launch: a graph of 10 of them,
            # over 10; and the floor, a graph of 36 one-element kernels
            out["levels_ms"] = [
                (lv.n_pairs, cs.graph_ms(
                    lambda lv=lv: [extend_add(pk, lv) for _ in range(10)])
                 / 10) for lv in levels]
            one = pk[:1]
            out["floor_36_launches_ms"] = cs.graph_ms(
                lambda: [one.add_(0) for _ in range(36)])
        del pk, pp
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
