#!/usr/bin/env python3
"""Device time of each CUDA kernel behind one K2 product (``gather_spmv``)
and behind cuSPARSE's product of the same matrix, from ``torch.profiler``,
on the n = 2^20 matrices of ``chip_smoke.py`` phase 8 (uniform d = 10 and
the skewed zipf rows), in float32 and float64.

    python3 tools/k2_profile.py [--repo DIR] [--reps 50] [--seed 0]

``--repo`` names the checkout whose ``elemental_tpu_torch`` is profiled (by
default this one; another tree unpacked with ``git archive`` profiles its
kernel in the same call).  Prints, per matrix and dtype, each kernel's
name, its launches and its mean device microseconds a product; needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose elemental_tpu_torch is profiled")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.repo))
    import torch
    if not torch.cuda.is_available():
        print("k2_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile
    import elemental_tpu_torch
    from elemental_tpu_torch.kernels.unstructured import (gather_spmv,
                                                          plan_gather_spmv)
    cs.phase_card()
    print(f"port: {os.path.dirname(elemental_tpu_torch.__file__)}")
    for label, M in (("uniform d=10", cs.random_d10(args.seed)),
                     ("skewed zipf", cs.skewed_zipf(args.seed))):
        host = plan_gather_spmv(M)
        A = M.to_scipy()
        for dtype in (torch.float32, torch.float64):
            plan = host.to("cuda", dtype)
            x = torch.randn(M.width, device="cuda", dtype=dtype)
            csr = torch.sparse_csr_tensor(
                torch.from_numpy(A.indptr).to("cuda", torch.int32),
                torch.from_numpy(A.indices).to("cuda", torch.int32),
                torch.from_numpy(A.data).to("cuda", dtype), size=A.shape)
            print(f"{label} {str(dtype)[6:]}: nnz={M.nnz}")
            for name, fn in (("K2", lambda: gather_spmv(plan, x)),
                             ("cuSPARSE", lambda: csr @ x)):
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(args.reps):
                        fn()
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    if e.device_time_total > 0:
                        print(f"  {name}: {e.key[:72]} x{e.count // args.reps}"
                              f" {e.device_time_total / args.reps:.2f} us a "
                              f"product")
            del plan, x, csr
    return 0


if __name__ == "__main__":
    sys.exit(main())
