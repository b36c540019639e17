#!/usr/bin/env python3
"""What bounds K5 (``masked_rank_k_update``) on the card: times its four
Hopper kernels as built and in variants of ``csrc/matmul_sm90.cu`` that each
leave one part of the work out, side by side in one process.

    python3 tools/k5_variants.py [--reps 20] [--seed 0]

Variants, text edits of the source built with nvcc into a temporary
directory (for measurement only; their outputs are not K5's).  Each leaves
its part out behind a condition that is false at run time (k < 0), so that
the compiler keeps the rest of the kernel as it was; the registers and
spills of each are printed:

- ``as built``: the source as it is;
- ``compute only``: no stream of c (no tile of c into shared memory, no
  float32 mirror copy) and copy tiles do nothing: the product tiles' FMAs
  and their stores of out;
- ``copy blocks`` (float32): no mirror copy; every copy tile is a block of
  its own beside the product blocks, as in the float64 kernel.

At phase 12's 4096², rank 128, prints each kernel's time in each variant
(CUDA events, min-max of two runs of ``--reps`` launches, variants in turns
in each order), the host's µs a call as built, then the SM clock and power
(nvidia-smi) while each float32-lower variant runs for about a second.  Needs one CUDA card and
nvcc.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "elemental_tpu_torch", "csrc", "matmul_sm90.cu")
KERNELS = (("el_rank_k_ffma_lower_f32", "float32"),
           ("el_rank_k_ffma_upper_f32", "float32"),
           ("el_rank_k_dmma_lower_f64", "float64"),
           ("el_rank_k_dmma_upper_f64", "float64"))


def edit(src: str, pairs) -> str:
    for old, new in pairs:
        if old not in src:
            raise SystemExit(f"k5_variants: the source no longer holds "
                             f"{old.strip()[:60]!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    wait_c = "  mbar_wait(bar, 0);\n"
    mirrored = ("  const bool mirrored = tile.m0 != tile.n0 && tile.n0 < m && "
                "tile.m0 < n")
    return {
        "as built": src,
        "compute only": edit(src, [
            ("  const bool lead = threadIdx.x == 0;",
             "  const bool lead = threadIdx.x == 0 && k < 0;"),
            ("    if (!mirrored)  ", "    if (!mirrored && k < 0)"),
            ("    copy_tile<double, DM_THREADS>",
             "    if (k < 0) copy_tile<double, DM_THREADS>"),
            ("  prefetch_c<double, RK_DM_CS>",
             "  if (k < 0) prefetch_c<double, RK_DM_CS>"),
            (wait_c + "\n  const int tx",
             "  if (k < 0) mbar_wait(bar, 0);\n\n  const int tx"),
            (wait_c + "\n  const int lane",
             "  if (k < 0) mbar_wait(bar, 0);\n\n  const int lane")]),
        "copy blocks": edit(src, [(mirrored + ";", mirrored + " && k < 0;")]),
    }


def build(nvcc: str, out_dir: str, name: str, src: str) -> str:
    cu = os.path.join(out_dir, f"{name.replace(' ', '_')}.cu")
    so = cu[:-3] + ".so"
    with open(cu, "w") as f:
        f.write(src)
    proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v", "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"k5_variants: {name} did not build:\n"
                         f"{proc.stderr[-3000:]}")
    # ptxas: each entry's name, then its spills and registers
    lines = proc.stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "rank_k" in line:
            kernel = ("ffma" if "ffma" in line else "dmma") + (
                "_lower" if "ILb1E" in line else "_upper")
            stats = " ".join(x.strip() for x in lines[i + 1:i + 4]
                             if "spill" in x or "Used" in x)
            print(f"  {name} {kernel}: {stats}")
    return so


def clock_and_power(run, seconds: float = 1.2):
    """Mean SM clock (MHz) and power (W) from nvidia-smi every 100 ms while
    ``run()`` repeats for about ``seconds``."""
    import torch
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(200):
            run()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [line.split(",") for line in smi.communicate()[0].splitlines()
            if line.strip()]
    rows = [(float(a), float(b)) for a, b in rows[2:-1]]   # settled samples
    if not rows:
        return float("nan"), float("nan")
    return (sum(r[0] for r in rows) / len(rows),
            sum(r[1] for r in rows) / len(rows))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("k5_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from elemental_tpu_torch._build import nvcc_path
    cs.phase_card()
    with open(SOURCE) as f:
        srcs = variants(f.read())
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        jobs = {name: pool.submit(build, nvcc, tmp, name, src)
                for name, src in srcs.items()}
        libs = {name: ctypes.CDLL(job.result()) for name, job in jobs.items()}

    n, k = 4096, 128
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    ops = {dtype: tuple(torch.randn(*shape, generator=gen, device="cuda",
                                    dtype=getattr(torch, dtype))
                        for shape in ((n, n), (n, k), (k, n)))
           for dtype in ("float32", "float64")}

    def kernel(lib, fname, dtype):
        c, a, b = ops[dtype]
        out = torch.empty_like(c)
        fn = getattr(lib, fname)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [
            ctypes.c_double, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        stream = torch.cuda.current_stream().cuda_stream

        def run():
            rc = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
                    n, n, k, -1.0, stream)
            if rc:
                raise RuntimeError(f"{fname}: launch failed ({rc})")
        return run

    print(f"K5 at {n}x{n}, rank {k}: ms a call, min-max of 2 runs of "
          f"{args.reps} launches")
    for fname, dtype in KERNELS:
        runs = {name: kernel(lib, fname, dtype) for name, lib in libs.items()}
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(cs.cuda_ms(runs[name], args.reps))
        print(f"  {fname}: " + "; ".join(
            f"{name} {min(t):.4f}-{max(t):.4f}" for name, t in times.items()))
    for fname, dtype in KERNELS[::2]:
        run = kernel(libs["as built"], fname, dtype)
        us = cs.host_us(lambda: [run() for _ in range(args.reps)], args.reps)
        print(f"  {fname} as built: {us:.1f} us of host a call (the C "
              f"entry, tensor maps included)")
    for name, lib in libs.items():
        clk, watts = clock_and_power(kernel(lib, KERNELS[0][0], "float32"))
        print(f"  {KERNELS[0][0]} {name}: SM clock {clk:.0f} MHz, power "
              f"{watts:.0f} W")
    return 0


if __name__ == "__main__":
    sys.exit(main())
