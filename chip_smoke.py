#!/usr/bin/env python3
"""Drive the PyTorch port (``elemental_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py [--n1 224] [--max-iters 3] [--seed 0]

Phases, each printing at least one line and each fatal when it fails:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: K1 (``csrc/extend_add.cu``), K2 (``csrc/csr_spmv.cu``), K3
   (``csrc/stencil_spmv.cu``), the bridged tier's stream gather and K7
   (``csrc/bridged.cu``), K4 and K5 (``csrc/matmul.cu``) and K6
   (``csrc/elementwise.cu``), one nvcc each for sm_90a, all started
   together;
3. K1 against its plain version on every level of the at-scale LP's KKT
   plan (concat_fd_2d n1×n1, analysed once here), in float32 and float64,
   with the time of one whole factor's extend-add for both;
4. sparse LDL of the 24³ Laplacian in float32, SPD and LDL kernels: solve
   residual under the dtype's bound, K1 launched;
5. the LP at full size: ``lp_direct`` for ``--max-iters`` iterations in
   float32 (the ordering of phase 3 reused), after the first KKT factor is
   checked against one made with the plain extend-add; its seconds per
   iteration are the run's time less that of a ``max_iters=0`` run, which
   returns the starting point;
6. K3: ``plan_spmv`` of the 1024² 2-D Laplacian/8 and the 128³ 3-D
   Laplacian on the card (kind 'stencil'), one ``SpMVPlan.matvec`` each in
   float32 and float64 held against the plain version and scipy, and the
   kernel and plain times over 100 launches;
7. 'stencil_rcm': a scrambled symmetric banded matrix (n = 2²⁰, bandwidth
   6) planned and multiplied through the permutation boundary, against
   scipy;
8. K2: the uniform-random CSR (n = 2²⁰, 10 entries a row) planned on the
   card (kind 'gather_csr'), as phase 6;
9. CG on the unscaled 1024² Laplacian in float32 (tol 1e-6) through the
   stencil plan: iterations, residuals, seconds per iteration, K3 launches;
10. the bridged tier: ``plan_spmv(kind='bridged')`` of phase 8's matrix, one
    ``SpMVPlan.matvec`` in float32 and float64 (y float32 in both) held
    against the plain versions of both stages and scipy; the stream gather
    and K7 each against its plain version, and the whole matvec against
    the whole plain path and against K2 on the same matrix;
11. K4 ``matmul`` at 4096³ in float32, bfloat16 and float64 against the
    float64 product and ``torch.matmul`` (TF32 off), with TFLOP/s;
12. K5 ``masked_rank_k_update`` at m = n = 4096, k = 128 (the default
    blocksize), lower and upper, float32 and float64: the triangle against
    the plain version, the rest bit-equal to c;
13. K6 ``axpy``, ``scale``, ``hadamard``, ``copy``, ``fill`` and
    ``transpose`` on 8192² float32 (``transpose`` also on 8192×4096)
    against their plain versions, with GB/s.

Then one JSON line of kernel results, and as the last line
``{"ok": true, "device": {...}}``.  Needs a CUDA card: without one (or
without the package beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

sys.modules["jax"] = None       # the port must run with no JAX at all


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall(fn):
    """(result, seconds) of ``fn()`` ending in a device synchronisation."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1 card] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")


def phase_build():
    """nvcc for every kernel of the port, one process per source, all
    started together."""
    from concurrent.futures import ThreadPoolExecutor
    from elemental_tpu_torch.kernels import (elementwise, extend_add, matmul,
                                             spmv, unstructured)

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    builds = (("K1 extend_add", extend_add.build),
              ("K2 gather_spmv", unstructured.build),
              ("K3 stencil_spmv", spmv.build),
              ("stream gather + K7 combine", unstructured.build_bridged),
              ("K4 matmul + K5 masked_rank_k_update", matmul.build),
              ("K6 elementwise", elementwise.build))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = [(name, pool.submit(timed, build)) for name, build in builds]
        built = [(name, *job.result()) for name, job in jobs]
    for name, path, dt in built:
        print(f"[2 build] {name} built with nvcc for sm_90a in {dt:.2f} s "
              f"-> {path}")
    print(f"[2 build] all kernels in {time.perf_counter() - t0:.2f} s")


def phase_k1(kkt, seed: int):
    """K1 against ``index_add_`` on every level of the KKT plan."""
    import torch
    from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                        extend_add_plain)
    plan = kkt.ea_plan
    levels = [plan.levels[li] for li in sorted(plan.levels)]
    out = {}
    for dtype, rtol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        g = torch.Generator(device="cuda").manual_seed(seed)
        pool0 = torch.rand(plan.pool_size, generator=g, device="cuda",
                           dtype=dtype)
        pk, pp = pool0.clone(), pool0.clone()
        for lv in levels:
            extend_add(pk, lv)
            extend_add_plain(pp, lv)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        scale = float(pp.abs().max())
        check(err <= rtol * scale,
              f"K1 {dtype} max|err| {err:.3e} > {rtol:g}·max|pool| "
              f"({scale:.3e})")

        def run_kernel():
            for lv in levels:
                extend_add(pk, lv)

        def run_plain():
            for lv in levels:
                extend_add_plain(pp, lv)

        run_kernel(), run_plain()                  # warm
        p1 = cuda_ms(run_plain, 5)
        k1 = cuda_ms(run_kernel, 5)
        k2 = cuda_ms(run_kernel, 5)
        p2 = cuda_ms(run_plain, 5)
        out[dtype] = dict(err=err, scale=scale, ms=(k1 + k2) / 2,
                          plain_ms=(p1 + p2) / 2)
        print(f"[3 K1] {str(dtype)[6:]}: {len(levels)} levels, "
              f"{plan.n_pairs} pairs, max|err| {err:.3e} "
              f"(max|pool| {scale:.3e}); one factor's extend-add: kernel "
              f"{(k1 + k2) / 2:.3f} ms, index_add_ {(p1 + p2) / 2:.3f} ms")
        del pool0, pk, pp
    return out


def phase_ldl():
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.matrices import sparse_laplacian_3d
    from elemental_tpu_torch.sparse_direct import SparseLDLFactorization
    A = sparse_laplacian_3d(24, 24, 24, scaled=False)
    b = np.random.default_rng(0).standard_normal(A.height)
    for spd in (True, False):
        f = SparseLDLFactorization(device="cuda", dtype=torch.float32,
                                   spd=spd).initialize(A, cutoff=64)
        f.factor()                                  # warm
        extend_add.launches = 0
        _, tf = wall(f.factor)
        launches = extend_add.launches
        x, ts = wall(lambda: f.solve(b))
        x = x.cpu().numpy().astype(np.float64)
        r = float(np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b))
        check(np.isfinite(r) and r < f.residual_bound(),
              f"LDL (spd={spd}) residual {r:.3e} >= bound "
              f"{f.residual_bound():.3e}")
        check(launches > 0, f"LDL (spd={spd}) factor launched no K1")
        print(f"[4 sparse LDL] 24^3 Laplacian f32 {'SPD' if spd else 'LDL'}"
              f": factor {tf:.4f} s ({f.factor_gflops():.2f} GFlop), solve "
              f"{ts:.4f} s, residual {r:.3e} < {f.residual_bound():.3e}, "
              f"K1 launches {launches}")


def phase_lp(A, b, c, kkt, max_iters: int):
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                        extend_add_plain)
    from elemental_tpu_torch.optimization import LPCtrl, lp_direct
    from elemental_tpu_torch.optimization.lp import (_resolve_numerics,
                                                     _resolve_refine,
                                                     sparse_ruiz)
    from elemental_tpu_torch.sparse_direct import numeric
    m, n = A.shape
    f32 = torch.float32
    gamma, _ = _resolve_numerics(LPCtrl(), f32)
    nref = _resolve_refine(LPCtrl(), f32)
    _, r, _ = sparse_ruiz(A)

    # the first KKT factor of lp_direct (Θ = I): K1 against the plain
    # extend-add, both on the card
    vals = kkt.assemble([torch.ones(n, dtype=f32, device="cuda")])
    kkt.prepare(vals)                               # warm
    fk, t_factor = wall(lambda: kkt.prepare(vals))
    numeric.extend_add = extend_add_plain
    try:
        fp, t_plain = wall(lambda: kkt.prepare(vals))
    finally:
        numeric.extend_add = extend_add
    err = float((fk.pool - fp.pool).abs().max())
    scale = float(fp.pool.abs().max())
    check(np.isfinite(err) and err <= 1e-5 * scale,
          f"first KKT factor: K1 vs plain max|err| {err:.3e} > "
          f"1e-5·max|pool| ({scale:.3e})")
    del fp
    ctx, t_ctx = wall(fk.solve_context)
    reg_diag = torch.cat([torch.full((n,), gamma), torch.full((m,), -gamma)]
                         ).to("cuda", f32)
    rhs = torch.cat([torch.zeros(n), torch.as_tensor(b / r)]).to("cuda", f32)
    fk.solve_refined(rhs, reg_diag, iters=nref, ctx=ctx)   # warm
    _, t_sweep = wall(lambda: fk.solve_refined(rhs, reg_diag, iters=nref,
                                               ctx=ctx))
    print(f"[5 LP] first KKT factor: K1 {t_factor:.3f} s, plain extend-add "
          f"{t_plain:.3f} s, pools agree to {err:.3e} (max|pool| "
          f"{scale:.3e}); panel inverses {t_ctx:.3f} s; FGMRES-{nref} sweep "
          f"{t_sweep:.3f} s")
    del fk, ctx

    levels_with_children = len(kkt.ea_plan.levels)
    ordering = kkt.symb.perm.cpu().numpy()
    A_sp = A.to_scipy()

    def rel_primal(x):
        return float(np.linalg.norm(A_sp @ x - b) / (1 + np.linalg.norm(b)))

    def solve(iters):
        return wall(lambda: lp_direct(
            A, b, c, LPCtrl(max_iters=iters, ordering=ordering),
            device="cuda", dtype=f32))

    # max_iters=0 returns the starting point: its residual is where the
    # IPM starts, and its time (analysis, Θ=I factor, two solves) is what
    # the full run spends before its first iteration
    start, t_start = solve(0)
    torch.cuda.reset_peak_memory_stats()
    extend_add.launches = 0
    res, t_lp = solve(max_iters)
    launches = extend_add.launches
    factors = 1 + res.iterations
    for x in (res.x, res.y, res.z):
        check(np.all(np.isfinite(x)), "non-finite iterate")
    check(res.iterations >= 1, "no IPM iteration ran")
    r0, r1 = rel_primal(start.x), rel_primal(res.x)
    check(r1 < r0, f"relative primal residual did not fall: {r0:.3e} -> "
          f"{r1:.3e}")
    check(launches >= factors * levels_with_children,
          f"K1 launched {launches} times, expected at least "
          f"{factors} factors x {levels_with_children} levels")
    print(f"[5 LP] lp_direct concat_fd_2d m={m} n={n} f32: {res.iterations} "
          f"iterations in {t_lp:.2f} s; a max_iters=0 run (analysis and "
          f"starting point) took {t_start:.2f} s, so "
          f"{(t_lp - t_start) / res.iterations:.3f} s/iteration; relative "
          f"primal residual {r0:.3e} -> {r1:.3e}; metric {res.metric:.3e}, "
          f"converged={res.converged}; K1 launches {launches} = {factors} "
          f"factors x {levels_with_children} levels; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def time_pair(kernel, plain, reps: int = 100):
    """(kernel ms, plain ms): each warmed, then timed over ``reps``
    back-to-back launches in the order plain, kernel, kernel, plain."""
    kernel(), plain()
    p1, k1 = cuda_ms(plain, reps), cuda_ms(kernel, reps)
    k2, p2 = cuda_ms(kernel, reps), cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def spmv_cases(tag, M, kind, launch, plain, seed):
    """Plan ``M`` with ``plan_spmv`` on the card (asserting ``kind``); in
    float32 and float64 drive one ``SpMVPlan.matvec`` (the main path, its
    kernel launches counted), hold it against the plain version and scipy,
    and time kernel and plain.  Returns the main path's launches and the
    float32 result."""
    import numpy as np
    import torch
    from elemental_tpu_torch.sparse import plan_spmv
    t0 = time.perf_counter()
    host = plan_spmv(M)
    t_plan = time.perf_counter() - t0
    check(host.kind == kind, f"{tag}: plan_spmv chose {host.kind!r}, "
          f"expected {kind!r}")
    x64 = np.random.default_rng(seed).standard_normal(M.width)
    A_sp = M.to_scipy().astype(np.float64)
    launches, out = 0, None
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        plan = host.to("cuda", dtype)
        x = torch.from_numpy(x64).to("cuda", dtype)
        part = plan.stencil if plan.stencil is not None else plan.gather
        launch.launches = 0
        y = plan.matvec(x)
        torch.cuda.synchronize()
        n_main = launch.launches
        check(n_main == 1, f"{tag}: SpMVPlan.matvec launched the kernel "
              f"{n_main} times")
        launches += n_main
        ref = plain(part, x)
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        expect = A_sp @ x.cpu().numpy().astype(np.float64)
        host_err = float(np.abs(y.cpu().numpy() - expect).max())
        check(np.isfinite(err) and err <= tol * scale,
              f"{tag} {dtype}: kernel vs plain max|err| {err:.3e} > "
              f"{tol:g}·max|y| ({scale:.3e})")
        check(host_err <= 10 * tol * scale,
              f"{tag} {dtype}: kernel vs scipy max|err| {host_err:.3e}")
        ms, plain_ms = time_pair(lambda: launch(part, x),
                                 lambda: plain(part, x))
        gbs = plan.stream_bytes / (ms * 1e-3) / 1e9
        print(f"{tag} {str(dtype)[6:]}: n={M.height} nnz={M.nnz}, "
              f"plan {t_plan:.2f} s (host); max|err| vs plain {err:.3e}, "
              f"vs scipy {host_err:.3e} (max|y| {scale:.3e}); kernel "
              f"{ms:.4f} ms ({gbs:.0f} GB/s of stream_bytes), plain "
              f"{plain_ms:.4f} ms over 100 launches")
        if dtype == torch.float32:
            out = dict(err=err, ms=ms, plain_ms=plain_ms)
        del plan, x, y, ref
    return launches, out


def phase_k3(A2, seed: int):
    """K3 on the bench's 1024² Laplacian/8 and the 128³ Laplacian."""
    from elemental_tpu_torch.kernels.spmv import (stencil_spmv,
                                                  stencil_spmv_plain)
    from elemental_tpu_torch.matrices import sparse_laplacian_3d
    launches = 0
    cases = (("1024^2 Laplacian/8", A2.change_nonzero_values(A2.vals / 8.0)),
             ("128^3 Laplacian", sparse_laplacian_3d(128, 128, 128,
                                                     scaled=False)))
    for label, M in cases:
        n, out = spmv_cases(f"[6 K3] {label}", M, "stencil", stencil_spmv,
                            stencil_spmv_plain, seed)
        launches += n
        if label.startswith("1024"):
            result = out
    return launches, result


def phase_rcm(seed: int):
    """A scrambled symmetric banded matrix through 'stencil_rcm'."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from elemental_tpu_torch.kernels.spmv import stencil_spmv
    from elemental_tpu_torch.sparse import SparseMatrix, plan_spmv
    n, bw = 1 << 20, 6
    rng = np.random.default_rng(seed)
    offs = list(range(-bw, bw + 1))
    S = sp.diags([rng.standard_normal(n) for _ in offs], offs, shape=(n, n),
                 format="csr")
    S = (S + S.T).astype(np.float32)
    p = rng.permutation(n)
    A = SparseMatrix.from_scipy(S[p][:, p].tocsr())
    t0 = time.perf_counter()
    host = plan_spmv(A)
    t_plan = time.perf_counter() - t0
    check(host.kind == "stencil_rcm",
          f"scrambled banded: plan_spmv chose {host.kind!r}")
    plan = host.to("cuda", torch.float32)
    x = rng.standard_normal(n).astype(np.float32)
    stencil_spmv.launches = 0
    y = plan.from_plan_space(plan.matvec(plan.to_plan_space(
        torch.from_numpy(x).to("cuda"))))
    torch.cuda.synchronize()
    launches = stencil_spmv.launches
    check(launches == 1, f"stencil_rcm: {launches} K3 launches")
    expect = A.to_scipy().astype(np.float64) @ x.astype(np.float64)
    err = float(np.abs(y.cpu().numpy() - expect).max())
    scale = float(np.abs(expect).max())
    check(err <= 1e-5 * scale, f"stencil_rcm: max|err| vs scipy {err:.3e} "
          f"> 1e-5·max|y| ({scale:.3e})")
    print(f"[7 stencil_rcm] n={n} nnz={A.nnz} bandwidth {bw}, scrambled: "
          f"plan (RCM + DIA) {t_plan:.2f} s (host), "
          f"{len(plan.stencil.offsets)} diagonals; f32 max|err| vs scipy "
          f"{err:.3e} (max|y| {scale:.3e}); K3 launches {launches}")
    return launches


def random_d10(seed: int):
    """The bench's uniform-random CSR (n = 2^20, 10 a row)."""
    import numpy as np
    from elemental_tpu_torch.sparse import SparseMatrix
    n = 1 << 20
    rng = np.random.default_rng(seed)
    return SparseMatrix.from_coo(n, n, np.repeat(np.arange(n), 10),
                                 rng.integers(0, n, 10 * n),
                                 rng.standard_normal(10 * n))


def phase_k2(A, seed: int):
    """K2 on the uniform-random CSR of :func:`random_d10`."""
    from elemental_tpu_torch.kernels.unstructured import (gather_spmv,
                                                          gather_spmv_plain)
    return spmv_cases("[8 K2] uniform random d=10", A, "gather_csr",
                      gather_spmv, gather_spmv_plain, seed)


# f32 CG on the unscaled 1024^2 Laplacian: the bound on the true relative
# residual ‖b − A·x‖/‖b‖, computed on the host in float64 (PERF.md).
CG_RESIDUAL_BOUND = 1e-3


def phase_cg(A2, seed: int):
    """CG through the 1024² stencil plan in float32, as
    examples/cg_laplacian.py runs it."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.spmv import stencil_spmv
    from elemental_tpu_torch.lapack import cg
    from elemental_tpu_torch.sparse import plan_spmv
    host = plan_spmv(A2)
    check(host.kind == "stencil", f"CG: plan_spmv chose {host.kind!r}")
    plan = host.to("cuda", torch.float32)
    b = np.random.default_rng(seed).standard_normal(A2.height).astype(
        np.float32)
    bt = torch.from_numpy(b).to("cuda")
    stencil_spmv.launches = 0
    res, t = wall(lambda: cg(plan.matvec, bt, tol=1e-6, max_iters=20000))
    launches = stencil_spmv.launches
    x = res.x.cpu().numpy().astype(np.float64)
    check(np.all(np.isfinite(x)), "CG: non-finite x")
    check(res.iterations > 0 and launches == res.iterations + 1,
          f"CG: {launches} K3 launches for {res.iterations} iterations")
    bnorm = float(np.linalg.norm(b.astype(np.float64)))
    rel = float(np.linalg.norm(A2.to_scipy() @ x - b) / bnorm)
    check(rel < CG_RESIDUAL_BOUND, f"CG: host residual {rel:.3e} >= "
          f"{CG_RESIDUAL_BOUND:g}")
    print(f"[9 CG] 1024^2 Laplacian f32, tol 1e-6: {res.iterations} "
          f"iterations in {t:.3f} s ({t / res.iterations * 1e3:.4f} "
          f"ms/iteration); recurrence residual {res.residual / bnorm:.3e}, "
          f"host-verified (float64, scipy) {rel:.3e} < "
          f"{CG_RESIDUAL_BOUND:g}; K3 launches {launches} = iterations + 1")
    return launches


def phase_bridged(A, seed: int):
    """The bridged tier (stream gather, then K7) on phase 8's matrix."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.unstructured import (
        gather_spmv, onehot_combine_bucketed, onehot_combine_bucketed_plain,
        plan_gather_spmv, stream_gather, stream_gather_plain)
    from elemental_tpu_torch.sparse import plan_spmv
    t0 = time.perf_counter()
    host = plan_spmv(A, kind="bridged")
    t_plan = time.perf_counter() - t0
    check(host.kind == "bridged", f"bridged: plan_spmv gave {host.kind!r}")
    g = host.gather
    print(f"[10 bridged] n={A.height} nnz={A.nnz}: host plan {t_plan:.2f} s; "
          f"{g.nbuckets} buckets of {g.bucket} rows, SUB={g.sub}, "
          f"{g.slots} slots ({g.slots / A.nnz - 1:.4f} padding)")
    x64 = np.random.default_rng(seed).standard_normal(A.width)
    A_sp = A.to_scipy().astype(np.float64)
    launches = {"gather": 0, "combine": 0}
    out = {}
    for dtype in (torch.float32, torch.float64):
        plan = host.to("cuda", dtype)
        bp = plan.gather
        x = torch.from_numpy(x64).to("cuda", dtype)
        stream_gather.launches = onehot_combine_bucketed.launches = 0
        y = plan.matvec(x)
        torch.cuda.synchronize()
        n_g, n_c = stream_gather.launches, onehot_combine_bucketed.launches
        check((n_g, n_c) == (1, 1), f"bridged {dtype}: SpMVPlan.matvec "
              f"launched the stream gather {n_g} and K7 {n_c} times")
        launches["gather"] += n_g
        launches["combine"] += n_c
        check(y.dtype == torch.float32 and y.shape == (A.height,),
              f"bridged {dtype}: y is {y.dtype} {tuple(y.shape)}")
        P = stream_gather_plain(bp, x).view(bp.lr.shape)
        ref = onehot_combine_bucketed_plain(P, bp.lr, bp.bucket)[:A.height]
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        expect = A_sp @ x.cpu().numpy().astype(np.float64)
        host_err = float(np.abs(y.cpu().numpy() - expect).max())
        check(np.isfinite(err) and err <= 1e-5 * scale,
              f"bridged {dtype}: kernels vs plain max|err| {err:.3e} > "
              f"1e-5·max|y| ({scale:.3e})")
        check(host_err <= 1e-5 * np.abs(expect).max(),
              f"bridged {dtype}: kernels vs scipy max|err| {host_err:.3e}")
        Pk = stream_gather(bp, x)
        g_err = float((Pk - P.view(-1)).abs().max())
        check(g_err == 0.0, f"bridged {dtype}: stream gather vs plain "
              f"max|err| {g_err:.3e} (one product a slot: must be 0)")
        Pk = Pk.view(bp.lr.shape)
        yk = onehot_combine_bucketed(Pk, bp.lr, bucket=bp.bucket)
        ck = onehot_combine_bucketed_plain(Pk, bp.lr, bp.bucket)
        c_err = float((yk - ck).abs().max())
        check(c_err <= 1e-5 * float(ck.abs().max()),
              f"bridged {dtype}: K7 vs index_add_ max|err| {c_err:.3e}")
        ms_g, plain_g = time_pair(lambda: stream_gather(bp, x),
                                  lambda: stream_gather_plain(bp, x))
        ms_c, plain_c = time_pair(
            lambda: onehot_combine_bucketed(Pk, bp.lr, bucket=bp.bucket),
            lambda: onehot_combine_bucketed_plain(Pk, bp.lr, bp.bucket))
        ms_all, plain_all = time_pair(
            lambda: plan.matvec(x),
            lambda: onehot_combine_bucketed_plain(
                stream_gather_plain(bp, x).view(bp.lr.shape), bp.lr,
                bp.bucket)[:A.height])
        k2 = plan_gather_spmv(A).to("cuda", dtype)
        ms_b, ms_k2 = time_pair(lambda: plan.matvec(x),
                                lambda: gather_spmv(k2, x))
        gbs = plan.stream_bytes / (ms_all * 1e-3) / 1e9
        print(f"[10 bridged] {str(dtype)[6:]}: y float32, max|err| vs plain "
              f"{err:.3e}, vs scipy {host_err:.3e} (max|y| {scale:.3e}); "
              f"stream gather {ms_g:.4f} ms vs plain {plain_g:.4f} ms; K7 "
              f"{ms_c:.4f} ms vs index_add_ {plain_c:.4f} ms (max|err| "
              f"{c_err:.3e}); whole matvec {ms_all:.4f} ms ({gbs:.0f} GB/s "
              f"of stream_bytes) vs plain path {plain_all:.4f} ms; bridged "
              f"{ms_b:.4f} ms vs K2 gather_csr {ms_k2:.4f} ms (over 100 "
              f"launches each)")
        out[dtype] = dict(err=err, g_err=g_err, c_err=c_err, ms_g=ms_g,
                          plain_g=plain_g, ms_c=ms_c, plain_c=plain_c)
        del plan, bp, x, y, P, Pk, yk, ck, ref, k2
    return launches, out[torch.float32]


def phase_k4(seed: int):
    """K4 at 4096³ (``bench.py``'s GEMM) in float32, bfloat16, float64.
    cuBLAS, the plain version, runs without TF32 and with float32 sums for
    bfloat16 (no reduced-precision reduction), as K4 does."""
    import torch
    from elemental_tpu_torch.kernels.matmul import matmul, matmul_plain
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    n = 4096
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a64 = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    b64 = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    # against max|C| of the float64 product of the same (rounded) inputs:
    # float32 sums in float32 (TF32 would leave ~1e-3); bfloat16 rounds the
    # output once (unit roundoff 2^-8) after float32 sums; float64 sums in
    # float64
    bounds = ((torch.float32, 1e-5), (torch.bfloat16, 2.0**-8 + 1e-5),
              (torch.float64, 1e-12))
    launches, out = 0, {}
    for dtype, bound in bounds:
        a, b = a64.to(dtype), b64.to(dtype)
        exact = a.double() @ b.double()
        scale = float(exact.abs().max())
        matmul.launches = 0
        c = matmul(a, b)
        torch.cuda.synchronize()
        check(matmul.launches == 1, f"K4 {dtype}: {matmul.launches} launches")
        launches += matmul.launches
        check(c.dtype == dtype and c.shape == (n, n),
              f"K4 {dtype}: C is {c.dtype} {tuple(c.shape)}")
        err = float((c.double() - exact).abs().max())
        check(err <= bound * scale, f"K4 {dtype}: max|err| vs the float64 "
              f"product {err:.3e} > {bound:g}·max|C| ({scale:.3e})")
        err_plain = float((c.double() - matmul_plain(a, b).double()).abs()
                          .max())
        ms, plain_ms = time_pair(lambda: matmul(a, b),
                                 lambda: matmul_plain(a, b), reps=10)
        flop = 2.0 * n ** 3
        print(f"[11 K4] {n}^3 {str(dtype)[6:]}: max|err| vs float64 product "
              f"{err:.3e} ({err / scale:.2e}·max|C|, bound {bound:g}), vs "
              f"torch.matmul {err_plain:.3e}; kernel {ms:.3f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s), torch.matmul (cuBLAS) "
              f"{plain_ms:.3f} ms ({flop / plain_ms / 1e9:.2f} TFLOP/s) over "
              f"10 launches")
        out[dtype] = dict(err=err_plain, ms=ms, plain_ms=plain_ms)
        del a, b, c, exact
    return launches, out[torch.float32]


def bits(t):
    """``t``'s bits as integers, for bit-for-bit comparisons."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def phase_k5(seed: int):
    """K5 at m = n = 4096, k = 128: the trailing update of a blocked
    Cholesky (C − L·Lᵀ) at the library's default blocksize."""
    import torch
    from elemental_tpu_torch.kernels.matmul import (
        masked_rank_k_update, masked_rank_k_update_plain)
    n, k = 4096, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.arange(n, device="cuda")[:, None]
    cols = torch.arange(n, device="cuda")[None, :]
    launches, out = 0, None
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        c = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
        a = torch.randn(n, k, generator=gen, device="cuda", dtype=dtype)
        b = torch.randn(k, n, generator=gen, device="cuda", dtype=dtype)
        for lower in (True, False):
            mask = rows >= cols if lower else rows <= cols
            masked_rank_k_update.launches = 0
            o = masked_rank_k_update(c, a, b, alpha=-1.0, lower=lower)
            torch.cuda.synchronize()
            check(masked_rank_k_update.launches == 1,
                  f"K5: {masked_rank_k_update.launches} launches")
            launches += 1
            ref = masked_rank_k_update_plain(c, a, b, alpha=-1.0,
                                             lower=lower)
            err = float((o - ref).abs().max())
            scale = float(ref.abs().max())
            check(err <= tol * scale, f"K5 {dtype} lower={lower}: max|err| "
                  f"{err:.3e} > {tol:g}·max|C| ({scale:.3e})")
            check(torch.equal(bits(o)[~mask], bits(c)[~mask]),
                  f"K5 {dtype} lower={lower}: the other triangle is not c")
            ms, plain_ms = time_pair(
                lambda: masked_rank_k_update(c, a, b, -1.0, lower),
                lambda: masked_rank_k_update_plain(c, a, b, -1.0, lower),
                reps=20)
            print(f"[12 K5] {n}x{n} rank {k} {str(dtype)[6:]} "
                  f"{'lower' if lower else 'upper'}: max|err| vs plain "
                  f"{err:.3e} (max|C| {scale:.3e}), other triangle bit-equal "
                  f"to c; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms over "
                  f"20 launches")
            if out is None:
                out = dict(err=err, ms=ms, plain_ms=plain_ms)
        del c, a, b
    return launches, out


def phase_k6(seed: int):
    """K6's six ops on 8192² float32 (transpose also on 8192×4096)."""
    import torch
    from elemental_tpu_torch.kernels import elementwise as ew
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, n, generator=gen, device="cuda")
    y = torch.randn(n, n, generator=gen, device="cuda")
    xr = torch.randn(n, n // 2, generator=gen, device="cuda")
    item = x.element_size()
    # (name, kernel, plain, bytes moved, within one rounding of |terms|)
    cases = (
        ("axpy", lambda: ew.axpy(1.7, x, y), lambda: ew.axpy_plain(1.7, x, y),
         3, lambda: y.abs() + (1.7 * x).abs()),
        ("scale", lambda: ew.scale(-0.3, x), lambda: ew.scale_plain(-0.3, x),
         2, lambda: (0.3 * x).abs()),
        ("hadamard", lambda: ew.hadamard(x, y),
         lambda: ew.hadamard_plain(x, y), 3, lambda: (x * y).abs()),
        ("copy", lambda: ew.copy(x), lambda: ew.copy_plain(x), 2, None),
        ("fill", lambda: ew.fill((n, n), 1.1, device="cuda"),
         lambda: ew.fill_plain((n, n), 1.1, device="cuda"), 1, None),
        ("transpose", lambda: ew.transpose(x),
         lambda: ew.transpose_plain(x), 2, None),
        ("transpose", lambda: ew.transpose(xr),
         lambda: ew.transpose_plain(xr), 2, None))
    eps = torch.finfo(torch.float32).eps
    launches, out = {}, {}
    for name, kernel, plain, moves, terms in cases:
        counter = getattr(ew, name)
        counter.launches = 0
        got = kernel()
        torch.cuda.synchronize()
        check(counter.launches == 1, f"K6 {name}: {counter.launches} "
              f"launches")
        launches[name] = launches.get(name, 0) + 1
        ref = plain()
        check(got.shape == ref.shape and got.dtype == ref.dtype,
              f"K6 {name}: {tuple(got.shape)} {got.dtype}")
        err = float((got - ref).abs().max())
        if terms is None:
            check(torch.equal(bits(got), bits(ref)),
                  f"K6 {name}: not bit-equal to the plain version")
            rule = "bit-equal"
        else:
            ok = bool(((got.double() - ref.double()).abs()
                       <= eps * terms().double()).all())
            check(ok, f"K6 {name}: beyond one float32 rounding of its terms "
                  f"(max|err| {err:.3e})")
            rule = "within eps·|terms|"
        ms, plain_ms = time_pair(kernel, plain, reps=20)
        nbytes = moves * got.numel() * item
        print(f"[13 K6] {name} {tuple(got.shape)} f32: max|err| vs plain "
              f"{err:.3e} ({rule}); kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms "
              f"({nbytes / plain_ms / 1e6:.0f} GB/s) over 20 launches")
        if name not in out:
            out[name] = dict(err=err, ms=ms, plain_ms=plain_ms)
        del got, ref
    return launches, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n1", type=int, default=224,
                    help="grid side of the LP (n = 2·n1² variables)")
    ap.add_argument("--max-iters", type=int, default=3,
                    help="IPM iterations of the LP phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import elemental_tpu_torch  # noqa: F401  (fails outside the repo)
    from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_2d
    from elemental_tpu_torch.optimization import LPCtrl
    from elemental_tpu_torch.optimization.lp import (_build_lp_kkt,
                                                     _resolve_numerics,
                                                     sparse_ruiz)

    phase_card()
    phase_build()

    A = concat_fd_2d(args.n1, args.n1)
    m, n = A.shape
    rng = np.random.default_rng(args.seed)
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    b = A.to_scipy() @ x0
    c = np.abs(rng.standard_normal(n)) + 0.5
    gamma, _ = _resolve_numerics(LPCtrl(), torch.float32)
    t0 = time.perf_counter()
    kkt, _ = _build_lp_kkt(sparse_ruiz(A)[0], gamma, gamma, None,
                           device="cuda", dtype=torch.float32)
    t_host = time.perf_counter() - t0
    print(f"[3 K1] host analysis of the KKT (N={kkt.N}, nnz={kkt.nnz}, "
          f"{kkt.symb.num_levels} levels, pool {kkt.symb.pool_size}): "
          f"{t_host:.2f} s")
    k1 = phase_k1(kkt, args.seed)
    phase_ldl()
    launches = phase_lp(A, b, c, kkt, args.max_iters)
    del kkt
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    A2 = sparse_laplacian_2d(1024, 1024, scaled=False)
    k3_launches, k3 = phase_k3(A2, args.seed)
    k3_launches += phase_rcm(args.seed)
    A_rand = random_d10(args.seed)
    k2_launches, k2 = phase_k2(A_rand, args.seed)
    k3_launches += phase_cg(A2, args.seed)
    print(f"[6-9] the SpMV and CG phases took {time.perf_counter() - t0:.1f} "
          f"s (host planning included)")

    t0 = time.perf_counter()
    br_launches, br = phase_bridged(A_rand, args.seed)
    del A_rand, A2
    torch.cuda.empty_cache()
    k4_launches, k4 = phase_k4(args.seed)
    k5_launches, k5 = phase_k5(args.seed)
    k6_launches, k6 = phase_k6(args.seed)
    print(f"[10-13] the bridged tier and the dense kernels took "
          f"{time.perf_counter() - t0:.1f} s (host planning included)")

    def entry(name, source, replaces, launches, err, ms, plain_ms):
        return {"name": name, "route": "cuda",
                "source": f"elemental_tpu_torch/csrc/{source}",
                "replaces": f"elemental_tpu/kernels/{replaces}",
                "launches": launches, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms}

    ew_lines = {"axpy": 49, "scale": 56, "hadamard": 63, "fill": 70,
                "copy": 84, "transpose": 91}
    r32 = k1[torch.float32]
    print(json.dumps({"kernels": [
        entry("extend_add", "extend_add.cu", "extend_add.py:58", launches,
              r32["err"], r32["ms"], r32["plain_ms"]),
        entry("stencil_spmv", "stencil_spmv.cu", "spmv.py:123", k3_launches,
              k3["err"], k3["ms"], k3["plain_ms"]),
        entry("gather_spmv", "csr_spmv.cu", "unstructured.py:179",
              k2_launches, k2["err"], k2["ms"], k2["plain_ms"]),
        entry("stream_gather", "bridged.cu", "unstructured.py:179",
              br_launches["gather"], br["g_err"], br["ms_g"],
              br["plain_g"]),
        entry("onehot_combine_bucketed", "bridged.cu", "unstructured.py:287",
              br_launches["combine"], br["c_err"], br["ms_c"],
              br["plain_c"]),
        entry("matmul", "matmul.cu", "matmul.py:32", k4_launches, k4["err"],
              k4["ms"], k4["plain_ms"]),
        entry("masked_rank_k_update", "matmul.cu", "matmul.py:68",
              k5_launches, k5["err"], k5["ms"], k5["plain_ms"]),
        *(entry(op, "elementwise.cu", f"elementwise.py:{line}",
                k6_launches[op], k6[op]["err"], k6[op]["ms"],
                k6[op]["plain_ms"]) for op, line in ew_lines.items())]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
