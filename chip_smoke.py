#!/usr/bin/env python3
"""Drive the PyTorch port (``elemental_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py [--n1 224] [--max-iters 3] [--seed 0]

Phases, each printing at least one line and each fatal when it fails:

1. card: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: K1 (``csrc/extend_add.cu``), K2 (``csrc/csr_spmv.cu``), K3
   (``csrc/stencil_spmv.cu``), the bridged tier's stream gather and K7
   (``csrc/bridged.cu``), K4's and K5's SIMT kernels (``csrc/matmul.cu``),
   K4's wgmma, dmma and ffma kernels and K5's ffma and dmma kernels
   (``csrc/matmul_sm90.cu``), K6 (``csrc/elementwise.cu``), K8
   (``csrc/front_panel.cu``), K9 (``csrc/level_scatter.cu``) and K10
   (``csrc/level_solve.cu``), one nvcc each for sm_90a, all started
   together;
3. K1 against its plain version on every level of the at-scale LP's KKT
   plan (concat_fd_2d n1×n1, analysed once here), in float32 and float64,
   two kernel runs bit-equal, with the time of one whole factor's
   extend-add for both: issued from the host level by level, and replayed
   as a CUDA graph (device time); the host's µs a call; the values bound;
4. sparse LDL of the 24³ Laplacian in float32, SPD and LDL kernels: solve
   residual under the dtype's bound, K1 launched;
5. the LP at full size: ``lp_direct`` for ``--max-iters`` iterations in
   float32 (the ordering of phase 3 reused), after the first KKT factor is
   checked against one made with the plain extend-add and timed with and
   without ``KKTSystem.prepare``'s zero-pivot check, and its FGMRES-16
   refined solve timed as a CUDA graph replay and issued from the host;
   its seconds per iteration are the run's time less that of a
   ``max_iters=0`` run, which returns the starting point; K1's and K8's
   launches in the run are counted (K8: one a blocked panel of every
   factor), and its refined solves: one graph captured a factor, replayed
   by the factor's other solves (``solve_refined.captures``,
   ``.replays``, in the JSON line);
6. K3: ``plan_spmv`` of the 1024² 2-D Laplacian/8 and the 128³ 3-D
   Laplacian on the card (kind 'stencil'), one ``SpMVPlan.matvec`` each in
   float32 and float64 held against the plain version and scipy, and the
   kernel, plain and cuSPARSE (``torch.sparse_csr_tensor(...) @ x``) times
   over 100 launches;
7. 'stencil_rcm': a scrambled symmetric banded matrix (n = 2²⁰, bandwidth
   6) planned and multiplied through the permutation boundary, against
   scipy;
8. K2: the uniform-random CSR (n = 2²⁰, 10 entries a row) planned on the
   card (kind 'gather_csr'), as phase 6; then a matrix of skewed rows (n =
   2²⁰, power-law lengths: empty rows and rows of 10⁴ entries or more)
   the same way, its time printed, not gated;
9. CG on the unscaled 1024² Laplacian in float32 (tol 1e-6) through the
   stencil plan: iterations, residuals, seconds per iteration, K3 launches;
10. the bridged tier: ``plan_spmv(kind='bridged')`` of phase 8's matrix, one
    ``SpMVPlan.matvec`` in float32 and float64 (y float32 in both) held
    against the plain versions of both stages and scipy; the stream gather
    and K7 each against its plain version; K7 bit-equal to its sums in
    plan order (``combine_in_plan_order``) with and without the prebuilt
    summation plan, and K7 and the matvec bit-stable over 5 calls; K7's
    time with and without the plan and the plan's build time; the whole
    matvec against the whole plain path and against K2 on the same matrix,
    in event time and in device time (``torch.profiler``) per kernel;
11. K4 ``matmul`` at 4096³ in float32, bfloat16 and float64 (the ffma,
    wgmma and dmma paths, asserted by their counters), at 3000×1000×2056
    through the same paths and at 4096×4095×4096 float32 (the SIMT path),
    against the float64 product and ``torch.matmul`` (cuBLAS, TF32 off):
    TFLOP/s, the fraction of the bound, kernel/cuBLAS, and the SIMT
    kernel's time at 4096³ beside the new path's;
12. K5 ``masked_rank_k_update`` at m = n = 4096, k = 128 (the default
    blocksize), lower and upper, through the ffma (float32) and dmma
    (float64) paths, and at 4096×4094 float32 with k = 127 through the SIMT
    path (each asserted by its counter): the triangle against the plain
    version, the rest bit-equal to c, the bits equal on a second call; the
    fraction of the bound, and at 4096² the SIMT kernel and
    ``torch.addmm`` over the whole square beside it, in event time and in
    device time (``torch.profiler``);
13. K6 ``axpy``, ``scale``, ``hadamard``, ``copy``, ``fill`` and
    ``transpose`` on 8192² float32 (``transpose`` also on 8192×4096)
    against their plain versions (torch's own kernels), with GB/s and
    kernel/torch, the latter also with the window opened on an idle card;

14-17. the rest of the IPM tier, each at the LP's KKT size (N ≈ 3·n1²),
    its host analysis (ordering, symbolic analysis, extend-add plan) run
    for all six patterns at once, one spawned process each, beside phase
    3's analysis of the LP.  Each at-scale run is float32 with the
    ordering given: a ``max_iters=0`` run and a ``--max-iters`` run, whose
    difference over the iterations is the s/iteration; the iterates
    finite, the host-f64 primal and dual residuals below the start's, K1
    launched at least levels × factors times, and the run's first factor
    taken again with K1 held against the plain extend-add on the same pool
    at every level, within 1e-5 of max|pool| (1e-12 in float64; phase 17's
    runs too).  14: ``qp_direct`` (Q = blockdiag(L, L) of the grid Laplacian, A =
    concat_fd_2d) and one iteration under ``torch.profiler`` (the factor's
    share of it); converged in float64 at n1 = 32 to test_ipm.py's KKT
    gate, and ``portfolio`` and ``nnls`` at their test sizes.  15:
    ``lp_affine`` (the orthant) and ``socp_affine`` (cones of order 4) on A
    = concat_fd_2d, G = −I, each on its own ordering (the SOCP's, whose
    pattern holds the LP's, gave the LP 177 levels and a 26-43 s symbolic
    analysis, PERF.md §6); converged in float64:
    ``lp_affine`` against HiGHS, ``socp_affine`` against lstsq,
    ``robust_least_squares`` and ``basis_pursuit_complex``.  16: a
    general-form MPS file (E, L, G rows, RANGES, UP/LO/FX/FR/MI bounds, an
    objective constant) written and read back exactly, then ``solve_mps``;
    the same generator at n1 = 16 converged in float64 to HiGHS.  17:
    ``sparse_least_squares`` (examples/sequential_least_squares.py's
    extended Laplacian) and ``sparse_lse`` (examples/sequential_lse.py's
    problem) in float64 and float32, held to the drivers' gates.
18. complex sparse LDL, each pattern ordered by ``natural_nested_dissection``
    and analysed in a worker beside phase 3 as well: damped Helmholtz
    ``sparse_helmholtz_2d(384, 384, ω²(1 + 0.05i))``, ω = 2π·385/10
    (complex-symmetric LDLᵀ, N = 147,456, the LP's KKT size); on its
    pattern the 384² magnetic Laplacian (Landau gauge, flux 1/64 a
    plaquette), Hermitian, once HPD through ``spd=True`` and once shifted
    into the middle of its lowest Landau gap through the LDLᴴ kernels
    (indefinite), with an estimate of its κ; and
    ``sparse_helmholtz_3d(32, 32, 32, ω²(1 + 0.05i))``, ω = 2π·33/10.  Each
    in complex64 and complex128: the factor's seconds, K1 launched through
    its complex instantiations on every level with children, the first
    factor taken again with K1 held against the plain extend-add at every
    level (1e-5 / 1e-12 of max|pool|), solve ms, the refined solve's
    relative residual (host, complex128) under the dtype's bound, and for
    the Hermitian ones the solve through the panel inverses (the conjugate
    backward step) against substitution.  K1 alone on the 384² plan in
    both complex dtypes against ``index_add_``, as phase 3, and one
    complex64 factor of each size under ``torch.profiler``.
19. the dense core and the BLAS tier (``core``, ``ops``; plain torch, no
    kernel of the port): ``Grid()`` is 1×1 on the card and every block of
    every result lies there; every [MC,MR] block made by ``distribute``, a
    redistribution or an op owns storage of its own size; an 8192² float64
    matrix on a 2×2 grid over the card through every pair of
    ``DIST_PAIRS`` and back, bit-exact; a
    ``BlockCyclicMatrix`` (nb = 128) round trip and a gemm through the
    conversion; ``ops.gemm`` at 8192³ in float32 and float64, ``alg='xla'``
    on the 1×1 grid and ``stationary_c``, ``stationary_a``, ``stationary_b``
    and ``pipelined`` on the 2×2 grid's blocks, and 8191×8190×8193 on the
    2×2 grid (m and n replicated), each within 1e-5 (float32: TF32 would
    read about 1e-3) and 1e-13 (float64) of the float64 product, with ms
    (CUDA events, 10 launches), TFLOP/s and the ratio to one
    ``torch.matmul`` of the same operands beside the assembled route's
    (run N3), the transfer log
    by kind and the device bytes the call allocates above its operands and
    result (a whole operand gathered on the 2×2 grid is fatal); ``trsm``
    ('L','L','N','N') and ('R','U','C','N') at n = 8192 with 8192
    right-hand sides in float32, float64 and complex64, the
    residual ‖op(T)X − αB‖/(‖T‖‖X‖) under ``residual_bound``, beside
    ``torch.linalg.solve_triangular``; ``herk`` and ``trrk`` at 8192×4096,
    ``symm``, ``hemm`` (complex64) and ``trmm`` at 8192² against the same
    formula in float64; ``herk`` on the 2×2 grid's blocks and ``trsm``
    assembled there (as the JAX HLO gathers it), with their transfers;
    ``gemv``, ``ger``, ``axpy``, ``nrm2`` and ``dot`` at 8192² on the 2×2
    grid's blocks, each with its transfers (a whole operand or result
    gathered is fatal), extra bytes and ratio to the bare op beside the
    assembled route's; ``gemm_3d`` on a 2×2×2 mesh over the card at
    4096³; 10⁵ queued updates on an 8192² matrix against ``index_put_(...,
    accumulate=True)``, and 1000 queued pulls.
20. the sparse products and the distributed sparse containers (plain
    torch, no kernel of the port): ``spgemm_plan`` of the unscaled 1024²
    Laplacian with itself and ``galerkin_plan`` (A·D·Aᵀ, d from the seed,
    the plan reused with a second d) of it and of the LP's
    ``concat_fd_2d(224, 224)``, each numeric in float32 and float64 within
    1e-5 / 1e-12 (relative, Frobenius) of scipy's product with scipy's
    structure: ms (CUDA events, 10 launches), the bound (its index arrays,
    gathered values and C at 3.35 TB/s), the host symbolic seconds, whether
    5 calls gave the same bits, and ``torch.sparse.mm`` (cuSPARSE) of the
    same CSR operands for A·A; then on a 2×2 grid over the card the
    Laplacian's ``DistSparseMatrix``: ``matvec`` and ``matvec_transpose``
    against ``CSRDevice.matvec`` (ms beside it and beside the 1×1 grid),
    the transfer log's bytes per ``DistMultiVec`` matvec beside a full
    gather of x, float32 CG to 1e-6 under phase 9's gate, ``dist_spgemm``
    A·A and ``dist_galerkin`` of the LP's A equal to the 1×1 results within
    the same tolerances, and ``DistMap.translate_device`` of 2²⁰ indices
    equal to ``translate``.
21. every driver of ``elemental_tpu_torch/examples`` (65) in this process
    at its default size with ``--device cuda`` (``lp_direct`` on phase
    16's n1 = 16 MPS file, float64), each held to its own checks, with its seconds
    and K1's launches across them; then ``entry()``'s forward (25 CG
    iterations on the 64² Laplacian, float32) on the card against the
    same forward on the CPU within 1e-4 relative in x and ‖r‖.
22. the dense LAPACK tier (``lapack``, ``matrices``, ``extended``; plain
    torch, no kernel of the port on its path): at 8192² in float32 and
    float64 ``cholesky`` L and U, ``lu``, ``qr`` (reduced), ``ldl`` (the
    unpivoted recursion, SPD), ``symmetric_solve``, ``hpd_solve`` and
    ``linear_solve`` (16 right-hand sides), each with ms (CUDA events),
    TFLOP/s and the ``torch.linalg`` call's time, its relative residual
    (Frobenius) under 1e-5 / 1e-13; at 2048² float64 the host-driven
    ``pivoted_cholesky`` (a rank-512 PSD matrix: the rank found),
    ``lu_full`` and ``ldl_pivoted`` (indefinite, tiny diagonal) with ms and
    host synchronisations; ``tsqr`` of 262,144 × 256 on a 2×2 grid over the
    card, gather and butterfly, beside ``torch.linalg.qr``, with the
    transfer log's bytes equal to p(p−1)·n² and p·log₂p·n² elements; the
    Euclidean minimizations at 8192 × 4096 float64 against float64 host
    solutions at the reference tests' gates; every generator at n = 1024
    on the card (the deterministic ones equal to the CPU's within 1e-14,
    the random ones held to structure and moments); ``dd_gemm`` at 1024³
    float32 words within 1e-12 of the float64 product and
    ``refined_solve_dd`` on the float32 ``cholesky`` at 4096; and K5 timed
    on the Cholesky's top-level trailing update (4096², k = 4096) beside
    the path's ``torch.matmul`` and ``torch.addmm``, with the recursion's
    whole matmul time (a measurement: the path stays ``torch.matmul``).
23. the spectral tier (``lapack`` condense, tridiag_eig, spectral, funcs,
    lattice's drivers; ``control``, ``io``, ``utils.roofline``; plain
    torch, no kernel of the port on its path), float64 unless named, each
    call timed with CUDA events beside the ``torch.linalg`` call that
    computes the same function where there is one, with its group's peak
    device memory and its relative (Frobenius) residuals, direct calls
    gated at 1e-4 (float32) / 1e-12 (float64): at 8192²
    ``hermitian_eig`` 'direct' in float32 and float64 beside ``eigh``,
    ``inverse`` and ``hpd_inverse`` beside ``inv`` and ``cholesky`` +
    ``cholesky_inverse``; at 4096² the blocked ``hermitian_tridiag``
    (float32 and float64), ``hermitian_eig`` 'tridiag', the blocked
    ``hessenberg``, ``bidiag`` and ``svd`` (float32 and float64) of 4096 ×
    2048, with the Python loops' device operators counted; ``polar``,
    ``sign``, ``square_root``, ``symmetric_inverse``, and ``sylvester``,
    ``lyapunov`` (m = n = 2048) and ``ricatti_hamiltonian`` (n = 2048) at
    their reference tests' gates, the iterative ones also on the card
    against the CPU at 1024 within 1e-10; at 2048 the MRRR-slot solver on
    the whole spectrum and on 64 eigenpairs (test_aux_tiers.py's gates,
    against the CPU within 1e-10), the Sturm count against ``eigvalsh``'s
    and the complex128 ``hermitian_tridiag``; at 1024 ``schur`` and ``eig``
    on the host, ``triang_eig`` in complex128 in chunks and the unblocked
    ``hessenberg``; ``pseudospectra`` of ``fox_li(512)`` over 64×64 shifts
    (30 iterations), 16 of them at 200 iterations within 1e-2 of
    ``svdvals`` and at 30 against the CPU; ``lanczos``, ``product_lanczos``
    and ``extremal_singular_value_estimates`` on the unscaled 1024²
    Laplacian's ``CSRDevice`` against the CPU and the analytic spectrum;
    ``roofline.audit`` of K6 ``axpy`` at 8192² against ``bound()``; and an
    ``io`` round trip of an 8192² tensor, bit for bit.
24. the distributed sparse-direct tier (``sparse_direct/dist_front.py``,
    ``numeric.factor(grid=...)``, ``DistSparseLDLFactorization``; K1 on
    its path): the unscaled 48³ Laplacian (N = 110,592), ordered by nested
    dissection (cutoff 64) in a worker beside phase 3 and analysed once
    (relax 8, size buckets 1.5), on a 2×2 grid over the card, ``spd=True``,
    the default thresholds (the distributed front from S = 1536 on levels
    of ≤ 8 fronts, the batch split at nf·S³ ≥ 2e9), which levels took
    each tier; in float64 and float32 the grid's factor and the
    one-device ``SparseLDLFactorization`` of the same plan, each best of 3
    on the host clock with GF/s from ``factor_gflops()``, K1 launched once
    a level with an extend-add in every grid factor and held against the
    plain extend-add on the first, the transfer log's bytes equal to the
    tiers' formula, the fronts' lower triangles and d within 1e-10
    (float64) / 1e-4 (float32) of max|pool| of the one-device factor's,
    the solve residual under ``residual_bound()``, in float32 the refined
    solve under 1e-5, peak GiB, and in float64 one grid and one
    one-device factor under ``torch.profiler`` (kernels launched, device
    busy share).  Where four cards are visible, the same plan's float64
    LDLᵀ (``spd=False``) on a 2×2 grid of four cards, one position a card:
    best of 3 with the first factor's time, K1 once a level with an
    extend-add, K8's launches, the bytes copied between the cards
    (``transfers.peer_bytes``) equal to the tiers' formula, the lower
    triangles and d within 1e-10 of max|pool| of the one-card factor's,
    the solve residual under ``residual_bound()`` and each card's peak
    GiB.  Then ``entry.dryrun_multichip(4)`` on the card at its default
    32³ with the weak-scaling table over 1, 2 and 4 positions (one card,
    repeated positions: bytes, no speed-up), and where four cards are
    visible once more on its default devices, one position a card.
25. K8 ``ldl_panel`` (``csrc/front_panel.cu``), the blocked LDLᵀ front
    factor's panel kernel: the 48³ Laplacian's float64 LDLᵀ through
    ``SparseLDLFactorization(spd=False)`` (phase 24's ordering), one K8
    launch a blocked panel of its plan and a solve within the residual
    bound; then at the largest blocked level of the LP's KKT plan (phase
    3's, float32) and of the 48³ plan (float64): the first panel of every
    front of the level on a random indefinite batch, bit-equal to the
    plain panel loop with its scratch panels, then its time (CUDA events,
    50 launches) beside the bound (the panel read and written and both
    scratch panels written, at 3.35 TB/s) and beside the plain loop's,
    and the whole level's blocked factor
    (``numeric._masked_partial_ldl_blocked``) through K8 and through the
    plain loop, bit-equal, each on the host clock.
26. K9 ``level_scatter`` (``csrc/level_scatter.cu``), the tree solve's
    level scatter, on the LP's KKT plan (phase 3's, float32) and the 48³
    plan (phase 25's factor, float64): on every level of each plan, random
    values, the kernel bit-equal to the plain version run on the CPU and
    to itself over two runs, row n untouched; the launches of one
    refined KKT solve (FGMRES-16 with panel inverses, at a random Θ),
    counted in the call that captures its CUDA graph (a replay launches
    from the card), and of one tree solve with the panel inverses, 2 ×
    levels; that tree solve's time (the KKT's and the 48³ one's; host
    clock, least of 3) through K9 and through the scatter the solve ran
    before (``w - xf`` and ``index_add_`` over every padded slot), the
    two results within rounding (the old atomics add in no fixed order);
    and on level 0 of each plan the kernel, the plain
    version on the card and that old pair (CUDA events) beside the
    kernel's bound (its plan and values read, ``xe`` read and written).
27. K10 ``level_solve`` (``csrc/level_solve.cu``), the plain tree solve's
    level step, on the 48³ plan (phase 25's factor, float64) and the
    LP's KKT plan (float32, factored at a random Θ): on level 0 and on the
    root level, both directions (forward with K9's sum of the update
    slots), from random values, the kernel within 64 ulps of the plain
    version run on the CPU and bit-equal to itself over two runs; its
    time (CUDA events) beside its byte bound (the L panels, each real
    row's value read and each solved or update value written, the plan's
    ids, at 3.35 TB/s), the plain version's on the card and the masked
    step it replaced (masked S×S panels, one batched triangular solve,
    ``index_add_`` over every slot); then one whole plain solve: its K10
    launches (two a panel on a split level, else one, a direction), the
    same bits twice, and its time (host clock, least of 3) against the
    masked path's, within rounding of it.

Then one JSON line of kernel results (each with its bound: the bytes it
must move at 3.35 TB/s or its operations at the dtype's peak, whichever
is longer, from ``utils.roofline``'s H100 SXM entry, and the time of one PyTorch call that computes the same
function, or null), and as the last line
``{"ok": true, "device": {...}}``.  Needs a CUDA card: without one (or
without the package beside it) it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

sys.modules["jax"] = None       # the port must run with no JAX at all


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, queued: bool = True) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events).  With
    ``queued``, one more run is queued ahead of the start event, so the card
    is busy while the host issues the first timed launch and the window
    holds device time, not the host's launch cost; without it the window
    opens on an idle card, as every time before PR 4 was taken."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        fn()
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


def bound(nbytes: float, flops: float = 0.0, dtype: str = "float32"):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the longer of the bytes at the HBM rate and the FLOPs at the dtype's
    peak, both from the H100 SXM entry of the port's
    ``utils.roofline.CHIPS`` (NVIDIA's data sheet: bfloat16 and float64 on
    the tensor cores, float32 on the CUDA cores, as K4's float32 is never
    TF32)."""
    from elemental_tpu_torch.utils.roofline import CHIPS
    spec = CHIPS["h100 sxm"]
    peak = {"bfloat16": spec.peak_bf16, "float64": spec.peak_f64,
            "float32": spec.peak_f32}[dtype]
    t_bytes = nbytes / spec.hbm_bw * 1e3
    t_ops = flops / peak * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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
    from elemental_tpu_torch.kernels import (elementwise, extend_add,
                                             front_panel, level_scatter,
                                             level_solve, matmul, spmv,
                                             unstructured)

    def timed(build):
        t0 = time.perf_counter()
        return build(), time.perf_counter() - t0

    builds = (("K1 extend_add", extend_add.build),
              ("K2 gather_spmv", unstructured.build),
              ("K3 stencil_spmv", spmv.build),
              ("stream gather + K7 combine", unstructured.build_bridged),
              ("K4 simt + K5 simt", matmul.build),
              ("K4 wgmma + dmma + ffma, K5 ffma + dmma", matmul.build_sm90),
              ("K6 elementwise", elementwise.build),
              ("K8 ldl_panel", front_panel.build),
              ("K9 level_scatter", level_scatter.build),
              ("K10 level_solve", level_solve.build))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(builds)) as pool:
        jobs = [(name, pool.submit(timed, build)) for name, build in builds]
        built = [(name, *job.result()) for name, job in jobs]
    for name, path, dt in built:
        print(f"[2 build] {name} built with nvcc for sm_90a in {dt:.2f} s "
              f"-> {path}")
    print(f"[2 build] all kernels in {time.perf_counter() - t0:.2f} s")


def graph_ms(fn, reps: int = 20) -> float:
    """Mean milliseconds of one replay of a CUDA graph captured around
    ``fn()``: the device time of its kernels, without the host's cost of
    issuing them one by one."""
    import torch
    fn()                                    # warm outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return cuda_ms(g.replay, reps)


def host_us(fn, calls: int, reps: int = 3) -> float:
    """Host microseconds a call when ``fn()`` issues ``calls`` calls (no
    synchronisation inside the window; the least of ``reps`` windows)."""
    import torch
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    torch.cuda.synchronize()
    return best / calls * 1e6


def phase_k1(plan, seed: int, tols=None, tag: str = "3 K1"):
    """K1 against ``index_add_`` on every level of an extend-add plan, for
    each dtype of ``tols`` (dtype: gate as a fraction of max|pool|; float32
    and float64 by default): issued from the host as the factor issues it,
    and replayed as a CUDA graph (device time)."""
    import torch
    from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                        extend_add_plain)
    tols = tols or {torch.float32: 1e-5, torch.float64: 1e-12}
    levels = [plan.levels[li] for li in sorted(plan.levels)]
    runs = sum(lv.n_runs for lv in levels)
    dests = sum(lv.n_dest for lv in levels)
    print(f"[{tag}] plan: {len(levels)} levels, {plan.n_pairs} pairs, "
          f"{dests} destinations, {runs} runs "
          f"({sum(lv.n_run_pairs for lv in levels)} pairs, "
          f"{sum(lv.n_run_pairs for lv in levels) / max(runs, 1):.1f} a "
          f"run), {sum(lv.n_multi for lv in levels)} destinations with two "
          f"sources or more")
    out = {}
    for dtype, rtol in tols.items():
        g = torch.Generator(device="cuda").manual_seed(seed)
        pool0 = torch.rand(plan.pool_size, generator=g, device="cuda",
                           dtype=dtype)
        pk, pk2, pp = pool0.clone(), pool0.clone(), pool0.clone()
        for lv in levels:
            extend_add(pk, lv)
            extend_add(pk2, lv)
            extend_add_plain(pp, lv)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        scale = float(pp.abs().max())
        check(err <= rtol * scale,
              f"K1 {dtype} max|err| {err:.3e} > {rtol:g}·max|pool| "
              f"({scale:.3e})")
        check(torch.equal(pk, pk2), f"K1 {dtype}: two runs differ")
        del pk2

        def run_kernel():
            for lv in levels:
                extend_add(pk, lv)

        def run_plain():
            for lv in levels:
                extend_add_plain(pp, lv)

        ms, plain_ms = time_pair(run_kernel, run_plain, reps=5)
        g_ms = graph_ms(run_kernel)
        try:
            g_plain = graph_ms(run_plain)
        except RuntimeError as e:           # not capturable: say so
            print(f"[{tag}] index_add_ could not be captured: {e}")
            g_plain = None
        us, plain_us = (host_us(run_kernel, len(levels)),
                        host_us(run_plain, len(levels)))
        # the values any implementation moves: each source read once, each
        # destination read and written once
        item = pk.element_size()
        values = sum(lv.n_pairs * item + 2 * lv.n_dest * item
                     for lv in levels)
        b_ms, b_by = bound(values)
        out[dtype] = dict(err=err, scale=scale, ms=ms, plain_ms=plain_ms,
                          graph_ms=g_ms, graph_plain_ms=g_plain,
                          bound=(b_ms, b_by))
        g_plain_txt = "n/a" if g_plain is None else f"{g_plain:.4f}"
        line = (f"[{tag}] {str(dtype)[6:]}: max|err| {err:.3e} (max|pool| "
                f"{scale:.3e}), two runs bit-equal; one factor's "
                f"extend-add: issued from the host kernel {ms:.4f} ms, "
                f"index_add_ {plain_ms:.4f} ms; as a CUDA graph kernel "
                f"{g_ms:.4f} ms, index_add_ {g_plain_txt} ms; host "
                f"{us:.1f} us a kernel call, {plain_us:.1f} us an "
                f"index_add_ call; values bound {b_ms:.4f} ms "
                f"({values / 1e6:.0f} MB), graph time "
                f"{b_ms / g_ms:.3f} of it")
        if dtype == torch.float32:
            # the bound as first counted: with a destination-sorted plan's
            # index bytes
            idx = levels[0].src.element_size()
            old = sum(lv.n_pairs * (idx + item) + (lv.n_dest + 1) * idx
                      + lv.n_dest * (idx + 2 * item) for lv in levels)
            line += (f"; counting a destination-sorted plan's index bytes "
                     f"as well, as the bound once did: {bound(old)[0]:.4f} "
                     f"ms")
        print(line)
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
    from elemental_tpu_torch.kernels.front_panel import ldl_panel
    from elemental_tpu_torch.optimization import LPCtrl, lp_direct
    from elemental_tpu_torch.optimization.kkt import KKTFactor
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
    # what prepare's zero-pivot check costs: prepare against its own steps
    # without the check (order: without, with, with, without), and the
    # check alone, reading a finished factor

    def unchecked():
        v, _ = kkt.equilibrate(vals)
        return numeric.factor(kkt.symb, v, ea_plan=kkt.ea_plan, dtype=f32)

    runs = {"with": lambda: kkt.prepare(vals), "without": unchecked}
    t_pair = dict.fromkeys(runs, 0.0)
    for label in ("without", "with", "with", "without"):
        t_pair[label] += wall(runs[label])[1] / 2
    _, t_check = wall(lambda: [bool((fk.d == 0).any()) for _ in range(10)])
    ctx, t_ctx = wall(fk.solve_context)
    reg_diag = torch.cat([torch.full((n,), gamma), torch.full((m,), -gamma)]
                         ).to("cuda", f32)
    rhs = torch.cat([torch.zeros(n), torch.as_tensor(b / r)]).to("cuda", f32)
    # the first call captures the refined solve as a CUDA graph, the
    # second replays it; the same sweep issued from the host beside it
    fk.solve_refined(rhs, reg_diag, iters=nref, ctx=ctx)
    _, t_sweep = wall(lambda: fk.solve_refined(rhs, reg_diag, iters=nref,
                                               ctx=ctx))
    fk._fgmres(rhs, reg_diag, nref, ctx)                    # warm
    _, t_eager = wall(lambda: fk._fgmres(rhs, reg_diag, nref, ctx))
    print(f"[5 LP] first KKT factor: K1 {t_factor:.3f} s, plain extend-add "
          f"{t_plain:.3f} s, pools agree to {err:.3e} (max|pool| "
          f"{scale:.3e}); prepare with its zero-pivot check "
          f"{t_pair['with']:.3f} s, without it {t_pair['without']:.3f} s "
          f"(mean of two each), the check alone "
          f"{t_check / 10 * 1e3:.3f} ms; panel inverses {t_ctx:.3f} s; "
          f"FGMRES-{nref} sweep {t_sweep * 1e3:.2f} ms as a graph replay, "
          f"{t_eager * 1e3:.2f} ms issued from the host")
    del fk, ctx

    levels_with_children = len(kkt.ea_plan.levels)
    panels = blocked_panels(kkt.symb)
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
    ldl_panel.launches = 0
    graphs = KKTFactor.solve_refined
    counts = (graphs.captures, graphs.replays)
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return graphs(*args, **kw)

    KKTFactor.solve_refined = counted
    try:
        res, t_lp = solve(max_iters)
    finally:
        KKTFactor.solve_refined = graphs
    launches = extend_add.launches
    k8_launches = ldl_panel.launches
    captures = graphs.captures - counts[0]
    replays = graphs.replays - counts[1]
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
    # one K8 launch a blocked panel of every factor; a zero pivot retakes
    # the whole factor with floors
    check(panels > 0 and k8_launches % panels == 0
          and k8_launches >= factors * panels,
          f"K8 launched {k8_launches} times, expected a multiple of the "
          f"plan's {panels} blocked panels, at least {factors} factors' "
          f"worth")
    # one graph a factor (the start's and each iteration's), captured by
    # its first refined solve and replayed by the others
    check(captures == factors and replays == calls[0] - captures,
          f"refined-solve graphs: {captures} captures and {replays} "
          f"replays over {calls[0]} refined solves against {factors} "
          f"factors")
    print(f"[5 LP] lp_direct concat_fd_2d m={m} n={n} f32: {res.iterations} "
          f"iterations in {t_lp:.2f} s; a max_iters=0 run (analysis and "
          f"starting point) took {t_start:.2f} s, so "
          f"{(t_lp - t_start) / res.iterations:.3f} s/iteration; relative "
          f"primal residual {r0:.3e} -> {r1:.3e}; metric {res.metric:.3e}, "
          f"converged={res.converged}; K1 launches {launches} = {factors} "
          f"factors x {levels_with_children} levels; K8 launches "
          f"{k8_launches} = {k8_launches // panels} factors x {panels} "
          f"blocked panels; {calls[0]} refined solves: {captures} graph "
          f"captures (one a factor), {replays} replays; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, k8_launches, dict(captures=captures, replays=replays,
                                       refined_solves=calls[0])


def time_pair(kernel, plain, reps: int = 100, queued: bool = True):
    """(kernel ms, plain ms): each warmed, then timed over ``reps``
    back-to-back launches in the order plain, kernel, kernel, plain."""
    kernel(), plain()
    p1, k1 = cuda_ms(plain, reps, queued), cuda_ms(kernel, reps, queued)
    k2, p2 = cuda_ms(kernel, reps, queued), cuda_ms(plain, reps, queued)
    return (k1 + k2) / 2, (p1 + p2) / 2


def spmv_cases(tag, M, kind, launch, plain, seed, tols=(1e-5, 1e-12)):
    """Plan ``M`` with ``plan_spmv`` on the card (asserting ``kind``); in
    float32 and float64 drive one ``SpMVPlan.matvec`` (the main path, its
    kernel launches counted), hold it against the plain version and scipy
    (to ``tols`` of max|y|), and time kernel and plain.  Returns the main
    path's launches and the float32 result."""
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
    idx = torch.int32 if M.nnz < 2**31 else torch.int64
    crow = torch.from_numpy(A_sp.indptr).to("cuda", idx)
    ccol = torch.from_numpy(A_sp.indices).to("cuda", idx)
    for dtype, tol in zip((torch.float32, torch.float64), tols):
        plan = host.to("cuda", dtype)
        x = torch.from_numpy(x64).to("cuda", dtype)
        part = plan.stencil if plan.stencil is not None else plan.gather
        # the library's y = A·x: torch's CSR product (cuSPARSE)
        csr = torch.sparse_csr_tensor(
            crow, ccol, torch.from_numpy(A_sp.data).to("cuda", dtype),
            size=A_sp.shape)
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
        lib_err = float((csr @ x - y).abs().max())
        check(lib_err <= 10 * tol * scale, f"{tag} {dtype}: cuSPARSE vs "
              f"kernel max|err| {lib_err:.3e}")
        ms, plain_ms = time_pair(lambda: launch(part, x),
                                 lambda: plain(part, x))
        _, lib_ms = time_pair(lambda: launch(part, x), lambda: csr @ x)
        gbs = plan.stream_bytes / (ms * 1e-3) / 1e9
        print(f"{tag} {str(dtype)[6:]}: n={M.height} nnz={M.nnz}, "
              f"plan {t_plan:.2f} s (host); max|err| vs plain {err:.3e}, "
              f"vs scipy {host_err:.3e}, vs cuSPARSE {lib_err:.3e} (max|y| "
              f"{scale:.3e}); kernel {ms:.4f} ms ({gbs:.0f} GB/s of "
              f"stream_bytes), plain {plain_ms:.4f} ms, cuSPARSE CSR "
              f"{lib_ms:.4f} ms (kernel/cuSPARSE {ms / lib_ms:.2f}) over 100 "
              f"launches")
        if dtype == torch.float32:
            out = dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                       bound=bound(plan.stream_bytes))
        del plan, x, y, ref, csr
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


def skewed_zipf(seed: int):
    """n = 2^20 rows with power-law lengths (zipf(1.93) - 1, capped at
    65,536): about 10·n entries, 58 % of the rows empty, ~140 rows of 10^4
    entries or more; uniform random columns."""
    import numpy as np
    from elemental_tpu_torch.sparse import SparseMatrix
    n = 1 << 20
    rng = np.random.default_rng(seed)
    lengths = np.minimum(rng.zipf(1.93, n) - 1, 65536)
    nnz = int(lengths.sum())
    return SparseMatrix.from_coo(n, n, np.repeat(np.arange(n), lengths),
                                 rng.integers(0, n, nnz),
                                 rng.standard_normal(nnz))


def phase_k2(A, seed: int):
    """K2 on the uniform-random CSR of :func:`random_d10`, then on the
    skewed rows of :func:`skewed_zipf` (printed, not gated on time)."""
    from elemental_tpu_torch.kernels.unstructured import (gather_spmv,
                                                          gather_spmv_plain)
    launches, out = spmv_cases("[8 K2] uniform random d=10", A, "gather_csr",
                               gather_spmv, gather_spmv_plain, seed)
    S = skewed_zipf(seed)
    lengths = S.row_nnz()
    print(f"[8 K2] skewed rows: n={S.height} nnz={S.nnz}, "
          f"{int((lengths == 0).sum())} empty rows, "
          f"{int((lengths >= 10**4).sum())} rows of 10^4 entries or more, "
          f"longest {int(lengths.max())}")
    # rows of up to 65,536 terms: the sums' rounding grows with the row
    # (and index_add_ and cuSPARSE add in orders of their own), so the
    # gates are ten times the uniform matrix's
    n, _ = spmv_cases("[8 K2] skewed zipf rows", S, "gather_csr",
                      gather_spmv, gather_spmv_plain, seed,
                      tols=(1e-4, 1e-11))
    return launches + n, out


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
        combine_in_plan_order, gather_spmv, onehot_combine_bucketed,
        onehot_combine_bucketed_plain, plan_bridged_spmv, plan_combine,
        plan_gather_spmv, stream_gather, stream_gather_plain)
    from elemental_tpu_torch.sparse import plan_spmv
    t0 = time.perf_counter()
    host = plan_spmv(A, kind="bridged")
    t_plan = time.perf_counter() - t0
    check(host.kind == "bridged", f"bridged: plan_spmv gave {host.kind!r}")
    g = host.gather
    print(f"[10 bridged] n={A.height} nnz={A.nnz}: host plan {t_plan:.2f} s; "
          f"{g.nbuckets} buckets of {g.bucket} rows, SUB={g.sub}, "
          f"{g.slots} slots ({g.slots / A.nnz - 1:.4f} padding); K7's "
          f"summation order is "
          f"{'the slots' if g.combine.order is None else 'permuted'}")
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
        cp = bp.combine
        yk = onehot_combine_bucketed(Pk, bp.lr, bucket=bp.bucket, plan=cp)
        ck = onehot_combine_bucketed_plain(Pk, bp.lr, bp.bucket)
        c_err = float((yk - ck).abs().max())
        check(c_err <= 1e-5 * float(ck.abs().max()),
              f"bridged {dtype}: K7 vs index_add_ max|err| {c_err:.3e}")
        # the fixed order: K7 has the bits of the plain sum in plan order,
        # with or without the prebuilt plan, and K7 and the whole matvec
        # keep their bits over 5 calls
        check(torch.equal(bits(yk), bits(combine_in_plan_order(Pk, cp))),
              f"bridged {dtype}: K7 is not bit-equal to its sums in plan "
              f"order")
        check(torch.equal(bits(yk), bits(onehot_combine_bucketed(
            Pk, bp.lr, bucket=bp.bucket))), f"bridged {dtype}: K7 without "
              f"a prebuilt plan gives other bits")
        y_bits = bits(y)
        for _ in range(5):
            check(torch.equal(bits(onehot_combine_bucketed(
                Pk, bp.lr, bucket=bp.bucket, plan=cp)), bits(yk)),
                f"bridged {dtype}: K7's bits changed between calls")
            check(torch.equal(bits(plan.matvec(x)), y_bits),
                  f"bridged {dtype}: the matvec's bits changed between "
                  f"calls")
        ms_g, plain_g = time_pair(lambda: stream_gather(bp, x),
                                  lambda: stream_gather_plain(bp, x))
        ms_c, plain_c = time_pair(
            lambda: onehot_combine_bucketed(Pk, bp.lr, bucket=bp.bucket,
                                            plan=cp),
            lambda: onehot_combine_bucketed_plain(Pk, bp.lr, bp.bucket))
        # without a plan the wrapper sorts LR on every call
        ms_bare = cuda_ms(lambda: onehot_combine_bucketed(
            Pk, bp.lr, bucket=bp.bucket), 20)
        ms_build = cuda_ms(lambda: plan_combine(bp.lr, bp.bucket), 20)
        ms_all, plain_all = time_pair(
            lambda: plan.matvec(x),
            lambda: onehot_combine_bucketed_plain(
                stream_gather_plain(bp, x).view(bp.lr.shape), bp.lr,
                bp.bucket)[:A.height])
        k2 = plan_gather_spmv(A).to("cuda", dtype)
        ms_b, ms_k2 = time_pair(lambda: plan.matvec(x),
                                lambda: gather_spmv(k2, x))
        dev_b = device_us(lambda: plan.matvec(x))
        dev_k2 = device_us(lambda: gather_spmv(k2, x))
        gbs = plan.stream_bytes / (ms_all * 1e-3) / 1e9
        # the stream gather reads each slot's column and value and x once,
        # and writes P; K7's yardstick reads P and LR and writes the
        # float32 y; the kernel itself reads P and the plan (offsets, and
        # order where there is one) instead of LR
        g_bytes = (bp.slots * (bp.cols_b.element_size()
                               + bp.vals_b.element_size() + Pk.element_size())
                   + A.width * x.element_size())
        c_bytes = (bp.slots * (Pk.element_size() + bp.lr.element_size())
                   + 4 * yk.numel())
        read_bytes = (bp.slots * Pk.element_size() + 4 * cp.offsets.numel()
                      + (0 if cp.order is None else 4 * cp.order.numel())
                      + 4 * yk.numel())
        print(f"[10 bridged] {str(dtype)[6:]}: y float32, max|err| vs plain "
              f"{err:.3e}, vs scipy {host_err:.3e} (max|y| {scale:.3e}); K7 "
              f"bit-equal to its sums in plan order, with and without the "
              f"prebuilt plan, and K7 and the matvec bit-stable over 5 "
              f"calls; stream gather {ms_g:.4f} ms vs plain {plain_g:.4f} "
              f"ms (bound {bound(g_bytes)[0]:.4f}); K7 with the plan "
              f"{ms_c:.4f} ms (bound P+LR+y {bound(c_bytes)[0]:.4f}, what it "
              f"reads: P+plan+y {bound(read_bytes)[0]:.4f}), without a plan "
              f"{ms_bare:.4f} ms, plan build {ms_build:.4f} ms, index_add_ "
              f"{plain_c:.4f} ms (max|err| {c_err:.3e}); whole matvec "
              f"{ms_all:.4f} ms ({gbs:.0f} GB/s of stream_bytes) vs plain "
              f"path {plain_all:.4f} ms; bridged {ms_b:.4f} ms vs K2 "
              f"gather_csr {ms_k2:.4f} ms ({ms_b / ms_k2:.2f}x, over 100 "
              f"launches each)")
        print(f"[10 bridged] {str(dtype)[6:]} device time (torch.profiler, "
              f"us a call): matvec {fmt_us(dev_b)}; K2 {fmt_us(dev_k2)}; "
              f"bridged/K2 {total_us(dev_b) / total_us(dev_k2):.2f}")
        out[dtype] = dict(err=err, g_err=g_err, c_err=c_err, ms_g=ms_g,
                          plain_g=plain_g, ms_c=ms_c, plain_c=plain_c,
                          g_bound=bound(g_bytes), c_bound=bound(c_bytes))
        del plan, bp, x, y, P, Pk, yk, ck, ref, k2, cp
    # rows of every length (phase 8's skewed zipf matrix: K7's warp and
    # block tiers), and phase 8's uniform matrix with its slots shuffled
    # within each bucket (K7 through a permutation, as on the reference's
    # route layout); checked, times printed, not gated on time
    S = skewed_zipf(seed)
    for label, hp, M in (("skewed zipf rows", plan_bridged_spmv(S), S),
                         ("uniform d=10, shuffled slots", shuffled(g, seed),
                          A)):
        for dtype in (torch.float32, torch.float64):
            bridged_rows(label, hp, M, dtype, seed)
    return launches, out[torch.float32]


def shuffled(plan, seed: int):
    """The host ``BridgedPlan`` with its slots shuffled within each
    bucket."""
    import numpy as np
    from elemental_tpu_torch.kernels.unstructured import _make_bridged
    nb = plan.nbuckets
    per = plan.slots // nb
    perm = (np.argsort(np.random.default_rng(seed).random((nb, per)), axis=1)
            + per * np.arange(nb)[:, None]).reshape(-1)
    return _make_bridged(plan.n_rows, plan.n_cols, plan.nnz, plan.bucket,
                         plan.precision, plan.cols_b.numpy()[perm],
                         plan.vals_b.numpy()[perm],
                         plan.lr.numpy().reshape(-1)[perm].reshape(
                             plan.lr.shape))


def bridged_rows(label, host, M, dtype, seed: int) -> None:
    """K7 and the bridged matvec of the host plan ``host`` of ``M``: K7
    bit-equal to its sums in plan order, the same bits over 5 calls, within
    1e-5·max|y| of the exact sums of P; the matvec within 1e-5·max|y| of
    scipy; device times (torch.profiler) of K7, the matvec and K2."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.unstructured import (
        combine_in_plan_order, gather_spmv, onehot_combine_bucketed,
        plan_gather_spmv, stream_gather)
    plan = host.to("cuda", dtype)
    cp = plan.combine
    x64 = np.random.default_rng(seed).standard_normal(M.width)
    x = torch.from_numpy(x64).to("cuda", dtype)
    P = stream_gather(plan, x).view(plan.lr.shape)
    y = onehot_combine_bucketed(P, plan.lr, bucket=plan.bucket, plan=cp)
    tag = f"bridged {label} {str(dtype)[6:]}"
    check(torch.equal(bits(y), bits(combine_in_plan_order(P, cp))),
          f"{tag}: K7 is not bit-equal to its sums in plan order")
    for _ in range(5):
        check(torch.equal(bits(onehot_combine_bucketed(
            P, plan.lr, bucket=plan.bucket, plan=cp)), bits(y)),
            f"{tag}: K7's bits changed between calls")
    nb = plan.nbuckets
    lr = plan.lr.reshape(nb, -1).long()
    keep = (lr >= 0) & (lr < plan.bucket) & (plan.cols_b.view(nb, -1) >= 0)
    rows = (lr + plan.bucket * torch.arange(nb, device="cuda")[:, None])[keep]
    exact = torch.zeros(y.numel(), dtype=torch.float64, device="cuda")
    exact.index_add_(0, rows, P.reshape(nb, -1).float()[keep].double())
    c_err = float((y - exact).abs().max())
    check(c_err <= 1e-5 * float(exact.abs().max()),
          f"{tag}: K7 vs the exact sums max|err| {c_err:.3e}")
    ym = plan.matvec(x)
    expect = M.to_scipy().astype(np.float64) @ x.cpu().numpy().astype(
        np.float64)
    m_err = float(np.abs(ym.cpu().numpy() - expect).max())
    check(m_err <= 1e-5 * np.abs(expect).max(),
          f"{tag}: the matvec vs scipy max|err| {m_err:.3e}")
    k2 = plan_gather_spmv(M).to("cuda", dtype)
    dev_c = device_us(lambda: onehot_combine_bucketed(
        P, plan.lr, bucket=plan.bucket, plan=cp))
    dev_b = device_us(lambda: plan.matvec(x))
    dev_k2 = device_us(lambda: gather_spmv(k2, x))
    print(f"[10 bridged] {label} {str(dtype)[6:]}: nnz={M.nnz}, "
          f"{plan.slots} slots, K7 tiers: {cp.block_rows.numel()} block "
          f"rows, {cp.warp_rows.numel()} warp rows, order "
          f"{'none' if cp.order is None else 'permuted'}; K7 bit-equal to "
          f"plan order and bit-stable over 5 calls, max|err| vs exact "
          f"{c_err:.3e}, matvec vs scipy {m_err:.3e}; device time (us a "
          f"call): K7 {fmt_us(dev_c)}; matvec {fmt_us(dev_b)}; K2 "
          f"{fmt_us(dev_k2)}; bridged/K2 "
          f"{total_us(dev_b) / total_us(dev_k2):.2f}")


def device_us(fn, reps: int = 50) -> dict:
    """{kernel name: (launches a call, mean device µs a call)} of each
    CUDA kernel that ``fn()`` launches, from ``torch.profiler`` over
    ``reps`` calls (5 warm first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count // reps, e.device_time_total / reps)
            for e in prof.key_averages() if e.device_time_total > 0}


def total_us(times: dict) -> float:
    return sum(us for _, us in times.values())


def fmt_us(times: dict) -> str:
    """``name µs`` for each kernel of :func:`device_us`: the function's
    name, without namespace, template or parameters."""
    def short(k):
        k = k.replace("(anonymous namespace)::", "")
        return k.split("(")[0].split("<")[0].split()[-1].split("::")[-1]
    return ", ".join(f"{short(k)} {us:.2f}" for k, (_, us) in times.items())


def phase_k4(seed: int):
    """K4 at 4096³ (``bench.py``'s GEMM) in float32, bfloat16, float64
    through the ffma, wgmma and dmma paths, at 3000×1000×2056 through the
    same paths (ragged against every tile), and at 4096×4095×4096 float32
    (off the 16-byte vectors: the SIMT path).  cuBLAS, the plain version,
    runs without TF32 and with float32 sums for bfloat16 (no
    reduced-precision reduction), as K4 does."""
    import torch
    from elemental_tpu_torch.kernels import matmul as mm
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    n = 4096
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a64 = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    b64 = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    # gates against max|C| of the float64 product of the same (rounded)
    # inputs: float32 sums in float32 (TF32 would leave ~1e-3); bfloat16
    # rounds the output once (unit roundoff 2^-8) after float32 sums;
    # float64 sums in float64
    paths = ((torch.float32, "ffma", 1e-5), (torch.bfloat16, "wgmma",
                                             2.0**-8 + 1e-5),
             (torch.float64, "dmma", 1e-12))

    def operands(m, k, nn, dtype):
        return (a64[:m, :k].to(dtype).contiguous(),
                b64[:k, :nn].to(dtype).contiguous())

    cases = [(f"{n}^3", dtype, path, gate, *operands(n, n, n, dtype))
             for dtype, path, gate in paths]
    cases += [("3000x1000x2056", dtype, path, gate,
               *operands(3000, 1000, 2056, dtype))
              for dtype, path, gate in paths]
    cases.append(("4096x4095x4096", torch.float32, "simt", 1e-5,
                  *operands(n, n - 1, n, torch.float32)))

    # the main path: each product once through the wrapper, each launch
    # counted by its path
    mm.matmul.launches = 0
    mm.matmul.launches_by_path = dict.fromkeys(mm.PATHS, 0)
    outs = []
    for label, dtype, path, _, a, b in cases:
        before = dict(mm.matmul.launches_by_path)
        outs.append(mm.matmul(a, b))
        check(mm.matmul.launches_by_path[path] - before[path] == 1
              and mm.matmul.launches == len(outs),
              f"K4 {label} {dtype}: not one launch of the {path} path "
              f"({before} -> {mm.matmul.launches_by_path})")
    torch.cuda.synchronize()
    launches = dict(mm.matmul.launches_by_path)

    out = {}
    for (label, dtype, path, gate, a, b), c in zip(cases, outs):
        m, k = a.shape
        nn = b.shape[1]
        check(c.dtype == dtype and c.shape == (m, nn),
              f"K4 {label} {dtype}: C is {c.dtype} {tuple(c.shape)}")
        exact = a.double() @ b.double()
        scale = float(exact.abs().max())
        err = float((c.double() - exact).abs().max())
        check(err <= gate * scale, f"K4 {label} {dtype}: max|err| vs the "
              f"float64 product {err:.3e} > {gate:g}·max|C| ({scale:.3e})")
        lib = mm.matmul_plain(a, b).double()
        err_lib = float((c.double() - lib).abs().max())
        if label == f"{n}^3":
            # the SIMT kernel on the same operands, held to the same gates
            simt = mm._run_matmul(a, b, "simt").double()
            simt_err = float((simt - exact).abs().max())
            simt_err_lib = float((simt - lib).abs().max())
            check(simt_err <= gate * scale, f"K4 {label} {dtype} simt: "
                  f"max|err| vs the float64 product {simt_err:.3e} > "
                  f"{gate:g}·max|C| ({scale:.3e})")
            del simt
        del exact, lib
        ms, lib_ms = time_pair(lambda: mm._run_matmul(a, b, path),
                               lambda: mm.matmul_plain(a, b), reps=10)
        flop = 2.0 * m * k * nn
        name = str(dtype)[6:]
        b_ms, b_by = bound((m * k + k * nn + m * nn) * a.element_size(),
                           flop, name)
        line = (f"[11 K4] {label} {name} {path}: max|err| vs float64 "
                f"product {err:.3e} ({err / scale:.2e}·max|C|, gate "
                f"{gate:g}), vs cuBLAS {err_lib:.3e}; kernel {ms:.4f} ms "
                f"({flop / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the "
                f"{b_ms:.4f} ms bound), cuBLAS {lib_ms:.4f} ms "
                f"({flop / lib_ms / 1e9:.1f} TFLOP/s), kernel/cuBLAS "
                f"{ms / lib_ms:.2f} over 10 launches")
        if label == f"{n}^3":
            simt_ms = cuda_ms(lambda: mm._run_matmul(a, b, "simt"), 5)
            line += (f"; the SIMT kernel: max|err| vs float64 product "
                     f"{simt_err:.3e}, vs cuBLAS {simt_err_lib:.3e}, "
                     f"{simt_ms:.3f} ms "
                     f"({flop / simt_ms / 1e9:.1f} TFLOP/s, "
                     f"{simt_ms / ms:.1f}x the {path} path's time)")
            out[path] = dict(err=err_lib, ms=ms, plain_ms=lib_ms,
                             bound=(b_ms, b_by))
        elif path == "simt":
            out[path] = dict(err=err_lib, ms=ms, plain_ms=lib_ms,
                             bound=(b_ms, b_by))
        print(line)
    del cases, outs, a64, b64
    return launches, out


def bits(t):
    """``t``'s bits as integers, for bit-for-bit comparisons."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def phase_k5(seed: int):
    """K5 at m = n = 4096, k = 128 (the trailing update of a blocked
    Cholesky, C − L·Lᵀ, at the library's default blocksize), lower and
    upper, through the ffma (float32) and dmma (float64) paths, and at
    4096×4094 float32 with k = 127 (off the 16-byte vectors: the SIMT
    path), each asserted by its counter.  Each against the plain version
    (TF32 off), the other triangle bit-equal to c, the same bits on a second
    call; at 4096² the SIMT kernel on the same operands (held to the same
    checks) and ``torch.addmm`` over the whole square beside it, in event
    time and in device time."""
    import torch
    from elemental_tpu_torch.kernels import matmul as mm
    torch.backends.cuda.matmul.allow_tf32 = False
    n, k = 4096, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def operands(m, kk, nn, dtype):
        return tuple(torch.randn(*shape, generator=gen, device="cuda",
                                 dtype=dtype)
                     for shape in ((m, nn), (m, kk), (kk, nn)))

    cases = []
    for dtype, path, tol in ((torch.float32, "ffma", 1e-5),
                             (torch.float64, "dmma", 1e-12)):
        ops = operands(n, k, n, dtype)
        cases += [(f"{n}x{n} rank {k}", dtype, path, tol, lower, *ops)
                  for lower in (True, False)]
    cases.append((f"{n}x{n - 2} rank {k - 1}", torch.float32, "simt", 1e-5,
                  True, *operands(n, k - 1, n - 2, torch.float32)))

    # the main path: each update once through the wrapper, each launch
    # counted by its path
    counter = mm.masked_rank_k_update
    counter.launches = 0
    counter.launches_by_path = dict.fromkeys(mm.RANK_K_PATHS, 0)
    outs = []
    for label, dtype, path, _, lower, c, a, b in cases:
        before = dict(counter.launches_by_path)
        outs.append(mm.masked_rank_k_update(c, a, b, alpha=-1.0, lower=lower))
        check(counter.launches_by_path[path] - before[path] == 1
              and counter.launches == len(outs),
              f"K5 {label} {dtype}: not one launch of the {path} path "
              f"({before} -> {counter.launches_by_path})")
    torch.cuda.synchronize()
    launches = dict(counter.launches_by_path)

    out = {}
    for (label, dtype, path, tol, lower, c, a, b), o in zip(cases, outs):
        m, nn = c.shape
        name = str(dtype)[6:]
        tag = f"{label} {name} {'lower' if lower else 'upper'} {path}"
        rows = torch.arange(m, device="cuda")[:, None]
        cols = torch.arange(nn, device="cuda")[None, :]
        mask = rows >= cols if lower else rows <= cols
        ref = mm.masked_rank_k_update_plain(c, a, b, -1.0, lower)
        scale = float(ref.abs().max())

        def held(got, what):
            err = float((got - ref).abs().max())
            check(err <= tol * scale, f"K5 {tag}{what}: max|err| {err:.3e} "
                  f"> {tol:g}·max|C| ({scale:.3e})")
            check(torch.equal(bits(got)[~mask], bits(c)[~mask]),
                  f"K5 {tag}{what}: the other triangle is not c")
            return err

        def kernel(p=path):
            return mm._run_rank_k(c, a, b, -1.0, lower, p)

        err = held(o, "")
        check(torch.equal(bits(kernel()), bits(o)),
              f"K5 {tag}: the bits changed on a second call")
        ms, plain_ms = time_pair(
            kernel, lambda: mm.masked_rank_k_update_plain(c, a, b, -1.0,
                                                          lower), reps=20)
        # c read and out written whole, a and b read once; the triangle's
        # product is 2k FLOPs an entry
        b_ms, b_by = bound((2 * m * nn + (m + nn) * a.shape[1])
                           * c.element_size(),
                           2.0 * a.shape[1] * int(mask.sum()), name)
        line = (f"[12 K5] {tag}: max|err| vs plain {err:.3e} (max|C| "
                f"{scale:.3e}), other triangle bit-equal to c, the same bits "
                f"on a second call; kernel {ms:.4f} ms ({b_ms / ms:.3f} of "
                f"the {b_ms:.4f} ms bound, by {b_by}), plain "
                f"{plain_ms:.4f} ms over 20 launches")
        if path != "simt":
            def addmm():
                return torch.addmm(c, a, b, alpha=-1.0)

            simt_err = held(kernel("simt"), " simt")
            simt_ms = cuda_ms(lambda: kernel("simt"), 20)
            addmm_ms = cuda_ms(addmm, 20)
            line += (f"; the SIMT kernel: max|err| vs plain {simt_err:.3e}, "
                     f"{simt_ms:.4f} ms ({simt_ms / ms:.2f}x the {path} "
                     f"path's time); torch.addmm over the whole square (same "
                     f"bytes, twice the FLOPs, not the same function) "
                     f"{addmm_ms:.4f} ms; device time (us a call): "
                     f"{fmt_us(device_us(kernel))}; SIMT "
                     f"{fmt_us(device_us(lambda: kernel('simt')))}; addmm "
                     f"{fmt_us(device_us(addmm))}")
        print(line)
        if path not in out:
            out[path] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             bound=(b_ms, b_by))
        del ref, mask
    del cases, outs
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
        idle_ms, idle_plain_ms = time_pair(kernel, plain, reps=20,
                                           queued=False)
        nbytes = moves * got.numel() * item
        print(f"[13 K6] {name} {tuple(got.shape)} f32: max|err| vs plain "
              f"{err:.3e} ({rule}); kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), torch {plain_ms:.4f} ms "
              f"({nbytes / plain_ms / 1e6:.0f} GB/s), kernel/torch "
              f"{ms / plain_ms:.3f} over 20 launches; with the window "
              f"opened on an idle card {idle_ms:.4f} / {idle_plain_ms:.4f} "
              f"ms, kernel/torch {idle_ms / idle_plain_ms:.3f}")
        if name not in out:
            out[name] = dict(err=err, ms=ms, plain_ms=plain_ms,
                             bound=bound(nbytes))
        del got, ref
    return launches, out


# ---------------------------------------------------------------------------
# Phases 14-17: the rest of the IPM tier, each at the LP's KKT size
# ---------------------------------------------------------------------------

def grids(n1: int) -> dict:
    """The grid side of each at-scale instance, chosen so that its KKT (or
    augmented system) has the LP's N = 3·n1²: the affine LP and SOCP have
    N = 5·g², the standardized MPS LP about 4.2·g², least squares 3·g² and
    the LSE about 2·g² (the affine side even, so that 2·g² variables fill
    cones of order 4)."""
    return {"qp": n1, "affine": 2 * round(n1 * (3 / 5) ** 0.5 / 2),
            "mps": round(n1 * (3 / 4.2) ** 0.5), "ls": n1,
            "lse": round(n1 * 1.5 ** 0.5)}


def qp_instance(n1: int, seed: int):
    """min ½xᵀQx + cᵀx, Ax = b, x ≥ 0 with Q = blockdiag(L, L), L the
    unscaled 5-point Laplacian on the n1×n1 grid, A = concat_fd_2d(n1, n1)
    and b = A·x0 for an x0 > 0."""
    import numpy as np
    from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_2d
    from elemental_tpu_torch.sparse import SparseMatrix
    A = concat_fd_2d(n1, n1)
    L = sparse_laplacian_2d(n1, n1, scaled=False)
    h = L.height
    Q = SparseMatrix.from_coo(2 * h, 2 * h,
                              np.concatenate([L.row_ids(), L.row_ids() + h]),
                              np.concatenate([L.colind, L.colind + h]),
                              np.concatenate([L.vals, L.vals]))
    rng = np.random.default_rng(seed)
    x0 = np.abs(rng.standard_normal(A.width)) + 0.1
    return Q, A, A.to_scipy() @ x0, rng.standard_normal(A.width)


def affine_instance(n1: int, seed: int, order: int):
    """min cᵀx, Ax = b, Gx + s = h, s ∈ K with A = concat_fd_2d(n1, n1),
    G = −I, h = 0 (so s = x) and K the orthant (order 1) or cones of order
    4; b = A·x0 and c = z0 − Aᵀy0 with x0 and z0 in K's interior, so primal
    and dual are strictly feasible."""
    import numpy as np
    from elemental_tpu_torch.matrices import concat_fd_2d
    from elemental_tpu_torch.sparse import SparseMatrix
    A = concat_fd_2d(n1, n1)
    m, n = A.shape
    rng = np.random.default_rng(seed)

    def interior():
        v = rng.standard_normal((n // order, order)) * 0.3
        v[:, 0] = np.linalg.norm(v[:, 1:], axis=1) + rng.uniform(
            0.5, 1.5, n // order)
        return v.reshape(-1)

    x0, z0 = interior(), interior()
    G = SparseMatrix.from_coo(n, n, np.arange(n), np.arange(n), -np.ones(n))
    c = z0 - A.to_scipy().T @ rng.standard_normal(m)
    return A, A.to_scipy() @ x0, G, np.zeros(n), c, [order] * (n // order)


def general_form_lp(n1: int, seed: int):
    """(MPS text, what read_mps must give back) of a feasible, bounded
    general-form LP on concat_fd_2d(n1, n1): E rows, every 10th row from the
    4th L and from the 8th G, RANGES of 3 on half of those, and UP, LO, FX,
    FR, MI and a negative UP bound on every 20th column from the 2nd to the
    7th; an objective constant of 7.25.  An interior x0 meets every row and
    bound, and c = A_Eᵀy0 + d with d ≥ 0 on lower-bounded columns, ≤ 0 on
    upper-bounded ones and 0 on free ones, so the dual is feasible too."""
    import numpy as np
    import scipy.sparse as sp
    from elemental_tpu_torch.matrices import concat_fd_2d
    A = concat_fd_2d(n1, n1).to_scipy()
    m, n = A.shape
    rng = np.random.default_rng(seed)
    kind = np.full(m, "E")
    kind[3::10], kind[7::10] = "L", "G"
    ranged = (kind != "E") & (np.arange(m) % 20 >= 10)
    x0 = rng.uniform(0.5, 1.5, n)
    bound = np.full(n, "", dtype="<U3")
    for off, bk in enumerate(("UP", "LO", "FX", "FR", "MI", "UPN"), 1):
        bound[off::20] = bk
    x0[bound == "UPN"] = -rng.uniform(2.0, 3.0, int((bound == "UPN").sum()))
    lower, upper = np.zeros(n), np.full(n, np.inf)
    upper[bound == "UP"] = x0[bound == "UP"] + 1.0
    lower[bound == "LO"] = x0[bound == "LO"] - 1.0
    lower[bound == "FX"] = upper[bound == "FX"] = x0[bound == "FX"]
    lower[np.isin(bound, ["FR", "MI", "UPN"])] = -np.inf
    upper[bound == "UPN"] = x0[bound == "UPN"] + 1.0
    rhs = A @ x0 + np.where(kind == "L", 1.0,
                            np.where(kind == "G", -1.0, 0.0))
    eq, ineq = np.nonzero(kind == "E")[0], np.nonzero(kind != "E")[0]
    d = rng.uniform(0.1, 1.0, n)
    d[bound == "UPN"] *= -1.0
    d[np.isin(bound, ["FR", "MI"])] = 0.0
    d[np.isin(bound, ["UP", "FX"])] -= 0.55
    c = A[eq].T @ rng.standard_normal(eq.size) + d
    csc = A.tocsc()
    out = [f"NAME          GEN{n1}", "ROWS", " N  OBJ"]
    out += [f" {kind[i]}  R{i}" for i in range(m)]
    out.append("COLUMNS")
    for j in range(n):
        out.append(f"    C{j}  OBJ  {float(c[j])!r}")
        out += [f"    C{j}  R{csc.indices[p]}  {float(csc.data[p])!r}"
                for p in range(csc.indptr[j], csc.indptr[j + 1])]
    out += ["RHS", "    RHS  OBJ  -7.25"]
    out += [f"    RHS  R{i}  {float(rhs[i])!r}" for i in range(m)]
    out.append("RANGES")
    out += [f"    RNG  R{i}  3.0" for i in np.nonzero(ranged)[0]]
    out.append("BOUNDS")
    for j in np.nonzero(bound != "")[0]:
        bk = bound[j]
        val = {"UP": upper, "UPN": upper, "LO": lower, "FX": lower}.get(bk)
        v = "" if val is None else f"  {float(val[j])!r}"
        out.append(f" {'UP' if bk == 'UPN' else bk} BND  C{j}{v}")
    out.append("ENDATA")
    # the reader's form: G rows negated into ≤, then a ≤ row of the
    # opposite side for each ranged L/G row, in row order
    sign = np.where(kind[ineq] == "G", -1.0, 1.0)
    A_le = sp.diags(sign) @ A[ineq]
    b_le = sign * rhs[ineq]
    rr = np.nonzero(ranged[ineq])[0]
    A_le = sp.vstack([A_le, -A_le[rr]]).tocsr()
    A_le.sort_indices()
    expect = dict(c=c, c0=7.25, A_eq=A[eq].tocsr(), b_eq=rhs[eq], A_le=A_le,
                  b_le=np.concatenate([b_le, -(b_le[rr] - 3.0)]),
                  lower=lower, upper=upper,
                  col_names=[f"C{j}" for j in range(n)],
                  row_names=[f"R{i}" for i in range(m)])
    return "\n".join(out) + "\n", expect


def extended_laplacian(n0: int, n1: int):
    """examples/sequential_least_squares.py's matrix: the 5-point Laplacian
    (scaled by the grid) stacked on 2(hx + hy)·I, 2n × n."""
    import numpy as np
    from elemental_tpu_torch.sparse import SparseMatrix
    n = n0 * n1
    s = np.arange(n)
    x, y = s % n0, s // n0
    hx, hy = float(n0 + 1) ** 2, float(n1 + 1) ** 2
    rows, cols = [s, s + n], [s, s]
    vals = [np.full(n, 2 * (hx + hy)), np.full(n, 2 * (hx + hy))]
    for mask, col, v in [(x > 0, s - 1, -hx), (x < n0 - 1, s + 1, -hx),
                         (y > 0, s - n0, -hy), (y < n1 - 1, s + n0, -hy)]:
        rows.append(s[mask])
        cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), v))
    return SparseMatrix.from_coo(2 * n, n, np.concatenate(rows),
                                 np.concatenate(cols), np.concatenate(vals))


def fd2d_dense_column(n0: int, n1: int):
    """examples/sequential_lse.py's A: the reference's FD2D stencil with its
    dense last column, n × n."""
    import numpy as np
    from elemental_tpu_torch.sparse import SparseMatrix
    n = n0 * n1
    s = np.arange(n)
    x, y = s % n0, s // n0
    rows, cols, vals = [s], [s], [np.full(n, 11.0)]
    for mask, col, v in [(x > 0, s - 1, -1.0), (x < n0 - 1, s + 1, 2.0),
                         (y > 0, s - n0, -3.0), (y < n1 - 1, s + n0, 4.0)]:
        rows.append(s[mask])
        cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), v))
    rows.append(s)
    cols.append(np.full(n, n - 1))
    vals.append(np.full(n, -10.0 / n))
    return SparseMatrix.from_coo(n, n, np.concatenate(rows),
                                 np.concatenate(cols), np.concatenate(vals))


def lse_instance(g: int, seed: int, p: int = 5):
    """examples/sequential_lse.py's problem on a g×g grid: B dense
    uniform(0, 1) p×n, c and d normal."""
    import numpy as np
    from elemental_tpu_torch.sparse import SparseMatrix
    A = fd2d_dense_column(g, g)
    rng = np.random.default_rng(seed)
    B = SparseMatrix.from_dense(rng.uniform(0, 1, (p, A.width)))
    return A, B, rng.standard_normal(A.width), rng.standard_normal(p)


def ordering_job(kind: str, arg, seed: int):
    """Host analysis of one at-scale pattern, run in a worker process: the
    fill ordering (nested dissection; the grid's natural nested dissection
    for "complex"), the symbolic analysis and the extend-add plan.  ``arg``
    is --n1, the MPS file's path for "mps", "2d" or "3d" for "complex",
    the side for "lap3d" (phase 24's 3-D Laplacian, whose ordering alone
    is taken here: its plan is too large to send back).  Returns a dict:
    the ordering (``perm``), N, nnz, the levels with an extend-add and the
    seconds taken."""
    import torch
    from elemental_tpu_torch.lapack.sparse_min import _ls_system, _lse_system
    from elemental_tpu_torch.optimization.lp import (_build_affine_kkt,
                                                     _build_lp_kkt,
                                                     mps_to_standard,
                                                     sparse_ruiz)
    from elemental_tpu_torch.optimization.socp import Cones, _build_socp_kkt
    from elemental_tpu_torch.sparse import read_mps
    from elemental_tpu_torch.sparse_direct import (analyze, build_ea_plan,
                                                   natural_nested_dissection,
                                                   nested_dissection)
    torch.set_num_threads(1)
    cpu = dict(device="cpu", dtype=torch.float32)
    t0 = time.perf_counter()
    if kind == "lap3d":
        from elemental_tpu_torch.matrices import sparse_laplacian_3d
        A = sparse_laplacian_3d(arg, arg, arg, scaled=False)
        return dict(perm=nested_dissection(A, cutoff=64), N=A.height,
                    nnz=A.nnz, levels=None,
                    seconds=time.perf_counter() - t0)
    if kind == "mps":
        A = mps_to_standard(read_mps(arg))[0]
        kkt, _ = _build_lp_kkt(sparse_ruiz(A)[0], 1e-2, 1e-2, None, **cpu)
    g = None if kind in ("mps", "complex") else grids(arg)
    if kind == "qp":
        Q, A, _, _ = qp_instance(g["qp"], seed)
        kkt, _ = _build_lp_kkt(A, 1e-2, 1e-2, None, Q=Q, **cpu)
    elif kind == "lp_affine":
        A, _, G, _, _, _ = affine_instance(g["affine"], seed, 1)
        kkt = _build_affine_kkt(A, G, 1e-2, 1e-2, None, **cpu)
    elif kind == "socp":
        A, _, G, _, _, orders = affine_instance(g["affine"], seed, 4)
        kkt, _ = _build_socp_kkt(A, G, Cones(orders), 1e-2, 1e-2, None,
                                 **cpu)
    if kind in ("qp", "lp_affine", "socp", "mps"):
        return dict(perm=kkt.symb.perm.numpy(), N=kkt.N, nnz=kkt.nnz,
                    levels=len(kkt.ea_plan.levels),
                    seconds=time.perf_counter() - t0)
    if kind == "complex":
        K, dims = complex_pattern(arg)
        host = analyze(K, perm=natural_nested_dissection(dims))
        return dict(perm=host.perm, N=K.height, nnz=K.nnz,
                    levels=len(build_ea_plan(host).levels),
                    seconds=time.perf_counter() - t0, pool=host.pool_size,
                    front=max(lev.front_size for lev in host.levels))
    if kind == "ls":
        K = _ls_system(extended_laplacian(g["ls"], g["ls"]), 1.0)
        perm = nested_dissection(K, cutoff=64)
    else:
        A, B, _, _ = lse_instance(g["lse"], seed)
        K = _lse_system(A, B, 1.0)
        perm = dense_last_ordering(K)
    levels = len(build_ea_plan(analyze(K, perm=perm)).levels)
    return dict(perm=perm, N=K.height, nnz=K.nnz, levels=levels,
                seconds=time.perf_counter() - t0)


def dense_last_ordering(K):
    """Nested dissection of K without its dense rows (degree above
    10·√N, the rule of AMD), those rows last.  The LSE's B rows and its
    dense column are such rows: the port's nested dissection, a Python BFS,
    spends minutes on the whole graph at N = 150,157 (PERF.md §5)."""
    import numpy as np
    from elemental_tpu_torch.sparse import SparseMatrix
    from elemental_tpu_torch.sparse_direct import nested_dissection
    dense = np.diff(K.rowptr) > 10 * np.sqrt(K.height)
    keep = np.nonzero(~dense)[0]
    sub = SparseMatrix.from_scipy(K.to_scipy()[keep][:, keep])
    return np.concatenate([keep[nested_dissection(sub, cutoff=64)],
                           np.nonzero(dense)[0]])


def start_ipm_analyses(n1: int, seed: int, tmp: str):
    """Write phase 16's MPS file into ``tmp`` and start the host analysis
    of the six at-scale patterns of phases 14-17, the two of phase 18 and
    phase 24's ordering (``ordering_job``), one spawned process each, so no CUDA state is
    shared, while the caller goes on.  Returns (the MPS file's path, what
    read_mps must give back, ``wait``); ``wait()`` returns the analyses by
    name once every process has ended."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    g = grids(n1)
    path = os.path.join(tmp, f"gen{g['mps']}.mps")
    text, expect = general_form_lp(g["mps"], seed)
    with open(path, "w") as f:
        f.write(text)
    jobs = [("qp", "qp", n1), ("lp_affine", "lp_affine", n1),
            ("socp", "socp", n1), ("mps", "mps", path), ("ls", "ls", n1),
            ("lse", "lse", n1), ("c2d", "complex", "2d"),
            ("c3d", "complex", "3d"), ("lap48", "lap3d", DIST_LAP)]
    t0 = time.perf_counter()
    pool = ProcessPoolExecutor(len(jobs), mp_context=multiprocessing
                               .get_context("spawn"))
    futs = {name: pool.submit(ordering_job, kind, arg, seed)
            for name, kind, arg in jobs}

    def wait():
        t_wait = time.perf_counter()
        try:
            out = {name: f.result() for name, f in futs.items()}
        finally:
            pool.shutdown(cancel_futures=True)
        t_end = time.perf_counter()
        print(f"[14-18, 24] host analysis of {len(jobs)} patterns, one "
              f"process each, beside the LP's: {t_end - t0:.1f} s from their "
              f"start, {t_end - t_wait:.1f} s of it waited for; " + "; ".join(
                  f"{name} N={o['N']} nnz={o['nnz']}, " + (
                      "the ordering" if o["levels"] is None else
                      f"{o['levels']} levels with an extend-add")
                  + f", {o['seconds']:.1f} s" for name, o in out.items()))
        return out

    return path, expect, wait


class FirstFactor:
    """Keeps the arguments of the first numeric factor
    (``numeric._factor_impl``) taken inside the ``with`` block."""

    def __enter__(self):
        from elemental_tpu_torch.sparse_direct import numeric
        self.args, self._saved = None, numeric._factor_impl

        def keep(*args):
            if self.args is None:
                self.args = args
            return self._saved(*args)

        numeric._factor_impl = keep
        return self

    def __exit__(self, *exc):
        from elemental_tpu_torch.sparse_direct import numeric
        numeric._factor_impl = self._saved


def k1_against_plain(args) -> str:
    """A path's first factor (``FirstFactor.args``) taken again on the card,
    with K1 held against the plain extend-add on the same inputs at every
    level: before each K1 launch the pool is copied and the plain version
    applied to the copy.  Fails unless K1 launched on every level and each
    level's pool agrees within 1e-5 (float32) or 1e-12 (float64) of its
    max|pool|, as in phase 3; K1's counter is left as it was.  Returns the
    line's text."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.extend_add import (extend_add,
                                                        extend_add_plain)
    from elemental_tpu_torch.sparse_direct import numeric
    check(args is not None, "no factor was taken")
    rtol = 1e-5 if args[3] in (torch.float32, torch.complex64) else 1e-12
    counted = extend_add.launches
    worst = dict(ratio=0.0, err=0.0, scale=0.0, levels=0)

    def held(pool, level):
        ref = pool.clone()
        extend_add_plain(ref, level)
        extend_add(pool, level)
        err = float((pool - ref).abs().max())
        scale = float(ref.abs().max())
        ratio = err / scale if scale else err
        check(np.isfinite(err) and err <= rtol * scale,
              f"K1 vs plain on level {worst['levels']} of the first factor: "
              f"max|err| {err:.3e} > {rtol:g}·max|pool| ({scale:.3e})")
        if ratio >= worst["ratio"]:
            worst.update(ratio=ratio, err=err, scale=scale)
        worst["levels"] += 1

    numeric.extend_add = held
    try:
        with numeric.full_fp32_matmul():
            numeric._factor_impl(*args)
    finally:
        numeric.extend_add = extend_add
    launched = extend_add.launches - counted
    extend_add.launches = counted
    check(launched == worst["levels"] > 0,
          f"first factor: {launched} K1 launches on {worst['levels']} levels")
    return (f"first factor again, K1 held against the plain extend-add on "
            f"each of its {worst['levels']} levels: worst max|err| "
            f"{worst['err']:.3e} (max|pool| {worst['scale']:.3e}, gate "
            f"{rtol:g} of it)")


def ipm_at_scale(tag: str, label: str, run, resid, levels: int,
                 start_factors: int, max_iters: int):
    """``run(0)`` (the starting point) and ``run(max_iters)``, the ordering
    given: wall times and s/iteration, finite iterates, host-f64 primal and
    dual residuals below the start's, K1 launched at least levels × factors
    times, and the run's first factor held against the plain extend-add
    (``k1_against_plain``).  Returns (K1 launches, s/iteration)."""
    import numpy as np
    from elemental_tpu_torch.kernels.extend_add import extend_add
    start, t_start = wall(lambda: run(0))
    extend_add.launches = 0
    with FirstFactor() as first:
        res, t_run = wall(lambda: run(max_iters))
    launches = extend_add.launches
    k1_line = k1_against_plain(first.args)
    its = res.iterations
    check(its >= 1, f"{label}: no iteration ran")
    for name in ("x", "y", "z", "s"):
        v = getattr(res, name, None)
        check(v is None or bool(np.all(np.isfinite(v))),
              f"{label}: non-finite {name}")
    (p0, d0), (p1, d1) = resid(start), resid(res)
    check(p1 < p0 and d1 < d0, f"{label}: residuals did not fall: primal "
          f"{p0:.3e} -> {p1:.3e}, dual {d0:.3e} -> {d1:.3e}")
    factors = start_factors + its
    check(launches >= factors * levels,
          f"{label}: K1 launched {launches} times, expected at least "
          f"{factors} factors x {levels} levels")
    per_it = (t_run - t_start) / its
    print(f"[{tag}] {label} f32: {its} iterations in {t_run:.2f} s; the "
          f"max_iters=0 run (symbolic analysis with the ordering given, "
          f"set-up, start) {t_start:.2f} s, so {per_it:.3f} s/iteration; "
          f"relative primal residual {p0:.3e} -> {p1:.3e}, dual {d0:.3e} -> "
          f"{d1:.3e}; K1 launches {launches} >= {factors} factors x "
          f"{levels} levels; {k1_line}")
    return launches, per_it


def _rel(v, ref) -> float:
    import numpy as np
    return float(np.linalg.norm(v) / (1.0 + np.linalg.norm(ref)))


def profile_qp_iteration(run) -> None:
    """One ``qp_direct`` iteration (a max_iters=1 run) under
    ``torch.profiler``, its window opened when the KKT's symbolic analysis
    returns: the host time of the iteration and of the factor, the panel
    inverses and the two refined solves (each ending in a device
    synchronisation), and the device busy share of each (the kernel time
    inside the part's host span over that span)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from elemental_tpu_torch.optimization import kkt
    ranges = {"factor": (kkt.KKTSystem, "prepare"),
              "panel inverses": (kkt.KKTFactor, "default_context"),
              "refined solves": (kkt.KKTFactor, "solve_refined")}
    saved = {label: getattr(cls, name)
             for label, (cls, name) in ranges.items()}
    saved_finalize = kkt.KKTBuilder.finalize

    def one_iteration(prof):
        host = dict.fromkeys(ranges, 0.0)
        t_start = []

        def ranged(label, fn):
            def inner(*args, **kw):
                t0 = time.perf_counter()
                with record_function(label):
                    out = fn(*args, **kw)
                    torch.cuda.synchronize()
                host[label] += time.perf_counter() - t0
                return out
            return inner

        def finalize(*args, **kw):
            out = saved_finalize(*args, **kw)
            torch.cuda.synchronize()
            prof.start()
            t_start.append(time.perf_counter())
            return out

        for label, (cls, name) in ranges.items():
            setattr(cls, name, ranged(label, saved[label]))
        kkt.KKTBuilder.finalize = finalize
        try:
            run(1)
            torch.cuda.synchronize()
            it = time.perf_counter() - t_start[0]
            prof.stop()
        finally:
            for label, (cls, name) in ranges.items():
                setattr(cls, name, saved[label])
            kkt.KKTBuilder.finalize = saved_finalize
        return it, host

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    it, host = one_iteration(prof)
    # the raw events: building the profiler's event tree over the
    # iteration's ~10⁵ kernels and their host ops takes minutes
    t0 = time.perf_counter()
    spans, kernels, names = {}, [], {}
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns() / 1e3
        iv = (a, a + e.duration_ns() / 1e3)             # µs
        if name in ranges:
            if e.device_type() == DeviceType.CPU:     # a part's host span
                spans.setdefault(name, []).append(iv)
        elif e.device_type() == DeviceType.CUDA:
            kernels.append(iv)
            names[name] = names.get(name, 0.0) + iv[1] - iv[0]
    ks = sorted(kernels)
    busy = sum(b - a for a, b in ks) / 1e6

    def inside(ivs):
        return sum(max(0, min(b, y) - max(a, x)) for x, y in ivs
                   for a, b in ks if b > x and a < y) / 1e6

    parts = [f"{label} {host[label]:.3f} s = {host[label] / it:.3f} of it, "
             f"device busy "
             f"{inside(spans.get(label, [])) / max(host[label], 1e-9):.3f}"
             for label in ranges]
    top = sorted(names.items(), key=lambda kv: -kv[1])[:3]
    print(f"[14 QP] one qp_direct iteration under torch.profiler: "
          f"{it:.3f} s on the host's clock, device busy {busy / it:.3f} "
          f"({len(ks)} kernels and copies, {busy:.3f} s); " + "; ".join(parts)
          + "; most device time: " + ", ".join(
              f"{k[:40]} {v / 1e3:.1f} ms" for k, v in top)
          + f" (events read in {time.perf_counter() - t0:.1f} s)")


def phase_qp(n1: int, seed: int, order, max_iters: int):
    """14: qp_direct at scale in float32 (residuals, s/iteration, K1, one
    iteration profiled); qp_direct converged in float64 at n1 = 32 to
    test_ipm.py:94-98's KKT gate; portfolio and nnls at their test sizes."""
    import numpy as np
    import scipy.optimize as so
    import torch
    from elemental_tpu_torch.optimization import (LPCtrl, nnls, portfolio,
                                                  qp_direct)
    perm, N, levels = order["perm"], order["N"], order["levels"]
    Q, A, b, c = qp_instance(grids(n1)["qp"], seed)
    Qs, As = Q.to_scipy(), A.to_scipy()

    def run(iters):
        return qp_direct(Q, A, b, c, LPCtrl(max_iters=iters, ordering=perm),
                         device="cuda", dtype=torch.float32)

    def resid(r):
        return (_rel(As @ r.x - b, b),
                _rel(Qs @ r.x + c - As.T @ r.y - r.z, c))

    print(f"[14 QP] qp_direct: Q = blockdiag(L, L) of the {grids(n1)['qp']}² "
          f"Laplacian, A = concat_fd_2d, N={N} (ordering of the QP's own "
          f"pattern)")
    launches, _ = ipm_at_scale("14 QP", "qp_direct", run, resid, levels, 0,
                               max_iters)
    profile_qp_iteration(run)

    Q, A, b, c = qp_instance(32, seed)
    r = qp_direct(Q, A, b, c, LPCtrl(tol=1e-9), device="cuda",
                  dtype=torch.float64)
    Qd, Ad = Q.to_dense(), A.to_dense()
    kkt_err = float(np.abs(Qd @ r.x + c - Ad.T @ r.y - r.z).max())
    check(r.converged and kkt_err < 1e-6 and r.x.min() > -1e-9
          and r.z.min() > -1e-9 and abs(r.x @ r.z) < 1e-6,
          f"qp_direct f64 n1=32: converged={r.converged}, KKT {kkt_err:.3e}")
    rng = np.random.default_rng(222)
    L = rng.standard_normal((8, 8))
    xp = portfolio(L @ L.T + np.eye(8), rng.standard_normal(8), 1.0,
                   LPCtrl(tol=1e-9), device="cuda", dtype=torch.float64)
    check(abs(xp.sum() - 1.0) < 1e-6 and xp.min() > -1e-8,
          f"portfolio: sum {xp.sum():.9f}, min {xp.min():.3e}")
    rng = np.random.default_rng(165)
    M, v = rng.standard_normal((15, 8)), rng.standard_normal(15)
    xn = nnls(M, v, LPCtrl(tol=1e-10), device="cuda", dtype=torch.float64)
    ref = np.linalg.norm(M @ so.nnls(M, v)[0] - v)
    check(abs(np.linalg.norm(M @ xn - v) - ref) <= 1e-6 * ref
          and xn.min() > -1e-8, "nnls off scipy's optimum")
    print(f"[14 QP] f64: qp_direct at n1=32 converged in {r.iterations} "
          f"iterations, max|Qx + c − Aᵀy − z| {kkt_err:.3e} < 1e-6, "
          f"|xᵀz| {abs(r.x @ r.z):.3e}; portfolio sums to {xp.sum():.12f}; "
          f"nnls residual {np.linalg.norm(M @ xn - v):.10f} (scipy "
          f"{ref:.10f})")
    return launches


def phase_affine(n1: int, seed: int, orders, max_iters: int):
    """15: lp_affine and socp_affine at scale in float32, each on the
    ordering of its own pattern; converged in float64: lp_affine
    against HiGHS (test_ipm.py:67-82), socp_affine against lstsq
    (test_ipm.py:112-127), robust_least_squares and basis_pursuit_complex
    with their gates."""
    import numpy as np
    import scipy.optimize as so
    import torch
    from elemental_tpu_torch.optimization import (Cones, LPCtrl,
                                                  basis_pursuit_complex,
                                                  lp_affine,
                                                  robust_least_squares,
                                                  socp_affine)
    launches = 0
    for label, kord in (("lp_affine", 1), ("socp_affine", 4)):
        order = orders["lp_affine" if kord == 1 else "socp"]
        perm, N, levels = order["perm"], order["N"], order["levels"]
        A, b, G, h, c, cones = affine_instance(grids(n1)["affine"], seed,
                                               kord)
        As, Gs = A.to_scipy(), G.to_scipy()

        def run(iters, A=A, b=b, G=G, h=h, c=c, cones=cones, kord=kord,
                perm=perm):
            ctrl = LPCtrl(max_iters=iters, ordering=perm)
            if kord == 1:
                return lp_affine(A, b, G, h, c, ctrl, device="cuda",
                                 dtype=torch.float32)
            return socp_affine(A, b, G, h, c, Cones(cones), ctrl,
                               device="cuda", dtype=torch.float32)

        def resid(r, As=As, Gs=Gs, b=b, h=h, c=c):
            prim = np.concatenate([As @ r.x - b, Gs @ r.x + r.s - h])
            return (_rel(prim, np.concatenate([b, h])),
                    _rel(c + As.T @ r.y + Gs.T @ r.z, c))

        print(f"[15 affine] {label}: A = concat_fd_2d, G = −I, "
              f"{len(cones)} cones of order {kord}, N={N}")
        got, _ = ipm_at_scale("15 affine", label, run, resid, levels, 0,
                              max_iters)
        launches += got

    f64 = dict(device="cuda", dtype=torch.float64)
    rng = np.random.default_rng(53)
    A = rng.standard_normal((5, 8))
    x0 = rng.standard_normal(8)
    G = rng.standard_normal((12, 8))
    h = G @ x0 + np.abs(rng.standard_normal(12)) + 0.1
    c = rng.standard_normal(8)
    r = lp_affine(A, A @ x0, G, h, c, LPCtrl(tol=1e-9), **f64)
    ref = so.linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=A @ x0,
                     bounds=(None, None), method="highs")
    check(r.converged and abs(r.objective - ref.fun) <= 1e-5 * abs(ref.fun),
          f"lp_affine f64 {r.objective} vs HiGHS {ref.fun}")
    B, d = rng.standard_normal((12, 5)), rng.standard_normal(12)
    G = np.zeros((13, 6))
    G[0, 5], G[1:, :5] = -1.0, -B
    cs = np.zeros(6)
    cs[5] = 1.0
    rs = socp_affine(np.zeros((0, 6)), np.zeros(0), G,
                     np.concatenate([[0], -d]), cs, Cones([13]),
                     LPCtrl(max_iters=200, tol=1e-9), **f64)
    ls_err = float(np.abs(rs.x[:5] - np.linalg.lstsq(B, d, rcond=None)[0]
                          ).max())
    check(rs.converged and ls_err < 1e-6, f"socp_affine LS off {ls_err:.3e}")
    M, v = rng.standard_normal((10, 4)), rng.standard_normal(10)
    xr = robust_least_squares(M, v, 0.1, LPCtrl(tol=1e-9, max_iters=300),
                              **f64)

    def f(w):
        return np.linalg.norm(M @ w - v) + 0.1 * np.linalg.norm(w)

    nm = so.minimize(f, np.zeros(4), method="Nelder-Mead",
                     options={"xatol": 1e-10, "fatol": 1e-12,
                              "maxiter": 20000})
    check(f(xr) <= nm.fun + 1e-5, f"RLS {f(xr)} vs Nelder-Mead {nm.fun}")
    rng = np.random.default_rng(11)
    Ac = (rng.standard_normal((12, 30))
          + 1j * rng.standard_normal((12, 30))) / np.sqrt(24)
    xt = np.zeros(30, complex)
    xt[rng.choice(30, 3, replace=False)] = (rng.standard_normal(3)
                                            + 1j * rng.standard_normal(3))
    xc = basis_pursuit_complex(Ac, Ac @ xt, **f64)
    feas = np.linalg.norm(Ac @ xc - Ac @ xt) / (1 + np.linalg.norm(Ac @ xt))
    check(feas < 1e-3 and np.abs(xc).sum() <= np.abs(xt).sum() * 1.01,
          f"complex BP: feasibility {feas:.3e}")
    print(f"[15 affine] f64: lp_affine {r.iterations} iterations, objective "
          f"{r.objective:.10f} (HiGHS {ref.fun:.10f}); socp_affine LS "
          f"{rs.iterations} iterations, max|x − lstsq| {ls_err:.3e}; RLS "
          f"{f(xr):.10f} (Nelder-Mead {nm.fun:.10f}); complex BP ‖x‖₁ "
          f"{np.abs(xc).sum():.6f} (generator {np.abs(xt).sum():.6f}), "
          f"feasibility {feas:.3e}")
    return launches


def _same_mps(got, expect) -> bool:
    import numpy as np
    for k, v in expect.items():
        g = getattr(got, k)
        if k in ("A_eq", "A_le"):
            g = g.to_scipy()
            same = (g.shape == v.shape and np.array_equal(g.indptr, v.indptr)
                    and np.array_equal(g.indices, v.indices)
                    and np.array_equal(g.data, v.data))
        elif isinstance(v, np.ndarray):
            same = np.array_equal(g, v)
        else:
            same = g == v
        if not same:
            print(f"[16 MPS] read_mps differs in {k}")
            return False
    return True


def phase_mps(path: str, expect: dict, n1: int, seed: int, order,
              max_iters: int, tmpdir: str):
    """16: the general-form MPS file at scale read back exactly and solved
    by solve_mps in float32; the same generator at n1 = 16 converged in
    float64 to HiGHS's objective on the general form (rtol 1e-6)."""
    import numpy as np
    import scipy.optimize as so
    import torch
    from elemental_tpu_torch.optimization import (LPCtrl, mps_to_standard,
                                                  solve_mps)
    from elemental_tpu_torch.sparse import read_mps
    perm, N, levels = order["perm"], order["N"], order["levels"]
    lp, t_read = wall(lambda: read_mps(path))
    check(_same_mps(lp, expect), "read_mps did not give back the file")
    A, b, c, _, _ = mps_to_standard(lp)
    As = A.to_scipy()

    def run(iters):
        return solve_mps(lp, LPCtrl(max_iters=iters, ordering=perm),
                         device="cuda", dtype=torch.float32)[0]

    def resid(r):
        return _rel(As @ r.x - b, b), _rel(c - As.T @ r.y - r.z, c)

    print(f"[16 MPS] general form on concat_fd_2d at n1={grids(n1)['mps']}: "
          f"{lp.A_eq.height} E rows, {lp.A_le.height} ≤ rows (RANGES "
          f"included), {int(np.isinf(lp.lower).sum())} columns without a "
          f"lower bound, {int(np.isfinite(lp.upper).sum())} with an upper "
          f"one; read back exactly in {t_read:.2f} s; standardized KKT "
          f"N={N}")
    launches, _ = ipm_at_scale("16 MPS", "solve_mps", run, resid, levels, 1,
                               max_iters)

    import os
    text, _ = general_form_lp(16, seed)
    small = os.path.join(tmpdir, "gen16.mps")
    with open(small, "w") as f:
        f.write(text)
    lp = read_mps(small)
    res, x = solve_mps(lp, LPCtrl(tol=1e-9, max_iters=200), device="cuda",
                       dtype=torch.float64)
    bounds = [(None if np.isneginf(lo) else lo, None if np.isposinf(hi)
               else hi) for lo, hi in zip(lp.lower, lp.upper)]
    ref = so.linprog(lp.c, A_ub=lp.A_le.to_scipy(), b_ub=lp.b_le,
                     A_eq=lp.A_eq.to_scipy(), b_eq=lp.b_eq, bounds=bounds,
                     method="highs")
    want = ref.fun + lp.c0
    check(ref.success and res.converged
          and abs(res.objective - want) <= 1e-6 * abs(want),
          f"solve_mps f64 n1=16: {res.objective} vs HiGHS {want}")
    print(f"[16 MPS] f64 at n1=16: {res.iterations} iterations, objective "
          f"{res.objective:.10f}, HiGHS on the general form {want:.10f} "
          f"(rel {abs(res.objective - want) / abs(want):.2e})")
    return launches


def phase_sparse_min(n1: int, seed: int, orders):
    """17: sparse_least_squares on the extended Laplacian and sparse_lse on
    the FD2D stencil with a dense column, at the LP's N, in float64 and
    float32 on one ordering each, held to the drivers' gates
    (sequential_least_squares.py:43-50, sequential_lse.py:39-53)."""
    import numpy as np
    import torch
    from elemental_tpu_torch.core.policy import residual_bound
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.lapack import sparse_least_squares, sparse_lse
    g = grids(n1)
    launches = 0
    A = extended_laplacian(g["ls"], g["ls"])
    As = A.to_scipy()
    b = np.random.default_rng(4).standard_normal(A.height)
    perm, N, levels = (orders["ls"][k] for k in ("perm", "N", "levels"))
    for dt in (torch.float64, torch.float32):
        extend_add.launches = 0
        with FirstFactor() as first:
            x, t = wall(lambda: sparse_least_squares(A, b, device="cuda",
                                                     dtype=dt, perm=perm))
        launches += extend_add.launches
        k1_line = k1_against_plain(first.args)
        check(extend_add.launches >= levels, "LS: K1 not launched a level")
        x = x.cpu().numpy().astype(np.float64)
        gv = float(np.abs(As.T @ (b - As @ x)).max())
        bound = residual_bound(dt, A.width) * np.abs(As.data).max() \
            * np.linalg.norm(b)
        check(gv < bound, f"LS {dt}: ‖Aᵀr‖∞ {gv:.3e} >= {bound:.3e}")
        print(f"[17 sparse LS] {str(dt)[6:]} extended Laplacian {g['ls']}² "
              f"({A.height}×{A.width}, N={N}): {t:.2f} s (symbolic "
              f"analysis with the ordering, factor, 9 solves), ‖Aᵀ(b − "
              f"Ax)‖∞ {gv:.3e} < {bound:.3e}, K1 launches "
              f"{extend_add.launches}; {k1_line}")
    A, B, c, d = lse_instance(g["lse"], seed)
    As, Bd = A.to_scipy(), B.to_dense()
    perm, N, levels = (orders["lse"][k] for k in ("perm", "N", "levels"))
    for dt in (torch.float64, torch.float32):
        extend_add.launches = 0
        with FirstFactor() as first:
            (x, _), t = wall(lambda: sparse_lse(A, B, c, d, device="cuda",
                                                dtype=dt, perm=perm))
        launches += extend_add.launches
        k1_line = k1_against_plain(first.args)
        check(extend_add.launches >= levels, "LSE: K1 not launched a level")
        x = x.cpu().numpy().astype(np.float64)
        bound = residual_bound(dt, A.width)
        cons = float(np.abs(Bd @ x - d).max())
        gr = As.T @ (c - As @ x)
        perp = float(np.abs(gr - Bd.T @ np.linalg.lstsq(Bd.T, gr,
                                                        rcond=None)[0]).max())
        pbound = bound * (np.abs(As.data).max() * np.linalg.norm(c) + 1)
        check(cons < bound * (1 + np.abs(d).max()) and perp < pbound,
              f"LSE {dt}: constraint {cons:.3e}, projected gradient "
              f"{perp:.3e}")
        print(f"[17 sparse LSE] {str(dt)[6:]} FD2D {g['lse']}² with a dense "
              f"column, p={B.height} (N={N}): {t:.2f} s, ‖Bx − d‖∞ "
              f"{cons:.3e} < {bound * (1 + np.abs(d).max()):.3e}, "
              f"‖P·Aᵀr‖∞ {perp:.3e} < {pbound:.3e}, K1 launches "
              f"{extend_add.launches}; {k1_line}")
    return launches


def phases_ipm_tier(n1: int, seed: int, max_iters: int, orders: dict,
                    mps_path: str, mps_expect: dict, tmp: str) -> int:
    """Phases 14-17, each timed; returns their K1 launches."""
    import torch
    launches = 0
    for tag, phase in (
            ("14 QP", lambda: phase_qp(n1, seed, orders["qp"], max_iters)),
            ("15 affine", lambda: phase_affine(n1, seed, orders, max_iters)),
            ("16 MPS", lambda: phase_mps(mps_path, mps_expect, n1, seed,
                                         orders["mps"], max_iters, tmp)),
            ("17 sparse LS", lambda: phase_sparse_min(n1, seed, orders))):
        t0 = time.perf_counter()
        launches += phase()
        torch.cuda.empty_cache()
        print(f"[{tag}] the phase took {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# Phase 18: complex sparse LDL (LDLᵀ complex-symmetric, LDLᴴ Hermitian)
# ---------------------------------------------------------------------------

# grid sides: 384² = 147,456 unknowns (the LP's KKT size), and 32³
C2D, C3D = 384, 32


def helmholtz_shift(n: int) -> complex:
    """ω²(1 + 0.05i), ω = 2π(n+1)/10: ten grid points a wavelength at
    h = 1/(n+1), damped by 5 % (the reference's Helmholtz.cpp scenario)."""
    omega = 2 * 3.141592653589793 * (n + 1) / 10
    return omega ** 2 * (1 + 0.05j)


def complex_pattern(kind: str):
    """(damped Helmholtz matrix, grid dims) of phase 18's "2d" or "3d"."""
    from elemental_tpu_torch.matrices import (sparse_helmholtz_2d,
                                              sparse_helmholtz_3d)
    if kind == "2d":
        return sparse_helmholtz_2d(C2D, C2D, helmholtz_shift(C2D)), (C2D,
                                                                     C2D)
    return (sparse_helmholtz_3d(C3D, C3D, C3D, helmholtz_shift(C3D)),
            (C3D,) * 3)


def magnetic_laplacian(n: int, sigma: float, flux: float = 1 / 64):
    """The port's scaled n×n Laplacian in the Landau gauge: the edges along
    axis 0 carry e^{±2πi·flux·j} (j the index along axis 1), minus the real
    ``sigma`` on the diagonal.  Hermitian, with the Helmholtz matrix's
    pattern; positive definite at sigma = 0."""
    import numpy as np
    from elemental_tpu_torch.matrices import sparse_laplacian_2d
    L = sparse_laplacian_2d(n, n)
    r, c = L.row_ids(), L.colind
    phase = np.exp(2j * np.pi * flux * (r % n))
    v = L.vals.astype(np.complex128)
    v = np.where(c - r == n, v * phase, v)
    v = np.where(r - c == n, v * phase.conj(), v)
    return L.change_nonzero_values(np.where(r == c, v - sigma, v))


def landau_gap_shift(n: int, flux: float = 1 / 64) -> float:
    """4π·flux·(n+1)²: the middle of the gap between the two lowest Landau
    levels of ``magnetic_laplacian(n, 0)`` (lattice energies near 2π·flux
    and 6π·flux, scaled by h⁻² = (n+1)²).  At σ = ω² instead, the
    unpivoted LDLᴴ loses most of its accuracy and complex64's iterative
    refinement diverges (``tools/hermitian_probe.py``; PERF.md)."""
    return 4 * 3.141592653589793 * flux * (n + 1) ** 2


def same_analysis(base, M, *, dtype, hermitian: bool, spd: bool):
    """A facade on M, which has ``base``'s pattern, sharing base's ordering,
    symbolic analysis and extend-add plan (they do not depend on the values,
    the dtype or ``hermitian``), as ``change_nonzero_values`` shares them."""
    import copy
    f = copy.copy(base)
    f.dtype, f.hermitian, f.spd = dtype, hermitian, spd
    f.numeric = None
    return f.change_nonzero_values(M.vals)


def kappa_estimate(f, iters: int = 8) -> float:
    """‖M‖₂·‖M⁻¹‖₂ of the factored matrix by ``iters`` power iterations
    each (M through its device CSR, M⁻¹ through the factor's solve): a
    lower bound, close for a Hermitian M."""
    import numpy as np
    import torch
    dev = f.A.device_csr(device=f.device, dtype=f.dtype)
    rng = np.random.default_rng(1)

    def norm(apply):
        v = torch.as_tensor(rng.standard_normal(f.A.height)).to(f.device,
                                                                 f.dtype)
        for _ in range(iters):
            w = apply(v / torch.linalg.vector_norm(v))
            v = w
        return float(torch.linalg.vector_norm(w))

    return norm(dev.matvec) * norm(f.solve)


def profile_factor(f) -> str:
    """One factor under ``torch.profiler``: its host time and the device
    busy share (kernel time over that span), from the raw events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        f.factor()
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    kernels = [e.duration_ns() / 1e9 for e in
               prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
    f.numeric = None
    return (f"one {str(f.dtype)[6:]} factor under torch.profiler: {span:.3f} "
            f"s on the host's clock, device busy {sum(kernels) / span:.3f} "
            f"({len(kernels)} kernels and copies, {sum(kernels):.3f} s)")


def complex_factor(tag: str, label: str, f, levels: int, seed: int,
                   ctx: bool = False, kappa: bool = False) -> int:
    """18: one matrix in one dtype through the facade (its analysis done):
    the factor timed with K1 counted (at least one launch a level with
    children), a solve, the refined solve's relative residual on the host
    in complex128 under the dtype's bound; with ``ctx`` the solve through
    the panel inverses against substitution; with ``kappa`` an estimate of
    κ; then the first factor taken again with K1 held against the plain
    extend-add (``k1_against_plain``).  Returns the factor's K1 launches."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.extend_add import extend_add
    dt = str(f.dtype)[6:]
    extend_add.launches = 0
    with FirstFactor() as first:
        _, t_factor = wall(f.factor)
    launches = extend_add.launches
    check(launches >= levels > 0, f"{label} {dt}: K1 launched {launches} "
          f"times on {levels} levels with children")
    n = f.A.height
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    S = f.A.to_scipy()

    def resid(x):
        x = x.cpu().numpy().astype(np.complex128)
        return float(np.linalg.norm(S @ x - b) / np.linalg.norm(b))

    f.solve(b)                                          # warm
    x, t_solve = wall(lambda: f.solve(b))
    xr, t_ref = wall(lambda: f.solve_with_iterative_refinement(b))
    r0, r = resid(x), resid(xr)
    bound = f.residual_bound()
    check(np.isfinite(r) and r < bound, f"{label} {dt}: refined residual "
          f"{r:.3e} >= bound {bound:.3e}")
    line = (f"[{tag}] {label} {dt}: factor {t_factor:.3f} s, K1 launches "
            f"{launches} ({levels} levels with children); solve "
            f"{t_solve * 1e3:.1f} ms, residual {r0:.3e}; refined (6 steps) "
            f"{t_ref * 1e3:.1f} ms, residual {r:.3e} < {bound:.3e}")
    if ctx:
        num = f.numeric
        panels, t_ctx = wall(num.solve_context)
        xc, t_csolve = wall(lambda: num.solve(b, panels))
        del panels
        rc = resid(xc)
        diff = float(torch.linalg.vector_norm(xc - x)
                     / torch.linalg.vector_norm(x))
        check(np.isfinite(rc) and rc < bound and (
            f.dtype != torch.complex128 or diff <= 1e-6),
            f"{label} {dt}: solve through the panel inverses: residual "
            f"{rc:.3e} (bound {bound:.3e}), {diff:.3e} from substitution")
        line += (f"; through the panel inverses ({t_ctx:.3f} s to build) "
                 f"{t_csolve * 1e3:.1f} ms, residual {rc:.3e}, "
                 f"{diff:.3e} from substitution")
    if kappa:
        line += f"; κ ≥ {kappa_estimate(f):.3e} (8 power iterations each)"
    f.numeric = None
    torch.cuda.empty_cache()
    line += "; " + k1_against_plain(first.args)
    print(line)
    torch.cuda.empty_cache()
    return launches


def phase_complex(seed: int, orders) -> tuple:
    """18: complex sparse LDL on the card (see the module docstring).
    Returns (K1 launches by dtype, K1 alone on the 384² plan by dtype)."""
    import torch
    from elemental_tpu_torch.sparse_direct import SparseLDLFactorization
    c64, c128 = torch.complex64, torch.complex128
    launches = {c64: 0, c128: 0}
    tag = "18 complex LDL"
    A, _ = complex_pattern("2d")
    shift = helmholtz_shift(C2D)
    o2 = orders["c2d"]
    base = SparseLDLFactorization(device="cuda", dtype=c64)
    _, t_init = wall(lambda: base.initialize(A, perm=o2["perm"]))
    print(f"[{tag}] 2-D: damped Helmholtz {C2D}², shift ω²(1 + 0.05i) = "
          f"{shift:.6g}, N={A.height}, natural nested dissection: "
          f"{base.symb.num_levels} levels, {o2['levels']} with an "
          f"extend-add, largest front {o2['front']}, pool {o2['pool']} "
          f"entries ({o2['pool'] * 16 / 1e9:.2f} GB in complex128); "
          f"initialize {t_init:.2f} s (the worker's analysis "
          f"{o2['seconds']:.1f} s)")
    k1 = phase_k1(base.ea_plan, seed, {c64: 1e-5, c128: 1e-12},
                  tag=f"{tag} K1")
    cases = (("A (Helmholtz, LDLᵀ)", A, False, False, False),
             ("H(a) (magnetic, σ = 0, HPD)", magnetic_laplacian(C2D, 0.0),
              True, True, False),
             (f"H(b) (magnetic, σ = {landau_gap_shift(C2D):.6g} in the "
              f"lowest Landau gap, LDLᴴ)",
              magnetic_laplacian(C2D, landau_gap_shift(C2D)), True, False,
              True))
    for label, M, herm, spd, kappa in cases:
        for dtype in (c64, c128):
            f = same_analysis(base, M, dtype=dtype, hermitian=herm, spd=spd)
            launches[dtype] += complex_factor(
                tag, label, f, o2["levels"], seed, ctx=herm,
                kappa=kappa and dtype == c128)
    print(f"[{tag}] A: " + profile_factor(base))
    del base, cases
    torch.cuda.empty_cache()

    A3, _ = complex_pattern("3d")
    o3 = orders["c3d"]
    base = SparseLDLFactorization(device="cuda", dtype=c64)
    _, t_init = wall(lambda: base.initialize(A3, perm=o3["perm"]))
    print(f"[{tag}] 3-D: damped Helmholtz {C3D}³, shift "
          f"{helmholtz_shift(C3D):.6g}, N={A3.height}: "
          f"{base.symb.num_levels} levels, {o3['levels']} with an "
          f"extend-add, largest front {o3['front']}, pool {o3['pool']} "
          f"entries ({o3['pool'] * 16 / 1e9:.2f} GB in complex128); "
          f"initialize {t_init:.2f} s (the worker's analysis "
          f"{o3['seconds']:.1f} s)")
    for dtype in (c64, c128):
        f = same_analysis(base, A3, dtype=dtype, hermitian=False, spd=False)
        launches[dtype] += complex_factor(tag, "A3 (Helmholtz 3-D, LDLᵀ)", f,
                                          o3["levels"], seed)
    print(f"[{tag}] A3: " + profile_factor(base))
    del base
    torch.cuda.empty_cache()
    return launches, k1


DENSE_N = 8192          # phase 19's matrices: DENSE_N², the 3-D GEMM at half


def _fro(x, ref) -> float:
    """‖x − ref‖_F / ‖ref‖_F in float64 (complex128 for complex)."""
    import torch
    wide = torch.complex128 if ref.is_complex() else torch.float64
    ref = ref.to(wide)
    return float(torch.linalg.norm(x.to(wide) - ref)
                 / torch.linalg.norm(ref))


def _on_card(D) -> bool:
    return all(D.local(i, j).is_cuda for i, j in D.grid.positions())


def _owned(D) -> bool:
    """Every block's storage is its own size."""
    return all(D.local(i, j).untyped_storage().nbytes()
               == D.local(i, j).numel() * D.local(i, j).element_size()
               for i, j in D.grid.positions())


# run N3 (one NVIDIA H100 80GB HBM3 at 700 W), taken when the BLAS tier
# assembled each operand on the grid's first position: each level 1/2
# case's time over the bare torch op, the SUMMA variants' over
# torch.matmul
N3_RATIO = {"gemv N": "5.55", "ger": "1.68", "axpy": "2.88", "nrm2": "5.36",
            "dot": "5.68"}
N3_SUMMA = {"float32": "1.039-1.068", "float64": "1.220-1.253"}


def _audit(log) -> str:
    """The transfer log's records by kind: count and MiB."""
    kinds = {}
    for r in log:
        c, b = kinds.get(r.kind, (0, 0))
        kinds[r.kind] = (c + 1, b + r.bytes)
    return ", ".join(f"{k} {c}× {b / 2 ** 20:.1f} MiB"
                     for k, (c, b) in sorted(kinds.items())) or "none"


def _whole_gathers(log, shapes, numel: int) -> list:
    """The all-gather records that hold a whole operand or result: a shape
    in ``shapes``, or at least ``numel`` entries."""
    return [r for r in log.of("all-gather")
            if r.shape in shapes or math.prod(r.shape) >= numel]


def _stored(x) -> int:
    """Bytes of device storage a result holds (each block once)."""
    ts = ([x.local(i, j) for i, j in x.grid.positions()]
          if hasattr(x, "grid") else [x] if hasattr(x, "untyped_storage")
          else [t for t in x if hasattr(t, "untyped_storage")])
    seen = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
            for t in ts}
    return sum(seen.values())


def _counted(fn):
    """(fn()'s result, its transfer log, the device bytes it allocated
    above what was allocated before it, less those its result holds)."""
    import torch
    from elemental_tpu_torch.utils import count_transfers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with count_transfers() as log:
        out = fn()
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - _stored(out)
    return out, log, extra


def phase_dense(seed: int) -> None:
    """19: the dense core and the BLAS tier on the card (see the module
    docstring).  Every gate is fatal."""
    import warnings
    import numpy as np
    import torch
    from elemental_tpu_torch import ops
    from elemental_tpu_torch.core import (DIST_PAIRS, MC, MR, Grid,
                                          as_array, distribute,
                                          residual_bound)
    from elemental_tpu_torch.core.blockcyclic import BlockCyclicMatrix
    tag = "19 dense"
    n = DENSE_N
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rand(shape, dtype):
        real = {torch.complex64: torch.float32}.get(dtype, dtype)
        x = torch.randn(shape, generator=gen, device="cuda", dtype=real)
        if dtype.is_complex:
            x = torch.complex(x, torch.randn(shape, generator=gen,
                                             device="cuda", dtype=real))
        return x

    Grid.set_default(None)
    g1 = Grid()
    dev = g1.device(0, 0)
    check(g1.size == 1 and dev.type == "cuda" and (dev.index or 0) == 0,
          f"Grid() is {g1}, not 1×1 on the first card")
    g4 = Grid(devices=[dev] * 4, height=2)
    print(f"[{tag}] Grid() = {g1}; the 2×2 grid repeats it: {g4}")

    # redistribution: every pair of DIST_PAIRS and back, bit-exact
    a = rand((n, n), torch.float64)
    A = distribute(a, MC, MR, g4)
    check(_on_card(A) and tuple(A.local(1, 1).shape) == (n // 2, n // 2),
          "[MC,MR] blocks")
    S = ops.scale(2.0, A)
    check(_owned(A) and _owned(S),
          "an [MC,MR] block does not own its storage (distribute, scale)")
    print(f"[{tag}] storage: each [MC,MR] block of {n}² float64 made by "
          f"distribute and by scale owns "
          f"{A.local(1, 1).untyped_storage().nbytes() / 2 ** 20:.0f} MiB, "
          f"its own size")
    del S
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for pair in DIST_PAIRS:
        B = A.redistribute(*pair)
        check(_on_card(B), f"[{pair[0].value},{pair[1].value}] off the card")
        check(_owned(B), f"[{pair[0].value},{pair[1].value}]: a block that "
              f"does not own its storage")
        check(torch.equal(as_array(B.redistribute(MC, MR)), a),
              f"[MC,MR] → [{pair[0].value},{pair[1].value}] → [MC,MR] "
              f"changed the matrix")
        del B
    torch.cuda.synchronize()
    print(f"[{tag}] redistribution: {n}² float64 on the 2×2 grid through "
          f"all {len(DIST_PAIRS)} pairs and back, bit-exact, in "
          f"{time.perf_counter() - t0:.2f} s (with the checks)")

    # block-cyclic: a round trip and a gemm through the conversion
    nb = 128
    Bc = BlockCyclicMatrix.from_element(A, mb=nb, nb=nb)
    per = len(Bc.rperm) // 2
    check(all(((Bc.rperm[p * per:(p + 1) * per] // nb) % 2 == p).all()
              for p in range(2)), "block-cyclic row ownership")
    check(torch.equal(as_array(Bc.to_element()), a),
          "block-cyclic round trip changed the matrix")
    b = rand((n, n), torch.float64)
    Cb = ops.gemm("N", "N", 1.0, Bc.to_element(),
                  BlockCyclicMatrix.from_element(
                      distribute(b, MC, MR, g4), mb=nb, nb=nb).to_element())
    err = _fro(as_array(Cb), a @ b)
    check(err <= 1e-13, f"gemm through the block-cyclic layout: {err:.3g}")
    print(f"[{tag}] block-cyclic nb = {nb}: {n}² round trip bit-exact; "
          f"gemm through the conversion, rel. error {err:.3g}")
    del A, Bc, Cb, a, b

    # GEMM: the 1×1 grid's 'xla' and each SUMMA variant on the 2×2 grid
    gates = {torch.float32: 1e-5, torch.float64: 1e-13}
    for dtype, gate in gates.items():
        a, b = rand((n, n), dtype), rand((n, n), dtype)
        ref = a.double() @ b.double()
        lib = cuda_ms(lambda: torch.matmul(a, b), 10)
        tf = 2.0 * n ** 3 / 1e9
        cases = [("xla", g1)] + [(alg, g4) for alg in (
            "stationary_c", "stationary_a", "stationary_b", "pipelined")]
        for alg, g in cases:
            A, B = distribute(a, MC, MR, g), distribute(b, MC, MR, g)
            C, log, extra = _counted(
                lambda: ops.gemm("N", "N", 1.0, A, B, alg=alg))
            check(_on_card(C) and _owned(C),
                  f"gemm {alg}: a block off the card or not its own")
            whole = _whole_gathers(log, {(n, n)}, n * n)
            check(not whole, f"gemm {alg}: a whole operand gathered: "
                  f"{whole[:2]}")
            err = _fro(as_array(C), ref)
            check(err <= gate, f"gemm {alg} {dtype}: rel. error {err:.3g} "
                  f"over {gate:g}")
            del C
            ms = cuda_ms(lambda: ops.gemm("N", "N", 1.0, A, B, alg=alg), 10)
            print(f"[{tag}] gemm {str(dtype)[6:]} {n}³ {alg} on "
                  f"{g.height}×{g.width}: {ms:.3f} ms, {tf / ms:.2f} "
                  f"TFLOP/s, {ms / lib:.3f}× torch.matmul ({lib:.3f} ms; "
                  f"assembled, N3: {N3_SUMMA[str(dtype)[6:]]}× on 2×2); "
                  f"rel. error {err:.3g}; transfers: {_audit(log)}; extra "
                  f"peak {extra / 2 ** 20:.0f} MiB")
        m_, k_, n_ = n - 1, n - 2, n + 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)   # not divisible
            A = distribute(a[:m_, :k_], MC, MR, g4)
            B = distribute(rand((k_, n_), dtype), MC, MR, g4)
        alg = ops.summa.choose_algorithm(m_, n_, k_, g4)
        C, log, extra = _counted(lambda: ops.gemm("N", "N", 1.0, A, B))
        err = _fro(as_array(C), as_array(A).double() @ as_array(B).double())
        check(err <= gate, f"gemm {m_}×{k_}×{n_} {dtype}: {err:.3g}")
        del C
        ms = cuda_ms(lambda: ops.gemm("N", "N", 1.0, A, B), 10)
        print(f"[{tag}] gemm {str(dtype)[6:]} {m_}×{k_}×{n_} (not divided: "
              f"m and n replicated) on 2×2, auto = {alg}: {ms:.3f} ms, "
              f"{2.0 * m_ * n_ * k_ / 1e9 / ms:.2f} TFLOP/s; rel. error "
              f"{err:.3g}; transfers: {_audit(log)}; extra peak "
              f"{extra / 2 ** 20:.0f} MiB")
        del A, B, a, b, ref
        torch.cuda.empty_cache()

    # trsm: ‖op(T)X − αB‖ / (‖T‖‖X‖) under residual_bound
    for dtype in (torch.float32, torch.float64, torch.complex64):
        eye = n * torch.eye(n, device="cuda", dtype=dtype)
        rhs = rand((n, n), dtype)
        for side, uplo, orient in (("L", "L", "N"), ("R", "U", "C")):
            T = (torch.tril if uplo == "L" else torch.triu)(
                rand((n, n), dtype)) + eye
            X = ops.trsm(side, uplo, orient, "N", 1.5, T, rhs)
            wide = torch.complex128 if dtype.is_complex else torch.float64
            Tw, Xw = T.to(wide), X.to(wide)
            op = Tw if orient == "N" else Tw.conj().T
            r = (op @ Xw if side == "L" else Xw @ op) - 1.5 * rhs.to(wide)
            res = float(torch.linalg.norm(r) / (torch.linalg.norm(Tw)
                                                * torch.linalg.norm(Xw)))
            bound = residual_bound(dtype, n)
            check(res < bound, f"trsm {side}{uplo}{orient} {dtype}: "
                  f"residual {res:.3g} over {bound:.3g}")
            del X, Tw, Xw, op, r
            ms = cuda_ms(lambda: ops.trsm(side, uplo, orient, "N", 1.5, T,
                                          rhs), 3)
            lib = cuda_ms(lambda: torch.linalg.solve_triangular(
                T if orient == "N" else T.conj().T, 1.5 * rhs,
                upper=(uplo == "U") != (orient != "N"), left=side == "L"), 3)
            flops = n ** 3 * (4 if dtype.is_complex else 1) / 1e9
            print(f"[{tag}] trsm {side}{uplo}{orient}N {str(dtype)[6:]} "
                  f"n = {n}, {n} right-hand sides: {ms:.3f} ms "
                  f"({flops / ms:.2f} TFLOP/s), solve_triangular "
                  f"{lib:.3f} ms; residual {res:.3g} (bound {bound:.3g})")
            del T
        del eye, rhs
        torch.cuda.empty_cache()

    # herk, trrk, symm, hemm, trmm against the same formula in float64
    k = n // 2
    a, c = rand((n, k), torch.float32), rand((n, n), torch.float32)
    bk = rand((k, n), torch.float32)
    s, z = rand((n, n), torch.float32), rand((n, n), torch.complex64)
    zb = rand((n, n), torch.complex64)
    ad, cd, bkd, sd = a.double(), c.double(), bk.double(), s.double()
    hermitian = torch.tril(z.to(torch.complex128))
    hermitian = hermitian + torch.tril(hermitian, -1).conj().T \
        - 1j * torch.diag(torch.diagonal(hermitian).imag)
    symmetric = torch.tril(sd) + torch.tril(sd, -1).T
    cases = (
        (f"herk L N {n}×{k}", torch.float32,
         lambda: ops.herk("L", "N", 1.0, a),
         lambda: torch.tril(ad @ ad.T), 2.0 * n * n * k),
        (f"trrk L N N {n}×{k}", torch.float32,
         lambda: ops.trrk("L", "N", "N", 1.5, a, bk, 0.5, c),
         lambda: torch.tril(1.5 * (ad @ bkd) + 0.5 * cd)
         + torch.triu(cd, 1), 2.0 * n * n * k),
        ("symm L L", torch.float32,
         lambda: ops.symm("L", "L", 1.0, s, c),
         lambda: symmetric @ cd, 2.0 * n ** 3),
        ("hemm L L", torch.complex64,
         lambda: ops.hemm("L", "L", 1.0, z, zb),
         lambda: hermitian @ zb.to(torch.complex128), 8.0 * n ** 3),
        ("trmm L U N N", torch.float32,
         lambda: ops.trmm("L", "U", "N", "N", 1.0, s, c),
         lambda: torch.triu(sd) @ cd, 2.0 * n ** 3),
    )
    for what, dtype, run, formula, flops in cases:
        got = run()
        err = _fro(got, formula())
        check(err <= 1e-5, f"{what}: rel. error {err:.3g}")
        del got
        ms = cuda_ms(run, 3)
        print(f"[{tag}] {what} {str(dtype)[6:]} ({n}²): {ms:.3f} ms, "
              f"{flops / 1e9 / ms:.2f} TFLOP/s; rel. error {err:.3g} against "
              f"the formula in float64")
    del a, c, bk, s, z, zb, ad, cd, bkd, sd, hermitian, symmetric
    torch.cuda.empty_cache()

    # herk on the 2×2 grid's blocks (no whole operand or result gathered),
    # and trsm, assembled at the first position as the JAX HLO gathers it
    k = n // 2
    a = rand((n, k), torch.float32)
    Ad = distribute(a, MC, MR, g4)
    H, log, extra = _counted(lambda: ops.herk("L", "N", 1.0, Ad))
    whole = _whole_gathers(log, {(n, k), (n, n)}, n * k)
    check(_on_card(H) and _owned(H) and not whole,
          f"herk on the 2×2 grid: a block off the card or not its own, or "
          f"a whole operand gathered: {whole[:2]}")
    ad = a.double()
    err = _fro(as_array(H), torch.tril(ad @ ad.T))
    check(err <= 1e-5, f"herk on the 2×2 grid: rel. error {err:.3g}")
    del H, ad
    ms = cuda_ms(lambda: ops.herk("L", "N", 1.0, Ad), 3)
    lib = cuda_ms(lambda: torch.tril(a @ a.T), 3)
    print(f"[{tag}] herk L N float32 {n}×{k} on the 2×2 grid: {ms:.3f} ms, "
          f"{2.0 * n * n * k / 1e9 / ms:.2f} TFLOP/s, {ms / lib:.3f}× "
          f"torch.tril(a @ a.T) ({lib:.3f} ms); rel. error {err:.3g}; "
          f"transfers: {_audit(log)}; extra peak {extra / 2 ** 20:.0f} MiB")
    del a, Ad
    T = distribute(torch.tril(rand((n, n), torch.float64))
                   + n * torch.eye(n, device="cuda", dtype=torch.float64),
                   MC, MR, g4)
    R = distribute(rand((n, n), torch.float64), MC, MR, g4)
    X, log, extra = _counted(lambda: ops.trsm("L", "L", "N", "N", 1.5, T, R))
    check(_on_card(X) and _owned(X), "trsm on the 2×2 grid: the result's "
          "blocks")
    t, x, r = as_array(T), as_array(X), as_array(R)
    res = float(torch.linalg.norm(torch.tril(t) @ x - 1.5 * r)
                / (torch.linalg.norm(torch.tril(t)) * torch.linalg.norm(x)))
    bound = residual_bound(torch.float64, n)
    check(res < bound, f"trsm on the 2×2 grid: residual {res:.3g}")
    del X, t, x, r
    ms = cuda_ms(lambda: ops.trsm("L", "L", "N", "N", 1.5, T, R), 3)
    print(f"[{tag}] trsm LLNN float64 {n}² on the 2×2 grid (assembled at "
          f"the first position, as the JAX HLO gathers A whole): "
          f"{ms:.3f} ms; residual {res:.3g}; transfers: {_audit(log)}; "
          f"extra peak {extra / 2 ** 20:.0f} MiB")
    del T, R
    torch.cuda.empty_cache()

    # level 1 and 2 on the 2×2 grid
    x, y = rand((n, n), torch.float32), rand((n, n), torch.float32)
    u, v = rand((n,), torch.float32), rand((n,), torch.float32)
    X, Y = distribute(x, MC, MR, g4), distribute(y, MC, MR, g4)
    xd, yd = x.double(), y.double()
    nx, ny = float(torch.linalg.norm(xd)), float(torch.linalg.norm(yd))
    cases = (
        ("gemv N", lambda: ops.gemv("N", 2.0, X, u),
         lambda: 2.0 * (xd @ u.double()), lambda: 2.0 * (x @ u), 4 * n * n),
        ("ger", lambda: ops.ger(0.5, u, v, X),
         lambda: xd + 0.5 * torch.outer(u.double(), v.double()),
         lambda: x + 0.5 * torch.outer(u, v), 8 * n * n),
        ("axpy", lambda: ops.axpy(2.0, X, Y), lambda: yd + 2.0 * xd,
         lambda: y + 2.0 * x, 12 * n * n),
        ("nrm2", lambda: ops.nrm2(X), None,
         lambda: torch.linalg.vector_norm(x), 4 * n * n),
        ("dot", lambda: ops.dot(X, Y), None,
         lambda: torch.vdot(x.reshape(-1), y.reshape(-1)), 8 * n * n),
    )
    for what, run, formula, bare, nbytes in cases:
        got, log, extra = _counted(run)
        whole = _whole_gathers(log, {(n, n), (n,)}, n * n)
        check(not whole, f"{what}: a whole operand or result gathered on "
              f"the block route: {whole[:2]}")
        if hasattr(got, "grid"):
            check(_owned(got), f"{what}: a block not its own")
        if what == "nrm2":
            err = abs(float(got) - nx) / nx
        elif what == "dot":
            err = abs(float(got) - float(torch.sum(xd * yd))) / (nx * ny)
        else:
            if hasattr(got, "grid"):
                check(_on_card(got) and got.dist() == (MC, MR),
                      f"{what}: the result's layout")
                got = as_array(got)
            err = _fro(got, formula())
        check(err <= 1e-5, f"{what}: rel. error {err:.3g}")
        del got
        ms, bare_ms = cuda_ms(run, 10), cuda_ms(bare, 10)
        print(f"[{tag}] {what} float32 on the 2×2 grid ({n}²): {ms:.3f} ms, "
              f"{nbytes / 1e6 / ms:.1f} GB/s of the operands, {ms / bare_ms:.2f}"
              f"× the same torch op on the whole tensors ({bare_ms:.3f} ms; "
              f"assembled, N3: {N3_RATIO[what]}×); rel. error {err:.3g}; "
              f"transfers: {_audit(log)}; extra peak "
              f"{extra / 2 ** 20:.0f} MiB")
    del x, y, X, Y, xd, yd
    torch.cuda.empty_cache()

    # the 3-D GEMM on a 2×2×2 mesh over the card
    m3 = n // 2
    mesh = ops.make_3d_mesh([dev] * 8, depth=2)
    for dtype, gate in gates.items():
        a, b = rand((m3, m3), dtype), rand((m3, m3), dtype)
        err = _fro(ops.gemm_3d(a, b, mesh), a.double() @ b.double())
        check(err <= gate, f"gemm_3d {dtype}: rel. error {err:.3g}")
        ms = cuda_ms(lambda: ops.gemm_3d(a, b, mesh), 10)
        lib = cuda_ms(lambda: torch.matmul(a, b), 10)
        print(f"[{tag}] gemm_3d {str(dtype)[6:]} {m3}³ on 2×2×2: "
              f"{ms:.3f} ms, {2.0 * m3 ** 3 / 1e9 / ms:.2f} TFLOP/s, "
              f"{ms / lib:.3f}× torch.matmul ({lib:.3f} ms); rel. error "
              f"{err:.3g}")
        del a, b

    # queued updates against index_put_ with accumulation (integer values:
    # every order of the sums is exact)
    rng = np.random.default_rng(seed)
    q = 100_000
    ii, jj = rng.integers(0, n, q), rng.integers(0, n, q)
    ii[: q // 10] = ii[q // 10: q // 5]           # repeats
    jj[: q // 10] = jj[q // 10: q // 5]
    vals = rng.integers(-8, 9, q).astype(np.float64)
    base = torch.round(4 * rand((n, n), torch.float64))
    M = distribute(base, MC, MR, g4)
    t0 = time.perf_counter()
    for i, j, val in zip(ii.tolist(), jj.tolist(), vals.tolist()):
        M.queue_update(i, j, val)
    t_queue = time.perf_counter() - t0
    M2, t_drain = wall(M.process_queues)
    idx = (torch.from_numpy(ii).to(dev), torch.from_numpy(jj).to(dev))
    want = base.clone().index_put_(idx, torch.from_numpy(vals).to(dev),
                                   accumulate=True)
    check(torch.equal(as_array(M2), want),
          "queued updates differ from index_put_(accumulate=True)")
    for i, j in zip(ii[:1000].tolist(), jj[:1000].tolist()):
        M2.queue_pull(i, j)
    pulled = M2.process_pull_queue()
    check(np.array_equal(pulled, want[idx[0][:1000], idx[1][:1000]].cpu()
                         .numpy()), "queued pulls")
    print(f"[{tag}] {q} queued updates (repeats included) on {n}² float64, "
          f"2×2 grid: queued in {t_queue:.2f} s, drained in {t_drain:.3f} s, "
          f"equal to index_put_(accumulate=True); 1000 pulls equal")
    del base, M, M2, want
    torch.cuda.empty_cache()
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s; "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


SPARSE_N1 = 1024        # phase 20's Laplacian: SPARSE_N1² rows
SPARSE_LP = 224         # phase 20's Galerkin: concat_fd_2d(SPARSE_LP, ...)


def _frob(x, ref) -> float:
    """‖x − ref‖_F / ‖ref‖_F of two host arrays, in float64."""
    import numpy as np
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(x, np.float64) - ref)
                 / np.linalg.norm(ref))


SPARSE_TOL = {"float32": 1e-5, "float64": 1e-12}


def _same_structure(M, ref) -> bool:
    """A SparseMatrix's CSR structure equals a sorted scipy matrix's."""
    import numpy as np
    return (M.shape == ref.shape and np.array_equal(M.rowptr, ref.indptr)
            and np.array_equal(M.colind, ref.indices))


def sparse_product_cases(tag: str, label: str, plan, operands, ref,
                         t_sym: float, lib) -> dict:
    """One fixed-structure product's numeric on the card in float32 and
    float64: ``plan`` (on the card; ``plan.c_idx`` its multiplications'
    destinations) and ``operands(dtype)`` → the numeric's arguments;
    ``ref`` the scipy product (its values the gate, within SPARSE_TOL
    relative, Frobenius); ``lib(dtype)`` → a function that runs the one
    PyTorch call computing the same product, or None.  Prints ms (CUDA
    events, 10 launches), the bound and whether 5 calls gave the same bits;
    returns {dtype name: {"ms", "lib_ms", "vals" (host)}}."""
    import torch
    idx_arrays = [v for v in vars(plan).values()
                  if isinstance(v, torch.Tensor)]
    nmul = int(plan.c_idx.numel())
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        args = operands(dtype)
        vals = plan.numeric(*args)
        host = vals.cpu().numpy()
        err = _frob(host, ref.data)
        check(err <= SPARSE_TOL[name], f"{label} {name}: {err:.3e} from "
              f"scipy (bound {SPARSE_TOL[name]:g})")
        same = all(torch.equal(plan.numeric(*args), vals) for _ in range(5))
        ms = cuda_ms(lambda: plan.numeric(*args), 10)
        # each index array read once, one value gathered per array but the
        # destinations', C written once
        isz = vals.element_size()
        nbytes = (sum(t.numel() * t.element_size() for t in idx_arrays)
                  + nmul * isz * (len(idx_arrays) - 1) + plan.c_nnz * isz)
        bms, _ = bound(nbytes)
        lib_ms = cuda_ms(lib(dtype), 10) if lib is not None else None
        out[name] = {"ms": ms, "lib_ms": lib_ms, "vals": host}
        lib_txt = (f"torch.sparse.mm (cuSPARSE, its symbolic phase again "
                   f"every call) {lib_ms:.3f} ms" if lib_ms is not None
                   else "no one PyTorch call computes it")
        print(f"[{tag}] {label} {name}: numeric {ms:.3f} ms (10 launches, "
              f"{nmul:,} multiplications into {plan.c_nnz:,} nonzeros), "
              f"bound {bms:.4f} ms ({nbytes / 1e6:.0f} MB: index arrays, "
              f"gathered values, C), {bms / ms:.2f} of its speed; "
              f"{lib_txt}; host symbolic {t_sym:.2f} s; {err:.2e} from "
              f"scipy (Frobenius, bound {SPARSE_TOL[name]:g}); 5 calls "
              f"bit-equal: {same}")
    return out


def phase_sparse_products(seed: int) -> None:
    """20: the sparse products and the distributed sparse containers at
    full size (see the module docstring).  Every gate is fatal."""
    import numpy as np
    import scipy.sparse as sps
    import torch
    from elemental_tpu_torch.core import Grid
    from elemental_tpu_torch.lapack import cg
    from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_2d
    from elemental_tpu_torch.sparse import (DistMap, DistMultiVec,
                                            DistSparseMatrix, dist_galerkin,
                                            dist_spgemm_plan, galerkin_plan,
                                            spgemm_plan)
    from elemental_tpu_torch.utils import count_transfers
    tag = "20 sparse products"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    cuda = torch.device("cuda")
    A = sparse_laplacian_2d(SPARSE_N1, SPARSE_N1, scaled=False)
    K = concat_fd_2d(SPARSE_LP, SPARSE_LP)
    N = A.height
    print(f"[{tag}] the unscaled {SPARSE_N1}² Laplacian: N = {N:,}, nnz = "
          f"{A.nnz:,}; the LP's concat_fd_2d({SPARSE_LP}, {SPARSE_LP}): "
          f"{K.height:,} × {K.width:,}, nnz = {K.nnz:,}")

    def on(M, dtype):
        return torch.from_numpy(M.vals).to(cuda, dtype)

    def csr(M, dtype):
        return torch.sparse_csr_tensor(
            torch.from_numpy(M.rowptr), torch.from_numpy(M.colind),
            torch.from_numpy(M.vals).to(dtype), M.shape).to(cuda)

    # SpGEMM A·A against scipy, beside torch.sparse.mm
    plan, t_sym = wall(lambda: spgemm_plan(A, A))
    As = A.to_scipy()
    ref = (As @ As).tocsr()
    ref.sort_indices()
    nmul = int(plan.a_idx.numel())
    check(_same_structure(plan.c_struct, ref), "A·A: C's structure is not "
          "scipy's")
    print(f"[{tag}] spgemm A·A: {nmul:,} multiplications, {plan.c_nnz:,} "
          f"nonzeros, structure equal to scipy's")
    pd = plan.to(cuda)

    def lib_mm(dtype):
        S = csr(A, dtype)
        return lambda: torch.sparse.mm(S, S)

    for dtype in (torch.float32, torch.float64):
        L = torch.sparse.mm(csr(A, dtype), csr(A, dtype))
        x = torch.from_numpy(rng.standard_normal(N)).to(cuda, dtype)
        mine = torch.sparse_csr_tensor(
            torch.from_numpy(ref.indptr).to(cuda),
            torch.from_numpy(ref.indices).to(cuda),
            pd.numeric(on(A, dtype), on(A, dtype)), ref.shape)
        err = _frob((L @ x).cpu().numpy(), (mine @ x).cpu().numpy())
        print(f"[{tag}] torch.sparse.mm {str(dtype)[6:]}: {L.values().numel():,}"
              f" nonzeros; (its C)·x against (ours)·x: {err:.2e}")
        del L, mine
    spg = sparse_product_cases(tag, "spgemm A·A", pd,
                               lambda dt: (on(A, dt), on(A, dt)), ref, t_sym,
                               lib_mm)
    del pd

    # Galerkin A·D·Aᵀ on both matrices, the plan reused with a second d
    for label, M in (("Laplacian", A), ("LP's A", K)):
        gp, t_sym = wall(lambda: galerkin_plan(M))
        Ms = M.to_scipy()
        d1, d2 = (rng.uniform(0.5, 2.0, M.width) for _ in range(2))
        gpd = gp.to(cuda)
        for k, d in enumerate((d1, d2)):
            gref = (Ms @ sps.diags(d) @ Ms.T).tocsr()
            gref.sort_indices()
            check(_same_structure(gp.c_struct, gref),
                  f"Galerkin {label}: C's structure is not scipy's")
            sparse_product_cases(
                tag, f"Galerkin A·D·Aᵀ, {label}, d{k + 1}", gpd,
                lambda dt: (on(M, dt), torch.from_numpy(d).to(cuda, dt)),
                gref, t_sym, None)
        del gpd

    # the 2×2 grid over the card
    g4 = Grid(devices=[cuda] * 4, height=2)
    g1 = Grid(devices=[cuda])
    dA, t_plan = wall(lambda: DistSparseMatrix.from_sparse(
        A, g4, dtype=torch.float32))
    check(all(t.is_cuda for t in dA.lvals), "DistSparseMatrix off the card")
    dA1 = DistSparseMatrix.from_sparse(A, g1, dtype=torch.float32)
    dev = A.device_csr(device=cuda, dtype=torch.float32)
    x = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(cuda)
    want = dev.matvec(x)
    for name, got in (("matvec", dA.matvec(x)),
                      ("matvec_transpose", dA.matvec_transpose(x))):
        err = float((got - want).abs().max() / want.abs().max())
        check(err <= 1e-5, f"2×2 {name}: {err:.2e} from CSRDevice")
    xv = DistMultiVec.from_array(x, g4)
    with count_transfers() as log:
        yv = dA.matvec(xv)
    err = float((yv.assemble() - want).abs().max() / want.abs().max())
    check(err <= 1e-5 and not log.of("all-gather"),
          f"2×2 DistMultiVec matvec: {err:.2e}, gathers "
          f"{len(log.of('all-gather'))}")
    full = N * 4 * g4.size
    t_csr = cuda_ms(lambda: dev.matvec(x), 20)
    t_mv = cuda_ms(lambda: dA.matvec(x), 20)
    t_mt = cuda_ms(lambda: dA.matvec_transpose(x), 20)
    t_mvd = cuda_ms(lambda: dA.matvec(xv), 20)
    t_1 = cuda_ms(lambda: dA1.matvec(x), 20)
    print(f"[{tag}] DistSparseMatrix of the Laplacian on 2×2 (host plan "
          f"{t_plan:.2f} s, halo H = {dA.halo}): matvec {t_mv:.4f} ms, "
          f"matvec_transpose {t_mt:.4f} ms, on DistMultiVec blocks "
          f"{t_mvd:.4f} ms; on 1×1 {t_1:.4f} ms; CSRDevice.matvec "
          f"{t_csr:.4f} ms; ratio 2×2/CSRDevice {t_mv / t_csr:.2f} "
          f"(blocks {t_mvd / t_csr:.2f}); float32, 20 launches each")
    print(f"[{tag}] transfers per DistMultiVec matvec: {log.bytes():,} bytes "
          f"in {len(log)} all-to-all records; a full gather of x to every "
          f"position: {full:,} bytes ({log.bytes() / full:.2e} of it)")

    b = rng.standard_normal(N).astype(np.float32)
    res, t_cg = wall(lambda: cg(dA.matvec, torch.from_numpy(b).to(cuda),
                                tol=1e-6, max_iters=20000))
    xs = res.x.cpu().numpy().astype(np.float64)
    rel = float(np.linalg.norm(As @ xs - b) / np.linalg.norm(b))
    check(np.all(np.isfinite(xs)) and rel < CG_RESIDUAL_BOUND,
          f"2×2 CG: host residual {rel:.3e}")
    print(f"[{tag}] CG on the 2×2 DistSparseMatrix, float32, tol 1e-6: "
          f"{res.iterations} iterations in {t_cg:.2f} s "
          f"({t_cg / res.iterations * 1e3:.4f} ms/iteration); host-verified "
          f"(float64) {rel:.3e} < {CG_RESIDUAL_BOUND:g}")
    del dA1, dev

    # dist_spgemm A·A and dist_galerkin of the LP's A against 1×1
    d64 = DistSparseMatrix.from_sparse(A, g4, dtype=torch.float64)
    dp, t_dsym = wall(lambda: dist_spgemm_plan(d64, d64))
    check(np.array_equal(dp.c_host.colind, ref.indices),
          "dist_spgemm: C's structure")
    for dtype, dX in ((torch.float32, dA), (torch.float64, d64)):
        name = str(dtype)[6:]
        with count_transfers() as log:
            lv = dp.numeric(dX.lvals, dX.lvals)
        flat = torch.cat([v.cpu() for v in lv]).numpy()[
            dp.c_template.val_slot]
        err = _frob(flat, spg[name]["vals"])
        check(err <= SPARSE_TOL[name], f"dist_spgemm {name}: {err:.2e} from "
              f"the 1×1 spgemm")
        ms = cuda_ms(lambda: dp.numeric(dX.lvals, dX.lvals), 10)
        print(f"[{tag}] dist_spgemm A·A on 2×2, {name}: numeric {ms:.3f} ms "
              f"(1×1 spgemm {spg[name]['ms']:.3f}); {err:.2e} from the 1×1 "
              f"result; host symbolic {t_dsym:.2f} s; halo H = {dp.halo}, "
              f"{log.bytes():,} bytes across positions, no all-gather: "
              f"{not log.of('all-gather')}")
    del d64, dp, dA
    d = rng.uniform(0.5, 2.0, K.width)
    gK = galerkin_plan(K)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        dK = DistSparseMatrix.from_sparse(K, g4, dtype=dtype)
        dC, t_dg = wall(lambda: dist_galerkin(dK, d))
        one = gK.numeric(torch.from_numpy(K.vals).to(dtype),
                         torch.from_numpy(d).to(dtype)).numpy()
        check(np.array_equal(dC.host.colind, gK.c_struct.colind),
              "dist_galerkin: C's structure")
        err = _frob(dC.host.vals, one)
        check(err <= SPARSE_TOL[name], f"dist_galerkin {name}: {err:.2e}")
        print(f"[{tag}] dist_galerkin of the LP's A on 2×2, {name}: "
              f"{t_dg:.2f} s (host plan included), {err:.2e} from the 1×1 "
              f"Galerkin product")

    # DistMap over the 2×2 grid
    n = 1 << 20
    perm = rng.permutation(n)
    dm = DistMap(perm).to(g4)
    idx = torch.from_numpy(rng.integers(0, n, n))
    got, t_map = wall(lambda: dm.translate_device(idx))
    check(np.array_equal(got.cpu().numpy(), perm[idx.numpy()]),
          "DistMap.translate_device differs from translate")
    print(f"[{tag}] DistMap.translate_device of {n:,} indices over a "
          f"permutation of {n:,} on 2×2: equal to translate, {t_map:.3f} s")
    torch.cuda.empty_cache()
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")


# phase 21: every driver of elemental_tpu_torch/examples that needs no file
# (lp_direct gets phase 16's small MPS file)
DRIVERS = ["bp", "bp_complex", "bp_dense", "bpdn", "bpdn_dense", "cp",
           "cp_dense", "ds", "ds_dense", "en", "en_dense", "lav",
           "lav_dense", "long_only_portfolio", "lp_affine",
           "lp_affine_dense", "lp_direct_dense", "nnls", "nnls_dense",
           "qp_affine_dense", "qp_affine_ex", "qp_direct_dense",
           "qp_direct_ex", "rls", "rnnls_ex", "soc_atom", "soc_members",
           "socp_trivial", "svm", "svm_dense", "tv",
           "sequential_linear_solve", "sequential_lse",
           "dynamic_reg_counter", "sparse_multiply", "multiply_ex",
           "remote_dist_sparse", "lp_direct_large", "cg_laplacian",
           "helmholtz_solve", "sequential_least_squares", "different_grids",
           "remote_update", "least_squares", "linear_solve", "simple_solve",
           "symmetric_solve_ex", "lse", "glm", "tikhonov_ex", "gepp_growth",
           "matrix_zoo", "eig", "fox_li", "pseudospectra_portrait",
           "triang_eig_ex", "pnorm", "product_lanczos_ex", "inv_pos",
           "lattice_tools", "lll_reduction", "lll_singular", "control_ex",
           "lcf"]


def phase_drivers(mps_path: str) -> None:
    """21: every driver in-process at its default size with ``--device
    cuda`` (its own checks are the gates), ``lp_direct`` on ``mps_path``;
    then ``entry()``'s forward on the card against the CPU."""
    import importlib
    import numpy as np
    import torch
    from elemental_tpu_torch.entry import entry
    from elemental_tpu_torch.kernels import extend_add as ea
    tag = "21 drivers"
    t_phase = time.perf_counter()
    before = ea.extend_add.launches
    runs = [(name, []) for name in DRIVERS]
    runs.append(("lp_direct", ["--mps", mps_path, "--dtype", "float64"]))
    seconds = {}
    saved = sys.argv
    try:
        for name, extra in runs:
            sys.argv = [name, "--device", "cuda", *extra]
            mod = importlib.import_module(
                f"elemental_tpu_torch.examples.{name}")
            out, seconds[name] = wall(mod.main)
            if name == "lp_direct":
                check(out[0].converged, "lp_direct on phase 16's file did "
                      "not converge")
    finally:
        sys.argv = saved
    k1 = ea.extend_add.launches - before
    check(k1 > 0, "no driver launched K1")
    print(f"[{tag}] {len(runs)} drivers passed their own checks on the card "
          f"in {sum(seconds.values()):.1f} s, K1 launched {k1} times: "
          + ", ".join(f"{n} {t:.2f} s" for n, t in seconds.items()))

    fwd, args = entry()
    check(all(t.is_cuda for t in args), "entry(): arguments off the card")
    (x, r), t_fwd = wall(lambda: fwd(*args))
    cx, cr = fwd(*(t.cpu() for t in args))
    ex = float((x.cpu() - cx).abs().max() / cx.abs().max())
    er = abs(float(r) - float(cr)) / float(cr)
    check(ex <= 1e-4 and er <= 1e-4, f"entry(): card vs CPU x {ex:.2e}, "
          f"‖r‖ {er:.2e}")
    print(f"[{tag}] entry(): 25 CG iterations on the 64² Laplacian's ELL "
          f"form, float32, {t_fwd * 1e3:.1f} ms on the card; ‖r‖ "
          f"{float(r):.6e}, against the CPU x {ex:.2e}, ‖r‖ {er:.2e}")
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")


# phase 22: the dense LAPACK tier
LAPACK_N = 8192         # the factors' size
PIVOT_N = 2048          # the host-driven pivoted loops'
TSQR_M, TSQR_N = 262144, 256
EMIN_M, EMIN_N = 8192, 4096
GEN_N = 1024
DD_N, REFINE_N = 1024, 4096
LAPACK_GATE = {"float32": 1e-5, "float64": 1e-13}


def _syncs(fn):
    """(result, host synchronisations of ``fn()``): the warnings of
    ``torch.cuda.set_sync_debug_mode('warn')``, counted."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def _lapack_factors(gen, tag: str) -> None:
    """The factors at LAPACK_N² beside their torch.linalg calls, the
    residual gates, and hpd_solve / linear_solve with 16 right-hand
    sides."""
    import torch
    from elemental_tpu_torch import lapack
    n = LAPACK_N
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        gate = LAPACK_GATE[name]
        g = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
        spd = torch.matmul(g, g.T) / n + torch.eye(n, device="cuda",
                                                    dtype=dtype)
        b = torch.randn(n, 16, generator=gen, device="cuda", dtype=dtype)
        # the Gaussian g's own float32 LU reads ~2e-5 (getrf's growth, not
        # TF32; printed below): LU and linear_solve factor g + 2√n·I, whose
        # spectrum lies in the disk of radius √n about 2√n
        gs = g + 2 * n ** 0.5 * torch.eye(n, device="cuda", dtype=dtype)
        spd64, g64, gs64 = spd.double(), g.double(), gs.double()

        def rel(r, ref):
            return float(torch.linalg.norm(r) / torch.linalg.norm(ref))

        def chol_res(uplo):
            f = lapack.cholesky(uplo, spd).double()
            return rel(spd64 - (f @ f.T if uplo == "L" else f.T @ f), spd64)

        def lu_res(a=gs, a64=gs64):
            f = lapack.lu(a)
            L = torch.tril(f.lu, -1).double() + torch.eye(
                n, device="cuda", dtype=torch.float64)
            return rel(a64[f.perm] - L @ torch.triu(f.lu).double(), a64)

        def qr_res():
            q, r = lapack.qr(g)
            return rel(g64 - q.double() @ r.double(), g64)

        def ldl_res():
            f = lapack.ldl(spd, conjugate=False)
            L = f.lower.double()
            return rel(spd64 - (L * f.diag.double()[None, :]) @ L.T, spd64)

        def solve_res(A64, X):
            X = X.double()
            return float(torch.linalg.norm(A64 @ X - b.double())
                         / (torch.linalg.norm(A64) * torch.linalg.norm(X)))

        n3 = float(n) ** 3
        cases = [
            ("cholesky L", lambda: lapack.cholesky("L", spd),
             lambda: torch.linalg.cholesky(spd), "torch.linalg.cholesky",
             n3 / 3, lambda: chol_res("L")),
            ("cholesky U", lambda: lapack.cholesky("U", spd),
             lambda: torch.linalg.cholesky(spd, upper=True),
             "torch.linalg.cholesky(upper=True)", n3 / 3,
             lambda: chol_res("U")),
            ("lu", lambda: lapack.lu(gs), lambda: torch.linalg.lu_factor(gs),
             "torch.linalg.lu_factor", 2 * n3 / 3, lu_res),
            ("qr (reduced)", lambda: lapack.qr(g),
             lambda: torch.linalg.qr(g), "torch.linalg.qr", 4 * n3 / 3,
             qr_res),
            ("ldl (unpivoted, SPD)", lambda: lapack.ldl(spd, False),
             lambda: torch.linalg.ldl_factor(spd),
             "torch.linalg.ldl_factor (Bunch-Kaufman pivoted: not the same "
             "function)", n3 / 3, ldl_res),
            ("symmetric_solve (16 rhs)",
             lambda: lapack.symmetric_solve(spd, b),
             lambda: torch.linalg.ldl_solve(*torch.linalg.ldl_factor(spd),
                                            b),
             "torch.linalg.ldl_factor + ldl_solve", n3 / 3,
             lambda: solve_res(spd64, lapack.symmetric_solve(spd, b))),
            ("hpd_solve (16 rhs)", lambda: lapack.hpd_solve("L", spd, b),
             lambda: torch.cholesky_solve(b, torch.linalg.cholesky(spd)),
             "torch.linalg.cholesky + cholesky_solve", n3 / 3,
             lambda: solve_res(spd64, lapack.hpd_solve("L", spd, b))),
            ("linear_solve (16 rhs)", lambda: lapack.linear_solve(gs, b),
             lambda: torch.linalg.solve(gs, b), "torch.linalg.solve",
             2 * n3 / 3, lambda: solve_res(gs64, lapack.linear_solve(gs, b))),
        ]
        print(f"[{tag}] lu {name} of the Gaussian {n}² itself (not gated): "
              f"relative residual {lu_res(g, g64):.3e}")
        for label, fn, lib, lib_name, flops, resid in cases:
            res = resid()
            check(res <= gate, f"{label} {name} at {n}²: relative residual "
                  f"{res:.3e} over {gate:g}")
            reps = 3 if "ldl" in label or "symmetric" in label else 5
            ms, lib_ms = time_pair(fn, lib, reps=reps)
            print(f"[{tag}] {label} {name} {n}²: {ms:.2f} ms, "
                  f"{flops / ms / 1e9:.2f} TFLOP/s ({flops / 1e12:.3g} "
                  f"TFLOP counted), {ms / lib_ms:.3f}× {lib_name} "
                  f"({lib_ms:.2f} ms); relative residual {res:.3e} "
                  f"(gate {gate:g})")
        del g, gs, spd, spd64, g64, gs64, b
        torch.cuda.empty_cache()


def _lapack_pivoted(gen, tag: str) -> None:
    """The host-driven pivoted loops at PIVOT_N², float64: ms and host
    synchronisations, each held to its reconstruction."""
    import torch
    from elemental_tpu_torch import lapack
    from elemental_tpu_torch.lapack.ldl import ldl_pivoted
    n, dt = PIVOT_N, torch.float64
    eye = torch.eye(n, device="cuda", dtype=dt)
    # rank-deficient PSD: true rank n/4
    rank = n // 4
    g = torch.randn(n, rank, generator=gen, device="cuda", dtype=dt)
    psd = g @ g.T
    tol = 1e-10 * float(torch.diagonal(psd).max())
    f, syncs = _syncs(lambda: lapack.pivoted_cholesky("L", psd, tol=tol))
    check(int(f.rank) == rank, f"pivoted_cholesky rank {int(f.rank)}, "
          f"true rank {rank}")
    L = f.factor[:, :rank]
    err = float((L @ L.T - psd[f.perm][:, f.perm]).abs().max()
                / psd.abs().max())
    check(err <= 1e-12, f"pivoted_cholesky reconstruction {err:.3e}")
    ms = cuda_ms(lambda: lapack.pivoted_cholesky("L", psd, tol=tol), 1)
    print(f"[{tag}] pivoted_cholesky float64 {n}² of rank {rank}: rank "
          f"detected {int(f.rank)}, reconstruction {err:.3e}; {ms:.1f} ms, "
          f"{syncs} host syncs")
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=dt)
    f, syncs = _syncs(lambda: lapack.lu_full(a))
    Lf = torch.tril(f.lu, -1) + eye
    err = float((Lf @ torch.triu(f.lu) - a[f.rowperm][:, f.colperm]).abs()
                .max() / a.abs().max())
    check(err <= 1e-12 * n, f"lu_full reconstruction {err:.3e}")
    ms = cuda_ms(lambda: lapack.lu_full(a), 1)
    print(f"[{tag}] lu_full float64 {n}²: P·A·Q − L·U max {err:.3e} of "
          f"max|A|; {ms:.1f} ms, {syncs} host syncs")
    # indefinite with tiny diagonals (test_bunch_kaufman_pivoted_ldl)
    s = (a + a.T) / 2
    s.diagonal().mul_(1e-12)
    f, syncs = _syncs(lambda: ldl_pivoted(s))
    D = torch.diag(f.diag) + torch.diag(f.subdiag, -1) \
        + torch.diag(f.subdiag, 1)
    err = float((f.lower @ D @ f.lower.T - s[f.perm][:, f.perm]).abs().max())
    bound_ = 1e-12 * max(1.0, float(s.abs().max())) * n
    check(err <= bound_, f"ldl_pivoted reconstruction {err:.3e} over "
          f"{bound_:.3e}")
    two = int((f.subdiag != 0).sum())
    ms = cuda_ms(lambda: ldl_pivoted(s), 1)
    print(f"[{tag}] ldl_pivoted float64 {n}² indefinite, tiny diagonal: "
          f"{two} 2×2 pivots, max|L| {float(f.lower.abs().max()):.3f}, "
          f"reconstruction {err:.3e} (gate {bound_:.3e}); {ms:.1f} ms, "
          f"{syncs} host syncs")
    torch.cuda.empty_cache()


def _lapack_tsqr(gen, tag: str) -> None:
    """TSQR of TSQR_M × TSQR_N on a 2×2 grid over the card, both trees,
    beside torch.linalg.qr of the whole; the transfer log's bytes held to
    p(p−1)·n² and p·log₂p·n² elements."""
    import torch
    from elemental_tpu_torch.core import Grid
    from elemental_tpu_torch.lapack import tsqr
    from elemental_tpu_torch.utils import count_transfers
    m, n, p = TSQR_M, TSQR_N, 4
    g4 = Grid(devices=[torch.device("cuda", 0)] * 4, height=2)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        gate = {"float32": 1e-5, "float64": 1e-12}[name]
        a = torch.randn(m, n, generator=gen, device="cuda", dtype=dtype)
        eye = torch.eye(n, device="cuda", dtype=dtype)
        lib_ms = cuda_ms(lambda: torch.linalg.qr(a), 3)
        rs = {}
        for tree, count in ((False, p * (p - 1)), (True, p * 2)):
            with count_transfers() as log:
                q, r = tsqr(a, g4, tree=tree)
            want = count * n * n * a.element_size()
            check(log.bytes() == want, f"tsqr tree={tree} {name}: "
                  f"{log.bytes()} bytes across positions, not {want}")
            res = float(torch.linalg.norm((q @ r - a).double())
                        / torch.linalg.norm(a.double()))
            orth = float(torch.linalg.norm((q.T @ q - eye).double()))
            check(res <= gate and orth <= gate, f"tsqr tree={tree} {name}: "
                  f"‖QR − A‖/‖A‖ {res:.3e}, ‖QᵀQ − I‖ {orth:.3e}")
            rs[tree] = r
            ms = cuda_ms(lambda: tsqr(a, g4, tree=tree), 3)
            print(f"[{tag}] tsqr {'butterfly' if tree else 'gather'} "
                  f"{name} {m}×{n} on 2×2: {ms:.2f} ms, {ms / lib_ms:.3f}× "
                  f"torch.linalg.qr of the whole ({lib_ms:.2f} ms); "
                  f"‖QR − A‖/‖A‖ {res:.3e}, ‖QᵀQ − I‖ {orth:.3e}; "
                  f"{log.bytes()} bytes across positions = {count}·n²·"
                  f"{a.element_size()}")
            del q, r
        # R is unique up to the signs of its rows
        diff = float((rs[True].abs() - rs[False].abs()).abs().max()
                     / rs[False].abs().max())
        check(diff <= gate, f"tsqr {name}: the trees' R differ by {diff:.3e}")
        print(f"[{tag}] tsqr {name}: the two trees' |R| agree within "
              f"{diff:.3e}")
        del a, rs
        torch.cuda.empty_cache()


def _lapack_euclid(gen, tag: str) -> None:
    """The Euclidean minimizations at EMIN_M × EMIN_N in float64 against
    float64 NumPy solutions on the host, at the reference tests' gates
    (``tests/lapack/test_spectral_solve.py``)."""
    import numpy as np
    import torch
    from elemental_tpu_torch import lapack
    m, n = EMIN_M, EMIN_N
    dt = torch.float64

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)

    a, b, bt = rand(m, n), rand(m), rand(n)
    G = 0.1 * rand(n, n)
    A, B, Bt, Gh = (t.cpu().numpy() for t in (a, b, bt, G))
    t0 = time.perf_counter()
    AtA = A.T @ A
    ref_ls = np.linalg.solve(AtA, A.T @ B)
    ref_mn = A @ np.linalg.solve(AtA, Bt)     # min-norm x of Aᵀx = bt
    ref_ridge = np.linalg.solve(AtA + 0.09 * np.eye(n), A.T @ B)
    ref_tik = np.linalg.solve(AtA + Gh.T @ Gh, A.T @ B)
    t_host = time.perf_counter() - t0
    cases = (("least_squares N", lambda: lapack.least_squares("N", a, b),
              ref_ls, 1e-8),
             ("least_squares T (minimum norm)",
              lambda: lapack.least_squares("T", a, bt), ref_mn, 1e-8),
             ("ridge γ = 0.3", lambda: lapack.ridge("N", a, b, 0.3),
              ref_ridge, 1e-9),
             ("tikhonov", lambda: lapack.tikhonov("N", a, b, G), ref_tik,
              1e-8))
    for label, fn, ref, gate in cases:
        x, t = wall(fn)
        err = float(np.abs(x.cpu().numpy() - ref).max()
                    / max(1.0, np.abs(ref).max()))
        check(err <= gate, f"{label} {m}×{n}: {err:.3e} from the host "
              f"solution, over {gate:g}")
        ms = cuda_ms(fn, 3)
        print(f"[{tag}] {label} float64 {m}×{n}: {ms:.2f} ms; "
              f"{err:.3e} from the host float64 solution (gate {gate:g})")
    p = 256
    Bc, c, d = rand(p, n), rand(m), rand(p)
    x, _ = wall(lambda: lapack.lse(a, Bc, c, d))
    xh, Bh, ch, dh = (t.cpu().numpy() for t in (x, Bc, c, d))
    cons = float(np.abs(Bh @ xh - dh).max())
    grad = A.T @ (A @ xh - ch)
    proj = grad - Bh.T @ np.linalg.lstsq(Bh.T, grad, rcond=None)[0]
    check(cons <= 1e-8 and np.abs(proj).max() <= 1e-6,
          f"lse: constraint {cons:.3e}, projected gradient "
          f"{np.abs(proj).max():.3e}")
    ms = cuda_ms(lambda: lapack.lse(a, Bc, c, d), 3)
    print(f"[{tag}] lse float64 {m}×{n}, {p} constraints: {ms:.2f} ms; "
          f"max|Bx − d| {cons:.3e} (gate 1e-8), projected gradient "
          f"{np.abs(proj).max():.3e} (gate 1e-6)")
    pg = m
    Bg, dg = rand(m, pg), rand(m)
    (x, y), _ = wall(lambda: lapack.glm(a, Bg, dg))
    res = float(np.abs(A @ x.cpu().numpy() + Bg.cpu().numpy()
                       @ y.cpu().numpy() - dg.cpu().numpy()).max())
    check(res <= 1e-8, f"glm: constraint {res:.3e}")
    ms = cuda_ms(lambda: lapack.glm(a, Bg, dg), 3)
    print(f"[{tag}] glm float64 A {m}×{n}, B {m}×{pg} (KKT of "
          f"{n + pg + m}): {ms:.2f} ms; max|Ax + By − d| {res:.3e} "
          f"(gate 1e-8); the host references took {t_host:.1f} s")
    torch.cuda.empty_cache()


def _random_generator_checks(n: int) -> dict:
    """{random generator: whether its matrix at n on the card has its
    structure (Hermitian, unitary, normal, support, triangle) and, where it
    is i.i.d., its mean and variance within 5σ}."""
    import math
    import torch
    from elemental_tpu_torch import matrices as M
    dev, f64, c128 = "cuda", torch.float64, torch.complex128

    def sigma5(x, mean, var):
        x = x.double().reshape(-1)
        k = x.numel()
        return (abs(float(x.mean()) - mean) <= 5 * (var / k) ** 0.5
                and abs(float(x.var()) - var)
                <= 5 * (2 * var * var / k) ** 0.5)

    def most(x):
        return float(x.abs().max())

    ok = {"uniform": sigma5(M.uniform(n, n, f64, 1.0, 2.0, device=dev),
                            1.0, 4 / 3),
          "gaussian": sigma5(M.gaussian(n, n, f64, 0.5, 2.0, device=dev),
                             0.5, 4.0),
          "bernoulli": sigma5(M.bernoulli(n, n, 0.3, f64, device=dev), 0.3,
                              0.21),
          "rademacher": sigma5(M.rademacher(n, n, f64, device=dev), 0.0,
                               1.0)}
    W = M.wigner(n, c128, device=dev)
    upper = torch.triu(torch.ones(n, n, dtype=torch.bool, device=dev), 1)
    ok["wigner"] = most(W - W.mH) == 0 and sigma5(W[upper].real, 0.0, 0.5)
    Q = M.haar(n, c128, device=dev)
    ok["haar"] = most(Q.mH @ Q - torch.eye(n, device=dev,
                                           dtype=c128)) <= 1e-12
    H = M.hermitian_uniform_spectrum(n, 2.0, 5.0, c128, device=dev)
    ok["hermitian_uniform_spectrum"] = (
        most(H - H.mH) <= 1e-12
        and float(torch.linalg.eigvalsh(H).min()) >= 2.0 - 1e-9)
    N = M.normal_uniform_spectrum(n, 1.0, 0.5, c128, device=dev)
    ok["normal_uniform_spectrum"] = most(N @ N.mH - N.mH @ N) <= 1e-12
    T = M.three_valued(n, n, 0.5, f64, device=dev)
    ok["three_valued"] = (bool(((T == -1) | (T == 0) | (T == 1)).all())
                          and sigma5((T != 0).double(), 0.5, 0.25))
    A = M.hatano_nelson(n, g=0.3, device=dev)
    ok["hatano_nelson"] = (abs(float(A[0, 1]) - math.exp(0.3)) < 1e-12
                           and abs(float(A[n - 1, 0]) - math.exp(0.3))
                           < 1e-12)
    G = M.uniform_helmholtz_greens(n, 0.5, device=dev)
    ok["uniform_helmholtz_greens"] = (most(G - G.T) <= 1e-12 * most(G)
                                      and most(torch.diagonal(G)) == 0)
    B = M.ajtai_type_basis(64, 0.5, device=dev)
    ok["ajtai_type_basis"] = (
        most(torch.tril(B, -1)) == 0
        and bool((torch.triu(B, 1) <= torch.diagonal(B)[None, :] / 2).all()))
    K = M.knapsack_type_basis(n, 100.0, device=dev)
    ok["knapsack_type_basis"] = (tuple(K.shape) == (n + 1, n)
                                 and bool((K[n] == K[n].round()).all()))
    return ok


def _lapack_generators(tag: str) -> None:
    """Every generator at GEN_N on the card: the deterministic ones
    against the same call on the CPU (float64: 1e-14 of the largest
    entry), the random ones held to shape, dtype and structure."""
    import inspect
    import torch
    from elemental_tpu_torch import matrices as M
    from elemental_tpu_torch.core import random_ as rng
    from elemental_tpu_torch.matrices import deterministic, random_gen
    n = GEN_N
    args = {"jordan": (n, 2.0), "kahan": (n, 0.3), "pei": (n, 2.0),
            "forsythe": (n, 1e-3, 2.0), "lauchli": (n, 0.1),
            "hanowa": (n, 2.0), "walsh": (10,), "wilkinson": (n // 2,),
            "extended_kahan": (8, 0.9, 0.1), "druinsky_toledo": (n // 2,),
            "tri_w": (n, -2.0, 3), "fox_li": (n, 16.0)}
    vec = torch.linspace(1.0, 2.0, n, dtype=torch.float64)
    vec_args = {"diagonal": (vec,), "cauchy": (vec, vec + 0.5),
                "circulant": (vec,), "toeplitz": (vec, vec.flip(0)),
                "hankel": (vec, vec.flip(0)), "fiedler": (vec,),
                "cauchy_like": (vec, vec, vec, vec + 0.5)}
    t0 = time.perf_counter()
    names = [f for f, obj in vars(deterministic).items()
             if inspect.isfunction(obj) and not f.startswith("_")
             and obj.__module__ == deterministic.__name__]
    worst = (0.0, "")
    for f in names:
        fn = getattr(M, f)
        if f in vec_args:
            got = fn(*(v.to("cuda") for v in vec_args[f]))
            ref = fn(*vec_args[f])
        else:
            got = fn(*args.get(f, (n,)), device="cuda")
            ref = fn(*args.get(f, (n,)), device="cpu")
        check(got.is_cuda and got.dtype == ref.dtype
              and got.shape == ref.shape, f"generator {f}: {got.dtype} "
              f"{tuple(got.shape)} on {got.device}")
        scale = max(1.0, float(ref.abs().max()))
        err = float((got.cpu() - ref).abs().max()) / scale
        gate = 1e-14 if ref.dtype in (torch.float64, torch.complex128) \
            else 1e-6
        check(err <= gate, f"generator {f}: card vs CPU {err:.3e}")
        worst = max(worst, (err, f))
    print(f"[{tag}] {len(names)} deterministic generators at n = {n} "
          f"(walsh k = 10, extended_kahan k = 8) on the card equal the CPU's "
          f"within {worst[0]:.3e} ({worst[1]}); {time.perf_counter() - t0:.1f}"
          f" s with the host pieces")
    rng.seed(0)
    checks = _random_generator_checks(n)
    rnames = [f for f, obj in vars(random_gen).items()
              if inspect.isfunction(obj) and not f.startswith("_")
              and obj.__module__ == random_gen.__name__]
    check(sorted(rnames) == sorted(checks), f"random generators {rnames}")
    for f, ok in checks.items():
        check(ok, f"random generator {f} at n = {n}: structure or "
              f"distribution off")
    print(f"[{tag}] {len(checks)} random generators at n = {n} (ajtai 64) on "
          f"the card: shapes, dtypes, structure and moments within 5σ")
    torch.cuda.empty_cache()


def _lapack_dd(gen, tag: str) -> None:
    """dd_gemm of DD_N³ float32 words against float64 torch.matmul of the
    same values, and refined_solve_dd on the port's float32 cholesky at
    REFINE_N."""
    import torch
    from elemental_tpu_torch import extended as X
    from elemental_tpu_torch import lapack
    n = DD_N
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    b = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)

    def words(x):
        hi = x.float()
        return X.DD(hi, (x - hi.double()).float())

    A, B = words(a), words(b)
    C, t = wall(lambda: X.dd_gemm(A, B))
    ref = (A.hi.double() + A.lo.double()) @ (B.hi.double() + B.lo.double())
    err = float(((C.hi.double() + C.lo.double()) - ref).abs().max()
                / ref.abs().max())
    f32 = float((A.hi @ B.hi - ref).abs().max() / ref.abs().max())
    check(err <= 1e-12, f"dd_gemm {n}³: {err:.3e} from the float64 product")
    ms = cuda_ms(lambda: X.dd_gemm(A, B), 2)
    print(f"[{tag}] dd_gemm {n}³ float32 words: {ms:.1f} ms; {err:.3e} of "
          f"max|C| from the float64 product (float32 alone {f32:.3e})")
    n = REFINE_N
    g = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    A32 = (g @ g.T + n * torch.eye(n, device="cuda",
                                    dtype=torch.float64)).float()
    b32 = torch.randn(n, generator=gen, device="cuda", dtype=torch.float32)
    L = lapack.cholesky("L", A32)

    def solve(r):
        return lapack.cholesky_solve_after("L", "N", L, r[:, None])[:, 0]

    xdd, t = wall(lambda: X.refined_solve_dd(A32, solve, b32, iters=4))
    x_true = torch.linalg.solve(A32.double(), b32.double())
    scale = float(x_true.abs().max())
    err_dd = float((xdd.hi.double() + xdd.lo.double() - x_true).abs().max()
                   ) / scale
    err_f32 = float((solve(b32).double() - x_true).abs().max()) / scale
    check(err_dd <= 1e-10 and err_dd <= 1e-2 * err_f32,
          f"refined_solve_dd {n}: {err_dd:.3e} (plain f32 {err_f32:.3e})")
    print(f"[{tag}] refined_solve_dd on the float32 cholesky at {n}: "
          f"{t * 1e3:.1f} ms (4 refinements); error {err_dd:.3e}, the "
          f"plain float32 solve's {err_f32:.3e}")
    torch.cuda.empty_cache()


def _lapack_k5(gen, tag: str) -> None:
    """K5 (``masked_rank_k_update``) on the recursive Cholesky's top-level
    trailing update at LAPACK_N (A22 − L21·L21ᴴ, 4096², k = 4096, lower),
    beside the path's update (``torch.matmul`` and a subtraction) and
    ``torch.addmm`` over the square, and the recursion's whole matmul
    time; a measurement only, the path stays torch.matmul."""
    import torch
    from elemental_tpu_torch import lapack
    from elemental_tpu_torch.kernels import matmul as mm
    n = LAPACK_N
    m = n // 2
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        gate = LAPACK_GATE[name]
        g = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
        spd = torch.matmul(g, g.T) / n + torch.eye(n, device="cuda",
                                                    dtype=dtype)
        del g
        L = lapack.cholesky("L", spd)
        c = spd[m:, m:].contiguous()
        L21 = L[m:, :m].contiguous()
        L21h = L21.T.contiguous()
        path = mm._rank_k_path(c, L21, L21h)

        def k5():
            return mm._run_rank_k(c, L21, L21h, -1.0, True, path)

        def ours():
            return c - torch.matmul(L21, L21.mH)

        def addmm():
            return torch.addmm(c, L21, L21h, alpha=-1.0)

        want = ours()
        got = k5()
        low = torch.tril(torch.ones(m, m, dtype=torch.bool, device="cuda"))
        err = float((got - want)[low].abs().max() / want.abs().max())
        check(err <= gate, f"K5 on the trailing update {name}: {err:.3e}")
        k5_ms, path_ms = time_pair(k5, ours, reps=5)
        addmm_ms = cuda_ms(addmm, 5)
        # the recursion's matmuls: 2^l of (m/2^l)³ at level l, down to the
        # 256 base
        rec_ms, lvl, size = 0.0, 0, m
        while 2 * size > 256:
            x = torch.randn(size, size, generator=gen, device="cuda",
                            dtype=dtype)
            rec_ms += (1 << lvl) * cuda_ms(lambda: torch.matmul(x, x.mH), 3)
            lvl, size = lvl + 1, size // 2
        chol_ms = cuda_ms(lambda: lapack.cholesky("L", spd), 3)
        print(f"[{tag}] K5 {path} on cholesky's top trailing update {name} "
              f"({m}², k = {m}, lower): {k5_ms:.3f} ms against the path's "
              f"A22 − L21·L21ᴴ {path_ms:.3f} ms (torch.matmul, the whole "
              f"square) and torch.addmm {addmm_ms:.3f} ms; K5's triangle "
              f"within {err:.3e} of the path's; the recursion's matmuls "
              f"{rec_ms:.2f} ms of the {chol_ms:.2f} ms factor")
        del spd, L, c, L21, L21h, want, got
        torch.cuda.empty_cache()


def phase_lapack(seed: int) -> None:
    """22: the dense LAPACK tier on the card (see the module docstring).
    Every gate is fatal."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = "22 lapack"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    print(f"[{tag}] linalg library: "
          f"{torch.backends.cuda.preferred_linalg_library()}")
    for part in (_lapack_factors, _lapack_pivoted, _lapack_tsqr,
                 _lapack_euclid, _lapack_dd, _lapack_k5):
        t0 = time.perf_counter()
        part(gen, tag)
        print(f"[{tag}] {part.__name__[8:]}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _lapack_generators(tag)
    print(f"[{tag}] generators: {time.perf_counter() - t0:.1f} s")
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s; "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")


# phase 23: the spectral tier
SPEC_BIG = 8192         # hermitian_eig 'direct', inverse, hpd_inverse
SPEC_MID = 4096         # the reductions, svd, the matrix functions
SPEC_MRRR = 2048        # the tridiagonal eigensolver, complex128 tridiag
SPEC_HOST = 1024        # schur, eig, triang_eig, the unblocked hessenberg
SPEC_CTRL = 2048        # sylvester and lyapunov at m = n, ricatti's n
SPEC_PARITY = 1024      # the iterative calls' card-against-CPU runs
PSEUDO_N, PSEUDO_G = 512, 64
LANCZOS_SIDE = 1024
SPEC_GATE = {"float32": 1e-4, "float64": 1e-12}


def _device_ops(fn):
    """(fn()'s result, the aten operators it dispatched, views excluded):
    about one kernel launch each, counted on the host."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def _scaled_ops(fn, make, n: int, nb: int = 32) -> int:
    """The device operators of the blocked reduction ``fn(make(n))``, from
    counts at two small sizes with n's last partial panel: every full
    nb-column panel dispatches the same operators, whatever the size."""
    small = 64 + (n - 64) % nb
    counts = []
    for m in (small, small + nb):
        x = make(m)
        counts.append(_device_ops(lambda: fn(x))[1])
    return counts[0] + (n - small) // nb * (counts[1] - counts[0])


def _peak(fn):
    """(fn()'s result, the peak device memory it took, GiB)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 2 ** 30


def _ortho(q) -> float:
    """‖QᴴQ − I‖_F / √n in float64."""
    import torch
    wide = torch.complex128 if q.is_complex() else torch.float64
    q = q.to(wide)
    eye = torch.eye(q.shape[1], dtype=wide, device=q.device)
    return float(torch.linalg.norm(q.mH @ q - eye) / q.shape[1] ** 0.5)


def _gate(label: str, value: float, gate: float) -> None:
    check(value <= gate, f"{label}: {value:.3e} over {gate:g}")


def _spec_eig(gen, tag: str) -> None:
    """hermitian_eig 'direct' at SPEC_BIG² in float32 and float64 beside
    torch.linalg.eigh; inverse and hpd_inverse (float64) beside inv and
    cholesky + cholesky_inverse."""
    import torch
    from elemental_tpu_torch import lapack
    n = SPEC_BIG
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        g = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
        a = (g + g.T) / 2
        del g
        (pair, peak) = _peak(lambda: lapack.hermitian_eig("L", a))
        a64, q64 = a.double(), pair.q.double()
        res = float(torch.linalg.norm(a64 @ q64 - q64 * pair.w.double())
                    / torch.linalg.norm(a64))
        orth = _ortho(pair.q)
        del a64, q64
        _gate(f"hermitian_eig {name} {n}² ‖AQ − QΛ‖/‖A‖", res,
              SPEC_GATE[name])
        _gate(f"hermitian_eig {name} {n}² ‖QᴴQ − I‖/√n", orth,
              SPEC_GATE[name])
        del pair
        ms, lib_ms = time_pair(lambda: lapack.hermitian_eig("L", a),
                               lambda: torch.linalg.eigh(a), 1, False)
        print(f"[{tag}] hermitian_eig 'direct' {name} {n}²: {ms:.1f} ms, "
              f"{ms / lib_ms:.3f}× torch.linalg.eigh ({lib_ms:.1f} ms); "
              f"‖AQ − QΛ‖/‖A‖ {res:.3e}, ‖QᴴQ − I‖/√n {orth:.3e} (gate "
              f"{SPEC_GATE[name]:g}); peak {peak:.2f} GiB")
        del a
        torch.cuda.empty_cache()
    dtype = torch.float64
    g = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
    eye = torch.eye(n, device="cuda", dtype=dtype)
    gs = g + 2 * n ** 0.5 * eye
    spd = g @ g.T / n + eye
    del g
    for label, fn, lib, lib_name, a in (
            ("inverse", lambda: lapack.inverse(gs),
             lambda: torch.linalg.inv(gs), "torch.linalg.inv", gs),
            ("hpd_inverse", lambda: lapack.hpd_inverse("L", spd),
             lambda: torch.cholesky_inverse(torch.linalg.cholesky(spd)),
             "torch.linalg.cholesky + cholesky_inverse", spd)):
        x, peak = _peak(fn)
        res = float(torch.linalg.norm(a @ x - eye)
                    / (torch.linalg.norm(a) * torch.linalg.norm(x)))
        _gate(f"{label} float64 {n}² ‖AX − I‖/(‖A‖‖X‖)", res,
              SPEC_GATE["float64"])
        del x
        ms, lib_ms = time_pair(fn, lib, 3, False)
        print(f"[{tag}] {label} float64 {n}²: {ms:.2f} ms, "
              f"{ms / lib_ms:.3f}× {lib_name} ({lib_ms:.2f} ms); "
              f"‖AX − I‖/(‖A‖‖X‖) {res:.3e}; peak {peak:.2f} GiB")
    del gs, spd, eye
    torch.cuda.empty_cache()


def _tridiag_res(a, t) -> tuple:
    """(‖QᴴAQ − T‖/‖A‖, ‖QᴴQ − I‖/√n) in float64 (complex128)."""
    import torch
    wide = torch.complex128 if a.is_complex() else torch.float64
    a, q = a.to(wide), t.q.to(wide)
    T = (torch.diag(t.d.to(wide)) + torch.diag(t.e.to(wide), 1)
         + torch.diag(t.e.to(wide), -1))
    return (float(torch.linalg.norm(q.mH @ a @ q - T) / torch.linalg.norm(a)),
            _ortho(t.q))


def _event_ms(fn):
    """(fn()'s result, its ms between CUDA events on an idle card): one
    launch of a call that is also checked."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _spec_reductions(gen, tag: str) -> None:
    """At SPEC_MID: the blocked hermitian_tridiag (float32, float64),
    hermitian_eig 'tridiag' beside eigh, the blocked hessenberg, the
    blocked bidiag of SPEC_MID × SPEC_MID/2 and svd (float32, float64)
    beside torch.linalg.svd.  The Python-loop reductions are launch-bound:
    one checked launch is timed; their device operators are counted at
    two small sizes and scaled by the panels (``_scaled_ops``)."""
    import torch
    from elemental_tpu_torch import lapack
    from elemental_tpu_torch.lapack import condense
    n = SPEC_MID

    def small(m, cols=None):
        return torch.randn(m, cols or m, generator=gen, device="cuda",
                           dtype=torch.float64)

    tri_ops = _scaled_ops(lambda x: condense._hermitian_tridiag_blocked(
        "L", x), small, n)
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        g = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
        a = (g + g.T) / 2
        del g
        (t, ms), peak = _peak(lambda: _event_ms(
            lambda: lapack.hermitian_tridiag("L", a)))
        res, orth = _tridiag_res(a, t)
        _gate(f"hermitian_tridiag {name} {n}² ‖QᴴAQ − T‖/‖A‖", res,
              SPEC_GATE[name])
        _gate(f"hermitian_tridiag {name} {n}² ‖QᴴQ − I‖/√n", orth,
              SPEC_GATE[name])
        del t
        print(f"[{tag}] hermitian_tridiag (blocked, nb = 32) {name} {n}²: "
              f"{ms:.1f} ms, {tri_ops} device operators; ‖QᴴAQ − T‖/‖A‖ "
              f"{res:.3e}, ‖QᴴQ − I‖/√n "
              f"{orth:.3e} (gate {SPEC_GATE[name]:g}); peak {peak:.2f} GiB")
        if dtype == torch.float64:
            pair, ms = _event_ms(lambda: lapack.hermitian_eig(
                "L", a, alg="tridiag"))
            q = pair.q
            res = float(torch.linalg.norm(a @ q - q * pair.w)
                        / torch.linalg.norm(a))
            orth = _ortho(q)
            werr = float((pair.w - torch.linalg.eigvalsh(a)).abs().max()
                         / pair.w.abs().max())
            _gate(f"hermitian_eig 'tridiag' {n}² ‖AQ − QΛ‖/‖A‖", res,
                  SPEC_GATE[name])
            _gate(f"hermitian_eig 'tridiag' {n}² ‖QᴴQ − I‖/√n", orth,
                  SPEC_GATE[name])
            _gate(f"hermitian_eig 'tridiag' {n}² eigenvalues against "
                  f"eigvalsh", werr, SPEC_GATE[name])
            del pair, q
            lib_ms = cuda_ms(lambda: torch.linalg.eigh(a), 2, False)
            print(f"[{tag}] hermitian_eig 'tridiag' float64 {n}²: "
                  f"{ms:.1f} ms, {ms / lib_ms:.3f}× torch.linalg.eigh "
                  f"({lib_ms:.1f} ms); ‖AQ − QΛ‖/‖A‖ {res:.3e}, ‖QᴴQ − I‖/√n "
                  f"{orth:.3e}, eigenvalues within {werr:.3e} of eigvalsh")
        del a
        torch.cuda.empty_cache()
    dtype = torch.float64
    g = torch.randn(n, n, generator=gen, device="cuda", dtype=dtype)
    (h, ms), peak = _peak(lambda: _event_ms(
        lambda: lapack.hessenberg("L", g)))
    ops = _scaled_ops(condense._hessenberg_blocked, small, n)
    q = h.q
    res = float(torch.linalg.norm(q @ h.h @ q.T - g) / torch.linalg.norm(g))
    orth = _ortho(q)
    below = float(torch.tril(h.h, -2).abs().max() / g.abs().max())
    _gate(f"hessenberg {n}² ‖QHQᴴ − A‖/‖A‖", res, SPEC_GATE["float64"])
    _gate(f"hessenberg {n}² ‖QᴴQ − I‖/√n", orth, SPEC_GATE["float64"])
    _gate(f"hessenberg {n}² below the subdiagonal", below,
          SPEC_GATE["float64"])
    del h, q
    print(f"[{tag}] hessenberg (blocked, n ≥ 3072) float64 {n}²: {ms:.1f} "
          f"ms, {ops} device operators; ‖QHQᴴ − A‖/‖A‖ {res:.3e}, ‖QᴴQ − I‖"
          f"/√n {orth:.3e}, below the subdiagonal {below:.1e} (the blocked "
          f"path masks it); peak {peak:.2f} GiB")
    b = g[:, :n // 2].contiguous()
    del g
    m2 = n // 2
    (bd, ms), peak = _peak(lambda: _event_ms(lambda: lapack.bidiag(b)))
    ops = _scaled_ops(condense._bidiag_blocked, lambda m: small(2 * m, m),
                      m2)
    B = torch.diag(bd.d) + torch.diag(bd.e, 1)
    res = float(torch.linalg.norm(bd.u[:, :m2] @ B @ bd.v.T - b)
                / torch.linalg.norm(b))
    orth = max(_ortho(bd.u), _ortho(bd.v))
    _gate(f"bidiag {n}×{m2} ‖UBVᴴ − A‖/‖A‖", res, SPEC_GATE["float64"])
    _gate(f"bidiag {n}×{m2} ‖UᴴU − I‖, ‖VᴴV − I‖", orth,
          SPEC_GATE["float64"])
    del bd, B
    print(f"[{tag}] bidiag (blocked) float64 {n}×{m2}: {ms:.1f} ms, {ops} "
          f"device operators; ‖UBVᴴ − A‖/‖A‖ {res:.3e}, orthogonality "
          f"{orth:.3e}; peak {peak:.2f} GiB")
    for dtype in (torch.float32, torch.float64):
        name = str(dtype)[6:]
        a = b.to(dtype)

        def svd_res(out):
            return (float(torch.linalg.norm((out[0] * out[1]).double()
                                            @ out[2].double() - a.double())
                          / torch.linalg.norm(a.double())),
                    max(_ortho(out[0]), _ortho(out[2].mH)))

        out, peak = _peak(lambda: lapack.svd(a))
        res, orth = svd_res(out)
        _gate(f"svd {name} {n}×{m2} ‖UΣVᴴ − A‖/‖A‖", res, SPEC_GATE[name])
        _gate(f"svd {name} {n}×{m2} orthogonality", orth, SPEC_GATE[name])
        del out
        lib_res, lib_orth = svd_res(torch.linalg.svd(a, full_matrices=False))
        ms, lib_ms = time_pair(lambda: lapack.svd(a),
                               lambda: torch.linalg.svd(
                                   a, full_matrices=False), 1, False)
        print(f"[{tag}] svd {name} {n}×{m2}: {ms:.1f} ms, {ms / lib_ms:.3f}× "
              f"torch.linalg.svd's default ({lib_ms:.1f} ms, residual "
              f"{lib_res:.3e}, orthogonality {lib_orth:.3e}); ‖UΣVᴴ − A‖/‖A‖ "
              f"{res:.3e}, orthogonality {orth:.3e}; peak {peak:.2f} GiB")
        del a
    del b
    torch.cuda.empty_cache()


def _spec_functions(gen, tag: str) -> None:
    """At SPEC_MID, float64: polar, sign (of V·diag(±λ)·Vᵀ, its exact sign
    known), square_root (SPD) and symmetric_inverse; at SPEC_CTRL the
    control solvers with their equations' residuals; the iterative calls
    also on the CPU at SPEC_PARITY.  symmetric_inverse is timed beside ``torch.linalg.inv`` (cuSOLVER's
    ``sytrf`` failed with an internal error at 4096 on the card)."""
    import torch
    from elemental_tpu_torch import control, lapack
    n = SPEC_MID
    dt = torch.float64
    eye = torch.eye(n, device="cuda", dtype=dt)

    def gauss(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dt)

    a_polar = gauss(n, n) / n ** 0.5 + 3 * eye
    V, _ = torch.linalg.qr(gauss(n, n))
    lam = (0.5 + 1.5 * torch.rand(n, generator=gen, device="cuda",
                                  dtype=dt)) * torch.where(
        torch.arange(n, device="cuda") % 2 == 0, 1.0, -1.0).to(dt)
    a_sign = (V * lam) @ V.T
    s_exact = (V * torch.sign(lam)) @ V.T
    del V
    g = gauss(n, n)
    spd = g @ g.T / n + eye
    sym = g + g.T + 6 * n ** 0.5 * eye
    del g

    def polar_res():
        q, p = lapack.polar(a_polar)
        return max(float(torch.linalg.norm(q @ p - a_polar)
                         / torch.linalg.norm(a_polar)), _ortho(q))

    def sign_res():
        return _fro(lapack.sign(a_sign), s_exact)

    def sqrt_res():
        r = lapack.square_root(spd)
        return float(torch.linalg.norm(r @ r - spd) / torch.linalg.norm(spd))

    def syminv_res():
        x = lapack.symmetric_inverse(sym)
        return float(torch.linalg.norm(sym @ x - eye)
                     / (torch.linalg.norm(sym) * torch.linalg.norm(x)))

    cases = (
        ("polar", lambda: lapack.polar(a_polar), polar_res, 1e-6, None, ""),
        ("sign", lambda: lapack.sign(a_sign), sign_res, 1e-6, None, ""),
        ("square_root", lambda: lapack.square_root(spd), sqrt_res, 1e-7,
         None, ""),
        ("symmetric_inverse", lambda: lapack.symmetric_inverse(sym),
         syminv_res, SPEC_GATE["float64"], lambda: torch.linalg.inv(sym),
         "torch.linalg.inv"))
    for label, fn, resid, gate, lib, lib_name in cases:
        res, peak = _peak(resid)
        _gate(f"{label} float64 {n}²", res, gate)
        if lib is None:
            ms = cuda_ms(fn, 2, False)
            beside = ""
        else:
            ms, lib_ms = time_pair(fn, lib, 1, False)
            beside = f", {ms / lib_ms:.3f}× {lib_name} ({lib_ms:.1f} ms)"
        print(f"[{tag}] {label} float64 {n}²: {ms:.1f} ms{beside}; "
              f"residual {res:.3e} (gate {gate:g}); peak {peak:.2f} GiB")
    del a_polar, a_sign, s_exact, spd, sym, eye
    torch.cuda.empty_cache()

    m = SPEC_CTRL
    eye = torch.eye(m, device="cuda", dtype=dt)
    g = gauss(m, m)
    A = g @ g.T / m + 2 * eye
    g = gauss(m, m)
    B = g @ g.T / m + 2 * eye
    X0 = gauss(m, m)
    C = A @ X0 + X0 @ B
    Cl = A @ (X0 + X0.T) + (X0 + X0.T) @ A.T
    As = -2 * eye + 0.1 * gauss(m, m) / m ** 0.5
    K, L = eye, 0.5 * eye
    del g

    def syl_res():
        return _fro(control.sylvester(A, B, C), X0)

    def lyap_res():
        return _fro(control.lyapunov(A, Cl), X0 + X0.T)

    def ric_res():
        X = control.ricatti_hamiltonian(As, K, L)
        return float(torch.linalg.norm(As.T @ X + X @ As + K - X @ L @ X)
                     / torch.linalg.norm(K))

    for label, fn, resid, what in (
            ("sylvester", lambda: control.sylvester(A, B, C), syl_res,
             f"m = n = {m}, ‖X − X₀‖/‖X₀‖"),
            ("lyapunov", lambda: control.lyapunov(A, Cl), lyap_res,
             f"n = {m}, ‖X − X₀‖/‖X₀‖"),
            ("ricatti_hamiltonian",
             lambda: control.ricatti_hamiltonian(As, K, L), ric_res,
             f"n = {m} (W {2 * m}²), ‖AᵀX + XA + K − XLX‖/‖K‖")):
        res, peak = _peak(resid)
        _gate(f"{label} {what}", res, 1e-6)
        ms = cuda_ms(fn, 2, False)
        print(f"[{tag}] {label} float64 {what}: {ms:.1f} ms; residual "
              f"{res:.3e} (gate 1e-6); peak {peak:.2f} GiB")
    del A, B, C, Cl, X0, As, K, L, eye
    torch.cuda.empty_cache()

    # the iterative calls on the card against the CPU, same inputs
    p = SPEC_PARITY
    cpu = torch.Generator().manual_seed(23)
    g = torch.randn(p, p, generator=cpu, dtype=dt)
    e = torch.eye(p, dtype=dt)
    a_pol, spd_p = g / p ** 0.5 + 3 * e, g @ g.T / p + e
    a_sgn = g @ g.T / p - 0.5 * e
    h = p // 2
    Ah, Bh = spd_p[:h, :h] + e[:h, :h], spd_p[h:, h:] + e[h:, h:]
    Ch = g[:h, h:]
    Ash = -2 * e[:h, :h] + 0.1 * g[h:, :h] / h ** 0.5
    worst = 0.0
    for label, fn, args in (
            ("polar", lambda x: lapack.polar(x)[0], (a_pol,)),
            ("sign", lapack.sign, (a_sgn,)),
            ("square_root", lapack.square_root, (spd_p,)),
            ("sylvester", control.sylvester, (Ah, Bh, Ch)),
            ("lyapunov", control.lyapunov, (Ah, Ch + Ch.T)),
            ("ricatti_hamiltonian", control.ricatti_hamiltonian,
             (Ash, e[:h, :h], 0.5 * e[:h, :h]))):
        on_card = fn(*(x.cuda() for x in args)).cpu()
        err = _fro(on_card, fn(*args))
        _gate(f"{label} card against CPU at {p}", err, 1e-10)
        worst = max(worst, err)
    print(f"[{tag}] polar, sign, square_root, sylvester, lyapunov, ricatti "
          f"at {p} (control {h}): card within {worst:.3e} of the CPU "
          f"(gate 1e-10)")


def _spec_tridiagonal(gen, tag: str) -> None:
    """At SPEC_MRRR, float64: hermitian_tridiag_eig(alg='mrrr') on the
    whole spectrum and on 64 eigenpairs (device operators and seconds; the
    reference test's gates; against the CPU), the Sturm count against
    eigvalsh's, and the complex128 hermitian_tridiag."""
    import torch
    from elemental_tpu_torch import lapack
    from elemental_tpu_torch.lapack import condense
    n = SPEC_MRRR
    dt = torch.float64
    cpu = torch.Generator().manual_seed(29)
    d_h = torch.randn(n, generator=cpu, dtype=dt)
    e_h = torch.randn(n - 1, generator=cpu, dtype=dt)
    d, e = d_h.cuda(), e_h.cuda()
    T = torch.diag(d) + torch.diag(e, 1) + torch.diag(e, -1)
    w_ref = torch.linalg.eigvalsh(T)
    for label, sel in (("whole spectrum", None),
                       ("subset of 64", (n // 2 - 32, n // 2 + 31))):
        (w, Z), ms = _event_ms(lambda: lapack.hermitian_tridiag_eig(
            d, e, alg="mrrr", select=sel))
        want = w_ref if sel is None else w_ref[sel[0]:sel[1] + 1]
        werr = float((w - want).abs().max() / w_ref.abs().max())
        res = float((T @ Z - Z * w).abs().max())
        orth = float((Z.T @ Z - torch.eye(Z.shape[1], device="cuda",
                                           dtype=dt)).abs().max())
        # the same Python loops dispatch the same operators on either
        # device and for any number of targets: counted on the CPU run of
        # the subset
        run_cpu = (lambda: lapack.hermitian_tridiag_eig(
            d_h, e_h, alg="mrrr", select=sel))
        if sel is None:
            wc, Zc = run_cpu()
        else:
            (wc, Zc), ops = _device_ops(run_cpu)
        cw = float((w.cpu() - wc).abs().max() / wc.abs().max())
        cz = float((Z.cpu() - Zc).abs().max())
        _gate(f"mrrr {label}: eigenvalues against eigvalsh", werr,
              1e-12)
        _gate(f"mrrr {label}: max|TZ − ZΛ|", res, 1e-7)
        _gate(f"mrrr {label}: max|ZᵀZ − I|", orth, 1e-5)
        _gate(f"mrrr {label}: card against CPU", max(cw, cz), 1e-10)
        print(f"[{tag}] hermitian_tridiag_eig 'mrrr' n = {n}, {label}: "
              f"{ms / 1e3:.2f} s" + ("" if sel is None else
                                     f", {ops} device operators (counted on "
                                     f"the CPU run)") + "; eigenvalues within "
              f"{werr:.3e} of eigvalsh, max|TZ − ZΛ| {res:.3e}, "
              f"max|ZᵀZ − I| {orth:.3e}, card against CPU {max(cw, cz):.3e}")
        del Z
    lo, hi = float(w_ref[n // 4]) + 1e-9, float(w_ref[3 * n // 4]) + 1e-9
    cnt, sec = wall(lambda: lapack.hermitian_tridiag_eig_estimate(d, e, lo,
                                                                   hi))
    want = int(((w_ref > lo) & (w_ref <= hi)).sum())
    check(int(cnt) == want, f"hermitian_tridiag_eig_estimate {int(cnt)} "
          f"against eigvalsh's {want}")
    print(f"[{tag}] hermitian_tridiag_eig_estimate n = {n}: {int(cnt)} "
          f"eigenvalues in (λ_{n // 4}, λ_{3 * n // 4}], as eigvalsh counts; "
          f"{sec * 1e3:.1f} ms")
    del T
    g = torch.randn(n, n, generator=gen, device="cuda",
                    dtype=torch.complex128)
    a = (g + g.mH) / 2
    del g
    (t, peak) = _peak(lambda: lapack.hermitian_tridiag("L", a))
    ops = _scaled_ops(
        lambda x: condense._hermitian_tridiag_blocked("L", x),
        lambda m: torch.randn(m, m, generator=gen, device="cuda",
                              dtype=torch.complex128), n)
    res, orth = _tridiag_res(a, t)
    _gate(f"hermitian_tridiag complex128 {n}² ‖QᴴAQ − T‖/‖A‖", res,
          SPEC_GATE["float64"])
    _gate(f"hermitian_tridiag complex128 {n}² ‖QᴴQ − I‖/√n", orth,
          SPEC_GATE["float64"])
    del t
    ms = cuda_ms(lambda: lapack.hermitian_tridiag("L", a), 2, False)
    print(f"[{tag}] hermitian_tridiag (blocked) complex128 {n}²: {ms:.1f} "
          f"ms, {ops} device operators; ‖QᴴAQ − T‖/‖A‖ {res:.3e}, "
          f"‖QᴴQ − I‖/√n {orth:.3e}; peak {peak:.2f} GiB")
    del a
    torch.cuda.empty_cache()


def _spec_host(gen, tag: str) -> None:
    """At SPEC_HOST: schur and eig on the host (seconds), triang_eig in
    complex128 chunked (peak), the unblocked hessenberg; pseudospectra on
    fox_li(PSEUDO_N) over a PSEUDO_G² grid at 30 iterations, and 16 of the
    shifts at 200 iterations against svdvals."""
    import numpy as np
    import torch
    from elemental_tpu_torch import lapack
    from elemental_tpu_torch.matrices import fox_li
    n = SPEC_HOST
    dt = torch.float64
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=dt)
    sch, sec = wall(lambda: lapack.schur(a))
    a_c = a.to(torch.complex128)
    res = float(torch.linalg.norm(sch.q @ sch.t @ sch.q.mH - a_c)
                / torch.linalg.norm(a_c))
    _gate(f"schur {n}² ‖QTQᴴ − A‖/‖A‖", res, SPEC_GATE["float64"])
    check(sch.t.is_cuda, "schur's factors are not on the card")
    (w, v), sec_eig = wall(lambda: lapack.eig(a))
    eres = float(torch.linalg.norm(a_c @ v - v * w) / torch.linalg.norm(a_c))
    _gate(f"eig {n}² ‖AV − VΛ‖/‖A‖", eres, 1e-10)
    print(f"[{tag}] schur {n}² on the host (scipy): {sec:.2f} s, ‖QTQᴴ − "
          f"A‖/‖A‖ {res:.3e}; eig {n}² on the host (NumPy): {sec_eig:.2f} s, "
          f"‖AV − VΛ‖/‖A‖ {eres:.3e}")
    t = sch.t
    X, peak = _peak(lambda: lapack.triang_eig(t))
    tres = float(torch.linalg.norm(t @ X - X * torch.diagonal(t))
                 / torch.linalg.norm(t))
    _gate(f"triang_eig complex128 {n}² ‖TX − XΛ‖/‖T‖", tres, 1e-10)
    ms = cuda_ms(lambda: lapack.triang_eig(t), 2, False)
    from elemental_tpu_torch.lapack.spectral import _chunk
    print(f"[{tag}] triang_eig complex128 {n}² in chunks of "
          f"{_chunk(n, t.dtype)}: {ms:.1f} ms, ‖TX − XΛ‖/‖T‖ "
          f"{tres:.3e}; peak {peak:.2f} GiB (one batch: "
          f"{n ** 3 * 16 / 2 ** 30:.0f} GiB of shifted matrices)")
    del sch, X, t, w, v, a_c
    h, sec = wall(lambda: lapack.hessenberg("L", a))
    res = float(torch.linalg.norm(h.q @ h.h @ h.q.T - a)
                / torch.linalg.norm(a))
    _gate(f"hessenberg unblocked {n}² ‖QHQᴴ − A‖/‖A‖", res,
          SPEC_GATE["float64"])
    print(f"[{tag}] hessenberg (rank-1 loop, n < 3072) float64 {n}²: "
          f"{sec * 1e3:.1f} ms; ‖QHQᴴ − A‖/‖A‖ {res:.3e}")
    del a, h
    torch.cuda.empty_cache()

    A = fox_li(PSEUDO_N, 16.0, device="cuda")
    re = np.linspace(-1.1, 1.1, PSEUDO_G)
    shifts = torch.from_numpy((re[:, None] + 1j * re[None, :]).reshape(-1))
    (smin, sec), peak = _peak(lambda: wall(
        lambda: lapack.pseudospectra(A, shifts, iters=30)))
    check(bool(torch.isfinite(smin).all()) and float(smin.min()) >= 0,
          "pseudospectra: a σ_min not finite and non-negative")
    pick = torch.from_numpy(np.random.default_rng(0).choice(
        PSEUDO_G ** 2, 16, replace=False))
    sub = shifts[pick]
    s200 = lapack.pseudospectra(A, sub, iters=200).cpu()
    eye = torch.eye(PSEUDO_N, dtype=A.dtype, device="cuda")
    true = torch.stack([torch.linalg.svdvals(A - z * eye)[-1]
                        for z in sub.tolist()]).cpu()
    rel = float(((s200 - true).abs() / true).max())
    _gate("pseudospectra at 200 iterations against svdvals", rel, 1e-2)
    s30 = lapack.pseudospectra(A, sub, iters=30).cpu()
    cpu30 = lapack.pseudospectra(A.cpu(), sub, iters=30)
    cerr = float(((s30 - cpu30).abs() / cpu30).max())
    _gate("pseudospectra card against CPU (16 shifts, 30 iterations)",
          cerr, 1e-10)
    print(f"[{tag}] pseudospectra of fox_li({PSEUDO_N}) over "
          f"{PSEUDO_G}×{PSEUDO_G} shifts, 30 iterations: {sec:.2f} s "
          f"(schur included), σ_min in [{float(smin.min()):.3e}, "
          f"{float(smin.max()):.3e}]; peak {peak:.2f} GiB; 16 shifts at 200 "
          f"iterations within {rel:.3e} of svdvals (gate 1e-2), at 30 the "
          f"card within {cerr:.3e} of the CPU")
    del A, eye
    torch.cuda.empty_cache()


def _spec_lanczos(tag: str) -> None:
    """lanczos, product_lanczos and extremal_singular_value_estimates on the
    unscaled LANCZOS_SIDE² Laplacian's CSRDevice from a given v0: against
    the CPU, and the Ritz values inside the analytic spectrum."""
    import math
    import torch
    from elemental_tpu_torch import lapack
    from elemental_tpu_torch.matrices import sparse_laplacian_2d
    s = LANCZOS_SIDE
    A = sparse_laplacian_2d(s, s, scaled=False)
    N = A.height
    v0 = torch.randn(N, generator=torch.Generator().manual_seed(31),
                     dtype=torch.float64)
    lam_min = 8 * math.sin(math.pi / (2 * (s + 1))) ** 2
    lam_max = 8 - lam_min
    runs = {}
    for dev in ("cuda", "cpu"):
        M = A.device_csr(device=dev, dtype=torch.float64)
        v = v0.to(dev)
        (T1, sec) = wall(lambda: lapack.lanczos(N, M.matvec, 20, v0=v)) \
            if dev == "cuda" else (lapack.lanczos(N, M.matvec, 20, v0=v), 0)
        T2 = lapack.product_lanczos(M, 20, v0=v)
        ext = torch.stack(lapack.extremal_singular_value_estimates(M, 20,
                                                                   v0=v))
        runs[dev] = (T1.cpu(), T2.cpu(), ext.cpu(), sec)
    card, host = runs["cuda"], runs["cpu"]
    err = max(float((c - h).abs().max() / h.abs().max())
              for c, h in zip(card[:3], host[:3]))
    _gate("Lanczos family card against CPU", err, 1e-10)
    r1 = torch.linalg.eigvalsh(card[0])
    r2 = torch.linalg.eigvalsh(card[1])
    slack = 1e-10
    check(float(r1.min()) >= lam_min * (1 - slack)
          and float(r1.max()) <= lam_max * (1 + slack),
          f"lanczos Ritz values [{float(r1.min())}, {float(r1.max())}] "
          f"outside [{lam_min}, {lam_max}]")
    check(float(r2.min()) >= lam_min ** 2 * (1 - slack)
          and float(r2.max()) <= lam_max ** 2 * (1 + slack),
          "product_lanczos Ritz values outside [λ_min², λ_max²]")
    smin, smax = card[2].tolist()
    print(f"[{tag}] lanczos on the {s}² Laplacian (n = {N}), 20 steps: "
          f"{card[3] * 1e3:.1f} ms, Ritz values [{float(r1.min()):.6f},"
          f" {float(r1.max()):.6f}] inside [{lam_min:.3e}, {lam_max:.6f}]; "
          f"product_lanczos [{float(r2.min()):.6f}, {float(r2.max()):.6f}]; "
          f"σ estimates [{smin:.6f}, {smax:.6f}]; card within {err:.3e} of "
          f"the CPU")


def _spec_roofline_io(tag: str) -> None:
    """roofline.audit of K6 axpy at 8192² against bound(); an io.write and
    read of an 8192² float64 tensor from the card, bit for bit."""
    import torch
    from elemental_tpu_torch import io as elio
    from elemental_tpu_torch.kernels import elementwise as ew
    from elemental_tpu_torch.utils import roofline
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(37)
    x = torch.randn(n, n, generator=gen, device="cuda")
    y = torch.randn(n, n, generator=gen, device="cuda")
    nbytes = 3 * 4 * n * n
    spec = roofline.chip_specs()
    rep = roofline.audit(lambda v: ew.axpy(1e-3, v, y), x, flops=2 * n * n,
                         bytes_accessed=nbytes, dtype=torch.float32,
                         spec=roofline.CHIPS["h100 sxm"])
    b_ms, b_by = bound(nbytes, 2 * n * n)
    check(abs(rep.sol_seconds * 1e3 - b_ms) <= 1e-12 * b_ms
          and b_by == "bytes" and rep.bound == "memory",
          f"audit's bound {rep.sol_seconds * 1e3} ms against bound()'s "
          f"{b_ms} ms")
    check(rep.sol_fraction <= 1.05, f"axpy at {rep.sol_fraction:.3f} of the "
          f"bound's speed")
    print(f"[{tag}] roofline.audit of K6 axpy at {n}² (spec {spec.name} by "
          f"the card's name): {rep}; bound {b_ms:.4f} ms = bound()'s")
    del x, y
    a = torch.randn(n, n, generator=gen, device="cuda", dtype=torch.float64)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "a.bin")
        _, sec_w = wall(lambda: elio.write(path, a))
        back, sec_r = wall(lambda: elio.read(path, device="cuda"))
    check(back.is_cuda and torch.equal(back, a), "io round trip changed "
          "the bits")
    print(f"[{tag}] io.write/read of an {n}² float64 tensor from the card: "
          f"bits equal; write {sec_w:.2f} s, read {sec_r:.2f} s")
    del a, back
    torch.cuda.empty_cache()


def phase_spectral(seed: int) -> None:
    """23: the spectral tier on the card (see the module docstring).  Every
    gate is fatal."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = "23 spectral"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t_phase = time.perf_counter()
    for part in (_spec_eig, _spec_reductions, _spec_functions,
                 _spec_tridiagonal, _spec_host):
        t0 = time.perf_counter()
        part(gen, tag)
        print(f"[{tag}] {part.__name__[6:]}: {time.perf_counter() - t0:.1f} s")
    for part in (_spec_lanczos, _spec_roofline_io):
        t0 = time.perf_counter()
        part(tag)
        print(f"[{tag}] {part.__name__[6:]}: {time.perf_counter() - t0:.1f} s")
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")


DIST_LAP = 48            # phase 24's 3-D Laplacian: DIST_LAP³ rows
DIST_GATE = {"float32": 1e-4, "float64": 1e-10}


def dist_tiers(symb, grid, dist_front_min: int, dtype) -> dict:
    """24: which levels of ``symb`` the grid's factor gives to each tier
    (``numeric.level_tier``): the level indices, by tier."""
    from elemental_tpu_torch.sparse_direct import numeric
    key = {"dist": "dist_front", "split": "split"}
    out = {"dist_front": [], "split": [], "plain": []}
    for li, lev in enumerate(symb.levels):
        tier = numeric.level_tier(lev, grid=grid, spd=False, dtype=dtype,
                                  dist_front_min=dist_front_min)
        out[key.get(tier, "plain")].append(li)
    return out


def dist_bytes(symb, grid, tiers: dict, itemsize: int) -> int:
    """24: the bytes a grid factor must record across positions: each
    distributed front's panel gathers ((P − 1)·rows·nb elements a position
    a panel holding a pivot) and its replication ((P − 1)·S²), and each
    split level's replication (every position receives the chunks it does
    not hold; the split is over every axis)."""
    from elemental_tpu_torch.sparse_direct.dist_front import (PANEL,
                                                              padded_size)
    P = grid.size
    total = 0
    for li in tiers["dist_front"]:
        lev = symb.levels[li]
        S = lev.front_size
        rl = padded_size(S, PANEL, P) // P
        for ns in lev.ns:
            total += -(-int(ns) // PANEL) * P * (P - 1) * rl * PANEL
            total += (P - 1) * S * S
    for li in tiers["split"]:
        lev = symb.levels[li]
        nf, S = lev.sn_ids.shape[0], lev.front_size
        size = -(-nf // P)
        total += sum(nf - max(0, min(size, nf - c * size))
                     for c in range(P)) * S * S
    return total * itemsize


def dist_peer_bytes(symb, grid, tiers: dict, itemsize: int) -> int:
    """24: the bytes a grid factor copies between distinct cards
    (``transfers.peer_bytes``): each distributed front's row blocks out to
    their positions' cards and back, and per panel every card of a
    position holding a row ≥ j0 receives the other cards' such rows of the
    panel's min(nb, ns − j0) columns; each split level's chunks on other
    cards than the pool's out and back, with their int64 ``ns``."""
    from elemental_tpu_torch.sparse_direct.dist_front import (PANEL,
                                                              padded_size)
    devs = [grid.device(i, j) for i, j in grid.positions()]
    P = len(devs)
    total = 0
    for li in tiers["dist_front"]:
        lev = symb.levels[li]
        Sp = padded_size(lev.front_size, PANEL, P)
        rl = Sp // P
        for ns in (int(n) for n in lev.ns):
            total += 2 * sum(d != devs[0] for d in devs) * rl * Sp
            for j0 in range(0, ns, PANEL):
                act = range(j0 // rl, P)
                need = {devs[q] for q in act}
                if len(need) > 1:
                    total += min(PANEL, ns - j0) * sum(
                        rl - max(j0 - q * rl, 0) for d in need for q in act
                        if devs[q] != d)
    total *= itemsize
    for li in tiers["split"]:
        lev = symb.levels[li]
        nf, S = lev.sn_ids.shape[0], lev.front_size
        size = -(-nf // P)
        for c in range(P):
            k = max(0, min(size, nf - c * size))
            if k and devs[c] != devs[0]:
                total += 2 * k * S * S * itemsize + 8 * k
    return total


def dist_ldl_cards(tag: str, base, b, Ssc, gflop: float) -> None:
    """24, where four cards are visible: the same plan's float64 LDLᵀ
    (``spd=False``: K8 in both grid tiers) on a 2×2 grid of four cards, one
    position a card, against the one-card factor at the phase's gate, with
    K1's and K8's launches and the bytes copied between the cards
    (``transfers.peer_bytes``) against ``dist_peer_bytes``."""
    import copy
    import numpy as np
    import torch
    from elemental_tpu_torch.core import Grid
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.kernels.front_panel import ldl_panel
    from elemental_tpu_torch.sparse_direct import SparseLDLFactorization
    from elemental_tpu_torch.utils import transfers
    cards = [torch.device("cuda", i) for i in range(4)]
    grid = Grid(cards, height=2)

    def synced(fn):
        def run():
            fn()
            for c in cards:
                torch.cuda.synchronize(c)
        return run

    f4 = copy.copy(base)
    f4.grid, f4.spd, f4.dtype, f4.numeric = grid, False, torch.float64, None
    tiers = dist_tiers(f4.symb, grid, f4.dist_front_min, f4.dtype)
    _, t_first = wall(synced(f4.factor))
    k1, k8, peer = extend_add.launches, ldl_panel.launches, \
        transfers.peer_bytes
    t_grid = best_wall(synced(f4.factor))
    n_k1 = (extend_add.launches - k1) // 3
    n_k8 = (ldl_panel.launches - k8) // 3
    got = (transfers.peer_bytes - peer) // 3
    want = dist_peer_bytes(f4.symb, grid, tiers, 8)
    check(got == want, f"four cards: {got} bytes copied between the cards "
          f"a factor, the tiers' formula {want}")
    check(n_k1 == len(base.ea_plan.levels), f"four cards: K1 launched "
          f"{n_k1} times a factor, {len(base.ea_plan.levels)} levels with an "
          f"extend-add")
    peaks = [torch.cuda.max_memory_allocated(c) / 2 ** 30 for c in cards]
    f1 = SparseLDLFactorization(device=cards[0], dtype=torch.float64)
    f1.A, f1.symb, f1.ea_plan = base.A, base.symb, base.ea_plan
    f1.factor()
    t_one = best_wall(f1.factor)
    lo_g, lo_1 = lower_fronts(f4), lower_fronts(f1)
    scale = max(float(t.abs().max()) for t in lo_1)
    err = max(float((a - c).abs().max()) for a, c in zip(lo_g, lo_1))
    err_d = float((f4.numeric.d - f1.numeric.d).abs().max())
    del lo_g, lo_1, f1
    gate = DIST_GATE["float64"]
    check(err <= gate * scale and err_d <= gate * scale,
          f"four cards: grid factor {err:.3e} (pool) / {err_d:.3e} (d) from "
          f"the one-card factor, gate {gate:g}·{scale:.3e}")
    x = f4.solve(b).cpu().double().numpy()
    res = float(np.linalg.norm(Ssc @ x - b) / np.linalg.norm(b))
    check(np.isfinite(res) and res < f4.residual_bound(),
          f"four cards: solve residual {res:.3e} >= "
          f"{f4.residual_bound():.3e}")
    print(f"[{tag}] float64 LDLᵀ (spd=False) on a 2×2 grid of four cards, "
          f"one position a card: factor {t_grid:.3f} s (best of 3; first "
          f"{t_first:.3f} s) = {gflop / t_grid:.1f} GF/s, one card "
          f"{t_one:.3f} s (four / one {t_grid / t_one:.2f}); K1 {n_k1} and "
          f"K8 {n_k8} launches a factor; {got} bytes copied between the "
          f"cards a factor (= the tiers' formula); pool and d {err:.3e} / "
          f"{err_d:.3e} from the one-card factor (max|pool| {scale:.3e}, "
          f"gate {gate:g}); solve residual {res:.3e}; peak GiB by card "
          + ", ".join(f"{p:.2f}" for p in peaks))
    f4.numeric = None
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()


def lower_fronts(f) -> list:
    """24: each level's fronts' lower triangles (the entries the factor
    defines and the solves read; above the diagonal the LDL elimination
    and the Cholesky kernel leave different values)."""
    import torch
    return [torch.tril(f.numeric._level_fronts(lev)) for lev in f.symb.levels]


def best_wall(fn, reps: int = 3) -> float:
    """Least seconds of ``fn()`` over ``reps`` runs (``wall``)."""
    return min(wall(fn)[1] for _ in range(reps))


def phase_dist_ldl(seed: int, order: dict) -> int:
    """24: the distributed sparse-direct tier on a 2×2 grid over the card
    (see the module docstring).  Returns K1's launches in the grid
    factors."""
    import copy
    import numpy as np
    import torch
    from elemental_tpu_torch import entry as port_entry
    from elemental_tpu_torch.core import Grid
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.matrices import sparse_laplacian_3d
    from elemental_tpu_torch.sparse import DistSparseMatrix
    from elemental_tpu_torch.sparse_direct import (DistSparseLDLFactorization,
                                                   SparseLDLFactorization)
    from elemental_tpu_torch.utils.transfers import count_transfers
    tag = "24 dist LDL"
    t_phase = time.perf_counter()
    card = torch.device("cuda", 0)
    A = sparse_laplacian_3d(DIST_LAP, DIST_LAP, DIST_LAP, scaled=False)
    grid = Grid([card] * 4, height=2)
    base = DistSparseLDLFactorization(dtype=torch.float64, spd=True)
    _, t_init = wall(lambda: base.initialize(
        DistSparseMatrix.from_sparse(A, grid), perm=order["perm"],
        size_bucket=1.5))
    symb = base.symb
    tiers = dist_tiers(symb, grid, base.dist_front_min, base.dtype)
    check(tiers["dist_front"] and tiers["split"],
          f"{DIST_LAP}³: a tier took no level at the default thresholds: "
          f"{ {k: len(v) for k, v in tiers.items()} }")
    sizes = [symb.levels[li].front_size for li in tiers["dist_front"]]
    fronts = sum(symb.levels[li].sn_ids.shape[0]
                 for li in tiers["dist_front"])
    sum_ns = sum(int(symb.levels[li].ns.sum()) for li in tiers["dist_front"])
    gflop = base.factor_gflops()
    levels = len(base.ea_plan.levels)
    print(f"[{tag}] {DIST_LAP}³ Laplacian, N={A.height}, 2×2 grid over the "
          f"card: {symb.num_levels} levels, {levels} with an extend-add, "
          f"pool {symb.pool_size} entries; distributed front on "
          f"{len(tiers['dist_front'])} levels ({fronts} fronts, S "
          f"{min(sizes)}-{max(sizes)}, Σns = {sum_ns} columns, "
          f"dist_front_min {base.dist_front_min}), batch split on "
          f"{len(tiers['split'])} levels {tiers['split']}, plain on "
          f"{len(tiers['plain'])}; {gflop:.1f} GFLOP a factor; initialize "
          f"{t_init:.1f} s with the worker's ordering "
          f"({order['seconds']:.1f} s)")
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(A.height)
    Ssc = A.to_scipy()
    launches = 0
    for dtype in (torch.float64, torch.float32):
        dt = str(dtype)[6:]
        fg = copy.copy(base)
        fg.dtype, fg.numeric = dtype, None
        f1 = SparseLDLFactorization(device=card, dtype=dtype, spd=True)
        f1.A, f1.symb, f1.ea_plan = base.A, base.symb, base.ea_plan
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        extend_add.launches = 0
        with count_transfers() as log, FirstFactor() as first:
            _, t_first = wall(fg.factor)
        n_k1 = extend_add.launches
        check(n_k1 == levels, f"{dt}: K1 launched {n_k1} times in a grid "
              f"factor, {levels} levels with an extend-add")
        aud = log.audit()
        want = dist_bytes(symb, grid, tiers, torch.finfo(dtype).bits // 8)
        check(log.bytes() == log.bytes("all-gather") == want,
              f"{dt}: the grid factor recorded {log.bytes()} bytes, the "
              f"tiers' formula {want}")
        extend_add.launches = 0
        t_grid = best_wall(fg.factor)
        n_k1 += extend_add.launches
        launches += n_k1
        peak_grid = torch.cuda.max_memory_allocated() / 2 ** 30
        f1.factor()
        t_one = best_wall(f1.factor)
        lo_g, lo_1 = lower_fronts(fg), lower_fronts(f1)
        scale = max(float(t.abs().max()) for t in lo_1)
        err = max(float((a - c).abs().max()) for a, c in zip(lo_g, lo_1))
        err_d = float((fg.numeric.d - f1.numeric.d).abs().max())
        del lo_g, lo_1
        gate = DIST_GATE[dt]
        check(err <= gate * scale and err_d <= gate * scale,
              f"{dt}: grid factor {err:.3e} (pool) / {err_d:.3e} (d) from "
              f"the one-device factor, gate {gate:g}·{scale:.3e}")
        x = fg.solve(b).cpu().double().numpy()
        res = float(np.linalg.norm(Ssc @ x - b) / np.linalg.norm(b))
        bound = fg.residual_bound()
        check(np.isfinite(res) and res < bound, f"{dt}: grid solve "
              f"residual {res:.3e} >= {bound:.3e}")
        line = (f"[{tag}] {dt}: grid factor {t_grid:.3f} s (best of 3; "
                f"first {t_first:.3f} s) = {gflop / t_grid:.1f} GF/s, one "
                f"device {t_one:.3f} s = {gflop / t_one:.1f} GF/s (grid / "
                f"one {t_grid / t_one:.2f}); K1 {n_k1} launches in 4 grid "
                f"factors; transfers a factor: {aud['total']['count']} "
                f"records, {aud['total']['bytes']} bytes (all-gather, = the "
                f"tiers' formula); pool and d {err:.3e} / {err_d:.3e} from "
                f"the one-device factor (max|pool| {scale:.3e}, gate "
                f"{gate:g}); solve residual {res:.3e} < {bound:.3e}")
        if dtype == torch.float32:
            xr = fg.solve_with_iterative_refinement(b).cpu().double()
            rr = float(np.linalg.norm(Ssc @ xr.numpy() - b)
                       / np.linalg.norm(b))
            check(rr < 1e-5, f"float32: refined residual {rr:.3e} >= 1e-5")
            line += f"; refined (6 steps) {rr:.3e} < 1e-5"
        line += (f"; peak {peak_grid:.2f} GiB (grid), "
                 f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
                 f"(with the one-device factor)")
        if dtype == torch.float64:
            line += (f"; grid: {profile_factor(fg)}; one device: "
                     f"{profile_factor(f1)}")
        del f1
        fg.numeric = None
        torch.cuda.empty_cache()
        print(line + "; " + k1_against_plain(first.args))
        del fg, first
        torch.cuda.empty_cache()
    if torch.cuda.device_count() >= 4:
        dist_ldl_cards(tag, base, b, Ssc, gflop)
    del base
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = port_entry.dryrun_multichip(4, devices=[card] * 4)
    print(f"[{tag}] entry.dryrun_multichip(4) on the card (one card, "
          f"repeated positions; lap3d=32): {time.perf_counter() - t0:.1f} s; "
          f"factor {out['factor_s_grid']:.3f} s on the grid, "
          f"{out['factor_s_one']:.3f} s on one position, "
          f"{out['factor_transfers']['bytes']} bytes across positions; "
          f"weak scaling (one card, repeated positions): " + "; ".join(
              f"{r['op']} {r['positions']}: {r['ms']:.2f} ms, "
              f"{r['bytes']} bytes" for r in out["scaling"]))
    if torch.cuda.device_count() >= 4:
        t0 = time.perf_counter()
        out = port_entry.dryrun_multichip(4)
        print(f"[{tag}] entry.dryrun_multichip(4) on its default devices "
              f"(four cards, one position a card; lap3d=32): "
              f"{time.perf_counter() - t0:.1f} s; factor "
              f"{out['factor_s_grid']:.3f} s on the grid, "
              f"{out['factor_s_one']:.3f} s on one position; weak scaling "
              f"(one card a position): " + "; ".join(
                  f"{r['op']} {r['positions']}: {r['ms']:.2f} ms"
                  for r in out["scaling"]))
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


def random_level(ns, S: int, dtype, seed: int):
    """A random indefinite batch of fronts on the card for a level of
    ``len(ns)`` fronts of order S: normal entries, the diagonal ±2√S."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    nf = len(ns)
    F = torch.randn(nf, S, S, generator=g, device="cuda", dtype=dtype)
    sign = torch.where(torch.rand(nf, S, generator=g, device="cuda") < 0.5,
                       -1.0, 1.0).to(dtype)
    F.diagonal(dim1=1, dim2=2).add_(sign * 2 * math.sqrt(S))
    return F


def blocked_panels(symb) -> int:
    """K8 launches a factor of the plan ``symb`` takes: one a panel of NB
    columns of every level (the blocked LDLᵀ kernel takes them all)."""
    from elemental_tpu_torch.kernels.front_panel import NB
    return sum(-(-int(lev.ns.max()) // NB) for lev in symb.levels)


def phase_front_panel(seed: int, lp_symb=None, lap_perm=None) -> dict:
    """25: K8 at the largest blocked level of the LP's KKT plan (float32)
    and of the 48³ Laplacian's (float64), against the plain panel loop;
    see the module docstring.  Without the plans (alone:
    ``c.phase_card(); c.phase_front_panel(0)``) it makes them (~1 min of
    host analysis)."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.front_panel import (NB, ldl_panel,
                                                         ldl_panel_plain)
    from elemental_tpu_torch.matrices import (concat_fd_2d,
                                              sparse_laplacian_3d)
    from elemental_tpu_torch.optimization.lp import (_build_lp_kkt,
                                                     sparse_ruiz)
    from elemental_tpu_torch.sparse_direct import (SparseLDLFactorization,
                                                   nested_dissection, numeric)
    tag = "25 K8"
    t_phase = time.perf_counter()
    if lp_symb is None:
        lp_symb = _build_lp_kkt(sparse_ruiz(concat_fd_2d(224, 224))[0],
                                1e-2, 1e-2, None, device="cpu",
                                dtype=torch.float32)[0].symb
    A = sparse_laplacian_3d(48, 48, 48, scaled=False)
    if lap_perm is None:
        lap_perm = nested_dissection(A, cutoff=64)
    # the 48³ LDLᵀ factor on the card through the facade: one K8 launch a
    # blocked panel of its plan, and a solve within the residual bound
    lap = SparseLDLFactorization(device="cuda", dtype=torch.float64,
                                 spd=False).initialize(A, perm=lap_perm)
    lap_symb = lap.symb
    lap.factor()                                    # warm
    before = ldl_panel.launches
    _, t_lap = wall(lap.factor)
    lap_launches = ldl_panel.launches - before
    lap_panels = blocked_panels(lap_symb)
    check(lap_launches == lap_panels,
          f"K8 {lap_launches} launches in a 48^3 factor, the plan has "
          f"{lap_panels} blocked panels")
    rhs = np.random.default_rng(seed).standard_normal(A.height)
    x = lap.solve(rhs).cpu().numpy()
    res = float(np.linalg.norm(A.to_scipy() @ x - rhs) / np.linalg.norm(rhs))
    check(np.isfinite(res) and res < lap.residual_bound(),
          f"48^3 LDL residual {res:.3e} >= bound {lap.residual_bound():.3e}")
    print(f"[{tag}] 48^3 Laplacian float64 LDL through the facade: factor "
          f"{t_lap:.4f} s, K8 launches {lap_launches} = the plan's blocked "
          f"panels, residual {res:.3e} < {lap.residual_bound():.3e}")
    del x
    before = ldl_panel.launches
    out = {}
    for case, symb, dtype in (("lp224", lp_symb, torch.float32),
                              ("lap48", lap_symb, torch.float64)):
        wide = [lev for lev in symb.levels if int(lev.ns.max()) > NB]
        panels = blocked_panels(symb)
        lev = max(wide, key=lambda lv: lv.sn_ids.shape[0]
                  * lv.front_size)
        nf, S = lev.sn_ids.shape[0], lev.front_size
        ns_host = [int(v) for v in lev.ns]
        ns = torch.tensor(ns_host, dtype=torch.int64, device="cuda")
        F0 = random_level(ns_host, S, dtype, seed)
        scratch = [torch.empty(nf, S, NB, dtype=dtype, device="cuda")
                   for _ in range(4)]
        a, b = F0.clone(), F0.clone()
        ldl_panel(a, ns, 0, NB, False, None, *scratch[:2])
        ldl_panel_plain(b, ns, 0, NB, False, None, *scratch[2:])
        torch.cuda.synchronize()
        check(torch.equal(a, b) and torch.equal(scratch[0], scratch[2])
              and torch.equal(scratch[1], scratch[3]),
              f"K8 {case}: the kernel's panel differs from the plain loop's")
        ms = cuda_ms(lambda: ldl_panel(a, ns, 0, NB, False, None,
                                       *scratch[:2]), 50)
        plain_ms = cuda_ms(lambda: ldl_panel_plain(b, ns, 0, NB, False,
                                                   None, *scratch[2:]), 5)
        item = F0.element_size()
        nbytes = 4 * nf * S * NB * item
        b_ms, b_by = bound(nbytes)
        # the whole level's blocked factor through K8 and the plain loop:
        # bit-equal, then each timed as the lesser of two runs (the first
        # loads cuBLAS's kernels)
        max_ns = max(ns_host)

        def level():
            return wall(lambda: numeric._masked_partial_ldl_blocked(
                F0.clone(), ns, max_ns, False))

        f_k8, t_k8 = level()
        t_k8 = min(t_k8, level()[1])
        saved = numeric.ldl_panel
        numeric.ldl_panel = (
            lambda F, ns_, j0, w, c, pf, lp=None, ld=None, arrivals=None:
            ldl_panel_plain(F, ns_, j0, w, c, pf, lp, ld))
        try:
            f_plain, t_plain = level()
            t_plain = min(t_plain, level()[1])
        finally:
            numeric.ldl_panel = saved
        check(torch.equal(f_k8, f_plain),
              f"K8 {case}: the level's blocked factor differs from the "
              f"plain loop's")
        del f_k8, f_plain
        out[case] = dict(ms=ms, plain_ms=plain_ms, bound=(b_ms, b_by))
        print(f"[{tag}] {case} {str(dtype)[6:]}: {len(wide)} levels wider "
              f"than a panel, {panels} panels a factor; largest nf={nf}, "
              f"S={S}, max ns={max_ns}: first panel bit-equal to the plain "
              f"loop; kernel {ms:.4f} ms, plain loop {plain_ms:.4f} ms "
              f"({plain_ms / ms:.1f}x), bound {b_ms * 1e3:.2f} us ({b_by}, "
              f"{nbytes / 1e6:.1f} MB), kernel at {b_ms / ms:.3f} of it; "
              f"the level's blocked factor bit-equal to the plain loop's, "
              f"{t_k8:.4f} s through K8, {t_plain:.4f} s through the plain "
              f"loop")
        del F0, a, b, scratch
        torch.cuda.empty_cache()
    print(f"[{tag}] {ldl_panel.launches - before} K8 launches in the "
          f"kernel and level timings; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(cases=out, lap48_launches=lap_launches, lap=lap)


def old_scatter(symb):
    """The level scatter the tree solve ran before K9, as a stand-in for
    ``numeric.level_scatter``: ``w - xf`` added into every front slot of
    the level, the padded ones (row n) included, by ``index_add_``."""
    rows = {id(sc): lev.front_rows.reshape(-1)
            for lev, sc in zip(symb.levels, symb.solve_plan.levels)}

    def scatter(xe, w, xf, sc):
        xe.index_add_(0, rows[id(sc)], (w - xf).reshape(-1, xe.shape[1]))
    return scatter


def scatter_bytes(sc, itemsize: int) -> int:
    """K9's bytes for one level and one column: each real slot's w, xf and
    slot id, each row's offset, row id and ``xe`` value read and
    written."""
    idx = sc.slots.element_size()
    return (sc.n_slots * (2 * itemsize + idx)
            + sc.n_rows * (2 * idx + 2 * itemsize))


def phase_level_scatter(seed: int, kkt, lap) -> dict:
    """26: K9 on the LP's KKT plan and the 48³ plan; see the module
    docstring.  ``kkt``: phase 3's ``KKTSystem``; ``lap``: phase 25's
    factored ``SparseLDLFactorization``.  Alone: ``c.phase_card();
    c.phase_build(); k8 = c.phase_front_panel(0)`` and a ``KKTSystem`` of
    the LP, as ``run_phases`` makes it."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.level_scatter import (
        level_scatter, level_scatter_plain)
    from elemental_tpu_torch.sparse_direct import numeric
    tag = "26 K9"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    out = {}
    for case, symb, dtype in (("lp224", kkt.symb, torch.float32),
                              ("lap48", lap.symb, torch.float64)):
        plan = symb.solve_plan
        n = symb.n
        g = torch.Generator(device="cuda").manual_seed(seed)
        slots = real = 0
        for i, sc in enumerate(plan.levels):
            xe = torch.randn(n + 1, 1, generator=g, device="cuda",
                             dtype=dtype)
            w, xf = (torch.randn(sc.n_level_slots, 1, generator=g,
                                 device="cuda", dtype=dtype)
                     for _ in range(2))
            a, b = xe.clone(), xe.clone()
            level_scatter(a, w, xf, sc)
            level_scatter(b, w, xf, sc)
            ref = xe.cpu()
            level_scatter_plain(ref, w.cpu(), xf.cpu(), sc.to("cpu"))
            torch.cuda.synchronize()
            check(torch.equal(a.cpu(), ref) and torch.equal(a, b),
                  f"K9 {case} level {i}: the kernel differs from the plain "
                  f"version or from its own second run")
            check(bool(a[n] == xe[n]), f"K9 {case} level {i} wrote row n")
            slots += sc.n_level_slots
            real += sc.n_slots
        # the launches of one refined KKT solve (its 16 tree solves), then
        # one tree solve's launches and its time through K9 and through the
        # old scatter, and the same result
        levels = len(symb.levels)
        if case == "lp224":
            theta = torch.as_tensor(np.abs(rng.standard_normal(
                kkt.dyn_pos[0].shape[0])) + 0.1, device="cuda",
                dtype=dtype)
            fact = kkt.prepare(kkt.assemble([theta]))
            rhs = torch.as_tensor(rng.standard_normal(kkt.N),
                                  device="cuda", dtype=dtype)
            fact.solve_refined(rhs, kkt.reg, iters=16,
                               ctx=fact.solve_context())
            # a replayed graph's launches come from the card, not the host:
            # count the capturing call of a fresh context
            ctx = fact.solve_context()
            before = level_scatter.launches
            fact.solve_refined(rhs, kkt.reg, iters=16, ctx=ctx)
            launches = level_scatter.launches - before
            check(launches == 2 * levels * 16,
                  f"K9 {case}: {launches} launches in one refined solve, "
                  f"expected 2 x {levels} levels x 16 tree solves")

            def solve():
                return fact.solve(rhs, ctx)
        else:
            # the plain solve's level steps are K10's (phase 27); the solve
            # with the panel inverses scatters through K9 on every level
            rhs = torch.as_tensor(rng.standard_normal(n), device="cuda",
                                  dtype=dtype)
            lap_ctx = lap.numeric.solve_context()

            def solve():
                return lap.numeric.solve(rhs, lap_ctx)
        solve()
        before = level_scatter.launches
        x, t_k9 = wall(solve)
        tree = level_scatter.launches - before
        check(tree == 2 * levels, f"K9 {case}: {tree} launches in one tree "
              f"solve, expected 2 x {levels} levels")
        if case != "lp224":
            launches = tree
        t_k9 = min(t_k9, wall(solve)[1], wall(solve)[1])
        saved = numeric.level_scatter
        numeric.level_scatter = old_scatter(symb)
        try:
            x_old, t_old = wall(solve)
            t_old = min(t_old, wall(solve)[1], wall(solve)[1])
        finally:
            numeric.level_scatter = saved
        # the old scatter's atomics add a row's slots in no fixed order
        diff = float(torch.linalg.norm(x - x_old) / torch.linalg.norm(x_old))
        gate = 1e-4 if dtype == torch.float32 else 1e-10
        check(diff < gate, f"K9 {case}: the solve is {diff:.3e} from the "
              f"old scatter's (gate {gate:g})")
        # level 0 alone: K9, the plain version and the old pair
        sc, lev = plan.levels[0], symb.levels[0]
        xe = torch.randn(n + 1, 1, generator=g, device="cuda", dtype=dtype)
        w, xf = (torch.randn(lev.front_rows.shape + (1,), generator=g,
                             device="cuda", dtype=dtype) for _ in range(2))
        old = old_scatter(symb)
        ms = cuda_ms(lambda: level_scatter(xe, w, xf, sc), 100)
        plain_ms = cuda_ms(lambda: level_scatter_plain(xe, w, xf, sc), 100)
        old_ms = cuda_ms(lambda: old(xe, w, xf, sc), 20)
        nbytes = scatter_bytes(sc, xe.element_size())
        b_ms, b_by = bound(nbytes)
        out[case] = dict(ms=ms, plain_ms=plain_ms, old_ms=old_ms,
                         bound=(b_ms, b_by), launches=launches,
                         solve_ms=t_k9 * 1e3, old_solve_ms=t_old * 1e3)
        print(f"[{tag}] {case} {str(dtype)[6:]}: {len(plan.levels)} levels, "
              f"{slots} front slots, {real} real ({1 - real / slots:.1%} "
              f"padded): every level bit-equal to the plain version and "
              f"to itself, row n untouched; {launches} launches in one "
              f"{'refined ' if case == 'lp224' else ''}solve; a tree solve "
              f"with the panel inverses "
              f"{t_k9 * 1e3:.2f} ms through K9, {t_old * 1e3:.2f} ms through "
              f"the old scatter, {diff:.2e} apart; level 0 "
              f"({lev.front_rows.shape[0]} fronts x "
              f"S={lev.front_rows.shape[1]}, {sc.n_slots} real "
              f"slots, {sc.n_rows} rows): K9 {ms * 1e3:.2f} us, plain "
              f"{plain_ms * 1e3:.2f} us, old w - xf + index_add_ "
              f"{old_ms * 1e3:.2f} us ({old_ms / ms:.0f}x), bound "
              f"{b_ms * 1e3:.2f} us ({b_by}, {nbytes / 1e6:.2f} MB), K9 at "
              f"{b_ms / ms:.3f} of it")
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def masked_level_step(num, xe, i: int, forward: bool) -> None:
    """The plain solve's level step as it ran before K10: masked nf×S×S
    unit-lower panels (``LDLFactorization._level_panels``), one batched
    triangular solve over each padded S×S panel, ``w - xf`` added into
    every slot of the level by ``index_add_``."""
    import torch
    lev = num.symb.levels[i]
    lp = num._level_panels(lev)
    rows = lev.front_rows
    xf = xe[rows]
    if forward:
        w = torch.linalg.solve_triangular(lp, xf, upper=False,
                                          unitriangular=True)
    else:
        w = torch.linalg.solve_triangular(num._adjoint(lp), xf, upper=True,
                                          unitriangular=True)
    xe.index_add_(0, rows.reshape(-1), (w - xf).reshape(-1, xe.shape[1]))


def level_solve_bytes(lev, sub, itemsize: int, forward: bool) -> int:
    """K10's bytes for one level step and one column: the L panels (each
    front's ns·(ns-1)/2 + ns·(sz-ns) entries), each real row's value read
    (and each pivot's written; forward, each update slot's -L21·w1
    written), each real row's id and each front's ns and sz."""
    import numpy as np
    ns = sub.ns.cpu().numpy().astype(np.int64)
    sz = sub.sz.cpu().numpy().astype(np.int64)
    idx = lev.front_rows.element_size()
    panels = int((ns * (ns - 1) // 2 + ns * (sz - ns)).sum())
    values = int(sz.sum() + ns.sum()) + (int((sz - ns).sum()) if forward
                                         else 0)
    return ((panels + values) * itemsize + int(sz.sum()) * idx
            + 2 * ns.size * idx)


def phase_level_solve(seed: int, kkt, lap) -> dict:
    """27: K10 on the 48³ plan (phase 25's factor, float64) and the LP's
    KKT plan (phase 3's, float32, at a random Θ); see the module
    docstring."""
    import numpy as np
    import torch
    from elemental_tpu_torch.kernels.level_scatter import level_scatter
    from elemental_tpu_torch.kernels.level_solve import (level_solve,
                                                         level_solve_plain)
    from elemental_tpu_torch.sparse_direct import numeric
    tag = "27 K10"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed)
    theta = torch.as_tensor(np.abs(rng.standard_normal(
        kkt.dyn_pos[0].shape[0])) + 0.1, device="cuda", dtype=torch.float32)
    cases = (("lap48", lap.numeric, torch.float64),
             ("lp224", kkt.prepare(kkt.assemble([theta]))._ldl(),
              torch.float32))
    out = {}
    for case, num, dtype in cases:
        symb = num.symb
        n, plan = symb.n, symb.solve_plan
        g = torch.Generator(device="cuda").manual_seed(seed)
        gate = 64 * torch.finfo(dtype).eps
        delta = torch.empty(plan.max_level_slots, 1, device="cuda",
                            dtype=dtype)
        rows = []
        for i in (0, len(symb.levels) - 1):
            lev, sub = symb.levels[i], plan.substitution[i]
            host = types.SimpleNamespace(front_rows=lev.front_rows.cpu(),
                                         offset=0, front_size=lev.front_size)
            nf, S = lev.front_rows.shape
            pool = num.pool[lev.offset:lev.offset + nf * S * S].cpu()
            for forward in (True, False):
                xe = torch.randn(n + 1, 1, generator=g, device="cuda",
                                 dtype=dtype)
                xe[n] = 0

                def step(x, forward=forward):
                    level_solve(x, num.pool, lev, sub, forward,
                                num.conjugate, delta)
                    if forward and sub.update.n_rows:
                        level_scatter(x, delta, None, sub.update)
                a, b = xe.clone(), xe.clone()
                step(a)
                step(b)
                ref = xe.cpu()
                hd = torch.empty(nf * S, 1, dtype=dtype)
                level_solve_plain(ref, pool, host, sub.to("cpu"), forward,
                                  num.conjugate, hd)
                if forward and sub.update.n_rows:
                    level_scatter(ref, hd, None, sub.update.to("cpu"))
                torch.cuda.synchronize()
                err = float((a.cpu() - ref).abs().max() / ref.abs().max())
                check(torch.equal(a, b) and err <= gate,
                      f"K10 {case} level {i} {'fwd' if forward else 'bwd'}: "
                      f"{err:.2e} from the plain version (gate {gate:.1e}) "
                      f"or not its own bits twice")
                x = xe.clone()
                ms = cuda_ms(lambda: step(x), 20)
                plain_ms = cuda_ms(lambda: level_solve_plain(
                    x, num.pool, lev, sub, forward, num.conjugate, delta), 5)
                old_ms = cuda_ms(lambda: masked_level_step(num, x, i,
                                                           forward), 5)
                nbytes = level_solve_bytes(lev, sub, xe.element_size(),
                                           forward)
                b_ms, b_by = bound(nbytes)
                rows.append(dict(level=i, forward=forward, nf=nf, S=S,
                                 max_ns=sub.max_ns, launches=sub.launches,
                                 ms=ms, plain_ms=plain_ms, old_ms=old_ms,
                                 bound=(b_ms, b_by), err=err))
                print(f"[{tag}] {case} {str(dtype)[6:]} level {i} "
                      f"({nf} fronts, S={S}, max ns={sub.max_ns}, "
                      f"{sub.launches} K10 launch(es)) "
                      f"{'forward (K10 + K9)' if forward else 'backward'}: "
                      f"{err:.1e} from the plain version, bits repeat; "
                      f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
                      f"the masked step {old_ms * 1e3:.1f} us "
                      f"({old_ms / ms:.0f}x), bound {b_ms * 1e3:.2f} us "
                      f"({b_by}, {nbytes / 1e6:.2f} MB), at "
                      f"{b_ms / ms:.3f} of it")
        # whole solves: launches, bits, time against the masked path
        rhs = torch.as_tensor(rng.standard_normal(n), device="cuda",
                              dtype=dtype)
        num.solve(rhs)
        before = level_solve.launches
        x, t_k10 = wall(lambda: num.solve(rhs))
        launches = level_solve.launches - before
        want = 2 * sum(sub.launches for sub in plan.substitution)
        check(launches == want, f"K10 {case}: {launches} launches in one "
              f"solve, expected {want}")
        check(torch.equal(x, num.solve(rhs)), f"K10 {case}: two solves "
              f"differ")
        t_k10 = min(t_k10, wall(lambda: num.solve(rhs))[1],
                    wall(lambda: num.solve(rhs))[1])
        saved = numeric.LDLFactorization._level_solve
        numeric.LDLFactorization._level_solve = (
            lambda self, xe, i, forward, ctx=None, delta=None:
            masked_level_step(self, xe, i, forward))
        try:
            x_old, t_old = wall(lambda: num.solve(rhs))
            t_old = min(t_old, wall(lambda: num.solve(rhs))[1])
        finally:
            numeric.LDLFactorization._level_solve = saved
        diff = float(torch.linalg.norm(x - x_old) / torch.linalg.norm(x_old))
        gate = 1e-4 if dtype == torch.float32 else 1e-10
        check(diff < gate, f"K10 {case}: the solve is {diff:.3e} from the "
              f"masked path's (gate {gate:g})")
        out[case] = dict(levels=rows, launches=launches,
                         solve_ms=t_k10 * 1e3, old_solve_ms=t_old * 1e3)
        print(f"[{tag}] {case}: one solve {launches} K10 launches "
              f"({len(symb.levels)} levels, "
              f"{sum(sub.split for sub in plan.substitution)} split), "
              f"bit-equal twice; {t_k10 * 1e3:.2f} ms through K10 against "
              f"{t_old * 1e3:.2f} ms through the masked panels "
              f"({t_old / t_k10:.1f}x), {diff:.2e} apart")
    print(f"[{tag}] the phase took {time.perf_counter() - t_phase:.1f} s")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n1", type=int, default=224,
                    help="grid side of the LP (n = 2·n1² variables)")
    ap.add_argument("--max-iters", type=int, default=3,
                    help="IPM iterations of each at-scale IPM run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import elemental_tpu_torch  # noqa: F401  (fails outside the repo)

    t_start = time.perf_counter()
    phase_card()
    phase_build()
    with tempfile.TemporaryDirectory() as tmp:
        return run_phases(args, tmp, t_start)


def run_phases(args, tmp: str, t_start: float) -> int:
    """Phases 3-27 and the JSON lines; phase 16's files go into ``tmp``;
    ``t_start``: when phase 1 began."""
    import numpy as np
    import torch
    from elemental_tpu_torch.matrices import concat_fd_2d, sparse_laplacian_2d
    from elemental_tpu_torch.optimization import LPCtrl
    from elemental_tpu_torch.optimization.lp import (_build_lp_kkt,
                                                     _resolve_numerics,
                                                     sparse_ruiz)
    # phases 14-17's host analyses run beside the LP's, not after it
    mps_path, mps_expect, wait_analyses = start_ipm_analyses(
        args.n1, args.seed, tmp)
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
          f"{t_host:.2f} s, beside phases 14-17's")
    orders = wait_analyses()
    k1 = phase_k1(kkt.ea_plan, args.seed)
    phase_ldl()
    launches, k8_lp, solve_graphs = phase_lp(A, b, c, kkt, args.max_iters)
    k8 = phase_front_panel(args.seed, kkt.symb, orders["lap48"]["perm"])
    k8_launches = {"lp224": k8_lp, "lap48": k8["lap48_launches"]}
    lap = k8.pop("lap")
    k9 = phase_level_scatter(args.seed, kkt, lap)
    k10 = phase_level_solve(args.seed, kkt, lap)
    del kkt, lap
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

    t0 = time.perf_counter()
    launches += phases_ipm_tier(args.n1, args.seed, args.max_iters, orders,
                                mps_path, mps_expect, tmp)
    print(f"[14-17] the QP, affine LP, SOCP, MPS and sparse least-squares "
          f"phases took {time.perf_counter() - t0:.1f} s (host analysis "
          f"included)")

    t0 = time.perf_counter()
    c_launches, k1c = phase_complex(args.seed, orders)
    print(f"[18 complex LDL] the phase took {time.perf_counter() - t0:.1f} s "
          f"(its two symbolic analyses included)")

    phase_dense(args.seed)
    phase_sparse_products(args.seed)
    phase_drivers(os.path.join(tmp, "gen16.mps"))
    phase_lapack(args.seed)
    phase_spectral(args.seed)

    t0 = time.perf_counter()
    launches += phase_dist_ldl(args.seed, orders["lap48"])
    print(f"[24 dist LDL] the phase took {time.perf_counter() - t0:.1f} s "
          f"(its symbolic analysis included)")

    print(f"[1-27] every phase, the kernels' build included, took "
          f"{time.perf_counter() - t_start:.1f} s")

    def entry(name, source, replaces, launches, r, ms="ms",
              plain_ms="plain_ms", bound_key="bound", library_ms=None):
        """One kernel's line: r holds its max|err| vs the plain version,
        its and the plain version's ms, and its bound."""
        bound_ms, bound_by = r[bound_key]
        return {"name": name, "route": "cuda",
                "source": f"elemental_tpu_torch/csrc/{source}",
                "replaces": f"elemental_tpu/kernels/{replaces}",
                "launches": launches, "max_abs_err": r.get("err"),
                "ms": r[ms], "plain_ms": r[plain_ms], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms}

    ew_lines = {"axpy": 49, "scale": 56, "hadamard": 63, "fill": 70,
                "copy": 84, "transpose": 91}
    r32 = k1[torch.float32]
    # where the plain version is itself the one library call (index_add_,
    # cuBLAS, torch's elementwise kernels), library_ms is its time
    print(json.dumps({"kernels": [
        dict(entry("extend_add", "extend_add.cu", "extend_add.py:58",
                   launches, r32, library_ms=r32["plain_ms"]),
             graph_ms=r32["graph_ms"],
             graph_plain_ms=r32["graph_plain_ms"]),
        *(dict(entry(f"extend_add_{str(dt)[6:]}", "extend_add.cu",
                     "extend_add.py:58", c_launches[dt], k1c[dt],
                     library_ms=k1c[dt]["plain_ms"]),
               graph_ms=k1c[dt]["graph_ms"],
               graph_plain_ms=k1c[dt]["graph_plain_ms"])
          for dt in (torch.complex64, torch.complex128)),
        entry("stencil_spmv", "stencil_spmv.cu", "spmv.py:123", k3_launches,
              k3, library_ms=k3["lib_ms"]),
        entry("gather_spmv", "csr_spmv.cu", "unstructured.py:179",
              k2_launches, k2, library_ms=k2["lib_ms"]),
        entry("stream_gather", "bridged.cu", "unstructured.py:179",
              br_launches["gather"], dict(br, err=br["g_err"]), "ms_g",
              "plain_g", "g_bound"),
        entry("onehot_combine_bucketed", "bridged.cu", "unstructured.py:287",
              br_launches["combine"], dict(br, err=br["c_err"]), "ms_c",
              "plain_c", "c_bound", library_ms=br["plain_c"]),
        *(entry(f"matmul_{path}", src, "matmul.py:32", k4_launches[path],
                k4[path], library_ms=k4[path]["plain_ms"])
          for path, src in (("wgmma", "matmul_sm90.cu"),
                            ("dmma", "matmul_sm90.cu"),
                            ("ffma", "matmul_sm90.cu"),
                            ("simt", "matmul.cu"))),
        *(entry(name, src, "matmul.py:68", k5_launches[path], k5[path])
          for name, path, src in (
              ("masked_rank_k_update", "ffma", "matmul_sm90.cu"),
              ("masked_rank_k_update_dmma", "dmma", "matmul_sm90.cu"),
              ("masked_rank_k_update_simt", "simt", "matmul.cu"))),
        *(entry(op, "elementwise.cu", f"elementwise.py:{line}",
                k6_launches[op], k6[op], library_ms=k6[op]["plain_ms"])
          for op, line in ew_lines.items()),
        *({"name": f"ldl_panel_{case}", "route": "cuda",
           "source": "elemental_tpu_torch/csrc/front_panel.cu",
           "replaces": None, "launches": k8_launches[case],
           "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
           "library_ms": None} for case, r in k8["cases"].items()),
        *({"name": f"level_scatter_{case}", "route": "cuda",
           "source": "elemental_tpu_torch/csrc/level_scatter.cu",
           "replaces": None, "launches": r["launches"],
           "max_abs_err": 0.0, "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
           "library_ms": None, "old_pair_ms": r["old_ms"],
           "solve_ms": r["solve_ms"], "old_solve_ms": r["old_solve_ms"]}
          for case, r in k9.items()),
        *({"name": f"level_solve_{case}_level{r['level']}_"
                   f"{'fwd' if r['forward'] else 'bwd'}", "route": "cuda",
           "source": "elemental_tpu_torch/csrc/level_solve.cu",
           "replaces": None, "launches": k10[case]["launches"],
           "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
           "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
           "library_ms": None, "masked_ms": r["old_ms"],
           "solve_ms": k10[case]["solve_ms"],
           "masked_solve_ms": k10[case]["old_solve_ms"]}
          for case in k10 for r in k10[case]["levels"])],
        "solve_refined": solve_graphs}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
