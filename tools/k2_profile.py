#!/usr/bin/env python3
"""Device time of each CUDA kernel behind one sparse product, from
``torch.profiler``, in float32 and float64, on the matrices of
``chip_smoke.py``:

- ``k2``: K2 (``gather_spmv``) and cuSPARSE's CSR product on the n = 2^20
  matrices of phase 8 (uniform d = 10 and the skewed zipf rows);
- ``k3``: K3 (``stencil_spmv``) and cuSPARSE's CSR product on phase 6's
  1024² Laplacian/8 and 128³ Laplacian;
- ``bridged``: on phase 8's uniform matrix, the bridged tier's stream
  gather, K7 (with the plan's summation plan where the tree has one) and
  the whole ``BridgedPlan.matvec``, beside K2; and, to show what bounds
  the gather, the gather over the same bytes with x read in slot order,
  and the gather and K7 with each bucket's slots sorted by column; then
  the gather, K7, the matvec and K2 on phase 8's skewed zipf matrix and
  on the uniform matrix with its slots shuffled within each bucket;
- ``k5``: K5 (``masked_rank_k_update``) at phase 12's 4096², rank 128,
  lower and upper, beside ``torch.addmm`` over the whole square (same
  bytes, twice the FLOPs); and K4 (``matmul``) at 4096³, whose float32 and
  float64 main loops K5 shares; in float32 and float64.

    python3 tools/k2_profile.py [--repo DIR] [--cases k2,k3,bridged,k5]
                                [--reps 50] [--seed 0]

``--repo`` names the checkout whose ``elemental_tpu_torch`` is profiled (by
default this one; another tree unpacked with ``git archive`` profiles its
kernels in the same call).  Prints, per matrix, dtype and product, each
kernel's name, its launches and its mean device microseconds a product;
needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def profile_products(label, products, reps):
    """Print each kernel's launches and device µs a call for each
    (name, fn) of ``products``."""
    import chip_smoke as cs
    print(label)
    for name, fn in products:
        for key, (count, us) in cs.device_us(fn, reps).items():
            print(f"  {name}: {key[:72]} x{count} {us:.2f} us a product")


def cusparse(M, dtype):
    import torch
    A = M.to_scipy()
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr).to("cuda", torch.int32),
        torch.from_numpy(A.indices).to("cuda", torch.int32),
        torch.from_numpy(A.data).to("cuda", dtype), size=A.shape)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=HERE,
                    help="checkout whose elemental_tpu_torch is profiled")
    ap.add_argument("--cases", default="k2",
                    help="comma-separated: k2, k3, bridged, k5")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cases = args.cases.split(",")
    if not set(cases) <= {"k2", "k3", "bridged", "k5"}:
        ap.error(f"unknown cases {args.cases!r}")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.repo))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k2_profile: no CUDA device", file=sys.stderr)
        return 1
    import elemental_tpu_torch
    from elemental_tpu_torch.kernels.spmv import stencil_spmv
    from elemental_tpu_torch.kernels.unstructured import (
        _make_bridged, gather_spmv, onehot_combine_bucketed,
        plan_bridged_spmv, plan_gather_spmv, stream_gather)
    from elemental_tpu_torch.matrices import (sparse_laplacian_2d,
                                              sparse_laplacian_3d)
    from elemental_tpu_torch.sparse import plan_spmv
    cs.phase_card()
    print(f"port: {os.path.dirname(elemental_tpu_torch.__file__)}")
    dtypes = (torch.float32, torch.float64)
    if "k2" in cases:
        for label, M in (("uniform d=10", cs.random_d10(args.seed)),
                         ("skewed zipf", cs.skewed_zipf(args.seed))):
            host = plan_gather_spmv(M)
            for dtype in dtypes:
                plan = host.to("cuda", dtype)
                x = torch.randn(M.width, device="cuda", dtype=dtype)
                csr = cusparse(M, dtype)
                profile_products(
                    f"{label} {str(dtype)[6:]}: nnz={M.nnz}",
                    (("K2", lambda: gather_spmv(plan, x)),
                     ("cuSPARSE", lambda: csr @ x)), args.reps)
                del plan, x, csr
    if "k3" in cases:
        A2 = sparse_laplacian_2d(1024, 1024, scaled=False)
        for label, M in (("1024^2 Laplacian/8",
                          A2.change_nonzero_values(A2.vals / 8.0)),
                         ("128^3 Laplacian",
                          sparse_laplacian_3d(128, 128, 128, scaled=False))):
            host = plan_spmv(M)
            for dtype in dtypes:
                st = host.to("cuda", dtype).stencil
                x = torch.randn(M.width, device="cuda", dtype=dtype)
                csr = cusparse(M, dtype)
                profile_products(
                    f"{label} {str(dtype)[6:]}: nnz={M.nnz}",
                    (("K3", lambda: stencil_spmv(st, x)),
                     ("cuSPARSE", lambda: csr @ x)), args.reps)
                del st, x, csr
    if "bridged" in cases:
        M = cs.random_d10(args.seed)
        host, k2_host = plan_bridged_spmv(M), plan_gather_spmv(M)
        # the same plan with each bucket's slots sorted by column (padding
        # last), so that a warp's reads of x ascend; K7 then sums through a
        # permutation
        nb, per = host.nbuckets, host.slots // host.nbuckets
        cb = host.cols_b.numpy().reshape(nb, per)
        perm = (np.argsort(np.where(cb >= 0, cb, np.iinfo(np.int64).max),
                           axis=1, kind="stable")
                + per * np.arange(nb)[:, None]).reshape(-1)
        by_col = _make_bridged(host.n_rows, host.n_cols, host.nnz,
                               host.bucket, host.precision,
                               host.cols_b.numpy()[perm],
                               host.vals_b.numpy()[perm],
                               host.lr.numpy().reshape(-1)[perm].reshape(
                                   host.lr.shape))
        for dtype in dtypes:
            bp, k2 = host.to("cuda", dtype), k2_host.to("cuda", dtype)
            x = torch.randn(M.width, device="cuda", dtype=dtype)
            P = stream_gather(bp, x).view(bp.lr.shape)
            # the summation plan, where this tree's plans carry one
            kw = ({"plan": bp.combine} if hasattr(bp, "combine") else {})
            # the same bytes with x read in slot order, not at random
            seq = dataclasses.replace(bp, cols_b=torch.arange(
                bp.slots, device="cuda", dtype=bp.cols_b.dtype) % M.width)
            bc = by_col.to("cuda", dtype)
            Pc = stream_gather(bc, x).view(bc.lr.shape)
            kwc = ({"plan": bc.combine} if hasattr(bc, "combine") else {})
            profile_products(
                f"bridged uniform d=10 {str(dtype)[6:]}: nnz={M.nnz}, "
                f"{bp.slots} slots",
                (("stream gather", lambda: stream_gather(bp, x)),
                 ("stream gather, x read in order",
                  lambda: stream_gather(seq, x)),
                 ("K7", lambda: onehot_combine_bucketed(
                     P, bp.lr, bucket=bp.bucket, **kw)),
                 ("matvec", lambda: bp.matvec(x)),
                 ("stream gather, slots by column",
                  lambda: stream_gather(bc, x)),
                 ("K7, slots by column", lambda: onehot_combine_bucketed(
                     Pc, bc.lr, bucket=bc.bucket, **kwc)),
                 ("K2", lambda: gather_spmv(k2, x))), args.reps)
            del bp, k2, x, P, seq, bc, Pc
        # rows of every length, and the uniform matrix's slots shuffled
        # within each bucket (K7 through a permutation)
        S = cs.skewed_zipf(args.seed)
        for label, M, host in (
                ("skewed zipf", S, plan_bridged_spmv(S)),
                ("uniform d=10, shuffled slots", M, cs.shuffled(host,
                                                                args.seed))):
            k2_host = plan_gather_spmv(M)
            for dtype in dtypes:
                bp, k2 = host.to("cuda", dtype), k2_host.to("cuda", dtype)
                x = torch.randn(M.width, device="cuda", dtype=dtype)
                P = stream_gather(bp, x).view(bp.lr.shape)
                kw = ({"plan": bp.combine} if hasattr(bp, "combine") else {})
                profile_products(
                    f"bridged {label} {str(dtype)[6:]}: nnz={M.nnz}, "
                    f"{bp.slots} slots",
                    (("stream gather", lambda: stream_gather(bp, x)),
                     ("K7", lambda: onehot_combine_bucketed(
                         P, bp.lr, bucket=bp.bucket, **kw)),
                     ("matvec", lambda: bp.matvec(x)),
                     ("K2", lambda: gather_spmv(k2, x))), args.reps)
                del bp, k2, x, P
    if "k5" in cases:
        from elemental_tpu_torch.kernels.matmul import (masked_rank_k_update,
                                                        matmul)
        torch.backends.cuda.matmul.allow_tf32 = False
        n, k = 4096, 128
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        for dtype in dtypes:
            name = str(dtype)[6:]
            c, a, b = (torch.randn(*shape, generator=gen, device="cuda",
                                   dtype=dtype)
                       for shape in ((n, n), (n, k), (k, n)))
            for lower in (True, False):
                profile_products(
                    f"K5 {n}x{n} rank {k} {name} "
                    f"{'lower' if lower else 'upper'}",
                    (("K5", lambda: masked_rank_k_update(c, a, b, -1.0,
                                                         lower)),
                     ("addmm, whole square",
                      lambda: torch.addmm(c, a, b, alpha=-1.0))), args.reps)
            a4, b4 = (torch.randn(n, n, generator=gen, device="cuda",
                                  dtype=dtype) for _ in range(2))
            profile_products(f"K4 {n}^3 {name}",
                             (("K4", lambda: matmul(a4, b4)),), args.reps)
            del c, a, b, a4, b4
    return 0


if __name__ == "__main__":
    sys.exit(main())
