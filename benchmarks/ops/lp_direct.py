"""Back-to-back ``lp_direct`` calls, each on a fresh seeded instance of the
configuration's LP and capped at the mix's ``max_iters``; the KKT fill
ordering is computed once at set-up and passed through ``LPCtrl.ordering``,
so each call pays its own KKT build and symbolic analysis, as a caller does.

The check runs the reference's Mehrotra IPM (``reference/lp_fd2d.py``) on a
seeded sample of the window's calls and compares x, y, z and the
objective."""

from __future__ import annotations

import scipy.sparse as sp

from harness.inputs import Reservoir
from reference import lp_fd2d, precision


def kkt_pattern(A: sp.csr_matrix) -> sp.csr_matrix:
    """The structure of the LP's KKT, [[I, Aᵀ], [A, I]]."""
    m, n = A.shape
    K = sp.bmat([[sp.identity(n), A.T], [A, sp.identity(m)]], format="csr")
    K.sum_duplicates()
    K.sort_indices()
    return K


def setup(cfg, params, seed, device, span):
    import torch
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.optimization import LPCtrl, lp_direct
    from elemental_tpu_torch.sparse import SparseMatrix
    from elemental_tpu_torch.sparse_direct import (analyze, build_ea_plan,
                                                   nested_dissection)
    dtype = getattr(torch, cfg["dtype"])
    A_sp = lp_fd2d.concat_fd_2d(cfg["n1"], cfg["n1"])
    A = SparseMatrix.from_scipy(A_sp)
    with span("host_analysis"):
        K = SparseMatrix.from_scipy(kkt_pattern(A_sp))
        perm = nested_dissection(K, cutoff=cfg["cutoff"])
        plan = build_ea_plan(analyze(K, perm=perm))
    # the tolerance lp_direct clamps 1e-8 to in this precision, given as it
    # is so that no call warns
    tol = lp_fd2d.lp_tolerance(cfg["dtype"])
    ctrl = LPCtrl(approach=params["approach"], max_iters=params["max_iters"],
                  ordering=perm, tol=tol)
    state = dict(
        A=A, A_sp=A_sp, ctrl=ctrl, device=device, dtype=dtype,
        lp_direct=lp_direct, extend_add=extend_add, cfg=cfg, params=params,
        k1_levels=[(lv.n_pairs, lv.n_dest) for lv in plan.levels.values()],
        itemsize=torch.empty((), dtype=dtype).element_size())
    reseed(state, seed)
    with span("warmup"):
        # every kernel and shape of an iteration, on an instance the
        # window does not use
        b, c = lp_fd2d.instance(A_sp, seed, params["instances"])
        warm = LPCtrl(approach=params["approach"], max_iters=1,
                      ordering=perm, tol=tol)
        lp_direct(A, b, c, warm, device=device, dtype=dtype)
    return state


def reseed(state, seed):
    """The seed's instances, and a fresh sample for the check."""
    params = state["params"]
    state["instances"] = [lp_fd2d.instance(state["A_sp"], seed, i)
                          for i in range(params["instances"])]
    state["sample"] = Reservoir(params["check_calls"], seed)


def release(state):
    """Nothing of the program's stays on the device between calls."""


def request(state, k):
    b, c = state["instances"][k % len(state["instances"])]
    res = state["lp_direct"](state["A"], b, c, state["ctrl"],
                             device=state["device"], dtype=state["dtype"])
    state["sample"].offer(k, dict(x=res.x, y=res.y, z=res.z,
                                  objective=res.objective))
    return {"iterations": res.iterations, "calls": 1}


def counters(state):
    return {"k1_launches": state["extend_add"].launches}


def info(state):
    return {"k1_levels": state["k1_levels"], "itemsize": state["itemsize"]}


def check(state, seed, control=False):
    """The largest relative gaps of the sampled calls' x, y, z and
    objective to the reference's.  ``control``: the reference computed in
    the precision below the configuration's in the program's place."""
    tol = lp_fd2d.lp_tolerance(state["cfg"]["dtype"])
    iters = state["params"]["max_iters"]
    worst = {}
    for k, got in state["sample"].sample():
        b, c = state["instances"][k % len(state["instances"])]
        ref = lp_fd2d.mehrotra(state["A_sp"], b, c, iters, tol)
        if control:
            got = lp_fd2d.mehrotra(state["A_sp"], b, c, iters, tol,
                                   rnd=precision.BELOW[state["cfg"]["dtype"]])
        for key, v in lp_fd2d.iterate_errors(got, ref).items():
            worst[key] = max(worst.get(key, 0.0), float(v))
    return worst
