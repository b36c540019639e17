"""Closed loop of refactors on a fixed pattern (Elemental's
``ChangeNonzeroValues``): each request hands ``SparseLDLFactorization`` one
of the mix's seeded value sets (``change_nonzero_values``, which refactors)
and solves one seeded right-hand side against the new factor.  The solve is
also timed on its own, from the factor's synchronisation to its own.

The check solves a seeded sample of the window's requests again with the
reference's conjugate gradients (``reference/lap3d.py``), on the matrix the
reference builds from the same value set, and compares the solutions."""

from __future__ import annotations

import time

from harness.core import synchronize
from harness.inputs import Reservoir, device_normal
from reference import lap3d
from reference.lp_fd2d import rng_for


def setup(cfg, params, seed, device, span):
    import torch
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.sparse import SparseMatrix
    from elemental_tpu_torch.sparse_direct import SparseLDLFactorization
    dtype = getattr(torch, cfg["dtype"])
    L = lap3d.laplacian(cfg["side"])
    f = SparseLDLFactorization(device=device, dtype=dtype, spd=cfg["spd"])
    with span("host_analysis"):
        f.initialize(SparseMatrix.from_scipy(L), cutoff=cfg["cutoff"])
    state = dict(L=L, f=f, extend_add=extend_add, params=params,
                 k1_levels=[(lv.n_pairs, lv.n_dest)
                            for lv in f.ea_plan.levels.values()],
                 itemsize=torch.empty((), dtype=dtype).element_size(),
                 device=device, dtype=dtype)
    reseed(state, seed)
    with span("warmup"):
        f.factor()
        f.change_nonzero_values(state["values"][0])
        f.solve(state["rhs"][0])
    return state


def reseed(state, seed):
    """The seed's value sets and right-hand sides, and a fresh sample."""
    params, L = state["params"], state["L"]
    state["values"] = [
        lap3d.diffusion_values(L, rng_for(seed, 0, i), params["coef_low"],
                               params["coef_high"])
        for i in range(params["value_sets"])]
    state["rhs"] = device_normal(seed, 1, (params["rhs_pool"], L.shape[0]),
                                 state["dtype"], state["device"])
    state["sample"] = Reservoir(params["check_requests"], seed)


def release(state):
    """The program's factor goes before the reference runs."""
    import torch
    state.pop("f", None)
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.empty_cache()


def request(state, k):
    f = state["f"]
    f.change_nonzero_values(state["values"][k % len(state["values"])])
    synchronize(state["device"])
    t0 = time.perf_counter()
    x = f.solve(state["rhs"][k % state["rhs"].shape[0]])
    synchronize(state["device"])
    solve_s = time.perf_counter() - t0
    state["sample"].offer(k, x)
    return {"refactors": 1, "solve_after_refactor_s": solve_s}


def counters(state):
    return {"k1_launches": state["extend_add"].launches}


def info(state):
    return {"k1_levels": state["k1_levels"], "itemsize": state["itemsize"]}


def check(state, seed, control=False):
    """The largest relative forward error of the sampled solutions against
    CG in float64 on the reference's own matrices.  ``control``: CG in
    float32, the precision below the configuration's float64, in the
    program's place."""
    import torch
    L = state["L"]
    worst = 0.0
    for k, x in state["sample"].sample():
        M = L.copy()
        M.data = state["values"][k % len(state["values"])]
        b = state["rhs"][k % state["rhs"].shape[0]].double().cpu().numpy()
        ref = lap3d.solve(M, b[:, None], state["device"])
        if control:
            x = lap3d.solve(M, b[:, None], state["device"],
                            dtype=torch.float32, rtol=1e-7)
        got = torch.as_tensor(x).double().cpu().numpy()
        worst = max(worst, lap3d.forward_error(got, ref))
    return {"x_err": worst}
