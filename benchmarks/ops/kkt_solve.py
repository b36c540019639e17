"""Closed loop of refined KKT solves against one finished factor: the LP's
KKT (``KKTSystem``, on the Ruiz-scaled matrix of the configuration) at a
seeded interior iterate is factored once at set-up through ``prepare``, and
each request is one ``KKTFactor.solve_refined`` (FGMRES with the mix's
``refine_iters`` steps) of a right-hand side from a pool made on the device
from the seed.

The check solves a seeded sample of the window's requests exactly with the
reference (``reference/lp_fd2d.py``: the unregularized KKT K₀ through its
normal equations, in float64) and compares the solutions and their
residuals against K₀."""

from __future__ import annotations

import numpy as np

from harness.inputs import Reservoir, device_normal
from reference import lp_fd2d, precision


def setup(cfg, params, seed, device, span):
    import torch
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.optimization import LPCtrl
    from elemental_tpu_torch.optimization.lp import (_build_lp_kkt,
                                                     _resolve_numerics)
    from elemental_tpu_torch.sparse import SparseMatrix
    dtype = getattr(torch, cfg["dtype"])
    A_sp, _, _ = lp_fd2d.ruiz(lp_fd2d.concat_fd_2d(cfg["n1"], cfg["n1"]))
    gamma, _ = _resolve_numerics(
        LPCtrl(tol=lp_fd2d.lp_tolerance(cfg["dtype"])), dtype)
    with span("host_analysis"):
        kkt, _ = _build_lp_kkt(SparseMatrix.from_scipy(A_sp), gamma, gamma,
                               None, device=device, dtype=dtype)
    state = dict(A_sp=A_sp, kkt=kkt, reg=kkt.reg, params=params,
                 iters=params["refine_iters"], device=device, dtype=dtype,
                 extend_add=extend_add, cfg=cfg)
    with span("warmup"):
        reseed(state, seed)
        state["fact"].solve_refined(state["rhs"][0], kkt.reg,
                                    iters=state["iters"], ctx=state["ctx"])
    return state


def reseed(state, seed):
    """The seed's interior iterate, its KKT factor and panel inverses, the
    right-hand sides, and a fresh sample."""
    import torch
    kkt, dev, dt = state["kkt"], state["device"], state["dtype"]
    m, n = state["A_sp"].shape
    state["theta"] = lp_fd2d.interior_point(n, seed)
    state["fact"] = kkt.prepare(kkt.assemble(
        [torch.as_tensor(state["theta"]).to(dev, dt)]))
    state["ctx"] = state["fact"].solve_context()
    state["rhs"] = device_normal(seed, 1, (state["params"]["rhs_pool"],
                                           n + m), dt, dev)
    state["sample"] = Reservoir(state["params"]["check_requests"], seed)


def release(state):
    """The program's factor goes before the reference runs."""
    import torch
    for key in ("fact", "ctx", "kkt"):
        state.pop(key, None)
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.empty_cache()


def request(state, k):
    import torch
    x = state["fact"].solve_refined(state["rhs"][k % state["rhs"].shape[0]],
                                    state["reg"], iters=state["iters"],
                                    ctx=state["ctx"])
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    state["sample"].offer(k, x)
    return {"solves": 1}


def counters(state):
    return {"k1_launches": state["extend_add"].launches}


def info(state):
    return {}


def check(state, seed, control=False):
    """The largest relative forward error of the sampled solutions, and
    the largest relative residual ‖rhs − K₀·x‖/‖rhs‖, against the exact
    float64 solve.  ``control``: the reference computed in the precision
    below the configuration's in the program's place."""
    import torch
    A, theta = state["A_sp"], state["theta"]
    At = A.T.tocsr()
    m, n = A.shape
    exact = lp_fd2d.kkt_solver(A, At, theta)
    rnd = precision.BELOW[state["cfg"]["dtype"]]
    rounded = lp_fd2d.kkt_solver(A, At, theta, rnd) if control else None
    P = state["rhs"].shape[0]
    err = res = 0.0
    for k, x in state["sample"].sample():
        r = state["rhs"][k % P].double().cpu().numpy()
        f, g = r[:n], r[n:]
        ref = np.concatenate(exact(f, g))
        if rounded is not None:
            got = np.concatenate(rounded(rnd(f), rnd(g)))
        else:
            got = torch.as_tensor(x).double().cpu().numpy()
        p, q = got[:n], got[n:]
        resid = np.concatenate([f - theta * p - At @ q, g - A @ p])
        err = max(err, float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))
        res = max(res, float(np.linalg.norm(resid) / np.linalg.norm(r)))
    return {"x_err": err, "resid": res}
