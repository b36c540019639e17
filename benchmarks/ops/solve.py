"""Closed loop of solves against one finished factor: the configuration's
matrix is factored once at set-up (``SparseLDLFactorization``), and each
request solves one right-hand side from a pool made on the device from the
seed before the window.  No factor and no extend-add runs in the window.

The check solves a seeded sample of the window's requests again with the
reference's conjugate gradients (``reference/lap3d.py``) and compares."""

from __future__ import annotations

from harness.inputs import Reservoir, device_normal
from reference import lap3d


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
                 device=device, dtype=dtype)
    reseed(state, seed)
    with span("warmup"):
        f.factor()
        f.solve(state["rhs"][0])
    return state


def reseed(state, seed):
    """The seed's right-hand sides, and a fresh sample."""
    params = state["params"]
    state["rhs"] = device_normal(seed, 1, (params["rhs_pool"],
                                           state["L"].shape[0]),
                                 state["dtype"], state["device"])
    state["sample"] = Reservoir(params["check_requests"], seed)


def release(state):
    """The program's factor goes before the reference runs."""
    import torch
    state.pop("f", None)
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.empty_cache()


def request(state, k):
    import torch
    x = state["f"].solve(state["rhs"][k % state["rhs"].shape[0]])
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    state["sample"].offer(k, x)
    return {"solves": 1}


def counters(state):
    return {"k1_launches": state["extend_add"].launches}


def info(state):
    return {}


def check(state, seed, control=False):
    """The largest relative forward error of the sampled solutions against
    CG in float64.  ``control``: CG in float32, the precision below the
    configuration's float64, in the program's place."""
    import torch
    sample = state["sample"].sample()
    if not sample:
        return {}
    P = state["rhs"].shape[0]
    B = torch.stack([state["rhs"][k % P] for k, _ in sample], 1)
    B = B.double().cpu().numpy()
    ref = lap3d.solve(state["L"], B, state["device"])
    if control:
        got = lap3d.solve(state["L"], B, state["device"],
                          dtype=torch.float32, rtol=1e-7)
    else:
        got = torch.stack([x for _, x in sample], 1).double().cpu().numpy()
    return {"x_err": lap3d.forward_error(got, ref)}
