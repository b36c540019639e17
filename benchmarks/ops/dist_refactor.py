"""Closed loop of refactors on a fixed pattern, as the ``refactor`` mix
drives them, through ``DistSparseLDLFactorization`` on a grid of devices
(Elemental's ``ChangeNonzeroValues`` under ``mpiexec``): the matrix is a
``DistSparseMatrix`` on the configuration's grid, the pool, K1 and the
tree solve stay on the grid's first device, and each request hands the
factor one of the mix's seeded value sets (``change_nonzero_values``,
which refactors over the grid), waits for every device of the grid, then
solves one seeded right-hand side, timed alone to its synchronisation.

The inputs, the sample and the check are ``refactor``'s: CG in float64
on the reference's own matrices (``reference/lap3d.py``)."""

from __future__ import annotations

import time
from pathlib import Path

from harness.core import load_module, synchronize
from reference import lap3d

_single = load_module(Path(__file__).with_name("refactor.py"))
reseed = _single.reseed
check = _single.check


def setup(cfg, params, seed, device, span):
    import torch
    from elemental_tpu_torch.core import Grid
    from elemental_tpu_torch.kernels.extend_add import extend_add
    from elemental_tpu_torch.sparse import DistSparseMatrix, SparseMatrix
    from elemental_tpu_torch.sparse_direct import DistSparseLDLFactorization
    from elemental_tpu_torch.utils import transfers
    dtype = getattr(torch, cfg["dtype"])
    g = cfg["grid"]
    grid = Grid([torch.device(d) for d in g["devices"]], height=g["height"])
    if grid.width != g["width"]:
        raise ValueError(f"grid of {len(g['devices'])} devices and height "
                         f"{g['height']} is not {g['width']} wide")
    L = lap3d.laplacian(cfg["side"])
    f = DistSparseLDLFactorization(dtype=dtype, spd=cfg["spd"],
                                   tree_axis=tuple(cfg["tree_axis"]),
                                   dist_front_min=cfg["dist_front_min"])
    with span("host_analysis"):
        f.initialize(DistSparseMatrix.from_sparse(SparseMatrix.from_scipy(L),
                                                  grid),
                     cutoff=cfg["cutoff"])
    cards = list(dict.fromkeys(grid.devices.ravel()))
    state = dict(L=L, f=f, extend_add=extend_add, transfers=transfers,
                 cards=cards,
                 params=params,
                 k1_levels=[(lv.n_pairs, lv.n_dest)
                            for lv in f.ea_plan.levels.values()],
                 itemsize=torch.empty((), dtype=dtype).element_size(),
                 device=f.device, dtype=dtype)
    reseed(state, seed)
    with span("warmup"):
        f.factor()
        f.change_nonzero_values(state["values"][0])
        f.solve(state["rhs"][0])
        for card in cards:
            synchronize(card)
    return state


def release(state):
    """The program's factor goes before the reference runs."""
    import torch
    state.pop("f", None)
    for card in state["cards"]:
        if card.type == "cuda":
            with torch.cuda.device(card):
                torch.cuda.empty_cache()


def request(state, k):
    f = state["f"]
    f.change_nonzero_values(state["values"][k % len(state["values"])])
    for card in state["cards"]:
        synchronize(card)
    t0 = time.perf_counter()
    x = f.solve(state["rhs"][k % state["rhs"].shape[0]])
    synchronize(state["device"])
    solve_s = time.perf_counter() - t0
    state["sample"].offer(k, x)
    return {"refactors": 1, "solve_after_refactor_s": solve_s}


def counters(state):
    """K1's launches, and the bytes the factor copied between distinct
    devices where the program counts them (``transfers.peer_bytes``)."""
    out = {"k1_launches": state["extend_add"].launches}
    peer = getattr(state["transfers"], "peer_bytes", None)
    if peer is not None:
        out["peer_bytes"] = peer
    return out


def info(state):
    return {"k1_levels": state["k1_levels"], "itemsize": state["itemsize"],
            "devices": [str(c) for c in state["cards"]]}
