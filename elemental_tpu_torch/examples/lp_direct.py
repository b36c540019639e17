"""Interior-point LP on an MPS file (counterpart of
``examples/lp_direct.py``; mirror of the reference's
``examples/interface/LPDirect.py``).

    python -m elemental_tpu_torch.examples.lp_direct --mps afiro.mps
"""

from ..core.environment import Args, output
from ..optimization import Approach, LPCtrl, solve_mps
from ..sparse import read_mps
from . import device_and_dtype


def main():
    args = Args()
    args.input("mps", "path to an MPS file", "")
    args.input("approach", "mehrotra | ipf", Approach.MEHROTRA)
    args.input("tol", "convergence tolerance", 1e-8)
    where = device_and_dtype(args)
    args.process_input()
    if not args["mps"]:
        raise SystemExit("lp_direct: give the LP as --mps FILE")
    device, dtype = where()

    lp = read_mps(args["mps"])
    output(f"LP '{lp.name}': {lp.c.shape[0]} vars, "
           f"{lp.A_eq.height} eq + {lp.A_le.height} ineq rows; {dtype} on "
           f"{device}")
    ctrl = LPCtrl(approach=args["approach"], tol=args["tol"],
                  max_iters=200, verbose=True)
    res, x = solve_mps(lp, ctrl, device=device, dtype=dtype)
    output(f"objective = {res.objective:.8g}  "
           f"({res.iterations} iterations, converged={res.converged})")
    return res, x


if __name__ == "__main__":
    main()
