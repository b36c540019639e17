"""LCF-notation graphs (counterpart of ``examples/lcf.py``; mirror of the
reference's ``examples/interface/LCF.py``): the Levi, dodecahedral and
truncated-octahedral graphs from their Lewis-Coxeter-Frucht codes; each is
checked 3-regular (degrees as a device CSR product with ones on
``--device``) and symmetric, and drawn with ``io.spy`` where matplotlib is
installed.

    python -m elemental_tpu_torch.examples.lcf
"""

import numpy as np
import torch

from ..core.environment import Args, output
from ..io import spy
from ..sparse import Graph
from . import check, device_and_dtype


def lcf_graph(lcf) -> Graph:
    n = len(lcf)
    s = np.arange(n)
    srcs = np.concatenate([s, s, s, (s + lcf) % n])
    tgts = np.concatenate([(s - 1) % n, (s + 1) % n, (s + lcf) % n, s])
    return Graph.from_edges(n, n, srcs, tgts)


def main():
    args = Args()
    where = device_and_dtype(args, "float64")
    args.process_input()
    device, dtype = where()
    levi = np.array([-13, -9, 7, -7, 9, 13] * 5)
    dodec = np.array([10, 7, 4, -4, -7, 10, -4, 7, -7, 4] * 2)
    trunc_oct = np.array([3, -7, 7, -3] * 6)
    for name, code in [("Levi", levi), ("dodecahedral", dodec),
                       ("truncated octahedral", trunc_oct)]:
        G = lcf_graph(code)
        S = G.to_sparse()
        ones = torch.ones(G.num_targets, dtype=dtype, device=device)
        deg = S.device_csr(device=device, dtype=dtype).matvec(ones)
        check(bool((deg == 3).all()), f"{name}: not 3-regular: {deg}")
        check(bool((np.diff(G.rowptr) == 3).all()), f"{name}: rowptr")
        Ss = S.to_scipy()
        check((Ss != Ss.T).nnz == 0, f"{name}: adjacency not symmetric")
        fig = spy(S, title=f"{name} graph")
        if fig is not None:
            import matplotlib.pyplot as plt
            plt.close(fig)
        output(f"{name} graph: {G.num_sources} vertices, "
               f"{G.num_edges // 2} undirected edges, 3-regular"
               + ("" if fig is None else " (spy rendered)"))


if __name__ == "__main__":
    main()
