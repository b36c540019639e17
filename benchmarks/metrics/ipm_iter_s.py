"""ipm_iter_s: the window's seconds over the IPM iterations its calls
completed (each call pays its own KKT build and analysis)."""


def read(w):
    iters = w.units.get("iterations", 0)
    return w.elapsed_s / iters if iters else None
