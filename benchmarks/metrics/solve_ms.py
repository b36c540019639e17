"""solve_ms: the window's milliseconds over its solves against a finished
factor."""


def read(w):
    n = w.units.get("solves", 0)
    return 1e3 * w.elapsed_s / n if n else None
