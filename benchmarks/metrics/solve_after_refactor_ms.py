"""solve_after_refactor_ms: the milliseconds of all the window's solves
against a factor just refactored, each from the factor's synchronisation to
its own, over those solves."""


def read(w):
    n = w.units.get("refactors", 0)
    t = w.units.get("solve_after_refactor_s", 0.0)
    return 1e3 * t / n if n and t > 0 else None
