"""refactor_wall_s: the traced window's seconds over its refactor requests
(new values on the fixed pattern, the factor, one solve), on the host clock
under the profiler."""


def read(w):
    n = w.units.get("refactors", 0)
    return w.elapsed_s / n if n else None
