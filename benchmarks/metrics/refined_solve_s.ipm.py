"""refined_solve_s.ipm: seconds of the program's ``el.kkt.solve_refined``
spans (one FGMRES sweep against the factored KKT each,
``optimization.kkt.KKTFactor.solve_refined``) per IPM iteration, on the host
clock of the traced window; the start's solves count too."""

from metrics import _spans


def read(w):
    return _spans.seconds_per(w, "el.kkt.solve_refined", "iterations")
