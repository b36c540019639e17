"""fgmres_sweeps.ipm: the program's ``el.kkt.solve_refined`` spans per IPM
iteration: each of an iteration's direction solves is one FGMRES sweep
plus one for each restart on the true residual; the start's two solves
count too."""

from metrics import _spans


def read(w):
    return _spans.count_per(w, "el.kkt.solve_refined", "iterations")
