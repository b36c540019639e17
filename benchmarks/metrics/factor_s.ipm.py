"""factor_s.ipm: seconds of the program's ``el.ldl.factor`` spans (the
multifrontal numeric factor, ``sparse_direct.numeric.factor``) per IPM
iteration, on the host clock of the traced window.  Every factor a call
takes counts: one an iteration, the Θ = I start's, and any taken again
for a zero pivot (``el.kkt.factor_retake``)."""

from metrics import _spans


def read(w):
    return _spans.seconds_per(w, "el.ldl.factor", "iterations")
