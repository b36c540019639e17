"""kkt_build_s.ipm: seconds of the program's ``el.kkt.finalize`` span (the
KKT pattern's assembly, symbolic analysis and extend-add plan, and their
copy to the device: ``KKTBuilder.finalize``) per ``lp_direct`` call, on the
host clock of the traced window."""

from metrics import _spans


def read(w):
    return _spans.seconds_per(w, "el.kkt.finalize", "calls")
