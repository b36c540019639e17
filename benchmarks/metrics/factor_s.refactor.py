"""factor_s.refactor: the mean seconds of the program's ``el.ldl.factor``
spans (``sparse_direct.numeric.factor``, which ``change_nonzero_values``
runs) in the traced window, on the host clock: the refactor without the
values' copy and the solve that ``refactor_wall_s`` includes."""

import numpy as np

from metrics import _spans


def read(w):
    span = _spans.intervals(w, _spans.named("el.ldl.factor"))
    if span is None:
        return None
    return float(np.mean(span[1] - span[0]))
