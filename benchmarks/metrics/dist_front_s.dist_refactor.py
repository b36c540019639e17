"""dist_front_s.dist_refactor: the summed seconds of the program's
``el.ldl.front.dist`` spans (the levels whose few large fronts are each
cut into row blocks over every position, ``sparse_direct.dist_front``) in
the traced window, per ``el.ldl.factor`` span."""

import numpy as np

from metrics import _spans


def read(w):
    factors = _spans.intervals(w, _spans.named("el.ldl.factor"))
    span = _spans.intervals(w, _spans.named("el.ldl.front.dist"))
    if factors is None or span is None:
        return None
    return float(np.sum(span[1] - span[0])) / factors[0].size
