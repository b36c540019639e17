"""split_s.dist_refactor: the summed seconds of the program's
``el.ldl.front.split`` spans (the levels whose batch is split into chunks
over the positions, ``sparse_direct.numeric._shard_level``) in the traced
window, per ``el.ldl.factor`` span."""

import numpy as np

from metrics import _spans


def read(w):
    factors = _spans.intervals(w, _spans.named("el.ldl.factor"))
    span = _spans.intervals(w, _spans.named("el.ldl.front.split"))
    if factors is None or span is None:
        return None
    return float(np.sum(span[1] - span[0])) / factors[0].size
