"""factor_idle.refactor: the device's idle share inside the program's
``el.ldl.factor`` spans, in %: 100·(1 − union of the device operations'
intervals inside the spans / the spans' summed length).  The factor's own
part of ``device_idle.refactor``; None where the trace holds no device
operation (no card)."""

import numpy as np

from metrics import _spans


def read(w):
    span = _spans.intervals(w, _spans.named("el.ldl.factor"))
    if span is None or not w.trace.dev_name:
        return None
    total = float(np.sum(span[1] - span[0]))
    if total <= 0:
        return None
    return 100.0 * (1.0 - _spans.busy_inside(w, span) / total)
