"""front_launches.refactor: kernel launches from inside the program's
``el.ldl.front.*`` spans (each level's front factor: ``rank1``,
``blocked``, ``spd``, ``dist``, ``split``), per ``el.ldl.factor`` span.  A
launch is a CUDA runtime or driver event of ``_spans.LAUNCHES``.  Of
``kernels_per_factor.refactor``, the share the front kernels issue; the
rest is the assembly, K1, the pivots' gather and the solve.  None where the
trace holds no CUDA runtime events (no card)."""

from metrics import _spans


def read(w):
    factors = _spans.intervals(w, _spans.named("el.ldl.factor"))
    fronts = _spans.intervals(w, lambda n: n.startswith("el.ldl.front."))
    if factors is None or fronts is None or not _spans.cuda_seen(w):
        return None
    return _spans.starting_inside(w, _spans.LAUNCHES.__contains__,
                                  fronts) / factors[0].size
