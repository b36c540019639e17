"""K1 (``kernels/extend_add``, ``csrc/extend_add.cu``): the bytes one
factor's extend-add must move, and its share of the roofline.

The values only, as PERF.md's K1 bound counts them: each source read once,
each destination read and written once, over the levels of the run plan
(``EAPlan``: per level its pairs and its unique destinations).  The plan's
index arrays are not counted: a kernel could take them from anywhere."""

KERNEL = "extend_add"


def values_bytes(levels, itemsize):
    """levels: (pairs, unique destinations) per level of one factor."""
    return sum(p * itemsize + 2 * d * itemsize for p, d in levels)


def roofline_percent(w, unit):
    """K1's least time over its device time in the traced window, in %:
    the factors in the window (K1 launches over the plan's levels) times
    one factor's value bytes at the card's HBM rate."""
    levels = w.info.get("k1_levels")
    launches = w.counters.get("k1_launches", 0)
    if (w.trace is None or w.peaks is None or not levels or not launches
            or not w.units.get(unit)):
        return None
    t = w.trace.device_seconds(KERNEL)
    if t <= 0:
        return None
    factors = launches / len(levels)
    least = factors * values_bytes(levels, w.info["itemsize"]) \
        / w.peaks.hbm_bytes_per_s
    return 100.0 * least / t
