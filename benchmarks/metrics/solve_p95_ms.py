"""solve_p95_ms: the 95th percentile (nearest rank) of all solve latencies
of the window, each on the host clock to its synchronisation."""

import math


def nearest_rank(values, q):
    """The value at rank ceil(q·n) of the sorted values."""
    v = sorted(values)
    return v[max(1, math.ceil(q * len(v))) - 1]


def read(w):
    if not w.units.get("solves") or not w.latencies_s:
        return None
    return 1e3 * nearest_rank(w.latencies_s, 0.95)
