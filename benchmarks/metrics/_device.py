"""What the device-trace metrics share: device operations per unit of work,
and the idle share of the traced window."""


def ops_per(w, unit):
    n = w.units.get(unit, 0)
    if w.trace is None or not n:
        return None
    ops = w.trace.device_ops()
    return ops / n if ops else None


def idle_percent(w, unit):
    """100·(1 − busy/window): busy is the union of the device operations'
    intervals in the traced window; None unless the window did ``unit``
    work and the device ran something."""
    if w.trace is None or not w.units.get(unit) or w.trace.window_s <= 0:
        return None
    busy = w.trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / w.trace.window_s)
