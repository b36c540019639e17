"""peer_gb.dist_refactor: the gigabytes (10^9 bytes) the factor copied
between distinct devices in the window (the program's counter
``utils.transfers.peer_bytes``, its window delta), per refactor.  None
where the program does not count them."""


def read(w):
    n = w.units.get("refactors", 0)
    b = w.counters.get("peer_bytes")
    if b is None or not n:
        return None
    return b / n / 1e9
