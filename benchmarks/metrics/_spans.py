"""What the program-span metrics share.  The program opens a profiler
range named ``el.<layer>`` at each layer boundary while a profiler records
(``elemental_tpu_torch.core.profiling``; a host operator, so it has no
device-side projection); the trace keeps those ranges among its host
events, on the one clock of the device operations.  Here: a span's intervals by exact name, the host
events that start inside a set of intervals, and the device's busy time
inside them."""

import weakref

import numpy as np

# CUDA runtime events in which the host waits for the device (a tensor's
# value read on the host is a copy and a cudaStreamSynchronize)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize"})
# CUDA runtime and driver events that launch a kernel
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"})

_index = [None, None]          # (weak reference to a trace, its index)


def _codes(tr):
    """The trace's distinct host event names, each one's index, and each
    event's index into them: one pass over the names, kept for the last
    trace read."""
    ref, idx = _index
    if ref is not None and ref() is tr:
        return idx
    names = {}
    codes = np.fromiter((names.setdefault(n, len(names))
                         for n in tr.host_name), np.int64,
                        len(tr.host_name))
    _index[:] = [weakref.ref(tr), (names, codes)]
    return names, codes


def events(tr, match):
    """Boolean mask of the host events whose name satisfies ``match``."""
    names, codes = _codes(tr)
    hit = np.array([bool(match(n)) for n in names] or [False], bool)
    return hit[codes] if codes.size else np.zeros(0, bool)


def intervals(w, match):
    """The (starts, ends) of the window's host events whose name satisfies
    ``match``, by start; None without a trace or without such an event."""
    if w.trace is None:
        return None
    m = events(w.trace, match)
    if not m.any():
        return None
    s, e = w.trace.host_start[m], w.trace.host_end[m]
    order = np.argsort(s, kind="stable")
    return s[order], e[order]


def named(name):
    return lambda n: n == name


def merged(s, e):
    """The union of the intervals [s, e) (sorted by start) as disjoint
    intervals: nested spans count once."""
    if s.size == 0:
        return s, e
    run = np.maximum.accumulate(e)
    new = np.concatenate([[True], s[1:] > run[:-1]])
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:], [s.size]]) - 1
    return s[first], run[last]


def starting_inside(w, match, span):
    """How many host events whose name satisfies ``match`` start inside
    the union of ``span``'s intervals."""
    ms, me = merged(*span)
    m = events(w.trace, match)
    t = w.trace.host_start[m]
    j = np.searchsorted(ms, t, side="right") - 1
    ok = j >= 0
    return int(np.sum(t[ok] < me[j[ok]]))


def busy_inside(w, span):
    """Seconds of the union of device operations inside the union of
    ``span``'s intervals."""
    tr = w.trace
    if not tr.dev_name:
        return 0.0
    order = np.argsort(tr.dev_start, kind="stable")
    ds, de = merged(tr.dev_start[order], tr.dev_end[order])
    cum = np.concatenate([[0.0], np.cumsum(de - ds)])

    def before(t):
        """Busy seconds before each time of ``t``."""
        j = np.searchsorted(ds, t, side="right")
        past = np.maximum(de[np.maximum(j - 1, 0)] - t, 0.0)
        return cum[j] - np.where(j > 0, past, 0.0)

    ms, me = merged(*span)
    return float(np.sum(before(me) - before(ms)))


def cuda_seen(w):
    """Whether the trace holds CUDA runtime events (a card was traced)."""
    names, _ = _codes(w.trace)
    return any(n.startswith("cuda") for n in names)


def seconds_per(w, name, unit):
    """Summed seconds of the span ``name`` over the window's ``unit``."""
    span = intervals(w, named(name))
    n = w.units.get(unit, 0)
    if span is None or not n:
        return None
    return float(np.sum(span[1] - span[0])) / n


def count_per(w, name, unit):
    span = intervals(w, named(name))
    n = w.units.get(unit, 0)
    if span is None or not n:
        return None
    return span[0].size / n
