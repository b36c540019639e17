"""Reduction of a ``torch.profiler`` trace to what the per-layer metrics
read: the device's busy intervals inside the measured window, the device
operations by name, and the idle gaps labelled by what the host was doing.

The raw kineto events are read (``kineto_results.events()``), not
``key_averages()``: the event tree of a window with millions of launches
takes minutes to build."""

from __future__ import annotations

import dataclasses
import functools
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW_SPAN = "bench.window"
NAME_CHARS = 160
# kineto activity types: what ran on the device, and what the host did
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPAN = ("user_annotation",)
HOST_EVENTS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Trace:
    """Device operations and host events of one traced window, times in
    seconds from the window's start."""
    window_s: float
    dev_start: np.ndarray
    dev_end: np.ndarray
    dev_name: List[str]
    host_start: np.ndarray
    host_end: np.ndarray
    host_name: List[str]
    spans: List[Tuple[str, float, float]]   # the benchmark's own spans

    def busy_s(self) -> float:
        return busy_union(self.dev_start, self.dev_end, 0.0, self.window_s)

    @functools.cached_property
    def _codes(self) -> Tuple[List[str], np.ndarray]:
        """The device operations' distinct names, and each one's index."""
        index: Dict[str, int] = {}
        codes = np.fromiter((index.setdefault(n, len(index))
                             for n in self.dev_name), np.int64,
                            len(self.dev_name))
        return list(index), codes

    def _matching(self, substring: str) -> np.ndarray:
        names, codes = self._codes
        return np.array([substring in n for n in names] or [False],
                        bool)[codes]

    def device_ops(self) -> int:
        """Device operations (kernels, copies, sets) that start in the
        window."""
        return int(((self.dev_start >= 0)
                    & (self.dev_start < self.window_s)).sum())

    def _clipped(self) -> np.ndarray:
        return (np.clip(self.dev_end, 0.0, self.window_s)
                - np.clip(self.dev_start, 0.0, self.window_s))

    def device_seconds(self, substring: str) -> float:
        """Summed device time of the operations whose name holds
        ``substring``, clipped to the window."""
        return float(self._clipped()[self._matching(substring)].sum())

    def top_device_ops(self, k: int = 10) -> List[List]:
        names, codes = self._codes
        if not names:
            return []
        total = np.bincount(codes, weights=self._clipped(),
                            minlength=len(names))
        by: Dict[str, float] = defaultdict(float)
        for name, t in zip(names, total.tolist()):
            by[name[:NAME_CHARS]] += t
        return [[n, t] for n, t in sorted(by.items(), key=lambda v: -v[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The window's idle time by what the host was doing at the middle
        of each gap: the innermost host event open there (under the
        benchmark's own span), summed by label, longest first."""
        starts, ends = gaps(self.dev_start, self.dev_end, 0.0, self.window_s)
        if starts.size == 0:
            return []
        mids = 0.5 * (starts + ends)
        labels = innermost(self.host_start, self.host_end, self.host_name,
                           mids)
        by: Dict[str, float] = defaultdict(float)
        for t, label, length in zip(mids.tolist(), labels,
                                    (ends - starts).tolist()):
            outer = [n for n, s, e in self.spans if s <= t <= e][-1:]
            by[" > ".join(outer + [label[:NAME_CHARS]])] += length
        return [[n, t] for n, t in sorted(by.items(), key=lambda v: -v[1])[:k]]


def innermost(starts, ends, names, times) -> List[str]:
    """For each of the sorted ``times``, the name of the latest-starting
    host event still open at that time (events on one thread nest), or
    "python (no operator)": one sweep with a stack of open events."""
    order = np.argsort(starts, kind="stable")
    s, e = np.asarray(starts)[order].tolist(), np.asarray(ends)[order]
    e = e.tolist()
    out, stack, i = [], [], 0
    for t in np.asarray(times).tolist():
        while i < len(s) and s[i] <= t:
            while stack and e[stack[-1]] < s[i]:
                stack.pop()
            stack.append(i)
            i += 1
        while stack and e[stack[-1]] < t:
            stack.pop()
        out.append(names[order[stack[-1]]] if stack
                   else "python (no operator)")
    return out


def busy_union(starts: np.ndarray, ends: np.ndarray, lo: float,
               hi: float) -> float:
    """Length of the union of the intervals [starts, ends), clipped to
    [lo, hi)."""
    s = np.clip(np.asarray(starts, float), lo, hi)
    e = np.clip(np.asarray(ends, float), lo, hi)
    if s.size == 0:
        return 0.0
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    # an interval adds what reaches past the furthest end before it
    prev = np.concatenate([[lo], e[:-1]])
    return float(np.sum(np.clip(e - np.maximum(s, prev), 0.0, None)))


def gaps(starts: np.ndarray, ends: np.ndarray, lo: float,
         hi: float) -> Tuple[np.ndarray, np.ndarray]:
    """The idle intervals of [lo, hi) that no interval covers."""
    s = np.clip(np.asarray(starts, float), lo, hi)
    e = np.clip(np.asarray(ends, float), lo, hi)
    if s.size == 0:
        return np.array([lo]), np.array([hi])
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    prev = np.concatenate([[lo], e])
    nxt = np.concatenate([s, [hi]])
    idle = nxt > prev
    return prev[idle], nxt[idle]


def from_profiler(prof) -> Trace:
    """The window's events from a stopped ``torch.profiler.profile``."""
    import torch
    return from_events(prof.profiler.kineto_results.events(),
                       torch.autograd.DeviceType.CUDA)


def from_events(events, cuda) -> Trace:
    """The window's device operations, host events and the benchmark's
    spans, in one pass over the raw events (some ten million in a traced
    LP window: four calls an event).  Torch releases without
    ``activity_type()`` tell a device operation from a device range by
    its name: the only ranges are the benchmark's own (``bench.*``)."""
    win = None
    dev, host, spans = [], [], []
    typed = bool(events) and hasattr(events[0], "activity_type")
    in_ns = not events or hasattr(events[0], "start_ns")
    for e in events:
        name = e.name()
        if in_ns:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        else:
            start = e.start_us() * 1000
            end = start + e.duration_us() * 1000
        if typed:
            kind = e.activity_type()
            if kind in DEVICE_OPS:
                dev.append((start, end, name))
                continue
            if kind not in HOST_EVENTS:
                continue
            is_span = kind in HOST_SPAN and name.startswith("bench.")
        elif e.device_type() == cuda:
            if not name.startswith("bench."):
                dev.append((start, end, name))
            continue
        else:
            is_span = name.startswith("bench.")
        if not is_span:
            host.append((start, end, name))
        elif name == WINDOW_SPAN:
            win = (start, end - start)
        else:
            spans.append((name[len("bench."):], start, end))
    if win is None:
        raise RuntimeError(f"trace: no {WINDOW_SPAN!r} span")
    t0 = win[0]

    def arrays(rows):
        if not rows:
            return np.zeros(0), np.zeros(0), []
        a, b, n = zip(*rows)
        # whole nanoseconds until t0 is out: a float64 of ~1e18 ns since
        # the epoch keeps only ~256 ns
        return ((np.asarray(a, np.int64) - int(t0)) * 1e-9,
                (np.asarray(b, np.int64) - int(t0)) * 1e-9, list(n))

    ds, de, dn = arrays(dev)
    hs, he, hn = arrays(host)
    spans = [(n, (a - t0) * 1e-9, (b - t0) * 1e-9) for n, a, b in spans]
    return Trace(win[1] * 1e-9, ds, de, dn, hs, he, hn, spans)
