"""Profiling/tracing (counterpart of ``elemental_tpu/core/profiling.py``;
reference ``include/El/core/Profiling.hpp:138-190``: NVTX region annotation
+ synchronizing profiling).

Regions are ``torch.profiler.record_function`` ranges, and NVTX ranges
where a CUDA device is present, so both a ``torch.profiler`` trace and an
NVTX-reading tool see them.  Synchronizing mode waits for the card at each
region's end (``torch.cuda.synchronize``), so the host timers measure device
time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch

_enabled = True
_sync = False  # synchronizing profiling (HYDROGEN_DEFAULT_SYNC_PROFILING analog)
_stage_times: Dict[str, float] = {}
_trace: Optional[tuple] = None


def enable_profiling(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enable_sync_profiling(on: bool = True) -> None:
    """Block until device work completes at region ends, so host timers
    measure device time (reference synchronizing profiling)."""
    global _sync
    _sync = on


@contextlib.contextmanager
def profile_region(name: str, color: Optional[int] = None):
    """RAII region annotation (reference ``AUTO_PROFILE_REGION``)."""
    if not _enabled:
        yield
        return
    cuda = torch.cuda.is_available()
    t0 = time.perf_counter()
    if cuda:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if cuda:
            torch.cuda.nvtx.range_pop()
            if _sync:
                torch.cuda.synchronize()
        _stage_times[name] = (_stage_times.get(name, 0.0)
                              + time.perf_counter() - t0)


def profiled(name: Optional[str] = None):
    def deco(fn):
        region = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with profile_region(region):
                return fn(*a, **k)
        return wrapper
    return deco


def stage_times() -> Dict[str, float]:
    """Accumulated per-region host times (the analog of the reference's
    ``timeStages`` solver reports, ``HermitianEig.cpp:943-1056``)."""
    return dict(_stage_times)


def reset_stage_times() -> None:
    _stage_times.clear()


def start_trace(logdir: str) -> None:
    """Start a ``torch.profiler`` trace (CPU, and CUDA where present);
    :func:`stop_trace` writes it to ``logdir`` as a Chrome trace."""
    global _trace
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _trace = (prof, logdir)


def stop_trace() -> str:
    """Stop the trace and write it; returns the file's path."""
    global _trace
    if _trace is None:
        raise RuntimeError("no trace was started")
    prof, logdir = _trace
    _trace = None
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path
