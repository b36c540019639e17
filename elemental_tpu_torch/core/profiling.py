"""Profiling/tracing (counterpart of ``elemental_tpu/core/profiling.py``;
reference ``include/El/core/Profiling.hpp:138-190``: region annotation
+ synchronizing profiling).

A region is active while a ``torch.profiler`` records (:func:`start_trace`,
or any profiler a caller runs) or after ``enable_profiling(True)``; an
inactive :func:`profile_region` returns one shared null context, so a region
on a hot path costs one check.  An active region is a profiler range on the
clock the profiler's device trace shares, and adds its host time to
:func:`stage_times`.  The range is recorded as a host operator
(``torch._C._profiler._RecordFunctionFast``, a ``cpu_op`` in the trace), not
as a ``record_function`` user annotation: the profiler projects a user
annotation onto the device timeline over the kernels launched inside it,
and a trace whose events carry no activity type (torch 2.11) cannot tell
that projection from a device operation.  NVTX ranges, for NVTX-reading
tools, are pushed only under an explicit ``enable_profiling(True)``.
Synchronizing mode waits for the card at each active region's end
(``torch.cuda.synchronize``), so the host timers measure device time.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Dict, Optional

import torch

_enabled = False
_sync = False  # synchronizing profiling (HYDROGEN_DEFAULT_SYNC_PROFILING)
_stage_times: Dict[str, float] = {}
_trace: Optional[tuple] = None
_NULL = contextlib.nullcontext()
_profiler_recording = torch.autograd._profiler_enabled
_host_range = torch._C._profiler._RecordFunctionFast


def enable_profiling(on: bool = True) -> None:
    """Make every region active, with NVTX ranges where a card is present
    (without it, regions are active only while a profiler records)."""
    global _enabled
    _enabled = on


def enable_sync_profiling(on: bool = True) -> None:
    """Block until device work completes at region ends, so host timers
    measure device time (reference synchronizing profiling)."""
    global _sync
    _sync = on


class _Region:
    """One active region: a profiler range, an NVTX range when ``nvtx``,
    and its host time added to :func:`stage_times`."""

    __slots__ = ("name", "nvtx", "range", "t0")

    def __init__(self, name: str, nvtx: bool):
        self.name = name
        self.nvtx = nvtx

    def __enter__(self):
        self.t0 = time.perf_counter()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.range = _host_range(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        try:
            self.range.__exit__(*exc)
        finally:
            if self.nvtx:
                torch.cuda.nvtx.range_pop()
            if _sync and torch.cuda.is_available():
                torch.cuda.synchronize()
            _stage_times[self.name] = (_stage_times.get(self.name, 0.0)
                                       + time.perf_counter() - self.t0)
        return False


def profile_region(name: str):
    """Region annotation (reference ``AUTO_PROFILE_REGION``), used as
    ``with profile_region("el.layer"):``; the shared null context unless a
    profiler records or profiling is enabled."""
    if _enabled:
        return _Region(name, torch.cuda.is_available())
    if _profiler_recording():
        return _Region(name, False)
    return _NULL


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
