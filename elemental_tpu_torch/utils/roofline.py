"""Roofline audit helpers (counterpart of ``elemental_tpu/utils/
roofline.py``): a kernel's time against the least time the card could take
for the same bytes and operations.

Usage::

    from elemental_tpu_torch.utils.roofline import audit
    report = audit(fn, x0, flops=..., bytes_accessed=...)
    # report.sol_fraction, report.achieved_flops, report.bound

``CHIPS`` holds NVIDIA's data-sheet peaks of the H100 (dense rates, no
sparsity, at the full power limit): HBM bytes/s, float32 on the CUDA
cores, float64 and bfloat16 on the tensor cores.  :func:`chip_specs`
raises on a device it has no entry for, rather than put another chip's
peak beside this one's time.  Timing is the dependent-chain slope
(:func:`marginal_time`): sweeps of two lengths remove the fixed launch
cost; on the card each sweep is timed with CUDA events.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class ChipSpec:
    name: str
    hbm_bw: float          # B/s
    peak_f32: float        # FLOP/s, float32 on the CUDA cores (no TF32)
    peak_bf16: float       # FLOP/s, bfloat16 tensor cores (dense)
    peak_f64: float        # FLOP/s, float64 tensor cores


_H100_SXM = ChipSpec("H100 SXM", 3.35e12, 67e12, 989e12, 67e12)
_H100_PCIE = ChipSpec("H100 PCIe", 2.0e12, 51e12, 756e12, 51e12)

# keys are matched against the lower-cased device name, in this order
CHIPS = {
    "h100 pcie": _H100_PCIE,
    "h100 sxm": _H100_SXM,
    "h100 80gb hbm3": _H100_SXM,     # the SXM part, as the card names it
}


def chip_specs() -> ChipSpec:
    """The spec of the current CUDA device, found by its name; raises on a
    CPU-only host and on a device with no entry."""
    if not torch.cuda.is_available():
        raise RuntimeError("chip_specs: no CUDA device")
    kind = torch.cuda.get_device_name()
    for key, spec in CHIPS.items():
        if key in kind.lower():
            return spec
    raise LookupError(f"chip_specs: no peaks known for {kind!r}")


@dataclasses.dataclass
class RooflineReport:
    seconds: float
    achieved_flops: float
    achieved_bw: float
    bound: str              # 'memory' or 'compute'
    sol_seconds: float
    sol_fraction: float

    def __str__(self):
        return (f"{self.seconds * 1e6:.1f} us | "
                f"{self.achieved_flops / 1e12:.2f} TFLOP/s, "
                f"{self.achieved_bw / 1e9:.0f} GB/s | {self.bound}-bound, "
                f"{100 * self.sol_fraction:.1f}% of SoL")


def _chain_seconds(fn: Callable, x0, reps: int) -> float:
    """Seconds of ``reps`` dependent applications x ← fn(x) from x0 (CUDA
    events on the card, the host clock for a CPU tensor)."""
    def run():
        x = x0
        for _ in range(reps):
            x = fn(x)
        return x

    if x0.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def marginal_time(fn: Callable, x0, r1: int = 20, r2: int = 100,
                  tries: int = 3) -> float:
    """Seconds of one application of ``fn`` (x → x-like): the slope
    between dependent chains of ``r1`` and ``r2`` applications, each the
    best of ``tries`` after a warm-up chain."""
    def sweep(reps):
        _chain_seconds(fn, x0, reps)
        return min(_chain_seconds(fn, x0, reps) for _ in range(tries))

    t1, t2 = sweep(r1), sweep(r2)
    return max((t2 - t1) / (r2 - r1), 1e-12)


def audit(fn: Callable, x0, flops: float, bytes_accessed: float,
          dtype=torch.float32, chain: bool = True,
          seconds: Optional[float] = None, *,
          spec: Optional[ChipSpec] = None) -> RooflineReport:
    """Roofline-audit a self-composable kernel (fn: x → x-like) against
    ``spec`` (:func:`chip_specs` of the current card by default)."""
    spec = chip_specs() if spec is None else spec
    if seconds is None:
        seconds = marginal_time(fn, x0) if chain else _simple_time(fn, x0)
    peak = {torch.bfloat16: spec.peak_bf16,
            torch.float64: spec.peak_f64}.get(dtype, spec.peak_f32)
    t_mem = bytes_accessed / spec.hbm_bw
    t_cmp = flops / peak
    sol = max(t_mem, t_cmp)
    return RooflineReport(
        seconds=seconds,
        achieved_flops=flops / seconds,
        achieved_bw=bytes_accessed / seconds,
        bound="memory" if t_mem >= t_cmp else "compute",
        sol_seconds=sol,
        sol_fraction=sol / seconds,
    )


def _simple_time(fn, x0, reps: int = 20) -> float:
    """Seconds of one independent application, averaged over ``reps``."""
    fn(x0)
    return _chain_seconds(lambda x: (fn(x0), x)[1], x0, reps) / reps
