"""Drivers of the port, counterparts of the repository's ``examples/``:

    python -m elemental_tpu_torch.examples.<name> [--device cuda] [--dtype float32]

Each takes its inputs through :class:`..core.environment.Args`, runs on
``--device`` (default ``cuda``) in ``--dtype`` and checks its own answer
(:func:`check`), with the JAX package's drivers' thresholds.  Those run in
float64 on a host, so the drivers of the conic and sparse tiers default to
float64.
"""

import torch

from ..core.environment import Args
from ..core.policy import effective_dtype


def check(ok, what: str) -> None:
    """A driver's self-check: raises ``AssertionError(what)`` unless
    ``ok``."""
    if not ok:
        raise AssertionError(what)


def device_and_dtype(args: Args, dtype: str = "float32"):
    """Register ``--device`` (default cuda) and ``--dtype`` on ``args``
    (before ``process_input``); returns a function that reads them back as
    (torch.device, torch.dtype)."""
    args.input("device", "torch device to run on", "cuda")
    args.input("dtype", "working dtype", dtype)
    return lambda: (torch.device(args["device"]),
                    effective_dtype(args["dtype"]))


def tolerance(dtype: torch.dtype, tol64: float, tol32: float = 1e-4) -> float:
    """A driver's threshold: the JAX driver's (float64) one in float64 and
    complex128, ``tol32`` in float32 and complex64."""
    return tol64 if dtype in (torch.float64, torch.complex128) else tol32
