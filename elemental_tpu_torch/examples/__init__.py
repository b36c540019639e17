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
