"""Drivers of the port, counterparts of the repository's ``examples/``:

    python -m elemental_tpu_torch.examples.<name> [--device cuda] [--dtype float32]

Each takes its inputs through :class:`..core.environment.Args`, runs on
``--device`` (default ``cuda``) in ``--dtype`` and checks its own answer.
"""

import torch

from ..core.environment import Args
from ..core.policy import effective_dtype


def device_and_dtype(args: Args, dtype: str = "float32"):
    """Register ``--device`` (default cuda) and ``--dtype`` on ``args``
    (before ``process_input``); returns a function that reads them back as
    (torch.device, torch.dtype)."""
    args.input("device", "torch device to run on", "cuda")
    args.input("dtype", "working dtype", dtype)
    return lambda: (torch.device(args["device"]),
                    effective_dtype(args["dtype"]))
