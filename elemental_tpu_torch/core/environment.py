"""Environment: init, blocksize stacks, CLI args, logging (counterpart of
``elemental_tpu/core/environment.py``).

Mirrors the reference's ``El::Initialize`` pipeline
(``src/core/environment.cpp:215-330``) and its configuration layers
(SURVEY §5): the ``Input``/``ProcessInput`` CLI registry
(``include/El/core/environment/decl.hpp:52-88``) and the runtime blocksize
stack (``src/blas_like/blocksizes.cpp:16-107``).

The port runs one process that sees every device, as the JAX package does
on one host: there is no ``MPI_Init`` and no distributed runtime to start.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import Any, Dict, List, Optional

from .grid import Grid

logger = logging.getLogger("elemental_tpu_torch")

_initialized = False

# --------------------------------------------------------------------------
# Blocksize stacks (reference ``src/blas_like/blocksizes.cpp``): a global
# stack plus per-kernel local stacks consulted by blocked algorithms.
# --------------------------------------------------------------------------

_DEFAULT_BLOCKSIZE = 128  # the reference pushes 128 too
_blocksize_stack: List[int] = [_DEFAULT_BLOCKSIZE]
_local_blocksizes: Dict[str, List[int]] = {}


def blocksize(kernel: Optional[str] = None) -> int:
    if kernel is not None and _local_blocksizes.get(kernel):
        return _local_blocksizes[kernel][-1]
    return _blocksize_stack[-1]


def set_blocksize(nb: int) -> None:
    _blocksize_stack[-1] = nb


def push_blocksize_stack(nb: int) -> None:
    _blocksize_stack.append(nb)


def pop_blocksize_stack() -> int:
    if len(_blocksize_stack) <= 1:
        raise RuntimeError("cannot pop the last blocksize")
    return _blocksize_stack.pop()


def set_local_blocksize(kernel: str, nb: int) -> None:
    _local_blocksizes.setdefault(kernel, []).append(nb)


# --------------------------------------------------------------------------
# Init / finalize
# --------------------------------------------------------------------------

def initialize() -> None:
    """Initialise the runtime (reference ``El::Initialize``): the default
    grid is rebuilt lazily from the visible CUDA devices and the RNG is
    seeded with 0."""
    global _initialized
    if _initialized:
        return
    Grid.set_default(None)
    from . import random_ as _random
    _random.seed(0)
    _initialized = True


def initialized() -> bool:
    return _initialized


def finalize() -> None:
    global _initialized
    _initialized = False


# --------------------------------------------------------------------------
# CLI flag registry (reference Input/ProcessInput/PrintInputReport)
# --------------------------------------------------------------------------

class Args:
    """Typed CLI flag registry: ``Input(name, desc, default)`` then
    ``ProcessInput()`` — every driver doubles as a benchmark/repro tool
    exactly like the reference's (``decl.hpp:67-88``)."""

    def __init__(self, argv: Optional[List[str]] = None):
        self._parser = argparse.ArgumentParser(add_help=False)
        self._argv = argv if argv is not None else sys.argv[1:]
        self._values: Dict[str, Any] = {}
        self._descs: Dict[str, str] = {}

    def input(self, name: str, desc: str, default: Any) -> None:
        flag = "--" + name.lstrip("-")
        kwargs: Dict[str, Any] = {"help": desc, "default": default}
        if isinstance(default, bool):
            kwargs["type"] = lambda s: s.lower() in ("1", "true", "yes")
        else:
            kwargs["type"] = type(default)
        self._parser.add_argument(flag, **kwargs)
        self._descs[name.lstrip("-")] = desc

    def process_input(self) -> None:
        ns, _ = self._parser.parse_known_args(self._argv)
        self._values = vars(ns)

    def __getitem__(self, name: str) -> Any:
        return self._values[name.lstrip("-")]

    def print_report(self) -> None:
        output("Input report:")
        for k, v in self._values.items():
            output(f"  --{k} = {v!r}   ({self._descs.get(k, '')})")


_args: Optional[Args] = None


def args() -> Args:
    global _args
    if _args is None:
        _args = Args()
    return _args


# --------------------------------------------------------------------------
# Output / logging (reference Output/OutputFromRoot)
# --------------------------------------------------------------------------

_indent = 0


def output(*parts: Any) -> None:
    print(" " * _indent + " ".join(str(p) for p in parts))


def output_from_root(*parts: Any) -> None:
    """One controlling process: every output is the root's."""
    output(*parts)


def push_indent(n: int = 2) -> None:
    global _indent
    _indent += n


def pop_indent(n: int = 2) -> None:
    global _indent
    _indent = max(0, _indent - n)


class Timer:
    """Reference ``Timer`` (``include/El/core/Timer.hpp:23-39``): host
    clock; synchronise the device before ``stop`` to time device work."""

    def __init__(self, name: str = ""):
        self.name = name
        self._start: Optional[float] = None
        self.total = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer not started")
        dt = time.perf_counter() - self._start
        self.total += dt
        self._start = None
        return dt

    def partial(self) -> float:
        return (time.perf_counter() - self._start
                if self._start is not None else 0.0)
