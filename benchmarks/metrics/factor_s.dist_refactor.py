"""factor_s.dist_refactor: ``factor_s.refactor``'s reading (the mean
seconds of the program's ``el.ldl.factor`` spans, on the host clock) on
the four-card refactor: the factor over the grid without the values' copy
and the solve."""

from pathlib import Path

from harness.core import load_module

read = load_module(Path(__file__).with_name("factor_s.refactor.py")).read
