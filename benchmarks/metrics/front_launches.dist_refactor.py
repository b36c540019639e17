"""front_launches.dist_refactor: ``front_launches.refactor``'s reading
(kernel launches from inside the program's ``el.ldl.front.*`` spans, per
``el.ldl.factor`` span) on the four-card refactor, where the spans hold
every card's launches: ``dist``, ``split`` and the one-device kinds."""

from pathlib import Path

from harness.core import load_module

read = load_module(Path(__file__).with_name("front_launches.refactor.py")).read
