"""Finds a piece of the benchmark by the name that ``BENCHMARK.json``,
a configuration or a mix gives it: ``<kind>/<name>.py`` under this
folder, where ``kind`` is ``metrics``, ``families`` or ``loops``.  A later
cell brings its pieces as new files and edits none."""
from __future__ import annotations

import functools
import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def load(kind: str, name: str):
    """The module ``<kind>/<name>.py``."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in (HERE / kind).glob("*.py"))
        raise KeyError(f"no {kind}/{name}.py; have {have}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_" + re.sub(r"\W", "_", name), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
