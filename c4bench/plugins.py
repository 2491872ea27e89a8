"""Loading a file of the harness that a name in ``BENCHMARK.json`` or in a
configuration leads to: a per-layer metric's reader, an architecture's
reference or its program side. The name makes the path; no list of them is
kept anywhere, so a later architecture or metric is a new file alone."""

from __future__ import annotations

import importlib.util
import os
import re
import sys


def load(path: str, what: str):
    """The module in the file ``path``, executed once a process. Exits
    naming ``what`` where there is no such file."""
    key = "c4bench_file_" + re.sub(r"\W", "_", os.path.abspath(path))
    if key not in sys.modules:
        if not os.path.isfile(path):
            raise SystemExit(f"c4bench: no {what}: {os.path.relpath(path)} is missing")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules[key] = module
    return sys.modules[key]
