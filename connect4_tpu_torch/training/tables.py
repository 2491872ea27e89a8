"""The training loop's metric tables, stored without pandas.

The loop keeps three tables in ``save_dir``, one row per evaluation, with
the names and columns of the JAX package's pandas pickles (``8ply``,
``7ply``, ``match_results``). Here each is a JSON file, ``<name>.json``,
holding the list of row dicts, so that a run needs neither pandas nor
pickle: ``pandas.DataFrame(load_table(save_dir, "8ply"))`` gives the frame
the JAX package would have pickled, except that the keys of the ``correct``
column's dicts (the buckets 0.0, 0.5, 1.0) are strings, as JSON has them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List

Row = Dict[str, Any]


def table_path(save_dir: str, name: str) -> str:
    return os.path.join(save_dir, f"{name}.json")


def load_table(save_dir: str, name: str) -> List[Row]:
    """The rows of ``<save_dir>/<name>.json``; no rows when it is absent."""
    path = table_path(save_dir, name)
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return json.load(fh)


def save_table(save_dir: str, name: str, rows: List[Row]) -> str:
    """Write the rows, to a temporary name first so that a reader (or a
    crash) never finds half a file."""
    path = table_path(save_dir, name)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(rows, fh, indent=1, default=float)
    os.replace(tmp, path)
    return path
