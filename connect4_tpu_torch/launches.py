"""Launch counts of the hand-written kernels, kept right under CUDA graphs.

A kernel's wrapper counts a launch with ``count(record, *args)``:
``record(*args)`` adds the launch to the wrapper's own counters. A launch
made while a CUDA graph is captured runs only when the graph is replayed,
so inside ``captured()`` the call is logged instead, and ``replay(log)``
makes it once for each replay of that graph. One log holds every kernel's
launches of a graph.
"""

from __future__ import annotations

import contextlib

# the logs of the CUDA graphs being captured, innermost last
_CAPTURING = []


def count(record, *args) -> None:
    """``record(*args)`` now, or, while a CUDA graph is captured, at each
    of its replays."""
    if _CAPTURING:
        _CAPTURING[-1].append((record, args))
    else:
        record(*args)


@contextlib.contextmanager
def captured():
    """Around the capture of a CUDA graph: yields the log of the launches
    captured, ``[(record, args)]``, which are not counted."""
    log = []
    _CAPTURING.append(log)
    try:
        yield log
    finally:
        _CAPTURING.pop()


def replay(log) -> None:
    """Count the launches of ``log`` (from ``captured``), once for a replay
    of the graph they were captured into."""
    for record, args in log:
        record(*args)
