"""The port's tracing layer: launch counts that stay right under CUDA
graphs, the program's spans with their marks on the card, and counters
kept on the card.

Launch counts. A kernel's wrapper counts a launch with ``count(record,
*args)``: ``record(*args)`` adds the launch to the wrapper's own counters.
A launch made while a CUDA graph is captured runs only when the graph is
replayed, so inside ``captured()`` the call is logged instead, and
``replay(log)`` makes it once for each replay of that graph. One log holds
every kernel's launches of a graph, the marks and counter updates below
among them.

Spans. ``SPANS`` names every span of the program. ``span(name, device)``
holds a block in a profiler range of that name on the host
(``record_function``: a few microseconds without a profiler). While tracing
is on (``tracing(True)``) and ``device`` is a CUDA device, the span first
launches its mark on the current stream: ``span_mark<i>``, an empty kernel
of ``mcts/csrc/span_mark.cu`` (``i`` the span's index in ``SPANS``). A mark
captured into a CUDA graph runs at every replay, so a device trace shows
where each span starts on the card even where no host range can, inside a
replayed graph. ``partition(device)`` holds consecutive spans, each begun
by ``phase(name)``, which ends the one before; a partition ends with the
closing mark, ``span_mark<0>``. A phase outside a partition is no span. ``MARKS`` counts the marks launched, by
span. What the switch says while a graph is captured decides what the
graph holds: with tracing off, no mark and no counter update.

Counters. ``Counter(name, fields, device)`` holds an int64 tensor of one
entry a field on ``device``; ``tally(counter, field_index)`` adds one to
the field each element of ``field_index`` names, on the device, while
tracing is on (a graph holds the update). ``counters()`` sums the live
counters of each name by field, one host read a device;
``reset_counters()`` zeroes them all. ``UPDATES`` counts the updates, by
counter.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import weakref
from typing import Dict, List, Sequence

import torch
from torch.profiler import record_function

# the spans of a search iteration, in order: they partition it
SEARCH_PHASES = ("search.descend", "search.fanout", "search.tower", "search.heads", "search.backup")
# the parts of a refill wave (``training.self_play``): the search, recording
# the move and refilling finished slots, the host's read of the live count,
# and the gathers that narrow the pool
WAVE_PARTS = {
    "search": "selfplay.search",
    "record": "selfplay.record_refill",
    "transfer": "selfplay.live_count",
    "gather": "selfplay.compact",
}
# the learner's step and its three parts
LEARNER_PARTS = ("learner.step", "learner.forward", "learner.backward", "learner.optimizer")
# every span; a span's index i names its mark, span_mark<i> (0: a
# partition's end, which begins no span)
SPANS = ("end", *SEARCH_PHASES, "search.init", "search.finish", *WAVE_PARTS.values(), *LEARNER_PARTS)
_INDEX = {name: i for i, name in enumerate(SPANS)}

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mcts", "csrc", "span_mark.cu")

# the logs of the CUDA graphs being captured, innermost last
_CAPTURING = []
_TRACING = False
# the open partitions, innermost last: [device, the range of its open span]
_PARTITIONS = []
# weak references to every ``Counter``
_COUNTERS = []

MARKS: Dict[str, int] = {}
UPDATES: Dict[str, int] = {}


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


# ---------------------------------------------------------------------------
# the switch and the spans


def tracing(on: bool) -> bool:
    """Switch marks and counter updates on or off for the whole process;
    returns the previous setting. Graphs captured before keep what they
    hold."""
    global _TRACING
    previous, _TRACING = _TRACING, bool(on)
    return previous


def traced() -> bool:
    """Whether tracing is on."""
    return _TRACING


def _library() -> ctypes.CDLL:
    from connect4_tpu_torch.build import load_library

    lib = load_library(SOURCE)
    lib.c4_span_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.c4_span_mark.restype = ctypes.c_int
    return lib


def _mark(name: str, device) -> None:
    """Launch the mark of span ``name`` on ``device``'s current stream,
    while tracing is on and ``device`` is a CUDA device."""
    index = _INDEX[name]
    if not _TRACING or torch.device(device).type != "cuda":
        return
    with torch.cuda.device(device):
        err = _library().c4_span_mark(index, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"span mark launch failed with cudaError {err} (span {name})")
    count(_record_mark, name)


def _record_mark(name: str) -> None:
    MARKS[name] = MARKS.get(name, 0) + 1


@contextlib.contextmanager
def span(name: str, device):
    """The enclosed block as span ``name`` (one of ``SPANS``): a host range,
    begun by the span's mark on ``device`` while tracing is on."""
    with record_function(name):
        _mark(name, device)
        yield


def _end_phase() -> None:
    part = _PARTITIONS[-1]
    if part[1] is not None:
        part[1].__exit__(None, None, None)
        part[1] = None


@contextlib.contextmanager
def partition(device):
    """Consecutive spans on ``device``, each begun by ``phase``; the last
    ends with the block, and the closing mark is launched."""
    _PARTITIONS.append([device, None])
    try:
        yield
    finally:
        _end_phase()
        _PARTITIONS.pop()
    _mark("end", device)


def phase(name: str) -> None:
    """End the open span of the innermost partition and begin span
    ``name``; outside a partition (a part of a search iteration run on its
    own), nothing."""
    _INDEX[name]  # a name outside SPANS raises wherever it is
    if not _PARTITIONS:
        return
    _end_phase()
    host = record_function(name)
    host.__enter__()
    _PARTITIONS[-1][1] = host
    _mark(name, _PARTITIONS[-1][0])


# ---------------------------------------------------------------------------
# counters on the card


class Counter:
    """An int64 tensor of one entry a field on a device, registered under
    ``name`` for as long as the object lives."""

    def __init__(self, name: str, fields: Sequence[str], device):
        self.name, self.fields = name, tuple(fields)
        self.tensor = torch.zeros((len(self.fields),), dtype=torch.long, device=device)
        _COUNTERS.append(weakref.ref(self))


def tally(counter: Counter, field_index: torch.Tensor) -> None:
    """Add one to field ``i`` of ``counter`` for each element ``i`` of
    ``field_index``, on the counter's device, while tracing is on."""
    if not _TRACING:
        return
    idx = field_index.reshape(-1)
    counter.tensor.index_add_(0, idx, torch.ones_like(idx))
    count(_record_update, counter.name)


def _record_update(name: str) -> None:
    UPDATES[name] = UPDATES.get(name, 0) + 1


def _live() -> List[Counter]:
    _COUNTERS[:] = [ref for ref in _COUNTERS if ref() is not None]
    return [c for c in (ref() for ref in _COUNTERS) if c is not None]


def counters() -> Dict[str, Dict[str, int]]:
    """Every counter's fields, summed over the counters of its name:
    ``{name: {field: n}}``. One host read a device."""
    by_device: Dict[torch.device, List[Counter]] = {}
    for c in _live():
        by_device.setdefault(c.tensor.device, []).append(c)
    out: Dict[str, Dict[str, int]] = {}
    for group in by_device.values():
        values = iter(torch.cat([c.tensor for c in group]).tolist())
        for c in group:
            fields = out.setdefault(c.name, dict.fromkeys(c.fields, 0))
            for f in c.fields:
                fields[f] += next(values)
    return out


def reset_counters() -> None:
    """Zero every counter, on its device."""
    for c in _live():
        c.tensor.zero_()
