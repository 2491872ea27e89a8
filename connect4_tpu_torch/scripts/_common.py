"""What the tools of ``connect4_tpu_torch.scripts`` share: the result line,
timing with the card synchronised, the fresh full-width net of the
measurement tools, random positions from a seeded generator, and readings
of a ``utils.trace`` file, the card's work by the program's span among
them (``span_times``)."""

from __future__ import annotations

import argparse
import bisect
import heapq
import itertools
import json
import os
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

from connect4_tpu_torch import launches
from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.core import BoardState, initial_state, legal_moves, step
from connect4_tpu_torch.types import ONGOING
from connect4_tpu_torch.utils import TRACE_FILE

# the net the JAX package's measurement tools time: the bench workload's
FULL_WIDTH = dict(filters=64, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")

# what the profiler records of the card's work in a Chrome trace, and of
# the host's calls that launch it
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the name of a span's mark on the card (``launches``)
MARK = re.compile(r"\bspan_mark<(\d+)>")


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def emit(result: Dict) -> None:
    """The tool's result as its last line: one JSON object."""
    print(json.dumps(result, default=str), flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device: torch.device):
    """``(fn(), seconds)`` on the host clock, with the card synchronised
    before and after, so the time is the work's and not its enqueue."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def fresh_net(device: torch.device, filters: int = 64, seed: int = 0):
    """A freshly initialised full-width bf16 net (F=64, fc 6, res 6 unless
    ``filters`` says otherwise) from a seeded CPU generator."""
    from connect4_tpu_torch.models.net import init_net

    config = NetConfig(**{**FULL_WIDTH, "filters": filters})
    return init_net(config, torch.Generator().manual_seed(seed), device=device)


def load_net(checkpoint_dir: Optional[str], generation: Optional[int], device):
    """``(name, net)``: the packaged gen-161 net when ``checkpoint_dir`` is
    None, else generation ``generation`` (default: the latest readable one)
    of a run's checkpoints, which carry the net's widths and dtype."""
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.training import checkpoint as ckpt

    if checkpoint_dir is None:
        return "gen161", load_example_net(device=device)
    if generation is None:
        restored = ckpt.restore_latest(checkpoint_dir, device=device)
        if restored is None:
            raise FileNotFoundError(f"no readable checkpoints under {checkpoint_dir}")
        generation, state, _ = restored
    else:
        state, _ = ckpt.restore_checkpoint(checkpoint_dir, generation, device=device)
    return f"gen{generation}", state.net


def random_playouts(n: int, plies: int, generator: torch.Generator, device) -> BoardState:
    """``n`` games of ``plies`` uniformly random legal moves from the empty
    board; a game that ends stays as it ended."""
    state = initial_state((n,), device=device)
    for _ in range(plies):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        move = torch.multinomial(weights, 1, generator=generator)[:, 0]
        state = step(state, move, state.result == ONGOING)
    return state


def live_boards_at_ply(ply: int, rows: int, generator: torch.Generator, device) -> BoardState:
    """``rows`` games still running after ``ply`` random plies
    (rejection-sampled: playouts that ended are drawn again)."""
    parts, have = [], 0
    for _ in range(64):
        state = random_playouts(2 * rows, ply, generator, device)
        live = state.result == ONGOING
        parts.append(state.map(lambda x: x[live]))
        have += int(live.sum())
        if have >= rows:
            return concat_states(parts).map(lambda x: x[:rows])
    raise RuntimeError(f"fewer than {rows} live games at ply {ply} after 64 draws")


def concat_states(states: List[BoardState]) -> BoardState:
    return BoardState(*(torch.cat(xs) for xs in zip(*states)))


# ---------------------------------------------------------------------------
# readings of a trace written by ``utils.trace``


def trace_events(log_dir: str) -> List[Dict]:
    """The complete events (``"ph": "X"``) of ``<log_dir>/trace.json``."""
    with open(os.path.join(log_dir, TRACE_FILE)) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_busy_ms(events: List[Dict], window: Optional[Tuple[float, float]] = None) -> Optional[float]:
    """Milliseconds in which the card ran at least one kernel, copy or
    set (overlaps counted once), within ``window`` (trace microseconds)
    when given; None when the trace holds no work of a card."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") in DEVICE_CATEGORIES]
    if not spans:
        return None
    if window is not None:
        lo, hi = window
        spans = [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]
    return _union_us(spans) / 1e3


def top_ops(events: List[Dict], n: int = 10) -> Tuple[str, List[Dict]]:
    """The ``n`` ops that took the most time, by the names the profiler
    records: the card's kernels when the trace has them, else the host's
    ``aten::`` ops (a CPU run). Returns ``(what, rows)``."""
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    what, chosen = ("device", device) if device else ("cpu", [e for e in events if e.get("cat") == "cpu_op"])
    by_name: Dict[str, List[float]] = {}
    for e in chosen:
        acc = by_name.setdefault(e["name"], [0.0, 0])
        acc[0] += e["dur"] / 1e3
        acc[1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return what, [{"name": k, "ms": v[0], "count": v[1]} for k, v in rows]


def annotation_spans(events: List[Dict], name: str) -> List[Tuple[float, float]]:
    """``(start, end)`` microseconds of every ``record_function(name)``
    range on the host."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == "user_annotation" and e["name"] == name]


class _Busy:
    """The union of intervals, and how much of it lies within any
    ``[a, b]``."""

    def __init__(self, intervals):
        self.merged: List[List[float]] = []
        for a, b in sorted(intervals):
            if self.merged and a <= self.merged[-1][1]:
                self.merged[-1][1] = max(self.merged[-1][1], b)
            else:
                self.merged.append([a, b])
        self.starts = [a for a, _ in self.merged]
        self.cum = list(itertools.accumulate((b - a for a, b in self.merged), initial=0.0))

    @property
    def total(self) -> float:
        return self.cum[-1]

    def within(self, a: float, b: float) -> float:
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        j = bisect.bisect_left(self.starts, b)  # the intervals that start before b
        if b <= a or i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        s, e = self.merged[i]
        total -= max(0.0, min(e, a) - s)
        s, e = self.merged[j - 1]
        total -= max(0.0, e - max(s, b))
        return max(total, 0.0)


def span_times(events: List[Dict], window: Optional[Tuple[float, float]] = None) -> Dict:
    """The card's work by the program's span (``launches.SPANS``), from a
    trace's complete events, within ``window`` (trace microseconds) when
    given. A kernel, copy or set that a CUDA graph's replay launched belongs
    to the span of the last mark before it on its stream (a mark to the span
    it begins, the closing mark to the span it closes); any other to the
    innermost span whose host range holds the call that launched it, on any
    host thread (so the kernels that autograd's thread launches in
    ``learner.backward`` count there). For each span, in milliseconds:

    - ``calls``: its host ranges, or where it has none (a span inside a
      replayed graph), its marks;
    - ``busy_ms``: the union of its ops;
    - ``marked_ms``: from each of its marks in a replay to the next mark on
      the stream (to its run's last op where none follows);
    - ``gap_ms``: the card's idle time between the first and the last op of
      each of its runs inside a replay (from its mark to the next);
    - ``host_ms``: its host ranges;
    - ``wait_ms``: the card's idle time while the host was inside them.

    Besides ``spans``: the card's ``busy_ms``, the part of it that spans
    hold (``attributed_ms``), and the replayed ops that no mark precedes
    (``unattributed_replayed``). A trace without work of a card (a CPU run)
    gives its host times alone, every time of the card None."""
    lo, hi = window or (float("-inf"), float("inf"))
    names = launches.SPANS
    index = {n: i for i, n in enumerate(names)}
    calls = {e["args"]["correlation"]: e for e in events
             if e.get("cat") in LAUNCH_CATEGORIES and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"] in index]
    ops = sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("stream"), e["name"],
                  e.get("args", {}).get("correlation")) for e in events if e.get("cat") in DEVICE_CATEGORIES)

    span_of: List[Optional[str]] = [None] * len(ops)
    run_of: List[Optional[int]] = [None] * len(ops)  # the mark that began the op's run
    marks: Dict[object, List[Tuple[float, int]]] = {}  # stream -> (start, op) of each mark
    replayed = set()  # the marks that a replay launched
    current: Dict[object, Tuple[Optional[str], Optional[int]]] = {}
    eager, unattributed = [], 0
    for i, (a, _, stream, name, corr) in enumerate(ops):
        call = calls.get(corr)
        in_replay = call is not None and "GraphLaunch" in call["name"]
        mark = MARK.search(name)
        if mark is not None and int(mark.group(1)) < len(names):
            span = names[int(mark.group(1))]
            marks.setdefault(stream, []).append((a, i))
            if in_replay:
                replayed.add(i)
            if span == names[0]:
                span_of[i], run_of[i] = current.get(stream, (None, None))
                current[stream] = (None, None)
            else:
                span_of[i], run_of[i] = current[stream] = (span, i)
        elif in_replay:
            span_of[i], run_of[i] = current.get(stream, (None, None))
            unattributed += span_of[i] is None and a < hi and ops[i][1] > lo
        elif call is not None:
            eager.append((call["ts"], i))

    # eager ops: the innermost range holding the launching call, by a sweep
    # over the calls in time order with the open ranges in a heap (latest
    # start on top; ranges that ended are dropped as they surface)
    ranges.sort()
    heap, r = [], 0
    for t, i in sorted(eager):
        while r < len(ranges) and ranges[r][0] <= t:
            heapq.heappush(heap, (-ranges[r][0], ranges[r][1], ranges[r][2]))
            r += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        span_of[i] = heap[0][2] if heap else None

    def clip(a, b):
        return max(a, lo), min(b, hi)

    busy = _Busy(clip(a, b) for a, b, *_ in ops if b > lo and a < hi)
    out = {n: {"calls": 0, "busy_ms": 0.0, "marked_ms": 0.0, "gap_ms": 0.0, "host_ms": 0.0, "wait_ms": 0.0}
           for n in names[1:]}
    by_span: Dict[str, List[Tuple[float, float]]] = {}
    runs: Dict[int, List[float]] = {}
    for (a, b, *_), span, run in zip(ops, span_of, run_of):
        if span is None or b <= lo or a >= hi:
            continue
        by_span.setdefault(span, []).append(clip(a, b))
        if run is not None:
            extent = runs.setdefault(run, [a, b])
            extent[0], extent[1] = min(extent[0], a), max(extent[1], b)
    for span, intervals in by_span.items():
        out[span]["busy_ms"] = _Busy(intervals).total / 1e3
    for run, (a, b) in runs.items():
        a, b = clip(a, b)
        out[span_of[run]]["gap_ms"] += ((b - a) - busy.within(a, b)) / 1e3
    for stream_marks in marks.values():
        for (a, i), (b, _) in zip(stream_marks, stream_marks[1:] + [(None, None)]):
            if i in replayed and run_of[i] == i and lo <= a < hi:
                end = runs[i][1] if b is None else b
                out[span_of[i]]["marked_ms"] += (min(end, hi) - a) / 1e3
                out[span_of[i]]["calls"] += 1
    for span in {n for _, _, n in ranges}:
        held = _Busy(clip(a, b) for a, b, n in ranges if n == span and b > lo and a < hi)
        out[span]["host_ms"] = held.total / 1e3
        out[span]["wait_ms"] = sum((b - a) - busy.within(a, b) for a, b in held.merged) / 1e3
        starts = sum(1 for a, _, n in ranges if n == span and lo <= a < hi)
        if starts:
            out[span]["calls"] = starts
    result = {
        "spans": out,
        "busy_ms": busy.total / 1e3,
        "attributed_ms": _Busy(iv for ivs in by_span.values() for iv in ivs).total / 1e3,
        "unattributed_replayed": unattributed,
    }
    if not ops:
        for t in out.values():
            t.update(busy_ms=None, marked_ms=None, gap_ms=None, wait_ms=None)
        result.update(busy_ms=None, attributed_ms=None)
    return result


def span_table(times: Dict) -> List[str]:
    """``span_times`` as lines of text, spans with work or calls only."""
    def ms(v, width):
        return f"{'-':>{width}s}" if v is None else f"{v:{width}.3f}"

    lines = [f"{'span':22s} {'calls':>7s} {'busy ms':>10s} {'marked ms':>10s} {'gap ms':>9s} "
             f"{'host ms':>10s} {'wait ms':>9s}"]
    for name, t in times["spans"].items():
        if t["calls"] or t["busy_ms"]:
            lines.append(f"{name:22s} {t['calls']:7d} {ms(t['busy_ms'], 10)} {ms(t['marked_ms'], 10)} "
                         f"{ms(t['gap_ms'], 9)} {ms(t['host_ms'], 10)} {ms(t['wait_ms'], 9)}")
    lines.append(f"card busy {ms(times['busy_ms'], 0)} ms, in spans {ms(times['attributed_ms'], 0)} ms; "
                 f"replayed ops before any mark: {times['unattributed_replayed']}")
    return lines
