"""A profiled segment of a run, read in memory.

``Segment`` turns on PyTorch's profiler (host ops and the card's kernels,
copies and sets, through CUPTI) for a stated part of a window, marks the
part with a host range of its own, and hands back the events without
writing a timeline. ``summary`` reduces them to what the per-layer readers
and the result line need: the segment's length, the card's busy time (the
union of its work, overlaps once), kernel time by name, and the idle gaps
by what the host was doing in them. The busy arithmetic is that of the
program's ``scripts/selfplay_breakdown.py`` (``scripts/_common.py``:
``device_busy_ms``), copied here.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

import torch

SEGMENT = "c4bench.segment"
# idle gaps labelled by what the host ran, longest first, and how far back
# among the host events a label is looked for
LABELLED_GAPS = 2000
SCAN = 4000


class Segment:
    def __init__(self, device):
        self.device = torch.device(device)
        self._profile = None
        self._range = None

    def start(self) -> None:
        from torch.autograd import profiler

        torch.cuda.synchronize(self.device)
        self._profile = profiler.profile(use_kineto=True, use_device="cuda")
        self._profile._prepare_trace()
        self._profile._start_trace()
        self._range = torch.profiler.record_function(SEGMENT)
        self._range.__enter__()

    def stop(self) -> List:
        torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        # the raw events, without the profiler's own post-processing into
        # Python objects, which grows with the number of ops
        return torch.autograd._disable_profiler().events()


def _union(spans: List[Tuple[int, int]]) -> int:
    total, end = 0, None
    for a, b in sorted(spans):
        if end is None or b > end:
            total += b - (a if end is None else max(a, end))
            end = b
    return total


def summary(events, top: int = 10) -> Dict:
    """Segment length, busy time, kernel time by name and idle gaps, in
    seconds, from the events of ``Segment.stop``."""
    marks = [e for e in events if e.name() == SEGMENT and e.device_type() == torch.autograd.DeviceType.CPU]
    if not marks:
        raise RuntimeError("the profiled segment left no range of its own in the trace")
    lo, hi = marks[0].start_ns(), marks[0].start_ns() + marks[0].duration_ns()
    device, host = [], []
    # a host range's span on the card is no work of the card's
    ranges = {e.name() for e in events if e.is_user_annotation() and e.device_type() != torch.autograd.DeviceType.CUDA}
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if b <= lo or a >= hi or e.name() == SEGMENT:
            continue
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and e.name() not in ranges:
                device.append((max(a, lo), min(b, hi), e.name()))
        else:
            host.append((a, b, e.name(), e.is_user_annotation()))
    busy = _union([(a, b) for a, b, _ in device])
    by_name: Dict[str, float] = {}
    for a, b, name in device:
        by_name[name] = by_name.get(name, 0) + (b - a)
    gaps = sorted(_idle_gaps(sorted(device), lo, hi), key=lambda g: g[0] - g[1])
    host.sort()
    starts = [h[0] for h in host]
    by_host: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        # the longest gaps by what the host ran; the rest in one entry
        label = _doing(host, starts, (a + b) // 2) if i < LABELLED_GAPS else "shorter gaps"
        by_host[label] = by_host.get(label, 0) + (b - a)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
        "kernels": len(device),
        "device_ops": [[k, v / 1e9] for k, v in ranked[:top]],
        "idle_gaps": [[k, v / 1e9] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]],
    }


def _idle_gaps(device, lo: int, hi: int) -> List[Tuple[int, int]]:
    gaps, end = [], lo
    for a, b, _ in device:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def _doing(host, starts, t: int) -> str:
    """What the host ran at ``t``: the innermost of the program's marked
    ranges that holds it and the innermost op, from ``host`` sorted by
    start."""
    mark = op = None
    for j in range(bisect.bisect_right(starts, t) - 1, max(-1, bisect.bisect_right(starts, t) - 1 - SCAN), -1):
        a, b, name, annotation = host[j]
        if a <= t < b:
            if annotation and mark is None:
                mark = name
            elif not annotation and op is None:
                op = name
            if mark is not None and op is not None:
                break
    return f"host: {mark or '-'} / {op or 'no op traced'}"
