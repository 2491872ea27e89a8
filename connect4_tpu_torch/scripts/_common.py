"""What the tools of ``connect4_tpu_torch.scripts`` share: the result line,
timing with the card synchronised, the fresh full-width net of the
measurement tools, random positions from a seeded generator, and readings
of a ``utils.trace`` file."""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Tuple

import torch

from connect4_tpu_torch.config import NetConfig
from connect4_tpu_torch.env.core import BoardState, initial_state, legal_moves, step
from connect4_tpu_torch.types import ONGOING
from connect4_tpu_torch.utils import TRACE_FILE

# the net the JAX package's measurement tools time: the bench workload's
FULL_WIDTH = dict(filters=64, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")

# what the profiler records of the card's work in a Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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


def annotation_spans(events: List[Dict], name: str, cat: str = "user_annotation") -> List[Tuple[float, float]]:
    """``(start, end)`` microseconds of every ``record_function(name)``
    range (``cat="gpu_user_annotation"``: its span on the card)."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("cat") == cat and e["name"] == name]
