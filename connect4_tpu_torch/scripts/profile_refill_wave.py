"""Break the refill-pool self-play waves into their parts and time each.

The counterpart of the JAX package's ``scripts/profile_refill_wave.py``
(256 slots, 1200 games, 800 simulations, K=8, ``sims_per_call`` 200, a fresh
F=64 / fc 6 / res 6 bf16 net): a first run of ``make_refill_play_fn`` warms
up, a steady run is timed wave by wave (full-pool waves against the tail's
narrowing ones), and a third run is traced over two waves of the full
pool. A wave's parts are the spans of ``launches.WAVE_PARTS``: the search,
recording the moves and refilling finished slots, the host's read of the
live count (a transfer from the card) and the gathers that narrow the pool;
each is given as host time and as the card's busy time that is its own or
its inner spans' (the search's: ``search.init``, ``search.finish`` and the
phases of its iterations), by ``_common.span_times``, which reads the marks
that the search's CUDA graphs replay. The tool runs with tracing on
(``launches.tracing``), so the traced run also gives every span's times and
the search's evaluations by class, counted on the card over that run
(``evals``). Last, the bare chunked search at the pool's width, for
comparison.

    python -m connect4_tpu_torch.scripts.profile_refill_wave [--slots 256] [--games 1200] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.core import initial_state
from connect4_tpu_torch.mcts.batched import make_chunked_search_fn
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch import launches
from connect4_tpu_torch.launches import SEARCH_PHASES, WAVE_PARTS
from connect4_tpu_torch.training.self_play import make_refill_play_fn
from connect4_tpu_torch.utils import TRACE_FILE, make_generator, resolve_device

TRACED_WAVES = 2


# the spans inside a part, whose card time is the part's too
INNER = {"search": ("search.init", "search.finish", *SEARCH_PHASES)}


def _parts(events, spans, n_waves: int) -> dict:
    """Host and card milliseconds a wave of each part, the card's from
    ``span_times``; None without work of a card in the trace."""
    out = {}
    for key, name in WAVE_PARTS.items():
        host = _common.annotation_spans(events, name)
        busy = [spans["spans"][n]["busy_ms"] for n in (name, *INNER.get(key, ()))]
        out[key] = {
            "range": name, "calls": len(host),
            "host_ms": sum(b - a for a, b in host) / 1e3 / n_waves,
            "device_ms": None if spans["busy_ms"] is None else sum(busy) / n_waves,
        }
    return out


def profile_refill(eval_fn, config: MCTSConfig, slots: int, games: int, sims_per_call: Optional[int],
                   device) -> dict:
    """The three runs and the bare search; see the module's docstring."""
    previous = launches.tracing(True)
    try:
        return _profile_refill(eval_fn, config, slots, games, sims_per_call, torch.device(device))
    finally:
        launches.tracing(previous)


def _profile_refill(eval_fn, config: MCTSConfig, slots: int, games: int, sims_per_call: Optional[int],
                    dev: torch.device) -> dict:
    play = make_refill_play_fn(eval_fn, config, slots, games, sims_per_call, device=dev)
    _, first_s = _common.timed(lambda: play(make_generator(99, dev)), dev)

    marks = []
    t0 = time.perf_counter()
    out = play(make_generator(1, dev), progress=lambda w, live: marks.append((time.perf_counter(), live)))
    _common.sync(dev)
    steady_s = time.perf_counter() - t0
    times = np.diff([t0] + [t for t, _ in marks])
    live = np.array([n for _, n in marks])
    full = live >= slots * 0.95
    moves = int(out.mask.sum())

    # the traced run: a step a wave, skipping the first wave
    from torch.profiler import ProfilerActivity, profile, schedule

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    launches.reset_counters()
    with tempfile.TemporaryDirectory(prefix="profile_refill_wave_") as log_dir:
        path = os.path.join(log_dir, TRACE_FILE)
        with profile(activities=activities, schedule=schedule(wait=1, warmup=1, active=TRACED_WAVES, repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
            play(make_generator(2, dev), progress=lambda w, n: prof.step())
        events = _common.trace_events(log_dir)
    evals = launches.counters()["evals"]
    spans = _common.span_times(events)
    parts = _parts(events, spans, TRACED_WAVES)

    chunked = make_chunked_search_fn(eval_fn, config, sims_per_call or config.simulations)
    state0 = initial_state((slots,), device=dev)
    with torch.no_grad():
        _common.timed(lambda: chunked(state0, make_generator(2, dev)), dev)
        bare = min(_common.timed(lambda: chunked(state0, make_generator(3 + i, dev)), dev)[1] for i in range(3))
    return {
        "device": _common.device_name(dev), "slots": slots, "games": games,
        "simulations": config.simulations, "parallel_sims": config.parallel_sims,
        "first_s": first_s, "steady_s": steady_s, "waves": len(times),
        "full_waves": int(full.sum()), "full_wave_s": float(times[full].mean()) if full.any() else None,
        "tail_waves": int((~full).sum()), "tail_wave_s": float(times[~full].mean()) if (~full).any() else None,
        "moves": moves, "sims_per_s": moves * config.simulations / steady_s,
        "live_per_wave": live.tolist(), "traced_waves": TRACED_WAVES, "parts": parts,
        "spans": spans, "evals": evals, "bare_search_s": bare,
    }


def report(r: dict) -> None:
    print(f"first run (warm-up): {r['first_s']:.1f}s on {r['device']}")
    full = "-" if r["full_wave_s"] is None else f"{r['full_wave_s']:.3f}s"
    tail = "-" if r["tail_wave_s"] is None else f"{r['tail_wave_s']:.3f}s"
    print(f"steady run: {r['steady_s']:.1f}s over {r['waves']} waves; full-pool waves: "
          f"{r['full_waves']} x {full}; tail waves: {r['tail_waves']} x {tail}")
    print(f"moves {r['moves']}  sims/s {r['sims_per_s']:,.0f}")
    print(f"a wave's parts over {r['traced_waves']} traced waves (host ms | card busy ms):")
    for key, p in r["parts"].items():
        card = "not measured" if p["device_ms"] is None else f"{p['device_ms']:.2f}"
        print(f"  {key:9s} {p['host_ms']:10.2f} | {card}  ({p['range']}, {p['calls']} calls)")
    print(f"every span over the {r['traced_waves']} traced waves:")
    for line in _common.span_table(r["spans"]):
        print(f"  {line}")
    print(f"the traced run's evaluations by class: {r['evals']}")
    print(f"bare chunked search at S={r['slots']}: {r['bare_search_s']:.3f}s")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, default=256)
    parser.add_argument("--games", type=int, default=1200)
    parser.add_argument("--sims", type=int, default=800)
    parser.add_argument("--parallel-sims", type=int, default=8)
    parser.add_argument("--sims-per-call", type=int, default=200)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.eval.evaluators import make_net_evaluator

    dev = resolve_device(args.device)
    config = MCTSConfig(simulations=args.sims, root_dirichlet_alpha=0.3, root_exploration_fraction=0.25,
                        num_sampling_moves=6, parallel_sims=args.parallel_sims)
    r = profile_refill(make_net_evaluator(_common.fresh_net(dev)), config, args.slots, args.games,
                       args.sims_per_call, dev)
    report(r)
    _common.emit({k: v for k, v in r.items() if k != "live_per_wave"})
    return r


if __name__ == "__main__":
    main()
