"""Wall-clock decomposition of one self-play search wave.

The counterpart of the JAX package's ``scripts/selfplay_breakdown.py``, at
its workload: 256 slots, a fresh F=64 / fc 6 / res 6 bf16 net, 800
simulations, K=8 walkers, ``sims_per_call`` 200, mid-game boards after 14
random plies. It measures the search in its eager form
(``graphs=False``: the same ops, dispatched one by one from the host) and,
on the card, in its graphed form (``mcts.batched.Search``: each iteration
replayed from CUDA graphs), after a warm wave of each (the kernel's build,
cuDNN's algorithm search and the graphs' capture stay out of the times):

1. each part of a wave with the card synchronised after it: the root
   evaluation (``Search.init``), every segment and ``Search.finish``;
2. the bare evaluator forward at the fan-out batch S x K, against which a
   segment's forwards are counted (one forward a search iteration);
3. the wave with and without those per-part synchronisations, and a
   search iteration's mean;
4. one iteration's tail (expansion, evaluation, backup, the next
   descent's start), timed over repeated calls on the tree the wave left
   (in the graphed form a graph of its own, captured before the timed
   calls), and the descent: on the card the descent kernel's device time an
   iteration (its mean over the traced segment of 5.), on the CPU, whose
   iterations descend level by level, one level timed as the tail is; the
   graphed form also reports each graph's capture;
5. the card's busy share over one traced segment (``utils.trace``: the
   kernels' and copies' union over the segment's wall-clock), against the
   untraced segment's time as well;
6. the net's FLOP/s against the H100's bf16 peak, a board's FLOPs counted
   as ``models.tower.tower_bound`` counts them (37.3 MFLOP at full width).

The top-level numbers are the eager form's; ``graphed`` holds the graphed
form's (``None`` on the CPU, which has no CUDA graphs).

    python -m connect4_tpu_torch.scripts.selfplay_breakdown [--waves 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from connect4_tpu_torch.config import MCTSConfig, NetConfig
from connect4_tpu_torch.env.core import BoardState
from connect4_tpu_torch.mcts.batched import PATH_MAX, Search
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.types import ONGOING
from connect4_tpu_torch.utils import make_generator, resolve_device, trace

# calls a part of an iteration is timed over, on the tree the last wave
# left: 10 tails and, on the CPU only, a whole descent's levels (the most
# one walks, so the level counter stays in its path)
PART_REPS = {"level": PATH_MAX - 2, "tail": 10}


def _form(search: Search, state: BoardState, active, waves: int, generator: torch.Generator) -> dict:
    """One form of the search (eager or graphed) timed on ``state``."""
    device = state.device
    n_segments = search.config.simulations // search.sims_per_call
    iterations = search.config.simulations // search.config.parallel_sims

    t0 = time.perf_counter()
    search(state, generator, active)  # warm-up, and the graphs' capture
    _common.sync(device)
    warm_s = time.perf_counter() - t0
    graphs = search.workspaces[device, state.age.shape[0]].graphs
    captures = None if graphs is None else dict(graphs.capture_ms)  # before the tail's own, below

    per = {"init": 0.0, "segments": 0.0, "finish": 0.0}
    seg_times = []
    for _ in range(waves):
        ws, dt = _common.timed(lambda: search.init(state, generator, active), device)
        per["init"] += dt
        for _ in range(n_segments):
            _, dt = _common.timed(lambda: search.segment(ws), device)
            per["segments"] += dt
            seg_times.append(dt)
        res, dt = _common.timed(lambda: search.finish(ws, generator), device)
        per["finish"] += dt
    blocking = sum(per.values()) / waves

    def unsynced_waves():
        for _ in range(waves):
            out = search(state, generator, active)
        return out

    res, unsynced = _common.timed(unsynced_waves, device)
    unsynced /= waves

    # a tail and, on the CPU, a level, on the tree the last wave left (the
    # next init resets it)
    ws = search.workspaces[device, state.age.shape[0]]
    part_ms = dict.fromkeys(PART_REPS)
    for name, reps in PART_REPS.items():
        if name == "level" and device.type == "cuda":
            continue  # the card descends by the kernel, timed in the trace below
        part = getattr(search, name)
        if ws.graphs is not None:  # its graph's warm-up and capture stay out of the time
            part(ws)
            part(ws)
        _, dt = _common.timed(lambda: [part(ws) for _ in range(reps)], device)
        part_ms[name] = dt / reps * 1e3

    # the card's busy share over one traced segment of a warm tree
    ws = search.init(state, generator, active)
    search.segment(ws)
    _common.sync(device)
    with tempfile.TemporaryDirectory(prefix="selfplay_breakdown_") as log_dir:
        with trace(log_dir):
            t_start = time.perf_counter()
            search.segment(ws)
            _common.sync(device)
            traced_s = time.perf_counter() - t_start
        events = _common.trace_events(log_dir)
    busy_ms = _common.device_busy_ms(events)
    descent_us = [e["dur"] for e in events if e.get("cat") == "kernel" and "descent_kernel" in e["name"]]
    seg_mean = float(np.mean(seg_times))
    out = {
        "warm_s": warm_s,
        "init_ms": per["init"] / waves * 1e3, "segments_ms": per["segments"] / waves * 1e3,
        "finish_ms": per["finish"] / waves * 1e3,
        "segment_ms": [t * 1e3 for t in seg_times[:n_segments]],
        "blocking_wave_ms": blocking * 1e3, "unsynced_wave_ms": unsynced * 1e3,
        "iteration_ms": per["segments"] / waves / iterations * 1e3,
        "descent_ms": float(np.mean(descent_us)) / 1e3 if descent_us else None,
        "descent_launches_traced": len(descent_us),
        "level_ms": part_ms["level"], "tail_ms": part_ms["tail"],
        "share": {k: v / waves / blocking for k, v in per.items()},
        "traced_segment_ms": traced_s * 1e3,
        "device_busy_ms": busy_ms,
        "device_busy_share": None if busy_ms is None else busy_ms / (traced_s * 1e3),
        "device_busy_share_of_untraced": None if busy_ms is None else busy_ms / (seg_mean * 1e3),
        "sims_per_s": state.age.shape[0] * search.config.simulations / unsynced,
    }
    if ws.graphs is not None:
        out["capture_ms"] = captures
        out["replays"] = ws.graphs.replays
    return out, res


@torch.no_grad()
def breakdown(
    eval_fn,
    state: BoardState,
    config: MCTSConfig,
    sims_per_call: int,
    waves: int,
    generator: torch.Generator,
    net_config: Optional[NetConfig] = None,
    eval_reps: int = 20,
) -> dict:
    """Time ``waves`` searches of every board of ``state`` (finished games
    ride along inactive), split into their parts, in the eager form and,
    on the card, in the graphed form. ``net_config`` names the net
    ``eval_fn`` runs, for the FLOP count. Returns the times in ms, the
    card's busy share and the counts of the eager form's last wave: live
    rows, moves chosen and tree nodes a row."""
    device = state.device
    S, K = state.age.shape[0], config.parallel_sims
    if config.simulations % sims_per_call:
        raise ValueError("simulations must be divisible by sims_per_call")
    active = state.result == ONGOING
    flat = state.map(lambda x: torch.cat([x] * K))  # the fan-out batch

    eval_fn(flat)
    _, eval_s = _common.timed(lambda: [eval_fn(flat) for _ in range(eval_reps)], device)
    eval_s /= eval_reps

    out, res = _form(Search(eval_fn, config, sims_per_call, graphs=False), state, active, waves, generator)
    graphed = None
    if device.type == "cuda":
        graphed, _ = _form(Search(eval_fn, config, sims_per_call), state, active, waves, generator)
    iters = config.simulations // K
    out = {
        "device": _common.device_name(device),
        "slots": S, "live_rows": int(active.sum()), "simulations": config.simulations,
        "parallel_sims": K, "sims_per_call": sims_per_call, "waves": waves,
        "eval_ms": eval_s * 1e3, "eval_batch": S * K,
        **out,
        "eval_share": iters * eval_s / (out["unsynced_wave_ms"] / 1e3),
        "graphed": graphed,
        "moves": res.move[active].tolist(),
        "nodes": res.tree.next_free.tolist(),
    }
    if net_config is not None and device.type == "cuda":
        flops_board = tower.tower_bound(net_config, 1)[2]
        out["mflop_per_board"] = flops_board / 1e6
        for form in (out, graphed):
            form["achieved_tflops"] = form["sims_per_s"] * flops_board / 1e12
            form["mfu"] = form["sims_per_s"] * flops_board / tower.PEAK_BF16_FLOPS
        out["eval_tflops"] = S * K * flops_board / eval_s / 1e12
        out["eval_mfu"] = S * K * flops_board / eval_s / tower.PEAK_BF16_FLOPS
    return out


def _descent(r: dict) -> str:
    if r["descent_ms"] is not None:
        return (f"the descent kernel {r['descent_ms'] * 1e3:.2f} us an iteration (device time, "
                f"{r['descent_launches_traced']} launches in the traced segment)")
    if r["level_ms"] is not None:
        return f"one descent level (the CPU's form) {r['level_ms']:.3f} ms"
    return "the descent kernel: not measured (no card in the trace)"


def report(r: dict) -> None:
    print(f"setup: {r['live_rows']}/{r['slots']} boards live; warm-up {r['warm_s']:.1f} s on {r['device']}")
    print(f"eval forward [{r['eval_batch']}]: {r['eval_ms']:.2f} ms")
    print(
        f"blocking wave: init {r['init_ms']:.1f} ms | {len(r['segment_ms'])} segments "
        f"{r['segments_ms']:.1f} ms (per-seg {[round(t) for t in r['segment_ms']]}) | "
        f"finish {r['finish_ms']:.1f} ms"
    )
    print(
        f"wave wall-time: blocking {r['blocking_wave_ms']:.1f} ms, without per-part syncs "
        f"{r['unsynced_wave_ms']:.1f} ms"
    )
    print(
        f"per-wave eval share (est): {r['eval_share']:.1%} of the wave; descent/expand/backup "
        f"and overheads the rest"
    )
    busy = r["device_busy_share"]
    print(
        "device busy over one traced segment: "
        + ("not measured (no card in the trace)" if busy is None else
           f"{r['device_busy_ms']:.1f} ms of {r['traced_segment_ms']:.1f} ms traced = {busy:.1%} "
           f"({r['device_busy_share_of_untraced']:.1%} of an untraced segment)")
    )
    print(f"per iteration {r['iteration_ms']:.2f} ms; {_descent(r)}, one tail {r['tail_ms']:.3f} ms")
    g = r["graphed"]
    if g is None:
        print("graphed form: not run (no CUDA graphs on the CPU)")
    else:
        print(f"graphed form: warm-up and capture {g['warm_s']:.2f} s (captures {g['capture_ms']} ms); wave "
              f"{g['unsynced_wave_ms']:.1f} ms, blocking {g['blocking_wave_ms']:.1f} ms; per iteration "
              f"{g['iteration_ms']:.2f} ms; {_descent(g)}, one tail {g['tail_ms']:.3f} ms; "
              f"device busy {g['device_busy_share']} of a traced segment; {g['sims_per_s']:,.0f} sims/s")
    if "mfu" in r:
        print(
            f"throughput {r['sims_per_s']:,.0f} sims/s x {r['mflop_per_board']:.1f} MFLOP/sim = "
            f"{r['achieved_tflops']:.2f} TFLOP/s = {r['mfu']:.2%} of the bf16 peak; bare eval "
            f"{r['eval_tflops']:.2f} TFLOP/s ({r['eval_mfu']:.1%}) at batch {r['eval_batch']}"
        )
    else:
        print(f"throughput {r['sims_per_s']:,.0f} sims/s (FLOP/s against the card's peak: not measured)")


def run(slots=256, sims=800, parallel_sims=8, sims_per_call=200, waves=3, setup_plies=14,
        device="cuda") -> dict:
    """The JAX script's workload on ``device``."""
    dev = resolve_device(device)
    net = _common.fresh_net(dev)
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator

    state = _common.random_playouts(slots, setup_plies, make_generator(42, dev), dev)
    config = MCTSConfig(simulations=sims, parallel_sims=parallel_sims, root_dirichlet_alpha=1.0,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    return breakdown(make_net_evaluator(net), state, config, sims_per_call, waves,
                     make_generator(0, dev), net.config)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--slots", type=int, default=256)
    parser.add_argument("--sims", type=int, default=800)
    parser.add_argument("--parallel-sims", type=int, default=8)
    parser.add_argument("--sims-per-call", type=int, default=200)
    parser.add_argument("--waves", type=int, default=3)
    parser.add_argument("--setup-plies", type=int, default=14)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    r = run(args.slots, args.sims, args.parallel_sims, args.sims_per_call, args.waves,
            args.setup_plies, args.device)
    report(r)
    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
