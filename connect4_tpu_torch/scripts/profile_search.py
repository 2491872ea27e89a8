"""Profile the batched search: one warm search, then one traced search.

The counterpart of the JAX package's ``scripts/profile_search.py``: a fresh
bf16 net (F=64 unless ``--filters``, fc 6, res 6), a batch of empty boards,
one search to warm up (the kernel's build, cuDNN's algorithm search), then
one search under ``utils.trace``. Prints the steady search's time and
simulations a second, where the trace went, and the ops that took the most
time by the names the profiler records: the card's kernels, or the host's
``aten::`` ops on the CPU. Open the trace in Perfetto or chrome://tracing.

    python -m connect4_tpu_torch.scripts.profile_search [--batch 512] [--sims 200] \\
        [--parallel-sims 8] [--logdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.core import BoardState, initial_state
from connect4_tpu_torch.mcts.batched import make_search_fn
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import TRACE_FILE, make_generator, resolve_device, trace


def profile_search(eval_fn, state: BoardState, config: MCTSConfig, log_dir=None, top: int = 12) -> dict:
    """One warm search of ``state``, then one traced; returns its time, its
    simulations a second, the trace file and the top ops by time."""
    device = state.device
    search = make_search_fn(eval_fn, config)
    _, warm_s = _common.timed(lambda: search(state, make_generator(0, device)), device)
    with trace(log_dir) as log_dir:
        res, steady_s = _common.timed(lambda: search(state, make_generator(1, device)), device)
    t0 = time.perf_counter()
    events = _common.trace_events(log_dir)
    what, ops = _common.top_ops(events, top)
    batch = state.age.shape[0]
    return {
        "device": _common.device_name(device), "batch": batch, "simulations": config.simulations,
        "parallel_sims": config.parallel_sims, "warm_s": warm_s, "steady_s": steady_s,
        "sims_per_s": batch * config.simulations / steady_s,
        "trace": os.path.join(log_dir, TRACE_FILE), "events": len(events),
        "device_busy_ms": _common.device_busy_ms(events), "top_ops_of": what, "top_ops": ops,
        "read_s": time.perf_counter() - t0, "moves": res.move.tolist(),
    }


def report(r: dict) -> None:
    print(f"warm-up: {r['warm_s']:.1f}s on {r['device']}")
    print(f"steady search: {r['steady_s']:.3f}s  {r['sims_per_s']:,.0f} sims/s  trace: {r['trace']}")
    busy = r["device_busy_ms"]
    print("device busy in the traced search: "
          + ("not measured (no card in the trace)" if busy is None else
             f"{busy:.1f} ms of {r['steady_s'] * 1e3:.1f} ms"))
    print(f"top {r['top_ops_of']} ops by time:")
    for op in r["top_ops"]:
        print(f"  {op['ms']:10.3f} ms  {op['count']:7d}x  {op['name'][:100]}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=512)
    parser.add_argument("--sims", type=int, default=200)
    parser.add_argument("--parallel-sims", type=int, default=8)
    parser.add_argument("--filters", type=int, default=64)
    parser.add_argument("--logdir", default=None)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.eval.evaluators import make_net_evaluator

    dev = resolve_device(args.device)
    evaluator = make_net_evaluator(_common.fresh_net(dev, args.filters))
    config = MCTSConfig(simulations=args.sims, parallel_sims=args.parallel_sims)
    with torch.no_grad():
        r = profile_search(evaluator, initial_state((args.batch,), device=dev), config, args.logdir)
    report(r)
    _common.emit({k: v for k, v in r.items() if k != "moves"})
    return r


if __name__ == "__main__":
    main()
