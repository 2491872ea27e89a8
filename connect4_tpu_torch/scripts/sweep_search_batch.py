"""Measure steady-state MCTS search throughput across batch sizes.

The counterpart of the JAX package's ``scripts/sweep_search_batch.py``: for
each batch size and walker count K, the chunked search
(``mcts.batched.make_chunked_search_fn``) of a fresh F=64 / fc 6 / res 6
bf16 net on random 12-ply positions (numpy's ``default_rng(0)``, the JAX
script's boards), once to warm up and twice timed; the faster run gives
simulations a second.

    python -m connect4_tpu_torch.scripts.sweep_search_batch [--sims 800] \\
        [--batches 512 1024 ...] [--parallel-sims 1 8] [--no-noise] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.mcts.batched import make_chunked_search_fn
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import make_generator, resolve_device


def midgame_boards(batch: int, plies: int = 12):
    """Random ``plies``-ply positions still in play, drawn as the JAX script
    draws them (``numpy.random.default_rng(0)``): search depth there is
    representative of the expensive middle of a generation."""
    rng = np.random.default_rng(0)
    boards = []
    while len(boards) < batch:
        b = HostBoard()
        ok = True
        for _ in range(plies):
            valid = sorted(b.valid_moves)
            if not valid or b.result is not None:
                ok = False
                break
            b.make_move(int(rng.choice(valid)))
        if ok and b.result is None:
            boards.append(b)
    return boards


def segment_size(sims: int, k: int, sims_per_call: int) -> Optional[int]:
    """The largest segment of at most ``sims_per_call`` simulations that
    holds whole K-iterations and divides ``sims``, or None."""
    return next(
        (d for d in range(min(sims_per_call, sims), 0, -1) if sims % d == 0 and d % k == 0), None
    )


@torch.no_grad()
def sweep(eval_fn, config: MCTSConfig, batches: Sequence[int], parallel_sims: Sequence[int],
          sims_per_call: int, device, repeats: int = 2) -> list:
    """One row a (batch, K): first and steady seconds, simulations a second
    and the moves the last timed search chose."""
    dev = torch.device(device)
    rows = []
    for batch in batches:
        state = stack_boards(midgame_boards(batch), device=dev)
        for k in parallel_sims:
            spc = segment_size(config.simulations, k, sims_per_call)
            if spc is None:
                rows.append({"batch": batch, "parallel_sims": k, "skipped": True})
                continue
            run = make_chunked_search_fn(eval_fn, dataclasses.replace(config, parallel_sims=k), spc)
            _, first_s = _common.timed(lambda: run(state, make_generator(0, dev)), dev)
            times = []
            for i in range(repeats):
                res, dt = _common.timed(lambda: run(state, make_generator(i + 1, dev)), dev)
                times.append(dt)
            steady = min(times)
            rows.append({
                "batch": batch, "parallel_sims": k, "sims_per_call": spc, "first_s": first_s,
                "steady_s": steady, "sims_per_s": batch * config.simulations / steady,
                "ms_per_sim": steady / config.simulations * 1e3, "moves": res.move.tolist(),
            })
    return rows


def report(rows: list, sims: int, sims_per_call: int) -> None:
    for r in rows:
        if r.get("skipped"):
            print(f"skipping parallel_sims={r['parallel_sims']}: no segment size <= {sims_per_call} "
                  f"divides sims={sims} in whole K-iterations")
            continue
        print(f"batch {r['batch']:>5} K={r['parallel_sims']}: first {r['first_s']:6.1f}s  "
              f"steady {r['steady_s']:6.2f}s  {r['sims_per_s']:>10,.0f} sims/s  "
              f"{r['ms_per_sim']:6.2f} ms/sim", flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sims", type=int, default=800)
    parser.add_argument("--batches", type=int, nargs="+", default=[512, 600, 1024, 1200, 1280, 2048])
    parser.add_argument("--noise", action=argparse.BooleanOptionalAction, default=True,
                        help="root Dirichlet noise (disable with --no-noise)")
    parser.add_argument("--parallel-sims", type=int, nargs="+", default=[1])
    parser.add_argument("--sims-per-call", type=int, default=100,
                        help="segment searches into calls of at most this many simulations")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.eval.evaluators import make_net_evaluator

    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}", flush=True)
    config = MCTSConfig(
        simulations=args.sims,
        root_dirichlet_alpha=0.3 if args.noise else 0.0,
        root_exploration_fraction=0.25 if args.noise else 0.0,
        num_sampling_moves=6,
    )
    rows = sweep(make_net_evaluator(_common.fresh_net(dev)), config, args.batches, args.parallel_sims,
                 args.sims_per_call, dev)
    report(rows, args.sims, args.sims_per_call)
    result = {"device": _common.device_name(dev), "simulations": args.sims,
              "rows": [{k: v for k, v in r.items() if k != "moves"} for r in rows]}
    _common.emit(result)
    return rows


if __name__ == "__main__":
    main()
