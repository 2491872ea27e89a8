"""Descent depth against board age, and segment cost against row count.

The counterpart of the JAX package's ``scripts/descent_depth_profile.py``,
which measures the two quantities that decide whether age-banded search
calls could cut the self-play tree walk:

1. **Descent depth by board age.** In the JAX search an iteration
   descends every row until the deepest one reaches a leaf, so in a
   mixed-age pool every row pays for the young rows' depth (on the card
   the port's descent kernel walks each row only to its own leaf).
   For boards still in play after 2, 8, ... 32 random plies: the depth the
   descent reaches (mean / p95 / max) after the first and after the last
   ``sims_per_call`` segment.
2. **Segment cost by rows.** Splitting one search call into age bands pays
   only if a segment's cost shrinks with its rows: one segment's time on a
   mixed-age pool of 32 ... 512 rows, in the form the main path runs (on
   the card, each iteration replayed from CUDA graphs).

The net is the packaged gen-161 (``--random-net``: a fresh F=64 / fc 6 /
res 6 bf16 net); boards come from seeded ``torch.Generator`` playouts.

    python -m connect4_tpu_torch.scripts.descent_depth_profile [--sims 800] [--k 8] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Sequence

import numpy as np
import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.core import BoardState
from connect4_tpu_torch.mcts.batched import Descent, Search, TreeArrays, _descent_start, descend
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import make_generator, resolve_device

PLIES = (2, 8, 14, 20, 26, 32)
POOL_ROWS = (32, 64, 128, 256, 512)


def measure_depth(tree: TreeArrays, state: BoardState, config: MCTSConfig) -> torch.Tensor:
    """The depth each row's descent reaches in ``tree`` (a workspace's
    slabs, dump column included), scored with K walkers' constant overlay
    as the JAX script scores it, as ``[rows]``: the descent kernel on the
    card, its plain version on the CPU (``batched.descend``)."""
    rows = torch.arange(state.age.shape[0], device=state.device)
    capacity = config.tree_capacity()
    d = Descent.empty(rows.shape[0], capacity, state.device)
    _descent_start(d, tree, state, torch.ones_like(rows, dtype=torch.bool), capacity)
    descend(d, tree, rows, config, capacity, config.parallel_sims)
    return d.depth


def _stats(depth: torch.Tensor):
    d = depth.cpu().numpy()
    return [float(d.mean()), float(np.percentile(d, 95)), int(d.max())]


@torch.no_grad()
def depth_by_age(eval_fn, boards: Dict[int, BoardState], config: MCTSConfig, sims_per_call: int) -> list:
    """For each ``ply -> boards``: the depth (mean, p95, max) after the first
    and after the last segment of one search (root noise from a generator
    seeded with the ply)."""
    n_segments = config.simulations // sims_per_call
    search = Search(eval_fn, config, sims_per_call)
    rows = []
    for ply, st in boards.items():
        ws = search.init(st, make_generator(ply, st.device))
        depths = []
        for s in range(n_segments):
            search.segment(ws)
            if s == 0 or s == n_segments - 1:
                depths.append(_stats(measure_depth(ws.tree, st, config)))
        rows.append({"ply": ply, "rows": int(st.age.shape[0]), "first": depths[0], "final": depths[-1]})
    return rows


@torch.no_grad()
def segment_cost_by_rows(eval_fn, pools: Dict[int, BoardState], config: MCTSConfig, sims_per_call: int,
                         reps: int = 3) -> list:
    """For each ``rows -> pool``: one segment's milliseconds on a tree one
    segment deep (each rep from a fresh root init and a first segment,
    which also warm the search), and the depth after it."""
    search = Search(eval_fn, config, sims_per_call)
    out = []
    for n_rows, st in pools.items():
        dev = st.device
        total = 0.0
        for _ in range(reps):
            ws = search.init(st, make_generator(n_rows, dev))
            search.segment(ws)  # warm and grow the tree
            _, dt = _common.timed(lambda: search.segment(ws), dev)
            total += dt
        ms = total / reps * 1e3
        mean, _, top = _stats(measure_depth(ws.tree, st, config))
        out.append({"rows": n_rows, "ms": ms, "ms_per_256_rows": ms / n_rows * 256,
                    "depth_mean": mean, "depth_max": top})
    return out


def mixed_pool(rows: int, seed: int, device) -> BoardState:
    """Equal parts of boards live at each of ``PLIES`` (the rest at the last)."""
    per = rows // len(PLIES)
    parts = []
    for i, ply in enumerate(PLIES):
        n = per if i < len(PLIES) - 1 else rows - per * (len(PLIES) - 1)
        parts.append(_common.live_boards_at_ply(ply, n, make_generator(seed + i, device), device))
    return _common.concat_states(parts)


def run(eval_fn, config: MCTSConfig, sims_per_call: int, rows: int, device,
        pool_rows: Sequence[int] = POOL_ROWS) -> dict:
    """Both measurements at the JAX script's plies and pool sizes."""
    dev = torch.device(device)
    boards = {ply: _common.live_boards_at_ply(ply, rows, make_generator(ply, dev), dev) for ply in PLIES}
    pools = {n: mixed_pool(n, 1000 + n, dev) for n in pool_rows}
    return {
        "device": _common.device_name(dev), "simulations": config.simulations,
        "parallel_sims": config.parallel_sims, "sims_per_call": sims_per_call, "rows": rows,
        "depth_by_age": depth_by_age(eval_fn, boards, config, sims_per_call),
        "segment_by_rows": segment_cost_by_rows(eval_fn, pools, config, sims_per_call),
    }


def report(r: dict) -> None:
    print(f"\n== descent depth by board age (rows={r['rows']}) ==")
    print("age | after 1st segment (mean/p95/max) | after final (mean/p95/max)")
    for row in r["depth_by_age"]:
        (m1, p1, x1), (m2, p2, x2) = row["first"], row["final"]
        print(f"{row['ply']:3d} | {m1:5.1f} / {p1:5.1f} / {x1:3d}          | {m2:5.1f} / {p2:5.1f} / {x2:3d}")
    print(f"\n== one {r['sims_per_call']}-sim segment wall-time vs rows (mixed ages) ==")
    for row in r["segment_by_rows"]:
        print(f"rows {row['rows']:4d}: {row['ms']:7.1f} ms/segment  ({row['ms_per_256_rows']:6.1f} ms "
              f"row-normalised to 256)  depth mean/max {row['depth_mean']:.1f}/{row['depth_max']}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--sims", type=int, default=800)
    parser.add_argument("--k", type=int, default=8)
    parser.add_argument("--sims-per-call", type=int, default=200)
    parser.add_argument("--rows", type=int, default=256)
    parser.add_argument("--random-net", action="store_true")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.models.convert import load_example_net

    dev = resolve_device(args.device)
    print(f"device: {_common.device_name(dev)}", flush=True)
    net = _common.fresh_net(dev) if args.random_net else load_example_net(device=dev)
    config = MCTSConfig(simulations=args.sims, root_dirichlet_alpha=0.3, root_exploration_fraction=0.25,
                        num_sampling_moves=6, parallel_sims=args.k)
    r = run(make_net_evaluator(net), config, args.sims_per_call, args.rows, dev)
    report(r)
    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
