"""Round-robin strength table between a run's saved generations.

The counterpart of the JAX package's ``scripts/matches.py``: every pair of
the listed generations plays all distinct k-ply start positions (2 by
default) in both colours, seeded ``g1 * 1000 + g2``, and the table of
returns (row against column) is printed. Players come from the run's
checkpoints through ``cli._load_player``; a checkpoint carries its net's
widths and compute dtype, so there are no width flags, and a bf16 net
plays through the tower kernel on the card. ``--parallel-sims`` sets the
walkers of both players (1, the JAX script's, by default).

    python -m connect4_tpu_torch.scripts.matches SAVE_DIR --gens 20 40 60 \\
        [--simulations 800] [--device cpu]
"""

from __future__ import annotations

import argparse
import itertools
from typing import Dict, Sequence, Tuple

from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import resolve_device


def round_robin(players: Dict[int, object], plies: int = 2, device=None) -> Dict[Tuple[int, int], float]:
    """``{(g1, g2): return of g1 against g2}`` for every pair ``g1 < g2`` in
    the order given, each pair seeded ``g1 * 1000 + g2``."""
    from connect4_tpu_torch.eval.match import play_match

    results = {}
    for g1, g2 in itertools.combinations(players, 2):
        res = play_match(players[g1], players[g2], plies=plies, switch=True, seed=g1 * 1000 + g2,
                         device=device)
        results[(g1, g2)] = res["return"]
    return results


def table_lines(gens: Sequence[int], results: Dict[Tuple[int, int], float]) -> list:
    """The JAX script's table of returns, row against column."""
    lines = ["", "returns (row vs column):", "      " + "  ".join(f"g{g:>4}" for g in gens)]
    for g1 in gens:
        row = []
        for g2 in gens:
            if (g1, g2) in results:
                row.append(f"{results[(g1, g2)]:.3f}")
            elif (g2, g1) in results:
                row.append(f"{1 - results[(g2, g1)]:.3f}")
            else:
                row.append("  -  ")
        lines.append(f"g{g1:>4}  " + "  ".join(row))
    return lines


def matches(save_dir: str, gens: Sequence[int], simulations: int = 800, plies: int = 2,
            parallel_sims: int = 1, device="cuda") -> dict:
    from connect4_tpu_torch.cli import _load_player

    dev = resolve_device(device)
    players = {}
    for g in gens:
        player = _load_player(f"gen{g}", save_dir, g, simulations, device=dev)
        player.config.parallel_sims = parallel_sims
        players[g] = player
    results = round_robin(players, plies, dev)
    return {"device": _common.device_name(dev), "gens": list(gens), "simulations": simulations,
            "plies": plies, "parallel_sims": parallel_sims,
            "returns": {f"{a}-{b}": r for (a, b), r in results.items()},
            "table": table_lines(gens, results)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("save_dir")
    parser.add_argument("--gens", type=int, nargs="+", required=True)
    parser.add_argument("--simulations", type=int, default=800)
    parser.add_argument("--plies", type=int, default=2)
    parser.add_argument("--parallel-sims", type=int, default=1)
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)
    r = matches(args.save_dir, args.gens, args.simulations, args.plies, args.parallel_sims, args.device)
    print("\n".join(r["table"]))
    _common.emit({k: v for k, v in r.items() if k != "table"})
    return r


if __name__ == "__main__":
    main()
