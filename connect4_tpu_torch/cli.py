"""Command-line interface of the PyTorch port.

- ``selfplay-demo`` — generate a handful of games and pretty-print one; a
  quick smoke test of the whole stack. ``--device cpu`` runs it without a
  GPU; the default is CUDA.

Run as ``python -m connect4_tpu_torch.cli <mode> ...``. The JAX package's
``game``, ``training`` and ``match`` modes are not ported yet.
"""

from __future__ import annotations

import argparse

import numpy as np


def game_str(moves, move_values, policies, length) -> str:
    """Pretty-print one recorded game, board by board (a copy of
    ``connect4_tpu.training.replay.game_str``)."""
    from connect4_tpu_torch.env.host_board import HostBoard

    board = HostBoard()
    out = [str(board)]
    for t in range(int(length)):
        board.make_move(int(moves[t]))
        out.append(
            "Move: {}  Value: {:.4f} Policy: {}\n{}".format(
                int(moves[t]),
                float(move_values[t]),
                np.round(np.asarray(policies[t]), 3),
                board,
            )
        )
    return "\n".join(out)


def cmd_selfplay_demo(args):
    import torch

    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
    from connect4_tpu_torch.training.self_play import make_play_fn
    from connect4_tpu_torch.types import DRAW, O_WIN, X_WIN
    from connect4_tpu_torch.utils import make_generator

    config = MCTSConfig(
        simulations=args.simulations,
        root_dirichlet_alpha=0.3,
        root_exploration_fraction=0.25,
        num_sampling_moves=6,
    )
    play = make_play_fn(centre_evaluator_batched, config, args.batch, device=args.device)
    out = play(make_generator(args.seed, args.device))
    out = type(out)(*(x.cpu().numpy() for x in out))
    results = out.result
    print(
        "games: {}  o wins: {}  draws: {}  x wins: {}  mean length: {:.1f}  device: {}".format(
            args.batch,
            int((results == O_WIN).sum()),
            int((results == DRAW).sum()),
            int((results == X_WIN).sum()),
            float(out.length.mean()),
            torch.device(args.device),
        )
    )
    print(game_str(out.moves[0], out.move_values[0], out.policies[0], out.length[0]))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="connect4_tpu_torch",
        description="AlphaZero-style Connect4, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="mode", required=True)
    d = sub.add_parser("selfplay-demo", help="generate a few games")
    d.add_argument("-b", "--batch", type=int, default=8)
    d.add_argument("-s", "--simulations", type=int, default=50)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    d.set_defaults(fn=cmd_selfplay_demo)
    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
