"""Command-line interface of the PyTorch port.

Modes mirror the JAX package's CLI:

- ``game``: interactive human-vs-AI in the terminal (two games, one per
  colour); plays the packaged gen-161 net unless given a checkpoint.
- ``training``: run the training loop from a Python config file defining
  ``config`` (a ``connect4_tpu_torch.config.AlphaZeroConfig``). Under
  ``torchrun --nproc_per_node W`` (a config with ``mesh_shape=(W,)``) every
  process joins the group and trains data parallel; ``--device cuda`` is
  then ``cuda:<LOCAL_RANK>``.
- ``match``: head-to-head between two checkpoints (or the centre
  heuristic where no checkpoint directory is given). A checkpoint carries
  its net's architecture, so there are no width flags.
- ``selfplay-demo``: generate a handful of games and pretty-print one; a
  quick smoke test of the whole stack.

Every mode takes ``--device`` (default ``cuda``; ``--device cpu`` runs
without a GPU). Run as ``python -m connect4_tpu_torch.cli <mode> ...``.
"""

from __future__ import annotations

import argparse

import numpy as np


def _load_player(name, ckpt_dir, gen, sims, max_nodes=None, device=None):
    """Build a MatchPlayer from a checkpoint directory of the port (a
    training ``save_dir`` holding ``<gen>/ckpt``; the checkpoint carries its
    net's architecture), or the centre heuristic when ``ckpt_dir`` is None."""
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import (
        centre_evaluator_batched,
        make_net_evaluator,
    )
    from connect4_tpu_torch.eval.match import MatchPlayer
    from connect4_tpu_torch.training import checkpoint as ckpt

    config = MCTSConfig(simulations=sims, max_nodes=max_nodes)
    if ckpt_dir is None:
        return MatchPlayer(name, centre_evaluator_batched, config)

    if gen is None:
        restored = ckpt.restore_latest(ckpt_dir, device=device)
        if restored is None:
            raise FileNotFoundError(f"no readable checkpoints under {ckpt_dir}")
        gen, state, _ = restored
    else:
        state, _ = ckpt.restore_checkpoint(ckpt_dir, gen, device=device)
    return MatchPlayer(f"{name}(gen{gen})", make_net_evaluator(state.net), config)


def _interactive_game(ai_player, human_side, device):
    """One human-vs-AI game in the terminal."""
    from connect4_tpu_torch.env.convert import stack_boards
    from connect4_tpu_torch.env.host_board import HostBoard
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.types import Side
    from connect4_tpu_torch.utils import make_generator

    search = make_search_fn(ai_player.evaluator, ai_player.config)
    board = HostBoard()
    generator = make_generator(np.random.randint(0, 2**31 - 1), device)
    print(board)
    while board.result is None:
        if board.player_to_move == human_side:
            move = -1
            while move not in board.valid_moves:
                try:
                    move = int(
                        input(
                            "Enter User ({}'s) move:".format(
                                Side.as_str(board.player_to_move)
                            )
                        )
                    )
                except ValueError:
                    print("Not a valid move. Try again:")
            board.make_move(move)
        else:
            res = search(stack_boards([board], device=device), generator)
            move = int(res.move[0])
            value = float(res.value[0])
            policy = np.round(res.visit_policy[0].cpu().numpy(), 3)
            print(
                "{} selected move: {}, value: {:.4f}, prior: {}".format(
                    ai_player.name, move, value, policy
                )
            )
            board.make_move(move)
        print(board)
    print("Result:", board.result)
    return board.result


def cmd_game(args):
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.eval.match import MatchPlayer
    from connect4_tpu_torch.models.convert import EXAMPLE_NET, load_example_net
    from connect4_tpu_torch.types import Side

    if args.checkpoint_dir is None:
        # default to the packaged trained net
        print(f"Using packaged example net ({EXAMPLE_NET})")
        net = load_example_net(device=args.device)
        ai = MatchPlayer("AI(gen161)", make_net_evaluator(net), MCTSConfig(simulations=args.simulations))
    else:
        ai = _load_player(
            "AI", args.checkpoint_dir, args.generation, args.simulations, device=args.device
        )
    # two games, one per colour
    _interactive_game(ai, Side.o, args.device)
    _interactive_game(ai, Side.x, args.device)


def cmd_training(args):
    import os

    from connect4_tpu_torch.config import load_config_file
    from connect4_tpu_torch.training.loop import TrainingLoop

    config = load_config_file(args.config)
    if "WORLD_SIZE" not in os.environ:  # not launched by torchrun
        TrainingLoop(config, device=args.device).run(args.generations, until=args.until_generation)
        return
    import torch.distributed as dist

    from connect4_tpu_torch.parallel.mesh import initialize_distributed, local_device

    device = local_device(args.device)
    initialize_distributed("gloo" if device.type == "cpu" else "nccl", device)
    try:
        TrainingLoop(config, device=device).run(args.generations, until=args.until_generation)
    finally:
        dist.destroy_process_group()


def cmd_match(args):
    from connect4_tpu_torch.eval.match import play_match

    p1 = _load_player(
        "player1", args.checkpoint_dir_1, args.generation_1, args.simulations, device=args.device
    )
    p2 = _load_player(
        "player2", args.checkpoint_dir_2, args.generation_2, args.simulations, device=args.device
    )
    play_match(p1, p2, plies=args.plies, switch=True, seed=args.seed, device=args.device)


def cmd_selfplay_demo(args):
    import torch

    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
    from connect4_tpu_torch.training.replay import game_str
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

    g = sub.add_parser("game", help="play against the AI in the terminal")
    g.add_argument("-n", "--checkpoint-dir", default=None,
                   help="training save_dir holding <gen>/ckpt (default: packaged example net)")
    g.add_argument("-g", "--generation", type=int, default=None)
    g.add_argument("-s", "--simulations", type=int, default=800)
    g.set_defaults(fn=cmd_game)

    t = sub.add_parser("training", help="run the training loop")
    t.add_argument("-c", "--config", required=True, help="Python config file defining `config`")
    t.add_argument("--generations", type=int, default=None,
                   help="stop after N generations (default: run forever)")
    t.add_argument("--until-generation", type=int, default=None,
                   help="stop after the given absolute generation number "
                        "(restart-safe: resumed runs still stop there)")
    t.set_defaults(fn=cmd_training)

    m = sub.add_parser("match", help="head-to-head between checkpoints")
    m.add_argument("--checkpoint-dir-1", default=None)
    m.add_argument("--generation-1", type=int, default=None)
    m.add_argument("--checkpoint-dir-2", default=None)
    m.add_argument("--generation-2", type=int, default=None)
    m.add_argument("-s", "--simulations", type=int, default=800)
    m.add_argument("--plies", type=int, default=2)
    m.add_argument("--seed", type=int, default=0)
    m.set_defaults(fn=cmd_match)

    d = sub.add_parser("selfplay-demo", help="generate a few games")
    d.add_argument("-b", "--batch", type=int, default=8)
    d.add_argument("-s", "--simulations", type=int, default=50)
    d.add_argument("--seed", type=int, default=0)
    d.set_defaults(fn=cmd_selfplay_demo)

    for p in (g, t, m, d):
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    args = parser.parse_args(argv)
    if args.mode == "game" and args.simulations <= 0:
        raise ValueError("Simulations must be a positive integer")
    args.fn(args)


if __name__ == "__main__":
    main()
