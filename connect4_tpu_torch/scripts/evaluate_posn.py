"""Evaluate one position: the net's output, and optionally a full search.

The counterpart of the JAX package's ``scripts/evaluate_posn.py``: reads an
ASCII position file (rows top-down, the characters o / x / . separated by
spaces), prints the board, the side to move and the net's (value, prior);
with ``--search`` it runs the batched MCTS (no noise, one generator seeded
0) and prints the chosen move, its value, both policies and the root
children's visit counts. The net is the packaged gen-161
(``models.convert.load_example_net``) unless ``--checkpoint-dir`` (and
``--generation``, default the latest) names a run's checkpoint, which
carries its net's widths.

    python -m connect4_tpu_torch.scripts.evaluate_posn POS_FILE [--checkpoint-dir DIR] \\
        [--generation N] [--simulations 800] [--search] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.scripts import _common
from connect4_tpu_torch.utils import resolve_device


def parse_position(path: str) -> HostBoard:
    """The board of an ASCII position file, as the JAX script reads it."""
    with open(path) as f:
        rows = [line.rstrip("\n") for line in f if line.strip()]
    o = np.zeros((6, 7), dtype=bool)
    x = np.zeros((6, 7), dtype=bool)
    for r, row in enumerate(rows[:6]):
        for c, ch in enumerate(row.split()[:7]):
            if ch == "o":
                o[r, c] = True
            elif ch == "x":
                x[r, c] = True
    return HostBoard.from_pieces(o, x)


def load_player(checkpoint_dir, generation, simulations: int, device):
    """The packaged gen-161 net, or a run's checkpoint, as a ``MatchPlayer``."""
    from connect4_tpu_torch.cli import _load_player
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.eval.match import MatchPlayer
    from connect4_tpu_torch.models.convert import load_example_net

    if checkpoint_dir is None:
        net = load_example_net(device=device)
        return MatchPlayer("gen161", make_net_evaluator(net), MCTSConfig(simulations=simulations))
    return _load_player("net", checkpoint_dir, generation, simulations, device=device)


@torch.no_grad()
def evaluate_posn(board: HostBoard, player, search: bool, device) -> dict:
    """The net's value and prior on ``board`` and, with ``search``, the
    search's move, value, policies and root children's visit counts."""
    from connect4_tpu_torch.env.convert import stack_boards
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.utils import make_generator

    dev = torch.device(device)
    state = stack_boards([board], device=dev)
    value, prior = player.evaluator(state)
    out = {"device": _common.device_name(dev), "player": player.name,
           "to_move": board.player_to_move.name,
           "value": float(value[0]), "prior": prior[0].cpu().tolist()}
    if search:
        res = make_search_fn(player.evaluator, player.config)(state, make_generator(0, dev))
        base = int(res.tree.children_base[0, 0])
        out.update({
            "simulations": player.config.simulations,
            "move": int(res.move[0]), "search_value": float(res.value[0]),
            "values_policy": res.values_policy[0].cpu().tolist(),
            "visit_policy": res.visit_policy[0].cpu().tolist(),
            "root_visits": res.tree.visits[0, base:base + 7].cpu().tolist() if base >= 0 else [0] * 7,
        })
    return out


def report(board: HostBoard, r: dict) -> None:
    print(board)
    print("to move:", r["to_move"])
    print("net value: {:.4f}".format(r["value"]))
    print("net prior:", np.round(np.asarray(r["prior"], dtype=np.float32), 4))
    if "move" in r:
        print("search move:", r["move"])
        print("search value: {:.4f}".format(r["search_value"]))
        print("values policy:", np.round(np.asarray(r["values_policy"], dtype=np.float32), 4))
        print("visit policy: ", np.round(np.asarray(r["visit_policy"], dtype=np.float32), 4))
        print("root visits:  ", r["root_visits"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("position")
    parser.add_argument("--checkpoint-dir", default=None)
    parser.add_argument("--generation", type=int, default=None)
    parser.add_argument("--simulations", type=int, default=800)
    parser.add_argument("--search", action="store_true")
    _common.add_device_arg(parser)
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    board = parse_position(args.position)
    player = load_player(args.checkpoint_dir, args.generation, args.simulations, dev)
    r = evaluate_posn(board, player, args.search, dev)
    report(board, r)
    _common.emit(r)
    return r


if __name__ == "__main__":
    main()
