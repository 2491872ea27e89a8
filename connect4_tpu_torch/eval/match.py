"""Batched match system.

The counterpart of ``connect4_tpu.eval.match``: all games of a pairing
share a start-position set (every distinct non-terminal k-ply position),
and because every game in a sub-batch starts at the same ply, the side to
move is uniform across the batch at every step: each step is exactly one
batched MCTS for whichever player owns that colour.

With ``switch=True`` the pairing is mirrored (player 2 takes the o seat on
the same start set) and mirrored results are flipped before aggregation.
The return is ``(wins + 0.5 draws) / n``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.env.core import result_value, step
from connect4_tpu_torch.env.host_board import HostBoard, enumerate_start_positions
from connect4_tpu_torch.eval.evaluators import BatchedEvaluator
from connect4_tpu_torch.mcts.batched import make_search_fn
from connect4_tpu_torch.types import AREA, ONGOING, Side
from connect4_tpu_torch.utils import DeviceLike, make_generator, resolve_device


@dataclasses.dataclass
class MatchPlayer:
    """A named agent: batched evaluator + search settings."""

    name: str
    evaluator: BatchedEvaluator
    config: MCTSConfig


def _search_move_fn(player: MatchPlayer):
    """``(state, generator, active) -> move`` for one player."""
    search = make_search_fn(player.evaluator, player.config)

    def run(state, generator, active):
        return search(state, generator, active).move

    return run


@torch.no_grad()
def _play_sub_batch(
    search_o,
    search_x,
    boards: List[HostBoard],
    seed: int,
    device: DeviceLike = None,
) -> np.ndarray:
    """Play every game to completion; returns o-perspective result values."""
    ages = {b.age for b in boards}
    if len(ages) != 1:
        raise ValueError(
            "play_match start boards must share a single start age (the "
            "lockstep loop derives the side to move from the shared ply "
            f"counter); got ages {sorted(ages)}"
        )
    dev = resolve_device(device)
    state = stack_boards(boards, device=dev)
    generator = make_generator(seed, dev)
    searches = {Side.o: search_o, Side.x: search_x}

    start_age = boards[0].age
    for i in range(AREA - start_age):
        active = state.result == ONGOING
        if not bool(active.any()):
            break
        # all games share start parity and step in lockstep, so the side to
        # move in every live game is determined by the ply counter (frozen
        # finished games no longer advance their age)
        side = Side((start_age + i) % 2)
        move = searches[side](state, generator, active)
        state = step(state, move, active)
    return result_value(state.result).cpu().numpy()


def play_match(
    player_1: MatchPlayer,
    player_2: MatchPlayer,
    plies: int = 0,
    switch: bool = False,
    seed: int = 0,
    display: bool = True,
    start_boards: Optional[List[HostBoard]] = None,
    device: DeviceLike = None,
) -> Dict[str, float]:
    """Play all k-ply start positions with player_1 as o (plus the mirrored
    set when ``switch``); returns the summary dict ``{"wins", "draws",
    "losses", "return"}`` from player_1's side."""
    boards = start_boards if start_boards is not None else enumerate_start_positions(plies)

    search_1 = _search_move_fn(player_1)
    search_2 = _search_move_fn(player_2)
    results = _play_sub_batch(search_1, search_2, boards, seed, device)
    if switch:
        flipped = _play_sub_batch(search_2, search_1, boards, seed + 1, device)
        results = np.concatenate([results, 1.0 - flipped])

    wins = int((results == 1.0).sum())
    draws = int((results == 0.5).sum())
    losses = int((results == 0.0).sum())
    return_ = (wins + 0.5 * draws) / max(wins + draws + losses, 1)

    if display:
        print(
            "The results for {} vs {} are: {} wins, {} draws, {} losses, "
            "{:.3f} return".format(
                player_1.name, player_2.name, wins, draws, losses, return_
            )
        )

    return {"wins": wins, "draws": draws, "losses": losses, "return": return_}
