"""Fixed-depth minimax reference player.

A copy of ``connect4_tpu.eval.grid_search`` under the port's imports: the
reference's ``GridSearch`` (``oinkoink/grid_search.py:12-71``), full-width
expansion to a fixed depth, minimax (o maximises the absolute value, x
minimises), terminal values nudged by -/+ age/10000 so that wins are
preferred sooner and losses later. A deterministic opponent and oracle for
the search tests; not a performance path.
"""

from __future__ import annotations

from typing import Callable, Tuple

from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.types import Result, Side, value_to_side


def _terminal_value(board: HostBoard) -> float:
    value = board.result.value
    # prefer faster wins and slower losses (grid_search.py:44-50)
    if board.result == Result.o_win:
        return value - board.age / 10000.0
    return value + board.age / 10000.0


def minimax_value(
    board: HostBoard,
    plies: int,
    evaluate_fn: Callable[[HostBoard], float],
) -> float:
    """Absolute-value minimax with leaf evaluation."""
    if board.result is not None:
        return _terminal_value(board)
    if plies == 0:
        return evaluate_fn(board)
    values = []
    for move in sorted(board.valid_moves):
        child = board.copy()
        child.make_move(move)
        values.append(minimax_value(child, plies - 1, evaluate_fn))
    return max(values) if board.player_to_move == Side.o else min(values)


class GridSearch:
    """Depth-limited minimax player with the reference's move-choice rules:
    immediate terminal children count as their exact result value (the age
    nudge applies only deeper), ties break toward the larger move."""

    def __init__(self, plies: int, evaluate_fn: Callable[[HostBoard], float]):
        self.plies = plies
        self.evaluate_fn = evaluate_fn

    def choose(self, board: HostBoard) -> Tuple[int, float]:
        side = board.player_to_move
        best_move, best_val = -1, -float("inf")
        for move in sorted(board.valid_moves):
            child = board.copy()
            child.make_move(move)
            if child.result is not None:
                absolute = child.result.value
            else:
                absolute = minimax_value(child, self.plies - 1, self.evaluate_fn)
            val = value_to_side(absolute, side)
            if val >= best_val:  # >= biases ties toward the larger move
                best_val, best_move = val, move
        return best_move, best_val

    def make_move(self, board: HostBoard) -> Tuple[int, float]:
        move, value = self.choose(board)
        board.make_move(move)
        return move, value
