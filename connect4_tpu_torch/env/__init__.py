from connect4_tpu_torch.env.core import (
    BoardState,
    flip_lr,
    has_four,
    initial_state,
    legal_moves,
    result_value,
    step,
    symmetrical,
    to_planes,
)
from connect4_tpu_torch.env.host_board import HostBoard, enumerate_start_positions

__all__ = [
    "BoardState",
    "HostBoard",
    "enumerate_start_positions",
    "flip_lr",
    "has_four",
    "initial_state",
    "legal_moves",
    "result_value",
    "step",
    "symmetrical",
    "to_planes",
]
