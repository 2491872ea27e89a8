"""Host <-> device board conversions (off the hot path)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from connect4_tpu_torch.env.core import BoardState
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.types import ONGOING, Result
from connect4_tpu_torch.utils import DeviceLike, resolve_device


def stack_boards(boards: Sequence[HostBoard], device: DeviceLike = None) -> BoardState:
    """Pack host boards into a batched BoardState [N, ...] on ``device``."""
    dev = resolve_device(device)
    pieces = np.stack([b.pieces for b in boards])
    height = np.stack([b.height for b in boards]).astype(np.int32)
    age = np.array([b.age for b in boards], dtype=np.int32)
    result = np.array(
        [ONGOING if b.result is None else b.result.code for b in boards],
        dtype=np.int8,
    )
    return BoardState(*(torch.from_numpy(a).to(dev) for a in (pieces, height, age, result)))


def unstack_state(state: BoardState) -> List[HostBoard]:
    """Unpack a batched state into host boards."""
    pieces, height, age, result = (x.cpu().numpy() for x in state)
    boards = []
    for i in range(pieces.shape[0]):
        b = HostBoard()
        b.pieces = pieces[i].copy()
        b.height = height[i].astype(np.int64)
        b.age = int(age[i])
        b.result = Result.from_code(int(result[i]))
        boards.append(b)
    return boards
