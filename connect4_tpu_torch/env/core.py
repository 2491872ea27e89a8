"""Vectorised Connect4 environment on torch tensors.

The counterpart of ``connect4_tpu.env.core``: a struct of arrays with an
arbitrary leading batch shape, so thousands of games step in lockstep in a
few tensor ops. Win detection is a static-slice shift-AND over boolean
piece planes.

Conventions (the same as the JAX package, so tests compare like with like):

- ``pieces[..., p, r, c]`` — True when player ``p`` (0 = o, 1 = x) has a
  stone at row ``r`` (row 0 is the *bottom*), column ``c``.
- ``height[..., c]`` — int32 number of stones in column ``c``.
- ``age[...]`` — int32 total stones on the board; side to move is ``age % 2``.
- ``result[...]`` — int8 result code (see ``connect4_tpu_torch.types``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from connect4_tpu_torch.types import AREA, DRAW, HEIGHT, O_WIN, ONGOING, RESULT_VALUE, WIDTH, X_WIN
from connect4_tpu_torch.utils import DeviceLike, resolve_device


class BoardState(NamedTuple):
    """Batched Connect4 position."""

    pieces: torch.Tensor  # bool[..., 2, HEIGHT, WIDTH], row 0 = bottom
    height: torch.Tensor  # int32[..., WIDTH]
    age: torch.Tensor  # int32[...]
    result: torch.Tensor  # int8[...]

    @property
    def batch_shape(self):
        return tuple(self.age.shape)

    @property
    def device(self) -> torch.device:
        return self.age.device

    def map(self, fn) -> "BoardState":
        """Apply ``fn`` to every field (the port's ``tree_map``)."""
        return BoardState(*(fn(x) for x in self))


def initial_state(batch_shape: tuple = (), device: DeviceLike = None) -> BoardState:
    """Empty board(s) with the given leading batch shape."""
    dev = resolve_device(device)
    batch_shape = tuple(batch_shape)
    return BoardState(
        pieces=torch.zeros(batch_shape + (2, HEIGHT, WIDTH), dtype=torch.bool, device=dev),
        height=torch.zeros(batch_shape + (WIDTH,), dtype=torch.int32, device=dev),
        age=torch.zeros(batch_shape, dtype=torch.int32, device=dev),
        result=torch.zeros(batch_shape, dtype=torch.int8, device=dev),
    )


def has_four(plane: torch.Tensor) -> torch.Tensor:
    """True where ``plane`` (bool[..., HEIGHT, WIDTH]) contains 4 in a row."""
    p = plane
    horiz = p[..., :, :-3] & p[..., :, 1:-2] & p[..., :, 2:-1] & p[..., :, 3:]
    vert = p[..., :-3, :] & p[..., 1:-2, :] & p[..., 2:-1, :] & p[..., 3:, :]
    diag = p[..., :-3, :-3] & p[..., 1:-2, 1:-2] & p[..., 2:-1, 2:-1] & p[..., 3:, 3:]
    anti = p[..., :-3, 3:] & p[..., 1:-2, 2:-1] & p[..., 2:-1, 1:-2] & p[..., 3:, :-3]
    return (
        horiz.flatten(-2).any(-1)
        | vert.flatten(-2).any(-1)
        | diag.flatten(-2).any(-1)
        | anti.flatten(-2).any(-1)
    )


def legal_moves(state: BoardState) -> torch.Tensor:
    """bool[..., WIDTH] — playable columns; all-False once the game is over."""
    return (state.height < HEIGHT) & (state.result == ONGOING).unsqueeze(-1)


def place_stone(pieces, height, age, move):
    """Pieces and height after the side to move drops a stone into column
    ``move``, with no win check (shared by ``step`` and the search's
    descent step)."""
    player = age.long() % 2
    row = torch.gather(height, -1, move.long().unsqueeze(-1)).squeeze(-1)
    rows = torch.arange(HEIGHT, dtype=torch.int32, device=age.device)
    cols = torch.arange(WIDTH, dtype=torch.int32, device=age.device)
    cell = (rows[:, None] == row[..., None, None]) & (
        cols[None, :] == move[..., None, None]
    )  # bool[..., H, W]
    side_sel = torch.arange(2, device=age.device)[:, None, None] == player[..., None, None, None]
    new_pieces = pieces | (side_sel & cell.unsqueeze(-3))
    new_height = height + (cols == move.unsqueeze(-1)).to(torch.int32)
    return new_pieces, new_height, player


def step(
    state: BoardState,
    move: torch.Tensor,
    enabled: Optional[torch.Tensor] = None,
) -> BoardState:
    """Drop the side-to-move's stone into column ``move`` (int[...]).

    ``enabled`` (bool[...]) optionally freezes entries; finished games are
    always frozen. The caller is responsible for ``move`` being legal on
    enabled, ongoing games. Place stone, check win for the mover, then
    draw when the board fills."""
    new_pieces, new_height, player = place_stone(
        state.pieces, state.height, state.age, move
    )
    new_age = state.age + 1
    mover_plane = torch.where(
        (player == 0)[..., None, None], new_pieces[..., 0, :, :], new_pieces[..., 1, :, :]
    )
    won = has_four(mover_plane)
    new_result = torch.where(
        won,
        (player + 1).to(torch.int8),  # O_WIN=1 for player 0, X_WIN=2 for player 1
        torch.where(new_age >= AREA, DRAW, ONGOING).to(torch.int8),
    )

    active = state.result == ONGOING
    if enabled is not None:
        active = active & enabled
    return BoardState(
        pieces=torch.where(active[..., None, None, None], new_pieces, state.pieces),
        height=torch.where(active[..., None], new_height, state.height),
        age=torch.where(active, new_age, state.age),
        result=torch.where(active, new_result, state.result),
    )


def to_planes(state: BoardState, dtype=torch.float32) -> torch.Tensor:
    """Network input planes, shape ``[..., 3, HEIGHT, WIDTH]``.

    Channel 0 is all-ones when o is to move (else zeros), channels 1/2 are
    o/x stones, with row 0 at the *top* to match the reference encoding."""
    to_move = (state.age % 2 == 0)[..., None, None].expand(
        state.age.shape + (HEIGHT, WIDTH)
    )
    top_down = torch.flip(state.pieces, dims=(-2,))  # row 0 = top
    return torch.stack(
        [to_move, top_down[..., 0, :, :], top_down[..., 1, :, :]], dim=-3
    ).to(dtype)


def flip_lr(state: BoardState) -> BoardState:
    """Mirror the board about the centre column."""
    return BoardState(
        pieces=torch.flip(state.pieces, dims=(-1,)),
        height=torch.flip(state.height, dims=(-1,)),
        age=state.age,
        result=state.result,
    )


def symmetrical(state: BoardState) -> torch.Tensor:
    """bool[...] — True when the position equals its left-right mirror."""
    return (state.pieces == torch.flip(state.pieces, dims=(-1,))).flatten(-3).all(-1)


def result_value(result_code: torch.Tensor) -> torch.Tensor:
    """float32[...] absolute value of a *terminal* result code
    (``RESULT_VALUE``), from constants in the ops rather than a table
    copied from the host: the search calls this inside a CUDA graph, which
    cannot hold a copy from pageable host memory."""
    code = result_code.long()
    v = torch.full(code.shape, float(RESULT_VALUE[ONGOING]), dtype=torch.float32, device=code.device)
    for c in (O_WIN, X_WIN, DRAW):
        v = torch.where(code == c, float(RESULT_VALUE[c]), v)
    return v
