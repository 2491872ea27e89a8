"""Connect Four rules in plain PyTorch, for the benchmark's own use.

Written from the game's rules and the published input encoding of the
oinkoink net (willis-richard/connect4, ``oinkoink/board.py``), not from the
program under test. A batch of boards is a ``Boards``: ``grid[N, 6, 7]``
int8 with 0 empty, 1 a stone of o (who moves first) and 2 one of x, row 0
the bottom; ``height[N, 7]`` stones a column; ``age[N]`` stones on the
board, so the side to move is ``age % 2`` (0 = o).

Results: 0 ongoing, 1 o won, 2 x won, 3 drawn; values are absolute, 1.0
when o wins, 0.0 when x wins, 0.5 for a draw.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ROWS, COLS = 6, 7
CELLS = ROWS * COLS
ONGOING, O_WIN, X_WIN, DRAW = 0, 1, 2, 3


class Boards(NamedTuple):
    grid: torch.Tensor  # int8[N, 6, 7]
    height: torch.Tensor  # int64[N, 7]
    age: torch.Tensor  # int64[N]

    def take(self, idx: torch.Tensor) -> "Boards":
        return Boards(self.grid[idx], self.height[idx], self.age[idx])


def empty(n: int, device) -> Boards:
    return Boards(
        torch.zeros((n, ROWS, COLS), dtype=torch.int8, device=device),
        torch.zeros((n, COLS), dtype=torch.long, device=device),
        torch.zeros((n,), dtype=torch.long, device=device),
    )


def legal(b: Boards) -> torch.Tensor:
    """bool[N, 7]: columns with room."""
    return b.height < ROWS


def four_in_a_row(stones: torch.Tensor) -> torch.Tensor:
    """bool[N]: ``stones`` (bool[N, 6, 7]) holds four in a line."""
    s = stones
    lines = (
        s[:, :, :-3] & s[:, :, 1:-2] & s[:, :, 2:-1] & s[:, :, 3:],
        s[:, :-3, :] & s[:, 1:-2, :] & s[:, 2:-1, :] & s[:, 3:, :],
        s[:, :-3, :-3] & s[:, 1:-2, 1:-2] & s[:, 2:-1, 2:-1] & s[:, 3:, 3:],
        s[:, :-3, 3:] & s[:, 1:-2, 2:-1] & s[:, 2:-1, 1:-2] & s[:, 3:, :-3],
    )
    return torch.stack([x.flatten(1).any(1) for x in lines]).any(0)


def play(b: Boards, col: torch.Tensor, on: torch.Tensor) -> tuple:
    """Drop the side to move's stone into ``col`` where ``on``; the caller
    makes sure the column has room there. Returns ``(boards, result)``,
    the result from the mover's line (a win) or a full board (a draw)."""
    n = col.shape[0]
    rows = torch.arange(n, device=col.device)
    col = col.long()
    row = b.height[rows, col].clamp(max=ROWS - 1)
    stone = (b.age % 2 + 1).to(torch.int8)
    grid = b.grid.clone()
    grid[rows[on], row[on], col[on]] = stone[on]
    height = b.height.clone()
    height[rows[on], col[on]] += 1
    age = b.age + on.long()
    won = four_in_a_row(grid == stone[:, None, None])
    result = torch.where(won, stone.long(), torch.where(age >= CELLS, DRAW, ONGOING))
    result = torch.where(on, result, torch.zeros_like(result))
    return Boards(grid, height, age), result


def status(b: Boards) -> torch.Tensor:
    """int64[N]: the result of each board as it stands (a board with both
    sides holding four is reported as o's win; no legal game reaches one)."""
    o = four_in_a_row(b.grid == 1)
    x = four_in_a_row(b.grid == 2)
    full = b.age >= CELLS
    return torch.where(o, O_WIN, torch.where(x, X_WIN, torch.where(full, DRAW, ONGOING)))


def well_formed(b: Boards) -> torch.Tensor:
    """bool[N]: stones rest on stones, heights and age agree with the grid,
    and o has as many stones as x or one more."""
    filled = b.grid != 0
    rows = torch.arange(ROWS, device=b.grid.device)[None, :, None]
    stacked = (filled == (rows < b.height[:, None, :])).flatten(1).all(1)
    n_o = (b.grid == 1).flatten(1).sum(1)
    n_x = (b.grid == 2).flatten(1).sum(1)
    return stacked & (n_o + n_x == b.age) & ((n_o == n_x) | (n_o == n_x + 1))


def planes(b: Boards) -> torch.Tensor:
    """float32[N, 3, 6, 7] net input: channel 0 all ones when o is to move,
    channels 1 and 2 the stones of o and of x, row 0 the *top* row."""
    top_down = torch.flip(b.grid, dims=(1,))
    to_move = (b.age % 2 == 0).float()[:, None, None].expand(-1, ROWS, COLS)
    return torch.stack([to_move, (top_down == 1).float(), (top_down == 2).float()], dim=1)


def from_planes(p: torch.Tensor) -> Boards:
    """The boards of ``p`` ([N, 3, 6, 7], the encoding of ``planes``)."""
    bottom_up = torch.flip(p[:, 1:], dims=(2,)) > 0.5
    grid = bottom_up[:, 0].to(torch.int8) + 2 * bottom_up[:, 1].to(torch.int8)
    height = (grid != 0).sum(1).long()
    return Boards(grid, height, height.sum(1))


def result_value(result: torch.Tensor) -> torch.Tensor:
    """float32 absolute value of a finished game's result."""
    return torch.where(result == O_WIN, 1.0, torch.where(result == X_WIN, 0.0, 0.5)).float()
