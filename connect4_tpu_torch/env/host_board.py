"""Host-side scalar Connect4 board.

A plain numpy implementation used *off* the hot path: CLI interactive play,
start-position enumeration for matches, dataset tooling, and as the golden
oracle in tests for the vectorized device environment. It deliberately
mirrors the behaviour (not the bitboard design) of the reference ``Board``
(``oinkoink/board.py:35-243``); the device hot path lives in
``connect4_tpu_torch.env.core``.

Internal layout matches ``core.BoardState``: row 0 is the *bottom* row.
``to_planes``/``from_pieces`` convert to/from the reference's top-down
orientation.
"""

from __future__ import annotations

from typing import List, Optional, Set

import numpy as np

from connect4_tpu_torch.types import AREA, HEIGHT, WIDTH, Result, Side

_WIN_OFFSETS = []
for dr, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
    for r in range(HEIGHT):
        for c in range(WIDTH):
            cells = [(r + i * dr, c + i * dc) for i in range(4)]
            if all(0 <= rr < HEIGHT and 0 <= cc < WIDTH for rr, cc in cells):
                _WIN_OFFSETS.append(cells)
_WIN_LINES = np.array(_WIN_OFFSETS, dtype=np.int64)  # [n_lines, 4, 2]


def _plane_has_four(plane: np.ndarray) -> bool:
    vals = plane[_WIN_LINES[:, :, 0], _WIN_LINES[:, :, 1]]
    return bool(np.any(np.all(vals, axis=1)))


class HostBoard:
    """Mutable scalar board with reference-compatible semantics."""

    __slots__ = ("pieces", "height", "age", "result")

    def __init__(self) -> None:
        self.pieces = np.zeros((2, HEIGHT, WIDTH), dtype=bool)
        self.height = np.zeros(WIDTH, dtype=np.int64)
        self.age = 0
        self.result: Optional[Result] = None

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_pieces(cls, o_pieces: np.ndarray, x_pieces: np.ndarray) -> "HostBoard":
        """Build from top-down 6x7 boolean planes (reference orientation,
        ``oinkoink/board.py:43-62``)."""
        board = cls()
        board.pieces[0] = np.flipud(np.asarray(o_pieces, dtype=bool))
        board.pieces[1] = np.flipud(np.asarray(x_pieces, dtype=bool))
        board.height = board.pieces.any(axis=0).sum(axis=0).astype(np.int64)
        board.age = int(board.pieces.sum())
        if _plane_has_four(board.pieces[0]):
            board.result = Result.o_win
        elif _plane_has_four(board.pieces[1]):
            board.result = Result.x_win
        elif board.age == AREA:
            board.result = Result.draw
        return board

    def copy(self) -> "HostBoard":
        board = HostBoard()
        board.pieces = self.pieces.copy()
        board.height = self.height.copy()
        board.age = self.age
        board.result = self.result
        return board

    __copy__ = copy

    # -- views -------------------------------------------------------------

    @property
    def o_pieces(self) -> np.ndarray:
        """Top-down o plane (reference orientation)."""
        return np.flipud(self.pieces[0])

    @property
    def x_pieces(self) -> np.ndarray:
        return np.flipud(self.pieces[1])

    @property
    def player_to_move(self) -> Side:
        return Side(self.age % 2)

    @property
    def valid_moves(self) -> Set[int]:
        if self.result is not None:
            return set()
        return {c for c in range(WIDTH) if self.height[c] < HEIGHT}

    @property
    def symmetrical(self) -> bool:
        return bool(np.array_equal(self.pieces, self.pieces[:, :, ::-1]))

    def to_planes(self) -> np.ndarray:
        """float32[3, 6, 7] network input, top-down, matching
        ``oinkoink/board.py:147-154``."""
        to_move = np.full((HEIGHT, WIDTH), 1.0 if self.age % 2 == 0 else 0.0)
        return np.stack([to_move, self.o_pieces, self.x_pieces]).astype(np.float32)

    def key(self):
        """Hashable position identity (piece planes only, like the
        reference's color-pair hash, ``oinkoink/board.py:198-203``)."""
        return self.pieces.tobytes()

    # -- mutation ----------------------------------------------------------

    def make_move(self, move: int) -> Optional[Result]:
        player = self.age % 2
        row = self.height[move]
        assert self.result is None and row < HEIGHT, (move, self)
        self.pieces[player, row, move] = True
        self.height[move] += 1
        self.age += 1
        if _plane_has_four(self.pieces[player]):
            self.result = Result.o_win if player == 0 else Result.x_win
        elif self.age == AREA:
            self.result = Result.draw
        return self.result

    def create_fliplr(self) -> "HostBoard":
        board = HostBoard()
        board.pieces = self.pieces[:, :, ::-1].copy()
        board.height = self.height[::-1].copy()
        board.age = self.age
        board.result = self.result
        return board

    # -- dunder ------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, HostBoard) and np.array_equal(self.pieces, other.pieces)

    def __hash__(self) -> int:
        return hash(self.key())

    def __str__(self) -> str:
        header = " ".join(str(c) for c in range(WIDTH))
        rows = []
        for r in range(HEIGHT - 1, -1, -1):
            cells = []
            for c in range(WIDTH):
                if self.pieces[0, r, c]:
                    cells.append("o")
                elif self.pieces[1, r, c]:
                    cells.append("x")
                else:
                    cells.append("-")
            rows.append(" ".join(cells))
        return header + "\n" + "\n".join(rows) + "\n" + header

    def __repr__(self) -> str:
        return "age: {}, result: {}\n{}".format(self.age, self.result, self)


def enumerate_start_positions(plies: int) -> List[HostBoard]:
    """All distinct non-terminal positions exactly ``plies`` moves deep,
    in a deterministic order. Equivalent to the reference's
    ``make_random_ips`` (``oinkoink/board.py:225-243``) but
    returns a stably-sorted list so batched matches are reproducible."""
    seen = {}

    def recurse(board: HostBoard, remaining: int) -> None:
        if remaining == 0:
            if board.result is None:
                seen.setdefault(board.key(), board)
            return
        for move in sorted(board.valid_moves):
            nxt = board.copy()
            nxt.make_move(move)
            recurse(nxt, remaining - 1)

    recurse(HostBoard(), plies)
    return [seen[k] for k in sorted(seen.keys())]
