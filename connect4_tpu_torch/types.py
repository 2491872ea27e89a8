"""Core types and conventions of the PyTorch port (a copy of
``connect4_tpu.types``, kept here so the port never imports the JAX package).

Conventions follow the reference implementation (oinkoink):

- Board is 6 rows x 7 columns (``oinkoink/utils.py:4-7``).
- ``Side.o`` (player 0) always moves first; side to move is ``age % 2``
  (``oinkoink/board.py:85-86``).
- Values are *absolute* in ``[0, 1]`` where ``1.0`` means the first player
  (o) wins, ``0.0`` means x wins and ``0.5`` a draw
  (``oinkoink/utils.py:19-22``).

Game results are additionally represented on-device as a small int8 code so
that batched array programs can carry them without object types:

====  =========
code  meaning
====  =========
0     game in progress
1     o wins  (value 1.0)
2     x wins  (value 0.0)
3     draw    (value 0.5)
====  =========
"""

from __future__ import annotations

import enum

import numpy as np

HEIGHT: int = 6
WIDTH: int = 7
AREA: int = HEIGHT * WIDTH  # 42

# Result codes used inside array programs.
ONGOING: int = 0
O_WIN: int = 1
X_WIN: int = 2
DRAW: int = 3

# Map result code -> absolute value. Index 0 (ongoing) is a placeholder and
# must never be read as a value; 0.5 keeps accidental reads finite.
RESULT_VALUE = np.array([0.5, 1.0, 0.0, 0.5], dtype=np.float32)


class Side(enum.IntEnum):
    """Player identifier; ``o`` moves first."""

    o = 0
    x = 1

    @classmethod
    def as_str(cls, side: "Side") -> str:
        return "o" if side == cls.o else "x"


class Result(enum.Enum):
    """Game outcome carrying its absolute value, reference-compatible
    (``oinkoink/utils.py:19-22``)."""

    o_win = 1.0
    x_win = 0.0
    draw = 0.5

    @property
    def code(self) -> int:
        return {Result.o_win: O_WIN, Result.x_win: X_WIN, Result.draw: DRAW}[self]

    @classmethod
    def from_code(cls, code: int) -> "Result | None":
        return {ONGOING: None, O_WIN: cls.o_win, X_WIN: cls.x_win, DRAW: cls.draw}[int(code)]


def same_side(result: Result, side: Side) -> bool:
    """True when ``result`` is a win for ``side``."""
    return (result == Result.o_win and side == Side.o) or (
        result == Result.x_win and side == Side.x
    )


def value_to_side(value: float, side: Side) -> float:
    """Convert an absolute value into ``side``'s perspective
    (``oinkoink/utils.py:33-34``)."""
    return value if side == Side.o else (1.0 - value)
