"""ctypes bindings for the exact solver (``solver.cpp``).

The port's copy of ``connect4_tpu.native.solver``. The shared library is
built with g++ at first use by ``connect4_tpu_torch.build`` into
``build/native/`` at the root of the checkout, under a name that carries a
hash of the source, the flags and the CPU, never into the package
directory. The solver weak-solves arbitrary positions (win, draw or loss
for the side to move under perfect play) and is the data source of the
8-ply and 7-ply benchmark sets (``connect4_tpu_torch.data.datasets``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterable, List, Optional

import numpy as np

from connect4_tpu_torch import build
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.types import HEIGHT, Side

_H1 = HEIGHT + 1
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "solver.cpp")


_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load_library(SOURCE, build.GXX)
        lib.solver_create.restype = ctypes.c_void_p
        lib.solver_create.argtypes = [ctypes.c_uint64]
        lib.solver_destroy.argtypes = [ctypes.c_void_p]
        lib.solver_nodes.restype = ctypes.c_uint64
        lib.solver_nodes.argtypes = [ctypes.c_void_p]
        lib.solver_solve.restype = ctypes.c_int
        lib.solver_solve.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64]
        lib.solver_solve_batch.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
            ctypes.c_int,
            ctypes.c_uint64,
        ]
        _lib = lib
    return _lib


def board_to_bits(board: HostBoard) -> tuple:
    """(o_bits, x_bits) in the solver's col*7+row layout."""
    bits = [0, 0]
    for p in range(2):
        rows, cols = np.nonzero(board.pieces[p])
        for r, c in zip(rows, cols):
            bits[p] |= 1 << (int(c) * _H1 + int(r))
    return bits[0], bits[1]


class ExactSolver:
    """Weak solver: exact win/draw/loss outcomes under perfect play. The
    transposition table is shared across calls, so batch solves of related
    positions amortise each other."""

    def __init__(self, tt_size_pow2: int = 1 << 24):
        if tt_size_pow2 <= 0 or tt_size_pow2 & (tt_size_pow2 - 1):
            raise ValueError(f"tt_size_pow2={tt_size_pow2} is not a power of two")
        self._lib = _load()
        self._handle = self._lib.solver_create(tt_size_pow2)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.solver_destroy(self._handle)
            self._handle = None

    @property
    def nodes(self) -> int:
        return int(self._lib.solver_nodes(self._handle))

    def outcome_to_move(self, board: HostBoard) -> int:
        """-1 / 0 / +1 from the perspective of the side to move."""
        o_bits, x_bits = board_to_bits(board)
        if board.player_to_move == Side.o:
            return int(self._lib.solver_solve(self._handle, o_bits, x_bits))
        return int(self._lib.solver_solve(self._handle, x_bits, o_bits))

    def absolute_value(self, board: HostBoard) -> float:
        """Game-theoretic value in the framework's absolute convention
        (1.0 = o wins, 0.0 = x wins, 0.5 = draw)."""
        outcome = self.outcome_to_move(board)
        if board.player_to_move == Side.o:
            return {1: 1.0, 0: 0.5, -1: 0.0}[outcome]
        return {1: 0.0, 0: 0.5, -1: 1.0}[outcome]

    def absolute_values(
        self, boards: Iterable[HostBoard], n_threads: int = 0
    ) -> np.ndarray:
        """Vectorised ``absolute_value`` through the C batch entry point;
        ``n_threads=0`` uses all cores (workers share the table)."""
        boards = list(boards)
        if n_threads == 0:
            n_threads = os.cpu_count() or 1
        to_move = np.zeros(len(boards), dtype=np.uint64)
        other = np.zeros(len(boards), dtype=np.uint64)
        o_to_move = np.zeros(len(boards), dtype=bool)
        for i, b in enumerate(boards):
            o_bits, x_bits = board_to_bits(b)
            if b.player_to_move == Side.o:
                to_move[i], other[i], o_to_move[i] = o_bits, x_bits, True
            else:
                to_move[i], other[i] = x_bits, o_bits
        out = np.zeros(len(boards), dtype=np.int8)
        self._lib.solver_solve_batch(
            self._handle, to_move, other, len(boards), out, n_threads, 0
        )
        # outcome (side to move) -> absolute value
        value_to_move = (out.astype(np.float32) + 1.0) / 2.0
        return np.where(o_to_move, value_to_move, 1.0 - value_to_move)

    def optimal_moves(self, board: HostBoard) -> List[int]:
        """Moves achieving the best exact outcome for the side to move —
        the definition behind the reference's 7-ply policy labels
        (``oinkoink/scripts/generate_7ply.py:83-91``)."""
        side = board.player_to_move
        best_val, moves = -2.0, []
        for move in sorted(board.valid_moves):
            child = board.copy()
            child.make_move(move)
            if child.result is not None:
                absolute = child.result.value
            else:
                absolute = self.absolute_value(child)
            val = absolute if side == Side.o else 1.0 - absolute
            if val > best_val + 1e-9:
                best_val, moves = val, [move]
            elif abs(val - best_val) <= 1e-9:
                moves.append(move)
        return moves
