"""The port's exact solver (``connect4_tpu_torch.native.solver``) against
the JAX package's: the same scores and optimal moves on seeded random
positions, batch against scalar, mirror invariance, and where and how the
library is built (``build/native/`` at the root of the checkout, never in
the package; two processes building at once each load a whole library).
Skips only where g++ is missing."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from connect4_tpu.env.host_board import HostBoard as JHostBoard
from connect4_tpu.native.solver import ExactSolver as JExactSolver
from connect4_tpu.native.solver import board_to_bits as jboard_to_bits
from connect4_tpu_torch import build
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.native import solver as tsolver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def solvers():
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: the solver is built with g++")
    return tsolver.ExactSolver(1 << 20), JExactSolver(1 << 20)


def _random_boards(seed, plies, n, cls=HostBoard):
    """``n`` unfinished positions at exactly ``plies`` moves of seeded
    random play (the same positions for either board class)."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        b = cls()
        for _ in range(plies):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        if b.result is None and b.age == plies:
            out.append(b)
    return out


@pytest.mark.parametrize("plies", [26, 32])
def test_solver_matches_jax(solvers, plies):
    mine, theirs = solvers
    boards = _random_boards(plies, plies, 12)
    jboards = _random_boards(plies, plies, 12, JHostBoard)
    for b, jb in zip(boards, jboards):
        assert tsolver.board_to_bits(b) == jboard_to_bits(jb)
        assert mine.outcome_to_move(b) == theirs.outcome_to_move(jb)
        assert mine.absolute_value(b) == theirs.absolute_value(jb)
        assert mine.optimal_moves(b) == theirs.optimal_moves(jb)
    np.testing.assert_array_equal(mine.absolute_values(boards, n_threads=2),
                                  theirs.absolute_values(jboards, n_threads=2))


def test_batch_matches_scalar_and_mirror(solvers):
    mine, _ = solvers
    boards = _random_boards(2, 30, 12)
    batch = mine.absolute_values(boards, n_threads=2)
    np.testing.assert_array_equal(batch, [mine.absolute_value(b) for b in boards])
    np.testing.assert_array_equal(batch, [mine.absolute_value(b.create_fliplr()) for b in boards])
    assert mine.nodes > 0


def test_tactics(solvers):
    mine, _ = solvers
    b = HostBoard()
    for m in [3, 0, 3, 1, 3, 2]:  # o has three stacked in column 3, to move
        b.make_move(m)
    assert mine.outcome_to_move(b) == 1 and mine.absolute_value(b) == 1.0
    b = HostBoard()
    for m in [6, 0, 6, 1, 5, 2]:  # x threatens column 3 only
        b.make_move(m)
    assert 3 in mine.optimal_moves(b)


def test_builds_into_build_native_and_not_the_package(solvers):
    path = build.library_path(tsolver.SOURCE, build.GXX)
    assert os.path.dirname(path) == os.path.join(ROOT, "build", "native")
    assert os.path.exists(path)
    package = os.path.dirname(tsolver.SOURCE)
    files = {f for f in os.listdir(package) if f != "__pycache__"}
    assert files == {"__init__.py", "solver.cpp", "solver.py"}, files


def test_concurrent_builds_each_find_a_whole_library(solvers, tmp_path):
    """Two processes build the same source into an empty directory at once
    (as two ranks or two test workers do): both load it."""
    code = (
        "from connect4_tpu_torch import build\n"
        "from connect4_tpu_torch.native import solver\n"
        f"tc = build.GXX._replace(build_dir={str(tmp_path)!r})\n"
        "build.load_library(solver.SOURCE, tc)\n"
        "print(build.library_path(solver.SOURCE, tc))\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1] and os.path.exists(outs[0])
    assert os.listdir(tmp_path) == [os.path.basename(outs[0])]  # no temporary file left
