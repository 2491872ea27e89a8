"""The port's environment (``connect4_tpu_torch.env``) against the JAX
package's, bit for bit: the same moves, drawn with numpy, go through both
and every field must be equal (tolerance: none, all integer or boolean)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.env import core as jcore
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.env.host_board import HostBoard as JHostBoard
from connect4_tpu_torch.env import core
from connect4_tpu_torch.env.convert import stack_boards, unstack_state
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.types import ONGOING, WIDTH, Result

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

_jstep = jax.jit(jcore.step)
_jplanes = jax.jit(jcore.to_planes)
_jlegal = jax.jit(jcore.legal_moves)
_jhas_four = jax.jit(jcore.has_four)


def _equal(jstate, tstate):
    for name, j, t in zip(jstate._fields, jstate, tstate):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
        assert np.asarray(j).dtype == t.numpy().dtype, name


def _play(moves):
    state = core.initial_state((), device="cpu")
    for mv in moves:
        state = core.step(state, torch.tensor(mv))
    return state


def test_random_playouts_match_jax():
    """128 random games with a frozen-game mix, stepped in one batch by
    both environments: state, planes, legal moves and has_four agree at
    every ply."""
    rng = np.random.default_rng(0)
    batch = 128
    jstate = jcore.initial_state((batch,))
    tstate = core.initial_state((batch,), device="cpu")
    for t in range(44):  # two plies past a full board: finished games freeze
        legal = np.asarray(_jlegal(jstate))
        moves = np.array(
            [rng.choice(np.flatnonzero(r)) if r.any() else rng.integers(WIDTH) for r in legal],
            dtype=np.int32,
        )
        enabled = rng.random(batch) < 0.9
        jstate = _jstep(jstate, jnp.asarray(moves), jnp.asarray(enabled))
        tstate = core.step(tstate, torch.from_numpy(moves), torch.from_numpy(enabled))
        _equal(jstate, tstate)
        np.testing.assert_array_equal(
            np.asarray(_jplanes(jstate)), core.to_planes(tstate).numpy(), err_msg=f"ply {t}"
        )
        np.testing.assert_array_equal(
            np.asarray(jcore.to_planes(jstate, dtype=jnp.uint8)),
            core.to_planes(tstate, dtype=torch.uint8).numpy(),
        )
        np.testing.assert_array_equal(np.asarray(_jlegal(jstate)), core.legal_moves(tstate).numpy())
        np.testing.assert_array_equal(
            np.asarray(_jhas_four(jstate.pieces)), core.has_four(tstate.pieces).numpy()
        )
    assert (tstate.result != ONGOING).all()


def test_mirror_symmetry_and_result_value_match_jax():
    rng = np.random.default_rng(1)
    boards = []
    for _ in range(32):
        b = JHostBoard()
        for _ in range(rng.integers(0, 12)):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        boards.append(b)
    sym = JHostBoard()
    sym.make_move(3)
    boards.append(sym)
    jstate = jstack_boards(boards)
    tstate = stack_boards(boards, device="cpu")
    _equal(jcore.flip_lr(jstate), core.flip_lr(tstate))
    np.testing.assert_array_equal(np.asarray(jcore.symmetrical(jstate)), core.symmetrical(tstate).numpy())
    assert bool(core.symmetrical(tstate)[-1])
    codes = np.array([0, 1, 2, 3, 3, 1], dtype=np.int8)
    np.testing.assert_array_equal(
        np.asarray(jcore.result_value(jnp.asarray(codes))),
        core.result_value(torch.from_numpy(codes)).numpy(),
    )


@pytest.mark.parametrize(
    "moves,result",
    [([3, 0, 3, 1, 3, 2, 3], Result.o_win), ([6, 0, 6, 1, 6, 2, 5, 3], Result.x_win)],
)
def test_golden_games(moves, result):
    state = _play(moves)
    assert Result.from_code(int(state.result)) == result
    assert not core.legal_moves(state).any(), "no legal moves after a win"
    jstate = jcore.initial_state(())
    for mv in moves:
        jstate = _jstep(jstate, jnp.int32(mv))
    _equal(jstate, state)


def test_stepping_a_finished_game_freezes_it():
    state = _play([0, 1, 0, 1, 0, 1, 0])  # o wins in column 0
    for mv in range(WIDTH):
        after = core.step(state, torch.tensor(mv))
        for name, a, b in zip(state._fields, state, after):
            assert torch.equal(a, b), (mv, name)


def test_stack_unstack_round_trip():
    rng = np.random.default_rng(2)
    boards = []
    for n in range(0, 42, 3):
        b = HostBoard()
        for _ in range(n):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        boards.append(b)
    state = stack_boards(boards, device="cpu")
    _equal(jstack_boards(boards), state)
    back = unstack_state(state)
    for a, b in zip(boards, back):
        np.testing.assert_array_equal(a.pieces, b.pieces)
        np.testing.assert_array_equal(a.height, b.height)
        assert a.age == b.age and a.result == b.result
        np.testing.assert_array_equal(a.to_planes(), b.to_planes())


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, chip_smoke.py and bench_gpu.py import in
    a process where JAX, Flax, optax, Orbax, the JAX package, pandas and
    matplotlib cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'flax', 'optax', 'orbax', 'connect4_tpu', 'pandas', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import connect4_tpu_torch\n"
        "for m in pkgutil.walk_packages(connect4_tpu_torch.__path__, 'connect4_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "import bench_gpu\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)


def test_entry_points_refuse_a_missing_cuda():
    """The default device is CUDA; without a card an entry point raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        core.initial_state((2,))
