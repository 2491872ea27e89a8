"""The port's reference searches (``mcts.host.HostMCTS``,
``eval.grid_search``, the host centre evaluator and the lockstep walker
form ``mcts.batched._simulate_parallel_reference``) against the JAX
package's, and the port's batched search against its own host oracle, on
the tactic and fidelity boards of ``tests/test_mcts.py``. The host searches
are numpy in both packages with the same operations, so moves, values and
visit counts are equal; the walker form equals the JAX one bit for bit and
the port's deduplicated search in topology and visits (value sums within
1e-4, the JAX tests' tolerance for the two orders of summation)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.env.host_board import HostBoard as JHostBoard
from connect4_tpu.eval import evaluators as jev
from connect4_tpu.eval.grid_search import GridSearch as JGridSearch
from connect4_tpu.eval.grid_search import minimax_value as jminimax_value
from connect4_tpu.mcts import batched as jb
from connect4_tpu.mcts.host import HostMCTS as JHostMCTS
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval import evaluators as tev
from connect4_tpu_torch.eval.grid_search import GridSearch, minimax_value
from connect4_tpu_torch.mcts import batched as tb
from connect4_tpu_torch.mcts.host import HostMCTS
from connect4_tpu_torch.types import WIDTH

torch.set_num_threads(1)

# (moves to reach the position, plies, acceptable best moves): tests/test_mcts.py
TACTICS = [
    ([1, 1, 2, 2, 3, 3], 1, {0, 4}),
    ([6, 0, 6, 1, 5, 2], 2, {3}),
    ([5, 0, 5, 1, 5, 2], 1, {5}),
    ([], 1, {3}),
    ([0, 6, 1, 6, 0, 6], 2, {6}),
]
POSITIONS = [[], [3], [3, 3], [2, 4, 3], [0, 1, 0, 1, 0], [3, 3, 4, 2, 5, 1], [6, 6, 5, 5, 4]]


def _board(moves, cls=HostBoard):
    b = cls()
    for m in moves:
        b.make_move(m)
    return b


def _children(root):
    visits = np.zeros(WIDTH, dtype=np.int64)
    vsum = np.zeros(WIDTH, dtype=np.float64)
    for m, c in root.children.items():
        visits[m], vsum[m] = c.visits, float(c.value_sum)
    return visits, vsum


def test_host_evaluators_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(30):
        moves = []
        b, jb_ = HostBoard(), JHostBoard()
        for _ in range(int(rng.integers(0, 30))):
            if b.result is not None:
                break
            m = int(rng.choice(sorted(b.valid_moves)))
            b.make_move(m), jb_.make_move(m), moves.append(m)
        assert tev.centre_value_host(b) == jev.centre_value_host(jb_), moves
        v, p = tev.centre_evaluator_host(b)
        jv, jp = jev.centre_evaluator_host(jb_)
        assert v == jv and p.dtype == jp.dtype
        np.testing.assert_array_equal(p, jp)
    assert tev.CENTRE_GRID_SUM == jev.CENTRE_GRID_SUM
    np.testing.assert_array_equal(tev.UNIFORM_PRIOR, jev.UNIFORM_PRIOR)


@pytest.mark.parametrize("moves,plies,best", TACTICS)
def test_grid_search_matches_jax(moves, plies, best):
    move, value = GridSearch(plies, tev.centre_value_host).choose(_board(moves))
    jmove, jvalue = JGridSearch(plies, jev.centre_value_host).choose(_board(moves, JHostBoard))
    assert move in best and (move, value) == (jmove, jvalue)
    assert minimax_value(_board(moves), plies, tev.centre_value_host) == jminimax_value(
        _board(moves, JHostBoard), plies, jev.centre_value_host)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("moves,plies,best", TACTICS)
def test_host_mcts_matches_jax(moves, plies, best, dtype):
    """The near-exhaustive recipe of tests/test_mcts.py: the same move,
    value, root children visits and value sums as the JAX oracle."""
    kw = dict(simulations=7**plies + 1, pb_c_init=9999.0)
    mine = HostMCTS(MCTSConfig(**kw), tev.centre_evaluator_host, dtype=dtype)
    theirs = JHostMCTS(JMCTSConfig(**kw), jev.centre_evaluator_host, dtype=dtype)
    move, value, root = mine.make_move(_board(moves))
    jmove, jvalue, jroot = theirs.make_move(_board(moves, JHostBoard))
    assert move in best and (move, value) == (jmove, jvalue)
    for a, b in zip(_children(root), _children(jroot)):
        np.testing.assert_array_equal(a, b)
    assert root.visits == jroot.visits
    np.testing.assert_array_equal(mine.values_policy(root), theirs.values_policy(jroot))
    np.testing.assert_array_equal(mine.visit_policy(root), theirs.visit_policy(jroot))


def test_host_mcts_noise_and_sampling_match_jax():
    """Root noise and the value^2 opening sample come from the numpy
    generator in both packages, so seeded searches agree exactly."""
    kw = dict(simulations=40, root_dirichlet_alpha=0.3, root_exploration_fraction=0.25,
              num_sampling_moves=6)
    mine = HostMCTS(MCTSConfig(**kw), tev.centre_evaluator_host, rng=np.random.default_rng(5))
    theirs = JHostMCTS(JMCTSConfig(**kw), jev.centre_evaluator_host, rng=np.random.default_rng(5))
    b, jb_ = HostBoard(), JHostBoard()
    for _ in range(8):
        move, value, root = mine.make_move(b)
        jmove, jvalue, jroot = theirs.make_move(jb_)
        assert (move, value) == (jmove, jvalue)
        np.testing.assert_array_equal(root.prior, jroot.prior)


@pytest.mark.parametrize("sims", [15, 100])
def test_batched_k1_matches_the_host_oracle(sims):
    """The counterpart of test_batched_matches_host_oracle: the port's
    batched search (K=1) against the port's HostMCTS, all positions in one
    batch."""
    config = MCTSConfig(simulations=sims)
    boards = [_board(m) for m in POSITIONS]
    res = tb.make_search_fn(tev.centre_evaluator_batched, config)(
        stack_boards(boards, device="cpu"), torch.Generator().manual_seed(7)
    )
    for i, board in enumerate(boards):
        host = HostMCTS(config, tev.centre_evaluator_host)
        root = host.search(board.copy())
        h_visits, h_vsum = _children(root)
        base = int(res.tree.children_base[i, 0])
        np.testing.assert_array_equal(res.tree.visits[i, base:base + WIDTH].numpy(), h_visits)
        np.testing.assert_allclose(res.tree.value_sum[i, base:base + WIDTH].numpy(), h_vsum, rtol=0, atol=1e-4)
        assert int(res.tree.visits[i, 0]) == root.visits
        assert int(res.move[i]) == host._best_child(root, board.player_to_move).move
        np.testing.assert_allclose(res.values_policy[i].numpy(), host.values_policy(root), atol=1e-5)


def _port_tree_from(jtree):
    def pad(x, fill):
        x = torch.from_numpy(np.array(x))
        return torch.cat([x, torch.full((x.shape[0], 1) + tuple(x.shape[2:]), fill, dtype=x.dtype)], dim=1)

    return tb.TreeArrays(
        parent=pad(jtree.parent, -1), children_base=pad(jtree.children_base, -1),
        stats=pad(jtree.stats, 0), prior=pad(jtree.prior, 0),
        evaluated=pad(jtree.evaluated, False), next_free=torch.from_numpy(np.array(jtree.next_free)),
    )


@pytest.mark.parametrize("k", [4, 8])
def test_walker_reference_matches_dedup_and_jax(k):
    """48 simulations as 48/K iterations of the walker form: bit for bit
    the JAX walker form's tree, and the port's deduplicated search's in
    topology, visits and priors (value sums within 1e-4)."""
    config = MCTSConfig(simulations=48, parallel_sims=k)
    jconfig = JMCTSConfig(simulations=48, parallel_sims=k)
    boards = [_board(m) for m in POSITIONS]
    jstate = jstack_boards([_board(m, JHostBoard) for m in POSITIONS])
    state = stack_boards(boards, device="cpu")
    active = torch.ones(len(boards), dtype=torch.bool)
    capacity = config.tree_capacity()
    kw = dict(eval_fn=tev.centre_evaluator_batched, config=config, root_state=state,
              active=active, capacity=capacity)

    jtree = jb._root_init(jev.centre_evaluator_batched, jstate, jax.random.key(3), jconfig,
                          jnp.ones((len(boards),), jnp.bool_))
    jstep = jax.jit(functools.partial(
        jb._simulate_parallel_reference, 0, eval_fn=jev.centre_evaluator_batched, config=jconfig,
        root_state=jstate, active=jnp.ones((len(boards),), jnp.bool_), capacity=capacity))
    ref = _port_tree_from(jtree)
    dedup = _port_tree_from(jtree)
    for _ in range(48 // k):
        jtree = jstep(jtree)
        ref = tb._simulate_parallel_reference(ref, **kw)
        dedup = tb._simulate_parallel(dedup, **kw)

    ref, dedup = ref.without_dump(), dedup.without_dump()
    for name in ("parent", "children_base", "stats", "prior", "evaluated", "next_free"):
        np.testing.assert_array_equal(getattr(ref, name).numpy(), np.asarray(getattr(jtree, name)), err_msg=name)
    for name in ("parent", "children_base", "evaluated", "next_free"):
        torch.testing.assert_close(getattr(dedup, name), getattr(ref, name), rtol=0, atol=0)
    torch.testing.assert_close(dedup.visits, ref.visits, rtol=0, atol=0)
    torch.testing.assert_close(dedup.stats, ref.stats, rtol=0, atol=1e-4)
    torch.testing.assert_close(dedup.prior, ref.prior, rtol=0, atol=1e-6)
