"""The port's batched MCTS (``connect4_tpu_torch.mcts.batched``) against the
JAX package's, with the deterministic centre evaluator and noise and
sampling off, on the tactic and fidelity boards of ``tests/test_mcts.py``.
Both compute in float32 with the same operation order, so trees match
exactly in topology and visit counts; value sums are held within 1e-4 and
priors within 1e-6 (the JAX tests' own tolerances)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
from connect4_tpu.mcts import batched as jb
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.mcts import batched as tb

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

TACTIC_MOVES = [[1, 1, 2, 2, 3, 3], [6, 0, 6, 1, 5, 2], [5, 0, 5, 1, 5, 2], [], [0, 6, 1, 6, 0, 6]]
POSITIONS = [[3], [3, 3], [2, 4, 3], [0, 1, 0, 1, 0], [3, 3, 4, 2, 5, 1], [6, 6, 5, 5, 4]]
FINISHED = [0, 1, 0, 1, 0, 1, 0]  # o has won


def board_from_moves(moves):
    b = HostBoard()
    for m in moves:
        b.make_move(m)
    return b


def _boards(lists):
    return [board_from_moves(m) for m in lists]


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _tree_equal(jtree, ttree, stats_atol=1e-4):
    for name in ("parent", "children_base", "evaluated", "next_free"):
        np.testing.assert_array_equal(np.asarray(getattr(jtree, name)), getattr(ttree, name).numpy(), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jtree.visits), ttree.visits.numpy())
    np.testing.assert_allclose(np.asarray(jtree.stats), ttree.stats.numpy(), rtol=0, atol=stats_atol)
    np.testing.assert_allclose(np.asarray(jtree.prior), ttree.prior.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize(
    "kw",
    [dict(simulations=15), dict(simulations=100), dict(simulations=50, pb_c_init=9999.0)],
)
def test_exact_search_matches_jax(kw):
    """K=1 search on the tactic and fidelity boards, one batch, with a
    finished game masked inactive."""
    boards = _boards(TACTIC_MOVES + POSITIONS + [FINISHED])
    active = np.array([True] * (len(boards) - 1) + [False])
    jres = jb.make_search_fn(jcentre, JMCTSConfig(**kw))(
        jstack_boards(boards), jax.random.key(0), jnp.asarray(active)
    )
    tres = tb.make_search_fn(centre_evaluator_batched, MCTSConfig(**kw))(
        stack_boards(boards, device="cpu"), _gen(), torch.from_numpy(active)
    )
    live = active
    np.testing.assert_array_equal(np.asarray(jres.move)[live], tres.move.numpy()[live])
    for name in ("value", "values_policy", "visit_policy", "root_value"):
        np.testing.assert_allclose(
            np.asarray(getattr(jres, name))[live], getattr(tres, name).numpy()[live],
            rtol=0, atol=1e-4, err_msg=name,
        )
    _tree_equal(jres.tree, tres.tree)
    # the masked game left no trace beyond its root bookkeeping
    assert int(tres.tree.next_free[-1]) == 1 and int(tres.tree.children_base[-1, 0]) == -1


def _jax_tree(state, config, iters, seed=3):
    active = jnp.ones((state.age.shape[0],), jnp.bool_)
    tree = jb._root_init(jcentre, state, jax.random.key(seed), config, active)
    step = jax.jit(functools.partial(
        jb._simulate_parallel, 0, eval_fn=jcentre, config=config, root_state=state,
        active=active, capacity=config.tree_capacity(),
    ))
    for _ in range(iters):
        tree = step(tree)
    return tree, step


def _to_port_tree(jtree) -> tb.TreeArrays:
    """A JAX tree as the port's slabs (with the dump column appended)."""
    def pad(x, fill):
        x = torch.from_numpy(np.array(x))
        col = torch.full((x.shape[0], 1) + tuple(x.shape[2:]), fill, dtype=x.dtype)
        return torch.cat([x, col], dim=1)

    return tb.TreeArrays(
        parent=pad(jtree.parent, -1),
        children_base=pad(jtree.children_base, -1),
        stats=pad(jtree.stats, 0),
        prior=pad(jtree.prior, 0),
        evaluated=pad(jtree.evaluated, False),
        next_free=torch.from_numpy(np.array(jtree.next_free)),
    )


@pytest.mark.parametrize("iters", [0, 3])
def test_parallel_step_matches_jax_on_identical_trees(iters):
    """One K=8 walker-deduplicated iteration from the same tree (fresh, and
    after three iterations) in both packages."""
    config = JMCTSConfig(simulations=48, parallel_sims=8)
    boards = _boards(POSITIONS + TACTIC_MOVES)
    jstate = jstack_boards(boards)
    jtree, jstep = _jax_tree(jstate, config, iters)
    ttree = _to_port_tree(jtree)
    jtree = jstep(jtree)
    state = stack_boards(boards, device="cpu")
    ttree = tb._simulate_parallel(
        ttree, eval_fn=centre_evaluator_batched, config=MCTSConfig(simulations=48, parallel_sims=8),
        root_state=state, active=torch.ones(len(boards), dtype=torch.bool),
        capacity=config.tree_capacity(),
    )
    _tree_equal(jtree, ttree.without_dump())


@pytest.mark.parametrize("k", [4, 8])
def test_parallel_search_matches_jax(k):
    boards = _boards(POSITIONS)
    kw = dict(simulations=48, parallel_sims=k)
    jres = jb.make_search_fn(jcentre, JMCTSConfig(**kw))(jstack_boards(boards), jax.random.key(0))
    tres = tb.make_search_fn(centre_evaluator_batched, MCTSConfig(**kw))(
        stack_boards(boards, device="cpu"), _gen()
    )
    np.testing.assert_array_equal(np.asarray(jres.move), tres.move.numpy())
    np.testing.assert_allclose(np.asarray(jres.values_policy), tres.values_policy.numpy(), rtol=0, atol=1e-5)
    _tree_equal(jres.tree, tres.tree)


def test_tree_capacity():
    for sims, k in [(48, 8), (48, 1), (64, 8), (800, 8), (10, 4)]:
        assert MCTSConfig(simulations=sims, parallel_sims=k).tree_capacity() == 1 + 7 * -(-sims // k)
        assert (MCTSConfig(simulations=sims, parallel_sims=k).tree_capacity()
                == JMCTSConfig(simulations=sims, parallel_sims=k).tree_capacity())
    config = MCTSConfig(simulations=48, parallel_sims=8)
    res = tb.make_search_fn(centre_evaluator_batched, config)(
        stack_boards(_boards([[], [3, 3, 2, 4]]), device="cpu"), _gen()
    )
    assert res.tree.parent.shape[1] == config.tree_capacity()
    assert int(res.tree.next_free.max()) <= config.tree_capacity()
    assert (res.tree.visits[:, 0] == 49).all()


def test_chunked_search_matches_whole():
    config = MCTSConfig(simulations=24, parallel_sims=4, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    state = stack_boards(_boards(POSITIONS), device="cpu")
    a = tb.make_search_fn(centre_evaluator_batched, config)(state, _gen(9))
    b = tb.make_chunked_search_fn(centre_evaluator_batched, config, 8)(state, _gen(9))
    for name, x, y in zip(a._fields[:5], a[:5], b[:5]):
        assert torch.equal(x, y), name
    with pytest.raises(ValueError):
        tb.make_chunked_search_fn(centre_evaluator_batched, config, 7)


def test_rejects_indivisible_parallel_sims():
    run = tb.make_search_fn(centre_evaluator_batched, MCTSConfig(simulations=10, parallel_sims=4))
    with pytest.raises(ValueError):
        run(stack_boards([HostBoard()], device="cpu"), _gen())


def test_noise_and_sampling_follow_the_generator():
    """With noise and sampling on, the same seed gives the same search and
    another seed (almost surely) another; outputs stay well formed."""
    config = MCTSConfig(simulations=30, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    run = tb.make_search_fn(centre_evaluator_batched, config)
    state = stack_boards([HostBoard() for _ in range(8)] + [board_from_moves([3, 3, 3, 3, 3, 3])], device="cpu")
    r1, r2, r3 = run(state, _gen(42)), run(state, _gen(42)), run(state, _gen(43))
    assert torch.equal(r1.move, r2.move) and torch.equal(r1.tree.stats, r2.tree.stats)
    assert not torch.equal(r1.tree.visits, r3.tree.visits)
    torch.testing.assert_close(r1.values_policy.sum(-1), torch.ones(9), rtol=0, atol=1e-5)
    assert r1.values_policy[-1, 3] == 0.0 and int(r1.move[-1]) != 3  # full column
    prior = r1.tree.prior[:, 0]
    torch.testing.assert_close(prior.sum(-1), torch.ones(9), rtol=0, atol=1e-5)
    assert not torch.allclose(prior[0], torch.full((7,), 1 / 7))  # noise mixed in
