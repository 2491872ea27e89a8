"""The search as a device program (``connect4_tpu_torch.mcts.batched.Search``)
on the CPU: every iteration descends the number of levels the host knows,
``min(t - 1, PATH_MAX - 2)``, with no read of the tensors in between, on a
workspace that every search of a shape resets in place. On the card an
iteration is one CUDA graph whose descent is one launch of the descent
kernel (``tests/test_torch_gpu.py`` holds the graphed search to the eager
one and to this level form there; ``tests/test_torch_descent.py`` holds the
kernel's plain version to the JAX descent); here the level form runs
eagerly.

Held: the sync-free search against the loop that stops each descent when
no row descends any more (one host read a level, as the search ran before
it became a device program), bit for bit, and against the JAX search
within ``tests/test_torch_mcts.py``'s tolerances; no host read inside an
iteration; the level bound; the reuse of workspaces."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
from connect4_tpu.mcts import batched as jb
from connect4_tpu_torch import launches
from connect4_tpu_torch.config import MCTSConfig, NetConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
from connect4_tpu_torch.mcts import batched as tb
from connect4_tpu_torch.models import tower
from connect4_tpu_torch.models.net import init_net
from test_torch_mcts import FINISHED, POSITIONS, TACTIC_MOVES, _boards, _gen, _tree_equal
from test_torch_profile_scripts import random_boards

torch.set_num_threads(1)


def _late_boards():
    """Four live boards 37 plies old, from seeded random play."""
    boards = random_boards(4, 37, seed=36, live_only=True)
    assert all(b.age == 37 and b.result is None for b in boards)
    return boards


def _eager_loop(search, state, generator, active=None):
    """The search with each descent stopped where no row descends any more,
    read from the tensors every level: the loop the search ran before its
    level count was fixed on the host."""
    ws = search.init(state, generator, active)
    for _ in range(search.config.simulations // search.config.parallel_sims):
        ws.iteration += 1
        while bool(ws.descent.descending.any()):
            search.level(ws)
        search.tail(ws)
    return search.finish(ws, generator)


def _results_equal(a, b):
    for name in ("move", "value", "values_policy", "visit_policy", "root_value"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for name, x, y in zip(a.tree._fields, a.tree, b.tree):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("k, sims, sims_per_call", [(1, 40, None), (1, 40, 8), (8, 64, None), (8, 64, 16)])
def test_sync_free_search_equals_the_eager_loop_and_jax(k, sims, sims_per_call):
    """K=1 and K=8, whole and chunked, noise and sampling off, on the
    tactic and fidelity boards with a finished game masked inactive: bit
    for bit the loop that reads the card every level, and the JAX search
    within the JAX tests' tolerances."""
    boards = _boards(TACTIC_MOVES + POSITIONS + [FINISHED])
    active = np.array([True] * (len(boards) - 1) + [False])
    kw = dict(simulations=sims, parallel_sims=k)
    state = stack_boards(boards, device="cpu")
    search = tb.Search(centre_evaluator_batched, MCTSConfig(**kw), sims_per_call)
    got = search(state, _gen(), torch.from_numpy(active))
    _results_equal(got, _eager_loop(search, state, _gen(), torch.from_numpy(active)))

    jres = jb.make_search_fn(jcentre, JMCTSConfig(**kw))(jstack_boards(boards), jax.random.key(0),
                                                         jnp.asarray(active))
    np.testing.assert_array_equal(np.asarray(jres.move)[active], got.move.numpy()[active])
    for name in ("value", "values_policy", "visit_policy", "root_value"):
        np.testing.assert_allclose(np.asarray(getattr(jres, name))[active], getattr(got, name).numpy()[active],
                                   rtol=0, atol=1e-4, err_msg=name)
    _tree_equal(jres.tree, got.tree)


@contextlib.contextmanager
def _host_reads_raise(monkeypatch):
    """Every way a tensor reaches the host raises inside the block."""
    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"host read inside a search iteration: {name}")
        return fn

    with monkeypatch.context() as m:
        for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist", "cpu", "numpy"):
            m.setattr(torch.Tensor, name, refuse(name))
        m.setattr(torch, "nonzero", refuse("nonzero"))
        yield


def _tiny_net_evaluator():
    config = NetConfig(filters=16, n_fc_layers=1, n_residuals=1, compute_dtype="bfloat16")
    return make_net_evaluator(init_net(config, torch.Generator().manual_seed(0), device="cpu"))


@pytest.mark.parametrize("k, evaluator", [(1, "centre"), (8, "centre"), (8, "net")])
def test_an_iteration_reads_nothing_back(monkeypatch, k, evaluator):
    """The segments (every iteration: its levels, its tail and the next
    descent's start) run with every host read of a tensor patched to
    raise; the net evaluator is the folded bf16 tower's plain version."""
    eval_fn = centre_evaluator_batched if evaluator == "centre" else _tiny_net_evaluator()
    config = MCTSConfig(simulations=8 * k, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    search = tb.Search(eval_fn, config, 4 * k)
    state = stack_boards(_boards(POSITIONS + [FINISHED]), device="cpu")
    active = state.result == 0
    generator = _gen()
    ws = search.init(state, generator, active)
    with _host_reads_raise(monkeypatch):
        for _ in range(2):
            search.segment(ws)
    with _host_reads_raise(monkeypatch), pytest.raises(AssertionError, match="host read"):
        bool(ws.descent.descending.any())  # the patch does catch a read
    _results_equal(search.finish(ws, generator), tb.Search(eval_fn, config, 4 * k)(state, _gen(), active))


def _watch_levels(search, state, generator):
    """Drive ``search`` iteration by iteration with the fixed level count;
    after each descent check that no row still descends and that no row
    went deeper than t - 1. Returns the deepest descent of each iteration."""
    ws = search.init(state, generator)
    deepest = []
    for _ in range(search.config.simulations // search.config.parallel_sims):
        ws.iteration += 1
        levels = min(ws.iteration - 1, tb.PATH_MAX - 2)
        for _ in range(levels):
            search.level(ws)
        assert not bool(ws.descent.descending.any()), f"iteration {ws.iteration}: a row still descends"
        deepest.append(int(ws.descent.depth.max()))
        assert deepest[-1] <= levels
        search.tail(ws)
    return deepest


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("boards", ["fresh", "late"])
def test_level_bound_holds(k, boards):
    """At level min(t - 1, PATH_MAX - 2) of iteration t no row is still
    descending, on fresh boards and on boards 37 plies old."""
    rows = _boards([[]] * 3 + POSITIONS) if boards == "fresh" else _late_boards()
    config = MCTSConfig(simulations=48 * k, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25)
    deepest = _watch_levels(tb.Search(centre_evaluator_batched, config), stack_boards(rows, device="cpu"), _gen(3))
    assert max(deepest) > 1  # the trees grew past the root's children
    if boards == "late":
        assert max(deepest) <= 42 - 37


def test_level_bound_is_reached():
    """With no exploration a K=1 search deepens one path an iteration, so
    iteration t descends t - 1 levels: the bound is the least that holds."""
    config = MCTSConfig(simulations=12, pb_c_init=0.0)
    deepest = _watch_levels(tb.Search(centre_evaluator_batched, config),
                            stack_boards(_boards([[3], [2, 4]]), device="cpu"), _gen())
    assert deepest == list(range(12))


@pytest.mark.parametrize("k", [1, 8])
def test_workspaces_are_reused_and_reset(k):
    """One search object: two searches of one shape in a row, then a
    narrower pool, then the first shape again, each bit for bit a fresh
    search object's; the results of earlier calls stay as they were."""
    config = MCTSConfig(simulations=16 * k, parallel_sims=k, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25, num_sampling_moves=6)
    wide = stack_boards(_boards(TACTIC_MOVES + POSITIONS), device="cpu")
    narrow = stack_boards(_boards(POSITIONS[:4]), device="cpu")
    search = tb.Search(centre_evaluator_batched, config, 8 * k)
    calls = [(wide, 1), (wide, 2), (narrow, 3), (wide, 4)]
    got = [search(state, _gen(seed)) for state, seed in calls]
    for (state, seed), res in zip(calls, got):
        _results_equal(res, tb.Search(centre_evaluator_batched, config, 8 * k)(state, _gen(seed)))
    assert sorted(rows for _, rows in search.workspaces) == [4, len(TACTIC_MOVES + POSITIONS)]
    assert all(ws.graphs is None for ws in search.workspaces.values())  # no CUDA graphs on the CPU
    assert not torch.equal(got[0].tree.stats, got[1].tree.stats)  # another seed: another tree


def test_opening_samples_are_multinomial_draws():
    """The finish samples opening moves as ``torch.multinomial`` draws one
    sample from the same generator, without its host-side checks."""
    config = MCTSConfig(simulations=8, num_sampling_moves=42)
    state = stack_boards(_boards([[]] * 40 + POSITIONS), device="cpu")
    search = tb.Search(centre_evaluator_batched, config)
    ws = search.init(state, _gen())
    search.segment(ws)
    res = search.finish(ws, _gen(7))
    # the distribution the finish samples from, as it computes it
    valid = tb.legal_moves(state)
    child = tb._take_child_block(ws.tree.stats, ws.rows, ws.tree.children_base[:, 0].long(), ws.capacity)
    mean = child[..., 1] / child[..., 0].clamp(min=1.0)
    known = (child[..., 3] > 0.5) | (child[..., 0] > 0)
    abs_val = torch.where(child[..., 3] > 0.5, child[..., 2], torch.where(child[..., 0] > 0, mean, 0.0))
    side_val = torch.where(valid, torch.where(known, tb._value_to_side(abs_val, (state.age % 2)[:, None]), 0.0), 0.0)
    weights = torch.where(valid, side_val ** 2, 0.0)
    probs = weights / weights.sum(-1, keepdim=True)
    assert torch.equal(res.move.long(), torch.multinomial(probs, 1, generator=_gen(7))[:, 0])


def test_captured_launches_count_at_replay(monkeypatch):
    """A tower forward made while a graph is captured is logged, not
    counted; each replay counts the log, by packed width and batch. The
    counters are the process's own, so they are restored afterwards for
    the tests that read them."""
    for name, value in (("launches", 0), ("layer_launches", 0), ("by_shape", {})):
        monkeypatch.setattr(tower.run_tower, name, value)
    before = tower.run_tower.launches, tower.run_tower.layer_launches
    with launches.captured() as log:
        launches.count(tower._record, 64, 512, 0)
        launches.count(tower._record, 512, 49, 13)
    assert log == [(tower._record, (64, 512, 0)), (tower._record, (512, 49, 13))]
    assert (tower.run_tower.launches, tower.run_tower.layer_launches) == before and tower.run_tower.by_shape == {}
    for _ in range(3):
        launches.replay(log)
    assert tower.run_tower.launches == before[0] + 6 and tower.run_tower.layer_launches == before[1] + 39
    assert tower.run_tower.by_shape == {64: {512: 3}, 512: {49: 3}}
