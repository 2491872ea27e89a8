"""The port's self-play (``connect4_tpu_torch.training.self_play``) against
the JAX package's, end to end: the same config with noise and sampling off
and a deterministic evaluator (the centre heuristic, or a small float32
folded net carried over by ``from_flax``), K=8 walkers, a few slots. Moves,
results and lengths must be identical; policies within 1e-5 (float32
network outputs differ in the last bits between the frameworks). Runs with
noise and sampling on are checked by replaying every game on the host
board."""

import numpy as np
import pytest
import torch

import jax

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
from connect4_tpu.eval.evaluators import make_net_evaluator as jmake_net_evaluator
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.training import self_play as jsp
from connect4_tpu_torch.config import MCTSConfig, NetConfig
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
from connect4_tpu_torch.models.convert import from_flax
from connect4_tpu_torch.training import self_play as sp

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _np(out):
    return type(out)(*(np.asarray(x) for x in out))


def _assert_same_games(jout, tout, policy_atol=1e-5):
    jout, tout = _np(jout), _np(tout)
    for name in ("moves", "mask", "result", "length", "planes"):
        np.testing.assert_array_equal(getattr(jout, name), getattr(tout, name), err_msg=name)
        assert getattr(jout, name).dtype == getattr(tout, name).dtype, name
    np.testing.assert_allclose(tout.policies, jout.policies, rtol=0, atol=policy_atol)
    np.testing.assert_allclose(tout.move_values, jout.move_values, rtol=0, atol=policy_atol)


def _replay(out, games=None):
    out = _np(out)
    games = range(out.result.shape[0]) if games is None else games
    for b in games:
        np.testing.assert_array_equal(out.mask[b], np.arange(42) < out.length[b], err_msg=f"game {b}")
        board = HostBoard()
        for t in range(int(out.length[b])):
            np.testing.assert_array_equal(
                out.planes[b, t], board.to_planes().astype(np.uint8), err_msg=f"game {b} ply {t}"
            )
            mv = int(out.moves[b, t])
            assert mv in board.valid_moves, f"game {b} ply {t} move {mv}"
            board.make_move(mv)
        assert board.result is not None and board.result.code == int(out.result[b]), f"game {b}"
    sums = out.policies.sum(-1)
    np.testing.assert_allclose(sums[out.mask], 1.0, atol=1e-5)
    assert (sums[~out.mask] == 0.0).all()


@pytest.mark.parametrize("n_blocks", [1, 2])
def test_refill_matches_jax_centre_evaluator(n_blocks):
    kw = dict(simulations=16, parallel_sims=8)
    jout = jsp.make_refill_play_fn(jcentre, JMCTSConfig(**kw), 4, 10, n_blocks=n_blocks)(jax.random.key(0))
    tout = sp.make_refill_play_fn(
        centre_evaluator_batched, MCTSConfig(**kw), 4, 10, n_blocks=n_blocks, device="cpu"
    )(_gen())
    _assert_same_games(jout, tout)


def test_refill_matches_jax_float32_net():
    """A small float32 net, folded on both sides, drives both searches."""
    jconfig = JNetConfig(filters=8, n_fc_layers=1, n_residuals=1)
    net, var = jinit_net(jconfig, jax.random.key(1))
    params = jax.tree_util.tree_map(np.asarray, var["params"])
    stats = jax.tree_util.tree_map(np.asarray, var["batch_stats"])
    kw = dict(simulations=16, parallel_sims=8)
    jout = jsp.make_refill_play_fn(
        jmake_net_evaluator(net, params, stats), JMCTSConfig(**kw), 3, 6
    )(jax.random.key(0))
    tnet = from_flax(NetConfig(filters=8, n_fc_layers=1, n_residuals=1), params, stats, device="cpu")
    tout = sp.make_refill_play_fn(make_net_evaluator(tnet), MCTSConfig(**kw), 3, 6, device="cpu")(_gen())
    _assert_same_games(jout, tout)


def test_lockstep_and_chunked_match_jax():
    config = dict(simulations=12)
    jout = jsp.make_play_fn(jcentre, JMCTSConfig(**config), 4)(jax.random.key(0))
    whole = sp.make_play_fn(centre_evaluator_batched, MCTSConfig(**config), 4, device="cpu")(_gen())
    chunked = sp.make_stepwise_play_fn(
        centre_evaluator_batched, MCTSConfig(**config), 4, sims_per_call=4, device="cpu"
    )(_gen())
    _assert_same_games(jout, whole)
    for name, a, b in zip(whole._fields, whole, chunked):
        assert torch.equal(a, b), name


def test_refill_drain_narrowing_replays():
    """With 128 slots the drain phase compacts the live rows into
    narrower pools (floor 64); every game still finishes and replays."""
    config = MCTSConfig(simulations=4, num_sampling_moves=4,
                        root_dirichlet_alpha=0.3, root_exploration_fraction=0.25)
    live = []
    out = sp.make_refill_play_fn(centre_evaluator_batched, config, 128, 140, device="cpu")(
        _gen(11), progress=lambda w, n: live.append(n)
    )
    assert (out.result != 0).all(), "all games must finish"
    assert min(n for n in live if n) < 64, "drain must reach the narrow phase"
    assert live[-1] == 0
    _replay(out, games=range(0, 140, 7))


def test_noisy_refill_replays_on_host_board():
    config = MCTSConfig(simulations=16, parallel_sims=8, num_sampling_moves=6,
                        root_dirichlet_alpha=0.3, root_exploration_fraction=0.25)
    out = sp.make_refill_play_fn(centre_evaluator_batched, config, 3, 9, sims_per_call=8, device="cpu")(_gen(3))
    assert out.result.shape == (9,) and (out.result != 0).all()
    assert (out.length >= 7).all() and (out.length <= 42).all()
    _replay(out)
    assert len(np.unique(out.moves[:, :2].numpy(), axis=0)) > 1, "sampling must vary the openings"


def test_training_arrays_match_jax():
    """The same generation through both packages' ``training_arrays``."""
    config = MCTSConfig(simulations=8, num_sampling_moves=3,
                        root_dirichlet_alpha=0.3, root_exploration_fraction=0.25)
    out = sp.make_refill_play_fn(centre_evaluator_batched, config, 3, 5, device="cpu")(_gen(5))
    as_jax = jsp.SelfPlayOutput(*(jax.numpy.asarray(x.numpy()) for x in out))
    for name, a, b in zip(("planes", "values", "policies"), jsp.training_arrays(as_jax), sp.training_arrays(out)):
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    m = int(out.mask.sum())
    planes, values, policies = sp.training_arrays(out)
    assert planes.shape == (2 * m, 3, 6, 7) and values.shape == (2 * m,) and policies.shape == (2 * m, 7)
    np.testing.assert_array_equal(planes[m:], planes[:m][:, :, :, ::-1])


def test_refill_rejects_bad_pool_shapes():
    with pytest.raises(ValueError):
        sp.make_refill_play_fn(centre_evaluator_batched, MCTSConfig(), 8, 4, device="cpu")
    with pytest.raises(ValueError):
        sp.make_refill_play_fn(centre_evaluator_batched, MCTSConfig(), 6, 12, n_blocks=4, device="cpu")
