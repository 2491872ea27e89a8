"""The port's match system (``connect4_tpu_torch.eval.match``) against the
JAX package's: deterministic players (noise and sampling off), the same
start sets, the same wins / draws / losses / return."""

import numpy as np
import pytest
import torch

import jax

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
from connect4_tpu.eval.evaluators import make_net_evaluator as jmake_net_evaluator
from connect4_tpu.eval.match import MatchPlayer as JMatchPlayer
from connect4_tpu.eval.match import play_match as jplay_match
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu_torch.config import MCTSConfig, NetConfig
from connect4_tpu_torch.env.host_board import HostBoard, enumerate_start_positions
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
from connect4_tpu_torch.eval.match import MatchPlayer, play_match
from connect4_tpu_torch.models.convert import from_flax

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)


def _players(sims_a=8, sims_b=6, parallel=1):
    """Two centre-heuristic players that differ in search depth, in both
    packages."""
    mine = [MatchPlayer(n, centre_evaluator_batched, MCTSConfig(simulations=s, parallel_sims=parallel))
            for n, s in (("a", sims_a), ("b", sims_b))]
    theirs = [JMatchPlayer(n, jcentre, JMCTSConfig(simulations=s, parallel_sims=parallel))
              for n, s in (("a", sims_a), ("b", sims_b))]
    return mine, theirs


@pytest.mark.parametrize("switch", [False, True])
def test_match_with_the_centre_evaluator_equals_jax(switch):
    mine, theirs = _players()
    got = play_match(*mine, plies=1, switch=switch, display=False, device="cpu")
    want = jplay_match(*theirs, plies=1, switch=switch, display=False)
    assert got == want
    total = got["wins"] + got["draws"] + got["losses"]
    assert total == (14 if switch else 7)
    assert got["return"] == (got["wins"] + 0.5 * got["draws"]) / total


def test_match_with_a_float32_net_equals_jax(capsys):
    """A float32 net carried over by ``from_flax`` against the centre
    heuristic, two-ply starts, both colours, K=4 walkers: the same summary
    and the same printed line."""
    kw = dict(filters=8, n_fc_layers=1, n_residuals=1)
    net, var = jinit_net(JNetConfig(**kw), jax.random.key(2))
    params = jax.tree_util.tree_map(np.asarray, var["params"])
    stats = jax.tree_util.tree_map(np.asarray, var["batch_stats"])
    tnet = from_flax(NetConfig(**kw), params, stats, device="cpu")
    cfg = dict(simulations=8, parallel_sims=4)
    want = jplay_match(
        JMatchPlayer("net", jmake_net_evaluator(net, params, stats), JMCTSConfig(**cfg)),
        JMatchPlayer("centre", jcentre, JMCTSConfig(**cfg)),
        plies=2, switch=True, seed=3,
    )
    jline = capsys.readouterr().out
    got = play_match(
        MatchPlayer("net", make_net_evaluator(tnet), MCTSConfig(**cfg)),
        MatchPlayer("centre", centre_evaluator_batched, MCTSConfig(**cfg)),
        plies=2, switch=True, seed=3, device="cpu",
    )
    assert got == want
    assert got["wins"] + got["draws"] + got["losses"] == 98
    assert capsys.readouterr().out == jline


def test_mirror_symmetry_of_identical_players():
    """Identical deterministic players: the switched sub-match replays the
    same games with colours swapped, so wins and losses mirror."""
    mine, _ = _players(sims_a=8, sims_b=8)
    res = play_match(mine[0], mine[0], plies=1, switch=True, display=False, device="cpu")
    assert res["wins"] == res["losses"] and res["return"] == 0.5


def test_start_positions_and_explicit_start_boards():
    boards = enumerate_start_positions(2)
    assert len(boards) == 49
    mine, theirs = _players(sims_a=4, sims_b=4)
    got = play_match(*mine, start_boards=boards[:5], display=False, device="cpu")
    want = jplay_match(*theirs, start_boards=boards[:5], display=False)
    assert got == want and got["wins"] + got["draws"] + got["losses"] == 5


def test_mixed_age_start_boards_rejected():
    b0, b1 = HostBoard(), HostBoard()
    b1.make_move(3)
    mine, _ = _players(sims_a=4, sims_b=4)
    with pytest.raises(ValueError, match="start age"):
        play_match(*mine, start_boards=[b0, b1], display=False, device="cpu")
