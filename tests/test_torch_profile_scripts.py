"""The port's measurement tools (``connect4_tpu_torch.scripts``:
selfplay_breakdown, profile_search, profile_refill_wave,
sweep_search_batch, descent_depth_profile) and ``utils.trace`` against the
JAX package's functions and scripts, on the CPU at small sizes. With root
noise off and the deterministic centre evaluator, what the tools count
(moves chosen, live rows, tree nodes, descent depths) equals the JAX
package's bit for bit on the same boards, made with numpy; their times are
only checked to be there and positive (a CPU time says nothing of the
card)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.env.core import legal_moves as jlegal_moves
from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
from connect4_tpu.mcts import batched as jbatched
from connect4_tpu.training.self_play import make_refill_play_fn as jmake_refill_play_fn
from connect4_tpu_torch.config import MCTSConfig
from connect4_tpu_torch.env.convert import stack_boards
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.launches import WAVE_PARTS
from connect4_tpu_torch.scripts import (
    _common,
    descent_depth_profile,
    profile_refill_wave,
    profile_search,
    selfplay_breakdown,
    sweep_search_batch,
)
from connect4_tpu_torch.utils import TRACE_FILE, trace

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NO_NOISE = dict(root_dirichlet_alpha=0.0, root_exploration_fraction=0.0)


def random_boards(n, plies, seed, live_only=False):
    """``n`` boards after ``plies`` random moves from numpy's generator
    (a game that ends stays as it ended, unless ``live_only``)."""
    rng = np.random.default_rng(seed)
    boards = []
    while len(boards) < n:
        b = HostBoard()
        for _ in range(plies):
            if b.result is not None:
                break
            b.make_move(int(rng.choice(sorted(b.valid_moves))))
        if b.result is None or not live_only:
            boards.append(b)
    return boards


def test_trace_writes_a_chrome_trace_naming_aten_ops(tmp_path, monkeypatch):
    with trace(str(tmp_path / "t")) as log_dir:
        (torch.ones(4, 4) @ torch.ones(4, 4)).sum()
    assert log_dir == str(tmp_path / "t")
    with open(os.path.join(log_dir, TRACE_FILE)) as fh:
        text = fh.read()
    assert "aten::mm" in text and json.loads(text)["traceEvents"]
    events = _common.trace_events(log_dir)
    assert _common.device_busy_ms(events) is None  # no card in a CPU trace
    what, ops = _common.top_ops(events, 3)
    assert what == "cpu" and ops and all(op["name"].startswith("aten::") for op in ops)
    # the default directory is under the home directory
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    with trace() as log_dir:
        torch.ones(2).sum()
    assert log_dir.startswith(str(tmp_path / "home" / "connect4_tpu_torch_traces"))
    assert os.path.exists(os.path.join(log_dir, TRACE_FILE))


def test_device_busy_counts_overlapping_kernels_once():
    events = [
        {"ph": "X", "cat": "kernel", "name": "a", "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "b", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 30.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0.0, "dur": 100.0},
    ]
    assert _common.device_busy_ms(events) == pytest.approx(0.020)
    assert _common.device_busy_ms(events, (10.0, 32.0)) == pytest.approx(0.007)
    what, ops = _common.top_ops(events)
    assert what == "device" and [op["name"] for op in ops] == ["a", "b", "c"]


def test_selfplay_breakdown_counts_equal_jax():
    """A wave over mid-game boards (one finished game rides along
    inactive): the moves chosen, the live rows and the tree nodes a row
    equal the JAX package's ``_root_init`` / ``_run_sims`` / ``_finish``."""
    boards = random_boards(6, 14, seed=5)
    boards[2] = random_boards(1, 41, seed=1)[0]
    assert boards[2].result is not None
    config = dict(simulations=16, parallel_sims=4, **NO_NOISE)
    got = selfplay_breakdown.breakdown(centre_evaluator_batched, stack_boards(boards, device="cpu"),
                                       MCTSConfig(**config), 8, 2, torch.Generator().manual_seed(0),
                                       eval_reps=2)
    state = jstack_boards(boards)
    active = np.asarray(state.result) == 0
    jconfig = JMCTSConfig(**config)
    key = jax.random.key(0)
    active_j = jnp.asarray(active)
    tree = jax.jit(lambda st, k: jbatched._root_init(jcentre, st, k, jconfig, active_j))(state, key)
    segment = jax.jit(lambda tr, st: jbatched._run_sims(jcentre, tr, st, jconfig, active_j, 8))
    for _ in range(2):
        tree = segment(tree, state)
    res = jax.jit(lambda tr, st, k: jbatched._finish(tr, st, jbatched._sample_key(k), jconfig, jlegal_moves(st)))(
        tree, state, key)
    assert got["live_rows"] == int(active.sum()) == 5
    assert got["moves"] == np.asarray(res.move)[active].tolist()
    assert got["nodes"] == np.asarray(res.tree.next_free).tolist()
    for key in ("eval_ms", "init_ms", "segments_ms", "finish_ms", "blocking_wave_ms", "unsynced_wave_ms",
                "traced_segment_ms", "sims_per_s"):
        assert got[key] > 0, key
    assert len(got["segment_ms"]) == 2 and got["eval_batch"] == 24
    assert got["device_busy_share"] is None and "mfu" not in got  # no card


def test_profile_search_writes_a_trace_on_the_cpu(tmp_path, capsys):
    got = profile_search.main(["--batch", "2", "--sims", "8", "--parallel-sims", "4", "--filters", "16",
                               "--logdir", str(tmp_path), "--device", "cpu"])
    assert got["trace"] == os.path.join(str(tmp_path), TRACE_FILE) and os.path.exists(got["trace"])
    assert got["top_ops_of"] == "cpu" and got["top_ops"][0]["name"].startswith("aten::")
    assert got["steady_s"] > 0 and got["sims_per_s"] > 0 and len(got["moves"]) == 2
    out = capsys.readouterr().out
    assert "steady search:" in out and json.loads(out.strip().split("\n")[-1])["batch"] == 2


def test_profile_refill_wave_counts_equal_jax():
    """The live rows after every wave and the moves played equal the JAX
    refill pool's with noise off; every traced wave has its parts."""
    config = dict(simulations=8, parallel_sims=4, **NO_NOISE)
    got = profile_refill_wave.profile_refill(centre_evaluator_batched, MCTSConfig(**config), 4, 8, 4, "cpu")
    live = []
    out = jmake_refill_play_fn(jcentre, JMCTSConfig(**config), 4, 8, 4)(
        jax.random.key(1), progress=lambda wave, n: live.append(int(n)))
    assert got["live_per_wave"] == live
    assert got["moves"] == int(np.asarray(out.mask).sum())
    assert got["waves"] == len(live) == got["full_waves"] + got["tail_waves"]
    parts = got["parts"]
    assert set(parts) == set(WAVE_PARTS)
    for key in ("search", "record", "transfer"):
        assert parts[key]["calls"] == profile_refill_wave.TRACED_WAVES and parts[key]["host_ms"] > 0, key
        assert parts[key]["device_ms"] is None
    assert got["bare_search_s"] > 0 and got["sims_per_s"] > 0


def test_sweep_search_batch_moves_equal_jax():
    """The chunked search's moves on the JAX script's 12-ply boards, for
    each batch and K, equal the JAX chunked search's; a K that no segment
    holds is skipped, as there."""
    config = MCTSConfig(simulations=16, num_sampling_moves=6, **NO_NOISE)
    rows = sweep_search_batch.sweep(centre_evaluator_batched, config, [3, 5], [4, 3], 8, "cpu", repeats=1)
    assert [(r["batch"], r["parallel_sims"], r.get("skipped", False)) for r in rows] == [
        (3, 4, False), (3, 3, True), (5, 4, False), (5, 3, True)]
    jconfig = JMCTSConfig(simulations=16, num_sampling_moves=6, **NO_NOISE)
    for r in rows:
        if r.get("skipped"):
            continue
        state = jstack_boards(sweep_search_batch.midgame_boards(r["batch"]))
        run = jbatched.make_chunked_search_fn(jcentre, dataclasses.replace(jconfig, parallel_sims=r["parallel_sims"]),
                                              r["sims_per_call"])
        assert r["moves"] == np.asarray(run(state, jax.random.key(1)).move).tolist()
        assert r["steady_s"] > 0 and r["sims_per_s"] > 0


def _jax_descent_script():
    spec = importlib.util.spec_from_file_location(
        "jax_descent_depth_profile", os.path.join(ROOT, "scripts", "descent_depth_profile.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_descent_depth_table_equals_jax():
    """Depth by board age, noise off, K=4: the mean / p95 / max after the
    first and the last segment equal those of the JAX script's
    ``measure_depth`` on the same boards."""
    config = dict(simulations=48, parallel_sims=4, **NO_NOISE)
    spc = 16
    boards = {ply: random_boards(5, ply, seed=ply, live_only=True) for ply in (2, 8, 14)}
    got = descent_depth_profile.depth_by_age(
        centre_evaluator_batched, {p: stack_boards(b, device="cpu") for p, b in boards.items()},
        MCTSConfig(**config), spc)
    measure_depth = _jax_descent_script().measure_depth
    jconfig = JMCTSConfig(**config)
    ones = jnp.ones((5,), jnp.bool_)
    init = jax.jit(lambda st, k: jbatched._root_init(jcentre, st, k, jconfig, ones))
    segment = jax.jit(lambda tr, st: jbatched._run_sims(jcentre, tr, st, jconfig, ones, spc))
    depth = jax.jit(lambda tr, st: measure_depth(tr, st, jconfig, jconfig.tree_capacity()))
    want = []
    for ply, b in boards.items():
        st = jstack_boards(b)
        tree = init(st, jax.random.key(ply))
        depths = []
        for s in range(3):
            tree = segment(tree, st)
            if s in (0, 2):
                d = np.asarray(depth(tree, st))
                depths.append([float(d.mean()), float(np.percentile(d, 95)), int(d.max())])
        want.append({"ply": ply, "rows": 5, "first": depths[0], "final": depths[1]})
    assert got == want
    assert max(r["final"][2] for r in got) > 1  # the trees grew past the root's children

    pools = {n: descent_depth_profile.mixed_pool(n, 1000 + n, "cpu") for n in (6, 12)}
    assert [int(p.age.shape[0]) for p in pools.values()] == [6, 12]
    assert all(bool((p.result == 0).all()) for p in pools.values())
    cost = descent_depth_profile.segment_cost_by_rows(centre_evaluator_batched, pools, MCTSConfig(**config), spc,
                                                      reps=1)
    assert [c["rows"] for c in cost] == [6, 12] and all(c["ms"] > 0 for c in cost)
