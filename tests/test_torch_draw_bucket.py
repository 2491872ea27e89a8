"""The port's draw-bucket tools (``connect4_tpu_torch.scripts``:
draw_bucket_diagnosis, draw_bucket_experiment) against the JAX package's
scripts, on the CPU at small sizes: the same nets and data, made from
seeds with numpy, through both sides."""

import json
import re
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.training import checkpoint as jckpt
from connect4_tpu_torch.config import MCTSConfig, NetConfig
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.scripts import draw_bucket_diagnosis, draw_bucket_experiment
from connect4_tpu_torch.training import checkpoint as ckpt
from connect4_tpu_torch.training import replay
from connect4_tpu_torch.training.self_play import make_play_fn
from test_torch_last_tools import solved_cut
from test_torch_scripts import TINY_NET, flax_net, human_lines, jax_script, port_state, run_jax_main

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def assert_lines_agree(got, want, atol):
    """Two printouts line for line: the same text between the numbers, the
    numbers within ``atol``."""
    assert len(got) == len(want), (got, want)
    for a, b in zip(got, want):
        assert NUMBER.sub("#", a) == NUMBER.sub("#", b), (a, b)
        np.testing.assert_allclose([float(x) for x in NUMBER.findall(a)],
                                   [float(x) for x in NUMBER.findall(b)], rtol=0, atol=atol, err_msg=a)


@pytest.fixture(scope="module")
def run_with_games(tmp_path_factory):
    """A port run of two generations of centre-heuristic games (``data.npz``
    and ``games.npz`` each, so that λ > 0 recovers the search values) with
    a tiny net's checkpoint at generation 2, and a copy of the games beside
    the JAX checkpoint of the same net: ``(port_run, jax_run, jax_net, variables)``."""
    port_run = tmp_path_factory.mktemp("port_run")
    jax_run = tmp_path_factory.mktemp("jax_run")
    config = MCTSConfig(simulations=8, num_sampling_moves=4, root_dirichlet_alpha=0.3,
                        root_exploration_fraction=0.25)
    for gen in (1, 2):
        out = make_play_fn(centre_evaluator_batched, config, 8, device="cpu")(torch.Generator().manual_seed(gen))
        replay.save_generation(str(port_run), gen, out)
        shutil.copytree(replay.generation_dir(str(port_run), gen), replay.generation_dir(str(jax_run), gen))
    jnet, var, jstate = flax_net(21)
    ckpt.save_checkpoint(str(port_run), 2, port_state(var), torch.Generator())
    jckpt.save_checkpoint(str(jax_run), 2, jstate, jax.random.key(0))
    return str(port_run), str(jax_run), jnet, var


def test_draw_bucket_diagnosis_prints_what_the_jax_script_prints(tmp_path, monkeypatch, capsys):
    """A tiny float32 net as a JAX checkpoint with ``net_config.json`` and as
    a port checkpoint, on a fully solved cut of the 8-ply set: every printed
    number within 1e-5 of the JAX script's (the histograms exactly), the
    packaged run's line the same."""
    data = solved_cut(tmp_path / "sets", {"connect4dataset_8ply.npz": 600})
    jnet, var, jstate = flax_net(8)
    jdir = tmp_path / "jax_net"
    jckpt.save_checkpoint(str(jdir), 3, jstate, jax.random.key(0))
    (jdir / "net_config.json").write_text(json.dumps(TINY_NET))
    want = run_jax_main("draw_bucket_diagnosis", ["--data-dir", data, "--ckpt-dir", jdir, "--batch", 256],
                        monkeypatch, capsys).rstrip("\n").split("\n")
    ckpt.save_checkpoint(str(tmp_path / "run"), 3, port_state(var), torch.Generator())
    got = draw_bucket_diagnosis.main(["--data-dir", data, "--ckpt-dir", str(tmp_path / "run"), "--batch", "256",
                                      "--device", "cpu"])
    lines = human_lines(capsys.readouterr().out)
    assert_lines_agree(lines, want, atol=1e-5)
    assert lines[-1] == want[-1] and lines[-1].startswith("packaged run: {'generation': 161")
    hists = [line for line in want if "hist[" in line]
    assert [" ".join(map(str, s["hist"])) for s in got["classes"].values()] == [h.split(": ")[1] for h in hists]
    assert sum(s["n"] for s in got["classes"].values()) == got["positions"] == 600
    rc = got["recalibration"]
    assert max(s["bucket_acc"] for s in got["classes"].values()) <= 1 and 0 < rc["accuracy"] <= 1


def test_best_recalibration_is_the_best_pair_of_thresholds():
    """The cumulative-sum sweep against trying every pair of split points."""
    rng = np.random.default_rng(3)
    preds = rng.random(60)
    values = rng.choice([0.0, 0.5, 1.0], 60)
    order = np.argsort(preds)
    v = values[order]
    best = max(
        (v[:i] == 0.0).sum() + (v[i:j] == 0.5).sum() + (v[j:] == 1.0).sum()
        for i in range(61) for j in range(i, 61)
    )
    assert draw_bucket_diagnosis.best_recalibration(preds, values)["accuracy"] == best / 60


def _jax_experiment(jax_run, data, orders, variants, monkeypatch, capsys):
    """The JAX script's baseline and per-epoch scores, unrounded (its
    ``round`` is replaced), with the tiny net and the injected orders."""
    import connect4_tpu.config
    import connect4_tpu.utils

    monkeypatch.setattr(connect4_tpu.config, "NetConfig", lambda **kw: JNetConfig(**TINY_NET))
    monkeypatch.setattr(connect4_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
    calls = []

    def permutation(key, n):
        calls.append(n)
        return jnp.asarray(orders[(len(calls) - 1) % len(orders)])

    monkeypatch.setattr(jax.random, "permutation", permutation)
    module = jax_script("draw_bucket_experiment")
    module.round = lambda x, places=None: x
    monkeypatch.setattr(sys, "argv", ["draw_bucket_experiment", "--run-dir", jax_run, "--gen", "2", "--epochs",
                                      str(len(orders)), "--lr", "0.01", "--batch", "64", "--variants", variants,
                                      "--data-dir", data])
    capsys.readouterr()
    module.main()
    out = capsys.readouterr().out.rstrip("\n").split("\n")
    baseline = json.loads(out[1].split(": ", 1)[1])
    epochs = [json.loads(line.split(": ", 1)[1]) for line in out[2:]]
    return baseline, epochs


def test_draw_bucket_experiment_matches_the_jax_script(tmp_path, run_with_games, monkeypatch, capsys):
    """Two variants (one weighted with λ > 0, so q is recovered), two epochs
    in injected orders: the baseline's and every epoch's MSE and accuracies
    within 1e-5 of the JAX script's."""
    port_run, jax_run, _, _ = run_with_games
    data = solved_cut(tmp_path / "sets", {"connect4dataset_8ply.npz": 400})
    _, z, _, _ = replay.load_window_ex(port_run, 2)
    _, mixed, _, weights = replay.load_window_ex(port_run, 2, value_target_mix=0.5, draw_loss_weight=4.0)
    assert not np.array_equal(z, mixed) and weights is not None  # q recovered, rows weighted
    rng = np.random.default_rng(4)
    orders = [rng.permutation(len(z)) for _ in range(2)]
    want_base, want = _jax_experiment(jax_run, data, orders, "1:0,4:0.5", monkeypatch, capsys)
    got = draw_bucket_experiment.experiment(port_run, 2, data, epochs=2, lr=0.01, batch=64,
                                            variants=[(1.0, 0.0), (4.0, 0.5)], device="cpu",
                                            net_config=NetConfig(**TINY_NET), epoch_orders=orders)
    lines = capsys.readouterr().out.rstrip("\n").split("\n")
    assert lines[0] == "8-ply eval set: 400 solved positions" and lines[1].startswith("baseline gen-2: {")
    assert [line.split(":")[0] for line in lines[2:]] == [
        f"w={w} lam={lam} epoch={e}" for w, lam in ((1.0, 0.0), (4.0, 0.5)) for e in (1, 2)]
    assert got["baseline"].keys() == want_base.keys()
    np.testing.assert_allclose(list(got["baseline"].values()), list(want_base.values()), rtol=0, atol=1e-5)
    scores = [e for v in got["variants"] for e in v["epochs"]]
    assert len(scores) == len(want) == 4
    for mine, theirs in zip(scores, want):
        np.testing.assert_allclose([mine[k] for k in theirs], list(theirs.values()), rtol=0, atol=1e-5)
    assert scores[0] != scores[2]  # the variants trained on different targets
    assert [v["steps_per_epoch"] for v in got["variants"]] == [len(z) // 64] * 2


def test_each_draw_bucket_variant_restarts_from_the_checkpoint(tmp_path, run_with_games, capsys):
    """``1:0,1:0``: the second variant trains from the checkpoint as saved,
    not from where the first one ended, so both give the same numbers."""
    port_run = run_with_games[0]
    data = solved_cut(tmp_path / "sets", {"connect4dataset_8ply.npz": 200})
    got = draw_bucket_experiment.experiment(port_run, 2, data, epochs=2, lr=0.05, batch=64,
                                            variants=draw_bucket_experiment.parse_variants("1:0,1:0"),
                                            device="cpu", net_config=NetConfig(**TINY_NET))
    first, second = (v["epochs"] for v in got["variants"])
    assert first == second
    assert first[0] != got["baseline"] and first[1] != first[0]  # it trained


