"""The port's replay storage, checkpoints, statistics, training loop and CLI
(``connect4_tpu_torch.training``, ``connect4_tpu_torch.cli``) against the JAX
package's: files written by either package read by the other, the
statistics on the same random arrays, a ``_train`` pass against the JAX
learner, and a miniature two-generation loop with resume, on the CPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.config import ModelConfig as JModelConfig
from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.training import learner as jlearner
from connect4_tpu.training import replay as jreplay
from connect4_tpu.training import stats as jstats
from connect4_tpu.training.self_play import make_play_fn as jmake_play_fn
from connect4_tpu_torch.config import (
    AlphaZeroConfig,
    MCTSConfig,
    ModelConfig,
    NetConfig,
    StorageConfig,
    load_config_file,
)
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.models.convert import from_flax, train_state_from_flax
from connect4_tpu_torch.training import checkpoint as ckpt
from connect4_tpu_torch.training import learner, replay, stats
from connect4_tpu_torch.training.loop import TrainingLoop
from connect4_tpu_torch.training.self_play import make_play_fn
from connect4_tpu_torch.training.tables import load_table

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = dict(filters=4, n_fc_layers=1, n_residuals=1)


def _port_output(batch=3, sims=6, seed=0):
    play = make_play_fn(centre_evaluator_batched, MCTSConfig(simulations=sims), batch, device="cpu")
    return play(torch.Generator().manual_seed(seed))


def _jax_output(batch=3, sims=6):
    play = jmake_play_fn(jcentre, JMCTSConfig(simulations=sims), batch)
    return jax.tree_util.tree_map(np.asarray, play(jax.random.key(0)))


def _assert_same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_window_size_schedule_matches_jax():
    for gen in (1, 2, 3, 10, 39, 40, 100):
        assert replay.window_size(gen) == jreplay.window_size(gen)
    assert replay.window_size(39) == 20


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_replay_files_are_interchangeable(tmp_path, writer):
    """Generations written by one package (``save_generation`` for gens 1
    and 2, ``append_generation`` of two waves for gen 3) load in the other:
    both loaders return equal arrays of equal dtypes, also for
    ``load_window_ex`` with a target mix and draw weights."""
    d = str(tmp_path)
    if writer == "port":
        out, mod = _port_output(), replay
        out2 = _port_output(seed=1)
    else:
        out, mod = _jax_output(), jreplay
        out2 = out
    n = mod.save_generation(d, 1, out)
    assert n == 2 * int(np.asarray(out.mask).sum())
    mod.save_generation(d, 2, out2)
    mod.append_generation(d, 3, [out, out2])
    for gen in (1, 3):
        _assert_same_arrays(replay.load_window(d, gen), jreplay.load_window(d, gen))
        _assert_same_arrays(
            replay.load_window_ex(d, gen, 0.5, 4.0), jreplay.load_window_ex(d, gen, 0.5, 4.0)
        )
        _assert_same_arrays(replay.load_window_ex(d, gen), jreplay.load_window_ex(d, gen))
    # gen 3's window covers gens 2..3
    assert len(replay.load_window(d, 3)[1]) == len(jreplay.load_window(d, 2)[1]) + \
        2 * int(np.asarray(out.mask).sum()) + 2 * int(np.asarray(out2.mask).sum())
    with np.load(os.path.join(d, "1", "games.npz")) as mine:
        assert {k: mine[k].dtype.name for k in mine.files} == {
            "moves": "int8", "move_values": "float32", "policies": "float32",
            "mask": "bool", "result": "int8", "length": "int32",
        }


def test_load_window_ex_q_recovery_and_weights(tmp_path):
    """As the JAX package's test: q lines up with the rows of data.npz, and
    the weight column marks rows of drawn games only."""
    out = _port_output()
    replay.save_generation(str(tmp_path), 1, out)
    planes, z, policies = replay.load_window(str(tmp_path), 1)
    p2, mixed, pol2, w = replay.load_window_ex(str(tmp_path), 1, value_target_mix=0.5, draw_loss_weight=4.0)
    np.testing.assert_array_equal(planes, p2)
    np.testing.assert_array_equal(policies, pol2)
    b_idx, t_idx = np.nonzero(out.mask.numpy())
    q_sel = out.move_values.numpy()[b_idx, t_idx]
    np.testing.assert_allclose(mixed, 0.5 * z + 0.5 * np.concatenate([q_sel, q_sel]), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(w, np.where(z == 0.5, 4.0, 1.0).astype(np.float32))
    # mix 0 and weight 1: the classic loader's arrays, and no weights
    _, z0, _, w0 = replay.load_window_ex(str(tmp_path), 1)
    np.testing.assert_array_equal(z0, z)
    assert w0 is None


def test_window_tolerates_missing_generations(tmp_path, capsys):
    out = _port_output()
    n = replay.save_generation(str(tmp_path), 7, out)
    planes, values, policies = replay.load_window(str(tmp_path), 7)  # window 4..7, only 7 exists
    assert len(planes) == n
    assert "missing from disk" in capsys.readouterr().out
    planes, values, policies, w = replay.load_window_ex(str(tmp_path), 7)
    assert len(planes) == n and w is None
    with pytest.raises(FileNotFoundError):
        replay.load_window(str(tmp_path), 3)


def test_game_str_matches_jax():
    out = _port_output()
    fields = [x.numpy() for x in (out.moves[0], out.move_values[0], out.policies[0], out.length[0])]
    text = replay.game_str(*fields)
    assert text == jreplay.game_str(*fields)
    assert text.count("Move:") == int(out.length[0])


def _trained_state(seed, steps=2):
    """A learner a few steps into training: non-trivial momentum, running
    statistics and learning rate."""
    cfg = ModelConfig(net_config=NetConfig(**TINY_NET))
    state = learner.init_train_state(cfg, torch.Generator().manual_seed(seed), device="cpu")
    learner.set_learning_rate(state.optimizer, 0.0037)
    step = learner.make_train_step(state.net, state.optimizer)
    g = torch.Generator().manual_seed(seed + 100)
    for _ in range(steps):
        step(
            torch.rand((16, 6, 7, 3), generator=g).round(),
            torch.rand((16,), generator=g),
            torch.softmax(torch.randn((16, 7), generator=g), -1),
        )
    return cfg, state


def test_checkpoint_round_trip_bit_for_bit(tmp_path):
    """Net, running statistics, momentum, learning rate and the generator's
    state come back bit for bit into a differently initialised learner."""
    cfg, state = _trained_state(0)
    gen = torch.Generator().manual_seed(123)
    torch.rand(5, generator=gen)  # a generator that has been used
    path = ckpt.save_checkpoint(str(tmp_path), 5, state, gen)
    assert os.listdir(path) == [ckpt.FILE_NAME]  # no temporary file is left
    assert ckpt.latest_generation(str(tmp_path)) == 5
    expected_draw = torch.rand(4, generator=gen)

    _, fresh = _trained_state(9, steps=1)
    fresh_gen = torch.Generator().manual_seed(0)
    restored, rgen = ckpt.restore_checkpoint(str(tmp_path), 5, fresh, fresh_gen, device="cpu")
    assert restored is fresh and rgen is fresh_gen
    want, got = state.net.state_dict(), fresh.net.state_dict()
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for p, q in zip(state.net.parameters(), fresh.net.parameters()):
        assert torch.equal(
            state.optimizer.state[p]["momentum_buffer"], fresh.optimizer.state[q]["momentum_buffer"]
        )
    assert fresh.optimizer.param_groups[0]["lr"] == 0.0037
    assert torch.equal(torch.rand(4, generator=fresh_gen), expected_draw)
    with pytest.raises(FileNotFoundError):
        ckpt.restore_checkpoint(str(tmp_path), 4, fresh)


def test_restore_latest_steps_back_past_unreadable_checkpoints(tmp_path, capsys):
    d = str(tmp_path)
    _, state = _trained_state(1)
    ckpt.save_checkpoint(d, 1, state, torch.Generator())
    os.makedirs(os.path.join(d, "2", "ckpt"))  # present but empty
    os.makedirs(os.path.join(d, "3", "ckpt"))
    with open(os.path.join(d, "3", "ckpt", ckpt.FILE_NAME), "wb") as fh:
        fh.write(b"half a file")
    os.makedirs(os.path.join(d, "notes"))
    assert ckpt.checkpoint_generations(d) == [1, 2, 3]
    _, fresh = _trained_state(2)
    gen, restored, _ = ckpt.restore_latest(d, fresh)
    assert gen == 1 and restored is fresh
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, fresh.net.state_dict()[k]), k
    assert capsys.readouterr().out.count("falling back one generation") == 2
    shutil.rmtree(os.path.join(d, "1"))
    assert ckpt.restore_latest(d, fresh) is None
    assert ckpt.restore_latest(os.path.join(d, "absent"), fresh) is None


@pytest.mark.parametrize(
    "net",
    [dict(TINY_NET), dict(filters=16, n_fc_layers=2, n_residuals=1, compute_dtype="bfloat16")],
    ids=["float32", "bfloat16"],
)
def test_checkpoint_carries_its_architecture(tmp_path, net):
    """Restored without a state to load into, a checkpoint builds the net it
    was saved from (widths and compute dtype), bit for bit."""
    cfg = ModelConfig(net_config=NetConfig(**net))
    state = learner.init_train_state(cfg, torch.Generator().manual_seed(3), device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 7, state, torch.Generator())
    for restored in (
        ckpt.restore_checkpoint(str(tmp_path), 7, device="cpu")[0],
        ckpt.restore_latest(str(tmp_path), device="cpu")[1],
    ):
        assert restored.net.config == cfg.net_config
        assert not restored.net.training
        for k, v in state.net.state_dict().items():
            assert torch.equal(v, restored.net.state_dict()[k]), k


def test_restore_is_all_or_nothing(tmp_path, capsys):
    """A checkpoint whose net loads but whose optimiser does not leaves the
    learner and the generator exactly as they were."""
    d = str(tmp_path)
    _, state = _trained_state(4)
    path = os.path.join(ckpt.save_checkpoint(d, 1, state, torch.Generator()), ckpt.FILE_NAME)
    payload = torch.load(path, weights_only=True)
    payload["optimizer"] = {"state": {}, "param_groups": []}
    torch.save(payload, path)

    _, fresh = _trained_state(5)
    gen = torch.Generator().manual_seed(8)
    net_before = {k: v.clone() for k, v in fresh.net.state_dict().items()}
    momentum_before = [fresh.optimizer.state[p]["momentum_buffer"].clone() for p in fresh.net.parameters()]
    gen_before = gen.get_state()
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(d, 1, fresh, gen)
    assert ckpt.restore_latest(d, fresh, gen) is None
    assert "falling back one generation" in capsys.readouterr().out
    for k, v in net_before.items():
        assert torch.equal(v, fresh.net.state_dict()[k]), k
    for p, m in zip(fresh.net.parameters(), momentum_before):
        assert torch.equal(fresh.optimizer.state[p]["momentum_buffer"], m)
    assert fresh.optimizer.param_groups[0]["lr"] == 0.0037
    assert torch.equal(gen.get_state(), gen_before)


def test_train_epochs_visits_every_row_once_an_epoch():
    """Full batches and the tail, in the injected order or a fresh
    permutation an epoch; the losses come back as one tensor."""
    rows = torch.arange(11)
    seen = []

    def step(batch):
        seen.append(batch.tolist())
        return {"loss": batch.float().mean()}

    orders = [list(range(11)), list(range(10, -1, -1))]
    losses = learner.train_epochs(step, (rows,), 4, 2, epoch_orders=orders)
    assert [len(b) for b in seen] == [4, 4, 3, 4, 4, 3]
    assert sum(seen[:3], []) == orders[0] and sum(seen[3:], []) == orders[1]
    assert losses.shape == (6,) and float(losses[0]) == 1.5
    seen.clear()
    learner.train_epochs(step, (rows,), 64, 2, generator=torch.Generator().manual_seed(0))
    assert [sorted(b) for b in seen] == [list(range(11))] * 2 and seen[0] != seen[1]


def test_stats_match_jax_on_random_arrays():
    """Two updates of random predictions: every field of ``to_dict`` and
    the printed form equal the JAX package's."""
    rng = np.random.default_rng(0)
    mine, theirs = stats.CombinedStats(), jstats.CombinedStats()
    v_mine, v_theirs = stats.ValueStats(), jstats.ValueStats()
    for _ in range(2):
        preds = rng.random(200).astype(np.float32)
        targets = rng.choice([0.0, 0.5, 1.0], 200).astype(np.float32)
        prior = rng.dirichlet(np.ones(7), 200).astype(np.float32)
        label = np.round(rng.dirichlet(np.ones(7), 200), 1).astype(np.float32)
        for s in (mine, theirs):
            s.update(preds, targets, 0.21, prior, label, 0.4)
        for s in (v_mine, v_theirs):
            s.update(preds, targets, 0.3)
    assert mine.to_dict() == theirs.to_dict()
    assert repr(mine) == repr(theirs) and mine.loss == theirs.loss
    assert v_mine.to_dict() == v_theirs.to_dict()
    assert list(stats.categorise_predictions(np.array([0.1, 0.5, 0.95, 0.4]))) == [0.0, 0.5, 1.0, 0.5]


def test_config_copies_match_jax_and_reject_a_mesh(tmp_path):
    """``AlphaZeroConfig`` carries over field by field (only the default
    directories are the port's own), ``search_config`` equals the JAX one,
    and a mesh is accepted by the config but refused by the loop when no
    process group of its size exists (it never runs on one device)."""
    import dataclasses

    from connect4_tpu.config import AlphaZeroConfig as JAlphaZeroConfig

    mine, theirs = AlphaZeroConfig(parallel_sims=8, max_nodes=99), JAlphaZeroConfig(parallel_sims=8, max_nodes=99)
    a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    a.pop("storage_config"), b.pop("storage_config")
    assert a == b
    for training in (True, False):
        assert dataclasses.asdict(mine.search_config(training)) == dataclasses.asdict(theirs.search_config(training))
    for name in ("connect4dataset_7ply.npz", "connect4dataset_8ply.npz"):
        with open(os.path.join(StorageConfig().data_dir, name), "rb") as f, \
                open(os.path.join(theirs.storage_config.data_dir, name), "rb") as g:
            assert f.read() == g.read()
    assert AlphaZeroConfig(mesh_shape=(2,)).mesh_shape == (2,)
    config = AlphaZeroConfig(storage_config=StorageConfig(save_dir=str(tmp_path)), mesh_shape=(4,))
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        TrainingLoop(config, device="cpu")
    assert not os.listdir(tmp_path)


def _tiny_config(save_dir, **kw):
    return AlphaZeroConfig(
        model_config=ModelConfig(
            net_config=NetConfig(**TINY_NET), batch_size=64, n_training_epochs=1,
        ),
        storage_config=StorageConfig(save_dir=str(save_dir)),
        simulations=8, n_training_games=4, selfplay_batch=4, num_sampling_moves=4,
        n_eval=2, seed=0, **kw,
    )


def test_train_pass_matches_the_jax_learner(tmp_path):
    """``TrainingLoop._train`` on a stored generation, two epochs at batch
    64 with a tail batch and injected epoch orders, against the same pass
    with the JAX learner from the same weights: every parameter and running
    statistic within 1e-5, and the checkpoint is written."""
    config = _tiny_config(tmp_path)
    config.model_config.n_training_epochs = 2
    out = _port_output(batch=4, sims=8)
    replay.save_generation(str(tmp_path), 1, out)
    planes, values, policies = replay.load_window(str(tmp_path), 1)
    n = len(values)
    assert n % 64  # there is a tail batch
    rng = np.random.default_rng(0)
    orders = [rng.permutation(n) for _ in range(2)]

    jcfg = JModelConfig(net_config=JNetConfig(**TINY_NET), batch_size=64)
    net, var = jinit_net(jcfg.net_config, jax.random.key(0))
    opt = jlearner.make_optimizer(jcfg)
    jstate = jlearner.TrainState(var["params"], var["batch_stats"], opt.init(var["params"]))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731

    loop = TrainingLoop(config, device="cpu")
    carried = train_state_from_flax(
        config.model_config, np_tree(jstate.params), np_tree(jstate.batch_stats),
        np_tree(jstate.opt_state[1].inner_state[0].trace), jcfg.initial_lr, device="cpu",
    )
    loop.state.net.load_state_dict(carried.net.state_dict())
    loop._train(epoch_orders=orders)

    jstep = jax.jit(jlearner.make_train_step(net, opt))
    arrays = tuple(jnp.asarray(a) for a in (planes, values, policies))
    n_full = (n // 64) * 64
    jlosses = []
    for order in orders:
        for i in list(range(0, n_full, 64)) + [n_full]:
            idx = order[i:i + 64]
            jstate, m = jstep(jstate, *(a[idx] for a in arrays))
            jlosses.append(float(m["loss"]))
    np.testing.assert_allclose(loop.train_losses, jlosses, rtol=0, atol=1e-5)
    want = from_flax(config.model_config.net_config, np_tree(jstate.params), np_tree(jstate.batch_stats), device="cpu")
    for (k, a), b in zip(loop.state.net.state_dict().items(), want.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5, err_msg=k)
    assert ckpt.latest_generation(str(tmp_path)) == 1


def _run_two_generations_and_resume(tmp_path):
    """Two generations of the full loop with a tiny config, a resume in a
    new TrainingLoop, and the fallback past a broken checkpoint."""
    config = _tiny_config(tmp_path)
    loop = TrainingLoop(config, device="cpu")
    assert loop.gen == 1
    before = [p.detach().clone() for p in loop.state.net.parameters()]
    loop.run(generations=2)
    assert loop.gen == 3
    assert all(np.isfinite(loop.train_losses))
    assert any(not torch.equal(a, b) for a, b in zip(before, loop.state.net.parameters()))
    assert set(loop.timer.seconds) == {"generate", "train", "evaluate", "match"}

    for g in (1, 2):
        gdir = os.path.join(str(tmp_path), str(g))
        for name in ("data.npz", "games.npz", os.path.join("ckpt", ckpt.FILE_NAME)):
            assert os.path.exists(os.path.join(gdir, name)), (g, name)
    # both sets were evaluated each generation; gen 2 ran the gating match
    assert len(load_table(str(tmp_path), "8ply")) == 2
    rows7 = load_table(str(tmp_path), "7ply")
    assert len(rows7) == 2 and {"Average loss", "Accuracy", "prior Average loss", "prior Accuracy",
                                "Smallest", "Largest", "Average", "correct"} == set(rows7[0])
    matches = load_table(str(tmp_path), "match_results")
    assert len(matches) == 1 and set(matches[0]) == {"wins", "draws", "losses", "return"}
    assert matches[0]["wins"] + matches[0]["draws"] + matches[0]["losses"] == 98
    # the replay files of the port's loop load in the JAX package
    assert len(jreplay.load_window(str(tmp_path), 2)[1]) == len(replay.load_window(str(tmp_path), 2)[1])

    resumed = TrainingLoop(config, device="cpu")
    assert resumed.gen == 3
    for (k, a), b in zip(resumed.state.net.state_dict().items(), loop.state.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(resumed.generator.get_state(), loop.generator.get_state())
    assert len(resumed.stats_8ply) == 2 and len(resumed.match_results) == 1

    # a STOP file ends the run at the generation boundary
    open(os.path.join(str(tmp_path), "STOP"), "w").close()
    resumed.run(generations=1)
    assert resumed.gen == 3
    os.remove(os.path.join(str(tmp_path), "STOP"))

    # a crash mid-save can leave an empty checkpoint dir: resume falls back
    g2_ckpt = os.path.join(str(tmp_path), "2", "ckpt")
    shutil.rmtree(g2_ckpt)
    os.makedirs(g2_ckpt)
    fallback = TrainingLoop(config, device="cpu")
    assert fallback.gen == 2  # restored gen 1, continues at gen 2
    state1 = learner.init_train_state(config.model_config, torch.Generator().manual_seed(5), "cpu")
    ckpt.restore_checkpoint(str(tmp_path), 1, state1)
    for (k, a), b in zip(fallback.state.net.state_dict().items(), state1.net.state_dict().values()):
        assert torch.equal(a, b), k


def test_training_loop_end_to_end_and_resume(tmp_path):
    _run_two_generations_and_resume(tmp_path)
    assert os.path.exists(os.path.join(str(tmp_path), "8ply.png"))  # matplotlib is here


def test_training_loop_without_pandas_and_matplotlib(tmp_path, monkeypatch, capsys):
    """The same two generations with pandas and matplotlib impossible to
    import: training goes on, only the curves are not drawn."""
    for name in [m for m in sys.modules if m.split(".")[0] in ("pandas", "matplotlib")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        import matplotlib  # noqa: F401
    _run_two_generations_and_resume(tmp_path)
    assert "plot rendering failed" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(str(tmp_path), "8ply.png"))


def test_gating_match_falls_back_to_the_nearest_older_checkpoint(tmp_path, capsys):
    """Past generation 10 the opponent is the checkpoint of ten generations
    ago, or the nearest older one on disk."""
    config = _tiny_config(tmp_path, gating_plies=1)
    loop = TrainingLoop(config, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), 2, loop.state, loop.generator)
    loop.gen = 14  # wants generation 4; only 2 is there
    loop._match()
    assert "no checkpoint for generation 4; using generation 2" in capsys.readouterr().out
    row = load_table(str(tmp_path), "match_results")[-1]
    # the same net on both sides, noise off: the switched games mirror
    assert row["wins"] == row["losses"] and row["return"] == 0.5


def test_cli_training_and_match_on_the_cpu(tmp_path, capsys):
    """``training`` from a config file for one tiny generation, then
    ``match`` between the centre heuristic and that checkpoint."""
    from connect4_tpu_torch import cli

    cfg_path = tmp_path / "config.py"
    cfg_path.write_text(
        "from connect4_tpu_torch.config import *\n"
        "config = AlphaZeroConfig(\n"
        "    model_config=ModelConfig(net_config=NetConfig(filters=4, n_fc_layers=1, n_residuals=1),\n"
        "                             batch_size=64, n_training_epochs=1),\n"
        f"    storage_config=StorageConfig(save_dir={str(tmp_path / 'run')!r}),\n"
        "    simulations=8, n_training_games=6, selfplay_batch=4, parallel_sims=4,\n"
        "    num_sampling_moves=4, n_eval=0)\n"
    )
    assert load_config_file(str(cfg_path)).n_training_games == 6
    cli.main(["training", "-c", str(cfg_path), "--generations", "1", "--device", "cpu"])
    assert ckpt.latest_generation(str(tmp_path / "run")) == 1
    assert "positions created for training" in capsys.readouterr().out
    cli.main([
        "match", "--checkpoint-dir-2", str(tmp_path / "run"), "-s", "8", "--plies", "1",
        "--device", "cpu",
    ])
    out = capsys.readouterr().out
    assert "The results for player1 vs player2(gen1) are:" in out and "return" in out
    with pytest.raises(FileNotFoundError):
        cli.main(["match", "--checkpoint-dir-1", str(tmp_path / "none"), "--device", "cpu", "-s", "8"])
    bad = tmp_path / "bad.py"
    bad.write_text("config = 3\n")
    with pytest.raises(TypeError):
        load_config_file(str(bad))


def test_bench_gpu_refuses_to_run_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = subprocess.run(
        [sys.executable, "bench_gpu.py"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "BENCH_FAST": "1"},
    )
    assert run.returncode != 0
    assert "CUDA is not available" in run.stderr
    assert run.stdout.strip() == ""  # no result line
