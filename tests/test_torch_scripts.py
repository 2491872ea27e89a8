"""The port's run tools (``connect4_tpu_torch.scripts``: matches,
reevaluate_run, plot_training_graphs, compare_runs, evaluate_posn,
view_games, game_stats, verify_supervised, ship_run_artifacts), the
``--help`` and missing-card refusal of every tool, and the port's example
configs against the JAX package's scripts and functions, on the
CPU at small sizes: the same inputs, made from seeds with numpy, through
both sides."""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.config import ModelConfig as JModelConfig
from connect4_tpu.config import NetConfig as JNetConfig
from connect4_tpu.env.convert import stack_boards as jstack_boards
from connect4_tpu.eval.evaluators import make_net_evaluator as jmake_net_evaluator
from connect4_tpu.eval.match import MatchPlayer as JMatchPlayer
from connect4_tpu.eval.match import play_match as jplay_match
from connect4_tpu.mcts.batched import make_search_fn as jmake_search_fn
from connect4_tpu.models import init_net as jinit_net
from connect4_tpu.training import checkpoint as jckpt
from connect4_tpu.training import learner as jlearner
from connect4_tpu_torch.config import ModelConfig, NetConfig, load_config_file
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.models.convert import load_example_net, train_state_from_flax
from connect4_tpu_torch.scripts import (
    compare_runs,
    evaluate_posn,
    game_stats,
    matches,
    plot_training_graphs,
    reevaluate_run,
    ship_run_artifacts,
    verify_supervised,
    view_games,
)
from connect4_tpu_torch.training import checkpoint as ckpt
from connect4_tpu_torch.training import replay
from connect4_tpu_torch.training.self_play import make_play_fn
from connect4_tpu_torch.training.tables import load_table, save_table

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_NET = dict(filters=4, n_fc_layers=1, n_residuals=1)
TOOLS = [
    "selfplay_breakdown", "profile_search", "profile_refill_wave", "sweep_search_batch",
    "descent_depth_profile", "matches", "reevaluate_run", "plot_training_graphs", "compare_runs",
    "evaluate_posn", "view_games", "game_stats", "verify_supervised", "ship_run_artifacts",
    "measure_compile", "k_head_to_head", "draw_bucket_diagnosis", "draw_bucket_experiment", "finalize_fullset",
    "pallas_eval_speed",
]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_script(name):
    """The JAX package's ``scripts/<name>.py`` as a module, for its main."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_jax_main(name, argv, monkeypatch, capsys):
    """Stdout of the JAX script run with ``argv`` (its XLA cache kept off:
    the tests write nothing outside their temporary directories)."""
    import connect4_tpu.utils

    monkeypatch.setattr(connect4_tpu.utils, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [name] + [str(a) for a in argv])
    capsys.readouterr()
    jax_script(name).main()
    return capsys.readouterr().out


def human_lines(out):
    """A port tool's stdout without its closing JSON line."""
    lines = out.rstrip("\n").split("\n")
    assert lines[-1].startswith("{"), lines[-1]
    return lines[:-1]


def flax_net(seed, net=TINY_NET):
    """A Flax net's variables, and the JAX ``TrainState`` around them."""
    jnet, var = jinit_net(JNetConfig(**net), jax.random.key(seed))
    opt = jlearner.make_optimizer(JModelConfig(net_config=JNetConfig(**net)))
    return jnet, var, jlearner.TrainState(var["params"], var["batch_stats"], opt.init(var["params"]))


def port_state(var, net=TINY_NET, lr=0.01):
    """The port's learner state with the Flax variables' weights."""
    zeros = jax.tree_util.tree_map(lambda x: np.zeros(np.shape(x), np.float32), var["params"])
    return train_state_from_flax(ModelConfig(net_config=NetConfig(**net)), _np_tree(var["params"]),
                                 _np_tree(var["batch_stats"]), zeros, lr, device="cpu")


def save_port_generations(save_dir, seeds, net=TINY_NET):
    """Port checkpoints of the nets of ``flax_net(seed)``, generation 1, 2, ...;
    returns the JAX side's ``(net, variables, state)`` a generation."""
    out = {}
    for gen, seed in enumerate(seeds, start=1):
        jnet, var, jstate = flax_net(seed, net)
        ckpt.save_checkpoint(str(save_dir), gen, port_state(var, net), torch.Generator())
        out[gen] = (jnet, var, jstate)
    return out


@pytest.fixture(scope="module")
def generations(tmp_path_factory):
    """One run of two generations shared by the tests that read a run:
    ``(run_dir, {gen: (jax net, variables, jax state)})``. The tools only
    read it (each writes under its own output directory)."""
    run = tmp_path_factory.mktemp("run")
    return str(run), save_port_generations(run, [11, 12])


@pytest.fixture(scope="module")
def games_npz(tmp_path_factory):
    """A ``games.npz`` of six centre-heuristic games written by the port."""
    d = tmp_path_factory.mktemp("games")
    from connect4_tpu_torch.config import MCTSConfig

    out = make_play_fn(centre_evaluator_batched, MCTSConfig(simulations=8, num_sampling_moves=4,
                                                             root_dirichlet_alpha=0.3,
                                                             root_exploration_fraction=0.25), 6,
                       device="cpu")(torch.Generator().manual_seed(3))
    replay.save_generation(str(d), 1, out)
    return os.path.join(str(d), "1", "games.npz")


@pytest.fixture(scope="module")
def small_sets(tmp_path_factory):
    """Benchmark sets cut from the packaged ones: 300 8-ply and 200 7-ply
    positions, a few of each marked unsolved."""
    from connect4_tpu_torch.config import StorageConfig

    d = tmp_path_factory.mktemp("sets")
    rng = np.random.default_rng(0)
    for name, n in (("connect4dataset_8ply.npz", 300), ("connect4dataset_7ply.npz", 200)):
        with np.load(os.path.join(StorageConfig().data_dir, name)) as full:
            rows = rng.choice(len(full["values"]), n, replace=False)
            arrays = {k: full[k][rows] for k in full.files}
        arrays["solved"] = rng.random(n) > 0.1
        np.savez(os.path.join(str(d), name), **arrays)
    return str(d)


@pytest.mark.parametrize("tool", TOOLS)
def test_every_tool_has_help(tool, capsys):
    module = importlib.import_module(f"connect4_tpu_torch.scripts.{tool}")
    with pytest.raises(SystemExit) as exc:
        module.main(["--help"])
    assert exc.value.code == 0
    assert "usage:" in capsys.readouterr().out


@pytest.mark.parametrize("tool,argv", [
    ("selfplay_breakdown", []),
    ("profile_search", []),
    ("profile_refill_wave", []),
    ("sweep_search_batch", []),
    ("descent_depth_profile", []),
    ("matches", ["run", "--gens", "1", "2"]),
    ("reevaluate_run", ["-c", "config.py", "--out", "out"]),
    ("evaluate_posn", ["position.txt"]),
    ("verify_supervised", []),
    ("measure_compile", []),
    ("k_head_to_head", []),
    ("draw_bucket_diagnosis", []),
    ("draw_bucket_experiment", ["--run-dir", "run"]),
    ("finalize_fullset", ["--out", "out"]),
    ("pallas_eval_speed", []),
])
def test_compute_tools_refuse_a_missing_cuda(tool, argv):
    """The default device is CUDA; without a card a tool raises before it
    reads a file, instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    module = importlib.import_module(f"connect4_tpu_torch.scripts.{tool}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_view_games_and_game_stats_print_what_the_jax_scripts_print(games_npz, monkeypatch, capsys):
    for index in ("0", "5"):
        want = run_jax_main("view_games", [games_npz, index], monkeypatch, capsys)
        view_games.main([games_npz, index])
        assert human_lines(capsys.readouterr().out) == want.rstrip("\n").split("\n")
    want = run_jax_main("game_stats", [games_npz], monkeypatch, capsys)
    stats = game_stats.main([games_npz])
    assert human_lines(capsys.readouterr().out) == want.rstrip("\n").split("\n")
    assert stats["games"] == 6 and sum(stats["first_moves"]) == 6


def test_compare_runs_prints_what_the_jax_script_prints(tmp_path, monkeypatch, capsys):
    """The same rows, as pandas pickles for the JAX script and as the port's
    JSON tables: the same printed comparison, a missing table included."""
    import pandas as pd

    from connect4_tpu_torch.training.stats import CombinedStats, ValueStats

    rng = np.random.default_rng(1)
    specs = []
    for name, n in (("k1", 3), ("k8", 2)):
        run = tmp_path / name
        run.mkdir()
        for table, make in (("8ply", ValueStats), ("7ply", CombinedStats)):
            rows = []
            for _ in range(n):
                s = make()
                preds = rng.random(50).astype(np.float32)
                targets = rng.choice([0.0, 0.5, 1.0], 50).astype(np.float32)
                if table == "8ply":
                    s.update(preds, targets, float(rng.random()))
                else:
                    prior = rng.dirichlet(np.ones(7), 50).astype(np.float32)
                    s.update(preds, targets, float(rng.random()), prior, prior, float(rng.random()))
                rows.append(s.to_dict())
            save_table(str(run), table, rows)
            pd.DataFrame(load_table(str(run), table)).to_pickle(str(run / f"{table}.pkl"))
        specs.append(f"{name}={run}")
    specs.append(f"none={tmp_path / 'absent'}")
    for table in ("8ply", "7ply"):
        want = run_jax_main("compare_runs", specs + ["--pickle", f"{table}.pkl"], monkeypatch, capsys)
        compare_runs.main(specs + ["--table", table])
        got = capsys.readouterr()
        assert human_lines(got.out) == want.rstrip("\n").split("\n")
        assert "none: no" in got.err


def test_matches_table_equals_the_jax_round_robin(generations):
    """Float32 nets from equal Flax weights, noise off: the return of the
    pair equals the JAX ``play_match``'s with the seed ``g1 * 1000 + g2``,
    and the table prints as the JAX script prints it."""
    run, gens = generations
    sims = 4
    got = matches.matches(run, [1, 2], simulations=sims, plies=1, device="cpu")
    players = [JMatchPlayer(f"gen{g}", jmake_net_evaluator(n, v["params"], v["batch_stats"]),
                            JMCTSConfig(simulations=sims)) for g, (n, v, _) in gens.items()]
    want = jplay_match(*players, plies=1, switch=True, seed=1002, display=False)["return"]
    assert got["returns"] == {"1-2": want}
    assert got["table"] == ["", "returns (row vs column):", "      g   1  g   2",
                            f"g   1    -    {want:.3f}", f"g   2  {1 - want:.3f}    -  "]


def _jax_config_file(path, save_dir, data_dir):
    path.write_text(
        "from connect4_tpu.config import *\n"
        f"config = AlphaZeroConfig(model_config=ModelConfig(net_config=NetConfig(filters=4, n_fc_layers=1, "
        f"n_residuals=1)), storage_config=StorageConfig(save_dir={str(save_dir)!r}, data_dir={str(data_dir)!r}))\n"
    )
    return str(path)


def _port_config_file(path, save_dir, data_dir=None):
    extra = "" if data_dir is None else f", data_dir={str(data_dir)!r}"
    path.write_text(
        "from connect4_tpu_torch.config import *\n"
        f"config = AlphaZeroConfig(model_config=ModelConfig(net_config=NetConfig(filters=4, n_fc_layers=1, "
        f"n_residuals=1)), storage_config=StorageConfig(save_dir={str(save_dir)!r}{extra}))\n"
    )
    return str(path)


def test_reevaluate_run_rows_match_the_jax_script(tmp_path, generations, small_sets, monkeypatch, capsys):
    """Two generations, ``--stride 2`` (generation 2 alone), the solved
    subset of partly solved sets (``--allow-partial``): every column of the
    8ply and 7ply rows within 1e-5 of the JAX script's pickles."""
    import pandas as pd

    run, gens = generations
    jrun = tmp_path / "jax"
    for g, (_, _, jstate) in gens.items():
        jckpt.save_checkpoint(str(jrun), g, jstate, jax.random.key(0))
    jcfg = _jax_config_file(tmp_path / "jcfg.py", jrun, small_sets)
    run_jax_main("reevaluate_run", ["-c", jcfg, "--out", tmp_path / "jout", "--allow-partial", "--stride", 2],
                 monkeypatch, capsys)
    pcfg = _port_config_file(tmp_path / "pcfg.py", run, small_sets)
    with pytest.raises(SystemExit, match="partially built"):
        reevaluate_run.main(["-c", pcfg, "--out", str(tmp_path / "pout"), "--device", "cpu"])
    got = reevaluate_run.main(["-c", pcfg, "--out", str(tmp_path / "pout"), "--allow-partial", "--stride", "2",
                               "--device", "cpu"])
    assert got["generations"] == [2] and got["curves"] is True
    assert os.path.exists(tmp_path / "pout" / "8ply.png")
    for table in ("8ply", "7ply"):
        want = pd.read_pickle(tmp_path / "jout" / f"{table}.pkl")
        rows = load_table(str(tmp_path / "pout"), table)
        assert [r["generation"] for r in rows] == list(want.index) == [2]
        for row, (_, jrow) in zip(rows, want.iterrows()):
            for col in want.columns:
                if col == "correct":
                    assert {float(k): tuple(v) for k, v in row[col].items()} == jrow[col]
                else:
                    np.testing.assert_allclose(row[col], jrow[col], rtol=0, atol=1e-5, err_msg=col)


def test_reevaluate_equals_the_rows_the_loop_wrote(tmp_path):
    """A generation of the port's own loop, then the tool on its checkpoint:
    the same rows as the loop's (the loop evaluates the net it has just
    saved)."""
    from connect4_tpu_torch.config import AlphaZeroConfig, StorageConfig
    from connect4_tpu_torch.training.loop import TrainingLoop

    config = AlphaZeroConfig(
        model_config=ModelConfig(net_config=NetConfig(**TINY_NET), batch_size=64, n_training_epochs=1),
        storage_config=StorageConfig(save_dir=str(tmp_path / "run")),
        simulations=8, n_training_games=4, selfplay_batch=4, num_sampling_moves=4, n_eval=0,
    )
    TrainingLoop(config, device="cpu").run(generations=1)
    got = reevaluate_run.reevaluate(str(tmp_path / "run"), config.storage_config.data_dir, str(tmp_path / "out"),
                                    device="cpu")
    for table in ("8ply", "7ply"):
        loop_rows = load_table(str(tmp_path / "run"), table)
        tool_rows = load_table(str(tmp_path / "out"), table)
        assert len(loop_rows) == len(tool_rows) == 1
        assert {k: v for k, v in tool_rows[0].items() if k != "generation"} == loop_rows[0]
    assert got["sets"] == {"8ply": [67557, 67557], "7ply": [54131, 54131]}


def test_evaluate_posn_matches_the_jax_script_and_search(tmp_path, generations, monkeypatch, capsys):
    """The same parsed board as the JAX script prints; a float32 checkpoint's
    value and prior within 1e-5 of the JAX evaluator's; with ``--search``
    the same root visit counts and move as the JAX search (no noise, K=1)."""
    pos = tmp_path / "position.txt"
    pos.write_text(". . . . . . .\n. . . . . . .\n. . . . . . .\n. . . x . . .\n"
                   ". . o o x . .\n. x o o x o .\n")
    jout = run_jax_main("evaluate_posn", [pos], monkeypatch, capsys)
    board = evaluate_posn.parse_position(str(pos))
    run, gens = generations
    jnet, var, _ = gens[1]
    sims = 24
    got = evaluate_posn.main([str(pos), "--checkpoint-dir", run, "--generation", "1", "--simulations", str(sims),
                              "--search", "--device", "cpu"])
    lines = human_lines(capsys.readouterr().out)
    n_board = str(board).count("\n") + 1
    assert lines[:n_board + 1] == jout.split("\n")[:n_board + 1]  # the board and the side to move
    assert got["player"] == "net(gen1)" and got["to_move"] == "x"

    jeval = jmake_net_evaluator(jnet, var["params"], var["batch_stats"])
    state = jstack_boards([board])
    value, prior = jeval(state)
    np.testing.assert_allclose(got["value"], float(value[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["prior"], np.asarray(prior[0]), rtol=0, atol=1e-5)
    res = jmake_search_fn(jeval, JMCTSConfig(simulations=sims))(state, jax.random.key(0))
    base = int(res.tree.children_base[0, 0])
    assert got["root_visits"] == np.asarray(res.tree.visits[0, base:base + 7]).tolist()
    assert got["move"] == int(res.move[0]) and sum(got["root_visits"]) == sims

    # the packaged gen-161 net is the default
    default = evaluate_posn.main([str(pos), "--device", "cpu"])
    assert default["player"] == "gen161" and 0.0 <= default["value"] <= 1.0
    assert abs(sum(default["prior"]) - 1.0) < 1e-5


def test_verify_supervised_losses_match_the_jax_learner(generations, small_sets):
    """One epoch from equal float32 weights in the order
    ``default_rng(0)`` draws (both sides draw it): every step's loss within
    1e-5 of the JAX learner's."""
    jnet, var, _ = generations[1][1]
    batch = 64
    got = verify_supervised.verify_supervised(small_sets, epochs=1, batch_size=batch, lr=0.01,
                                              net_config=NetConfig(**TINY_NET), device="cpu",
                                              state=port_state(var))
    planes, values, policies = verify_supervised.load_sets(small_sets)
    opt = jlearner.make_optimizer(JModelConfig(net_config=JNetConfig(**TINY_NET)))
    jstate = jlearner.TrainState(var["params"], var["batch_stats"],
                                 jlearner.set_learning_rate(opt.init(var["params"]), 0.01))
    step = jax.jit(jlearner.make_train_step(jnet, opt))
    order = np.random.default_rng(0).permutation(len(values))
    want = []
    for i in range(0, len(values) - batch + 1, batch):
        idx = jnp.asarray(order[i:i + batch])
        jstate, m = step(jstate, jnp.take(jnp.asarray(planes), idx, axis=0),
                         jnp.take(jnp.asarray(values), idx, axis=0), jnp.take(jnp.asarray(policies), idx, axis=0))
        want.append(float(m["loss"]))
    epoch = got["epochs"][0]
    assert epoch["steps"] == len(want) == (len(values) // batch)
    np.testing.assert_allclose(epoch["losses"], want, rtol=0, atol=1e-5)
    assert got["positions"] == len(values) < 500  # the unsolved rows were left out


def test_ship_run_artifacts_and_plot_training_graphs(tmp_path, monkeypatch, capsys):
    """The shipped npz loads through ``load_example_net`` to the checkpoint's
    net bit for bit; tables, config and curves are copied; without
    matplotlib the tools say that no curves were drawn."""
    net = dict(filters=16, n_fc_layers=2, n_residuals=1, compute_dtype="bfloat16")
    from connect4_tpu_torch.training.learner import init_train_state

    run = tmp_path / "run"
    for gen in (1, 2):
        state = init_train_state(ModelConfig(net_config=NetConfig(**net)), torch.Generator().manual_seed(gen), "cpu")
        ckpt.save_checkpoint(str(run), gen, state, torch.Generator())
    save_table(str(run), "8ply", [{"Average loss": 0.2, "Accuracy": 0.5}, {"Average loss": 0.1, "Accuracy": 0.6}])
    save_table(str(run), "match_results", [{"wins": 3, "draws": 1, "losses": 0, "return": 0.875}])
    cfg = _port_config_file(tmp_path / "cfg.py", run)
    (tmp_path / "train.log").write_text("generation 1\n")
    got = ship_run_artifacts.main(["-c", cfg, "--dest", str(tmp_path / "dest"), "--gen", "1",
                                   "--log", str(tmp_path / "train.log")])
    shipped = load_example_net(got["npz"], device="cpu")
    want = ckpt.restore_checkpoint(str(run), 1, device="cpu")[0].net
    assert shipped.config == want.config
    for k, v in want.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, shipped.state_dict()[k]), k
    out = tmp_path / "dest" / "example_run"
    assert load_table(str(out), "8ply") == load_table(str(run), "8ply")
    assert set(os.listdir(out)) >= {"8ply.json", "match_results.json", "config.py", "train.log",
                                    "PACKAGED.json", "8ply.png", "match_results.png"}
    assert got["curves"] is True
    assert sorted(os.listdir(tmp_path / "dest" / "example_net")) == ["example_net_1.npz", "net_config.json"]

    written = plot_training_graphs.main([str(run)])
    assert written == ["8ply.png", "match_results.png"]

    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    again = ship_run_artifacts.main(["-c", cfg, "--dest", str(tmp_path / "dest2")])
    assert again["generation"] == 2 and again["curves"] is False
    assert "no curves drawn: matplotlib is not installed" in capsys.readouterr().out
    assert not any(f.endswith(".png") for f in os.listdir(tmp_path / "dest2" / "example_run"))
    with pytest.raises(SystemExit, match="matplotlib is not installed"):
        plot_training_graphs.main([str(tmp_path / "dest2" / "example_run")])


def test_ship_run_artifacts_needs_no_card(tmp_path, monkeypatch):
    """As the JAX tool, it takes no device: with CUDA unavailable it
    restores a float32 checkpoint to the CPU and ships it bit for bit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = tmp_path / "run"
    _, var, _ = flax_net(7)
    ckpt.save_checkpoint(str(run), 3, port_state(var), torch.Generator())
    cfg = _port_config_file(tmp_path / "cfg.py", run)
    with pytest.raises(SystemExit):
        ship_run_artifacts.main(["-c", cfg, "--dest", str(tmp_path / "dest"), "--device", "cpu"])
    got = ship_run_artifacts.main(["-c", cfg, "--dest", str(tmp_path / "dest")])
    assert got["generation"] == 3 and os.path.basename(got["npz"]) == "example_net_3.npz"
    shipped = load_example_net(got["npz"], device="cpu")
    want = port_state(var).net
    assert shipped.config == want.config
    for k, v in want.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, shipped.state_dict()[k]), k


@pytest.mark.parametrize("name", ["config", "config_r3_k1", "config_r3_k8", "config_r3_k8_draw"])
def test_example_configs_equal_the_jax_ones(name):
    """Field for field; the directories are the port's own (its run
    directory under the same name, the packaged benchmark sets)."""
    from connect4_tpu.config import load_config_file as jload_config_file

    mine = load_config_file(os.path.join(ROOT, "connect4_tpu_torch", "examples", f"{name}.py"))
    theirs = jload_config_file(os.path.join(ROOT, "examples", f"{name}.py"))
    a, b = dataclasses.asdict(mine), dataclasses.asdict(theirs)
    sa, sb = a.pop("storage_config"), b.pop("storage_config")
    assert a == b
    assert os.path.basename(sa["save_dir"]) == os.path.basename(sb["save_dir"]).replace(
        "connect4_tpu_runs", "connect4_tpu_torch_runs")
    assert sa["data_dir"] == os.path.join(ROOT, "connect4_tpu_torch", "data")
