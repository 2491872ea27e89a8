"""Three of the port's last five tools (``connect4_tpu_torch.scripts``:
k_head_to_head, finalize_fullset, measure_compile) against the JAX
package's functions and the port's own tools they chain, on the CPU at
small sizes: the same inputs, made from seeds with numpy, through both
sides. The draw-bucket tools are in ``test_torch_draw_bucket.py``."""

import json
import os

import numpy as np
import pytest
import torch

from connect4_tpu.config import MCTSConfig as JMCTSConfig
from connect4_tpu.eval.evaluators import make_net_evaluator as jmake_net_evaluator
from connect4_tpu.eval.match import MatchPlayer as JMatchPlayer
from connect4_tpu.eval.match import play_match as jplay_match
from connect4_tpu_torch.config import NetConfig, StorageConfig
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval.evaluators import make_net_evaluator
from connect4_tpu_torch.scripts import (
    finalize_fullset,
    k_head_to_head,
    measure_compile,
    reevaluate_run,
    verify_supervised,
)
from connect4_tpu_torch.training.tables import load_table
from test_torch_scripts import TINY_NET, _port_config_file, flax_net, port_state, save_port_generations

# The suite runs several workers at once, each with JAX's threads beside
# PyTorch's: one intra-op thread a worker keeps these small nets from
# contending for the cores (the results do not depend on it).
torch.set_num_threads(1)


def solved_cut(directory, sizes, seed=0):
    """Rows cut from the packaged sets, every one solved: ``{name: n}``."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for name, n in sizes.items():
        with np.load(os.path.join(StorageConfig().data_dir, name)) as full:
            rows = np.sort(rng.choice(np.flatnonzero(full["solved"]), n, replace=False))
            arrays = {k: full[k][rows] for k in full.files}
        np.savez(os.path.join(str(directory), name), **arrays)
    return str(directory)



def test_k_head_to_head_equals_the_jax_match(tmp_path, capsys):
    """One float32 net from Flax weights, K=2 against K=4, 8 simulations,
    1-ply starts in both colours: the same result as the JAX ``play_match``;
    from the command line a run's checkpoint plays in bf16."""
    jnet, var, _ = flax_net(5)
    jeval = jmake_net_evaluator(jnet, var["params"], var["batch_stats"])
    want = jplay_match(JMatchPlayer("K2", jeval, JMCTSConfig(simulations=8, parallel_sims=2)),
                       JMatchPlayer("K4", jeval, JMCTSConfig(simulations=8, parallel_sims=4)),
                       plies=1, switch=True, display=False)
    got = k_head_to_head.k_head_to_head(make_net_evaluator(port_state(var).net), 2, 4, 8, plies=1, device="cpu")
    assert got == {"ka": 2, "kb": 4, **want}
    assert got["wins"] + got["draws"] + got["losses"] == 14

    with pytest.raises(ValueError, match="not a multiple of K=16"):
        k_head_to_head.k_head_to_head(make_net_evaluator(port_state(var).net), 8, 16, 24, device="cpu")

    save_port_generations(tmp_path / "run", [5], dict(TINY_NET, filters=16))  # the packed tower's least width
    capsys.readouterr()
    r = k_head_to_head.main(["--checkpoint-dir", str(tmp_path / "run"), "--ka", "2", "--kb", "4",
                             "--simulations", "8", "--plies", "1", "--device", "cpu"])
    lines = capsys.readouterr().out.rstrip("\n").split("\n")
    assert lines[0].startswith("The results for K2 vs K4 are:") and len(lines) == 2
    last = json.loads(lines[-1])
    assert last["net"] == "gen1" and {k: last[k] for k in r} == r
    assert r["wins"] + r["draws"] + r["losses"] == 14


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    run = tmp_path_factory.mktemp("run")
    save_port_generations(run, [11, 12])
    return str(run)


def test_finalize_fullset_runs_reevaluate_and_verify_supervised(tmp_path, tiny_run):
    """On a fully solved cut of both sets: the rows of ``reevaluate_run``
    and the losses of ``verify_supervised`` (10 epochs) as each tool gives
    them alone; the tables land under ``--out``. The packaged sets are
    complete at the script's counts."""
    sizes = {"connect4dataset_8ply.npz": 300, "connect4dataset_7ply.npz": 200}
    data = solved_cut(tmp_path / "sets", sizes)
    cfg = _port_config_file(tmp_path / "cfg.py", tiny_run, data)
    supervised = dict(batch_size=64, net_config=NetConfig(**TINY_NET))
    out = str(tmp_path / "out")
    got = finalize_fullset.finalize(cfg, out, device="cpu", expected=sizes, supervised=supervised)
    assert got["solved"] == sizes
    alone = reevaluate_run.reevaluate(tiny_run, data, str(tmp_path / "alone"), device="cpu")
    for table in ("8ply", "7ply"):
        assert got["reevaluate_run"][table] == alone[table]
        assert load_table(out, table) == load_table(str(tmp_path / "alone"), table)
    sup = verify_supervised.verify_supervised(data, epochs=10, device="cpu", **supervised)
    assert len(got["verify_supervised"]["epochs"]) == 10
    assert [e["losses"] for e in got["verify_supervised"]["epochs"]] == [e["losses"] for e in sup["epochs"]]
    assert finalize_fullset.check_solved(StorageConfig().data_dir) == finalize_fullset.SOLVED


def test_finalize_fullset_refuses_an_unsolved_row_before_writing(tmp_path, tiny_run):
    sizes = {"connect4dataset_8ply.npz": 50, "connect4dataset_7ply.npz": 40}
    data = solved_cut(tmp_path / "sets", sizes)
    with np.load(os.path.join(data, "connect4dataset_7ply.npz")) as d:
        arrays = {k: d[k] for k in d.files}
    arrays["solved"][7] = False
    np.savez(os.path.join(data, "connect4dataset_7ply.npz"), **arrays)
    cfg = _port_config_file(tmp_path / "cfg.py", tiny_run, data)
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="connect4dataset_7ply.npz: 39/40 solved"):
        finalize_fullset.finalize(cfg, str(out), device="cpu", expected=sizes)
    assert not out.exists()


def test_measure_compile_times_a_fresh_child_process(tmp_path, monkeypatch):
    """``--device cpu`` with a tiny bf16 net (F=16, the packed tower's
    least width), 4 slots, 16 simulations: every
    phase present, the card's phases not run, the numbers from a child
    process that had not loaded torch, and the generation's 16 games each
    replaying legally on the host board."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    games = str(tmp_path / "games")
    r = measure_compile.measure(slots=4, sims=16, parallel_sims=4, sims_per_call=8, device="cpu", filters=16,
                                n_fc_layers=1, n_residuals=1, games_dir=games)
    assert r["parent_pid"] == os.getpid() != r["child_pid"]
    assert r["torch_loaded_at_start"] is False and r["device"] == "cpu"
    for key in ("interpreter_start_s", "import_torch_s", "import_port_s", "net_s"):
        assert r[key] > 0, key
    for key in ("cuda_context_s", "nvcc_build_s", "library_load_s", "ptxas"):
        assert r[key] is None, key
    assert "asked for the CPU" in r["not_run"]
    assert set(r["programs"]) == {"root_init", "segment", "finish"}
    assert all(t["first_s"] > 0 and t["warm_s"] > 0 for t in r["programs"].values())
    g = r["generation"]
    assert g["games"] == g["finished"] == 16 and g["first_s"] > 0 and g["second_s"] > 0
    assert r["launches"] == 0 and r["launches_by_boards"] == {}  # the plain tower: no kernel on the CPU

    with np.load(os.path.join(games, "1", "games.npz")) as d:
        moves, length, result = d["moves"], d["length"], d["result"]
    assert len(result) == 16 and int(length.sum()) == g["moves"]
    for i in range(16):
        board = HostBoard()
        for t in range(int(length[i])):
            assert int(moves[i, t]) in board.valid_moves
            board.make_move(int(moves[i, t]))
        assert board.result is not None and board.result.code == int(result[i])
