"""The port's data parallelism at four ranks from two torchrun agents on the
CPU: two nodes of two gloo ranks each, joined through torchrun's
rendezvous (``env://``), held against one process and against the JAX
package's (4,)-device mesh (4 of the 8 virtual CPU devices,
tests/conftest.py):

- the four ranks report global ranks 0-3, local ranks 0, 1, 0, 1, world 4,
  the CPU and gloo, and a mesh of another size than the group raises;
- the gathered refill (centre evaluator, noise off) equals one process's
  pool of the same ``n_blocks`` bit for bit, at 4 blocks (one a rank, which
  narrows as it drains) and at 8 (two a rank), and the JAX package's pool
  of those blocks on its (4,) mesh (integer fields bit for bit, the float
  policies and values within 1e-5, as tests/test_torch_self_play.py holds
  one process to the JAX package);
- lockstep self-play of 8 games, two a rank, equals the whole-batch run;
- with noise on every game finishes and replays legally, and the four
  ranks' openings differ pairwise;
- the data-parallel train step (plain, weighted, uint8 NCHW, a batch whose
  halves have different statistics) is within 1e-5 of the port's
  single-process step and of the JAX package's ``make_sharded_train_step``
  over its (4,) mesh, the replicas are bitwise equal, and a batch of 66
  rows (which divides by 2 but not by 4) runs whole and leaves every rank
  on rank 0's replica;
- ``cli training`` with ``mesh_shape=(4,)``: one generation on the group
  the cases joined, then a second launch of the two agents in which the
  CLI joins from torchrun's environment itself and resumes. Only rank 0
  writes the generation, the checkpoint and the tables; every rank resumes
  at the same generation and ends on the same replica; the gating match
  runs on rank 0 alone.

The ranks are this file run as a script (``__main__``) by two
``python -m torch.distributed.run --nnodes 2 --nproc_per_node 2
--rdzv_backend static --node_rank {0,1}`` agents; they run every case in
one launch while this process computes the references. A launch that
outlasts ``TIMEOUT`` seconds is killed with its ranks, and the test fails.
JAX is imported inside the functions that use it, so that the ranks do not
load it."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from connect4_tpu_torch.config import MCTSConfig, ModelConfig, NetConfig
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.models.convert import train_state_from_flax
from connect4_tpu_torch.parallel import mesh as tmesh
from connect4_tpu_torch.training.self_play import make_refill_play_fn, make_stepwise_play_fn
from test_torch_parallel import (
    NET,
    _assert_close,
    _batch,
    _equal_outputs,
    _jax_case,
    _jax_sharded_steps,
    _np_output,
    _single_process_step,
    _state_arrays,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, PER_NODE = 2, 2
WORLD = NODES * PER_NODE
TIMEOUT = 300  # seconds for both launches together
# noise off: 128 slots a rank, narrowing to 64 as its one block drains
REFILL = dict(config=dict(simulations=4, parallel_sims=4), slots=512, games=768)
LOCKSTEP = dict(config=dict(simulations=8), batch=8)
NOISY = dict(config=dict(simulations=8, parallel_sims=4, root_dirichlet_alpha=0.3,
                         root_exploration_fraction=0.25, num_sampling_moves=4), slots=8, games=16)
CASES = {
    "plain": dict(seed=1, weighted=False, batches=lambda: [_batch(64, 10)[:3], _batch(64, 11)[:3]]),
    "weighted": dict(seed=2, weighted=True, batches=lambda: [_batch(64, 12), _batch(64, 13)]),
    "uint8_nchw": dict(seed=3, weighted=False,
                       batches=lambda: [_batch(64, 14, uint8=True)[:3], _batch(64, 15, uint8=True)[:3]]),
    # ranks 0-1 hold sparse boards and draws, ranks 2-3 dense boards and wins
    "halves": dict(seed=4, weighted=False,
                   batches=lambda: [_batch(64, 16, dense_half=True)[:3], _batch(64, 17, dense_half=True)[:3]]),
    # 66 rows divide over two ranks but not over four, nor over the JAX mesh
    "tail66": dict(seed=5, weighted=False, batches=lambda: [_batch(66, 18)[:3]]),
}
# the CLI's run: tiny net, 16 games in 8 slots (2 a rank), a 14-game gating
# match against the centre heuristic every generation, cut benchmark sets
CONFIG = """from connect4_tpu_torch.config import AlphaZeroConfig, ModelConfig, NetConfig, StorageConfig

config = AlphaZeroConfig(
    model_config=ModelConfig(net_config=NetConfig(filters=4, n_fc_layers=1, n_residuals=1),
                             batch_size=64, n_training_epochs=1),
    storage_config=StorageConfig(save_dir={save_dir!r}, data_dir={data_dir!r}),
    simulations=4, sims_per_call=2, n_training_games=16, selfplay_batch=8, num_sampling_moves=2,
    n_eval=1, gating_plies=1, mesh_shape=({world},),
)
"""
EVAL_ROWS = 64


# --- the ranks ----------------------------------------------------------------

def _record_writes(out_dir, tag):
    """Stand in front of every write, of the gating match and of ``run``
    of the training loop (the generation it starts at, and the replica it
    ends with); ``dump`` saves what this rank did to
    ``<out_dir>/<tag>_rank<r>.json``."""
    from connect4_tpu_torch.training import checkpoint, loop, replay

    rec = {"writes": [], "matches": [], "started_at": []}

    def wrap(owner, name, record):
        inner = getattr(owner, name)

        def wrapped(*args, **kwargs):
            record(*args)
            return inner(*args, **kwargs)

        setattr(owner, name, wrapped)

    wrap(replay, "append_generation", lambda save_dir, gen, *_: rec["writes"].append(f"{gen}/games"))
    wrap(checkpoint, "save_checkpoint", lambda save_dir, gen, *_: rec["writes"].append(f"{gen}/ckpt"))
    wrap(loop, "save_table", lambda save_dir, name, *_: rec["writes"].append(f"table {name}"))
    wrap(loop.TrainingLoop, "_match", lambda self: rec["matches"].append(self.gen))
    run = loop.TrainingLoop.run

    def recorded_run(self, *args, **kwargs):
        rec["started_at"].append(self.gen)
        run(self, *args, **kwargs)
        rec["replica"] = {k: v.tolist() for k, v in _state_arrays(self.state).items()}

    loop.TrainingLoop.run = recorded_run

    def dump():
        rank = int(os.environ["RANK"])
        with open(os.path.join(out_dir, f"{tag}_rank{rank}.json"), "w") as fh:
            json.dump(rec, fh)

    return dump


def _cases_main(out_dir):
    """One rank of the first launch: every case, saved to ``rank<r>.pt``,
    then one CLI generation on the group already joined (the CLI leaves it
    destroyed)."""
    from connect4_tpu_torch import cli
    from connect4_tpu_torch.parallel.sharded import make_sharded_play_fn, make_sharded_train_step

    tmesh.initialize_distributed("gloo", "cpu")  # torchrun's env://
    mesh = tmesh.make_mesh((WORLD,), "cpu")
    res = {"mesh": (mesh.rank, mesh.local_rank, mesh.world_size, str(mesh.device), mesh.backend,
                    int(os.environ["GROUP_RANK"]))}
    res["wrong_shapes"] = []
    for shape in ((2,), (8,)):
        try:
            tmesh.make_mesh(shape, "cpu")
            res["wrong_shapes"].append(False)
        except ValueError:
            res["wrong_shapes"].append(True)

    res["refill"] = {}
    for n_blocks in (4, 8):
        play = make_refill_play_fn(centre_evaluator_batched, MCTSConfig(**REFILL["config"]),
                                   REFILL["slots"], REFILL["games"], n_blocks=n_blocks, mesh=mesh)
        widths = []
        out = play(torch.Generator().manual_seed(0), progress=lambda w, n: widths.append(n))
        res["refill"][n_blocks] = (_np_output(out), widths)
    play = make_sharded_play_fn(centre_evaluator_batched, MCTSConfig(**LOCKSTEP["config"]),
                                LOCKSTEP["batch"], mesh)
    res["lockstep"] = _np_output(play(torch.Generator().manual_seed(0)))
    play = make_refill_play_fn(centre_evaluator_batched, MCTSConfig(**NOISY["config"]),
                               NOISY["slots"], NOISY["games"], mesh=mesh)
    res["noisy"] = _np_output(play(mesh.fork_generator(torch.Generator().manual_seed(11))))

    res["steps"] = {}
    for name, (leaves, batches, weighted) in torch.load(os.path.join(out_dir, "cases.pt"),
                                                         weights_only=False).items():
        state = train_state_from_flax(ModelConfig(net_config=NetConfig(**dict(NET))), *leaves, device="cpu")
        step = make_sharded_train_step(state.net, state.optimizer, mesh, weighted=weighted)
        metrics = [{k: float(v) for k, v in step(*(torch.from_numpy(a) for a in b)).items()}
                   for b in batches]
        res["steps"][name] = (metrics, _state_arrays(state))
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))

    dump = _record_writes(out_dir, "cli1")
    cli.main(["training", "-c", os.path.join(out_dir, "config.py"), "--generations", "1",
              "--device", "cpu"])
    dump()
    if torch.distributed.is_initialized():
        raise RuntimeError("the CLI left the process group joined")


def _cli_main(out_dir):
    """One rank of the second launch: the CLI as torchrun launches it,
    joining the group from the environment, resuming the run."""
    from connect4_tpu_torch import cli

    dump = _record_writes(out_dir, "cli2")
    cli.main(["training", "-c", os.path.join(out_dir, "config.py"), "--generations", "1",
              "--device", "cpu"])
    dump()


# --- this process ---------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out_dir, mode):
    """Start the two agents (a session each, so that a kill takes their
    ranks with them), each logging to ``<out_dir>/<mode>_node<n>.log``."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = str(_free_port())
    agents = []
    for node in range(NODES):
        log = open(os.path.join(out_dir, f"{mode}_node{node}.log"), "w")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", str(NODES),
               "--nproc_per_node", str(PER_NODE), "--rdzv_backend", "static", "--node_rank", str(node),
               "--master_addr", "127.0.0.1", "--master_port", port, os.path.abspath(__file__), mode, out_dir]
        with log:
            agents.append(subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
                                           start_new_session=True))
    return agents


def _kill(agents):
    for a in agents:
        if a.poll() is None:
            os.killpg(a.pid, signal.SIGKILL)
            a.wait()


def _wait(agents, out_dir, mode, deadline):
    """Wait for both agents until ``deadline``; fail (killing both) when one
    fails or they outlast it."""
    while any(a.poll() is None for a in agents) and not any(a.returncode for a in agents):
        if time.monotonic() > deadline:
            _kill(agents)
            pytest.fail(f"the {mode} launch did not finish within {TIMEOUT} s")
        time.sleep(0.2)
    _kill(agents)  # the other agent of one that failed
    if any(a.returncode for a in agents):
        logs = []
        for node in range(NODES):
            with open(os.path.join(out_dir, f"{mode}_node{node}.log")) as fh:
                logs.append(fh.read()[-6000:])
        pytest.fail(f"the {mode} launch failed: exit codes {[a.returncode for a in agents]}\n"
                    + "\n".join(logs))


def _jax_pool(n_blocks):
    """The JAX package's refill pool of ``n_blocks`` blocks on its (4,) mesh."""
    import jax

    from connect4_tpu.config import MCTSConfig as JMCTSConfig
    from connect4_tpu.eval.evaluators import centre_evaluator_batched as jcentre
    from connect4_tpu.parallel.mesh import make_mesh
    from connect4_tpu.training.self_play import make_refill_play_fn as jmake_refill_play_fn

    play = jmake_refill_play_fn(jcentre, JMCTSConfig(**REFILL["config"]), REFILL["slots"], REFILL["games"],
                                n_blocks=n_blocks, mesh=make_mesh((WORLD,)))
    out = play(jax.random.key(0))
    return {name: np.asarray(x) for name, x in zip(out._fields, out)}


def _write_inputs(out_dir, cases):
    torch.save(cases, os.path.join(out_dir, "cases.pt"))
    data_dir = os.path.join(out_dir, "data")
    os.makedirs(data_dir)
    for name in ("connect4dataset_7ply.npz", "connect4dataset_8ply.npz"):
        with np.load(os.path.join(REPO, "connect4_tpu_torch", "data", name)) as d:
            np.savez(os.path.join(data_dir, name), **{k: d[k][:EVAL_ROWS] for k in d.files})
    with open(os.path.join(out_dir, "config.py"), "w") as fh:
        fh.write(CONFIG.format(save_dir=os.path.join(out_dir, "run"), data_dir=data_dir, world=WORLD))


@pytest.fixture(scope="module")
def multinode(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("multinode"))
    cases, jax_states = {}, {}
    for name, c in CASES.items():
        leaves, jax_states[name] = _jax_case(c["seed"])
        cases[name] = (leaves, c["batches"](), c["weighted"])
    _write_inputs(out_dir, cases)
    deadline = time.monotonic() + TIMEOUT
    agents = _launch(out_dir, "cases")
    try:
        want = {"refill": {}, "jax_refill": {}}
        for n_blocks in (4, 8):
            play = make_refill_play_fn(centre_evaluator_batched, MCTSConfig(**REFILL["config"]),
                                       REFILL["slots"], REFILL["games"], n_blocks=n_blocks, device="cpu")
            want["refill"][n_blocks] = _np_output(play(torch.Generator().manual_seed(0)))
            want["jax_refill"][n_blocks] = _jax_pool(n_blocks)
        play = make_stepwise_play_fn(centre_evaluator_batched, MCTSConfig(**LOCKSTEP["config"]),
                                     LOCKSTEP["batch"], device="cpu")
        want["lockstep"] = _np_output(play(torch.Generator().manual_seed(0)))
        want["single"] = {name: _single_process_step(*case) for name, case in cases.items()}
        want["jax"] = {name: _jax_sharded_steps(*jax_states[name], case[1], case[2], devices=WORLD)
                       for name, case in cases.items() if len(case[1][0][1]) % WORLD == 0}
        _wait(agents, out_dir, "cases", deadline)
        agents = _launch(out_dir, "cli")
        _wait(agents, out_dir, "cli", deadline)
    finally:
        _kill(agents)
    ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    cli = {}
    for tag in ("cli1", "cli2"):
        cli[tag] = []
        for r in range(WORLD):
            with open(os.path.join(out_dir, f"{tag}_rank{r}.json")) as fh:
                cli[tag].append(json.load(fh))
    return dict(ranks=ranks, want=want, cli=cli, out_dir=out_dir)


def test_four_ranks_from_two_agents(multinode):
    assert [r["mesh"] for r in multinode["ranks"]] == [
        (0, 0, 4, "cpu", "gloo", 0), (1, 1, 4, "cpu", "gloo", 0),
        (2, 0, 4, "cpu", "gloo", 1), (3, 1, 4, "cpu", "gloo", 1),
    ]
    for r in multinode["ranks"]:  # a mesh is never quietly another size than the group
        assert r["wrong_shapes"] == [True, True]


@pytest.mark.parametrize("n_blocks", [4, 8])
def test_gathered_refill_equals_one_process_and_jax(multinode, n_blocks):
    want = multinode["want"]["refill"][n_blocks]
    assert (want["result"] != 0).all()
    for r in multinode["ranks"]:
        _equal_outputs(r["refill"][n_blocks][0], want)
    jax_pool = multinode["want"]["jax_refill"][n_blocks]
    assert jax_pool.keys() == want.keys()
    for name in want:
        assert jax_pool[name].dtype == want[name].dtype, name
        if want[name].dtype == np.float32:
            np.testing.assert_allclose(want[name], jax_pool[name], rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(want[name], jax_pool[name], err_msg=name)
    if n_blocks == WORLD:
        # each rank's one-block pool of 128 slots narrowed to 64 rows as it drained
        assert min(multinode["ranks"][0]["refill"][n_blocks][1]) < 64


def test_gathered_lockstep_equals_the_whole_batch(multinode):
    for r in multinode["ranks"]:
        _equal_outputs(r["lockstep"], multinode["want"]["lockstep"])


def test_noisy_refill_finishes_with_four_different_openings(multinode):
    out = multinode["ranks"][0]["noisy"]
    for r in multinode["ranks"][1:]:  # every rank holds the whole output
        _equal_outputs(out, r["noisy"])
    assert (out["result"] != 0).all()
    for g in range(NOISY["games"]):
        board = HostBoard()
        for t in range(int(out["length"][g])):
            np.testing.assert_array_equal(out["planes"][g, t], board.to_planes().astype(np.uint8))
            move = int(out["moves"][g, t])
            assert move in board.valid_moves
            board.make_move(move)
        assert board.result.code == int(out["result"][g])
    per = NOISY["games"] // WORLD
    openings = [out["moves"][r * per:(r + 1) * per, :4] for r in range(WORLD)]
    for a in range(WORLD):
        for b in range(a + 1, WORLD):
            assert not np.array_equal(openings[a], openings[b]), (a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_one_process_and_jax(multinode, name):
    got = [r["steps"][name] for r in multinode["ranks"]]
    m0, s0 = got[0]
    for m, s in got[1:]:
        assert m == m0
        for k in s0:
            np.testing.assert_array_equal(s[k], s0[k], err_msg=f"replicas differ at {k}")
    _assert_close((m0, s0), multinode["want"]["single"][name])
    if name == "tail66":
        assert name not in multinode["want"]["jax"]
    else:
        _assert_close((m0, s0), multinode["want"]["jax"][name])


def test_cli_generation_and_resume_under_two_agents(multinode):
    cli = multinode["cli"]
    tables = ["table 8ply", "table 7ply", "table match_results"]
    for tag, gen in (("cli1", 1), ("cli2", 2)):
        ranks = cli[tag]
        assert [r["started_at"] for r in ranks] == [[gen]] * WORLD, tag
        assert ranks[0]["writes"] == [f"{gen}/games", f"{gen}/ckpt"] + tables, tag
        assert ranks[0]["matches"] == [gen], tag
        for r in ranks[1:]:
            assert r["writes"] == [] and r["matches"] == [], tag
            assert r["replica"] == ranks[0]["replica"], tag
    run = os.path.join(multinode["out_dir"], "run")
    for gen in (1, 2):
        with np.load(os.path.join(run, str(gen), "games.npz")) as games:
            assert games["result"].shape == (16,) and (games["result"] != 0).all()
        assert os.path.exists(os.path.join(run, str(gen), "ckpt", "state.pt"))
    with open(os.path.join(run, "match_results.json")) as fh:
        matches = json.load(fh)
    assert len(matches) == 2
    assert all(m["wins"] + m["draws"] + m["losses"] == 14 for m in matches)


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"cases": _cases_main, "cli": _cli_main}[sys.argv[1]](sys.argv[2])
