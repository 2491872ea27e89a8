"""The port's data parallelism (``connect4_tpu_torch.parallel``) with two
gloo ranks on the CPU, each a spawned process, against one process and
against the JAX package's mesh (8 virtual CPU devices, tests/conftest.py):

- the gathered refill and lockstep self-play of the two ranks equal the
  single-process ``n_blocks=2`` (refill) and whole-batch (lockstep) runs
  field for field, bit for bit, with noise off (the ranks' one-block pools
  narrow as they drain; the single-process two-block pool does not); with
  noise on, every game finishes and the two ranks' openings differ;
- the data-parallel train step (plain, weighted, uint8 NCHW, a batch whose
  halves have different statistics, and a tail that does not divide over
  the ranks) is within 1e-5 of the port's single-process step and of the
  JAX package's ``make_sharded_train_step`` on losses and state, all from
  ``train_state_from_flax`` of the same weights, and the replicas are
  bitwise equal;
- a tiny ``TrainingLoop`` generation with ``mesh_shape=(2,)``, a resumed
  one, the gen > 10 gating match branch on rank 0, and a third generation
  through the CLI's torchrun path;
- a mesh with no process group, and a batch that does not divide, raise.

The two ranks run every case in one spawn (a process takes seconds to
start) while this process computes the references; each test reads its
part of both. JAX is imported inside the functions that use it, so that
the spawned ranks, which import this module, do not load it."""

import functools
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from connect4_tpu_torch.config import (
    AlphaZeroConfig,
    MCTSConfig,
    ModelConfig,
    NetConfig,
    StorageConfig,
)
from connect4_tpu_torch.env.host_board import HostBoard
from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched
from connect4_tpu_torch.models.convert import train_state_from_flax
from connect4_tpu_torch.parallel import mesh as tmesh
from connect4_tpu_torch.training.learner import make_train_step
from connect4_tpu_torch.training.loop import TrainingLoop
from connect4_tpu_torch.training.self_play import make_refill_play_fn, make_stepwise_play_fn

torch.set_num_threads(1)

WORLD = 2
NET = (('filters', 8), ('n_fc_layers', 2), ('n_residuals', 2))
# noise off: the refill pool narrows (128 slots a rank) and refills (384 games)
REFILL = dict(config=dict(simulations=4, parallel_sims=4), slots=256, games=384)
LOCKSTEP = dict(config=dict(simulations=8), batch=8, sims_per_call=4)
NOISY = dict(config=dict(simulations=8, parallel_sims=4, root_dirichlet_alpha=0.3,
                         root_exploration_fraction=0.25, num_sampling_moves=4), slots=8, games=16)
LOOP = dict(
    model_config=dict(net_config=dict(filters=4, n_fc_layers=1, n_residuals=1), batch_size=64,
                      n_training_epochs=1),
    simulations=4, sims_per_call=2, n_training_games=16, selfplay_batch=8, num_sampling_moves=2,
    n_eval=1, gating_plies=1, mesh_shape=(WORLD,),
)


def _loop_config(save_dir):
    mc = dict(LOOP["model_config"])
    mc["net_config"] = NetConfig(**mc["net_config"])
    kw = {k: v for k, v in LOOP.items() if k != "model_config"}
    return AlphaZeroConfig(
        model_config=ModelConfig(**mc),
        storage_config=StorageConfig(save_dir=save_dir, data_dir=os.path.join(save_dir, "nodata")),
        **kw,
    )


def _np_output(out):
    return {name: x.numpy().copy() for name, x in zip(out._fields, out)}


def _state_arrays(state):
    arrays = {k: v.numpy().copy() for k, v in state.net.state_dict().items()}
    for i, p in enumerate(state.net.parameters()):
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            arrays[f"momentum.{i}"] = buf.numpy().copy()
    return arrays


def _rank_main(rank, init_file, out_dir, step_cases):
    """One rank: every case, its results saved to ``rank<r>.pt``."""
    torch.set_num_threads(1)
    from connect4_tpu_torch.parallel.sharded import make_sharded_play_fn, make_sharded_train_step

    tmesh.initialize_distributed("gloo", "cpu", init_method=f"file://{init_file}", rank=rank,
                                 world_size=WORLD)
    mesh = tmesh.make_mesh((WORLD,), "cpu")
    res = {"mesh": (mesh.rank, mesh.world_size, str(mesh.device), mesh.backend)}

    play = make_refill_play_fn(centre_evaluator_batched, MCTSConfig(**REFILL["config"]),
                               REFILL["slots"], REFILL["games"], mesh=mesh)
    widths = []
    res["refill"] = _np_output(play(torch.Generator().manual_seed(0), progress=lambda w, n: widths.append(n)))
    res["refill_live"] = widths
    play = make_stepwise_play_fn(centre_evaluator_batched, MCTSConfig(**LOCKSTEP["config"]),
                                 LOCKSTEP["batch"], LOCKSTEP["sims_per_call"], mesh=mesh)
    res["lockstep"] = _np_output(play(torch.Generator().manual_seed(0)))
    play = make_refill_play_fn(centre_evaluator_batched, MCTSConfig(**NOISY["config"]),
                               NOISY["slots"], NOISY["games"], mesh=mesh)
    res["noisy"] = _np_output(play(mesh.fork_generator(torch.Generator().manual_seed(11))))
    res["uneven"] = []
    for make in (
        lambda: make_sharded_play_fn(centre_evaluator_batched, MCTSConfig(simulations=2), 3, mesh),
        lambda: make_refill_play_fn(centre_evaluator_batched, MCTSConfig(simulations=2), 6, 12,
                                    n_blocks=3, mesh=mesh),
        lambda: tmesh.shard_batch(torch.zeros(5), mesh),
    ):
        try:
            make()
            res["uneven"].append(False)
        except ValueError:
            res["uneven"].append(True)

    res["steps"] = {}
    for name, (model_kw, leaves, batches, weighted) in step_cases.items():
        state = train_state_from_flax(ModelConfig(net_config=NetConfig(**model_kw)), *leaves, device="cpu")
        step = make_sharded_train_step(state.net, state.optimizer, mesh, weighted=weighted)
        metrics = [{k: float(v) for k, v in step(*(torch.from_numpy(a) for a in b)).items()}
                   for b in batches]
        res["steps"][name] = (metrics, _state_arrays(state))

    save_dir = os.path.join(out_dir, "run")
    config = _loop_config(save_dir)
    loop = TrainingLoop(config, device="cpu")
    loop.run(generations=1)
    res["loop"] = [(loop.gen, _state_arrays(loop.state))]
    resumed = TrainingLoop(config, device="cpu")
    res["resumed_at"] = resumed.gen
    resumed.run(generations=1)
    res["loop"].append((resumed.gen, _state_arrays(resumed.state)))
    if rank == 0:
        resumed.gen = 12  # the checkpoint of generation 2 is the opponent
        resumed._match()
        res["match"] = resumed.match_results[-1]
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))

    # generation 3 through the CLI as torchrun launches it (WORLD_SIZE set):
    # it finds the group already joined, and leaves it destroyed
    from connect4_tpu_torch import cli

    config_file = os.path.join(out_dir, f"config_rank{rank}.py")
    with open(config_file, "w") as fh:
        fh.write(f"from {_rank_main.__module__} import _loop_config\nconfig = _loop_config({save_dir!r})\n")
    os.environ["WORLD_SIZE"] = str(WORLD)
    cli.main(["training", "-c", config_file, "--generations", "1", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


@functools.lru_cache(maxsize=None)
def _jax_init(net_kw):
    from connect4_tpu.config import NetConfig as JNetConfig
    from connect4_tpu.models import init_net as jinit_net

    import jax

    return jinit_net(JNetConfig(**dict(net_kw)), jax.random.key(0))  # jitted: seconds


def _jax_case(seed):
    """A mid-training JAX state (random statistics and momentum) and its
    leaves for ``train_state_from_flax``."""
    import jax
    import jax.numpy as jnp

    from connect4_tpu.config import ModelConfig as JModelConfig
    from connect4_tpu.config import NetConfig as JNetConfig
    from connect4_tpu.training import learner as jlearner

    cfg = JModelConfig(net_config=JNetConfig(**dict(NET)))
    net, var = _jax_init(NET)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.uniform(0.1, 0.5, x.shape).astype(np.float32), var["batch_stats"])
    opt = jlearner.make_optimizer(cfg)
    opt_state = jlearner.set_learning_rate(opt.init(var["params"]), 0.01)
    trace = jax.tree_util.tree_map(
        lambda x: 0.01 * rng.standard_normal(x.shape).astype(np.float32), var["params"])
    inner = opt_state[1].inner_state
    inner = (inner[0]._replace(trace=jax.tree_util.tree_map(jnp.asarray, trace)),) + tuple(inner[1:])
    opt_state = (opt_state[0], opt_state[1]._replace(inner_state=inner))
    leaves = (jax.tree_util.tree_map(np.asarray, var["params"]), stats, trace, 0.01)
    jstate = jlearner.TrainState(var["params"], jax.tree_util.tree_map(jnp.asarray, stats), opt_state)
    return leaves, (net, opt, jstate)


def _jax_sharded_steps(net, opt, jstate, batches, weighted, devices=8):
    """Metrics and final state (as the port's arrays) of the JAX package's
    data-parallel step over the first ``devices`` of its 8 virtual CPU
    devices."""
    import jax
    import jax.numpy as jnp

    from connect4_tpu.parallel.mesh import make_mesh, replicate
    from connect4_tpu.parallel.sharded import make_sharded_train_step

    mesh = make_mesh((devices,))
    step = make_sharded_train_step(net, opt, mesh, weighted=weighted)
    jstate = replicate(jstate, mesh)
    metrics = []
    for batch in batches:
        jstate, m = step(jstate, *(jnp.asarray(a) for a in batch))
        metrics.append({k: float(v) for k, v in m.items()})
    state = train_state_from_flax(
        ModelConfig(net_config=NetConfig(**dict(NET))),
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats),
        jax.tree_util.tree_map(np.asarray, jstate.opt_state[1].inner_state[0].trace), 0.01, device="cpu",
    )
    return metrics, _state_arrays(state)


def _single_process_step(leaves, batches, weighted):
    state = train_state_from_flax(ModelConfig(net_config=NetConfig(**dict(NET))), *leaves, device="cpu")
    step = make_train_step(state.net, state.optimizer, weighted=weighted)
    metrics = [{k: float(v) for k, v in step(*(torch.from_numpy(a) for a in b)).items()} for b in batches]
    return metrics, _state_arrays(state)


def _batch(n, seed, uint8=False, dense_half=False):
    rng = np.random.default_rng(seed)
    p = np.where(np.arange(n) < n // 2, 0.1, 0.6)[:, None, None, None] if dense_half else 0.3
    planes = (rng.random((n, 3, 6, 7)) < p).astype(np.uint8)
    values = rng.choice([0.0, 0.5, 1.0], n).astype(np.float32)
    if dense_half:
        values[n // 2:] = 1.0
    priors = rng.dirichlet(np.ones(7), n).astype(np.float32)
    weights = np.where(values == 0.5, 4.0, 1.0).astype(np.float32)
    if not uint8:
        planes = np.moveaxis(planes, 1, -1).astype(np.float32)
    return planes, values, priors, weights


CASES = {
    "plain": dict(seed=1, weighted=False, batches=lambda: [_batch(64, 10)[:3], _batch(64, 11)[:3]]),
    "weighted": dict(seed=2, weighted=True, batches=lambda: [_batch(64, 12), _batch(64, 13)]),
    "uint8_nchw": dict(seed=3, weighted=False,
                       batches=lambda: [_batch(64, 14, uint8=True)[:3], _batch(64, 15, uint8=True)[:3]]),
    "halves": dict(seed=4, weighted=False,
                   batches=lambda: [_batch(64, 16, dense_half=True)[:3], _batch(64, 17, dense_half=True)[:3]]),
    # 33 rows divide neither over two ranks (replicated, then rank 0's
    # replica) nor over the JAX mesh's 8 devices
    "tail": dict(seed=5, weighted=False, batches=lambda: [_batch(33, 18)[:3]]),
}


def _join(ranks, seconds):
    """Wait for every rank; ``join`` raises when one failed (after ending
    the others) and returns True once all have exited."""
    deadline = time.monotonic() + seconds
    while not ranks.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ranks.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish within {seconds} s")


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    out_dir = str(tmp_path_factory.mktemp("dp"))
    cases, jax_states = {}, {}
    for name, c in CASES.items():
        leaves, jax_states[name] = _jax_case(c["seed"])
        cases[name] = (dict(NET), leaves, c["batches"](), c["weighted"])
    ranks = tmp.spawn(_rank_main, args=(os.path.join(out_dir, "init"), out_dir, cases), nprocs=WORLD,
                      join=False, start_method="spawn")
    try:
        refill = make_refill_play_fn(centre_evaluator_batched, MCTSConfig(**REFILL["config"]),
                                     REFILL["slots"], REFILL["games"], n_blocks=WORLD, device="cpu")
        lockstep = make_stepwise_play_fn(centre_evaluator_batched, MCTSConfig(**LOCKSTEP["config"]),
                                         LOCKSTEP["batch"], LOCKSTEP["sims_per_call"], device="cpu")
        want = {
            "refill": _np_output(refill(torch.Generator().manual_seed(0))),
            "lockstep": _np_output(lockstep(torch.Generator().manual_seed(0))),
            "single": {name: _single_process_step(*case[1:]) for name, case in cases.items()},
            "jax": {name: _jax_sharded_steps(*jax_states[name], case[2], case[3])
                    for name, case in cases.items() if len(case[2][0][1]) % 8 == 0},
        }
    finally:
        _join(ranks, 600)
    got = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return dict(ranks=got, want=want, out_dir=out_dir)


def _equal_outputs(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_mesh_of_each_rank(dp):
    assert [r["mesh"] for r in dp["ranks"]] == [(0, 2, "cpu", "gloo"), (1, 2, "cpu", "gloo")]


def test_gathered_refill_equals_the_two_block_pool(dp):
    want = dp["want"]["refill"]
    for r in dp["ranks"]:
        _equal_outputs(r["refill"], want)
    assert (want["result"] != 0).all()
    # each rank's 128-slot pool narrowed to 64 rows as it drained
    assert min(dp["ranks"][0]["refill_live"]) < 64


def test_gathered_lockstep_equals_one_process(dp):
    for r in dp["ranks"]:
        _equal_outputs(r["lockstep"], dp["want"]["lockstep"])


def test_noisy_refill_finishes_with_different_openings_per_rank(dp):
    out = dp["ranks"][0]["noisy"]
    _equal_outputs(out, dp["ranks"][1]["noisy"])  # every rank holds the whole output
    assert (out["result"] != 0).all()
    for g in range(NOISY["games"]):
        board = HostBoard()
        for t in range(int(out["length"][g])):
            np.testing.assert_array_equal(out["planes"][g, t], board.to_planes().astype(np.uint8))
            board.make_move(int(out["moves"][g, t]))
        assert board.result.code == int(out["result"][g])
    half = NOISY["games"] // 2
    assert not np.array_equal(out["moves"][:half, :4], out["moves"][half:, :4])


def test_uneven_batches_raise(dp):
    for r in dp["ranks"]:
        assert r["uneven"] == [True, True, True]


def _assert_close(got, want):
    (gm, gs), (wm, ws) = got, want
    for a, b in zip(gm, wm):
        for k in ("loss", "value_loss", "prior_loss"):
            assert abs(a[k] - b[k]) <= 1e-5, (k, a, b)
    assert gs.keys() == ws.keys()
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_one_process_and_jax(dp, name):
    (m0, s0), (m1, s1) = (r["steps"][name] for r in dp["ranks"])
    assert m0 == m1
    for k in s0:
        np.testing.assert_array_equal(s0[k], s1[k], err_msg=f"replicas differ at {k}")
    _assert_close((m0, s0), dp["want"]["single"][name])
    if name != "tail":
        _assert_close((m0, s0), dp["want"]["jax"][name])


def test_training_loop_on_two_ranks_resumes_and_gates(dp):
    r0, r1 = dp["ranks"]
    assert r0["resumed_at"] == r1["resumed_at"] == 2
    for (g0, s0), (g1, s1) in zip(r0["loop"], r1["loop"]):
        assert g0 == g1
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)
    assert [g for g, _ in r0["loop"]] == [2, 3]
    run = os.path.join(dp["out_dir"], "run")
    for gen in (1, 2, 3):  # 3 through the CLI
        with np.load(os.path.join(run, str(gen), "games.npz")) as games:
            assert games["result"].shape == (16,) and (games["result"] != 0).all()
        assert os.path.exists(os.path.join(run, str(gen), "ckpt", "state.pt"))
    match = r0["match"]
    assert match["wins"] + match["draws"] + match["losses"] == 14


def test_a_mesh_without_a_process_group_raises(tmp_path):
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        tmesh.make_mesh((2,), "cpu")
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        TrainingLoop(_loop_config(str(tmp_path / "run")), device="cpu")
    with pytest.raises(ValueError, match="name one of"):
        tmesh.initialize_distributed("mpi", "cpu")
