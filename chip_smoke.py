"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit; imports nothing of JAX or of the JAX package. Phases, each
fatal on failure:

1. build every CUDA kernel of the main path from the sources in the
   checkout (``nvcc``, printed with its ptxas report);
2. hold each kernel against its plain PyTorch version on the card, on
   legal board positions at every batch shape the driven paths launch it
   at (``COMPARE_BOARDS``: a pool of S slots evaluates S roots and S x K=8
   leaves, and halves S down to 64 while it drains, so 4096 ... 64 for the
   512-slot and 256-slot pools; the 49 boards of a match, 49 roots and 392
   leaves; B=261, as the JAX package's tests take it; B=1), with the
   packaged gen-161 net (F=64, fc 6, res 6, bf16). A block takes 3 boards,
   so the last block holds 1, 2 or 3 boards over these shapes. The script
   records the batch of every launch the paths make and fails if one was
   not among the shapes compared.
   The tolerances are held against the plain version that emulates the
   tensor core's accumulate (and reproduces the kernel bit for bit); the
   errors against the plain version rounded to nearest, an independent
   reference, are printed beside them and held to limits of their own. The tile and block count of each shape
   are printed; at B=4096 and B=261 the kernel's other chain lengths are
   printed beside the shipped one, each against both plain versions summed
   in the same order;
3. time each kernel, its plain version and the cuDNN tower (a yardstick
   only: the port never calls it) at B=4096, 2048, 512, 392 and 64, beside
   the bound of each (the ``kernels`` line reports the batch that most
   launches of the training generations have, B=2048, their leaf batch);
4. check the search and self-play on the card against the same code on
   the CPU with the deterministic centre evaluator;
5. drive the self-play path: a generation through
   ``make_net_evaluator`` + ``make_refill_play_fn`` with gen-161, 512 slots,
   K=8, 64 simulations, 512 games, noise and sampling on. Every game must
   finish and replay legally on the host board; the kernel launch counts
   are read from this run alone;
6. check the learner on the card against the CPU: three SGD steps of the
   full-width net (F=64, fc 6, res 6) on 512 legal positions with made-up
   targets from the same weights, in float32 (IEEE float32 on the card, as
   ``utils.full_float32`` sets it) and in bf16, each with its stated limit;
7. time a train step (forward, backward, update) at batch 4096 in bf16 and
   float32;
8. drive the training path at full width: a ``TrainingLoop`` in a temporary
   directory with a freshly initialised F=64 / fc 6 / res 6 bf16 net, 512
   training games in 256 slots (the refill path), K=8, 64 simulations (cut
   from 800 for the time limit), 5 epochs at batch 4096, the packaged 7-ply
   and 8-ply sets and the 98-game gating match against the centre
   heuristic; then a new ``TrainingLoop`` on the same directory resumes at
   generation 2 and runs it. Losses must be finite, parameters and running
   statistics must change, generation 2's replay window and checkpoint must
   exist, the resumed state must equal the saved one bit for bit, and the
   tower kernel must have been launched by the self-play and by the match
   of each generation while its plain version was never entered;
9. play gen-161 against the centre heuristic (64 simulations, 2-ply starts,
   both colours): a return under 0.5 is a fault;
10. [dp] data parallelism with two ranks sharing the card through gloo
    (spawned processes on ``cuda:0``; a rank that fails fails the run):
    sharded refill self-play of 256 games in 256 slots with gen-161 (K=8,
    64 simulations, noise on), whose games must finish, replay legally and
    open differently on the two ranks; three data-parallel train steps at
    full width and batch 4096 (2048 a rank), float32 and bf16, held against
    the single-process step with the limits of phase 6 (and the momentum
    buffers with ``TOL_DP_MOMENTUM``, which a planted fault must exceed),
    the replicas equal bit for bit after each, timed beside the
    single-process step with the share of the all-reduces; one ``TrainingLoop`` generation with
    ``mesh_shape=(2,)`` at the depth of phase 8 (no match), then a resumed
    one. Each rank's launches by batch go through the [shapes] check, and
    neither rank may enter the plain tower;
11. a one-rank NCCL group takes one data-parallel step, bit for bit the
    single-process step;
12. [host] ``HostMCTS`` and ``GridSearch`` choose the tactic table's moves,
    and the batched search on the card agrees with ``HostMCTS``; the exact
    solver builds with g++ and agrees with exhaustive minimax on 300
    late-game positions of seeded random playouts;
13. [supervisor] the supervisor runs ``cli training --device cuda
    --generations 1`` on a tiny config; the child exits 0 with a checkpoint;
14. print the ``kernels`` JSON line, the card's name and power limit, and
    last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when CUDA is unavailable or the
package is not beside this script. A copy of every number goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# stated tolerances, kernel vs plain version (same rounding points and the
# same order of summation; with the tensor core's accumulate emulated the
# plain version has so far equalled the kernel bit for bit)
TOL_VALUE_PRIOR = 2e-2  # max |diff| of value and of prior
TOL_TOWER_MEAN = 2e-3  # mean |diff| of the bf16 tower output
# The plain version rounded to nearest owes nothing to a model of the tensor
# core. It differs from the kernel inside a chain's float32 sum, which flips
# an occasional bf16 rounding that then propagates through the following
# layers. Against it the tower's mean and the prior keep the tolerances
# above; the value head, which amplifies single bf16 flips of the tower
# (its maximum over a batch moves between 0.012 and 0.027 with the draw of
# positions, whatever the chain), is held to the 5e-2 that the port's net is
# held to against the JAX package's (tests/test_torch_net.py).
TOL_VALUE_NEAREST = 5e-2

SMOKE = dict(slots=512, games=512, simulations=64, parallel_sims=8, seed=0)

# Batch shapes (boards) the kernel is held against its plain version at:
# every shape the driven paths launch it at, and two more. A pool of S slots
# evaluates S roots and S x 8 leaves and halves S down to 64 as it drains:
# 4096 ... 64 covers the 512-slot self-play of phase 5 and the 256-slot
# self-play of the generations. A match plays 49 boards: 49 roots, 392
# leaves. 261 is the shape of the JAX package's tests, 1 a single board.
COMPARE_BOARDS = (4096, 2048, 1024, 512, 392, 261, 256, 128, 64, 49, 1)
# The shapes timed. The kernels line reports the one that most launches of
# the path it counts have: the leaf batch of the generations' self-play, 2048.
TIME_BOARDS = (4096, 2048, 512, 392, 64)

# the training generation of phase 8 (depth cut from 800 simulations and
# 1200 games; widths and batch size are the bench workload's)
GENERATION = dict(
    net=dict(filters=64, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16"),
    games=512, slots=256, simulations=64, parallel_sims=8, batch_size=4096, epochs=5,
)

# Stated limits of the learner on the card against the CPU after three steps
# at batch 512 (phase 6). float32: IEEE float32 on both, summed in different
# orders. bf16: both round every conv output to bf16, cuDNN and the CPU sum
# in different orders, so single roundings flip and spread.
TOL_TRAIN_F32 = dict(loss=1e-4, state=1e-4)
TOL_TRAIN_BF16 = dict(loss=5e-2, state=5e-3)
# The [dp] steps' momentum buffers against one process's after three steps
# at batch 4096: the largest sound readings on the H100 were 1.19e-4 in
# float32 and 1.70e-3 in bf16, each in value_head.conv.weight; the limit
# sits above them and below what a planted fault (the gradients averaged
# over the ranks, not summed) gives, which the [dp] phase reads every run.
TOL_DP_MOMENTUM = dict(float32=5e-4, bfloat16=5e-3)


def log(*args):
    print(*args, flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


class LaunchShapes:
    """Counts the tower kernel's launches by batch (boards) while a path is
    driven, by standing in front of ``tower._tower_cuda``. ``check`` fails
    when a path launched a shape that was not compared with the plain
    version."""

    def __init__(self, tower):
        self.by_boards = {}
        launch = tower._tower_cuda

        def counted(packed, x2d, chain=None):
            boards = x2d.shape[0] // 42
            self.by_boards[boards] = self.by_boards.get(boards, 0) + 1
            return launch(packed, x2d, chain)

        tower._tower_cuda = counted

    def take(self, path: str):
        """The launches by batch since the last call, checked."""
        seen, self.by_boards = self.by_boards, {}
        return check_shapes(path, seen)


def check_shapes(path: str, seen: dict) -> dict:
    """Print a path's tower launches by batch; fail on a batch that was
    not held against the plain version."""
    seen = dict(sorted(seen.items(), reverse=True))
    log(f"[shapes] {path}: tower kernel launches by batch {seen}")
    missing = sorted(set(seen) - set(COMPARE_BOARDS))
    if missing:
        fail(f"{path} launched the tower kernel at B={missing}, "
             f"which was not held against the plain version")
    return seen


def random_positions(n: int, generator, device):
    """``n`` legal positions reached by uniformly random play of 0..35
    plies (finished games stay as they ended)."""
    import torch

    from connect4_tpu_torch.env.core import initial_state, legal_moves, step

    state = initial_state((n,), device=device)
    plies = torch.randint(0, 36, (n,), generator=generator, device=device)
    for t in range(36):
        legal = legal_moves(state)
        weights = torch.where(legal.any(-1, keepdim=True), legal.float(), 1.0)
        move = torch.multinomial(weights, 1, generator=generator)[:, 0]
        state = step(state, move, t < plies)
    return state


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cudnn_tower(folded, config):
    """The folded tower as cuDNN bf16 convolutions (channels_last), the
    yardstick for ``library_ms``. Not used by the port."""
    import torch
    import torch.nn.functional as F

    from connect4_tpu_torch.models.net import lrelu

    w = {k: v.to(torch.bfloat16) for k, v in folded.items()}

    def run(nhwc):
        x = nhwc.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        x = lrelu(F.conv2d(x, w["conv0.weight"], w["conv0.bias"], padding=1))
        for i in range(config.n_residuals):
            y = lrelu(F.conv2d(x, w[f"res.{2 * i}.weight"], w[f"res.{2 * i}.bias"], padding=1))
            y = F.conv2d(y, w[f"res.{2 * i + 1}.weight"], w[f"res.{2 * i + 1}.bias"], padding=1)
            x = lrelu(y + x)
        return x

    return run


def tower_bound(config, boards: int):
    """(bound_ms, bound_by, flops, bytes) of the tower on ``boards`` boards:
    every MAC of the 13 convs on 42 rows per board, and each input, weight
    and output byte moved once."""
    f, c, n = config.filters, config.channels, config.n_residuals
    flops = boards * 42 * 2 * (9 * c * f + 2 * n * 9 * f * f)
    weight_bytes = 2 * (9 * c * f + f + 2 * n * (9 * f * f + f))
    nbytes = boards * 42 * c * 4 + weight_bytes + boards * 42 * f * 2
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def replay_games(out) -> int:
    """Replay every recorded game on the host board: legal moves, the
    recorded pre-move planes, the recorded result. Returns the move count."""
    import numpy as np

    from connect4_tpu_torch.env.host_board import HostBoard

    moves, planes = out.moves.cpu().numpy(), out.planes.cpu().numpy()
    length, result = out.length.cpu().numpy(), out.result.cpu().numpy()
    mask = out.mask.cpu().numpy()
    total = 0
    for g in range(moves.shape[0]):
        if not np.array_equal(mask[g], np.arange(42) < length[g]):
            fail(f"game {g}: ply mask is not a prefix")
        board = HostBoard()
        for t in range(int(length[g])):
            if not np.array_equal(planes[g, t], board.to_planes().astype(np.uint8)):
                fail(f"game {g} ply {t}: recorded planes differ from the replay")
            mv = int(moves[g, t])
            if mv not in board.valid_moves:
                fail(f"game {g} ply {t}: illegal move {mv}")
            board.make_move(mv)
        if board.result is None or board.result.code != int(result[g]):
            fail(f"game {g}: replay ends {board.result}, recorded result {int(result[g])}")
        total += int(length[g])
    return total


def check_train_step(dev, generator):
    """Phase 6: three SGD steps on the card against the same steps on the
    CPU, float32 and bf16, from the same weights and batches."""
    import copy

    import torch

    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.learner import init_train_state, make_optimizer, make_train_step

    n = 512
    batches = []
    for _ in range(3):
        planes = to_planes(random_positions(n, generator, dev), dtype=torch.uint8)
        values = torch.randint(0, 3, (n,), generator=generator, device=dev).float() / 2
        priors = torch.softmax(2 * torch.randn((n, 7), generator=generator, device=dev), -1)
        batches.append((planes, values, priors))
    out = {}
    for dtype, tol in (("float32", TOL_TRAIN_F32), ("bfloat16", TOL_TRAIN_BF16)):
        config = ModelConfig(net_config=NetConfig(
            filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        on_cpu = init_train_state(config, torch.Generator().manual_seed(7), "cpu")
        net = copy.deepcopy(on_cpu.net).to(dev)
        on_card = type(on_cpu)(net, make_optimizer(config, net))
        losses = {}
        for name, state, where in (("cpu", on_cpu, "cpu"), ("card", on_card, dev)):
            step = make_train_step(state.net, state.optimizer)
            losses[name] = [
                float(step(*(t.to(where) for t in batch))["loss"]) for batch in batches]
        d_loss = max(abs(a - b) for a, b in zip(losses["cpu"], losses["card"]))
        sd_cpu, sd_card = on_cpu.net.state_dict(), on_card.net.state_dict()
        d_state, worst = max(
            ((sd_cpu[k] - sd_card[k].cpu()).abs().max().item(), k)
            for k in sd_cpu if not k.endswith("num_batches_tracked"))
        finite = all(bool(torch.isfinite(v).all()) for v in sd_card.values())
        out[dtype] = {"losses_cpu": losses["cpu"], "losses_card": losses["card"],
                      "loss_max_diff": d_loss, "state_max_diff": d_state, "state_max_at": worst,
                      "tolerance": tol}
        log(f"[check] train step {dtype}, 3 steps at batch {n}, card vs CPU: losses "
            f"{['%.6f' % x for x in losses['card']]} vs {['%.6f' % x for x in losses['cpu']]}, "
            f"|loss| max {d_loss:.3g} (limit {tol['loss']}), |parameter or statistic| max "
            f"{d_state:.3g} at {worst} (limit {tol['state']})")
        if not finite or not d_loss <= tol["loss"] or not d_state <= tol["state"]:
            fail(f"the {dtype} train step on the card differs from the CPU: {out[dtype]}")
    return out


def time_train_step(dev, generator):
    """Phase 7: ms per train step (forward, backward, update) at batch 4096
    by CUDA events, on stored uint8 NCHW planes as the loop feeds them."""
    import torch

    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step

    n = 4096
    planes = to_planes(random_positions(n, generator, dev), dtype=torch.uint8)
    values = torch.randint(0, 3, (n,), generator=generator, device=dev).float() / 2
    priors = torch.softmax(2 * torch.randn((n, 7), generator=generator, device=dev), -1)
    out = {}
    for dtype in ("bfloat16", "float32"):
        config = ModelConfig(net_config=NetConfig(
            filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        state = init_train_state(config, torch.Generator().manual_seed(0), dev)
        step = make_train_step(state.net, state.optimizer)
        ms = timed_ms(lambda: step(planes, values, priors), iters=20, warmup=5)
        ms_again = timed_ms(lambda: step(planes, values, priors), iters=20, warmup=0)
        out[dtype] = {"batch": n, "ms": ms, "ms_again": ms_again, "positions_per_s": n / ms * 1e3}
        log(f"[train] {dtype} step at batch {n}: {ms:.3f} ms (again {ms_again:.3f}), "
            f"{n / ms * 1e3:,.0f} positions/s")
    return out


def drive_generations(dev, shapes):
    """Phase 8: two generations of ``TrainingLoop`` at full width, the
    second in a new loop that resumes from the first one's checkpoint."""
    import numpy as np
    import torch

    from connect4_tpu_torch.config import AlphaZeroConfig, ModelConfig, NetConfig, StorageConfig
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training import replay
    from connect4_tpu_torch.training.loop import TrainingLoop
    from connect4_tpu_torch.training.tables import load_table

    G = GENERATION
    plain_calls = []
    tower_plain = tower.tower_plain

    def watched_plain(*args, **kwargs):
        plain_calls.append(1)
        return tower_plain(*args, **kwargs)

    def counting(method, counts, name):
        def run(*args, **kwargs):
            before = tower.run_tower.launches
            result = method(*args, **kwargs)
            counts[name] = tower.run_tower.launches - before
            return result
        return run

    generations = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_run_") as save_dir:
        config = AlphaZeroConfig(
            model_config=ModelConfig(
                net_config=NetConfig(**G["net"]),
                batch_size=G["batch_size"], n_training_epochs=G["epochs"],
            ),
            storage_config=StorageConfig(save_dir=save_dir),
            simulations=G["simulations"], parallel_sims=G["parallel_sims"],
            n_training_games=G["games"], selfplay_batch=G["slots"], n_eval=1, seed=0,
        )
        tower.tower_plain = watched_plain
        try:
            previous = None
            for gen in (1, 2):
                loop = TrainingLoop(config, device=dev)  # generation 2: a new loop, resumed
                if loop.gen != gen:
                    fail(f"[generation] the loop starts at generation {loop.gen}, expected {gen}")
                before = {k: v.clone() for k, v in loop.state.net.state_dict().items()}
                if previous is not None:
                    for k, v in previous.items():
                        if not torch.equal(v, before[k]):
                            fail(f"[generation] resumed {k} differs from the saved one")
                counts = {"selfplay": 0, "match": 0}
                loop._generate_games = counting(loop._generate_games, counts, "selfplay")
                loop._match = counting(loop._match, counts, "match")
                tower.run_tower.launches = 0
                t0 = time.perf_counter()
                loop.run(generations=1)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                previous = {k: v.clone() for k, v in loop.state.net.state_dict().items()}
                changed = [k for k in before if not torch.equal(before[k], previous[k])]
                unchanged = [k for k in before if k not in changed and not k.endswith("num_batches_tracked")]
                losses = loop.train_losses
                if not losses or not all(np.isfinite(losses)):
                    fail(f"[generation {gen}] training losses not finite: {losses}")
                if unchanged:
                    fail(f"[generation {gen}] training left these unchanged: {unchanged}")
                if not all(bool(torch.isfinite(v).all()) for v in previous.values()):
                    fail(f"[generation {gen}] a parameter or statistic is not finite")
                if counts["selfplay"] == 0 or counts["match"] == 0:
                    fail(f"[generation {gen}] tower kernel launches {counts}: a phase never launched it")
                if plain_calls:
                    fail(f"[generation {gen}] the plain tower was entered {len(plain_calls)} times on the card")
                planes, values, _ = replay.load_window(save_dir, gen)
                if ckpt.latest_generation(save_dir) != gen or not os.path.exists(
                        os.path.join(save_dir, str(gen), "ckpt", ckpt.FILE_NAME)):
                    fail(f"[generation {gen}] no checkpoint")
                match = load_table(save_dir, "match_results")[-1]
                rows8, rows7 = load_table(save_dir, "8ply"), load_table(save_dir, "7ply")
                if len(rows8) != gen or len(rows7) != gen:
                    fail(f"[generation {gen}] benchmark tables hold {len(rows8)} and {len(rows7)} rows")
                with np.load(os.path.join(save_dir, str(gen), "games.npz")) as games:
                    moves = int(games["mask"].sum())
                    if not (games["result"] != 0).all() or games["result"].shape[0] != G["games"]:
                        fail(f"[generation {gen}] not every game finished")
                phases = dict(loop.timer.seconds)
                info = {
                    "generation": gen, "seconds": seconds, "phases": phases, "moves": moves,
                    "moves_per_s": moves / phases["generate"], "positions": int(len(values)),
                    "train_steps": len(losses), "first_loss": losses[0], "last_loss": losses[-1],
                    "match": match, "launches": dict(counts),
                    "launches_by_boards": shapes.take(f"generation {gen}"),
                    "8ply": {k: rows8[-1][k] for k in ("Average loss", "Accuracy")},
                    "7ply": {k: rows7[-1][k] for k in ("Average loss", "Accuracy", "prior Accuracy")},
                }
                generations.append(info)
                log(f"[generation] {gen}{' (resumed in a new loop)' if gen == 2 else ''}: {seconds:.2f} s = "
                    + ", ".join(f"{k} {v:.2f}" for k, v in phases.items())
                    + f"; {moves} moves, {info['moves_per_s']:.1f} moves/s; {len(values)} positions, "
                    f"{len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}; match vs centre "
                    f"{match['wins']}-{match['draws']}-{match['losses']} (return {match['return']:.3f}); "
                    f"tower kernel launches: self-play {counts['selfplay']}, match {counts['match']}; "
                    f"plain tower entered {len(plain_calls)} times")
        finally:
            tower.tower_plain = tower_plain
    return {"config": G, "generations": generations}


def gen161_match(net, dev, shapes):
    """Phase 9: the packaged net against the centre heuristic."""
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.eval.match import MatchPlayer, play_match
    from connect4_tpu_torch.models import tower

    cfg = MCTSConfig(simulations=64, parallel_sims=8)
    before = tower.run_tower.launches
    t0 = time.perf_counter()
    result = play_match(
        MatchPlayer("gen161", make_net_evaluator(net), cfg),
        MatchPlayer("centre", centre_evaluator_batched, cfg),
        plies=2, switch=True, seed=0, display=False, device=dev,
    )
    result = {**result, "seconds": time.perf_counter() - t0,
              "launches": tower.run_tower.launches - before,
              "launches_by_boards": shapes.take("match")}
    log(f"[match] gen161 vs centre, 64 simulations, 98 games: {result['wins']} wins, {result['draws']} draws, "
        f"{result['losses']} losses, return {result['return']:.3f} in {result['seconds']:.1f} s, "
        f"tower kernel launches {result['launches']}")
    if result["return"] < 0.5 or result["launches"] == 0:
        fail(f"gen-161 does not beat the centre heuristic through the kernel: {result}")
    return result


# ---------------------------------------------------------------------------
# [dp]: data parallelism, two ranks sharing the one card through gloo

DP = dict(
    world=2, device="cuda:0", backend="gloo",
    selfplay=dict(slots=256, games=256, simulations=64, parallel_sims=8, seed=0),
    batch=4096, steps=3, time_steps=5, seed=3,
)


def state_tensors(state) -> dict:
    """Every parameter, running statistic and momentum buffer of a
    ``TrainState`` by name."""
    out = {k: t.detach() for k, t in state.net.state_dict().items()}
    for name, p in state.net.named_parameters():
        buf = state.optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            out[f"momentum {name}"] = buf
    return out


def state_vector(state):
    """``state_tensors`` as one float64 vector (float32 and int64 convert
    exactly), to compare replicas bit for bit."""
    import torch

    return torch.cat([t.reshape(-1).double() for t in state_tensors(state).values()])


def state_max_diff(a, b, momentum: bool = False):
    """(largest |difference|, the entry it is in) between two states: of the
    net's parameters and running statistics, as the [check] train step
    compares them, or with ``momentum`` of the optimisers' momentum buffers."""
    ta, tb = state_tensors(a), state_tensors(b)
    keys = [k for k in ta if k.startswith("momentum ") == momentum and not k.endswith("num_batches_tracked")]
    return max(((ta[k].double() - tb[k].double()).abs().max().item(), k) for k in keys)


def train_batches(n, count, generator, dev):
    """``count`` training batches of ``n`` legal positions with made-up
    targets, in the stored uint8 NCHW form."""
    import torch

    from connect4_tpu_torch.env.core import to_planes

    out = []
    for _ in range(count):
        planes = to_planes(random_positions(n, generator, dev), dtype=torch.uint8)
        values = torch.randint(0, 3, (n,), generator=generator, device=dev).float() / 2
        priors = torch.softmax(2 * torch.randn((n, 7), generator=generator, device=dev), -1)
        out.append((planes, values, priors))
    return out


def dp_rank(rank, init_file, out_dir):
    """One rank of the [dp] phase, in a spawned process on ``DP['device']``:
    sharded refill self-play, data-parallel train steps against the
    single-process step (rank 0 runs that), and two ``TrainingLoop``
    generations with ``mesh_shape=(2,)``, the second resumed. Its numbers go
    to ``<out_dir>/rank<r>.pt``; an exception fails the rank, and the spawn
    fails the parent."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from connect4_tpu_torch.config import AlphaZeroConfig, MCTSConfig, ModelConfig, NetConfig, StorageConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.parallel import mesh as pmesh
    from connect4_tpu_torch.parallel.sharded import make_sharded_train_step
    from connect4_tpu_torch.training import learner
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step
    from connect4_tpu_torch.training.loop import TrainingLoop
    from connect4_tpu_torch.training.self_play import make_refill_play_fn
    from connect4_tpu_torch.utils import make_generator, resolve_device

    dev = resolve_device(DP["device"])
    pmesh.initialize_distributed(DP["backend"], dev, init_method=f"file://{init_file}", rank=rank,
                                 world_size=DP["world"])
    mesh = pmesh.make_mesh((DP["world"],), dev)
    out = {"mesh": [mesh.rank, mesh.world_size, str(mesh.device), mesh.backend]}
    shapes = LaunchShapes(tower)
    plain_calls = []
    tower_plain = tower.tower_plain

    def watched_plain(*args, **kwargs):
        plain_calls.append(1)
        return tower_plain(*args, **kwargs)

    tower.tower_plain = watched_plain

    def replicas_equal(state):
        both = pmesh.all_gather_rows(state_vector(state)[None], mesh)
        return all(bool(torch.equal(both[0], both[r])) for r in range(1, DP["world"]))

    # --- sharded refill self-play ------------------------------------------
    sp = DP["selfplay"]
    cfg = MCTSConfig(simulations=sp["simulations"], parallel_sims=sp["parallel_sims"],
                     root_dirichlet_alpha=0.3, root_exploration_fraction=0.25, num_sampling_moves=6)
    play = make_refill_play_fn(make_net_evaluator(load_example_net(device=dev)), cfg, sp["slots"],
                               sp["games"], mesh=mesh)
    generator = mesh.fork_generator(make_generator(sp["seed"], dev))
    mesh.barrier()
    torch.cuda.synchronize()
    tower.run_tower.launches = 0
    t0 = time.perf_counter()
    games = play(generator)
    torch.cuda.synchronize()
    out["selfplay"] = {"seconds": time.perf_counter() - t0, "launches": tower.run_tower.launches,
                       "by_boards": shapes.by_boards}
    shapes.by_boards = {}
    if rank == 0:
        torch.save(type(games)(*(x.cpu() for x in games)), os.path.join(out_dir, "games.pt"))

    # --- data-parallel train steps against the single-process step -----------
    sound_all_reduce_grads = learner._all_reduce_grads

    def averaged_grads(net, mesh):  # the planted fault: averaged, not summed
        sound_all_reduce_grads(net, mesh)
        for p in net.parameters():
            p.grad.div_(mesh.world_size)

    t_train = time.perf_counter()
    batches = train_batches(DP["batch"], DP["steps"], make_generator(DP["seed"], dev), dev)
    out["train"] = {}
    for dtype in ("float32", "bfloat16"):
        config = ModelConfig(net_config=NetConfig(filters=64, n_fc_layers=6, n_residuals=6, compute_dtype=dtype))
        state = init_train_state(config, torch.Generator().manual_seed(7), dev)
        dp_step = make_sharded_train_step(state.net, state.optimizer, mesh)
        one = init_train_state(config, torch.Generator().manual_seed(7), dev)
        one_step = make_train_step(one.net, one.optimizer)
        faulty = init_train_state(config, torch.Generator().manual_seed(7), dev)
        faulty_step = make_train_step(faulty.net, faulty.optimizer, mesh=mesh)
        rec = {"loss_dp": [], "loss_one": [], "loss_max_diff": 0.0, "state_max_diff": (0.0, ""),
               "momentum_max_diff": (0.0, ""), "fault_momentum_max_diff": (0.0, ""), "replicas_equal": []}
        for batch in batches:
            rec["loss_dp"].append(float(dp_step(*batch)["loss"]))
            rec["replicas_equal"].append(replicas_equal(state))
            learner._all_reduce_grads = averaged_grads
            try:
                faulty_step(*batch)
            finally:
                learner._all_reduce_grads = sound_all_reduce_grads
            if rank == 0:
                rec["loss_one"].append(float(one_step(*batch)["loss"]))
                rec["loss_max_diff"] = max(rec["loss_max_diff"], abs(rec["loss_dp"][-1] - rec["loss_one"][-1]))
                rec["state_max_diff"] = max(rec["state_max_diff"], state_max_diff(state, one))
                rec["momentum_max_diff"] = max(rec["momentum_max_diff"], state_max_diff(state, one, True))
                rec["fault_momentum_max_diff"] = max(rec["fault_momentum_max_diff"],
                                                     state_max_diff(faulty, one, True))
        del faulty, faulty_step
        # time: every rank steps together, each all-reduce timed with the
        # card synchronised before and after it (a gloo all-reduce of a CUDA
        # tensor waits for the card anyway); rank 0 then times the plain
        # step on the whole batch while the other ranks wait
        mesh.barrier()
        spent = [0.0, 0]
        all_reduce = pmesh.Mesh.all_reduce

        def timed(self, tensor):
            torch.cuda.synchronize()
            t = time.perf_counter()
            result = all_reduce(self, tensor)
            torch.cuda.synchronize()
            spent[0] += time.perf_counter() - t
            spent[1] += 1
            return result

        pmesh.Mesh.all_reduce = timed
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP["time_steps"]):
                dp_step(*batches[0])
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            pmesh.Mesh.all_reduce = all_reduce
        rec["dp_ms"] = total / DP["time_steps"] * 1e3
        rec["all_reduce_share"] = spent[0] / total
        rec["all_reduces_per_step"] = spent[1] / DP["time_steps"]
        if rank == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DP["time_steps"]):
                one_step(*batches[0])
            torch.cuda.synchronize()
            rec["one_ms"] = (time.perf_counter() - t0) / DP["time_steps"] * 1e3
        mesh.barrier()
        out["train"][dtype] = rec
    out["train_seconds"] = time.perf_counter() - t_train

    # --- the training generation on the mesh, then resumed -------------------
    G = GENERATION
    config = AlphaZeroConfig(
        model_config=ModelConfig(net_config=NetConfig(**G["net"]), batch_size=G["batch_size"],
                                 n_training_epochs=G["epochs"]),
        storage_config=StorageConfig(save_dir=os.path.join(out_dir, "run")),
        simulations=G["simulations"], parallel_sims=G["parallel_sims"], n_training_games=G["games"],
        selfplay_batch=G["slots"], n_eval=0, seed=0, mesh_shape=(DP["world"],),
    )
    out["generations"] = []
    for gen in (1, 2):
        loop = TrainingLoop(config, device=dev)  # generation 2: a new loop, resumed
        start = loop.gen
        tower.run_tower.launches = 0
        t0 = time.perf_counter()
        loop.run(generations=1)
        torch.cuda.synchronize()
        out["generations"].append({
            "generation": gen, "started_at": start, "seconds": time.perf_counter() - t0,
            "phases": dict(loop.timer.seconds), "launches": tower.run_tower.launches,
            "by_boards": shapes.by_boards, "steps": len(loop.train_losses),
            "first_loss": loop.train_losses[0], "last_loss": loop.train_losses[-1],
            "replicas_equal": replicas_equal(loop.state),
        })
        shapes.by_boards = {}
    out["plain_calls"] = len(plain_calls)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def join_ranks(ranks, seconds: float) -> None:
    """Wait for spawned ranks; ``join`` raises when one failed (after ending
    the others). Fails when they outlast ``seconds``."""
    deadline = time.monotonic() + seconds
    while not ranks.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ranks.processes:
                p.kill()
            fail(f"the ranks did not finish within {seconds} s")


def drive_dp(dev):
    """Phase 10, [dp]: two ranks on the one card (gloo, spawned), checked."""
    import numpy as np
    import torch
    import torch.multiprocessing as tmp

    from connect4_tpu_torch.training import checkpoint as ckpt

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out_dir:
        t0 = time.perf_counter()
        ranks = tmp.spawn(dp_rank, args=(os.path.join(out_dir, "init"), out_dir), nprocs=DP["world"],
                          join=False, start_method="spawn")
        join_ranks(ranks, 900)
        seconds = time.perf_counter() - t0
        res = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False) for r in range(DP["world"])]
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_dp.json"), "w") as fh:
            json.dump(res, fh, indent=1, default=str)
        games = torch.load(os.path.join(out_dir, "games.pt"), weights_only=False)
        run = os.path.join(out_dir, "run")
        if ckpt.latest_generation(run) != 2:
            fail(f"[dp] the mesh generations left checkpoint {ckpt.latest_generation(run)}, expected 2")
        for gen in (1, 2):
            with np.load(os.path.join(run, str(gen), "games.npz")) as g:
                if g["result"].shape[0] != GENERATION["games"] or not (g["result"] != 0).all():
                    fail(f"[dp] generation {gen}: not every game finished")
    # print every line first, then fail on what is wrong
    problems = []
    log(f"[dp] {DP['world']} ranks on {DP['device']} ({DP['backend']}): {[r['mesh'] for r in res]}, "
        f"{seconds:.1f} s from spawn to exit (rank 0: self-play {res[0]['selfplay']['seconds']:.1f} s, "
        f"train-step checks {res[0]['train_seconds']:.1f} s, generations "
        f"{sum(g['seconds'] for g in res[0]['generations']):.1f} s)")
    sp = DP["selfplay"]
    moves = replay_games(games)
    if games.result.shape[0] != sp["games"] or not bool((games.result != 0).all()):
        problems.append("sharded self-play: not every game finished")
    half = sp["games"] // DP["world"]
    if torch.equal(games.moves[:half, :6], games.moves[half:, :6]):
        problems.append("both ranks played the same openings")
    launches = {"selfplay": 0, "generation": 0}
    by_boards = {}
    for r, rr in enumerate(res):
        if rr["plain_calls"]:
            problems.append(f"rank {r} entered the plain tower {rr['plain_calls']} times on the card")
        paths = [("selfplay", rr["selfplay"])] + [("generation", g) for g in rr["generations"]]
        for name, p in paths:
            if p["launches"] == 0:
                problems.append(f"rank {r} never launched the tower kernel in {name}")
            launches[name] += p["launches"]
            for b, n in check_shapes(f"dp rank {r} {name}", p["by_boards"]).items():
                by_boards[b] = by_boards.get(b, 0) + n
    log(f"[dp] sharded refill self-play, {sp['games']} games in {sp['slots']} slots (gen-161, K=8, "
        f"{sp['simulations']} sims, noise on): {moves} moves replay on the host board; "
        + ", ".join(f"rank {r} {rr['selfplay']['seconds']:.2f} s, {rr['selfplay']['launches']} tower launches"
                    for r, rr in enumerate(res)))
    for dtype, tol in (("float32", TOL_TRAIN_F32), ("bfloat16", TOL_TRAIN_BF16)):
        tol = {**tol, "momentum": TOL_DP_MOMENTUM[dtype]}
        recs = [rr["train"][dtype] for rr in res]
        r0 = recs[0]
        log(f"[dp] train step {dtype}, {DP['steps']} steps at batch {DP['batch']} "
            f"({DP['batch'] // DP['world']} a rank) vs one process on the card: losses "
            f"{['%.6f' % x for x in r0['loss_dp']]} vs {['%.6f' % x for x in r0['loss_one']]}, |loss| max "
            f"{r0['loss_max_diff']:.3g} (limit {tol['loss']}), |parameter or statistic| max "
            f"{r0['state_max_diff'][0]:.3g} at {r0['state_max_diff'][1]} (limit {tol['state']}), "
            f"|momentum| max {r0['momentum_max_diff'][0]:.3g} at {r0['momentum_max_diff'][1]} (limit "
            f"{tol['momentum']}; planted fault, gradients averaged over the ranks: "
            f"{r0['fault_momentum_max_diff'][0]:.3g} at {r0['fault_momentum_max_diff'][1]}); "
            f"replicas equal after each step {r0['replicas_equal']}")
        log(f"[dp] train step {dtype} time: data parallel {r0['dp_ms']:.2f} ms a step, one process "
            f"{r0['one_ms']:.2f} ms; all-reduces {r0['all_reduces_per_step']:.0f} a step, "
            f"{100 * r0['all_reduce_share']:.1f}% of a step (each timed with a sync around it)")
        if not all(r["replicas_equal"] == [True] * DP["steps"] for r in recs):
            problems.append(f"{dtype}: the replicas differ after a step")
        if (not r0["loss_max_diff"] <= tol["loss"] or not r0["state_max_diff"][0] <= tol["state"]
                or not r0["momentum_max_diff"][0] <= tol["momentum"]):
            problems.append(f"{dtype}: the data-parallel step differs from one process beyond {tol}")
        if not r0["fault_momentum_max_diff"][0] > tol["momentum"]:
            problems.append(f"{dtype}: the momentum check does not catch the planted fault")
    gens = [rr["generations"] for rr in res]
    for i, g in enumerate(gens[0]):
        log(f"[dp] generation {g['generation']}{' (resumed)' if i else ''} on the mesh: "
            f"{g['seconds']:.2f} s = " + ", ".join(f"{k} {v:.2f}" for k, v in g["phases"].items())
            + f"; {g['steps']} steps, loss {g['first_loss']:.4f} -> {g['last_loss']:.4f}; tower launches "
            + ", ".join(f"rank {r} {gr[i]['launches']}" for r, gr in enumerate(gens)))
        if [gr[i]["started_at"] for gr in gens] != [i + 1] * DP["world"]:
            problems.append(f"generation {i + 1}: the ranks started at {[gr[i]['started_at'] for gr in gens]}")
        if not all(gr[i]["replicas_equal"] for gr in gens):
            problems.append(f"generation {i + 1}: the replicas differ")
        if not (np.isfinite(g["first_loss"]) and np.isfinite(g["last_loss"])):
            problems.append(f"generation {i + 1}: losses not finite")
    if problems:
        fail("[dp] " + "; ".join(problems))
    return {"config": DP, "seconds": seconds, "ranks": res, "moves": moves, "launches": launches,
            "launches_by_boards": by_boards}


def nccl_one_rank(dev):
    """Phase 11: a one-rank NCCL group takes one data-parallel step, which
    must equal the single-process step bit for bit (with cuDNN's
    deterministic algorithms, so that two runs of one step agree)."""
    import torch
    import torch.distributed as dist

    from connect4_tpu_torch.config import ModelConfig, NetConfig
    from connect4_tpu_torch.parallel import mesh as pmesh
    from connect4_tpu_torch.parallel.sharded import make_sharded_train_step
    from connect4_tpu_torch.training.learner import init_train_state, make_train_step
    from connect4_tpu_torch.utils import make_generator

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as d:
        pmesh.initialize_distributed("nccl", dev, init_method=f"file://{d}/init", rank=0, world_size=1)
        try:
            mesh = pmesh.make_mesh((1,), dev)
            batch = train_batches(512, 1, make_generator(DP["seed"], dev), dev)[0]
            config = ModelConfig(net_config=NetConfig(filters=64, n_fc_layers=6, n_residuals=6))
            states = [init_train_state(config, torch.Generator().manual_seed(7), dev) for _ in range(3)]
            losses = [float(make_sharded_train_step(states[0].net, states[0].optimizer, mesh)(*batch)["loss"])]
            losses += [float(make_train_step(s.net, s.optimizer)(*batch)["loss"]) for s in states[1:]]
            vecs = [state_vector(s) for s in states]
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = deterministic
    out = {"backend": mesh.backend, "losses": losses,
           "dp_equals_one": losses[0] == losses[1] and bool(torch.equal(vecs[0], vecs[1])),
           "one_equals_one": losses[1] == losses[2] and bool(torch.equal(vecs[1], vecs[2]))}
    log(f"[dp] one-rank {mesh.backend} group, one float32 step at batch 512: data parallel equals the "
        f"single-process step bit for bit: {out['dp_equals_one']} (two single-process steps: "
        f"{out['one_equals_one']}); loss {losses[0]!r}")
    if not out["dp_equals_one"]:
        fail(f"[dp] the one-rank NCCL step differs from the single-process step: {out}")
    return out


# tests/test_mcts.py's tactic table: (moves, plies, acceptable best moves)
TACTICS = [
    ([1, 1, 2, 2, 3, 3], 1, {0, 4}),
    ([6, 0, 6, 1, 5, 2], 2, {3}),
    ([5, 0, 5, 1, 5, 2], 1, {5}),
    ([], 1, {3}),
    ([0, 6, 1, 6, 0, 6], 2, {6}),
]


def host_phase(dev):
    """Phase 12, [host]: the reference searches choose the tactic table's
    moves and the batched search on the card agrees with the host MCTS;
    the solver builds with g++ and agrees with exhaustive minimax on
    late-game positions of seeded random playouts."""
    import numpy as np
    import torch

    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.env.convert import stack_boards
    from connect4_tpu_torch.env.host_board import HostBoard
    from connect4_tpu_torch.eval.evaluators import (
        centre_evaluator_batched,
        centre_evaluator_host,
        centre_value_host,
    )
    from connect4_tpu_torch.eval.grid_search import GridSearch, minimax_value
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.mcts.host import HostMCTS
    from connect4_tpu_torch.native import solver
    from connect4_tpu_torch.utils import make_generator

    for moves, plies, best in TACTICS:
        board = HostBoard()
        for m in moves:
            board.make_move(m)
        grid, _ = GridSearch(plies, centre_value_host).choose(board)
        config = MCTSConfig(simulations=7**plies + 1, pb_c_init=9999.0)
        host = HostMCTS(config, centre_evaluator_host)
        root = host.search(board.copy())
        host_move = host._best_child(root, board.player_to_move).move
        res = make_search_fn(centre_evaluator_batched, config)(stack_boards([board], device=dev),
                                                              make_generator(0, dev))
        base = int(res.tree.children_base[0, 0])
        visits = res.tree.visits[0, base:base + 7].cpu().numpy()
        host_visits = np.array([root.children[m].visits if m in root.children else 0 for m in range(7)])
        log(f"[host] {moves}: GridSearch {grid}, HostMCTS {host_move}, batched on the card "
            f"{int(res.move[0])} (expected {sorted(best)}); root visits equal {bool((visits == host_visits).all())}")
        if grid not in best or host_move not in best or int(res.move[0]) != host_move \
                or not (visits == host_visits).all():
            fail(f"[host] the searches disagree on {moves}")

    t0 = time.perf_counter()
    exact = solver.ExactSolver(1 << 22)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    boards = []
    while len(boards) < 300:
        board, target = HostBoard(), int(rng.integers(34, 40))
        while board.result is None and board.age < target:
            board.make_move(int(rng.choice(sorted(board.valid_moves))))
        if board.result is None:
            boards.append(board)

    def no_leaf(board):
        raise AssertionError("an exhaustive search evaluates no leaf")

    t0 = time.perf_counter()
    values = exact.absolute_values(boards)
    solve_s = time.perf_counter() - t0
    # minimax nudges a terminal value by the game's age/10000; the nearest
    # half is the game-theoretic value
    want = np.array([np.round(2 * minimax_value(b, 42 - b.age, no_leaf)) / 2 for b in boards])
    agree = int((values == want).sum())
    log(f"[host] solver (g++, {os.path.basename(build.library_path(solver.SOURCE, build.GXX))}) "
        f"ready in {build_s:.1f} s; {len(boards)} positions at ages 34-39: {agree} agree with exhaustive "
        f"minimax, solved in {solve_s:.3f} s ({exact.nodes:,} nodes)")
    if agree != len(boards):
        fail("[host] the solver disagrees with exhaustive minimax")
    return {"positions": len(boards), "agree": agree, "build_s": build_s, "solve_s": solve_s}


def supervisor_phase():
    """Phase 13, [supervisor]: the watchdog runs one generation of the
    training CLI on the card (a tiny float32 net, 8 games, no match) and the
    child's checkpoint exists."""
    from connect4_tpu_torch.training import checkpoint as ckpt
    from connect4_tpu_torch.training.supervisor import supervise

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sup_") as d:
        config = os.path.join(d, "config.py")
        with open(config, "w") as fh:
            fh.write(
                "from connect4_tpu_torch.config import *\n"
                "config = AlphaZeroConfig(\n"
                "    model_config=ModelConfig(net_config=NetConfig(filters=8, n_fc_layers=1, n_residuals=1),\n"
                "                             batch_size=64, n_training_epochs=1),\n"
                f"    storage_config=StorageConfig(save_dir={os.path.join(d, 'run')!r},\n"
                f"                                 data_dir={os.path.join(d, 'nodata')!r}),\n"
                "    simulations=8, parallel_sims=4, n_training_games=8, selfplay_batch=8, n_eval=0)\n")
        t0, launched = time.perf_counter(), time.time()
        code = supervise(config, os.path.join(d, "train.log"), generations=1, poll_seconds=0.5,
                         stall_seconds=300, settle_seconds=0, max_restarts=1, device="cuda",
                         extra_env={"PYTHONPATH": os.pathsep.join(filter(None, (ROOT, os.environ.get("PYTHONPATH"))))})
        seconds = time.perf_counter() - t0
        with open(os.path.join(d, "train.log")) as fh:
            tail = fh.read()[-2000:]
        saved = os.path.exists(os.path.join(d, "run", "1", "ckpt", ckpt.FILE_NAME))
    phases = [line.strip() for line in tail.splitlines() if line.startswith("generate:")]
    # the loop logs "Time now: <asctime>" as its generation starts: the
    # child's start on the card (interpreter, imports, CUDA) comes before it
    started = [time.mktime(time.strptime(line.split("Time now: ")[1].strip()))
               for line in tail.splitlines() if line.startswith("Time now: ")]
    startup = f"{started[0] - launched:.0f} s" if started else "not read"
    log(f"[supervisor] cli training --device cuda --generations 1 under the supervisor: exit {code}, "
        f"checkpoint {'written' if saved else 'MISSING'}, {seconds:.1f} s (the child's start to its "
        f"generation {startup}, to the second; the generation: {phases[-1] if phases else 'no phase line'})")
    if code != 0 or not saved:
        fail(f"[supervisor] the supervised run failed (exit {code}); its log ends:\n{tail}")
    return {"exit": code, "checkpoint": saved, "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from connect4_tpu_torch import build
    from connect4_tpu_torch.config import MCTSConfig
    from connect4_tpu_torch.eval.evaluators import centre_evaluator_batched, make_net_evaluator
    from connect4_tpu_torch.mcts.batched import make_search_fn
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.models.convert import load_example_net
    from connect4_tpu_torch.models.net import fold_bn_params
    from connect4_tpu_torch.env.core import to_planes
    from connect4_tpu_torch.training.self_play import make_refill_play_fn, training_arrays
    from connect4_tpu_torch.utils import make_generator, resolve_device

    # resolve_device sets what float32 means in the port (utils.full_float32:
    # no TF32), for the float32 references below as for every entry point
    dev = resolve_device("cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail("resolve_device left TF32 on")
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {report['device']}")

    # --- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    tower._library()
    report["build_s"] = time.perf_counter() - t0
    log(f"[build] tower kernel ready in {report['build_s']:.1f} s")
    log(build.BUILD_LOGS.get(tower.SOURCE, "(already built)").strip())

    net = load_example_net(device=dev)
    config = net.config
    folded = fold_bn_params(net)
    packed = tower.pack_weights(config, folded)
    gen = make_generator(SMOKE["seed"], dev)

    # --- 2. kernel vs plain -------------------------------------------------
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {b: tower.tile_plan(b) for b in COMPARE_BOARDS}
    for b, (tb, blocks) in plans.items():
        log(f"[tile] B={b}: {tb} boards a block, {blocks} blocks on {n_sms} SMs (chain={tower.CHAIN})")
    report["tiles"] = plans

    def compare(x2d, chain):
        """Error sets of the kernel at ``chain`` against the plain version
        summed in the same order: ``model`` with the tensor core's
        accumulate emulated, ``nearest`` rounded to nearest."""
        with torch.no_grad():
            tk = tower.run_tower(packed, x2d, chain=chain)
            torch.cuda.synchronize()
            vk, pk = tower.heads(packed, tk)
            sets = {"finite": bool(torch.isfinite(tk.float()).all())}
            for name, tensor_core in (("model", True), ("nearest", False)):
                tp = tower.tower_plain(packed, x2d, chain or tower.CHAIN, tensor_core)
                vp, pp = tower.heads(packed, tp)
                d = (tk.float() - tp.float()).abs()
                sets[name] = {
                    "differ": int((tk != tp).sum()), "tower_max": d.max().item(), "tower_mean": d.mean().item(),
                    "value_max": (vk - vp).abs().max().item(),
                    "prior_max": (pk - pp).abs().max().item(),
                }
        return sets

    def show(sets):
        return "; ".join(
            f"vs {name}: {e['differ']} differ, |tower| max {e['tower_max']:.6g} mean {e['tower_mean']:.3g}"
            f" |value| max {e['value_max']:.6g} |prior| max {e['prior_max']:.6g}"
            for name, e in ((n, sets[n]) for n in ("model", "nearest")))

    errs, chain_errs = {}, {}
    for b in COMPARE_BOARDS:
        nhwc = to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
        x2d = nhwc.reshape(b * 42, config.channels).float().contiguous()
        e = errs[b] = compare(x2d, None)  # the shipped kernel, as the main path calls it
        log(f"[compare] tower B={b}: {show(e)}")
        if not e["finite"]:
            fail(f"kernel output not finite at B={b}")
        m, n = e["model"], e["nearest"]
        if max(m["value_max"], m["prior_max"]) > TOL_VALUE_PRIOR or m["tower_mean"] > TOL_TOWER_MEAN:
            fail(f"kernel disagrees with the plain tower at B={b}: {m} "
                 f"(tolerance value/prior {TOL_VALUE_PRIOR}, tower mean {TOL_TOWER_MEAN})")
        if (n["value_max"] > TOL_VALUE_NEAREST or n["prior_max"] > TOL_VALUE_PRIOR
                or n["tower_mean"] > TOL_TOWER_MEAN):
            fail(f"kernel disagrees with the plain tower rounded to nearest at B={b}: {n} "
                 f"(tolerance value {TOL_VALUE_NEAREST}, prior {TOL_VALUE_PRIOR}, "
                 f"tower mean {TOL_TOWER_MEAN})")
        if b in (4096, 261):
            # the chain lengths that were not shipped, for the record only
            for chain in tower.CHAINS:
                ce = e if chain == tower.CHAIN else compare(x2d, chain)
                chain_errs[f"{chain}@{b}"] = ce
                log(f"[compare] chain={chain}{' (shipped)' if chain == tower.CHAIN else ''} B={b}: {show(ce)}")
    report["compare"] = errs
    report["compare_chains"] = chain_errs

    # --- 3. times -----------------------------------------------------------
    lib_tower = cudnn_tower(folded, config)
    times = {}
    with torch.no_grad():
        for b in TIME_BOARDS:
            x2d = (to_planes(random_positions(b, gen, dev)).permute(0, 2, 3, 1)
                   .reshape(b * 42, config.channels).float().contiguous())
            nhwc = x2d.reshape(b, 6, 7, config.channels)
            bound_ms, bound_by, flops, nbytes = tower_bound(config, b)
            t = {
                "ms": timed_ms(lambda: tower.run_tower(packed, x2d)),
                "plain_ms": timed_ms(lambda: tower.tower_plain(packed, x2d), iters=5),
                "plain_model_ms": timed_ms(
                    lambda: tower.tower_plain(packed, x2d, tensor_core=True), iters=2, warmup=1),
                "library_ms": timed_ms(lambda: lib_tower(nhwc)),
                "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops, "bytes": nbytes,
            }
            t["ms_again"] = timed_ms(lambda: tower.run_tower(packed, x2d))
            times[b] = t
            log(f"[time] tower B={b}: kernel {t['ms']:.4f} ms (again {t['ms_again']:.4f}), "
                f"plain {t['plain_ms']:.4f} ms (tensor core emulated {t['plain_model_ms']:.1f}), cuDNN {t['library_ms']:.4f} ms, bound "
                f"{bound_ms:.4f} ms by {bound_by} ({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.2f} MB), "
                f"{flops / t['ms'] / 1e9:.1f} TFLOP/s")
    report["times"] = times

    # --- 4. search and self-play on the card against the CPU -----------------
    cpu = torch.device("cpu")
    for k in (1, 8):
        cfg = MCTSConfig(simulations=48, parallel_sims=k)
        roots = random_positions(64, make_generator(1, cpu), cpu)
        ongoing = roots.result == 0
        r_cpu = make_search_fn(centre_evaluator_batched, cfg)(roots, make_generator(0, cpu), ongoing)
        r_gpu = make_search_fn(centre_evaluator_batched, cfg)(
            roots.map(lambda x: x.to(dev)), make_generator(0, dev), ongoing.to(dev))
        sd = (r_cpu.tree.stats - r_gpu.tree.stats.cpu()).abs().max().item()
        same = bool((r_cpu.move == r_gpu.move.cpu())[ongoing].all())
        log(f"[check] search K={k} on 64 positions, card vs CPU: moves equal {same}, |stats| max {sd:.3g}")
        if not same or sd > 1e-4:
            fail(f"search on the card differs from the CPU (K={k})")
    cfg = MCTSConfig(simulations=16, parallel_sims=8)
    outs = [
        make_refill_play_fn(centre_evaluator_batched, cfg, 8, 20, device=d)(make_generator(0, d))
        for d in (cpu, dev)
    ]
    same = all(bool((a.cpu() == b.cpu()).all()) for a, b in zip(outs[0], outs[1]) if a.dtype != torch.float32)
    pd = (outs[0].policies - outs[1].policies.cpu()).abs().max().item()
    log(f"[check] refill self-play 20 games, card vs CPU: records equal {same}, |policy| max {pd:.3g}")
    if not same or pd > 1e-5:
        fail("refill self-play on the card differs from the CPU")

    # --- 5. the self-play path -------------------------------------------------
    search_cfg = MCTSConfig(
        simulations=SMOKE["simulations"], root_dirichlet_alpha=0.3,
        root_exploration_fraction=0.25, num_sampling_moves=6,
        parallel_sims=SMOKE["parallel_sims"],
    )
    shapes = LaunchShapes(tower)
    evaluator = make_net_evaluator(net)
    play = make_refill_play_fn(evaluator, search_cfg, SMOKE["slots"], SMOKE["games"], device=dev)
    waves = []
    torch.cuda.synchronize()
    tower.run_tower.launches = 0
    t0 = time.perf_counter()
    out = play(make_generator(SMOKE["seed"], dev), progress=lambda w, n: waves.append(n))
    torch.cuda.synchronize()
    t_play = time.perf_counter() - t0
    launches = tower.run_tower.launches
    planes, values, policies = training_arrays(out)
    n_moves = replay_games(out)
    if int(out.mask.sum()) != n_moves or not (out.result.cpu() != 0).all():
        fail("not every game finished")
    pol_sums = out.policies.sum(-1)[out.mask]
    if not torch.allclose(pol_sums, torch.ones_like(pol_sums), atol=1e-5):
        fail("policy targets are not distributions")
    if planes.shape != (2 * n_moves, 3, 6, 7) or values.shape != (2 * n_moves,):
        fail(f"training_arrays shapes {planes.shape} {values.shape}")
    if launches == 0:
        fail("the main path never launched the tower kernel")
    res = out.result.cpu()
    selfplay = {
        **SMOKE, "seconds": t_play, "moves": n_moves, "waves": len(waves),
        "moves_per_s": n_moves / t_play, "sims_per_s": n_moves * SMOKE["simulations"] / t_play,
        "tower_launches": launches, "launches_by_boards": shapes.take("self-play"),
        "o_wins": int((res == 1).sum()), "x_wins": int((res == 2).sum()), "draws": int((res == 3).sum()),
        "positions": int(values.shape[0]),
    }
    report["selfplay"] = selfplay
    log(f"[selfplay] {SMOKE['games']} games ({selfplay['o_wins']} o / {selfplay['draws']} draw / "
        f"{selfplay['x_wins']} x), {n_moves} moves in {t_play:.2f} s over {len(waves)} waves: "
        f"{selfplay['moves_per_s']:.1f} moves/s, {selfplay['sims_per_s']:.0f} sims/s, "
        f"tower kernel launches {launches}; all games replay on the host board")

    # --- 6.-9. the learner, the training generation, a match -------------------
    # a generator of their own: the learner's batches do not depend on how
    # many positions the phases above drew
    train_gen = make_generator(SMOKE["seed"] + 1, dev)
    report["train_check"] = check_train_step(dev, train_gen)
    report["train_times"] = time_train_step(dev, train_gen)
    report["generation"] = drive_generations(dev, shapes)
    generation_launches = sum(
        g["launches"]["selfplay"] + g["launches"]["match"] for g in report["generation"]["generations"])
    generation_shapes = {}
    for g in report["generation"]["generations"]:
        for b, n in g["launches_by_boards"].items():
            generation_shapes[b] = generation_shapes.get(b, 0) + n
    if sum(generation_shapes.values()) != generation_launches:
        fail(f"launches by batch {generation_shapes} do not add up to {generation_launches}")
    report_boards = max(generation_shapes, key=generation_shapes.get)
    if report_boards not in times:
        fail(f"most launches of the generations are at B={report_boards}, which was not timed: "
             f"{generation_shapes}")
    report["match"] = gen161_match(net, dev, shapes)

    # --- 10.-13. data parallelism, the host search and solver, the supervisor --
    seconds = {}
    for name, phase in (("dp", lambda: drive_dp(dev)), ("nccl", lambda: nccl_one_rank(dev)),
                        ("host", lambda: host_phase(dev)), ("supervisor", supervisor_phase)):
        t0 = time.perf_counter()
        report[name] = phase()
        seconds[name] = time.perf_counter() - t0
    report["phase_seconds"] = seconds
    log("[phases] " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
        + f"; together {sum(seconds.values()):.1f} s")
    dp_launches = sum(report["dp"]["launches"].values())
    for b, n in report["dp"]["launches_by_boards"].items():
        generation_shapes[b] = generation_shapes.get(b, 0) + n

    # --- 14. result lines ------------------------------------------------------
    # time, bound and library time at the batch most launches of the
    # generations have (their self-play's leaves); the error is the largest
    # over every shape the generations and the [dp] ranks launched
    t_report = times[report_boards]
    kernels = [{
        "name": "tower",
        "route": "cuda",
        "source": "connect4_tpu_torch/models/csrc/tower.cu",
        "replaces": "connect4_tpu/models/pallas_net.py:153",
        # of the training generations of phase 8 (self-play and gating match
        # of both) and of the [dp] ranks (sharded self-play and two mesh
        # generations); the self-play path of phase 5 is counted beside it
        "launches": generation_launches + dp_launches,
        "launches_by_path": {"selfplay": launches, "generation": generation_launches,
                             "dp_selfplay": report["dp"]["launches"]["selfplay"],
                             "dp_generation": report["dp"]["launches"]["generation"]},
        "launches_by_boards": generation_shapes,
        "boards": report_boards,
        "max_abs_err": max(errs[b]["model"]["tower_max"] for b in generation_shapes),
        "max_abs_err_nearest": max(errs[b]["nearest"]["tower_max"] for b in generation_shapes),
        "ms": t_report["ms"],
        "plain_ms": t_report["plain_ms"],
        "bound_ms": t_report["bound_ms"],
        "bound_by": t_report["bound_by"],
        "library_ms": t_report["library_ms"],
        "by_boards": {b: {k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                      for b, t in times.items()},
    }]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    report["nvidia_smi"] = smi
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
