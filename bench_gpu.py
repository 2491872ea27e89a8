"""Headline benchmark of the PyTorch/CUDA port: wall-clock for one full
training generation on one GPU.

The same workload as ``bench.py`` (which times the JAX package), through
``connect4_tpu_torch``: 1200 self-play games x 800 MCTS simulations per move
with the example-net architecture (filters=64, fc=6, res=6, bf16), K=8
walkers, a 512-slot refill pool, searches in calls of 200 simulations, then
5 epochs of SGD at batch 4096 on the generated data.

Prints exactly one JSON line on stdout:
  {"metric": "generation_wall_clock", "value": <seconds>, "unit": "s",
   "vs_baseline": <reference_seconds / value>}

Context goes to stderr: the card's name and power limit as ``nvidia-smi``
gives them, the workload, the split into self-play and training seconds and
the throughput, and the tower's launches by batch (boards). Set
BENCH_FAST=1 for a reduced workload; BENCH_GAMES, BENCH_SIMS,
BENCH_PARALLEL_SIMS, BENCH_SIMS_PER_CALL and BENCH_SLOTS override single
settings, as for ``bench.py``, and BENCH_FILTERS the net's width (above
256 filters the tower runs through the layer kernel). A workload other
than 1200 x 800 is scaled linearly to it and marked as scaled on stderr.

Needs a CUDA card (the tower and descent kernels are built for sm_90a) and
``nvcc``; raises without CUDA. Nothing in the port compiles at run time
except those kernels, so the warm-up before the timed generation is a small
one: the kernels' builds, cuDNN's choice of algorithms and the allocator's
first blocks. The timed generation's search is a new one, as each generation of
``TrainingLoop`` is, so the capture of its CUDA graphs (one a pool width:
an iteration, whose descent is one launch of the descent kernel) is timed
with it and printed, beside the descent kernel's launches.
"""

import json
import os
import subprocess
import sys
import time

REFERENCE_GENERATION_SECONDS = 50 * 60  # the reference's ~50 min/generation


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_gpu: CUDA is not available; this benchmark runs on the GPU")

    import numpy as np

    from connect4_tpu_torch.config import MCTSConfig, ModelConfig, NetConfig
    from connect4_tpu_torch.eval.evaluators import make_net_evaluator
    from connect4_tpu_torch.mcts import batched
    from connect4_tpu_torch.models import tower
    from connect4_tpu_torch.training.learner import (
        init_train_state,
        make_train_step,
        set_learning_rate,
        train_epochs,
    )
    from connect4_tpu_torch.training.self_play import (
        make_refill_play_fn,
        make_stepwise_play_fn,
        training_arrays,
    )
    from connect4_tpu_torch.utils import make_generator, resolve_device

    dev = resolve_device("cuda")
    fast = os.environ.get("BENCH_FAST") == "1"
    n_games = int(os.environ.get("BENCH_GAMES", 128 if fast else 1200))
    sims = int(os.environ.get("BENCH_SIMS", 64 if fast else 800))
    # leaf parallelism (virtual-visit walkers); BENCH_PARALLEL_SIMS=1 for the
    # exact sequential search
    parallel = int(os.environ.get("BENCH_PARALLEL_SIMS", 8))
    sims_per_call = int(os.environ.get("BENCH_SIMS_PER_CALL", 0)) or min(sims, 200)
    # compact-and-refill slot pool (slots < games keeps every search row
    # busy); BENCH_SLOTS=0 selects the pure-lockstep path instead. In fast
    # mode slots stay below n_games so that the run still takes the refill
    # path. 512 slots at K=8 evaluate leaves at batch 4096.
    default_slots = min(256, n_games // 2) if fast else min(512, n_games)
    slots = int(os.environ.get("BENCH_SLOTS", default_slots))
    filters = int(os.environ.get("BENCH_FILTERS", 64))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} "
        f"(nvidia-smi: {smi}); torch {torch.__version__}, cuda {torch.version.cuda}")
    log(f"workload: {n_games} games x {sims} sims, filters {filters}")
    log(f"parallel_sims: {parallel}  sims_per_call: {sims_per_call}  slots: {slots or n_games}")

    net_config = NetConfig(filters=filters, n_fc_layers=6, n_residuals=6, compute_dtype="bfloat16")
    model_config = ModelConfig(net_config=net_config)

    def fresh_state():
        state = init_train_state(model_config, torch.Generator().manual_seed(0), dev)
        set_learning_rate(state.optimizer, model_config.initial_lr)
        return state

    def search_config(simulations):
        return MCTSConfig(
            simulations=simulations,
            root_dirichlet_alpha=0.3,
            root_exploration_fraction=0.25,
            num_sampling_moves=6,
            parallel_sims=parallel,
        )

    # ---- warm-up, outside the timed region --------------------------------
    t0 = time.time()
    warm_state = fresh_state()
    warm_slots = min(slots or n_games, 64)
    warm_play = make_refill_play_fn(
        make_net_evaluator(warm_state.net), search_config(2 * parallel),
        warm_slots, 2 * warm_slots, device=dev,
    )
    warm = warm_play(make_generator(99, dev))
    torch.cuda.synchronize()
    log(f"kernel build + warm-up self-play ({2 * warm_slots} games x {2 * parallel} sims): "
        f"{time.time() - t0:.1f}s")
    t0 = time.time()
    planes_w, values_w, policies_w = training_arrays(warm)
    rows = np.resize(np.arange(len(values_w)), model_config.batch_size)
    warm_step = make_train_step(warm_state.net, warm_state.optimizer)
    for _ in range(2):
        warm_step(*(torch.from_numpy(a[rows]).to(dev) for a in (planes_w, values_w, policies_w)))
    torch.cuda.synchronize()
    log(f"warm-up train steps at batch {model_config.batch_size}: {time.time() - t0:.1f}s")
    del warm_state, warm_play, warm, warm_step

    state = fresh_state()
    evaluator = make_net_evaluator(state.net)
    if slots and slots < n_games:
        play = make_refill_play_fn(
            evaluator, search_config(sims), slots, n_games, sims_per_call, device=dev
        )
    else:
        play = make_stepwise_play_fn(evaluator, search_config(sims), n_games, sims_per_call, device=dev)
    train_step = make_train_step(state.net, state.optimizer)

    # ---- timed generation --------------------------------------------------
    tower.run_tower.launches = 0
    batched.descend.launches = 0
    tower.run_tower.by_shape = {}
    torch.cuda.synchronize()
    t_gen = time.time()
    out = play(make_generator(0, dev))
    torch.cuda.synchronize()
    t_selfplay = time.time() - t_gen
    launches = tower.run_tower.launches
    descents = batched.descend.launches
    by_boards = {}  # the tower's launches by batch
    for per in tower.run_tower.by_shape.values():
        for b, n in per.items():
            by_boards[b] = by_boards.get(b, 0) + n
    # the CUDA graphs the generation's search captured, one a pool width
    captures = {rows: dict(ws.graphs.capture_ms) for (_, rows), ws in play.search.workspaces.items()
                if ws.graphs is not None}

    planes, values, policies = training_arrays(out)
    n = len(values)
    # stored uint8 NCHW layout; the train step converts each batch (the
    # epoch pass is the one TrainingLoop._train runs)
    arrays = tuple(torch.from_numpy(a).to(dev) for a in (planes, values, policies))
    losses = train_epochs(
        train_step, arrays, model_config.batch_size, model_config.n_training_epochs,
        make_generator(1, dev),
    )
    torch.cuda.synchronize()
    t_total = time.time() - t_gen

    losses = losses.cpu()
    if not bool(torch.isfinite(losses).all()):
        raise SystemExit("bench_gpu: a training loss is not finite")
    if launches == 0:
        raise SystemExit("bench_gpu: self-play never launched the tower kernel")
    moves_played = int(out.mask.sum())
    sims_total = moves_played * sims
    log(
        f"self-play: {t_selfplay:.1f}s  training: {t_total - t_selfplay:.1f}s  "
        f"moves: {moves_played}  positions: {n}  train steps: {len(losses)}  "
        f"loss: {losses[0]:.4f} -> {losses[-1]:.4f}  tower kernel launches: {launches}"
    )
    log(f"tower launches by batch (boards): {dict(sorted(by_boards.items(), reverse=True))}")
    log(f"search graphs captured in the generation (ms, by pool width): {captures}; descent kernel launches: "
        f"{descents}")
    log(
        f"throughput: {moves_played / t_selfplay:,.0f} moves/s, "
        f"{sims_total / t_selfplay:,.0f} sims/s"
    )

    # scale the measured time to the reference workload if overridden
    scale = (1200 * 800) / (n_games * sims)
    effective = t_total * scale if scale != 1.0 else t_total
    if scale != 1.0:
        log(f"(measured {t_total:.2f}s, scaled x{scale:.1f} to the 1200x800 reference workload)")

    print(
        json.dumps(
            {
                "metric": "generation_wall_clock",
                "value": round(effective, 2),
                "unit": "s",
                "vs_baseline": round(REFERENCE_GENERATION_SECONDS / effective, 2),
            }
        )
    )


if __name__ == "__main__":
    main()
